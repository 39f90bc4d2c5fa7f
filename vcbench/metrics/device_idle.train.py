"""device_idle.train (layer: device): the share of the profiled train step
in which no operation ran on the card (the union of the device's
activity intervals), in %."""


def read(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
