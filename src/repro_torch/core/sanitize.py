"""REPRO_SANITIZE=1 runtime sanitizer: the dynamic half of vclint.

Static rules (tools/vclint) prove what they can see; this module catches
what they can't. When ``REPRO_SANITIZE=1``:

- the store hands out **deep-frozen proxies** for all ``copy=False``
  reads (LIST pages, snapshots, zero-copy watch events). A proxy is a
  dynamically created *subclass* of the real object class — ``isinstance``
  checks, ``type(obj).kind`` lookups, ``dataclasses.fields`` and
  field-wise ``==`` all keep working — but any attribute/item mutation
  raises :class:`ZeroCopyMutationError` immediately, with the site that
  acquired the reference in the message;
- a **lock-hold watchdog** wraps the store lock and times executor quanta:
  holds/quanta longer than ``REPRO_SANITIZE_LOCK_MS`` /
  ``REPRO_SANITIZE_QUANTUM_MS`` are counted and reported to stderr
  (bounded; never raises — latency warts are reported, not fatal).

The flag is read once per ObjectStore/CooperativeExecutor construction,
so tests can monkeypatch the env var and build fresh instances. With the
env var unset every hook is a no-op and behavior is byte-identical.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

_TRUTHY = ("1", "true", "yes", "on")


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() in _TRUTHY


def long_quantum_seconds() -> float:
    return float(os.environ.get("REPRO_SANITIZE_QUANTUM_MS", "500")) / 1e3


def lock_warn_seconds() -> float:
    return float(os.environ.get("REPRO_SANITIZE_LOCK_MS", "200")) / 1e3


class ZeroCopyMutationError(RuntimeError):
    """A consumer mutated a ``copy=False`` (shared, READ-ONLY) store ref."""


# ----------------------------------------------------------------- reporting

long_hold_reports = 0
_MAX_STDERR_REPORTS = 25
_report_lock = threading.Lock()


def report_long_hold(msg: str) -> None:
    """Count a watchdog trip; echo the first few to stderr."""
    global long_hold_reports
    with _report_lock:
        long_hold_reports += 1
        n = long_hold_reports
    if n <= _MAX_STDERR_REPORTS:
        print(f"[sanitize] {msg}", file=sys.stderr)


# ------------------------------------------------------------- frozen proxies

def _acquire_site() -> str:
    """First stack frame outside the store/sanitizer plumbing — the consumer
    that asked for the zero-copy ref."""
    f = sys._getframe(1)
    skip = ("sanitize.py", "store.py", "apiserver.py")
    while f is not None:
        fname = f.f_code.co_filename
        if not fname.endswith(skip):
            return (f"{os.path.basename(fname)}:{f.f_lineno} "
                    f"in {f.f_code.co_name}")
        f = f.f_back
    return "<unknown>"


def _mutation_error(obj: Any, what: str) -> ZeroCopyMutationError:
    site = getattr(obj, "__acquired_at__", "<unknown>")
    base = getattr(type(obj), "__frozen_base__", type(obj))
    return ZeroCopyMutationError(
        f"{what} on a zero-copy (copy=False) {base.__name__} ref — these "
        f"are shared READ-ONLY store state; deepcopy_obj() before "
        f"mutating. Ref acquired at {site}.")


class FrozenDict(dict):
    __slots__ = ("__acquired_at__",)

    def _refuse(self, what: str) -> None:
        raise _mutation_error(self, what)

    def __setitem__(self, k: Any, v: Any) -> None:
        self._refuse(f"item assignment [{k!r}]")

    def __delitem__(self, k: Any) -> None:
        self._refuse(f"item deletion [{k!r}]")

    def clear(self) -> None:                          # type: ignore[override]
        self._refuse(".clear()")

    def pop(self, *a: Any) -> Any:                    # type: ignore[override]
        self._refuse(".pop()")

    def popitem(self) -> Any:                         # type: ignore[override]
        self._refuse(".popitem()")

    def setdefault(self, *a: Any) -> Any:             # type: ignore[override]
        self._refuse(".setdefault()")

    def update(self, *a: Any, **kw: Any) -> None:     # type: ignore[override]
        self._refuse(".update()")

    def __ior__(self, other: Any) -> Any:
        self._refuse("|= update")


class FrozenList(list):
    __slots__ = ("__acquired_at__",)

    def _refuse(self, what: str) -> None:
        raise _mutation_error(self, what)

    def __setitem__(self, i: Any, v: Any) -> None:
        self._refuse(f"item assignment [{i!r}]")

    def __delitem__(self, i: Any) -> None:
        self._refuse(f"item deletion [{i!r}]")

    def append(self, v: Any) -> None:                 # type: ignore[override]
        self._refuse(".append()")

    def extend(self, it: Any) -> None:                # type: ignore[override]
        self._refuse(".extend()")

    def insert(self, i: int, v: Any) -> None:         # type: ignore[override]
        self._refuse(".insert()")

    def remove(self, v: Any) -> None:                 # type: ignore[override]
        self._refuse(".remove()")

    def pop(self, *a: Any) -> Any:                    # type: ignore[override]
        self._refuse(".pop()")

    def clear(self) -> None:                          # type: ignore[override]
        self._refuse(".clear()")

    def sort(self, *a: Any, **kw: Any) -> None:       # type: ignore[override]
        self._refuse(".sort()")

    def reverse(self) -> None:                        # type: ignore[override]
        self._refuse(".reverse()")

    def __iadd__(self, other: Any) -> Any:
        self._refuse("+= extend")


_frozen_classes: Dict[type, type] = {}
_frozen_lock = threading.Lock()


def _frozen_class(base: type) -> type:
    with _frozen_lock:
        cls = _frozen_classes.get(base)
        if cls is not None:
            return cls

        def _setattr(self: Any, name: str, value: Any) -> None:
            raise _mutation_error(self, f"attribute assignment .{name}")

        def _delattr(self: Any, name: str) -> None:
            raise _mutation_error(self, f"attribute deletion .{name}")

        def _eq(self: Any, other: Any) -> Any:
            b = type(self).__frozen_base__
            if dataclasses.is_dataclass(b) and isinstance(other, b):
                return all(
                    getattr(self, f.name) == getattr(other, f.name)
                    for f in dataclasses.fields(b))
            return NotImplemented

        def _ne(self: Any, other: Any) -> Any:
            eq = _eq(self, other)
            return eq if eq is NotImplemented else not eq

        ns = {
            "__frozen_base__": base,
            "__setattr__": _setattr,
            "__delattr__": _delattr,
        }
        if dataclasses.is_dataclass(base):
            # dataclass __eq__ is class-identity-gated; replace with a
            # field-wise one so frozen-vs-plain spec comparisons still work
            ns["__eq__"] = _eq
            ns["__ne__"] = _ne
            ns["__hash__"] = base.__hash__
        cls = type("Frozen" + base.__name__, (base,), ns)
        _frozen_classes[base] = cls
        return cls


def freeze(obj: Any, site: Optional[str] = None) -> Any:
    """Deep-frozen proxy of ``obj``; scalars pass through unchanged."""
    if site is None:
        site = _acquire_site()
    if obj is None or isinstance(obj, (str, int, float, bool, bytes,
                                       frozenset)):
        return obj
    if getattr(type(obj), "__frozen_base__", None) is not None \
            or isinstance(obj, (FrozenDict, FrozenList)):
        return obj
    if isinstance(obj, dict):
        d = FrozenDict({k: freeze(v, site) for k, v in obj.items()})
        object.__setattr__(d, "__acquired_at__", site)
        return d
    if isinstance(obj, (list, tuple)):
        items = [freeze(v, site) for v in obj]
        if isinstance(obj, tuple):
            return tuple(items)
        fl = FrozenList(items)
        object.__setattr__(fl, "__acquired_at__", site)
        return fl
    if hasattr(obj, "__dict__"):
        cls = _frozen_class(type(obj))
        proxy = object.__new__(cls)
        for k, v in vars(obj).items():
            object.__setattr__(proxy, k, freeze(v, site))
        object.__setattr__(proxy, "__acquired_at__", site)
        return proxy
    return obj


def freeze_all(objs: Any) -> list:
    """Freeze a sequence with one shared acquisition site (list/page path)."""
    site = _acquire_site()
    return [freeze(o, site) for o in objs]


def maybe_freeze(obj: Any, active: bool) -> Any:
    """Store hook: freeze only when that store was built with the
    sanitizer active (one branch in the fast path otherwise)."""
    if not active:
        return obj
    return freeze(obj, _acquire_site())


# -------------------------------------------------------------- lock watchdog

class WatchdogLock:
    """Wraps an (R)Lock; wall-times each thread's outermost hold and
    reports holds longer than ``warn_seconds``. Never raises, never
    changes locking semantics."""

    def __init__(self, inner: Any, name: str,
                 warn_seconds: Optional[float] = None):
        self._inner = inner
        self._name = name
        self._warn_s = (lock_warn_seconds() if warn_seconds is None
                        else warn_seconds)
        self._tl = threading.local()
        self.long_holds = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            depth = getattr(self._tl, "depth", 0)
            if depth == 0:
                self._tl.t0 = time.monotonic()
            self._tl.depth = depth + 1
        return ok

    def release(self) -> None:
        depth = getattr(self._tl, "depth", 1) - 1
        self._tl.depth = depth
        if depth == 0:
            held = time.monotonic() - self._tl.t0
            if held > self._warn_s:
                self.long_holds += 1
                report_long_hold(
                    f"lock {self._name!r} held {held * 1e3:.0f}ms "
                    f"(> {self._warn_s * 1e3:.0f}ms) by "
                    f"{threading.current_thread().name}")
        self._inner.release()

    def __enter__(self) -> "WatchdogLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()
