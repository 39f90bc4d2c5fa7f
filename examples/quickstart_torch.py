"""Quickstart on the PyTorch port: a multi-tenant VirtualCluster (twin of
``examples/quickstart.py``, the same script on ``repro_torch.core``).

Two tenants get dedicated control planes on a shared 4-node super cluster;
each submits WorkUnits with identical names — full API compatibility, no
collisions, vNode views preserved. Each node's provider serves a unit by
running its arch's prefill (the port's model, random weights) on the card
unless ``--device cpu``, and the result shows in the unit's logs. Run:

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (CallableProvider,  # noqa: E402
                              VirtualClusterFramework)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_cache, init_params, prefill  # noqa: E402


def unit_runner(device):
    """A provider callable: the unit's arch, a 16-token prefill on
    ``device``, the next token."""
    models = {}

    def run_unit(unit):
        arch = unit.spec.arch
        if arch not in models:
            gen = torch.Generator(device=device).manual_seed(0)
            models[arch] = init_params(get_config(arch), generator=gen,
                                       device=device)
        cfg = get_config(arch)
        tokens = torch.arange(16, device=device, dtype=torch.int32)[None]
        cache = init_cache(cfg, 1, 16, device=device)
        logits, _, _ = prefill(models[arch], cfg, tokens, cache)
        return {"arch": arch, "device": str(device),
                "next_token": int(logits[0, -1].argmax())}
    return run_unit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    run_unit = unit_runner(resolve_device(args.device))
    # autoscale=True: the closed-loop autoscaler (sixth controller) sizes
    # the downward shard fleet and the executor pool from live load
    # metering/audit: per-tenant usage attribution + request audit trail,
    # surfaced at /usage and /audit (both default off, ~zero cost off)
    fw = VirtualClusterFramework(
        num_nodes=4, scan_interval=5.0, heartbeat_interval=2.0,
        autoscale=True, metering=True, audit=True,
        provider_factory=lambda node: CallableProvider(run_unit))
    with fw:
        # metrics over HTTP: counters/summaries/gauges as JSON (stdlib only)
        port = fw.serve_metrics()
        print(f"metrics: http://127.0.0.1:{port}/metrics  "
              f"health: http://127.0.0.1:{port}/healthz")
        # tenants are provisioned by the tenant operator from VC objects
        acme = fw.add_tenant("acme", weight=2)
        globex = fw.add_tenant("globex", weight=1)
        print("tenants provisioned:",
              [vc.metadata.name
               for vc in fw.super_api.list("VirtualClusterCR")])

        # both tenants use the same namespace/name — isolated control planes
        for plane in (acme, globex):
            unit = fw.make_unit("train-job", "default", chips=2,
                                arch="tiny-dense", shape="train_4k")
            fw.submit(plane, unit)

        for plane in (acme, globex):
            u = fw.wait_ready(plane, "default", "train-job", timeout=30)
            print(f"[{plane.name}] train-job -> {u.status.phase} on "
                  f"vNode {u.status.node}")
            print(f"[{plane.name}] vNodes visible: "
                  f"{[v.metadata.name for v in plane.api.list('VirtualNode')]}")

        # the super cluster sees namespace-prefixed copies (paper §III-B(2))
        print("super-cluster namespaces:",
              [n.metadata.name for n in fw.super_api.list("Namespace")])

        # logs flow through the vn-agent with credential-based identity
        u = acme.api.get("WorkUnit", "default", "train-job")
        log = fw.vn_agent.logs(acme.api.credential, u.status.node,
                               "default", "train-job")
        print("acme logs via vn-agent:", log.strip())

        # tenant-visible Events: the node agents record WorkUnit phase
        # transitions (and node heartbeats) as deduplicated Events in the
        # super cluster; the upward pipeline syncs each tenant's events —
        # dedup counts included — into its own control plane, so this is
        # the tenant's "kubectl get events"
        deadline = time.monotonic() + 5.0
        while not acme.api.list("Event", "default") \
                and time.monotonic() < deadline:
            time.sleep(0.05)      # the upward sync is asynchronous
        for ev in acme.api.list("Event", "default"):
            print(f"[acme] event {ev.reason} x{ev.count} "
                  f"{ev.involved_kind}/{ev.involved_name}: {ev.message}")

        # tenant deletion cascades: super copies and vNodes are GC'd
        acme.api.delete("WorkUnit", "default", "train-job")
        time.sleep(0.5)
        print("super WorkUnits after acme delete:",
              len(fw.super_api.list("WorkUnit")))

        # every controller runs on the shared runtime: one health map and
        # one metrics registry for the whole control plane, served over HTTP
        try:
            health = json.load(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz"))
        except urllib.error.HTTPError as e:   # 503 = some controller down
            health = json.load(e.fp)
        print("controller health (HTTP):", all(health["controllers"].values()))
        # the autoscaler's loop state rides /healthz: last decision, live
        # targets, cooldown remaining — a wedged loop is visible here
        scaler = health["autoscaler"]
        print("autoscaler targets:", scaler["targets"],
              "last decision:", scaler["last_decision"])
        snap = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics"))
        reconciles = {k: int(v) for k, v in snap["counters"].items()
                      if k.startswith("reconcile_total")}
        print("reconciles by controller:", reconciles)
        # the whole control plane — informers, workers, scans for every
        # tenant — multiplexes onto one fixed-size cooperative pool
        print("executor:", {k: int(v) for k, v in snap["gauges"].items()
                            if k.startswith("executor")})

        # who used what: /usage attributes every resource axis per tenant
        # (lifetime totals + rolling window) and scores noisy neighbors
        usage = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/usage"))
        acme_usage = usage["totals"].get("acme", {})
        print("acme usage:",
              {k: round(v, 1) for k, v in sorted(acme_usage.items())})
        print("noisy neighbors (score >= "
              f"{usage['noisy_threshold']}):",
              [f"{n['tenant']}@{n['score']:.2f}" for n in usage["noisy"]])
        # and who did what: the audit trail, filterable per tenant/verb
        audit = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/audit?tenant=acme&verb=delete"))
        for rec in audit["records"]:
            print(f"[audit] {rec['tenant']} {rec['verb']} "
                  f"{rec['kind']}/{rec['name']} -> {rec['outcome']}")
    print("done")


if __name__ == "__main__":
    main()
