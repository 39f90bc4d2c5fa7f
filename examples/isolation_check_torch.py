"""Data-plane isolation on the PyTorch port: tenant programs cannot talk
across slices (twin of ``examples/isolation_check.py``).

Eight ranks form a (2, 2, 2) ("tenant", "data", "model") mesh; each rank's
tenant slice is its (2, 2) ("data", "model") sub-mesh, ranks 0-3 for
tenant A and 4-7 for tenant B. Each slice runs a small sharded
forward-and-gradient program (DTensors) while ``record_collectives`` lists
the group of every collective as global ranks, and the control plane's
router holds the list to the slice (``validate_groups``, the rule of
``MeshRouter.validate_isolation``). Then one program over a full (2, 4)
mesh must be rejected against tenant A's slice.

Runs on the card (8 GPUs, NCCL) unless ``--device cpu`` (gloo):

    PYTHONPATH=src python examples/isolation_check_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import IsolationViolation  # noqa: E402
from repro_torch.launch.spmd import spawn  # noqa: E402

TENANT_A = range(0, 4)


def tenant_program(mesh, device):
    """grad of sum(tanh(x @ w)) with x rows on "data", w columns on
    "model": an all-gather and a gradient reduction inside the mesh."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 128, generator=g).to(device)
    w = torch.randn(128, 64, generator=g).to(device)
    x = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    w = distribute_tensor(w, mesh, [Replicate(), Shard(1)]).requires_grad_()
    torch.tanh(x @ w).sum().backward()
    return w.grad.full_tensor()


def rank_main(rank, n, device):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import record_collectives, validate_groups
    grid = init_device_mesh(device, (2, 2, 2),
                            mesh_dim_names=("tenant", "data", "model"))
    tenant = grid["data", "model"]
    slice_ranks = sorted(tenant.mesh.flatten().tolist())
    with record_collectives() as groups:
        tenant_program(tenant, device)
    ok = validate_groups(groups, slice_ranks)
    full = make_test_mesh((2, 4), ("data", "model"), device=device)
    with record_collectives() as groups:
        tenant_program(full, device)
    try:
        validate_groups(groups, TENANT_A)
        rejected = None
    except IsolationViolation as e:
        rejected = str(e)
    return {"slice": slice_ranks, "collectives": ok, "rejected": rejected}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cpu' for 8 gloo ranks (default: 8 GPUs)")
    args = ap.parse_args(argv)
    res = spawn(rank_main, 8, device=args.device, args=(args.device,))
    for name, r in (("tenant-A", res[0]), ("tenant-B", res[4])):
        print(f"[{name}] slice ranks {r['slice']}: {r['collectives']} "
              f"collectives, all inside the slice OK")
    if any(r["rejected"] is None for r in res):
        raise SystemExit("ERROR: cross-slice program passed validation")
    print(f"[full-mesh program vs tenant-A slice] correctly rejected: "
          f"{res[0]['rejected']}")
    print("done")


if __name__ == "__main__":
    main()
