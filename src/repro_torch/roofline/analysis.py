"""Roofline terms of a traced step (twin of ``repro.roofline.analysis``).

    compute term    = FLOPs / (GPUs * peak FLOP/s)
    memory term     = bytes / (GPUs * HBM bandwidth)
    collective term = sum over collectives of per-GPU send bytes / the
                      bandwidth of the slowest link the collective's group
                      crosses

FLOPs and bytes come from ``roofline.trace_cost`` (a dispatch mode over one
call of the step on fake tensors, per GPU, multiplied by the GPU count);
collectives are the ones that trace recorded, each with its output bytes
and its group's global ranks. Per collective the ring algorithm's per-GPU
send bytes are charged, as the reference charges them: all-reduce
2 S (n-1)/n, all-gather S (n-1)/n, reduce-scatter S (n-1), all-to-all
S (n-1)/n, collective-permute S, for an output of S bytes and a group of n
(a group of one moves nothing and is skipped).

Hardware constants: NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core
GPU data sheet: 989 TFLOP/s bf16 dense (1,979 with sparsity), 3.35 TB/s
HBM3, NVLink 4 at 900 GB/s per GPU in total, 450 GB/s each way. Across
nodes (a DGX H100 / HGX H100 node holds 8 GPUs on one NVSwitch fabric)
each GPU has one 400 Gb/s ConnectX-7 NIC: 50 GB/s each way.

The link rule, the counterpart of the reference's one ICI link: GPUs are
numbered by global rank, 8 consecutive ranks to a node (ranks 0-7 node 0,
8-15 node 1, ...). A collective whose ranks all lie in one node is
charged at NVLink's ``NVLINK_BW``; one whose group spans nodes at the
NIC's ``NIC_BW`` (a ring through the group crosses a NIC, and the
slowest hop sets its rate). On the 16 x 16 production mesh the "model"
axis (16 consecutive ranks) spans two nodes, so its collectives are
charged at the NIC, and so are the "data" axis's (stride 16).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12          # bf16 dense, per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
NVLINK_BW = 450e9            # bytes/s each way per GPU, inside a node
NIC_BW = 50e9                # bytes/s each way per GPU, across nodes
NODE_GPUS = 8                # GPUs a node, consecutive global ranks

# the reference's names for the op kinds
OP_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")


def link_bw(link: str) -> float:
    return NVLINK_BW if link == "nvlink" else NIC_BW


def link_of(ranks: Iterable[int]) -> str:
    """"nvlink" if every rank of the group lies in one node of
    ``NODE_GPUS`` consecutive ranks, else "nic"."""
    nodes = {int(r) // NODE_GPUS for r in ranks}
    return "nvlink" if len(nodes) <= 1 else "nic"


def ring_send_bytes(op: str, out_bytes: float, n: int) -> float:
    """Per-GPU send bytes of one collective (``repro.roofline.analysis``'s
    ring charge), for an output of ``out_bytes`` over a group of ``n``."""
    if op == "all-reduce":
        return 2.0 * out_bytes * (n - 1) / n
    if op == "all-gather":
        return out_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return out_bytes * (n - 1)
    if op == "all-to-all":
        return out_bytes * (n - 1) / n
    if op == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {op!r}; known: {OP_KINDS}")


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    total_bytes: float = 0.0   # per-device send bytes
    bytes_by_link: Dict[str, float] = field(default_factory=dict)

    def add(self, op: str, nbytes: float, link: str = "nic") -> None:
        self.counts[op] = self.counts.get(op, 0) + 1
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + nbytes
        self.bytes_by_link[link] = self.bytes_by_link.get(link, 0.0) + nbytes
        self.total_bytes += nbytes


def collective_stats(records: Iterable[Tuple[str, float, Iterable[int]]]
                     ) -> CollectiveStats:
    """The counterpart of the reference's ``parse_collectives``: from
    recorded collectives (op kind, output bytes, the group's global ranks)
    rather than HLO text. Groups of one are skipped, as there."""
    stats = CollectiveStats()
    for op, out_bytes, ranks in records:
        ranks = tuple(ranks)
        n = len(ranks)
        if n <= 1:
            continue
        stats.add(op, ring_send_bytes(op, out_bytes, n), link_of(ranks))
    return stats


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # traced FLOPs, all GPUs
    hlo_bytes: float                 # kernel-adjusted (deployment path)
    collective_bytes: float          # per device
    model_flops: float               # 6*N*D (active params)
    collectives: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    bytes_per_device: float = 0.0    # peak live bytes of rank 0
    hlo_bytes_raw: float = 0.0       # torch-route bytes (pre-adjust)
    bytes_by_region: Dict[str, float] = field(default_factory=dict)
    collective_bytes_by_link: Dict[str, float] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return sum(b / link_bw(k)
                   for k, b in self.collective_bytes_by_link.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline fraction: useful model FLOP/s at the step-time lower
        bound, over peak."""
        t = self.step_time_lower_bound
        if t <= 0:
            return 0.0
        return self.model_flops / t / (self.chips * PEAK_FLOPS)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "bytes_per_device": self.bytes_per_device,
            "collectives": self.collectives,
            "collective_counts": self.collective_counts,
            "hlo_bytes_raw": self.hlo_bytes_raw,
            "bytes_by_region": self.bytes_by_region,
            "collective_bytes_by_link": self.collective_bytes_by_link,
        }


def kernel_region_traffic(cfg, shape) -> Dict[str, float]:
    """Analytic GLOBAL HBM bytes for the kernel regions.

    The dry-run traces the kernels' plain PyTorch routes (fake tensors are
    not CUDA tensors), whose interior intermediates (attention
    probabilities, scan cumulants) pass through device memory. On the card
    those regions run as the CUDA kernels, whose interiors stay in shared
    memory and registers — their true HBM traffic is just the boundary
    tensors. The dry-run subtracts the traced region bytes and adds these
    analytic boundary numbers (train: fwd + remat-refwd + bwd ~= 4
    boundary passes). Copied from the reference as it is: arithmetic on
    the config and the shape.
    """
    mode = shape.kind
    B, S = shape.global_batch, shape.seq_len
    bys = 2.0  # bf16 boundaries
    passes = 4.0 if mode == "train" else 1.0
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_attn = sum(1 for k in kinds if k in "gl")
    n_mamba = sum(1 for k in kinds if k == "m")
    n_rwkv = sum(1 for k in kinds if k == "r")
    H, KV, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    out: Dict[str, float] = {}
    if mode == "decode":
        # read the cache once + write the new entry; q/out negligible
        att = n_attn * (2 * B * S * KV * hd * bys + 4 * B * H * hd * bys)
    else:
        att = n_attn * passes * (2 * B * S * H * hd
                                 + 2 * B * S * KV * hd) * bys
    if cfg.is_encdec and mode != "decode":
        att += (cfg.n_enc_layers + cfg.n_layers) * passes * (
            2 * B * S * H * hd + 2 * B * S * KV * hd) * bys
    out["attention"] = att
    if mode == "decode":
        hs = cfg.rwkv_head_size
        out["rwkv"] = n_rwkv * (5 * B * D * bys + 2 * B * D * hs * 4.0)
        out["mamba"] = n_mamba * 2 * B * cfg.mamba_d_inner * (
            cfg.mamba_d_state + 3) * 4.0
    else:
        out["rwkv"] = n_rwkv * passes * 5 * B * S * D * bys
        out["mamba"] = n_mamba * passes * (
            3 * B * S * cfg.mamba_d_inner + 2 * B * S * cfg.mamba_d_state) * 4.0
    return out


def model_flops_for(cfg, shape, mode: str) -> float:
    """MODEL_FLOPS = 6*N*D (+3x attention term) for training, 2*N*D (+1x)
    for inference. The attention term (2*B*ceil(S^2/2)*H*hd*2 per layer,
    windowed layers capped at the window) is genuine useful work that the
    param-count convention misses — at 32k prefill it DOMINATES, so without
    it the roofline fraction would be nonsensically pessimistic."""
    n_active = cfg.num_active_params()
    B, S = shape.global_batch, shape.seq_len
    H, hd = cfg.n_heads, cfg.head_dim

    def attn_fwd_flops() -> float:
        total = 0.0
        for i in range(cfg.n_layers):
            kind = cfg.layer_kind(i)
            if kind not in ("g", "l"):
                continue
            if mode == "decode":
                ctx = S if kind == "g" else min(S, cfg.sliding_window)
                total += 2.0 * 2.0 * B * ctx * H * hd
            else:
                ctx = (S / 2 if kind == "g"
                       else min(S, cfg.sliding_window))  # causal half / window
                total += 2.0 * 2.0 * B * S * ctx * H * hd / (
                    1.0 if kind == "l" else 1.0)
        if cfg.is_encdec and mode != "decode":
            total += cfg.n_enc_layers * 2.0 * 2.0 * B * S * S * H * hd
            total += cfg.n_layers * 2.0 * 2.0 * B * S * S * H * hd  # cross
        return total

    if mode == "train":
        return 6.0 * n_active * shape.tokens + 3.0 * attn_fwd_flops()
    if mode == "prefill":
        return 2.0 * n_active * shape.tokens + attn_fwd_flops()
    return 2.0 * n_active * shape.global_batch + attn_fwd_flops()
