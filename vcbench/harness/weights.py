"""Weights made by the benchmark from the run's seed, on the device, one
call a leaf (each leaf stacked over the layers), in the type the cell
serves or trains them in. The tree has the program's layout (nested
dicts, dense ``w`` as [in, out], blocks stacked on a leading layer axis),
so the same tensors go to the program and to the reference.

Every leaf has a generator of its own, seeded from (seed, leaf index):
one leaf can be made again alone, which is how the training check finds
the change of each parameter without keeping a copy of the start.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]


def padded_vocab(vocab: int) -> int:
    """The program's padded vocabulary (rows of the table and the head)."""
    unit = 256 if vocab < 8192 else 4096
    return -(-vocab // unit) * unit


def leaves(model: Dict[str, Any]) -> List[Leaf]:
    """(path, shape, kind, stddev) of every leaf, in a fixed order. Kinds:
    "matrix" (the compute dtype), "bias" and "norm" (float32)."""
    d, L = model["d_model"], model["n_layers"]
    H, KV, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    dff, V = model["d_ff"], padded_vocab(model["vocab"])
    if model.get("layer_pattern", "g") != "g" or model.get("n_experts", 0):
        raise NotImplementedError("the benchmark's weights cover dense 'g' "
                                  "decoders only")
    out: List[Leaf] = [(("embed", "table"), (V, d), "matrix", 1.0),
                       (("final_norm",), (d,), "norm", 0.1)]
    if not model.get("tie_embeddings", False):
        out.append((("lm_head", "w"), (d, V), "matrix", d ** -0.5))
    sub = ("blocks", "sub0")
    out.append((sub + ("ln1",), (L, d), "norm", 0.1))
    for name, width in (("wq", H * hd), ("wk", KV * hd), ("wv", KV * hd)):
        out.append((sub + ("attn", name, "w"), (L, d, width), "matrix",
                    d ** -0.5))
        if model.get("qkv_bias", False):
            out.append((sub + ("attn", name, "b"), (L, width), "bias", 0.05))
    out.append((sub + ("attn", "wo", "w"), (L, H * hd, d), "matrix",
                (H * hd) ** -0.5))
    out.append((sub + ("ln2",), (L, d), "norm", 0.1))
    for name in ("wi", "wg"):
        out.append((sub + ("ffn", name, "w"), (L, d, dff), "matrix",
                    d ** -0.5))
    out.append((sub + ("ffn", "wo", "w"), (L, dff, d), "matrix",
                dff ** -0.5))
    if model.get("frontend") == "vit_stub":
        fd = model["frontend_dim"]
        out.append((("frontend_proj", "w"), (fd, d), "matrix", fd ** -0.5))
    return out


def leaf_seed(seed: int, index: int) -> int:
    return int(np.random.default_rng([int(seed), index]).integers(2 ** 62))


def make_leaf(leaf: Leaf, seed: int, index: int, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    """One leaf: normal of its stddev (norm scales 1 + that), in ``dtype``
    for matrices and float32 for biases and norms."""
    _, shape, kind, std = leaf
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    dt = dtype if kind == "matrix" else torch.float32
    t = torch.randn(shape, generator=gen, device=device, dtype=dt)
    t.mul_(std)
    if kind == "norm":
        t.add_(1.0)
    return t


def put(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def get(tree: Dict[str, Any], path: Tuple[str, ...]) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def make_weights(model: Dict[str, Any], seed: int, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The whole tree of ``model``'s weights for ``seed``."""
    tree: Dict[str, Any] = {}
    for i, leaf in enumerate(leaves(model)):
        put(tree, leaf[0], make_leaf(leaf, seed, i, device, dtype))
    return tree


def refill(tree: Dict[str, Any], model: Dict[str, Any], seed: int) -> None:
    """Write ``seed``'s weights into ``tree``'s tensors in place (a graph
    that binds their addresses stays valid)."""
    for i, leaf in enumerate(leaves(model)):
        t = get(tree, leaf[0])
        t.copy_(make_leaf(leaf, seed, i, t.device, t.dtype))


def per_layer(tree: Dict[str, Any], model: Dict[str, Any]
              ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, stacked leaves split by layer: the
    leaves that the training check compares one by one."""
    for path, _, _, _ in leaves(model):
        t = get(tree, path)
        name = ".".join(path)
        if path[0] == "blocks":
            for layer in range(t.shape[0]):
                yield f"{name}[{layer}]", t[layer]
        else:
            yield name, t
