"""Weights made by the benchmark from the run's seed, on the device, one
call a leaf (each leaf stacked over the layers), in the type the cell
serves or trains them in. The leaves, in the program's layout (nested
dicts, dense ``w`` as [in, out], blocks stacked on a leading layer axis)
and in a fixed order, are the configuration's reference module's
(``leaves``), so the same tensors go to the program and to the reference.

Every leaf has a generator of its own, seeded from (seed, leaf index):
one leaf can be made again alone, which is how the training check finds
the change of each parameter without keeping a copy of the start.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from .manifest import reference

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]


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


def leaves(config: Dict[str, Any]) -> List[Leaf]:
    """The leaves of ``config``'s model, from its reference module."""
    return reference(config).leaves(config["model"])


def make_weights(config: Dict[str, Any], seed: int, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The whole tree of ``config``'s weights for ``seed``."""
    tree: Dict[str, Any] = {}
    for i, leaf in enumerate(leaves(config)):
        put(tree, leaf[0], make_leaf(leaf, seed, i, device, dtype))
    return tree


def refill(tree: Dict[str, Any], config: Dict[str, Any], seed: int) -> None:
    """Write ``seed``'s weights into ``tree``'s tensors in place (a graph
    that binds their addresses stays valid)."""
    for i, leaf in enumerate(leaves(config)):
        t = get(tree, leaf[0])
        t.copy_(make_leaf(leaf, seed, i, t.device, t.dtype))


def per_layer(tree: Dict[str, Any], config: Dict[str, Any]
              ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, stacked leaves split by layer: the
    leaves that the training check compares one by one."""
    for path, _, _, _ in leaves(config):
        t = get(tree, path)
        name = ".".join(path)
        if path[0] == "blocks":
            for layer in range(t.shape[0]):
                yield f"{name}[{layer}]", t[layer]
        else:
            yield name, t
