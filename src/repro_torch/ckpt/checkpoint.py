"""Checkpointing with async write and atomic commit (twin of
``repro.ckpt.checkpoint``), on the port's trees of tensors.

Layout, the reference's: <dir>/step_<N>/{manifest.json, <flat-key>.npy ...}.
A checkpoint is valid iff manifest.json exists (written last, then the
directory renamed into place), so a crash mid-write never yields a
readable-but-corrupt checkpoint. The flat keys are those of JAX's
``tree_flatten_with_path``: a tuple or list index, then dict keys in sorted
order, joined by "/" (``0/blocks/sub0/attn/wq/w``, ``1/step`` for a
``(params, opt_state)`` tuple), so a checkpoint either package writes
restores in the other. ``restore`` puts each leaf on the device and in the
dtype of the matching leaf of ``tree_like``.

Leaves are saved as numpy arrays, and numpy has no bfloat16: a bf16 leaf
raises ``TypeError``. The training state (fp32 masters and moments, an
int32 step) has none.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _items(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """(flat key, leaf) in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(key: str, leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {key} is bfloat16, which numpy cannot "
                "hold; save fp32 masters (the training state is fp32 and "
                "int32)")
        # a copy: the port updates its training state in place
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _rebuild(tree: Any, leaves: Iterator[Any]) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self.save_count = 0

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, block: bool = False) -> None:
        """Snapshot to host memory synchronously (a copy of every leaf, so
        later in-place updates do not reach it); write to disk async."""
        flat = {k: _to_numpy(k, v) for k, v in _items(tree)}
        self.wait()  # one outstanding write at a time
        if self.async_write and not block:
            self._pending = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._pending.start()
        else:
            self._write(step, flat)

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "keys": {}}
        for key, arr in flat.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["keys"][key] = {"file": fname, "shape": list(arr.shape),
                                     "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # commit
        self.save_count += 1
        self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """Restore into the structure of ``tree_like``: fresh tensors, each
        on the device and in the dtype of ``tree_like``'s leaf."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = []
        for key, like in _items(tree_like):
            meta = manifest["keys"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint {d} missing key {key}")
            arr = np.load(os.path.join(d, meta["file"]))
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint {d} key {key}: shape "
                                 f"{arr.shape}, expected {tuple(like.shape)}")
            out.append(torch.from_numpy(arr).to(device=like.device,
                                                dtype=like.dtype))
        return _rebuild(tree_like, iter(out)), step
