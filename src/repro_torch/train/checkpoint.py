"""Atomic checkpoints of trees of tensors (numpy on disk): the port of the
JAX package's ``train/checkpoint.py``, with its on-disk layout, so a
checkpoint written by either package restores in the other.

Layout: ``<dir>/step_<N:08d>/proc_0.npz`` + ``manifest.json``.  Each leaf
is keyed by JAX's key string of its path (``"['opt']['m']['embed']"``,
``repro_torch.tree``), the leaves sorted by it and stored as ``a0``,
``a1``, ... with the manifest listing (key, name, shape, dtype) and the
step.  Atomicity: written to ``step_<N>.tmp``, then ``os.rename``d.  A
bf16 leaf is written as its raw 16-bit patterns (numpy has no bf16
without ``ml_dtypes``), dtype ``"bfloat16"`` in the manifest, and read
back from those bits; the JAX package writes such a leaf through
``ml_dtypes`` and reads the port's with ``ml_dtypes`` at hand.

:func:`restore` needs no model: the tree's structure comes from the
manifest's keys, or from ``like`` (its leaves are not read, so a tree of
meta tensors will do), and each leaf goes to ``device`` (None: the
card).  One process writes ``proc_0``: the multi-host layout waits for
the models' mesh paths (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.engine import resolve_device


def _to_numpy(x) -> tuple:
    """(the leaf as a numpy array, its manifest dtype)."""
    t = torch.as_tensor(x).detach()
    if t.dtype == torch.bfloat16:
        return t.cpu().view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, state, *, keep: int = 3) -> str:
    """Atomically persist ``state`` (a tree of tensors or arrays) as step
    ``step``, then keep the newest ``keep`` steps."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "time": time.time(), "keys": [],
                "process_count": 1}
    for i, (key, leaf) in enumerate(sorted(tree.keyed_leaves(state),
                                           key=lambda kv: kv[0])):
        name = f"a{i}"
        arrays[name], dtype = _to_numpy(leaf)
        manifest["keys"].append({"key": key, "name": name,
                                 "shape": list(arrays[name].shape),
                                 "dtype": dtype})
    np.savez(os.path.join(tmp, "proc_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def restore(ckpt_dir: str, like=None, *, step: Optional[int] = None,
            device=None) -> tuple:
    """(tree, step) of checkpoint ``step`` (the latest by default): the
    structure of ``like`` where given (its keys only), else the
    manifest's; each leaf a tensor of its saved dtype on ``device``
    (None: the card)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "proc_0.npz")) as data:
        by_key = {e["key"]: _leaf(data[e["name"]], e["dtype"], dev)
                  for e in manifest["keys"]}
    if like is None:
        return tree.from_keyed(by_key.items()), step
    keys = [k for k, _ in tree.keyed_leaves(like)]
    missing = [k for k in keys if k not in by_key]
    if missing:
        raise KeyError(f"checkpoint step {step} lacks {missing[:3]}")
    return tree.unflatten_like(like, (by_key[k] for k in keys)), step
