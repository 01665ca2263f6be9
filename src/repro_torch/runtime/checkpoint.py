"""Atomic checkpoints of tensor trees (port of
``repro/runtime/checkpoint.py``), in the reference's layout, so a
checkpoint written by either package restores in the other.

Layout per checkpoint:  <dir>/step_<n>/   (n zero-padded to 8 digits)
    manifest.json   — version, step, sorted key list, the tree's structure
    arrays.npz      — one entry per leaf, keyed by its ``/``-joined path
                      (dict keys and list indices); bfloat16 leaves are
                      stored as their uint16 bits (npz has no bfloat16)

Writes go to ``<dir>/.tmp_step_<n>`` then ``os.replace`` (atomic on POSIX):
a crash mid-write never corrupts the latest checkpoint. ``keep_last``
prunes the oldest. Restore reads every leaf on the host and puts it on
``device``, or where the ``like`` tree's leaf lives. The reference writes
a JAX ``treedef`` repr under ``"treedef"``; the port writes its own
description of the structure there (:func:`repro_torch.tree.describe`);
neither restore reads it.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from .. import tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:     # npz has no bf16: store bits
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(state) -> dict[str, np.ndarray]:
    return {tree.path_key(path): _host(leaf)
            for path, leaf in tree.flatten(state)}


def save_checkpoint(ckpt_dir: str, step: int, state: dict,
                    keep_last: int = 3) -> str:
    """state: a tree of tensors (params, optimizer state, ...)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "version": 1,
        "step": step,
        "keys": sorted(arrays),
        "treedef": tree.describe(state),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def _tensor(arr: np.ndarray, like: torch.Tensor,
            device: torch.device) -> torch.Tensor:
    if arr.dtype == np.uint16 and like.dtype == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(device)


def restore_checkpoint(ckpt_dir: str, like: dict, step: int | None = None,
                       device=None) -> tuple[int, dict]:
    """Restore into the structure, dtypes and shapes of ``like`` (the
    latest step by default); each leaf on ``device``, or on the device of
    ``like``'s leaf. Raises ``KeyError`` for a missing leaf and
    ``ValueError`` for a shape that differs."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    out = []
    for path, leaf in tree.flatten(like):
        key = tree.path_key(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        out.append(_tensor(arr, leaf, torch.device(device) if device
                           is not None else leaf.device))
    return step, tree.unflatten(like, out)
