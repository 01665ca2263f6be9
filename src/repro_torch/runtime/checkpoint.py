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

On a mesh a checkpoint stays mesh-agnostic, as the reference's is:
``save_checkpoint(..., specs=, mesh=)`` all-gathers each rank's pieces
into whole leaves (``convert.gather_shards``) and rank 0 of the default
group writes them; ``restore_checkpoint(..., specs=, mesh=)`` cuts each
rank's pieces out of the whole leaves (``convert.local_shard``), on any
mesh: the counterpart of the reference's ``shardings=`` and its elastic
re-mesh path. ``specs`` is keyed by the state's paths (``"params/..."``,
``"opt/m/..."``).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from .. import tree
from ..convert import gather_shards, local_shard


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
                    keep_last: int = 3, specs: dict | None = None,
                    mesh=None) -> str:
    """state: a tree of tensors (params, optimizer state, ...). On a mesh
    (``specs``, the layouts of ``state``'s leaves, and ``mesh``) every rank
    calls it with its pieces: they are gathered into whole leaves and
    rank 0 writes them, the others wait for it."""
    if mesh is not None:
        with torch.no_grad():
            state = gather_shards(state, specs or {}, mesh)
        if dist.get_rank() != 0:
            dist.barrier()
            return os.path.join(ckpt_dir, f"step_{step:08d}")
        try:
            return save_checkpoint(ckpt_dir, step, state, keep_last)
        finally:
            dist.barrier()
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
                       device=None, specs: dict | None = None,
                       mesh=None) -> tuple[int, dict]:
    """Restore into the structure, dtypes and shapes of ``like`` (the
    latest step by default); each leaf on ``device``, or on the device of
    ``like``'s leaf. On a mesh (``specs`` and ``mesh``) ``like`` holds this
    rank's pieces and each is cut out of the whole leaf
    (``convert.local_shard``). Raises ``KeyError`` for a missing leaf and
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
        dev = torch.device(device) if device is not None else leaf.device
        if mesh is not None and (specs or {}).get(key):
            piece = local_shard({"a": _tensor(arr, leaf, "cpu")},
                                {"a": specs[key]}, mesh)["a"]
            if tuple(piece.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: piece {tuple(piece.shape)} of "
                                 f"{arr.shape} != {tuple(leaf.shape)}")
            out.append(piece.to(dev))
            continue
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        out.append(_tensor(arr, leaf, dev))
    return step, tree.unflatten(like, out)
