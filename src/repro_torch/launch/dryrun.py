"""Dry run of every (arch x shape) cell on the ``meta`` device (port of
``repro/launch/dryrun.py``).

Each cell's step (``configs.registry.build_cell``) runs once on meta
tensors: every operation computes shapes and dtypes and allocates no
storage, and each kernel wrapper's meta branch returns its outputs and
reports the kernel's operation count (``kernels.meta_ops``). Per cell it
records:

  - ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
    matrix products (forward and backward) plus the kernels' meta tallies
    (``flops_by`` splits them); a decode kernel counts the whole cache,
    since the lengths are data;
  - ``argument_bytes``: the meta arguments' bytes (params, AdamW state,
    batch, cache, tokens, ``pos``);
  - ``peak_bytes``: the arguments plus the most bytes of new storages
    alive at once (:class:`PeakMemory`: each new storage's bytes added
    when an operation returns it, dropped when it is freed, so a
    checkpoint's recompute counts), ``output_bytes`` the new storages the
    step returns, ``temp_bytes`` the rest of the peak;
  - GNN cells of more than ``models.gnn.EDGE_CHUNK`` edges: the chunks
    are cut uniformly (``"chunk_plan": "uniform"``), as the destination
    runs are data.

Where the reference's numbers come from XLA (``memory_analysis``,
``cost_analysis``), these come from the eager operations themselves. Nor
does it need the reference's single-layer probe: XLA counts a scan body
once, eager counting sees every layer.

Meshes (``--mesh``): ``single`` is one device (``mesh_shape`` [1, 1]),
where the reference's ``single`` is 16 x 16; ``16x16`` (``("data",
"model")``) and ``2x16x16`` (``("pod", "data", "model")``) are the
reference's production meshes (its ``single`` and ``multi``). On those
the cell is built on a :class:`~repro_torch.launch.mesh.MetaMesh` and
rank 0's pieces of its arguments (``convert.local_shard`` by the cell's
``in_specs``) run through the mesh routes: every byte count is per rank,
and ``collectives`` tallies the bytes and ops of each kind of collective
(``all-gather``, ``reduce-scatter``, ``all-reduce``: the output bytes of
each, as the reference's ``collective_bytes`` reads them off the
post-SPMD HLO). It is shape arithmetic on the host; no device is
involved.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16
Results go to artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json; a
failing cell is a record with ``ok: false`` and the exit code is 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .. import tree
from ..configs.registry import (all_cells, build_cell, gnn_cell_config,
                                get_spec, skipped_cells)
from ..convert import local_shard
from ..kernels import meta_ops, reset_meta_ops
from ..models import gnn
from .collectives import collective_counts, reset_collective_counts
from .mesh import MetaMesh, production_shape

MESH_SHAPES = {"single": [1, 1], "16x16": [16, 16], "2x16x16": [2, 16, 16]}


def meta_mesh(mesh_kind: str) -> MetaMesh | None:
    """Rank 0 of ``mesh_kind``'s mesh, None for ``single``."""
    if mesh_kind == "single":
        return None
    shape, axes = production_shape(multi_pod=mesh_kind == "2x16x16")
    return MetaMesh(shape, axes)


def rank_cell(cell, mesh):
    """``cell`` with rank 0's pieces of its arguments on ``mesh``."""
    return dataclasses.replace(cell, abstract_args=tuple(
        local_shard(a, specs, mesh)
        for a, specs in zip(cell.abstract_args, cell.in_specs)))


class PeakMemory(TorchDispatchMode):
    """Bytes of the storages operations create, while they live: each new
    storage's bytes are added when an operation first returns it (or
    grows it) and dropped when it is freed (a finalizer on its storage
    object, which lives as long as the storage). Storages that existed
    before (``known``, the arguments') are not counted. ``peak``: the most
    bytes alive at once."""

    def __init__(self, known=()):
        super().__init__()
        self.known = {id(s) for s in known}
        self.sizes: dict[int, int] = {}
        self.now = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.now -= self.sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.known:
                continue
            nbytes = st.nbytes()
            old = self.sizes.get(key)
            if old is None:
                weakref.finalize(st, self._free, key)
                self.sizes[key] = old = 0
            if nbytes > old:
                self.sizes[key] = nbytes
                self.now += nbytes - old
                self.peak = max(self.peak, self.now)
        return out


def storages(obj) -> list:
    """The distinct storages of the tensors of a tree, in order."""
    seen, out = set(), []
    for t in tree.leaves(obj):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                out.append(st)
    return out


def analyze(cell) -> dict:
    """One run of ``cell.fn`` on its meta arguments: flops (matrix
    products and the kernels' tallies), argument, output, temporary and
    peak bytes."""
    args = cell.abstract_args
    known = storages(args)
    arg_bytes = sum(t.nbytes for t in tree.leaves(args)
                    if isinstance(t, torch.Tensor))
    reset_meta_ops()
    reset_collective_counts()
    mem = PeakMemory(known)
    with FlopCounterMode(display=False) as flops, mem:
        out = cell.fn(*args)
    kernels = meta_ops()
    coll = collective_counts()
    known_ids = {id(s) for s in known}
    out_bytes = sum(s.nbytes() for s in storages(out)
                    if id(s) not in known_ids)
    matmul = int(flops.get_total_flops())
    return {
        "flops": float(matmul + sum(kernels.values())),
        "flops_by": {"matmul": matmul, **kernels},
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(out_bytes),
        "temp_bytes": int(mem.peak - out_bytes),
        "peak_bytes": int(arg_bytes + mem.peak),
        "collectives": coll,
    }


def _chunk_plan(spec, shape: str) -> str | None:
    if spec.family != "gnn":
        return None
    _, sh = gnn_cell_config(spec.config, shape)
    E = (sh["n_graphs"] * sh["edges_per"] if sh["kind"] == "molecule"
         else sh["n_edges"])
    return "uniform" if E > gnn.EDGE_CHUNK else None


def run_cell(arch: str, shape: str, mesh_kind: str = "single",
             out_dir: str | None = None, skip_existing: bool = True,
             log=print) -> dict:
    """The record of one cell, written to ``out_dir`` when given (and read
    from there instead when ``skip_existing`` finds it)."""
    tag = f"{arch}__{shape}__{mesh_kind}".replace("/", "_")
    path = os.path.join(out_dir, f"{tag}.json") if out_dir else None
    if path and skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    record: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                    "mesh_shape": MESH_SHAPES[mesh_kind]}
    t0 = time.time()
    try:
        spec = get_spec(arch)
        if shape not in spec.shapes:
            raise KeyError(f"{arch} has no cell {shape!r}; one of "
                           f"{list(spec.shapes)}")
        mesh = meta_mesh(mesh_kind)
        cell = build_cell(spec, shape, mesh)
        if mesh is not None:
            cell = rank_cell(cell, mesh)
        record.update(analyze(cell))
        record["description"] = cell.description
        record["cost_multiplier"] = cell.cost_multiplier
        plan = _chunk_plan(spec, shape)
        if plan:
            record["chunk_plan"] = plan
        record["ok"] = True
    except Exception as e:  # noqa: BLE001 — record failures as data
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-3000:]
    record["seconds"] = round(time.time() - t0, 2)
    if path:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    status = "OK " if record["ok"] else "FAIL"
    log(f"[dryrun] {status} {tag} ({record['seconds']}s)")
    if not record["ok"]:
        log(f"    {record['error']}")
    return record


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=sorted(MESH_SHAPES), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a, s in all_cells():
            print(f"{a:26s} {s}")
        for a, s, why in skipped_cells():
            print(f"{a:26s} {s}  SKIPPED: {why}")
        return
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, --all or --list")

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    n_fail = 0
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.mesh, args.out,
                       skip_existing=not args.force)
        n_fail += 0 if rec.get("ok") else 1
    print(f"[dryrun] done, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
