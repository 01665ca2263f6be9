"""The plan and index arithmetic of the ``embedding_bag`` kernel
(``csrc/sparse_kernels.cu``) emulated on the CPU.

The kernel cannot run here, so its loops are emulated as they run, from
the plan the launcher takes (``embedding_bag.bag_plan``): blocks of the
persistent grid walk chunks of bags by the grid's stride, group ``tid //
lanes`` of a block takes bags ``group, group + groups, ...`` of a chunk,
and lane ``tid % lanes`` of the group columns ``sub * vec + k * lanes *
vec``, ``vec`` at a time. Every (bag, column) must be written exactly
once, and the in-order float32 sums that land there must equal the plain
version (exactly on integer-valued tables, within ``chip_smoke.sum_err``'s
bound otherwise). The ring's copy of a chunk's ids and mask is split as
the kernel splits it: a 16-byte-aligned middle for the bulk copy, plain
words at either end, inside its slot."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.embedding_bag import (BAG_STAGES,  # noqa: E402
                                               BAG_THREADS, RING_SMEM,
                                               bag_plan, ring_slot_bytes)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def emulate(table, ids, mask, combiner, plan):
    """The kernel's output, and how often each (bag, column) was written,
    from the plan's cut of the work."""
    n_bags, nnz = ids.shape
    D = table.shape[1]
    tab = table.float().numpy()
    ids, mask = ids.numpy(), mask.numpy().astype(np.float32)
    vec, lanes, groups = plan.vec, plan.lanes, plan.groups
    assert groups == BAG_THREADS // lanes
    out = np.zeros((n_bags, D), np.float32)
    cover = np.zeros((n_bags, D), np.int64)
    tid = np.arange(BAG_THREADS)
    group, sub = tid // lanes, tid % lanes
    for blk in range(plan.blocks):
        for c in range(blk, plan.n_chunks, plan.blocks):
            b0 = c * plan.chunk
            nb = min(plan.chunk, n_bags - b0)
            for k in range(-(-nb // groups)):
                j = group + k * groups
                for p in range(-(-D // (lanes * vec))):
                    c0 = sub * vec + p * lanes * vec
                    live = (j < nb) & (c0 < D)
                    bag, col = b0 + j[live], c0[live]
                    assert (col + vec <= D).all()
                    cols = col[:, None] + np.arange(vec)
                    acc = np.zeros(cols.shape, np.float32)
                    cnt = np.zeros(bag.shape, np.float32)
                    for z in range(nnz):
                        m = mask[bag, z]
                        row = tab[ids[bag, z][:, None], cols]
                        acc = (acc + row * m[:, None]).astype(np.float32)
                        cnt = (cnt + m).astype(np.float32)
                    if combiner == "mean":
                        acc = acc / np.maximum(cnt, np.float32(1))[:, None]
                    out[bag[:, None], cols] = acc
                    np.add.at(cover, (bag[:, None], cols), 1)
    return torch.from_numpy(out).to(table.dtype), cover


@pytest.mark.parametrize("D", [1, 7, 16, 32, 33, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nnz", [1, 4, 33])
def test_plan_covers_every_bag_and_column_once(D, dtype, nnz):
    """Bag counts off a chunk and off the bags a warp holds, and a single
    bag, with the table on and off 16 bytes: each (bag, column) written
    once, with the plain version's value."""
    smoke = _smoke()
    rng = np.random.default_rng(D * 100 + nnz)
    elem = 4 if dtype == "float32" else 2
    for aligned in (True, False):
        probe = bag_plan(1000, nnz, D, elem, aligned)
        per16 = 16 // elem
        assert probe.vec == (per16 if aligned and D % per16 == 0 else 1)
        assert probe.lanes & (probe.lanes - 1) == 0 and probe.lanes <= 32
        assert probe.lanes * probe.vec >= min(D, 32 * probe.vec)
        for n_bags in (1, probe.chunk + probe.groups // 2 + 1,
                       2 * probe.chunk - 1):
            plan = bag_plan(n_bags, nnz, D, elem, aligned)
            V = 50
            ids = torch.from_numpy(rng.integers(0, V, (n_bags, nnz))
                                   .astype(np.int32))
            mask = torch.from_numpy(rng.choice(
                np.asarray([0.0, 0.5, 1.0, 2.0], np.float32),
                (n_bags, nnz)))
            table = torch.from_numpy(rng.normal(size=(V, D))
                                     .astype(np.float32)).to(DTYPES[dtype])
            itable = torch.from_numpy(rng.integers(-8, 9, (V, D))
                                      .astype(np.float32)).to(DTYPES[dtype])
            for combiner in ("mean", "sum"):
                got, cover = emulate(itable, ids, mask, combiner, plan)
                assert (cover == 1).all()
                want = ref.embedding_bag_reference(
                    itable, ids[:, None], mask[:, None], combiner)[:, 0]
                assert torch.equal(got, want)
                got, _ = emulate(table, ids, mask, combiner, plan)
                want = ref.embedding_bag_reference(
                    table, ids[:, None], mask[:, None], combiner)[:, 0]
                bound = smoke.bag_bound(table, ids[:, None], mask[:, None],
                                        combiner)[:, 0]
                assert smoke.sum_err(got, want, bound)[1] <= 1.0


@pytest.mark.parametrize("nnz", [1, 4, 33, 37, 511, 600])
@pytest.mark.parametrize("D,elem", [(32, 4), (1, 4), (256, 2), (7, 2)])
def test_ring_fits_and_its_copies_split_at_16_bytes(nnz, D, elem):
    """A ring plan's slots fit RING_SMEM and start each chunk's ids on 16
    bytes; NNZ too long for it reads ids directly. For every start
    offset within 16 bytes and every chunk (the last one short), the
    kernel's split of the copy covers the chunk's bytes once, the bulk
    part is 16-byte aligned at both ends and in size, and everything
    lands inside the slot."""
    plan = bag_plan(10_000, nnz, D, elem, aligned=True)
    slot = ring_slot_bytes(plan.chunk, nnz)
    if plan.ring:
        assert plan.chunk % 4 == 0
        assert plan.smem == 2 * BAG_STAGES * slot + 8 * BAG_STAGES
        assert plan.smem <= RING_SMEM and slot % 16 == 0
    else:
        assert nnz > 500 and plan.smem == 0 and plan.chunk == plan.groups
    for base in (0, 4, 8, 12):
        for c in range(plan.n_chunks):
            b0 = c * plan.chunk
            nb = min(plan.chunk, 10_000 - b0)
            nbytes = nb * nnz * 4
            a = base + b0 * nnz * 4              # the chunk's first byte
            off = a % 16
            head = min(nbytes, (16 - off) % 16)
            body = (nbytes - head) // 16 * 16
            tail = nbytes - head - body
            assert head % 4 == 0 and tail % 4 == 0 and tail < 16
            if body:
                assert (a + head) % 16 == 0 and (off + head) % 16 == 0
            assert off + nbytes <= slot or not plan.ring
            if plan.ring and base == 0:
                assert off == 0 and tail == 0 or c == plan.n_chunks - 1


def test_plan_at_the_serving_shape():
    """wide-deep's serve_bulk: 262,144 x 40 bags of 4 ids, D = 32
    float32: 8 lanes a row (4 bags a warp), chunks of 128 bags in a ring
    of 3 x 2 KB of ids and mask, 4 blocks on each of 132 SMs."""
    plan = bag_plan(262_144 * 40, 4, 32, 4, aligned=True)
    assert plan == (4, 8, 32, 128, 81_920, 528, True,
                    2 * 3 * 2064 + 24)
    assert bag_plan(262_144 * 40, 4, 32, 2, aligned=True)[:2] == (8, 4)
    with pytest.raises(ValueError):
        bag_plan(10, 4, 0, 4, True)
