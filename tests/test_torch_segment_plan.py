"""The plan and index arithmetic of the ``segment_sum_sorted`` kernel
(``csrc/sparse_kernels.cu``) emulated in numpy on the CPU.

The kernel cannot run here, so its loops are emulated as they run, from
the plan the launcher takes (``segment_mp.segment_plan``): block ``b`` of
the persistent grid owns edges ``[b * per, min((b + 1) * per, E))`` and
walks them in chunks of ``chunk`` edges; a chunk's bytes are split as the
ring's producer splits them (a bulk copy of the multiple of 16 bytes, plain
loads of the rest) or as the scalar route's threads copy them; thread
(sub-span s, column c) sums the runs of equal dst in its ``sub`` edges and
flushes those that start and end there; a segmented scan over the
sub-spans of each column joins the runs cut by their ends, carries the run
open at a chunk's end into the next chunk, and flushes each run once: by a
store, or atomically where it is the range's first or last run. The sums
must equal ``np.add.at``'s exactly on integer-valued messages, every
(node, column) must take either exactly one store and no atomic or atomics
alone, and the launcher's own checks (``launch_segment``) must accept the
plan."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels.segment_mp import (BLOCK_SMEM_MAX,  # noqa: E402
                                            SEG_MAX_STAGES, SEG_THREADS,
                                            seg_ranges, seg_smem_bytes,
                                            segment_plan)

MAX_STAGE_TX = (1 << 20) - 1     # bytes an mbarrier phase can count


def launcher_accepts(plan, E, D, elem_bytes, aligned) -> bool:
    """The plan checks of ``launch_segment`` in csrc/sparse_kernels.cu."""
    align = 16 // elem_bytes
    if E == 0:
        return True                  # nothing launches
    return (plan.cols == min(D, SEG_THREADS) and plan.n_sub >= 1
            and plan.sub >= 1 and plan.n_sub * plan.cols <= SEG_THREADS
            and plan.n_sub * plan.sub == plan.chunk
            and plan.chunk % align == 0 and plan.per >= 1
            and plan.per % align == 0 and plan.blocks >= 1
            and plan.blocks * plan.per >= E
            and (plan.blocks - 1) * plan.per < E
            and ((2 <= plan.stages <= SEG_MAX_STAGES and aligned)
                 if plan.ring else plan.stages == 1)
            and plan.chunk * D * elem_bytes + 4 * plan.chunk <= MAX_STAGE_TX
            and plan.smem == seg_smem_bytes(plan.stages, plan.chunk, D,
                                            elem_bytes)
            and plan.smem <= BLOCK_SMEM_MAX)


def thread_copy_spans(at: int, nbytes: int) -> list[tuple[int, int]]:
    """(offset, width) of every load of the scalar route's copy of
    ``nbytes`` from an address ``at`` (mod 16): 16-byte loads from an
    address on 16, 4-byte ones from one on 4, the rest 2 bytes a load."""
    width = 16 if at % 16 == 0 else 4 if at % 4 == 0 else 2
    done = nbytes // width * width
    spans = [(k, width) for k in range(0, done, width)]
    return spans + [(k, 2) for k in range(done, nbytes, 2)]


def check_copies(plan, E, D, elem_bytes, msg_at, dst_at, e0, n):
    """One chunk's copies: the ring's bulk part starts on 16 bytes and is a
    multiple of 16, only the graph's last chunk leaves an end for plain
    loads, and both fit their slots; the scalar route's loads cover the
    bytes once with loads no wider than their alignment."""
    mbytes, dbytes = n * D * elem_bytes, 4 * n
    assert mbytes <= -(-plan.chunk * D * elem_bytes // 16) * 16
    assert dbytes <= -(-4 * plan.chunk // 16) * 16
    for base, nbytes in ((msg_at + e0 * D * elem_bytes, mbytes),
                         (dst_at + 4 * e0, dbytes)):
        if plan.ring:
            assert base % 16 == 0
            body = nbytes & ~15
            assert body % 16 == 0 and nbytes - body < 16
            assert nbytes == body or e0 + n == E
            assert (nbytes - body) % 2 == 0
        else:
            cover = np.zeros(nbytes, np.int64)
            for k, w in thread_copy_spans(base, nbytes):
                assert (base + k) % w == 0 and k + w <= nbytes
                cover[k:k + w] += 1
            assert (cover == 1).all()


def emulate(msg, dst, n_nodes, plan, elem_bytes, msg_at=0, dst_at=0):
    """The kernel's float32 output, and per (node, column) the number of
    stores and of atomics that reached it."""
    msg = np.asarray(msg, np.float32)
    dst = np.asarray(dst, np.int64)
    E, D = msg.shape
    out = np.zeros((n_nodes, D), np.float32)
    stores = np.zeros((n_nodes, D), np.int64)
    atomics = np.zeros((n_nodes, D), np.int64)
    if E == 0 or n_nodes == 0:
        return out, stores, atomics
    per, chunk, sub, n_sub, cols = (plan.per, plan.chunk, plan.sub,
                                    plan.n_sub, plan.cols)
    for b in range(plan.blocks):
        e_begin, e_end = b * per, min((b + 1) * per, E)
        if e_begin >= e_end:
            continue
        first_node, last_node = dst[e_begin], dst[e_end - 1]

        def flush(node, c0, sums):
            if not 0 <= node < n_nodes:
                return
            at = slice(c0, c0 + len(sums))
            if node in (first_node, last_node):
                out[node, at] += sums
                atomics[node, at] += 1
            else:
                out[node, at] = sums
                stores[node, at] += 1

        carry = np.zeros(D, np.float32)
        carry_node = 0
        n_chunks = -(-(e_end - e_begin) // chunk)
        for k in range(n_chunks):
            e0 = e_begin + k * chunk
            n = min(chunk, e_end - e0)
            check_copies(plan, E, D, elem_bytes, msg_at, dst_at, e0, n)
            cd, cm = dst[e0:e0 + n], msg[e0:e0 + n]
            have_carry, range_ends = k > 0, k + 1 == n_chunks
            for c0 in range(0, D, cols):
                w = min(cols, D - c0)
                tile = cm[:, c0:c0 + w]
                head = np.zeros((n_sub, w), np.float32)
                tail = np.zeros((n_sub, w), np.float32)
                info = []
                # 1. each sub-span's runs
                for s in range(n_sub):
                    j0, j1 = s * sub, min(s * sub + sub, n)
                    if j0 >= j1:
                        info.append(None)
                        continue
                    d = cd[j0:j1]
                    starts = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
                    sums = np.add.reduceat(tile[j0:j1], starts, axis=0,
                                           dtype=np.float32)
                    nodes = d[starts]
                    cont = (cd[j0 - 1] == d[0]) if j0 > 0 else \
                        (have_carry and carry_node == d[0])
                    whole = len(starts) == 1
                    if not whole and not cont:
                        flush(nodes[0], c0, sums[0])
                    for r in range(1, len(starts) - 1):
                        flush(nodes[r], c0, sums[r])
                    head[s], tail[s] = sums[0], sums[-1]
                    info.append((j0, j1, nodes[0], nodes[-1], cont, whole))
                # 2. the scan: y_s = tail_s + pass_s * y_{s-1}, the chunk's
                # carry-in folded into the first sub-span
                y = np.zeros((n_sub, w), np.float32)
                cin0 = carry[c0:c0 + w] if have_carry else np.zeros(w)
                for s, it in enumerate(info):
                    if it is None:
                        continue
                    _, _, _, _, cont, whole = it
                    prev = cin0 if s == 0 else y[s - 1]
                    y[s] = tail[s] + prev if (whole and cont) else tail[s]
                # 3. flushes
                for s, it in enumerate(info):
                    if it is None:
                        continue
                    j0, j1, f, lnode, cont, whole = it
                    cin = cin0 if s == 0 else y[s - 1]
                    if s == 0 and have_carry and not cont:
                        flush(carry_node, c0, cin)
                    if cont and not whole:
                        flush(f, c0, (cin + head[s]).astype(np.float32))
                    if j1 < n:
                        if cd[j1] != lnode:
                            flush(lnode, c0, y[s])
                    elif range_ends:
                        flush(lnode, c0, y[s])
                    else:
                        carry[c0:c0 + w] = y[s]
            carry_node = cd[n - 1]
    return out, stores, atomics


def replan(plan, E, D, elem_bytes, grid=None, stages=None):
    """The plan with another grid (ranges of many chunks at small E) or
    another number of ring stages, as a timing variant takes it."""
    if stages is not None:
        plan = plan._replace(stages=stages, smem=seg_smem_bytes(
            stages, plan.chunk, D, elem_bytes))
    if grid is not None:
        per, blocks = seg_ranges(E, elem_bytes, grid)
        plan = plan._replace(per=per, blocks=blocks)
    return plan


def _check(msg, dst, n_nodes, elem_bytes=4, aligned=True, msg_at=0,
           dst_at=0, grid=None, stages=None):
    E, D = msg.shape
    plan = replan(segment_plan(E, D, elem_bytes, aligned), E, D, elem_bytes,
                  grid, stages)
    assert launcher_accepts(plan, E, D, elem_bytes, aligned)
    # ranges cover every edge once and start on 16 bytes' rows
    cover = np.zeros(E, np.int64)
    for b in range(plan.blocks):
        assert (b * plan.per) % (16 // elem_bytes) == 0
        cover[b * plan.per:min((b + 1) * plan.per, E)] += 1
    assert (cover == 1).all()
    got, stores, atomics = emulate(msg, dst, n_nodes, plan, elem_bytes,
                                   msg_at, dst_at)
    want = np.zeros((n_nodes, D), np.float64)
    keep = (dst >= 0) & (dst < n_nodes)
    np.add.at(want, dst[keep], msg[keep])
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert ((stores == 1) & (atomics == 0) | (stores == 0)).all()
    assert stores.max(initial=0) <= 1
    return plan, atomics


def _graph(rng, E, n_nodes, D, lo=0, hi=None, hub=None, hub_share=0.0):
    dst = rng.integers(lo, n_nodes if hi is None else hi, E)
    if hub is not None:
        dst[rng.random(E) < hub_share] = hub
    dst = np.sort(dst)
    msg = rng.integers(-2, 3, (E, D)).astype(np.float32)
    return msg, dst


@pytest.mark.parametrize("D", [1, 7, 16, 300])
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_plan_sums_every_edge_once(D, elem_bytes):
    """Integer-valued messages on a power-law-like graph: the default
    grid (ranges shorter than a chunk) and a grid of 3 blocks (ranges of
    many chunks, a run carried across each chunk's end)."""
    rng = np.random.default_rng(D * 10 + elem_bytes)
    E = {1: 40_000, 7: 20_000, 16: 6_000, 300: 600}[D]
    msg, dst = _graph(rng, E, E // 20, D, hub=3, hub_share=0.1)
    for grid in (None, 3):
        plan, _ = _check(msg, dst, E // 20, elem_bytes, grid=grid)
        if grid == 3:
            assert plan.blocks == 3 and plan.per > 2 * plan.chunk


@pytest.mark.parametrize("E", [0, 1, 2, 3])
@pytest.mark.parametrize("D", [1, 7, 16, 300])
def test_plan_tiny_graphs(E, D):
    rng = np.random.default_rng(E + D)
    for n_nodes in (0, 1, 5):
        msg, dst = _graph(rng, E, max(n_nodes, 1), D)
        for elem_bytes in (4, 2):
            _check(msg, dst, n_nodes, elem_bytes)


@pytest.mark.parametrize("D", [1, 16])
def test_plan_hub_across_many_ranges(D):
    """A run of 60% of the edges crosses many ranges, and whole ranges
    lie inside it: their first run is their last, added once a column by
    an atomic; every other node's run is stored."""
    rng = np.random.default_rng(7)
    E = 30_000
    msg, dst = _graph(rng, E, 500, D, hub=250, hub_share=0.6)
    for grid in (None, 40):
        plan, atomics = _check(msg, dst, 500, grid=grid)
        inside = sum(1 for b in range(plan.blocks)
                     if dst[b * plan.per] == 250
                     and dst[min((b + 1) * plan.per, E) - 1] == 250)
        assert inside >= 3
        assert (atomics[250] <= plan.blocks).all()


@pytest.mark.parametrize("D", [1, 7, 16])
def test_plan_drops_dst_outside_the_nodes(D):
    rng = np.random.default_rng(11)
    msg, dst = _graph(rng, 9_000, 300, D, lo=-40, hi=340)
    for grid in (None, 2):
        _check(msg, dst, 300, grid=grid)


@pytest.mark.parametrize("elem_bytes,msg_at,dst_at",
                         [(4, 4, 0), (4, 12, 8), (2, 2, 0), (2, 6, 4),
                          (4, 0, 4)])
def test_plan_misaligned_start_takes_the_scalar_route(elem_bytes, msg_at,
                                                      dst_at):
    """msg or dst off 16 bytes: the plan takes the scalar route, whose
    threads' loads cover each chunk's bytes once."""
    rng = np.random.default_rng(13)
    for D in (1, 7, 16):
        msg, dst = _graph(rng, 5_000, 200, D)
        plan, _ = _check(msg, dst, 200, elem_bytes, aligned=False,
                         msg_at=msg_at, dst_at=dst_at, grid=3)
        assert not plan.ring and plan.stages == 1


def test_plan_serving_shapes_fit_and_fill_the_card():
    """The GCN forward's three launches on ogb_products' size: a resident
    grid of 3 blocks on each of 132 SMs, 2 ring stages, chunks of about
    32 KB and ranges that start on 16 bytes."""
    E = 61_841_859
    for D in (16, 7, 1):
        plan = segment_plan(E, D, 4, True)
        assert launcher_accepts(plan, E, D, 4, True)
        assert plan.ring and plan.stages == 2 and plan.blocks == 396
        assert 24_000 <= plan.chunk * (4 * D + 4) <= 36_000
        assert plan.per % 4 == 0 and 3 * (plan.smem + 1024) <= 228 * 1024
    for D, elem_bytes in ((4096, 4), (4096, 2)):
        plan = segment_plan(E, D, elem_bytes, True)
        assert launcher_accepts(plan, E, D, elem_bytes, True)
    with pytest.raises(ValueError):
        segment_plan(E, 8192, 4, True)


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_plan_other_ring_stages(stages):
    """The ring's stage count does not change the sums (the timing
    variants run 2 to 4)."""
    rng = np.random.default_rng(stages)
    msg, dst = _graph(rng, 4_000, 100, 16)
    plan, _ = _check(msg, dst, 100, stages=stages, grid=2)
    assert plan.stages == stages
