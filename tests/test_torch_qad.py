"""The port's R-QAD (``repro_torch.core.qad``, the plain torch version of
the ``qad_solve`` CUDA kernel) against the reference's ``repro.core.qad``
on the instances and seeds of ``tests/test_scheduler.py``, and the port's
``branch_and_bound(bound="rqad", device="cpu")`` against the reference's.

Both solve in float32 (the reference runs with x64 off), but not in the
same order: XLA fuses multiply-adds and picks its own reduction order, so
the two agree within float32 rounding, not bit for bit. Tolerances: D
within 1e-5 absolute, f and lb within 1e-5 * max(1, |f|) (the relaxation
is flat in places, so float32 rounding alone moves D by about that much).
A numpy emulation of each route of the kernel (the generic route: rows in
threads, the warp-shuffle column sums, the pinned rows' sums taken once;
the register route: one lane a row with K padded, xor-shuffle trees, the
clipped sums as trees and the bisection's early exit) is held to the plain
version within the same tolerances, so the kernel's order is pinned here;
the early exit is held to the 40-step bisection bit for bit. The kernel
itself runs only on the card (``cuda`` marker)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bnb as r_bnb  # noqa: E402
from repro.core import qad as r_qad  # noqa: E402
from repro.core.cost import QueryTasks, SystemParams  # noqa: E402

from repro_torch.convert import system_params_from_reference  # noqa: E402
from repro_torch.core import bnb as t_bnb  # noqa: E402
from repro_torch.core import cost as t_cost  # noqa: E402
from repro_torch.core import qad as t_qad  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.kernels import qad_solve as t_kern  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

D_TOL = 1e-5
F_RTOL = 1e-5


def make_instance(N, K, seed=0, exec_prob=0.7):
    """``tests/test_scheduler.py:make_instance``."""
    rng = np.random.default_rng(seed)
    params = SystemParams.synthetic(N, K, seed=seed)
    c = rng.uniform(1e7, 5e8, N)
    w = rng.uniform(1e5, 5e7, N)
    e = (rng.random((N, K)) < exec_prob).astype(float) * params.assoc
    return QueryTasks(c=c, w=w, e=e), params


def port_instance(tasks, params):
    return (t_cost.QueryTasks(c=tasks.c, w=tasks.w, e=tasks.e),
            system_params_from_reference(params))


def qad_arrays(N, K, seed):
    tasks, params = make_instance(N, K, seed=seed)
    e = tasks.e * params.assoc
    A, b, const = r_qad.build_qad_arrays(tasks.c, tasks.w, e, params.r_edge,
                                         params.r_cloud)
    return A, b, params.F, e


def frontier(e, depth, seed):
    """Children of one B&B expansion at ``depth``: rows before it pinned to
    a seeded prefix, row ``depth`` to each of cloud and its edges."""
    rng = np.random.default_rng(seed)
    N, K = e.shape
    fm = np.zeros(N)
    fm[:depth + 1] = 1.0
    prefix = np.zeros((N, K))
    for n in range(depth):
        feas = np.flatnonzero(e[n] > 0)
        ch = rng.integers(-1, len(feas))
        if ch >= 0:
            prefix[n, feas[ch]] = 1.0
    kids = []
    for ch in [-1] + list(np.flatnonzero(e[depth] > 0)):
        D = prefix.copy()
        if ch >= 0:
            D[depth, ch] = 1.0
        kids.append(D)
    return fm, np.stack(kids)


def assert_close(got, want, what):
    gD, gf, gl = (np.asarray(x, dtype=np.float64) for x in got)
    wD, wf, wl = (np.asarray(x, dtype=np.float64) for x in want)
    scale = np.maximum(1.0, np.abs(wf))
    assert np.abs(gD - wD).max() <= D_TOL, (what, np.abs(gD - wD).max())
    assert (np.abs(gf - wf) <= F_RTOL * scale).all(), (what, gf, wf)
    assert (np.abs(gl - wl) <= F_RTOL * scale).all(), (what, gl, wl)


# (N, K, seed, frontier depth, iters): test_scheduler's R-QAD instances,
# then frontiers at the paper's scale (test_scheduler's B&B seeds)
CASES = [(5, 2, 3, None, 600), (8, 3, 4, 2, 300), (20, 4, 1, 3, 200),
         (20, 4, 12, 6, 200), (20, 4, 1, 11, 300)]


@pytest.mark.parametrize("N,K,seed,depth,iters", CASES)
def test_plain_solve_matches_reference(N, K, seed, depth, iters):
    A, b, F, e = qad_arrays(N, K, seed)
    if depth is None:
        fm, Ds = np.zeros(N), np.zeros((1, N, K))
    else:
        fm, Ds = frontier(e, depth, seed)
    want = r_qad.solve_rqad_batch(A, b, F, e, fm, Ds, iters)
    got = t_qad.solve_rqad_batch(A, b, F, e, fm, Ds, iters, device="cpu")
    for x in got:
        assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert tuple(got[0].shape) == Ds.shape and tuple(got[1].shape) == \
        (len(Ds),)
    assert_close([x.numpy() for x in got], want, (N, K, seed))
    one = t_qad.solve_rqad(A, b, F, e, fm, Ds[0], iters, device="cpu")
    assert_close([x.numpy()[None] for x in one],
                 [np.asarray(x)[:1] for x in want], "solve_rqad")


def test_rqad_against_scipy():
    """``test_scheduler.py::test_rqad_against_scipy`` through the port."""
    from scipy.optimize import minimize
    tasks, params = make_instance(5, 2, seed=3)
    e = tasks.e * params.assoc
    A, b, const = t_qad.build_qad_arrays(tasks.c, tasks.w, e, params.r_edge,
                                         params.r_cloud)
    N, K = A.shape
    D_rel, f_val, lb = (x.numpy() for x in t_qad.solve_rqad(
        A, b, params.F, e, np.zeros(N), np.zeros((N, K)), 600,
        device="cpu"))

    def obj(x):
        D = x.reshape(N, K)
        S = (D * A).sum(axis=0)
        return (S ** 2 / params.F).sum() + (D * b).sum()

    cons = [{"type": "ineq",
             "fun": (lambda x, n=n: 1.0 - (x.reshape(N, K)[n] * e[n]).sum())}
            for n in range(N)]
    res = minimize(obj, np.zeros(N * K), bounds=[(0, 1)] * (N * K),
                   constraints=cons, method="SLSQP")
    assert f_val <= res.fun + 1e-6 * abs(res.fun) + 1e-9 or \
        np.isclose(f_val, res.fun, rtol=1e-4)
    assert lb <= f_val + 1e-9
    assert lb <= res.fun + 1e-6 * abs(res.fun)


def test_rqad_feasibility_and_fixed_rows():
    """``test_scheduler.py::test_rqad_feasibility_and_fixed_rows`` through
    the port."""
    tasks, params = make_instance(8, 3, seed=4)
    e = tasks.e * params.assoc
    A, b, const = t_qad.build_qad_arrays(tasks.c, tasks.w, e, params.r_edge,
                                         params.r_cloud)
    fixed_mask = np.zeros(8)
    fixed_mask[:3] = 1
    fixed_D = np.zeros((8, 3))
    feas0 = np.flatnonzero(e[0] > 0)
    if len(feas0):
        fixed_D[0, feas0[0]] = 1.0
    D_rel = t_qad.solve_rqad(A, b, params.F, e, fixed_mask, fixed_D, 300,
                             device="cpu")[0].numpy()
    assert (D_rel >= -1e-9).all() and (D_rel <= 1 + 1e-9).all()
    assert ((D_rel * e).sum(axis=1) <= 1 + 1e-6).all()
    assert np.allclose(D_rel[:3], fixed_D[:3])
    assert np.allclose(D_rel[e == 0], 0.0)


def test_numpy_helpers_match_reference():
    tasks, params = make_instance(12, 3, seed=6)
    e = tasks.e * params.assoc
    cc = tasks.c / 2e9
    for a, b in zip(t_qad.build_qad_arrays(tasks.c, tasks.w, e, params.r_edge,
                                           params.r_cloud, cc),
                    r_qad.build_qad_arrays(tasks.c, tasks.w, e, params.r_edge,
                                           params.r_cloud, cc)):
        assert np.array_equal(a, b)
    cloud = np.array([1.0, 2.0, 3.0])
    free = np.array([0.5, np.inf, 4.0])
    assert t_qad.partial_lb_slack(cloud, free) == \
        r_qad.partial_lb_slack(cloud, free) == 0.5
    D = np.array([[0.6, 0.3], [0.5, 0.5], [0.2, 0.1], [0.0, 0.9]])
    R = t_qad.round_relaxed(D, np.ones_like(D))
    assert np.array_equal(R, r_qad.round_relaxed(D, np.ones_like(D)))
    assert set(np.unique(R)) <= {0.0, 1.0} and (R.sum(axis=1) <= 1).all()
    assert R[0, 0] == 1 and R[3, 1] == 1 and R[2].sum() == 0


def test_wrapper_checks_and_plan():
    A = torch.zeros(4, 2)
    ok = dict(b=torch.zeros(4, 2), F=torch.ones(2), e=torch.ones(4, 2),
              fixed_mask=torch.zeros(4), fixed_Ds=torch.zeros(3, 4, 2))
    assert t_kern.qad_solve(A, iters=5, **ok).shape == (3, 4 * 2 + 2)
    with pytest.raises(TypeError):
        t_kern.qad_solve(A.double(), iters=5, **ok)
    with pytest.raises(ValueError):
        t_kern.qad_solve(A, iters=5, **dict(ok, F=torch.ones(3)))
    assert t_kern.qad_plan(21, 4) == ("register", 4, 32, 0)
    assert t_kern.generic_plan(21, 4) == \
        ("generic", 0, 32, 4 * (5 * 84 + 21 + 12 + 4))
    assert t_kern.qad_plan(2000, 4).threads == 1024
    t_kern.generic_plan(1000, 11)             # 220 KB: fits
    with pytest.raises(ValueError, match="shared memory"):
        t_kern.generic_plan(1000, 12)
    with pytest.raises(ValueError, match="shared memory"):
        t_kern.qad_plan(2000, 12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_qad.solve_rqad_batch(A.numpy(), ok["b"], ok["F"], ok["e"],
                                   ok["fixed_mask"], ok["fixed_Ds"], 5)


# -- the kernel's arithmetic, emulated in numpy -------------------------------

def _f32(x):
    return np.float32(x) if np.ndim(x) == 0 else np.asarray(x, np.float32)


def _warp_tree(v):
    """Lane 0 of ``v += __shfl_down_sync(v, off)``, off = 16, 8, 4, 2, 1."""
    v = v.copy()
    for off in (16, 8, 4, 2, 1):
        v[:32 - off] = v[:32 - off] + v[off:32]
    return v[0]


def _column_sums(X, A, own, base, threads):
    """Each thread's rows in order, the warp tree, the warps in order,
    added to ``base``."""
    N, K = X.shape
    part = np.zeros((threads, K), np.float32)
    for n in range(N):
        if own[n]:
            part[n % threads] = part[n % threads] + X[n] * A[n]
    out = base.copy()
    for w in range(threads // 32):
        out = out + np.array([_warp_tree(part[32 * w:32 * w + 32, k])
                              for k in range(K)], np.float32)
    return out


def _block_sum(vals, threads):
    part = np.zeros(threads, np.float32)
    for n, v in enumerate(vals):
        part[n % threads] = part[n % threads] + v
    s = np.float32(0)
    for w in range(threads // 32):
        s = s + _warp_tree(part[32 * w:32 * w + 32])
    return s


def _project(V, E):
    """project_row on every row: clip-sum and the early exit, else the
    40-step bisection inside the row's thread; scaled by e."""
    X = np.where(E > 0, V, np.float32(0))
    s = np.zeros(len(V), np.float32)
    hi = np.zeros(len(V), np.float32)
    for k in range(V.shape[1]):
        s = s + np.clip(X[:, k], 0, 1)
        hi = np.maximum(hi, X[:, k])
    lo = np.zeros(len(V), np.float32)
    for _ in range(t_ref.QAD_BISECT):
        mid = _f32(0.5) * (lo + hi)
        val = np.zeros(len(V), np.float32)
        for k in range(V.shape[1]):
            val = val + np.clip(X[:, k] - mid, 0, 1)
        gt = val > 1
        lo, hi = np.where(gt, mid, lo), np.where(gt, hi, mid)
    out = np.where((s <= 1)[:, None], np.clip(X, 0, 1),
                   np.clip(X - hi[:, None], 0, 1))
    return (out * E).astype(np.float32)


def emulate_kernel(A, b, F, e, fm, Ds, iters):
    A, b, F, e, fm, Ds = map(_f32, (A, b, F, e, fm, Ds))
    N, K = A.shape
    threads = t_kern.generic_plan(N, K).threads
    free = ~(fm > 0)
    L = np.float32(0)
    for k in range(K):
        s = np.float32(0)
        for n in range(N):
            s = s + A[n, k] * A[n, k]
        L = max(L, s / F[k])
    step = np.float32(1) / (np.float32(2) * L + np.float32(1e-12))
    out = []
    for Dfix in Ds:
        Sfix = _column_sums(Dfix, A, ~free, np.zeros(K, np.float32), threads)
        x = np.zeros((N, K), np.float32)
        x[free] = _project((np.float32(0.5) * e)[free], e[free])
        xp = x.copy()
        for t in range(iters):
            beta = np.float32(t) / (np.float32(t) + np.float32(3))
            y = x + beta * (x - xp)
            xp = x
            S = _column_sums(y, A, free, Sfix, threads)
            g = (np.float32(2) * A * (S / F) + b) * e
            x = np.zeros((N, K), np.float32)
            x[free] = _project((y - step * g)[free], e[free])
        x[free] = _project(x[free], e[free])
        S = _column_sums(x, A, free, Sfix, threads)
        D = np.where(free[:, None], x * e, Dfix)
        g = (np.float32(2) * A * (S / F) + b) * e
        lin = np.where(e > 0, g, np.float32(np.inf)).min(axis=1)
        lin = np.minimum(lin, 0)
        lin = np.where(np.isfinite(lin), lin, 0)
        gx = np.zeros(N, np.float32)
        for k in range(K):
            gx = gx + g[:, k] * x[:, k]
        db = np.zeros(N, np.float32)
        for k in range(K):
            db = db + D[:, k] * b[:, k]
        f = np.float32(0)
        for k in range(K):
            f = f + S[k] * S[k] / F[k]
        f = f + _block_sum(db, threads)
        gap = _block_sum(np.where(free, lin - gx, 0), threads)
        out.append((D, f, f + gap))
    return (np.stack([o[0] for o in out]), np.array([o[1] for o in out]),
            np.array([o[2] for o in out]))


@pytest.mark.parametrize("N,K,seed,depth,iters",
                         [(8, 3, 4, 2, 300), (20, 4, 1, 3, 200),
                          (40, 3, 2, 5, 100)])
def test_kernel_emulation_matches_plain(N, K, seed, depth, iters):
    A, b, F, e = qad_arrays(N, K, seed)
    fm, Ds = frontier(e, depth, seed)
    plain = t_qad.solve_rqad_batch(A, b, F, e, fm, Ds, iters, device="cpu")
    assert_close(emulate_kernel(A, b, F, e, fm, Ds, iters),
                 [x.numpy() for x in plain], (N, K, seed))


# -- the register route's arithmetic, emulated in numpy ----------------------

def _tree(C):
    """``tree_sum`` over the last axis (KMAX): c[k] += c[k + h], h = KMAX/2,
    ..., 1."""
    C = C.copy()
    h = C.shape[-1] // 2
    while h:
        C[..., :h] = C[..., :h] + C[..., h:2 * h]
        h //= 2
    return C[..., 0]


def _xor_sums(P, base):
    """``child_sums``: each warp's xor-shuffle trees over its 32 lanes (P
    [threads, M], one row a lane), then ``base`` (zeros: 0.f) plus the
    warps' sums in warp order."""
    lanes = np.arange(32)
    out = base.copy()
    for w in range(len(P) // 32):
        v = P[32 * w:32 * w + 32].copy()
        for off in (16, 8, 4, 2, 1):
            v = v + v[lanes ^ off]
        assert (v == v[0]).all()                 # every lane: the same bits
        out = out + v[0]
    return out


def project_register(V, E, early_exit=True):
    """``project`` on rows of one warp (V, E [rows, KMAX] float32): the
    clipped values summed as a tree; the bisection two steps a turn, left
    after a turn whose first step changed no row's lo or hi (the warp's
    vote), or after 40 steps. Returns the rows and the steps the warp
    took."""
    X = np.where(E > 0, V, np.float32(0))
    bisect = _tree(np.clip(X, 0, 1)) > 1
    hi = np.maximum(X.max(axis=1), np.float32(0))
    lo = np.zeros(len(V), np.float32)
    moving = bisect.copy()

    def step(lo, hi):
        mid = _f32(0.5) * (lo + hi)
        gt = _tree(np.clip(X - mid[:, None], 0, 1)) > 1
        return np.where(gt, mid, lo), np.where(gt, hi, mid)

    steps = 0
    for _ in range(t_ref.QAD_BISECT // 2):
        nlo, nhi = step(lo, hi)
        moving &= (nlo != lo) | (nhi != hi)
        lo, hi = step(nlo, nhi)
        steps += 2
        if early_exit and not moving.any():
            break
    out = np.where(bisect[:, None], np.clip(X - hi[:, None], 0, 1),
                   np.clip(X, 0, 1))
    return (out * E).astype(np.float32), steps


def _project_warps(V, E):
    return np.concatenate([project_register(V[w:w + 32], E[w:w + 32])[0]
                           for w in range(0, len(V), 32)])


def emulate_register(A, b, F, e, fm, Ds, iters):
    """``qad_reg_kernel``: one lane a row (rows padded to the plan's
    threads, K to its KMAX with inert coordinates), the pinned rows' sums
    and the column sums as xor trees, q = S / F once a step, pinned rows
    and rows past N zero in A, b, e and x."""
    A, b, F, e, fm, Ds = map(_f32, (A, b, F, e, fm, Ds))
    N, K = A.shape
    plan = t_kern.qad_plan(N, K)
    assert plan.route == "register"
    T, KM = plan.threads, plan.kmax

    def pad(X, fill=0.0):
        out = np.full((T, KM), fill, np.float32)
        out[:N, :K] = X
        return out

    Fp = np.ones(KM, np.float32)
    Fp[:K] = F
    L = np.float32(0)
    for k in range(K):
        s = np.float32(0)
        for n in range(N):
            s = s + A[n, k] * A[n, k]
        L = max(L, s / F[k])
    step = np.float32(1) / (np.float32(2) * L + np.float32(1e-12))
    pinned = np.zeros(T, bool)
    pinned[:N] = fm > 0
    free = ~pinned
    free[N:] = False
    zero = np.zeros(KM, np.float32)
    Ar, br, er = (np.where(free[:, None], pad(X), 0) for X in (A, b, e))
    out = []
    for Dfix in Ds:
        Sfix = _xor_sums(np.where(pinned[:, None], pad(Dfix) * pad(A), 0),
                         zero)
        x = _project_warps(_f32(0.5) * er, er)
        xp = x.copy()
        for t in range(iters):
            beta = np.float32(t) / (np.float32(t) + np.float32(3))
            y = x + beta * (x - xp)
            xp = x
            q = _xor_sums(y * Ar, Sfix) / Fp
            g = (np.float32(2) * Ar * q + br) * er
            x = _project_warps(y - step * g, er)
        x = _project_warps(x, er)
        S = _xor_sums(x * Ar, Sfix)
        D = np.where(pinned[:N, None], Dfix, (x * er)[:N, :K])
        g = ((np.float32(2) * Ar * (S / Fp) + br) * er)[:N, :K]
        lin = np.where(e > 0, g, np.float32(np.inf)).min(axis=1)
        lin = np.minimum(lin, 0)
        lin = np.where(np.isfinite(lin), lin, 0)
        sums = np.zeros((T, 2), np.float32)
        for k in range(K):
            sums[:N, 0] = sums[:N, 0] + D[:, k] * b[:, k]
        gx = np.zeros(N, np.float32)
        for k in range(K):
            gx = gx + g[:, k] * x[:N, k]
        sums[:N, 1] = np.where(free[:N], np.float32(0) + (lin - gx), 0)
        db, gap = _xor_sums(sums, np.zeros(2, np.float32))
        f = np.float32(0)
        for k in range(K):
            f = f + S[k] * S[k] / F[k]
        f = f + db
        out.append((D, f, f + gap))
    return (np.stack([o[0] for o in out]), np.array([o[1] for o in out]),
            np.array([o[2] for o in out]))


@pytest.mark.parametrize("N,K,seed,depth,iters",
                         [(8, 3, 4, 2, 300), (20, 4, 1, 3, 200),
                          (40, 3, 2, 5, 100), (21, 6, 5, 4, 200),
                          (12, 9, 7, 2, 150)])
def test_register_emulation_matches_plain(N, K, seed, depth, iters):
    """The register route's arithmetic (one warp a child up to 32 rows,
    two warps at 40; K padded to 4, 8 and 16) within the tolerances of the
    plain version."""
    A, b, F, e = qad_arrays(N, K, seed)
    fm, Ds = frontier(e, depth, seed)
    plain = t_qad.solve_rqad_batch(A, b, F, e, fm, Ds, iters, device="cpu")
    assert_close(emulate_register(A, b, F, e, fm, Ds, iters),
                 [x.numpy() for x in plain], (N, K, seed))


def _rows(kind, rng, KM=4):
    """Seeded float32 rows [64, KMAX] and their masks."""
    V = rng.uniform(-0.3, 1.3, (64, KM))
    E = np.ones((64, KM))
    if kind == "near_zero_threshold":       # the clipped sum just above 1
        V = rng.uniform(0, 0.2, (64, KM))
        V[:, 0] = 1.0 - V[:, 1:].sum(1) + rng.uniform(1e-7, 1e-5, 64)
    elif kind == "clipped_sum_at_most_1":
        V = rng.uniform(-1, 1.0 / KM, (64, KM))
    elif kind == "tied_maxima":
        V[:, :3] = V[:, :1]
    elif kind == "padded":                  # K = 5 of KMAX = 8
        KM = 8
        V = rng.uniform(-0.3, 1.3, (64, KM))
        E = np.ones((64, KM))
        E[:, 5:] = 0
        V[:, 5:] = 0
    elif kind == "masked_edges":            # some e = 0 inside K
        E = (rng.random((64, KM)) < 0.7).astype(float)
    return _f32(V), _f32(E)


@pytest.mark.parametrize("kind", ["uniform", "near_zero_threshold",
                                  "clipped_sum_at_most_1", "tied_maxima",
                                  "padded", "masked_edges"])
def test_early_exit_bisection_is_exact(kind):
    """Leaving the bisection once a step changes neither lo nor hi gives
    the 40-step bisection's rows bit for bit, warp by warp."""
    rng = np.random.default_rng(["uniform", "near_zero_threshold",
                                 "clipped_sum_at_most_1", "tied_maxima",
                                 "padded", "masked_edges"].index(kind))
    V, E = _rows(kind, rng)
    for w in range(0, 64, 32):
        fast, steps = project_register(V[w:w + 32], E[w:w + 32])
        full, all_steps = project_register(V[w:w + 32], E[w:w + 32],
                                           early_exit=False)
        assert all_steps == t_ref.QAD_BISECT
        assert np.array_equal(fast.view(np.int32), full.view(np.int32))
        if kind == "clipped_sum_at_most_1":
            assert steps == 2
        elif kind != "near_zero_threshold":
            assert steps < t_ref.QAD_BISECT
    # and the rows are the plain version's projection, within rounding
    plain = t_ref.project_rows_reference(torch.from_numpy(V),
                                         torch.from_numpy(E)).numpy() * E
    got = np.concatenate([project_register(V[w:w + 32], E[w:w + 32])[0]
                          for w in (0, 32)])
    assert np.abs(got - plain).max() <= 1e-6


@pytest.mark.parametrize("N,K,route,kmax,threads", [
    (21, 4, "register", 4, 32),         # the round's instance: one warp
    (33, 5, "register", 8, 64),
    (64, 8, "register", 8, 64),
    (24, 16, "register", 16, 32),
    (1024, 1, "register", 4, 1024),
    (24, 17, "generic", 0, 32),
    (1025, 4, "generic", 0, 1024),
    (24, 18, "generic", 0, 32)])
def test_qad_plan_picks_the_route_from_the_shapes(N, K, route, kmax,
                                                   threads):
    plan = t_kern.qad_plan(N, K)
    assert (plan.route, plan.kmax, plan.threads) == (route, kmax, threads)
    assert plan.smem_bytes == (t_kern.generic_plan(N, K).smem_bytes
                               if route == "generic" else 0)


def test_qad_plan_raises_past_shared_memory():
    """Beyond the register route's shapes the generic route keeps the
    instance in shared memory, and raises past 227 KB."""
    t_kern.qad_plan(1025, 10)                 # 210 KB: fits
    for N, K in ((1025, 12), (100, 120)):
        with pytest.raises(ValueError, match="shared memory"):
            t_kern.qad_plan(N, K)
    with pytest.raises(ValueError):
        t_kern.qad_plan(0, 4)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Both routes against the plain version on the card: the register
    route on the paper-scale frontiers, the generic one at K = 17."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the qad_solve kernel has no CPU mode")
    from repro_torch.kernels import launch_counts, reset_launch_counts
    for N, K, seed, depth, iters in CASES[1:] + [(12, 17, 2, 3, 200)]:
        A, b, F, e = qad_arrays(N, K, seed)
        fm, Ds = frontier(e, depth, seed)
        route = t_kern.qad_plan(N, K).route
        reset_launch_counts()
        got = t_qad.solve_rqad_batch(A, b, F, e, fm, Ds, iters,
                                     device="cuda")
        assert launch_counts().get("qad_solve") == 1
        assert launch_counts().get(f"qad_solve/{route}") == 1
        plain = t_qad.solve_rqad_batch(A, b, F, e, fm, Ds, iters,
                                       device="cpu")
        assert_close([x.cpu().numpy() for x in got],
                      [x.numpy() for x in plain], (N, K, seed))


# -- B&B with the R-QAD bound -------------------------------------------------

def run_both(N, K, seed, kw, monkeypatch):
    """Both B&B runs on one instance, each frontier's raw R-QAD lower
    bounds (before the constant is added) recorded."""
    tasks, params = make_instance(N, K, seed=seed)
    ref_lbs, port_lbs = [], []
    real_r = r_qad.solve_rqad_batch

    def rec_r(*a):
        out = real_r(*a)
        ref_lbs.append(np.asarray(out[2]))
        return out

    real_t = t_qad.RqadBounder.solve

    def rec_t(self, *a):
        out = real_t(self, *a)
        port_lbs.append(out[2])
        return out

    monkeypatch.setattr(r_qad, "solve_rqad_batch", rec_r)
    monkeypatch.setattr(t_qad.RqadBounder, "solve", rec_t)
    want = r_bnb.branch_and_bound(tasks, params, bound="rqad", **kw)
    got = t_bnb.branch_and_bound(*port_instance(tasks, params), bound="rqad",
                                 device="cpu", **kw)
    return tasks, params, want, got, ref_lbs, port_lbs


BNB_CASES = [((5, 2, s), dict(solver_iters=400, warm_start="cloud",
                              order="given")) for s in (0, 3, 11)]
BNB_CASES += [((20, 4, 1), {}), ((20, 4, 12), {})]


@pytest.mark.parametrize("inst,kw", BNB_CASES)
def test_bnb_rqad_matches_reference(inst, kw, monkeypatch):
    """Same objective, D and partial mask; node counts equal, or every
    difference traced to a float32 tie: a bound within 2 ulps of the
    optimum, which the reference and the port may round to either side
    of it (seed 1 at 20 x 4 has one: the reference prunes a child whose
    bound rounds 1 ulp above the optimum, the port explores it and finds
    nothing better)."""
    N, K, seed = inst
    tasks, params, want, got, ref_lbs, port_lbs = run_both(N, K, seed, kw,
                                                           monkeypatch)
    assert got.optimal and want.optimal
    assert np.isclose(got.objective, want.objective, rtol=1e-9)
    assert np.array_equal(got.D, want.D)
    assert np.array_equal(got.partial, want.partial)
    # every expansion both runs made bounds the same children alike
    for a, b in zip(ref_lbs, port_lbs):
        assert a.shape == b.shape
        assert (np.abs(a - b) <= F_RTOL * np.maximum(1, np.abs(a))).all()
    if (got.nodes_explored, got.nodes_pruned) != \
            (want.nodes_explored, want.nodes_pruned):
        inst_r = r_bnb._Instance(tasks, params, kw.get("order", "impact"))
        A, b, const = r_qad.build_qad_arrays(
            inst_r.c, inst_r.w, inst_r.e,
            np.where(inst_r.e > 0, inst_r.w[:, None]
                     / np.maximum(inst_r.tx_edge, 1e-300), 1e-30),
            inst_r.w / np.maximum(inst_r.cloud - inst_r.c / params.F_cloud,
                                  1e-300),
            cloud_compute=inst_r.c / params.F_cloud)
        ulp = np.spacing(np.float32(want.objective))
        near = [np.abs(lbs + np.float32(const) - want.objective).min()
                for lbs in ref_lbs + port_lbs]
        assert min(near) <= 2 * ulp, (got.nodes_explored,
                                      want.nodes_explored, min(near), ulp)
    if N <= 6:
        bf = r_bnb.brute_force(tasks, params)
        assert np.isclose(got.objective, bf.objective, rtol=1e-9)


def test_bnb_rqad_equals_reference_on_its_bounds(monkeypatch):
    """With the reference's own solver behind the port's B&B (its float32
    bounds, bit for bit), every count matches: the port's pins, constant,
    slack and float32 rounding of the node bound are the reference's."""
    def ref_bounds(self, fixed_mask, fixed_Ds, iters):
        out = r_qad.solve_rqad_batch(*self._host, fixed_mask, fixed_Ds,
                                     iters)
        return tuple(np.asarray(x) for x in out)

    real_init = t_qad.RqadBounder.__init__

    def init(self, A, b, F, e, device=None):
        real_init(self, A, b, F, e, device)
        self._host = (A, b, F, e)

    monkeypatch.setattr(t_qad.RqadBounder, "__init__", init)
    monkeypatch.setattr(t_qad.RqadBounder, "solve", ref_bounds)
    for (N, K, seed), kw in BNB_CASES:
        tasks, params = make_instance(N, K, seed=seed)
        want = r_bnb.branch_and_bound(tasks, params, bound="rqad", **kw)
        got = t_bnb.branch_and_bound(*port_instance(tasks, params),
                                     bound="rqad", device="cpu", **kw)
        assert (got.nodes_explored, got.nodes_pruned, got.objective) == \
            (want.nodes_explored, want.nodes_pruned, want.objective)
        assert np.array_equal(got.D, want.D)


def partial_instance(mod, N, K, seed):
    """``tests/test_torch_core.py:_instance`` with partial options on
    every second row (a congested cloud, so some rows take them)."""
    rng = np.random.default_rng(seed)
    params = mod.SystemParams.synthetic(N, K, seed=seed)
    params.F_cloud = 0.05e9
    c = rng.uniform(1e7, 5e8, N)
    w = rng.uniform(1e5, 5e7, N)
    e = (rng.random((N, K)) < 0.7).astype(float) * params.assoc
    partial = [None] * N
    for n in range(0, N, 2):
        e[n] = 0.0
        m = int(rng.integers(1, K + 1))
        edges = np.sort(rng.choice(K, size=m, replace=False))
        partial[n] = mod.PartialOption(
            edges=edges, cycles=rng.uniform(1e5, 1e6, m),
            ship_bits=rng.uniform(1e5, 2e7, m),
            assemble_cycles=float(rng.uniform(1e6, 5e7)))
    return mod.QueryTasks(c=c, w=w, e=e, partial=partial), params


@pytest.mark.parametrize("depth", [None, 0, 2])
def test_bnb_rqad_partial_slack_and_depth_cap(depth):
    """The partial slack and ``rqad_max_depth`` through the scheduler
    facade, against the reference and brute force."""
    from repro.core import cost as r_cost
    from repro.core import scheduler as r_sched
    r_tasks, r_params = partial_instance(r_cost, 6, 3, 2)
    t_tasks, t_params = partial_instance(t_cost, 6, 3, 2)
    want = r_sched.schedule(r_tasks, r_params, policy="bnb", bound="rqad",
                            rqad_max_depth=depth)
    got = t_sched.schedule(t_tasks, t_params, policy="bnb", bound="rqad",
                           rqad_max_depth=depth, device="cpu")
    bf = r_bnb.brute_force(r_tasks, r_params)
    assert got.info["optimal"] and got.partial.any()
    assert np.isclose(got.objective, want.objective, rtol=1e-9)
    assert np.isclose(got.objective, bf.objective, rtol=1e-9)
    assert np.array_equal(got.D, want.D)
    assert np.array_equal(got.partial, want.partial)


def test_bnb_bound_names_and_device():
    """Unknown bounds raise; ``device=None`` means the card; the marginal
    bound never reads the device."""
    tasks, params = port_instance(*make_instance(6, 3, seed=0))
    with pytest.raises(ValueError):
        t_bnb.branch_and_bound(tasks, params, bound="nope")
    with pytest.raises(ValueError):
        t_sched.schedule(tasks, params, policy="bnb", bound="nope")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_bnb.branch_and_bound(tasks, params, bound="rqad")
    got = t_bnb.branch_and_bound(tasks, params, bound="marginal",
                                 device="no-such-device")
    assert got.optimal
