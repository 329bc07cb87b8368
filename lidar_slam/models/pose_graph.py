"""In-JAX pose-graph optimization over SE(2): the GTSAM replacement.

Capability parity with the reference's inlined GTSAM stage
(reference: main.py:148-192): a prior on pose 0, a between factor per
consecutive scan-matched pair, and gated fixed-interval loop closures,
minimized by Levenberg-Marquardt. The reference crosses a C++ binding per
factor and solves on the host; here the whole graph is three dense factor
arrays and the entire LM solve — batched block linearization, matrix-free CG
normal equations, damping schedule — runs on device inside one jit.
Residuals use the full SE(2) log map (utils/se2.py:log_se2),
the same error model as gtsam.BetweenFactorPose2, so the optimum matches
GTSAM's.

Scale note: N poses -> 3N variables. The graph is a chain plus sparse loop
arcs, so J^T J is block-tridiagonal + sparse off-band; CG with a Jacobi
preconditioner solves it matrix-free in O(factors) per iteration without
materializing the (3N, 3N) system.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PoseGraphConfig
from ..utils import se2
from ..utils.precision import matmul as p_matmul


class PoseGraph(NamedTuple):
    """Dense factor arrays for a 2-D pose graph.

    prior_pose (3,): measured pose for the prior on vertex 0
    prior_sigmas (3,)
    between_meas (B, 3, 3): SE(2) measurement for factor i -> i+1
    between_sigmas (3,)
    loop_i, loop_j (L,): loop factor endpoints
    loop_meas (L, 3, 3): SE(2) loop measurements
    loop_mask (L,): gate (rejected closures get zero weight)
    loop_sigmas (3,)
    """

    prior_pose: jnp.ndarray
    prior_sigmas: jnp.ndarray
    between_meas: jnp.ndarray
    between_sigmas: jnp.ndarray
    loop_i: jnp.ndarray
    loop_j: jnp.ndarray
    loop_meas: jnp.ndarray
    loop_mask: jnp.ndarray
    loop_sigmas: jnp.ndarray


def make_graph(
    relative_poses: jnp.ndarray,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    prior_pose: jnp.ndarray | None = None,
    loop_i: jnp.ndarray | None = None,
    loop_j: jnp.ndarray | None = None,
    loop_meas: jnp.ndarray | None = None,
    loop_mask: jnp.ndarray | None = None,
) -> PoseGraph:
    """Assemble a PoseGraph from scan-matching relative poses and optional
    loop closures (reference graph construction: main.py:148-173)."""
    dtype = relative_poses.dtype
    if prior_pose is None:
        prior_pose = jnp.zeros(3, dtype)
    if loop_i is None:
        loop_i = jnp.zeros((0,), jnp.int32)
        loop_j = jnp.zeros((0,), jnp.int32)
        loop_meas = jnp.zeros((0, 3, 3), dtype)
        loop_mask = jnp.zeros((0,), bool)
    return PoseGraph(
        prior_pose=prior_pose,
        prior_sigmas=jnp.asarray(cfg.prior_sigmas, dtype),
        between_meas=relative_poses,
        between_sigmas=jnp.asarray(cfg.between_sigmas, dtype),
        loop_i=loop_i.astype(jnp.int32),
        loop_j=loop_j.astype(jnp.int32),
        loop_meas=loop_meas,
        loop_mask=loop_mask,
        loop_sigmas=jnp.asarray(cfg.loop_sigmas, dtype),
    )


def residuals(poses: jnp.ndarray, g: PoseGraph) -> jnp.ndarray:
    """Whitened residual vector of the whole graph.

    Factor error is Log(meas^-1 * (T_i^-1 T_j)) / sigmas — the
    gtsam.BetweenFactorPose2 error model. Gated-out loop factors contribute
    exactly zero.
    """
    T = se2.T_from_pose(poses)
    Tinv = se2.inverse_T(T)

    # prior on vertex 0 (reference: main.py:149-150)
    T_prior = se2.T_from_pose(g.prior_pose)
    r_prior = se2.log_se2(p_matmul(se2.inverse_T(T_prior), T[0])) / g.prior_sigmas

    # consecutive between factors (reference: main.py:151-155)
    rel = p_matmul(Tinv[:-1], T[1:])
    r_btw = se2.log_se2(p_matmul(se2.inverse_T(g.between_meas), rel)) / g.between_sigmas

    # loop closures (reference: main.py:161-172)
    rel_l = p_matmul(Tinv[g.loop_i], T[g.loop_j])
    r_loop = se2.log_se2(p_matmul(se2.inverse_T(g.loop_meas), rel_l)) / g.loop_sigmas
    r_loop = jnp.where(g.loop_mask[:, None], r_loop, 0.0)

    return jnp.concatenate([r_prior[None].reshape(-1), r_btw.reshape(-1),
                            r_loop.reshape(-1)])


def graph_cost(poses: jnp.ndarray, g: PoseGraph) -> jnp.ndarray:
    r = residuals(poses, g)
    return 0.5 * jnp.dot(r, r)


class LMResult(NamedTuple):
    poses: jnp.ndarray
    cost: jnp.ndarray
    iterations: jnp.ndarray
    final_lambda: jnp.ndarray


_HI = jax.lax.Precision.HIGHEST


def _dot(a, b):
    return jnp.matmul(a, b, precision=_HI)


def _inv3x3b(A):
    """Batched closed-form (adjugate) 3x3 inverse; A (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g_, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = -(d * i - f * g_)
    C02 = d * h - e * g_
    C10 = -(b * i - c * h)
    C11 = a * i - c * g_
    C12 = -(a * h - b * g_)
    C20 = b * f - c * e
    C21 = -(a * f - c * d)
    C22 = a * e - b * d
    det = a * C00 + b * C01 + c * C02
    adjT = jnp.stack([
        jnp.stack([C00, C10, C20], -1),
        jnp.stack([C01, C11, C21], -1),
        jnp.stack([C02, C12, C22], -1),
    ], -2)
    return adjT / det[..., None, None]


def _binv(A):
    """Batched block inverse: closed-form adjugate for 3x3 blocks, LU
    (full matmul precision) for larger blocks (the banded solver's
    super-blocks)."""
    if A.shape[-1] == 3:
        return _inv3x3b(A)
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.inv(A)


def _thomas(A, O, R):
    """Plain block-tridiagonal solve T X = R via LDL^T + two scans.

    A (n, b, b) diag blocks, O (n-1, b, b) sub-diag (O_i = T[i+1, i]),
    R (n, b, m). Batched over leading axes of each step's operands if the
    arrays carry an extra batch axis BEFORE the chain axis: i.e. shapes
    (B, n, b, b)/(B, n-1, b, b)/(B, n, b, m) also work (the scan runs over
    the chain axis, everything else is vectorized).
    """
    batched = A.ndim == 4
    ax = 1 if batched else 0
    sw = (lambda x: jnp.swapaxes(x, -1, -2))
    A0 = A[:, 0] if batched else A[0]
    R0 = R[:, 0] if batched else R[0]
    Dinv0 = _binv(A0)
    z0 = R0

    def fwd(carry, inp):
        Dinv_p, z_p = carry
        A_i, O_p, R_i = inp
        L_i = _dot(O_p, Dinv_p)
        D_i = A_i - _dot(L_i, sw(O_p))
        z_i = R_i - _dot(L_i, z_p)
        Dinv_i = _binv(D_i)
        return (Dinv_i, z_i), (Dinv_i, z_i, L_i)

    tail = (lambda x: jnp.moveaxis(x[:, 1:] if batched else x[1:], ax, 0))
    (_, _), (Dinv_t, z_t, L_t) = jax.lax.scan(
        fwd, (Dinv0, z0), (tail(A), jnp.moveaxis(O, ax, 0), tail(R)))
    Dinv = jnp.concatenate([Dinv0[None], Dinv_t])
    z = jnp.concatenate([z0[None], z_t])
    w = _dot(Dinv, z)

    def bwd(x_next, inp):
        w_i, L_next = inp
        x_i = w_i - _dot(sw(L_next), x_next)
        return x_i, x_i

    x_last = w[-1]
    _, Y_rev = jax.lax.scan(bwd, x_last, (w[:-1], L_t), reverse=True)
    Y = jnp.concatenate([Y_rev, x_last[None]])  # (n, [B,] 3, m)
    return jnp.moveaxis(Y, 0, ax)


def block_tridiag_solve(A, O, R, q: int = 64):
    """SPD block-tridiagonal solve T X = R with a short sequential chain.

    A (n, b, b), O (n-1, b, b) with O_i = T[i+1, i], R (n, b, m); any
    block size b (3 for pose chains, 3*interval for the banded solver's
    super-blocks).

    A plain Thomas recurrence costs ~2n sequential lax.scan steps, each
    a small dependent kernel launch. For n > 2q this uses a
    two-level SPIKE decomposition instead: the chain is split into B
    segments of q poses whose q-1 interior poses are eliminated by a
    Thomas solve batched ACROSS segments (depth q-1), leaving a reduced
    block-tridiagonal system on the B segment-end interface poses (depth
    B). Total sequential depth ~2(q+B) ~ O(sqrt n) instead of 2n, with
    identical arithmetic to the dense factorization.
    """
    n = A.shape[0]
    b = A.shape[-1]
    m = R.shape[-1]
    if n <= 2 * q:
        return _thomas(A, O, R)

    B = -(-n // q)
    n_pad = B * q
    dtype = A.dtype
    eyeb = jnp.eye(b, dtype=dtype)
    if n_pad != n:
        A = jnp.concatenate([A, jnp.broadcast_to(eyeb, (n_pad - n, b, b))])
        O = jnp.concatenate([O, jnp.zeros((n_pad - n, b, b), dtype)])
        R = jnp.concatenate([R, jnp.zeros((n_pad - n, b, m), dtype)])
    # O index i couples poses i and i+1; pad with one trailing zero so it
    # reshapes to (B, q): O_r[b, j] couples pose b*q+j with b*q+j+1
    O_r = jnp.concatenate([O, jnp.zeros((1, b, b), dtype)]).reshape(
        B, q, b, b)
    A_r = A.reshape(B, q, b, b)
    R_r = R.reshape(B, q, b, m)

    # segment interiors: poses b*q .. b*q+q-2; interface: pose b*q+q-1
    A_int = A_r[:, :q - 1]
    O_int = O_r[:, :q - 2]
    Lc = jnp.concatenate([jnp.zeros((1, b, b), dtype),
                          O_r[:-1, q - 1]])     # T[bq, bq-1] (left iface)
    Rc = O_r[:, q - 2]                          # T[v_b, last interior]
    Ic = O_r[:, q - 1]                          # T[(b+1)q, v_b]; zero at B-1

    # batched Thomas: T_int Y = [R_int | e_first | e_last]
    Ef = jnp.zeros((B, q - 1, b, b), dtype).at[:, 0].set(eyeb)
    El = jnp.zeros((B, q - 1, b, b), dtype).at[:, q - 2].set(eyeb)
    RHS = jnp.concatenate([R_r[:, :q - 1], Ef, El], axis=-1)
    Y = _thomas(A_int, O_int, RHS)              # (B, q-1, b, m+2b)
    YR, Yf, Yl = Y[..., :m], Y[..., m:m + b], Y[..., m + b:]

    # next-segment first-row quantities, shifted so index b refers to b+1
    zbb = jnp.zeros((1, b, b), dtype)
    Yf_next0 = jnp.concatenate([Yf[1:, 0], zbb])       # (T_{b+1}^-1)_ff
    YR_next0 = jnp.concatenate(
        [YR[1:, 0], jnp.zeros((1, b, m), dtype)])
    Yf_next_last = jnp.concatenate([Yf[1:, q - 2], zbb])  # (T_{b+1}^-1)_lf
    Rc_next = jnp.concatenate([Rc[1:], zbb])

    sw = (lambda x: jnp.swapaxes(x, -1, -2))
    # reduced interface system (B blocks)
    A_hat = (A_r[:, q - 1]
             - _dot(Rc, _dot(Yl[:, q - 2], sw(Rc)))
             - _dot(sw(Ic), _dot(Yf_next0, Ic)))
    O_hat = -_dot(Rc_next[:-1], _dot(Yf_next_last[:-1], Ic[:-1]))
    R_hat = (R_r[:, q - 1]
             - _dot(Rc, YR[:, q - 2])
             - _dot(sw(Ic), YR_next0))
    x_hat = _thomas(A_hat, O_hat, R_hat)        # (B, b, m)

    # interior back-substitution
    x_left = jnp.concatenate([jnp.zeros((1, b, m), dtype), x_hat[:-1]])
    x_int = (YR
             - _dot(Yf, _dot(Lc, x_left)[:, None])
             - _dot(Yl, _dot(sw(Rc), x_hat)[:, None]))
    X = jnp.concatenate([x_int, x_hat[:, None]], axis=1).reshape(
        n_pad, b, m)
    return X[:n]


def _banded_scatter(n: int, band: int, dtype, D: jnp.ndarray,
                    off_r: jnp.ndarray, off_c: jnp.ndarray,
                    off_M: jnp.ndarray):
    """Scatter per-pose (3, 3) diagonal blocks and off-diagonal pose-pair
    blocks into super-block tridiagonal storage.

    D (n, 3, 3): diagonal block of H for each pose. off_M (F, 3, 3) with
    off_M[f] = H[off_r[f], off_c[f]], requiring off_r >= off_c and
    off_r - off_c <= band (zero blocks at any index are harmless no-ops,
    which is how masked/padded factors pass through). Returns
    (A_sup (n_sup, 3*band, 3*band), O_sup (max(n_sup-1, 1), ...)); the
    caller slices O_sup[:n_sup-1] before the solve and adds anything that
    must count exactly once (lambda damping, the prior block, padded-tail
    identity blocks) itself — banded_solve folds those into D up front,
    optimize_sharded adds them after its cross-device psum.

    Shared by the single-device banded_solve and the factor-sharded
    optimize_sharded so the two exactness-coupled paths cannot drift.
    """
    G = band
    bs = 3 * G
    n_sup = -(-n // G)
    ii = jnp.arange(3)[:, None]
    jj = jnp.arange(3)[None, :]
    s_all = jnp.arange(n) // G
    o_all = jnp.arange(n) % G

    A_sup = jnp.zeros((n_sup, bs, bs), dtype)
    A_sup = A_sup.at[s_all[:, None, None],
                     (3 * o_all)[:, None, None] + ii,
                     (3 * o_all)[:, None, None] + jj].add(D)

    s_r, o_r = off_r // G, off_r % G
    s_c, o_c = off_c // G, off_c % G
    same = (s_r == s_c)[:, None, None]
    adj = (s_r == s_c + 1)[:, None, None]
    MT = jnp.swapaxes(off_M, -1, -2)
    # same-super entries land in A (both triangles)
    A_sup = A_sup.at[jnp.where(same[:, 0, 0], s_r, 0)[:, None, None],
                     (3 * o_r)[:, None, None] + ii,
                     (3 * o_c)[:, None, None] + jj].add(
        jnp.where(same, off_M, 0.0))
    A_sup = A_sup.at[jnp.where(same[:, 0, 0], s_r, 0)[:, None, None],
                     (3 * o_c)[:, None, None] + ii,
                     (3 * o_r)[:, None, None] + jj].add(
        jnp.where(same, MT, 0.0))
    # adjacent-super entries land in O[s_c] = H[super s_c+1, super s_c];
    # padded to length >= 1 so the masked scatter always has a valid row 0
    # to dump zeros into (n <= band => n_sup == 1 => NO off-diagonals)
    O_sup = jnp.zeros((max(n_sup - 1, 1), bs, bs), dtype)
    O_sup = O_sup.at[jnp.where(adj[:, 0, 0], s_c, 0)[:, None, None],
                     (3 * o_r)[:, None, None] + ii,
                     (3 * o_c)[:, None, None] + jj].add(
        jnp.where(adj, off_M, 0.0))
    return A_sup, O_sup


def _banded_rhs(g: jnp.ndarray, n: int, band: int, dtype) -> jnp.ndarray:
    """-g scattered into (n_sup, 3*band, 1) super-block RHS storage
    (padded-tail poses keep a zero RHS)."""
    G = band
    n_sup = -(-n // G)
    s_all = jnp.arange(n) // G
    o_all = jnp.arange(n) % G
    return jnp.zeros((n_sup, 3 * G, 1), dtype).at[
        s_all[:, None], (3 * o_all)[:, None] + jnp.arange(3), 0].add(-g)


def _factor_residual(pose_i: jnp.ndarray, pose_j: jnp.ndarray,
                     meas: jnp.ndarray, inv_sigmas: jnp.ndarray) -> jnp.ndarray:
    """Whitened between-factor residual for one factor (3,)."""
    Ti = se2.T_from_pose(pose_i)
    Tj = se2.T_from_pose(pose_j)
    rel = p_matmul(se2.inverse_T(Ti), Tj)
    return se2.log_se2(p_matmul(se2.inverse_T(meas), rel)) * inv_sigmas


# batched residual + (3, 3) Jacobian blocks wrt pose_i and pose_j
_factor_r_and_J = jax.vmap(
    lambda pi, pj, m, s: (
        _factor_residual(pi, pj, m, s),
        jax.jacfwd(_factor_residual, argnums=(0, 1))(pi, pj, m, s),
    ),
    in_axes=(0, 0, 0, None),
)


def _robust_w_rho(e2: jnp.ndarray, kind: str, delta: float):
    """Per-factor IRLS weight w = rho'(e)/e and robust cost rho(e), from the
    squared whitened residual norm e2 (L,).

    The analog of gtsam.noiseModel.mEstimator.{Huber,Cauchy}: scaling the
    whitened residual and Jacobian blocks by sqrt(w) at each linearization
    is exactly how GTSAM applies a robust noise model inside LM (the
    standard IRLS approximation — the rho'' term is omitted, as there).
    Both kernels are identity for e -> 0, so inliers are untouched;
    masked-out factors have e2 = 0 and contribute w = 1 on a zero block.
    """
    if kind == "huber":
        # rho(e) = e^2/2 for e <= delta, delta*e - delta^2/2 beyond
        e = jnp.sqrt(e2)
        out = e > delta
        w = jnp.where(out, delta / jnp.maximum(e, 1e-30), 1.0)
        rho = jnp.where(out, delta * e - 0.5 * delta * delta, 0.5 * e2)
    elif kind == "cauchy":
        # rho(e) = (delta^2/2) * log(1 + e^2/delta^2)
        t = e2 / (delta * delta)
        w = 1.0 / (1.0 + t)
        rho = 0.5 * delta * delta * jnp.log1p(t)
    else:
        raise ValueError(f"unknown robust kernel {kind!r}")
    return w, rho


def optimize(
    poses0: jnp.ndarray,
    graph: PoseGraph,
    max_iters: int = 50,
    lambda_init: float = 1e-4,
    lambda_up: float = 10.0,
    lambda_down: float = 0.1,
    cg_iters: int = 250,
    cg_tol: float = 1e-8,
    cost_rtol: float = 1e-9,
    solver: str = "direct",
    band: int = 10,
    robust: str = "none",
    robust_delta: float = 1.0,
) -> LMResult:
    """Public LM entry point. See _optimize_jit for the solver itself.

    robust in {"none", "huber", "cauchy"} applies an m-estimator to the
    LOOP factors only (the outlier-prone factor class — the reference
    hard-gates exactly these, main.py:163-172; odometry/scan-matching
    between factors stay Gaussian, as in standard GTSAM practice).
    robust_delta is the kernel width in whitened-residual units.

    Host-side safety net for solver="banded": the banded solver is exact
    ONLY when every live loop factor spans <= band poses (fixed-interval
    graphs); a wider arc's Hessian blocks would be silently dropped. When
    the loop index arrays are concrete (the normal eager call), verify the
    span and fall back to the any-topology "direct" solver instead of
    returning a quietly degraded step. Inside an enclosing jit the indices
    are tracers and the check is skipped — the pipeline callers there
    (run_slam/refine) construct fixed-interval graphs by design.
    """
    if solver == "banded" and graph.loop_i.shape[0]:
        import numpy as np
        if not (isinstance(graph.loop_i, jax.core.Tracer)
                or isinstance(graph.loop_j, jax.core.Tracer)):
            # signed span: the banded assembly assumes loop_i < loop_j
            # (off-diagonal blocks live in the lower triangle), so any
            # REVERSED arc — not just wide ones — must fall back too
            span = np.asarray(graph.loop_j) - np.asarray(graph.loop_i)
            if not isinstance(graph.loop_mask, jax.core.Tracer):
                span = span[np.asarray(graph.loop_mask).astype(bool)]
            if span.size and (int(span.max()) > band or int(span.min()) < 0):
                solver = "direct"
    return _optimize_jit(poses0, graph, max_iters=max_iters,
                         lambda_init=lambda_init, lambda_up=lambda_up,
                         lambda_down=lambda_down, cg_iters=cg_iters,
                         cg_tol=cg_tol, cost_rtol=cost_rtol, solver=solver,
                         band=band, robust=robust,
                         robust_delta=robust_delta)


@partial(jax.jit, static_argnames=("max_iters", "cg_iters", "solver", "band",
                                   "trace", "robust"))
def _optimize_jit(
    poses0: jnp.ndarray,
    graph: PoseGraph,
    max_iters: int = 50,
    lambda_init: float = 1e-4,
    lambda_up: float = 10.0,
    lambda_down: float = 0.1,
    cg_iters: int = 250,
    cg_tol: float = 1e-8,
    cost_rtol: float = 1e-9,
    solver: str = "direct",
    band: int = 10,
    trace: bool = False,
    robust: str = "none",
    robust_delta: float = 1.0,
) -> LMResult:
    """Levenberg-Marquardt with explicit block-sparse normal equations.

    Replaces gtsam.LevenbergMarquardtOptimizer (reference: main.py:181-182),
    Per-factor 3x3 Jacobian blocks are computed ONCE per LM step
    by a vmapped forward-mode autodiff over the dense factor arrays (one
    batched pass — this is the graph linearization GTSAM does factor by
    factor in C++), and each CG iteration is then just two batched 3x3
    einsums plus scatter-adds. This keeps the CG inner loop at a handful of
    large fused ops instead of re-walking the autodiff graph per matvec,
    which keeps the number of dependent device launches small.
    """
    n = poses0.shape[0]
    dtype = poses0.dtype
    idx_i = jnp.arange(n - 1)
    idx_j = idx_i + 1
    inv_btw = 1.0 / graph.between_sigmas
    inv_loop = 1.0 / graph.loop_sigmas
    inv_prior = 1.0 / graph.prior_sigmas

    def linearize(x):
        """r blocks, J blocks, gradient, and cost at x (poses (n, 3))."""
        # prior (acts on pose 0 only)
        rp = se2.log_se2(p_matmul(se2.inverse_T(se2.T_from_pose(graph.prior_pose)),
                                  se2.T_from_pose(x[0]))) * inv_prior
        Jp = jax.jacfwd(lambda p: se2.log_se2(
            p_matmul(se2.inverse_T(se2.T_from_pose(graph.prior_pose)),
                     se2.T_from_pose(p))) * inv_prior)(x[0])

        rb, (Jbi, Jbj) = _factor_r_and_J(x[idx_i], x[idx_j],
                                         graph.between_meas, inv_btw)
        rl, (Jli, Jlj) = _factor_r_and_J(x[graph.loop_i], x[graph.loop_j],
                                         graph.loop_meas, inv_loop)
        lw = graph.loop_mask.astype(dtype)[:, None]
        rl = rl * lw
        Jli = Jli * lw[..., None]
        Jlj = Jlj * lw[..., None]

        if robust == "none":
            loop_cost = 0.5 * jnp.sum(rl * rl)
        else:
            # IRLS: sqrt(w)-scale the loop blocks so every downstream
            # solver (CG/direct/banded) sees the robustly reweighted
            # normal equations; cost uses rho (see _robust_w_rho)
            w, rho = _robust_w_rho(jnp.sum(rl * rl, axis=1), robust,
                                   robust_delta)
            sw = jnp.sqrt(w)[:, None]
            rl = rl * sw
            Jli = Jli * sw[..., None]
            Jlj = Jlj * sw[..., None]
            loop_cost = jnp.sum(rho)

        # gradient g = J^T r, accumulated per variable
        g = jnp.zeros((n, 3), dtype)
        g = g.at[0].add(jnp.matmul(Jp.T, rp, precision=_HI))
        g = g.at[idx_i].add(jnp.einsum("bij,bi->bj", Jbi, rb, precision=_HI))
        g = g.at[idx_j].add(jnp.einsum("bij,bi->bj", Jbj, rb, precision=_HI))
        g = g.at[graph.loop_i].add(
            jnp.einsum("bij,bi->bj", Jli, rl, precision=_HI))
        g = g.at[graph.loop_j].add(
            jnp.einsum("bij,bi->bj", Jlj, rl, precision=_HI))

        cost = 0.5 * (jnp.dot(rp, rp) + jnp.sum(rb * rb)) + loop_cost
        return (Jp, Jbi, Jbj, Jli, Jlj), g, cost

    def cost_at(x):
        rp = se2.log_se2(p_matmul(se2.inverse_T(se2.T_from_pose(graph.prior_pose)),
                                  se2.T_from_pose(x[0]))) * inv_prior
        rb = jax.vmap(_factor_residual, in_axes=(0, 0, 0, None))(
            x[idx_i], x[idx_j], graph.between_meas, inv_btw)
        rl = jax.vmap(_factor_residual, in_axes=(0, 0, 0, None))(
            x[graph.loop_i], x[graph.loop_j], graph.loop_meas, inv_loop)
        rl = rl * graph.loop_mask.astype(dtype)[:, None]
        if robust == "none":
            loop_cost = 0.5 * jnp.sum(rl * rl)
        else:
            _, rho = _robust_w_rho(jnp.sum(rl * rl, axis=1), robust,
                                   robust_delta)
            loop_cost = jnp.sum(rho)
        return 0.5 * (jnp.dot(rp, rp) + jnp.sum(rb * rb)) + loop_cost

    def make_preconditioner(J, lam):
        """Block-Jacobi: invert the (3, 3) diagonal blocks of J^T J + lam I.

        The graph is a chain plus sparse loop arcs, so the diagonal blocks
        carry most of the spectrum; preconditioning cuts CG iterations by
        an order of magnitude at dataset scale.
        """
        Jp, Jbi, Jbj, Jli, Jlj = J
        D = jnp.zeros((n, 3, 3), dtype)
        D = D.at[0].add(_dot(Jp.T, Jp))
        D = D.at[idx_i].add(jnp.einsum("bij,bik->bjk", Jbi, Jbi))
        D = D.at[idx_j].add(jnp.einsum("bij,bik->bjk", Jbj, Jbj))
        D = D.at[graph.loop_i].add(jnp.einsum("bij,bik->bjk", Jli, Jli))
        D = D.at[graph.loop_j].add(jnp.einsum("bij,bik->bjk", Jlj, Jlj))
        D = D + lam * jnp.eye(3, dtype=dtype)
        Dinv = _inv3x3b(D)
        return lambda v: jnp.einsum("nij,nj->ni", Dinv, v)

    def make_matvec(J, lam):
        Jp, Jbi, Jbj, Jli, Jlj = J

        def matvec(v):
            # u_f = J_i v_i + J_j v_j per factor; y_i += J_i^T u_f etc.
            y = lam * v
            up = Jp @ v[0]
            y = y.at[0].add(Jp.T @ up)
            ub = (jnp.einsum("bij,bj->bi", Jbi, v[idx_i])
                  + jnp.einsum("bij,bj->bi", Jbj, v[idx_j]))
            y = y.at[idx_i].add(jnp.einsum("bij,bi->bj", Jbi, ub))
            y = y.at[idx_j].add(jnp.einsum("bij,bi->bj", Jbj, ub))
            ul = (jnp.einsum("bij,bj->bi", Jli, v[graph.loop_i])
                  + jnp.einsum("bij,bj->bi", Jlj, v[graph.loop_j]))
            y = y.at[graph.loop_i].add(jnp.einsum("bij,bi->bj", Jli, ul))
            y = y.at[graph.loop_j].add(jnp.einsum("bij,bi->bj", Jlj, ul))
            return y

        return matvec

    n_loops = int(graph.loop_i.shape[0])

    def direct_solve(J, lam, g):
        """Exact Newton step: block-tridiagonal LDL^T (Thomas) over the
        chain part of J^T J + lam I, with a Woodbury correction for the
        sparse loop arcs.

        CG cannot converge here in few iterations: on a 5k-pose chain,
        information moves ~1 vertex per matvec, so any maxiter << n leaves
        long-wavelength error. The chain Hessian is block-tridiagonal and
        loops are rank 3L, so H = T + U U^T solves exactly with two scans
        over the chain plus one (3L, 3L) dense SPD solve.
        """
        Jp, Jbi, Jbj, Jli, Jlj = J
        eye3 = jnp.eye(3, dtype=dtype)

        # chain tridiagonal blocks (loops live entirely in U U^T)
        A = jnp.zeros((n, 3, 3), dtype) + lam * eye3
        A = A.at[0].add(_dot(Jp.T, Jp))
        A = A.at[idx_i].add(jnp.einsum("bij,bik->bjk", Jbi, Jbi,
                                       precision=jax.lax.Precision.HIGHEST))
        A = A.at[idx_j].add(jnp.einsum("bij,bik->bjk", Jbj, Jbj,
                                       precision=jax.lax.Precision.HIGHEST))
        # O_i = H[i+1, i] (factor i couples blocks i -> Jbi, i+1 -> Jbj)
        O = jnp.einsum("bij,bik->bjk", Jbj, Jbi,
                       precision=jax.lax.Precision.HIGHEST)

        # right-hand sides: [-g | U], U[:, l] = loop-l Jacobian transposed
        if n_loops:
            R = jnp.zeros((n, 3, 1 + 3 * n_loops), dtype)
            R = R.at[:, :, 0].set(-g)
            Uli = jnp.swapaxes(Jli, 1, 2).reshape(n_loops, 3, 3)
            Ulj = jnp.swapaxes(Jlj, 1, 2).reshape(n_loops, 3, 3)
            cols = (1 + 3 * jnp.arange(n_loops)[:, None]
                    + jnp.arange(3)[None, :])
            R = R.at[graph.loop_i[:, None, None],
                     jnp.arange(3)[None, :, None],
                     cols[:, None, :]].add(Uli)
            R = R.at[graph.loop_j[:, None, None],
                     jnp.arange(3)[None, :, None],
                     cols[:, None, :]].add(Ulj)
        else:
            R = (-g)[:, :, None]

        # SPIKE block-tridiagonal solve (O(sqrt n) sequential depth)
        Y = block_tridiag_solve(A, O, R)  # (n, 3, m)

        yb = Y[:, :, 0]
        if not n_loops:
            return yb
        Yu = Y[:, :, 1:]
        # S = I + U^T Y_u ; rhs = U^T y_b  (U^T row-block l = J_l gathered)
        UtY = (jnp.einsum("lab,lbm->lam", Jli, Y[graph.loop_i],
                          precision=jax.lax.Precision.HIGHEST)
               + jnp.einsum("lab,lbm->lam", Jlj, Y[graph.loop_j],
                            precision=jax.lax.Precision.HIGHEST))
        UtY = UtY.reshape(3 * n_loops, -1)
        S = jnp.eye(3 * n_loops, dtype=dtype) + UtY[:, 1:]
        zc = jnp.linalg.solve(S, UtY[:, 0])
        corr = jnp.einsum("nim,m->ni", Yu, zc,
                          precision=jax.lax.Precision.HIGHEST)
        return yb - corr

    def banded_solve(J, lam, g):
        """Exact Newton step for FIXED-INTERVAL loop graphs.

        Every loop factor in the pipeline couples pose i to pose i+interval
        (reference: main.py:158-161), so H = J^T J + lam I is block-BANDED
        with block bandwidth <= band. Grouping `band` consecutive poses into
        one (3*band, 3*band) super-block makes H block-TRIDIAGONAL in
        super-blocks, and the SPIKE solve applies directly with a single
        RHS — no Woodbury panel at all. Unlike direct_solve (whose RHS
        panel is 1 + 3*n_candidates columns wide even when nearly all
        candidates are gate-rejected), the cost here is independent of the
        loop count. EXACT for any graph with max(loop_j - loop_i) <= band;
        callers with arbitrary loop topology must use solver="direct".
        """
        Jp, Jbi, Jbj, Jli, Jlj = J
        G = band
        n_sup = -(-n // G)
        n_padded = n_sup * G
        ii = jnp.arange(3)[:, None]
        jj = jnp.arange(3)[None, :]

        def jtj(Ja, Jb):
            return jnp.einsum("bij,bik->bjk", Ja, Jb, precision=_HI)

        # per-pose 3x3 diagonal blocks of H (damping + prior folded in —
        # this path has no cross-device combine to defer them past)
        D = jnp.zeros((n, 3, 3), dtype) + lam * jnp.eye(3, dtype=dtype)
        D = D.at[0].add(_dot(Jp.T, Jp))
        D = D.at[idx_i].add(jtj(Jbi, Jbi))
        D = D.at[idx_j].add(jtj(Jbj, Jbj))
        D = D.at[graph.loop_i].add(jtj(Jli, Jli))
        D = D.at[graph.loop_j].add(jtj(Jlj, Jlj))

        # off-diagonal pose-pair blocks M = H[r, c] (r > c, r - c <= G)
        off_r = jnp.concatenate([idx_j, graph.loop_j])
        off_c = jnp.concatenate([idx_i, graph.loop_i])
        off_M = jnp.concatenate([jtj(Jbj, Jbi), jtj(Jlj, Jli)])

        A_sup, O_sup = _banded_scatter(n, G, dtype, D, off_r, off_c, off_M)
        # padded tail poses: identity diagonal, zero coupling, zero rhs
        if n_padded != n:
            pad = jnp.arange(n, n_padded)
            A_sup = A_sup.at[pad[:, None, None] // G,
                             (3 * (pad % G))[:, None, None] + ii,
                             (3 * (pad % G))[:, None, None] + jj].add(
                jnp.broadcast_to(jnp.eye(3, dtype=dtype),
                                 (n_padded - n, 3, 3)))

        R_sup = _banded_rhs(g, n, G, dtype)
        X = block_tridiag_solve(A_sup, O_sup[:n_sup - 1], R_sup, q=32)
        return X.reshape(n_padded, 3)[:n]

    def step(state):
        x, lam, cost, it, done, stalls, dx_prev = state
        J, g, _ = linearize(x)
        if solver == "banded":
            dx = banded_solve(J, lam, g)
        elif solver == "direct":
            dx = direct_solve(J, lam, g)
        else:
            # warm-started, block-Jacobi-preconditioned CG
            dx, _ = jax.scipy.sparse.linalg.cg(make_matvec(J, lam), -g,
                                               x0=dx_prev,
                                               M=make_preconditioner(J, lam),
                                               tol=cg_tol, maxiter=cg_iters)
        x_new = x + dx
        cost_new = cost_at(x_new)
        accept = cost_new < cost
        x = jnp.where(accept, x_new, x)
        lam = jnp.where(accept, lam * lambda_down, lam * lambda_up)
        improved = (cost - cost_new) > cost_rtol * jnp.maximum(cost, 1.0)
        # gtsam checkConvergence analog: an ACCEPTED step whose relative
        # decrease is below tol ends the optimization immediately; rejected
        # steps instead retry with larger lambda under the stall/lambda
        # caps (gtsam's lambdaUpperBound analog)
        converged = accept & ~improved
        stalls = jnp.where(accept & improved, 0, stalls + 1)
        done = converged | (stalls >= 3) | (lam > 1e10)
        cost = jnp.where(accept, cost_new, cost)
        dx_prev = jnp.where(accept, jnp.zeros_like(dx), dx)
        return (x, lam, cost, it + 1, done, stalls, dx_prev)

    def cond(state):
        it, done = state[3], state[4]
        return (~done) & (it < max_iters)

    lam0 = jnp.asarray(lambda_init, dtype)
    state = (poses0, lam0, cost_at(poses0), jnp.asarray(0),
             jnp.asarray(False), jnp.asarray(0), jnp.zeros_like(poses0))
    if trace:
        # observability variant: fixed-length scan recording the per-
        # iteration (cost, lambda, stalls) trajectory; rows past
        # convergence repeat the final state (`ran` marks live rows)
        def scan_step(st, _):
            live = cond(st)
            new = jax.lax.cond(live, step, lambda s: s, st)
            return new, (live, new[2], new[1], new[5])
        state, hist = jax.lax.scan(scan_step, state, None, length=max_iters)
        x, lam, cost, it, _, _, _ = state
        ran, h_cost, h_lam, h_stalls = hist
        return (LMResult(poses=x, cost=cost, iterations=it,
                         final_lambda=lam),
                {"ran": ran, "cost": h_cost, "lambda": h_lam,
                 "stalls": h_stalls})
    x, lam, cost, it, _, _, _ = jax.lax.while_loop(cond, step, state)
    return LMResult(poses=x, cost=cost, iterations=it, final_lambda=lam)


def optimize_with_config(poses0: jnp.ndarray, graph: PoseGraph,
                         cfg: PoseGraphConfig = PoseGraphConfig()) -> LMResult:
    return optimize(poses0, graph, max_iters=cfg.max_lm_iters,
                    lambda_init=cfg.lambda_init, lambda_up=cfg.lambda_up,
                    lambda_down=cfg.lambda_down, cg_iters=cfg.cg_iters,
                    cg_tol=cfg.cg_tol, cost_rtol=cfg.cost_rtol,
                    solver=getattr(cfg, "solver", "direct"),
                    band=cfg.fixed_interval,
                    robust=getattr(cfg, "robust_loss", "none"),
                    robust_delta=getattr(cfg, "robust_delta", 1.0))


def optimize_sharded(
    poses0: jnp.ndarray,
    graph: PoseGraph,
    mesh,
    axis: str = "dp",
    max_iters: int = 50,
    lambda_init: float = 1e-4,
    lambda_up: float = 10.0,
    lambda_down: float = 0.1,
    cost_rtol: float = 1e-9,
    band: int = 10,
    robust: str = "none",
    robust_delta: float = 1.0,
) -> LMResult:
    """Multi-chip pose-graph LM: FACTOR-parallel linearization + assembly.

    The single-chip banded solver's 12.6 ms/LM-iteration is dominated by
    parallel work — the batched per-factor r+J forward-mode pass, the
    J^T J block products, and the super-block Hessian scatters (PERF.md
    "Pose graph: at its per-iteration floor") — not by the SPIKE solve's
    ~96-step sequential chain. This optimizer therefore shards the FACTOR
    axis over the mesh while POSES replicate: each device linearizes its
    contiguous shard of between + loop factors and scatters its
    contributions into a local gradient and local super-block tridiagonal
    (A, O) arrays; ONE fused psum per LM iteration combines them (~3.7 MB
    at dataset scale: (n_sup, 3*band, 3*band) x 2 + (n, 3) — vs the
    ~5.4k-factor linearization work it divides by D); the prior, the
    lambda damping, and the padding-identity blocks are added AFTER the
    psum from replicated values so they count exactly once; the SPIKE
    solve and the LM accept/damping control flow run replicated (psum
    results are identical on every device, so control flow cannot
    diverge). Exactness: same per-factor math as _optimize_jit's banded
    path; the only difference is summation ORDER in the scatter-adds
    (within-shard then cross-device), so results match the single-chip
    optimizer to float reassociation — the 8-device CPU-mesh tests pin
    poses to ~1e-5 and the final cost to ~1e-8 relative (the iteration
    count may differ by one when reassociation moves the step where the
    relative decrease crosses cost_rtol).

    BANDED solver only: every live loop factor must span <= band poses
    (the pipeline's fixed-interval graphs, reference main.py:158-161).
    Wide/reversed arcs raise when the indices are concrete, mirroring
    optimize()'s host-side guard (no silent fallback — the direct
    solver's Woodbury panel is not sharded).
    """
    from jax.sharding import PartitionSpec

    n = poses0.shape[0]
    dtype = poses0.dtype
    n_dev = mesh.shape[axis]

    if graph.loop_i.shape[0] and not (
            isinstance(graph.loop_i, jax.core.Tracer)
            or isinstance(graph.loop_j, jax.core.Tracer)):
        import numpy as np
        span = np.asarray(graph.loop_j) - np.asarray(graph.loop_i)
        if not isinstance(graph.loop_mask, jax.core.Tracer):
            span = span[np.asarray(graph.loop_mask).astype(bool)]
        if span.size and (int(span.max()) > band or int(span.min()) < 0):
            raise ValueError(
                f"optimize_sharded is banded-only: loop spans must lie in "
                f"[0, band={band}], got [{int(span.min())}, "
                f"{int(span.max())}] — use the single-device "
                "solver='direct' path for wide/reversed arcs")

    # ---- pad the factor axes to multiples of the mesh axis. Padded
    # factors carry mask 0 and benign indices; their zeroed J/r blocks
    # scatter zeros, so they are exact no-ops on every device.
    Bf = graph.between_meas.shape[0]
    Bp = max(-(-Bf // n_dev) * n_dev, n_dev)
    bfi = jnp.concatenate([jnp.arange(Bf, dtype=jnp.int32),
                           jnp.zeros(Bp - Bf, jnp.int32)])
    bfj = jnp.concatenate([jnp.arange(1, Bf + 1, dtype=jnp.int32),
                           jnp.ones(Bp - Bf, jnp.int32)])
    bmask = jnp.arange(Bp) < Bf
    bmeas = jnp.concatenate([
        graph.between_meas,
        jnp.broadcast_to(jnp.eye(3, dtype=dtype), (Bp - Bf, 3, 3))])

    Lf = graph.loop_i.shape[0]
    Lp = max(-(-max(Lf, 1) // n_dev) * n_dev, n_dev)
    lfi = jnp.concatenate([graph.loop_i.astype(jnp.int32),
                           jnp.zeros(Lp - Lf, jnp.int32)])
    lfj = jnp.concatenate([graph.loop_j.astype(jnp.int32),
                           jnp.zeros(Lp - Lf, jnp.int32)])
    lmask = jnp.concatenate([graph.loop_mask.astype(bool),
                             jnp.zeros(Lp - Lf, bool)])
    lmeas = jnp.concatenate([
        graph.loop_meas,
        jnp.broadcast_to(jnp.eye(3, dtype=dtype), (Lp - Lf, 3, 3))])

    # ---- static super-block geometry (identical to banded_solve)
    G = band
    bs = 3 * G
    n_sup = -(-n // G)
    n_padded = n_sup * G
    ii = jnp.arange(3)[:, None]
    jj = jnp.arange(3)[None, :]
    s_all = jnp.arange(n) // G
    o_all = jnp.arange(n) % G
    eye3n = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (n, 3, 3))
    # lambda-damping template: eye3 at every LIVE pose's diagonal block
    eye_live = jnp.zeros((n_sup, bs, bs), dtype).at[
        s_all[:, None, None], (3 * o_all)[:, None, None] + ii,
        (3 * o_all)[:, None, None] + jj].add(eye3n)
    # padded-tail poses: identity diagonal, zero coupling, zero rhs
    eye_pad = jnp.zeros((n_sup, bs, bs), dtype)
    if n_padded != n:
        pad = jnp.arange(n, n_padded)
        eye_pad = eye_pad.at[
            pad[:, None, None] // G, (3 * (pad % G))[:, None, None] + ii,
            (3 * (pad % G))[:, None, None] + jj].add(
            jnp.broadcast_to(jnp.eye(3, dtype=dtype), (n_padded - n, 3, 3)))

    inv_btw = 1.0 / graph.between_sigmas
    inv_loop = 1.0 / graph.loop_sigmas
    inv_prior = 1.0 / graph.prior_sigmas
    T_prior_inv = se2.inverse_T(se2.T_from_pose(graph.prior_pose))

    def jtj(Ja, Jb):
        return jnp.einsum("bij,bik->bjk", Ja, Jb, precision=_HI)

    def shard_fn(x0, bfi_l, bfj_l, bmeas_l, bmask_l,
                 lfi_l, lfj_l, lmeas_l, lmask_l):
        def prior_r(x):
            return se2.log_se2(
                p_matmul(T_prior_inv, se2.T_from_pose(x[0]))) * inv_prior

        def loop_blocks(rl, Jli=None, Jlj=None):
            """Robust reweight + loop cost from (masked) loop residuals."""
            if robust == "none":
                return rl, Jli, Jlj, 0.5 * jnp.sum(rl * rl)
            w, rho = _robust_w_rho(jnp.sum(rl * rl, axis=1), robust,
                                   robust_delta)
            sw = jnp.sqrt(w)[:, None]
            if Jli is not None:
                Jli = Jli * sw[..., None]
                Jlj = Jlj * sw[..., None]
            return rl * sw, Jli, Jlj, jnp.sum(rho)

        def cost_at(x):
            rb = jax.vmap(_factor_residual, in_axes=(0, 0, 0, None))(
                x[bfi_l], x[bfj_l], bmeas_l, inv_btw)
            rb = rb * bmask_l.astype(dtype)[:, None]
            rl = jax.vmap(_factor_residual, in_axes=(0, 0, 0, None))(
                x[lfi_l], x[lfj_l], lmeas_l, inv_loop)
            rl = rl * lmask_l.astype(dtype)[:, None]
            _, _, _, loop_cost = loop_blocks(rl)
            cost_loc = 0.5 * jnp.sum(rb * rb) + loop_cost
            rp = prior_r(x)
            return jax.lax.psum(cost_loc, axis) + 0.5 * jnp.dot(rp, rp)

        def linearize(x):
            rb, (Jbi, Jbj) = _factor_r_and_J(x[bfi_l], x[bfj_l], bmeas_l,
                                             inv_btw)
            wb = bmask_l.astype(dtype)[:, None]
            rb = rb * wb
            Jbi = Jbi * wb[..., None]
            Jbj = Jbj * wb[..., None]
            rl, (Jli, Jlj) = _factor_r_and_J(x[lfi_l], x[lfj_l], lmeas_l,
                                             inv_loop)
            wl = lmask_l.astype(dtype)[:, None]
            rl = rl * wl
            Jli = Jli * wl[..., None]
            Jlj = Jlj * wl[..., None]
            rl, Jli, Jlj, loop_cost = loop_blocks(rl, Jli, Jlj)
            cost_loc = 0.5 * jnp.sum(rb * rb) + loop_cost

            g_loc = jnp.zeros((n, 3), dtype)
            g_loc = g_loc.at[bfi_l].add(
                jnp.einsum("bij,bi->bj", Jbi, rb, precision=_HI))
            g_loc = g_loc.at[bfj_l].add(
                jnp.einsum("bij,bi->bj", Jbj, rb, precision=_HI))
            g_loc = g_loc.at[lfi_l].add(
                jnp.einsum("bij,bi->bj", Jli, rl, precision=_HI))
            g_loc = g_loc.at[lfj_l].add(
                jnp.einsum("bij,bi->bj", Jlj, rl, precision=_HI))

            # per-pose diagonal blocks from THIS shard's factors
            D = jnp.zeros((n, 3, 3), dtype)
            D = D.at[bfi_l].add(jtj(Jbi, Jbi))
            D = D.at[bfj_l].add(jtj(Jbj, Jbj))
            D = D.at[lfi_l].add(jtj(Jli, Jli))
            D = D.at[lfj_l].add(jtj(Jlj, Jlj))

            # off-diagonal pose-pair blocks M = H[r, c] (r > c, r - c <= G)
            off_r = jnp.concatenate([bfj_l, lfj_l])
            off_c = jnp.concatenate([bfi_l, lfi_l])
            off_M = jnp.concatenate([jtj(Jbj, Jbi), jtj(Jlj, Jli)])

            # the SHARED super-block scatter (_banded_scatter — the same
            # helper banded_solve calls, so the two exactness-coupled
            # paths cannot drift), minus lambda/prior/padding: those are
            # added once, post-psum, from replicated values
            A_loc, O_loc = _banded_scatter(n, G, dtype, D, off_r, off_c,
                                           off_M)

            # ONE fused collective per LM iteration
            return jax.lax.psum((A_loc, O_loc, g_loc, cost_loc), axis)

        def step(state):
            x, lam, cost, it, done, stalls = state
            A_sup, O_sup, g, _ = linearize(x)
            rp = prior_r(x)
            Jp = jax.jacfwd(lambda p: se2.log_se2(
                p_matmul(T_prior_inv, se2.T_from_pose(p))) * inv_prior)(x[0])
            g = g.at[0].add(jnp.matmul(Jp.T, rp, precision=_HI))
            A_sup = A_sup + lam * eye_live + eye_pad
            A_sup = A_sup.at[0, 0:3, 0:3].add(_dot(Jp.T, Jp))
            R_sup = _banded_rhs(g, n, G, dtype)
            X = block_tridiag_solve(A_sup, O_sup[:n_sup - 1], R_sup, q=32)
            dx = X.reshape(n_padded, 3)[:n]
            x_new = x + dx
            cost_new = cost_at(x_new)
            accept = cost_new < cost
            x = jnp.where(accept, x_new, x)
            lam = jnp.where(accept, lam * lambda_down, lam * lambda_up)
            improved = (cost - cost_new) > cost_rtol * jnp.maximum(cost, 1.0)
            converged = accept & ~improved
            stalls = jnp.where(accept & improved, 0, stalls + 1)
            done = converged | (stalls >= 3) | (lam > 1e10)
            cost = jnp.where(accept, cost_new, cost)
            return (x, lam, cost, it + 1, done, stalls)

        def cond(state):
            it, done = state[3], state[4]
            return (~done) & (it < max_iters)

        state = (x0, jnp.asarray(lambda_init, dtype), cost_at(x0),
                 jnp.asarray(0), jnp.asarray(False), jnp.asarray(0))
        x, lam, cost, it, _, _ = jax.lax.while_loop(cond, step, state)
        return LMResult(poses=x, cost=cost, iterations=it, final_lambda=lam)

    Pn = PartitionSpec()
    Pa = PartitionSpec(axis)
    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(Pn, Pa, Pa, Pa, Pa, Pa, Pa, Pa, Pa),
        out_specs=LMResult(poses=Pn, cost=Pn, iterations=Pn,
                           final_lambda=Pn),
    )(poses0, bfi, bfj, bmeas, bmask, lfi, lfj, lmeas, lmask)


@partial(jax.jit, static_argnames=("cfg",))
def optimize_trajectory(
    poses0: jnp.ndarray,
    relative_poses: jnp.ndarray,
    loop_i: jnp.ndarray,
    loop_j: jnp.ndarray,
    loop_meas: jnp.ndarray,
    loop_mask: jnp.ndarray,
    cfg: PoseGraphConfig = PoseGraphConfig(),
) -> LMResult:
    """Fused graph assembly + LM solve in ONE jit entry point.

    Fusing the whole pose-graph stage (reference: main.py:148-189) into a
    single dispatch removes the host round trips that make_graph followed
    by optimize as separate eager calls would pay."""
    graph = make_graph(relative_poses, cfg, loop_i=loop_i, loop_j=loop_j,
                       loop_meas=loop_meas, loop_mask=loop_mask)
    return optimize_with_config(poses0, graph, cfg)
