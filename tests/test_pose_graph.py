import numpy as np
import jax.numpy as jnp
import pytest

from lidar_slam.config import PoseGraphConfig
from lidar_slam.models import pose_graph
from lidar_slam.utils import se2


def _np_T(pose):
    x, y, th = pose
    return np.array([[np.cos(th), -np.sin(th), x],
                     [np.sin(th), np.cos(th), y],
                     [0, 0, 1.0]])


def _np_log_se2(T):
    w = np.arctan2(T[1, 0], T[0, 0])
    t = T[:2, 2]
    if abs(w) < 1e-9:
        a, b = 1.0, w / 2
    else:
        a, b = np.sin(w) / w, (1 - np.cos(w)) / w
    Vinv = np.array([[a, b], [-b, a]]) / (a * a + b * b)
    u = Vinv @ t
    return np.array([u[0], u[1], w])


def test_log_exp_roundtrip():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 1.0, (32, 3))
    back = np.asarray(se2.log_se2(se2.exp_se2(jnp.asarray(xi))))
    # omega within (-pi, pi) round-trips exactly
    sel = np.abs(xi[:, 2]) < np.pi - 1e-3
    np.testing.assert_allclose(back[sel], xi[sel], atol=1e-10)


def test_log_matches_numpy_spec():
    rng = np.random.default_rng(1)
    poses = rng.normal(0, 1.0, (16, 3))
    T = se2.T_from_pose(jnp.asarray(poses))
    got = np.asarray(se2.log_se2(T))
    want = np.stack([_np_log_se2(_np_T(p)) for p in poses])
    np.testing.assert_allclose(got, want, atol=1e-10)


def _chain_graph(rng, n=40, drift=0.02, loops=True):
    """Ground-truth loopy trajectory + noisy odometry measurements."""
    t = np.linspace(0, 2 * np.pi, n)
    gt = np.stack([3 * np.cos(t), 3 * np.sin(t), t + np.pi / 2], axis=1)
    # relative measurements corrupted with noise
    rel_meas = []
    for i in range(n - 1):
        rel = np.linalg.inv(_np_T(gt[i])) @ _np_T(gt[i + 1])
        noise = se2.exp_se2(jnp.asarray(rng.normal(0, drift, 3)))
        rel_meas.append(rel @ np.asarray(noise))
    rel_meas = np.stack(rel_meas)

    if loops:
        li = np.array([0, 5, 10])
        lj = np.array([n - 1, n - 7, n - 12])
        lm = np.stack([np.linalg.inv(_np_T(gt[a])) @ _np_T(gt[b])
                       for a, b in zip(li, lj)])
        mask = np.ones(3, bool)
    else:
        li = lj = np.zeros((0,), np.int32)
        lm = np.zeros((0, 3, 3))
        mask = np.zeros((0,), bool)

    graph = pose_graph.make_graph(
        jnp.asarray(rel_meas), PoseGraphConfig(),
        prior_pose=jnp.asarray(gt[0]),
        loop_i=jnp.asarray(li), loop_j=jnp.asarray(lj),
        loop_meas=jnp.asarray(lm), loop_mask=jnp.asarray(mask))

    # initial estimate: integrate noisy odometry from the prior
    init = [gt[0]]
    T = _np_T(gt[0])
    for i in range(n - 1):
        T = T @ rel_meas[i]
        init.append([T[0, 2], T[1, 2], np.arctan2(T[1, 0], T[0, 0])])
    return gt, graph, np.array(init)


def test_optimize_pulls_loopy_graph_to_ground_truth():
    rng = np.random.default_rng(2)
    gt, graph, init = _chain_graph(rng, n=40, drift=0.03)
    res = pose_graph.optimize_with_config(jnp.asarray(init), graph)
    opt = np.asarray(res.poses)

    err_init = np.linalg.norm(init[:, :2] - gt[:, :2], axis=1).mean()
    err_opt = np.linalg.norm(opt[:, :2] - gt[:, :2], axis=1).mean()
    assert err_opt < err_init * 0.5
    assert float(res.cost) < 0.5 * float(
        pose_graph.graph_cost(jnp.asarray(init), graph))


def test_optimum_matches_scipy_least_squares():
    """Independent solver cross-check: scipy.optimize.least_squares on the
    identical residual function must find the same optimum."""
    from scipy.optimize import least_squares
    rng = np.random.default_rng(3)
    gt, graph, init = _chain_graph(rng, n=12, drift=0.05)

    res = pose_graph.optimize_with_config(jnp.asarray(init), graph)

    def np_res(xflat):
        return np.asarray(pose_graph.residuals(
            jnp.asarray(xflat.reshape(-1, 3)), graph))

    sp = least_squares(np_res, init.reshape(-1), method="lm", xtol=1e-14,
                       ftol=1e-14)
    cost_sp = 0.5 * np.sum(sp.fun ** 2)
    cost_us = float(res.cost)
    # same basin, same optimum value
    np.testing.assert_allclose(cost_us, cost_sp, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(np.asarray(res.poses).reshape(-1),
                               sp.x, atol=1e-3)


def test_gradient_near_zero_at_optimum():
    import jax
    rng = np.random.default_rng(4)
    _, graph, init = _chain_graph(rng, n=20, drift=0.02)
    res = pose_graph.optimize_with_config(jnp.asarray(init), graph)
    g = jax.grad(lambda p: pose_graph.graph_cost(p, graph))(res.poses)
    assert float(jnp.abs(g).max()) < 1e-4


def test_masked_loops_equal_no_loops():
    rng = np.random.default_rng(5)
    _, graph_loops, init = _chain_graph(rng, n=20, drift=0.02, loops=True)
    graph_masked = graph_loops._replace(
        loop_mask=jnp.zeros_like(graph_loops.loop_mask))
    rng = np.random.default_rng(5)
    _, graph_none, _ = _chain_graph(rng, n=20, drift=0.02, loops=False)

    r_masked = pose_graph.optimize_with_config(jnp.asarray(init), graph_masked)
    r_none = pose_graph.optimize_with_config(jnp.asarray(init), graph_none)
    np.testing.assert_allclose(np.asarray(r_masked.poses),
                               np.asarray(r_none.poses), atol=1e-6)


def test_prior_anchors_gauge():
    rng = np.random.default_rng(6)
    gt, graph, init = _chain_graph(rng, n=15, drift=0.01)
    res = pose_graph.optimize_with_config(jnp.asarray(init), graph)
    # pose 0 stays within the prior sigma of its measured value
    np.testing.assert_allclose(np.asarray(res.poses)[0], gt[0], atol=0.05)


def _interval_graph(rng, n, G, span_mode="fixed"):
    """Noisy chain + loops whose spans never exceed G (the banded-solver
    contract). span_mode="mixed" uses arbitrary spans in [1, G] at
    arbitrary offsets (same-super and cross-super cases)."""
    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0)
    rel = se2.get_relative_pose(jnp.asarray(gt[:-1]), jnp.asarray(gt[1:]))
    rel = se2.T_from_pose(se2.pose_from_T(rel)
                          + jnp.asarray(rng.normal(0, 0.01, (n - 1, 3))))
    if span_mode == "fixed":
        li = np.arange(0, n - G - 1, G)
        lj = li + G
    elif span_mode == "none":
        li = np.zeros((0,), np.int64)
        lj = li
    else:
        li = rng.integers(0, n - G, 25)
        lj = li + rng.integers(1, G + 1, 25)
    lm = se2.get_relative_pose(jnp.asarray(gt[li]), jnp.asarray(gt[lj]))
    mask = jnp.asarray(rng.random(len(li)) > 0.3)
    init = jnp.asarray(gt + rng.normal(0, 0.02, (n, 3)))
    graph = pose_graph.make_graph(
        rel, PoseGraphConfig(), loop_i=jnp.asarray(li),
        loop_j=jnp.asarray(lj), loop_meas=lm, loop_mask=mask)
    return init, graph


@pytest.mark.parametrize("n,G,span_mode", [
    (97, 10, "fixed"),    # n % G != 0 (padded tail super-block)
    (100, 10, "mixed"),   # arbitrary offsets and spans <= G
    (64, 7, "mixed"),
    (205, 10, "fixed"),   # n_sup > 2q: exercises the SPIKE path
])
def test_banded_solver_matches_direct(n, G, span_mode):
    """The banded super-block solver must reach the same optimum as the
    any-topology Woodbury solver on fixed-interval graphs (its contract:
    max(loop_j - loop_i) <= band)."""
    rng = np.random.default_rng(n * 7 + G)
    init, graph = _interval_graph(rng, n, G, span_mode)
    rd = pose_graph.optimize(init, graph, max_iters=30, solver="direct")
    rb = pose_graph.optimize(init, graph, max_iters=30, solver="banded",
                             band=G)
    assert int(rd.iterations) == int(rb.iterations)
    np.testing.assert_allclose(np.asarray(rb.poses), np.asarray(rd.poses),
                               atol=1e-5)
    np.testing.assert_allclose(float(rb.cost), float(rd.cost), rtol=1e-6)


def test_banded_solver_falls_back_on_wide_loops():
    """optimize(solver='banded') with a CONCRETE loop arc wider than `band`
    must fall back to the exact any-topology solver instead of silently
    dropping the loop's Hessian blocks (round-2 advisor finding)."""
    rng = np.random.default_rng(23)
    n = 60
    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    rel = se2.get_relative_pose(jnp.asarray(gt[:-1]), jnp.asarray(gt[1:]))
    li = jnp.asarray(np.array([3, 10]))
    lj = jnp.asarray(np.array([48, 20]))  # span 45 >> band 10
    lm = se2.get_relative_pose(jnp.asarray(gt[np.asarray(li)]),
                               jnp.asarray(gt[np.asarray(lj)]))
    graph = pose_graph.make_graph(
        rel, PoseGraphConfig(), loop_i=li, loop_j=lj, loop_meas=lm,
        loop_mask=jnp.ones(2, bool))
    init = jnp.asarray(gt + rng.normal(0, 0.05, (n, 3)))
    rb = pose_graph.optimize(init, graph, max_iters=30, solver="banded",
                             band=10)
    rd = pose_graph.optimize(init, graph, max_iters=30, solver="direct")
    # identical, not merely close: the fallback runs the same solver
    np.testing.assert_array_equal(np.asarray(rb.poses), np.asarray(rd.poses))

    # wide loops that are all MASKED OUT contribute zero blocks, so the
    # banded solver stays in effect (and must still match direct)
    graph0 = graph._replace(loop_mask=jnp.zeros(2, bool))
    rb0 = pose_graph.optimize(init, graph0, max_iters=30, solver="banded",
                              band=10)
    rd0 = pose_graph.optimize(init, graph0, max_iters=30, solver="direct")
    np.testing.assert_allclose(np.asarray(rb0.poses), np.asarray(rd0.poses),
                               atol=1e-6)

    # REVERSED arcs (loop_i > loop_j) violate the banded lower-triangle
    # assembly even within the band — they must fall back too (round-3
    # review: the signed-span check let them through)
    graph_r = graph._replace(
        loop_i=graph.loop_j, loop_j=graph.loop_i,
        loop_meas=se2.inverse_T(graph.loop_meas))
    rb_r = pose_graph.optimize(init, graph_r, max_iters=30, solver="banded",
                               band=10)
    rd_r = pose_graph.optimize(init, graph_r, max_iters=30, solver="direct")
    np.testing.assert_array_equal(np.asarray(rb_r.poses),
                                  np.asarray(rd_r.poses))


def test_banded_solver_tiny_graph():
    """n <= band => a single super-block and NO off-diagonals; this used
    to crash _thomas with a zero-length scan mismatch (round-2 review)."""
    rng = np.random.default_rng(11)
    init, graph = _interval_graph(rng, 8, 10, "none")
    rd = pose_graph.optimize(init, graph, max_iters=20, solver="direct")
    rb = pose_graph.optimize(init, graph, max_iters=20, solver="banded",
                             band=10)
    np.testing.assert_allclose(np.asarray(rb.poses), np.asarray(rd.poses),
                               atol=1e-6)


def test_run_slam_fixed_interval_syncs_banded_band():
    """run_slam(fixed_interval=K) must solve with band=K even though the
    config default is 10 — a mismatch silently drops loop Hessian blocks
    spanning more than `band` poses (round-2 review)."""
    from lidar_slam.models import slam
    from lidar_slam.utils import io as io_utils

    data = io_utils.synthetic_dataset(n_steps=90, n_rays=180, seed=9)
    kw = dict(counts=data["encoder"]["counts"],
              gyro=data["imu"]["angular_velocity"],
              ranges=data["lidar"]["ranges"],
              range_min=0.1, range_max=30.0, mode="gtsam",
              build_map=False, chunk_size=16)
    res20 = slam.run_slam(fixed_interval=20, **kw)
    # reference for span-20 loops: the any-topology direct solver
    import dataclasses
    from lidar_slam.config import SlamConfig, PoseGraphConfig
    cfg_direct = dataclasses.replace(
        SlamConfig(), pose_graph=PoseGraphConfig(solver="direct"))
    res20_direct = slam.run_slam(fixed_interval=20, cfg=cfg_direct, **kw)
    np.testing.assert_allclose(res20.poses_optimized,
                               res20_direct.poses_optimized, atol=1e-4)
