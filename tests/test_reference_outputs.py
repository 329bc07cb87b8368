"""Regression tests against the reference's COMMITTED real-data artifacts.

`/root/reference/outputs/*.npy` are the only real dataset-20 data shipped
with the reference (the raw datasets are gitignored — SURVEY.md section 0):
poses and relative SE(2) transforms for the odometry and scan-matching
stages, plus the GTSAM-optimized trajectory. They pin:

  - compose-chain semantics: the reference builds its global trajectories by
    prefix-composing the relative transforms from identity
    (reference: modules/localization.py:118-130, main.py:107-124);
  - the pose-graph solver at the real problem's scale and curvature: the
    loop-free subgraph (prior + 4,955 between factors, main.py:148-155) has
    the committed scan-matching chain as its EXACT global optimum, so our LM
    must (a) not move it when started there and (b) recover it from the real
    odometry start;
  - the evaluation metrics on real (not synthetic) trajectories.

All tests skip cleanly when the reference tree is absent.
"""

import os

import numpy as np
import pytest

_OUT = "/root/reference/outputs"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(_OUT), reason="reference outputs not available")


@pytest.fixture(scope="module")
def ref():
    return {
        "p_odom": np.load(os.path.join(_OUT, "poses_odom_20.npy")),
        "rp_odom": np.load(os.path.join(_OUT, "relative_poses_odom_20.npy")),
        "p_sm": np.load(os.path.join(_OUT, "poses_scan_matching_20.npy")),
        "rp_sm": np.load(
            os.path.join(_OUT, "relative_poses_scan_matching_20.npy")),
        "p_opt": np.load(os.path.join(_OUT, "poses_optimized_20.npy")),
    }


def _wrapdiff(a, b):
    return np.abs(np.arctan2(np.sin(a - b), np.cos(a - b)))


@pytest.mark.parametrize("poses_key,rel_key", [
    ("p_odom", "rp_odom"), ("p_sm", "rp_sm")])
def test_compose_chain_reproduces_committed_trajectories(ref, poses_key,
                                                         rel_key):
    """se2.compose_chain over the committed relative transforms must
    reproduce the committed global trajectory (the reference composes them
    exactly that way: modules/localization.py:127 for scan matching,
    localization.py:84-89 for odometry)."""
    import jax.numpy as jnp

    from lidar_slam.utils import se2

    chain = se2.compose_chain(jnp.asarray(ref[rel_key]))
    poses = np.asarray(se2.pose_from_T(chain))
    expected = ref[poses_key]
    assert poses.shape == expected.shape == (4956, 3)
    np.testing.assert_allclose(poses[:, :2], expected[:, :2], atol=1e-10)
    assert _wrapdiff(poses[:, 2], expected[:, 2]).max() < 1e-10


def test_lm_stationary_at_committed_chain_optimum(ref):
    """The committed scan-matching chain is the exact optimum of the
    loop-free graph (prior at origin + between factors = its own relative
    poses, reference main.py:148-155). Started THERE, our LM must not move
    it materially."""
    import jax.numpy as jnp

    from lidar_slam.models import pose_graph as pg

    g = pg.make_graph(jnp.asarray(ref["rp_sm"]))
    p_sm = jnp.asarray(ref["p_sm"])
    c0 = float(pg.graph_cost(p_sm, g))
    assert c0 < 1e-20  # chain consistency: residuals vanish at the optimum

    res = pg.optimize(p_sm, g, max_iters=5, solver="direct")
    assert float(res.cost) <= c0 + 1e-20
    assert float(jnp.abs(res.poses - p_sm).max()) < 1e-9


def test_lm_recovers_committed_chain_from_real_odometry_start(ref):
    """Full-scale solve on the real 4,955-factor graph: from the committed
    ODOMETRY trajectory (4.3 m ATE away), LM must recover the committed
    scan-matching chain to numerical precision — the loop-free graph's
    unique global optimum under the origin prior."""
    import jax.numpy as jnp

    from lidar_slam.models import pose_graph as pg
    from lidar_slam.utils import metrics

    g = pg.make_graph(jnp.asarray(ref["rp_sm"]))
    c_init = float(pg.graph_cost(jnp.asarray(ref["p_odom"]), g))
    assert c_init > 1.0  # the odometry start is genuinely far

    # cost_rtol=0: polish to machine precision — this test pins the
    # solver's CAPABILITY to recover the chain exactly, independent of the
    # shipping GTSAM-parity stopping schedule (which exits ~1e-5-relative
    # earlier and lands at ~2e-8 ATE)
    res = pg.optimize(jnp.asarray(ref["p_odom"]), g, max_iters=60,
                      solver="direct", cost_rtol=0.0)
    assert float(res.cost) < 1e-18
    ate = metrics.ate_translation(np.asarray(res.poses), ref["p_sm"],
                                  align=False)
    assert ate["rmse"] < 1e-8
    assert ate["max"] < 1e-8


def test_lm_never_worsens_committed_gtsam_optimum(ref):
    """Partial GTSAM-optimum evidence (the full check needs the raw scans
    for loop factors, reference main.py:161-172): on the loop-free
    subgraph, starting AT the committed GTSAM-optimized trajectory, every
    accepted LM step must REDUCE the graph cost — the solver never damages
    the committed solution."""
    import jax.numpy as jnp

    from lidar_slam.models import pose_graph as pg

    g = pg.make_graph(jnp.asarray(ref["rp_sm"]))
    p_opt = jnp.asarray(ref["p_opt"])
    c0 = float(pg.graph_cost(p_opt, g))
    # GTSAM's optimum trades chain consistency against its loop factors, so
    # the loop-free cost is moderate but nonzero
    assert 1.0 < c0 < 100.0

    res = pg.optimize(p_opt, g, max_iters=10, solver="direct")
    assert float(res.cost) <= c0


def test_metrics_on_real_trajectories(ref):
    """ATE/RPE exercised on the real committed arrays with value pins from
    the actual dataset (identity self-check + cross-stage magnitudes)."""
    from lidar_slam.utils import metrics

    ident = metrics.ate_translation(ref["p_sm"], ref["p_sm"])
    # self-ATE is zero up to the rigid-alignment round-off
    assert ident["rmse"] < 1e-12 and ident["max"] < 1e-12

    # odometry drifts meters from the scan-matched trajectory at dataset
    # scale; the optimized trajectory sits between them
    ate_odom = metrics.ate_translation(ref["p_odom"], ref["p_sm"])
    assert 1.0 < ate_odom["rmse"] < 10.0
    ate_opt = metrics.ate_translation(ref["p_opt"], ref["p_sm"])
    assert 0.5 < ate_opt["rmse"] < ate_odom["rmse"]

    # per-step drift is small even for raw odometry
    rpe = metrics.relative_pose_error(ref["p_odom"], ref["p_sm"])
    assert 0.0 < rpe["trans_rmse"] < 0.1
    assert 0.0 < rpe["rot_rmse_deg"] < 2.0


def test_gtsam_mode_graph_vs_committed_optimized_trajectory(ref):
    """Reconstruct the reference's gtsam-mode pose graph as far as the
    committed artifacts allow and bound our solution against the committed
    `poses_optimized_20.npy` (the one indirect leg of
    the GTSAM-equivalence evidence).

    Reconstructed exactly (reference main.py:148-155): prior at the origin
    with sigmas [.1,.1,.1]; 4,955 between factors = the committed
    scan-matching relative poses with sigmas [.3,.3,.3] (our
    PoseGraphConfig defaults — asserted here). Reconstructed approximately
    (main.py:158-172): the fixed-interval-10 loop factors. Their true
    measurements are `run_icp(z_i, z_j)` on raw scans that are gitignored
    upstream; the reconstructable stand-in is the chain-consistent relative
    pose T_i^-1 T_j from the committed scan-matching chain (the same scans'
    matched trajectory). The reference's acceptance gates ARE
    reconstructable: max_distance = max per-step encoder distance = max
    odometry step translation (main.py:94-100, poses_from_odometry's
    v*dt), and max_yaw = max |gyro_z|*dt in degrees = max odometry step
    yaw (main.py:101).

    Documented residual: with chain-consistent loop measurements the graph
    optimum IS the committed scan-matching chain, so the gap to
    `poses_optimized_20.npy` equals the pull of the true ICP loop
    measurements — measured here at ATE(p_sm, p_opt) rmse ~0.66 m. The
    bound asserts (a) our optimizer lands within that documented envelope
    of the committed optimum and (b) on the reconstructed graph our
    solution's cost is <= the committed optimized trajectory's cost (the
    committed answer solves a slightly different graph, so ours must
    dominate on this one)."""
    import jax.numpy as jnp

    from lidar_slam.config import PoseGraphConfig
    from lidar_slam.models import pose_graph as pg
    from lidar_slam.utils import metrics, se2

    cfg = PoseGraphConfig()
    assert tuple(cfg.prior_sigmas) == (0.1, 0.1, 0.1)  # main.py:149
    assert tuple(cfg.between_sigmas) == (0.3, 0.3, 0.3)  # main.py:151
    assert tuple(cfg.loop_sigmas) == (0.3, 0.3, 0.3)  # main.py:168
    assert cfg.fixed_interval == 10  # main.py:20

    # the reference's gates, from the committed odometry relative poses
    rp_odom = ref["rp_odom"]
    max_distance = float(np.linalg.norm(rp_odom[:, :2, 2], axis=1).max())
    step_yaw = np.abs(np.arctan2(rp_odom[:, 1, 0], rp_odom[:, 0, 0]))
    max_yaw_deg = float(np.degrees(step_yaw.max()))
    assert 0.01 < max_distance < 1.0 and 0.1 < max_yaw_deg < 45.0

    p_sm = jnp.asarray(ref["p_sm"])
    T = se2.T_from_pose(p_sm)
    n = p_sm.shape[0]
    loop_i = np.arange(0, n - cfg.fixed_interval, cfg.fixed_interval,
                       dtype=np.int32)
    loop_j = loop_i + cfg.fixed_interval
    loop_meas = np.asarray(
        jnp.matmul(se2.inverse_T(T[loop_i]), T[loop_j]))
    # reference gate (main.py:167): translation < max_distance AND
    # yaw DEGREES < max_yaw (note: signed angle, the reference quirk)
    trans = np.linalg.norm(loop_meas[:, :2, 2], axis=1)
    ang = np.degrees(np.arctan2(loop_meas[:, 1, 0], loop_meas[:, 0, 0]))
    gate = (trans < max_distance) & (ang < max_yaw_deg)
    assert 0 < gate.sum() < len(gate)  # the gate genuinely filters

    g = pg.make_graph(jnp.asarray(ref["rp_sm"]), cfg,
                      loop_i=jnp.asarray(loop_i),
                      loop_j=jnp.asarray(loop_j),
                      loop_meas=jnp.asarray(loop_meas),
                      loop_mask=jnp.asarray(gate))
    res = pg.optimize(p_sm, g, max_iters=10, solver="direct")

    # (b) dominance on the reconstructed graph: the committed optimized
    # trajectory answers a different loop set, so ours must cost no more
    cost_opt = float(pg.graph_cost(jnp.asarray(ref["p_opt"]), g))
    assert float(res.cost) <= cost_opt

    # (a) the committed optimized trajectory sits within the documented
    # loop-factor envelope of our solution
    ate_envelope = metrics.ate_translation(ref["p_sm"], ref["p_opt"],
                                           align=False)
    ate_ours = metrics.ate_translation(np.asarray(res.poses), ref["p_opt"],
                                       align=False)
    assert ate_ours["rmse"] <= ate_envelope["rmse"] + 0.05
    # and our solve stays essentially at the chain (its true optimum here)
    ate_chain = metrics.ate_translation(np.asarray(res.poses), ref["p_sm"],
                                        align=False)
    assert ate_chain["rmse"] < 0.05


def test_banded_solver_on_real_chain_with_fixed_interval_loops(ref):
    """The production 'banded' solver on the real chain, with synthetic
    fixed-interval loop closures whose measurements are consistent with the
    committed chain (interval 10, reference main.py:158-161): the committed
    trajectory stays the optimum, and banded agrees with 'direct'."""
    import jax.numpy as jnp

    from lidar_slam.models import pose_graph as pg
    from lidar_slam.utils import se2

    p_sm = jnp.asarray(ref["p_sm"])
    T = se2.T_from_pose(p_sm)
    loop_i = jnp.arange(0, p_sm.shape[0] - 10, 10, dtype=jnp.int32)
    loop_j = loop_i + 10
    loop_meas = jnp.matmul(se2.inverse_T(T[loop_i]), T[loop_j])
    mask = jnp.ones(loop_i.shape[0], bool)

    g = pg.make_graph(jnp.asarray(ref["rp_sm"]), loop_i=loop_i,
                      loop_j=loop_j, loop_meas=loop_meas, loop_mask=mask)
    res_b = pg.optimize(jnp.asarray(ref["p_odom"]), g, max_iters=60,
                        solver="banded", band=10)
    res_d = pg.optimize(jnp.asarray(ref["p_odom"]), g, max_iters=60,
                        solver="direct")
    assert float(res_b.cost) < 1e-16
    np.testing.assert_allclose(np.asarray(res_b.poses),
                               np.asarray(res_d.poses), atol=1e-7)
    # the solver's theta is unwrapped modulo 2*pi relative to the committed
    # array (the committed trajectory crosses +/-pi thousands of times)
    got = np.asarray(res_b.poses)
    exp = np.asarray(p_sm)
    np.testing.assert_allclose(got[:, :2], exp[:, :2], atol=1e-7)
    assert _wrapdiff(got[:, 2], exp[:, 2]).max() < 1e-7
