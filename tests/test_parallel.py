import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lidar_slam.config import MapConfig
from lidar_slam.models import occupancy
from lidar_slam.ops.icp import run_icp_batch
from lidar_slam.parallel import mesh as mesh_lib
from lidar_slam.parallel import sharding

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _pairs(rng, B, P):
    src = rng.normal(size=(B, P, 3)) * [1, 1, 0.2]
    yaw = rng.uniform(-0.2, 0.2, B)
    T = np.tile(np.eye(4), (B, 1, 1))
    tgt = np.empty_like(src)
    for b in range(B):
        c, s = np.cos(yaw[b]), np.sin(yaw[b])
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        tgt[b] = src[b] @ R.T + rng.uniform(-0.1, 0.1, 3)
    return jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(T)


def test_mesh_construction():
    m1 = mesh_lib.make_mesh(8)
    assert m1.devices.shape == (8,)
    m2 = mesh_lib.make_mesh(8, axes=("dp", "rp"))
    assert m2.devices.size == 8 and len(m2.devices.shape) == 2


def test_sharded_icp_matches_single_device():
    rng = np.random.default_rng(0)
    B, P = 16, 64
    src, tgt, T0 = _pairs(rng, B, P)
    ones = jnp.ones((B, P), bool)

    ref = run_icp_batch(src, tgt, ones, ones, T0, epsilon=1e-8)

    m = mesh_lib.make_mesh(8)
    fn = sharding.sharded_icp_batch(m)
    got = fn(src, tgt, ones, ones, T0, epsilon=1e-8)
    np.testing.assert_allclose(np.asarray(got.T), np.asarray(ref.T), atol=1e-9)
    np.testing.assert_array_equal(np.asarray(got.iters), np.asarray(ref.iters))


def test_sharded_map_matches_single_device():
    cfg = MapConfig(resolution=0.1, world_max_x=8, world_min_x=-8,
                    world_max_y=8, world_min_y=-8)
    rng = np.random.default_rng(1)
    N, R = 6, 64  # R divisible by 8
    poses = jnp.asarray(np.cumsum(rng.normal(0, 0.05, (N, 3)), axis=0))
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 6.0, (N, R))
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1))
    masks = jnp.asarray(rng.random((N, R)) > 0.05)
    K = occupancy.max_ray_cells(cfg, 6.0)

    ref = occupancy.build_logodds(poses, pts, masks, cfg, K)

    m = mesh_lib.make_mesh(8)
    build = sharding.sharded_build_logodds(m, cfg, K)
    got = build(poses, pts, masks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_sharded_map_matches_dense_single_device():
    """The ray-sharded build (compacted scatter per ray shard, psum of the
    deltas) equals the single-device DENSE scatter: psum-of-deltas
    exactness per scan, across both engines."""
    cfg = MapConfig(resolution=0.1, world_max_x=8, world_min_x=-8,
                    world_max_y=8, world_min_y=-8)
    rng = np.random.default_rng(5)
    N, R = 6, 64
    poses = jnp.asarray(np.cumsum(rng.normal(0, 0.05, (N, 3)), axis=0),
                        jnp.float32)
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 6.0, (N, R))
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1),
                      jnp.float32)
    masks = jnp.asarray(rng.random((N, R)) > 0.05)
    K = occupancy.max_ray_cells(cfg, 6.0)

    ref = occupancy.build_logodds(poses, pts, masks, cfg, K, compact=False)

    m = mesh_lib.make_mesh(8)
    build = sharding.sharded_build_logodds(m, cfg, K)
    got = build(poses, pts, masks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)
    assert int((np.asarray(ref) != 0).sum()) > 100


def test_sharded_map_on_two_axis_mesh():
    """Rays sharded over the named 'rp' axis of a 2-D (dp=4, rp=2) mesh
    (the superstep's mesh shape) match the single-device build."""
    cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                    world_max_y=6, world_min_y=-6)
    rng = np.random.default_rng(6)
    N, R = 4, 32
    poses = jnp.asarray(np.cumsum(rng.normal(0, 0.05, (N, 3)), axis=0),
                        jnp.float32)
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 5.0, (N, R))
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1),
                      jnp.float32)
    masks = jnp.asarray(rng.random((N, R)) > 0.05)
    K = occupancy.max_ray_cells(cfg, 6.0)

    ref = occupancy.build_logodds(poses, pts, masks, cfg, K)
    m = mesh_lib.make_mesh(8, axes=("dp", "rp"))  # rp size 2
    build = sharding.sharded_build_logodds(m, cfg, K, axis="rp")
    got = build(poses, pts, masks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(occupancy.finalize_grid(got)),
        np.asarray(occupancy.finalize_grid(ref)))


def test_pad_batch():
    x = jnp.ones((5, 3))
    padded, pad = sharding.pad_batch(x, 8)
    assert padded.shape == (8, 3) and pad == 3
    y, pad0 = sharding.pad_batch(x, 5)
    assert y.shape == (5, 3) and pad0 == 0


def test_sharded_texture_paint_matches_sequential():
    """Frame-sharded texture painting equals the sequential paint_cells
    loop bit-for-bit: unique global sequence numbers make the scatter-max
    winner (and so last-writer-wins color) mesh-invariant."""
    from lidar_slam.config import CameraConfig
    from lidar_slam.models import texture

    cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                    world_max_y=6, world_min_y=-6)
    cam = CameraConfig()
    rng = np.random.default_rng(7)
    # 24x32 frames: the RGB-registration constants assume 480-px-scale
    # geometry, and below ~24 rows no pixel passes the validity window
    B, H, W = 16, 24, 32
    disp = rng.integers(300, 900, (B, H, W)).astype(np.uint16)
    rgb = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    poses = rng.normal(0, 0.8, (B, 3)).astype(np.float32)

    # sequential reference: two batches through models/texture.paint_cells
    cells = cfg.width * cfg.height
    winner = jnp.full((cells,), -1, jnp.int32)
    color = jnp.zeros((cells,), jnp.int32)
    base = 0
    for s in range(0, B, 8):
        lin, cols, _ = texture.frames_to_cells(
            jnp.asarray(disp[s:s + 8]), jnp.asarray(rgb[s:s + 8]),
            jnp.asarray(poses[s:s + 8]), cfg, cam)
        winner, color = texture.paint_cells(winner, color, lin, cols,
                                            jnp.int32(base))
        base += int(lin.shape[0])

    # sharded: same frames in one 8-way call per batch (+ a padded batch
    # exercising frame_mask)
    m = mesh_lib.make_mesh(8)
    paint = sharding.sharded_texture_paint(m, cfg, cam)
    w2 = jnp.full((cells,), -1, jnp.int32)
    c2 = jnp.zeros((cells,), jnp.int32)
    base = 0
    for s in range(0, B, 8):
        w2, c2 = paint(w2, c2, jnp.asarray(disp[s:s + 8]),
                       jnp.asarray(rgb[s:s + 8]), jnp.asarray(poses[s:s + 8]),
                       jnp.ones((8,), bool), jnp.int32(base))
        base += 8 * H * W
    # padding frames must contribute nothing
    w2, c2 = paint(w2, c2, jnp.asarray(disp[:8]), jnp.asarray(rgb[:8]),
                   jnp.asarray(poses[:8]), jnp.zeros((8,), bool),
                   jnp.int32(base))

    np.testing.assert_array_equal(np.asarray(w2), np.asarray(winner))
    np.testing.assert_array_equal(np.asarray(c2), np.asarray(color))
    assert int(jnp.sum(winner >= 0)) > 0  # something was painted


def test_sharded_texture_paint_on_two_axis_mesh():
    """The frame shard rides 'dp' of a (dp=4, rp=2) mesh (the dryrun's
    production mesh shape): results must equal the 1-axis 8-way mesh."""
    from lidar_slam.config import CameraConfig
    from lidar_slam.models import texture

    cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                    world_max_y=6, world_min_y=-6)
    cam = CameraConfig()
    rng = np.random.default_rng(3)
    B, H, W = 8, 24, 32
    disp = rng.integers(300, 900, (B, H, W)).astype(np.uint16)
    rgb = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    poses = rng.normal(0, 0.8, (B, 3)).astype(np.float32)
    cells = cfg.width * cfg.height
    args = (jnp.asarray(disp), jnp.asarray(rgb), jnp.asarray(poses),
            jnp.ones((B,), bool), jnp.int32(0))

    m2 = mesh_lib.make_mesh(8, axes=("dp", "rp"))  # (4, 2)
    dp = int(m2.shape["dp"])
    w2, c2 = sharding.sharded_texture_paint(m2, cfg, cam)(
        jnp.full((cells,), -1, jnp.int32), jnp.zeros((cells,), jnp.int32),
        jnp.asarray(disp[:dp]), jnp.asarray(rgb[:dp]),
        jnp.asarray(poses[:dp]), jnp.ones((dp,), bool), jnp.int32(0))

    m1 = mesh_lib.make_mesh(8)
    w1, c1 = sharding.sharded_texture_paint(m1, cfg, cam)(
        jnp.full((cells,), -1, jnp.int32), jnp.zeros((cells,), jnp.int32),
        *args)
    # compare the first-dp-frames paint across mesh layouts via the
    # sequential reference
    lin, cols, _ = texture.frames_to_cells(
        jnp.asarray(disp[:dp]), jnp.asarray(rgb[:dp]),
        jnp.asarray(poses[:dp]), cfg, cam)
    ws, cs = texture.paint_cells(jnp.full((cells,), -1, jnp.int32),
                                 jnp.zeros((cells,), jnp.int32), lin, cols,
                                 jnp.int32(0))
    np.testing.assert_array_equal(np.asarray(w2), np.asarray(ws))
    np.testing.assert_array_equal(np.asarray(c2), np.asarray(cs))
    assert int(jnp.sum(w1 >= 0)) > 0


def test_scan_sharded_map_matches_single_device():
    """SCAN-parallel map build (clamp-affine composition over contiguous
    scan blocks, ops/clamp_affine.py): 8-device result vs the sequential
    single-device build."""
    cfg = MapConfig(resolution=0.1, world_max_x=8, world_min_x=-8,
                    world_max_y=8, world_min_y=-8)
    rng = np.random.default_rng(7)
    N, R = 16, 64  # N divisible by 8
    poses = jnp.asarray(np.cumsum(rng.normal(0, 0.05, (N, 3)), axis=0),
                        jnp.float32)
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 6.0, (N, R))
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1),
                      jnp.float32)
    masks = jnp.asarray(rng.random((N, R)) > 0.05)
    K = occupancy.max_ray_cells(cfg, 6.0)

    ref = occupancy.build_logodds(poses, pts, masks, cfg, K)

    m = mesh_lib.make_mesh(8)
    build = sharding.sharded_build_logodds_scans(m, cfg, K)
    got = build(poses, pts, masks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(occupancy.finalize_grid(got)),
        np.asarray(occupancy.finalize_grid(ref)))


def test_scan_sharded_map_saturating_cells():
    """A stationary robot re-observing the same scene: cells saturate at
    the +/-clip rails across MANY scans, exercising the clip-composition
    path (not just pure sums). Deviations at the rails are bounded to ULP
    scale (ops/clamp_affine.py analysis); the finalized uint8 map is
    identical."""
    cfg = MapConfig(resolution=0.1, world_max_x=8, world_min_x=-8,
                    world_max_y=8, world_min_y=-8)
    rng = np.random.default_rng(8)
    N, R = 48, 32
    # nearly-stationary poses; same rays re-observed with range jitter
    poses = jnp.asarray(rng.normal(0, 0.01, (N, 3)), jnp.float32)
    ang = np.tile(np.linspace(-np.pi, np.pi, R, endpoint=False), (N, 1))
    r = 4.0 + rng.normal(0, 0.02, (N, R))
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1),
                      jnp.float32)
    masks = jnp.ones((N, R), bool)
    K = occupancy.max_ray_cells(cfg, 6.0)

    ref = occupancy.build_logodds(poses, pts, masks, cfg, K)
    assert float(jnp.max(jnp.abs(ref))) >= cfg.logodds_clip - 1e-6

    m = mesh_lib.make_mesh(8)
    build = sharding.sharded_build_logodds_scans(m, cfg, K)
    got = build(poses, pts, masks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(
        np.asarray(occupancy.finalize_grid(got)),
        np.asarray(occupancy.finalize_grid(ref)))


def test_scan_sharded_map_matches_dense_single_device():
    """Scan-parallel build (compacted scatter per scan, clamp-affine
    composition across blocks) vs the unsharded DENSE scatter build."""
    cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                    world_max_y=6, world_min_y=-6)
    rng = np.random.default_rng(9)
    N, R = 8, 32
    poses = jnp.asarray(np.cumsum(rng.normal(0, 0.05, (N, 3)), axis=0),
                        jnp.float32)
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 5.0, (N, R))
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1),
                      jnp.float32)
    masks = jnp.asarray(rng.random((N, R)) > 0.05)
    K = occupancy.max_ray_cells(cfg, 6.0)

    ref = occupancy.build_logodds(poses, pts, masks, cfg, K, compact=False)
    m = mesh_lib.make_mesh(8)
    build = sharding.sharded_build_logodds_scans(m, cfg, K)
    got = build(poses, pts, masks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_scan_sharded_map_padded_scans_and_init():
    """N not a multiple of the mesh: pad with mask=False scans (identity
    functions) and start from a nonzero carried grid."""
    cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                    world_max_y=6, world_min_y=-6)
    rng = np.random.default_rng(10)
    N, R = 11, 32
    poses = jnp.asarray(np.cumsum(rng.normal(0, 0.05, (N, 3)), axis=0),
                        jnp.float32)
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 5.0, (N, R))
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1),
                      jnp.float32)
    masks = jnp.asarray(rng.random((N, R)) > 0.05)
    K = occupancy.max_ray_cells(cfg, 6.0)
    init = jnp.clip(
        jnp.asarray(rng.normal(0, 2.0, (cfg.width, cfg.height)), jnp.float32),
        -cfg.logodds_clip, cfg.logodds_clip)

    ref = occupancy.build_logodds(poses, pts, masks, cfg, K, init=init)

    poses_p, _ = sharding.pad_batch(poses, 8)
    pts_p, _ = sharding.pad_batch(pts, 8)
    masks_p, _ = sharding.pad_batch(masks, 8, pad_value=False)

    m = mesh_lib.make_mesh(8)
    build = sharding.sharded_build_logodds_scans(m, cfg, K)
    got = build(poses_p, pts_p, masks_p, init=init)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_sharded_pf_score_bitwise_and_filter_equality():
    """Particle-sharded scoring (sharding.sharded_pf_score): the (P, R)
    scoring is per-particle row sums, so sharding particles and gathering
    must be BIT-IDENTICAL to the single-device kernel. The whole filter
    track then agrees to float tolerance — the replicated downstream math
    is the same ops but a different executable (GSPMD), so fusion may
    differ by ULPs (measured max 7e-8 over 48 steps)."""
    from lidar_slam.config import LidarConfig
    from lidar_slam.models import particle_filter as pf
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    cfg_map = MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                        world_max_y=15, world_min_y=-15)
    data = io.synthetic_dataset(n_steps=48, n_rays=181, seed=5)
    gt = jnp.asarray(data["ground_truth"], jnp.float32)
    counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
    gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
    ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
    points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0,
                                             LidarConfig())
    K = int(occupancy.adaptive_ray_cells(points, masks, cfg_map, 30.0))
    logodds = occupancy.build_logodds(gt, points, masks, cfg_map, K)
    im = (logodds > 0).astype(jnp.float32)

    m = mesh_lib.make_mesh(8)
    score_fn = sharding.sharded_pf_score(m, cfg_map)
    cfg = pf.PFConfig(n_particles=64)  # divisible by the 8-device axis

    # kernel-level bitwise equality on a spread particle cloud
    rng = np.random.default_rng(3)
    particles = jnp.asarray(
        np.asarray(gt[7])[None] + rng.normal(0, 0.3, (64, 3)), jnp.float32)
    ref = pf._score_particles(particles, points[7, :, :2], masks[7], im,
                              cfg_map)
    got = score_fn(particles, points[7, :, :2], masks[7], im)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    # whole-filter equality (same PRNG stream, replicated everything else)
    biased = counts * 1.10
    ref_poses, ref_aux = pf.localize_particle_filter(
        im, biased, gyro, points[..., :2], masks, cfg_map, cfg, x0=gt[0])
    got_poses, got_aux = pf.localize_particle_filter(
        im, biased, gyro, points[..., :2], masks, cfg_map, cfg, x0=gt[0],
        score_fn=score_fn)
    np.testing.assert_allclose(np.asarray(got_poses),
                               np.asarray(ref_poses), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got_aux["resampled"]),
                                  np.asarray(ref_aux["resampled"]))


def test_sharded_pf_score_in_pf_slam():
    """The same sharded scorer drops into pf_slam_step: the causal-map SLAM
    track matches the single-device run (tolerance as in the test above;
    the map may differ only where a ULP-level pose diff crosses a
    world2grid cell boundary — bounded to a trace fraction of cells)."""
    from lidar_slam.config import LidarConfig
    from lidar_slam.models import pf_slam
    from lidar_slam.models.particle_filter import PFConfig
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    cfg_map = MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                        world_max_y=15, world_min_y=-15)
    data = io.synthetic_dataset(n_steps=32, n_rays=121, seed=7)
    gt = jnp.asarray(data["ground_truth"], jnp.float32)
    counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
    gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
    ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
    points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0,
                                             LidarConfig())
    K = int(occupancy.adaptive_ray_cells(points, masks, cfg_map, 30.0))
    pts2 = points[..., :2]

    m = mesh_lib.make_mesh(8)
    score_fn = sharding.sharded_pf_score(m, cfg_map)
    cfg = PFConfig(n_particles=64)

    ref_poses, ref_map, _ = pf_slam.slam_particle_filter(
        counts, gyro, pts2, masks, cfg_map, cfg, x0=gt[0], K=K)
    got_poses, got_map, _ = pf_slam.slam_particle_filter(
        counts, gyro, pts2, masks, cfg_map, cfg, x0=gt[0], K=K,
        score_fn=score_fn)
    np.testing.assert_allclose(np.asarray(got_poses),
                               np.asarray(ref_poses), atol=1e-5)
    assert float(np.mean(np.asarray(got_map) != np.asarray(ref_map))) < 1e-3


def test_sharded_reloc_score_bitwise_search_equality():
    """Node-sharded relocalization scoring: the full certified search
    (pose, score, certificate, margin) is bit-identical to single-device."""
    from lidar_slam.models import relocalization as rl

    rng = np.random.default_rng(5)
    mcfg = MapConfig(world_max_x=3.2, world_min_x=-3.2,
                     world_max_y=3.2, world_min_y=-3.2, resolution=0.05)
    im = jnp.asarray((rng.random((mcfg.width, mcfg.height)) > 0.85)
                     .astype(np.float32))
    pts = jnp.asarray(rng.uniform(-3, 3, (181, 2)).astype(np.float32))
    mask = jnp.asarray(rng.random(181) > 0.1)
    cfg = rl.RelocConfig(n_angles=8, search_radius=0.8, n_levels=3,
                         beam=64, max_rays=64, score_chunk=512)

    base = rl.relocalize(im, mcfg, pts, mask, cfg)
    m = mesh_lib.make_mesh(8)
    sharded = rl.relocalize(im, mcfg, pts, mask, cfg,
                            score_fn=sharding.sharded_reloc_score(m))
    assert np.array_equal(np.asarray(base.pose), np.asarray(sharded.pose))
    assert float(base.score) == float(sharded.score)
    assert bool(base.certified) == bool(sharded.certified)
    assert float(base.pruned_margin) == float(sharded.pruned_margin)


def test_sharded_paint_ops_matches_sequential():
    """The op-stream shard of the paint-op engine (native host projector)
    equals the sequential paint bit-for-bit, including across batches and
    with padding ops."""
    from lidar_slam.config import CameraConfig
    from lidar_slam.models import texture
    from lidar_slam.utils import native

    if not native.available():
        import pytest
        pytest.skip("native library not built")
    cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                    world_max_y=6, world_min_y=-6)
    cam = CameraConfig()
    rng = np.random.default_rng(11)
    B, H, W = 16, 24, 32
    disp = rng.integers(300, 900, (B, H, W)).astype(np.uint16)
    rgb = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    poses = rng.normal(0, 0.8, (B, 3)).astype(np.float64)

    cells_n = cfg.width * cfg.height
    m = mesh_lib.make_mesh(8)
    paint8 = sharding.sharded_paint_ops(m, cfg)

    # separate carries: paint_ops donates its winner/color buffers
    w1 = jnp.full((cells_n,), -1, jnp.int32)
    c1 = jnp.zeros((cells_n,), jnp.int32)
    w8 = jnp.full((cells_n,), -1, jnp.int32)
    c8 = jnp.zeros((cells_n,), jnp.int32)
    base = 0
    for s in range(0, B, 8):
        cells, colors = native.project_frames(
            disp[s:s + 8], rgb[s:s + 8], poses[s:s + 8], cam, cfg)
        ops = jnp.asarray(texture._pad_paint_ops(cells, colors, min_pad=64))
        w1, c1 = texture.paint_ops(w1, c1, ops, jnp.int32(base))
        w8, c8 = paint8(w8, c8, ops, jnp.int32(base))
        base += int(ops.shape[1])

    np.testing.assert_array_equal(np.asarray(w8), np.asarray(w1))
    np.testing.assert_array_equal(np.asarray(c8), np.asarray(c1))
    assert int(jnp.sum(w1 >= 0)) > 0


def _pg_problem(rng, n, interval=10, noise=0.05):
    """Fixed-interval pose-graph problem: noisy circle + exact loop arcs."""
    from lidar_slam.utils import se2

    t = np.linspace(0, 2 * np.pi, n)
    gt = np.stack([np.cos(t) * 5, np.sin(t) * 5, t + np.pi / 2],
                  -1).astype(np.float32)
    T = np.asarray(se2.T_from_pose(jnp.asarray(gt)))
    rel = np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]),
                    T[1:]).astype(np.float32)
    rel[:, :2, 2] += rng.normal(0, 0.01, (n - 1, 2)).astype(np.float32)
    li = np.arange(0, n - interval, interval, dtype=np.int32)
    lj = li + interval
    lmeas = np.einsum("nij,njk->nik", np.linalg.inv(T[li]),
                      T[lj]).astype(np.float32)
    lmask = np.ones(len(li), bool)
    lmask[1] = False  # one gated-out closure, as the pipeline produces
    poses0 = jnp.asarray(gt + rng.normal(0, noise, gt.shape)
                         .astype(np.float32))
    return poses0, jnp.asarray(rel), (jnp.asarray(li), jnp.asarray(lj),
                                      jnp.asarray(lmeas), jnp.asarray(lmask))


def test_sharded_pose_graph_matches_single_device():
    """Factor-sharded LM == single-device banded LM up to psum
    reassociation: poses ~1e-5, cost ~1e-6 relative. n = 53 exercises
    BOTH pad paths (52 between factors -> 56; 5 loop arcs -> 8)."""
    from lidar_slam.models import pose_graph as pg

    rng = np.random.default_rng(3)
    poses0, rel, (li, lj, lmeas, lmask) = _pg_problem(rng, 53)
    graph = pg.make_graph(rel, loop_i=li, loop_j=lj, loop_meas=lmeas,
                          loop_mask=lmask)
    ref = pg.optimize(poses0, graph, solver="banded", band=10,
                      max_iters=30, cost_rtol=1e-9)
    m = mesh_lib.make_mesh(8)
    got = pg.optimize_sharded(poses0, graph, m, axis="dp", band=10,
                              max_iters=30, cost_rtol=1e-9)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(np.asarray(got.poses), np.asarray(ref.poses),
                               atol=2e-5)
    assert abs(float(got.cost) - float(ref.cost)) <= max(
        1e-4 * float(ref.cost), 1e-7)


def test_sharded_pose_graph_trajectory_wrapper_and_robust():
    """The fused sharded wrapper (graph assembly + LM in one jit) matches
    the single-device fused path, with a robust loop kernel enabled and a
    deliberately corrupted (gated-IN) loop measurement."""
    from lidar_slam.config import PoseGraphConfig
    from lidar_slam.models import pose_graph as pg

    rng = np.random.default_rng(5)
    poses0, rel, (li, lj, lmeas, lmask) = _pg_problem(rng, 64)
    # corrupt one live loop arc; huber should bound its influence the
    # same way on both paths
    lmeas = lmeas.at[2, 0, 2].add(1.5)
    cfg = PoseGraphConfig(solver="banded", fixed_interval=10,
                          robust_loss="huber", robust_delta=1.0,
                          max_lm_iters=40, cost_rtol=1e-9)
    ref = pg.optimize_trajectory(poses0, rel, li, lj, lmeas, lmask, cfg)
    m = mesh_lib.make_mesh(8)
    run = sharding.sharded_optimize_trajectory(m, cfg)
    got = run(poses0, rel, li, lj, lmeas, lmask)
    # the corrupted arc sits at the huber boundary, which makes the
    # optimum a FLAT valley: both paths land within 2e-6 of the same
    # cost, but poses are only pinned to ~the valley width (measured:
    # restarting either solver from the other's solution moves poses
    # another 0.5-1.5e-3 while improving cost in the 6th decimal).
    # Assert what the problem actually determines — the cost tightly,
    # the poses to the valley scale.
    np.testing.assert_allclose(np.asarray(got.poses), np.asarray(ref.poses),
                               atol=5e-3)
    assert abs(float(got.cost) - float(ref.cost)) <= max(
        1e-4 * float(ref.cost), 1e-7)


def test_sharded_pose_graph_rejects_wide_arcs():
    """Banded-only guard: a loop arc wider than the band raises instead of
    silently dropping Hessian blocks (optimize() falls back to 'direct';
    the sharded path has no Woodbury panel to fall back to). BOTH entry
    points must guard: optimize_sharded eagerly, and the jitted wrapper
    host-side BEFORE tracing (inside the jit the indices are tracers and
    the inner guard is skipped)."""
    from lidar_slam.models import pose_graph as pg

    rng = np.random.default_rng(7)
    poses0, rel, (li, lj, lmeas, lmask) = _pg_problem(rng, 53)
    lj = lj.at[0].set(30)  # span 30 > band 10
    graph = pg.make_graph(rel, loop_i=li, loop_j=lj, loop_meas=lmeas,
                          loop_mask=lmask)
    m = mesh_lib.make_mesh(8)
    with pytest.raises(ValueError, match="banded-only"):
        pg.optimize_sharded(poses0, graph, m, band=10)

    # the production wrapper path (everything inside its jit is a tracer,
    # so the guard must run on concrete values before the jitted call)
    from lidar_slam.config import PoseGraphConfig
    run = sharding.sharded_optimize_trajectory(
        m, PoseGraphConfig(solver="banded", fixed_interval=10))
    with pytest.raises(ValueError, match="banded-only"):
        run(poses0, rel, li, lj, lmeas, lmask)
    # a gated-out wide arc is fine — the guard looks at LIVE arcs only
    lmask2 = lmask.at[0].set(False)
    res = run(poses0, rel, li, lj, lmeas, lmask2)
    assert bool(jnp.isfinite(res.poses).all())


def test_sharded_pose_graph_no_loops_and_f64():
    """The Lf=0 padding branch (no loop factors -> one all-masked pad
    shard per device) and dtype generality: a chain-only f32 graph and
    the same graph in f64 both match the single-device banded solver."""
    from lidar_slam.models import pose_graph as pg

    rng = np.random.default_rng(11)
    poses0, rel, _ = _pg_problem(rng, 41)
    m = mesh_lib.make_mesh(8)
    kw = dict(band=10, max_iters=30, cost_rtol=1e-9)

    graph = pg.make_graph(rel)  # no loops at all
    ref = pg.optimize(poses0, graph, solver="banded", **kw)
    got = pg.optimize_sharded(poses0, graph, m, **kw)
    np.testing.assert_allclose(np.asarray(got.poses), np.asarray(ref.poses),
                               atol=2e-5)

    poses64 = poses0.astype(jnp.float64)
    graph64 = pg.make_graph(rel.astype(jnp.float64))
    ref64 = pg.optimize(poses64, graph64, solver="banded", **kw)
    got64 = pg.optimize_sharded(poses64, graph64, m, **kw)
    assert got64.poses.dtype == ref64.poses.dtype
    np.testing.assert_allclose(np.asarray(got64.poses),
                               np.asarray(ref64.poses), atol=1e-9)
