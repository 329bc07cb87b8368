import numpy as np
import jax.numpy as jnp
import pytest

from lidar_slam.config import CameraConfig, MapConfig
from lidar_slam.models import texture


def _np_texture_reference(poses, rgb_pose_indices, disp_frames, rgb_frames,
                          grid_map, map_cfg, cam_cfg):
    """Independent numpy spec model of the reference texture pipeline
    (spec: modules/texture_mapping.py:7-99,134-224)."""
    K, T_rc, R_oc = texture.camera_matrices(cam_cfg)
    K_inv = np.linalg.inv(K)
    T_oc = np.eye(4)
    T_oc[:3, :3] = R_oc

    tex = np.repeat(np.asarray(grid_map, np.uint8)[..., None], 3, axis=2).copy()
    for f in range(len(rgb_pose_indices)):
        disp = disp_frames[f].astype(np.float32)
        rgb = rgb_frames[f]
        h, w = disp.shape
        ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        ii, jj = ii.flatten(), jj.flatten()
        depth = (cam_cfg.depth_scale /
                 (cam_cfg.disp_a * disp + cam_cfg.disp_b)).flatten()

        pix = np.stack([jj, ii, np.ones_like(ii)], axis=-1)
        xyz = (K_inv @ pix.T).T * depth[:, None]

        # reference passes depth into the dd slot (texture_mapping.py:198)
        rgbi = (cam_cfg.reg_scale * ii + cam_cfg.reg_i_off
                - cam_cfg.reg_dd * depth) / cam_cfg.reg_div
        rgbj = (cam_cfg.reg_scale * jj + cam_cfg.reg_j_off) / cam_cfg.reg_div
        valid = (0 <= rgbi) & (rgbi < h) & (0 <= rgbj) & (rgbj < w)
        vi = np.clip(rgbi[valid].astype(int), 0, h - 1)
        vj = np.clip(rgbj[valid].astype(int), 0, w - 1)
        colors = rgb[vi, vj]
        xyz = xyz[valid]

        # optical -> camera -> robot -> world
        xyz = (np.linalg.inv(T_oc)[:3, :3] @ xyz.T).T
        xyz = (T_rc[:3, :3] @ xyz.T).T + T_rc[:3, 3]
        x, y, yaw = poses[rgb_pose_indices[f]]
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                      [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        xyz = (R @ xyz.T).T + np.array([x, y, 0.0])

        gi = np.ceil((xyz[:, 0] - map_cfg.world_min_x) / map_cfg.resolution
                     ).astype(int) - 1
        gj = np.ceil((xyz[:, 1] - map_cfg.world_min_y) / map_cfg.resolution
                     ).astype(int) - 1
        ok = (gi >= 0) & (gi < map_cfg.width) & (gj >= 0) & (gj < map_cfg.height)
        tex[gi[ok], gj[ok]] = colors[ok]
    return tex.astype(np.float32) / 255.0


def _synthetic_frames(rng, n_frames, h=24, w=32):
    # disparity values giving positive depth: dd = -0.00304 d + 3.31 > 0
    disp = rng.uniform(300, 900, (n_frames, h, w)).astype(np.float32)
    rgb = rng.integers(0, 255, (n_frames, h, w, 3)).astype(np.uint8)
    return disp, rgb


def test_texture_matches_reference_spec():
    rng = np.random.default_rng(0)
    map_cfg = MapConfig(resolution=0.1, world_max_x=8, world_min_x=-8,
                        world_max_y=8, world_min_y=-8)
    cam = CameraConfig()
    n_frames = 3
    disp, rgb = _synthetic_frames(rng, n_frames)
    poses = rng.normal(0, 1.0, (10, 3))
    rgb_pose = np.array([1, 4, 7])
    grid_map = rng.integers(0, 2, (map_cfg.width, map_cfg.height)).astype(np.uint8)

    def loader(ids):
        return disp[ids], rgb[ids]

    got = texture.generate_texture_map(
        poses, rgb_pose, np.arange(n_frames), grid_map, loader,
        map_cfg, cam, batch_size=2)
    want = _np_texture_reference(poses, rgb_pose, disp, rgb, grid_map,
                                 map_cfg, cam)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_texture_last_frame_wins():
    """Two frames painting the same cells: the later frame's colors stay."""
    rng = np.random.default_rng(1)
    map_cfg = MapConfig(resolution=0.1, world_max_x=8, world_min_x=-8,
                        world_max_y=8, world_min_y=-8)
    cam = CameraConfig()
    disp, rgb = _synthetic_frames(rng, 2)
    disp[1] = disp[0]  # same geometry
    poses = np.zeros((2, 3))
    grid_map = np.zeros((map_cfg.width, map_cfg.height), np.uint8)

    got = texture.generate_texture_map(
        poses, np.array([0, 1]), np.arange(2), grid_map,
        lambda ids: (disp[ids], rgb[ids]), map_cfg, cam, batch_size=1)
    want = _np_texture_reference(poses, np.array([0, 1]), disp, rgb,
                                 grid_map, map_cfg, cam)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_depth_and_registration_formulas():
    cam = CameraConfig()
    d = jnp.asarray([600.0])
    depth = texture.get_depth_image(d, cam)
    np.testing.assert_allclose(np.asarray(depth),
                               1.03 / (-0.00304 * 600 + 3.31), rtol=1e-6)
    ri, rj = texture.get_rgbi_rgbj(jnp.asarray([5.0]), jnp.asarray([7.0]),
                                   jnp.asarray([2.0]), cam)
    np.testing.assert_allclose(np.asarray(ri),
                               (526.37 * 5 + 19276 - 7877.07 * 2) / 585.051,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(rj), (526.37 * 7 + 16662) / 585.051,
                               rtol=1e-6)


def test_png_16bit_roundtrip(tmp_path):
    from lidar_slam.utils.png import read_png, write_png
    rng = np.random.default_rng(2)
    img = rng.integers(0, 65535, (20, 30)).astype(np.uint16)
    write_png(str(tmp_path / "d.png"), img)
    back = read_png(str(tmp_path / "d.png"))
    np.testing.assert_array_equal(back, img)


def test_native_decoder_matches_python(tmp_path):
    from lidar_slam.utils import native
    from lidar_slam.utils.png import write_png, _read_png_python
    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(3)
    g8 = rng.integers(0, 255, (16, 20)).astype(np.uint8)
    rgb = rng.integers(0, 255, (16, 20, 3)).astype(np.uint8)
    g16 = rng.integers(0, 65535, (16, 20)).astype(np.uint16)
    for name, img in [("g8.png", g8), ("rgb.png", rgb), ("g16.png", g16)]:
        write_png(str(tmp_path / name), img)
        got = native.read_png(str(tmp_path / name))
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(_read_png_python(str(tmp_path / name)), img)


def test_native_batch_loader(tmp_path):
    from lidar_slam.utils import native
    from lidar_slam.utils.png import write_png
    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 65535, (6, 12, 14)).astype(np.uint16)
    paths = []
    for i in range(6):
        p = str(tmp_path / f"f{i}.png")
        write_png(p, imgs[i])
        paths.append(p)
    got = native.read_png_batch(paths, (12, 14), np.uint16, n_threads=3)
    np.testing.assert_array_equal(got, imgs)
    # error surfaces for a missing file
    with pytest.raises(IOError):
        native.read_png_batch([paths[0], str(tmp_path / "nope.png")],
                              (12, 14), np.uint16)


def test_packed_upload_path_bit_identical():
    """The single-buffer upload path (pack_frame_batch on host +
    frames_to_cells_packed's device-side bitcast unpack) must reproduce
    the separate-array path bit-for-bit — it exists purely to pay one
    host-to-device transfer per batch instead of three."""
    rng = np.random.default_rng(11)
    B, H, W = 3, 24, 32
    disp = rng.integers(300, 900, (B, H, W)).astype(np.uint16)
    rgb = rng.integers(0, 255, (B, H, W, 3)).astype(np.uint8)
    poses = rng.normal(0, 0.5, (B, 3)).astype(np.float32)
    map_cfg = MapConfig(resolution=0.2, world_min_x=-8, world_max_x=8,
                        world_min_y=-8, world_max_y=8)
    cam_cfg = CameraConfig()

    lin0, col0, ok0 = texture.frames_to_cells(
        jnp.asarray(disp), jnp.asarray(rgb), jnp.asarray(poses),
        map_cfg, cam_cfg)
    buf = texture.pack_frame_batch(disp, rgb, poses)
    assert buf.dtype == np.uint8 and buf.shape == (B * H * W * 5 + B * 12,)
    lin1, col1, ok1 = texture.frames_to_cells_packed(
        jnp.asarray(buf), B, H, W, map_cfg, cam_cfg)
    np.testing.assert_array_equal(np.asarray(lin0), np.asarray(lin1))
    np.testing.assert_array_equal(np.asarray(col0), np.asarray(col1))
    np.testing.assert_array_equal(np.asarray(ok0), np.asarray(ok1))


def test_generate_texture_packed_vs_float_loader():
    """End-to-end: an integer-disparity loader (packed single-upload
    path) and a float32 loader (separate-array path) produce the same
    texture (the device-side uint16->f32 cast is exact)."""
    rng = np.random.default_rng(12)
    n = 7
    disp_i = rng.integers(300, 900, (n, 24, 32)).astype(np.uint16)
    rgb = rng.integers(0, 255, (n, 24, 32, 3)).astype(np.uint8)
    poses = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    grid = rng.integers(0, 2, (81, 81)).astype(np.uint8)
    map_cfg = MapConfig(resolution=0.2, world_min_x=-8, world_max_x=8,
                        world_min_y=-8, world_max_y=8)
    tex_i = texture.generate_texture_map(
        poses, np.arange(n), np.arange(n), grid,
        lambda ids: (disp_i[ids], rgb[ids]), map_cfg, CameraConfig(),
        batch_size=3)
    tex_f = texture.generate_texture_map(
        poses, np.arange(n), np.arange(n), grid,
        lambda ids: (disp_i[ids].astype(np.float32), rgb[ids]),
        map_cfg, CameraConfig(), batch_size=3)
    np.testing.assert_array_equal(tex_i, tex_f)


def test_native_projector_matches_spec():
    """The C++ host projector (paint-op path) against the independent
    numpy spec model — same last-writer-wins texture as the reference
    chain (reference: modules/texture_mapping.py:7-99,134-224)."""
    from lidar_slam.utils import native
    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(21)
    map_cfg = MapConfig(resolution=0.1, world_max_x=8, world_min_x=-8,
                        world_max_y=8, world_min_y=-8)
    cam = CameraConfig()
    n = 5
    disp = rng.integers(300, 900, (n, 24, 32)).astype(np.uint16)
    rgb = rng.integers(0, 255, (n, 24, 32, 3)).astype(np.uint8)
    poses = rng.normal(0, 1.0, (10, 3))
    rgb_pose = np.array([1, 3, 5, 7, 9])
    grid = rng.integers(0, 2, (map_cfg.width, map_cfg.height)).astype(np.uint8)
    loader = lambda ids: (disp[ids], rgb[ids])

    got = texture.generate_texture_map(
        poses, rgb_pose, np.arange(n), grid, loader, map_cfg, cam,
        batch_size=2, projector="native")
    want = _np_texture_reference(poses, rgb_pose, disp, rgb, grid,
                                 map_cfg, cam)
    np.testing.assert_allclose(got, want, atol=1e-6)

    # cross-engine: the device (f32 on-device chain) and native (f64 host
    # chain) engines agree exactly on this scene
    dev = texture.generate_texture_map(
        poses, rgb_pose, np.arange(n), grid, loader, map_cfg, cam,
        batch_size=2, projector="device")
    np.testing.assert_array_equal(got, dev)


def test_native_projector_grouped_uploads_equal():
    """ops_group folds several projected batches into one padded upload +
    one paint dispatch; grouping must be invisible in the result. Equality
    across group sizes (1 = one upload per batch, 3 = uneven final flush,
    8 = everything in one group) and vs the device engine
    (models/texture.py generate_texture_map ops_group)."""
    from lidar_slam.utils import native
    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(7)
    map_cfg = MapConfig(resolution=0.1, world_max_x=8, world_min_x=-8,
                        world_max_y=8, world_min_y=-8)
    cam = CameraConfig()
    n = 10
    disp = rng.integers(300, 900, (n, 24, 32)).astype(np.uint16)
    rgb = rng.integers(0, 255, (n, 24, 32, 3)).astype(np.uint8)
    poses = rng.normal(0, 1.0, (n, 3))
    rgb_pose = np.arange(n)
    grid = rng.integers(0, 2, (map_cfg.width, map_cfg.height)).astype(np.uint8)
    loader = lambda ids: (disp[ids], rgb[ids])

    outs = {}
    for g in (1, 3, 8):
        outs[g] = texture.generate_texture_map(
            poses, rgb_pose, np.arange(n), grid, loader, map_cfg, cam,
            batch_size=2, projector="native", ops_group=g)
    np.testing.assert_array_equal(outs[1], outs[3])
    np.testing.assert_array_equal(outs[1], outs[8])
    dev = texture.generate_texture_map(
        poses, rgb_pose, np.arange(n), grid, loader, map_cfg, cam,
        batch_size=2, projector="device")
    np.testing.assert_array_equal(outs[1], dev)


def test_native_project_frames_last_writer_wins():
    """Unit semantics of native.project_frames: within a frame each cell
    appears once carrying its LAST pixel's color; frames concatenate in
    order (the device scatter-max then makes later frames win)."""
    from lidar_slam.utils import native
    if not native.available():
        pytest.skip("native library not built")
    cam = CameraConfig()
    map_cfg = MapConfig(resolution=0.5, world_max_x=8, world_min_x=-8,
                        world_max_y=8, world_min_y=-8)
    # constant disparity -> every pixel shares one depth; a tiny 2x2 frame
    # projects to few cells with known duplicate structure
    disp = np.full((2, 2, 2), 600, np.uint16)
    rgb = np.arange(2 * 2 * 2 * 3, dtype=np.uint8).reshape(2, 2, 2, 3)
    poses = np.zeros((2, 3))
    cells, colors = native.project_frames(disp, rgb, poses, cam, map_cfg)
    # both frames identical geometry: same cells, split evenly
    assert len(cells) % 2 == 0
    half = len(cells) // 2
    np.testing.assert_array_equal(cells[:half], cells[half:])
    assert (cells >= 0).all()
    # colors are valid packed uint8 triples
    assert (colors >= 0).all() and (colors < (1 << 24)).all()


def test_native_projector_thread_count_bit_equality():
    """slamio_project_frames across n_threads in {1, 2, 4}: bit-identical
    output. The worker pool hands out whole FRAMES (dynamic counter), but
    each frame's (cells, colors) land in per-frame slots concatenated in
    frame order at the end, so thread count must not change a single byte —
    this pins the advertised attached-multicore-host scaling path
    before anyone relies on it."""
    from lidar_slam.utils import native
    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(33)
    cam = CameraConfig()
    map_cfg = MapConfig(resolution=0.1, world_max_x=10, world_min_x=-10,
                        world_max_y=10, world_min_y=-10)
    B = 7  # odd + > thread counts: uneven work distribution
    disp = rng.integers(300, 900, (B, 48, 64)).astype(np.uint16)
    # sprinkle invalid (dd <= 0) pixels so the masked path is exercised
    disp[rng.random((B, 48, 64)) < 0.05] = 0
    rgb = rng.integers(0, 255, (B, 48, 64, 3)).astype(np.uint8)
    poses = rng.normal(0, 2.0, (B, 3))
    ref_cells, ref_colors = native.project_frames(
        disp, rgb, poses, cam, map_cfg, n_threads=1)
    assert len(ref_cells) > 0
    for nt in (2, 4):
        cells, colors = native.project_frames(
            disp, rgb, poses, cam, map_cfg, n_threads=nt)
        np.testing.assert_array_equal(cells, ref_cells)
        np.testing.assert_array_equal(colors, ref_colors)


def test_pad_paint_ops_buckets():
    c = np.arange(5, dtype=np.int32)
    ops = texture._pad_paint_ops(c, c, min_pad=4)
    assert ops.shape == (2, 8)
    np.testing.assert_array_equal(ops[0, :5], c)
    assert (ops[0, 5:] == -1).all()
    assert texture._pad_paint_ops(np.array([], np.int32),
                                  np.array([], np.int32),
                                  min_pad=4).shape == (2, 4)
