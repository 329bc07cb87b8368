import numpy as np
import jax.numpy as jnp

from lidar_slam import sensors
from lidar_slam.config import LidarConfig
from lidar_slam.ops import scan as scan_ops
from lidar_slam.utils import io


def _np_find_nearest(array, value):
    # reference semantics: modules/utils.py:104-117 (argmin of abs diff)
    return int(np.abs(np.asarray(array) - value).argmin())


def test_find_nearest_indices_matches_argmin_scan():
    rng = np.random.default_rng(0)
    stamps = np.sort(rng.uniform(0, 100, 500))
    queries = rng.uniform(-5, 105, 300)
    got = io.find_nearest_indices(stamps, queries)
    want = np.array([_np_find_nearest(stamps, q) for q in queries])
    np.testing.assert_array_equal(got, want)


def test_find_nearest_tie_breaks_to_first_index():
    stamps = np.array([0.0, 1.0, 2.0, 3.0])
    # 1.5 is equidistant from 1.0 and 2.0 -> argmin picks index 1
    got = io.find_nearest_indices(stamps, np.array([1.5]))
    assert got[0] == 1


def test_synchronize_sensors():
    rng = np.random.default_rng(1)
    n_enc, n_imu, n_lid = 100, 250, 90
    enc = sensors.Encoder(counts=rng.normal(size=(n_enc, 4)),
                          stamps=np.sort(rng.uniform(0, 10, n_enc)))
    imu = sensors.Imu(gyro=rng.normal(size=(n_imu, 3)),
                      acc=rng.normal(size=(n_imu, 3)),
                      stamps=np.sort(rng.uniform(0, 10, n_imu)))
    lid = sensors.Lidar(ranges=rng.uniform(0.5, 20, size=(n_lid, 16)),
                        stamps=np.sort(rng.uniform(0, 10, n_lid)))
    sensors.synchronize_sensors(enc, imu, lid, base_sensor_index=0)

    assert enc.counts_synced.shape == (n_enc, 4)
    assert imu.gyro_synced.shape == (n_enc, 3)
    assert lid.ranges_synced.shape == (n_enc, 16)
    # spot-check against the O(N*M) reference semantics
    for k in range(0, n_enc, 17):
        i_imu = _np_find_nearest(imu.stamps, enc.stamps[k])
        np.testing.assert_array_equal(imu.gyro_synced[k], imu.gyro[i_imu])
        i_lid = _np_find_nearest(lid.stamps, enc.stamps[k])
        np.testing.assert_array_equal(lid.ranges_synced[k], lid.ranges[i_lid])


def test_scans_to_points_matches_ragged_reference():
    """The masked fixed-shape representation must contain exactly the
    reference's ragged per-scan points (reference: modules/localization.py:283-305)."""
    rng = np.random.default_rng(2)
    cfg = LidarConfig(n_rays=64)
    ranges = rng.uniform(0.0, 35.0, size=(5, 64))
    range_min, range_max = 0.1, 30.0

    pts, mask = scan_ops.scans_to_points(jnp.asarray(ranges), range_min, range_max, cfg)
    pts, mask = np.asarray(pts), np.asarray(mask)

    angles = np.linspace(np.radians(-135), np.radians(135), 64)
    for i in range(5):
        valid = (ranges[i] >= range_min) & (ranges[i] <= range_max)
        vr, va = ranges[i][valid], angles[valid]
        want = np.stack([vr * np.cos(va) + 0.13323, vr * np.sin(va)], axis=1)
        np.testing.assert_array_equal(mask[i], valid)
        np.testing.assert_allclose(pts[i][valid], want, atol=1e-12)


def test_synthetic_dataset_shapes():
    data = io.synthetic_dataset(n_steps=100, n_rays=1081)
    assert data["encoder"]["counts"].shape == (100, 4)
    assert data["lidar"]["ranges"].shape == (100, 1081)
    assert data["imu"]["angular_velocity"].shape == (100, 3)
    assert data["ground_truth"].shape == (100, 3)
    # most rays should be valid hits inside range
    valid = (data["lidar"]["ranges"] >= 0.1) & (data["lidar"]["ranges"] <= 30.0)
    assert valid.mean() > 0.5


def test_save_load_numpy_roundtrip(tmp_path):
    arr = np.arange(12.0).reshape(3, 4)
    io.save_numpy(arr, str(tmp_path / "x"))
    back = io.load_numpy(str(tmp_path / "x.npy"))
    np.testing.assert_array_equal(arr, back)
