"""Installation smoke test (parity with the reference's GTSAM smoke test,
code/test_gtsam.py:1-27): constructs a tiny pose graph with a prior and one
between factor, optimizes it with the in-JAX LM solver, and checks the
optimum, exercising JAX, the geometry core, and the solver end-to-end."""

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from lidar_slam.config import PoseGraphConfig
    from lidar_slam.models import pose_graph
    from lidar_slam.utils import se2

    from lidar_slam.utils.runtime import report_devices
    print(f"jax {jax.__version__}, devices: {report_devices()}")

    # two poses, a prior at the origin, one between factor of (1, 0, 90deg)
    meas = se2.T_from_pose(jnp.asarray([[1.0, 0.0, np.pi / 2]]))
    graph = pose_graph.make_graph(meas, PoseGraphConfig())
    init = jnp.asarray([[0.1, -0.1, 0.05], [0.8, 0.3, 1.3]])
    res = pose_graph.optimize_with_config(init, graph)
    opt = np.asarray(res.poses)

    np.testing.assert_allclose(opt[0], [0, 0, 0], atol=1e-4)
    np.testing.assert_allclose(opt[1], [1, 0, np.pi / 2], atol=1e-4)
    print(f"optimized poses:\n{opt}")
    print(f"final cost {float(res.cost):.2e} in {int(res.iterations)} LM iters")
    print("smoke test PASSED")


if __name__ == "__main__":
    main()
