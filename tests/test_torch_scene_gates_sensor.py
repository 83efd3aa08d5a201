"""tests/test_scenes.py's accuracy gates held in the port, photometric and
sparse families (CPU, plain kernel versions): the frames the JAX test
renders through the port's ``VOSystem(device="cpu")`` and the JAX package's
``VOSystem``, with the checks of tests/test_torch_scene_gates_box.py (the
JAX test's gate on the port's run, flags identical, the median pose gap
within 5e-5 m / 5e-5 rad of JAX's and every frame within the case's own
tolerance, whose reason that file gives), and the sparse family's fill-in
at 640x480 on one frame (tests/test_scenes.py:184-207) in both packages.
"""
import jax.numpy as jnp
import numpy as np
import torch

from revo_tpu import frontend as jfront
from revo_tpu.config import SystemConfig as JConfig
from revo_tpu.io import synthetic as jsyn
from revo_tpu_torch import convert, frontend
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.ops.edge_hist import patch_histogram

from test_scenes import SENSOR_PROFILE
from test_torch_scene_gates_box import hold_gate, sequence

torch.set_num_threads(1)


class TestPhotometricRobustness:
    """tests/test_scenes.py:140-181, under SENSOR_PROFILE (read and shot
    noise, defocus blur, exposure flicker, vignette)."""

    def test_box_scene_sensor_profile(self):
        hold_gate(sequence(jsyn.box_scene(**SENSOR_PROFILE), 30, seed=3), 0.02,
                  pose_tol=2.5e-4)  # frame 22: 1.25e-4 m, 3.5e-5 rad

    def test_column_scene_sensor_profile(self):
        hold_gate(sequence(jsyn.column_scene(**SENSOR_PROFILE), 30, seed=4), 0.02,
                  pose_tol=1e-3)  # frame 29: 4.66e-4 m, 1.58e-4 rad

    def test_plane_scene_sensor_profile(self):
        hold_gate(sequence(jsyn.SyntheticScene(**SENSOR_PROFILE), 30, seed=5), 0.02,
                  pose_tol=4e-4)  # frame 22: 1.94e-4 m; frame 28: 9.2e-5 rad

    def test_photometric_and_depth_corruption_combined(self):
        """The JAX test gates the ATE only."""
        scene = jsyn.box_scene(depth_noise=0.04, depth_hole_frac=0.2, **SENSOR_PROFILE)
        hold_gate(sequence(scene, 30, seed=3), 0.035, require_tracking=False,
                  pose_tol=2.5e-4)  # frame 29: 1.15e-4 m; frame 26: 1.3e-5 rad


class TestSparseScene:
    """tests/test_scenes.py:184-221."""

    def test_fill_in_fires_on_sparse_frame_640(self):
        """One 640x480 frame: the coarse levels' occupancy under
        n_percentage and the fill-in adds edges, in the port as in JAX, with
        edges before and after it equal bit for bit."""
        cfg = JConfig()
        tcfg = convert.config_from_jax(cfg)
        g, d = jsyn.render_frame(jsyn.sparse_scene(), cfg.camera, np.eye(4), seed=1)
        gt_, dt_ = tsyn.render_frame(tsyn.sparse_scene(), tcfg.camera, np.eye(4), seed=1)
        np.testing.assert_array_equal(gt_, g)
        np.testing.assert_array_equal(dt_, d)
        fj = jfront.build_frame(jnp.asarray(g), jnp.asarray(d), cfg)
        ft = frontend.build_frame(torch.from_numpy(g), torch.from_numpy(d), tcfg)
        for lvl in (1, 2):
            lt, lj = ft.levels[lvl], fj.levels[lvl]
            np.testing.assert_array_equal(lt.edges_orig.numpy(), np.asarray(lj.edges_orig))
            np.testing.assert_array_equal(lt.edges.numpy(), np.asarray(lj.edges))
            occ = float(patch_histogram(lt.edges_orig, tcfg.pyramid.dist_patch_sizes[lvl])[1])
            assert occ < tcfg.pyramid.n_percentage, f"level {lvl} occupancy {occ:.3f} not sparse"
            assert int(lt.edges.sum()) - int(lt.edges_orig.sum()) > 0, (
                f"level {lvl}: fill-in did not fire")

    def test_tracks_on_sparse_scene_160(self):
        hold_gate(sequence(jsyn.sparse_scene(), 30, seed=3), 0.02,
                  pose_tol=1.5e-4)  # frame 24: 7.3e-5 m, 5.0e-5 rad
