"""The port's segment-parallel tracking (revo_tpu_torch.parallel.segments)
against the JAX package's (revo_tpu.parallel.segments), at 160x120 on the
CPU; the cases of tests/test_segments.py.

Tolerances: ``split_segments`` equal; ``stitch_segments`` within 1e-5 (a
running float32 product here, a scan tree in JAX); ``track_long_sequence``
poses within 5e-4 of JAX's, with and without the pose-graph relaxation
(every segment starts a fresh track from the identity, and JAX's vmapped
scan sums in another order).  The sequence is ``render_sequence`` seed 2, 13
frames in 4 segments: at this size seed 0's frame 1 is a knife edge of the
LM schedule (tests/test_torch_run.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu.parallel import segments as jseg
from revo_tpu_torch import convert, lie
from revo_tpu_torch.eval import absolute_trajectory_error
from revo_tpu_torch.parallel import batch, segments

from test_batch import _render_stack
from test_solver import small_cfg

torch.set_num_threads(1)


def test_split_segments_matches_jax():
    g = np.arange(9.0, dtype=np.float32)[:, None, None] * np.ones((1, 4, 4), np.float32)
    d = g + 100
    sg, sd = segments.split_segments(torch.from_numpy(g), torch.from_numpy(d), 4)
    wg, wd = jseg.split_segments(jnp.asarray(g), jnp.asarray(d), 4)
    assert sg.shape == (4, 3, 4, 4)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(wg))
    np.testing.assert_array_equal(sd.numpy(), np.asarray(wd))
    assert torch.equal(sg[0, -1], sg[1, 0]) and torch.equal(sg[2, -1], sg[3, 0])  # the overlap
    # Sensor dtypes split as they are: uint8 gray, raw uint16 depth.
    raw_g, raw_d = torch.from_numpy(g.astype(np.uint8)), torch.from_numpy(d.astype(np.uint16))
    ug, ud = segments.split_segments(raw_g, raw_d, 4)
    assert ug.dtype == torch.uint8 and ud.dtype == torch.uint16
    assert torch.equal(ug.float(), sg) and torch.equal(ud.float(), sd)
    with pytest.raises(ValueError, match="% S == 0"):
        segments.split_segments(torch.from_numpy(g), torch.from_numpy(d), 5)


@pytest.mark.parametrize("n, s", [(13, 4), (9, 8), (7, 1)])
def test_stitch_segments_matches_jax(n, s):
    """Stitching exact segment-local ground truth gives back the global
    trajectory, as JAX's associative scan does."""
    xs = np.random.default_rng(0).normal(size=(n - 1, 6)).astype(np.float32) * 0.05
    steps = lie.matrix_from_rt(*lie.exp_se3(torch.from_numpy(xs))).numpy()
    glob = [np.eye(4, dtype=np.float32)]
    for T in steps:
        glob.append(glob[-1] @ T)
    glob = np.stack(glob)
    step = (n - 1) // s
    seg_local = np.stack([
        np.linalg.inv(glob[k * step])[None] @ glob[k * step:k * step + step + 1]
        for k in range(s)
    ]).astype(np.float32)
    got = segments.stitch_segments(torch.from_numpy(seg_local)).numpy()
    assert got.shape == (n, 4, 4)
    np.testing.assert_allclose(got, glob, atol=1e-4)
    want = np.asarray(jseg.stitch_segments(jnp.asarray(seg_local)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def clip():
    cfg = small_cfg()
    grays, depths, gt = _render_stack(cfg, 13, seed=2)
    return (cfg, convert.config_from_jax(cfg), grays, depths, gt,
            torch.from_numpy(np.asarray(grays)), torch.from_numpy(np.asarray(depths)))


@pytest.mark.parametrize("refine", [False, True])
def test_track_long_sequence_matches_jax(clip, refine):
    cfg, tcfg, grays, depths, gt, tg, td = clip
    got = segments.track_long_sequence(tg, td, tcfg, 4, refine=refine).numpy()
    want = np.asarray(jseg.track_long_sequence(grays, depths, cfg, 4, refine=refine))
    assert got.shape == (13, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    assert absolute_trajectory_error(got, gt).rmse < 0.03


def test_segments_match_serial_roughly(clip):
    """tests/test_segments.py::test_matches_serial_roughly: each segment
    restarts its keyframe at the boundary, so the stitched end pose carries
    each boundary's single-frame error, within 2 cm of the serial scan's."""
    _, tcfg, _, _, _, tg, td = clip
    serial = batch.vo_scan(tg, td, tcfg)[0].numpy()
    sg, sd = segments.split_segments(tg, td, 4)
    seg_poses = segments.track_segments(sg, sd, tcfg)
    assert seg_poses.shape == (4, 4, 4, 4)
    np.testing.assert_array_equal(seg_poses[:, 0].numpy(), np.tile(np.eye(4, dtype=np.float32), (4, 1, 1)))
    # A segment is vo_scan of its frames: the first equals the serial scan's start.
    np.testing.assert_array_equal(seg_poses[0].numpy(), serial[:4])
    parallel = segments.stitch_segments(seg_poses).numpy()
    d = np.linalg.inv(serial[-1]) @ parallel[-1]
    assert np.linalg.norm(d[:3, 3]) < 0.02
    with pytest.raises(TypeError, match="Mesh"):
        segments.track_segments(sg, sd, tcfg, mesh=object())
