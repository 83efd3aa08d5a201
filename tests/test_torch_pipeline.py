"""The port's two-stage replay (revo_tpu_torch.parallel.pipeline) against the
port's sequential step and the JAX package's ``pipeline_replay``
(revo_tpu.parallel.pipeline), on the CPU at 160x120; the case of
tests/test_pipeline.py (small_cfg, 6 frames, seed 5).

Tolerances: bit-equal to the port's sequential build + track on one device,
with the stages on ``[cpu, cpu]`` and on ``[cpu]`` (the same kernels in the
same order); within 1e-4 m / 1e-4 rad of JAX's pipeline (conftest's virtual
devices); non-trivial motion and errors < 5.0, as the JAX test asks.
"""
import numpy as np
import pytest
import torch

from revo_tpu.io.synthetic import SyntheticScene, render_sequence
from revo_tpu.parallel.pipeline import pipeline_replay as jpipeline_replay
from revo_tpu_torch import convert, lie, pipeline_replay, tracker
from revo_tpu_torch.frontend import build_frame, make_keyframe

from test_solver import small_cfg
from test_torch_vo import assert_poses_close

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def clip():
    cfg = small_cfg()
    frames = list(render_sequence(SyntheticScene(), cfg.camera, 6, seed=5))
    return cfg, convert.config_from_jax(cfg), [f[0] for f in frames], [f[1] for f in frames]


def _sequential(grays, depths, cfg):
    """The single-device step: build, then track against frame 0's keyframe."""
    kf = make_keyframe(build_frame(torch.from_numpy(grays[0]), torch.from_numpy(depths[0]), cfg),
                       torch.eye(4), cfg)
    R, t = torch.eye(3), torch.zeros(3)
    poses, errors = [torch.eye(4)], [torch.zeros(())]
    for g, d in zip(grays[1:], depths[1:]):
        res = tracker.track_frames(
            kf, build_frame(torch.from_numpy(g), torch.from_numpy(d), cfg), R, t, cfg)
        R, t = res.R, res.t
        poses.append(lie.matrix_from_rt(R, t))
        errors.append(res.error)
    return torch.stack(poses), torch.stack(errors)


@pytest.mark.parametrize("devices", [[CPU, CPU], [CPU]])
def test_matches_sequential_step_and_jax(clip, devices):
    cfg, tcfg, grays, depths = clip
    poses, errors = pipeline_replay(grays, depths, tcfg, devices=devices)
    want_p, want_e = _sequential(grays, depths, tcfg)
    assert poses.shape == (6, 4, 4) and errors.shape == (6,)
    assert torch.equal(poses, want_p) and torch.equal(errors, want_e)
    poses_j, _ = jpipeline_replay(grays, depths, cfg)
    assert_poses_close(poses.numpy(), np.asarray(poses_j), 1e-4)
    # It tracked: non-trivial motion, low DT error.
    assert float(poses[1:, :3, 3].abs().max()) > 1e-4
    assert float(errors[1:].max()) < 5.0


def test_tensor_inputs_and_no_card(clip, monkeypatch):
    """Frames may come as one stacked tensor; with no devices named and no
    card the pipeline refuses instead of running on the CPU."""
    _, tcfg, grays, depths = clip
    g, d = torch.from_numpy(np.stack(grays[:3])), torch.from_numpy(np.stack(depths[:3]))
    poses, _ = pipeline_replay(g, d, tcfg, devices=["cpu"])
    assert torch.equal(poses, _sequential(grays[:3], depths[:3], tcfg)[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline_replay(grays, depths, tcfg)
