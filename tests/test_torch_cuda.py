"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports no jax, so it runs where the
card is:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: bit-equal for K1/K2 masks (K2 in both its forms) and the front
end's edges/clouds; K3 within rtol 1e-4 / atol 1e-5 of each output's
largest entry (reduction order), and bit-identical from run to run (fixed
order, no atomics); fused K3: good and bad counts equal, floats within 1e-5
of each output's largest entry, bit-identical from run to run; VOSystem on
the card: the CPU run's per-frame flags, poses within 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from revo_tpu_torch import frontend, solver
from revo_tpu_torch.config import CameraConfig, SystemConfig
from revo_tpu_torch.io.synthetic import SyntheticScene, render_frame
from revo_tpu_torch.ops import canny as K12
from revo_tpu_torch.ops import lgsx as K3
from revo_tpu_torch.ops.filters import _reflect_pad

from _torch_inputs import CAM, make_inputs, make_pose, torch_args

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


def _gray(h, w, seed):
    """Smooth blobs plus a bright rectangle, uint8-valued float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 40.0 + 30.0 * np.sin(xx / 17.0) + 25.0 * np.cos(yy / 23.0)
    for _ in range(8):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s, a = rng.uniform(5, 25), rng.uniform(40, 120)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img[int(h * 0.3):int(h * 0.6), int(w * 0.2):int(w * 0.5)] += 60
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 480, 640), (8, 120, 160), (3, 37, 53)])
def test_canny_kernels_bit_equal(cuda, shape):
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)]))
    gp = _reflect_pad(imgs, 1, 1).contiguous().to(cuda)
    c_k, s_k = K12.canny_nms(gp, 1e4, 2.25e4)
    c_p, s_p = K12.canny_nms_ref(gp, 1e4, 2.25e4)
    assert torch.equal(c_k, c_p) and torch.equal(s_k, s_p)
    want = K12.hysteresis_ref(c_p, s_p)
    assert K12.hysteresis_fits_shared(cuda, h, w)
    for form in (None, "shared", "global"):
        assert torch.equal(K12.canny_hysteresis(c_p, s_p, _form=form), want)


@pytest.mark.parametrize("shape", [(24, 40), (23, 41)])
def test_hysteresis_cap_binds_on_card(cuda, shape):
    """A snake longer than H+W: both kernels must stop where the JAX loop's
    cap stops the plain version (whole-word and ragged rows)."""
    h, w = shape
    cand = torch.zeros(h, w, dtype=torch.bool)
    for y in range(0, h, 2):
        cand[y, 1:w - 1] = True
        if y + 1 < h:
            cand[y + 1, (w - 2) if (y // 2) % 2 == 0 else 1] = True
    strong = torch.zeros_like(cand)
    strong[0, 1] = True
    cand, strong = cand[None].to(cuda), strong[None].to(cuda)
    want = K12.hysteresis_ref(cand, strong)
    for form in ("shared", "global"):
        got = K12.canny_hysteresis(cand, strong, _form=form)
        assert torch.equal(got, want)
        assert 0 < int(got.sum()) < int(cand.sum())


def test_hysteresis_form_follows_the_shape(cuda):
    """Every pyramid level of a 640x480 frame takes the shared-memory kernel;
    an image whose packed masks exceed a block's shared memory takes the
    global one, by shape alone."""
    assert all(K12.hysteresis_fits_shared(cuda, h, w)
               for h, w in ((480, 640), (240, 320), (120, 160), (576, 1024)))
    h, w = 720, 1280
    assert not K12.hysteresis_fits_shared(cuda, h, w)
    rng = np.random.default_rng(7)
    cand = torch.from_numpy(rng.random((1, h, w)) < 0.3).to(cuda)
    strong = cand & torch.from_numpy(rng.random((1, h, w)) < 0.01).to(cuda)
    assert torch.equal(K12.canny_hysteresis(cand, strong), K12.hysteresis_ref(cand, strong))
    with pytest.raises(ValueError):
        K12.canny_hysteresis(cand, strong, _form="shared")


def test_lgsx_kernel_close_and_deterministic(cuda):
    rng = np.random.default_rng(2)
    p = 16384
    wxp = rng.normal(size=(p, 3)).astype(np.float32)
    wxp[:, 2] = np.abs(wxp[:, 2]) + 0.5
    grads = (rng.normal(size=(p, 2)) * 50).astype(np.float32)
    r = rng.uniform(0, 3, p).astype(np.float32)
    w = np.where(rng.random(p) < 0.8, np.minimum(1.0, 0.3 / r), 0.0).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (wxp, grads, r, w)]
    got = K3.lgsx_reduce(*args)
    want = K3.lgsx_reduce_ref(*args)
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max())
    again = K3.lgsx_reduce(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("quad_form", ["dt4bf", "dt4"])
@pytest.mark.parametrize("pose", ["identity", "tracked", "out"])
@pytest.mark.parametrize("size", [(640, 480, 16384), (320, 240, 4864), (160, 120, 1000)])
def test_residual_lgsx_kernel_counts_equal_sums_close_deterministic(cuda, size, pose, quad_form):
    """The fused kernel against its plain version on the card: one launch,
    no other work; counts equal; floats within 1e-5 of the largest entry;
    the same bits from a second launch."""
    w, h, p = size
    cam = dict(CAM, width=w, height=h, fx=CAM["fx"] * w / 160, fy=CAM["fy"] * w / 160,
               cx=CAM["cx"] * w / 160, cy=CAM["cy"] * w / 160)
    quad, pts, valid = make_inputs(p, p, quad_form, cam)
    args = torch_args(quad, pts, valid, *make_pose(pose), quad_form, device=cuda, cam=cam)
    before = K3.residual_lgsx.launches
    got = solver._residual_sums(*args)
    assert K3.residual_lgsx.launches == before + 1
    want = K3.residual_lgsx_ref(*args)
    assert int(got[4]) == int(want[4]) and int(got[5]) == int(want[5])
    assert int(got[4]) + int(got[5]) == int(valid.sum())
    if pose == "out":
        assert int(got[5]) > int(got[4])
    for a, b in zip(got[:4], want[:4]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    again = K3.residual_lgsx(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_build_frame_on_card_matches_cpu(cuda):
    cam = CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)
    cfg = SystemConfig(camera=cam, pyramid=dataclasses.replace(
        SystemConfig().pyramid, edge_capacity=(4096, 2048, 1024)))
    g, d = render_frame(SyntheticScene(), cam, np.eye(4, dtype=np.float32), seed=5)
    g8 = torch.from_numpy(g.astype(np.uint8))
    d16 = torch.from_numpy((d * 5000.0).astype(np.uint16))
    before = K12.canny_nms.launches
    f_card = frontend.build_frame(g8.to(cuda), d16.to(cuda), cfg)
    assert K12.canny_nms.launches == before + 3
    f_cpu = frontend.build_frame(g8, d16, cfg)
    for a, b in zip(f_card.levels, f_cpu.levels):
        assert torch.equal(a.edges.cpu(), b.edges)
        assert torch.equal(a.cloud.valid.cpu(), b.cloud.valid)
        assert int(a.cloud.count) == int(b.cloud.count)
        torch.testing.assert_close(a.cloud.points.cpu(), b.cloud.points, rtol=1e-6, atol=0)


def test_vosystem_pan_on_card_matches_cpu(cuda):
    """VOSystem over a 160x120 fast pan (4 cm + ~1 deg per frame, the motion
    of tests/test_system.py) on the card: the same promotion /
    relocalization / lost flags as on the CPU, poses within 1e-4."""
    from revo_tpu_torch import lie, system

    cam = CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)
    cfg = SystemConfig(camera=cam, pyramid=dataclasses.replace(
        SystemConfig().pyramid, edge_capacity=(4096, 2048, 1024)))
    step = lie.matrix_from_rt(*lie.exp_se3(
        torch.tensor([0.04, 0.0, 0.005, 0.0, 0.017, 0.0]))).numpy()
    T = np.eye(4, dtype=np.float32)
    frames = []
    for i in range(20):
        frames.append((*render_frame(SyntheticScene(), cam, T), i / 30.0))
        T = T @ step
    runs = []
    for device in (cuda, "cpu"):
        vo = system.VOSystem(cfg, device=device)
        poses, flags = [], []
        for g, d, ts in frames:
            before = (vo.n_keyframes, vo.n_relocalized, vo.n_tracking_lost)
            poses.append(vo.process_frame(g, d, ts))
            flags.append((vo.n_keyframes - before[0], vo.n_relocalized - before[1],
                          vo.n_tracking_lost - before[2]))
        runs.append((np.stack(poses), flags))
    (p_card, f_card), (p_cpu, f_cpu) = runs
    assert f_card == f_cpu
    assert sum(f[0] for f in f_card[1:]) >= 1  # the pan promotes
    np.testing.assert_allclose(p_card[:, :3, 3], p_cpu[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_card[:, :3, :3], p_cpu[:, :3, :3], rtol=0, atol=1e-4)
