"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports no jax, so it runs where the
card is:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: bit-equal for K1/K2 masks (K2 in both its forms), the fused
Canny's edges and the front end's edges/clouds; K3 within rtol 1e-4 / atol 1e-5 of each output's
largest entry (reduction order), and bit-identical from run to run (fixed
order, no atomics); fused K3: good and bad counts equal, floats within 1e-5
of each output's largest entry, bit-identical from run to run; VOSystem on
the card: the CPU run's per-frame flags, poses within 1e-4; loop closure on
the card: the CPU's verdicts, corrected poses within 1e-4; a run resumed on
the card from a checkpoint or a saved scan state: the continuous run's
poses bit for bit; windowed BA on the card: within 1e-3 m / 1e-3 rad of the
CPU's on the same keyframes (its block sums are atomic adds, and the LM
schedule may part on a tie), the windowed system itself within 1e-4 of its
largest entry; undistortion on the card: the rectified frame equal to the
CPU's, VOSystem flags equal and poses within 1e-4; segments on the card: the
CPU's stitched poses within 5e-4.
"""
import dataclasses
import os
import sys

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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import serpentine_gray  # noqa: E402

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", [(1, 480, 640), (8, 240, 320), (8, 120, 160), (3, 37, 53),
                                   (2, 29, 65), (1, 576, 1024), (2, 2, 2)])
def test_canny_fused_bit_equal(cuda, shape, dtype):
    """One launch from unpadded gray, float32 or uint8, whole-word and
    ragged rows, up to the largest image the shared-memory fixpoint takes:
    the plain version's edges, and the same bits from a second launch."""
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)])).to(cuda, dtype)
    before = (K12.canny_fused.launches, K12.canny_nms.launches, K12.canny_hysteresis.launches)
    got = K12.canny_batched(imgs, 60.0, 30.0)
    assert (K12.canny_fused.launches, K12.canny_nms.launches,
            K12.canny_hysteresis.launches) == (before[0] + 1, before[1], before[2])
    want = K12.canny_fused_ref(imgs, 30.0, 60.0)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert torch.equal(K12.canny_fused(imgs, 30.0, 60.0), want)
    if h > 2:
        assert int(want.sum()) > 0


@pytest.mark.parametrize("shape", [(48, 64), (47, 41), (120, 200)])
def test_canny_fused_cap_binds_on_card(cuda, shape):
    """A gray serpentine whose weak contour is longer than H+W from one
    strong stretch: the fused kernel stops where the plain loop's cap
    stops."""
    g = torch.from_numpy(serpentine_gray(*shape))[None].to(cuda)
    want = K12.canny_fused_ref(g, 40.0, 150.0)
    cand = K12.canny_nms_ref(_reflect_pad(g.float(), 1, 1), 1600.0, 22500.0)[0]
    assert 0 < int(want.sum()) < int(cand.sum())
    assert torch.equal(K12.canny_fused(g, 40.0, 150.0), want)
    assert torch.equal(K12.canny_fused(g.float(), 40.0, 150.0), want)


def test_canny_large_image_takes_the_split_kernels(cuda):
    """An image whose packed masks exceed a block's shared memory: chosen by
    shape before any launch, canny_batched runs canny_nms and the
    global-memory hysteresis, and canny_fused refuses it."""
    h, w = 720, 1280
    g = torch.from_numpy(_gray(h, w, 3))[None].to(cuda)
    before = (K12.canny_fused.launches, K12.canny_nms.launches, K12.canny_hysteresis.launches)
    got = K12.canny_batched(g, 150.0, 100.0)
    assert (K12.canny_fused.launches, K12.canny_nms.launches,
            K12.canny_hysteresis.launches) == (before[0], before[1] + 1, before[2] + 1)
    assert torch.equal(got, K12.canny_fused_ref(g, 100.0, 150.0))
    with pytest.raises(ValueError, match="shared memory"):
        K12.canny_fused(g, 100.0, 150.0)


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
    before = (K12.canny_fused.launches, K12.canny_nms.launches, K12.canny_hysteresis.launches)
    f_card = frontend.build_frame(g8.to(cuda), d16.to(cuda), cfg)
    assert (K12.canny_fused.launches, K12.canny_nms.launches,
            K12.canny_hysteresis.launches) == (before[0] + 3, before[1], before[2])
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


def _small_cfg():
    cam = CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)
    return SystemConfig(camera=cam, pyramid=dataclasses.replace(
        SystemConfig().pyramid, edge_capacity=(4096, 2048, 1024)))


def test_close_loops_on_card_matches_cpu(cuda):
    """The four loop keyframes of chip_smoke's phase 10 at 160x120: edge
    (0, 3) accepted on both devices, corrected poses within 1e-4."""
    from chip_smoke import loop_keyframes
    from revo_tpu_torch import loopclosure

    cfg = _small_cfg()
    runs = []
    for device in (cuda, "cpu"):
        kfs, gt, drifted = loop_keyframes(cfg, device)
        corrected, loops = loopclosure.close_loops(kfs, cfg, min_separation=2, radius=0.3)
        runs.append((corrected, [(e.a, e.b) for e in loops]))
    assert runs[0][1] == runs[1][1] == [(0, 3)]
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=0, atol=1e-4)
    derr = np.linalg.norm(drifted[3, :3, 3] - gt[3, :3, 3])
    assert np.linalg.norm(runs[0][0][3, :3, 3] - gt[3, :3, 3]) < 0.6 * derr


def test_resume_on_card_is_bit_equal(cuda, tmp_path):
    """VOSystem cut at frame 6 and restored from its checkpoint file, and
    vo_scan continued from a saved scan state: the continuous card run's
    poses bit for bit."""
    from revo_tpu_torch import checkpoint, system
    from revo_tpu_torch.io.synthetic import render_sequence
    from revo_tpu_torch.parallel import batch

    cfg = _small_cfg()
    frames = [(g, d, ts) for g, d, _, ts in render_sequence(SyntheticScene(), cfg.camera, 12, seed=2)]

    def run(vo, part):
        return np.stack([vo.process_frame(g, d, ts) for g, d, ts in part])

    full = run(system.VOSystem(cfg, device=cuda), frames)
    vo_a = system.VOSystem(cfg, device=cuda)
    run(vo_a, frames[:6])
    path = str(tmp_path / "vo.npz")
    checkpoint.save(path, checkpoint.capture(vo_a))
    vo_b = system.VOSystem(cfg, device=cuda)
    checkpoint.restore(vo_b, checkpoint.load(path), vo_a.prev_frame)
    np.testing.assert_array_equal(run(vo_b, frames[6:]), full[6:])

    grays = torch.from_numpy(np.stack([f[0] for f in frames])).to(cuda)
    depths = torch.from_numpy(np.stack([f[1] for f in frames])).to(cuda)
    scan_full = batch.vo_scan(grays, depths, cfg)[0]
    path = str(tmp_path / "scan.npz")
    checkpoint.save_scan_state(path, batch.vo_scan(grays[:6], depths[:6], cfg)[2])
    state = checkpoint.load_scan_state(path, cfg, device=cuda)
    assert state.kf.quads[0].is_cuda and state.kf.quads[0].dtype == torch.bfloat16
    tail = batch.vo_scan_from_state(state, grays[6:], depths[6:], cfg)[0]
    assert torch.equal(tail, scan_full[6:])


def _pan_frames(cam, n):
    from revo_tpu_torch import lie

    step = lie.matrix_from_rt(*lie.exp_se3(
        torch.tensor([0.04, 0.0, 0.005, 0.0, 0.017, 0.0]))).numpy()
    T = np.eye(4, dtype=np.float32)
    frames, gt = [], []
    for _ in range(n):
        frames.append(render_frame(SyntheticScene(), cam, T))
        gt.append(T.copy())
        T = T @ step
    return frames, np.stack(gt)


def test_windowed_ba_on_card_matches_cpu(cuda):
    """chip_smoke's phase 12 at 160x120: six pan keyframes with perturbed
    stored poses; one assembled system and the refined poses, card against
    the same keyframes on the CPU."""
    from chip_smoke import (ba_keyframes, max_translation_error, perturbed_poses, to_device)
    from revo_tpu_torch.parallel import windowed

    cfg = _small_cfg()
    frames, gt = _pan_frames(cfg.camera, 11)
    gt = gt[::2]
    stored = perturbed_poses(gt)
    kfs = ba_keyframes(cfg, cuda, [f[0] for f in frames[::2]], [f[1] for f in frames[::2]], stored)
    kfs_cpu = [to_device(k, "cpu") for k in kfs]
    assert kfs[0].structs[0].is_cuda and not kfs_cpu[0].structs[0].is_cuda

    def system_of(keyframes):
        dev = keyframes[0].T_w_k.device
        win = windowed.keyframe_window(keyframes, 0, torch.from_numpy(stored).to(dev))
        return windowed._accumulate_pairs(
            win, *windowed.make_pairs(6, 2, device=dev), cfg.camera_pyramid()[0],
            cfg.tracker.optimizer, 0, 6)

    for a, b in zip(system_of(kfs), system_of(kfs_cpu)):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    card = windowed.refine_keyframes(kfs, cfg)
    cpu = windowed.refine_keyframes(kfs_cpu, cfg)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-3)
    np.testing.assert_allclose(card[0], stored[0], atol=1e-6)  # the gauge
    assert max_translation_error(card, gt) < 0.7 * max_translation_error(stored, gt)


def test_undistort_on_card_matches_cpu(cuda):
    """chip_smoke's phase 14 at 160x120: a distorted capture of the pan
    through VOSystem(undistort=True) on the card and on the CPU."""
    from chip_smoke import TUM_FR1_DISTORTION, distort_capture
    from revo_tpu_torch import system
    from revo_tpu_torch.ops.undistort import build_undistort_maps

    base = _small_cfg()
    cam = dataclasses.replace(base.camera, distortion=TUM_FR1_DISTORTION)
    cfg = dataclasses.replace(base, camera=cam,
                              pyramid=dataclasses.replace(base.pyramid, undistort=True))
    frames, _ = _pan_frames(cam, 8)
    captured = [distort_capture(g, d, cam) for g, d in frames]
    maps = build_undistort_maps(cam)
    g, d = captured[0]
    f_card = frontend.build_frame(
        torch.from_numpy(g).to(cuda), torch.from_numpy(d).to(cuda), cfg,
        tuple(torch.from_numpy(m).to(cuda) for m in maps))
    f_cpu = frontend.build_frame(torch.from_numpy(g), torch.from_numpy(d), cfg,
                                 tuple(torch.from_numpy(m) for m in maps))
    for a, b in zip(f_card.levels, f_cpu.levels):
        assert torch.equal(a.gray.cpu(), b.gray) and torch.equal(a.edges.cpu(), b.edges)
        assert torch.equal(a.depth.cpu(), b.depth)
    runs = []
    for device in (cuda, "cpu"):
        vo = system.VOSystem(cfg, device=device)
        assert vo.undistort_maps[0].device.type == torch.device(device).type
        poses = np.stack([vo.process_frame(g, d, i / 30.0) for i, (g, d) in enumerate(captured)])
        runs.append((poses, vo.n_keyframes, vo.n_relocalized, vo.n_tracking_lost))
    assert runs[0][1:] == runs[1][1:]
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=0, atol=1e-4)


def test_segments_on_card_match_cpu(cuda):
    """track_long_sequence over a 13-frame pan in 4 segments on the card:
    the CPU's stitched trajectory within 5e-4, with and without refine."""
    from revo_tpu_torch.parallel import segments

    cfg = _small_cfg()
    frames, _ = _pan_frames(cfg.camera, 13)
    grays = torch.from_numpy(np.stack([f[0] for f in frames]))
    depths = torch.from_numpy(np.stack([f[1] for f in frames]))
    for refine in (False, True):
        card = segments.track_long_sequence(grays.to(cuda), depths.to(cuda), cfg, 4, refine=refine)
        cpu = segments.track_long_sequence(grays, depths, cfg, 4, refine=refine)
        assert card.is_cuda and card.shape == (13, 4, 4)
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0, atol=5e-4)
