"""The port's windowed joint BA (revo_tpu_torch.parallel.windowed) against
the JAX package's (revo_tpu.parallel.windowed, jitted), on the same seeded
numpy inputs, on the CPU: the wireframe windows of tests/test_windowed.py
(160x120, P = 1024) and keyframes rendered at 160x120.

Tolerances: the pair pass's masks equal, r and w within 1e-5, Jr on the
lanes that count within 5e-7 of its largest entry (entries reach ~190,
where one float32 ulp is 1.5e-5, so an absolute 1e-5 cannot hold; measured
3e-5 to 4.6e-5, two or three ulps of the Jacobian's sums, which XLA fuses
into FMAs), the adjoint within 1e-6; one assembled system (H, b, err) within
1e-4 of its largest entry; overlap matrix within 1e-6, the
overlap pair lists identical and their weights within 1e-6; optimized poses
within 1e-4 and the exit lambda equal.  The pyramid, ``refine_keyframes`` and
the divergent start are in tests/test_torch_windowed_pyramid.py.

Seeds are the JAX tests' own; they sit away from accept/reject ties of the
LM schedule (where ``en < err`` holds by less than the summation-order
difference between the packages, the schedules part and poses differ by a
whole step): each case below checks that both packages took the same
number of accepted steps by comparing the exit lambda.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import lie as jlie
from revo_tpu.config import OptimizerConfig as JOpt
from revo_tpu.parallel import windowed as jw
from revo_tpu_torch import convert
from revo_tpu_torch.config import OptimizerConfig
from revo_tpu_torch.parallel import windowed as tw

from test_solver import CAM as JCAM
from test_windowed import _build_window, _build_window_at, _pose_errors

torch.set_num_threads(1)

POSE_TOL = 1e-4
CAM = convert._SECTIONS["camera"](**convert._fields(JCAM))
OPT = OptimizerConfig()


def _port(win):
    return convert.window_from_numpy(jax.tree.map(np.asarray, win), device="cpu")


def _pairs(pairs_j):
    return tuple(torch.from_numpy(np.asarray(a)) for a in pairs_j)


def _assert_pairs_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-6)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.float32


def _revisit_window(drift=0.012, seed=2):
    """tests/test_windowed.py::TestOverlapPairs._revisit_window: an
    out-and-back trajectory of 6 frames whose last frame revisits the
    first, with drift growing along the stored poses."""
    rng = np.random.default_rng(seed)
    xi = np.array([0.05, 0.012, 0.02, 0.004, 0.025, 0.0], np.float32)
    true = []
    for a in [0.0, 1.0, 2.0, 2.2, 1.1, 0.08]:
        dR, dt = jlie.exp_se3(jnp.asarray(a * xi))
        true.append(np.asarray(jlie.matrix_from_rt(dR, dt)))
    win, true = _build_window_at(JCAM, np.stack(true).astype(np.float32))
    init = np.asarray(win.poses).copy()
    for k in range(1, 6):
        dxi = rng.normal(size=6).astype(np.float32) * drift * k / 5.0
        dR, dt = jlie.exp_se3(jnp.asarray(dxi))
        init[k] = np.asarray(jlie.matrix_from_rt(dR, dt)) @ init[k]
    return win._replace(poses=jnp.asarray(init)), true


@pytest.mark.parametrize("n_frames, perturb, seed", [(3, 0.01, 8), (4, 0.02, 9), (4, 0.0, 0)])
def test_pair_system_matches_jax(n_frames, perturb, seed):
    win, _ = _build_window(n_frames=n_frames, perturb=perturb, seed=seed)
    pj_ = jw.make_pairs(n_frames, radius=2)
    pi, pj, _ = _pairs(pj_)

    @jax.jit
    def pair_pass(win, pi, pj):
        def one(a, b):
            return jw._pair_system(win.structs[a], win.points[b], win.valid[b], win.poses[a],
                                   win.poses[b], JCAM, OPT.huber_edge, OPT.edge_distance_lvl[0])
        return jax.vmap(one)(pi, pj)

    Jr_j, Ad_j, r_j, w_j, good_j = (np.asarray(x) for x in pair_pass(win, pj_[0], pj_[1]))
    tw_ = _port(win)
    Jr, Ad, r, w, good = (x.numpy() for x in tw._pair_system(
        tw_.structs, tw_.points, tw_.valid, tw_.poses, pi, pj, CAM,
        OPT.huber_edge, OPT.edge_distance_lvl[0]))
    assert good.shape == (len(pi), 1024) and good.sum() > 100 * len(pi)
    np.testing.assert_array_equal(good, good_j)
    np.testing.assert_array_equal(w > 0, w_j > 0)
    np.testing.assert_allclose(r, r_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(w, w_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(Ad, Ad_j, rtol=0, atol=1e-6)
    # Lanes outside ``good`` carry weight 0 (and 1 / 1e-12 where z is 0).
    np.testing.assert_allclose(Jr[good], Jr_j[good], rtol=0,
                               atol=5e-7 * np.abs(Jr_j[good]).max())


@pytest.mark.parametrize("n_frames, perturb, seed, radius", [(3, 0.01, 8, 2), (5, 0.008, 5, 1)])
def test_accumulate_pairs_matches_jax(n_frames, perturb, seed, radius):
    win, _ = _build_window(n_frames=n_frames, perturb=perturb, seed=seed)
    pairs_j = jw.make_pairs(n_frames, radius=radius)
    pairs_j = (pairs_j[0], pairs_j[1], pairs_j[2] * jnp.linspace(0.5, 2.0, len(pairs_j[2])))
    want = jax.jit(lambda w_, a, b, c: jw._accumulate_pairs(w_, a, b, c, JCAM, JOpt(), 0, n_frames))(
        win, *pairs_j)
    got = tw._accumulate_pairs(_port(win), *_pairs(pairs_j), CAM, OPT, 0, n_frames)
    assert got[0].shape == (n_frames, n_frames, 6, 6) and got[1].shape == (n_frames, 6)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())
    # Symmetric, and every block row sums to zero (a pair adds +A, +A, -A, -A).
    H = got[0].permute(0, 2, 1, 3).reshape(6 * n_frames, 6 * n_frames)
    assert float((H - H.T).abs().max()) <= 1e-4 * float(H.abs().max())
    assert float(got[0].sum(1).abs().max()) <= 1e-4 * float(H.abs().max())


def test_make_pairs_matches_jax():
    for n, radius in ((4, 2), (6, 1), (3, 5)):
        _assert_pairs_equal(tw.make_pairs(n, radius), jw.make_pairs(n, radius))


def test_overlap_matches_jax():
    win, _ = _revisit_window()
    O_j = np.asarray(jw.measure_overlap(win, JCAM, JOpt()))
    O = tw.measure_overlap(_port(win), CAM, OPT).numpy()
    assert O.shape == (6, 6) and np.allclose(np.diag(O), 0.0) and O[0, 5] > 0.5
    np.testing.assert_allclose(O, O_j, rtol=0, atol=1e-6)
    got = tw.make_pairs_overlap(_port(win), CAM, OPT)
    _assert_pairs_equal(got, jw.make_pairs_overlap(win, JCAM, JOpt()))
    assert (0, 5) in set(zip(got[0].tolist(), got[1].tolist()))
    # max_pairs, and the ring fallback when nothing clears the threshold.
    _assert_pairs_equal(tw.make_pairs_overlap(_port(win), CAM, OPT, max_pairs=4),
                        jw.make_pairs_overlap(win, JCAM, JOpt(), max_pairs=4))
    _assert_pairs_equal(tw.make_pairs_overlap(_port(win), CAM, OPT, min_overlap=1.5),
                        jw.make_pairs(6, radius=1))


@pytest.mark.parametrize("n_frames, perturb, seed, iters, radius", [
    (4, 0.0, 0, 10, 2),  # test_consistent_window_stays_put
    (4, 0.01, 3, 10, 2),  # test_recovers_perturbed_window
    (4, 0.01, 4, 5, 2),  # test_gauge_fixed
    (5, 0.008, 5, 6, 2),  # test_sharded_matches_single's window
])
def test_optimize_window_matches_jax(n_frames, perturb, seed, iters, radius):
    win, true = _build_window(n_frames=n_frames, perturb=perturb, seed=seed)
    pairs_j = jw.make_pairs(n_frames, radius=radius)
    p_j, e_j, lam_j = jw._optimize_window_full(win, *pairs_j, JCAM, JOpt(), iters=iters)
    twin = _port(win)
    p_t, e_t, lam_t = tw._optimize_window_full(twin, *_pairs(pairs_j), CAM, OPT, iters=iters)
    assert lam_t == float(lam_j)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=POSE_TOL)
    assert float(e_t) == pytest.approx(float(e_j), rel=1e-3)
    np.testing.assert_allclose(p_t[0].numpy(), np.asarray(win.poses[0]), atol=1e-6)  # gauge
    init = _pose_errors(np.asarray(win.poses), true)
    errs = _pose_errors(p_t.numpy(), true)
    if perturb > 0:
        assert errs.max() < init.max(), (init, errs)
    else:
        assert errs.max() < 0.005
    # The public form returns the same poses and error.
    p2, e2 = tw.optimize_window(twin, *_pairs(pairs_j), CAM, OPT, iters=iters)
    assert torch.equal(p2, p_t) and torch.equal(e2, e_t)


def test_overlap_pairs_beat_ring_on_revisit_like_jax():
    win, true = _revisit_window()
    twin = _port(win)
    ring = tw.optimize_window(twin, *tw.make_pairs(6, radius=1), CAM, OPT, iters=12)[0]
    pairs = tw.make_pairs_overlap(twin, CAM, OPT)
    ovl, _, lam_t = tw._optimize_window_full(twin, *pairs, CAM, OPT, iters=12)
    err_ring, err_ovl = _pose_errors(ring.numpy(), true), _pose_errors(ovl.numpy(), true)
    assert err_ovl.max() <= err_ring.max() * 1.05 and err_ovl[5] < err_ring[5]
    p_j, _, lam_j = jw._optimize_window_full(
        win, *jw.make_pairs_overlap(win, JCAM, JOpt()), JCAM, JOpt(), iters=12)
    assert lam_t == float(lam_j)
    np.testing.assert_allclose(ovl.numpy(), np.asarray(p_j), rtol=0, atol=POSE_TOL)


def test_sharded_form_raises_and_window_converts():
    win, _ = _build_window(n_frames=3)
    twin = _port(win)
    assert isinstance(twin, tw.Window) and twin.valid.dtype == torch.bool
    for a, b in zip(twin, win):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    as_dict = convert.window_from_numpy({k: np.asarray(v) for k, v in win._asdict().items()},
                                        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(as_dict, twin))
    with pytest.raises(TypeError, match="Mesh"):
        tw.optimize_window_sharded(twin, CAM, OPT, mesh=object())
