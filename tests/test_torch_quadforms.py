"""The reference-gradient tracker of the port: the 12-component quad forms
("hw12", "flat", "t", "flat16", "flatbf") and a ``bilinear_impl`` that is
not "quad*" (the structure sampled directly, "take4"), against the JAX
package's jitted functions on the same seeded inputs at 160x120 (CPU, plain
kernel versions).

Tolerances: quad tables bit-equal after ``convert`` maps the JAX layouts;
samples bit-equal (integer coordinates, the floor knife edge, and random
ones); one residual evaluation's per-point terms bit-equal and its sums
within the float32 summation bound of their float64 sum
(test_torch_slice.py); three chained frames' poses within 1e-4 m / 1e-4 rad,
counts and promotion flags equal; batched lanes bit-equal to B = 1; a
checkpoint resumed bit-equal to the continuous run.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront
from revo_tpu import ops as jops
from revo_tpu import tracker as jtracker
from revo_tpu.ops.interp import bilinear_sample as j_take4
from revo_tpu.ops.interp import bilinear_sample_quad as j_quad
from revo_tpu_torch import checkpoint, convert, frontend, lanes, lie, solver, system, tracker
from revo_tpu_torch.ops import edt as tedt
from revo_tpu_torch.ops import interp
from revo_tpu_torch.ops import lgsx as K3

from test_torch_batched import assert_lane_equal
from test_torch_ops import _edges
from test_torch_slice import (
    _angle, _jax_frames, _numpy_tree, _torch_frames, assert_terms_and_sums, jax_residual_fn, seq,
)
from test_torch_vo import run_host
from test_solver import small_cfg

torch.set_num_threads(1)

TWELVE = ["hw12", "flat", "t", "flat16", "flatbf"]
POSE_TOL = 1e-4  # a short chain against the JAX package (ROADMAP)
# (quad_form, bilinear_impl): the f32 and bf16 12-component tables through
# the quad sampler, and the structure through "take4".
CASES = [("flat", "quad_lf"), ("flatbf", "quad_lf"), ("dt4bf", "take4")]
IDS = ["flat", "flatbf", "take4"]


def _cfg(quad_form, impl, solver_name="lm"):
    cfg = small_cfg()
    opt = dataclasses.replace(cfg.tracker.optimizer, quad_form=quad_form, bilinear_impl=impl,
                              solver=solver_name)
    return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, optimizer=opt))


def _table(kf, lvl, tcfg):
    """The level's table as the tracker hands it to the solver."""
    if solver.uses_quad_table(tcfg.tracker.optimizer):
        return kf.quads[lvl]
    return kf.structs[lvl].flatten(-3, -2)


@pytest.mark.parametrize("form", TWELVE + ["dt4", "dt4bf"])
def test_quad_structure_bit_equal(form):
    """Tables from the port's structure bit-equal to the JAX package's in
    the port's rows; the structures themselves too."""
    e = _edges(9)
    sj = jops.keyframe_structure(jnp.asarray(e))
    st = tedt.keyframe_structure(torch.from_numpy(e))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    qt = tedt.quad_structure(st, form)
    want = convert._tensor(convert.quad_from_numpy(np.asarray(jops.quad_structure(sj, form)),
                                                   st.shape), "cpu")
    width, dtype = tedt.QUAD_FORMS[form]
    assert qt.shape == (120 * 160, width) and qt.dtype == dtype == want.dtype
    assert torch.equal(qt, want)
    # Lanes on the leading axis: each lane's table is the one it gets alone.
    both = tedt.quad_structure(torch.stack([st, st.flip(0)]), form)
    assert torch.equal(both[0], qt) and torch.equal(both[1], tedt.quad_structure(st.flip(0), form))


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="quad form"):
        tedt.quad_structure(torch.zeros(4, 5, 3), "hw16")
    for field, value in (("bilinear_impl", "quad_x"), ("quad_form", "dt8")):
        opt = dataclasses.replace(convert.config_from_jax(small_cfg()).tracker.optimizer,
                                  **{field: value})
        with pytest.raises(ValueError, match=field):
            solver.uses_quad_table(opt)
    with pytest.raises(ValueError, match="layout"):
        K3.table_layout(torch.zeros(6, 3, dtype=torch.bfloat16))


@pytest.mark.parametrize("form", ["flat", "flatbf", "take4"])
def test_samplers_match_jitted_jax(form):
    """Both new samplers against jitted JAX (XLA fuses the 4-tap sums into
    FMAs, which the port reproduces), on the keyframe structure of real
    edges: integer coordinates (floor knife edge) and random ones."""
    e = _edges(10)
    sj = jops.keyframe_structure(jnp.asarray(e))
    st = tedt.keyframe_structure(torch.from_numpy(e))
    rng = np.random.default_rng(12)
    u = rng.uniform(1.0, 157.9, 4096).astype(np.float32)
    v = rng.uniform(1.0, 117.9, 4096).astype(np.float32)
    u[:256] = np.round(u[:256])
    v[128:384] = np.round(v[128:384])
    uj, vj, ut, vt = jnp.asarray(u), jnp.asarray(v), torch.from_numpy(u), torch.from_numpy(v)
    if form == "take4":
        want = jax.jit(j_take4)(sj, uj, vj)
        got = interp.sample_table(st.reshape(-1, 3), ut, vt, 120, 160)
    else:
        want = jax.jit(lambda q, a, b: j_quad(q, a, b, h=120, w=160))(
            jops.quad_structure(sj, form), uj, vj)
        got = interp.sample_table(tedt.quad_structure(st, form), ut, vt, 120, 160)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lvl", [0, 2])
@pytest.mark.parametrize("quad_form,impl", CASES, ids=IDS)
def test_residual_system_matches_jax(seq, quad_form, impl, lvl):
    """One evaluation at the identity (projections on integer pixels) and
    at a seeded pose: per-point terms bit-equal, counts equal, sums within
    the float32 bound of the float64 sum of the terms."""
    cfg = _cfg(quad_form, impl)
    tcfg = convert.config_from_jax(cfg)
    opt, cam = cfg.tracker.optimizer, cfg.camera_pyramid()[lvl]
    fj = _jax_frames(seq, cfg)
    kj = jfront.make_keyframe(fj[0], jnp.eye(4), cfg)
    kt = convert.keyframe_from_numpy(_numpy_tree(kj), device="cpu")
    ft = convert.frame_from_numpy(_numpy_tree(fj[1]), device="cpu")
    table_j = kj.quads[lvl] if impl.startswith("quad") else kj.structs[lvl]
    table_t = _table(kt, lvl, tcfg)
    assert table_t.shape[-1] == (12 if impl.startswith("quad") else 3)
    xi = (np.random.default_rng(lvl).normal(size=6) * 0.004).astype(np.float32)
    R, t = lie.exp_se3(torch.from_numpy(xi))
    jsys = jax_residual_fn(cam, opt.edge_distance_lvl[lvl], opt.huber_edge,
                           opt.use_edge_filter, impl)
    for R_, t_ in ((torch.eye(3), torch.zeros(3)), (R, t)):
        sj, terms_j = jsys(table_j, fj[1].levels[lvl].cloud,
                           jnp.asarray(R_.numpy()), jnp.asarray(t_.numpy()))
        args = (table_t, ft.levels[lvl].cloud, tcfg.camera_pyramid()[lvl], R_, t_,
                opt.edge_distance_lvl[lvl], opt.huber_edge, opt.use_edge_filter)
        assert_terms_and_sums(sj, terms_j, solver.residual_system(*args),
                              K3.residual_terms(*args))


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
@pytest.mark.parametrize("quad_form,impl", CASES, ids=IDS)
def test_track_frames_matches_jax(seq, quad_form, impl, solver_name):
    """build_frame -> make_keyframe -> track_frames over frames 1..3 on both
    sides, each frame from the previous pose."""
    cfg = _cfg(quad_form, impl, solver_name)
    tcfg = convert.config_from_jax(cfg)
    fj, ft = _jax_frames(seq, cfg), _torch_frames(seq, cfg)
    kj = jfront.make_keyframe(fj[0], jnp.eye(4), cfg)
    kt = frontend.make_keyframe(ft[0], torch.eye(4), tcfg)
    Rj, tj, Rt, tt = jnp.eye(3), jnp.zeros(3), torch.eye(3), torch.zeros(3)
    moved = 0.0
    for i in range(1, len(fj)):
        rj = jtracker.track_frames(kj, fj[i], Rj, tj, cfg)
        rt = tracker.track_frames(kt, ft[i], Rt, tt, tcfg)
        Rj, tj, Rt, tt = rj.R, rj.t, rt.R, rt.t
        assert float(np.abs(rt.t.numpy() - np.asarray(rj.t)).max()) <= POSE_TOL
        assert _angle(rt.R.numpy(), np.asarray(rj.R)) <= POSE_TOL
        assert int(rt.good) == int(rj.good) and int(rt.bad) == int(rj.bad)
        assert bool(rt.new_kf) == bool(rj.new_kf)
        moved = max(moved, float(np.linalg.norm(rt.t.numpy())))
    assert moved > 1e-3


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
@pytest.mark.parametrize("quad_form,impl", CASES[1:], ids=IDS[1:])
def test_track_frames_lanes_bit_equal(seq, quad_form, impl, solver_name):
    """Frames 1..3 as three lanes against one keyframe shared by stride 0,
    from three initial poses: each lane bit-equal to it tracked alone."""
    tcfg = convert.config_from_jax(_cfg(quad_form, impl, solver_name))
    gray, depth, _ = seq
    g, d = torch.from_numpy(np.stack(gray)), torch.from_numpy(np.stack(depth))
    frames = frontend.build_frame_batched(g[1:], d[1:], tcfg)
    kf = frontend.make_keyframe(frontend.build_frame(g[0], d[0], tcfg), torch.eye(4), tcfg)
    xi = np.zeros((3, 6), np.float32)
    xi[2] = [0.01, -0.005, 0.004, 0.002, -0.003, 0.001]
    R0, t0 = lie.exp_se3(torch.from_numpy(xi))
    res = tracker.track_frames_batched(lanes.add_lane_axis(kf._replace(frame=None), 3), frames,
                                       R0, t0, tcfg)
    for i in range(3):
        assert_lane_equal(res, tracker.track_frames(kf, lanes.lane(frames, i), R0[i], t0[i],
                                                    tcfg), i)


def test_checkpoint_round_trip_flatbf(tmp_path):
    """VOSystem under "flatbf": cut after 4 frames, the checkpoint written,
    loaded and restored into a fresh system (its quad tables rebuilt from
    the structures), then 3 more frames: bit-equal to the continuous run;
    the scan state through save / load likewise."""
    from revo_tpu_torch.io import synthetic as tsyn
    from revo_tpu_torch.parallel import batch

    tcfg = convert.config_from_jax(_cfg("flatbf", "quad_lf"))
    frames = [(g, d, ts) for g, d, _, ts in
              tsyn.render_sequence(tsyn.SyntheticScene(), tcfg.camera, 7, seed=2)]
    full, _ = run_host(system.VOSystem(tcfg, device="cpu"), frames)
    vo = system.VOSystem(tcfg, device="cpu")
    run_host(vo, frames[:4])
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save(path, checkpoint.capture(vo))
    resumed = system.VOSystem(tcfg, device="cpu")
    checkpoint.restore(resumed, checkpoint.load(path), vo.prev_frame)
    assert resumed.kf.quads[0].dtype == torch.bfloat16 and resumed.kf.quads[0].shape[-1] == 12
    for a, b in zip(resumed.kf.quads, vo.kf.quads):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(run_host(resumed, frames[4:])[0], full[4:])
    grays = torch.from_numpy(np.stack([f[0] for f in frames]))
    depths = torch.from_numpy(np.stack([f[1] for f in frames]))
    state = batch.vo_scan(grays[:4], depths[:4], tcfg)[2]
    scan_path = os.path.join(tmp_path, "scan.npz")
    checkpoint.save_scan_state(scan_path, state)
    loaded = checkpoint.load_scan_state(scan_path, tcfg, device="cpu")
    for a, b in zip(loaded.kf.quads, state.kf.quads):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    np.testing.assert_array_equal(batch.vo_scan_from_state(loaded, grays[4:], depths[4:], tcfg)[0],
                                  batch.vo_scan(grays, depths, tcfg)[0][4:])
