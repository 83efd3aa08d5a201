"""The port's checkpointing (revo_tpu_torch.checkpoint) against the JAX
package's, at 160x120 on the CPU; the cases of tests/test_checkpoint.py,
then files carried between the packages in both directions.

Tolerances: within the port a resumed run equals the continuous one bit for
bit (one device, deterministic sums), for VOSystem and for vo_scan; a file
written by one package and resumed by the other gives poses within 1e-4 m /
1e-4 rad of the writer's continuous run (the usual port-against-JAX gap);
the two packages' scan-state files have the same keys, shapes and dtypes
(dt4bf quad tables as uint16 bits on both sides), and a state the port
saves under "hw12", "t" or "flat16" resumes in JAX with the port's flags
and poses within 1e-4.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import checkpoint as jckpt
from revo_tpu import frontend as jfront
from revo_tpu import system as jsystem
from revo_tpu.parallel import batch as jbatch
from revo_tpu_torch import checkpoint, convert, system
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.parallel import batch

from test_solver import small_cfg
from test_torch_vo import assert_poses_close

torch.set_num_threads(1)

TOL = 1e-4
CUT, N = 7, 14


def _frames(cfg, n, seed):
    return [(g, d, ts) for g, d, _, ts in
            tsyn.render_sequence(tsyn.SyntheticScene(), cfg.camera, n, seed=seed)]


def _run(vo, frames):
    return np.stack([np.asarray(vo.process_frame(g, d, ts), np.float64) for g, d, ts in frames])


@pytest.fixture(scope="module")
def cfgs():
    cfg = small_cfg()
    return cfg, convert.config_from_jax(cfg)


@pytest.fixture(scope="module")
def host_runs(cfgs, tmp_path_factory):
    """Both packages over 14 frames (seed 2), continuous and cut at frame 7
    with a checkpoint written there."""
    cfg, tcfg = cfgs
    frames = _frames(cfg, N, seed=2)
    tmp = tmp_path_factory.mktemp("ckpt")
    out = {"frames": frames}
    for name, make, mod in (("jax", lambda: jsystem.VOSystem(cfg), jckpt),
                            ("port", lambda: system.VOSystem(tcfg, device="cpu"), checkpoint)):
        out[name + "_full"] = _run(make(), frames)
        vo = make()
        _run(vo, frames[:CUT])
        path = os.path.join(tmp, name + ".npz")
        mod.save(path, mod.capture(vo))
        out[name + "_path"], out[name + "_cut"] = path, vo
    return out


def test_save_load_roundtrip(host_runs):
    vo = host_runs["port_cut"]
    ckpt = checkpoint.capture(vo)
    loaded = checkpoint.load(host_runs["port_path"])
    for f in dataclasses.fields(ckpt):
        a, b = getattr(ckpt, f.name), getattr(loaded, f.name)
        if f.name == "kf_structs":
            assert len(a) == len(b) == 3
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b and type(a) is type(b)
    assert loaded.n_frames == CUT and loaded.past_n == vo.past.n == 3
    assert loaded.T_w_kf.shape == (CUT, 4, 4)


def test_resume_equals_continuous_bit_for_bit(cfgs, host_runs):
    vo = system.VOSystem(cfgs[1], device="cpu")
    checkpoint.restore(vo, checkpoint.load(host_runs["port_path"]),
                       host_runs["port_cut"].prev_frame)
    resumed = _run(vo, host_runs["frames"][CUT:])
    np.testing.assert_array_equal(resumed, host_runs["port_full"][CUT:])
    assert_poses_close(resumed, host_runs["jax_full"][CUT:], TOL)
    assert len(vo.pose_graph) == N and vo.n_frames == N


def test_jax_checkpoint_resumes_in_the_port(cfgs, host_runs):
    loaded = checkpoint.load(host_runs["jax_path"])
    want = jckpt.load(host_runs["jax_path"])
    for f in dataclasses.fields(loaded):
        a, b = getattr(loaded, f.name), getattr(want, f.name)
        for x, y in zip(a, b) if f.name == "kf_structs" else [(a, b)]:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    prev = convert.frame_from_numpy(jax.tree.map(np.asarray, host_runs["jax_cut"].prev_frame),
                                    device="cpu")
    vo = system.VOSystem(cfgs[1], device="cpu")
    checkpoint.restore(vo, loaded, prev)
    assert vo.kf.quads[0].dtype == torch.bfloat16  # rebuilt from the structs
    assert_poses_close(_run(vo, host_runs["frames"][CUT:]), host_runs["jax_full"][CUT:], TOL)


def test_port_checkpoint_resumes_in_jax(cfgs, host_runs):
    cfg = cfgs[0]
    g, d, _ = host_runs["frames"][CUT - 1]
    prev = jfront.build_frame(jnp.asarray(g), jnp.asarray(d), cfg)
    vo = jsystem.VOSystem(cfg)
    jckpt.restore(vo, jckpt.load(host_runs["port_path"]), prev)
    assert_poses_close(_run(vo, host_runs["frames"][CUT:]), host_runs["port_full"][CUT:], TOL)


# -- scan state ------------------------------------------------------------------

SCAN_CUT, SCAN_N = 6, 10


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "reloc_ring"])
def scan_runs(request, cfgs, tmp_path_factory):
    """vo_scan in both packages over 10 frames (seed 6), continuous and cut
    after frame 6 with the state saved there; with and without the
    relocalization ring in the state."""
    cfg = dataclasses.replace(cfgs[0], tracker=dataclasses.replace(
        cfgs[0].tracker, scan_relocalization=request.param))
    tcfg = convert.config_from_jax(cfg)
    frames = _frames(cfg, SCAN_N, seed=6)
    grays, depths = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    tmp = tmp_path_factory.mktemp("scan")
    out = {"cfg": cfg, "tcfg": tcfg, "grays": grays, "depths": depths}
    gj, dj = jnp.asarray(grays), jnp.asarray(depths)
    out["jax_full"] = np.asarray(jbatch.vo_scan(gj, dj, cfg)[0], np.float64)
    out["jax_path"] = os.path.join(tmp, "jax.npz")
    jckpt.save_scan_state(out["jax_path"], jbatch.vo_scan(gj[:SCAN_CUT], dj[:SCAN_CUT], cfg)[2])
    gt, dt = torch.from_numpy(grays), torch.from_numpy(depths)
    out["port_full"] = batch.vo_scan(gt, dt, tcfg)[0].numpy().astype(np.float64)
    out["port_path"] = os.path.join(tmp, "port.npz")
    out["port_state"] = batch.vo_scan(gt[:SCAN_CUT], dt[:SCAN_CUT], tcfg)[2]
    checkpoint.save_scan_state(out["port_path"], out["port_state"],
                                tcfg.tracker.optimizer.quad_form)
    return out


def _tail(runs):
    return torch.from_numpy(runs["grays"][SCAN_CUT:]), torch.from_numpy(runs["depths"][SCAN_CUT:])


def test_scan_resume_equals_continuous_bit_for_bit(scan_runs):
    state = checkpoint.load_scan_state(scan_runs["port_path"], scan_runs["tcfg"], device="cpu")
    for (key, a), (_, b) in zip(checkpoint._flatten(state),
                                checkpoint._flatten(scan_runs["port_state"])):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), key
        else:
            assert a == b and type(a) is type(b), key
    poses = batch.vo_scan_from_state(state, *_tail(scan_runs), scan_runs["tcfg"])[0]
    np.testing.assert_array_equal(poses.numpy().astype(np.float64),
                                  scan_runs["port_full"][SCAN_CUT:])


def test_scan_state_files_have_jax_keys(scan_runs):
    """The key strings the port builds by walking its tuples are the ones
    jax.tree_util.keystr gives, with the same shapes and dtypes."""
    zj, zt = np.load(scan_runs["jax_path"]), np.load(scan_runs["port_path"])
    assert sorted(zt.files) == sorted(zj.files)
    assert ".kf.frame.levels[0].cloud.points" in zt.files and ".past.n" in zt.files
    assert (".kf_ring.quads[2]" in zt.files) == scan_runs["cfg"].tracker.scan_relocalization
    for key in zj.files:
        assert zt[key].shape == zj[key].shape and zt[key].dtype == zj[key].dtype, key
    assert zt[".kf.quads[0]"].dtype == np.uint16  # dt4bf rows as raw bits


def test_jax_scan_state_resumes_in_the_port(scan_runs):
    state = checkpoint.load_scan_state(scan_runs["jax_path"], scan_runs["tcfg"], device="cpu")
    assert state.kf.quads[0].dtype == torch.bfloat16
    assert isinstance(state.past.n, int) and isinstance(state.just_added_kf, bool)
    poses = batch.vo_scan_from_state(state, *_tail(scan_runs), scan_runs["tcfg"])[0]
    assert_poses_close(poses.numpy().astype(np.float64), scan_runs["jax_full"][SCAN_CUT:], TOL)


def test_port_scan_state_resumes_in_jax(scan_runs):
    state = jckpt.load_scan_state(scan_runs["port_path"], scan_runs["cfg"])
    poses = jbatch.vo_scan_from_state(
        state, jnp.asarray(scan_runs["grays"][SCAN_CUT:]),
        jnp.asarray(scan_runs["depths"][SCAN_CUT:]), scan_runs["cfg"])[0]
    assert_poses_close(np.asarray(poses, np.float64), scan_runs["port_full"][SCAN_CUT:], TOL)


@pytest.mark.parametrize("form", ["hw12", "t", "flat16"])
def test_port_scan_state_resumes_in_jax_in_every_quad_layout(cfgs, form, tmp_path):
    """A scan state the port saves under a quad form whose JAX layout is
    not the port's rows ((H, W, 12), (12, H*W), (H*W, 16) with a pad lane)
    is written in JAX's layout: JAX's loader takes it, its tables are JAX's
    own ``quad_structure`` of the stored structures, and JAX resumes from
    it with the port's resumed run's flags, poses within TOL; the port's own
    loader still resumes bit-equal to the port's continuous run."""
    from revo_tpu.ops.edt import quad_structure as j_quad_structure

    opt = dataclasses.replace(cfgs[0].tracker.optimizer, quad_form=form)
    cfg = dataclasses.replace(cfgs[0], tracker=dataclasses.replace(cfgs[0].tracker, optimizer=opt))
    tcfg = convert.config_from_jax(cfg)
    frames = _frames(cfg, SCAN_N - 2, seed=6)
    grays, depths = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    gt, dt = torch.from_numpy(grays), torch.from_numpy(depths)
    state = batch.vo_scan(gt[:SCAN_CUT], dt[:SCAN_CUT], tcfg)[2]
    path = str(tmp_path / "scan.npz")
    checkpoint.save_scan_state(path, state, form)
    h, w = cfg.camera.height, cfg.camera.width
    want_shape = {"hw12": (h, w, 12), "t": (12, h * w), "flat16": (h * w, 16)}[form]
    assert np.load(path)[".kf.quads[0]"].shape == want_shape
    for lvl, q in enumerate(state.kf.quads):  # the inverse of the port's reading of JAX tables
        rows = checkpoint.quad_to_jax_layout(q.numpy(), tuple(state.kf.structs[lvl].shape), form)
        np.testing.assert_array_equal(
            convert.quad_from_numpy(rows, tuple(state.kf.structs[lvl].shape)), q.numpy())

    port_state = checkpoint.load_scan_state(path, tcfg, device="cpu")
    port_poses, port_outs, _ = batch.vo_scan_from_state(port_state, gt[SCAN_CUT:], dt[SCAN_CUT:],
                                                        tcfg)
    np.testing.assert_array_equal(port_poses.numpy(), batch.vo_scan(gt, dt, tcfg)[0][SCAN_CUT:])
    jstate = jckpt.load_scan_state(path, cfg)
    for s_, q_ in zip(jstate.kf.structs, jstate.kf.quads):
        np.testing.assert_array_equal(np.asarray(q_), np.asarray(j_quad_structure(s_, form)))
    j_poses, j_outs, _ = jbatch.vo_scan_from_state(
        jstate, jnp.asarray(grays[SCAN_CUT:]), jnp.asarray(depths[SCAN_CUT:]), cfg)
    for flag in ("promoted", "relocalized", "lost"):
        np.testing.assert_array_equal(np.asarray(getattr(j_outs, flag)),
                                      getattr(port_outs, flag).numpy(), err_msg=flag)
    assert_poses_close(np.asarray(j_poses, np.float64), port_poses.numpy().astype(np.float64), TOL)


def test_config_mismatch_rejected(cfgs, tmp_path):
    cfg, tcfg = cfgs
    frames = _frames(cfg, 3, seed=6)
    state = batch.vo_scan(torch.from_numpy(np.stack([f[0] for f in frames])),
                          torch.from_numpy(np.stack([f[1] for f in frames])), tcfg)[2]
    path = str(tmp_path / "scan_state.npz")
    checkpoint.save_scan_state(path, state, tcfg.tracker.optimizer.quad_form)
    pyr = dataclasses.replace(tcfg.pyramid, edge_capacity=(2048, 1024, 512))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_scan_state(path, dataclasses.replace(tcfg, pyramid=pyr), device="cpu")
    ring = dataclasses.replace(tcfg.tracker, scan_relocalization=True)
    with pytest.raises(KeyError, match="kf_ring"):
        checkpoint.load_scan_state(path, dataclasses.replace(tcfg, tracker=ring), device="cpu")
    template = batch.scan_state_template(tcfg, "cpu")
    assert [k for k, _ in checkpoint._flatten(template)] == [
        k for k, _ in checkpoint._flatten(state)]
