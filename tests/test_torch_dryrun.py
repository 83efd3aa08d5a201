"""The port's multi-device dry run (``revo_tpu_torch.entry.dryrun_multichip``)
against the JAX package's (``__graft_entry__.dryrun_multichip``), on the CPU:
the port on ``[torch.device("cpu")] * 8`` slots, JAX on conftest's 8 virtual
CPU devices.  JAX's dry run is not called whole (its eight scans and their
eight parity runs take minutes here): its parts are called one by one on
the port's inputs, each once in a module fixture; the scan's parity is in
tests/test_torch_dryrun_scan.py.

Tolerances:
- the inputs (frames, trajectories, keyframe poses, the window's perturbed
  poses, the pose graph) bit-equal to the arrays the JAX dry run builds,
  rebuilt here with JAX's own functions;
- the port's summary: its own limits (scan parity < 1e-5, windowed BA
  < 2e-4), and promotions, relocalizations and loop edges equal to JAX's
  line on 8 devices (MULTICHIP_r05.json), the constants chip_smoke.py's
  phase 22 holds the card to; its printed line JAX's, field for field;
- dp: R and t within 1e-4, the error within 1e-4 relative, of JAX's
  build_frame -> make_keyframe -> track_frames per sequence;
- tp-points: counts equal, A, g within rtol 1e-4 / atol 1e-6
  (tests/test_torch_sharded.py), against JAX's form jitted as inside its
  tracker (the JAX dry run calls it eagerly, where XLA rounds a * b + c
  twice: one point of pair 0 changes sides, 446 / 66 good / bad against
  447 / 65 jitted and in the port);
- loop verify: decisions identical to JAX's sharded verification, poses
  within 1e-4;
- pose graph within 1e-4 of JAX's ``optimize_pose_graph_sharded``.
"""
import contextlib
import dataclasses
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront, lie as jlie, solver as jsolver, tracker as jtracker
from revo_tpu.config import CameraConfig as JCam, SystemConfig as JConfig
from revo_tpu.io import synthetic as jsyn
from revo_tpu.loopclosure import find_candidates as jfind, verify_candidates_batched as jverify
from revo_tpu.parallel import posegraph as jpg
from revo_tpu_torch import convert, entry

from chip_smoke import DRYRUN_LOOPS, DRYRUN_PROMOTIONS, DRYRUN_RELOCS
from test_torch_sharded import jax_mesh

torch.set_num_threads(1)

N = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def jax_dryrun_cfgs():
    """The JAX dry run's two configurations (__graft_entry__.py:81-89,
    :192-211)."""
    cam = JCam(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
    cfg = JConfig(camera=cam, pyramid=dataclasses.replace(
        JConfig().pyramid, edge_capacity=(512, 256, 128), dist_patch_sizes=(8, 4, 2)))
    cam_s = JCam(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)
    cfg_s = JConfig(camera=cam_s, pyramid=dataclasses.replace(
        JConfig().pyramid, edge_capacity=(4096, 2048, 1024), dist_patch_sizes=(20, 10, 5)))
    cfg_s = dataclasses.replace(cfg_s, tracker=dataclasses.replace(
        cfg_s.tracker, scan_relocalization=True, max_jump_translation=0.1, kf_history_size=4))
    return cfg, cfg_s


def _jax_pan_traj(n, step, phase):
    """__graft_entry__.py:222-234."""
    d = np.array([np.cos(phase), 0.55 * np.sin(phase), 0.3])
    d /= np.linalg.norm(d)
    poses = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        dR, _ = jlie.exp_se3(jnp.asarray(
            [0, 0, 0, 0.004 * i * np.sin(phase), 0.012 * i * np.cos(phase), 0], jnp.float32))
        T[:3, :3] = np.asarray(dR)
        T[:3, 3] = step * i * d
        poses.append(T)
    return np.stack(poses)


def _jax_inputs(n):
    """The arrays of __graft_entry__.py:94-112, :218-247, :280-285,
    :315-324 and :355-358, built as the JAX dry run builds them."""
    cfg, cfg_s = jax_dryrun_cfgs()
    scene = jsyn.SyntheticScene()
    g0s, d0s, g1s, d1s = [], [], [], []
    for i in range(n):
        T0 = np.eye(4, dtype=np.float32)
        dR, dt = jlie.exp_se3(jnp.asarray([0.004 * (i % 3), -0.003, 0.004, 0.002, 0.0, -0.001]))
        T1 = T0 @ np.asarray(jlie.matrix_from_rt(dR, dt))
        g0, d0 = jsyn.render_frame(scene, cfg.camera, T0, seed=i)
        g1, d1 = jsyn.render_frame(scene, cfg.camera, T1, seed=i)
        g0s.append(g0), d0s.append(d0), g1s.append(g1), d1s.append(d1)
    phases = [k * 2.0 * np.pi / 16.0 for k in (0, 2, 6, 7, 8, 10, 11, 12, 15)]
    gseqs, dseqs, trajs = [], [], []
    for i in range(n):
        traj = _jax_pan_traj(24, 0.03, phases[i % len(phases)])
        frames = list(jsyn.render_trajectory(scene, cfg_s.camera, traj, seed=i))
        g0, d0 = jsyn.render_frame(scene, cfg_s.camera, traj[0], seed=i * 1000)
        gseqs.append(np.stack([f[0] for f in frames] + [g0, g0]))
        dseqs.append(np.stack([f[1] for f in frames] + [d0, d0]))
        trajs.append(traj)
    kf_traj = _jax_pan_traj(8, 0.035, 0.785)
    kf_traj = np.concatenate([kf_traj[:5], kf_traj[[3, 2, 1, 0]]])
    loop = [jsyn.render_frame(scene, cfg_s.camera, T, seed=k) for k, T in enumerate(kf_traj)]
    rng = np.random.default_rng(3)
    pert = []
    for k, T in enumerate(kf_traj[:6]):
        xi = rng.normal(size=6).astype(np.float32) * 0.006
        dR, dt_ = jlie.exp_se3(jnp.asarray(xi))
        pert.append(np.asarray(jlie.matrix_from_rt(dR, dt_)) @ T if k > 0 else T)
    pg = np.tile(np.eye(4, dtype=np.float32), (2 * n + 1, 1, 1))
    pg[:, 0, 3] = np.linspace(0, 0.1, 2 * n + 1).astype(np.float32)
    return {
        "grays0": np.stack(g0s), "depths0": np.stack(d0s), "grays1": np.stack(g1s),
        "depths1": np.stack(d1s), "scan_grays": np.stack(gseqs), "scan_depths": np.stack(dseqs),
        "scan_trajs": np.stack(trajs), "loop_traj": kf_traj,
        "loop_grays": np.stack([f[0] for f in loop]), "loop_depths": np.stack([f[1] for f in loop]),
        "window_poses": np.stack(pert).astype(np.float32), "graph_poses": pg,
    }


@pytest.fixture(scope="module")
def inputs():
    return entry._dryrun_inputs(N)


@pytest.fixture(scope="module")
def port():
    """The port's dry run on 8 CPU slots and the line it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = entry.dryrun_multichip(N, devices=[torch.device("cpu")] * N)
    return summary, out.getvalue().strip().splitlines()[-1]


@pytest.fixture(scope="module")
def jax_keyframes(inputs):
    """The loop keyframes as the JAX dry run builds them (eager)."""
    _, cfg_s = jax_dryrun_cfgs()
    return [jfront.make_keyframe(jfront.build_frame(jnp.asarray(g), jnp.asarray(d), cfg_s),
                                 jnp.asarray(T), cfg_s)
            for g, d, T in zip(inputs["loop_grays"], inputs["loop_depths"], inputs["loop_traj"])]


def test_configs_match_jax():
    cfg, cfg_s = jax_dryrun_cfgs()
    assert convert.config_from_jax(cfg) == entry._dryrun_cfg()
    assert convert.config_from_jax(cfg_s) == entry._dryrun_scan_cfg()


def test_inputs_bit_equal(inputs):
    want = _jax_inputs(N)
    assert sorted(inputs) == sorted(want)
    for k, v in want.items():
        assert inputs[k].dtype == v.dtype and inputs[k].shape == v.shape, k
        assert np.array_equal(inputs[k].view(np.uint8), v.view(np.uint8)), k


def test_summary_holds_the_jax_counts(port):
    summary, _ = port
    assert summary["scan_max_dev"] < entry.SCAN_TOL
    assert summary["ba_dev"] < entry.BA_TOL
    assert summary["promotions"] == DRYRUN_PROMOTIONS
    assert summary["relocs"] == DRYRUN_RELOCS
    assert summary["n_loops"] == DRYRUN_LOOPS
    assert summary["frames"] == [26] * N and summary["slots"] == ["cpu"] * N
    assert set(summary["seconds"]) == {"dp", "tp", "sp", "pp", "scan_sharded", "scan_single",
                                       "loop_verify", "windowed_ba", "pose_graph"}


def test_printed_line_is_jax_line(port):
    """Field for field JAX's line on 8 devices; only the windowed BA's
    deviation, a float32 sum order, may differ."""
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        jax_line = json.load(f)["tail"].strip()
    _, line = port

    def masked(s):
        return re.sub(r"max dev: \S+;", "max dev: X;", s)

    assert masked(line) == masked(jax_line)
    assert "max dev: " in line


def test_constants_are_jax_line():
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"]
    assert f"per-device promotions: {DRYRUN_PROMOTIONS};" in tail
    assert f"per-device relocs: {DRYRUN_RELOCS};" in tail
    assert f"loop edges verified under mesh: {DRYRUN_LOOPS} " in tail


def test_dp_matches_jax(port, inputs):
    cfg, _ = jax_dryrun_cfgs()

    @jax.jit
    def one(g0, d0, g1, d1):
        kf = jfront.make_keyframe(jfront.build_frame(g0, d0, cfg), jnp.eye(4), cfg)
        res = jtracker.track_frames(kf, jfront.build_frame(g1, d1, cfg), jnp.eye(3),
                                    jnp.zeros(3), cfg)
        return res.R, res.t, res.error

    R, t, err = port[0]["parts"]["dp"]
    for i in range(N):
        Rj, tj, ej = (np.asarray(a) for a in one(*(inputs[k][i] for k in (
            "grays0", "depths0", "grays1", "depths1"))))
        np.testing.assert_allclose(R[i], Rj, rtol=0, atol=TOL)
        np.testing.assert_allclose(t[i], tj, rtol=0, atol=TOL)
        np.testing.assert_allclose(err[i], ej, rtol=TOL)
    assert np.isfinite(err).all() and float(np.linalg.norm(t, axis=-1).mean()) > 1e-3


def test_tp_points_matches_jax(port, inputs):
    """JAX's point-sharded system at level 0 of pair 0, jitted (module
    docstring)."""
    cfg, _ = jax_dryrun_cfgs()
    opt = cfg.tracker.optimizer

    @jax.jit
    def system(g0, d0, g1, d1):
        kf = jfront.make_keyframe(jfront.build_frame(g0, d0, cfg), jnp.eye(4), cfg)
        return jsolver.residual_system_point_sharded(
            kf.structs[0], jfront.build_frame(g1, d1, cfg).levels[0].cloud,
            cfg.camera_pyramid()[0], jnp.eye(3), jnp.zeros(3), opt.edge_distance_lvl[0],
            opt.huber_edge, opt.use_edge_filter, mesh=jax_mesh(N, "pt"))

    want = system(*(inputs[k][0] for k in ("grays0", "depths0", "grays1", "depths1")))
    got = port[0]["parts"]["tp"]
    assert (got["good"], got["bad"]) == (int(want.info.good), int(want.info.bad))
    assert got["good"] > 0
    for k in ("A", "g"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)), rtol=1e-4, atol=1e-6)
    assert np.isfinite(got["err"])


def test_loop_verify_matches_jax(port, jax_keyframes):
    _, cfg_s = jax_dryrun_cfgs()
    parts = port[0]["parts"]
    cands = jfind([np.asarray(k.T_w_k) for k in jax_keyframes], min_separation=2, radius=0.08)
    assert parts["candidates"] == cands
    want = jverify(jax_keyframes, cands, cfg_s, mesh=jax_mesh(N, "cand"), axis="cand")
    got = parts["verdicts"]
    assert [v is None for v in got] == [v is None for v in want]
    assert sum(v is not None for v in want) == DRYRUN_LOOPS
    for a, b in zip(got, want):
        if a is not None:
            np.testing.assert_allclose(a[0], np.asarray(b[0]), rtol=0, atol=TOL)


def test_pose_graph_matches_jax(port, inputs):
    pg = jnp.asarray(inputs["graph_poses"])
    want = jpg.optimize_pose_graph_sharded(pg, jpg.trajectory_to_edges(pg), jax_mesh(N, "edge"),
                                           iters=2)
    np.testing.assert_allclose(port[0]["parts"]["graph"], np.asarray(want), rtol=0, atol=TOL)


def test_segments_and_pipeline_finite(port):
    parts = port[0]["parts"]
    assert parts["sp"].shape == (2 * N + 1, 4, 4) and np.isfinite(parts["sp"]).all()
    assert parts["pp"].shape == (2, 4, 4) and np.isfinite(parts["pp"]).all()


def test_needs_a_card_or_named_devices():
    """Without a card the default slots raise; a device list of the wrong
    length raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(N)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main([str(N)])
    with pytest.raises(ValueError, match="devices given"):
        entry.dryrun_multichip(N, devices=[torch.device("cpu")] * 2)
