"""The port's bench (revo_tpu_torch/bench.py) and entry step
(revo_tpu_torch/entry.py) against bench.py and __graft_entry__.py at the
repo root, on the CPU at 160x120 (plain kernel versions).

- The chain scaffolding on seeded numpy inputs: phase_stack equal, ATE and
  RPE bit-equal (float64 and float32 as bench.py computes them), the same
  chains refused by the divergence guard; _batched_cfg the same config.
- Four frames rendered from seed 0: the single lm chain and the B = 2
  gn_fixed batch chain, each step from the last pose, against bench.py's
  jitted lax.scan over its vo_step (and jax.vmap of it) within 1e-4 m and
  1e-4 rad; lane 0 of the batch bit-equal to the port's own single chain;
  calibrate_capacities of both packages equal at margins 0.65 and 1.10.
- The numpy oracle's exp map within 1e-6 of revo_tpu.lie.exp_se3; run()
  with N_FRAMES = N_TIMED = 4, N_LANES = 2 and one call a timed block
  gives bench.py's keys minus its two TPU-only ones; chip_smoke's phase-21
  gates pass a good line and each raise is reached by a bad one.
"""
import dataclasses
import functools
import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront
from revo_tpu import lie as jlie
from revo_tpu import tracker as jtracker
from revo_tpu.autotune import calibrate_capacities as j_calibrate
from revo_tpu_torch import bench as tbench
from revo_tpu_torch import convert, entry as tentry
from revo_tpu_torch.autotune import calibrate_capacities
from revo_tpu_torch.io.synthetic import SyntheticScene, render_sequence

from _torch_inputs import small_config
from test_solver import small_cfg
from test_torch_vo import rot_angle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402
import __graft_entry__ as jentry  # noqa: E402

torch.set_num_threads(1)

POSE_TOL = 1e-4  # metres and radians: a chain against bench.py's
EXP_TOL = 1e-6
N_SEQ = 4
TPU_ONLY_KEYS = {"vs_baseline_v5e16_projected", "tunnel_dispatch_rate"}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cfgs():
    jcfg = small_cfg()
    cfg = small_config()
    assert convert.config_from_jax(jcfg) == cfg
    return jcfg, cfg


@pytest.fixture(scope="module")
def seq(cfgs):
    """Four frames from seed 0 as bench.py renders them: float gray, metric
    depth, ground-truth T_w_c."""
    frames = list(render_sequence(SyntheticScene(), cfgs[1].camera, N_SEQ, seed=0))
    return [f[0] for f in frames], [f[1] for f in frames], np.stack([f[2] for f in frames])


# -- (a), (b): the chain scaffolding ---------------------------------------------


def _seeded_chain(rng, chain, b=None):
    """((R, t), (errors, Rs, ts)) of a made-up chain, float32 numpy."""
    lanes = () if b is None else (b,)
    xi = rng.normal(scale=0.05, size=(chain, *lanes, 6)).astype(np.float32)
    Rs, ts = jlie.exp_se3(jnp.asarray(xi))
    Rs, ts = np.asarray(Rs), np.asarray(ts)
    errs = rng.uniform(0.01, 0.2, (chain, *lanes)).astype(np.float32)
    return (Rs[-1], ts[-1]), (errs, Rs, ts)


def _to_torch(r):
    return tuple(_to_torch(x) for x in r) if isinstance(r, tuple) else torch.from_numpy(np.array(r))


def test_phase_stack_matches_bench():
    rng = np.random.default_rng(0)
    for dtype in (np.uint8, np.uint16):
        xs = [rng.integers(0, 255, (6, 5)).astype(dtype) for _ in range(5)]
        for B, chain in ((3, 4), (8, 5), (1, 7)):
            want = np.asarray(jbench.phase_stack([jnp.asarray(x) for x in xs], B, chain))
            got = tbench.phase_stack([torch.from_numpy(x) for x in xs], B, chain)
            assert got.shape == (chain, B, 6, 5)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", [None, 3])
def test_ate_rpe_bit_equal(b):
    rng = np.random.default_rng(1 if b is None else 2)
    chain = 6
    gt = np.tile(np.eye(4, dtype=np.float32), (chain + 2, 1, 1))
    _, (_, gt_R, gt_t) = _seeded_chain(rng, chain + 2)
    gt[:, :3, :3], gt[:, :3, 3] = gt_R, gt_t
    r = _seeded_chain(rng, chain, b)
    lane = None if b is None else 0
    assert tbench._ate_m(_to_torch(r), gt, lane=lane) == jbench._ate_m(r, gt, lane=lane)
    for delta in (1, 3, chain - 1):
        want = jbench._rpe_m(r, gt, lane=lane, delta=delta)
        assert tbench._rpe_m(_to_torch(r), gt, lane=lane, delta=delta) == want


@pytest.mark.parametrize("final", [0.1, 4.99, 5.01, float("nan"), float("inf")])
def test_check_chain_refuses_as_bench(final):
    rng = np.random.default_rng(3)
    for b in (None, 2):
        r = _seeded_chain(rng, 4, b)
        r[1][0][-1] = final
        outcomes = []
        for check, rr in ((jbench._check_chain, r), (tbench._check_chain, _to_torch(r))):
            try:
                check(rr, "x")
                outcomes.append("ok")
            except RuntimeError:
                outcomes.append("refused")
        assert outcomes[0] == outcomes[1]
        assert outcomes[1] == ("ok" if final <= tbench.MAX_CHAIN_ERROR else "refused")


def test_batched_cfg_matches_bench(cfgs):
    jcfg, cfg = cfgs
    got = tbench._batched_cfg(cfg)
    assert got == convert.config_from_jax(jbench._batched_cfg(jcfg))
    assert got.tracker.optimizer.solver == "gn_fixed"
    assert dataclasses.replace(got, tracker=cfg.tracker) == cfg


# -- (c), (d), (e): the chains and capacities against bench.py ----------------------


@functools.partial(jax.jit, static_argnames=("c",))
def _j_vo_step(gray_u8, depth_u16, kf, R0, t0, c):  # bench.py:393-396
    f = jfront.build_frame(gray_u8, depth_u16, c)
    return jtracker.track_frames(kf, f, R0, t0, c)


def _jax_chains(jcfg, seq):
    """bench.py's single lm chain and B = 2 gn_fixed batch chain over the
    frames, as its headline and single sections dispatch them."""
    grays, depths, _ = seq
    g_u8 = [g.astype(np.uint8) for g in grays]
    d_u16 = [(d * jcfg.dataset.depth_scale_factor).astype(np.uint16) for d in depths]
    g_dev = [jax.device_put(x) for x in g_u8]
    d_dev = [jax.device_put(x) for x in d_u16]
    kf = jfront.make_keyframe(jfront.build_frame(g_dev[0], d_dev[0], jcfg), jnp.eye(4), jcfg)
    single = jbench.chain_of(lambda g, d, k, R, t: _j_vo_step(g, d, k, R, t, jcfg))
    r_single = single(jnp.stack(g_dev), jnp.stack(d_dev), kf, jnp.eye(3), jnp.zeros(3))
    B, cfg_b = 2, jbench._batched_cfg(jcfg)
    batched = jbench.chain_of(jax.vmap(lambda g, d, k, R, t: _j_vo_step(g, d, k, R, t, cfg_b)))
    r_batch = batched(jbench.phase_stack(g_dev, B, N_SEQ), jbench.phase_stack(d_dev, B, N_SEQ),
                      jax.tree.map(lambda x: jnp.stack([x] * B), kf),
                      jnp.stack([jnp.eye(3)] * B), jnp.stack([jnp.zeros(3)] * B))
    return jax.tree.map(np.asarray, r_single), jax.tree.map(np.asarray, r_batch)


def _port_chains(cfg, seq):
    """The same chains through the port's bench, plus its single gn_fixed
    chain."""
    grays, depths, _ = seq
    g_u8, d_u16 = tbench._sensor_frames(cfg, grays, depths)
    g_dev = [tbench._put(x, CPU) for x in g_u8]
    d_dev = [tbench._put(x, CPU) for x in d_u16]
    kf = tbench._keyframe(g_dev[0], d_dev[0], cfg, CPU)
    cfg_b = tbench._batched_cfg(cfg)

    def chain(c):
        return tbench.chain_of(lambda g, d, k, R, t: tbench.vo_step(g, d, k, R, t, c))

    xs_g, xs_d = torch.stack(g_dev), torch.stack(d_dev)
    r_single = chain(cfg)(xs_g, xs_d, kf, *tbench._identity(CPU))
    r_single_gn = chain(cfg_b)(xs_g, xs_d, kf, *tbench._identity(CPU))
    B = 2
    r_batch = chain(cfg_b)(tbench.phase_stack(g_dev, B, N_SEQ), tbench.phase_stack(d_dev, B, N_SEQ),
                           tbench.add_lane_axis(kf._replace(frame=None), B),
                           *tbench._identity(CPU, B))
    return r_single, r_batch, r_single_gn


@pytest.fixture(scope="module")
def chains(cfgs, seq):
    return _jax_chains(cfgs[0], seq), _port_chains(cfgs[1], seq)


def _assert_steps_close(got_Rs, got_ts, want_Rs, want_ts):
    got_Rs, got_ts = got_Rs.numpy(), got_ts.numpy()
    assert got_Rs.shape == want_Rs.shape and got_ts.shape == want_ts.shape
    assert np.isfinite(got_ts).all()
    dt = float(np.abs(got_ts - want_ts).max())
    dr = max(rot_angle(a, b) for a, b in zip(got_Rs.reshape(-1, 3, 3), want_Rs.reshape(-1, 3, 3)))
    assert dt <= POSE_TOL and dr <= POSE_TOL, f"steps differ by {dt} m, {dr} rad"


def test_single_lm_chain_matches_bench(chains, seq):
    (j_single, _), (t_single, _, _) = chains
    _assert_steps_close(t_single[1][1], t_single[1][2], j_single[1][1], j_single[1][2])
    # The chain tracks: its ATE is that of a working solver (bench.py's
    # 640x480 chain: 0.99 mm).
    assert tbench._ate_m(t_single, seq[2]) < 0.02


def test_batched_gn_fixed_chain_matches_bench(chains):
    (_, j_batch), (_, t_batch, t_single_gn) = chains
    _assert_steps_close(t_batch[1][1], t_batch[1][2], j_batch[1][1], j_batch[1][2])
    # Lane 0 walks the plain trajectory: bit-equal to the chain alone.
    for k in range(3):
        assert torch.equal(t_batch[1][k][:, 0], t_single_gn[1][k])


@pytest.mark.parametrize("margin", [tbench.HEADLINE_MARGIN, tbench.EXACTFIT_MARGIN])
def test_calibrated_capacities_match_bench(cfgs, seq, margin):
    jcfg, cfg = cfgs
    grays, depths, _ = seq
    want = j_calibrate(jcfg, grays[:2], depths[:2], margin=margin).pyramid.edge_capacity
    got = calibrate_capacities(cfg, grays[:2], depths[:2], margin=margin, device=CPU)
    assert tuple(got.pyramid.edge_capacity) == tuple(want)


# -- (f), (g): the oracle and the whole run ------------------------------------------


def test_oracle_exp_matches_jax():
    rng = np.random.default_rng(4)
    incs = rng.normal(scale=0.02, size=(100, 6))  # float64, as np.linalg.solve gives
    for inc in incs:
        dR, dt = tbench._oracle_exp(inc)
        jR, jt = jlie.exp_se3(jnp.asarray(inc, jnp.float32))
        assert dR.dtype == np.float32 and dt.dtype == np.float32
        np.testing.assert_allclose(dR, np.asarray(jR), rtol=0, atol=EXP_TOL)
        np.testing.assert_allclose(dt, np.asarray(jt), rtol=0, atol=EXP_TOL)


def test_cpu_oracle_rate_finite(cfgs, seq):
    fps = tbench._cpu_oracle_fps(cfgs[1], seq[0], seq[1])
    assert math.isfinite(fps) and fps > 0


def test_run_line_has_bench_keys(cfgs, seq, monkeypatch, capsys):
    monkeypatch.setattr(tbench, "N_FRAMES", N_SEQ)
    monkeypatch.setattr(tbench, "N_TIMED", N_SEQ)
    monkeypatch.setattr(tbench, "N_LANES", 2)
    time_chain = tbench._time_chain
    # One call a block: every section and both blocks still run.
    monkeypatch.setattr(tbench, "_time_chain",
                        lambda chained, args, n_calls, *rest: time_chain(chained, args, 1, *rest))
    line = tbench.run(cfgs[1], *seq, "cpu")
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        want_keys = set(json.load(f)["parsed"]) - TPU_ONLY_KEYS
    assert set(line) == want_keys
    assert line["platform"] == "cpu"
    json.dumps(line)  # one JSON line
    for key in ("ate_default_m", "ate_batch8_m", "ate_exactfit_m", "rpe1_default_m",
                "rpe7_default_m"):
        assert line[key] is not None and math.isfinite(line[key]), key
    # No section was skipped, and the headline is the batch.
    assert all(v is not None for k, v in line.items() if k != "baseline_cpp_fps"), line
    assert line["value"] == line["batch8_agg_fps"] > 0
    assert line["best_config"] == f"batch8_agg_margin{tbench.HEADLINE_MARGIN:g}"
    # The launch record on stderr: every hand kernel named, none launched on
    # the CPU.
    record = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert set(record) == {"launches"}
    assert set(record["launches"]) == {fn.__name__ for fn in tbench.COUNTED}
    assert not any(record["launches"].values())


def test_build_inputs_renders_seed_0(cfgs, seq, monkeypatch):
    """The frames are rendered anew each run, as bench.py renders them: the
    first N_FRAMES of the seed-0 sequence, ground truth from the identity."""
    monkeypatch.setattr(tbench, "N_FRAMES", 2)
    grays, depths, gt = tbench._build_inputs(cfgs[1])
    assert len(grays) == len(depths) == 2 and gt.shape == (2, 4, 4)
    for got, want in ((grays, seq[0]), (depths, seq[1]), (gt, seq[2])):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gt[0], np.eye(4))


def test_main_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--device", "cuda"])


# -- (h): chip_smoke's phase-21 gates ---------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _good_line():
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        line = {k: v for k, v in json.load(f)["parsed"].items() if k not in TPU_ONLY_KEYS}
    return dict(line, platform="cuda")


def _good_launches(pyramids=200):
    counts = dict.fromkeys(("canny_fused", "canny_cluster", "canny_grid", "canny_nms",
                            "canny_hysteresis", "lgsx_reduce", "residual_lgsx",
                            "solve_level_kernel"), 0)
    counts.update(canny_fused=3 * pyramids, solve_level_kernel=3 * pyramids)
    return {"launches": counts}


def test_check_bench_line_gates():
    cs = _chip_smoke()
    check = cs._check_bench_line
    code = check.__code__
    lines = set()

    def tracer(frame, event, arg):
        if frame.f_code is code:
            if event == "line":
                lines.add(frame.f_lineno)
            return tracer
        return None

    good, counts = _good_line(), _good_launches()
    bad_lines = [
        dict(good, value=None),
        {k: v for k, v in good.items() if k != "latency_ms_p99"},
        dict(good, exactfit_batch8_agg_fps=None),
        dict(good, value=0.0),
        dict(good, ate_batch8_m=0.003),
        dict(good, ate_exactfit_m=None),
        dict(good, rpe7_default_m=float("nan")),
        dict(good, rpe1_default_m=0.0021),
        dict(good, edge_capacity=[8192, 4864, 2560]),
        dict(good, platform="cpu"),
    ]
    bad_counts = [
        dict(counts, launches=dict(counts["launches"], canny_fused=3 * 200 + 1)),
        dict(counts, launches=dict(counts["launches"], canny_fused=0)),
        dict(counts, launches=dict(counts["launches"], canny_cluster=1)),
        dict(counts, launches=dict(counts["launches"], canny_nms=2, canny_hysteresis=2)),
        dict(counts, launches=dict(counts["launches"], solve_level_kernel=0)),
        dict(counts, launches=dict(counts["launches"], residual_lgsx=5000)),
    ]
    sys.settrace(tracer)
    try:
        check(good, counts)
        for bad in bad_lines:
            with pytest.raises(RuntimeError):
                check(bad, counts)
        for bad in bad_counts:
            with pytest.raises(RuntimeError):
                check(good, bad)
    finally:
        sys.settrace(None)
    import inspect

    src, first = inspect.getsourcelines(check)
    raises = {first + i for i, text in enumerate(src) if text.strip().startswith("raise ")}
    assert raises and raises <= lines, sorted(raises - lines)


# -- the entry step ---------------------------------------------------------------------


def test_entry_matches_graft_entry(cfgs, monkeypatch):
    jcfg, cfg = cfgs
    monkeypatch.setattr(jentry, "_flagship_cfg", lambda: jcfg)
    monkeypatch.setattr(tentry, "_flagship_cfg", lambda: cfg)
    jfn, jargs = jentry.entry()
    fn, args = tentry.entry(device="cpu")
    want = jax.jit(jfn)(*jargs)
    got = fn(*args)
    assert args[1].levels[0].gray.shape == (cfg.camera.height, cfg.camera.width)
    assert torch.isfinite(got.error)
    _assert_steps_close(got.R[None], got.t[None], np.asarray(want.R)[None],
                        np.asarray(want.t)[None])


def test_phase_21_rehearses_on_the_cpu(cfgs, monkeypatch, capsys):
    """chip_smoke's phase 21 (the text between its marker and phase 22's) on
    the CPU: the bench's process stands in as a good line and launch record,
    entry() runs at 160x120; the phase parses both, gates them, adds the
    launches and prints its line."""
    import subprocess
    import textwrap
    import types

    cs = _chip_smoke()
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    code = textwrap.dedent(src[src.index("    # -- 21. bench"):src.index("    # -- 22. dryrun")])
    good, record = _good_line(), _good_launches(pyramids=10)
    ran = []

    def bench_process(cmd, **kw):
        ran.append((cmd, kw["cwd"]))
        return subprocess.CompletedProcess(
            cmd, 0, "a line before\n" + json.dumps(good) + "\n",
            "bench: no C++ oracle: absent\n" + json.dumps(record) + "\n")

    monkeypatch.setattr(tentry, "_flagship_cfg", lambda: cfgs[1])
    monkeypatch.setattr(tentry.entry, "__defaults__", ("cpu",))
    launch_total = dict.fromkeys(record["launches"], 0)
    required = []

    def add_launches(counts):
        for k, v in counts.items():
            launch_total[k] += v

    def path_launches(counters_, fn):
        return fn(), dict.fromkeys(record["launches"], 0)

    ns = dict(vars(cs), torch=torch, smi="stub", counters_=(),
              subprocess=types.SimpleNamespace(run=bench_process),
              add_launches=add_launches, _path_launches=path_launches,
              require_vga=lambda phase, counts: required.append(phase))
    exec(compile(code, "chip_smoke phase 21", "exec"), ns)
    assert ran and ran[0][0][1:] == ["-m", "revo_tpu_torch.bench"] and ran[0][1] == REPO
    assert required == ["bench entry"]
    assert launch_total == record["launches"]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["phase"] == "bench" and out["line"] == good and out["record"] == record
    assert out["stderr"] == ["bench: no C++ oracle: absent"]
    assert math.isfinite(out["entry"]["error"])
