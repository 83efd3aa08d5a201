"""chip_smoke.py's phase 19 (quadforms) rehearsed on the CPU at 160x120:
the text of ``main`` between its marker and phase 20's runs with the device
set to the CPU and the card-only pieces stubbed (launch counts, CUDA-event
times, the sync debug mode), so wrong paths, arguments and control flow of
the smoke run show here, where there is no card.  The card and the CPU are
then the same device, so the card-against-CPU gates hold exactly; what the
card adds (the kernel's layouts, the launch counts, 640x480) only
``python3 chip_smoke.py`` on the card checks.  The ATE limits are those of
160x120 (1 cm).
"""
import dataclasses
import importlib.util
import json
import os
import textwrap

import numpy as np
import torch

from revo_tpu_torch import frontend, lanes, solver, tracker
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.eval import absolute_trajectory_error
from revo_tpu_torch.io import synthetic as syn
from revo_tpu_torch.ops import lgsx as K3
from revo_tpu_torch.ops.backproject import EdgeCloud
from revo_tpu_torch.system import VOSystem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Counter:
    """Stands in for a kernel wrapper's launch count."""

    def __init__(self, name):
        self.__name__, self.launches = name, 0


def test_phase_19_rehearses_on_the_cpu(capsys, monkeypatch):
    cs = _chip_smoke()
    real = K3.residual_lgsx_lanes

    def counted(*args, **kw):  # the plain version, counted as the card's launch would be
        K3.residual_lgsx.launches += 1
        return real(*args, **kw)

    monkeypatch.setattr(K3, "residual_lgsx_lanes", counted)
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    code = textwrap.dedent(src[src.index("    # -- 19. quadforms"):src.index("    # -- 20. soak")])
    for old in ('torch.cuda.set_sync_debug_mode("error")', 'torch.cuda.set_sync_debug_mode("default")'):
        assert code.count(old) == 1, old
        code = code.replace(old, "None")
    base = SystemConfig()
    c, s = base.camera, 0.25
    cam = dataclasses.replace(c, width=160, height=120, fx=c.fx * s, fy=c.fy * s,
                              cx=(c.cx + 0.5) * s - 0.5, cy=(c.cy + 0.5) * s - 0.5)
    cfg = dataclasses.replace(base, camera=cam, pyramid=dataclasses.replace(
        base.pyramid, edge_capacity=(4096, 2048, 1024)))
    scene = syn.SyntheticScene()
    traj = np.concatenate([scene.trajectory(cs.N_FRAMES, seed=0), cs.pan_sequence(cs.N_PAN)])
    rendered = [(*syn.render_frame(scene, cam, T, seed=i), T, i / 30.0)
                for i, T in enumerate(traj)]
    grays, depths, gt = cs._sensor_frames(rendered[:cs.N_FRAMES], cfg)
    p_grays, p_depths, p_gt = cs._sensor_frames(rendered[cs.N_FRAMES:], cfg)
    counters_ = [_Counter(n) for n in ("canny_fused", "residual_lgsx")]
    layouts = solver.solve_level_kernel.layout_launches

    def path_launches(counters, fn):  # what a 640x480 path on the card would count
        out = fn()
        layouts[:] = [999] * len(layouts)
        return out, {k.__name__: 999 for k in counters}

    ns = dict(vars(cs))
    ns.update(
        torch=torch, cfg=cfg, dev=torch.device("cpu"), smi="cpu rehearsal",
        grays=grays, depths=depths, gt=gt, p_grays=p_grays, p_depths=p_depths, p_gt=p_gt,
        cams=cfg.camera_pyramid(), opt=cfg.tracker.optimizer, counters_=counters_,
        _path_launches=path_launches, require_vga=lambda *a, **k: None,
        add_launches=lambda counts: None, K3=K3, solver=solver, tracker=tracker,
        frontend=frontend, lane_tree=lanes, EdgeCloud=EdgeCloud, VOSystem=VOSystem,
        absolute_trajectory_error=absolute_trajectory_error,
        _time_ms=lambda fn, reps, warmup=2: 0.0, _queued_ms=lambda fn, reps=50: 0.0,
        ATE_LIMIT_M=0.01, VO_FLATBF_ATE_LIMIT_M=0.01)
    saved = list(layouts)
    try:
        exec(compile(code, "chip_smoke phase 19", "exec"), ns)
    finally:
        layouts[:] = saved

    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"phase"')]
    assert [d["phase"] for d in lines] == ["quadforms"]
    got = lines[0]
    assert set(got["chains"]) == {f"{n}_{s}" for n, _, _ in cs.QUAD_CASES for s in ("lm", "gn_fixed")}
    assert all(v["vs_cpu_m"] == 0.0 for v in got["chains"].values())
    assert {v["layout"] for v in got["checks"].values()} == set(cs.LAYOUT_ROWS)
    assert got["vo_flatbf"]["lost"] == 0 and got["vo_flatbf"]["relocalized"] >= 1
    rows = ns["quad_rows"]
    assert sorted(r["name"] for r in rows) == sorted(cs.LAYOUT_ROWS.values())
    for r in rows:
        assert r["level_kernel_launches"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert r["bound_ms"] > 0 and r["library_ms"] is None
