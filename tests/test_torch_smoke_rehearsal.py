"""chip_smoke.py's phases 15 (live) and 16 (scenes) rehearsed on the CPU at
160x120: the text of ``main`` between the two phase markers runs with the
device set to the CPU and the card-only pieces stubbed (launch counts,
synchronize), so wrong paths, arguments and control flow of the smoke run
show here, where there is no card.  What the card adds (the kernels, the
launch counts, 640x480) only ``python3 chip_smoke.py`` on the card checks.

Differences from the card run, all forced by the size: the ATE limits are
those of 160x120 (1 cm, 5 cm for the loop), the camera goes to ``run.main``
in a camera file, and the sparse scene's fill-in, which needs the
full-resolution occupancy, is reported and not gated.
"""
import dataclasses
import importlib.util
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from revo_tpu_torch import frontend
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.eval import absolute_trajectory_error
from revo_tpu_torch.io import sensors
from revo_tpu_torch.io import synthetic as syn
from revo_tpu_torch.io.tum import read_tum_trajectory
from revo_tpu_torch.parallel import batch
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


def test_phases_15_and_16_rehearse_on_the_cpu(tmp_path, capsys):
    pytest.importorskip("cv2")
    cs = _chip_smoke()
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    code = textwrap.dedent(src[src.index("    # -- 15. live"):src.index("    # -- 17. mesh")])
    base = SystemConfig()
    c, s = base.camera, 0.25
    cam = dataclasses.replace(c, width=160, height=120, fx=c.fx * s, fy=c.fy * s,
                              cx=(c.cx + 0.5) * s - 0.5, cy=(c.cy + 0.5) * s - 0.5)
    cfg = dataclasses.replace(base, camera=cam)
    camlines = (f"Camera.width: {cam.width}\nCamera.height: {cam.height}\nCamera.fx: {cam.fx}\n"
                f"Camera.fy: {cam.fy}\nCamera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n")
    camfile = str(tmp_path / "camera.yaml")
    with open(camfile, "w") as f:
        f.write("%YAML:1.0\n" + camlines)

    for old, new, n in (
            ("torch.cuda.synchronize()", "None", None),
            ('"cuda"', '"cpu"', None),
            ('settings, "--out"', 'settings, camfile, "--out"', 1),
            ('Datasets: "pan"\\n', 'Datasets: "pan"\\n' + camlines.replace("\n", "\\n"), 1),
            ('raise RuntimeError(f"scenes: the sparse scene', 'print((f"rehearsal: the sparse scene', 1),
            ('did not fire at level {lvl}: {fill}")', 'did not fire at level {lvl}: {fill}"))', 1)):
        assert code.count(old) >= 1 and (n is None or code.count(old) == n), old
        code = code.replace(old, new)

    def render(scene, traj, seed0):
        return [(*syn.render_frame(scene, cam, T, seed=seed0 + i), T, i / 30.0)
                for i, T in enumerate(traj)]

    scene = syn.SyntheticScene()
    rendered = render(scene, np.concatenate(
        [scene.trajectory(cs.N_FRAMES, seed=0), cs.pan_sequence(cs.N_PAN)]), 0)
    grays, depths, gt = cs._sensor_frames(rendered[:cs.N_FRAMES], cfg)
    p_grays, p_depths, p_gt = cs._sensor_frames(rendered[cs.N_FRAMES:], cfg)
    families = {"box": syn.box_scene(), "column": syn.column_scene(), "sparse": syn.sparse_scene()}
    loop_traj = syn.loop_trajectory(cs.LOOP_FRAMES_OF, radius=0.75, wobble=0.004,
                                    seed=5)[:cs.N_LOOP]
    eye4 = np.eye(4, dtype=np.float32)
    family_frames = {name: cs._sensor_frames(render(sc, [eye4], 1), cfg)
                     for name, sc in families.items()}
    loop_seq = cs._sensor_frames(render(families["box"], loop_traj, 5000), cfg)
    poses_c = VOSystem(cfg, device="cpu").run(
        zip(p_grays[:cs.N_PAN], p_depths[:cs.N_PAN], [i / 30.0 for i in range(cs.N_PAN)]))[0]
    counters_ = [_Counter(n) for n in ("canny_fused", "canny_nms", "canny_hysteresis",
                                       "lgsx_reduce", "residual_lgsx", "solver_step",
                                       "init_check", "solve_level_kernel")]
    on_card = ("canny_fused", "init_check", "solve_level_kernel")

    def path_launches(counters, fn):  # what a 640x480 path on the card would count
        return fn(), {k.__name__: 999 if k.__name__ in on_card else 0 for k in counters}

    ns = dict(vars(cs))
    ns.update(
        torch=torch, cfg=cfg, cam=cam, dev=torch.device("cpu"), smi="cpu rehearsal",
        camfile=camfile, rendered=rendered, gt=gt,
        p_grays=p_grays, p_depths=p_depths, p_gt=p_gt, poses_c=poses_c, families=families,
        loop_traj=loop_traj, family_frames=family_frames, loop_seq=loop_seq,
        counters_=counters_, _path_launches=path_launches, require_vga=lambda *a, **k: None,
        add_launches=lambda counts: None, split_kernels=["canny_nms", "canny_hysteresis"],
        VOSystem=VOSystem, batch=batch, frontend=frontend,
        read_tum_trajectory=read_tum_trajectory,
        absolute_trajectory_error=absolute_trajectory_error,
        VO_ATE_LIMIT_M=0.01, LOOP_ATE_LIMIT_M=0.05)
    try:
        exec(compile(code, "chip_smoke phases 15-16", "exec"), ns)
    finally:
        if sensors.available():
            sensors.use_real_devices()

    lines = {}
    for ln in capsys.readouterr().out.splitlines():
        if ln.startswith('{"phase"'):
            d = json.loads(ln)
            lines[d["phase"]] = d
    assert set(lines) == {"host_libraries", "live", "scenes"}
    live = lines["live"]
    assert live["viewer_bit_equal"] and live["equals_phase7_poses"]
    assert live["refined_keyframes"] >= 2 and live["ply"]["trajectory"]["vertex"] == cs.N_PAN
    assert live["dataset_cli"]["pose_lines"] == cs.N_PAN
    if sensors.available():
        assert live["live_cli"]["pose_lines"] == cs.N_PAN and live["live_cli"]["vs_cpu_m"] == 0.0
    else:
        assert live["live_cli"] is None and "tracked library" in live["live_cli_not_run"]
    assert lines["scenes"]["loop"]["lost"] == 0 and lines["scenes"]["loop"]["vs_cpu_m"] == 0.0
