"""chip_smoke.py's phase 20 (soak) rehearsed on the CPU at 160x120: the text
of ``main`` between its marker and phase 21's runs with the device set to the
CPU, the frames rendered at 160x120 by the script's own pool, the card's
memory reads stubbed by the bytes of the live tensors' storages,
``torch.cuda.synchronize`` by a no-op, and the launch counts
taken from counting stand-ins of the two kernels' entries (each Canny of the
front end, each solver level), so wrong paths, arguments and
control flow of the phase show here, where there is no card.  Every gate of
the phase (an ``if`` that raises) must be reached: a gate whose code path the
run never takes would pass on the card without checking anything.  What the
card adds (the kernels, 640x480, device memory) only ``python3
chip_smoke.py`` checks.

The ATE bound is that of 160x120 (0.2 m, not the card's 0.08): at this
resolution the teleport of part (a) relocalizes onto a wrong keyframe and
stays ~0.4 m off for some 60 frames, in both packages: on these frames with
metric float depth the JAX package's VOSystem ends at 0.1815 m final-graph
ATE and the port at 0.1820 m, with the same five relocalizations; from the
uint16 sensor frames the phase feeds, the port ends at 0.1540 m
(``scripts/soak_parity.py vga_scenario``).
"""
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import textwrap
import warnings

import torch

from revo_tpu_torch import frontend, solver
from revo_tpu_torch.config import CameraConfig, SystemConfig
from revo_tpu_torch.eval import absolute_trajectory_error
from revo_tpu_torch.parallel import batch
from revo_tpu_torch.system import VOSystem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILENAME = "chip_smoke phase 20"
REHEARSAL_ATE_M = 0.2  # 160x120 (module docstring)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Counter:
    """Stands in for a kernel wrapper's launch count."""

    def __init__(self, name):
        self.__name__, self.launches = name, 0


def _live_tensor_bytes(*args, **kwargs) -> int:
    """The CPU's stand-in for the card's allocated memory: the bytes of the
    distinct storages of every tensor object alive in the process."""
    with warnings.catch_warnings():  # isinstance on torch.distributed's deprecated aliases
        warnings.simplefilter("ignore", FutureWarning)
        tensors = [t for t in gc.get_objects() if isinstance(t, torch.Tensor)]
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


def _gate_lines(code: str):
    """Line numbers of every ``if`` whose body raises: the phase's gates."""
    lines = code.splitlines()
    gates = []
    for n, line in enumerate(lines[:-1], start=1):
        if line.strip().startswith("if ") and lines[n].strip().startswith("raise RuntimeError"):
            gates.append(n)
    return gates


def test_phase_20_rehearses_on_the_cpu(capsys, monkeypatch):
    cs = _chip_smoke()
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    code = textwrap.dedent(src[src.index("    # -- 20. soak"):src.index("    # -- 21. bench")])
    gates = _gate_lines(code)
    assert len(gates) >= 15, gates

    # tests/test_solver.py's small_cfg: 160x120, capacities (4096, 2048, 1024).
    base = SystemConfig()
    cfg = dataclasses.replace(
        base, camera=CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120),
        pyramid=dataclasses.replace(base.pyramid, edge_capacity=(4096, 2048, 1024)))
    from revo_tpu_torch.io import synthetic as syn

    traj = syn.loop_trajectory(cs.SOAK_FRAMES, radius=cs.SOAK_RADIUS, wobble=0.004,
                               seed=cs.SOAK_SEED, circuits=cs.SOAK_CIRCUITS)
    jobs = [(syn.box_scene(), cfg.camera, T, 1000 * cs.SOAK_SEED + i) for i, T in enumerate(traj)]
    soak = cs._sensor_frames(cs.render_jobs(jobs, workers=2), cfg)

    canny, level = _Counter("canny_fused"), _Counter("solve_level_kernel")
    real_canny, real_level = frontend.canny_batched, solver.level_state

    def counted_canny(*a, **k):  # one canny_fused launch a call at 640x480 on the card
        canny.launches += 1
        return real_canny(*a, **k)

    def counted_level(*a, **k):  # one level kernel launch a solver level on the card
        level.launches += 1
        return real_level(*a, **k)

    monkeypatch.setattr(frontend, "canny_batched", counted_canny)
    monkeypatch.setattr(solver, "level_state", counted_level)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", _live_tensor_bytes)
    monkeypatch.setattr(torch.cuda, "memory_reserved", _live_tensor_bytes)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda *a, **k: {
        "requested_bytes.all.current": _live_tensor_bytes()})
    totals = {}

    def add_launches(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    ns = dict(vars(cs))
    ns.update(
        torch=torch, cfg=cfg, dev=torch.device("cpu"), smi="cpu rehearsal", soak=soak,
        counters_=(canny, level), add_launches=add_launches,
        require_vga=lambda phase, counts: cs._require_launched(
            phase, counts, ["canny_fused", "solve_level_kernel"]),
        solver=solver, frontend=frontend, batch=batch, VOSystem=VOSystem,
        absolute_trajectory_error=absolute_trajectory_error, SOAK_ATE_M=REHEARSAL_ATE_M)
    reached = set()

    def trace(frame, event, arg):
        if frame.f_code.co_filename != FILENAME:
            return None

        def local(frame, event, arg):
            if event == "line":
                reached.add(frame.f_lineno)
            return local

        return local

    sys.settrace(trace)
    try:
        exec(compile(code, FILENAME, "exec"), ns)
    finally:
        sys.settrace(None)

    missed = [code.splitlines()[n - 1].strip() for n in gates if n not in reached]
    assert not missed, f"gates never reached: {missed}"
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"phase"')]
    assert [d["phase"] for d in lines] == ["soak"]
    vo, scan = lines[0]["vo"], lines[0]["scan"]
    assert vo["frames"] == cs.SOAK_TELEPORT_FROM + cs.SOAK_REPLAY
    assert vo["relocalized"] >= 1 and vo["ring"] == cs.SOAK_RING < vo["keyframes"]
    assert vo["first_eviction_frame"] is not None
    assert len(vo["process_frame_ms_p50_p95_p99_max"]) == 4 and vo["closures"]
    assert vo["launches"]["canny_fused"] == 3 * vo["frames"]
    assert vo["launches"]["solve_level_kernel"] == vo["launches"]["levels"] > 0
    assert scan["resume_bit_equal"] and scan["promoted"] > cs.SOAK_RING
    assert scan["launches"]["canny_fused"] == 3 * (2 * cs.SOAK_FRAMES - cs.SOAK_CKPT)
    assert scan["checkpoint_bytes"] > 0
    assert totals["canny_fused"] == vo["launches"]["canny_fused"] + scan["launches"]["canny_fused"]
