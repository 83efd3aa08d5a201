"""Nothing the harness loads has the top-level name jax, jaxlib, flax or
revo_tpu; the check compares whole top-level names, since the program's
name begins with the JAX package's."""
from __future__ import annotations

import subprocess
import sys

from vobench import harness
from vobench.tests._tiny import ROOT


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "revo_tpu_torch_lookalike", sys)
    assert "revo_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "revo_tpu.sub", sys)
    assert harness.forbidden_modules() == ["revo_tpu"]


def test_harness_and_drivers_load_no_forbidden_module():
    code = ("import sys, vobench.harness, vobench.control, vobench.sweep, vobench.drivers.scan, "
            "vobench.drivers.track, vobench.common; from vobench import common; "
            "common.wrappers(); import revo_tpu_torch.parallel.batch; "
            "print(vobench.harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
