"""The port's twin of tests/test_solver_modes.py:42-81, the ATE parity of
the dt-only surface gradient ("dt4bf") against the reference's
interpolated central differences ("flatbf"), now that the port has both.

Solver "gn_fixed" at 160x120 on the CPU (plain kernel versions), over the
seed-4 walk of 25 frames and the seed-6 walk of 15 frames with 15% depth
holes.  In the port "dt4bf" is held to "flatbf" by the JAX test's own
limits; each form's run is held to the JAX package's on the same frames:
per-frame promoted / relocalized / lost flags identical and ATE within
1e-4 m (long runs are gated on ATE and flags, ROADMAP).
"""
import dataclasses

import numpy as np
import pytest
import torch

from revo_tpu import system as jsystem
from revo_tpu_torch import convert, system
from revo_tpu_torch.io import synthetic as tsyn

from test_solver import small_cfg
from test_torch_robustness import _ate, _sequence
from test_torch_vo import run_host

torch.set_num_threads(1)

ATE_TOL_M = 1e-4  # port against the JAX package, one form, one walk


def _form(form):
    cfg = small_cfg()
    opt = dataclasses.replace(cfg.tracker.optimizer, solver="gn_fixed", quad_form=form)
    return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, optimizer=opt))


def _ates(frames, gt):
    """{form: the port's ATE} over ``frames``, each form's flags identical
    to the JAX package's run and its ATE within ATE_TOL_M of it."""
    out = {}
    for form in ("flatbf", "dt4bf"):
        cfg = _form(form)
        pj, fj = run_host(jsystem.VOSystem(cfg), frames)
        pt, ft = run_host(system.VOSystem(convert.config_from_jax(cfg), device="cpu"), frames)
        np.testing.assert_array_equal(ft, fj)
        out[form] = _ate(pt, gt)
        assert abs(out[form] - _ate(pj, gt)) <= ATE_TOL_M, (form, out[form], _ate(pj, gt))
    return out


@pytest.mark.parametrize("walk", ["seed4_25", "seed6_15_holes"])
def test_dt4_surface_gradient_ate_parity(walk):
    if walk == "seed4_25":
        ate = _ates(*_sequence(25, seed=4))
        assert ate["dt4bf"] < max(ate["flatbf"] * 1.5, 0.005), ate
    else:
        ate = _ates(*_sequence(15, seed=6, scene=tsyn.SyntheticScene(depth_hole_frac=0.15)))
        assert ate["dt4bf"] < max(ate["flatbf"] * 1.5, 0.01), ate
