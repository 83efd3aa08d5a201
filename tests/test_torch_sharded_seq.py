"""The port's sequence-sharded forms against the JAX package's, on the CPU
at 160x120: ``vo_scan_batched(mesh=)`` and ``track_long_sequence(mesh=)``
(and ``track_segments`` through it).  The JAX side runs on conftest's 8
virtual CPU devices, the port's on ``[torch.device("cpu")] * n`` slots.

Tolerances: bit-equal to the port's mesh-less run (the same program per
sequence); against JAX's mesh form 5e-4 for the scan (tests/test_batch.py:
93-105), 5e-4 and ATE < 3 cm for the segments (tests/test_segments.py:76-84,
tests/test_torch_segments.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu.eval import absolute_trajectory_error
from revo_tpu.parallel import batch as jbatch, segments as jseg
from revo_tpu_torch import convert
from revo_tpu_torch.parallel import batch, segments

from test_batch import _render_stack
from test_solver import small_cfg
from test_torch_sharded import cpu_mesh, jax_mesh

torch.set_num_threads(1)


def test_vo_scan_batched_sharded():
    """tests/test_batch.py:93-105 at B = 4 on 4 slots."""
    cfg = small_cfg()
    tcfg = convert.config_from_jax(cfg)
    seqs = [_render_stack(cfg, 6, seed=s) for s in range(4)]
    grays = np.stack([np.asarray(s[0]) for s in seqs])
    depths = np.stack([np.asarray(s[1]) for s in seqs])
    tg, td = torch.from_numpy(grays), torch.from_numpy(depths)
    got = batch.vo_scan_batched(tg, td, tcfg, mesh=cpu_mesh(4, "seq"))
    assert got.shape == (4, 6, 4, 4)
    assert torch.equal(got, batch.vo_scan_batched(tg, td, tcfg))
    want = jbatch.vo_scan_batched(jnp.asarray(grays), jnp.asarray(depths), cfg,
                                  mesh=jax_mesh(4, "seq"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-4)
    with pytest.raises(ValueError, match="does not divide"):
        batch.vo_scan_batched(tg[:3], td[:3], tcfg, mesh=cpu_mesh(4, "seq"))


def test_track_long_sequence_sharded():
    """tests/test_segments.py:76-84: 17 frames, 8 segments over 8 slots."""
    cfg = small_cfg()
    tcfg = convert.config_from_jax(cfg)
    grays, depths, gt = _render_stack(cfg, 17, seed=3)
    tg, td = torch.from_numpy(np.asarray(grays)), torch.from_numpy(np.asarray(depths))
    got = segments.track_long_sequence(tg, td, tcfg, 8, mesh=cpu_mesh(8, "seq"))
    assert torch.equal(got, segments.track_long_sequence(tg, td, tcfg, 8))
    want = np.asarray(jseg.track_long_sequence(grays, depths, cfg, 8, mesh=jax_mesh(8, "seq")))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
    assert absolute_trajectory_error(got.numpy(), gt).rmse < 0.03
    assert absolute_trajectory_error(want, gt).rmse < 0.03
