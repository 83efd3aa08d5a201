"""The full-system scan of the port's dry run (``revo_tpu_torch.entry``)
against the JAX package's, on the CPU: the eight 26-frame sequences of
``entry._dryrun_inputs(8)`` (24 pan frames at the pinned phases, then two
teleports back to the start; 160x120, scan relocalization, a 0.1 m jump
gate, a ring of 4) through the port's ``vo_scan_batched`` sharded over 8
CPU slots, and each through JAX's ``vo_scan`` as the JAX dry run's parity
check runs it.  Apart from tests/test_torch_dryrun.py so that
``--dist loadfile`` runs the two on different workers.

Tolerances, per sequence: promoted / relocalized / lost flags identical
frame by frame to JAX's, their counts JAX's line on 8 devices
(MULTICHIP_r05.json); poses within 1e-4 of JAX's; the sharded poses
bit-equal to the port's own ``vo_scan`` of the sequence.  Sequence 0 alone
gets 2e-4: its frames 18-19, two and three frames after its promotion at
frame 16, part by 1.02e-4 and 1.05e-4 (every other frame of the eight
sequences stays under 5.6e-5).  The gap is carried state, not the step:
each of sequence 0's frames stepped by both packages from JAX's own carried
state (JAX's ``save_scan_state`` -> the port's ``load_scan_state``, as
tests/test_torch_soak.py does) gives flags identical and poses within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront
from revo_tpu.checkpoint import save_scan_state as jax_save_scan_state
from revo_tpu.parallel import batch as jbatch
from revo_tpu_torch import convert, entry
from revo_tpu_torch.checkpoint import load_scan_state
from revo_tpu_torch.parallel import batch

from chip_smoke import DRYRUN_PROMOTIONS, DRYRUN_RELOCS
from test_torch_dryrun import jax_dryrun_cfgs
from test_torch_sharded import cpu_mesh

torch.set_num_threads(1)

N = 8
TOL = {0: 2e-4}  # sequence 0, frame 19: 1.05e-4 (module docstring)
STEP_TOL = 1e-5  # one frame stepped from a common state


@pytest.fixture(scope="module")
def scan():
    """(inputs, JAX config, port config, the port's sharded poses)."""
    x = entry._dryrun_inputs(N)
    _, jcfg = jax_dryrun_cfgs()
    tcfg = convert.config_from_jax(jcfg)
    poses = batch.vo_scan_batched(torch.from_numpy(x["scan_grays"]),
                                  torch.from_numpy(x["scan_depths"]), tcfg,
                                  mesh=cpu_mesh(N, "seq"))
    return x, jcfg, tcfg, poses.numpy()


@pytest.mark.parametrize("seq", range(N))
def test_scan_sequence_matches_jax(scan, seq):
    x, jcfg, tcfg, sharded = scan
    g, d = x["scan_grays"][seq], x["scan_depths"][seq]
    poses_j, outs_j, _ = jbatch.vo_scan(jnp.asarray(g), jnp.asarray(d), jcfg)
    poses_t, outs_t, _ = batch.vo_scan(torch.from_numpy(g), torch.from_numpy(d), tcfg)
    assert np.array_equal(sharded[seq], poses_t.numpy())
    for name in ("promoted", "relocalized", "lost"):
        np.testing.assert_array_equal(getattr(outs_t, name).numpy(),
                                      np.asarray(getattr(outs_j, name)), err_msg=name)
    assert int(outs_t.promoted.sum()) == DRYRUN_PROMOTIONS[seq]
    assert int(outs_t.relocalized.sum()) == DRYRUN_RELOCS[seq]
    assert not outs_t.lost.any()
    np.testing.assert_allclose(sharded[seq], np.asarray(poses_j), rtol=0,
                               atol=TOL.get(seq, 1e-4))
    tele = float(np.linalg.norm(sharded[seq, entry.N_PAN, :3, 3] - x["scan_trajs"][seq][0, :3, 3]))
    assert tele < entry.TELEPORT_TOL_M


def _flags(outs):
    return np.stack([np.asarray(outs.promoted), np.asarray(outs.relocalized),
                     np.asarray(outs.lost)], axis=1)


def test_scan_steps_from_jax_state_match_jax(scan, tmp_path):
    """Sequence 0, every frame after the first stepped by both packages from
    JAX's carried state, moved into the port through a checkpoint file."""
    x, jcfg, tcfg, _ = scan
    g, d = x["scan_grays"][0], x["scan_depths"][0]
    state_j = jbatch._init_state(jfront.build_frame(jnp.asarray(g[0]), jnp.asarray(d[0]), jcfg),
                                 jcfg)
    step_file = str(tmp_path / "jax_state.npz")
    for k in range(1, g.shape[0]):
        jax_save_scan_state(step_file, state_j)
        T_t, outs_t, _ = batch.vo_scan_from_state(
            load_scan_state(step_file, tcfg, device="cpu"), torch.from_numpy(g[k:k + 1]),
            torch.from_numpy(d[k:k + 1]), tcfg)
        T_j, outs_j, state_j = jbatch.vo_scan_from_state(
            state_j, jnp.asarray(g[k:k + 1]), jnp.asarray(d[k:k + 1]), jcfg)
        np.testing.assert_array_equal(_flags(outs_t), _flags(outs_j), err_msg=f"frame {k}")
        np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=0, atol=STEP_TOL,
                                   err_msg=f"frame {k}")
