"""The fused residual pass + LGSX reduction (``ops.lgsx.residual_lgsx``) on
CPU tensors, i.e. its plain version, against the JAX package's jitted
``solver._residual_sums`` with the Pallas K3 in interpret mode.

Both sides get the same numpy-seeded inputs at 160x120: a keyframe table
(the dt quad table, float32 "dt4" or bfloat16 "dt4bf"; the 12-component
quad table, "flat" or bfloat16 "flatbf"; the structure, sampled by
"take4"), an edge cloud back-projected from
integer pixels (so the identity pose projects onto pixel corners, where
floor() and the bounds test are knife edges) with dead lanes, and a pose.
Tolerances: good and bad counts equal; every float output within 1e-5 of
its largest entry (reduction order).  The CUDA kernel against this plain
version is in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import solver as jsolver
from revo_tpu.config import CameraConfig as JCamera
from revo_tpu.ops.backproject import EdgeCloud as JCloud
from revo_tpu_torch import solver
from revo_tpu_torch.ops import lgsx as K3

from _torch_inputs import (
    BF16_FORMS, CAM, EDGE_DISTANCE, HUBER, TABLE_FORMS, make_inputs, make_pose, torch_args,
)

torch.set_num_threads(1)

RTOL = 1e-5  # of the largest entry of each output


@pytest.mark.parametrize("p", [4096, 1000])
@pytest.mark.parametrize("pose", ["identity", "tracked"])
@pytest.mark.parametrize("quad_form", TABLE_FORMS)
def test_residual_lgsx_matches_jax(quad_form, pose, p):
    quad, pts, valid = make_inputs(p + len(pose), p, quad_form)
    R, t = make_pose(pose)
    jcam = JCamera(**CAM)
    # Jitted, as inside track_frames: XLA fuses u = x / z * fx + cx into one
    # FMA, which the port reproduces.  "take4" samples the (H, W, 3)
    # structure, the other forms their quad table.
    impl = "take4" if quad_form == "take4" else "quad"
    jsums = jax.jit(lambda q, pts_, valid_, R_, t_: jsolver._residual_sums(
        q, JCloud(pts_, valid_, jnp.sum(valid_).astype(jnp.int32)), jcam, R_, t_,
        EDGE_DISTANCE, HUBER, True, True, impl))
    jq = jnp.asarray(quad)
    if quad_form == "take4":
        jq = jq.reshape(CAM["height"], CAM["width"], 3)
    if quad_form in BF16_FORMS:
        jq = jq.astype(jnp.bfloat16)
    want = jsums(jq, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(R), jnp.asarray(t))
    got = K3.residual_lgsx(*torch_args(quad, pts, valid, R, t, quad_form))
    assert int(got[4]) == int(want[4]) and int(got[5]) == int(want[5])
    assert int(got[4]) > p // 3 and int(got[5]) > 0  # both kinds of lane occur
    assert int(got[4]) + int(got[5]) == int(valid.sum())
    assert got[4].dtype == torch.int32 and got[0].shape == (6, 6)
    for a, b in zip(got[:4], want[:4]):
        a, b = a.numpy(), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max())


def test_solver_calls_the_fused_wrapper_and_cpu_takes_the_plain_version():
    args = torch_args(*make_inputs(3, 512, "dt4bf"), *make_pose("tracked"), "dt4bf")
    before = (K3.residual_lgsx.launches, K3.lgsx_reduce.launches)
    got = solver._residual_sums(*args)
    want = K3.residual_lgsx_ref(*args)
    assert (K3.residual_lgsx.launches, K3.lgsx_reduce.launches) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # residual_terms feeds the unfused reduction: its sums are the plain version's.
    wxp, grads, r, wg, gm, n_good, n_bad = K3.residual_terms(*args)
    assert torch.equal(K3.lgsx_reduce_ref(wxp, grads, r, wg)[0], want[0])
    assert int(gm.sum()) == int(n_good) == int(want[4])


def test_residual_lgsx_other_devices_raise():
    args = torch_args(*make_inputs(4, 64, "dt4"), *make_pose("identity"), "dt4", device="meta")
    with pytest.raises(ValueError):
        K3.residual_lgsx(*args)
    with pytest.raises(ValueError):
        solver._residual_sums(*args)


def test_all_lanes_dead_gives_zero_sums():
    quad, pts, valid = make_inputs(5, 256, "dt4")
    R, t = make_pose("identity")
    got = K3.residual_lgsx(*torch_args(quad, pts * 0, valid & False, R, t, "dt4"))
    assert int(got[4]) == 0 and int(got[5]) == 0
    assert all(float(x.abs().max()) == 0.0 for x in got[:4])
    sys = solver.residual_system(*torch_args(quad, pts * 0, valid & False, R, t, "dt4"))
    assert bool(torch.isfinite(sys.A).all()) and float(sys.err) == 0.0
