"""The solver's level loop with its lane state in device memory
(``solver.LevelState``, ``solver_step_ref``, ``init_check_ref``), on the CPU
at 160x120: the plain versions of the two kernels of csrc/solver.cu.

- ``lm_level`` / ``gn_level_fixed`` against the JAX package's jitted ones on
  keyframes and frames converted from JAX (tests/test_torch_slice.py's way),
  level by level from the same start: poses within 1e-5 m / 1e-5 rad, the
  error within rtol 1e-4, good and bad equal.
- B = 4 seeded lanes (tests/_torch_inputs.py) that stop at different
  evaluations, through every exit of each solver: each lane bit-equal to
  the same lane run alone at B = 1.
- lm's chunked reads of the live-lane count: the result is bit-equal for
  every chunk size, and evaluations after every lane stopped change no bit.
- The state's contract: the start makes new tensors, a step writes into
  them in place and returns the same state.
- ``init_check_ref`` against JAX's ``eval_cost`` and ``use_eye`` (jitted, as
  inside its ``track_frames``) on poses that put points behind the camera
  and outside the image: costs within float32's summation bound (JAX sums
  in float32, the port exactly in float64), the same choice; lanes
  bit-equal to B = 1.
- ``kernels.SIGNATURES`` against the C prototypes of every csrc/*.cu.
"""
import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront
from revo_tpu import solver as jsolver
from revo_tpu_torch import convert, kernels, lie, solver
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.lanes import lane
from revo_tpu_torch.ops.backproject import EdgeCloud

import _torch_step_model as step_model
from _torch_inputs import CAM, EDGE_DISTANCE, make_inputs, small_config
from test_solver import small_cfg

torch.set_num_threads(1)

POSE_TOL = 1e-5
P_LANE = 2048  # points a seeded lane


def _angle(Ra, Rb):
    D = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = np.linalg.norm(D - D.T) / (2 * np.sqrt(2))
    return float(np.arctan2(s, (np.trace(D) - 1.0) / 2.0))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_pair():
    """Frames 0 and 2 of a seeded 160x120 sequence built by the JAX package,
    frame 0 its keyframe, both also converted for the port."""
    cfg = small_cfg()
    scene = tsyn.SyntheticScene()
    traj = scene.trajectory(3, seed=3)
    frames = [tsyn.render_frame(scene, cfg.camera, T, seed=3000 + i) for i, T in enumerate(traj)]
    fj = [jfront.build_frame(jnp.asarray(g.astype(np.uint8)),
                             jnp.asarray((d * 5000.0).astype(np.uint16)), cfg) for g, d in frames]
    kj = jfront.make_keyframe(fj[0], jnp.eye(4), cfg)
    kt = convert.keyframe_from_numpy(_numpy_tree(kj), device="cpu")
    ft = convert.frame_from_numpy(_numpy_tree(fj[2]), device="cpu")
    return cfg, kj, fj[2], kt, ft


@pytest.mark.parametrize("start", ["identity", "perturbed"])
@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_level_matches_jax(jax_pair, solver_name, start):
    """Each level from the same start pose on both sides, coarse to fine,
    the next level starting from JAX's result."""
    cfg, kj, fj, kt, ft = jax_pair
    opt = dataclasses.replace(cfg.tracker.optimizer, solver=solver_name)
    topt = convert.config_from_jax(dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, optimizer=opt))).tracker.optimizer
    cams, tcams = cfg.camera_pyramid(), convert.config_from_jax(cfg).camera_pyramid()
    xi = np.zeros(6, np.float32) if start == "identity" else np.array(
        [0.01, -0.006, 0.012, 0.004, -0.006, 0.003], np.float32)
    R, t = (x.numpy() for x in lie.exp_se3(torch.from_numpy(xi)))
    jfn = jsolver.lm_level if solver_name == "lm" else jsolver.gn_level_fixed
    tfn = solver.lm_level if solver_name == "lm" else solver.gn_level_fixed
    for lvl in (2, 1, 0):
        jcloud = fj.levels[lvl].cloud
        Rj, tj, ej, ij = jax.jit(lambda R_, t_, lvl=lvl: jfn(
            kj.quads[lvl], jcloud, cams[lvl], R_, t_, opt, lvl))(jnp.asarray(R), jnp.asarray(t))
        Rt, tt, et, it = tfn(kt.quads[lvl], ft.levels[lvl].cloud, tcams[lvl], torch.from_numpy(R),
                             torch.from_numpy(t), topt, lvl)
        assert float(np.abs(tt.numpy() - np.asarray(tj)).max()) <= POSE_TOL, lvl
        assert _angle(Rt.numpy(), np.asarray(Rj)) <= POSE_TOL, lvl
        np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)
        assert (int(it.good), int(it.bad)) == (int(ij.good), int(ij.bad)), lvl
        R, t = np.array(Rj), np.array(tj)


# -- lanes through every exit ---------------------------------------------------

def _seeded_lanes(seeds, xis):
    """B lanes of the residual pass: each its own seeded dt4 table and
    cloud (tests/_torch_inputs.py), its own start pose exp(xi)."""
    quads, pts, valid = zip(*(make_inputs(s, P_LANE, "dt4") for s in seeds))
    Rs, ts = lie.exp_se3(torch.from_numpy(np.stack(xis).astype(np.float32)))
    cloud = EdgeCloud(points=torch.from_numpy(np.stack(pts)),
                      valid=torch.from_numpy(np.stack(valid)), count=None)
    return torch.from_numpy(np.stack(quads)), cloud, Rs, ts


def _cam():
    from revo_tpu_torch.config import CameraConfig
    return CameraConfig(**CAM)


def _copy(tree):
    """A copy of a LevelState: the step writes into the state it is given."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_copy(x) for x in tree))


def _exits(quad, cloud, R0, t0, opt, gn, max_inner=32):
    """The level's loop stepped by hand with the plain step: per lane the
    evaluation after which it stopped and the exit it took."""
    cam = _cam()
    b = R0.shape[0]
    p = solver.step_params(opt, 0, gn, "cpu", max_inner)
    ops = solver.lane_operands(quad, cloud, cam, b)
    sums = torch.zeros((b, 46))
    evaluate = lambda R_, t_, act: solver._evaluate(ops, R_, t_, EDGE_DISTANCE, opt, act, sums)
    state = solver.solver_start_ref(R0, t0, None if gn else evaluate(R0, t0, None), p)
    stopped = [None] * b
    n = 0
    while bool(state.active.any()):
        prev = _copy(state)
        state = solver.solver_step_ref(state, evaluate(prev.Rn, prev.tn, prev.active), p)
        n += 1
        sys_n = solver._system(sums)
        for k in range(b):
            if not (bool(prev.active[k]) and not bool(state.active[k])):
                continue
            err, last = float(sys_n.err[k]), float(prev.sys.err[k])
            accept = np.float32(err) < np.float32(last)
            ratio = np.float32(err) / np.float32(max(last, 1e-30))
            small = not float(solver.sq_norm6(prev.inc[k])) > np.float32(p.step_min)
            if accept and ratio > np.float32(p.conv_eps) and (not gn or int(prev.iteration[k]) > 0):
                why = "converged"
            elif not accept and small and (not gn or int(prev.iteration[k]) > 0):
                why = "small_step"
            elif gn and not accept and ratio < np.float32(p.flat_below) and int(prev.iteration[k]) > 0:
                why = "flat"
            else:
                why = "bound"
            stopped[k] = (n, why)
    return stopped


# Lanes and schedules found (by a seeded search) to stop at different
# evaluations through each exit: (table seeds, start twists, OptimizerConfig
# changes at level 0).  lm: converged after 3, a small step after 4, the
# iteration bound after 4 and 5; gn_fixed: converged after 3, the bound, a
# small step and a flat reject after 4.
EXIT_CASES = {
    "lm": ((78, 12, 3, 86),
           ([-0.0021, 0.0005, 0.0007, 0.0026, -0.0, 0.0021],
            [0.014, 0.0115, -0.0237, 0.0123, 0.0034, 0.0042],
            [0.0111, 0.0115, 0.0096, -0.0108, -0.057, -0.0033],
            [-0.0482, 0.0648, -0.0173, 0.005, -0.051, -0.0306]),
           dict(max_its_per_lvl=(4,) * 6, step_size_min=(1e-6,) * 6)),
    "gn_fixed": ((74, 96, 9, 72),
                 ([0.0007, 0.0016, 0.0007, -0.0026, 0.0018, 0.0009],
                  [-0.0054, 0.0058, 0.0036, 0.0029, 0.0003, 0.0055],
                  [-0.0221, -0.0049, -0.0145, 0.018, 0.0012, -0.0088],
                  [-0.0469, -0.0154, 0.0005, -0.0165, 0.0776, 0.0604]),
                 dict(fixed_iters=(3,) * 6, step_size_min=(1e-6,) * 6)),
}
EXITS = {"lm": {"converged", "small_step", "bound"},
         "gn_fixed": {"converged", "small_step", "flat", "bound"}}


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_lanes_through_every_exit_match_one_lane(solver_name):
    seeds, xis, change = EXIT_CASES[solver_name]
    opt = dataclasses.replace(small_config().tracker.optimizer, solver=solver_name, **change)
    quad, cloud, R0, t0 = _seeded_lanes(seeds, xis)
    gn = solver_name == "gn_fixed"
    stopped = _exits(quad, cloud, R0, t0, opt, gn)
    assert all(s is not None for s in stopped), stopped
    assert {why for _, why in stopped} >= EXITS[solver_name], stopped
    assert len({n for n, _ in stopped}) > 1, stopped  # different evaluations
    fn = solver.gn_level_fixed_batched if gn else solver.lm_level_batched
    cam = _cam()
    batched = fn(quad, cloud, cam, R0, t0, opt, 0)
    for k in range(R0.shape[0]):
        one = fn(quad[k:k + 1], EdgeCloud(cloud.points[k:k + 1], cloud.valid[k:k + 1], None), cam,
                 R0[k:k + 1], t0[k:k + 1], opt, 0)
        for x, y in zip(solver._tree_leaves(lane(batched, k)), solver._tree_leaves(lane(one, 0))):
            assert torch.equal(x, y), (k, stopped[k])


# -- lm's chunked reads ------------------------------------------------------------

def test_lm_chunks_and_overshoot_change_nothing(monkeypatch):
    """lm reads the live-lane count once a chunk, one chunk late: the level
    runs past its slowest lane, and no chunk size changes a bit."""
    seeds, xis, change = EXIT_CASES["lm"]
    opt = dataclasses.replace(small_config().tracker.optimizer, solver="lm", **change)
    quad, cloud, R0, t0 = _seeded_lanes(seeds, xis)
    cam = _cam()
    results, launches = {}, {}
    for chunk in (1, 2, 3, 4, 7):
        monkeypatch.setattr(solver, "LM_CHUNK", chunk)
        before = solver.lm_level_batched.host_reads
        calls = []
        real = solver.residual_lgsx_lanes

        def counted(*a, **k):
            act = a[6] if len(a) > 6 else k.get("active")
            calls.append(None if act is None else act.clone())  # the step rewrites it
            return real(*a, **k)

        monkeypatch.setattr(solver, "residual_lgsx_lanes", counted)
        results[chunk] = solver.lm_level_batched(quad, cloud, cam, R0, t0, opt, 0)
        monkeypatch.setattr(solver, "residual_lgsx_lanes", real)
        n = len(calls)
        slowest = int(sum(torch.ones(4, dtype=torch.int64) if a is None else a.long()
                          for a in calls).max())
        reads = solver.lm_level_batched.host_reads - before
        assert slowest <= n <= slowest + 2 * chunk - 1, (chunk, n, slowest)
        assert reads <= -(-n // chunk) + 1, (chunk, reads, n)
        launches[chunk] = n
    assert max(launches.values()) > min(launches.values())  # overshoot happened
    for chunk, res in results.items():
        for x, y in zip(solver._tree_leaves(res), solver._tree_leaves(results[1])):
            assert torch.equal(x, y), chunk


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_steps_after_every_lane_stopped_change_nothing(solver_name):
    seeds, xis, change = EXIT_CASES[solver_name]
    opt = dataclasses.replace(small_config().tracker.optimizer, solver=solver_name, **change)
    quad, cloud, R0, t0 = _seeded_lanes(seeds, xis)
    gn = solver_name == "gn_fixed"
    p = solver.step_params(opt, 0, gn, "cpu")
    ops = solver.lane_operands(quad, cloud, _cam(), 4)
    sums = torch.zeros((4, 46))
    state = solver.solver_start_ref(
        R0, t0, None if gn else solver._evaluate(ops, R0, t0, EDGE_DISTANCE, opt, None, sums), p)
    while bool(state.active.any()):
        state = solver.solver_step_ref(state, solver._evaluate(
            ops, state.Rn, state.tn, EDGE_DISTANCE, opt, state.active, sums), p)
    n_live = torch.full((1,), -1, dtype=torch.int32)
    after = _copy(state)
    for _ in range(5):
        after = solver.solver_step_ref(after, solver._evaluate(
            ops, after.Rn, after.tn, EDGE_DISTANCE, opt, after.active, sums), p, n_live)
    assert int(n_live) == 0
    for x, y in zip(solver._tree_leaves(after), solver._tree_leaves(state)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_step_writes_into_the_state_it_is_given(solver_name):
    """The start makes new tensors, none shared with its arguments or with
    each other; a step writes into them and returns the same state."""
    seeds, xis, change = EXIT_CASES[solver_name]
    opt = dataclasses.replace(small_config().tracker.optimizer, solver=solver_name, **change)
    quad, cloud, R0, t0 = _seeded_lanes(seeds, xis)
    R0_in, t0_in = R0.clone(), t0.clone()
    gn = solver_name == "gn_fixed"
    p = solver.step_params(opt, 0, gn, "cpu")
    ops = solver.lane_operands(quad, cloud, _cam(), 4)
    sums = torch.zeros((4, 46))
    state = solver.solver_start(
        R0, t0, None if gn else solver._evaluate(ops, R0, t0, EDGE_DISTANCE, opt, None, sums), p)
    leaves = solver._tree_leaves(state)
    ptrs = [x.data_ptr() for x in leaves]
    assert len(set(ptrs)) == len(leaves)
    assert not {R0.data_ptr(), t0.data_ptr(), sums.data_ptr()} & set(ptrs)
    before = _copy(state)
    stepped = solver.solver_step(state, solver._evaluate(
        ops, state.Rn, state.tn, EDGE_DISTANCE, opt, state.active, sums), p)
    assert stepped is state
    assert [x.data_ptr() for x in solver._tree_leaves(stepped)] == ptrs
    assert not all(torch.equal(x, y) for x, y in zip(leaves, solver._tree_leaves(before)))
    assert torch.equal(R0, R0_in) and torch.equal(t0, t0_in)


# -- the init check ------------------------------------------------------------

def _rot(axis, angle):
    w = np.zeros(3, np.float32)
    w[axis] = angle
    return lie.exp_so3(torch.from_numpy(w)).numpy()


INIT_POSES = {  # (R, t): points in front, behind the camera, outside the image
    "identity": (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
    "small": (_rot(1, 0.02), np.array([0.01, -0.02, 0.005], np.float32)),
    "half_turn_y": (_rot(1, np.pi), np.zeros(3, np.float32)),
    "pulled_back": (np.eye(3, dtype=np.float32), np.array([0, 0, -3.0], np.float32)),
    "shifted": (np.eye(3, dtype=np.float32), np.array([5.0, 0, 0], np.float32)),
    "quarter_turn_z": (_rot(2, 1.5), np.zeros(3, np.float32)),
}


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("use_edge_filter", [True, False])
def test_init_check_matches_jax(jax_pair, normalized, use_edge_filter):
    cfg, kj, fj, kt, ft = jax_pair
    lvl = cfg.pyramid.pyr_min_lvl
    cam, tcam = cfg.camera_pyramid()[lvl], convert.config_from_jax(cfg).camera_pyramid()[lvl]
    dist, margin = cfg.tracker.optimizer.edge_distance_lvl[lvl], cfg.tracker.init_check_margin
    jcloud = fj.levels[lvl].cloud
    jcost = jax.jit(lambda R_, t_: jsolver.eval_cost(
        kj.structs[lvl][..., 2], jcloud, cam, R_, t_, dist, use_edge_filter, normalized))
    names = list(INIT_POSES)
    Rs = np.stack([INIT_POSES[n][0] for n in names])
    ts = np.stack([INIT_POSES[n][1] for n in names])
    b = len(names)
    struct = kt.structs[lvl][None].expand(b, *kt.structs[lvl].shape)
    cl = ft.levels[lvl].cloud
    cloud = EdgeCloud(cl.points[None].expand(b, -1, -1), cl.valid[None].expand(b, -1), None)
    got = solver.init_check_ref(struct, cloud, tcam, torch.from_numpy(Rs), torch.from_numpy(ts),
                                dist, use_edge_filter, normalized, margin)
    # JAX sums the DT values in float32, the port in float64 (exact: square
    # roots of integers) rounded once: they agree within float32's bound for
    # a sum of P non-negative terms, and one rounding of the division.
    rtol = (cl.points.shape[0] + 1) * 2.0 ** -24
    cost_eye = np.float32(jcost(jnp.eye(3), jnp.zeros(3)))
    np.testing.assert_allclose(got.cost_eye.numpy(), cost_eye, rtol=rtol)
    for k, name in enumerate(names):
        cost = np.float32(jcost(jnp.asarray(Rs[k]), jnp.asarray(ts[k])))
        np.testing.assert_allclose(float(got.cost[k]), cost, rtol=rtol, err_msg=name)
        use_eye = bool(got.cost_eye[k] < np.float32(margin) * got.cost[k])
        assert use_eye == bool(cost_eye < margin * cost), name
        assert bool(got.use_eye[k]) == use_eye, name
        np.testing.assert_array_equal(got.R[k].numpy(), np.eye(3) if use_eye else Rs[k])
        np.testing.assert_array_equal(got.t[k].numpy(), np.zeros(3) if use_eye else ts[k])
        one = solver.init_check_ref(struct[:1], lane(cloud, slice(0, 1)), tcam,
                                    torch.from_numpy(Rs[k:k + 1]), torch.from_numpy(ts[k:k + 1]),
                                    dist, use_edge_filter, normalized, margin)
        for x, y in zip(lane(one, 0), lane(got, k)):
            assert torch.equal(x, y), name
    assert 0 < int(got.use_eye.sum()) < b  # both choices taken


def _partitioned_sum(terms: np.ndarray, cluster: int, threads: int) -> float:
    """``terms`` (P,) float64 summed as csrc/initcheck.cuh sums them: point
    p to thread p mod (cluster threads), each thread over its points in
    order, the shuffle tree of each warp, the warps in order, then the
    blocks (ranks) in order."""
    span = cluster * threads
    padded = np.zeros(-(-len(terms) // span) * span)
    padded[:len(terms)] = terms
    per_thread = np.zeros(span)
    for chunk in padded.reshape(-1, span):  # the thread's loop, in order
        per_thread = per_thread + chunk
    warps = per_thread.reshape(cluster, threads // 32, 32)
    for off in (16, 8, 4, 2, 1):  # __shfl_down_sync: lane l adds lane l + off
        shifted = np.concatenate([warps[..., off:], warps[..., :off]], axis=-1)
        warps = warps + shifted
    total = 0.0
    for rank in range(cluster):
        block = 0.0
        for w in range(threads // 32):
            block += warps[rank, w, 0]
        total += block
    return total


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("use_edge_filter", [True, False])
def test_init_check_partitioned_sums_match(jax_pair, normalized, use_edge_filter):
    """The check's sums as the kernels take them (csrc/initcheck.cuh: the
    standalone check's clusters of 8 blocks of 256 threads, the level
    kernel's 1-8 blocks of 512), and in a random order, in float64: equal
    to the plain sum of ``solver.cost_terms``, and rounded (and divided by
    the count) equal to ``init_check_ref``'s costs bit for bit, on the
    JAX-built frame pair; JAX's ``eval_cost`` within float32's summation
    bound of them."""
    cfg, kj, fj, kt, ft = jax_pair
    lvl = cfg.pyramid.pyr_min_lvl
    cam, tcam = cfg.camera_pyramid()[lvl], convert.config_from_jax(cfg).camera_pyramid()[lvl]
    dist, margin = cfg.tracker.optimizer.edge_distance_lvl[lvl], cfg.tracker.init_check_margin
    jcloud = fj.levels[lvl].cloud
    jcost = jax.jit(lambda R_, t_: jsolver.eval_cost(
        kj.structs[lvl][..., 2], jcloud, cam, R_, t_, dist, use_edge_filter, normalized))
    cl = ft.levels[lvl].cloud
    dt_img = kt.structs[lvl][..., 2]
    rng = np.random.default_rng(19)
    rtol = (cl.points.shape[0] + 1) * 2.0 ** -24
    for name, (R, t) in INIT_POSES.items():
        Rt, tt = torch.from_numpy(R), torch.from_numpy(t)
        terms, ok = solver.cost_terms(dt_img, cl, tcam, Rt, tt, dist, use_edge_filter)
        terms = terms.numpy().astype(np.float64)
        exact = float(np.sum(terms))
        assert math.fsum(terms) == exact
        sums = {_partitioned_sum(terms, c, nt) for c, nt in ((8, 256), (1, 512), (2, 512),
                                                             (4, 512), (8, 512))}
        sums.add(float(np.sum(terms[rng.permutation(len(terms))])))
        assert sums == {exact}, name
        cost = np.float32(exact)
        if normalized:
            cost = cost / np.float32(max(int(ok.sum()), 1))
        ref = solver.init_check_ref(kt.structs[lvl][None], EdgeCloud(cl.points[None],
                                                                     cl.valid[None], None),
                                    tcam, Rt[None], tt[None], dist, use_edge_filter,
                                    normalized, margin)
        assert np.float32(ref.cost[0]).tobytes() == np.float32(cost).tobytes(), name
        np.testing.assert_allclose(cost, np.float32(jcost(jnp.asarray(R), jnp.asarray(t))),
                                   rtol=rtol, err_msg=name)


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_warp_step_model_matches_the_plain_step(solver_name):
    """tests/_torch_step_model.py, the level kernel's step entry by entry as
    the warp's lanes take the entries (csrc/solver.cuh ``step_lane_warp``),
    against ``solver_start_ref`` and ``solver_step_ref`` on the seeded lanes
    that stop through every exit: every field of every lane bit for bit
    after the start and after every step."""
    seeds, xis, change = EXIT_CASES[solver_name]
    opt = dataclasses.replace(small_config().tracker.optimizer, solver=solver_name, **change)
    quad, cloud, R0, t0 = _seeded_lanes(seeds, xis)
    gn = solver_name == "gn_fixed"
    p = solver.step_params(opt, 0, gn, "cpu")
    pows = [np.float32(x) for x in p.pows.numpy()]
    ops = solver.lane_operands(quad, cloud, _cam(), 4)
    sums = torch.zeros((4, 46))
    first = None if gn else solver._evaluate(ops, R0, t0, EDGE_DISTANCE, opt, None, sums).clone()
    state = solver.solver_start_ref(R0, t0, first, p)
    for b in range(4):
        row = np.zeros(46, np.float32) if gn else first[b].numpy()
        model = step_model.step(None, row, p, pows, 1, R0[b].reshape(9).numpy(), t0[b].numpy())
        assert step_model.same(model, step_model.lane_state(state, b)), ("start", b)
    n = 0
    while bool(state.active.any()):
        rows = solver._evaluate(ops, state.Rn, state.tn, EDGE_DISTANCE, opt, state.active,
                                sums).clone()
        before = [step_model.lane_state(state, b) for b in range(4)]
        state = solver.solver_step_ref(state, rows, p)
        n += 1
        for b in range(4):
            model = step_model.step(before[b], rows[b].numpy(), p, pows, 0)
            assert step_model.same(model, step_model.lane_state(state, b)), (n, b)
    assert n > 2


def test_init_check_and_step_take_the_plain_version_on_the_cpu():
    """A CPU tensor goes to the plain version; the kernel's wrapper refuses
    a CPU state and the linalg solve."""
    seeds, xis, change = EXIT_CASES["gn_fixed"]
    quad, cloud, R0, t0 = _seeded_lanes(seeds[:2], xis[:2])
    p = solver.step_params(small_config().tracker.optimizer, 0, True, "cpu")
    state = solver.solver_start(R0, t0, None, p)
    want = solver.solver_start_ref(R0, t0, None, p)
    for x, y in zip(solver._tree_leaves(state), solver._tree_leaves(want)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unsupported device"):
        solver._launch_step(state, None, p, None)
    assert solver._steppers(p._replace(impl="linalg")) == (
        solver.solver_start_ref, solver.solver_step_ref)
    assert solver._steppers(p) == (solver.solver_start, solver.solver_step)


# -- the C interface ------------------------------------------------------------

_KIND = {"int": "i", "float": "f"}


def _c_kinds(params: str) -> str:
    kinds = []
    for param in params.split(","):
        param = param.strip()
        if param.startswith("const long long*"):  # a host array of int64
            kinds.append("a")
        elif "*" in param:
            kinds.append("p")
        elif param.startswith("cudaStream_t"):
            kinds.append("s")
        else:
            kinds.append(_KIND[param.split()[0]])
    return "".join(kinds)


def test_signatures_match_the_c_prototypes():
    """Every exported function of csrc/*.cu takes what ``kernels.SIGNATURES``
    says, stream last, and every entry has a function."""
    found = {}
    for name in sorted(os.listdir(kernels.SRC_DIR)):
        if name.endswith(".cu"):
            src = open(os.path.join(kernels.SRC_DIR, name)).read()
            for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
                found[fn] = _c_kinds(params)
    assert set(found) == set(kernels.SIGNATURES)
    for fn, kinds in kernels.SIGNATURES.items():
        assert found[fn] == kinds + "s", fn
