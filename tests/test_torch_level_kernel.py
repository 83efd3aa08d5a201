"""The level kernel (csrc/level.cu ``revo_solve_level``, wrapper
``solver.solve_level_kernel``) on the CPU, where it cannot run: its work
split, its schedule and its routing.

- A model of the kernel's work split, read from level.cu's constants: for
  each cluster size it may take and level sizes of the main path, every
  128-point virtual block is covered exactly once, by the threads
  ``residual_lgsx``'s block of that index uses, and rank 0 sums the partial
  rows in virtual-block order (the order of ``residual_lgsx``'s last block).
- Its plain version ``solver.solve_level_ref``, the kernel's schedule (each
  lane evaluates and steps until its own exit), on seeded lanes that stop
  at different evaluations through every exit: every LevelState field
  bit-equal to the CPU's two-launch loop (``level_state``), each lane's
  evaluation count the loop's count up to that lane's exit; and on the
  JAX-built frame pair of tests/test_torch_solver_step.py, two lanes a
  level within the JAX package's lm_level / gn_level_fixed tolerance there
  (1e-5 m / rad, errors within rtol 1e-4, counts equal).
- Routing: CUDA with solve6_impl "ldlt" takes the kernel, "launches" is
  the caller's choice, "linalg" and the CPU take the plain loop, any other
  device or form raises; the cluster size by the solver's waves.
- ``revo_solve_level``'s C prototype against ``kernels.SIGNATURES``.
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

from revo_tpu import solver as jsolver
from revo_tpu_torch import convert, kernels, lie, solver
from revo_tpu_torch.lanes import lane
from revo_tpu_torch.ops.backproject import EdgeCloud

from _torch_inputs import small_config
from test_torch_solver_step import (  # noqa: F401 (jax_pair: the fixture)
    EXIT_CASES, _angle, _c_kinds, _cam, _seeded_lanes, jax_pair,
)

torch.set_num_threads(1)

POSE_TOL = 1e-5
LEVEL_SRC = os.path.join(kernels.SRC_DIR, "level.cu")
# The level sizes of the main path (640x480 capacities and the JAX bench's
# margin-0.65 ones) and a one-point level.
LEVEL_POINTS = (16384, 8192, 4096, 4864, 2304, 1)


def _kernel_constant(name: str) -> int:
    src = open(LEVEL_SRC).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _work_split(points: int, cluster: int):
    """The kernel's loops as level.cu writes them: per (rank, group) the
    virtual blocks it forms rows of, in order, and the order in which rank
    0 sums the rows."""
    vb = _kernel_constant("VB_POINTS")
    groups = _kernel_constant("LV_GROUPS")
    nb = max(-(-points // vb), 1)
    rows = {(rank, g): list(range(rank * groups + g, nb, cluster * groups))
            for rank in range(cluster) for g in range(groups)}
    return vb, nb, rows, list(range(nb))


@pytest.mark.parametrize("points", LEVEL_POINTS)
@pytest.mark.parametrize("cluster", solver.LEVEL_CLUSTERS)
def test_work_split_covers_each_virtual_block_once(cluster, points):
    vb, nb, rows, sum_order = _work_split(points, cluster)
    assert vb == 128 and _kernel_constant("LV_CLUSTER_MAX") == max(solver.LEVEL_CLUSTERS)
    # residual_lgsx's grid over the same points: ceil(P / 128) blocks, at least one.
    assert nb == max(math.ceil(points / 128), 1)
    taken = sorted(j for js in rows.values() for j in js)
    assert taken == list(range(nb))  # each virtual block exactly once
    for js in rows.values():
        assert js == sorted(js)
    # Thread t of a virtual block's group takes point 128 j + t, the point
    # of thread t of residual_lgsx's block j; points past P count nothing.
    covered = sorted(j * vb + t for j in taken for t in range(vb) if j * vb + t < points)
    assert covered == list(range(points))
    # Rank 0 sums every row in virtual-block order.
    assert sum_order == list(range(nb))


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_level_schedule_matches_the_loop(solver_name, monkeypatch):
    """The kernel's plain version on four lanes that stop at different
    evaluations through every exit (tests/test_torch_solver_step.py's
    EXIT_CASES) against the CPU's two-launch loop."""
    seeds, xis, change = EXIT_CASES[solver_name]
    opt = dataclasses.replace(small_config().tracker.optimizer, solver=solver_name, **change)
    quad, cloud, R0, t0 = _seeded_lanes(seeds, xis)
    gn = solver_name == "gn_fixed"
    cam = _cam()
    state, evals = solver.solve_level_ref(quad, cloud, cam, R0, t0, opt, 0, gn)
    # The two-launch loop, each lane's evaluations counted from the masks
    # its residual passes take (all lanes: lm's start).
    took = torch.zeros(4, dtype=torch.int32)
    real = solver.residual_lgsx_lanes

    def counted(ops, *a, **k):
        act = a[5] if len(a) > 5 else k.get("active")
        took.add_(torch.ones(4, dtype=torch.int32) if act is None else act.to(torch.int32))
        return real(ops, *a, **k)

    monkeypatch.setattr(solver, "residual_lgsx_lanes", counted)
    loop = solver.level_state(quad, cloud, cam, R0, t0, opt, 0, gn)
    monkeypatch.undo()
    assert solver.level_route("cpu", opt.solve6_impl) == "plain"
    for name, x, y in zip(("R", "t", "Rn", "tn", "inc", "err", "A", "g", "good", "bad",
                           "sum_w", "sum_unw", "lam", "iteration", "tries", "active"),
                          solver._tree_leaves(state), solver._tree_leaves(loop)):
        assert torch.equal(x, y), name
    fn = solver.gn_level_fixed_batched if gn else solver.lm_level_batched
    for x, y in zip(solver._tree_leaves(fn(quad, cloud, cam, R0, t0, opt, 0)),
                    (state.R, state.t, state.sys.err, *state.sys.info)):
        assert torch.equal(x, y)
    # Each lane's evaluations: the loop's up to its exit (lm's start
    # evaluation included); the lanes stop at different ones.
    assert evals.dtype == torch.int32 and torch.equal(evals, took)
    assert len(set(evals.tolist())) > 1 and not bool(state.active.any())


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_level_schedule_matches_jax(jax_pair, solver_name):
    """Each level of tests/test_torch_solver_step.py's JAX-built frame pair,
    two lanes (the identity and a perturbed start) in one call of the
    kernel's plain version, each lane against JAX's jitted lm_level /
    gn_level_fixed from its start: poses within 1e-5 m / 1e-5 rad, the
    error within rtol 1e-4, good and bad equal (test_level_matches_jax's
    tolerance)."""
    cfg, kj, fj, kt, ft = jax_pair
    opt = dataclasses.replace(cfg.tracker.optimizer, solver=solver_name)
    topt = convert.config_from_jax(dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, optimizer=opt))).tracker.optimizer
    cams, tcams = cfg.camera_pyramid(), convert.config_from_jax(cfg).camera_pyramid()
    xis = np.stack([np.zeros(6, np.float32),
                    np.array([0.01, -0.006, 0.012, 0.004, -0.006, 0.003], np.float32)])
    R0, t0 = lie.exp_se3(torch.from_numpy(xis))
    jfn = jsolver.lm_level if solver_name == "lm" else jsolver.gn_level_fixed
    for lvl in (2, 1, 0):
        tc = ft.levels[lvl].cloud
        cloud = EdgeCloud(tc.points[None].expand(2, -1, -1), tc.valid[None].expand(2, -1), None)
        quad = kt.quads[lvl][None].expand(2, -1, -1)
        state, evals = solver.solve_level_ref(quad, cloud, tcams[lvl], R0, t0, topt, lvl,
                                              solver_name == "gn_fixed")
        assert bool((evals > 0).all())
        run = jax.jit(lambda R_, t_, lvl=lvl: jfn(kj.quads[lvl], fj.levels[lvl].cloud, cams[lvl],
                                                  R_, t_, opt, lvl))
        for k in range(2):
            Rj, tj, ej, ij = run(jnp.asarray(R0[k].numpy()), jnp.asarray(t0[k].numpy()))
            one = lane(state, k)
            assert float(np.abs(one.t.numpy() - np.asarray(tj)).max()) <= POSE_TOL, (lvl, k)
            assert _angle(one.R.numpy(), np.asarray(Rj)) <= POSE_TOL, (lvl, k)
            np.testing.assert_allclose(float(one.sys.err), float(ej), rtol=1e-4)
            assert (int(one.sys.info.good), int(one.sys.info.bad)) == (int(ij.good),
                                                                       int(ij.bad)), (lvl, k)


def test_routing():
    assert solver.level_route("cuda", "ldlt") == "kernel"
    assert solver.level_route(torch.device("cuda", 0), "ldlt", "launches") == "launches"
    for dev in ("cuda", "cpu"):
        for form in solver.LEVEL_FORMS:
            assert solver.level_route(dev, "linalg", form) == "plain"
    assert solver.level_route("cpu", "ldlt") == "plain"
    with pytest.raises(ValueError):
        solver.level_route("meta", "ldlt")
    with pytest.raises(ValueError):
        solver.level_route("cuda", "ldlt", "graph")


@pytest.mark.parametrize("lanes,gn,want", [
    (1, False, 8), (8, True, 8), (16, True, 4), (16, False, 8), (32, True, 2), (32, False, 4),
    (64, True, 1), (128, False, 1), (500, True, 1)])
def test_level_cluster_takes_the_largest_size_in_the_solvers_waves(monkeypatch, lanes, gn, want):
    """level_cluster's rule on a stand-in card that holds 8 clusters of 8
    blocks, 16 of 4, 32 of 2 and 64 of 1: gn_fixed's lanes in one wave,
    lm's in LEVEL_WAVES["lm"], else single blocks."""
    held = {8: 8, 4: 16, 2: 32, 1: 64}
    asked = []

    def call(name, layout, cluster, device=None):
        asked.append((name, layout, cluster))
        return held[cluster]

    monkeypatch.setattr(kernels, "call", call)
    assert solver.LEVEL_WAVES == {"gn_fixed": 1, "lm": 2}
    assert solver.level_cluster.__wrapped__(torch.device("cuda"), 3, lanes, gn) == want
    assert {a[:2] for a in asked} == {("revo_solve_level_clusters", 3)}


def test_level_state_launches_the_kernel_where_routed(monkeypatch):
    """level_state hands a level routed to the kernel to one
    solve_level_kernel call, with the level's schedule, and returns its
    state; the CPU never reaches it, and the wrapper refuses CPU operands."""
    seeds, xis, change = EXIT_CASES["lm"]
    opt = dataclasses.replace(small_config().tracker.optimizer, **change)
    quad, cloud, R0, t0 = _seeded_lanes(seeds, xis)
    cam = _cam()
    calls = []

    def fake(ops, R0_, t0_, edge_distance, opt_, p, _cluster=None):
        calls.append((ops.lanes, edge_distance, p.gn, p.max_iter, p.max_inner))
        return solver.solve_level_ref(quad, cloud, cam, R0, t0, opt, 0, p.gn, p.max_inner)

    monkeypatch.setattr(solver, "solve_level_kernel", fake)
    before = solver.level_state(quad, cloud, cam, R0, t0, opt, 0, False)
    assert calls == []
    monkeypatch.setattr(solver, "level_route", lambda *a, **k: "kernel")
    routed = solver.level_state(quad, cloud, cam, R0, t0, opt, 0, False, max_inner=32)
    assert calls == [(4, opt.edge_distance_lvl[0], False, opt.max_its_per_lvl[0], 32)]
    assert all(torch.equal(x, y) for x, y in zip(solver._tree_leaves(routed),
                                                  solver._tree_leaves(before)))
    monkeypatch.undo()
    ops = solver.lane_operands(quad, cloud, cam, 4)
    p = solver.step_params(opt, 0, False, "cpu")
    with pytest.raises(ValueError):
        solver.solve_level_kernel(ops, R0, t0, opt.edge_distance_lvl[0], opt, p)
    meta = type(cloud)(cloud.points.to("meta"), cloud.valid.to("meta"), None)
    with pytest.raises(ValueError):
        solver.lm_level_batched(quad.to("meta"), meta, cam, R0.to("meta"), t0.to("meta"), opt, 0)


def test_level_kernel_prototype_matches_its_signature():
    src = open(LEVEL_SRC).read()
    found = {fn: _c_kinds(params)
             for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(found) == {"revo_solve_level", "revo_solve_level_clusters", "revo_solve_level_attr"}
    for fn, kinds in found.items():
        assert kinds == kernels.SIGNATURES[fn] + "s", fn
    # The wrapper passes one argument a kind: its launch call's arguments
    # after the name, counted in solver.py's source.
    body = open(solver.__file__).read().split('"revo_solve_level", ', 1)[1].split("\n    )")[0]
    assert len([a for a in body.split(",") if a.strip()]) == len(kernels.SIGNATURES["revo_solve_level"])
