"""The port's meshes and collectives (revo_tpu_torch.parallel.mesh) against
the JAX package's (revo_tpu.parallel.mesh), on the CPU; the cases of
tests/test_mesh.py, then the plumbing that stands in for shard_map.

The JAX side runs on conftest's 8 virtual CPU devices, the port's on
``[torch.device("cpu")] * 8`` slots.  Mesh shapes must be equal and the same
bad inputs must raise; ``psum`` and ``gather`` are exact (integers, and
float sums in slot order against the same order by hand).
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from revo_tpu.parallel import mesh as jmesh
from revo_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def test_single_axis():
    mesh = M.make_mesh(("seq",), devices=CPU8)
    assert mesh.shape["seq"] == jmesh.make_mesh(("seq",)).shape["seq"] == len(jax.devices())
    assert mesh.axis_names == ("seq",) and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_two_axis_with_infer():
    mesh = M.make_mesh(("seq", "pair"), (-1, 2), devices=CPU8)
    want = jmesh.make_mesh(("seq", "pair"), (-1, 2))
    assert mesh.shape == dict(want.shape) == {"seq": 4, "pair": 2}
    assert mesh.devices.shape == (4, 2)


@pytest.mark.parametrize("names, sizes", [(("a", "b"), (3, 5)), (("a", "b"), None)])
def test_bad_shape_and_missing_sizes_raise(names, sizes):
    """A shape that does not cover the devices, and a multi-axis mesh
    without sizes, raise in both packages."""
    with pytest.raises(ValueError):
        jmesh.make_mesh(names, sizes)
    with pytest.raises(ValueError):
        M.make_mesh(names, sizes, devices=CPU8)


def test_noop_without_distributed_environment(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert jmesh.maybe_distributed_init() is False
    assert M.maybe_distributed_init() is False
    assert not dist.is_initialized()
    # An incomplete environment is no group either.
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert M.maybe_distributed_init() is False and not dist.is_initialized()


def test_make_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.cuda_devices()


def test_shard_replicate_gather():
    mesh = M.make_mesh(("pt",), devices=CPU8[:4])
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    parts = M.shard(x, mesh, "pt")
    assert [p.shape for p in parts] == [(2, 3)] * 4
    assert torch.equal(parts[1], x[2:4]) and torch.equal(M.gather(parts, mesh, "pt"), x)
    # A (named) tuple shards leaf by leaf; a list splits as a sequence.
    tree = M.shard((x, x[:, 0] > 3), mesh, "pt")
    assert torch.equal(tree[2][1], (x[:, 0] > 3)[4:6])
    assert M.shard(list("abcdefgh"), mesh, "pt")[3] == ["g", "h"]
    assert M.gather([["a"], ["b", "c"]], mesh, "pt") == ["a", "b", "c"]
    reps = M.replicate(x, mesh, "pt")
    assert len(reps) == 4 and all(r is x for r in reps)  # no copy on its own device
    # Raw uint16 depth shards by slices.
    depth = torch.arange(8 * 4, dtype=torch.int32).to(torch.uint16).reshape(8, 4)
    assert M.shard(depth, mesh, "pt")[3].dtype == torch.uint16
    with pytest.raises(ValueError, match="does not divide"):
        M.shard(x[:7], mesh, "pt")
    with pytest.raises(TypeError, match="Mesh"):
        M.shard(x, object(), "pt")


def test_psum_in_slot_order_and_fresh():
    mesh = M.make_mesh(("pt",), devices=CPU8)
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.normal(size=(6, 6)).astype(np.float32) * 10 ** k)
             for k in range(8)]
    want = parts[0].clone()
    for p in parts[1:]:
        want = want + p
    got = M.psum(parts, mesh, "pt")
    assert torch.equal(got, want)
    got.add_(1.0)  # the total is a fresh tensor, never a partial
    assert not torch.equal(parts[0], got)
    counts = [torch.tensor(k, dtype=torch.int32) for k in range(8)]
    total = M.psum(counts, mesh, "pt")
    assert total.dtype == torch.int32 and int(total) == 28


def test_multi_axis_runs_each_shard_once():
    """A function sharded over one axis of a 2-axis mesh runs at index 0 of
    the other axis, which only replicates it, as under shard_map."""
    mesh = M.make_mesh(("seq", "pair"), (4, 2), devices=CPU8)
    assert len(M.local_slots(mesh, "seq")) == 4 and len(M.local_slots(mesh, "pair")) == 2
    x = torch.arange(8.0)
    assert torch.equal(M.psum([p.sum() for p in M.shard(x, mesh, "pair")], mesh, "pair"),
                       x.sum())
    assert torch.equal(M.gather(M.shard(x, mesh, "seq"), mesh, "seq"), x)
