"""One rank of the port's two-process tests (tests/test_torch_distributed.py).

    python tests/_torch_distributed_worker.py psum|scan

The environment gives the rank as ``torchrun`` would (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).  Each rank starts the group
through ``maybe_distributed_init`` (gloo on the CPU) and puts two CPU slots
into the mesh, the counterpart of tests/distributed_worker.py's two virtual
devices per process.  "psum": a scalar and (8, 6) blocks reduced across the
four slots, checked on every rank.  "scan": ``vo_scan_batched`` of B = 4
sequences of N = 5 frames, one per slot, bit-equal on every rank to a
single-process ``vo_scan`` of each.  Prints ``DISTOK <rank>`` when done.
Imports no jax.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from revo_tpu_torch.parallel.mesh import (  # noqa: E402
    gather, make_mesh, maybe_distributed_init, psum, shard)

SLOTS = [torch.device("cpu")] * 2


def check_psum(mesh) -> None:
    data = torch.arange(8, dtype=torch.float32)  # 2 rows per slot
    total = psum([x.sum() for x in shard(data, mesh, "pair")], mesh, "pair")
    assert float(total) == float(data.sum()), (float(total), float(data.sum()))
    blocks = torch.arange(6, dtype=torch.float32).repeat(8, 1)
    reduced = psum([b.sum(0) for b in shard(blocks, mesh, "pair")], mesh, "pair")
    assert torch.equal(reduced, 8.0 * torch.arange(6, dtype=torch.float32)), reduced
    counts = psum([torch.tensor(1, dtype=torch.int32)] * 2, mesh, "pair")
    assert counts.dtype == torch.int32 and int(counts) == 4
    got = gather(shard(blocks, mesh, "pair"), mesh, "pair")
    assert torch.equal(got, blocks)
    assert gather([[dist.get_rank()]] * 2, mesh, "pair") == [0, 0, 1, 1]


def check_scan(mesh) -> None:
    from revo_tpu_torch.io.synthetic import SyntheticScene, render_sequence
    from revo_tpu_torch.parallel.batch import vo_scan, vo_scan_batched

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_inputs import small_config

    cfg = small_config()
    seqs = [list(render_sequence(SyntheticScene(), cfg.camera, 5, seed=s)) for s in range(4)]
    grays = torch.from_numpy(np.stack([np.stack([f[0] for f in q]) for q in seqs]))
    depths = torch.from_numpy(np.stack([np.stack([f[1] for f in q]) for q in seqs]))
    poses = vo_scan_batched(grays, depths, cfg, mesh=mesh, axis="pair")
    assert poses.shape == (4, 5, 4, 4), poses.shape
    for b in range(4):
        assert torch.equal(poses[b], vo_scan(grays[b], depths[b], cfg)[0]), f"sequence {b}"


def main() -> None:
    torch.set_num_threads(1)
    assert maybe_distributed_init(), "maybe_distributed_init did not start a group"
    try:
        assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
        mesh = make_mesh(("pair",), devices=SLOTS)
        assert mesh.shape["pair"] == 4 and mesh.group is not None
        {"psum": check_psum, "scan": check_scan}[sys.argv[1]](mesh)
        print(f"DISTOK {dist.get_rank()}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
