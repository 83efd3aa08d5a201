"""The port's process-group path across two real processes (the twin of
tests/test_distributed.py): each worker (tests/_torch_distributed_worker.py)
starts a gloo group through ``maybe_distributed_init`` from the environment
``torchrun`` would set, puts two CPU slots into the mesh, and checks the
collectives on every rank; the ``slow`` case runs ``vo_scan_batched`` over
the four slots, bit-equal on every rank to a single-process ``vo_scan``.
"""
import os
import socket
import subprocess
import sys

import pytest

from revo_tpu_torch import convert

from _torch_inputs import small_config
from test_solver import small_cfg

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(mode: str, timeout_s: float):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, mode], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"distributed workers hung; output so far: {outs}")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"DISTOK {rank}" in out, f"rank {rank} output:\n{out}"


def test_two_process_psum():
    assert small_config() == convert.config_from_jax(small_cfg())  # what "scan" runs
    _run_pair("psum", timeout_s=60)


@pytest.mark.slow  # like its JAX twin: each process scans 2 sequences and checks 4
def test_two_process_vo_scan_batched():
    _run_pair("scan", timeout_s=600)
