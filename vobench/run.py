"""Entry point: ``python -m vobench.run --workload NAME --seed N --seconds S
--trace 0|1`` (``vobench.harness.main``)."""
import os
import sys

# One process with few threads: the host loop is single-threaded, and idle
# OpenMP or BLAS workers only add noise beside it.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

from vobench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
