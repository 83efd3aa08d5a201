"""95th percentile of every step of the run's window (ms), each step timed
from its start until the host holds its flags; the scan's tail, host-paced."""
from vobench.harness import percentile


def read(obs):
    if not obs["durations"]:
        return None
    return 1e3 * percentile(obs["durations"], 95)
