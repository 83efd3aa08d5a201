"""Host reads a step in the traced segment: device-to-host copies and
stream, event or device synchronisations among the CUDA runtime calls that
the profiler records (it sees these whatever launched the kernels)."""


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr["steps"]:
        return None
    return (tr["syncs"] + tr["d2h"]) / tr["steps"]
