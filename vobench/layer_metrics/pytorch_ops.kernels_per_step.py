"""Torch kernels a step in the traced segment: the device kernels the
profiler records that are not the program's hand kernels (csrc/*.cu)."""


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr["steps"]:
        return None
    return tr["torch_kernels"] / tr["steps"]
