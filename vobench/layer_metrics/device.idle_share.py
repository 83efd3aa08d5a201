"""Share of the traced segment with no operation running on the device:
1 - busy_s / window_s, the union of the profiler's device operations over
the segment's length (the profiler sees the kernels launched through ctypes
too: its counts equal the wrappers' launches)."""


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
