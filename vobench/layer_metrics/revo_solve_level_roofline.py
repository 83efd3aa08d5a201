"""Roofline share of ``revo_solve_level`` over the traced segment: the least
time of the work its launches did, over the device seconds of
``solve_level_kernel`` in the segment's device operations.

The work, from the program's per-launch counts (each lane's evaluations and
its cloud's capacity P): each evaluation 166 P + 520 float32 operations
(the fused pass's 166 a point, the sums and the step's 520; PERF.md section
6); the bytes each lane's P points (12 B) and valid flags (1 B) and a table
row a point (``roofline.QUAD_BYTES``), read once a launch.  The larger of
the two times bounds."""
from vobench import program_spans, roofline

OPS_PER_POINT, OPS_PER_EVALUATION = 166, 520


def read(obs):
    snap = program_spans.session(obs)
    if snap is None or not snap["levels"]:
        return None
    seconds = sum(s for name, s, _ in obs["trace"]["device_ops"] if "solve_level_kernel" in name)
    row = roofline.QUAD_BYTES.get(obs["config"]["optimizer"]["quad_form"])
    if not seconds or row is None:
        return None
    flops = sum(sum(lv["evaluations"]) * (OPS_PER_POINT * lv["points"] + OPS_PER_EVALUATION)
                for lv in snap["levels"])
    n_bytes = sum(len(lv["evaluations"]) * lv["points"] * (12 + 1 + row) for lv in snap["levels"])
    return roofline.share(n_bytes, seconds, flops)
