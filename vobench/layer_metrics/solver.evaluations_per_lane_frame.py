"""The solver's work as a count: every lane's evaluations in every level of
the traced segment (the level kernel's own counts, which the program's
tracer keeps a launch; re-tracks included), over its lane-frames (steps x
B)."""
from vobench import program_spans


def read(obs):
    snap = program_spans.session(obs)
    if snap is None or not snap["levels"]:
        return None
    evaluations = sum(sum(lv["evaluations"]) for lv in snap["levels"])
    return evaluations / (obs["trace"]["steps"] * obs["lanes"])
