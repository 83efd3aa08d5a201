"""Host ms a step of the scan's per-lane loop: the self time of
``scan.stack`` (the B lanes' keyframes, voting rings and poses restacked)
and ``scan.merge`` (the lanes' outcomes merged and B new scan states built),
the program's spans in the traced segment."""
from vobench import program_spans


def read(obs):
    snap = program_spans.session(obs)
    if snap is None:
        return None
    return program_spans.ms_per_step(obs, snap, ("scan.stack", "scan.merge"))
