"""Host ms a step of the scan's promotion: the whole ``scan.promote`` span
(the promoted lanes' ``make_keyframe_batched`` and their re-track), 0 in a
step that promotes none, over the traced segment's steps."""
from vobench import program_spans


def read(obs):
    snap = program_spans.session(obs)
    if snap is None:
        return None
    return program_spans.ms_per_step(obs, snap, ("scan.promote",), key="ns")
