"""Host ms a step in ``frontend.build_frame_batched``: the self time of the
program's ``frontend.build`` spans (enqueueing the pyramid, Canny, fill-in
and edge-cloud work; the collector's passes left out) in the traced
segment."""
from vobench import program_spans


def read(obs):
    snap = program_spans.session(obs)
    if snap is None:
        return None
    return program_spans.ms_per_step(obs, snap, ("frontend.build",))
