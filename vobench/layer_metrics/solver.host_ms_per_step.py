"""Host ms a step in ``tracker.track_frames_batched``: the self time of the
program's ``tracker.track`` spans, the promotion's re-tracks included, in
the traced segment."""
from vobench import program_spans


def read(obs):
    snap = program_spans.session(obs)
    if snap is None:
        return None
    return program_spans.ms_per_step(obs, snap, ("tracker.track",))
