"""Host ms a step blocked on the device: the self time of the program's
``host_read.*`` spans (each around one blocking copy or synchronise:
``scan.flags``, ``lie.inv_lu``, ...) in the traced segment."""
from vobench import program_spans


def read(obs):
    snap = program_spans.session(obs)
    if snap is None:
        return None
    names = [n for n in snap["totals"] if n.startswith("host_read.")]
    return program_spans.ms_per_step(obs, snap, names)
