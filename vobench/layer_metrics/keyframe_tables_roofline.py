"""Roofline share of one ``ops.edt.keyframe_tables`` call (one
``revo_edt_columns_levels`` and a ``revo_keyframe_rows`` a level) on the
cell's B lanes of edges (the lanes' current frames), timed alone behind a
spin kernel; bytes: the edges in, g^2, the structure and the quad table."""
from vobench import roofline


def read(obs):
    if obs["device"].type != "cuda":
        return None
    from revo_tpu_torch.ops.edt import keyframe_tables

    form = obs["config"]["optimizer"]["quad_form"]
    edges = [e.contiguous() for e in obs["driver"].kernel_inputs()["edges"]]
    seconds = roofline.device_seconds(lambda: keyframe_tables(edges, form))
    return roofline.share(roofline.keyframe_tables_bytes([e.shape for e in edges], form), seconds)
