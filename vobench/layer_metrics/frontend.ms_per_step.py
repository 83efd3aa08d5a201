"""Mean ms a step between the CUDA events the track driver records around
its call of ``frontend.build_frame_batched`` in the traced segment."""


def read(obs):
    ms = obs.get("spans", {}).get("frontend_ms")
    return sum(ms) / len(ms) if ms else None
