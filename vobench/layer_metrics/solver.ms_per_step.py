"""Mean ms a step between the CUDA events the track driver records around
its call of ``tracker.track_frames_batched`` in the traced segment."""


def read(obs):
    ms = obs.get("spans", {}).get("solver_ms")
    return sum(ms) / len(ms) if ms else None
