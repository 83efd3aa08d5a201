"""Promotions per 1000 lane-frames of the window, from the scan's
``promoted`` flags."""


def read(obs):
    if not obs.get("promoted"):
        return None
    promotions, lane_frames = obs["promoted"]
    return 1000.0 * promotions / lane_frames if lane_frames else None
