"""Stage-parallel replay over two devices (counterpart of
revo_tpu/parallel/pipeline.py).

The reference's only concurrency is a 3-thread pipeline: an IO and
pyramid thread feeding a tracking thread through a locked queue
(iowrapperRGBD.cpp:341-352).  Here the per-frame work splits into a
frame-build stage (pyramid, Canny, back-projection) on one device and a
solve stage (coarse-to-fine tracking against the first frame's keyframe)
on another, software-pipelined: frame i+1's build is queued before frame
i's track, so while the solve stage tracks frame i the build stage is
already building frame i+1.

Where both stages share one card the build runs on a second CUDA stream.
Its frame is handed to the solve stream with ``wait_stream`` and a
``record_stream`` on every tensor, so that the caching allocator does not
give the frame's memory back to the build stream while the solve still
reads it.  The kernels launch on the current stream and keep their
scratch per (device, stream), so the two streams never share one.  Any
host read inside ``build_frame`` holds the host until the build stream
gets there, which serialises the stages for that moment.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from revo_tpu_torch import lie, tracker
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.frontend import build_frame, make_keyframe
from revo_tpu_torch.parallel.mesh import cuda_devices, to_device


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)


def pipeline_replay(
    grays, depths, cfg: SystemConfig, devices: Optional[Sequence] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track a preloaded sequence (numpy arrays or tensors, one per frame)
    against its first frame's keyframe with the build stage on
    ``devices[0]`` and the solve stage on ``devices[1]`` (both on
    ``devices[0]`` when only one is given; default: the CUDA devices,
    raising without one).

    Returns (T_kf_cam (N, 4, 4), errors (N,)) on the solve device; frame 0
    is the keyframe (identity, error 0).  The kernels and their order are
    the sequential step's, so the result is bit-equal to it."""
    devices = [torch.device(d) for d in devices] if devices is not None else cuda_devices()
    dev_build = devices[0]
    dev_solve = devices[1] if len(devices) > 1 else devices[0]
    side = (torch.cuda.Stream(dev_build)
            if dev_build.type == "cuda" and dev_build == dev_solve else None)

    def on(x, device):
        return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device)

    n = len(grays)
    kf = make_keyframe(build_frame(on(grays[0], dev_solve), on(depths[0], dev_solve), cfg),
                       torch.eye(4, device=dev_solve), cfg)
    R, t = torch.eye(3, device=dev_solve), torch.zeros(3, device=dev_solve)

    def build(i):
        if side is not None:  # the side stream starts after what the solve stream queued
            side.wait_stream(torch.cuda.current_stream(dev_build))
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            return build_frame(on(grays[i], dev_build), on(depths[i], dev_build), cfg)

    def hand_off(frame):
        if side is None:
            return to_device(frame, dev_solve)  # another device: a copy, ordered by torch
        solve_stream = torch.cuda.current_stream(dev_solve)
        solve_stream.wait_stream(side)
        for x in _tensors(frame):
            x.record_stream(solve_stream)
        return frame

    poses = [torch.eye(4, device=dev_solve)]
    errors = [torch.zeros((), device=dev_solve)]
    in_flight = build(1) if n > 1 else None
    for i in range(1, n):
        frame = hand_off(in_flight)
        if i + 1 < n:
            in_flight = build(i + 1)  # queued before the track below
        res = tracker.track_frames(kf, frame, R, t, cfg)
        R, t = res.R, res.t
        poses.append(lie.matrix_from_rt(R, t))
        errors.append(res.error)
    return torch.stack(poses), torch.stack(errors)
