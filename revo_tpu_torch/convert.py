"""Carry state from the JAX package into the port.

REVO has no weights: its state is the configuration, the keyframe and the
VO loop's rings.  These helpers read JAX-side objects by attribute only,
with array leaves already converted by ``np.asarray``, so this module
imports neither jax nor revo_tpu.  Ring fill counts and loop flags become
Python ints and bools, as the port keeps them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from revo_tpu_torch import config as C
from revo_tpu_torch.frontend import Frame, FrameLevel, Keyframe
from revo_tpu_torch.ops.backproject import EdgeCloud
from revo_tpu_torch.parallel.batch import ScanVOState
from revo_tpu_torch.parallel.posegraph import PoseGraphEdges
from revo_tpu_torch.parallel.windowed import Window
from revo_tpu_torch.tracker import KeyframeRing, PastFrames

_SECTIONS = {
    "camera": C.CameraConfig,
    "pyramid": C.PyramidConfig,
    "tracker": C.TrackerConfig,
    "dataset": C.DatasetConfig,
}


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return obj
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def config_from_jax(cfg) -> C.SystemConfig:
    """A ``revo_tpu`` SystemConfig (or its ``dataclasses.asdict``) -> the
    port's SystemConfig with the same field values."""
    top = _fields(cfg)
    kw = {}
    for name, value in top.items():
        if name in _SECTIONS:
            sec = _fields(value)
            if name == "tracker":
                sec = dict(sec, optimizer=C.OptimizerConfig(**_fields(sec["optimizer"])))
            kw[name] = _SECTIONS[name](**sec)
        else:
            kw[name] = value
    return C.SystemConfig(**kw)


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: exact via float32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def frame_from_numpy(tree, device) -> Frame:
    """A JAX ``Frame`` with numpy leaves -> the port's Frame on ``device``."""
    levels = []
    for lv in tree.levels:
        cloud = EdgeCloud(
            points=_tensor(lv.cloud.points, device),
            valid=_tensor(lv.cloud.valid, device),
            count=_tensor(lv.cloud.count, device),
        )
        levels.append(FrameLevel(
            gray=_tensor(lv.gray, device),
            depth=_tensor(lv.depth, device),
            edges=_tensor(lv.edges, device),
            edges_orig=_tensor(lv.edges_orig, device),
            cloud=cloud,
        ))
    return Frame(levels=tuple(levels), timestamp=_tensor(tree.timestamp, device))


def quad_from_numpy(quad, struct_shape) -> np.ndarray:
    """A JAX quad table (``revo_tpu.ops.edt.quad_structure``, any leading
    lane or slot axes) in the port's (..., H*W, C) rows, given the shape
    (..., H, W, 3) of the structure it was built from: "hw12" (H, W, 12) is
    reshaped, "t" (12, H*W) transposed, "flat16" (H*W, 16) loses its pad
    lane a tap; "flat", "flatbf", "dt4" and "dt4bf" are the port's rows
    already.  The dtype (bfloat16 for "flatbf" / "dt4bf") is kept."""
    a = np.asarray(quad)
    lead, (h, w) = tuple(struct_shape[:-3]), tuple(struct_shape[-3:-1])
    if a.shape == (*lead, h, w, 12):
        return a.reshape(*lead, h * w, 12)
    if a.shape == (*lead, 12, h * w):
        return np.ascontiguousarray(np.swapaxes(a, -1, -2))
    if a.shape == (*lead, h * w, 16):
        return a.reshape(*lead, h * w, 4, 4)[..., :3].reshape(*lead, h * w, 12)
    return a


def _quads(tree, device):
    return tuple(_tensor(quad_from_numpy(q, np.shape(s)), device)
                 for q, s in zip(tree.quads, tree.structs))


def keyframe_from_numpy(tree, device) -> Keyframe:
    """A JAX ``Keyframe`` with numpy leaves -> the port's Keyframe (quad
    tables in the port's rows, ``quad_from_numpy``)."""
    return Keyframe(
        structs=tuple(_tensor(s, device) for s in tree.structs),
        quads=_quads(tree, device),
        frame=frame_from_numpy(tree.frame, device),
        T_w_k=_tensor(tree.T_w_k, device),
    )


def past_from_numpy(tree, device) -> PastFrames:
    """A JAX ``PastFrames`` with numpy leaves -> the port's PastFrames."""
    return PastFrames(
        points=_tensor(tree.points, device),
        valid=_tensor(tree.valid, device),
        poses=_tensor(tree.poses, device),
        n=int(tree.n),
    )


def ring_from_numpy(tree, device) -> KeyframeRing:
    """A JAX ``KeyframeRing`` with numpy leaves -> the port's KeyframeRing."""
    return KeyframeRing(
        structs=tuple(_tensor(s, device) for s in tree.structs),
        quads=_quads(tree, device),
        T_w_k=_tensor(tree.T_w_k, device),
        n=int(tree.n),
    )


def scan_state_from_numpy(tree, device) -> ScanVOState:
    """A JAX ``ScanVOState`` with numpy leaves -> the port's ScanVOState."""
    return ScanVOState(
        kf=keyframe_from_numpy(tree.kf, device),
        prev=frame_from_numpy(tree.prev, device),
        prev_T_w=_tensor(tree.prev_T_w, device),
        past=past_from_numpy(tree.past, device),
        past_voting=past_from_numpy(tree.past_voting, device),
        R=_tensor(tree.R, device),
        t=_tensor(tree.t, device),
        T_nm1_n=_tensor(tree.T_nm1_n, device),
        just_added_kf=bool(tree.just_added_kf),
        n_keyframes=int(tree.n_keyframes),
        kf_ring=None if tree.kf_ring is None else ring_from_numpy(tree.kf_ring, device),
    )


def edges_from_numpy(tree, device) -> PoseGraphEdges:
    """A JAX ``PoseGraphEdges`` with numpy leaves (or a dict of its four
    arrays) -> the port's PoseGraphEdges on ``device``."""
    get = tree.__getitem__ if isinstance(tree, dict) else (lambda k: getattr(tree, k))
    return PoseGraphEdges(*(_tensor(get(k), device) for k in PoseGraphEdges._fields))


def window_from_numpy(tree, device) -> Window:
    """A JAX windowed-BA ``Window`` with numpy leaves (or a dict of its four
    arrays) -> the port's Window on ``device``."""
    get = tree.__getitem__ if isinstance(tree, dict) else (lambda k: getattr(tree, k))
    return Window(*(_tensor(get(k), device) for k in Window._fields))
