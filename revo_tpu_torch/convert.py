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


def frame_from_numpy(tree, device="cpu") -> Frame:
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


def keyframe_from_numpy(tree, device="cpu") -> Keyframe:
    """A JAX ``Keyframe`` with numpy leaves -> the port's Keyframe."""
    return Keyframe(
        structs=tuple(_tensor(s, device) for s in tree.structs),
        quads=tuple(_tensor(q, device) for q in tree.quads),
        frame=frame_from_numpy(tree.frame, device),
        T_w_k=_tensor(tree.T_w_k, device),
    )


def past_from_numpy(tree, device="cpu") -> PastFrames:
    """A JAX ``PastFrames`` with numpy leaves -> the port's PastFrames."""
    return PastFrames(
        points=_tensor(tree.points, device),
        valid=_tensor(tree.valid, device),
        poses=_tensor(tree.poses, device),
        n=int(tree.n),
    )


def ring_from_numpy(tree, device="cpu") -> KeyframeRing:
    """A JAX ``KeyframeRing`` with numpy leaves -> the port's KeyframeRing."""
    return KeyframeRing(
        structs=tuple(_tensor(s, device) for s in tree.structs),
        quads=tuple(_tensor(q, device) for q in tree.quads),
        T_w_k=_tensor(tree.T_w_k, device),
        n=int(tree.n),
    )


def scan_state_from_numpy(tree, device="cpu") -> ScanVOState:
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
