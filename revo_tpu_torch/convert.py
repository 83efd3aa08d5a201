"""Carry state from the JAX package into the port.

REVO has no weights: its state is the configuration and the keyframe.  These
helpers read JAX-side objects by attribute only, with array leaves already
converted by ``np.asarray``, so this module imports neither jax nor
revo_tpu.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from revo_tpu_torch import config as C
from revo_tpu_torch.frontend import Frame, FrameLevel, Keyframe
from revo_tpu_torch.ops.backproject import EdgeCloud

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
