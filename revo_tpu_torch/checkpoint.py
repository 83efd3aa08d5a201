"""Checkpoint / resume for VO runs (counterpart of revo_tpu/checkpoint.py).

The reference has no in-process checkpointing, only durable outputs (pose
file, PLY).  A checkpoint here holds what tracking needs to resume
mid-sequence: the pose graph as arrays, the current keyframe's structures,
the past-frame and voting rings and the motion prior (``VOCheckpoint``, for
``system.VOSystem``), or the whole carried state of ``vo_scan``
(``save_scan_state`` / ``load_scan_state``).

Both are ``.npz`` files with the JAX package's key names, so a checkpoint
written by either package loads in the other.  A scan state stores every
leaf of the ``ScanVOState`` tuple tree under its path in JAX's
``jax.tree_util.keystr`` form: ``.name`` for a NamedTuple field, ``[i]`` for
a tuple item, joined from the root, e.g. ``.kf.frame.levels[0].cloud.points``
or ``.past.n``; a field that is ``None`` (``kf_ring`` without
``scan_relocalization``) has no key.  The port's host-side counts and flags
(``n``, ``n_keyframes``, ``just_added_kf``) are stored as the int32 / bool
scalars JAX keeps there.  Each quad table is written in the JAX package's
layout for the config's ``quad_form`` ("hw12", "t" and "flat16" differ
from the port's rows); npz has no bfloat16, so the bfloat16 tables
("dt4bf", "flatbf") are written as their uint16 bits, as the JAX package
writes them; on load every quad table is rebuilt from the structures.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from revo_tpu_torch.frontend import Keyframe
from revo_tpu_torch.ops.edt import quad_structure
from revo_tpu_torch.tracker import PastFrames


@dataclasses.dataclass
class VOCheckpoint:
    """Serializable VO state snapshot (host numpy)."""

    # Pose graph as arrays (suitable for optimize_pose_graph).
    T_kf_curr: np.ndarray  # (N, 4, 4)
    T_w_kf: np.ndarray  # (N, 4, 4)
    timestamps: np.ndarray  # (N,)
    is_keyframe: np.ndarray  # (N,) bool
    # Tracker state.
    kf_structs: list  # per level (H, W, 3)
    kf_T_w: np.ndarray  # (4, 4)
    past_points: np.ndarray  # (K, P, 3) rolling ring
    past_valid: np.ndarray  # (K, P)
    past_poses: np.ndarray  # (K, 4, 4)
    past_n: int
    voting_points: np.ndarray  # (K, P, 3) frozen voting set
    voting_valid: np.ndarray  # (K, P)
    voting_poses: np.ndarray  # (K, 4, 4)
    voting_n: int
    R: np.ndarray  # (3, 3) current init guess
    t: np.ndarray  # (3,)
    T_nm1_n: np.ndarray  # (4, 4)
    just_added_kf: bool
    n_frames: int
    n_keyframes: int


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def capture(vo) -> VOCheckpoint:
    """Snapshot a system.VOSystem (device tensors pulled to the host)."""
    pg = vo.pose_graph
    empty = np.zeros((0, 4, 4), np.float32)
    return VOCheckpoint(
        T_kf_curr=np.stack([n.T_kf_curr for n in pg]) if pg else empty,
        T_w_kf=np.stack([n.T_w_kf for n in pg]) if pg else empty,
        timestamps=np.array([n.timestamp for n in pg]),
        is_keyframe=np.array([n.is_keyframe for n in pg], bool),
        kf_structs=[_np(s) for s in vo.kf.structs] if vo.kf is not None else [],
        kf_T_w=_np(vo.kf.T_w_k) if vo.kf is not None else np.eye(4, dtype=np.float32),
        past_points=_np(vo.past.points),
        past_valid=_np(vo.past.valid),
        past_poses=_np(vo.past.poses),
        past_n=int(vo.past.n),
        voting_points=_np(vo.past_voting.points),
        voting_valid=_np(vo.past_voting.valid),
        voting_poses=_np(vo.past_voting.poses),
        voting_n=int(vo.past_voting.n),
        R=_np(vo.R),
        t=_np(vo.t),
        T_nm1_n=np.asarray(vo.T_nm1_n),
        just_added_kf=vo.just_added_kf,
        n_frames=vo.n_frames,
        n_keyframes=vo.n_keyframes,
    )


_ARRAY_KEYS = (
    "T_kf_curr", "T_w_kf", "timestamps", "is_keyframe", "kf_T_w",
    "past_points", "past_valid", "past_poses",
    "voting_points", "voting_valid", "voting_poses", "R", "t", "T_nm1_n",
)


def save(path: str, ckpt: VOCheckpoint) -> None:
    """Write the checkpoint as a compressed npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {key: getattr(ckpt, key) for key in _ARRAY_KEYS}
    arrays["scalars"] = np.array([
        ckpt.past_n, ckpt.voting_n, int(ckpt.just_added_kf), ckpt.n_frames,
        ckpt.n_keyframes, len(ckpt.kf_structs),
    ])
    for i, s in enumerate(ckpt.kf_structs):
        arrays[f"kf_struct_{i}"] = s
    np.savez_compressed(path, **arrays)


def load(path: str) -> VOCheckpoint:
    z = np.load(path)
    past_n, voting_n, just_added, n_frames, n_keyframes, n_structs = z["scalars"]
    return VOCheckpoint(
        **{key: z[key] for key in _ARRAY_KEYS},
        kf_structs=[z[f"kf_struct_{i}"] for i in range(int(n_structs))],
        past_n=int(past_n),
        voting_n=int(voting_n),
        just_added_kf=bool(just_added),
        n_frames=int(n_frames),
        n_keyframes=int(n_keyframes),
    )


def restore(vo, ckpt: VOCheckpoint, frame_for_kf=None) -> None:
    """Restore a VOSystem from a checkpoint, on the system's device.

    The keyframe's structures are restored exactly and its quad tables are
    rebuilt from them; the keyframe's embedded Frame (only needed for a
    later promotion of that same frame, which cannot happen again) and the
    promotion candidate ``prev_frame`` are ``frame_for_kf``.  As in the JAX
    package, the retained-keyframe history and the relocalization ring are
    not part of a checkpoint: they refill from the next promotion on."""
    from revo_tpu_torch.system import PoseNode

    def dev(a):
        return torch.from_numpy(np.array(a)).to(vo.device)

    vo.pose_graph = [
        PoseNode(
            T_kf_curr=ckpt.T_kf_curr[i], T_w_kf=ckpt.T_w_kf[i],
            timestamp=float(ckpt.timestamps[i]), is_keyframe=bool(ckpt.is_keyframe[i]),
        )
        for i in range(len(ckpt.timestamps))
    ]
    structs = tuple(dev(s) for s in ckpt.kf_structs)
    vo.kf = Keyframe(
        structs=structs,
        quads=tuple(quad_structure(s, vo.cfg.tracker.optimizer.quad_form) for s in structs),
        frame=frame_for_kf,
        T_w_k=dev(ckpt.kf_T_w),
    )
    vo.past = PastFrames(
        points=dev(ckpt.past_points), valid=dev(ckpt.past_valid),
        poses=dev(ckpt.past_poses), n=int(ckpt.past_n),
    )
    vo.past_voting = PastFrames(
        points=dev(ckpt.voting_points), valid=dev(ckpt.voting_valid),
        poses=dev(ckpt.voting_poses), n=int(ckpt.voting_n),
    )
    vo.R = dev(ckpt.R)
    vo.t = dev(ckpt.t)
    vo.T_nm1_n = np.array(ckpt.T_nm1_n)
    vo.just_added_kf = bool(ckpt.just_added_kf)
    vo.n_frames = int(ckpt.n_frames)
    vo.n_keyframes = int(ckpt.n_keyframes)
    vo.prev_frame = frame_for_kf


# -- scan state ------------------------------------------------------------------


def _flatten(tree, prefix: str = ""):
    """(key, leaf) pairs of a tree of NamedTuples and tuples in field order,
    keyed as ``jax.tree_util.keystr`` keys them; ``None`` has no leaves."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        out = []
        for i, item in enumerate(tree):
            out += _flatten(item, f"{prefix}.{names[i]}" if names else f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _rebuild(template, leaves):
    """``template`` with its leaves replaced, in ``_flatten`` order, by the
    next items of the iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, tuple):
        items = [_rebuild(item, leaves) for item in template]
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    return next(leaves)


def _leaf_to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:  # raw bits, as the JAX package stores them
            return v.detach().contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
        return v.detach().cpu().numpy()
    if isinstance(v, bool):
        return np.asarray(v, np.bool_)
    return np.asarray(v, np.int32)


def quad_to_jax_layout(rows: np.ndarray, struct_shape, quad_form: str) -> np.ndarray:
    """The port's quad rows (..., H*W, C) of ``quad_form`` in the JAX
    package's layout (``revo_tpu.ops.edt.quad_structure``), given the shape
    (..., H, W, 3) of the structure they were built from: "hw12" becomes
    (..., H, W, 12), "t" (..., 12, H*W) and "flat16" (..., H*W, 16) with a
    zero pad lane after each tap's three components; "flat", "flatbf",
    "dt4" and "dt4bf" are the JAX layout already.  The inverse of
    ``convert.quad_from_numpy``; the dtype (uint16 bits for the bfloat16
    forms) is kept."""
    lead, (h, w) = tuple(struct_shape[:-3]), tuple(struct_shape[-3:-1])
    if quad_form == "hw12":
        return rows.reshape(*lead, h, w, 12)
    if quad_form == "t":
        return np.ascontiguousarray(np.swapaxes(rows, -1, -2))
    if quad_form == "flat16":
        taps = rows.reshape(*lead, h * w, 4, 3)
        return np.concatenate([taps, np.zeros_like(taps[..., :1])], -1).reshape(*lead, h * w, 16)
    return rows


def save_scan_state(path: str, state, quad_form: str) -> None:
    """Checkpoint a scan state (parallel.batch.ScanVOState) captured under a
    config whose ``tracker.optimizer.quad_form`` is ``quad_form``: every
    leaf under its tree path, so that restoring checks the structure
    against a template built from the config, and each quad table in the
    JAX package's layout for that form (``quad_to_jax_layout``), so that
    ``revo_tpu.checkpoint.load_scan_state`` takes the file too."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = dict(_flatten(state))
    arrays = {}
    for key, v in leaves.items():
        a = _leaf_to_numpy(v)
        if ".quads[" in key:
            struct = leaves[key.replace(".quads[", ".structs[")]
            a = quad_to_jax_layout(a, tuple(struct.shape), quad_form)
        arrays[key] = a
    np.savez_compressed(path, **arrays)


def load_scan_state(path: str, cfg, device="cuda"):
    """Restore a ScanVOState saved by ``save_scan_state`` (of either
    package) onto ``device``.  The structure comes from
    ``scan_state_template(cfg)``: the config must be the one the state was
    captured under (same shapes, same ``scan_relocalization``); a missing
    leaf raises KeyError and a shape mismatch ValueError.  The quad tables
    are rebuilt from the stored structures with the config's ``quad_form``
    (revo_tpu/checkpoint.py:228 rebuilds them so), which also maps the JAX
    package's storage layouts ("hw12", "t", "flat16") onto the port's."""
    from revo_tpu_torch.parallel.batch import scan_state_template

    template = scan_state_template(cfg, device)
    z = np.load(path)
    leaves = []
    for key, tmpl in _flatten(template):
        if key not in z:
            raise KeyError(f"checkpoint {path} missing leaf {key}: config mismatch?")
        if ".quads[" in key:  # rebuilt from the structures below
            leaves.append(None)
            continue
        arr = z[key]
        if not isinstance(tmpl, torch.Tensor):
            if arr.shape != ():
                raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} != ()")
            leaves.append(type(tmpl)(arr))
            continue
        if arr.shape != tuple(tmpl.shape):
            raise ValueError(
                f"leaf {key}: checkpoint shape {arr.shape} != config shape {tuple(tmpl.shape)}"
            )
        leaves.append(torch.from_numpy(np.array(arr)).to(tmpl.dtype).to(device))
    state = _rebuild(template, iter(leaves))
    form = cfg.tracker.optimizer.quad_form

    def tables(holder):  # a Keyframe or KeyframeRing
        return holder._replace(quads=tuple(quad_structure(s, form) for s in holder.structs))

    state = state._replace(kf=tables(state.kf))
    if state.kf_ring is not None:
        state = state._replace(kf_ring=tables(state.kf_ring))
    return state
