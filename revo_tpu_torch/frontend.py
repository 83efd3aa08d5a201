"""Per-frame front end: RGB-D -> pyramid of gray / depth / edges / edge
clouds, and keyframes (counterpart of revo_tpu/frontend.py).

``build_frame`` mirrors the ImgPyramidRGBD constructor
(imgpyramidrgbd.cpp:43-96): per level Canny edges (kernels K1 + K2), BMVC17
fill-in when patch occupancy is low, and back-projection of edge pixels with
valid depth into a fixed-capacity cloud; levels > 0 come from pyrDown gray
and hole-aware depth subsampling.  ``make_keyframe`` adds the per-level DT
structures and dt-only quad tables the solver samples.  Outputs live on the
device of the inputs.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.ops.backproject import EdgeCloud, backproject_edges
from revo_tpu_torch.ops.canny import canny
from revo_tpu_torch.ops.depth import subsample_depth_with_holes
from revo_tpu_torch.ops.edge_hist import fill_in_edges, patch_histogram
from revo_tpu_torch.ops.edt import keyframe_structure, quad_structure
from revo_tpu_torch.ops.filters import gaussian_blur, pyr_down


class FrameLevel(NamedTuple):
    """Per-pyramid-level data of one frame."""

    gray: torch.Tensor  # (H, W) float32, uint8-valued
    depth: torch.Tensor  # (H, W) float32 metres, 0 = invalid
    edges: torch.Tensor  # (H, W) bool, after fill-in
    edges_orig: torch.Tensor  # (H, W) bool, before fill-in
    cloud: EdgeCloud


class Frame(NamedTuple):
    levels: Tuple[FrameLevel, ...]
    timestamp: torch.Tensor  # () float32 placeholder; the host keeps times


class Keyframe(NamedTuple):
    """Frame + per-level DT structures and quad tables + world pose
    (makeKeyframe, imgpyramidrgbd.cpp:231-252)."""

    structs: Tuple[torch.Tensor, ...]  # per level (H, W, 3): (gx, gy, dt)
    quads: Tuple[torch.Tensor, ...]  # per level (H*W, 4) dt taps
    frame: Frame
    T_w_k: torch.Tensor  # (4, 4) keyframe-to-world


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """OpenCV BGR(A)2GRAY weights (imgpyramidrgbd.cpp:53) on RGB channel
    order: Y = 0.299 R + 0.587 G + 0.114 B, rounded to uint8 levels."""
    r, g, b = (rgb[..., c].to(torch.float32) for c in range(3))
    return torch.round(0.299 * r + 0.587 * g + 0.114 * b)


def edge_levels(gray: torch.Tensor, depth: torch.Tensor, cfg: SystemConfig):
    """The pyramid's edge maps, level by level from full resolution: yields
    (gray, depth, edges_orig, edges) per level, edges after fill-in.

    Takes uint8 or float32 gray, and uint16 raw depth (scaled by
    1 / depth_scale_factor, iowrapperRGBD.cpp:326-327) or float32 metres;
    conversion happens on the device."""
    if cfg.pyramid.undistort:
        raise NotImplementedError(
            "undistortion (PyramidConfig.undistort) is not ported yet: ROADMAP P11"
        )
    g = gray.to(torch.float32)
    if depth.dtype == torch.uint16:
        d = depth.to(torch.float32) * (1.0 / cfg.dataset.depth_scale_factor)
    else:
        d = depth.to(torch.float32)
    pyr = cfg.pyramid
    prev_edges = None
    for lvl in range(pyr.n_levels):
        canny_in = gaussian_blur(g) if pyr.gaussian_before_canny else g
        edges = canny(canny_in, pyr.canny_threshold1, pyr.canny_threshold2)
        edges_orig = edges
        patch = pyr.dist_patch_sizes[lvl]
        counts, occupancy = patch_histogram(edges, patch)
        if pyr.use_edge_hist and lvl > 0:
            filled = fill_in_edges(
                edges, prev_edges, counts, patch, pyr.dist_patch_sizes[lvl - 1]
            )
            sparse = occupancy < torch.full_like(occupancy, pyr.n_percentage)
            edges = torch.where(sparse, filled, edges)
        yield g, d, edges_orig, edges
        prev_edges = edges
        if lvl + 1 < pyr.n_levels:
            g = pyr_down(g)
            d = subsample_depth_with_holes(d)


def build_frame(gray: torch.Tensor, depth: torch.Tensor, cfg: SystemConfig) -> Frame:
    """Full pyramid from full-resolution gray and depth, on their device
    (input dtypes as ``edge_levels`` takes them)."""
    pyr = cfg.pyramid
    cams = cfg.camera_pyramid()
    levels = []
    for lvl, (g, d, edges_orig, edges) in enumerate(edge_levels(gray, depth, cfg)):
        cam = cams[lvl]
        cloud = backproject_edges(
            edges, d, cam.fx, cam.fy, cam.cx, cam.cy,
            pyr.depth_min, pyr.depth_max, pyr.edge_capacity[lvl],
        )
        levels.append(
            FrameLevel(gray=g, depth=d, edges=edges, edges_orig=edges_orig, cloud=cloud)
        )
    return Frame(levels=tuple(levels), timestamp=torch.zeros((), device=gray.device))


def make_keyframe(frame: Frame, T_w_k: torch.Tensor, cfg: SystemConfig) -> Keyframe:
    structs = tuple(keyframe_structure(lv.edges) for lv in frame.levels)
    quads = tuple(
        quad_structure(s, cfg.tracker.optimizer.quad_form) for s in structs
    )
    return Keyframe(structs=structs, quads=quads, frame=frame, T_w_k=T_w_k)


def prune_keyframe(kf: Keyframe) -> Keyframe:
    """Shrink a keyframe for retention: the per-level gray / depth / edge
    images, which tracking never reads from a stored keyframe, become (1, 1)
    placeholders; structs, quads, clouds and the pose stay
    (revo_tpu/frontend.py::prune_keyframe, prepareKfForStorage in
    imgpyramidrgbd.h:156-169)."""
    levels = tuple(
        lv._replace(
            gray=lv.gray.new_zeros((1, 1)),
            depth=lv.depth.new_zeros((1, 1)),
            edges=lv.edges.new_zeros((1, 1)),
            edges_orig=lv.edges_orig.new_zeros((1, 1)),
        )
        for lv in kf.frame.levels
    )
    return kf._replace(frame=kf.frame._replace(levels=levels))
