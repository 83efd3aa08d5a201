"""Per-frame front end: RGB-D -> pyramid of gray / depth / edges / edge
clouds, and keyframes (counterpart of revo_tpu/frontend.py).

``build_frame`` mirrors the ImgPyramidRGBD constructor
(imgpyramidrgbd.cpp:43-96): per level Canny edges (one fused K1 + K2 launch), BMVC17
fill-in when patch occupancy is low, and back-projection of edge pixels with
valid depth into a fixed-capacity cloud (``ops.backproject.backproject_edges``,
one ``revo_edge_cloud`` call a level on the card); levels > 0 come from
pyrDown gray and hole-aware depth subsampling (``ops.filters.pyramid``,
one ``revo_pyramid`` launch for two steps, which also converts the
sensor's level 0).  ``make_keyframe`` adds the per-level DT structures and
the quad tables of ``OptimizerConfig.quad_form`` the solver samples
(``ops.edt.keyframe_tables``: on the card one ``revo_edt_columns_levels``
launch for every level, then one ``revo_keyframe_rows`` a level, and no
host read).
Outputs live on the device of the inputs; the plain versions run on the
CPU.

Both run B sequences' frames at once (``build_frame_batched``,
``make_keyframe_batched``: a leading lane axis on every tensor of the
Frame / Keyframe, one Canny launch per level for all lanes), what the JAX
package gets from ``vmap``; each lane's bits are those it gets alone, and
``build_frame`` / ``make_keyframe`` are the B = 1 case; ``lanes`` moves
NamedTuples of tensors between the two forms.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.lanes import add_lane_axis, lane
from revo_tpu_torch.ops.backproject import EdgeCloud, backproject_edges
from revo_tpu_torch.ops.canny import canny_batched
from revo_tpu_torch.ops.edge_hist import fill_in_edges, patch_histogram
from revo_tpu_torch.ops.edt import keyframe_tables
from revo_tpu_torch.ops.filters import gaussian_blur, pyramid
from revo_tpu_torch.ops.undistort import remap_bilinear
from revo_tpu_torch.utils import trace


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
    quads: Tuple[torch.Tensor, ...]  # per level (H*W, C) taps, ``ops.edt.keyframe_tables``
    frame: Frame
    T_w_k: torch.Tensor  # (4, 4) keyframe-to-world


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """OpenCV BGR(A)2GRAY weights (imgpyramidrgbd.cpp:53) on RGB channel
    order: Y = 0.299 R + 0.587 G + 0.114 B, rounded to uint8 levels."""
    r, g, b = (rgb[..., c].to(torch.float32) for c in range(3))
    return torch.round(0.299 * r + 0.587 * g + 0.114 * b)


def edge_levels(gray: torch.Tensor, depth: torch.Tensor, cfg: SystemConfig,
                undistort_maps=None):
    """The pyramid's edge maps, level by level from full resolution: yields
    (gray, depth, edges_orig, edges) per level, edges after fill-in.  Images
    are (..., H, W), lanes on the leading axes; Canny takes them all in one
    launch per level.

    Takes uint8 or float32 gray, and uint16 raw depth (scaled by
    1 / depth_scale_factor, iowrapperRGBD.cpp:326-327) or float32 metres;
    conversion happens on the device.  ``undistort_maps``: (map_u, map_v)
    tensors from ``ops.undistort.build_undistort_maps``; gray and depth are
    then rectified first, cv::remap CV_INTER_LINEAR on both like the
    reference (imgpyramidrgbd.cpp:57-65), gray rounded back to uint8 levels."""
    inv_scale = 1.0 / cfg.dataset.depth_scale_factor
    if gray.dtype not in (torch.uint8, torch.float32):
        gray = gray.to(torch.float32)
    if depth.dtype not in (torch.uint16, torch.float32):
        depth = depth.to(torch.float32)
    if undistort_maps is not None:
        map_u, map_v = undistort_maps
        g = gray.to(torch.float32)
        d = depth.to(torch.float32) * inv_scale if depth.dtype == torch.uint16 else depth
        gray = torch.round(remap_bilinear(g, map_u, map_v))
        depth = remap_bilinear(d, map_u, map_v)
    # The whole pyramid first, from the sensor's uint8 gray and uint16 depth
    # as given (``pyramid`` converts level 0 as above) or a rectified
    # frame's float32 levels.
    pyr = cfg.pyramid
    lead, (h, w) = gray.shape[:-2], gray.shape[-2:]
    levels = pyramid(gray.reshape(-1, h, w), depth.reshape(-1, h, w), inv_scale, pyr.n_levels)
    prev_edges = None
    for lvl, (g, d) in enumerate(levels):
        g, d = g.reshape(*lead, *g.shape[-2:]), d.reshape(*lead, *d.shape[-2:])
        if pyr.gaussian_before_canny:
            canny_in = gaussian_blur(g)
        else:  # a uint8 level 0 goes to Canny as it is, uncast
            canny_in = gray if lvl == 0 and gray.dtype == torch.uint8 else g
        h, w = canny_in.shape[-2:]
        edges = canny_batched(
            canny_in.reshape(-1, h, w), pyr.canny_threshold1, pyr.canny_threshold2
        ).reshape(canny_in.shape)
        edges_orig = edges
        patch = pyr.dist_patch_sizes[lvl]
        counts, occupancy = patch_histogram(edges, patch)
        if pyr.use_edge_hist and lvl > 0:
            filled = fill_in_edges(
                edges, prev_edges, counts, patch, pyr.dist_patch_sizes[lvl - 1]
            )
            sparse = occupancy < torch.full_like(occupancy, pyr.n_percentage)
            edges = torch.where(sparse[..., None, None], filled, edges)
        yield g, d, edges_orig, edges
        prev_edges = edges


def build_frame_batched(gray: torch.Tensor, depth: torch.Tensor, cfg: SystemConfig,
                        undistort_maps=None) -> Frame:
    """Full pyramids of B frames from (B, H, W) full-resolution gray and
    depth, on their device (input dtypes and ``undistort_maps`` as
    ``edge_levels`` takes them): a Frame with a leading lane axis on every
    tensor.  Traced as ``frontend.build`` (``utils.trace``)."""
    pyr = cfg.pyramid
    cams = cfg.camera_pyramid()
    levels = []
    with trace.span("frontend.build"):
        for lvl, (g, d, edges_orig, edges) in enumerate(
                edge_levels(gray, depth, cfg, undistort_maps)):
            cam = cams[lvl]
            cloud = backproject_edges(
                edges, d, cam.fx, cam.fy, cam.cx, cam.cy,
                pyr.depth_min, pyr.depth_max, pyr.edge_capacity[lvl],
            )
            levels.append(
                FrameLevel(gray=g, depth=d, edges=edges, edges_orig=edges_orig, cloud=cloud)
            )
        return Frame(levels=tuple(levels),
                     timestamp=torch.zeros(gray.shape[:1], device=gray.device))


def build_frame(gray: torch.Tensor, depth: torch.Tensor, cfg: SystemConfig,
                undistort_maps=None) -> Frame:
    """``build_frame_batched`` of one (H, W) frame."""
    return lane(build_frame_batched(gray[None], depth[None], cfg, undistort_maps), 0)


def make_keyframe_batched(frame: Frame, T_w_k: torch.Tensor, cfg: SystemConfig) -> Keyframe:
    """Keyframes of a batched Frame with world poses T_w_k (B, 4, 4); traced
    as ``keyframe.make``."""
    with trace.span("keyframe.make"):
        tables = keyframe_tables([lv.edges for lv in frame.levels],
                                 cfg.tracker.optimizer.quad_form)
    return Keyframe(structs=tuple(s for s, _ in tables), quads=tuple(q for _, q in tables),
                    frame=frame, T_w_k=T_w_k)


def make_keyframe(frame: Frame, T_w_k: torch.Tensor, cfg: SystemConfig) -> Keyframe:
    """``make_keyframe_batched`` of one frame."""
    kf = make_keyframe_batched(add_lane_axis(frame), T_w_k[None], cfg)
    return lane(kf, 0)._replace(frame=frame)


def generate_colored_pcl(frame: Frame, cfg: SystemConfig, lvl: int = 0, dense: bool = False,
                         rgb01=None):
    """Colored point cloud (XYZ + RGB in [0, 1]) for export.

    Mirrors ImgPyramidRGBD::generateColoredPcl (imgpyramidrgbd.cpp:279-327):
    dense (all valid-depth pixels) or edge-sparse.  Colors come from
    ``rgb01`` (H, W, 3) if given, else the gray level is replicated.
    Returns (points (M, 3), colors (M, 3)) as numpy arrays (the export path
    is the host's; M depends on the data).  Needs the level's images: a
    keyframe stored with ``TrackerConfig.store_kf_images``."""
    lv = frame.levels[lvl]
    cam = cfg.camera_pyramid()[lvl]
    depth = lv.depth.detach().cpu().numpy()
    gray = lv.gray.detach().cpu().numpy()
    ok = np.isfinite(depth) & (depth > cfg.pyramid.depth_min) & (depth < cfg.pyramid.depth_max)
    if not dense:
        ok &= lv.edges.detach().cpu().numpy()
    ys, xs = np.nonzero(ok)
    z = depth[ys, xs]
    pts = np.stack(
        [z * (xs - cam.cx) / cam.fx, z * (ys - cam.cy) / cam.fy, z], axis=-1
    ).astype(np.float32)
    if rgb01 is not None:
        clr = np.asarray(rgb01)[ys, xs].astype(np.float32)
    else:
        g01 = (gray[ys, xs] / 255.0).astype(np.float32)
        clr = np.stack([g01, g01, g01], axis=-1)
    return pts, clr


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
