"""BMVC17 edge-histogram fill-in (counterpart of revo_tpu/ops/edge_hist.py).

A per-patch edge-count map decides whether a coarse pyramid level is too
sparsely covered; if so, edges of the finer parent level are copied down into
its empty patches (generateDistHistogram / fillInEdges,
imgpyramidrgbd.cpp:111-172).  Counts are int32, not the reference's wrapping
uint8, as in the JAX module.

``fill_in_levels`` fills levels 1 .. L-1 of a pyramid, each from the level
above it after its own fill-in, as JAX's build_frame runs the fill-in
(revo_tpu/frontend.py:99-110); level 0's histogram, which nothing reads, is
not computed.  Its plain version ``fill_in_levels_ref`` chains
``patch_histogram``, ``fill_in_edges`` and the ``where`` on occupancy level
by level and takes CPU tensors; CUDA tensors take the hand kernel
``revo_fill_levels`` (csrc/frontend.cu: every level of every lane in one
launch, a thread-block cluster a lane whose blocks count their bin rows in
shared memory and trade the bit map of sparse patches over DSMEM; no
per-pixel scratch, no host read), counted in ``fill_in_levels.launches``.
"""
from __future__ import annotations

import torch

from revo_tpu_torch import kernels

FILL_MAX_LEVELS = 8  # levels a launch of revo_fill_levels, the parent included (csrc/frontend.cu)
FILL_BITS_SHARED = 163840  # bytes of two levels' bit maps a block keeps in shared memory


def patch_histogram(edges: torch.Tensor, patch_size: int):
    """(counts (..., Hp, Wp) int32, occupancy (...) float32): edge count
    per patch_size^2 patch and the fraction of patches holding an edge, for
    (..., H, W) edges (lanes on the leading axes).  The image is truncated
    to whole patches.  The fraction is the count of patches over their
    number, rounded once (the mean of the CPU and of JAX) on every device."""
    h, w = edges.shape[-2:]
    hp, wp = h // patch_size, w // patch_size
    e = (edges[..., : hp * patch_size, : wp * patch_size] > 0).to(torch.int32)
    counts = e.reshape(*edges.shape[:-2], hp, patch_size, wp, patch_size).sum(dim=(-3, -1))
    counts = counts.to(torch.int32)
    held = (counts > 0).sum(dim=(-2, -1), dtype=torch.int32).to(torch.float32)
    occupancy = held / held.new_full((), float(hp * wp))
    return counts, occupancy


def fill_in_edges(
    edges: torch.Tensor,
    parent_edges: torch.Tensor,
    counts: torch.Tensor,
    patch_size: int,
    parent_patch_size: int,
) -> torch.Tensor:
    """Child pixel (y, x) takes parent pixel (2y+1, 2x+1) when it is in
    range and the count bin min((2y+1)//parent_patch, n-1) (per axis) is
    below patch_size^2 * 0.05 (imgpyramidrgbd.cpp:130-140).  Lanes on the
    leading axes of all three maps."""
    h, w = edges.shape[-2:]
    ph, pw = parent_edges.shape[-2:]
    dev = edges.device
    thresh = patch_size * patch_size * 0.05

    ys = 2 * torch.arange(h, device=dev) + 1
    xs = 2 * torch.arange(w, device=dev) + 1
    par = parent_edges[..., ys.clamp(max=ph - 1), :][..., xs.clamp(max=pw - 1)] > 0
    par = par & (ys < ph)[:, None] & (xs < pw)[None, :]

    hc, wc = counts.shape[-2:]
    by = torch.clamp(ys // parent_patch_size, max=hc - 1)
    bx = torch.clamp(xs // parent_patch_size, max=wc - 1)
    sparse = (counts < thresh)[..., by, :][..., bx]
    return edges | (sparse & par)


def fill_in_levels_ref(levels, patch_sizes, n_percentage: float):
    """The plain version of ``fill_in_levels``: ``patch_histogram``,
    ``fill_in_edges`` and the ``where`` on occupancy, level by level."""
    out, flags = [], []
    parent = levels[0]
    for lvl in range(1, len(levels)):
        edges, patch = levels[lvl], patch_sizes[lvl]
        counts, occupancy = patch_histogram(edges, patch)
        sparse = occupancy < torch.full_like(occupancy, n_percentage)
        if counts.shape[-2] and counts.shape[-1]:  # else occupancy is NaN: nothing is filled
            filled = fill_in_edges(edges, parent, counts, patch, patch_sizes[lvl - 1])
            edges = torch.where(sparse[..., None, None], filled, edges)
        out.append(edges)
        flags.append(sparse)
        parent = edges
    return out, torch.stack(flags, -1)


def fill_in_levels(levels, patch_sizes, n_percentage: float):
    """Levels 1 .. L-1 of a pyramid's (..., H_l, W_l) bool Canny edges after
    the BMVC17 fill-in, and the flags (..., L-1) of the levels filled (the
    occupancy of whole ``patch_sizes[l]`` patches below ``n_percentage``);
    level l takes parent pixels from level l-1 after its fill-in, level 1
    from ``levels[0]`` as given.  Bit-equal to ``fill_in_levels_ref``.  CUDA
    tensors: ``revo_fill_levels``, one launch for every lane and up to
    FILL_MAX_LEVELS - 1 levels (the levels in one allocation)."""
    levels = list(levels)
    if len(levels) < 2:
        raise ValueError("fill_in_levels: want level 0 and at least one more")
    if not kernels.on_card("fill_in_levels", *levels):
        return fill_in_levels_ref(levels, patch_sizes, n_percentage)
    lead = levels[0].shape[:-2]
    if any(e.shape[:-2] != lead or e.dtype != torch.bool or not e.is_contiguous()
           or min(e.shape[-2:]) < 1 for e in levels):
        raise ValueError(f"fill_in_levels: want contiguous bool edges on the same lanes, got "
                         f"{[(tuple(e.shape), e.dtype) for e in levels]}")
    flat = [e.reshape(-1, *e.shape[-2:]) for e in levels]
    b, n = flat[0].shape[0], len(flat)
    sizes = [tuple(e.shape[-2:]) for e in flat]
    offsets, at = [], 0
    for h, w in sizes[1:]:  # each level at a multiple of 16 bytes
        offsets.append(at)
        at += -(-b * h * w // 16) * 16
    buf = torch.empty(at, dtype=torch.bool, device=flat[0].device)
    outs = [buf[o:o + b * h * w].view(b, h, w) for o, (h, w) in zip(offsets, sizes[1:])]
    # apart from the levels: the tracer keeps the flags of every traced frame
    flags = torch.empty((b, n - 1), dtype=torch.bool, device=buf.device)
    words = max((h // p) * -(-(w // p) // 32) for (h, w), p in zip(sizes[1:], patch_sizes[1:n]))
    gbits = (torch.empty(b * 2 * words, dtype=torch.int32, device=buf.device)
             if 8 * words > FILL_BITS_SHARED else None)
    for s in range(0, n - 1, FILL_MAX_LEVELS - 1):
        table = []
        for i in range(s, min(s + FILL_MAX_LEVELS, n)):
            src = (flat[0] if i == 0 else outs[i - 1]) if i == s else flat[i]
            table += [src.data_ptr(), 0 if i == s else outs[i - 1].data_ptr(), *sizes[i],
                      patch_sizes[i]]
        kernels.launch("revo_fill_levels", table, len(table) // 5, b, flags[:, s:], n - 1,
                       n_percentage, gbits)
        fill_in_levels.launches += 1
    return ([o.reshape(*lead, *o.shape[-2:]) for o in outs],
            flags.reshape(*lead, n - 1))


fill_in_levels.launches = 0
