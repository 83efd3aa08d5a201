"""BMVC17 edge-histogram fill-in (counterpart of revo_tpu/ops/edge_hist.py).

A per-patch edge-count map decides whether a coarse pyramid level is too
sparsely covered; if so, edges of the finer parent level are copied down into
its empty patches (generateDistHistogram / fillInEdges,
imgpyramidrgbd.cpp:111-172).  Counts are int32, not the reference's wrapping
uint8, as in the JAX module.
"""
from __future__ import annotations

import torch


def patch_histogram(edges: torch.Tensor, patch_size: int):
    """(counts (Hp, Wp) int32, occupancy () float32): edge count per
    patch_size^2 patch and the fraction of patches holding an edge.  The
    image is truncated to whole patches."""
    h, w = edges.shape
    hp, wp = h // patch_size, w // patch_size
    e = (edges[: hp * patch_size, : wp * patch_size] > 0).to(torch.int32)
    counts = e.reshape(hp, patch_size, wp, patch_size).sum(dim=(1, 3))
    counts = counts.to(torch.int32)
    occupancy = (counts > 0).to(torch.float32).mean()
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
    below patch_size^2 * 0.05 (imgpyramidrgbd.cpp:130-140)."""
    h, w = edges.shape
    ph, pw = parent_edges.shape
    dev = edges.device
    thresh = patch_size * patch_size * 0.05

    ys = 2 * torch.arange(h, device=dev) + 1
    xs = 2 * torch.arange(w, device=dev) + 1
    par = parent_edges[ys.clamp(max=ph - 1)][:, xs.clamp(max=pw - 1)] > 0
    par = par & (ys < ph)[:, None] & (xs < pw)[None, :]

    hc, wc = counts.shape
    by = torch.clamp(ys // parent_patch_size, max=hc - 1)
    bx = torch.clamp(xs // parent_patch_size, max=wc - 1)
    sparse = (counts < thresh)[by][:, bx]
    return edges | (sparse & par)
