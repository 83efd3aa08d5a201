"""Lane-axis helpers: NamedTuples (or tuples) of tensors moved between one
sequence's form and the batched form, a leading lane axis on every tensor
(what the JAX package gets from ``vmap``'s in_axes / out_axes)."""
from __future__ import annotations

import torch


def stack_lanes(trees):
    """Stack NamedTuples (or tuples) of tensors lane by lane: the same
    structure with a leading lane axis on every tensor (None stays None; one
    lane is a view)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(trees) if len(trees) > 1 else first[None]
    fields = [stack_lanes([t[i] for t in trees]) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def lane(tree, i: int):
    """Lane ``i`` of a NamedTuple (or tuple) of tensors with a leading lane
    axis: views, no copies."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[i]
    fields = [lane(x, i) for x in tree]
    return type(tree)(*fields) if hasattr(tree, "_fields") else tuple(fields)


def add_lane_axis(tree, b: int = 1):
    """One lane's NamedTuple of tensors as a batch of ``b`` lanes that all
    share it: a stride-0 leading axis on every tensor, no copies."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[None].expand(b, *tree.shape)
    fields = [add_lane_axis(x, b) for x in tree]
    return type(tree)(*fields) if hasattr(tree, "_fields") else tuple(fields)
