"""Seeded inputs of the residual pass for the port's tests: a dt quad table,
an edge cloud back-projected from integer pixels, and a pose, at 160x120
unless a camera is given.  Imports no jax, so the tests that run where the
card is can use it.
"""
import numpy as np
import torch

from revo_tpu_torch import lie
from revo_tpu_torch.config import CameraConfig
from revo_tpu_torch.ops.backproject import EdgeCloud

CAM = dict(fx=150.0, fy=152.5, cx=79.5, cy=60.25, width=160, height=120)
EDGE_DISTANCE, HUBER = 6.0, 0.3


def make_inputs(seed: int, p: int, quad_form: str, cam=None):
    """(quad (H*W, 4) float32 holding the table's values, points (P, 3),
    valid (P,)) from a seed; "dt4bf" values are rounded to bfloat16."""
    cam = cam or CAM
    rng = np.random.default_rng(seed)
    h, w = cam["height"], cam["width"]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dt = (9.0 * np.abs(np.sin(xx / 9.0 + seed) * np.cos(yy / 7.0))
          + rng.uniform(0, 0.5, (h, w))).astype(np.float32)
    dt[rng.random((h, w)) < 0.02] = 0.0  # on-edge pixels: r == 0 taps
    pad = np.pad(dt, ((0, 1), (0, 1)), mode="edge")
    quad = np.stack([pad[:-1, :-1], pad[:-1, 1:], pad[1:, :-1], pad[1:, 1:]], -1).reshape(-1, 4)
    if quad_form == "dt4bf":
        quad = torch.from_numpy(quad).to(torch.bfloat16).float().numpy()
    # Points over integer pixels of the whole image (borders included), as
    # backproject_edges forms them.
    px = rng.integers(0, w, p).astype(np.float32)
    py = rng.integers(0, h, p).astype(np.float32)
    z = rng.uniform(0.5, 4.0, p).astype(np.float32)
    inv_fx, inv_fy = np.float32(1.0) / np.float32(cam["fx"]), np.float32(1.0) / np.float32(cam["fy"])
    pts = np.stack([z * (px - np.float32(cam["cx"])) * inv_fx,
                    z * (py - np.float32(cam["cy"])) * inv_fy, z], -1).astype(np.float32)
    valid = rng.random(p) < 0.9
    pts[~valid] = 0.0
    return quad, pts, valid


def make_pose(kind: str):
    """"identity", "tracked" (a small motion) or "out" (a motion that throws
    most points out of the image)."""
    if kind == "identity":
        return np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    xi = np.array([0.012, -0.007, 0.02, 0.004, -0.009, 0.006], np.float32)
    if kind == "out":
        xi = np.array([0.9, -0.3, 0.1, 0.03, 0.4, -0.08], np.float32)
    R, t = lie.exp_se3(torch.from_numpy(xi))
    return R.numpy(), t.numpy()


def torch_args(quad, pts, valid, R, t, quad_form, device="cpu", cam=None):
    q = torch.from_numpy(quad)
    if quad_form == "dt4bf":
        q = q.to(torch.bfloat16)
    cloud = EdgeCloud(
        points=torch.from_numpy(pts).to(device), valid=torch.from_numpy(valid).to(device),
        count=torch.tensor(int(valid.sum()), dtype=torch.int32, device=device))
    return (q.to(device), cloud, CameraConfig(**(cam or CAM)), torch.from_numpy(R).to(device),
            torch.from_numpy(t).to(device), EDGE_DISTANCE, HUBER, True)


def small_config():
    """The port's twin of tests/test_solver.py::small_cfg (160x120, 3
    levels, capacities (4096, 2048, 1024)) for callers that may not import
    jax; tests/test_torch_distributed.py holds it equal to the converted
    JAX config."""
    import dataclasses

    from revo_tpu_torch.config import SystemConfig

    cfg = SystemConfig()
    return dataclasses.replace(
        cfg,
        camera=CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120),
        pyramid=dataclasses.replace(cfg.pyramid, pyr_min_lvl=2, pyr_max_lvl=0,
                                    edge_capacity=(4096, 2048, 1024),
                                    dist_patch_sizes=(20, 10, 5)),
    )
