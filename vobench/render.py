"""The benchmark's own scene, trajectories and renderer: a frozen copy of
the default room of ``revo_tpu_torch/io/synthetic.py`` (textured planes,
aperiodic grid-and-blob texture, landmark discs, raycast depth), written as
torch ops so that a run renders all its frames on the device in a few
calls.  The yardstick owns this copy: a later change to the program's
renderer changes nothing here.

``trajectory`` walks a smooth seeded path whose every step has the same
translation and rotation, so every seed gives the same amount of motion in
another direction.  ``render`` returns what a sensor delivers: uint8 gray
and uint16 raw depth (metres times the configuration's scale factor).
"""
from __future__ import annotations

import numpy as np
import torch

# The default room (synthetic.py ``_default_planes``): normal, offset,
# texture axes, phase, bounds (u_lo, u_hi, v_lo, v_hi) or None.
PLANES = (
    ((0.0, 0.0, 1.0), 3.2, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.0, None),
    ((0.0, 1.0, 0.0), 1.0, (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), 1.3, None),
    ((1.0, 0.0, 0.0), 1.6, (0.0, 1.0, 0.0), (0.0, 0.0, 1.0), 2.1, None),
    ((0.0, 0.0, 1.0), 1.5, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.6, (-0.55, 0.15, -0.05, 0.55)),
    ((0.0, 0.0, 1.0), 1.1, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 3.0, (-0.75, -0.35, -0.45, 0.05)),
)
BACKGROUND = 30.0


def _discs(phase: float):
    """The six landmark discs of a plane (synthetic.py
    ``_add_landmark_discs``): (cu, cv, radius, sign), drawn as it draws them."""
    rng = np.random.default_rng(int(phase * 1000) + 7)
    out = []
    for _ in range(6):
        cu = rng.uniform(-2.0, 2.0)
        cv = rng.uniform(-2.0, 2.0)
        rad = rng.uniform(0.08, 0.2)
        sgn = rng.choice([-1.0, 1.0])
        out.append((cu, cv, rad, float(sgn)))
    return out


def _texture(u: torch.Tensor, v: torch.Tensor, phase: float) -> torch.Tensor:
    """synthetic.py ``_texture``: tanh-sharpened warped sinusoids, blobs,
    fine stripes and landmark discs, clipped to [0, 255]."""
    two_pi = 2.0 * np.pi
    uw = u + 0.13 * torch.sin(0.83 * v + phase) + 0.07 * torch.sin(2.19 * u)
    vw = v + 0.11 * torch.sin(0.71 * u + 1.3 * phase) + 0.06 * torch.sin(2.71 * v)
    g1 = torch.tanh(6.0 * torch.sin(two_pi * uw / 0.50 + phase))
    g2 = torch.tanh(6.0 * torch.sin(two_pi * vw / 0.53 + 0.7 * phase))
    blob = torch.sin(two_pi * uw / 1.7 + 2 * phase) * torch.cos(two_pi * vw / 2.3)
    fine = torch.tanh(5.0 * torch.sin(two_pi * (uw + vw) / 0.21 + phase))
    tex = 120.0 + 45.0 * g1 * g2 + 25.0 * blob + 15.0 * fine * (blob > 0.3)
    for cu, cv, rad, sgn in _discs(phase):
        tex = tex + sgn * 70.0 * (((u - cu) ** 2 + (v - cv) ** 2) < rad * rad)
    return torch.clamp(tex, 0.0, 255.0)


def _exp_so3(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1.0 - np.cos(th)) / th ** 2 * (W @ W)


def trajectory(n_frames: int, seed: int, step_m: float, step_rad: float,
               smooth: float = 0.9) -> np.ndarray:
    """(N, 4, 4) float64 world-from-camera poses, frame 0 the identity: a
    smooth random walk (white noise low-passed by ``smooth``, as
    synthetic.py's ``trajectory``) whose every step moves ``step_m`` metres
    along its translation and turns ``step_rad`` radians about its axis,
    both in the camera's frame."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n_frames - 1, 6))
    for i in range(1, len(xi)):
        xi[i] = smooth * xi[i - 1] + (1.0 - smooth) * xi[i]
    poses = [np.eye(4)]
    for x in xi:
        dT = np.eye(4)
        dT[:3, :3] = _exp_so3(x[3:] / np.linalg.norm(x[3:]) * step_rad)
        dT[:3, 3] = x[:3] / np.linalg.norm(x[:3]) * step_m
        poses.append(poses[-1] @ dT)
    return np.stack(poses)


def _log_so3(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    return w if th < 1e-12 else w * th / np.sin(th)


def loop(n_frames: int, seed: int, step_m: float, step_rad: float) -> np.ndarray:
    """(N, 4, 4) float64 world-from-camera poses on a closed loop through
    frame 0 = the identity: the camera circles in a plane and its view
    cones about an axis, both oriented by the seed, at a constant ``step_m``
    metres and ``step_rad`` radians from frame to frame (the last back to
    the first included).  Every seed moves the same amounts in another
    direction, and played in a cycle the motion never reverses."""
    rng = np.random.default_rng(seed)
    u, v, w1, w2 = (x for x in np.linalg.qr(rng.normal(size=(3, 3)))[0].T[[0, 1, 0, 2]])
    k = 2.0 * np.pi / n_frames
    radius = step_m / (2.0 * np.sin(k / 2.0))
    th = k * np.arange(n_frames)
    trans = radius * ((np.cos(th) - 1.0)[:, None] * u + np.sin(th)[:, None] * v)
    # The view's rotation vector on a circle through 0: a * ((cos - 1) w1 + sin w2).
    amp = step_rad / (2.0 * np.sin(k / 2.0))
    for _ in range(4):  # the angle between neighbours is nearly linear in the radius
        rot = amp * ((np.cos(th) - 1.0)[:, None] * w1 + np.sin(th)[:, None] * w2)
        Rs = [_exp_so3(r) for r in rot]
        ang = np.mean([np.linalg.norm(_log_so3(Rs[i].T @ Rs[(i + 1) % n_frames]))
                       for i in range(n_frames)])
        amp *= step_rad / ang
    rot = amp * ((np.cos(th) - 1.0)[:, None] * w1 + np.sin(th)[:, None] * w2)
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    for i in range(n_frames):
        poses[i, :3, :3] = _exp_so3(rot[i])
        poses[i, :3, 3] = trans[i]
    return poses


def render(cam: dict, poses: np.ndarray, depth_scale: float, device, chunk: int = 8):
    """Render ``poses`` (N, 4, 4) with the pinhole ``cam`` (fx, fy, cx, cy,
    width, height) on ``device``: returns (gray (N, H, W) uint8, depth (N,
    H, W) uint16 raw = metres * ``depth_scale`` truncated, 0 where no
    surface, and the same raw depth as int32), computed in float64 a chunk
    of frames at a time."""
    h, w = int(cam["height"]), int(cam["width"])
    f64 = dict(dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    d_cam = torch.stack([(xx - cam["cx"]) / cam["fx"], (yy - cam["cy"]) / cam["fy"],
                         torch.ones_like(xx)], dim=-1)
    grays, depths = [], []
    for start in range(0, len(poses), chunk):
        T = torch.as_tensor(np.asarray(poses[start:start + chunk]), **f64)
        R, o = T[:, :3, :3], T[:, :3, 3]
        d_world = torch.einsum("hwj,nij->nhwi", d_cam, R)
        best = torch.full(d_world.shape[:3], float("inf"), **f64)
        gray = torch.full(d_world.shape[:3], BACKGROUND, **f64)
        for n, d, a1, a2, phase, bounds in PLANES:
            n_, a1_, a2_ = (torch.tensor(x, **f64) for x in (n, a1, a2))
            denom = d_world @ n_
            denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
            t = (d - o @ n_)[:, None, None] / denom
            hit = (t > 0.05) & (t < best)
            X = o[:, None, None, :] + t[..., None] * d_world
            u, v = X @ a1_, X @ a2_
            if bounds is not None:
                ulo, uhi, vlo, vhi = bounds
                hit = hit & (u >= ulo) & (u <= uhi) & (v >= vlo) & (v <= vhi)
            gray = torch.where(hit, _texture(u, v, phase), gray)
            best = torch.where(hit, t, best)
        metres = torch.where(torch.isfinite(best), best, 0.0).to(torch.float32)
        grays.append(torch.round(torch.clamp(gray, 0, 255)).to(torch.uint8))
        raw = (metres.double() * depth_scale).clamp(0, 65535).to(torch.int32)
        depths.append(raw)
    raw = torch.cat(depths)
    return torch.cat(grays), raw.cpu().to(torch.uint16).to(device), raw  # uint16 cast on the host
