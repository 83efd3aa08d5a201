"""Synthetic textured RGB-D scene renderer with ground-truth poses (numpy
copy of revo_tpu/io/synthetic.py, trajectories through the port's ``lie``).

Correctness and smoke sequences are rendered, so they need no dataset on
disk: a camera moves through a scene of textured planes; per pixel we
raycast to the nearest plane, sample a procedural texture (sharp grid +
blobs -> strong Canny edges) and record metric depth.  This plays the role
of the reference's TUM dataset input (iowrapperRGBD.cpp:257-333) for the
tests and for chip_smoke.py, with exact ground-truth trajectories for ATE
gates.

Pure NumPy on the host — this is data generation, not the compute path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from revo_tpu_torch.config import CameraConfig


@dataclasses.dataclass
class Plane:
    """Textured plane: n . X = d, with texture axes (a1, a2) in-plane.

    ``bounds`` optionally clips the plane to a rectangle in (u, v) texture
    coordinates — used for near objects that create depth parallax."""

    n: np.ndarray  # (3,) unit normal
    d: float
    a1: np.ndarray  # (3,) texture u axis
    a2: np.ndarray  # (3,) texture v axis
    phase: float = 0.0
    bounds: Tuple[float, float, float, float] | None = None  # ulo,uhi,vlo,vhi
    # Texture mode: "full" (default aperiodic grid+blobs), "flat" (constant
    # intensity — NO in-surface Canny edges; only this plane's boundaries
    # against other surfaces produce edges), "discs" (flat base + the few
    # unique high-contrast landmark discs only).  "flat"/"discs" build the
    # edge-sparse regime the BMVC17 fill-in exists for
    # (imgpyramidrgbd.cpp:111-172).
    texture: str = "full"
    flat_value: float = 120.0


def _default_planes() -> List[Plane]:
    """A loose 'room': back wall, floor, side wall — all textured."""
    return [
        Plane(  # back wall z = 3.2
            n=np.array([0.0, 0.0, 1.0]),
            d=3.2,
            a1=np.array([1.0, 0.0, 0.0]),
            a2=np.array([0.0, 1.0, 0.0]),
            phase=0.0,
        ),
        Plane(  # floor y = 1.0 (camera looks slightly down at it)
            n=np.array([0.0, 1.0, 0.0]),
            d=1.0,
            a1=np.array([1.0, 0.0, 0.0]),
            a2=np.array([0.0, 0.0, 1.0]),
            phase=1.3,
        ),
        Plane(  # side wall x = 1.6
            n=np.array([1.0, 0.0, 0.0]),
            d=1.6,
            a1=np.array([0.0, 1.0, 0.0]),
            a2=np.array([0.0, 0.0, 1.0]),
            phase=2.1,
        ),
        Plane(  # near "table top": bounded plane at z = 1.5 (parallax)
            n=np.array([0.0, 0.0, 1.0]),
            d=1.5,
            a1=np.array([1.0, 0.0, 0.0]),
            a2=np.array([0.0, 1.0, 0.0]),
            phase=0.6,
            bounds=(-0.55, 0.15, -0.05, 0.55),
        ),
        Plane(  # near panel on the left at z = 1.1
            n=np.array([0.0, 0.0, 1.0]),
            d=1.1,
            a1=np.array([1.0, 0.0, 0.0]),
            a2=np.array([0.0, 1.0, 0.0]),
            phase=3.0,
            bounds=(-0.75, -0.35, -0.45, 0.05),
        ),
    ]


@dataclasses.dataclass
class Cylinder:
    """Vertical textured cylinder (axis along +y through (x, z) = center).

    Curved-surface regime: depth varies nonlinearly across the surface and
    the silhouette is view-dependent (the occluding contour slides around
    the cylinder as the camera moves) — unlike planes (affine depth) and
    boxes (piecewise-planar with fixed crease edges)."""

    center: np.ndarray  # (2,) axis position in x, z
    radius: float
    ylo: float
    yhi: float
    phase: float = 0.0


def box_faces(
    center, half_size, phase0: float = 0.0,
    texture: str = "full", flat_base: float = 120.0,
) -> List[Plane]:
    """Six bounded textured faces of an axis-aligned cuboid.

    Nearest-t raycasting resolves the convex self-occlusion exactly (the
    first bounded face a ray crosses is the visible one), so boxes create
    true depth discontinuities and view-dependent silhouette edges — the
    regime where DT edge alignment has to cope with appearing/disappearing
    occlusion contours rather than a smooth textured surface.
    """
    c = np.asarray(center, np.float64)
    s = np.asarray(half_size, np.float64)
    ex = np.array([1.0, 0.0, 0.0])
    ey = np.array([0.0, 1.0, 0.0])
    ez = np.array([0.0, 0.0, 1.0])
    faces = []
    axes = [(ex, ey, ez), (ey, ez, ex), (ez, ex, ey)]
    for k, (n, a1, a2) in enumerate(axes):
        for sgn in (+1.0, -1.0):
            d = float(n @ c + sgn * s[k])
            ulo, uhi = a1 @ c - s[(k + 1) % 3], a1 @ c + s[(k + 1) % 3]
            vlo, vhi = a2 @ c - s[(k + 2) % 3], a2 @ c + s[(k + 2) % 3]
            faces.append(
                Plane(
                    n=n.copy(),
                    d=d,
                    a1=a1.copy(),
                    a2=a2.copy(),
                    phase=phase0 + 0.7 * len(faces),
                    bounds=(float(ulo), float(uhi), float(vlo), float(vhi)),
                    texture=texture,
                    # Flat faces alternate brightness so box creases and
                    # silhouettes stay visible as intensity edges even with
                    # zero in-surface texture (the edge-sparse regime).
                    flat_value=flat_base + 35.0 * ((len(faces) % 3) - 1),
                )
            )
    return faces


def box_scene(**kw) -> "SyntheticScene":
    """Occlusion-heavy scene family: the textured room plus two cuboids at
    different depths.  Moving the camera slides the boxes' silhouettes
    across the far wall (depth discontinuities + occlusion boundaries),
    unlike the smooth-parallax bounded panels of the default scene."""
    planes = _default_planes()[:3]  # walls + floor only
    planes += box_faces((-0.25, 0.45, 1.9), (0.22, 0.16, 0.18), phase0=4.2)
    planes += box_faces((0.42, -0.05, 2.45), (0.18, 0.26, 0.15), phase0=7.9)
    return SyntheticScene(planes=planes, **kw)


def sparse_scene(**kw) -> "SyntheticScene":
    """Edge-sparse / low-texture scene family: flat (textureless) walls and
    floor plus two flat-faced cuboids and a handful of landmark discs.  The
    only Canny edges are surface boundaries — wall/floor creases, box
    creases, box-vs-wall silhouettes — and the disc rims, so large image
    regions are blank and coarse-level patch occupancy drops below the
    reference's nPercentage threshold: the regime BMVC17 edge fill-in
    exists for (imgpyramidrgbd.cpp:111-172, fillInEdges).  Gated in
    tests/test_torch_scenes.py (the fill-in fires as in the JAX package)."""
    walls = _default_planes()[:3]
    flat_vals = (150.0, 95.0, 60.0)  # back/floor/side: creases stay visible
    planes = []
    for pl, fv in zip(walls, flat_vals):
        # Back wall keeps the landmark discs (sparse unique anchors so the
        # alignment is not line-only); floor and side wall are fully flat.
        mode = "discs" if fv == 150.0 else "flat"
        planes.append(
            dataclasses.replace(pl, texture=mode, flat_value=fv)
        )
    planes += box_faces(
        (-0.25, 0.45, 1.9), (0.22, 0.16, 0.18), phase0=4.2,
        texture="flat", flat_base=200.0,
    )
    planes += box_faces(
        (0.42, -0.05, 2.45), (0.18, 0.26, 0.15), phase0=7.9,
        texture="flat", flat_base=30.0,
    )
    return SyntheticScene(planes=planes, **kw)


def column_scene(**kw) -> "SyntheticScene":
    """Curved-surface scene family: the textured room plus two cylindrical
    columns.  Depth varies nonlinearly across each column and the occluding
    contour slides around the surface as the camera moves — silhouette
    edges here are not attached to any fixed 3-D crease, the hardest edge
    regime for DT alignment (boxes at least keep their crease edges)."""
    planes = _default_planes()[:3]  # walls + floor only
    cyls = [
        Cylinder(center=np.array([-0.32, 2.05]), radius=0.17,
                 ylo=-0.8, yhi=1.0, phase=5.1),
        Cylinder(center=np.array([0.45, 2.55]), radius=0.24,
                 ylo=-0.9, yhi=1.0, phase=8.6),
    ]
    return SyntheticScene(planes=planes, cylinders=cyls, **kw)


def _libm_sincos():
    """The C library's ``sinf`` / ``cosf``.  XLA's CPU backend lowers the
    scalar sine and cosine of the JAX package's ``loop_trajectory`` to these
    calls; they are within an ulp but not correctly rounded, and
    ``torch.sin`` / ``torch.cos`` round differently at some angles."""
    import ctypes
    import ctypes.util

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for f in (libm.sinf, libm.cosf):
        f.restype = ctypes.c_float
        f.argtypes = [ctypes.c_float]
    return libm.sinf, libm.cosf


def _exp_so3_host(omega):
    """``lie.exp_so3`` of one float32 3-vector on the host, its sine and
    cosine taken from the C library (``_libm_sincos``): a last-bit change in
    a rotation moves rendered pixels, and the scenes must render as the JAX
    package's do.  Everything else is ``lie.exp_so3``'s float32 arithmetic."""
    import torch

    from revo_tpu_torch import lie
    from revo_tpu_torch.ops.project import sqrt_rn

    sinf, cosf = _libm_sincos()
    theta_sq = torch.sum(omega * omega, dim=-1)
    W = lie.hat_so3(omega)
    if float(theta_sq) < lie._EPS:
        a, b = 1.0 - theta_sq / 6.0, 0.5 - theta_sq / 24.0
    else:
        theta = sqrt_rn(theta_sq)
        a = torch.tensor(sinf(float(theta))) / theta
        b = (1.0 - torch.tensor(cosf(float(theta)))) / (theta * theta)
    return torch.eye(3) + a * W + b * (W @ W)


def loop_trajectory(
    n_frames: int,
    radius: float = 0.25,
    wobble: float = 0.004,
    seed: int = 0,
    circuits: int = 1,
) -> np.ndarray:
    """Closed-loop trajectory (N, 4, 4): ``circuits`` full lateral circuits
    in the x-y plane with gentle yaw, returning exactly to the start — the
    revisit geometry loop-closure needs (pose[N-1] ~ pose[0], and frames
    near the end re-observe the first keyframes' views).  With
    ``circuits=2`` (a double circuit) every azimuth is visited twice, so
    multiple independent loop edges exist along the whole path — the
    multi-loop gate geometry (VERDICT r2 item 4)."""
    import torch

    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        a = circuits * 2.0 * np.pi * i / (n_frames - 1)
        # lateral circle + slight look-around yaw, plus smooth wobble
        t = np.array(
            [
                radius * np.sin(a),
                0.4 * radius * (1.0 - np.cos(a)),
                0.15 * radius * np.sin(2 * a),
            ]
        )
        yaw = 0.25 * np.sin(a)
        dR = _exp_so3_host(torch.from_numpy(np.array([0, yaw, 0], np.float32)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = dR.numpy()
        T[:3, 3] = t
        if wobble > 0 and 0 < i < n_frames - 1:
            T[:3, 3] += rng.normal(scale=wobble, size=3)
        poses.append(T)
    return np.stack(poses)


def render_trajectory(scene: "SyntheticScene", cam, traj: np.ndarray, seed: int = 0):
    """Yield (gray, depth, T_w_c, timestamp) over an explicit trajectory."""
    for i, T in enumerate(traj):
        gray, depth = render_frame(scene, cam, T, seed=seed * 1000 + i)
        yield gray, depth, T, float(i) / 30.0


def _texture(u: np.ndarray, v: np.ndarray, phase: float) -> np.ndarray:
    """Procedural gray texture in [0, 255]: sharp *aperiodic* structure.

    tanh-sharpened sinusoids give clean, well-localized Canny edges; the
    coordinates are warped by incommensurate low-frequency terms and unique
    high-contrast blobs are added so the texture has no translational
    symmetry — a periodic grid would alias direct alignment once the drift
    approaches a lattice period (a pure synthetic-data artifact; real TUM
    scenes are aperiodic).
    """
    uw = u + 0.13 * np.sin(0.83 * v + phase) + 0.07 * np.sin(2.19 * u)
    vw = v + 0.11 * np.sin(0.71 * u + 1.3 * phase) + 0.06 * np.sin(2.71 * v)
    g1 = np.tanh(6.0 * np.sin(2 * np.pi * uw / 0.50 + phase))
    g2 = np.tanh(6.0 * np.sin(2 * np.pi * vw / 0.53 + 0.7 * phase))
    grid = g1 * g2
    blob = np.sin(2 * np.pi * uw / 1.7 + 2 * phase) * np.cos(
        2 * np.pi * vw / 2.3
    )
    fine = np.tanh(5.0 * np.sin(2 * np.pi * (uw + vw) / 0.21 + phase))
    tex = 120.0 + 45.0 * grid + 25.0 * blob + 15.0 * fine * (blob > 0.3)
    tex = _add_landmark_discs(tex, u, v, phase)
    return np.clip(tex, 0.0, 255.0)


def _add_landmark_discs(
    tex: np.ndarray, u: np.ndarray, v: np.ndarray, phase: float,
    amp: float = 70.0,
) -> np.ndarray:
    """Unique landmarks: a few deterministic high-contrast discs per plane
    (breaks any residual translational symmetry of the base texture)."""
    rng = np.random.default_rng(int(phase * 1000) + 7)
    for _ in range(6):
        cu = rng.uniform(-2.0, 2.0)
        cv_ = rng.uniform(-2.0, 2.0)
        rad = rng.uniform(0.08, 0.2)
        sgn = rng.choice([-1.0, 1.0])
        d2 = (u - cu) ** 2 + (v - cv_) ** 2
        tex = tex + sgn * amp * (d2 < rad * rad)
    return tex


def _plane_texture(pl: "Plane", u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Dispatch on the plane's texture mode (see Plane.texture)."""
    if pl.texture == "full":
        return _texture(u, v, pl.phase)
    base = np.full_like(u, pl.flat_value, dtype=np.float64)
    if pl.texture == "discs":
        base = _add_landmark_discs(base, u, v, pl.phase)
    elif pl.texture != "flat":
        raise ValueError(f"unknown texture mode {pl.texture!r}")
    return np.clip(base, 0.0, 255.0)


@dataclasses.dataclass
class SyntheticScene:
    """Scene + trajectory generator."""

    planes: List[Plane] = dataclasses.field(default_factory=_default_planes)
    cylinders: List[Cylinder] = dataclasses.field(default_factory=list)
    depth_noise: float = 0.0  # metres, gaussian
    depth_hole_frac: float = 0.0
    # Photometric corruption of the intensity channel (the reference
    # consumes real sensor images, iowrapperRGBD.cpp:325-327; these model
    # the sensor artifacts a pristine render lacks, so the Canny edge set
    # is no longer unrealistically stable between frames).  Break points
    # per corruption are measured in scripts/probes/photo_break.py and
    # gated per scene family in tests/test_scenes.py.
    image_noise: float = 0.0  # gaussian read noise, gray levels (std)
    shot_noise: float = 0.0  # signal-dependent noise: std at full scale
    image_blur: float = 0.0  # gaussian defocus/motion blur sigma, px
    exposure_drift: float = 0.0  # per-frame gain flicker amplitude (+bias)
    vignette: float = 0.0  # radial falloff: corners lose this fraction

    def trajectory(self, n_frames: int, seed: int = 0,
                   translation_step: float = 0.008,
                   rotation_step: float = 0.003) -> np.ndarray:
        """Smooth random-walk trajectory of T_w_c (world-from-camera),
        (N, 4, 4).  Steps are TUM-handheld-scale (~0.8 cm, ~0.17 deg)."""
        import torch

        from revo_tpu_torch import lie

        rng = np.random.default_rng(seed)
        # Smooth velocity: low-pass filtered white noise.
        xi_steps = rng.normal(size=(n_frames - 1, 6)).astype(np.float32)
        for i in range(1, len(xi_steps)):
            xi_steps[i] = 0.9 * xi_steps[i - 1] + 0.1 * xi_steps[i]
        xi_steps[:, :3] *= translation_step
        xi_steps[:, 3:] *= rotation_step

        poses = [np.eye(4, dtype=np.float32)]
        for xi in xi_steps:
            dR, dt = lie.exp_se3(torch.from_numpy(xi))
            dT = lie.matrix_from_rt(dR, dt).numpy()
            poses.append(poses[-1] @ dT)
        return np.stack(poses)


def render_frame(
    scene: SyntheticScene,
    cam: CameraConfig,
    T_w_c: np.ndarray,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (gray uint8-valued f32, depth f32 metres) for camera pose
    T_w_c.  Per pixel: raycast to the nearest plane intersection with t>0."""
    h, w = cam.height, cam.width
    R = T_w_c[:3, :3].astype(np.float64)
    o = T_w_c[:3, 3].astype(np.float64)

    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    d_cam = np.stack(
        [
            (xx - cam.cx) / cam.fx,
            (yy - cam.cy) / cam.fy,
            np.ones_like(xx, dtype=np.float64),
        ],
        axis=-1,
    )  # (h, w, 3); z-component 1 -> ray param t == camera depth
    d_world = d_cam @ R.T

    best_t = np.full((h, w), np.inf)
    gray = np.full((h, w), 30.0)
    for pl in scene.planes:
        denom = d_world @ pl.n
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        t = (pl.d - o @ pl.n) / denom
        hit = (t > 0.05) & (t < best_t)
        X = o[None, None, :] + t[..., None] * d_world
        u = X @ pl.a1
        v = X @ pl.a2
        if pl.bounds is not None:
            ulo, uhi, vlo, vhi = pl.bounds
            hit = hit & (u >= ulo) & (u <= uhi) & (v >= vlo) & (v <= vhi)
        tex = _plane_texture(pl, u, v)
        gray = np.where(hit, tex, gray)
        best_t = np.where(hit, t, best_t)

    for cyl in scene.cylinders:
        # Ray-cylinder (axis || y through center): quadratic in t on the
        # (x, z) components; the near root is the visible surface (the
        # camera stays outside the columns in these scenes).
        ox, oz = o[0] - cyl.center[0], o[2] - cyl.center[1]
        dx, dz = d_world[..., 0], d_world[..., 2]
        a = dx * dx + dz * dz
        b = 2.0 * (ox * dx + oz * dz)
        c = ox * ox + oz * oz - cyl.radius * cyl.radius
        disc = b * b - 4.0 * a * c
        safe = disc > 0
        sq = np.sqrt(np.where(safe, disc, 0.0))
        t = (-b - sq) / np.where(np.abs(a) < 1e-12, 1e-12, 2.0 * a)
        y = o[1] + t * d_world[..., 1]
        hit = safe & (t > 0.05) & (t < best_t) & (y >= cyl.ylo) & (y <= cyl.yhi)
        xs = ox + t * dx
        zs = oz + t * dz
        u = np.arctan2(xs, zs) * cyl.radius  # arc length around the surface
        tex = _texture(u, y, cyl.phase)
        gray = np.where(hit, tex, gray)
        best_t = np.where(hit, t, best_t)

    depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
    if scene.depth_noise > 0 or scene.depth_hole_frac > 0:
        rng = np.random.default_rng(seed)
        if scene.depth_noise > 0:
            depth = depth + rng.normal(
                scale=scene.depth_noise, size=depth.shape
            ).astype(np.float32) * (depth > 0)
        if scene.depth_hole_frac > 0:
            depth = np.where(
                rng.random(depth.shape) < scene.depth_hole_frac, 0.0, depth
            )
    gray = _apply_photometric(scene, cam, gray, seed)
    return np.round(np.clip(gray, 0, 255)).astype(np.float32), depth


def _apply_photometric(
    scene: SyntheticScene, cam: CameraConfig, gray: np.ndarray, seed: int
) -> np.ndarray:
    """Sensor-artifact model on the intensity channel, applied in optical
    order: vignette (lens, scene-fixed) -> exposure gain/bias flicker
    (per frame) -> defocus blur -> shot + read noise."""
    if not (
        scene.vignette > 0
        or scene.exposure_drift > 0
        or scene.image_blur > 0
        or scene.image_noise > 0
        or scene.shot_noise > 0
    ):
        return gray
    rng = np.random.default_rng(seed ^ 0x5EED)
    h, w = gray.shape
    if scene.vignette > 0:
        yy, xx = np.mgrid[0:h, 0:w]
        r2 = ((xx - cam.cx) / (w / 2)) ** 2 + ((yy - cam.cy) / (h / 2)) ** 2
        gray = gray * (1.0 - scene.vignette * np.clip(r2 / 2.0, 0.0, 1.0))
    if scene.exposure_drift > 0:
        gain = 1.0 + rng.uniform(-scene.exposure_drift, scene.exposure_drift)
        bias = rng.uniform(-20.0, 20.0) * scene.exposure_drift
        gray = gain * gray + bias
    if scene.image_blur > 0:
        import cv2

        gray = cv2.GaussianBlur(
            gray.astype(np.float32), (0, 0), scene.image_blur
        )
    if scene.shot_noise > 0:
        amp = scene.shot_noise * np.sqrt(np.clip(gray, 0.0, None) / 255.0)
        gray = gray + amp * rng.standard_normal(gray.shape)
    if scene.image_noise > 0:
        gray = gray + rng.normal(scale=scene.image_noise, size=gray.shape)
    return gray


def render_sequence(
    scene: SyntheticScene, cam: CameraConfig, n_frames: int, seed: int = 0
):
    """Yield (gray, depth, T_w_c, timestamp) for a smooth trajectory."""
    traj = scene.trajectory(n_frames, seed=seed)
    for i, T in enumerate(traj):
        gray, depth = render_frame(scene, cam, T, seed=seed * 1000 + i)
        yield gray, depth, T, float(i) / 30.0


def _render_one(args):
    scene, cam, T, seed = args
    return render_frame(scene, cam, T, seed=seed)


def render_trajectory_parallel(
    scene: SyntheticScene,
    cam: CameraConfig,
    traj: np.ndarray,
    seed: int = 0,
    workers: int | None = None,
):
    """render_trajectory with a process pool: bit-identical per-frame output
    (each frame's seed is ``seed*1000 + i`` exactly as the serial paths use)
    but ~Nx faster on multi-core hosts — long-sequence datasets (refbench
    v2 300-500-frame head-to-heads, the 1000-frame soak) render in minutes
    instead of tens of minutes.  Spawn context: workers only run the pure
    -NumPy render_frame and touch no device."""
    import multiprocessing as mp
    import os
    import sys

    n = len(traj)
    jobs = [(scene, cam, traj[i], seed * 1000 + i) for i in range(n)]
    # Spawn re-imports __main__ in each worker; with an unimportable
    # __main__ (stdin scripts, some REPLs) the pool respawns dying workers
    # forever — fall back to serial rendering there.
    main_file = getattr(sys.modules.get("__main__"), "__file__", None)
    if main_file is None or not os.path.exists(main_file):
        outs = [_render_one(j) for j in jobs]
    else:
        ctx = mp.get_context("spawn")
        workers = workers or max(mp.cpu_count() - 1, 1)
        with ctx.Pool(workers) as pool:
            outs = pool.map(_render_one, jobs, chunksize=8)
    return [
        (g, d, traj[i], float(i) / 30.0) for i, (g, d) in enumerate(outs)
    ]
