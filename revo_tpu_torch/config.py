"""Configuration dataclasses of the PyTorch port (copy of revo_tpu/config.py).

Field names and defaults are identical to ``revo_tpu.config`` so one
configuration drives both packages (``convert.config_from_jax``).  The YAML
loader imports ``yaml`` only when called.  revo_tpu/config.py documents
each knob and its measured history on the TPU.  The port implements every
value of ``solver``, ``solve6_impl``, ``quad_form`` and ``bilinear_impl``
that the JAX package knows, and raises ValueError for others.  Two of them
change the result: a ``bilinear_impl`` that is not "quad*" samples the
(gx, gy, dt) structure, and "quad*" samples the quad table of
``quad_form``, where "dt4" / "dt4bf" differentiate the bilinear dt surface
and the 12-component forms ("hw12", "flat", "t", "flat16", "flatbf")
interpolate the reference's central differences, as the structure does;
"dt4bf" and "flatbf" store the table in bfloat16.  The forms of one kind
differ in the JAX package only in storage layout, and the port holds them
as one table (``ops.edt.QUAD_FORMS``).  The other gather and layout knobs
(``lane_select``, ``proj_impl``, ``compaction``, ``use_pallas_*``) pick
how the TPU program is built and change nothing in the port.

Mirrors the reference's two-file YAML config split (algorithm settings +
dataset/sensor settings) parsed by ``REVOConfig`` (system.h:32-83),
``TrackerSettings`` (tracker.h:31-55), ``ImgPyramidSettings``
(camerapyr.h:27-89), ``IOWrapperSettings`` (iowrapperRGBD.h:41-153) and
``OptimizerConfig`` (optimizer.h:42-112), with per-key defaults identical to
the reference.  Everything is a frozen dataclass, so configs hash and compare
by value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics of the full-resolution camera (camerapyr.h:90-111)."""

    fx: float = 517.306408  # defaults: TUM freiburg1 (config/dataset_tum1.yaml)
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    width: int = 640
    height: int = 480
    distortion: Tuple[float, float, float, float, float] = (0.0,) * 5

    def level(self, lvl: int) -> "CameraConfig":
        """Per-level intrinsics: scale = 2**-lvl (camerapyr.h:140-144).

        Note the reference scales cx,cy by the plain factor (no half-pixel
        shift), and truncates width/height.
        """
        s = 1.0 / (2 ** lvl)
        return dataclasses.replace(
            self,
            fx=self.fx * s,
            fy=self.fy * s,
            cx=self.cx * s,
            cy=self.cy * s,
            width=int(self.width * s),
            height=int(self.height * s),
        )


@dataclass(frozen=True)
class PyramidConfig:
    """Pyramid + edge-extraction settings (ImgPyramidSettings, camerapyr.h:27-89)."""

    canny_threshold1: float = 150.0  # camerapyr.h:40
    canny_threshold2: float = 100.0  # camerapyr.h:41
    gaussian_before_canny: bool = False  # DO_GAUSSIAN_SMOOTHING_BEFORE_CANNY
    depth_min: float = 0.1  # camerapyr.h:43
    depth_max: float = 5.2  # camerapyr.h:44
    pyr_min_lvl: int = 2  # coarsest level tracked (camerapyr.h:45)
    pyr_max_lvl: int = 0  # finest level tracked (camerapyr.h:46)
    undistort: bool = False
    use_edge_hist: bool = True  # BMVC17 edge fill-in (camerapyr.h:62)
    compaction: str = "rank_sort2"
    n_percentage: float = 0.3  # occupancy threshold for fill-in
    dist_patch_sizes: Tuple[int, ...] = (20, 10, 5)
    edge_capacity: Tuple[int, ...] = (16384, 8192, 4096)
    use_pallas_canny: bool = True

    @property
    def n_levels(self) -> int:
        return self.pyr_min_lvl - self.pyr_max_lvl + 1  # camerapyr.h:68-71


@dataclass(frozen=True)
class OptimizerConfig:
    """LM/GN schedule (OptimizerSettings, optimizer.h:42-112)."""

    lambda_success_fac: float = 0.5  # optimizer.h:53
    lambda_fail_fac: float = 2.0  # optimizer.h:54
    lambda_initial: Tuple[float, ...] = (0.0,) * 6  # optimizer.h:63
    step_size_min: Tuple[float, ...] = (1e-16,) * 6  # optimizer.h:55
    convergence_eps: Tuple[float, ...] = (0.999,) * 6  # optimizer.h:65
    max_its_per_lvl: Tuple[int, ...] = (100,) * 6  # optimizer.h:56
    edge_distance_lvl: Tuple[float, ...] = (30, 20, 10, 5, 5, 5)  # optimizer.h:59
    max_inc_try: int = 10  # optimizer.h:69
    huber_edge: float = 0.3  # optimizer.h:75
    use_edge_filter: bool = True  # revo_settings.yaml USE_EDGE_FILTER
    solver: str = "lm"
    fixed_iters: Tuple[int, ...] = (6, 10, 12, 12, 12, 12)  # per level
    use_pallas_lgsx: bool = False
    bilinear_impl: str = "quad_lf"
    quad_form: str = "dt4bf"
    lane_select: str = "onehot"
    proj_impl: str = "fma"
    solve6_impl: str = "ldlt"


@dataclass(frozen=True)
class TrackerConfig:
    """Tracker settings (TrackerSettings, tracker.h:31-55)."""

    check_init_values: bool = True  # tracker.h:43
    normalized_init_cost: bool = True
    init_check_margin: float = 0.9
    check_tracking_results: bool = True  # tracker.h:45
    n_frames_histogram_voting: int = 3  # tracker.h:44,47
    histogram_level: int = 2  # tracker.cpp:229
    hist_weights: Tuple[float, ...] = (0.0, 1.0, 1.25, 1.5)
    good_bad_ratio_new_kf: float = 4.0
    enable_relocalization: bool = True
    max_jump_translation: float = 0.5  # metres per frame
    max_jump_rotation: float = 0.8  # radians per frame
    reloc_error_threshold: float = 2.0  # mean weighted DT error (px)
    reloc_min_good: int = 100
    kf_history_size: int = 5
    store_kf_images: bool = False
    online_loop_closure: bool = False
    loop_closure_every: int = 30
    loop_closure_radius: float = 0.8  # candidate search radius (m)
    scan_relocalization: bool = False
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


@dataclass(frozen=True)
class DatasetConfig:
    """Dataset / IO settings (IOWrapperSettings, iowrapperRGBD.h:41-153)."""

    main_folder: str = ""
    datasets: Tuple[str, ...] = ()
    associate_file: str = "associate.txt"
    depth_scale_factor: float = 5000.0  # TUM (iowrapperRGBD.cpp:326-327)
    skip_first_n_frames: int = 0  # iowrapperRGBD.h:108
    read_n_images: int = 100000  # iowrapperRGBD.h:109
    use_depth_timestamp: bool = False
    input_type: int = 0


@dataclass(frozen=True)
class SystemConfig:
    """Top-level config (REVOConfig, system.h:32-83)."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    pyramid: PyramidConfig = field(default_factory=PyramidConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    init_from_last_pose: bool = True  # system.h:54 INIT_FROM_LAST_POSE
    do_output_poses: bool = True
    output_folder: str = "out"

    def camera_pyramid(self) -> Tuple[CameraConfig, ...]:
        """Per-level intrinsics for levels 0..n_levels-1 (camerapyr.h:139-144)."""
        return tuple(
            self.camera.level(lvl) for lvl in range(self.pyramid.n_levels)
        )


def _get(d: dict, key: str, default):
    v = d.get(key, default)
    if isinstance(default, bool):
        return bool(v)
    if isinstance(default, int) and not isinstance(default, bool):
        return int(v)
    if isinstance(default, float):
        return float(v)
    return v


def load_config(
    settings_file: Optional[str] = None, dataset_file: Optional[str] = None
) -> SystemConfig:
    """Load the two-file YAML config, mirroring the reference split.

    ``settings_file`` = algorithm settings (config/revo_settings.yaml),
    ``dataset_file`` = camera/dataset settings (config/dataset_tum1.yaml).
    Missing keys fall back to the reference defaults listed above.  The
    reference parses OpenCV FileStorage YAML ("%YAML:1.0" + "key: value");
    we accept both plain YAML and the FileStorage dialect.
    """
    algo: dict = {}
    data: dict = {}
    if settings_file:
        algo = _load_yaml(settings_file)
    if dataset_file:
        data = _load_yaml(dataset_file)

    cam = CameraConfig(
        fx=_get(data, "Camera.fx", 517.306408),
        fy=_get(data, "Camera.fy", 516.469215),
        cx=_get(data, "Camera.cx", 318.643040),
        cy=_get(data, "Camera.cy", 255.313989),
        width=_get(data, "Camera.width", 640),
        height=_get(data, "Camera.height", 480),
        distortion=(
            _get(data, "Camera.k1", 0.0),
            _get(data, "Camera.k2", 0.0),
            _get(data, "Camera.p1", 0.0),
            _get(data, "Camera.p2", 0.0),
            _get(data, "Camera.k3", 0.0),
        ),
    )
    pyr = PyramidConfig(
        canny_threshold1=_get(data, "cannyThreshold1", 150.0),
        canny_threshold2=_get(data, "cannyThreshold2", 100.0),
        gaussian_before_canny=_get(
            data, "DO_GAUSSIAN_SMOOTHING_BEFORE_CANNY", False
        ),
        depth_min=_get(data, "DEPTH_MIN", 0.1),
        depth_max=_get(data, "DEPTH_MAX", 5.2),
        pyr_min_lvl=_get(data, "PYR_MIN_LVL", 2),
        pyr_max_lvl=_get(data, "PYR_MAX_LVL", 0),
        undistort=_get(data, "DO_UNDISTORT", False),
        use_edge_hist=_get(data, "USE_EDGE_HIST", True),
        n_percentage=_get(data, "nPercentage", 0.3),
    )
    opt = OptimizerConfig(
        use_edge_filter=_get(algo, "USE_EDGE_FILTER", True),
    )
    trk = TrackerConfig(
        check_init_values=_get(algo, "CHECK_INIT_VALUES", True),
        check_tracking_results=_get(algo, "CHECK_TRACKING_RESULTS", True),
        n_frames_histogram_voting=_get(
            algo, "N_FRAMES_HIST_VOTING", _get(algo, "nFramesHistogramVoting", 3)
        ),
        # revo_tpu extensions (absent from reference YAMLs; keys are ours).
        enable_relocalization=_get(algo, "ENABLE_RELOCALIZATION", True),
        kf_history_size=_get(algo, "KF_HISTORY_SIZE", 5),
        online_loop_closure=_get(algo, "ONLINE_LOOP_CLOSURE", False),
        loop_closure_every=_get(algo, "LOOP_CLOSURE_EVERY", 30),
        loop_closure_radius=_get(algo, "LOOP_CLOSURE_RADIUS", 0.8),
        optimizer=opt,
    )
    datasets = data.get("Datasets", ())
    if isinstance(datasets, str):
        datasets = (datasets,)
    else:
        datasets = tuple(datasets)
    ds = DatasetConfig(
        main_folder=_get(data, "MainFolder", ""),
        datasets=datasets,
        associate_file=_get(data, "ASSOCIATE", "associate.txt"),
        depth_scale_factor=_get(data, "DEPTH_SCALE_FACTOR", 5000.0),
        skip_first_n_frames=_get(data, "SKIP_FIRST_N_FRAMES", 0),
        read_n_images=_get(data, "READ_N_IMAGES", 100000),
        input_type=int(_get(algo, "INPUT_TYPE", _get(data, "INPUT_TYPE", 0))),
    )
    return SystemConfig(
        camera=cam,
        pyramid=pyr,
        tracker=trk,
        dataset=ds,
        do_output_poses=_get(algo, "DO_OUTPUT_POSES", True),
    )


def _load_yaml(path: str) -> dict:
    """Load plain YAML or OpenCV FileStorage YAML ("%YAML:1.0" header)."""
    import yaml

    with open(path) as f:
        text = f.read()
    # OpenCV FileStorage header is not valid YAML 1.1; strip it.
    if text.startswith("%YAML"):
        text = "\n".join(
            line for line in text.splitlines() if not line.startswith("%YAML")
        )
    loaded = yaml.safe_load(text)
    return loaded or {}
