"""What the drivers share: the program's configuration built from a
configuration file, the program's launch counters, and its outputs in the
form the comparison reads."""
from __future__ import annotations

import time

import torch

# The reference covers these settings; a configuration that states others
# needs a reference that covers them first.
REFERENCE_COVERS = {
    ("pyramid", "gaussian_before_canny"): False,
    ("pyramid", "undistort"): False,
    ("tracker", "normalized_init_cost"): True,
    ("tracker", "scan_relocalization"): False,
    ("optimizer", "use_edge_filter"): True,
    ("optimizer", "solver"): "lm",
}


def check_covered(cfg: dict) -> None:
    for (group, key), want in REFERENCE_COVERS.items():
        if cfg[group][key] != want:
            raise ValueError(f"the reference covers {group}.{key} = {want!r} only, "
                             f"not {cfg[group][key]!r}")
    if not cfg["optimizer"]["bilinear_impl"].startswith("quad"):
        raise ValueError("the reference samples the quad table (a 'quad*' bilinear_impl)")
    if cfg["optimizer"]["quad_form"] not in ("dt4", "dt4bf"):
        raise ValueError("the reference builds the dt-only quad tables ('dt4', 'dt4bf')")


def _tuples(group: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in group.items()}


def port_config(cfg: dict):
    """The program's SystemConfig of a configuration file: every group's
    keys given to the dataclass of the same name."""
    from revo_tpu_torch import config as C

    check_covered(cfg)
    opt = C.OptimizerConfig(**_tuples(cfg["optimizer"]))
    return C.SystemConfig(
        camera=C.CameraConfig(**_tuples(cfg["camera"])),
        pyramid=C.PyramidConfig(**_tuples(cfg["pyramid"])),
        tracker=C.TrackerConfig(optimizer=opt, **_tuples(cfg["tracker"])),
        dataset=C.DatasetConfig(**_tuples(cfg["dataset"])),
        **_tuples(cfg["system"]),
    )


def wrappers() -> dict:
    """The program's hand-kernel wrappers, whose ``launches`` count their
    kernels' launches, each with the names of the device functions it
    launches (``revo_tpu_torch/csrc/*.cu``)."""
    from revo_tpu_torch import solver
    from revo_tpu_torch.ops import backproject, canny, edt, filters, lgsx

    return {canny.canny_fused: ("canny_fused_kernel", "canny_fused_dense_kernel"),
            canny.canny_cluster: ("canny_cluster_kernel",),
            canny.canny_grid: ("canny_grid_kernel",),
            canny.canny_nms: ("canny_nms_kernel",),
            canny.canny_hysteresis: ("canny_hysteresis",),
            lgsx.lgsx_reduce: ("lgsx_reduce_kernel",),
            lgsx.residual_lgsx: ("residual_lgsx_kernel",),
            solver.solve_level_kernel: ("solve_level_kernel",),
            solver.solver_step: ("solver_step_kernel",),
            solver.init_check: ("init_check_kernel",),
            edt.edt_columns_levels: ("edt_levels_kernel",),
            edt.keyframe_rows: ("keyframe_rows_kernel",),
            backproject.backproject_edges: ("edge_cloud_kernel",),
            filters.pyramid: ("pyramid_kernel",)}


def launches() -> dict:
    return {fn.__name__: int(getattr(fn, "launches", 0)) for fn in wrappers()}


def wrapper_launches(kernel: str, launches: dict):
    """The launches that the wrapper of device function ``kernel`` (a name
    as the profiler gives it) counted, or None for a torch kernel."""
    for fn, device_fns in wrappers().items():
        if any(f in kernel for f in device_fns):
            return launches.get(fn.__name__)
    return None


def frame_levels(frame) -> list:
    """The program's batched Frame as the comparison reads it: per level a
    dict of gray, depth, edges_orig, edges, points, valid."""
    return [dict(gray=lv.gray, depth=lv.depth, edges_orig=lv.edges_orig, edges=lv.edges,
                 points=lv.cloud.points, valid=lv.cloud.valid) for lv in frame.levels]


def pick(levels: list, idx) -> list:
    """Lanes ``idx`` of batched level dicts."""
    idx = torch.as_tensor(idx, dtype=torch.long)
    return [{k: v[idx.to(v.device)] for k, v in lv.items()} for lv in levels]


class Clock:
    """Seconds of each set-up phase, each mark after the device has caught
    up: the driver's ``setup_log``."""

    def __init__(self, device):
        self.device, self.log, self.t = device, {}, time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.log[name] = round(now - self.t, 3)
        self.t = now
