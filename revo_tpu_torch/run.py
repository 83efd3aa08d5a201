"""CLI entry point: ``python -m revo_tpu_torch.run <settings.yaml> <dataset.yaml>``
(counterpart of revo_tpu/run.py).

Replaces main.cpp:22-48: loads the two-file config, then runs VO over each
dataset listed in the dataset file, writing ``poses_<dataset>.txt`` in TUM
format.  ``--synthetic N`` renders an N-frame synthetic sequence instead and
reports ATE/RPE against its exact ground truth.  Everything runs on
``--device`` (default ``cuda``); a CUDA device on a machine without one is
an error, never a quiet CPU run.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# Options of revo_tpu.run that the port does not have yet, and the ROADMAP
# item that brings each.
_NOT_PORTED = {
    "close_loops": ("--close-loops", "P12"),
    "windowed_ba": ("--windowed-ba", "P12"),
    "live_view": ("--live-view", "P11"),
    "export_ply": ("--export-ply", "P11"),
    "input_type": ("--input-type", "P11"),
    "color_dev": ("--color-dev", "P11"),
    "depth_dev": ("--depth-dev", "P11"),
    "replay_color": ("--replay-color", "P11"),
    "replay_depth": ("--replay-depth", "P11"),
    "max_frames": ("--max-frames", "P11"),
    "record": ("--record", "P11"),
}


def _print_report(report, pose_file) -> None:
    # VO report (system.cpp:292-304)
    print("-----VO Report-----")
    print(f"Frames Tracked: {report.frames_tracked}")
    print(f"Keyframes Tracked: {report.keyframes}")
    print(f"Tracking Lost: {report.tracking_lost}")
    print(f"Distance Transform: {report.mean_dt_time_ms:.2f} ms")
    print(f"Mean Tracking Time: {report.mean_tracking_time_ms:.2f} ms")
    print(
        "Tracking Latency p50/p95/p99: "
        f"{report.latency_ms_p50:.2f} / {report.latency_ms_p95:.2f} / "
        f"{report.latency_ms_p99:.2f} ms"
    )
    if pose_file:
        print(f"Poses written to {pose_file}")


def _calibrate(cfg, grays, depths, scale, device):
    from revo_tpu_torch.autotune import calibrate_capacities

    cfg = calibrate_capacities(cfg, grays, depths, margin=scale, device=device)
    print(f"[revo_tpu_torch] calibrated edge_capacity = {cfg.pyramid.edge_capacity}")
    return cfg


def _evaluate_against_gt(poses, stamps, ds_dir, gt_file) -> None:
    """ATE/RPE against a TUM groundtruth.txt (the reference delegates this
    to the external rgbd_benchmark_tools, README.md:57)."""
    from revo_tpu_torch.eval import absolute_trajectory_error, relative_pose_error
    from revo_tpu_torch.io.associate import associate
    from revo_tpu_torch.io.tum import read_tum_trajectory

    gt_path = gt_file if os.path.isabs(gt_file) else os.path.join(ds_dir, gt_file)
    gt_ts, gt_poses = read_tum_trajectory(gt_path)
    est_at = {t: i for i, t in enumerate(stamps)}
    gt_at = {t: i for i, t in enumerate(gt_ts)}
    pairs = associate(est_at, gt_at)
    if len(pairs) < 2:
        print("[revo_tpu_torch] too few gt associations; skipping evaluation")
        return
    est = poses[[est_at[a] for a, _ in pairs]]
    gt = gt_poses[[gt_at[b] for _, b in pairs]]
    ate = absolute_trajectory_error(est, gt)
    rpe = relative_pose_error(est, gt)
    print(
        f"ATE-RMSE vs GT: {ate.rmse * 100:.2f} cm "
        f"(mean {ate.mean * 100:.2f}, max {ate.max * 100:.2f}) "
        f"over {len(pairs)} frames"
    )
    print(f"RPE vs GT: {rpe.trans_rmse * 1000:.2f} mm / "
          f"{rpe.rot_rmse_deg:.4f} deg per frame")


def _run_dataset(cfg, dataset, out_dir, device, gt_file=None, auto_capacity=0,
                 capacity_scale=1.15) -> None:
    from revo_tpu_torch.io.tum import load_associations, load_tum_frame, load_tum_frame_raw
    from revo_tpu_torch.system import VOSystem

    ds_dir = os.path.join(cfg.dataset.main_folder, dataset)
    if not os.path.exists(os.path.join(ds_dir, cfg.dataset.associate_file)) and os.path.exists(
        os.path.join(ds_dir, "rgb.txt")
    ):
        # Raw TUM download: generate the associations (the reference needs
        # the external associate.py first, README.md:43-57).
        from revo_tpu_torch.io.associate import write_associations

        n = write_associations(ds_dir, out_file=cfg.dataset.associate_file)
        print(f"[revo_tpu_torch] generated {cfg.dataset.associate_file}: {n} pairs")
    assocs = load_associations(
        ds_dir, cfg.dataset.associate_file,
        skip_first=cfg.dataset.skip_first_n_frames, max_frames=cfg.dataset.read_n_images,
    )
    print(f"[revo_tpu_torch] {dataset}: {len(assocs)} frames")
    scale = cfg.dataset.depth_scale_factor
    if auto_capacity > 0:
        probe = [load_tum_frame(ds_dir, a, scale)[:2] for a in assocs[:auto_capacity]]
        cfg = _calibrate(cfg, [p[0] for p in probe], [p[1] for p in probe],
                         capacity_scale, device)

    frames = (load_tum_frame_raw(ds_dir, a) for a in assocs)
    pose_file = os.path.join(out_dir, f"poses_{dataset}.txt")
    poses, stamps, report = VOSystem(cfg, device=device).run(frames, pose_file=pose_file)
    _print_report(report, pose_file)
    if gt_file:
        _evaluate_against_gt(poses, stamps, ds_dir, gt_file)


def _run_synthetic(cfg, n_frames: int, out_dir: str, seed: int, device) -> int:
    from revo_tpu_torch.eval import absolute_trajectory_error, relative_pose_error
    from revo_tpu_torch.io.synthetic import SyntheticScene, render_sequence
    from revo_tpu_torch.system import VOSystem

    gt = []

    def frames():
        for gray, depth, T, ts in render_sequence(SyntheticScene(), cfg.camera, n_frames, seed=seed):
            gt.append(T)
            yield gray, depth, ts

    pose_file = os.path.join(out_dir, "poses_synthetic.txt")
    poses, _, report = VOSystem(cfg, device=device).run(frames(), pose_file=pose_file)
    _print_report(report, pose_file)
    gt_arr = np.stack(gt)
    ate = absolute_trajectory_error(poses, gt_arr)
    rpe = relative_pose_error(poses, gt_arr)
    print(
        f"ATE-RMSE: {ate.rmse * 100:.2f} cm  (mean {ate.mean * 100:.2f}, "
        f"max {ate.max * 100:.2f})"
    )
    print(f"RPE: {rpe.trans_rmse * 1000:.2f} mm / {rpe.rot_rmse_deg:.4f} deg per frame")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="revo_tpu_torch.run",
        description="edge-based visual odometry on PyTorch / CUDA",
    )
    parser.add_argument("settings", nargs="?", help="algorithm settings yaml")
    parser.add_argument("dataset", nargs="?", help="dataset settings yaml")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="run on an N-frame synthetic sequence")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="out", help="output directory")
    parser.add_argument(
        "--gt", default=None, metavar="FILE",
        help="groundtruth trajectory (TUM format, relative to the dataset dir) "
             "for ATE/RPE evaluation",
    )
    parser.add_argument(
        "--auto-capacity", type=int, default=0, metavar="N",
        help="calibrate edge-cloud capacities from the first N frames "
             "(revo_tpu_torch.autotune)",
    )
    parser.add_argument(
        "--capacity-scale", type=float, default=1.15, metavar="S",
        help="capacity = S * observed max edge count (with --auto-capacity); "
             "S < 1 subsamples edges on purpose (0.65 is the JAX bench's point)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device that runs VO (default cuda; cuda without a card "
             "is an error)",
    )
    for dest, (flag, item) in _NOT_PORTED.items():
        parser.add_argument(flag, dest=dest, nargs="?", const=True, default=None,
                            help=f"not ported yet (ROADMAP {item})")
    args = parser.parse_args(argv)

    for dest, (flag, item) in _NOT_PORTED.items():
        if getattr(args, dest) is not None:
            parser.exit(2, f"revo_tpu_torch.run: {flag} is not ported yet (ROADMAP {item})\n")

    from revo_tpu_torch.config import load_config
    from revo_tpu_torch.kernels import check_device

    device = check_device(args.device)
    cfg = load_config(args.settings, args.dataset)
    os.makedirs(args.out, exist_ok=True)

    if args.synthetic > 0:
        if args.auto_capacity > 0:
            from revo_tpu_torch.io.synthetic import SyntheticScene, render_sequence

            probe = list(render_sequence(SyntheticScene(), cfg.camera, args.auto_capacity,
                                         seed=args.seed))
            cfg = _calibrate(cfg, [f[0] for f in probe], [f[1] for f in probe],
                             args.capacity_scale, device)
        return _run_synthetic(cfg, args.synthetic, args.out, args.seed, device)

    if cfg.dataset.input_type != 0:
        parser.exit(2, "revo_tpu_torch.run: live sensors (INPUT_TYPE "
                       f"{cfg.dataset.input_type}) are not ported yet (ROADMAP P11)\n")
    if not args.dataset:
        parser.error("either provide dataset yaml or --synthetic N")
    if not cfg.dataset.datasets:
        print("[revo_tpu_torch] no datasets listed in config", file=sys.stderr)
        return 1
    for ds in cfg.dataset.datasets:
        _run_dataset(cfg, ds, args.out, device, gt_file=args.gt,
                     auto_capacity=args.auto_capacity, capacity_scale=args.capacity_scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
