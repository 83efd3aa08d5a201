"""CLI entry point: ``python -m revo_tpu_torch.run <settings.yaml> <dataset.yaml>``
(counterpart of revo_tpu/run.py).

Replaces main.cpp:22-48: loads the two-file config, then runs VO over each
dataset listed in the dataset file, writing ``poses_<dataset>.txt`` in TUM
format.  ``--synthetic N`` renders an N-frame synthetic sequence instead and
reports ATE/RPE against its exact ground truth.  With ``INPUT_TYPE`` 1/2/3
(settings yaml or ``--input-type``) it tracks a live sensor through the
native V4L2 engine, or recorded sessions of one through the engine's replay
shim.  Everything runs on ``--device`` (default ``cuda``); a CUDA device on a
machine without one is an error, never a quiet CPU run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

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


def _evaluate_against_gt(poses, stamps, ds_dir, gt_file, out_dir) -> None:
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
    try:
        from revo_tpu_torch.viz import plot_error, plot_trajectory

        plot_trajectory(os.path.join(out_dir, "trajectory_vs_gt.png"), est, gt)
        plot_error(os.path.join(out_dir, "ate_error_vs_gt.png"), est, gt)
    except ImportError:  # no matplotlib: the numbers above are the result
        pass


def _reanchor(vo, ring_poses) -> np.ndarray:
    """Every frame of the run re-anchored to its parent keyframe's pose in
    ``ring_poses`` (one per retained keyframe, in ``vo.kf_history`` order);
    frames of keyframes no longer retained keep their anchor."""
    all_kf = {o: ring_poses[i] for i, (o, _) in enumerate(vo.kf_history)}
    return np.stack([
        all_kf.get(node.kf_ordinal, node.T_w_kf) @ node.T_kf_curr for node in vo.pose_graph
    ])


def _maybe_export_ply(vo, poses, out_dir) -> None:
    """Map model export, the reference viewer's saveModel
    (MapDrawer.h:97-170) without a GUI: the edge-sparse colored cloud of
    every retained keyframe (transformed to world), the keyframe frusta and
    the trajectory polyline, all as PLY."""
    from revo_tpu_torch.frontend import generate_colored_pcl
    from revo_tpu_torch.viz.ply import (
        export_colored_pcl_ply,
        export_keyframe_frusta_ply,
        export_trajectory_ply,
    )

    kf_poses = [kf.T_w_k.detach().cpu().numpy() for _, kf in vo.kf_history]
    pts_all, clr_all = [], []
    for (_, kf), T in zip(vo.kf_history, kf_poses):
        pts, clr = generate_colored_pcl(kf.frame, vo.cfg)
        pts_all.append(pts @ T[:3, :3].T + T[:3, 3])
        clr_all.append(clr)
    if pts_all:
        export_colored_pcl_ply(
            os.path.join(out_dir, "map_cloud.ply"),
            np.concatenate(pts_all), np.concatenate(clr_all),
        )
    export_keyframe_frusta_ply(os.path.join(out_dir, "map_keyframes.ply"), kf_poses)
    export_trajectory_ply(os.path.join(out_dir, "trajectory.ply"), np.asarray(poses))
    print(f"[revo_tpu_torch] PLY model written to {out_dir}/map_cloud.ply, "
          f"map_keyframes.ply, trajectory.ply")


def _maybe_windowed_ba(vo, poses, loop_edges=None, ring_poses0=None):
    """Post-run windowed joint refinement over the retained keyframes (the
    BA the reference stubs out); returns re-anchored poses.

    ``loop_edges`` / ``ring_poses0``: when loop closure ran first, its
    verified revisit edges enter the refinement as residual pairs and its
    corrected ring poses seed the optimization."""
    from revo_tpu_torch.parallel.windowed import refine_keyframes

    if len(vo.kf_history) < 2:
        print("[revo_tpu_torch] windowed BA: <2 keyframes retained; skipping")
        return poses
    kfs = [kf for _, kf in vo.kf_history]
    extra = [(e.a, e.b, 2.0) for e in (loop_edges or [])]
    refined = refine_keyframes(kfs, vo.cfg, extra_pairs=extra, poses0=ring_poses0)
    print(f"[revo_tpu_torch] windowed BA: refined {len(kfs)} keyframes "
          f"(coarse-to-fine joint LM"
          + (f", {len(extra)} loop edge(s) as residual pairs" if extra else "") + ")")
    return _reanchor(vo, refined)


def _maybe_close_loops(vo, poses, return_detail: bool = False):
    """Post-run loop closure over the retained keyframes (a SLAM step the
    reference lacks); returns the poses, corrected where a loop verified,
    and with ``return_detail`` also (verified loop edges, corrected ring
    poses) for windowed BA to take."""
    from revo_tpu_torch.loopclosure import close_loops

    if vo.n_keyframes < 3 or len(vo.kf_history) < 3:
        print("[revo_tpu_torch] loop closure: <3 keyframes retained; skipping")
        return (poses, [], None) if return_detail else poses
    corrected, loops = close_loops([kf for _, kf in vo.kf_history], vo.cfg)
    if not loops:
        print("[revo_tpu_torch] loop closure: no verified loop edges")
        return (poses, [], None) if return_detail else poses
    print(f"[revo_tpu_torch] loop closure: {len(loops)} edge(s) "
          f"{[(e.a, e.b) for e in loops]}")
    out = _reanchor(vo, corrected)
    return (out, loops, corrected) if return_detail else out


def _post_run_refinement(vo, poses, windowed_ba_flag: bool, close_loops_flag: bool):
    """The post-run SLAM refinement the flags ask for.  With both, loop
    closure runs first and its verified edges and corrected poses feed the
    windowed BA."""
    loops, ring0 = [], None
    if close_loops_flag:
        poses, loops, ring0 = _maybe_close_loops(vo, poses, return_detail=True)
    if windowed_ba_flag:
        poses = _maybe_windowed_ba(vo, poses, loop_edges=loops, ring_poses0=ring0)
    return poses


def _maybe_viewer(live_view: bool, out_dir: str):
    if not live_view:
        return None
    from revo_tpu_torch.viz.live import LiveViewer

    return LiveViewer(out_dir)


def _run_vo(vo, frames, pose_file, live_view: bool, out_dir: str):
    """``vo.run`` with the live viewer when asked for, then the VO report."""
    viewer = _maybe_viewer(live_view, out_dir)
    poses, stamps, report = vo.run(frames, pose_file=pose_file, viewer=viewer)
    if viewer is not None:
        viewer.close()
        print(f"Live view written to {out_dir}/live/index.html")
    _print_report(report, pose_file)
    return poses, stamps


def _run_dataset(cfg, dataset, out_dir, device, gt_file=None, auto_capacity=0,
                 capacity_scale=1.15, close_loops_flag=False, live_view=False,
                 windowed_ba_flag=False, export_ply=False) -> None:
    from revo_tpu_torch.io import native_loader
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

    # Which host decoder reads the PNGs: the native threaded prefetcher
    # (replaces the reference's IO thread) where its library is available,
    # OpenCV otherwise.  Either way uint8 / uint16 frames go to the device
    # raw and convert there.
    if native_loader.native_available():
        def frames():
            rgb = [os.path.join(ds_dir, a.rgb_path) for a in assocs]
            dep = [os.path.join(ds_dir, a.depth_path) for a in assocs]
            shape = (cfg.camera.height, cfg.camera.width)
            with native_loader.NativePrefetcher(rgb, dep, shape) as pf:
                for i, a in enumerate(assocs):
                    gray_u8, depth_u16 = pf.get(i)
                    yield gray_u8, depth_u16, a.rgb_ts
    else:
        def frames():
            for a in assocs:
                yield load_tum_frame_raw(ds_dir, a)

    pose_file = os.path.join(out_dir, f"poses_{dataset}.txt")
    vo = VOSystem(cfg, device=device)
    poses, stamps = _run_vo(vo, frames(), pose_file, live_view, out_dir)
    poses = _post_run_refinement(vo, poses, windowed_ba_flag, close_loops_flag)
    if export_ply:
        _maybe_export_ply(vo, poses, out_dir)
    if gt_file:
        _evaluate_against_gt(poses, stamps, ds_dir, gt_file, out_dir)


def _run_live(cfg, input_type: int, out_dir: str, device, color_dev: str, depth_dev: str,
              replay_color=None, replay_depth=None, max_frames: int = 0,
              close_loops_flag: bool = False, live_view: bool = False,
              windowed_ba_flag: bool = False, export_ply: bool = False,
              record_dir=None) -> None:
    """INPUT_TYPE 1/2/3: live-sensor VO through the native V4L2 engine (the
    reference's live modalities, iowrapperRGBD.h:56-102).  Frames arrive as
    uint8 gray and raw uint16 depth and go to the device as they are.

    ``replay_color`` / ``replay_depth`` route the engine at recorded session
    files through the replay shim: the same engine path without hardware
    (field-capture debugging; also how the tests drive this)."""
    from revo_tpu_torch.io import sensors
    from revo_tpu_torch.system import VOSystem

    if replay_color:
        mapping = {color_dev: replay_color}
        if replay_depth:
            mapping[depth_dev] = replay_depth
        sensors.use_replay(mapping)
    cam = sensors.open_sensor(
        input_type, color_dev=color_dev, depth_dev=depth_dev,
        width=cfg.camera.width, height=cfg.camera.height,
        warmup=0 if replay_color else None,
    )
    print(f"[revo_tpu_torch] live sensor: {cam.profile.name} "
          f"(INPUT_TYPE={input_type}) {cam.width}x{cam.height}")

    def frames():
        rec = None
        if record_dir:
            from revo_tpu_torch.io.recorder import TUMRecorder

            rec = TUMRecorder(record_dir)
        try:
            for i, (gray, depth, ts) in enumerate(cam):
                if max_frames and i >= max_frames:
                    break
                if rec is not None:
                    rec.add(gray, depth, ts)
                yield gray, depth, ts
        finally:
            if rec is not None:
                rec.close()

    vo = VOSystem(cfg, device=device)
    pose_file = os.path.join(out_dir, "poses_live.txt")
    poses, _ = _run_vo(vo, frames(), pose_file, live_view, out_dir)
    cam.close()
    poses = _post_run_refinement(vo, poses, windowed_ba_flag, close_loops_flag)
    if export_ply:
        _maybe_export_ply(vo, poses, out_dir)


def _run_synthetic(cfg, n_frames: int, out_dir: str, seed: int, device,
                   close_loops_flag: bool = False, live_view: bool = False,
                   windowed_ba_flag: bool = False, export_ply: bool = False) -> int:
    from revo_tpu_torch.eval import absolute_trajectory_error, relative_pose_error
    from revo_tpu_torch.io.synthetic import SyntheticScene, render_sequence
    from revo_tpu_torch.system import VOSystem

    gt = []

    def frames():
        for gray, depth, T, ts in render_sequence(SyntheticScene(), cfg.camera, n_frames, seed=seed):
            gt.append(T)
            yield gray, depth, ts

    pose_file = os.path.join(out_dir, "poses_synthetic.txt")
    vo = VOSystem(cfg, device=device)
    poses, _ = _run_vo(vo, frames(), pose_file, live_view, out_dir)
    poses = _post_run_refinement(vo, poses, windowed_ba_flag, close_loops_flag)
    if export_ply:
        _maybe_export_ply(vo, poses, out_dir)
    gt_arr = np.stack(gt)
    try:
        from revo_tpu_torch.viz import plot_error, plot_trajectory

        plot_trajectory(os.path.join(out_dir, "trajectory.png"), poses, gt_arr,
                        title="synthetic VO")
        plot_error(os.path.join(out_dir, "ate_error.png"), poses, gt_arr)
        print(f"Plots written to {out_dir}/trajectory.png, ate_error.png")
    except ImportError:  # no matplotlib: the numbers below are the result
        pass
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
    parser.add_argument(
        "--close-loops", action="store_true",
        help="post-run loop closure over the retained keyframes: verified "
             "revisits correct the trajectory by pose-graph optimization",
    )
    parser.add_argument(
        "--windowed-ba", action="store_true",
        help="post-run windowed joint refinement of the retained keyframes "
             "(parallel.windowed; raise KF_HISTORY_SIZE to retain more); with "
             "--close-loops the verified loop edges enter as residual pairs",
    )
    parser.add_argument(
        "--export-ply", action="store_true",
        help="export the map model as PLY (colored keyframe cloud, keyframe "
             "frusta, trajectory)",
    )
    parser.add_argument(
        "--live-view", action="store_true",
        help="render live progress (trajectory + reprojection overlay + 3-D "
             "map + auto-refreshing index.html) to OUT/live/ on a background "
             "thread while the run progresses: the headless equivalent of "
             "the reference's Pangolin viewer thread",
    )
    parser.add_argument(
        "--input-type", type=int, default=None, metavar="N",
        help="live-sensor modality override (reference INPUT_TYPE, "
             "iowrapperRGBD.h:56-102): 1 = Orbbec Astra Pro, 2 = RealSense, "
             "3 = Orbbec Astra; default comes from the settings yaml "
             "(INPUT_TYPE, 0 = dataset files)",
    )
    parser.add_argument("--color-dev", default="/dev/video0",
                        help="V4L2 color device (live modes)")
    parser.add_argument("--depth-dev", default="/dev/video1",
                        help="V4L2 depth device (live modes)")
    parser.add_argument(
        "--replay-color", default=None, metavar="FILE",
        help="serve the color device from a recorded session file through "
             "the engine's replay shim (hardware-free live mode)",
    )
    parser.add_argument("--replay-depth", default=None, metavar="FILE",
                        help="session file for the depth device")
    parser.add_argument("--max-frames", type=int, default=0,
                        help="stop the live run after N frames (0 = until "
                             "the stream ends)")
    parser.add_argument(
        "--record", default=None, metavar="DIR",
        help="record the live stream as a TUM-format capture while "
             "tracking (DO_RECORD_IMAGES, iowrapperRGBD.cpp:181-217)",
    )
    args = parser.parse_args(argv)

    from revo_tpu_torch.config import load_config
    from revo_tpu_torch.kernels import check_device

    device = check_device(args.device)
    cfg = load_config(args.settings, args.dataset)
    if args.export_ply or args.live_view:
        # The colored-map surfaces read keyframe images from the retained
        # history; everything else runs with pruned keyframes
        # (frontend.prune_keyframe).
        cfg = dataclasses.replace(
            cfg, tracker=dataclasses.replace(cfg.tracker, store_kf_images=True)
        )
    os.makedirs(args.out, exist_ok=True)

    if args.synthetic > 0:
        if args.auto_capacity > 0:
            from revo_tpu_torch.io.synthetic import SyntheticScene, render_sequence

            probe = list(render_sequence(SyntheticScene(), cfg.camera, args.auto_capacity,
                                         seed=args.seed))
            cfg = _calibrate(cfg, [f[0] for f in probe], [f[1] for f in probe],
                             args.capacity_scale, device)
        return _run_synthetic(cfg, args.synthetic, args.out, args.seed, device,
                              close_loops_flag=args.close_loops, live_view=args.live_view,
                              windowed_ba_flag=args.windowed_ba, export_ply=args.export_ply)

    input_type = args.input_type if args.input_type is not None else cfg.dataset.input_type
    if input_type != 0:
        _run_live(cfg, input_type, args.out, device, args.color_dev, args.depth_dev,
                  replay_color=args.replay_color, replay_depth=args.replay_depth,
                  max_frames=args.max_frames, close_loops_flag=args.close_loops,
                  live_view=args.live_view, windowed_ba_flag=args.windowed_ba,
                  export_ply=args.export_ply, record_dir=args.record)
        return 0
    if not args.dataset:
        parser.error("either provide dataset yaml or --synthetic N")
    if not cfg.dataset.datasets:
        print("[revo_tpu_torch] no datasets listed in config", file=sys.stderr)
        return 1
    for ds in cfg.dataset.datasets:
        _run_dataset(cfg, ds, args.out, device, gt_file=args.gt,
                     auto_capacity=args.auto_capacity, capacity_scale=args.capacity_scale,
                     close_loops_flag=args.close_loops, live_view=args.live_view,
                     windowed_ba_flag=args.windowed_ba, export_ply=args.export_ply)
    return 0


if __name__ == "__main__":
    sys.exit(main())
