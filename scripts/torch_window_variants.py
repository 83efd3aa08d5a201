"""Windowed BA schedules of the PyTorch port on chip_smoke.py phase 12's six
perturbed pan keyframes at 640x480, on one CUDA card.

    python3 scripts/torch_window_variants.py

Prints the largest keyframe translation error (m) before refinement, after
``refine_keyframes`` with overlap and with ring pairs, and in mm per level
for coarse-to-fine chains of ``optimize_window`` over the +-radius index ring
(the pairs ``optimize_window_sharded`` takes) at each combination of radius,
evaluations per level and initial lambda.  chip_smoke.py phase 17 gates the
sharded window on one of these schedules.  Imports no jax.
"""
import importlib.util
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from revo_tpu_torch.config import SystemConfig
    from revo_tpu_torch.io.synthetic import SyntheticScene
    from revo_tpu_torch.parallel import windowed as W

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, scene = SystemConfig(), SyntheticScene()
    traj = cs.pan_sequence(cs.N_PAN)
    idx = list(cs.BA_FRAMES)
    jobs = [(scene, cfg.camera, traj[i], cs.N_FRAMES + i) for i in idx]
    rendered = cs.render_jobs(jobs, workers=6)
    dev = torch.device("cuda")
    grays, depths, _ = cs._sensor_frames(rendered, cfg)
    ba_gt = traj[idx].astype(np.float32)
    stored = cs.perturbed_poses(ba_gt)
    kfs = cs.ba_keyframes(cfg, dev, grays, depths, stored)
    cams, opt = cfg.camera_pyramid(), cfg.tracker.optimizer
    print(cs._smi(), flush=True)
    print("before", cs.max_translation_error(stored, ba_gt), flush=True)
    for pairs in ("overlap", "ring"):
        refined = W.refine_keyframes(kfs, cfg, pairs=pairs)
        print(f"refine {pairs}", cs.max_translation_error(refined, ba_gt), flush=True)

    def chain(levels, radius, iters, damping):
        poses, errs = torch.from_numpy(stored).to(dev), []
        for lvl in levels:
            win = W.keyframe_window(kfs, lvl, poses)
            poses, _ = W.optimize_window(win, *W.make_pairs(len(kfs), radius, device=dev),
                                         cams[lvl], opt, lvl=lvl, iters=iters, damping=damping)
            errs.append(round(cs.max_translation_error(poses.cpu().numpy(), ba_gt) * 1e3, 3))
        return errs

    for levels in ((2, 1, 0), (0,)):
        for radius in (1, 2, 5):
            for iters in (6, 24):
                for damping in (1.0, 0.1):
                    t0 = time.time()
                    print("levels", levels, "radius", radius, "iters", iters, "damping", damping,
                          "mm per level", chain(levels, radius, iters, damping),
                          round(time.time() - t0, 2), flush=True)


if __name__ == "__main__":
    main()
