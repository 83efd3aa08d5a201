"""ATE of the JAX package and of the port (both on the CPU) over
chip_smoke.py's phase 7 sequence: the 20-frame 640x480 pan and the
teleport frame with the motion prior poisoned, rendered from the same seeds.
The reference ATEs that chip_smoke.py's VOSystem limits are 1.5 times of
come from here.

    JAX_PLATFORMS=cpu python scripts/pan_teleport_ate.py [QUAD_FORM [BILINEAR_IMPL]]

Defaults: the default SystemConfig ("dt4bf", "quad_lf").  Prints one JSON
line: each package's ATE and flags (promoted, relocalized, lost summed),
whether the flags agree frame by frame, and the largest translation gap.
About 30 s for "flatbf" on a 4-core host.
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from revo_tpu import system as jsystem  # noqa: E402
from revo_tpu_torch.config import SystemConfig  # noqa: E402
from revo_tpu_torch.eval import absolute_trajectory_error  # noqa: E402
from revo_tpu_torch.io import synthetic as syn  # noqa: E402
from revo_tpu_torch.system import VOSystem  # noqa: E402


def main(form: str = "dt4bf", impl: str = "quad_lf") -> None:
    base = SystemConfig()
    cfg = dataclasses.replace(base, tracker=dataclasses.replace(
        base.tracker, optimizer=dataclasses.replace(
            base.tracker.optimizer, quad_form=form, bilinear_impl=impl)))
    # chip_smoke.py renders the pan after the 8-frame chain: seeds 8, 9, ...
    rendered = [(*syn.render_frame(syn.SyntheticScene(), cfg.camera, T, seed=cs.N_FRAMES + k),
                 T, k / 30.0) for k, T in enumerate(cs.pan_sequence(cs.N_PAN))]
    grays, depths, gt = cs._sensor_frames(rendered, cfg)
    from revo_tpu import config as J

    jcfg = J.SystemConfig(
        camera=J.CameraConfig(**dataclasses.asdict(cfg.camera)),
        pyramid=J.PyramidConfig(**dataclasses.asdict(cfg.pyramid)),
        tracker=J.TrackerConfig(**{**dataclasses.asdict(cfg.tracker),
                                   "optimizer": J.OptimizerConfig(
                                       **dataclasses.asdict(cfg.tracker.optimizer))}),
        dataset=J.DatasetConfig(**dataclasses.asdict(cfg.dataset)))
    torch.set_num_threads(1)
    p_port, f_port, _ = cs.run_teleport(VOSystem(cfg, device="cpu"), grays, depths, None,
                                        torch.from_numpy)
    p_jax, f_jax, _ = cs.run_teleport(jsystem.VOSystem(jcfg), grays, depths, None, jnp.asarray)
    print(json.dumps({
        "quad_form": form, "bilinear_impl": impl, "frames": len(grays),
        "jax_ate_m": absolute_trajectory_error(p_jax, gt).rmse,
        "port_ate_m": absolute_trajectory_error(p_port, gt).rmse,
        "jax_flags": f_jax.sum(0).tolist(), "port_flags": f_port.sum(0).tolist(),
        "flags_equal": bool(np.array_equal(f_jax, f_port)),
        "max_translation_gap_m": float(np.abs(p_jax[:, :3, 3] - p_port[:, :3, 3]).max()),
    }))


if __name__ == "__main__":
    main(*sys.argv[1:3])
