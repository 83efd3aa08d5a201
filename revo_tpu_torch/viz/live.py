"""Incremental during-run visualization — the live-viewer substitute
(counterpart of revo_tpu/viz/live.py).

The reference spawns a Pangolin viewer thread that renders the map,
trajectory and current camera at ~30 fps while tracking runs
(gui/Viewer.cc:61-168, thread spawned system.cpp:39).  A headless run
renders to files on a background thread instead: a trajectory plot, the
current reprojection-residual overlay (DO_SHOW_DEBUG_IMAGE equivalent), a
3-D map pane, a rolling metrics line, and an auto-refreshing index.html —
open it in any browser (or watch the PNGs) to follow the run live.

Decoupling mirrors the reference's design: the tracking thread only
enqueues snapshots (never blocks, drops frames when the renderer is behind
— like a real viewer), and a daemon thread does all matplotlib/IO work.
A snapshot is host numpy only.  The tracking thread takes it, and only for
a frame it is about to enqueue: a device-to-host copy from the render
thread would queue behind the tracker's stream, and ``np.asarray`` of a
CUDA tensor raises.  Each retained keyframe's cloud is copied once, keyed
by ordinal.  The render thread touches no tensor.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np

_INDEX_HTML = """<!DOCTYPE html>
<html><head><meta http-equiv="refresh" content="1">
<title>revo_tpu_torch live</title>
<style>body{{background:#111;color:#ddd;font-family:monospace}}
img{{max-width:48%;border:1px solid #444;margin:4px}}</style></head>
<body>
<h3>revo_tpu_torch live viewer</h3>
<pre id="status">{status}</pre>
<img src="trajectory.png?ts={ts}"><img src="overlay.png?ts={ts}">
<img src="map.png?ts={ts}">
</body></html>
"""

_MAX_CLOUDS = 64  # bound on the accumulated map (oldest evicted first)


class LiveViewer:
    """Background renderer of run progress.

    Usage::

        viewer = LiveViewer(out_dir, every=5)
        ...
        viewer.update(vo, frame, pose, frame_idx)   # non-blocking
        ...
        viewer.close()
    """

    def __init__(self, out_dir: str, every: int = 5):
        self.dir = os.path.join(out_dir, "live")
        os.makedirs(self.dir, exist_ok=True)
        self.every = max(1, every)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        # Per-keyframe decimated colored clouds in CAMERA frame, keyed by
        # ordinal (copied once per keyframe on the tracking thread; world
        # placement re-applies the CURRENT ring pose each render so loop
        # -closure corrections move the map).  Evicted keyframes keep
        # their last-known pose — the accumulated map a MapDrawer shows.
        self._cloud_cache: dict = {}
        self._kf_pose_cache: dict = {}
        # Tracking-thread side: ordinals whose cloud was already handed
        # over, and the current keyframe's overlay inputs.
        self._sent: set = set()
        self._kf_inputs = (None, None)  # (ordinal, (gray, dt))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- producer side (tracking thread) ----------------------------------

    def update(self, vo, frame, pose: np.ndarray, frame_idx: int) -> None:
        """Enqueue a snapshot every ``every`` frames; never blocks.

        ``vo`` is the VOSystem (pose graph, current keyframe and retained
        keyframes are read here, on the tracking thread, and copied to the
        host, so the render thread touches neither live state nor the
        device), ``frame`` the just-built device Frame.
        """
        if frame_idx % self.every or self._q.full():
            return  # not due, or the renderer is behind: drop, like a real viewer
        from revo_tpu_torch.viz.debug import frame_inputs, keyframe_inputs

        overlay = None
        if vo.kf is not None and frame is not None:
            if self._kf_inputs[0] != vo.kf_ordinal_current:
                self._kf_inputs = (vo.kf_ordinal_current, keyframe_inputs(vo.kf))
            overlay = (
                *self._kf_inputs[1], *frame_inputs(frame),
                vo.kf.T_w_k.detach().cpu().numpy(),
            )
        snap = {
            "poses": np.stack([n.T_w_curr for n in vo.pose_graph])
            if vo.pose_graph
            else np.eye(4)[None],
            "overlay": overlay,
            "pose": np.asarray(pose),
            "cfg": vo.cfg,
            "idx": frame_idx,
            "n_kf": vo.n_keyframes,
            "n_lost": vo.n_tracking_lost,
            "kf_ring": self._ring_snapshot(vo),
        }
        self._q.put_nowait(snap)  # one producer, and the queue had room

    def _ring_snapshot(self, vo):
        """[(ordinal, T_w_k float64, cloud or None)] of the retained
        keyframes: the cloud (decimated, camera frame) only the first time
        an ordinal is handed over."""
        import torch

        from revo_tpu_torch.frontend import generate_colored_pcl

        ring = list(vo.kf_history)
        if not ring:
            return []
        kf_poses = torch.stack([kf.T_w_k for _, kf in ring]).detach().cpu().numpy()
        out = []
        for (ordinal, kf), T in zip(ring, kf_poses):
            cloud = None
            if ordinal not in self._sent:
                lvl = min(1, len(kf.frame.levels) - 1)  # half-res: plenty
                pts, cols = generate_colored_pcl(kf.frame, vo.cfg, lvl)
                step = max(1, len(pts) // 1500)  # decimate for the pane
                cloud = (pts[::step].astype(np.float32), cols[::step].astype(np.float32))
                self._sent.add(ordinal)
                while len(self._sent) > _MAX_CLOUDS:
                    self._sent.discard(min(self._sent))
            out.append((ordinal, T.astype(np.float64), cloud))
        return out

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    # -- render side (daemon thread) ---------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set() or not self._q.empty():
            try:
                snap = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._render(snap)
            except Exception as e:  # viewer must never kill the run
                with open(os.path.join(self.dir, "viewer_errors.log"), "a") as f:
                    f.write(f"frame {snap.get('idx')}: {e!r}\n")

    def _render(self, snap) -> None:
        from revo_tpu_torch.viz.debug import overlay_from_arrays
        from revo_tpu_torch.viz.plot import plot_trajectory

        # A pane whose library is not installed is left out, as ``run``
        # leaves out its plots (matplotlib: trajectory and map; OpenCV: the
        # overlay's PNG); anything else that fails is an error.
        try:
            plot_trajectory(
                os.path.join(self.dir, "trajectory.png"),
                snap["poses"],
                title=f"frame {snap['idx']}",
            )
        except ImportError:
            pass
        if snap["overlay"] is not None:
            gray, dt, pts, valid, T_w_k = snap["overlay"]
            T_kf_cur = np.linalg.inv(T_w_k) @ snap["pose"]
            overlay_from_arrays(
                gray, dt, pts, valid,
                T_kf_cur[:3, :3],
                T_kf_cur[:3, 3],
                snap["cfg"].camera_pyramid()[0],
                out_png=os.path.join(self.dir, "overlay.png"),
            )
        try:
            self._render_map(snap)
        except ImportError:
            pass
        status = (
            f"frame {snap['idx']}  keyframes {snap['n_kf']}  "
            f"lost {snap['n_lost']}  "
            f"t = {np.round(snap['pose'][:3, 3], 4).tolist()}"
        )
        with open(os.path.join(self.dir, "index.html"), "w") as f:
            f.write(_INDEX_HTML.format(status=status, ts=snap["idx"]))

    def _render_map(self, snap) -> None:
        """The 3-D map pane: keyframe frusta + decimated colored cloud
        under a camera-follow projection (MapDrawer.cc:48-180 analog)."""
        from revo_tpu_torch.viz.map3d import render_map_png

        for ordinal, T_w_k, cloud in snap["kf_ring"]:
            if cloud is not None:
                self._cloud_cache[ordinal] = cloud
                while len(self._cloud_cache) > _MAX_CLOUDS:
                    self._cloud_cache.pop(min(self._cloud_cache))
                    self._kf_pose_cache.pop(min(self._kf_pose_cache), None)
            self._kf_pose_cache[ordinal] = T_w_k
        clouds = []
        kf_poses = []
        for ordinal, (pts_cam, cols) in self._cloud_cache.items():
            T = self._kf_pose_cache.get(ordinal)
            if T is None:
                continue
            kf_poses.append(T)
            clouds.append((pts_cam @ T[:3, :3].T + T[:3, 3], cols))
        render_map_png(
            os.path.join(self.dir, "map.png"),
            clouds,
            np.stack(kf_poses) if kf_poses else np.eye(4)[None],
            snap["poses"],
            snap["pose"].astype(np.float64),
            title=f"map @ frame {snap['idx']} ({len(kf_poses)} keyframes)",
        )
