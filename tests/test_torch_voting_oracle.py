"""The port's histogram vote against a numpy transcription of the reference's
loops (assessTrackingQuality, tracker.cpp:118-201): the twin of
tests/test_voting_oracle.py, on the same frames (three past frames 1 cm apart
in the default synthetic scene, 160x120) and the same query poses (the last
past pose, drifted by 0.15 m and by 5 m along x).  The oracle below is this
file's own copy of the C++ loops, not an import.  The vote is a bool and
must equal the oracle's exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from revo_tpu_torch import tracker
from revo_tpu_torch.config import CameraConfig, SystemConfig
from revo_tpu_torch.frontend import build_frame
from revo_tpu_torch.io.synthetic import SyntheticScene, render_frame

torch.set_num_threads(1)

QUERY_DRIFTS_M = (0.0, 0.15, 5.0)


def _reference_voting(past_pts, past_valid, past_poses, n_past, est_pose,
                      depth, edges, cam, depth_min, depth_max, weights):
    """tracker.cpp:138-200 in numpy: each past frame's valid edge points
    projected into the query pose mark a counting map once per frame; the
    histogram of the map over pixels with valid depth, and its share on the
    query's original edges, decide whether a new keyframe is needed."""
    h, w = depth.shape
    M = np.zeros((h, w), np.int32)
    for s in range(min(n_past, len(past_pts))):
        T = np.linalg.inv(est_pose) @ past_poses[s]
        R, t = T[:3, :3], T[:3, 3]
        Mi = np.zeros((h, w), np.int32)
        for p in past_pts[s][past_valid[s]]:
            q = R @ p + t
            u = q[0] / q[2] * cam.fx + cam.cx
            v = q[1] / q[2] * cam.fy + cam.cy
            if 0 <= u < w and 0 <= v < h:
                Mi[int(np.floor(v)), int(np.floor(u))] = 1
        M += Mi
    histogram = np.zeros(len(past_pts) + 1)
    overlaps = np.zeros(len(past_pts) + 1)
    for yy in range(h):
        for xx in range(w):
            z = depth[yy, xx]
            if np.isfinite(z) and depth_min < z < depth_max:
                val = M[yy, xx]
                histogram[val] += 1
                if edges[yy, xx]:
                    overlaps[val] += 1
    overlap_measure = sum(overlaps[k] * weights[k] for k in range(1, len(overlaps)))
    if n_past < 3:
        return False  # the histogram.size() < 4 guard
    return overlap_measure < overlaps[0]


@pytest.fixture(scope="module")
def voting_setup():
    """tests/test_voting_oracle.py's three past frames and query frame."""
    base = SystemConfig()
    cfg = dataclasses.replace(  # tests/test_solver.py's small_cfg
        base, camera=CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120),
        pyramid=dataclasses.replace(base.pyramid, edge_capacity=(4096, 2048, 1024)))
    scene = SyntheticScene()
    lvl = cfg.tracker.histogram_level
    past = tracker.empty_past(3, cfg.pyramid.edge_capacity[lvl], "cpu")
    poses, pts, valid = [], [], []
    for i in range(3):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.01 * i
        g, d = render_frame(scene, cfg.camera, T)
        cloud = build_frame(torch.from_numpy(g), torch.from_numpy(d), cfg).levels[lvl].cloud
        past = tracker.push_past(past, cloud.points, cloud.valid, torch.from_numpy(T))
        pts.append(cloud.points.numpy())
        valid.append(cloud.valid.numpy())
        poses.append(T)
    gq, dq = render_frame(scene, cfg.camera, poses[-1])
    query = build_frame(torch.from_numpy(gq), torch.from_numpy(dq), cfg)
    return cfg, past, (pts, valid, poses), query


def _votes(voting_setup, dx):
    cfg, past, (pts, valid, poses), query = voting_setup
    lvl = cfg.tracker.histogram_level
    est = poses[-1].copy()
    est[0, 3] += dx
    got = tracker.assess_tracking_quality(past, torch.from_numpy(est), query, cfg)
    want = _reference_voting(
        pts, valid, poses, 3, est, query.levels[lvl].depth.numpy(),
        query.levels[lvl].edges_orig.numpy(), cfg.camera_pyramid()[lvl],
        cfg.pyramid.depth_min, cfg.pyramid.depth_max, cfg.tracker.hist_weights)
    return got, want


@pytest.mark.parametrize("dx", QUERY_DRIFTS_M)
def test_vote_matches_reference_loops(voting_setup, dx):
    got, want = _votes(voting_setup, dx)
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == want, f"dx={dx}: port {bool(got)}, reference loops {want}"


def test_votes_tell_the_query_poses_apart(voting_setup):
    """The matching pose keeps the keyframe and the far-off one asks for a
    new one, so the cases above hold the vote on both of its outcomes."""
    assert [_votes(voting_setup, dx)[1] for dx in (QUERY_DRIFTS_M[0], QUERY_DRIFTS_M[-1])] == [
        False, True]
