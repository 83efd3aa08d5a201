"""The end-to-end statistics: a rate over all the work and all the time of
the window, and a p95 over every step, each moved by one stalled step; and
the roofline's byte counts against PERF.md section 6's 640x480 figures."""
from __future__ import annotations

import time

from vobench import harness, roofline


class _Steps:
    """A driver whose steps take ``ms`` each, one of them ``stall_ms``."""

    def __init__(self, ms: float, stall_at=None, stall_ms: float = 0.0):
        self.ms, self.stall_at, self.stall_ms, self.n = ms, stall_at, stall_ms, 0
        self.dropped = 0

    def step(self):
        self.n += 1
        time.sleep((self.stall_ms if self.n == self.stall_at else self.ms) / 1e3)

    def drop_last(self):
        self.dropped += 1


def test_rate_and_p95_move_with_one_stalled_step():
    seconds = 0.4
    calm, _ = harness.run_window(_Steps(20.0), seconds)
    stalled, _ = harness.run_window(_Steps(20.0, stall_at=5, stall_ms=150.0), seconds)
    assert len(stalled) < len(calm)  # the rate counts the whole window
    assert harness.percentile(stalled, 95) > 2 * harness.percentile(calm, 95)


def test_step_after_the_window_is_not_counted():
    drv = _Steps(30.0)
    durations, start = harness.run_window(drv, 0.2)
    assert drv.dropped == 1 and drv.n == len(durations) + 1
    assert sum(durations) <= 0.2 + 1e-3


def test_byte_counts_match_perf_md_640x480():
    # PERF.md section 6: canny_fused's bound 0.00018 ms from bytes (gray in,
    # edges out); the column pass 3 levels' edges 0.40 MB and g^2 1.61 MB;
    # the rows at level 0 g^2 1.23, structure 3.69, dt4bf quad 2.46 MB.
    assert roofline.canny_fused_bytes(1, 480, 640) == 614400
    assert round(roofline.least_seconds(614400) * 1e3, 5) == 0.00018
    shapes = [(1, 480, 640), (1, 240, 320), (1, 120, 160)]
    edges = sum(b * h * w for b, h, w in shapes)
    assert round(edges / 1e6, 2) == 0.40 and round(4 * edges / 1e6, 2) == 1.61
    level0 = roofline.keyframe_tables_bytes([(1, 480, 640)], "dt4bf")
    assert level0 == 307200 * (1 + 4 + 12 + 8)
    assert round(307200 * 12 / 1e6, 2) == 3.69 and round(307200 * 8 / 1e6, 2) == 2.46


def test_share_needs_a_time():
    assert roofline.share(1e6, None) is None
    assert abs(roofline.share(3.35e6, 1e-6) - 100.0) < 1e-9
