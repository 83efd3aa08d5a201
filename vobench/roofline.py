"""The yardstick of the kernels' roofline shares: the card's peaks, the
bytes and operations a kernel's call needs, computed from its shapes, and
the device time of one call, timed alone.

Bytes count each input read once and each output written once, as PERF.md
section 6 counts them; the least time is bytes over the peak bandwidth (or
operations over the peak rate, the larger), and a share is that least time
over the measured device time, in percent.
"""
from __future__ import annotations

import time

import torch

# NVIDIA H100 SXM5 80 GB (data sheet, 700 W): HBM3 bandwidth and float32 rate
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SPIN_CYCLES = 20_000_000  # ~10 ms: holds the stream while the host queues a call


def canny_fused_bytes(b: int, h: int, w: int) -> int:
    """uint8 gray in, bool edges out."""
    return b * h * w * (1 + 1)


QUAD_BYTES = {"dt4bf": 4 * 2, "dt4": 4 * 4}


def keyframe_tables_bytes(shapes, form: str) -> int:
    """Per level (B, H, W): bool edges in; the column pass's g^2 (float32)
    written once; the structure (3 float32) and the quad table out."""
    return sum(b * h * w * (1 + 4 + 12 + QUAD_BYTES[form]) for b, h, w in shapes)


def least_seconds(n_bytes: float, flops: float = 0.0) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def device_seconds(fn, reps: int = 5):
    """The median device time of one call of ``fn``, each call queued behind
    a spin kernel so that the events bracket its kernels alone; None if the
    host was still queueing when a spin ended."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        fn()
        ev[2].record()
        queued = time.perf_counter() - t0
        ev[2].synchronize()
        if queued * 1e3 >= ev[0].elapsed_time(ev[1]):
            return None
        times.append(ev[1].elapsed_time(ev[2]) * 1e-3)
    return sorted(times)[len(times) // 2]


def share(n_bytes: float, seconds, flops: float = 0.0):
    """Least time over device time, in percent; None without a time."""
    if seconds is None or seconds <= 0:
        return None
    return 100.0 * least_seconds(n_bytes, flops) / seconds
