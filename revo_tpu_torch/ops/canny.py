"""Canny edges: K1 (Sobel + NMS + double threshold), K2 (hysteresis) and
the two fused into one launch.

Counterpart of revo_tpu/ops/canny.py and of the Pallas kernels
revo_tpu/ops/pallas/canny_kernel.py (``_full_kernel2d`` via ``_canny_single``,
the single-image kernel that does NMS and hysteresis in one call; ``_nms_core``
via ``_nms_batched``) and revo_tpu/ops/pallas/hysteresis.py (``_fixpoint`` via
``_run_batched``).  cv::Canny(gray, 150, 100, apertureSize=3,
L2gradient=true) semantics, as called by the reference
(imgpyramidrgbd.cpp:105-108).

Each kernel has a plain PyTorch version beside it (``canny_nms_ref``,
``hysteresis_ref``, ``canny_fused_ref``).  A wrapper runs the plain version
for a tensor on the CPU and the CUDA kernel (revo_tpu_torch/csrc/canny.cu)
for a tensor on the card; for any other tensor it raises.  ``launches`` on
each wrapper counts its kernel launches.  ``canny_batched`` routes each
image by shape, before any launch (``canny_route`` is the arithmetic):
``canny_fused`` where the packed masks fit one block's shared memory
(``hysteresis_fits_shared``: up to 1024x576, all pyramid levels of a
640x480 frame), ``canny_cluster`` where they fit a thread-block cluster's
(``hysteresis_fits_cluster``: 1280x720 up to about 9.7 Mpx, 3840x2160
included), and ``canny_nms`` + ``canny_hysteresis`` (its global-memory
kernel) above that.

Sector test: the Pallas form ``ay > ax * f32(tan22.5 + 2)`` (the constant
folded in double, then rounded to f32), where revo_tpu/ops/canny.py writes
``tg22x + 2 * ax``.  For every integer gradient pair a Sobel of uint8 input
can give (|g| <= 1020) the two forms agree (checked exhaustively), so the
edges are bit-equal to both JAX paths.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from revo_tpu_torch import kernels
from revo_tpu_torch.ops.filters import _reflect_pad

_TAN22 = 0.4142135623730950488  # tan(pi/8)
_TG22 = float(torch.tensor(_TAN22, dtype=torch.float32))
_TG67 = float(torch.tensor(_TAN22 + 2.0, dtype=torch.float32))
_UNROLL = 8  # dilation steps per fixpoint trip (hysteresis.py:27)
CLUSTER_RANKS = (16, 8)  # blocks per image canny_cluster may take, the largest first
# K1's tile in canny_cluster (256 x 16 pixels): staged gray with a 2-pixel
# halo and magnitudes with a 1-pixel ring, float32 (csrc/canny.cu).
_CLUSTER_TILE_BYTES = ((16 + 4) * (256 + 4) + (16 + 2) * (256 + 2)) * 4


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], zero outside."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = x[
        ..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)
    ]
    return out


def canny_nms_ref(gray_pad: torch.Tensor, low_sq: float, high_sq: float):
    """Plain K1.  (B, H+2, W+2) REFLECT_101-padded uint8-valued float32 gray
    -> (cand, strong) (B, H, W) bool.

    Sobel gx/gy, squared-L2 magnitude, sector by |gy| against |gx| tan22.5
    and |gx| tan67.5 (sign of gx*gy picks the diagonal), NMS with OpenCV's
    asymmetry (``>`` then ``>=`` on horizontal/vertical, strict on the
    diagonals; magnitude 0 outside the image), then cand = keep & mag > low^2
    and strong = cand & mag > high^2 (canny_kernel.py:39-95)."""
    g = gray_pad
    hh, ww = g.shape[-2] - 2, g.shape[-1] - 2

    def at(dy, dx):
        return g[..., 1 + dy:1 + dy + hh, 1 + dx:1 + dx + ww]

    gx = (at(-1, 1) + 2.0 * at(0, 1) + at(1, 1)) - (
        at(-1, -1) + 2.0 * at(0, -1) + at(1, -1)
    )
    gy = (at(1, -1) + 2.0 * at(1, 0) + at(1, 1)) - (
        at(-1, -1) + 2.0 * at(-1, 0) + at(-1, 1)
    )
    mag = gx * gx + gy * gy
    ax, ay = gx.abs(), gy.abs()
    horiz = ay < ax * _TG22
    vert = ay > ax * _TG67
    diag_pos = (gx * gy) >= 0

    keep_h = (mag > _shift(mag, 0, -1)) & (mag >= _shift(mag, 0, 1))
    keep_v = (mag > _shift(mag, -1, 0)) & (mag >= _shift(mag, 1, 0))
    keep_dp = (mag > _shift(mag, -1, -1)) & (mag > _shift(mag, 1, 1))
    keep_dn = (mag > _shift(mag, -1, 1)) & (mag > _shift(mag, 1, -1))
    keep = torch.where(
        horiz, keep_h,
        torch.where(vert, keep_v, torch.where(diag_pos, keep_dp, keep_dn)),
    )
    cand = keep & (mag > low_sq)
    return cand, cand & (mag > high_sq)


def hysteresis_steps_ref(cand: torch.Tensor, strong: torch.Tensor):
    """Plain K2 and the work it took.  (B, H, W) bool -> ((B, H, W) bool
    reach, dilation steps the loop ran for the image that ran longest).

    Strong seeds grow through cand by synchronous 8-connected 3x3 dilation,
    in trips of 8 steps; an image stops after a trip that left its pixel sum
    unchanged, or once H+W steps have run (the JAX loop's cap,
    hysteresis.py:61-83), whichever comes first."""
    h, w = cand.shape[-2:]
    candf = cand.to(torch.float32)
    reach = strong.to(torch.float32)
    prev = torch.full(reach.shape[:-2], -1.0, device=reach.device)
    it = 0
    while it < h + w:
        total = reach.sum(dim=(-2, -1))
        active = total != prev
        if not bool(active.any()):
            break
        grown = reach
        for _ in range(_UNROLL):
            dil = F.max_pool2d(grown[:, None], 3, stride=1, padding=1)[:, 0]
            grown = torch.maximum(grown, candf * dil)
        reach = torch.where(active[:, None, None], grown, reach)
        prev = total
        it += _UNROLL
    return reach > 0.5, it


def hysteresis_ref(cand: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """Plain K2.  (B, H, W) bool -> (B, H, W) bool reach."""
    return hysteresis_steps_ref(cand, strong)[0]


def _check_cuda(x: torch.Tensor, dtype, ndim: int, name: str):
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} of rank {ndim}, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def canny_nms(gray_pad: torch.Tensor, low_sq: float, high_sq: float):
    """K1 wrapper: (B, H+2, W+2) float32 padded gray -> (cand, strong)
    (B, H, W) bool.  CPU tensor: plain version; CUDA tensor: the kernel."""
    if gray_pad.device.type == "cpu":
        return canny_nms_ref(gray_pad, low_sq, high_sq)
    if gray_pad.device.type != "cuda":
        raise ValueError(f"canny_nms: unsupported device {gray_pad.device}")
    _check_cuda(gray_pad, torch.float32, 3, "canny_nms")
    b, hp, wp = gray_pad.shape
    cand = torch.empty((b, hp - 2, wp - 2), dtype=torch.bool, device=gray_pad.device)
    strong = torch.empty_like(cand)
    kernels.launch(
        "revo_canny_nms",
        gray_pad, cand, strong, b, hp - 2, wp - 2, float(low_sq), float(high_sq),
    )
    canny_nms.launches += 1
    return cand, strong


canny_nms.launches = 0


@functools.lru_cache(maxsize=None)
def _shared_limit(device: torch.device) -> int:
    """Dynamic shared memory in bytes one block may use on ``device``, as
    the CUDA runtime gives it (232448 on an H100)."""
    limit = kernels.call("revo_canny_hysteresis_shared_limit", device=device)
    if limit <= 0:
        raise RuntimeError(f"canny_hysteresis: no shared-memory limit for {device}")
    return limit


def fused_smem_bytes(h: int, w: int) -> int:
    """Shared memory of the one-block fixpoint on an (h, w) image: cand and
    the two state masks, one bit a pixel in rows of whole 32-bit words
    (3 * h * ceil(w / 32) * 4 bytes: 640x480 needs 115200 and 1024x576
    221184 of an H100's 232448; 1280x720 needs 345600)."""
    return 3 * h * (-(-w // 32)) * 4


def cluster_smem_bytes(h: int, w: int, ranks: int) -> int:
    """Shared memory of one block of ``canny_cluster`` with ``ranks`` blocks
    an image: for its band of ceil(h / ranks) rows, cand and two state
    buffers with a halo row above and below, K1's tile overlaying the
    second buffer (csrc/canny.cu ``cluster_smem_bytes``)."""
    wpr, band = -(-w // 32), -(-h // ranks)
    buf = (band + 2) * wpr * 4
    return band * wpr * 4 + buf + max(buf, _CLUSTER_TILE_BYTES)


def canny_route(h: int, w: int, smem_limit: int) -> str:
    """Which kernels an (h, w) image takes on a card whose blocks may opt in
    to ``smem_limit`` bytes of shared memory: "fused" (``canny_fused``),
    "cluster" (``canny_cluster``, one of ``CLUSTER_RANKS`` blocks an image)
    or "split" (``canny_nms`` + ``canny_hysteresis``).  The card adds one
    condition to "cluster": that it can hold a cluster of that many blocks
    at once (``hysteresis_fits_cluster``)."""
    if fused_smem_bytes(h, w) <= smem_limit:
        return "fused"
    if any(cluster_smem_bytes(h, w, r) <= smem_limit for r in CLUSTER_RANKS):
        return "cluster"
    return "split"


def hysteresis_fits_shared(device, h: int, w: int) -> bool:
    """Whether an (h, w) image takes K2's shared-memory kernel on
    ``device``: ``fused_smem_bytes`` within one block's shared memory."""
    return fused_smem_bytes(h, w) <= _shared_limit(torch.device(device))


@functools.lru_cache(maxsize=None)
def _cluster_ranks(device: torch.device, h: int, w: int) -> int:
    """Blocks per image ``canny_cluster`` takes for an (h, w) image on
    ``device``, as the CUDA runtime admits them (the largest of
    ``CLUSTER_RANKS`` whose ``cluster_smem_bytes`` fit a block and of which
    the card holds a whole cluster at once), or 0 where none does."""
    ranks = kernels.call("revo_canny_cluster_ranks", h, w, device=device)
    if ranks < 0:
        raise RuntimeError(f"canny_cluster: CUDA error {-ranks} choosing the cluster size")
    return ranks


def hysteresis_fits_cluster(device, h: int, w: int) -> bool:
    """Whether an (h, w) image takes ``canny_cluster`` on ``device`` when it
    does not fit one block (``hysteresis_fits_shared``): its masks spread
    over a cluster of 16 or 8 blocks fit their shared memory, about 9.7 Mpx
    on an H100 (3840x2160 needs 196320 bytes a block with 16)."""
    return _cluster_ranks(torch.device(device), h, w) > 0


def canny_hysteresis(cand: torch.Tensor, strong: torch.Tensor, _form=None) -> torch.Tensor:
    """K2 wrapper: (B, H, W) bool cand/strong -> (B, H, W) bool edges.
    CPU tensor: plain version; CUDA tensor: the kernel, on bit-packed masks
    in shared memory where the image fits there (``hysteresis_fits_shared``:
    every pyramid level of a 640x480 frame), else on byte masks in global
    memory.  The form follows from the shape and the device alone, before
    the launch, and both give the same bits.  ``canny_batched`` sends every
    image that fits shared memory to ``canny_fused``, which runs the same
    loop, and every image that fits a cluster to ``canny_cluster``, so it
    reaches only the global form here, above about 9.7 Mpx; the shared form
    stays as the contract of the TPU's K2 at those shapes.  ``_form`` ("shared",
    "global") lets a comparison force one; "shared" raises for an image
    that does not fit."""
    if cand.device.type == "cpu":
        return hysteresis_ref(cand, strong)
    if cand.device.type != "cuda":
        raise ValueError(f"canny_hysteresis: unsupported device {cand.device}")
    _check_cuda(cand, torch.bool, 3, "canny_hysteresis")
    _check_cuda(strong, torch.bool, 3, "canny_hysteresis")
    if strong.shape != cand.shape or strong.device != cand.device:
        raise ValueError("canny_hysteresis: cand and strong differ in shape/device")
    b, h, w = cand.shape
    fits = hysteresis_fits_shared(cand.device, h, w)
    if _form not in (None, "shared", "global") or (_form == "shared" and not fits):
        raise ValueError(f"canny_hysteresis: form {_form!r} not available for {h}x{w}")
    out = torch.empty_like(cand)
    if _form == "shared" or (_form is None and fits):
        kernels.launch("revo_canny_hysteresis", cand, strong, out, b, h, w, h + w)
    else:
        tmp = torch.empty_like(cand)
        kernels.launch("revo_canny_hysteresis_global", cand, strong, out, tmp, b, h, w, h + w)
    canny_hysteresis.launches += 1
    return out


canny_hysteresis.launches = 0


def canny_fused_ref(gray: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Plain fused Canny.  (B, H, W) uint8-valued gray (uint8 or float32)
    -> (B, H, W) bool edges: REFLECT_101 pad, ``canny_nms_ref`` with the
    squared thresholds, ``hysteresis_ref``."""
    gp = _reflect_pad(gray.to(torch.float32), 1, 1)
    return hysteresis_ref(*canny_nms_ref(gp, low * low, high * high))


_fused_scratch = {}  # (device, stream) -> (packed mask words, tickets)


def _fused_buffers(device, n_words: int, b: int):
    """The fused kernel's packed ``cand`` / ``strong`` words and its
    per-image tickets on the current stream of ``device``.  Launches on one
    stream run in order and each leaves its tickets at 0, so they share the
    buffers; either grows when a call needs more."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    words, tickets = _fused_scratch.get(key, (None, None))
    if words is None or words.numel() < n_words:
        words = torch.empty(n_words, dtype=torch.int32, device=device)
    if tickets is None or tickets.numel() < b:
        tickets = torch.zeros(b, dtype=torch.int32, device=device)
    _fused_scratch[key] = (words, tickets)
    return words, tickets


def _check_gray(gray: torch.Tensor, name: str) -> bool:
    """Checks of the one-launch kernels' gray; True for a CUDA tensor that
    goes to the kernel, False for a CPU tensor (the plain version)."""
    if gray.dim() != 3 or min(gray.shape[-2:]) < 2:
        raise ValueError(
            f"{name}: want (B, H, W) with H, W >= 2 (REFLECT_101), got {tuple(gray.shape)}"
        )
    if gray.device.type == "cpu":
        return False
    if gray.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {gray.device}")
    if gray.dtype not in (torch.float32, torch.uint8) or not gray.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous float32 or uint8, got {gray.dtype} "
            f"contiguous={gray.is_contiguous()}"
        )
    return True


def canny_fused(gray: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """K1 + K2 in one launch: (B, H, W) uint8-valued gray, uint8 or float32,
    unpadded -> (B, H, W) bool edges, bit-equal to ``canny_fused_ref``.
    CPU tensor: plain version; CUDA tensor: the kernel, for images that
    ``hysteresis_fits_shared`` admits (others raise: ``canny_batched``
    routes them to ``canny_cluster`` or the split kernels).  H and W must
    be at least 2, as REFLECT_101 needs."""
    if not _check_gray(gray, "canny_fused"):
        return canny_fused_ref(gray, low, high)
    b, h, w = gray.shape
    if not hysteresis_fits_shared(gray.device, h, w):
        raise ValueError(f"canny_fused: a {h}x{w} image does not fit shared memory")
    words, tickets = _fused_buffers(gray.device, 2 * b * h * (-(-w // 32)), b)
    out = torch.empty((b, h, w), dtype=torch.bool, device=gray.device)
    kernels.launch(
        "revo_canny_fused",
        gray, int(gray.dtype == torch.uint8), words, tickets, out, b, h, w,
        float(low * low), float(high * high), h + w,
    )
    canny_fused.launches += 1
    return out


canny_fused.launches = 0


def canny_cluster(gray: torch.Tensor, low: float, high: float, _ranks=None) -> torch.Tensor:
    """K1 + K2 in one launch for images above one block's shared memory:
    (B, H, W) uint8-valued gray, uint8 or float32, unpadded -> (B, H, W)
    bool edges, bit-equal to ``canny_fused_ref``.  CPU tensor: plain
    version; CUDA tensor: the kernel, one thread-block cluster an image,
    its blocks sharing the masks through distributed shared memory, for
    images that ``hysteresis_fits_cluster`` admits (others raise).  The
    cluster size follows from the shape and the card (``_cluster_ranks``);
    ``_ranks`` (1-16) lets a comparison force one, and a launch the card
    refuses raises with the CUDA error.  H and W must be at least 2."""
    if not _check_gray(gray, "canny_cluster"):
        return canny_fused_ref(gray, low, high)
    b, h, w = gray.shape
    ranks = _cluster_ranks(gray.device, h, w) if _ranks is None else int(_ranks)
    if ranks <= 0:
        raise ValueError(f"canny_cluster: a {h}x{w} image does not fit a cluster's shared memory")
    out = torch.empty((b, h, w), dtype=torch.bool, device=gray.device)
    kernels.launch(
        "revo_canny_cluster",
        gray, int(gray.dtype == torch.uint8), out, b, h, w,
        float(low * low), float(high * high), h + w, ranks,
    )
    canny_cluster.launches += 1
    return out


canny_cluster.launches = 0


def canny_batched(
    gray: torch.Tensor, threshold1: float = 150.0, threshold2: float = 100.0
) -> torch.Tensor:
    """(B, H, W) uint8-valued gray -> (B, H, W) bool edges.  As cv::Canny,
    the smaller threshold is the low (hysteresis) one.  uint8 and float32
    gray go to the kernel as they are; other types are cast to float32.  On
    the card the shape picks the kernels (module docstring)."""
    low = float(min(threshold1, threshold2))
    high = float(max(threshold1, threshold2))
    if gray.dtype not in (torch.float32, torch.uint8):
        gray = gray.to(torch.float32)
    gray = gray.contiguous()
    h, w = gray.shape[-2:]
    if gray.device.type == "cuda" and not hysteresis_fits_shared(gray.device, h, w):
        if hysteresis_fits_cluster(gray.device, h, w):
            return canny_cluster(gray, low, high)
        gp = _reflect_pad(gray.to(torch.float32), 1, 1).contiguous()
        cand, strong = canny_nms(gp, low * low, high * high)
        return canny_hysteresis(cand, strong)
    return canny_fused(gray, low, high)


def canny(
    gray: torch.Tensor, threshold1: float = 150.0, threshold2: float = 100.0
) -> torch.Tensor:
    """(H, W) uint8-valued gray -> (H, W) bool edges."""
    return canny_batched(gray[None], threshold1, threshold2)[0]
