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
included), ``canny_grid`` where they fit the shared memory of every block
the card holds at once, one cooperative launch (``canny_fits_grid``: up to
about 80 Mpx on an H100, 5120x2880 and 7680x4320 included), and
``canny_nms`` + ``canny_hysteresis`` above that, whose K2 then runs over
the same cooperative grid with its packed state in global memory.

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
# Blocks an H100 holds at once for the cooperative kernels: one 1024-thread
# block on each of its 132 SMs (the routing arithmetic's default; on the
# card the CUDA runtime's occupancy query decides).
H100_RESIDENT_BLOCKS = 132
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


# K1's tile (rows, columns): persistent blocks walk the (B, ceil(H / 64),
# ceil(W / 128)) tiles, column fastest.  csrc/canny.cu's NMS_TY and NMS_TX
# set it; the built kernel reports them (revo_canny_nms_tile), and
# ``_nms_blocks`` raises where they differ from this copy, which the CPU's
# model of the tile walk uses.
NMS_TILE = (64, 128)


def canny_nms(gray: torch.Tensor, low_sq: float, high_sq: float):
    """K1 wrapper: (B, H, W) unpadded uint8-valued gray, uint8 or float32 ->
    (cand, strong) (B, H, W) bool, bit-equal to ``canny_nms_ref`` on the
    REFLECT_101-padded float32 copy.  CPU tensor: that copy and the plain
    version; CUDA tensor: the kernel, which applies REFLECT_101 on the index
    and so makes no copy, over as many persistent blocks as the card holds
    at once (``_nms_blocks``).  H and W must be at least 2."""
    if not _check_gray(gray, "canny_nms"):
        return canny_nms_ref(_reflect_pad(gray.to(torch.float32), 1, 1), low_sq, high_sq)
    b, h, w = gray.shape
    u8 = int(gray.dtype == torch.uint8)
    cand = torch.empty((b, h, w), dtype=torch.bool, device=gray.device)
    strong = torch.empty_like(cand)
    kernels.launch("revo_canny_nms", gray, u8, cand, strong, b, h, w, float(low_sq),
                   float(high_sq), _nms_blocks(gray.device, b, h, w, u8))
    canny_nms.launches += 1
    return cand, strong


canny_nms.launches = 0


def nms_tiles(b: int, h: int, w: int) -> int:
    """K1's tiles over ``b`` (h, w) images."""
    return b * -(-h // NMS_TILE[0]) * -(-w // NMS_TILE[1])


@functools.lru_cache(maxsize=None)
def _nms_blocks(device: torch.device, b: int, h: int, w: int, u8: int) -> int:
    """Persistent blocks of K1 for ``b`` (h, w) images on ``device``: as many
    as the card holds at once (the CUDA runtime's occupancy query), at most
    one a tile."""
    tile = kernels.call("revo_canny_nms_tile", device=device)
    if (tile >> 16, tile & 0xFFFF) != NMS_TILE:
        raise RuntimeError(f"canny_nms: the kernel's tile is {tile >> 16}x{tile & 0xFFFF}, "
                           f"NMS_TILE says {NMS_TILE[0]}x{NMS_TILE[1]}")
    blocks = kernels.call("revo_canny_nms_blocks", b, h, w, u8, device=device)
    if blocks < 0:
        raise RuntimeError(f"canny_nms: CUDA error {-blocks} counting the resident blocks")
    return blocks


@functools.lru_cache(maxsize=None)
def _shared_limit(device: torch.device) -> int:
    """Dynamic shared memory in bytes one block may use on ``device``, as
    the CUDA runtime gives it (232448 on an H100)."""
    limit = kernels.call("revo_canny_hysteresis_shared_limit", device=device)
    if limit <= 0:
        raise RuntimeError(f"canny_hysteresis: no shared-memory limit for {device}")
    return limit


def fused_smem_bytes(h: int, w: int) -> int:
    """Shared memory that ``canny_fused``'s fixpoint needs for an (h, w)
    image: eight flag words, cand and the two state masks, one bit a pixel
    in rows of whole 32-bit words (h * ceil(w / 32) words each, rounded up
    to a multiple of 4), and four masks of one bit a word (two dirty, room
    and grown; h rows of ceil(ceil(w / 32) / 32) words): 640x480 needs
    122912 bytes and 1024x576 230432 of an H100's 232448; 1280x720 needs
    368672.  The launch adds the list of frontier words, 2 bytes a word, as
    far as the block's limit allows (csrc/canny.cu ``fused_smem_bytes``,
    ``fused_launch_bytes``)."""
    wpr = -(-w // 32)
    n4 = -(-(h * wpr) // 4) * 4
    return 4 * (8 + 3 * n4 + 4 * h * -(-wpr // 32))


def band_smem_bytes(h: int, w: int, blocks: int, tile: int = 0) -> int:
    """Shared memory of one block that owns a band of an (h, w) image split
    over ``blocks`` blocks: for its ceil(h / blocks) rows, cand and two state
    buffers with a halo row above and below, a K1 tile of ``tile`` bytes
    overlaying the second buffer (csrc/canny.cu ``band_smem_bytes``)."""
    wpr, band = -(-w // 32), -(-h // blocks)
    buf = (band + 2) * wpr * 4
    return band * wpr * 4 + buf + max(buf, tile)


def cluster_smem_bytes(h: int, w: int, ranks: int) -> int:
    """Shared memory of one block of ``canny_cluster`` with ``ranks`` blocks
    an image, and of ``canny_grid`` with as many: the band with K1's
    256 x 16 tile."""
    return band_smem_bytes(h, w, ranks, _CLUSTER_TILE_BYTES)


def grid_blocks(h: int, w: int, b: int, smem_limit: int,
                resident: int = H100_RESIDENT_BLOCKS) -> int:
    """Blocks an image (G) of one ``canny_grid`` launch over ``b`` (h, w)
    images on a card that holds ``resident`` blocks at once, each of which
    may opt in to ``smem_limit`` bytes: G = resident // b, where its band
    (``cluster_smem_bytes``) fits; else 0.  A smaller G would have a larger
    band, so none fits then.  The card answers the same question with the
    CUDA runtime's occupancy query (``_grid_blocks``)."""
    blocks = resident // b if b >= 1 else 0
    return blocks if blocks >= 1 and cluster_smem_bytes(h, w, blocks) <= smem_limit else 0


def canny_route(h: int, w: int, smem_limit: int,
                resident: int = H100_RESIDENT_BLOCKS) -> str:
    """Which kernels an (h, w) image takes on a card whose blocks may opt in
    to ``smem_limit`` bytes of shared memory and which holds ``resident``
    1024-thread blocks at once: "fused" (``canny_fused``), "cluster"
    (``canny_cluster``, one of ``CLUSTER_RANKS`` blocks an image), "grid"
    (``canny_grid``, one cooperative launch over every resident block) or
    "split" (``canny_nms`` + ``canny_hysteresis``).  The card adds to
    "cluster" that it can hold a cluster of that many blocks at once
    (``hysteresis_fits_cluster``), and counts its resident blocks for
    "grid" by occupancy (``canny_fits_grid``)."""
    if fused_smem_bytes(h, w) <= smem_limit:
        return "fused"
    if any(cluster_smem_bytes(h, w, r) <= smem_limit for r in CLUSTER_RANKS):
        return "cluster"
    if grid_blocks(h, w, 1, smem_limit, resident):
        return "grid"
    return "split"


def hysteresis_fits_shared(device, h: int, w: int) -> bool:
    """Whether an (h, w) image takes ``canny_fused`` (and K2's
    shared-memory kernel, whose three masks need less) on ``device``:
    ``fused_smem_bytes`` within one block's shared memory."""
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


@functools.lru_cache(maxsize=None)
def _grid_blocks(device: torch.device, h: int, w: int, b: int, k2_form=None) -> int:
    """Blocks an image one cooperative launch over ``b`` (h, w) images takes
    on ``device``, as the CUDA runtime admits them (``grid_blocks``'s rule,
    with the card's occupancy for both gray types), or 0 where none fits:
    for ``canny_grid``, or with ``k2_form`` "grid" / "grid_global" for K2's
    grid form with its packed state in shared or in global memory."""
    if k2_form is None:
        blocks = kernels.call("revo_canny_grid_blocks", h, w, b, device=device)
    else:
        blocks = kernels.call("revo_canny_hysteresis_grid_blocks", h, w, b,
                              int(k2_form == "grid_global"), device=device)
    if blocks < 0:
        raise RuntimeError(f"canny grid: CUDA error {-blocks} counting the co-resident blocks")
    return blocks


def _grid_group(device: torch.device, h: int, w: int, b: int, k2_form=None) -> int:
    """Images one cooperative launch takes out of ``b``: the most, up to
    ``b``, whose blocks fit the card at once with a band that fits a block
    (at least 1 where one image fits; 0 where none does)."""
    group = min(b, _grid_blocks(device, h, w, 1, k2_form))
    while group > 0 and not _grid_blocks(device, h, w, group, k2_form):
        group -= 1
    return group


def canny_fits_grid(device, h: int, w: int) -> bool:
    """Whether an (h, w) image takes ``canny_grid`` on ``device`` when it
    fits neither one block nor a cluster: its masks spread over every block
    the card holds at once fit their shared memory, about 80 Mpx on an H100
    (132 blocks; 7680x4320 needs 104656 bytes a block)."""
    return _grid_blocks(torch.device(device), h, w, 1) > 0


K2_FORMS = ("shared", "global", "grid", "grid_global")


def canny_hysteresis(cand: torch.Tensor, strong: torch.Tensor, _form=None,
                     _blocks=None) -> torch.Tensor:
    """K2 wrapper: (B, H, W) bool cand/strong -> (B, H, W) bool edges.
    CPU tensor: plain version; CUDA tensor: a kernel on bit-packed masks,
    all forms giving the same bits.  The form follows from the shape and
    the device alone, before any launch: "shared", one block an image with
    the masks in its shared memory, where they fit there
    (``hysteresis_fits_shared``: every pyramid level of a 640x480 frame);
    else "grid", one cooperative launch over every block the card holds at
    once, each a band of rows in its shared memory, where the bands fit
    (about 80 Mpx on an H100); else "grid_global", the same launch with the
    packed state in global memory (3 bits a pixel).  The grid forms take as
    many images a launch as fit the card at once (``_grid_group``), so B
    images may take several launches.  ``canny_batched`` sends every image
    up to about 80 Mpx to ``canny_fused``, ``canny_cluster`` or
    ``canny_grid``, which run the same loop, so it reaches only
    "grid_global" here; the other forms stay as the contract of the TPU's
    K2 at those shapes.  ``_form`` (one of ``K2_FORMS``; "global" is the
    one-block kernel on byte masks in global memory, which no route takes)
    and ``_blocks`` (a grid form's blocks an image, all B images in one
    launch) let a comparison force one; a form that does not fit raises
    ValueError, a launch the card refuses RuntimeError."""
    if cand.device.type == "cpu":
        return hysteresis_ref(cand, strong)
    if cand.device.type != "cuda":
        raise ValueError(f"canny_hysteresis: unsupported device {cand.device}")
    _check_cuda(cand, torch.bool, 3, "canny_hysteresis")
    _check_cuda(strong, torch.bool, 3, "canny_hysteresis")
    if strong.shape != cand.shape or strong.device != cand.device:
        raise ValueError("canny_hysteresis: cand and strong differ in shape/device")
    b, h, w = cand.shape
    device = cand.device
    if _form is None:
        if hysteresis_fits_shared(device, h, w):
            _form = "shared"
        else:
            _form = "grid" if _grid_blocks(device, h, w, 1, "grid") else "grid_global"
    if _form not in K2_FORMS or (_form == "shared" and not hysteresis_fits_shared(device, h, w)):
        raise ValueError(f"canny_hysteresis: form {_form!r} not available for {h}x{w}")
    out = torch.empty_like(cand)
    if _form == "shared":
        kernels.launch("revo_canny_hysteresis", cand, strong, out, b, h, w, h + w)
        canny_hysteresis.launches += 1
        return out
    if _form == "global":
        tmp = torch.empty_like(cand)
        kernels.launch("revo_canny_hysteresis_global", cand, strong, out, tmp, b, h, w, h + w)
        canny_hysteresis.launches += 1
        return out
    group = b if _blocks is not None else _grid_group(device, h, w, b, _form)
    if group <= 0:
        raise ValueError(f"canny_hysteresis: form {_form!r} not available for {h}x{w}")
    wpr = -(-w // 32)
    for i in range(0, b, group):
        n = min(group, b - i)
        blocks = int(_blocks) if _blocks is not None else _grid_blocks(device, h, w, n, _form)
        state_global = _form == "grid_global"
        n_words = n * (3 * h + 4) * wpr if state_global else 4 * n * blocks * wpr
        words, slots = _grid_buffers(device, n_words)
        kernels.launch("revo_canny_hysteresis_grid", cand[i:i + n], strong[i:i + n],
                       out[i:i + n], words, words, slots, n, h, w, h + w, blocks,
                       int(state_global))
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
_grid_scratch = {}  # (device, stream) -> (halo rows or packed state, grew slots)


def _grid_buffers(device, n_words: int):
    """The grid kernels' halo rows (or K2's packed state) and their three
    "grew" slots on the current stream of ``device``.  Launches on one
    stream run in order and each writes what it reads before reading it
    (block 0 resets the slots), so they share the buffers; the first grows
    when a call needs more."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    words, slots = _grid_scratch.get(key, (None, None))
    if words is None or words.numel() < n_words:
        words = torch.empty(n_words, dtype=torch.int32, device=device)
    if slots is None:
        slots = torch.empty(3, dtype=torch.int32, device=device)
    _grid_scratch[key] = (words, slots)
    return words, slots


def _fused_buffers(device, n_words: int, b: int):
    """The fused kernel's packed ``cand`` / ``strong`` words (each image's
    at a multiple of 16 bytes) and its per-image tickets on the current
    stream of ``device``.  Launches on one
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
    """Checks of the gray the kernels read unpadded (K1 and the one-launch
    Cannys); True for a CUDA tensor that goes to the kernel, False for a CPU
    tensor (the plain version)."""
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


FUSED_FORMS = ("frontier", "dense")


@functools.lru_cache(maxsize=None)
def _fused_blocks(device: torch.device, b: int, h: int, w: int) -> int:
    """Blocks an image of one ``canny_fused`` launch over ``b`` (h, w)
    images on ``device``: the blocks the card holds at once (the CUDA
    runtime's occupancy query) shared by the images, at least 1 and at most
    one a K1 strip of 32 columns by 8 rows."""
    blocks = kernels.call("revo_canny_fused_blocks", b, h, w, device=device)
    if blocks < 0:
        raise RuntimeError(f"canny_fused: CUDA error {-blocks} counting the resident blocks")
    if blocks == 0:
        raise ValueError(f"canny_fused: a {h}x{w} image does not fit a block's shared memory")
    return blocks


def canny_fused(gray: torch.Tensor, low: float, high: float, _form: str = "frontier",
                _max_iters=None, _stats=None) -> torch.Tensor:
    """K1 + K2 in one launch: (B, H, W) uint8-valued gray, uint8 or float32,
    unpadded -> (B, H, W) bool edges, bit-equal to ``canny_fused_ref``.
    CPU tensor: plain version; CUDA tensor: the kernel, for images that
    ``hysteresis_fits_shared`` admits (others raise: ``canny_batched``
    routes them to ``canny_cluster`` or the split kernels), one launch for
    all B images.  H and W must be at least 2, as REFLECT_101 needs.

    For comparisons on the card only: ``_form`` "dense" launches the first
    form of the kernel (32x32 tiles, every word stepped), which no route
    takes; ``_max_iters`` replaces the fixpoint's cap of H + W steps (0
    times K1, the masks' round trip and the unpacking alone; the edges are
    then strong alone); ``_stats``, a (B, 9) int64 CUDA tensor, receives
    each image's steps, largest frontier and frontier words of all steps,
    then the card's global timer in ns at the start of the block that ran
    its fixpoint, after its ticket, before and after the steps and at its
    end, then the steps whose frontier overflowed the list and stepped
    every word (frontier form)."""
    if not _check_gray(gray, "canny_fused"):
        return canny_fused_ref(gray, low, high)
    if _form not in FUSED_FORMS:
        raise ValueError(f"canny_fused: form {_form!r} is not one of {FUSED_FORMS}")
    b, h, w = gray.shape
    if not hysteresis_fits_shared(gray.device, h, w):
        raise ValueError(f"canny_fused: a {h}x{w} image does not fit shared memory")
    wpr = -(-w // 32)
    n4 = -(-(h * wpr) // 4) * 4
    words, tickets = _fused_buffers(gray.device, 2 * b * n4, b)
    out = torch.empty((b, h, w), dtype=torch.bool, device=gray.device)
    u8 = int(gray.dtype == torch.uint8)
    cap = h + w if _max_iters is None else int(_max_iters)
    if _form == "dense":
        if _stats is not None:
            raise ValueError("canny_fused: the dense form keeps no stats")
        kernels.launch("revo_canny_fused_dense", gray, u8, words, tickets, out, b, h, w,
                       float(low * low), float(high * high), cap)
    else:
        if _stats is not None:
            _check_cuda(_stats, torch.int64, 2, "canny_fused stats")
            if tuple(_stats.shape) != (b, 9) or _stats.device != gray.device:
                raise ValueError(f"canny_fused: stats want ({b}, 9) on {gray.device}")
        kernels.launch("revo_canny_fused", gray, u8, words, tickets, out, _stats, b, h, w,
                       float(low * low), float(high * high), cap,
                       _fused_blocks(gray.device, b, h, w))
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


def canny_grid(gray: torch.Tensor, low: float, high: float, _blocks=None) -> torch.Tensor:
    """K1 + K2 in one cooperative launch for images above a cluster's shared
    memory: (B, H, W) uint8-valued gray, uint8 or float32, unpadded ->
    (B, H, W) bool edges, bit-equal to ``canny_fused_ref``.  CPU tensor:
    plain version; CUDA tensor: the kernel, G blocks an image over every
    block the card holds at once, each a band of rows in its shared memory,
    halo rows through global memory and one grid-wide barrier a step, for B
    images that ``_grid_blocks`` admits together (others raise:
    ``canny_batched`` launches images in groups where all B do not fit).
    ``_blocks`` lets a comparison force G; a launch the card refuses (more
    blocks than it holds at once, a band above a block's memory) raises
    with the CUDA error.  H and W must be at least 2."""
    if not _check_gray(gray, "canny_grid"):
        return canny_fused_ref(gray, low, high)
    b, h, w = gray.shape
    blocks = _grid_blocks(gray.device, h, w, b) if _blocks is None else int(_blocks)
    if blocks <= 0:
        raise ValueError(f"canny_grid: {b} images of {h}x{w} do not fit the shared memory "
                         "of the blocks the card holds at once")
    halo, slots = _grid_buffers(gray.device, 4 * b * blocks * (-(-w // 32)))
    out = torch.empty((b, h, w), dtype=torch.bool, device=gray.device)
    kernels.launch(
        "revo_canny_grid",
        gray, int(gray.dtype == torch.uint8), out, halo, slots, b, h, w,
        float(low * low), float(high * high), h + w, blocks,
    )
    canny_grid.launches += 1
    return out


canny_grid.launches = 0


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
        if canny_fits_grid(gray.device, h, w):
            group = _grid_group(gray.device, h, w, gray.shape[0])
            if group == gray.shape[0]:
                return canny_grid(gray, low, high)
            return torch.cat([canny_grid(gray[i:i + group], low, high)
                              for i in range(0, gray.shape[0], group)])
        return canny_hysteresis(*canny_nms(gray, low * low, high * high))
    return canny_fused(gray, low, high)


def canny(
    gray: torch.Tensor, threshold1: float = 150.0, threshold2: float = 100.0
) -> torch.Tensor:
    """(H, W) uint8-valued gray -> (H, W) bool edges."""
    return canny_batched(gray[None], threshold1, threshold2)[0]
