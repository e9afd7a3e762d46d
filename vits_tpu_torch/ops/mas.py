"""Monotonic alignment search: the port of TPU kernel K2
(vits_tpu/ops/mas.py::_mas_kernel, launched by maximum_path_pallas).

Semantics (vits_tpu/ops/mas.py:1-22): a Viterbi DP over hard monotonic
alignments of spec frames y to text tokens x, in f32, inside the band
x <= y, x >= t_x - t_y + y, x < t_x, y < t_y (cells outside hold exactly
-1e9), then a backtrace from (t_y - 1, t_x - 1) that moves left when
x == y or v[y-1, x] < v[y-1, x-1] (strict).

`maximum_path(neg_cent, mask)` is the entry (mas.py:200-218): lengths from
the mask, `neg_cent * mask`, an f32 DP, the path in the input dtype. On a
CPU tensor it runs `maximum_path_plain` (a torch twin of
`maximum_path_scan`, mas.py:74-123); on a CUDA tensor it launches the
hand-written kernel in `vits_tpu_torch/csrc/mas.cu`, once per call, in the
form `plan` picks ("warp": one warp runs the DP with its row in registers;
"block": a block's threads over the columns, one barrier per row), or
raises. `counter.launches` counts those launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from vits_tpu_torch.utils import cuda_build

SOURCE = "mas.cu"
NEG_INF = -1e9

counter = cuda_build.LaunchCounter()


def mask_to_lengths(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """attn mask (B, T_y, T_x) -> (t_ys, t_xs) int32, counted in f32 (exact
    to 2^24) whatever the mask's dtype. The JAX package sums in the mask's
    dtype, so a bf16 mask rounds a length past 256 to 8 significant bits
    (vits_tpu/ops/mas.py:37); the port does not copy that."""
    t_ys = mask[:, :, 0].float().sum(dim=1).to(torch.int32)
    t_xs = mask[:, 0, :].float().sum(dim=1).to(torch.int32)
    return t_ys, t_xs


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def maximum_path_plain(neg_cent: torch.Tensor, t_ys: torch.Tensor,
                       t_xs: torch.Tensor) -> torch.Tensor:
    """neg_cent (B, T_y, T_x); t_ys/t_xs (B,) int -> 0/1 path in
    neg_cent.dtype. Vectorised over the batch, Python loops over T_y for the
    forward DP and the backtrace, every value in f32."""
    out_dtype = neg_cent.dtype
    neg = neg_cent.float()
    B, T_y, T_x = neg.shape
    dev = neg.device
    t_ys, t_xs = t_ys.long(), t_xs.long()
    xs = torch.arange(T_x, device=dev)
    neg_row = torch.full((B, T_x), NEG_INF, dtype=torch.float32, device=dev)
    prev = neg_row
    values = []
    for y in range(T_y):
        first = torch.full((B, 1), 0.0 if y == 0 else NEG_INF, dtype=torch.float32, device=dev)
        best = torch.maximum(prev, torch.cat([first, prev[:, :-1]], dim=1))
        feas = ((xs[None, :] <= y) & (xs[None, :] >= (t_xs - t_ys + y)[:, None])
                & (xs[None, :] < t_xs[:, None]) & (y < t_ys)[:, None])
        prev = torch.where(feas, neg[:, y] + best, neg_row)
        values.append(prev)

    path = torch.zeros(B, T_y, T_x, dtype=out_dtype, device=dev)
    idx = (t_xs - 1).clamp(min=0)
    for y in range(T_y - 1, -1, -1):
        active = y < t_ys
        path[:, y] = ((xs[None, :] == idx[:, None]) & active[:, None]).to(out_dtype)
        if y == 0:
            break
        val_prev = values[y - 1]
        v_here = val_prev.gather(1, idx[:, None])[:, 0]
        v_left = val_prev.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0]
        move = active & (idx != 0) & ((idx == y) | (v_here < v_left))
        idx = idx - move.long()
    return path


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

# The plan's numbers are checked again by mas_forward in csrc/mas.cu, which
# holds its own copy of the rules below (kWarpRs, warp_smem, geometry) and
# refuses a plan that differs; tests/test_torch_cuda.py::
# test_mas_plan_agrees_with_the_kernel runs the two against each other.
SMEM_LIMIT = 232448                     # dynamic shared memory a block may use on sm_90
WARP_RS = (1, 3, 5, 7, 9, 13, 17, 25, 31)  # form "warp": columns per lane, each odd
WARP_MAX_TX = 32 * WARP_RS[-1]          # ... the widest T_x it takes (992)
WARP_RINGS = (256, 128, 64, 32, 16, 8)  # ... rows of neg in its ring, the deepest that fits
WARP_PARTS = 4                          # ... in parts, each copied and released as one
BLOCK_MAX_THREADS = 1024                # form "block"
FORMS = {"warp": 0, "block": 1}         # the C entry's form numbers


def _align(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class Plan:
    """How `maximum_path_cuda` runs one shape (the C entry checks it).

    form: "warp" (one block of 4 warps per utterance, warp 0 runs the DP
    with R = `warp_r(T_x)` columns per lane while warps 1-3 copy
    neg into a ring of D rows, in WARP_PARTS parts of D / WARP_PARTS rows,
    and zero-fill the path) or "block" (one block per utterance, its threads
    over the columns, R per thread, one barrier per row; D = 0). smem:
    dynamic shared memory per block. scratch_words: 32-bit words of global
    scratch per utterance ("block" only, where its bits do not fit in
    shared memory)."""
    form: str
    R: int
    D: int
    smem: int
    scratch_words: int = 0


def warp_r(T_x: int) -> int:
    """Form "warp": columns per lane for T_x <= WARP_MAX_TX, the first of
    WARP_RS that covers T_x over 32 lanes. Odd, so lane l's reads of ring
    column l R + r fall on 32 banks; at most 31, so lane r holds word r of a
    row's R move-left words."""
    return next(r for r in WARP_RS if 32 * r >= T_x)


def warp_smem(T_y: int, T_x: int, R: int, D: int) -> int:
    """Form "warp": the ring (D rows of T_x floats rounded up to 4, and 32 R
    floats that the last row's padded columns read) and the move-left words
    (T_y rows of R)."""
    return 4 * (D * _align(T_x, 4) + 32 * R + T_y * R)


def block_plan(T_y: int, T_x: int) -> Plan:
    """Form "block", as `geometry` in csrc/mas.cu: columns per thread (a power
    of two) so that at most 1024 threads cover T_x, the previous row
    double-buffered in shared memory, and the path's column per row and the
    move-left words beside it where they fit, else in global scratch."""
    xpt = 1
    while xpt <= 32 and _align(-(-T_x // xpt), 32) > BLOCK_MAX_THREADS:
        xpt *= 2
    threads = _align(-(-T_x // xpt), 32)
    rows = 2 * xpt * threads * 4
    if xpt > 32 or rows > SMEM_LIMIT:
        raise ValueError(f"maximum_path: no kernel form takes T_x = {T_x}")
    words = -(-T_x // 32)
    full = rows + 4 * T_y + 4 * T_y * words
    if full <= SMEM_LIMIT:
        return Plan("block", xpt, 0, full)
    return Plan("block", xpt, 0, rows, T_y * words + T_y)


@functools.lru_cache(maxsize=None)
def plan(B: int, T_y: int, T_x: int) -> Plan:
    """The kernel's plan for neg_cent (B, T_y, T_x): "warp" where T_x <=
    WARP_MAX_TX and a ring of at least 8 rows fits beside the bits (the
    deepest ring of WARP_RINGS that fits), else "block". Raises where neither
    form takes the shape."""
    if B <= 0 or T_y <= 0 or T_x <= 0:
        raise ValueError(f"maximum_path: no kernel form takes shape {(B, T_y, T_x)}")
    if T_x <= WARP_MAX_TX:
        R = warp_r(T_x)
        for D in WARP_RINGS:
            smem = warp_smem(T_y, T_x, R, D)
            if smem <= SMEM_LIMIT:
                return Plan("warp", R, D, smem)
    return block_plan(T_y, T_x)


_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_vits_typed", False):
        lib.mas_forward.argtypes = [_P] * 5 + [_I] * 7 + [_P]
        lib.mas_forward.restype = _I
        lib.mas_error_string.argtypes = [_I]
        lib.mas_error_string.restype = ctypes.c_char_p
        lib._vits_typed = True
    return lib


def maximum_path_cuda(neg_cent: torch.Tensor, t_ys: torch.Tensor,
                      t_xs: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on the current stream, in the form `plan`
    picks: neg_cent (B, T_y, T_x) float32, t_ys/t_xs (B,) int32, all
    contiguous on one CUDA device. Returns the f32 path."""
    B, T_y, T_x = neg_cent.shape
    dev = neg_cent.device
    for name, t, dtype, shape in (("neg_cent", neg_cent, torch.float32, (B, T_y, T_x)),
                                  ("t_ys", t_ys, torch.int32, (B,)),
                                  ("t_xs", t_xs, torch.int32, (B,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"maximum_path: {name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    path = torch.empty(B, T_y, T_x, dtype=torch.float32, device=dev)
    if path.numel() == 0:
        return path
    p = plan(B, T_y, T_x)
    lib = _lib()
    words = p.scratch_words
    scratch = torch.empty(B * words, dtype=torch.int32, device=dev) if words else None
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = lib.mas_forward(neg_cent.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(),
                          path.data_ptr(), scratch.data_ptr() if words else None,
                          B, T_y, T_x, FORMS[p.form], p.R, p.D, p.smem, stream)
    if err != 0:
        raise RuntimeError(f"mas_forward launch failed: {lib.mas_error_string(err).decode()}")
    counter.launches += 1
    return path


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Drop-in twin of vits_tpu.ops.mas.maximum_path: neg_cent (B, T_y, T_x),
    mask (B, T_y, T_x) 0/1 -> the 0/1 path in neg_cent's dtype. CPU tensors
    take the plain version, CUDA tensors the kernel."""
    t_ys, t_xs = mask_to_lengths(mask)
    neg_cent = neg_cent * mask
    if neg_cent.device.type == "cpu":
        return maximum_path_plain(neg_cent, t_ys, t_xs)
    if neg_cent.device.type != "cuda":
        raise ValueError(f"maximum_path runs on CUDA or CPU tensors, not {neg_cent.device}")
    return maximum_path_cuda(neg_cent.float().contiguous(), t_ys, t_xs).to(neg_cent.dtype)


@contextlib.contextmanager
def recorded(calls: list):
    """Within the block, every kernel launch (`maximum_path_cuda`) appends
    its (neg_cent, t_ys, t_xs, path), copied to the host without a
    synchronisation, to `calls`: synchronise before reading them. Launches
    on CPU tensors (the plain version) are not kernel launches and are not
    recorded."""
    global maximum_path_cuda
    kernel = maximum_path_cuda

    def recording(neg, t_ys, t_xs):
        path = kernel(neg, t_ys, t_xs)
        calls.append(tuple(t.to("cpu", non_blocking=True) for t in (neg, t_ys, t_xs, path)))
        return path

    maximum_path_cuda = recording
    try:
        yield calls
    finally:
        maximum_path_cuda = kernel


def mas_bytes(t_ys: torch.Tensor, t_xs: torch.Tensor, T_y: int, T_x: int) -> int:
    """Bytes the search must move for these lengths: one f32 read of the
    t_y x t_x cells of neg_cent it depends on and one f32 write of the whole
    path (B, T_y, T_x); the lengths themselves are negligible."""
    B = int(t_ys.shape[0])
    return 4 * int((t_ys.long() * t_xs.long()).sum()) + 4 * B * T_y * T_x
