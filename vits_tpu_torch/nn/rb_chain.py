"""int8 ResBlock2 chain: the port of TPU kernel K1
(vits_tpu/nn/pallas_rb.py::_make_kernel, launched by resblock2_chain_q8).

One ResBlock2's int8 chain over its dilations; per dilation:
  lrelu(0.1) -> quantize (divide by s_in, round half to even, clip +-127)
  -> int8 conv1 (k taps at dilation d, s8 x s8 -> s32) -> dequantize
  (acc * s_in*s_w) + b1 + cond(g) -> tanh(a) * sigmoid(b) -> mask
  -> quantize -> int8 conv2 -> dequantize + b2 -> + residual -> mask.

`resblock2_chain_q8` is the entry: on a CPU tensor it runs `chain_q8_plain`
(the arithmetic of the JAX package's `ResBlock2.apply_q8`, with exact
integer products); on a CUDA tensor it launches the hand-written kernels in
`vits_tpu_torch/csrc/rb_chain_q8.cu` (int8 `wgmma`, weights staged in
shared memory by the TMA unit) as `plan` says, or raises: one launch per
chain where a whole-chain tile fits ("chain"), else two per dilation
("split"). `counter.launches` counts the float32 form's launches and
`counter_bf16.launches` the bfloat16 form's; each counter's `last` holds its
last launch's M and `valid` tensor (on the device, not read).

Activations are float32 or bfloat16, the two forms of the kernel. In
bfloat16 the chain is the Pallas kernel's at that dtype: the arithmetic
above in float32, rounded to bf16 at the leaky ReLU (slope bf16(0.1)),
the gate (before the mask and the quantize), conv2's dequantized output
plus b2, and the residual sum.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vits_tpu_torch.nn import quant as Q
from vits_tpu_torch.nn.core import leaky_relu
from vits_tpu_torch.utils import cuda_build

SOURCE = "rb_chain_q8.cu"
LRELU_SLOPE = 0.1
IO_DTYPES = (torch.float32, torch.bfloat16)  # the kernel's two forms of x and out
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on sm_90

counter = cuda_build.LaunchCounter()        # the float32 form's launches
counter_bf16 = cuda_build.LaunchCounter()   # the bfloat16 form's


# ---------------------------------------------------------------------------
# quantized parameters
# ---------------------------------------------------------------------------

def pack_words(w8: torch.Tensor) -> torch.Tensor:
    """(K, C_in, C_out) int8 -> (K, C_in/4, C_out) int32: each word holds 4
    consecutive input channels, lowest byte first, the B-fragment word of an
    int8 `mma.sync`. The kernel reads `pack_kmajor`'s layout instead;
    scripts/bench_k1.py packs this one for the one-launch-per-dilation
    `mma.sync` kernel it times against the current one. None when C_in is
    not a multiple of 4."""
    K, C_in, C_out = w8.shape
    if C_in % 4:
        return None
    w = w8.reshape(K, C_in // 4, 4, C_out).permute(0, 1, 3, 2).contiguous()
    return w.view(torch.int32).reshape(K, C_in // 4, C_out)


def pack_kmajor(w8: torch.Tensor, nb: Optional[int] = None, glu: bool = False) -> torch.Tensor:
    """(K, C_in, C_out) int8 -> (G, K, KB * nb * 32) int8: the B operand of
    `wgmma` as the kernel copies it into shared memory. Per group of nb
    output columns (all of C_out when nb is None), per tap and per k-step of
    32 input channels (C_in zero-padded to KB * 32), a K-major nb x 32 tile
    of 8-row x 16-byte core matrices without swizzle: byte (n, k) at
    (n // 8) * 256 + (k // 16) * 128 + (n % 8) * 16 + k % 16. With `glu`,
    group g holds the GLU a-half columns [g nb/2, (g + 1) nb/2) and then the
    same columns of the b-half."""
    K, C_in, C_out = w8.shape
    nb = nb or C_out
    kp = -(-C_in // 32) * 32
    if kp != C_in:
        w8 = torch.cat([w8, w8.new_zeros(K, kp - C_in, C_out)], dim=1)
    G, KB = C_out // nb, kp // 32
    if glu:
        idx = torch.arange(C_out, device=w8.device).reshape(2, G, nb // 2)
        w8 = w8[:, :, idx.permute(1, 0, 2).reshape(-1)]
    w = w8.reshape(K, KB, 2, 16, G, nb // 8, 8).permute(4, 0, 1, 5, 2, 6, 3)
    return w.contiguous().reshape(G, K, KB * nb * 32)


def pack_kernel_operands(iters: List[Dict], kernel_size: int,
                         dilation: Sequence[int]) -> Optional[Dict]:
    """The kernel's operands for a quantized chain, packed once for the form
    `kernel_form` picks: "vec" (n, 4C + 4) f32 rows of deq1, b1, deq2, b2,
    s_in1, s_in2 per dilation; "wq" the whole-chain weights (per dilation
    conv1 then conv2, `pack_kmajor` with one group); or "w1"/"w2" per
    dilation in 64-column groups for the split form. None where no kernel
    form exists."""
    C = iters[0]["w1"].shape[1]
    form = kernel_form(C, kernel_size, dilation)
    if form is None or any(it["w2"].shape[1:] != (C // 2, C) for it in iters):
        return None
    zero = iters[0]["b1"].new_zeros(2)
    vec = torch.stack([torch.cat([it["s_in1"] * it["s_w1"], it["b1"], it["s_in2"] * it["s_w2"],
                                  it["b2"], it["s_in1"].reshape(1), it["s_in2"].reshape(1),
                                  zero]) for it in iters]).float().contiguous()
    if form == "chain":
        wq = torch.cat([torch.cat([pack_kmajor(it["w1"]).reshape(-1),
                                   pack_kmajor(it["w2"]).reshape(-1)]) for it in iters])
        return {"form": form, "vec": vec, "wq": wq.contiguous()}
    return {"form": form, "vec": vec,
            "w1": [pack_kmajor(it["w1"], SPLIT_NB, glu=True) for it in iters],
            "w2": [pack_kmajor(it["w2"], SPLIT_NB) for it in iters]}


@torch.no_grad()
def quantize_chain(convs, kernel_size: int, dilation: Sequence[int]) -> Dict:
    """Quantize one ResBlock2's convs. convs: per dilation
    (w1 (K, C, C), b1, amax1, w2 (K, C/2, C), b2, amax2) with float kernels in
    (K, C_in, C_out) layout and calibrated input max-abs values. Returns the
    chain's params: int8 kernels with per-output-channel scales, activation
    scales, and the kernel's packed operands ("kernel")."""
    iters = []
    for w1, b1, a1, w2, b2, a2 in convs:
        w1_8, s_w1 = Q.quantize_kernel(w1)
        w2_8, s_w2 = Q.quantize_kernel(w2)
        s1, s2 = Q.act_scale(a1).to(w1.device), Q.act_scale(a2).to(w1.device)
        iters.append({
            "w1": w1_8, "s_w1": s_w1, "b1": b1.detach().float(), "s_in1": s1,
            "w2": w2_8, "s_w2": s_w2, "b2": b2.detach().float(), "s_in2": s2,
        })
    return {"kernel_size": kernel_size, "dilation": tuple(dilation), "iters": iters,
            "kernel": pack_kernel_operands(iters, kernel_size, dilation)}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def chain_q8_plain(qp: Dict, x: torch.Tensor, gs: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """The chain in plain PyTorch, in the JAX package's `apply_q8` order.
    x (B, M, C) float32 or bfloat16; gs (B, n_iter, C) float32 = cond_i(g);
    valid (B,) int32. The products, dequantization and gate run in float32;
    in bfloat16 the values round to it where the Pallas chain at that dtype
    rounds (vits_tpu/nn/pallas_rb.py:119-137): the leaky ReLU of the
    residual (slope bf16(0.1)), the gate before the mask and the quantize,
    conv2's dequantized output, and the residual sum."""
    K = qp["kernel_size"]
    M, dt = x.shape[1], x.dtype
    mask = (torch.arange(M, device=x.device)[None, :] < valid[:, None]).to(dt)[..., None]
    for i, (it, d) in enumerate(zip(qp["iters"], qp["dilation"])):
        half = it["w2"].shape[1]
        xt = leaky_relu(x, LRELU_SLOPE)
        y = Q.conv1d_q8(Q.quantize_act(xt, it["s_in1"]), it["w1"], it["s_in1"], it["s_w1"],
                        it["b1"], dilation=d, padding=d * (K - 1) // 2)
        gate = torch.tanh(y[..., :half] + gs[:, i, None, :half]) * \
            torch.sigmoid(y[..., half:] + gs[:, i, None, half:])
        gate = gate.to(dt) * mask
        y = Q.conv1d_q8(Q.quantize_act(gate, it["s_in2"]), it["w2"], it["s_in2"], it["s_w2"],
                        it["b2"], padding=(K - 1) // 2, out_dtype=dt)
        x = (y + x) * mask
    return x


# ---------------------------------------------------------------------------
# plan: the kernel's form and tile for a shape (pure arithmetic, CPU-testable)
# ---------------------------------------------------------------------------

CHAIN_C = (32, 64, 128)      # channel counts the whole-chain kernel is built for
SPLIT_C = (128, 256)         # ... and the split kernels
CHAIN_TILES = tuple(range(512, 63, -32))  # whole-chain tile frames the plan weighs
CHAIN_WG = {32: 4, 64: 4, 128: 2}          # warpgroups per block, as launch_chain sets them
CHAIN_SLACK = 64             # rows read past a tile by the last 64-row wgmma tile
SPLIT_ROWS = 64              # split form: frames per block
SPLIT_NB = 64                # split form: output columns per block
SPLIT_STAGES = 4             # split form: taps in flight in the weight ring
SM_SHARED = 233472           # shared memory of one SM (each block also takes 1 KB)


@dataclass(frozen=True)
class Plan:
    """How `chain_q8_cuda` runs one chain shape.

    form: "chain" (all dilations in one launch on tiles of T frames plus the
    chain's halo on each side) or "split" (per dilation, a conv1 + gate
    launch and a conv2 + residual launch on 64-frame tiles). halo: frames a
    block reads beyond its tile on each side (the widest launch's). smem: dynamic
    shared memory per block (the largest launch's). grid: blocks of the
    (first) launch. offsets: the shared-memory layout the kernel is given
    (chain: `chain_layout`; split: `split_layout` of each launch in order)."""
    form: str
    T: int
    halo: int
    tiles: int
    smem: int
    launches: int
    grid: int
    resident: bool = False
    offsets: Tuple[int, ...] = ()


def _align(n: int, m: int) -> int:
    return -(-n // m) * m


def _k2(C: int) -> int:
    """conv2's input channels as packed: C/2, zero-padded to one 32-byte k-step."""
    return max(C // 2, 32)


def chain_halo(K: int, dilation: Sequence[int]) -> int:
    """Frames a whole-chain tile needs on each side: sum of (d + 1)(k - 1)/2."""
    return sum((d + 1) * (K - 1) // 2 for d in dilation)


def chain_layout(C: int, K: int, n: int, T: int, halo: int, resident: bool) -> Tuple[int, ...]:
    """Shared-memory layout of the whole-chain kernel: (off_xs, off_q, off_g,
    off_bar, total bytes). Weights at 0 (all n dilations when resident, else
    a ring of one dilation's conv1 and conv2), then the f32 residual (R rows
    of C + 8 floats, R = T + 2 halo), the int8 input and gate tiles (R + 64
    rows of C and of max(C/2, 32) bytes, chunk-major) and two mbarriers."""
    wbytes = (n if resident else 1) * K * C * (C + _k2(C))
    R = T + 2 * halo
    off_xs = _align(wbytes, 16)
    off_q = off_xs + R * (C + 8) * 4
    off_g = off_q + (R + CHAIN_SLACK) * C
    off_bar = _align(off_g + (R + CHAIN_SLACK) * _k2(C), 8)
    return off_xs, off_q, off_g, off_bar, off_bar + 16


def split_layout(C: int, K: int, d: int, mode: int) -> Tuple[int, ...]:
    """Shared-memory layout of a split launch (mode 0 conv1 + gate, 1 conv2):
    (off_a, off_bar, total bytes). A ring of SPLIT_STAGES taps of packed
    weights (K_in x 64 bytes each), the int8 input tile (64 + (k-1) step rows
    of K_in bytes, chunk-major), one mbarrier per stage."""
    k_in = C if mode == 0 else C // 2
    step = d if mode == 0 else 1
    rows = SPLIT_ROWS + (K - 1) * step
    off_a = SPLIT_STAGES * k_in * SPLIT_NB
    off_bar = _align(off_a + rows * k_in, 8)
    return off_a, off_bar, off_bar + 8 * SPLIT_STAGES


def _chain_fit(C: int, K: int, n: int, T: int, halo: int):
    for resident in (True, False):
        lay = chain_layout(C, K, n, T, halo, resident)
        if lay[-1] <= SMEM_LIMIT:
            return resident, lay
    return None


def kernel_form(C: int, K: int, dilation: Sequence[int]) -> Optional[str]:
    """"chain" where a whole-chain tile of 64 frames fits beside one
    dilation's weights, else "split"; None where neither kernel is built."""
    n = len(dilation)
    if K % 2 == 0 or n < 1:
        return None
    if C in CHAIN_C and n <= 3 and _chain_fit(C, K, n, min(CHAIN_TILES), chain_halo(K, dilation)):
        return "chain"
    return "split" if C in SPLIT_C else None


def chain_blocks_per_sm(C: int, smem: int) -> int:
    """Whole-chain blocks one SM holds: two at C = 32, whose kernel keeps to
    64 registers a thread, where the shared memory takes two; else one."""
    return 2 if C == 32 and 2 * (smem + 1024) <= SM_SHARED else 1


def chain_plan(B: int, M: int, C: int, K: int, dilation: Tuple[int, ...], T: int,
               n_sm: int = 132) -> Optional[Plan]:
    """The whole-chain plan at tile T, or None where T does not fit. Its
    blocks are persistent, as many as the SMs hold, each walking tiles."""
    halo = chain_halo(K, dilation)
    fit = _chain_fit(C, K, len(dilation), T, halo)
    if fit is None:
        return None
    resident, lay = fit
    tiles = B * -(-M // T)
    grid = min(tiles, chain_blocks_per_sm(C, lay[-1]) * n_sm)
    return Plan("chain", T, halo, tiles, lay[-1], 1, grid, resident, lay[:-1])


def chain_rounds(C: int, K: int, dilation: Sequence[int], T: int) -> int:
    """Rounds of 64-row wgmma tiles a whole-chain block runs per tile: each
    conv covers the rows still valid after it, shared by its warpgroups."""
    rows, a, rounds = T + 2 * chain_halo(K, dilation), 0, 0
    for d in dilation:
        p1, p2 = d * (K - 1) // 2, (K - 1) // 2
        for r in (rows - 2 * (a + p1), rows - 2 * (a + p1 + p2)):
            rounds += -(-r // (64 * CHAIN_WG[C]))
        a += p1 + p2
    return rounds


@functools.lru_cache(maxsize=None)
def plan(B: int, M: int, C: int, K: int, dilation: Tuple[int, ...], n_sm: int = 132) -> Plan:
    """The kernel's plan for x (B, M, C) and one chain of kernel size K over
    `dilation`. The whole-chain tile T (a multiple of 32 in [64, 512]) is
    the one that fits and gives the busiest block slot the fewest wgmma
    rounds, ceil(tiles / grid) * chain_rounds, the smaller T on a tie (a
    sweep of every T on an H100, scripts/bench_k1.py --sweep, found the
    fastest or within 8% of it at the base shapes). Raises where no kernel
    form exists."""
    dilation = tuple(int(d) for d in dilation)
    form = kernel_form(C, K, dilation)
    if form is None:
        raise ValueError(f"rb2_chain_q8 has no kernel for C={C}, k={K}, dilations {dilation}")
    if form == "chain":
        plans = [p for p in (chain_plan(B, M, C, K, dilation, T, n_sm) for T in CHAIN_TILES) if p]
        return min(plans, key=lambda p: (-(-p.tiles // p.grid) * chain_rounds(C, K, dilation, p.T),
                                         p.T))
    tiles = B * -(-M // SPLIT_ROWS)
    lays = tuple(split_layout(C, K, d, mode) for d in dilation for mode in (0, 1))
    return Plan("split", SPLIT_ROWS, max(dilation) * (K - 1) // 2, tiles,
                max(lay[-1] for lay in lays), 2 * len(dilation), tiles * (C // 64),
                offsets=lays)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_vits_typed", False):
        lib.rb2_chain_q8.argtypes = [_P] * 6 + [_I] * 18 + [_P]
        lib.rb2_chain_q8.restype = _I
        lib.rb2_split_q8.argtypes = [_I] + [_P] * 8 + [_I] * 11 + [_P]
        lib.rb2_split_q8.restype = _I
        lib.rb2_error_string.argtypes = [_I]
        lib.rb2_error_string.restype = ctypes.c_char_p
        lib._vits_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"rb2_chain_q8: {name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_operands(kp: Dict, C: int, K: int, n: int, dev: torch.device):
    """The packed operands, checked once per device they are used on."""
    if kp.get("checked_on") == dev:
        return
    _check("vec", kp["vec"], torch.float32, (n, 4 * C + 4), dev)
    if kp["form"] == "chain":
        _check("wq", kp["wq"], torch.int8, (n * K * C * (C + _k2(C)),), dev)
    else:
        for w1, w2 in zip(kp["w1"], kp["w2"]):
            _check("w1", w1, torch.int8, (C // 64, K, C * SPLIT_NB), dev)
            _check("w2", w2, torch.int8, (C // 64, K, (C // 2) * SPLIT_NB), dev)
    kp["checked_on"] = dev


def _raise_on(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.rb2_error_string(err).decode()}")


def chain_q8_cuda(qp: Dict, x: torch.Tensor, gs: torch.Tensor, valid: torch.Tensor,
                  p: Optional[Plan] = None) -> torch.Tensor:
    """Launch the kernel on the current stream as `plan` (or the given plan
    of the same form, for tuning: another tile of `chain_plan`) says: once
    per chain (whole-chain form) or twice per dilation (split form). The C
    entries recompute the plan's numbers from the shape and refuse, with
    "invalid argument", any that differ. x float32 or bfloat16: the
    kernel's form of that I/O type; the output has x's dtype."""
    B, M, C = x.shape
    K, dil = qp["kernel_size"], tuple(qp["dilation"])
    n = len(dil)
    dev = x.device
    kp = qp.get("kernel")
    if kp is None:
        raise ValueError(f"rb2_chain_q8 has no kernel for C={C}, k={K}, dilations {dil}")
    if p is None:
        p = plan(B, M, C, K, dil, _n_sm(dev.index if dev.index is not None else
                                        torch.cuda.current_device()))
    if p.form != kp["form"]:
        raise ValueError(f"rb2_chain_q8: weights packed for the {kp['form']} form, the plan "
                         f"for C={C} k={K} is {p.form}")
    if x.dtype not in IO_DTYPES:
        raise ValueError(f"rb2_chain_q8: x must be float32 or bfloat16, got {x.dtype}")
    bf16 = int(x.dtype == torch.bfloat16)
    count = counter_bf16 if bf16 else counter
    _check("x", x, x.dtype, (B, M, C), dev)
    _check("gs", gs, torch.float32, (B, n, C), dev)
    _check("valid", valid, torch.int32, (B,), dev)
    _check_operands(kp, C, K, n, dev)
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if p.form == "chain":
        out = torch.empty_like(x)
        d = list(dil) + [1] * (3 - n)
        err = lib.rb2_chain_q8(x.data_ptr(), out.data_ptr(), kp["wq"].data_ptr(),
                               kp["vec"].data_ptr(), gs.data_ptr(), valid.data_ptr(),
                               B, M, C, K, n, d[0], d[1], d[2], p.T, p.halo, int(p.resident),
                               *p.offsets, p.smem, p.grid, bf16, stream)
        _raise_on(lib, err, "rb2_chain_q8")
        count.launches += 1
        count.last = (M, valid)
        return out
    gate = torch.empty(B, M, C // 2, dtype=torch.int8, device=dev)
    xq = torch.empty(B, M, C, dtype=torch.int8, device=dev) if n > 1 else gate
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    cur = x
    for i, d in enumerate(dil):
        nxt = bufs[i % 2]
        for mode, w in ((0, kp["w1"][i]), (1, kp["w2"][i])):
            off_a, off_bar, smem = p.offsets[2 * i + mode]
            err = lib.rb2_split_q8(mode, cur.data_ptr(), gate.data_ptr(), xq.data_ptr(),
                                   nxt.data_ptr(), w.data_ptr(), kp["vec"].data_ptr(),
                                   gs.data_ptr(), valid.data_ptr(), B, M, C, K, d, i, n,
                                   off_a, off_bar, smem, bf16, stream)
            _raise_on(lib, err, "rb2_split_q8")
            count.launches += 1
            count.last = (M, valid)
        cur = nxt
    return cur


def resblock2_chain_q8(qp: Dict, x: torch.Tensor, gs: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """One ResBlock2's int8 chain. x (B, M, C) float32 or bfloat16
    activations (masked like the JAX package's apply_q8 input), the output
    in x's dtype; gs (B, n_iter, C) float32 gate
    conditioning cond_i(g); valid (B,) int32 valid-frame counts (<= M).
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return chain_q8_plain(qp, x, gs, valid)
    if x.device.type != "cuda":
        raise ValueError(f"rb2_chain_q8 runs on CUDA or CPU tensors, not {x.device}")
    return chain_q8_cuda(qp, x, gs, valid)


def chain_ops_bytes(B: int, M: int, C: int, K: int, n_iter: int,
                    io_bytes: int = 4) -> List[int]:
    """(operations, bytes) one chain needs: 2 ops per int8 MAC of both convs
    of every dilation; each activation (io_bytes: 4 in float32, 2 in
    bfloat16) read once and written once, the int8 weights and the f32
    per-channel vectors read once."""
    ops = n_iter * 2 * B * M * K * (C * C + (C // 2) * C)
    weights = n_iter * (K * C * C + K * (C // 2) * C)
    vectors = n_iter * 4 * (5 * C + 2) + B * n_iter * C * 4 + B * 4
    return [ops, 2 * B * M * C * io_bytes + weights + vectors]
