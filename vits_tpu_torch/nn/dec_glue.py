"""The float decoder's glue kernels (`csrc/dec_glue.cu`) and their plain
twins.

`Generator.forward`'s packed body (`models/synthesizer.py`) runs each
resblock dilation step as conv1 -> `gate` -> conv2 -> `epilogue`, with bias-
free cuDNN convs on (B, C, T) float32 activations; the upsamples, conv_pre
and conv_post get their bias, mask and activation from `epilogue` too. On a
CUDA tensor each call launches its hand-written kernel on the current stream
(`counter.launches` counts them); on a CPU tensor it runs the plain twin,
the same arithmetic in PyTorch ops; any other device raises.

Masks are prefixes: `valid` (B,) int32 frames, scaled by `vmul` (an upsample
stage's frames per latent frame), or None for "all valid". Masked positions
are written as zeros. See the kernel source for the layout and the bound.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vits_tpu_torch.utils import cuda_build

SOURCE = "dec_glue.cu"
ACTS = {None: 0, "lrelu": 1, "tanh": 2}


class GlueCounter(cuda_build.LaunchCounter):
    """The kernels' launches, and the bytes they move (`bytes`): each input
    read once and each output written once over the whole pad. An upper
    figure where a mask is given: the kernels write the masked tail and do
    not read it, and the reads there are counted. Exact where every frame
    is valid."""

    def __init__(self):
        super().__init__()
        self.bytes = 0


counter = GlueCounter()  # launches of both kernels


def prefix_mask(valid: Optional[torch.Tensor], vmul: int, T: int,
                dtype=torch.float32) -> Optional[torch.Tensor]:
    """(B, 1, T) 0/1 mask of t < valid * vmul, or None."""
    if valid is None:
        return None
    t = torch.arange(T, device=valid.device)
    return (t[None, :] < valid[:, None].long() * vmul).to(dtype)[:, None, :]


def _act(v: torch.Tensor, act: Optional[str], slope: float) -> torch.Tensor:
    if act == "lrelu":
        return torch.nn.functional.leaky_relu(v, slope)
    if act == "tanh":
        return torch.tanh(v)
    return v


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def gate_plain(a: torch.Tensor, s: torch.Tensor, valid: Optional[torch.Tensor], vmul: int,
               glu: bool) -> torch.Tensor:
    """a (B, Ca, T) conv1's output without its bias, s (B, Ca) conv1's bias
    plus the speaker term: tanh(a + s) * sigmoid over the channel halves
    (glu, out (B, Ca/2, T)) or tanh(a + s) (out (B, Ca, T)), masked."""
    a = a + s[:, :, None]
    if glu:
        half = a.shape[1] // 2
        h = torch.tanh(a[:, :half]) * torch.sigmoid(a[:, half:])
    else:
        h = torch.tanh(a)
    m = prefix_mask(valid, vmul, a.shape[2], h.dtype)
    return h if m is None else h * m


def epilogue_plain(c, bias=None, x=None, acc=None, valid=None, vmul: int = 1,
                   div: float = 1.0, act: Optional[str] = None, slope: float = 0.1,
                   want_v: bool = True, want_a: bool = False):
    """v = ((acc + ((c + bias) + x)) / div) * mask, each term where given.
    Returns (v or None, act(v) or None) as want_v / want_a ask. Where x and
    acc are masked, as in the decoder, v is the eager body's: its sum of
    masked terms, masked again."""
    v = c if bias is None else c + bias[None, :, None]
    if x is not None:
        v = v + x
    if acc is not None:
        v = acc + v
    if div != 1.0:
        v = v / div
    m = prefix_mask(valid, vmul, c.shape[2], c.dtype)
    if m is not None:
        v = v * m
    return (v if want_v else None), (_act(v, act, slope) if want_a else None)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


_LIB = []


def _lib() -> ctypes.CDLL:
    if _LIB:
        return _LIB[0]
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_vits_typed", False):
        lib.dg_gate.argtypes = [_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P]
        lib.dg_gate.restype = _I
        lib.dg_epilogue.argtypes = [_P] * 5 + [_I, _P, _P] + [_I] * 3 + [_F, _I, _F, _P]
        lib.dg_epilogue.restype = _I
        lib.dg_error_string.argtypes = [_I]
        lib.dg_error_string.restype = ctypes.c_char_p
        lib._vits_typed = True
    _LIB.append(lib)
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(name, t, shape, dev, dtype=torch.float32):
    if t is None:
        return
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"dec_glue: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {dev}; got {t.dtype} {tuple(t.shape)} "
                         f"(contiguous: {t.is_contiguous()}) on {t.device}")


def _launched(lib, err: int, what: str, nbytes: int):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.dg_error_string(err).decode()}")
    counter.launches += 1
    counter.bytes += nbytes


def _stream(dev: torch.device) -> int:
    """The current stream's handle (a capture's stream while a CUDA graph is
    captured), read each launch."""
    return torch.cuda.current_stream(dev).cuda_stream


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dec_glue runs on CUDA or CPU tensors, not {t.device}")
    return t.device.type


def gate(a: torch.Tensor, s: torch.Tensor, valid: Optional[torch.Tensor], vmul: int,
         glu: bool) -> torch.Tensor:
    """`gate_plain`'s function: the kernel on CUDA, the twin on the CPU. s
    may be a column slice of a wider (B, N) matrix (its rows strided)."""
    if _device(a) == "cpu":
        return gate_plain(a, s, valid, vmul, glu)
    B, Ca, T = a.shape
    Co = Ca // 2 if glu else Ca
    dev = a.device
    _check("a", a, (B, Ca, T), dev)
    if s.shape != (B, Ca) or s.dtype != torch.float32 or s.device != dev or s.stride(1) != 1:
        raise ValueError(f"dec_glue: s must be ({B}, {Ca}) float32 rows on {dev}, unit stride")
    _check("valid", valid, (B,), dev, torch.int32)
    out = torch.empty(B, Co, T, device=dev)
    lib = _lib()
    err = lib.dg_gate(a.data_ptr(), s.data_ptr(), s.stride(0), _ptr(valid), vmul,
                      out.data_ptr(), B, Co, Ca, T, int(glu), _stream(dev))
    _launched(lib, err, "dg_gate", 4 * B * T * (Ca + Co))
    return out


def epilogue(c: torch.Tensor, bias: Optional[torch.Tensor] = None,
             x: Optional[torch.Tensor] = None, acc: Optional[torch.Tensor] = None,
             valid: Optional[torch.Tensor] = None, vmul: int = 1, div: float = 1.0,
             act: Optional[str] = None, slope: float = 0.1, want_v: bool = True,
             want_a: bool = False, out_v: Optional[torch.Tensor] = None
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """`epilogue_plain`'s function: the kernel on CUDA, the twin on the CPU.
    out_v: where the kernel writes v (x or acc may be given: it is written in
    place); a new tensor where None."""
    if _device(c) == "cpu":
        v, a = epilogue_plain(c, bias, x, acc, valid, vmul, div, act, slope, want_v, want_a)
        if out_v is not None and v is not None:
            out_v.copy_(v)
            v = out_v
        return v, a
    B, C, T = c.shape
    dev = c.device
    if act not in ACTS or not (want_v or want_a):
        raise ValueError(f"dec_glue: act {act!r} (one of {list(ACTS)}), want_v or want_a")
    for name, t in (("c", c), ("x", x), ("acc", acc), ("out_v", out_v)):
        _check(name, t, (B, C, T), dev)
    _check("bias", bias, (C,), dev)
    _check("valid", valid, (B,), dev, torch.int32)
    v = (out_v if out_v is not None else torch.empty_like(c)) if want_v else None
    a = torch.empty_like(c) if want_a else None
    lib = _lib()
    err = lib.dg_epilogue(c.data_ptr(), _ptr(bias), _ptr(x), _ptr(acc), _ptr(valid), vmul,
                          _ptr(v), _ptr(a), B, C, T, float(div), ACTS[act], float(slope),
                          _stream(dev))
    n = 1 + (x is not None) + (acc is not None) + want_v + want_a
    _launched(lib, err, "dg_epilogue", 4 * B * C * T * n)
    return v, a
