"""Ahead-of-time serving artifacts (counterpart of vits_tpu/serve/aot.py and
of `export_aot`, vits_tpu/export.py:81-117): one `torch.export` program per
bucket shape, written by `python -m vits_tpu_torch.export --convert 1` and
served by `AOTBundle`.

  model_p1_t{T}.pt2       Synthesizer.infer_p1 at text bucket T
  model_p2_t{T}_f{F}.pt2  Synthesizer.infer_p2 (the float decoder) at text
                          bucket T and frame bucket F

Each program takes the serving model's state dict (weight norm folded, as
the deployment's checkpoint.npz gives it) as its first input, a dict, as
the JAX package's graphs take `params` at call time, so no artifact carries
a copy of the weights. The prior noise is an input of phase 2, never drawn
inside it. Device constants that tracing bakes in (the masks' `arange`, the
positional table) are moved to the serving device when a program loads.

On the GPU, `AOTBundle` runs each bucket by replaying a CUDA graph of its
program, captured at that bucket's first call: static input buffers, one
memory pool shared by every bucket, outputs copied out of the graph. That
is the card's counterpart of calling a compiled `.jaxexp` executable: no
retrace and no per-op dispatch. A capture that fails raises. On the CPU the
program's module runs directly.
"""

from __future__ import annotations

import glob
import os
import re
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call

TEXT_BUCKETS = (32, 64, 96, 128, 192, 256, 384)
FRAME_BUCKETS = (128, 256, 384, 512, 768, 1024)
_P1 = re.compile(r"model_p1_t(\d+)\.pt2$")
_P2 = re.compile(r"model_p2_t(\d+)_f(\d+)\.pt2$")


class _Call(nn.Module):
    """A synthesizer's serving phase as a module's forward, the args in the
    JAX graphs' order: phase 1 (x, x_mask, emo, sid), phase 2 (attn, m_p,
    s_p, g, noise, y_mask)."""

    def __init__(self, synth: nn.Module, phase: int):
        super().__init__()
        self.synth = synth
        self.phase = phase

    def forward(self, *args):
        if self.phase == 1:
            x, x_mask, emo, sid = args
            return self.synth.infer_p1(x, emo, sid, x_mask=x_mask)
        return self.synth.infer_p2(*args)


class _Phase(nn.Module):
    """The exported function of (weights, inputs): the synthesizer is held
    outside the module tree, so `torch.export` lifts none of its weights,
    and `functional_call` runs it on the weights given."""

    def __init__(self, synth: nn.Module, phase: int):
        super().__init__()
        self.__dict__["call"] = _Call(synth, phase)

    def forward(self, params: Dict[str, torch.Tensor], *args):
        return functional_call(self.call, {f"synth.{k}": v for k, v in params.items()}, args)


def _save(ep, path: str):
    # the example inputs hold the weights: leave them out of the artifact
    if hasattr(ep, "_example_inputs"):
        ep._example_inputs = None
    torch.export.save(ep, path)


@torch.no_grad()
def export_aot(synth: nn.Module, outdir: str, hps, text_buckets: Sequence[int] = TEXT_BUCKETS,
               frame_buckets: Sequence[int] = FRAME_BUCKETS) -> int:
    """Export `synth`'s (a serving Synthesizer, weights folded, in eval mode)
    infer_p1 at every text bucket and infer_p2 at every (text, frame) bucket
    pair into `outdir`, on the device the synthesizer lies on, in float32.
    Returns the number of programs written."""
    dev = next(synth.parameters()).device
    params = dict(sorted(synth.state_dict().items()))
    inter, gin = hps.model.inter_channels, hps.model.gin_channels
    tc = hps.data.text_channels

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    n = 0
    for tb in text_buckets:
        args = (params, zeros(1, tb, tc), zeros(1, tb, 1), zeros(1, 1024),
                zeros(1, dtype=torch.long))
        ep = torch.export.export(_Phase(synth, 1), args, strict=False)
        _save(ep, os.path.join(outdir, f"model_p1_t{tb}.pt2"))
        n += 1
    for tb in text_buckets:
        for fb in frame_buckets:
            args = (params, zeros(1, fb, tb), zeros(1, tb, inter), zeros(1, tb, inter),
                    zeros(1, gin), zeros(1, fb, inter), zeros(1, fb, 1))
            ep = torch.export.export(_Phase(synth, 2), args, strict=False)
            _save(ep, os.path.join(outdir, f"model_p2_t{tb}_f{fb}.pt2"))
            n += 1
    return n


class _Graph:
    """One bucket's CUDA graph: static inputs and the captured outputs."""

    def __init__(self, graph, inputs, outputs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs


class AOTBundle:
    """The model_p1_t{T}.pt2 / model_p2_t{T}_f{F}.pt2 programs of a
    directory, loaded onto `device` (`cuda` unless "cpu"; the caller
    resolves it), run on `params`: the serving model's state dict, bound
    once (the graphs read the weights where they lie)."""

    def __init__(self, artifact_dir: str, params: Dict[str, torch.Tensor], device="cuda"):
        self.dir = artifact_dir
        self.params = dict(sorted(params.items()))
        self.device = torch.device(device)
        self.p1: Dict[int, nn.Module] = {}
        self.p2: Dict[Tuple[int, int], nn.Module] = {}
        self.graphs: Dict[tuple, _Graph] = {}
        self.capture_s: Dict[tuple, float] = {}  # seconds each bucket's capture took
        self._pool = None
        for fn in glob.glob(os.path.join(artifact_dir, "model_p*.pt2")):
            m1, m2 = _P1.search(fn), _P2.search(fn)
            if m1:
                self.p1[int(m1.group(1))] = self._load(fn)
            elif m2:
                self.p2[(int(m2.group(1)), int(m2.group(2)))] = self._load(fn)

    def _load(self, path: str) -> nn.Module:
        from torch.export.passes import move_to_device_pass
        return move_to_device_pass(torch.export.load(path), self.device).module()

    def text_buckets(self):
        return sorted(self.p1)

    def frame_buckets(self, t_bucket: int):
        return sorted(f for (t, f) in self.p2 if t == t_bucket)

    def pick_text_bucket(self, n: int) -> Optional[int]:
        for b in self.text_buckets():
            if n <= b:
                return b
        return None

    def pick_frame_bucket(self, t_bucket: int, n: int) -> Optional[int]:
        for b in self.frame_buckets(t_bucket):
            if n <= b:
                return b
        return None

    def call_p1(self, t_bucket: int, x, x_mask, emo, sid):
        """(m_p, s_p, logw, g) of phase 1 at text bucket t_bucket."""
        return self._run(("p1", t_bucket), self.p1[t_bucket], (x, x_mask, emo, sid))

    def call_p2(self, t_bucket: int, f_bucket: int, attn, m_p, s_p, g, noise, y_mask):
        """The waveform (1, F * hop, 1) of phase 2 at (t_bucket, f_bucket)."""
        return self._run(("p2", t_bucket, f_bucket), self.p2[(t_bucket, f_bucket)],
                         (attn, m_p, s_p, g, noise, y_mask))

    def _run(self, key, prog: nn.Module, args):
        if self.device.type != "cuda":
            return prog(self.params, *args)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(key, prog, args)
        for buf, a in zip(entry.inputs, args):
            buf.copy_(a)
        entry.graph.replay()
        if isinstance(entry.outputs, torch.Tensor):
            return entry.outputs.clone()
        return tuple(o.clone() for o in entry.outputs)

    def _capture(self, key, prog, args) -> _Graph:
        """Capture `prog` at this bucket: two warm-up calls on a side
        stream, then the capture into the shared pool."""
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        inputs = [a.detach().clone() for a in args]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                prog(self.params, *inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            outputs = prog(self.params, *inputs)
        torch.cuda.synchronize(self.device)
        self.capture_s[key] = time.perf_counter() - t0
        return _Graph(graph, inputs, outputs)
