"""ONNX interchange export of the two serving phases (counterpart of
vits_tpu/onnx/export_model.py), with the JAX package's contract, which is
the reference's `torch.onnx.export` surface (emotional-vits/export.py:
197-226): two models, `model_p1.onnx` (text encoder + duration predictor)
and `model_p2.onnx` (prior expansion + reversed flows + HiFi-GAN decode),
opset 17, with the same I/O names, dtypes, channel-first layouts and
dynamic-axis annotations:

  p1: (input_text[B,T,Ctext], input_emo[B,1024], input_g[B] int64 sid)
      -> (output_m_p[B,C,T], output_s_p[B,C,T], output_logw[B,1,T],
          output_g[B,gin])                     dynamic: input_text axis 1
  p2: (input_attn[B,Ty,Tx], input_m_p[B,C,Tx], input_s_p[B,C,Tx],
       input_g[B,gin], input_noise[B,C,Ty]) -> output_wav[B,1,Twav]
                              dynamic: attn axes 1,2; m_p/s_p/noise T axes

Each phase is traced by `torch.export.export` on the model's device (the
port's serving model, weight norm folded, eval mode), decomposed to core
ATen and translated by `vits_tpu_torch.onnx.convert`. Transposes at the
boundary present the channel-first wire layout over the port's
channel-last modules. The sid is int64 on the wire, which is the port's id
dtype. p1 has no mask input and is genuinely length-dynamic: its text axis
is traced as a symbolic dim, up to the position table's `max_pos` rows (384
in configs/base.json); the JAX file's table is the same 384-row constant,
so its bound is the same. p2 is traced at a given (t_x, t_y) and is
shape-specialised beyond its annotated axes: pad to serving buckets, as
`EmoVITS` does, the contract a TensorRT optimization profile imposes.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional

import torch
from torch import nn

from vits_tpu_torch.nn.core import fold_module_weight_norm
from vits_tpu_torch.onnx.convert import convert_program

# (input names, output names, dynamic axes, graph name) of each file
P1_IO = (["input_text", "input_emo", "input_g"],
         ["output_m_p", "output_s_p", "output_logw", "output_g"],
         {"input_text": {1: "text_len"}, "output_m_p": {2: "text_len"},
          "output_s_p": {2: "text_len"}, "output_logw": {2: "text_len"}}, "vits_tpu_p1")
P2_IO = (["input_attn", "input_m_p", "input_s_p", "input_g", "input_noise"], ["output_wav"],
         {"input_attn": {1: "frames", 2: "text_len"}, "input_m_p": {2: "text_len"},
          "input_s_p": {2: "text_len"}, "input_noise": {2: "frames"},
          "output_wav": {2: "samples"}}, "vits_tpu_p2")
DOC = "vits_tpu_torch torch.export; "


class _P1(nn.Module):
    def __init__(self, synth):
        super().__init__()
        self.synth = synth

    def forward(self, text, emo, sid):
        m_p, s_p, logw, g = self.synth.infer_p1(text, emo, sid)
        return m_p.transpose(1, 2), s_p.transpose(1, 2), logw.transpose(1, 2), g


class _P2(nn.Module):
    def __init__(self, synth):
        super().__init__()
        self.synth = synth

    def forward(self, attn, m_p, s_p, g, noise):
        o = self.synth.infer_p2(attn, m_p.transpose(1, 2), s_p.transpose(1, 2), g,
                                noise.transpose(1, 2))
        return o.transpose(1, 2)


def _serving_copy(synth: nn.Module) -> nn.Module:
    """A copy of `synth` in eval mode with its weight norm folded: what the
    ONNX graphs are traced from."""
    return fold_module_weight_norm(copy.deepcopy(synth)).eval()


def _device(synth) -> torch.device:
    return next(synth.parameters()).device


def _export(model, args, dynamic_shapes, io, timings: Optional[dict]) -> bytes:
    """torch.export, decompositions and conversion of one phase, each timed
    into `timings` (seconds: "trace", "decompose", "convert")."""
    inputs, outputs, axes, graph_name = io
    t = [time.perf_counter()]
    ep = torch.export.export(model, args, dynamic_shapes=dynamic_shapes, strict=False)
    t.append(time.perf_counter())
    ep = ep.run_decompositions()
    t.append(time.perf_counter())
    data = convert_program(ep, inputs, outputs, args, axes, graph_name, DOC)
    t.append(time.perf_counter())
    if timings is not None:
        timings.update(trace=t[1] - t[0], decompose=t[2] - t[1], convert=t[3] - t[2])
    return data


@torch.no_grad()
def export_p1(synth, t_x: int = 48, timings: Optional[dict] = None) -> bytes:
    """Serialized model_p1.onnx of a port Synthesizer, traced at text length
    t_x on the synthesizer's device with the text axis dynamic."""
    model, dev = _P1(_serving_copy(synth)), _device(synth)
    args = (torch.zeros(1, t_x, synth.enc_p.emb["0"].in_features, device=dev),
            torch.zeros(1, 1024, device=dev), torch.zeros(1, dtype=torch.long, device=dev))
    text_len = torch.export.Dim("text_len", min=2, max=synth.enc_p.max_pos)
    return _export(model, args, ({1: text_len}, None, None), P1_IO, timings)


@torch.no_grad()
def export_p2(synth, t_x: int = 48, t_y: int = 384, timings: Optional[dict] = None) -> bytes:
    """Serialized model_p2.onnx (the float decoder), shape-specialised at
    t_x x t_y, traced on the synthesizer's device."""
    model, dev = _P2(_serving_copy(synth)), _device(synth)
    C, gin = synth.inter_channels, synth.emb_g.weight.shape[1]
    args = (torch.zeros(1, t_y, t_x, device=dev), torch.zeros(1, C, t_x, device=dev),
            torch.zeros(1, C, t_x, device=dev), torch.zeros(1, gin, device=dev),
            torch.zeros(1, C, t_y, device=dev))
    return _export(model, args, None, P2_IO, timings)


def export_onnx(synth, outdir: str, t_x: int = 48, t_y: int = 384,
                timings: Optional[dict] = None):
    """Write model_p1.onnx and model_p2.onnx into outdir; returns the paths.
    `timings`, a dict, receives each file's seconds by part ({"p1":
    {"trace", "decompose", "convert", "write"}, "p2": ...})."""
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for phase, fn in (("p1", lambda t: export_p1(synth, t_x, t)),
                      ("p2", lambda t: export_p2(synth, t_x, t_y, t))):
        part = {}
        data = fn(part)
        paths.append(os.path.join(outdir, f"model_{phase}.onnx"))
        start = time.perf_counter()
        with open(paths[-1], "wb") as f:
            f.write(data)
        part["write"] = time.perf_counter() - start
        if timings is not None:
            timings[phase] = part
    return tuple(paths)
