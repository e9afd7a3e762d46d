"""CUDA graphs of the fused serving path's two launch-bound halves.

`EmoVITS.infer_fused` reads one number back to the host, the frame count,
and splits there. Each side has a chain of small kernels whose shapes depend
on a pad alone, and a batch-1 request keeps the card waiting while the host
launches them one by one. `HalfGraphs` captures each chain once per pad and
replays it:

- the head, one graph per text pad: `Synthesizer.inference_durations` with
  no budget clamp (the speaker vector, the mask from `x_lengths`, the text
  encoder, the duration predictor, each token's frames and the frame
  count). Its static inputs are x (1, x_pad, text_channels), x_lengths
  (1,) int32, emo (1, 1024), sid (1,) long and the duration rate, a 0-d
  float32 tensor; nothing of a request is captured as a constant. The
  budget clamp is left to the host: the engine compares the count it reads
  back with the budget, which retries the same requests (a count clamped
  to the budget reaches it exactly when the count does) and, below the
  budget, serves the same count.
- the reversed flows, one graph per frame pad: `synth.flow(z_p, y_mask, g)`
  with z_p (1, y_pad, inter), y_mask (1, y_pad, 1) and g (1, gin) static.
  The alignment before them and the decoder after them stay eager.

Every graph is captured when `HalfGraphs` is built, after one eager warm-up
on a side stream, so no capture falls in a request. The graphs share one
memory pool. The heads are captured before the flows, so a flow's replay
writes only where graphs captured after it keep their outputs: a request's
head outputs survive its flows. Outputs are the graphs' own tensors, valid
until the next replay of the same graph; the engine is serial and reads
them first.

On a device other than CUDA nothing is captured: each entry runs its
function eagerly on the static inputs (the plain version the CPU tests hold
against the engine's eager path). The engine builds `HalfGraphs` on CUDA
only.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from vits_tpu_torch.utils.profiling import span


class _Entry:
    """One half at one pad: static inputs, and the graph that reads them
    (None where nothing is captured)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        self.fn, self.inputs = fn, tuple(inputs)
        self.graph = self.outputs = None

    def __call__(self, *args):
        """Load `args` into the static inputs (a tensor is copied, a number
        filled) and run: the graph's replay, or the function itself."""
        for buf, a in zip(self.inputs, args):
            if isinstance(a, torch.Tensor):
                buf.copy_(a)
            else:
                buf.fill_(a)
        if self.graph is None:
            return self.fn(*self.inputs)
        self.graph.replay()
        return self.outputs


class HalfGraphs:
    """`heads[x_pad](x, x_length, emo, sid, rate)` -> InferenceHead (its
    `y_lengths` not clamped to a budget) and `flows[y_pad](z_p, y_mask, g)`
    -> z, for the pads given; `captures` counts the graphs captured."""

    def __init__(self, synth, device, dtype: torch.dtype, text_channels: int,
                 text_pads: Iterable[int], frame_pads: Iterable[int]):
        self.device = torch.device(device)
        C, gin = synth.inter_channels, synth.emb_g.weight.shape[1]

        def head(x, x_lengths, emo, sid, rate):
            return synth.inference_durations(x, x_lengths, emo, sid, length_scale=rate,
                                             max_frames=None)

        def flow(z_p, y_mask, g):
            return synth.flow(z_p, y_mask, g=g)

        def zeros(*shape, dt=dtype):
            return torch.zeros(*shape, dtype=dt, device=self.device)

        self.captures = 0
        self._pool = self._side = None
        with torch.inference_mode():
            self.heads: Dict[int, _Entry] = {
                p: self._build(head, (zeros(1, p, text_channels),
                                      torch.full((1,), p, dtype=torch.int32, device=self.device),
                                      zeros(1, 1024), zeros(1, dt=torch.long),
                                      torch.ones((), device=self.device)))
                for p in text_pads}
            self.flows: Dict[int, _Entry] = {
                p: self._build(flow, (zeros(1, p, C), zeros(1, p, 1), zeros(1, gin)))
                for p in frame_pads}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build(self, fn: Callable, inputs) -> _Entry:
        entry = _Entry(fn, inputs)
        if self.device.type != "cuda":
            return entry
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            fn(*inputs)
        current.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            entry.outputs = fn(*inputs)
        entry.graph = graph
        self.captures += 1
        return entry

    def flow_at(self, y_pad: int) -> Optional[Callable]:
        """The flows' entry at y_pad, called as `synth.flow` is and run in
        its span ("synth.flow"); None where the pad has none."""
        entry = self.flows.get(y_pad)
        if entry is None:
            return None

        def flow(z_p, y_mask, g=None):
            with span("synth.flow"):
                return entry(z_p, y_mask, g)
        return flow
