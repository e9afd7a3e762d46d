"""The port's CUDA graphs: `Graph`, the one way the port captures and replays
one, and `HalfGraphs`, the fused serving path's two launch-bound halves.

A `Graph` holds a function and its static inputs. Each call loads its
arguments into those inputs; once `capture` has run, it replays the graph,
else it runs the function on them. A capture warms the function up on a side
stream (as many times as its caller asks), then records it into the memory
pool it is given. The outputs are the graph's own tensors, valid until a
replay writes the pool where they lie: a caller whose outputs must outlive
other replays in the pool copies them (`serve/aot.py` does).

`EmoVITS.infer_fused` reads one number back to the host, the frame count,
and splits there. Each side has a chain of small kernels whose shapes depend
on a pad alone, and a batch-1 request keeps the card waiting while the host
launches them one by one. `HalfGraphs` holds each chain once per pad:

- the head, one a text pad: `Synthesizer.inference_durations` with no budget
  clamp (the speaker vector, the mask from `x_lengths`, the text encoder,
  the duration predictor, each token's frames and the frame count). Its
  static inputs are x (1, x_pad, text_channels), x_lengths (1,) int32, emo
  (1, 1024), sid (1,) long and the duration rate, a 0-d float32 tensor;
  nothing of a request is captured as a constant. The budget clamp is left
  to the host: the engine compares the count it reads back with the budget,
  which retries the same requests as a clamp (a count clamped to the budget
  reaches it exactly when the count does) and, below the budget, serves the
  same count.
- the reversed flows, one a frame pad: `synth.flow(z_p, y_mask, g)` with z_p
  (1, y_pad, inter), y_mask (1, y_pad, 1) and g (1, gin) static. The
  alignment before them and the decoder after them run as they are.

The engine builds `HalfGraphs` on every device and serves every fused pass
through it. On CUDA, where no AOT bundle serves, every graph is captured
when `HalfGraphs` is built, after one warm-up, so no capture falls in a
request. The graphs share one memory pool. The heads are captured before the
flows, so a flow's replay writes only where graphs captured after it keep
their outputs: a request's head outputs survive its flows. The engine is
serial and reads the outputs before the next replay. Elsewhere nothing is
captured and each entry runs its function.

While a profiler records, a replay runs in its half's span ("synth.head",
"synth.flow"), loading its arguments included; a function run opens no span
of its own, so the model's spans show once.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from vits_tpu_torch.utils.profiling import span


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device):
    """The one stream a device that every capture's warm-ups run on. cuBLAS
    keeps a workspace for each stream it runs on: a new stream for each of
    the serving engine's 76 captures held about 1 GB more of the card."""
    return torch.cuda.Stream(device)


class Graph:
    """`fn` on static inputs, a CUDA graph once captured. `name` is the span
    a replay runs in (none without a name)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], name: Optional[str] = None):
        self.fn, self.inputs, self.name = fn, tuple(inputs), name
        self.graph = self.outputs = None

    def capture(self, pool, warmups: int):
        """Run `fn` `warmups` times on a side stream, then capture it into
        `pool` (a `torch.cuda.graph_pool_handle()`)."""
        dev = self.inputs[0].device
        current, side = torch.cuda.current_stream(dev), _side_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(warmups):
                self.fn(*self.inputs)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            self.outputs = self.fn(*self.inputs)
        self.graph = graph

    def _load(self, args):
        for buf, a in zip(self.inputs, args):
            if isinstance(a, torch.Tensor):
                buf.copy_(a)
            else:
                buf.fill_(a)

    def __call__(self, *args, **kwargs):
        """Load `args`, then `kwargs` in their order, into the static inputs
        (a tensor is copied, a number filled) and run: the graph's replay,
        or the function itself."""
        args += tuple(kwargs.values())
        if self.graph is None:
            self._load(args)
            return self.fn(*self.inputs)
        with span(self.name) if self.name else contextlib.nullcontext():
            self._load(args)
            self.graph.replay()
        return self.outputs


class HalfGraphs:
    """`heads[x_pad](x, x_length, emo, sid, rate)` -> InferenceHead (its
    `y_lengths` not clamped to a budget) and `flows[y_pad](z_p, y_mask, g)`
    -> z, for the pads given; each a `Graph`, captured at construction where
    `capture` (CUDA only). `captures` counts the graphs captured."""

    def __init__(self, synth, device, dtype: torch.dtype, text_channels: int,
                 text_pads: Iterable[int], frame_pads: Iterable[int], capture: bool):
        device = torch.device(device)
        C, gin = synth.inter_channels, synth.emb_g.weight.shape[1]

        def head(x, x_lengths, emo, sid, rate):
            return synth.inference_durations(x, x_lengths, emo, sid, length_scale=rate,
                                             max_frames=None)

        def flow(z_p, y_mask, g):
            return synth.flow(z_p, y_mask, g=g)

        def zeros(*shape, dt=dtype):
            return torch.zeros(*shape, dtype=dt, device=device)

        def new_head(p):
            return Graph(head, (zeros(1, p, text_channels),
                                torch.full((1,), p, dtype=torch.int32, device=device),
                                zeros(1, 1024), zeros(1, dt=torch.long),
                                torch.ones((), device=device)), "synth.head")

        self._new_head = new_head
        with torch.inference_mode():
            self.heads: Dict[int, Graph] = {p: new_head(p) for p in text_pads}
            self.flows: Dict[int, Graph] = {
                p: Graph(flow, (zeros(1, p, C), zeros(1, p, 1), zeros(1, gin)), "synth.flow")
                for p in frame_pads}
            self.captures = 0
            if capture:
                pool = torch.cuda.graph_pool_handle()
                for entry in (*self.heads.values(), *self.flows.values()):  # heads first
                    entry.capture(pool, warmups=1)
                    self.captures += 1
                torch.cuda.synchronize(device)

    def head_at(self, x_pad: int) -> Graph:
        """The head at x_pad; where set-up built none (an empty text's pad
        0), one made for the call, not captured."""
        entry = self.heads.get(x_pad)
        return entry if entry is not None else self._new_head(x_pad)
