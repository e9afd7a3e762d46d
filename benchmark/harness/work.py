"""The yardstick's arithmetic: least times of counted work at the card's
published peaks, from the frozen copies of the port's FLOP, K1 and K2
accounting (benchmark/reference/flops.py, rb_chain.chain_ops_bytes,
mas.mas_bytes)."""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from benchmark.harness.common import HBM_BYTES_PER_S, PEAK
from benchmark.reference import flops
from benchmark.reference.discriminators import MultiPeriodDiscriminator
from benchmark.reference.mas import mas_bytes
from benchmark.reference.rb_chain import chain_ops_bytes
from benchmark.reference.synthesizer import Synthesizer


def meta_models(hps, train: bool = False):
    """The frozen reference's synthesizer (serving, or training with
    `train`) and MPD on the meta device: shapes only."""
    with torch.device("meta"):
        synth = Synthesizer.from_hps(hps, train=train)
        disc = MultiPeriodDiscriminator(getattr(hps.model, "use_spectral_norm", False))
    return synth, disc


def synth_least_s(hps, work: Iterable[Tuple[int, int, int, bool]]) -> float:
    """Least seconds of serving work [(B, T_x, T_y, int8 decoder)]: float
    FLOPs at the fp32 peak (the engine turns TF32 off), int8 ops at the int8
    peak."""
    synth, _ = meta_models(hps)
    t = 0.0
    for B, T_x, T_y, q8 in work:
        if q8:
            s = flops.infer_q8_split(synth, B, T_x, T_y)
            t += s["int8"] / PEAK["int8"] + s["float"] / PEAK["fp32"]
        else:
            t += flops.infer_flops(synth, B, T_x, T_y) / PEAK["fp32"]
    return t


def train_least_s(hps, cfg, work: Iterable[Tuple[int, int, int]], dtype: str = "bf16") -> float:
    """Least seconds of training steps [(B, T_x, T_y)] at the `dtype` peak."""
    synth, disc = meta_models(hps, train=True)
    return sum(flops.train_step_flops(synth, disc, cfg, B, T_x, T_y)
               for B, T_x, T_y in work) / PEAK[dtype]


def k1_least_s(chains: Iterable[Tuple[int, int, int, int, int]]) -> float:
    """Least seconds of int8 ResBlock2 chains [(B, M, C, K, n_iter)] as
    launched (float32 activations): each chain's larger of int8 ops at the
    int8 peak and bytes at HBM bandwidth."""
    t = 0.0
    for B, M, C, K, n in chains:
        ops, nbytes = chain_ops_bytes(B, M, C, K, n)
        t += max(ops / PEAK["int8"], nbytes / HBM_BYTES_PER_S)
    return t


def k2_least_s(calls) -> float:
    """Least seconds of alignment searches [(t_ys, t_xs, T_y, T_x)]: their
    bytes at HBM bandwidth."""
    return sum(mas_bytes(t_ys, t_xs, T_y, T_x) for t_ys, t_xs, T_y, T_x in calls) \
        / HBM_BYTES_PER_S


def decoder_chains(hps, B: int, T_y: int):
    """The (B, M, C, K, n_iter) of every ResBlock2 chain of one int8 decode
    of B x T_y frames."""
    m = hps.model
    out, up = [], 1
    for s, u in enumerate(m.upsample_rates):
        up *= u
        C = m.upsample_initial_channel // 2 ** (s + 1)
        for k, dil in zip(m.resblock_kernel_sizes, m.resblock_dilation_sizes):
            out.append((B, T_y * up, C, k, len(dil)))
    return out
