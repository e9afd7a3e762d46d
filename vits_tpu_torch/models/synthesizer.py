"""The VITS synthesizer (counterpart of vits_tpu/models/synthesizer.py):
text encoder, duration predictor, posterior encoder, coupling flows, the
HiFi-GAN decoder in float and int8, the training graph `forward`, the
two-phase serving entry points `infer_p1` / `infer_p2` / `quantize_decoder`,
the one-graph `inference` of the fused serving path, and `stream_decode`.

Tensors are channel-last (B, T, C) at every public function, as in the JAX
package. The decoder runs unpacked: the JAX package's phase packing is a TPU
lane layout with the same numerics; its int8 scales are reproduced exactly
(`vits_tpu_torch.nn.quant`).

Serving builds the model with `Synthesizer.from_hps(hps)`: plain kernels (the
checkpoint's weight norm folded) and no posterior encoder. Training builds it
with `from_hps(hps, train=True)`: weight-norm g/v pairs where the JAX package
has them, the posterior encoder, and the dropout rates. `forward` takes its
noise as tensors (`draw_noise`), so the same noise can reach both packages.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from vits_tpu_torch.models.attentions import Encoder
from vits_tpu_torch.models.modules import (
    LRELU_SLOPE,
    WN,
    ResBlock2,
    ResidualCouplingLayer,
    flip_channels,
)
from vits_tpu_torch.nn import quant as Q
from vits_tpu_torch.nn.core import (Conv1d, ConvTranspose1d, Dense, Embedding, LayerNorm,
                                    dropout, leaky_relu)
from vits_tpu_torch.ops import mas
from vits_tpu_torch.ops.seq import (gen_sin_table, generate_path, rand_slice_segments,
                                    sequence_mask)


def _mask(x, m):
    return x if m is None else x * m


def stream_windows(n_frames: int, chunk: int, halo: int, limit: Optional[int] = None):
    """The decode windows of a chunked decode of n_frames frames: for each
    chunk start s, (s, lo, hi, keep), the window [lo, hi) reaching `halo`
    frames past the chunk on each side (clipped to [0, limit), limit
    defaulting to n_frames) and the `keep` frames of it from s on that the
    chunk contributes."""
    limit = n_frames if limit is None else limit
    for s in range(0, n_frames, chunk):
        yield s, max(0, s - halo), min(limit, s + chunk + halo), min(chunk, n_frames - s)


class DurationPredictor(nn.Module):
    """conv -> ReLU -> LN (-> dropout in training mode) twice with two
    speaker-conditioning adds (the shipped configs' act_func_d is ReLU). Its
    inputs are detached: the duration loss trains this module alone."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int = 5,
                 act_func: str = "ReLU", gin_channels: int = 0, p_dropout: float = 0.0):
        super().__init__()
        f, k = filter_channels, kernel_size
        self.p_dropout = p_dropout
        if act_func.lower() != "relu":
            raise NotImplementedError(f"act_func {act_func}: the port's duration predictor "
                                      "runs ReLU only")
        self.pre = Conv1d(in_channels, f, 1)
        self.conv_1 = Conv1d(f, f, k, padding=k // 2)
        self.norm_1 = LayerNorm(f)
        self.conv_2 = Conv1d(f, f, k, padding=k // 2)
        self.norm_2 = LayerNorm(f)
        self.proj = Conv1d(f, 1, 1)
        self.cond1 = Dense(gin_channels, f)
        self.cond2 = Dense(gin_channels, f)

    def forward(self, x, x_mask=None, g=None, rng=None):
        p = self.p_dropout if self.training else 0.0
        x, g = x.detach(), g.detach()
        x = self.pre(x) + self.cond1(g)[:, None, :]
        x = dropout(self.norm_1(torch.relu(self.conv_1(_mask(x, x_mask)))), p, rng)
        x = x + self.cond2(g)[:, None, :]
        x = dropout(self.norm_2(torch.relu(self.conv_2(_mask(x, x_mask)))), p, rng)
        x = self.proj(_mask(x, x_mask))
        return _mask(x, x_mask)  # (B, T, 1) log-durations


class DurationDiscriminator(nn.Module):
    """The adversarial duration critic of the `-d` flag (vits_tpu
    DurationDiscriminator, synthesizer.py:127): weight-norm 1x1 projections
    of the text encoder's hidden states (`pre_x`) and of a log-duration
    (`pre_d`), four weight-norm convs with leaky ReLU 0.1 over their
    concatenation, and a plain 1x1 `out` conv to one score per token. x is
    detached here, as the JAX package stops its gradient: a generator loss
    through this module reaches the generator only through the
    log-durations."""

    def __init__(self, in_channels: int, filter_channels: int = 128, kernel_size: int = 5):
        super().__init__()
        f, k = filter_channels, kernel_size
        self.pre_x = Conv1d(in_channels, f, 1, weight_norm=True)
        self.pre_d = Conv1d(1, f, 1, weight_norm=True)
        self.convs = nn.ModuleDict({
            str(i): Conv1d(2 * f if i == 0 else f, f, k, padding=k // 2, weight_norm=True)
            for i in range(4)})
        self.out = Conv1d(f, 1, 1)

    def _score(self, x, x_mask, d):
        h = torch.cat([x, self.pre_d(d)], dim=-1)
        for conv in self.convs.values():
            h = leaky_relu(conv(_mask(h, x_mask)), 0.1)
        return _mask(self.out(_mask(h, x_mask)), x_mask)

    def forward(self, x, x_mask, d_real, d_fake):
        """x (B, T, in_channels), x_mask (B, T, 1), d_real / d_fake (B, T, 1)
        log-durations -> ([score of d_real], [score of d_fake]), each
        (B, T, 1)."""
        x = self.pre_x(x.detach())
        return [self._score(x, x_mask, d_real)], [self._score(x, x_mask, d_fake)]


class TextEncoder(nn.Module):
    """Dense + LN embedding of float text vectors, 1024-d emotion projection,
    learned-alpha sinusoidal positions, transformer stack, conv projection to
    (m, logs)."""

    def __init__(self, in_channels, out_channels, hidden_channels, filter_channels,
                 n_heads, n_layers, kernel_size, ffn="FFN2", gin_channels=0,
                 max_pos: int = 256 + 128, p_dropout: float = 0.0):
        super().__init__()
        self.out_channels, self.hidden_channels, self.max_pos = (
            out_channels, hidden_channels, max_pos)
        h = hidden_channels
        self.emb = nn.ModuleDict({"0": Dense(in_channels, h), "1": LayerNorm(h)})
        self.emo_proj = Dense(1024, h, init="xavier")
        self.alpha = nn.Parameter(torch.tensor(1.0))
        self.encoder = Encoder(h, filter_channels, n_heads, n_layers, kernel_size,
                               ffn=ffn, gin_channels=gin_channels, p_dropout=p_dropout)
        self.proj = Conv1d(h, out_channels * 2, 1, init="xavier")

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.alpha.fill_(1.0)

    def forward(self, x, x_mask=None, emo=None, g=None, rng=None):
        h, T = self.hidden_channels, x.shape[1]
        x = self.emb["1"](self.emb["0"](x))
        x = x + self.emo_proj(emo)[:, None, :]
        pe = torch.from_numpy(gen_sin_table(max(self.max_pos, T), h)[:, :T]).to(x)
        x = x * math.sqrt(h) + pe * self.alpha
        x = self.encoder(x, x_mask, g=g, rng=rng)
        stats = _mask(self.proj(x), x_mask)
        return x, stats[..., :self.out_channels], stats[..., self.out_channels:]


class PosteriorEncoder(nn.Module):
    """Linear spectrogram -> (z, m, logs) (vits_tpu PosteriorEncoder): 1x1
    conv + LN, a speaker-independent WN stack, conv projection, then
    z = m + eps * exp(logs), masked."""

    def __init__(self, in_channels, out_channels, hidden_channels, kernel_size,
                 dilation_rate, n_layers, weight_norm: bool = False):
        super().__init__()
        self.out_channels = out_channels
        h = hidden_channels
        self.pre = nn.ModuleDict({"0": Conv1d(in_channels, h, 1), "1": LayerNorm(h)})
        self.enc = WN(h, kernel_size, dilation_rate, n_layers, weight_norm=weight_norm)
        self.proj = Conv1d(h, out_channels * 2, 1)

    def forward(self, x, x_mask, eps):
        """x (B, T, spec_channels), x_mask (B, T, 1), eps (B, T,
        out_channels) standard normal noise."""
        x = _mask(self.pre["1"](self.pre["0"](x)), x_mask)
        x = self.enc(x, x_mask)
        stats = _mask(self.proj(x), x_mask)
        m, logs = stats[..., :self.out_channels], stats[..., self.out_channels:]
        return _mask(m + eps.to(m.dtype) * torch.exp(logs), x_mask), m, logs


class ResidualCouplingBlock(nn.Module):
    """n_flows x (mean-only coupling + channel flip). The flows sit at
    indices 0, 2, 4, ... as in the torch reference's ModuleList."""

    def __init__(self, channels, hidden_channels, kernel_size,
                 dilation_rate: Sequence[int], n_layers, n_flows=4, gin_channels=0,
                 weight_norm: bool = False):
        super().__init__()
        self.n_flows = n_flows
        self.flows = nn.ModuleDict({
            str(2 * i): ResidualCouplingLayer(channels, hidden_channels, kernel_size,
                                              dilation_rate[i], n_layers,
                                              gin_channels=gin_channels,
                                              weight_norm=weight_norm)
            for i in range(n_flows)})

    def forward(self, x, x_mask=None, g=None, reverse: bool = True):
        """reverse (inference): flip then the reverse coupling, last flow
        first; forward (reverse=False, training): coupling then flip."""
        if reverse:
            for i in reversed(range(self.n_flows)):
                x = self.flows[str(2 * i)](flip_channels(x), x_mask, g=g, reverse=True)
            return x
        for i in range(self.n_flows):
            x = flip_channels(self.flows[str(2 * i)](x, x_mask, g=g, reverse=False))
        return x


class Generator(nn.Module):
    """HiFi-GAN decoder: conv_pre(7) -> per stage [lrelu -> transposed-conv
    upsample -> mean of ResBlock2s] -> lrelu(0.01) -> conv_post(7, no bias)
    -> tanh. `forward` is the float path (with optional calibration record),
    `forward_q8` the int8 path over `quantize`'s params."""

    def __init__(self, initial_channel, resblock, resblock_kernel_sizes,
                 resblock_dilation_sizes, upsample_rates, upsample_initial_channel,
                 upsample_kernel_sizes, gin_channels=0, weight_norm: bool = False):
        super().__init__()
        if str(resblock) != "2":
            raise NotImplementedError("the port serves ResBlock2 decoders (the shipped "
                                      "configs' resblock); ResBlock1 is not ported yet")
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.num_kernels = len(resblock_kernel_sizes)
        self.num_upsamples = len(upsample_rates)
        uic = upsample_initial_channel
        self.conv_pre = Conv1d(initial_channel, uic, 7, padding=3)
        ups, rbs = {}, {}
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ups[str(i)] = ConvTranspose1d(uic // 2 ** i, uic // 2 ** (i + 1), k, u,
                                          padding=(k - u) // 2, weight_norm=weight_norm)
            for j in range(self.num_kernels):
                rbs[str(i * self.num_kernels + j)] = ResBlock2(
                    uic // 2 ** (i + 1), resblock_kernel_sizes[j],
                    tuple(resblock_dilation_sizes[j]), gin_channels, weight_norm=weight_norm)
        self.ups = nn.ModuleDict(ups)
        self.resblocks = nn.ModuleDict(rbs)
        self.conv_post = Conv1d(uic // 2 ** self.num_upsamples, 1, 7, padding=3, bias=False)

    def _length_preserving(self, i) -> bool:
        u, k = self.upsample_rates[i], self.upsample_kernel_sizes[i]
        return k == 2 * ((k - u) // 2) + u

    def forward(self, x, g=None, x_mask=None, record: Optional[Dict] = None):
        """x (B, T, initial), x_mask (B, T, 1) -> (B, T * prod(rates), 1).
        record: a dict that collects the max-abs of every quantizable conv
        input (the JAX package's calibration points)."""
        if record is not None:
            record["pre_in"] = Q.amax(x)
        x = self.conv_pre(x)
        m = x_mask
        for i in range(self.num_upsamples):
            x = leaky_relu(x, LRELU_SLOPE)
            if m is not None:
                x = x * m
                m = m.repeat_interleave(self.upsample_rates[i], dim=1)
            if record is not None:
                record[f"up{i}_in"] = Q.amax(x)
            x = _mask(self.ups[str(i)](x), m)
            xs = None
            for j in range(self.num_kernels):
                idx = i * self.num_kernels + j
                y = self.resblocks[str(idx)](x, g, x_mask=m, record=record,
                                             rec_prefix=f"rb{idx}_")
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels
        x = leaky_relu(x, 0.01)
        xm = _mask(x, m)
        if record is not None:
            record["post_in"] = Q.amax(xm)
        return torch.tanh(self.conv_post(xm))

    def forward_q8(self, qp: Dict, x, g=None, x_mask=None):
        """The int8 decoder: conv_pre, the length-preserving upsamples, every
        ResBlock2 chain and conv_post run s8 x s8 -> s32, each dequantized
        to the activation dtype (float32 or bfloat16); gates, residuals and
        the speaker conditioning stay in it (K1 computes its gate in f32)."""
        q = qp["pre"]
        x = Q.conv1d_q8(Q.quantize_act(x, q["s_in"]), q["w8"], q["s_in"], q["s_w"],
                        q["b"], padding=3, out_dtype=x.dtype)
        m = x_mask
        for i in range(self.num_upsamples):
            x = leaky_relu(x, LRELU_SLOPE)
            if m is not None:
                x = x * m
                m = m.repeat_interleave(self.upsample_rates[i], dim=1)
            q = qp["ups"].get(str(i))
            if q is not None:
                x = Q.conv_transpose1d_q8(Q.quantize_act(x, q["s_in"]), q["wsub"], q["dmin"],
                                          q["dmax"], q["s_in"], q["s_w"], q["b"],
                                          out_dtype=x.dtype)
            else:  # not length-preserving: the JAX package runs this stage in float
                x = self.ups[str(i)](x)
            x = _mask(x, m)
            xs = None
            for j in range(self.num_kernels):
                idx = str(i * self.num_kernels + j)
                y = self.resblocks[idx].apply_q8(qp["resblocks"][idx], x, g, x_mask=m)
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels
        x = leaky_relu(x, 0.01)
        xm = _mask(x, m)
        q = qp["post"]
        x = Q.conv1d_q8(Q.quantize_act(xm, q["s_in"]), q["w8"], q["s_in"], q["s_w"],
                        None, padding=3, out_dtype=xm.dtype)
        return torch.tanh(x)

    @torch.no_grad()
    def calibrate(self, x, g=None, x_mask=None) -> Dict[str, torch.Tensor]:
        """One float decode recording the max-abs of every quantizable conv
        input; feed to `quantize`."""
        record = {}
        self.forward(x, g=g, x_mask=x_mask, record=record)
        return record

    @torch.no_grad()
    def quantize(self, scales: Dict[str, torch.Tensor]) -> Dict:
        """Post-training int8 quantization of the whole decoder from a
        calibration record. Per-output-channel weight scales for the regular
        convs; per-(output phase mod stride, channel) scales for the
        upsamples, the scales the JAX package's packed quantization gives."""
        w8, s_w = Q.quantize_kernel(Q.kernel_klast(self.conv_pre.weight))
        qp = {"pre": {"w8": w8, "s_w": s_w, "b": self.conv_pre.bias.detach().float(),
                      "s_in": Q.act_scale(scales["pre_in"])},
              "ups": {}, "resblocks": {}}
        for i in range(self.num_upsamples):
            if self._length_preserving(i):
                up = self.ups[str(i)]
                u, pad = self.upsample_rates[i], up.padding
                w8, s_w = Q.quantize_transposed_kernel(up.kernel().detach().permute(2, 0, 1),
                                                       u, pad)
                wsub, dmin, dmax = Q.transposed_subpixel_kernel(w8, u, pad)
                qp["ups"][str(i)] = {"wsub": wsub, "dmin": dmin, "dmax": dmax, "s_w": s_w,
                                     "b": up.bias.detach().float(),
                                     "s_in": Q.act_scale(scales[f"up{i}_in"])}
            for j in range(self.num_kernels):
                idx = str(i * self.num_kernels + j)
                qp["resblocks"][idx] = self.resblocks[idx].quantize_params(
                    scales, prefix=f"rb{idx}_")
        w8, s_w = Q.quantize_kernel(Q.kernel_klast(self.conv_post.weight))
        qp["post"] = {"w8": w8, "s_w": s_w, "s_in": Q.act_scale(scales["post_in"])}
        return qp


class Synthesizer(nn.Module):
    """SynthesizerTrn: `forward` (the training graph, with `spec_channels`
    set), `infer_p1` (text encode + durations), `infer_p2` (prior expansion,
    reversed flows, decode) and `quantize_decoder`. The constructor takes the
    JAX package's Synthesizer fields; `spec_channels=None` leaves out the
    posterior encoder (serving), `weight_norm=True` builds trainable g/v
    pairs. Submodule names follow the JAX parameter tree, so
    `vits_tpu_torch.convert.params_from_jax` fills them mechanically."""

    def __init__(self, text_channels, inter_channels, hidden_channels, filter_channels,
                 n_heads, n_layers, kernel_size, resblock_kernel_sizes,
                 resblock_dilation_sizes, upsample_rates, upsample_initial_channel,
                 upsample_kernel_sizes, resblock="2", ffn="FFN2", hidden_size_d=256,
                 kernel_size_d=5, act_func_d="ReLU", dilation_rate=(1, 1, 1, 1),
                 n_flows=4, n_speakers=0, gin_channels=0, spec_channels=None,
                 segment_size=None, p_dropout=0.0, kernel_size_q=5, n_layers_q=16,
                 p_dropout_d=0.0, weight_norm: bool = False):
        super().__init__()
        self.inter_channels, self.segment_size = inter_channels, segment_size
        wn = weight_norm
        self.enc_p = TextEncoder(text_channels, inter_channels, hidden_channels,
                                 filter_channels, n_heads, n_layers, kernel_size,
                                 ffn=ffn, gin_channels=gin_channels, p_dropout=p_dropout)
        if spec_channels is not None:
            self.enc_q = PosteriorEncoder(spec_channels, inter_channels, hidden_channels,
                                          kernel_size_q, 1, n_layers_q, weight_norm=wn)
        self.dp = DurationPredictor(hidden_channels, hidden_size_d, kernel_size_d,
                                    act_func=act_func_d, gin_channels=gin_channels,
                                    p_dropout=p_dropout_d)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5,
                                          tuple(dilation_rate), 4, n_flows=n_flows,
                                          gin_channels=gin_channels, weight_norm=wn)
        self.dec = Generator(inter_channels, resblock, resblock_kernel_sizes,
                             resblock_dilation_sizes, upsample_rates,
                             upsample_initial_channel, upsample_kernel_sizes,
                             gin_channels=gin_channels, weight_norm=wn)
        self.emb_g = Embedding(n_speakers, gin_channels)

    @classmethod
    def from_hps(cls, hps, train: bool = False) -> "Synthesizer":
        """Build from an HParams config (the JAX package's JSON schema);
        train=True builds the training model (posterior encoder, weight
        norm, the segment size in frames)."""
        m = hps.model
        extra = {}
        if train:
            extra = dict(spec_channels=hps.data.filter_length // 2 + 1,
                         segment_size=hps.train.segment_size // hps.data.hop_length,
                         kernel_size_q=getattr(m, "kernel_size_q", 5),
                         n_layers_q=getattr(m, "n_layers_q", 16), weight_norm=True)
        return cls(
            **extra,
            p_dropout=getattr(m, "p_dropout", 0.0),
            p_dropout_d=getattr(m, "p_dropout_d", 0.5),
            text_channels=hps.data.text_channels,
            inter_channels=m.inter_channels,
            hidden_channels=m.hidden_channels,
            filter_channels=m.filter_channels,
            n_heads=m.n_heads,
            n_layers=m.n_layers,
            kernel_size=m.kernel_size,
            resblock_kernel_sizes=tuple(m.resblock_kernel_sizes),
            resblock_dilation_sizes=tuple(tuple(d) for d in m.resblock_dilation_sizes),
            upsample_rates=tuple(m.upsample_rates),
            upsample_initial_channel=m.upsample_initial_channel,
            upsample_kernel_sizes=tuple(m.upsample_kernel_sizes),
            resblock=str(m.resblock),
            ffn=getattr(m, "ffn", "FFN2"),
            hidden_size_d=getattr(m, "hidden_size_d", 256),
            kernel_size_d=getattr(m, "kernel_size_d", 5),
            act_func_d=getattr(m, "act_func_d", "ReLU"),
            dilation_rate=tuple(getattr(m, "dilation_rate", (1, 1, 1, 1))),
            n_flows=getattr(m, "n_flows", 4),
            n_speakers=hps.data.n_speakers,
            gin_channels=m.gin_channels,
        )

    # training graph ---------------------------------------------------------
    def draw_noise(self, batch_size: int, t_x: int, t_y: int,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The noise `forward` takes, drawn from `generator` on the model's
        device: "post" the posterior eps (B, T_y, inter), "mas" the alignment
        noise (B, T_y, T_x), "slice" the window uniforms (B,), "fwd" the z_q
        eps (B, T_y, inter)."""
        dev = self.emb_g.weight.device
        c = self.inter_channels
        return {"post": torch.randn(batch_size, t_y, c, generator=generator, device=dev),
                "mas": torch.randn(batch_size, t_y, t_x, generator=generator, device=dev),
                "slice": torch.rand(batch_size, generator=generator, device=dev),
                "fwd": torch.randn(batch_size, t_y, c, generator=generator, device=dev)}

    def forward(self, x, x_lengths, spec, spec_lengths, emo, sid,
                noise: Dict[str, torch.Tensor], align_noise: float = 0.0,
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Training graph (vits_tpu Synthesizer.forward, synthesizer.py:674).
        x (B, T_x, text_channels), spec (B, T_y, spec_channels), emo
        (B, 1024), sid (B,) int, lengths (B,) int; noise from `draw_noise`;
        rng the dropout generator. Returns the JAX package's dict of every
        tensor the training losses need."""
        g = self.emb_g(sid)
        x_mask = sequence_mask(x_lengths, x.shape[1])[..., None].to(x.dtype)
        y_mask = sequence_mask(spec_lengths, spec.shape[1])[..., None].to(x.dtype)

        x_h, m_p, logs_p = self.enc_p(x, x_mask, emo=emo, g=g, rng=rng)
        z, m_q, logs_q = self.enc_q(spec, y_mask, eps=noise["post"])
        z_p = self.flow(z, y_mask, g=g, reverse=False)

        # MAS (no grad), synthesizer.py:694-707
        with torch.no_grad():
            logs_p_, m_p_, z_p_ = logs_p.detach(), m_p.detach(), z_p.detach()
            s_p_sq_r = torch.exp(-2.0 * logs_p_)
            nc1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p_, dim=-1)
            nc2 = torch.einsum("byc,bxc->byx", -0.5 * torch.square(z_p_), s_p_sq_r)
            nc3 = torch.einsum("byc,bxc->byx", z_p_, m_p_ * s_p_sq_r)
            nc4 = torch.sum(-0.5 * torch.square(m_p_) * s_p_sq_r, dim=-1)
            neg_cent = nc1[:, None, :] + nc2 + nc3 + nc4[:, None, :]
            # the population std over every cell, as jnp.std
            neg_cent = neg_cent + torch.std(neg_cent, correction=0) * \
                noise["mas"].to(neg_cent.dtype) * align_noise
            attn_mask = y_mask * x_mask.transpose(1, 2)
            attn = mas.maximum_path(neg_cent, attn_mask)

        # durations (synthesizer.py:709-713)
        w = torch.sum(attn, dim=1)
        logw_ = torch.log(w + 1e-6)[..., None] * x_mask
        logw = self.dp(x_h, x_mask, g=g, rng=rng)
        l_length = torch.sum(torch.abs(logw - logw_), dim=(1, 2)) / torch.sum(x_mask)

        # expand the prior (synthesizer.py:716-717)
        m_p_e = torch.einsum("byx,bxc->byc", attn, m_p)
        logs_p_e = torch.einsum("byx,bxc->byc", attn, logs_p)

        z_slice, ids_slice = rand_slice_segments(z, spec_lengths, self.segment_size,
                                                 noise["slice"])
        o = self.dec(z_slice, g=g)

        # forward-consistency branch (synthesizer.py:723-724)
        z_q = self.flow(m_p_e + noise["fwd"].to(m_p_e.dtype) * torch.exp(logs_p_e), y_mask, g=g,
                        reverse=True)
        return {
            "y_hat": o, "l_length": l_length, "attn": attn, "ids_slice": ids_slice,
            "x_mask": x_mask, "y_mask": y_mask,
            "z": z, "z_p": z_p, "m_p": m_p_e, "logs_p": logs_p_e,
            "m_q": m_q, "logs_q": logs_q, "z_q": z_q,
            "x_hidden": x_h, "logw_": logw_.detach(), "logw": logw,
        }

    # serving ---------------------------------------------------------------
    @torch.no_grad()
    def infer_p1(self, x, emo, sid, x_mask=None) -> Tuple[torch.Tensor, ...]:
        """Phase 1: encode text and predict log-durations. x (B, T_x,
        text_channels), emo (B, 1024), sid (B,) int, x_mask (B, T_x, 1).
        Returns (m_p, s_p, logw, g)."""
        if x_mask is not None:
            x_mask = x_mask.to(x.dtype)
        g = self.emb_g(sid)
        x_h, m_p, logs_p = self.enc_p(x, x_mask, emo=emo, g=g)
        logw = self.dp(x_h, x_mask, g=g)
        return m_p, torch.exp(logs_p), logw, g

    @torch.no_grad()
    def latent(self, attn, m_p, s_p, g, noise, y_mask=None) -> torch.Tensor:
        """The decoder's input: prior expanded along attn (B, T_y, T_x), plus
        pre-scaled noise (B, T_y, C) times its scale, through the reversed
        flows, masked."""
        attn = attn.to(m_p.dtype)
        if y_mask is not None:
            y_mask = y_mask.to(m_p.dtype)
        z_p = torch.einsum("byx,bxc->byc", attn, m_p) + \
            noise.to(m_p.dtype) * torch.einsum("byx,bxc->byc", attn, s_p)
        return _mask(self.flow(z_p, y_mask, g=g), y_mask)

    @torch.no_grad()
    def infer_p2(self, attn, m_p, s_p, g, noise, y_mask=None,
                 dec_q8: Optional[Dict] = None) -> torch.Tensor:
        """Phase 2: latent, then the float decoder or, with `dec_q8` from
        `quantize_decoder`, the int8 one. Returns (B, T_y * hop, 1)."""
        z = self.latent(attn, m_p, s_p, g, noise, y_mask)
        if y_mask is not None:
            y_mask = y_mask.to(m_p.dtype)
        if dec_q8 is not None:
            return self.dec.forward_q8(dec_q8, z, g=g, x_mask=y_mask)
        return self.dec(z, g=g, x_mask=y_mask)

    @torch.no_grad()
    def inference(self, x, x_lengths, emo, sid, noise_scale: float = 1.0,
                  length_scale: float = 1.0, max_frames: int = 1000,
                  noise: Optional[torch.Tensor] = None, dec_q8: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None):
        """One-graph synthesis with a static frame budget (vits_tpu
        Synthesizer.inference, synthesizer.py:734): text encoder, durations,
        the alignment built on the device by `generate_path`, the prior
        expanded, the reversed flows and the float decoder or, with `dec_q8`,
        the int8 one. x (B, T_x, text_channels), x_lengths (B,) int, emo
        (B, 1024), sid (B,) int. noise: pre-scaled prior noise (B,
        max_frames, inter); when None it is drawn from `generator` and scaled
        by noise_scale. Output lengths are clipped to max_frames. Nothing
        here reads a value back to the host. Returns (o (B, max_frames * hop,
        1), attn, y_mask, (z, z_p, m_p_e, logs_p_e))."""
        g = self.emb_g(sid)
        x_mask = sequence_mask(x_lengths, x.shape[1])[..., None].to(x.dtype)
        x_h, m_p, logs_p = self.enc_p(x, x_mask, emo=emo, g=g)
        logw = self.dp(x_h, x_mask, g=g)
        # the rate applies in f32, as the JAX engine passes it (an f32 scalar)
        w_ceil = torch.ceil((torch.exp(logw) * x_mask).float() * length_scale)[..., 0]
        y_lengths = torch.sum(w_ceil, dim=-1).clamp(min=1.0).to(torch.int32)
        y_lengths = y_lengths.clamp(max=max_frames)
        y_mask = sequence_mask(y_lengths, max_frames)[..., None].to(x.dtype)
        attn = generate_path(w_ceil, y_mask * x_mask.transpose(1, 2)).to(x.dtype)
        m_p_e = torch.einsum("byx,bxc->byc", attn, m_p)
        logs_p_e = torch.einsum("byx,bxc->byc", attn, logs_p)
        if noise is None:
            noise = torch.randn(m_p_e.shape, generator=generator, device=m_p_e.device,
                                dtype=m_p_e.dtype) * noise_scale
        z_p = m_p_e + noise.to(m_p_e.dtype) * torch.exp(logs_p_e)
        z = self.flow(z_p, y_mask, g=g)
        if dec_q8 is not None:
            o = self.dec.forward_q8(dec_q8, z * y_mask, g=g, x_mask=y_mask)
        else:
            o = self.dec(z * y_mask, g=g, x_mask=y_mask)
        return o, attn, y_mask, (z, z_p, m_p_e, logs_p_e)

    @torch.no_grad()
    def stream_decode(self, z, g=None, chunk_frames: int = 128,
                      halo: int = 24) -> torch.Tensor:
        """Chunked decode (vits_tpu Synthesizer.stream_decode,
        synthesizer.py:781): the latent z (B, T, inter) is decoded in windows
        of chunk_frames plus a receptive-field halo on each side, and only
        each window's interior is kept, so the concatenation equals a full
        decode when the halo covers the decoder's receptive radius (~15
        frames at the base config). Returns (B, T * prod(upsample_rates), 1)."""
        up = math.prod(self.dec.upsample_rates)
        outs = []
        for s, lo, hi, keep in stream_windows(z.shape[1], chunk_frames, halo):
            seg = self.dec(z[:, lo:hi], g=g)
            outs.append(seg[:, (s - lo) * up:(s - lo + keep) * up])
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def quantize_decoder(self, z_cal, g_cal, y_mask=None) -> Dict:
        """Calibrate the decoder on representative latents (B, T, inter) and
        speaker vectors, and quantize it. Returns dec_q8 for infer_p2."""
        return self.dec.quantize(self.dec.calibrate(z_cal, g=g_cal, x_mask=y_mask))
