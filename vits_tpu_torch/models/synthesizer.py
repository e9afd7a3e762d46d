"""The VITS synthesizer's inference half (counterpart of
vits_tpu/models/synthesizer.py): text encoder, duration predictor, reversed
coupling flows, the HiFi-GAN decoder in float and int8, and the two-phase
serving entry points `infer_p1` / `infer_p2` / `quantize_decoder`.

Tensors are channel-last (B, T, C) at every public function, as in the JAX
package. The decoder runs unpacked: the JAX package's phase packing is a TPU
lane layout with the same numerics; its int8 scales are reproduced exactly
(`vits_tpu_torch.nn.quant`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from vits_tpu_torch.models.attentions import Encoder
from vits_tpu_torch.models.modules import (
    LRELU_SLOPE,
    ResBlock2,
    ResidualCouplingLayer,
    flip_channels,
)
from vits_tpu_torch.nn import quant as Q
from vits_tpu_torch.nn.core import Conv1d, ConvTranspose1d, Dense, Embedding, LayerNorm, leaky_relu
from vits_tpu_torch.ops.seq import gen_sin_table


def _mask(x, m):
    return x if m is None else x * m


class DurationPredictor(nn.Module):
    """conv -> ReLU -> LN twice with two speaker-conditioning adds (inference;
    the shipped configs' act_func_d is ReLU)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int = 5,
                 act_func: str = "ReLU", gin_channels: int = 0):
        super().__init__()
        f, k = filter_channels, kernel_size
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

    def forward(self, x, x_mask=None, g=None):
        x = self.pre(x) + self.cond1(g)[:, None, :]
        x = self.norm_1(torch.relu(self.conv_1(_mask(x, x_mask))))
        x = x + self.cond2(g)[:, None, :]
        x = self.norm_2(torch.relu(self.conv_2(_mask(x, x_mask))))
        x = self.proj(_mask(x, x_mask))
        return _mask(x, x_mask)  # (B, T, 1) log-durations


class TextEncoder(nn.Module):
    """Dense + LN embedding of float text vectors, 1024-d emotion projection,
    learned-alpha sinusoidal positions, transformer stack, conv projection to
    (m, logs)."""

    def __init__(self, in_channels, out_channels, hidden_channels, filter_channels,
                 n_heads, n_layers, kernel_size, ffn="FFN2", gin_channels=0,
                 max_pos: int = 256 + 128):
        super().__init__()
        self.out_channels, self.hidden_channels, self.max_pos = (
            out_channels, hidden_channels, max_pos)
        h = hidden_channels
        self.emb = nn.ModuleDict({"0": Dense(in_channels, h), "1": LayerNorm(h)})
        self.emo_proj = Dense(1024, h, init="xavier")
        self.alpha = nn.Parameter(torch.tensor(1.0))
        self.encoder = Encoder(h, filter_channels, n_heads, n_layers, kernel_size,
                               ffn=ffn, gin_channels=gin_channels)
        self.proj = Conv1d(h, out_channels * 2, 1, init="xavier")

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.alpha.fill_(1.0)

    def forward(self, x, x_mask=None, emo=None, g=None):
        h, T = self.hidden_channels, x.shape[1]
        x = self.emb["1"](self.emb["0"](x))
        x = x + self.emo_proj(emo)[:, None, :]
        pe = torch.from_numpy(gen_sin_table(max(self.max_pos, T), h)[:, :T]).to(x)
        x = x * math.sqrt(h) + pe * self.alpha
        x = self.encoder(x, x_mask, g=g)
        stats = _mask(self.proj(x), x_mask)
        return x, stats[..., :self.out_channels], stats[..., self.out_channels:]


class ResidualCouplingBlock(nn.Module):
    """n_flows x (mean-only coupling + channel flip); reverse direction. The
    flows sit at indices 0, 2, 4, ... as in the torch reference's ModuleList."""

    def __init__(self, channels, hidden_channels, kernel_size,
                 dilation_rate: Sequence[int], n_layers, n_flows=4, gin_channels=0):
        super().__init__()
        self.n_flows = n_flows
        self.flows = nn.ModuleDict({
            str(2 * i): ResidualCouplingLayer(channels, hidden_channels, kernel_size,
                                              dilation_rate[i], n_layers,
                                              gin_channels=gin_channels)
            for i in range(n_flows)})

    def forward(self, x, x_mask=None, g=None):
        for i in reversed(range(self.n_flows)):
            x = self.flows[str(2 * i)](flip_channels(x), x_mask, g=g)
        return x


class Generator(nn.Module):
    """HiFi-GAN decoder: conv_pre(7) -> per stage [lrelu -> transposed-conv
    upsample -> mean of ResBlock2s] -> lrelu(0.01) -> conv_post(7, no bias)
    -> tanh. `forward` is the float path (with optional calibration record),
    `forward_q8` the int8 path over `quantize`'s params."""

    def __init__(self, initial_channel, resblock, resblock_kernel_sizes,
                 resblock_dilation_sizes, upsample_rates, upsample_initial_channel,
                 upsample_kernel_sizes, gin_channels=0):
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
                                          padding=(k - u) // 2)
            for j in range(self.num_kernels):
                rbs[str(i * self.num_kernels + j)] = ResBlock2(
                    uic // 2 ** (i + 1), resblock_kernel_sizes[j],
                    tuple(resblock_dilation_sizes[j]), gin_channels)
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
        ResBlock2 chain and conv_post run s8 x s8 -> s32; gates, residuals and
        the speaker conditioning stay float32."""
        q = qp["pre"]
        x = Q.conv1d_q8(Q.quantize_act(x, q["s_in"]), q["w8"], q["s_in"], q["s_w"],
                        q["b"], padding=3)
        m = x_mask
        for i in range(self.num_upsamples):
            x = leaky_relu(x, LRELU_SLOPE)
            if m is not None:
                x = x * m
                m = m.repeat_interleave(self.upsample_rates[i], dim=1)
            q = qp["ups"].get(str(i))
            if q is not None:
                x = Q.conv_transpose1d_q8(Q.quantize_act(x, q["s_in"]), q["wsub"], q["dmin"],
                                          q["dmax"], q["s_in"], q["s_w"], q["b"])
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
                        None, padding=3)
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
                w8, s_w = Q.quantize_transposed_kernel(up.weight.detach().permute(2, 0, 1),
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
    """The inference half of SynthesizerTrn: `infer_p1` (text encode +
    durations), `infer_p2` (prior expansion, reversed flows, decode) and
    `quantize_decoder`. Submodule names follow the JAX parameter tree, so
    `vits_tpu_torch.convert.params_from_jax` fills them mechanically."""

    def __init__(self, text_channels, inter_channels, hidden_channels, filter_channels,
                 n_heads, n_layers, kernel_size, resblock_kernel_sizes,
                 resblock_dilation_sizes, upsample_rates, upsample_initial_channel,
                 upsample_kernel_sizes, resblock="2", ffn="FFN2", hidden_size_d=256,
                 kernel_size_d=5, act_func_d="ReLU", dilation_rate=(1, 1, 1, 1),
                 n_flows=4, n_speakers=0, gin_channels=0):
        super().__init__()
        self.enc_p = TextEncoder(text_channels, inter_channels, hidden_channels,
                                 filter_channels, n_heads, n_layers, kernel_size,
                                 ffn=ffn, gin_channels=gin_channels)
        self.dp = DurationPredictor(hidden_channels, hidden_size_d, kernel_size_d,
                                    act_func=act_func_d, gin_channels=gin_channels)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5,
                                          tuple(dilation_rate), 4, n_flows=n_flows,
                                          gin_channels=gin_channels)
        self.dec = Generator(inter_channels, resblock, resblock_kernel_sizes,
                             resblock_dilation_sizes, upsample_rates,
                             upsample_initial_channel, upsample_kernel_sizes,
                             gin_channels=gin_channels)
        self.emb_g = Embedding(n_speakers, gin_channels)

    @classmethod
    def from_hps(cls, hps) -> "Synthesizer":
        """Build from an HParams config (the JAX package's JSON schema)."""
        m = hps.model
        return cls(
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
    def quantize_decoder(self, z_cal, g_cal, y_mask=None) -> Dict:
        """Calibrate the decoder on representative latents (B, T, inter) and
        speaker vectors, and quantize it. Returns dec_q8 for infer_p2."""
        return self.dec.quantize(self.dec.calibrate(z_cal, g=g_cal, x_mask=y_mask))
