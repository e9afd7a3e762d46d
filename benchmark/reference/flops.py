"""Closed-form FLOP accounting for the port's graphs (counterpart of
vits_tpu/utils/flops.py): the useful-FLOP count that a step's share of the
card's peak (`mfu`) divides by. Conventions, the JAX package's:

  * 1 MAC = 2 FLOPs, regardless of dtype;
  * only matmul-shaped work is counted: convolutions, dense layers,
    attention and alignment einsums, and the matmul-DFT STFT. Elementwise,
    normalisation and mask work is omitted;
  * shapes come from walking the port's modules (`Conv1d`,
    `ConvTranspose1d`, `Dense`, `Conv2d`, `WN`, the attention encoder, the
    `Generator`, the MPD and the MRD), so the count follows the model;
  * training backward: a differentiated conv or matmul costs 2x its forward
    (the input gradient and the weight gradient), so a differentiated pass
    is 3x forward; a pass that only chains gradients (no weight gradients,
    the G step's discriminator pass) is 2x; a pass without gradient is 1x.

Every function here returns the JAX package's number for the same
configuration (tests/test_torch_utils.py). The JAX package's
`generator_executed_flops` is not ported: it counts the TPU's phase-packed
decoder schedule (vits_tpu/nn/packed.py), which the port does not run.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


# ---------------------------------------------------------------------------
# primitive walkers
# ---------------------------------------------------------------------------

def conv1d_out_len(T: int, conv) -> int:
    eff_k = conv.dilation * (conv.kernel_size - 1) + 1
    return (T + 2 * int(conv.padding) - eff_k) // conv.stride + 1


def conv1d_flops(B: int, T: int, conv) -> Tuple[float, int]:
    """(flops, T_out) of a Conv1d applied to (B, T, C_in)."""
    T_out = conv1d_out_len(T, conv)
    macs = B * T_out * conv.kernel_size * (conv.in_channels // conv.groups) * conv.out_channels
    return 2.0 * macs, T_out


def conv2d_flops(B: int, H: int, W: int, conv) -> Tuple[float, int, int]:
    """(flops, H_out, W_out) of a Conv2d applied to (B, H, W, C_in)."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    ph, pw = conv.padding
    H_out = (H + 2 * ph - kh) // sh + 1
    W_out = (W + 2 * pw - kw) // sw + 1
    macs = B * H_out * W_out * kh * kw * conv.in_channels * conv.out_channels
    return 2.0 * macs, H_out, W_out


def conv_transpose1d_flops(B: int, T_in: int, conv) -> Tuple[float, int]:
    """(flops, T_out). Every input frame contributes k taps to the output."""
    macs = B * T_in * conv.kernel_size * conv.in_channels * conv.out_channels
    T_out = (T_in - 1) * conv.stride - 2 * conv.padding + conv.kernel_size
    return 2.0 * macs, T_out


def dense_flops(B: int, dense) -> float:
    return 2.0 * B * dense.in_features * dense.out_features


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def wn_flops(wn, B: int, T: int) -> float:
    """WN gated dilated stack (models/modules.py WN)."""
    h, L = wn.hidden_channels, wn.n_layers
    f = 0.0
    for i in range(L):
        f += conv1d_flops(B, T, wn.in_layers[str(i)])[0]
        f += conv1d_flops(B, T, wn.res_skip_layers[str(i)])[0]
    if wn.gin_channels:
        f += 2.0 * B * wn.gin_channels * 2 * h * L  # cond_layer Dense
    return f


def attention_encoder_flops(enc, B: int, T: int) -> float:
    """attentions.Encoder: per layer MHA (qkvo + 2 T^2 einsums) + FFN."""
    f = 0.0
    for i in range(enc.n_layers):
        h = enc.attn_layers[str(i)].channels
        f += 4 * 2.0 * B * T * h * h        # q, k, v, o projections
        f += 2 * 2.0 * B * T * T * h        # scores + probs@V
        ffn = enc.ffn_layers[str(i)]
        f += conv1d_flops(B, T, ffn.conv_1)[0]
        f += conv1d_flops(B, T, ffn.conv_2)[0]
        cond = getattr(ffn, "cond", None)   # FFN2 / FFN3
        if cond is not None and cond.in_features:
            f += dense_flops(B, cond)
    return f


def text_encoder_flops(te, B: int, T: int) -> float:
    h = te.hidden_channels
    f = 2.0 * B * T * te.emb["0"].in_features * h   # emb Dense
    f += 2.0 * B * 1024 * h                          # emo_proj
    f += attention_encoder_flops(te.encoder, B, T)
    f += 2.0 * B * T * h * 2 * te.out_channels       # proj conv 1x1
    return f


def duration_predictor_flops(dp, B: int, T: int) -> float:
    fch, k = dp.pre.out_channels, dp.conv_1.kernel_size
    f = 2.0 * B * T * dp.pre.in_channels * fch       # pre 1x1
    f += 2 * 2.0 * B * dp.cond1.in_features * fch    # cond1/cond2
    f += 2 * 2.0 * B * T * k * fch * fch             # conv_1, conv_2
    f += 2.0 * B * T * fch                           # proj
    return f


def posterior_encoder_flops(pe, B: int, T: int) -> float:
    h = pe.enc.hidden_channels
    f = 2.0 * B * T * pe.pre["0"].in_channels * h
    f += wn_flops(pe.enc, B, T)
    f += 2.0 * B * T * h * 2 * pe.out_channels
    return f


def flow_flops(fl, B: int, T: int) -> float:
    """ResidualCouplingBlock; forward and reverse cost the same."""
    f = 0.0
    for i in range(fl.n_flows):
        layer = fl.flows[str(2 * i)]
        h = layer.enc.hidden_channels
        f += 2.0 * B * T * layer.half_channels * h           # pre 1x1
        f += wn_flops(layer.enc, B, T)
        f += 2.0 * B * T * h * layer.half_channels * (2 - int(layer.mean_only))  # post
    return f


def generator_flops(gen, B: int, T: int) -> Dict[str, float]:
    """HiFi-GAN decoder on (B, T, inter). Breakdown dict + 'total'.
    'conds' are the per-resblock speaker Dense layers (stay float under q8)."""
    out: Dict[str, float] = {"conv_pre": conv1d_flops(B, T, gen.conv_pre)[0],
                             "ups": 0.0, "resblocks": 0.0, "conds": 0.0}
    t = T
    for i in range(gen.num_upsamples):
        fl, t = conv_transpose1d_flops(B, t, gen.ups[str(i)])
        out["ups"] += fl
        for j in range(gen.num_kernels):
            rb = gen.resblocks[str(i * gen.num_kernels + j)]
            for d in range(len(rb.dilation)):
                out["resblocks"] += conv1d_flops(B, t, rb.convs1[str(d)])[0]
                out["resblocks"] += conv1d_flops(B, t, rb.convs2[str(d)])[0]
                out["conds"] += dense_flops(B, rb.conds[str(d)])
    out["conv_post"] = conv1d_flops(B, t, gen.conv_post)[0]
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


# ---------------------------------------------------------------------------
# inference graphs
# ---------------------------------------------------------------------------

def infer_p1_flops(synth, B: int, T_x: int) -> float:
    """Phase 1: text encode + duration predict (Synthesizer.infer_p1)."""
    return text_encoder_flops(synth.enc_p, B, T_x) + \
        duration_predictor_flops(synth.dp, B, T_x)


def infer_p2_flops(synth, B: int, T_x: int, T_y: int) -> Dict[str, float]:
    """Phase 2: expand + flow reverse + decode. Breakdown + 'total'."""
    dec = generator_flops(synth.dec, B, T_y)
    out = {
        "expand": 2 * 2.0 * B * T_y * T_x * synth.inter_channels,  # m_p_e, s_p_e
        "flow": flow_flops(synth.flow, B, T_y),
        "decoder": dec["total"],
        "dec_breakdown": dec,
    }
    out["total"] = out["expand"] + out["flow"] + out["decoder"]
    return out


def infer_flops(synth, B: int, T_x: int, T_y: int) -> float:
    """Full two-phase inference."""
    return infer_p1_flops(synth, B, T_x) + infer_p2_flops(synth, B, T_x, T_y)["total"]


def infer_q8_split(synth, B: int, T_x: int, T_y: int) -> Dict[str, float]:
    """FLOPs by execution dtype for the int8-decoder serving mode: the
    decoder convs (pre/ups/resblocks/post) run s8 x s8 -> s32; the text
    encoder, flow, expand einsums, and speaker conds stay float."""
    p2 = infer_p2_flops(synth, B, T_x, T_y)
    dec = p2["dec_breakdown"]
    int8 = dec["conv_pre"] + dec["ups"] + dec["resblocks"] + dec["conv_post"]
    flt = infer_p1_flops(synth, B, T_x) + p2["expand"] + p2["flow"] + dec["conds"]
    return {"int8": int8, "float": flt, "total": int8 + flt}


# ---------------------------------------------------------------------------
# DSP + discriminators (training)
# ---------------------------------------------------------------------------

def stft_flops(B: int, T: int, fft: int, hop: int, win: int) -> float:
    """Matmul-DFT STFT: frames x (win -> F) for re and im."""
    frames = T // hop + 1  # center=True
    F = fft // 2 + 1
    return 2.0 * B * frames * win * F * 2


def mel_flops(B: int, T: int, fft: int, hop: int, win: int, n_mels: int) -> float:
    frames = T // hop + 1
    F = fft // 2 + 1
    return stft_flops(B, T, fft, hop, win) + 2.0 * B * frames * F * n_mels


def mpd_flops(mpd, B: int, T: int) -> float:
    """MultiPeriodDiscriminator forward on one (B, T, 1) wave."""
    f = 0.0
    for d in mpd.discriminators.values():
        if hasattr(d, "period"):  # DiscriminatorP: (B, T/p, p, 1)
            H = -(-T // d.period)
            W = d.period
            for conv in d.convs.values():
                fl, H, W = conv2d_flops(B, H, W, conv)
                f += fl
            f += conv2d_flops(B, H, W, d.conv_post)[0]
        else:  # DiscriminatorS
            t = T
            for conv in d.convs.values():
                fl, t = conv1d_flops(B, t, conv)
                f += fl
            f += conv1d_flops(B, t, d.conv_post)[0]
    return f


def mrd_flops(mrd, B: int, T: int,
              resolutions: Sequence[Tuple[int, int, int]]) -> float:
    """MultiWaveSTFTDiscriminator forward on one wave + its magnitudes."""
    f = 0.0
    t = T
    n = len(mrd.mwd.discriminators)
    for i, d in enumerate(mrd.mwd.discriminators.values()):
        tt = t
        for conv in d.convs.values():
            fl, tt = conv1d_flops(B, tt, conv)
            f += fl
        if i + 1 < n:
            t = t // 2
    for d, (fft, hop, _win) in zip(mrd.mfd.discriminators.values(), resolutions):
        H = fft // 2 + 1          # frequency axis
        W = T // hop + 1          # frames
        for conv in d.convs.values():
            fl, H, W = conv2d_flops(B, H, W, conv)
            f += fl
    return f


# ---------------------------------------------------------------------------
# training step
# ---------------------------------------------------------------------------

def train_step_flops(synth, disc, cfg, B: int, T_x: int, T_y: int) -> float:
    """Full D-then-G train step (train/step.py), base conventions above. The
    stft variant's resolutions are the MRD's (`disc.resolutions`), which the
    port's step reads.

    Differentiated generator graph (3x): enc_p, enc_q, flow fwd, dp, decoder
    on the segment, flow reverse (z_q), prior-expand einsums. MAS neg_cent
    einsums are without gradient (1x). D step: real+fake passes at 3x
    (weight grads need the full dgrad chain). G step: fake pass 2x (input
    grads only), mel-variant real pass 1x (fmaps without gradient).
    STFT/mel of y_hat 3x, of the real wave 1x.
    """
    seg_frames = cfg.segment_frames
    seg_T = seg_frames * cfg.hop_length

    g_fwd = (
        text_encoder_flops(synth.enc_p, B, T_x)
        + posterior_encoder_flops(synth.enc_q, B, T_y)
        + 2 * flow_flops(synth.flow, B, T_y)             # fwd + z_q reverse
        + duration_predictor_flops(synth.dp, B, T_x)
        + generator_flops(synth.dec, B, seg_frames)["total"]
        + 2 * 2.0 * B * T_y * T_x * synth.inter_channels  # m_p_e, logs_p_e
    )
    mas = 2 * 2.0 * B * T_y * T_x * synth.inter_channels  # nc2 + nc3 (no gradient)

    f = 3.0 * g_fwd + mas
    if cfg.variant == "mel":
        d_fwd = mpd_flops(disc, B, seg_T)
        f += 3.0 * (d_fwd + d_fwd)      # D step: real + fake
        f += 2.0 * d_fwd + 1.0 * d_fwd  # G step: fake (dgrad) + real (no gradient)
        f += 3.0 * mel_flops(B, seg_T, cfg.filter_length, cfg.hop_length,
                             cfg.win_length, cfg.n_mel_channels)   # mel(y_hat)
        f += mel_flops(B, seg_T, cfg.filter_length, cfg.hop_length,
                       cfg.win_length, cfg.n_mel_channels)          # mel(y) 1x
    else:
        d_fwd = mrd_flops(disc, B, seg_T, disc.resolutions)
        f += 3.0 * (d_fwd + d_fwd)
        f += 2.0 * d_fwd
        mags = sum(stft_flops(B, seg_T, *r) for r in disc.resolutions)
        f += 3.0 * mags + 1.0 * mags    # |STFT|(y_hat) differentiated, (y) not
    return f
