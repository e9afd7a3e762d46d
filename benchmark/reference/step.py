"""The GAN training step (counterpart of vits_tpu/train/step.py) of both
variants, `variant="mel"` (the MPD, train.py) and `variant="stft"` (the
MRD, train_stft.py), with the duration discriminator of the `-d` flag, in
float32 or in the configured bfloat16.

One step, as the JAX package's: the generator forward runs once under
autograd; the discriminator step runs first on `y_hat.detach()` (D loss,
backward, the D optimizer); then the generator loss is taken against the
UPDATED discriminator, backward, AdamW. The mel variant's generator loss is
mel L1 x c_mel, feature matching, LSGAN, duration x c_dur, KL x c_kl and the
z_q KL x c_kl_q. The stft variant's replaces the mel L1 and the feature
matching by (sc + mag) x c_stft, the multi-resolution STFT loss: the five
|STFT| of y_hat, at the MRD's resolutions
(`MultiWaveSTFTDiscriminator.resolutions`), are computed once, in float32,
and shared by the D step
(detached), that loss and the G pass (vits_tpu/train/step.py:152-158,
:182-199, :271-279); the real ones come from the real slice; the MRD sees
real and fake as one batch of 2B in the D step and the fake alone in the G
pass. After its RAdam update every spectral-norm u advances by one power
iteration (`sn_update`), so the D pass uses the incoming u and the G pass
the advanced one (vits_tpu/train/step.py:201-214). Its image summaries are
element 0's mels only, without the full mel. The discriminator's
parameters are frozen (`requires_grad_(False)`) while the generator loss
runs, so its gradients from that loss are never formed and cannot leak into
the next discriminator step. Gradients are not clipped; their global norms
are reported (`clip_grad_value`).

With the duration discriminator (`TrainStepConfig.use_dur_dis`), its own D
step follows the MPD's, on the detached text hidden states and predicted
log-durations against the MAS ones, at `lr_p`; the generator loss then adds
its LSGAN term against the UPDATED duration discriminator, frozen, whose
gradient reaches the generator only through the predicted log-durations.
Without it the step computes exactly what it computes without the flag's
code.

A compact batch's int16 wav is dequantized at 1/32767, the collate's scale.

Compute dtype (`TrainStepConfig.compute_dtype`, from `hps.train.bf16_run`
as the JAX package's loop sets it): the JAX step's mixed precision. The
parameters stay float32 masters; the generator forward, the D pass and G's
adversarial pass run on a copy of every float32 parameter cast to the
compute dtype (`cast_call`: weight norm's g and v, spectral norm's w_orig
and u, are cast, and the kernel is then formed in that dtype), with the
inputs x, spec and emo, the slices
and y_hat cast; y_hat comes back to float32 for the mel loss; losses,
gradients and optimizer state are float32, the gradients landing on the
masters through the casts. In float32 the casts are identities.
compute_dtype float64 runs the whole step in float64 (the models converted
by the caller, `.double()`; the step's own dtype is the wider of the compute
dtype and float32): the reference that tells float32 rounding from a fault
when two float32 steps disagree. No training setting selects it; MAS still
searches on neg_cent rounded to float32, as the kernel takes it.

Data parallelism (`make_train_step(cfg, group)`, one rank a card,
`vits_tpu_torch.parallel.dist`): the gradient is that of the JAX step's
loss on the global batch, the concatenation of the ranks' batches, as
GSPMD computes it over the `data` axis (vits_tpu/parallel/mesh.py:56-77),
not the mean of rank-local losses. Each rank's loss is its share of the
global one: a mean-type term (LSGAN, feature matching, mel L1, the STFT
log-magnitude term, the critic's terms) over W, since every rank's tensors
have the bucket's shape in a step; a masked sum over a global count (the
KL terms over sum(y_mask), the duration loss over sum(x_mask)) rescaled by
the rank's count over the all-reduced one (`dist.global_count`, no
gradient through it); the spectral convergence ||y - x|| / ||y||, a ratio
of global norms, by its first-order share around the global value (see
`_stft_share`). The alignment noise is scaled by the std over every rank's
neg_cent (`dist.global_std`). After each backward one coalesced all-reduce
sums that optimizer's gradients (D, then P, then G), before the norm and
the update, so every rank applies the same update. The metrics are the
rank's shares (the loss keys) and the global gradient norms; the loop
sums the shares at its log steps (`dist.allreduce_metrics`). With group
None the step computes exactly what it computes in one process.

Torch modules hold their parameters, so the step reads the models and their
optimizer states from `state` (`vits_tpu_torch.train.loop.init_state`) and
updates them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from benchmark.reference.core import sn_update
from benchmark.reference import dist
from benchmark.reference.seq import clip_grad_value, slice_segments, slice_segments_1d
from benchmark.reference.stft import mel_spectrogram, spec_to_mel, spectrogram
from benchmark.reference import losses as L
from benchmark.reference.optim import Optimizer

VARIANTS = ("mel", "stft")


def check_variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")


def compute_dtype_of(hps) -> torch.dtype:
    """bfloat16 where the config sets `train.bf16_run`, else float32
    (vits_tpu/train/loop.py:346)."""
    return torch.bfloat16 if getattr(hps.train, "bf16_run", False) else torch.float32


# The benchmark's lower-precision control rounds the compute copies through
# this dtype first (float8_e4m3fn); None casts straight to the compute dtype.
CAST_VIA = None


def cast_params(module: torch.nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor cast to `dtype`} for every float32 parameter and buffer
    (spectral norm's u) of `module`, as the JAX step's `cast_p` casts every
    float32 leaf. Each cast is differentiable, so gradients land on the
    float32 masters, and a frozen parameter's cast carries none. In float32
    every cast is the tensor itself."""
    tensors = list(module.named_parameters()) + list(module.named_buffers())
    if CAST_VIA is not None and dtype != torch.float32:
        return {n: _via(t, dtype) for n, t in tensors if t.dtype == torch.float32}
    return {n: t.to(dtype) for n, t in tensors if t.dtype == torch.float32}


def _via(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded through CAST_VIA to dtype, its gradient passed straight
    through to the float32 master."""
    r = t.detach().to(CAST_VIA).to(dtype)
    return t.to(dtype) + (r - t.detach().to(dtype))


def cast_call(module: torch.nn.Module, dtype: torch.dtype, *args, **kwargs):
    """module(*args, **kwargs) on `cast_params(module, dtype)`, through
    `torch.func.functional_call`."""
    return torch.func.functional_call(module, cast_params(module, dtype), args, kwargs)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    segment_frames: int
    hop_length: int
    filter_length: int
    win_length: int
    n_mel_channels: int
    sampling_rate: int
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    c_mel: float = 45.0
    c_dur: float = 2.0
    c_kl: float = 1.0
    c_kl_q: float = 0.01
    use_dur_dis: bool = False
    compute_dtype: torch.dtype = torch.float32
    variant: str = "mel"
    c_stft: float = 25.0

    def __post_init__(self):
        check_variant(self.variant)

    @classmethod
    def from_hps(cls, hps, compute_dtype: Optional[torch.dtype] = None,
                 use_dur_dis: Optional[bool] = None, variant: str = "mel"):
        """The config's step of `variant`; compute_dtype None takes it from
        `train.bf16_run` (`compute_dtype_of`), use_dur_dis None from the
        CLI's `hps.use_dur_dis` (default off)."""
        t, d = hps.train, hps.data
        if compute_dtype is None:
            compute_dtype = compute_dtype_of(hps)
        if use_dur_dis is None:
            use_dur_dis = bool(getattr(hps, "use_dur_dis", False))
        return cls(segment_frames=t.segment_size // d.hop_length,
                   hop_length=d.hop_length, filter_length=d.filter_length,
                   win_length=d.win_length, n_mel_channels=d.n_mel_channels,
                   sampling_rate=d.sampling_rate, mel_fmin=d.mel_fmin, mel_fmax=d.mel_fmax,
                   c_mel=t.c_mel, c_dur=t.c_dur, c_kl=t.c_kl, c_kl_q=t.c_kl_q,
                   use_dur_dis=use_dur_dis, compute_dtype=compute_dtype, variant=variant,
                   c_stft=getattr(t, "c_stft", 25.0))


def _stft_share(mags_real, mags_fake, group, inv_w: float):
    """The rank's shares of the multi-resolution STFT loss's (sc, mag) on the
    global batch. mag is a mean, so its share is the rank's over W. sc =
    sqrt(A / B) at each resolution, with A = ||y - x||^2 and B = ||y||^2
    summed over the ranks: the share A_r dsc/dA + B_r dsc/dB, the
    derivatives taken at the global A and B, has the global sc's gradient
    when summed over the ranks; its value is shifted to sc / W."""
    sq = torch.stack([torch.stack([torch.sum(torch.square(y - x)), torch.sum(torch.square(y))])
                      for x, y in zip(mags_real, mags_fake)])
    tot = dist.global_count(sq, group)
    a, b = tot[:, 0], tot[:, 1]
    sc = torch.sqrt(a) / torch.sqrt(b)
    lin = sq[:, 0] / (2.0 * torch.sqrt(a) * torch.sqrt(b)) - sc * sq[:, 1] / (2.0 * b)
    n = float(len(mags_real))
    sc_share = torch.sum(lin - lin.detach() + sc * inv_w) / n
    mag = sum(torch.mean(torch.abs(torch.log(x) - torch.log(y)))
              for x, y in zip(mags_real, mags_fake)) / n
    return sc_share, mag * inv_w


def make_train_step(cfg: TrainStepConfig, group=None):
    """The step `(state, batch, noise, lr_g, lr_d, align_noise, lr_p=1e-4)
    -> (state, metrics)`; `group` the data-parallel process group (None:
    one process).

    state: {"gen": Synthesizer (train=True), "disc": MultiPeriodDiscriminator
    (mel) or MultiWaveSTFTDiscriminator (stft), "gen_opt", "disc_opt": their
    optimizer states (`Optimizer.init`: AdamW, and RAdam for the stft D), "step":
    int, "rng": the dropout generator; with use_dur_dis also "dur": the
    DurationDiscriminator and "dur_opt"}. batch: {"x", "x_lengths", "spec",
    "spec_lengths", "wav", "emo", "sid"} on the models' device, x (B, T_x,
    C), spec (B, T_y, F) (optional: without it the spectrogram is computed
    from the wav, which then carries filter_length extra samples), wav
    (B, T) float, or int16 from a compact batch. noise:
    `Synthesizer.draw_noise`. Dropout runs where the modules are in
    training mode. metrics are detached tensors on the device, the JAX
    step's keys."""
    def mel_of(wav):
        return mel_spectrogram(wav, cfg.filter_length, cfg.n_mel_channels, cfg.sampling_rate,
                               cfg.hop_length, cfg.win_length, cfg.mel_fmin, cfg.mel_fmax)

    parallel = dist.world_size(group) > 1
    inv_w = 1.0 / dist.world_size(group)

    def share(x):
        """A mean-type loss (a tensor or a list of them) as the rank's share."""
        if not parallel:
            return x
        return [t * inv_w for t in x] if isinstance(x, list) else x * inv_w

    def train_step(state: Dict, batch: Dict[str, torch.Tensor],
                   noise: Dict[str, torch.Tensor], lr_g: float, lr_d: float,
                   align_noise: float, lr_p: float = 1e-4):
        synth, disc = state["gen"], state["disc"]
        cd = cfg.compute_dtype
        pd = torch.promote_types(cd, torch.float32)
        stft = cfg.variant == "stft"
        wav = batch["wav"]
        if wav.dtype == torch.int16:
            wav = wav.to(pd) * (1.0 / 32767.0)
        else:
            wav = wav.to(pd)
        if "spec" in batch:
            spec = batch["spec"].to(pd)
        else:
            frames = (wav.shape[1] - cfg.filter_length) // cfg.hop_length
            with torch.no_grad():
                spec = spectrogram(wav, cfg.filter_length, cfg.hop_length,
                                   cfg.win_length)[:, :frames]

        out = cast_call(synth, cd, batch["x"].to(cd), batch["x_lengths"], spec.to(cd),
                        batch["spec_lengths"], batch["emo"].to(cd), batch["sid"], noise,
                        align_noise=align_noise, rng=state.get("rng"), group=group)
        ids = out["ids_slice"]
        seg = cfg.segment_frames * cfg.hop_length
        y_slice = slice_segments_1d(wav, ids * cfg.hop_length, seg)[..., None]
        y_slice_c = y_slice.to(cd)
        y_hat = out["y_hat"].to(pd)

        # ---------------- D step (train.py:204-214) ----------------
        disc.requires_grad_(True)
        if stft:
            # the fake magnitudes once, in f32, shared with the loss and the G
            # pass; the real ones from the real slice (train_stft.py:195-199)
            mags_fake = [L.stft_magnitude(y_hat[..., 0], *r) for r in disc.resolutions]
            with torch.no_grad():
                mags_real = [L.stft_magnitude(y_slice[..., 0], *r) for r in disc.resolutions]
            B = y_slice.shape[0]
            both = cast_call(disc, cd, torch.cat([y_slice_c, y_hat.detach().to(cd)]),
                             [torch.cat([mr, mf.detach()]).to(cd)
                              for mr, mf in zip(mags_real, mags_fake)])
            y_d_r, y_d_g = [s[:B] for s in both], [s[B:] for s in both]
        else:
            y_d_r, y_d_g, _, _ = cast_call(disc, cd, y_slice_c, y_hat.detach().to(cd))
        loss_disc, losses_d_r, losses_d_g = map(share, L.discriminator_loss(y_d_r, y_d_g))
        state["disc_opt"].zero_grad(set_to_none=True)
        loss_disc.backward()
        dist.allreduce_grads(disc.parameters(), group)
        grad_norm_d = clip_grad_value(disc.parameters())
        Optimizer.update(state["disc_opt"], lr_d)
        sn_update(disc)  # spectral norm's one power iteration a step

        # ---------------- duration discriminator D step (train.py:205,215-220)
        if cfg.use_dur_dis:
            dur = state["dur"]
            dur.requires_grad_(True)
            p_r, p_g = cast_call(dur, cd, out["x_hidden"].detach(), out["x_mask"],
                                 out["logw_"], out["logw"].detach())
            loss_disc_p, losses_p_r, losses_p_g = map(share, L.discriminator_loss(p_r, p_g))
            state["dur_opt"].zero_grad(set_to_none=True)
            loss_disc_p.backward()
            dist.allreduce_grads(dur.parameters(), group)
            grad_norm_p = clip_grad_value(dur.parameters())
            Optimizer.update(state["dur_opt"], lr_p)

        # ---------------- G step (train.py:222-242) ----------------
        disc.requires_grad_(False)
        loss_dur = torch.sum(out["l_length"].to(pd)) * cfg.c_dur
        loss_kl = L.kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                            out["y_mask"]) * cfg.c_kl
        loss_kl_q = L.kl_loss(out["z_q"], out["logs_p"], out["m_q"], out["logs_q"],
                              out["y_mask"]) * cfg.c_kl_q
        if parallel:  # masked sums over the global counts
            n = torch.stack([torch.sum(out["x_mask"].to(pd)), torch.sum(out["y_mask"].to(pd))])
            frac = n / dist.global_count(n, group)
            loss_dur = loss_dur * frac[0]
            loss_kl, loss_kl_q = loss_kl * frac[1], loss_kl_q * frac[1]
        if stft:
            if parallel:
                sc, mag = _stft_share(mags_real, mags_fake, group, inv_w)
            else:
                sc, mag = L.multi_resolution_stft_losses(mags_real, mags_fake)
            loss_stft = (sc + mag) * cfg.c_stft
            y_d_g = cast_call(disc, cd, y_hat.to(cd), [m.to(cd) for m in mags_fake])
            loss_gen, gen_losses = map(share, L.generator_loss(y_d_g))
            loss_all = loss_gen + loss_stft + loss_dur + loss_kl + loss_kl_q
            with torch.no_grad():  # element 0's mels, for the image summaries only
                mel_1 = spec_to_mel(spec[:1], cfg.filter_length, cfg.n_mel_channels,
                                    cfg.sampling_rate, cfg.mel_fmin, cfg.mel_fmax)
                y_mel = slice_segments(mel_1, ids[:1], cfg.segment_frames)
                y_hat_mel = mel_of(y_hat[:1, :, 0])
            losses = {"loss_stft": loss_stft}
        else:
            with torch.no_grad():
                mel_full = spec_to_mel(spec, cfg.filter_length, cfg.n_mel_channels,
                                       cfg.sampling_rate, cfg.mel_fmin, cfg.mel_fmax)
                y_mel = slice_segments(mel_full, ids, cfg.segment_frames)
            y_hat_mel = mel_of(y_hat[..., 0])
            loss_mel = share(torch.mean(torch.abs(y_mel - y_hat_mel)) * cfg.c_mel)
            _, y_d_g, fmap_r, fmap_g = cast_call(disc, cd, y_slice_c, y_hat.to(cd))
            loss_fm = share(L.feature_loss(fmap_r, fmap_g))
            loss_gen, gen_losses = map(share, L.generator_loss(y_d_g))
            loss_all = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl + loss_kl_q
            losses = {"loss_mel": loss_mel, "loss_fm": loss_fm, "viz_mel_all": mel_full[0]}
        if cfg.use_dur_dis:
            dur.requires_grad_(False)
            _, p_g = cast_call(dur, cd, out["x_hidden"], out["x_mask"], out["logw_"],
                               out["logw"])
            loss_gen_p, losses_gen_p = map(share, L.generator_loss(p_g))
            loss_all = loss_all + loss_gen_p
        state["gen_opt"].zero_grad(set_to_none=True)
        loss_all.backward()
        dist.allreduce_grads(synth.parameters(), group)
        disc.requires_grad_(True)
        if cfg.use_dur_dis:
            dur.requires_grad_(True)
        grad_norm_g = clip_grad_value(synth.parameters())
        Optimizer.update(state["gen_opt"], lr_g)
        state["step"] += 1

        zero = torch.zeros((), device=wav.device, dtype=pd)
        metrics = {
            **losses, "loss_gen": loss_gen,
            "loss_dur": loss_dur, "loss_kl": loss_kl, "loss_kl_q": loss_kl_q,
            "loss_g_total": loss_all, "losses_g": torch.stack(gen_losses),
            "loss_disc": loss_disc, "grad_norm_d": grad_norm_d, "grad_norm_g": grad_norm_g,
            "loss_disc_p": zero, "grad_norm_p": zero,
            "losses_d_r": torch.stack(losses_d_r), "losses_d_g": torch.stack(losses_d_g),
            "viz_mel_org": y_mel[0], "viz_mel_gen": y_hat_mel[0],
            "viz_attn": out["attn"][0],
        }
        if cfg.use_dur_dis:
            metrics.update({
                "loss_disc_p": loss_disc_p, "grad_norm_p": grad_norm_p,
                "losses_p_r": torch.stack(losses_p_r), "losses_p_g": torch.stack(losses_p_g),
                "loss_gen_p": loss_gen_p, "losses_p": torch.stack(losses_gen_p)})
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
