"""Training orchestration (counterpart of vits_tpu/train/loop.py) for both
variants, the mel/MPD one (train.py) and the stft/MRD one (train_stft.py),
with the duration discriminator of the `-d` flag: the alignment-noise
schedule, the parameter count, the models and their optimizers (AdamW; RAdam
for the stft variant's discriminators), the seeded initial state,
checkpoint resume (the JAX package's tolerant merge; `adapt` resets the
step, the epoch and the optimizers) and saving, the training summaries under
the reference's tags, eval synthesis with its mel L1, and `run`: the scp
data pipeline (bucketed static shapes,
spectrograms computed on the device, compact batches when the step runs in
bf16), per-epoch learning rates, the stop conditions, and the step in the
config's compute dtype.

The checkpoints are the JAX package's `G_*/D_*/P_*.npz` files, parameters
and optimizer state in its layout (`vits_tpu_torch.convert`), so either
package resumes from the other's.

One process on one device: `WORLD_SIZE > 1` raises (data parallelism over
DDP is ROADMAP.md A7). Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from vits_tpu_torch.convert import (optimizer_from_jax, optimizer_to_jax, params_from_jax,
                                    params_to_jax)
from vits_tpu_torch.device import resolve_device
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from vits_tpu_torch.models.mrd import MultiWaveSTFTDiscriminator
from vits_tpu_torch.models.synthesizer import DurationDiscriminator, Synthesizer
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.ops.stft import mel_spectrogram, spec_to_mel
from vits_tpu_torch.train.data import (DEFAULT_BOUNDARIES, BucketSampler, Prefetcher,
                                       TextAudioSpeakerDataset, pin_batch, place_batch)
from vits_tpu_torch.train.optim import Optimizer, exponential_lr
from vits_tpu_torch.train.step import TrainStepConfig, check_variant, make_train_step
from vits_tpu_torch.utils import checkpoint as ckpt
from vits_tpu_torch.utils import summary as S


def align_noise_at(hps, step: int) -> float:
    """The annealed MAS noise scale at a step (models.py:491-495)."""
    t = hps.train
    noise = getattr(t, "align_noise", 0.0) - getattr(t, "align_noise_decay", 0.0) * step
    return max(noise, getattr(t, "align_noise_min", 0.0))


def count_params(module: nn.Module, exclude=("enc_q", "weight_g")) -> int:
    """Elements of a module's parameters and buffers (spectral norm's u),
    leaving out any whose name has a component in `exclude`: by default the
    posterior encoder and the weight-norm gains, as the reference counts the
    generator (train.py:111-113) and the JAX loop counts both models
    (vits_tpu/train/loop.py:47)."""
    return sum(t.numel() for name, t in module.state_dict().items()
               if not set(name.split(".")) & set(exclude))


def build_models(hps, variant: str = "mel", use_dur_dis: bool = False):
    """(synth, disc, dur): the training synthesizer, the discriminator (the
    multi-period one for "mel", MultiWaveSTFTDiscriminator for "stft") and,
    with use_dur_dis, the duration discriminator (else None),
    uninitialised, on the CPU."""
    check_variant(variant)
    synth = Synthesizer.from_hps(hps, train=True)
    if variant == "mel":
        disc = MultiPeriodDiscriminator(getattr(hps.model, "use_spectral_norm", False))
    else:
        disc = MultiWaveSTFTDiscriminator()
    dur = DurationDiscriminator(hps.model.hidden_channels, 64, 5) if use_dur_dis else None
    return synth, disc, dur


def build_optimizers(hps, variant: str = "mel", use_dur_dis: bool = False):
    """(gen_opt, disc_opt, dur_opt): AdamW for G with the config's weight
    decay; for D and for P (else None) AdamW without decay in the mel
    variant (train.py:86-106), RAdam without decay in the stft one
    (train_stft.py:97-98, vits_tpu/train/loop.py:74-80)."""
    check_variant(variant)
    t = hps.train
    betas = tuple(t.betas)
    kind = "adamw" if variant == "mel" else "radam"
    return (Optimizer(betas, t.eps, t.weight_decay), Optimizer(betas, t.eps, 0.0, kind),
            Optimizer(betas, t.eps, 0.0, kind) if use_dur_dis else None)


def init_state(hps, synth, disc, dur, gen_opt, disc_opt, dur_opt, seed: Optional[int] = None,
               device=None):
    """Initialise the models from `hps.train.seed` (or `seed`) through one
    CPU `torch.Generator` (synth, disc, then dur), move them to the device
    (`cuda` unless device="cpu") in training mode, and make their optimizer
    states. `state["rng"]` is the dropout generator, on the device, seeded
    from the same seed."""
    dev = resolve_device(device)
    seed = hps.train.seed if seed is None else seed
    gen = torch.Generator().manual_seed(seed)
    state = {"step": 0, "rng": torch.Generator(device=dev).manual_seed(seed + 1)}
    for key, model, opt in (("gen", synth, gen_opt), ("disc", disc, disc_opt),
                            ("dur", dur, dur_opt)):
        if model is None:
            continue
        init_weights(model, gen)
        state[key] = model.to(dev).train()
        state[f"{key}_opt"] = opt.init(model.parameters())
    return state


def build_step(hps, compute_dtype: Optional[torch.dtype] = None, variant: str = "mel"):
    """The train step of `variant` in the config's compute dtype (bfloat16
    where `train.bf16_run` is set, as vits_tpu/train/loop.py:346 builds it),
    or in `compute_dtype`, with the duration discriminator where
    `hps.use_dur_dis` is set."""
    return make_train_step(TrainStepConfig.from_hps(hps, compute_dtype, variant=variant))


_PARTS = (("G", "gen"), ("D", "disc"), ("P", "dur"))


def _part_tree(state, key: str, with_optimizer: bool = True):
    model = state[key]
    tree = {"model": params_to_jax(model.state_dict())}
    if with_optimizer:
        tree["optimizer"] = optimizer_to_jax(state[f"{key}_opt"], model)
    return tree


def resume(hps, state, logger=None):
    """Load the latest (or `hps.ckptG` / `hps.ckptD`) G, D and, with a
    duration discriminator, P checkpoints into `state`, each merged into the
    current values (a leaf missing from the file keeps its value, logged).
    `hps.adapt` loads the models only and resets the step and the epoch.
    Returns (state, epoch)."""
    model_dir = hps.model_dir
    adapt = getattr(hps, "adapt", False)
    epoch = 1
    explicit = {"G": getattr(hps, "ckptG", None), "D": getattr(hps, "ckptD", None)}
    for prefix, key in _PARTS:
        if key not in state:
            continue
        path = explicit.get(prefix) or ckpt.latest_checkpoint_path(model_dir, f"{prefix}_*.npz")
        if not (path and os.path.exists(path)):
            continue
        loaded, step, ep = ckpt.load_checkpoint(path, _part_tree(state, key, not adapt))
        params_from_jax(loaded["model"], state[key])
        if not adapt:
            optimizer_from_jax(loaded["optimizer"], state[f"{key}_opt"], state[key])
        if prefix == "G":
            epoch = ep
            if not adapt:
                state["step"] = step
        if logger:
            logger.info("Resumed %s from %s (adapt=%s)", prefix, path, adapt)
    if adapt:
        state["step"] = 0
        epoch = 1
    return state, epoch


def save_all(hps, state, epoch: int):
    """Write G_<step>.npz, D_<step>.npz and, with a duration discriminator,
    P_<step>.npz into the run dir: {"model", "optimizer"} trees in the JAX
    package's layout."""
    step = int(state["step"])
    for prefix, key in _PARTS:
        if key in state:
            ckpt.save_checkpoint(os.path.join(hps.model_dir, f"{prefix}_{step}.npz"),
                                 _part_tree(state, key), step=step, epoch=epoch)


# Reference TensorBoard tag names (train.py:253-265) for the step metrics.
_TAG_MAP = {
    "loss_g_total": "loss/g/total", "loss_disc": "loss/d/total",
    "loss_fm": "loss/g/fm", "loss_mel": "loss/g/mel",
    "loss_stft": "loss/g/stft", "loss_dur": "loss/g/dur",
    "loss_kl": "loss/g/kl", "loss_kl_q": "loss/g/kl_q",
    "loss_disc_p": "loss/p/total", "loss_gen_p": "loss/p/gen",
}
# Per-sub-discriminator loss vectors -> indexed reference tags.
_VEC_TAG_MAP = {
    "losses_g": "loss/g", "losses_d_r": "loss/d_r", "losses_d_g": "loss/d_g",
    "losses_p": "loss/p", "losses_p_r": "loss/p_r", "losses_p_g": "loss/p_g",
}


def log_train_summaries(writer, global_step: int, m: dict, lr: float):
    """The training summaries under the reference's tags (train.py:253-276):
    scalars (the per-sub-discriminator `loss/d_r/{i}`, `loss/d_g/{i}`,
    `loss/g/{i}` among them) and the mel-slice, full-mel (the mel variant's)
    and MAS-alignment images, of whichever the metrics hold. `m` holds the
    host copies of the step's metrics (scalars, the `losses_*` vectors and
    the `viz_*` tensors). Returns (scalars, images)."""
    scalars = {"learning_rate": float(lr)}
    for k, v in m.items():
        if k.startswith("viz_") or k in _VEC_TAG_MAP or np.ndim(v) != 0:
            continue
        if k == "loss_gen":
            # the reference emits only the per-sub `loss/g/{i}` (train.py:258)
            continue
        scalars[_TAG_MAP.get(k, f"loss/{k}" if k.startswith("loss") else k)] = float(v)
    for k, base in _VEC_TAG_MAP.items():
        if k in m:
            for i, v in enumerate(np.asarray(m[k]).ravel()):
                scalars[f"{base}/{i}"] = float(v)
    images = {}
    if "viz_mel_org" in m:  # (T, C) channel-last -> (C, T) for plotting
        images["slice/mel_org"] = S.plot_spectrogram_to_numpy(
            np.asarray(m["viz_mel_org"], np.float32).T)
        images["slice/mel_gen"] = S.plot_spectrogram_to_numpy(
            np.asarray(m["viz_mel_gen"], np.float32).T)
    if "viz_mel_all" in m:
        images["all/mel"] = S.plot_spectrogram_to_numpy(
            np.asarray(m["viz_mel_all"], np.float32).T)
    if "viz_attn" in m:
        images["all/attn"] = S.plot_alignment_to_numpy(np.asarray(m["viz_attn"], np.float32))
    S.summarize(writer, global_step, scalars=scalars, images=images)
    return scalars, images


EVAL_TEXT_BUCKET = 32
EVAL_MAX_FRAMES = 1000


@torch.no_grad()
def evaluate(hps, synth, eval_dataset, writer, global_step, generator=None,
             first: bool = False):
    """Single-utterance eval synthesis (train.py:289-346) on the first eval
    item: the training model, switched to eval mode and back, synthesizes it
    through `Synthesizer.inference` (text padded to a multiple of 32, at most
    1000 frames, prior noise from `generator` scaled by data.noise_scale);
    logs the generated mel and audio and `eval/mel_l1`, the mean L1 between
    its mel and the ground truth's over their common frames, and with
    `first` the ground-truth mel and audio. Returns the mel L1, or None
    without eval data."""
    if len(eval_dataset) == 0:
        return None
    d = hps.data
    item = eval_dataset[0]
    dev = next(synth.parameters()).device
    T_x = item["vec"].shape[0]
    t_bucket = -(-T_x // EVAL_TEXT_BUCKET) * EVAL_TEXT_BUCKET
    x = torch.zeros(1, t_bucket, item["vec"].shape[1])
    x[0, :T_x] = torch.from_numpy(item["vec"])
    was_training = synth.training
    synth.eval()
    try:
        o, _, y_mask, _ = synth.inference(
            x.to(dev), torch.tensor([T_x], device=dev),
            torch.from_numpy(item["emo"])[None].to(dev),
            torch.tensor([item["sid"]], device=dev),
            noise_scale=getattr(d, "noise_scale", 1.0), max_frames=EVAL_MAX_FRAMES,
            generator=generator)
        mel_full = mel_spectrogram(o[..., 0].float(), d.filter_length, d.n_mel_channels,
                                   d.sampling_rate, d.hop_length, d.win_length,
                                   d.mel_fmin, d.mel_fmax)
    finally:
        synth.train(was_training)
    y_frames = int(y_mask[0].sum())
    wav = o[0, :y_frames * d.hop_length, 0].float().cpu().numpy()
    mel = mel_full[0, :y_frames].cpu().numpy()
    gt_mel = spec_to_mel(torch.from_numpy(item["spec"])[None], d.filter_length,
                         d.n_mel_channels, d.sampling_rate, d.mel_fmin,
                         d.mel_fmax)[0].numpy()
    n = min(mel.shape[0], gt_mel.shape[0])
    mel_l1 = float(np.mean(np.abs(mel[:n] - gt_mel[:n]))) if n else float("nan")
    images = {"gen/mel": S.plot_spectrogram_to_numpy(mel.T)}
    audios = {"gen/audio": wav}
    if first:
        images["gt/mel"] = S.plot_spectrogram_to_numpy(gt_mel.T)
        audios["gt/audio"] = np.asarray(item["wav"], np.float32)
    S.summarize(writer, global_step, scalars={"eval/mel_l1": mel_l1}, images=images,
                audios=audios, audio_sampling_rate=d.sampling_rate)
    return mel_l1


def _spec_frames(batch, hps) -> int:
    """T_y of a batch: its spec's frames, or those the step computes from a
    spec-less batch's wav (which carries filter_length extra samples)."""
    if "spec" in batch:
        return batch["spec"].shape[1]
    return (batch["wav"].shape[1] - hps.data.filter_length) // hps.data.hop_length


def run(hps, variant: str = "mel", max_steps: Optional[int] = None, device=None,
        log_cb=None):
    """Train `variant` ("mel" or "stft") from `hps` (the CLI's config:
    `hps.model_dir`, `hps.adapt`, `hps.use_dur_dis`, `hps.ckptG` /
    `hps.ckptD`) on `device` (`cuda`
    unless "cpu"), resuming from the run dir's latest checkpoints, until
    `train.epochs`, the adapt step cap, the learning-rate floor or
    `max_steps`. Logs every `train.log_interval` steps (the only steps, with
    eval steps, that read device values back), evaluates and saves every
    `train.eval_interval`, saves at the end. `log_cb(step, metrics)` sees
    each log step's scalars. Returns (state, global_step)."""
    check_variant(variant)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("WORLD_SIZE > 1: the port trains in one process on one "
                                  "device; data parallelism over DDP is ROADMAP.md A7")
    dev = resolve_device(device)
    logger = S.get_logger(hps.model_dir)
    writer = S.SummaryWriter(hps.model_dir)
    writer_eval = S.SummaryWriter(os.path.join(hps.model_dir, "eval"))
    logger.info(hps.to_dict())
    S.check_git_hash(hps.model_dir)

    t, d = hps.train, hps.data
    use_dur_dis = bool(getattr(hps, "use_dur_dis", False))
    # the step computes spectrograms from the wav on the device unless the
    # config asks for host ones; compact batches (int16 wav, bf16 vectors)
    # when the step computes in bf16
    spec_on_device = bool(getattr(t, "spec_on_device", True))
    dataset = TextAudioSpeakerDataset(d.training_files, hps, load_spec=not spec_on_device)
    eval_dataset = TextAudioSpeakerDataset(d.validation_files, hps) \
        if os.path.exists(d.validation_files) else []
    sampler = BucketSampler(dataset.lengths, t.batch_size,
                            list(getattr(t, "bucket_boundaries", DEFAULT_BOUNDARIES)))
    on_cuda = dev.type == "cuda"
    prefetcher = Prefetcher(
        dataset, sampler,
        workers=int(getattr(t, "prefetch_workers", 8)),
        depth=int(getattr(t, "prefetch_depth", 2)),
        compact=bool(getattr(t, "compact_batch", getattr(t, "bf16_run", False))),
        transform=pin_batch if on_cuda else None,
        place=functools.partial(place_batch, device=dev) if on_cuda else None,
        place_depth=int(getattr(t, "prefetch_device_depth", 2)))

    synth, disc, dur = build_models(hps, variant, use_dur_dis)
    gen_opt, disc_opt, dur_opt = build_optimizers(hps, variant, use_dur_dis)
    state = init_state(hps, synth, disc, dur, gen_opt, disc_opt, dur_opt, device=dev)
    state, epoch_start = resume(hps, state, logger)
    logger.info("Load train files = %d", len(dataset))
    logger.info("Total parameters of Generator: %d", count_params(synth))
    logger.info("Total parameters of Discriminator: %d", count_params(disc))
    step_fn = make_train_step(TrainStepConfig.from_hps(hps, use_dur_dis=use_dur_dis,
                                                       variant=variant))

    global_step = int(state["step"])
    noise_gen = torch.Generator(device=dev).manual_seed(t.seed + 17)
    t_last = time.time()
    audio_sec_acc = 0.0
    input_wait_acc = 0.0
    first_eval = True
    saved_at = None
    epoch = epoch_start
    lr = exponential_lr(t.learning_rate, t.lr_decay, epoch)
    lr_p = exponential_lr(1e-4, t.lr_decay, epoch)  # train.py:100-102,148
    batches = prefetcher.stream(epoch_start, t.epochs)
    try:
        while True:
            t_fetch = time.time()
            item = next(batches, None)
            if item is None:
                break
            batch_epoch, batch = item
            if batch_epoch != epoch:
                # epoch rollover: the end-of-epoch stops, then the lr schedules
                if (getattr(hps, "adapt", False) and global_step > t.steps) or lr <= 5e-6:
                    break
                epoch = batch_epoch
                lr = exponential_lr(t.learning_rate, t.lr_decay, epoch)
                lr_p = exponential_lr(1e-4, t.lr_decay, epoch)
            # the step runs asynchronously on the card, so time spent here
            # waiting for the pipeline is input stall
            input_wait_acc += time.time() - t_fetch
            audio_sec = float(batch.pop("wav_lengths").sum()) / d.sampling_rate
            noise = synth.draw_noise(batch["x"].shape[0], batch["x"].shape[1],
                                     _spec_frames(batch, hps), noise_gen)
            state, metrics = step_fn(state, batch, noise, lr, lr,
                                     align_noise_at(hps, global_step), lr_p)
            global_step += 1
            audio_sec_acc += audio_sec
            if global_step % t.log_interval == 0:
                mh = {k: v.float().cpu().numpy() for k, v in metrics.items()}
                m = {k: float(v) for k, v in mh.items() if np.ndim(v) == 0}
                dt = time.time() - t_last
                m["audio_sec_per_s"] = audio_sec_acc / max(dt, 1e-9)
                m["input_stall_pct"] = 100.0 * input_wait_acc / max(dt, 1e-9)
                t_last = time.time()
                audio_sec_acc = 0.0
                input_wait_acc = 0.0
                logger.info("step %d epoch %d lr %.6g | %s", global_step, epoch, lr,
                            {k: round(v, 5) for k, v in m.items()})
                log_train_summaries(writer, global_step, {**mh, **m}, lr)
                if log_cb:
                    log_cb(global_step, m)
            if global_step % t.eval_interval == 0:
                t_eval = time.time()
                mel_l1 = evaluate(hps, synth, eval_dataset, writer_eval, global_step,
                                  noise_gen, first=first_eval)
                if mel_l1 is not None:
                    logger.info("eval step %d mel_l1 %.4f wall %.2fs",
                                global_step, mel_l1, time.time() - t_eval)
                first_eval = False
                save_all(hps, state, epoch)
                saved_at = global_step
            if max_steps is not None and global_step >= max_steps:
                break
        if saved_at != global_step:
            save_all(hps, state, epoch)
    finally:
        batches.close()
        writer.close()
        writer_eval.close()
    return state, global_step
