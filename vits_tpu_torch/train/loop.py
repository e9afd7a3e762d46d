"""Building the training state (counterpart of vits_tpu/train/loop.py:41-93)
for the mel/MPD variant without the duration discriminator: the
alignment-noise schedule, the parameter count, the models, their optimizers,
the seeded initial state and the step in the config's compute dtype. The loop over a data set (`run`, with the
data pipeline and checkpoints) is not ported yet: the repository holds no
corpus to drive it.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vits_tpu_torch.device import resolve_device
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from vits_tpu_torch.models.synthesizer import Synthesizer
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.train.optim import Optimizer
from vits_tpu_torch.train.step import TrainStepConfig, make_train_step


def align_noise_at(hps, step: int) -> float:
    """The annealed MAS noise scale at a step (models.py:491-495)."""
    t = hps.train
    noise = getattr(t, "align_noise", 0.0) - getattr(t, "align_noise_decay", 0.0) * step
    return max(noise, getattr(t, "align_noise_min", 0.0))


def count_params(module: nn.Module, exclude=("enc_q", "weight_g")) -> int:
    """Parameters of a module, leaving out any whose name has a component in
    `exclude` (by default the posterior encoder and the weight-norm gains, as
    the reference counts the generator, train.py:111-113)."""
    return sum(p.numel() for name, p in module.named_parameters()
               if not set(name.split(".")) & set(exclude))


def build_models(hps):
    """(synth, disc): the training synthesizer and the multi-period
    discriminator, uninitialised, on the CPU."""
    synth = Synthesizer.from_hps(hps, train=True)
    disc = MultiPeriodDiscriminator(getattr(hps.model, "use_spectral_norm", False))
    return synth, disc


def build_optimizers(hps):
    """(gen_opt, disc_opt): AdamW for G with the config's weight decay, AdamW
    without decay for D (train.py:86-106)."""
    t = hps.train
    return (Optimizer(tuple(t.betas), t.eps, t.weight_decay),
            Optimizer(tuple(t.betas), t.eps, 0.0))


def init_state(hps, synth, disc, gen_opt, disc_opt, seed: Optional[int] = None,
               device=None):
    """Initialise the models from `hps.train.seed` (or `seed`) through a CPU
    `torch.Generator`, move them to the device (`cuda` unless device="cpu")
    in training mode, and make their optimizer states. `state["rng"]` is the
    dropout generator, on the device, seeded from the same seed."""
    dev = resolve_device(device)
    seed = hps.train.seed if seed is None else seed
    gen = torch.Generator().manual_seed(seed)
    init_weights(synth, gen)
    init_weights(disc, gen)
    synth.to(dev).train()
    disc.to(dev).train()
    return {"gen": synth, "disc": disc,
            "gen_opt": gen_opt.init(synth.parameters()),
            "disc_opt": disc_opt.init(disc.parameters()),
            "step": 0, "rng": torch.Generator(device=dev).manual_seed(seed + 1)}


def build_step(hps, compute_dtype: Optional[torch.dtype] = None):
    """The mel/MPD train step in the config's compute dtype (bfloat16 where
    `train.bf16_run` is set, as vits_tpu/train/loop.py:346 builds it), or in
    `compute_dtype`."""
    return make_train_step(TrainStepConfig.from_hps(hps, compute_dtype))
