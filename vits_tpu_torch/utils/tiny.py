"""Tiny-config constructors shared by tests and the dry-run (counterpart of
vits_tpu/utils/tiny.py): the TINY stft/MRD discriminator, the TINY
`TrainStepConfig` and a fresh GAN training state, so that the dry-run and
the tests build the same tiny trainer.

The port's `TrainStepConfig` has no `resolutions` and no `mas_impl`: the
stft step reads its resolutions from the MRD
(`MultiWaveSTFTDiscriminator.resolutions`, `TINY_RESOLUTIONS` for
`tiny_mrd_disc()`), and MAS is always `ops.mas.maximum_path`.
"""

from __future__ import annotations

TINY_RESOLUTIONS = ((64, 16, 64), (32, 8, 32))


def tiny_mrd_disc():
    """Tiny MultiWaveSTFTDiscriminator matching TINY_RESOLUTIONS."""
    from vits_tpu_torch.models.mrd import MultiWaveSTFTDiscriminator
    return MultiWaveSTFTDiscriminator(
        num_dwt=2, wave_layers=4,
        fft_sizes=(64, 32), hop_sizes=(16, 8), win_sizes=(64, 32),
        stft_num_layers=(3, 3), stft_kernel_sizes=(3, 3),
        stft_conv_channels=(8, 8))


def tiny_step_config(variant="mel", **kw):
    """TrainStepConfig at the tiny scale (hop 8, 64-pt STFT)."""
    from vits_tpu_torch.train.step import TrainStepConfig
    return TrainStepConfig(
        variant=variant, segment_frames=8, hop_length=8, filter_length=64,
        win_length=64, n_mel_channels=20, sampling_rate=1600, **kw)


def init_gan_state(synth, disc, gen_opt, disc_opt, dur_disc=None, dur_opt=None,
                   seed=0, device=None):
    """Fresh {gen, disc, gen_opt, disc_opt, step, rng} training state
    (`loop.init_state` without the HParams plumbing): the models initialised
    from one `torch.Generator` seeded with `seed`, moved to `device` (`cuda`
    unless "cpu") in training mode, with their optimizer states; with
    `dur_disc` also "dur" and "dur_opt"."""
    from vits_tpu_torch.config import HParams
    from vits_tpu_torch.train.loop import init_state
    return init_state(HParams(train={"seed": seed}), synth, disc, dur_disc, gen_opt,
                      disc_opt, dur_opt, seed=seed, device=device)
