"""GAN, feature-matching and KL losses, and the stft/MRD variant's
multi-resolution STFT loss (counterpart of vits_tpu/train/losses.py), all in
float32."""

from __future__ import annotations

import torch

from vits_tpu_torch.ops.stft import stft

# (fft_size, hop_size, win_size) of the five resolutions (losses.py:100)
DEFAULT_RESOLUTIONS = ((128, 32, 128), (256, 64, 256), (512, 128, 512),
                       (1024, 256, 1024), (2048, 512, 2048))


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """L1 feature matching over every discriminator fmap, x2; the real fmaps
    are detached."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LSGAN D loss. Returns (loss, r_losses, g_losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean(torch.square(1.0 - dr.float()))
        g_loss = torch.mean(torch.square(dg.float()))
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN G loss. Returns (loss, per-discriminator losses)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean(torch.square(1.0 - dg.float()))
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """Masked Gaussian KL; all (B, T, C), z_mask (B, T, 1)."""
    z_p, logs_q, m_p, logs_p, z_mask = (t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * torch.square(z_p - m_p) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)


def stft_magnitude(x, fft_size: int, hop_size: int, win_size: int) -> torch.Tensor:
    """|STFT| with center=True and the 1e-7 floor (losses.py:72):
    x (B, T) -> (B, T', F)."""
    re, im = stft(x.float(), fft_size, hop_size, win_size, center=True)
    return torch.sqrt(re * re + im * im + 1e-7)


def stft_losses_from_mags(x_mag, y_mag):
    """Spectral convergence and log-magnitude L1 of the predicted magnitudes
    y_mag against the ground truth x_mag (losses.py:79). Returns (sc, mag)."""
    sc = torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)
    mag = torch.mean(torch.abs(torch.log(x_mag) - torch.log(y_mag)))
    return sc, mag


def multi_resolution_stft_losses(xs_mag, ys_mag):
    """The sc and mag losses averaged over the resolutions, from magnitudes
    computed once and shared with the discriminator (losses.py:104)."""
    sc_loss, mag_loss = 0.0, 0.0
    for x_mag, y_mag in zip(xs_mag, ys_mag):
        sc, mag = stft_losses_from_mags(x_mag, y_mag)
        sc_loss = sc_loss + sc
        mag_loss = mag_loss + mag
    n = float(len(xs_mag))
    return sc_loss / n, mag_loss / n
