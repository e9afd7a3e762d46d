"""GAN, feature-matching and KL losses (counterpart of
vits_tpu/train/losses.py:20-65), all in float32. The STFT losses of the
stft/MRD variant are not ported yet."""

from __future__ import annotations

import torch


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
