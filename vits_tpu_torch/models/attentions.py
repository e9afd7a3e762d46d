"""Transformer encoder of the text branch (counterpart of
vits_tpu/models/attentions.py): plain scaled-dot-product attention written
out (no relative position), FFN / FFN2 / FFN3, and the post-LN Encoder.

In training mode (`module.train()`) dropout of rate p_dropout applies at the
JAX package's places (attentions.py:58, 99, 138, 179, 240, 244): the
attention probabilities, inside the FFN, and after attention and after the
FFN; its masks come from the `rng` generator. In eval mode it is off."""

from __future__ import annotations

import math

import torch
from torch import nn

from vits_tpu_torch.nn.core import Conv1d, Dense, LayerNorm, dropout


def _mask(x, m):
    return x if m is None else x * m


def _drop(module: nn.Module, x, rng):
    return dropout(x, module.p_dropout if module.training else 0.0, rng)


class MultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, n_heads: int, p_dropout: float = 0.0):
        super().__init__()
        self.channels, self.n_heads, self.p_dropout = channels, n_heads, p_dropout
        self.conv_q = Conv1d(channels, channels, 1, init="xavier")
        self.conv_k = Conv1d(channels, channels, 1, init="xavier")
        self.conv_v = Conv1d(channels, channels, 1, init="xavier")
        self.conv_o = Conv1d(channels, out_channels, 1)

    def forward(self, x, c, attn_mask=None, rng=None):
        B, T_t, ch = x.shape
        T_s, h = c.shape[1], self.n_heads
        d = ch // h
        q = self.conv_q(x).reshape(B, T_t, h, d)
        k = self.conv_k(c).reshape(B, T_s, h, d)
        v = self.conv_v(c).reshape(B, T_s, h, d)
        # f32 scores from the working-dtype q, k (exact casts), as the JAX
        # package's preferred_element_type=float32
        scores = torch.einsum("bthd,bshd->bhts", (q / math.sqrt(d)).float(), k.float())
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        probs = _drop(self, torch.softmax(scores, dim=-1), rng)
        out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v).reshape(B, T_t, ch)
        return self.conv_o(out)


class FFN(nn.Module):
    """Plain conv FFN; conv_1's input is masked, as in the JAX package."""

    def __init__(self, in_channels, out_channels, filter_channels, kernel_size,
                 gin_channels=0, p_dropout=0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size,
                             padding=kernel_size // 2)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size,
                             padding=kernel_size // 2)

    def forward(self, x, x_mask=None, g=None, rng=None):
        x = _drop(self, torch.relu(self.conv_1(_mask(x, x_mask))), rng)
        return _mask(self.conv_2(_mask(x, x_mask)), x_mask)


class FFN2(nn.Module):
    """GLU-gated FFN with speaker conditioning (the configured default)."""

    def __init__(self, in_channels, out_channels, filter_channels, kernel_size,
                 gin_channels=0, p_dropout=0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.filter_channels = filter_channels
        self.conv_1 = Conv1d(in_channels, filter_channels * 2, kernel_size,
                             padding=kernel_size // 2, init="xavier")
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size,
                             padding=kernel_size // 2, init="xavier")
        self.cond = Dense(gin_channels, filter_channels * 2, init="xavier")

    def forward(self, x, x_mask=None, g=None, rng=None):
        f = self.filter_channels
        x = _drop(self, self.conv_1(_mask(x, x_mask)), rng)
        gs = self.cond(g)
        x = torch.tanh(x[..., :f] + gs[:, None, :f]) * torch.sigmoid(x[..., f:] + gs[:, None, f:])
        return _mask(self.conv_2(_mask(x, x_mask)), x_mask)


class FFN3(nn.Module):
    """Additive-conditioning FFN."""

    def __init__(self, in_channels, out_channels, filter_channels, kernel_size,
                 gin_channels=0, p_dropout=0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size,
                             padding=kernel_size // 2, init="xavier")
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size,
                             padding=kernel_size // 2, init="xavier")
        self.cond = Dense(gin_channels, filter_channels, init="xavier")

    def forward(self, x, x_mask=None, g=None, rng=None):
        x = _drop(self, torch.relu(self.conv_1(_mask(x, x_mask))), rng)
        x = self.conv_2(_mask(x + self.cond(g)[:, None, :], x_mask))
        return _mask(x, x_mask)


_FFNS = {"FFN": FFN, "FFN2": FFN2, "FFN3": FFN3}


class Encoder(nn.Module):
    """Per layer: self-attention + post-LN, then conditioned FFN + post-LN."""

    def __init__(self, hidden_channels, filter_channels, n_heads, n_layers,
                 kernel_size=1, ffn="FFN2", gin_channels=0, p_dropout=0.0):
        super().__init__()
        self.n_layers, self.p_dropout = n_layers, p_dropout
        ffn_cls = _FFNS[ffn]
        idx = [str(i) for i in range(n_layers)]
        self.attn_layers = nn.ModuleDict(
            {i: MultiHeadAttention(hidden_channels, hidden_channels, n_heads, p_dropout)
             for i in idx})
        self.norm_layers_1 = nn.ModuleDict({i: LayerNorm(hidden_channels) for i in idx})
        self.ffn_layers = nn.ModuleDict(
            {i: ffn_cls(hidden_channels, hidden_channels, filter_channels, kernel_size,
                        gin_channels=gin_channels, p_dropout=p_dropout) for i in idx})
        self.norm_layers_2 = nn.ModuleDict({i: LayerNorm(hidden_channels) for i in idx})

    def forward(self, x, x_mask=None, g=None, rng=None):
        """x: (B, T, C); x_mask: (B, T, 1) or None; g: (B, gin); rng: the
        dropout generator (training mode)."""
        attn_mask = None
        if x_mask is not None:
            m = x_mask[..., 0]
            attn_mask = m[:, None, :, None] * m[:, None, None, :]  # (B, 1, T, T)
            x = x * x_mask
        for i in range(self.n_layers):
            si = str(i)
            y = _drop(self, self.attn_layers[si](x, x, attn_mask, rng=rng), rng)
            x = self.norm_layers_1[si](x + y)
            y = _drop(self, self.ffn_layers[si](x, x_mask, g=g, rng=rng), rng)
            x = self.norm_layers_2[si](x + y)
        return _mask(x, x_mask)
