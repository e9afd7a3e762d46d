"""Optimizers and the learning-rate schedule (counterpart of
vits_tpu/train/optim.py).

AdamW with optax's `scale_by_adam -> add_decayed_weights -> scale(-lr)`
semantics: p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).
`torch.optim.AdamW` computes the same update (it applies the decay as
p * (1 - lr * wd) before the Adam step; tests/test_torch_train_layers.py
holds the two against each other). The learning rate is set on every
update, as the JAX package threads it as a runtime scalar. RAdam (the
stft/MRD discriminator's) is not ported yet.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch


class Optimizer:
    """AdamW's hyperparameters. `init(params)` makes the optimizer state;
    `update(state, lr)` applies one step with the gradients the parameters
    hold."""

    def __init__(self, betas: Sequence[float], eps: float, weight_decay: float):
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps, self.weight_decay = float(eps), float(weight_decay)

    def init(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(params), lr=0.0, betas=self.betas, eps=self.eps,
                                 weight_decay=self.weight_decay)

    @staticmethod
    def update(state: torch.optim.AdamW, lr: float):
        """One step at learning rate `lr`. A parameter without a gradient
        gets a zero one first, so that it decays like every other, as the
        optax chain updates every leaf."""
        for group in state.param_groups:
            group["lr"] = float(lr)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        state.step()


def exponential_lr(base_lr: float, lr_decay: float, epoch: int) -> float:
    """ExponentialLR per epoch: base * decay^(epoch - 1)."""
    return base_lr * (lr_decay ** max(epoch - 1, 0))
