"""Optimizers and the learning-rate schedule (counterpart of
vits_tpu/train/optim.py).

AdamW with optax's `scale_by_adam -> add_decayed_weights -> scale(-lr)`
semantics: p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).
`torch.optim.AdamW` computes the same update (it applies the decay as
p * (1 - lr * wd) before the Adam step; tests/test_torch_train_layers.py
holds the two against each other).

RAdam (the stft/MRD variant's discriminators) with the semantics of
`scale_by_radam_rect` (vits_tpu/train/optim.py:33-69), the decay decoupled
as the JAX `Optimizer` chains it: the rectified Adam step
sqrt(1 - b2^t) * r_t / (1 - b1^t) * m / (sqrt(v) + eps) where the length of
the approximated SMA rho_t reaches 5, else the momentum step m / (1 - b1^t).
`torch.optim.RAdam(decoupled_weight_decay=True)` computes the same update,
its rectifier r_t times sqrt(1 - b2^t) being the JAX package's; its
threshold is rho_t > 5 where the JAX package's is rho_t >= 5, and rho_t is
never exactly 5 at a step (with betas (0.8, 0.99) it is 4.9 at t = 5 and 5.9
at t = 6, so the first five updates take the momentum step).
tests/test_torch_mrd.py holds it against optax over both branches.

The learning rate is set on every update, as the JAX package threads it as
a runtime scalar.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

KINDS = ("adamw", "radam")


class Optimizer:
    """An optimizer's hyperparameters: `kind` "adamw" or "radam".
    `init(params)` makes the optimizer state; `update(state, lr)` applies
    one step with the gradients the parameters hold."""

    def __init__(self, betas: Sequence[float], eps: float, weight_decay: float,
                 kind: str = "adamw"):
        if kind not in KINDS:
            raise ValueError(f"optimizer kind {kind!r}: one of {KINDS}")
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps, self.weight_decay, self.kind = float(eps), float(weight_decay), kind

    def init(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        params = list(params)
        if self.kind == "radam":
            return torch.optim.RAdam(params, lr=0.0, betas=self.betas, eps=self.eps,
                                     weight_decay=self.weight_decay,
                                     decoupled_weight_decay=True)
        return torch.optim.AdamW(params, lr=0.0, betas=self.betas, eps=self.eps,
                                 weight_decay=self.weight_decay)

    @staticmethod
    def update(state: torch.optim.Optimizer, lr: float):
        """One step at learning rate `lr`. A parameter without a gradient
        gets a zero one first, so that its moments and decay advance like
        every other's, as the optax chain updates every leaf."""
        for group in state.param_groups:
            group["lr"] = float(lr)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        state.step()


def exponential_lr(base_lr: float, lr_decay: float, epoch: int) -> float:
    """ExponentialLR per epoch: base * decay^(epoch - 1)."""
    return base_lr * (lr_decay ** max(epoch - 1, 0))
