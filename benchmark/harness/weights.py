"""Seeded random weights made on the card in two large draws, and the
deployable checkpoint the program's serving engine reads.

The layers' distributions are the port's initialisers (torch's kaiming
uniform, xavier where a layer asks for it, zeros for the coupling layers'
post convs, unit LayerNorm gains, a normal speaker table), applied to the
frozen reference model's parameters. One assumption of the configuration
file shifts them: `frames_per_token` sets the duration predictor's output
bias to its log and `duration_spread` scales its kernel, so that random
weights speak at about the rate, and with about the spread of rates, of a
trained model (about 6 frames of 12 ms a token) on every seed."""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import core
from benchmark.reference.convert import params_to_jax
from benchmark.reference.synthesizer import Synthesizer, TextEncoder
from benchmark.reference.seq import gen_sin_table


def _bounds(module) -> List[Tuple[torch.Tensor, str, float]]:
    """(parameter, kind, value) of one layer: kind "u" uniform(-value, value),
    "n" standard normal, "c" the constant value."""
    out = []
    if isinstance(module, core.Dense):
        bound = (core._xavier_bound(module.in_features, module.out_features)
                 if module.init == "xavier" else core._kaiming_bound(module.in_features))
        return [(module.weight, "u", bound),
                (module.bias, "u", core._bias_bound(module.in_features))]
    if isinstance(module, core.Conv1d):
        k = module.kernel_size
        fan_in = (module.in_channels // module.groups) * k
        if module.init == "zeros":
            out.append((module.weight, "c", 0.0))
            if module.bias is not None:
                out.append((module.bias, "c", 0.0))
            return out
        bound = (core._xavier_bound(fan_in, module.out_channels * k, module.init_gain)
                 if module.init == "xavier" else core._kaiming_bound(fan_in))
        out.append((module.weight, "u", bound))
        if module.bias is not None:
            out.append((module.bias, "u", core._bias_bound(fan_in)))
        return out
    if isinstance(module, core.ConvTranspose1d):
        fan_in = module.out_channels * module.kernel_size
        return [(module.weight, "u", core._kaiming_bound(fan_in)),
                (module.bias, "u", core._bias_bound(fan_in))]
    if isinstance(module, core.Embedding):
        return [(module.weight, "n", 1.0)]
    if isinstance(module, core.LayerNorm):
        return [(module.gamma, "c", 1.0), (module.beta, "c", 0.0)]
    if isinstance(module, TextEncoder):
        return [(module.alpha, "c", 1.0)]
    return out


def build_serving_model(hps, seed: int, device, assumed: Dict) -> Synthesizer:
    """The serving synthesizer (weight norm folded, no posterior encoder) of
    the frozen reference, its weights drawn from `seed` on `device`: one
    uniform and one normal draw of a torch.Generator on the card."""
    with torch.device(device):
        model = Synthesizer.from_hps(hps)
    for m in model.modules():
        if isinstance(m, TextEncoder):
            m.pe = torch.from_numpy(gen_sin_table(m.max_pos, m.hidden_channels)).to(device)
    plan = [b for m in model.modules() for b in _bounds(m)]
    if {id(p) for p, _, _ in plan} != {id(p) for p in model.parameters()}:
        raise RuntimeError("a parameter of the serving model has no initialiser")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uni = [(p, v) for p, kind, v in plan if kind == "u"]
    n_u = sum(p.numel() for p, _ in uni)
    bounds = torch.repeat_interleave(
        torch.tensor([v for _, v in uni], device=device),
        torch.tensor([p.numel() for p, _ in uni], device=device))
    u = (torch.rand(n_u, generator=gen, device=device) * 2 - 1) * bounds
    normal = [p for p, kind, _ in plan if kind == "n"]
    z = torch.randn(sum(p.numel() for p in normal), generator=gen, device=device)
    with torch.no_grad():
        torch._foreach_copy_([p for p, _ in uni],
                             [t.view_as(p) for t, (p, _) in
                              zip(u.split([p.numel() for p, _ in uni]), uni)])
        torch._foreach_copy_(normal, [t.view_as(p) for t, p in
                                      zip(z.split([p.numel() for p in normal]), normal)])
        for p, kind, v in plan:
            if kind == "c":
                p.fill_(v)
        model.dp.proj.bias.fill_(math.log(assumed["frames_per_token"]))
        model.dp.proj.weight.mul_(assumed["duration_spread"])
    return model.eval()


def write_checkpoint(dirpath: str, model: Synthesizer, hps_dict: Dict) -> str:
    """checkpoint.npz (the JAX package's parameter tree, flattened with "//",
    as the program's checkpoint reader takes it) and config.json in
    `dirpath`. Returns the checkpoint's path."""
    import json
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(hps_dict, f)
    flat: Dict[str, np.ndarray] = {}

    def rec(node, prefix):
        for k, v in node.items():
            key = f"{prefix}//{k}" if prefix else str(k)
            if isinstance(v, dict):
                rec(v, key)
            else:
                flat[key] = np.asarray(v)

    rec({"model": params_to_jax(model.state_dict())}, "")
    flat["__step__"] = np.asarray(0)
    flat["__epoch__"] = np.asarray(1)
    path = os.path.join(dirpath, "checkpoint.npz")
    with open(path, "wb") as f:
        np.savez(f, **flat)
    return path
