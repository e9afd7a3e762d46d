#!/usr/bin/env python3
"""Where a training step's time goes on the GPU, for the PyTorch/CUDA port.

    python3 scripts/profile_torch_train.py [--variant mel|stft] [--batch 16] [--bf16]
        [--out DIR]

Builds the seeded random full-width base-config training state that
chip_smoke.py trains (mel/MPD by default, stft/MRD with --variant stft; fp32,
TF32 off; with --bf16 the configured bf16 step, its parameter casts a layer
of their own), runs three warm steps on the
training bench's synthetic batch (T_x 96, 400 spec frames; the last two
timed without the profiler), then traces one step with torch.profiler. Each kernel's device time is charged to the layer
whose host-side span launched it: the text encoder, posterior encoder,
flows (the forward flow and the z_q reverse flow), MAS (the kernel K2),
duration predictor, decoder, MPD or MRD (the D step's and the G step's
passes; the MRD's spectral norm, its kernels' power iteration and the
`sn_update` after D's update, a layer of its own), the mel loss (the stft
variant: its image-summary mels) or the STFT loss (the five magnitudes and
the sc/mag losses), the D and G backward passes, the two optimizer steps, and
"other" (the glue between them: the neg_cent einsums, slices, the other
losses). Prints the step's time untraced and traced, the device busy time
and idle share, the device time per layer, the top kernels and the top host
ops by their own CPU time. With --out, writes the chrome trace there. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TAG = "layer:"


def _busy_us(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _instrument(synth, disc, variant="mel"):
    """Wrap each layer's host span in a record_function range named
    "layer:<name>"; returns the undo callables."""
    from torch.profiler import record_function
    from vits_tpu_torch.nn import core
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.train import losses
    from vits_tpu_torch.train import step as step_mod
    from vits_tpu_torch.train.optim import Optimizer

    undo = []

    def hook_module(mod, name):
        ranges = []

        def pre(_m, _a):
            r = record_function(TAG + name)
            r.__enter__()
            ranges.append(r)

        def post(_m, _a, _o):
            ranges.pop().__exit__(None, None, None)

        h1, h2 = mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)
        undo.extend([h1.remove, h2.remove])

    def wrap(owner, attr, name):
        raw, fn = owner.__dict__[attr], getattr(owner, attr)

        def wrapped(*a, **k):
            with record_function(TAG + name):
                return fn(*a, **k)
        setattr(owner, attr, staticmethod(wrapped) if isinstance(raw, staticmethod) else wrapped)
        undo.append(lambda: setattr(owner, attr, raw))

    for name in ("enc_p", "enc_q", "flow", "dp", "dec"):
        hook_module(getattr(synth, name), {"enc_p": "text encoder",
                                           "enc_q": "posterior encoder", "flow": "flows",
                                           "dp": "duration predictor",
                                           "dec": "decoder"}[name])
    mel = "mel loss" if variant == "mel" else "summary mels"
    hook_module(disc, "MPD" if variant == "mel" else "MRD")
    wrap(step_mod, "cast_params", "parameter casts")
    wrap(mas, "maximum_path", "MAS (K2)")
    wrap(step_mod, "mel_spectrogram", mel)
    wrap(step_mod, "spec_to_mel", mel)
    if variant == "stft":
        wrap(core, "sn_kernel", "spectral norm")
        wrap(step_mod, "sn_update", "spectral norm")
        wrap(losses, "stft_magnitude", "STFT loss")
        wrap(losses, "multi_resolution_stft_losses", "STFT loss")
    wrap(Optimizer, "update", "optimizer")
    backward = torch.Tensor.backward
    n_backward = [0]

    def tagged_backward(self, *a, **k):
        name = "D backward" if n_backward[0] % 2 == 0 else "G backward"
        n_backward[0] += 1
        with record_function(TAG + name):
            return backward(self, *a, **k)
    torch.Tensor.backward = tagged_backward
    undo.append(lambda: setattr(torch.Tensor, "backward", backward))
    return undo


def _by_layer(prof, kernels):
    """Device time per layer: each torch op's kernels go to the innermost
    layer range whose host span holds the op's start. K2 is launched through
    ctypes, outside any torch op, so its kernel is charged by name."""
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, e.name[len(TAG):]) for e in events
              if e.name.startswith(TAG) and e.device_type == torch.autograd.DeviceType.CPU]
    out = {"MAS (K2)": sum(e.time_range.end - e.time_range.start for e in kernels
                           if "mas_kernel" in e.name)}
    for e in events:
        ks = [k for k in (getattr(e, "kernels", None) or []) if "mas_kernel" not in k.name]
        if not ks or e.name.startswith(TAG):
            continue
        t = e.time_range.start
        inside = [(r_e - r_s, n) for r_s, r_e, n in ranges if r_s <= t <= r_e]
        name = min(inside)[1] if inside else "other"
        out[name] = out.get(name, 0.0) + sum(k.duration for k in ks)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", choices=("mel", "stft"), default="mel")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--bf16", action="store_true", help="the configured bf16 step")
    ap.add_argument("--out", default=None, help="directory for the chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.train.loop import (align_noise_at, build_models, build_optimizers,
                                           init_state)
    from vits_tpu_torch.train.step import TrainStepConfig, make_train_step

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    hps = get_hparams_from_file(default_config_path("base"))
    B, T_x, T_y = args.batch, cs.TRAIN_TX, cs.TRAIN_TY
    synth, disc, _ = build_models(hps, args.variant)
    gen_opt, disc_opt, _ = build_optimizers(hps, args.variant)
    state = init_state(hps, synth, disc, None, gen_opt, disc_opt, None, seed=cs.SEED,
                       device=dev)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    step = make_train_step(TrainStepConfig.from_hps(hps, dtype, variant=args.variant))
    batch = cs._bench_batch(hps, dev, B, T_x, T_y)
    noise_gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    lr = hps.train.learning_rate

    def run():
        noise = synth.draw_noise(B, T_x, T_y, noise_gen)
        return step(state, batch, noise, lr, lr, align_noise_at(hps, state["step"]))

    warm = []
    for _ in range(3):  # the last two time the step without the profiler
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    plain_ms = sum(warm[1:]) / 2
    undo = _instrument(synth, disc, args.variant)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        for u in undo:
            u()
    # device events that are kernels (the record_function ranges also appear
    # on the device timeline, as user annotations)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _busy_us(kernels) / 1e3
    total_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    layers = {k: v / 1e3 for k, v in _by_layer(prof, kernels).items()}
    print(f"[profile] {args.variant} {str(dtype)[6:]} training step B={B}: {plain_ms:.2f} ms "
          f"without the profiler; traced: host {ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"device idle share "
          f"{1 - busy_ms / ms:.3f} of the traced step ({1 - busy_ms / plain_ms:.3f} of the "
          f"untraced one), {len(kernels)} kernels, kernel time {total_ms:.2f} ms "
          f"({sum(layers.values()):.2f} ms charged to layers)")
    for name, v in sorted(layers.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {name:22s} {v:9.3f} ms  {100 * v / total_ms:5.1f}%")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   top {us / 1e3:9.3f} ms  {n[:100]}")
    # where the host's time goes: torch ops and CUDA runtime calls by their
    # own (self) CPU time in the traced step, which the profiler inflates
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:12]:
        print(f"[profile]   host {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d} calls  "
              f"{e.key[:80]}")
    if args.out:
        prof.export_chrome_trace(os.path.join(
            args.out, f"trace_train_step_{args.variant}_{str(dtype)[6:]}.json"))
    print(json.dumps({"profile": {"variant": args.variant, "dtype": str(dtype)[6:], "batch": B,
                                  "step_ms": plain_ms,
                                  "traced_host_ms": ms,
                                  "busy_ms": busy_ms,
                                  "kernel_ms": total_ms, "layers_ms": layers},
                      "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
