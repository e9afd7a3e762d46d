#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vits_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):
  1. build    - compile every CUDA kernel of the port from csrc/ with nvcc
                (sm_90a), one nvcc per source, all started together; print
                the build seconds and ptxas' resource report;
  2. kernels  - hold K1, the int8 ResBlock2-chain kernel, against its plain
                PyTorch version at the 12 base-config chain shapes (C =
                256/128/64/32 x k = 3/7/11, dilations 1/3/5, B = 1, 256
                frames, ragged valid length; each with its plan's form, T
                and launches, kernel ms - device time, from a CUDA graph
                of 20 calls - against the bound) and at a B = 4
                ragged case (C = 64, k = 7), and K2, MAS, against its plain
                version, bit-exact, at (16, 400, 96) with the training
                bench's lengths, (32, 1000, 384) (the base config's longest
                utterance and text), (1, 1000, 1), a t_x == t_y case and
                (2, 2000, 384), all in the warp form, and (2, 1200, 1100)
                in the block form; print each case's form, kernel ms
                (device time, from a CUDA graph of 20 calls), plain ms,
                bound ms and errors;
  3. serving  - write a seeded random base-config checkpoint at full width,
                serve it with EmoVITS(device="cuda", quantize=True): 8
                calibration requests (float decodes), then int8 requests
                whose every ResBlock2 chain must go through the kernel
                (launch counts checked against the chains' plans), each
                compared with the float decode of the same request; one
                request's float decode is also held against the CPU;
  4. training - the base config's mel/MPD GAN step at full width (seeded
                random weights with weight norm, AdamW from
                build_optimizers), on the training bench's synthetic batch
                (B 16, T_x 96, 400 spec frames, spec shipped): 1 warm-up and
                5 timed steps, each launching K2 exactly once, with finite
                losses and moved parameters; print step ms, audio-s/s and
                peak memory; then one step on the card against the same step
                on the CPU (B = 2, same weights and noise, dropout off): the
                losses agree and the MAS paths are equal;
  5. card     - print the card's name and power limit.
The line before the card line is one JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}. Needs CUDA; with no GPU it
exits 2 and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
INT8_PEAK = 1979e12   # H100 SXM dense int8 ops/s (NVIDIA data sheet)
HBM_BW = 3.35e12      # H100 SXM HBM3 bytes/s
SEED = 1234
TRAIN_B, TRAIN_TX, TRAIN_TY = 16, 96, 400  # bench_train.py's batch
TRAIN_STEPS = 5                            # timed, after 1 warm-up step
# card vs CPU on one training step (B = 2): fp32 on both, TF32 off, but
# cuDNN and the CPU's convolutions sum in other orders through ~60 layers
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-5
CHAIN_FRAMES = 256    # T_y of the kernel check: M = 256 * (8, 48, 96, 192)
N_CALIB = 8
N_INT8 = 4
# each int8 request's waveform against the float decode of the same request:
# the JAX package's bench guard (bench.py); the gate's stricter 0.995 applies
# to the freezing request, whose activations the scales were calibrated on
MIN_REQUEST_CORR = 0.98


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one fn() call: `iters` calls captured in a CUDA graph,
    the graph replayed and timed with CUDA events, so the host's launch cost
    (Python, ctypes) is not in the number. fn runs once first, outside."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def phase_build():
    from vits_tpu_torch.utils import cuda_build
    sources = sorted(f for f in os.listdir(cuda_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    secs = time.perf_counter() - t0
    for s in sources:
        for line in cuda_build.build_log.get(s, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {s}: {line.strip()}")
    log(f"[build] {len(sources)} source(s) built in {secs:.1f} s: {', '.join(sources)}")
    return sources


def k1_case(dev, gen, C, k, dil, gin, lens, M):
    """A seeded random ResBlock2 at (C, k, dil), calibrated on its own input
    and quantized: (qp, x (B, M, C) masked past each length, gs, valid)."""
    from vits_tpu_torch.models.modules import ResBlock2
    from vits_tpu_torch.nn.core import init_weights
    rb = init_weights(ResBlock2(C, k, tuple(dil), gin), gen).to(dev).eval()
    B = len(lens)
    valid = torch.tensor(lens, dtype=torch.int32, device=dev)
    x = torch.randn(B, M, C, generator=gen).to(dev)
    mask = (torch.arange(M, device=dev)[None, :] < valid[:, None]).float()[..., None]
    x = x * mask
    g = torch.randn(B, gin, generator=gen).to(dev)
    with torch.no_grad():
        rec = {}
        rb(x, g, x_mask=mask, record=rec)
        qp = rb.quantize_params(rec)
        gs = torch.stack([rb.conds[str(i)](g) for i in range(len(dil))], 1).float()
    return qp, x, gs, valid


def k1_shapes():
    """The 12 base-config chain shapes of a CHAIN_FRAMES-frame request, with
    a ragged valid length (not a multiple of the stage's upsampling):
    (C, k, dilations, M, valid)."""
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    m = get_hparams_from_file(default_config_path("base")).model
    out, up = [], 1
    for s, u in enumerate(m.upsample_rates):
        up *= u
        C = m.upsample_initial_channel // 2 ** (s + 1)
        M = CHAIN_FRAMES * up
        for k, dil in zip(m.resblock_kernel_sizes, m.resblock_dilation_sizes):
            out.append((C, k, tuple(dil), M, M - 37 * up // 8 - 1))
    return out, m.gin_channels


def phase_kernels(dev):
    """K1 against its plain version at the 12 base-config chain shapes, and
    at one B = 4 ragged case (C = 64, k = 7) that runs the batch dimension of
    the whole-chain tiling."""
    from vits_tpu_torch.nn import rb_chain

    shapes, gin = k1_shapes()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst = [], 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_s": 0.0, "bytes_s": 0.0}
    gen = torch.Generator().manual_seed(SEED)
    M4 = CHAIN_FRAMES * 48
    cases = [(C, k, dil, M, [v]) for C, k, dil, M, v in shapes] + \
        [(64, 7, (1, 3, 5), M4, [M4 - 1, M4 - 3001, M4 // 2 + 17, 901])]
    for n_case, (C, k, dil, M, lens) in enumerate(cases):
        B = len(lens)
        qp, x, gs, valid = k1_case(dev, gen, C, k, dil, gin, lens, M)
        out = rb_chain.chain_q8_cuda(qp, x, gs, valid)
        ref = rb_chain.chain_q8_plain(qp, x, gs, valid)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"K1 B={B} C={C} k={k}: non-finite output")
        diff = (out - ref).abs()
        scale = max(1.0, float(ref.abs().max()))
        err = float(diff.max())
        off = float((diff > 1e-3 * float(ref.abs().max())).float().mean())
        ok = err <= 0.05 * scale and off < 0.01
        worst = max(worst, err)
        p = rb_chain.plan(B, M, C, k, dil, n_sm)
        check = (f"max_abs_err {err:.3e} (tol {0.05 * scale:.3e})  off>1e-3*max "
                 f"{100 * off:.3f}%  {'OK' if ok else 'FAIL'}")
        if n_case >= len(shapes):  # the batch case: checked, not part of a request
            log(f"[kernels] rb2_chain_q8 B={B} C={C:3d} k={k:2d} M={M:5d} valid={lens}: "
                f"{p.form} T={p.T} launches {p.launches}: {check}")
            rows.append(dict(B=B, C=C, k=k, M=M, ok=ok, batch_case=True))
            continue
        ms = graph_ms(lambda: rb_chain.chain_q8_cuda(qp, x, gs, valid))
        call_ms = cuda_ms(lambda: rb_chain.chain_q8_cuda(qp, x, gs, valid), iters=20)
        plain_ms = cuda_ms(lambda: rb_chain.chain_q8_plain(qp, x, gs, valid), iters=3, warmup=1)
        ops, nbytes = rb_chain.chain_ops_bytes(B, M, C, k, len(dil))
        bound = max(ops / INT8_PEAK, nbytes / HBM_BW) * 1e3
        by = "ops" if ops / INT8_PEAK > nbytes / HBM_BW else "bytes"
        log(f"[kernels] rb2_chain_q8 B={B} C={C:3d} k={k:2d} M={M:5d} valid={lens[0]}: "
            f"{p.form} T={p.T} launches {p.launches}: kernel {ms:.4f} ms (per eager call "
            f"{call_ms:.4f} ms)  plain "
            f"{plain_ms:.4f} ms  bound {bound:.4f} ms ({by}; {100 * bound / ms:.1f}% of it)  "
            f"{check}")
        rows.append(dict(C=C, k=k, M=M, form=p.form, T=p.T, launches=p.launches, ms=ms,
                         call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         max_abs_err=err, frac_off=off, ok=ok))
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        tot["ops_s"] += ops / INT8_PEAK
        tot["bytes_s"] += nbytes / HBM_BW
        del x, qp, out, ref
    bad = [r for r in rows if not r["ok"]]
    rows = [r for r in rows if not r.get("batch_case")]
    if bad:
        raise RuntimeError(f"K1 disagrees with its plain version at {len(bad)} shape(s): {bad}")
    log(f"[kernels] rb2_chain_q8: all {len(rows)} shapes and the B = 4 case agree; the "
        f"12 chains of a {CHAIN_FRAMES}-frame request: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
        f"({100 * tot['bound_ms'] / tot['ms']:.1f}% of it), "
        f"{sum(r['launches'] for r in rows)} launches")
    return rows, worst, tot


def _mas_case(gen, dev, B, T_y, T_x, t_ys, t_xs):
    from vits_tpu_torch.ops.seq import sequence_mask
    t_ys = torch.tensor(t_ys, dtype=torch.int32)
    t_xs = torch.tensor(t_xs, dtype=torch.int32)
    mask = (sequence_mask(t_ys, T_y)[:, :, None] & sequence_mask(t_xs, T_x)[:, None, :]).float()
    neg = torch.randn(B, T_y, T_x, generator=gen) * 10 * mask  # maximum_path's neg_cent * mask
    return neg.to(dev), t_ys.to(dev), t_xs.to(dev)


def mas_cases():
    """K2's shapes: (name, B, T_y, T_x, t_ys, t_xs). The first is the training
    step's; the last runs the block form (T_x > 1024)."""
    return [
        ("train bench", 16, 400, 96, [400 - 13 * (i % 4) for i in range(16)],
         [96 - i % 7 for i in range(16)]),
        ("longest", 32, 1000, 384, [1000] * 32, [384] * 32),
        ("one token", 1, 1000, 1, [1000], [1]),
        ("t_x == t_y", 4, 200, 200, [200, 150, 77, 1], [200, 150, 77, 1]),
        ("long utterance", 2, 2000, 384, [2000, 1873], [384, 301]),
        ("wide text", 2, 1200, 1100, [1200, 1187], [1100, 1093]),
    ]


def phase_mas(dev):
    """K2 against its plain version, bit-exact, at the listed shapes, each
    in the form its plan picks."""
    from vits_tpu_torch.ops import mas
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for name, B, T_y, T_x, t_ys, t_xs in mas_cases():
        neg, ty, tx = _mas_case(gen, dev, B, T_y, T_x, t_ys, t_xs)
        p = mas.plan(B, T_y, T_x)
        out = mas.maximum_path_cuda(neg, ty, tx)
        ref = mas.maximum_path_plain(neg, ty, tx)
        torch.cuda.synchronize()
        equal = torch.equal(out, ref) and torch.equal(out.sum(dim=(1, 2)), ty.float())
        err = float((out - ref).abs().max())
        ms = graph_ms(lambda: mas.maximum_path_cuda(neg, ty, tx))
        call_ms = cuda_ms(lambda: mas.maximum_path_cuda(neg, ty, tx), iters=20)
        plain_ms = cuda_ms(lambda: mas.maximum_path_plain(neg, ty, tx), iters=1, warmup=1)
        bound = mas.mas_bytes(ty, tx, T_y, T_x) / HBM_BW * 1e3
        log(f"[kernels] mas ({B}, {T_y}, {T_x}) {name}: form {p.form} R={p.R} D={p.D} "
            f"smem {p.smem}: kernel {ms:.4f} ms (per eager call {call_ms:.4f} ms)  plain "
            f"{plain_ms:.4f} ms  bound {bound:.3e} ms (bytes; {100 * bound / ms:.1f}% of it)  "
            f"max_abs_err {err:.1e} (bit-exact required)  {'OK' if equal else 'FAIL'}")
        rows.append(dict(name=name, shape=(B, T_y, T_x), form=p.form, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, bound_ms=bound, max_abs_err=err, ok=equal))
        del neg, out, ref
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"K2 differs from its plain version at {len(bad)} shape(s): {bad}")
    return rows


def _bench_batch(hps, dev, B, T_x, T_y):
    """bench_train.py's synthetic batch (numpy seed 0), spec shipped."""
    rng = np.random.RandomState(0)
    F = hps.data.filter_length // 2 + 1
    hop = hps.data.hop_length
    b = {
        "x": rng.randn(B, T_x, hps.data.text_channels).astype(np.float32),
        "x_lengths": np.array([T_x - (i % 7) for i in range(B)], np.int32),
        "spec": np.abs(rng.randn(B, T_y, F)).astype(np.float32),
        "spec_lengths": np.array([T_y - 13 * (i % 4) for i in range(B)], np.int32),
        "wav": rng.uniform(-0.5, 0.5, (B, T_y * hop)).astype(np.float32),
        "emo": rng.randn(B, 1024).astype(np.float32),
        "sid": rng.randint(0, hps.data.n_speakers, B).astype(np.int64),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _finite(metrics) -> bool:
    return bool(torch.stack([v.float() for v in metrics.values() if v.ndim == 0])
                .isfinite().all())


def phase_training(dev):
    """The mel/MPD step at full base width; K2 launches once per step."""
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.train.loop import (align_noise_at, build_models, build_optimizers,
                                           count_params, init_state)
    from vits_tpu_torch.train.step import TrainStepConfig, make_train_step

    hps = get_hparams_from_file(default_config_path("base"))
    B, T_x, T_y = TRAIN_B, TRAIN_TX, TRAIN_TY
    t0 = time.perf_counter()
    synth, disc = build_models(hps)
    gen_opt, disc_opt = build_optimizers(hps)
    state = init_state(hps, synth, disc, gen_opt, disc_opt, seed=SEED, device=dev)
    m = hps.model
    log(f"[training] base config at full width (gin {m.gin_channels}, "
        f"{hps.data.n_speakers} speakers, posterior {m.n_layers_q} layers, decoder "
        f"{m.upsample_initial_channel}->{m.upsample_initial_channel // 16} channels, MPD "
        f"periods 2/3/5/7/11): G {count_params(synth)} parameters (+ enc_q and weight-norm "
        f"gains: {count_params(synth, exclude=())}), D {count_params(disc, exclude=())}; "
        f"built and initialised in {time.perf_counter() - t0:.1f} s")
    step = make_train_step(TrainStepConfig.from_hps(hps))
    batch = _bench_batch(hps, dev, B, T_x, T_y)
    hop, sr = hps.data.hop_length, hps.data.sampling_rate
    audio_s = float(batch["spec_lengths"].sum()) * hop / sr
    noise_gen = torch.Generator(device=dev).manual_seed(SEED)
    lr = hps.train.learning_rate
    times = []
    mas.counter.launches = 0                 # main path starts here
    for i in range(1 + TRAIN_STEPS):
        noise = synth.draw_noise(B, T_x, T_y, noise_gen)
        params = {k: [p.detach().clone() for p in mod.parameters()]
                  for k, mod in (("G", synth), ("D", disc))}
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        before = mas.counter.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, noise, lr, lr, align_noise_at(hps, state["step"]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = mas.counter.launches - before
        moved = {k: any(not torch.equal(a, p) for a, p in zip(params[k], mod.parameters()))
                 for k, mod in (("G", synth), ("D", disc))}
        if launched != 1:
            raise RuntimeError(f"training step {i}: K2 launched {launched} times, expected 1")
        if not _finite(metrics):
            raise RuntimeError(f"training step {i}: non-finite losses "
                               f"{ {k: float(v) for k, v in metrics.items() if v.ndim == 0} }")
        if not all(moved.values()):
            raise RuntimeError(f"training step {i}: parameters did not change: {moved}")
        if i:
            times.append(ms)
        log(f"[training] step {i} {'warm-up' if i == 0 else 'timed  '}: {ms:.1f} ms, K2 "
            f"launches {launched}, loss_g_total {float(metrics['loss_g_total']):.4f}, "
            f"loss_disc {float(metrics['loss_disc']):.4f}, loss_mel "
            f"{float(metrics['loss_mel']):.4f}, grad_norm_g {float(metrics['grad_norm_g']):.4f}")
        del params
    main_launches = mas.counter.launches     # main path ends here
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = float(np.median(times))
    log(f"[training] {TRAIN_STEPS} timed steps: median {med:.1f} ms (min {min(times):.1f}, "
        f"max {max(times):.1f}), {audio_s / (med / 1e3):.1f} audio-s/s "
        f"({audio_s:.2f} audio s per step), peak memory {peak:.2f} GiB; K2 launches on "
        f"the main path {main_launches} in {1 + TRAIN_STEPS} steps")

    # one step on the card against the same step on the CPU: B = 2, the same
    # weights and noise, dropout off (eval mode) so both run one function
    small = {k: v[:2] for k, v in batch.items()}
    noise = {k: v[:2] for k, v in synth.draw_noise(B, T_x, T_y, noise_gen).items()}
    runs = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        g_m = copy.deepcopy(synth).to(d).eval()
        d_m = copy.deepcopy(disc).to(d).eval()
        b = {k: v.to(d) for k, v in small.items()}
        nz = {k: v.to(d) for k, v in noise.items()}
        with torch.no_grad():
            attn = g_m(b["x"], b["x_lengths"], b["spec"], b["spec_lengths"], b["emo"],
                       b["sid"], nz, align_noise=0.01)["attn"].cpu()
        st = {"gen": g_m, "disc": d_m, "gen_opt": gen_opt.init(g_m.parameters()),
              "disc_opt": disc_opt.init(d_m.parameters()), "step": 0, "rng": None}
        t0 = time.perf_counter()
        _, mt = step(st, b, nz, lr, lr, 0.01)
        runs[where] = (attn, {k: v.cpu() for k, v in mt.items()}, time.perf_counter() - t0)
        del g_m, d_m, st
    (a_gpu, m_gpu, _), (a_cpu, m_cpu, cpu_s) = runs["cuda"], runs["cpu"]
    worst = {}
    for k in ("loss_disc", "loss_gen", "loss_fm", "loss_mel", "loss_dur", "loss_kl",
              "loss_kl_q", "loss_g_total", "grad_norm_d", "grad_norm_g"):
        a, c = float(m_gpu[k]), float(m_cpu[k])
        worst[k] = abs(a - c) / max(abs(c), LOSS_ATOL / LOSS_RTOL)
        if abs(a - c) > LOSS_ATOL + LOSS_RTOL * abs(c):
            raise RuntimeError(f"card vs CPU step: {k} {a} vs {c}")
    if not torch.equal(a_gpu, a_cpu):
        raise RuntimeError("card vs CPU step: the MAS paths differ "
                           f"({int((a_gpu != a_cpu).sum())} cells)")
    log(f"[training] card vs CPU, one step at B = 2 (CPU {cpu_s:.1f} s): MAS paths equal "
        f"({int(a_gpu.sum())} cells on the path); largest relative loss difference "
        f"{max(worst.values()):.2e} ({max(worst, key=worst.get)}; tol {LOSS_RTOL:.0e})")
    return main_launches, med, audio_s, peak


def _write_checkpoint(dirpath, hps_dict, dev_gen_seed):
    from vits_tpu_torch.config import HParams
    from vits_tpu_torch.convert import params_to_jax
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.nn.core import init_weights
    from vits_tpu_torch.utils.checkpoint import write_checkpoint

    synth = Synthesizer.from_hps(HParams(**hps_dict))
    init_weights(synth, torch.Generator().manual_seed(dev_gen_seed))
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(hps_dict, f)
    path = os.path.join(dirpath, "checkpoint.npz")
    write_checkpoint(path, {"model": params_to_jax(synth.state_dict())})
    return path


def _requests(model, n, rng, dev):
    """n (spkid, text, emo, duration_rate) with 64-300 tokens, the rate chosen
    so each request decodes a frame count spread over 256-2048: frames =
    sum(ceil(w * rate)) lies in [target, target + tokens]."""
    out = []
    targets = np.linspace(300, 1700, n).astype(int)
    rng.shuffle(targets)
    for target in targets:
        n_tok = int(rng.randint(64, 301))
        text = rng.randn(n_tok, model.text_channels).astype(np.float32)
        emo = rng.randn(1024).astype(np.float32)
        spk = int(rng.randint(0, model.num_speaker))
        with torch.inference_mode():
            _, _, logw, _ = model.synth.infer_p1(
                torch.from_numpy(text[None]).to(dev), torch.from_numpy(emo[None]).to(dev),
                torch.tensor([spk], device=dev))
        base = float(torch.exp(logw).sum())
        rate = target / base
        out.append((spk, text, emo, rate))
    return out


def k1_launches_per_decode(m, frames: int, dev) -> int:
    """K1 launches one int8 decode of `frames` frames makes: the sum of the
    plans of the decoder's chains (a plan's launches depend on C, k and the
    dilations, not on the frame count)."""
    from vits_tpu_torch.nn import rb_chain
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    total, up = 0, 1
    for s, u in enumerate(m.upsample_rates):
        up *= u
        C = m.upsample_initial_channel // 2 ** (s + 1)
        for k, dil in zip(m.resblock_kernel_sizes, m.resblock_dilation_sizes):
            total += rb_chain.plan(1, frames * up, C, k, tuple(dil), n_sm).launches
    return total


def phase_serving(dev):
    from vits_tpu_torch.config import default_config_path
    from vits_tpu_torch.infer import EmoVITS
    from vits_tpu_torch.nn import rb_chain

    with open(default_config_path("base")) as f:
        hps_dict = json.load(f)
    rng = np.random.RandomState(SEED)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt = _write_checkpoint(d, hps_dict, SEED)
        model = EmoVITS(ckpt, device=str(dev), quantize=True)
        log(f"[serving] base config at full width (gin {hps_dict['model']['gin_channels']}, "
            f"{hps_dict['data']['n_speakers']} speakers, text {hps_dict['data']['text_channels']}); "
            f"checkpoint written and loaded in {time.perf_counter() - t0:.1f} s")
    if model.q8_calib_requests != N_CALIB:
        raise RuntimeError(f"expected {N_CALIB} calibration requests, "
                           f"VITS_TPU_Q8_CALIB_REQUESTS gives {model.q8_calib_requests}")
    reqs = _requests(model, N_CALIB + N_INT8, rng, dev)
    hop, sr = model.hop_size, model.sampling_rate
    lat = {"calib": [], "int8": []}
    audio_s = {"calib": 0.0, "int8": 0.0}
    rb_chain.counter.launches = 0           # main path starts here
    per_request = []
    for i, (spk, text, emo, rate) in enumerate(reqs):
        before = rb_chain.counter.launches
        np.random.seed(SEED + i)
        t0 = time.perf_counter()
        wav, _ = model.infer(spk, text, emo, duration_rate=rate)
        ms = (time.perf_counter() - t0) * 1e3
        launched = rb_chain.counter.launches - before
        frames = len(wav) // hop
        if len(wav) % hop or not 256 <= frames <= 2048:
            raise RuntimeError(f"request {i}: {len(wav)} samples is not 256-2048 frames of {hop}")
        if not np.all(np.isfinite(wav)) or np.abs(wav).max() > 1.0:
            raise RuntimeError(f"request {i}: waveform not finite or outside [-1, 1]")
        # requests 0..N_CALIB-2 run a calibration decode and the served float
        # decode; request N_CALIB-1 also freezes the scales and runs the gate's
        # float and int8 decodes, then decodes in int8; later ones are int8
        kind = "int8" if i >= N_CALIB else "calib" if i < N_CALIB - 1 else "freeze"
        if i == N_CALIB - 1 and model.dec_q8 is None:
            raise RuntimeError(f"the int8 decoder failed its correlation gate "
                               f"(corr {model.q8_corr}); K1 would never run")
        per_request.append((i, kind, frames, launched, ms, len(wav) / sr, wav))
        if kind != "freeze":
            lat[kind].append(ms)
            audio_s[kind] += len(wav) / sr
    main_launches = rb_chain.counter.launches  # main path ends here
    log(f"[serving] int8 gate passed at request {N_CALIB}: corr {model.q8_corr:.6f} "
        f"(>= {model.q8_min_corr})")

    # per-request check against the float decode of the same request
    dec_q8 = model.dec_q8
    for (i, kind, frames, launched, ms, secs, wav_q), (spk, text, emo, rate) in \
            zip(per_request, reqs):
        corr = float("nan")
        want = k1_launches_per_decode(model.hps.model, frames, dev)
        if kind == "freeze" and launched != 2 * want:
            raise RuntimeError(f"request {i}: K1 launched {launched} times, expected "
                               f"{2 * want} (the gate's int8 decode and the request's)")
        if kind == "int8":
            if launched != want:
                raise RuntimeError(f"request {i}: K1 launched {launched} times, expected "
                                   f"{want} (the plans of the decoder's chains)")
            model.dec_q8 = None
            model.quantize = False
            np.random.seed(SEED + i)
            wav_f, _ = model.infer(spk, text, emo, duration_rate=rate)
            model.dec_q8, model.quantize = dec_q8, True
            corr = float(np.corrcoef(wav_q, wav_f)[0, 1])
            if not corr > MIN_REQUEST_CORR:
                raise RuntimeError(f"request {i}: int8 vs float corr {corr:.6f}")
        log(f"[serving] request {i:2d} {kind:6s}: {len(text):3d} tokens, {frames:4d} frames, "
            f"{secs:.3f} audio s, latency {ms:.2f} ms, K1 launches {launched}, "
            f"int8-vs-float corr {corr:.6f}")
    for kind in ("calib", "int8"):
        v = np.array(lat[kind])
        log(f"[serving] {kind}: {len(v)} requests, latency mean {v.mean():.2f} ms "
            f"median {np.median(v):.2f} ms, {audio_s[kind] / (v.sum() / 1e3):.1f} audio-s/s")

    # the float decode on the card against the same model on the CPU
    spk, text, emo, rate = reqs[0]
    with torch.inference_mode():
        x = torch.from_numpy(text[None, :64])
        args = (x, torch.from_numpy(emo[None]), torch.tensor([spk]))
        cpu = copy.deepcopy(model.synth).cpu()
        m_p, s_p, logw, g = cpu.infer_p1(*args)
        from vits_tpu_torch.ops.seq import infer_path
        w = torch.ceil(torch.exp(logw[..., 0]) * rate).clamp(max=4.0)
        attn = infer_path(w, max(int(w.sum()), 1))
        noise = torch.from_numpy(
            np.random.RandomState(SEED).randn(1, attn.shape[1], model.inter_channels)
            .astype(np.float32) * model.noise_scale)
        ref = cpu.infer_p2(attn, m_p, s_p, g, noise)
        gpu = model.synth.infer_p2(attn.to(dev), m_p.to(dev), s_p.to(dev), g.to(dev),
                                   noise.to(dev)).cpu()
    err = float((gpu - ref).abs().max())
    corr = float(np.corrcoef(gpu.numpy().ravel(), ref.numpy().ravel())[0, 1])
    log(f"[serving] float decode, card vs CPU, {attn.shape[1]} frames: max_abs_err {err:.3e} "
        f"(tol 2e-3), corr {corr:.8f} (> 0.99999)")
    if not (err <= 2e-3 and corr > 0.99999):
        raise RuntimeError("the float decode on the card disagrees with the CPU")
    return main_launches, lat, audio_s


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import vits_tpu_torch  # noqa: F401  (fails when run outside the repo)
    from vits_tpu_torch.nn import rb_chain

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()
    rows, worst, tot = phase_kernels(dev)
    mas_rows = phase_mas(dev)
    launches, lat, audio_s = phase_serving(dev)
    if launches <= 0:
        raise RuntimeError("the serving path launched K1 no time")
    mas_launches, _, _, _ = phase_training(dev)
    if mas_launches <= 0:
        raise RuntimeError("the training path launched K2 no time")
    card = card_line()
    main = mas_rows[0]  # the shape the training step gives K2
    kernels = {"kernels": [{
        "name": "rb2_chain_q8",
        "route": "cuda",
        "source": "vits_tpu_torch/csrc/rb_chain_q8.cu",
        "replaces": "vits_tpu/nn/pallas_rb.py:96",
        "launches": launches,
        "max_abs_err": worst,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["ops_s"] >= tot["bytes_s"] else "bytes",
        "library_ms": None,
    }, {
        "name": "mas",
        "route": "cuda",
        "source": "vits_tpu_torch/csrc/mas.cu",
        "replaces": "vits_tpu/ops/mas.py:130",
        "launches": mas_launches,
        "max_abs_err": max(r["max_abs_err"] for r in mas_rows),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
