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
                of 20 calls - against the bound), at a B = 4 ragged case
                (C = 64, k = 7) and, bit-equal, at the 12 chains over the
                longest fused frame budget (4096 frames x the stage's
                upsampling, a 700-frame request in it);
     kernels_bf16 - the same cases for K1's bfloat16 form (bf16 weights,
                calibration and activations), every one bit-equal to the
                plain version in bf16; its 256-frame times and bound (half
                the activation bytes);
     mas      - K2, MAS, against its plain version, bit-exact, at
                (16, 400, 96) with the training bench's lengths, (32, 1000,
                384) (the base config's longest utterance and text), (1,
                1000, 1), a t_x == t_y case and (2, 2000, 384), all in the
                warp form, and (2, 1200, 1100) in the block form; print each
                case's form, kernel ms (device time, from a CUDA graph of 20
                calls), plain ms, bound ms and errors; then on bf16 neg_cent
                through `maximum_path` at (16, 800, 384) and the step's
                (16, 400, 96), the path back in bf16, bit-exact;
  3. serving  - write a seeded random base-config checkpoint at full width,
                serve it two-phase (`_infer_two_phase`) with
                EmoVITS(device="cuda", quantize=True): 8 calibration
                requests (float decodes), then int8 requests whose every
                ResBlock2 chain must go through the kernel (launch counts
                checked against the chains' plans), each compared with the
                float decode of the same request; one request's float decode
                is also held against the CPU;
  4. fused    - on the calibrated model, after one untimed round of the
                first request, 8 requests of 256-2048 frames in
                three modes in turns: two-phase int8, fused float (the
                default of `infer`) and fused int8 (VITS_TPU_FUSED_Q8=1):
                each request's latency per mode, the means and medians;
                fused lengths equal two-phase's, K1 launches per fused int8
                request equal the plans at the frame budget, fused int8
                against fused float; one fused float request held against
                a CPU copy of the model; one request with a clipped budget
                through the two-phase retry;
  5. stream   - one request through `infer_stream` against the two-phase
                float output (atol 1e-4); time to the first chunk and to the
                whole utterance;
     bf16     - EmoVITS(compute_dtype="bf16", quantize=True) on the same
                checkpoint: 8 bf16 calibration requests and the int8 gate,
                then, after an untimed round of each, 6 requests in turns
                in six modes: the fp32 engine's
                two-phase int8, and in bf16 two-phase float, fused float,
                two-phase int8 and fused int8 (K1's bf16 form, its launches
                = the plans, its last launch over the decoded M with the
                request's frames valid; none of the f32 form) and
                streaming; latency per mode, int8-vs-float correlation per
                request (two-phase and fused), the stream against two-phase;
                then one request decoded in bf16 and in fp32 from the fp32
                alignment: their waveform correlation;
  6. servers  - TTServer(port=0, device="cuda", quantize=True) on the same
                checkpoint, 2 calibration requests, then fused int8 requests
                through `protocol.synthesize` (K1 must launch on each), one
                `synthesize_stream` request and one POST through the HTTP
                gateway on a free port; each reply a RIFF WAV; the client
                latency of each; both servers stopped;
  7. training - the base config's mel/MPD GAN step at full width (seeded
                random weights with weight norm, AdamW from
                build_optimizers), on the training bench's synthetic batch
                (B 16, T_x 96, 400 spec frames, spec shipped), in both
                precisions in turns from the same weights: the configured
                bf16 step (configs/base.json's bf16_run) and the fp32 one,
                1 warm-up and 5 timed steps each, each step launching K2
                exactly once, with finite losses and moved parameters; print
                step ms, audio-s/s and peak memory of each; then one step of
                each precision on the card against the same step on the CPU
                (B = 2, same weights and noise, dropout off): fp32 losses
                within 1e-3 and the MAS paths equal; bf16: the losses that
                do not depend on the MAS path (D, GAN, feature, mel, D's
                gradient norm) within 3e-2, the path's moved cells and the
                other losses printed (bf16 neg_cent's rounding moves it);
     training_stft - the same for the stft/MRD variant's step
                (MultiWaveSTFTDiscriminator with spectral norm, RAdam for
                D, the multi-resolution STFT loss): both precisions in
                turns, K2 once per step, finite losses, moved parameters and
                every u of the MRD advanced; its medians against the mel
                step's in this call; the card-vs-CPU step at B = 2 with the
                same rules, the bf16 one holding the D, GAN and STFT losses
                and D's gradient norm;
  8. run      - `loop.run` on the card at full width with the duration
                discriminator (-d), in the configured bf16, batch 32, over
                a synthetic corpus written at the base widths (96
                utterances of 2-12 s, 256-d .vec of 40-200 vectors, 1024-d
                .emo, sids under 2048, 4 eval utterances), spectrograms on
                the device, compact batches: 4 steps with one eval and one
                save at the last (G/D/P_4.npz read back equal to the live
                state), then a resume for 2 steps; K2 launched once per step
                of each, losses finite (the critic's too); the loop's median
                step ms against the bare step at its largest bucket shape,
                audio-s/s, input stall, eval and save seconds, peak memory;
                then `python -m vits_tpu_torch.train -d` as a subprocess for
                one epoch of a 16-utterance corpus;
     run_stft - the same for `loop.run(variant="stft")` on the same corpus:
                4 steps with an eval and a save (G/D/P_4.npz, with RAdam's
                state and every u, read back equal to the live state), a
                resume for 2, every K2 launch held bit-exact against the
                plain search, the bare stft step at the largest bucket, and
                `python -m vits_tpu_torch.train_stft -d` as a subprocess for
                one step;
  9. sat      - SAT voice cloning at configs/adapt.json's full width (8 kHz,
                hop 96, upsampling 6-4-2-2, gin 256, text 192, 1024
                speakers) and its deployment: seeded random pretrained
                G_0/D_0 and two new speakers (10001, 10002) of 6 synthetic
                utterances of 2-8 s with transcripts; `sat.run_adapt` on the
                card in the config's bf16 for 4 steps (K2 launched once per
                step, every launch bit-exact against the plain search; the
                mapping 10001 -> 1023, 10002 -> 1022, spkid.map, the banks
                and their links); `python -m vits_tpu_torch.export
                --convert 1` as a subprocess (text buckets 64, 128; frame
                buckets 256, 512, 1024); the clone served by its external
                ids with EmoVITS(quantize=True): 8 calibration requests,
                then 4 int8 requests, K1's launches = the plans at the
                adapt shapes, each correlating >= 0.98 with its float
                decode; EmoVITS(aot=True) in fp32: in-bucket requests
                against the eager two-phase float decode at the same shapes
                and noise (atol 1e-4), one request past the text buckets
                served eagerly, the latency of AOT against eager two-phase
                float in turns, the capture seconds of each bucket; the
                deployment reloaded from save_torch_checkpoint's .pth, the
                same waveform; K1 at the 12 adapt chains of a 256-frame
                request, its time against its bound;
 10. card     - print the card's name and power limit.
Each phase prints the seconds it took. K1's launches in the kernels line are
those of the serving, fused, server and sat phases, each read with the
counter set to 0 just before the path runs and read just after; its bf16
form's those of the bf16 phase, and K2's those of both precisions' training
steps of both variants, of both runs and their resumes, and of the adapt
run.
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
# the same check of the bf16 step's path-free losses: cuDNN and the CPU round
# bf16 at other places through the decoder and the MPD, as the two packages
# do (tests/test_torch_bf16_train.py: the JAX and port bf16 steps at TINY
# differ by 0.5% in the mel loss)
BF16_LOSS_RTOL, BF16_LOSS_ATOL = 3e-2, 1e-3
CHAIN_FRAMES = 256    # T_y of the kernel check: M = 256 * (8, 48, 96, 192)
N_CALIB = 8
N_INT8 = 4
N_FUSED = 8           # requests served in the three modes of the fused phase, in turns
N_BF16 = 6            # ... and in the six modes of the bf16 phase
RING_FRAMES = 4096    # the noise ring's frames: the longest fused frame budget
BF16_MAS_SHAPES = ((16, 800, 384), (TRAIN_B, TRAIN_TY, TRAIN_TX))  # K2 on bf16 neg_cent
SERVER_CALIB = 2      # the socket server's int8 calibration requests
SERVER_INT8 = 3       # ... and its requests after the freeze
# each int8 request's waveform against the float decode of the same request:
# the JAX package's bench guard (bench.py); the gate's stricter 0.995 applies
# to the freezing request, whose activations the scales were calibrated on
MIN_REQUEST_CORR = 0.98
# the bf16 stream against the bf16 two-phase float decode of the same request:
# the same function, but cuDNN picks its algorithms per window shape, and in
# bf16 another summation order moves each conv output by up to an ulp of
# 2^-8 (the fp32 stream holds to 1e-4)
BF16_STREAM_CORR = 0.995


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


def k1_case(dev, gen, C, k, dil, gin, lens, M, dtype=torch.float32):
    """A seeded random ResBlock2 at (C, k, dil) in `dtype`, calibrated on its
    own input and quantized from its weights in that dtype, as serving in
    that dtype quantizes: (qp, x (B, M, C) masked past each length, gs,
    valid)."""
    from vits_tpu_torch.models.modules import ResBlock2
    from vits_tpu_torch.nn.core import init_weights
    rb = init_weights(ResBlock2(C, k, tuple(dil), gin), gen).to(dev, dtype).eval()
    B = len(lens)
    valid = torch.tensor(lens, dtype=torch.int32, device=dev)
    x = torch.randn(B, M, C, generator=gen).to(dev, dtype)
    mask = (torch.arange(M, device=dev)[None, :] < valid[:, None]).to(dtype)[..., None]
    x = x * mask
    g = torch.randn(B, gin, generator=gen).to(dev, dtype)
    with torch.no_grad():
        rec = {}
        rb(x, g, x_mask=mask, record=rec)
        qp = rb.quantize_params(rec)
        gs = torch.stack([rb.conds[str(i)](g) for i in range(len(dil))], 1).float()
    return qp, x, gs, valid


def k1_shapes(config="base"):
    """The 12 chain shapes of a config's CHAIN_FRAMES-frame request, with
    a ragged valid length (not a multiple of the stage's upsampling):
    (C, k, dilations, M, valid), and the config's gin."""
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    m = get_hparams_from_file(default_config_path(config)).model
    out, up = [], 1
    for s, u in enumerate(m.upsample_rates):
        up *= u
        C = m.upsample_initial_channel // 2 ** (s + 1)
        M = CHAIN_FRAMES * up
        for k, dil in zip(m.resblock_kernel_sizes, m.resblock_dilation_sizes):
            out.append((C, k, tuple(dil), M, M - 37 * up // 8 - 1))
    return out, m.gin_channels


def phase_kernels(dev, dtype=torch.float32):
    """K1's form for `dtype` against its plain version at the 12 base-config
    chain shapes, at one B = 4 ragged case (C = 64, k = 7) that runs the
    batch dimension of the whole-chain tiling, and at the 12 chains over the
    longest fused frame budget (RING_FRAMES frames, so a persistent block
    works through several tiles) with a 700-frame request in it, bit-equal.
    The bfloat16 form is bit-equal at every case."""
    from vits_tpu_torch.nn import rb_chain

    bf16 = dtype == torch.bfloat16
    name = "rb2_chain_q8 bf16" if bf16 else "rb2_chain_q8"
    shapes, gin = k1_shapes()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst = [], 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_s": 0.0, "bytes_s": 0.0}
    gen = torch.Generator().manual_seed(SEED + bf16)
    M4 = CHAIN_FRAMES * 48
    # the batch case; and each chain over the fused budget: the masked tail
    # the fused path gives K1 (valid = the request's samples, M the budget's)
    extra = [(64, 7, (1, 3, 5), M4, [M4 - 1, M4 - 3001, M4 // 2 + 17, 901], False)]
    extra += [(C, k, dil, M // CHAIN_FRAMES * RING_FRAMES, [M // CHAIN_FRAMES * 700], True)
              for C, k, dil, M, _ in shapes]
    cases = [(C, k, dil, M, [v], False) for C, k, dil, M, v in shapes] + extra
    for n_case, (C, k, dil, M, lens, bit_equal) in enumerate(cases):
        B = len(lens)
        bit_equal = bit_equal or bf16
        qp, x, gs, valid = k1_case(dev, gen, C, k, dil, gin, lens, M, dtype)
        out = rb_chain.chain_q8_cuda(qp, x, gs, valid)
        ref = rb_chain.chain_q8_plain(qp, x, gs, valid)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all() or out.dtype != dtype or ref.dtype != dtype:
            raise RuntimeError(f"{name} B={B} C={C} k={k}: non-finite output or a dtype "
                               f"other than {dtype} ({out.dtype}, plain {ref.dtype})")
        diff = (out - ref).float().abs()
        scale = max(1.0, float(ref.abs().max()))
        err = float(diff.max())
        off = float((diff > 1e-3 * float(ref.abs().max())).float().mean())
        ok = err <= 0.05 * scale and off < 0.01 and (not bit_equal or torch.equal(out, ref))
        worst = max(worst, err)
        p = rb_chain.plan(B, M, C, k, dil, n_sm)
        check = (f"max_abs_err {err:.3e} (tol {0.05 * scale:.3e}"
                 f"{', bit-equal required' if bit_equal else ''})  off>1e-3*max "
                 f"{100 * off:.3f}%  {'OK' if ok else 'FAIL'}")
        if n_case >= len(shapes):  # checked, not part of the 256-frame request
            log(f"[kernels] {name} B={B} C={C:3d} k={k:2d} M={M:6d} valid={lens}: "
                f"{p.form} T={p.T} grid {p.grid} launches {p.launches}: {check}")
            rows.append(dict(B=B, C=C, k=k, M=M, ok=ok, extra_case=True))
            del x, qp, out, ref, diff
            continue
        ms = graph_ms(lambda: rb_chain.chain_q8_cuda(qp, x, gs, valid))
        call_ms = cuda_ms(lambda: rb_chain.chain_q8_cuda(qp, x, gs, valid), iters=20)
        plain_ms = cuda_ms(lambda: rb_chain.chain_q8_plain(qp, x, gs, valid), iters=3, warmup=1)
        ops, nbytes = rb_chain.chain_ops_bytes(B, M, C, k, len(dil), x.element_size())
        bound = max(ops / INT8_PEAK, nbytes / HBM_BW) * 1e3
        by = "ops" if ops / INT8_PEAK > nbytes / HBM_BW else "bytes"
        log(f"[kernels] {name} B={B} C={C:3d} k={k:2d} M={M:5d} valid={lens[0]}: "
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
    rows = [r for r in rows if not r.get("extra_case")]
    if bad:
        raise RuntimeError(f"{name} disagrees with its plain version at {len(bad)} shape(s): "
                           f"{bad}")
    log(f"[kernels] {name}: all {len(rows)} shapes, the B = 4 case and the "
        f"{len(shapes)} chains over the {RING_FRAMES}-frame fused budget agree; the "
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
    # bf16 neg_cent, as the bf16 training step gives it: through the entry
    # point (cast to f32 for the kernel, the path back in bf16) against the
    # plain path on the same values
    for B, T_y, T_x in BF16_MAS_SHAPES:
        t_ys = [T_y - 13 * (i % 4) for i in range(B)]
        t_xs = [T_x - i % 7 for i in range(B)]
        neg, ty, tx = _mas_case(gen, dev, B, T_y, T_x, t_ys, t_xs)
        mask = ((torch.arange(T_y, device=dev)[None, :, None] < ty[:, None, None])
                & (torch.arange(T_x, device=dev)[None, None, :] < tx[:, None, None]))
        neg = neg.to(torch.bfloat16)
        before = mas.counter.launches
        out = mas.maximum_path(neg, mask.to(torch.bfloat16))
        ref = mas.maximum_path_plain(neg * mask, ty, tx)
        torch.cuda.synchronize()
        equal = (mas.counter.launches - before == 1 and out.dtype == torch.bfloat16
                 and torch.equal(out, ref) and torch.equal(out.float().sum(dim=(1, 2)),
                                                           ty.float()))
        err = float((out.float() - ref.float()).abs().max())
        log(f"[kernels] mas ({B}, {T_y}, {T_x}) bf16 neg_cent: form {mas.plan(B, T_y, T_x).form}, "
            f"path in {out.dtype}, max_abs_err {err:.1e} (bit-exact required)  "
            f"{'OK' if equal else 'FAIL'}")
        rows.append(dict(name="bf16", shape=(B, T_y, T_x), max_abs_err=err, ok=equal,
                         extra_case=True))
        del neg, out, ref
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"K2 differs from its plain version at {len(bad)} shape(s): {bad}")
    return [r for r in rows if not r.get("extra_case")], max(r["max_abs_err"] for r in rows)


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


def _state_bytes(state) -> int:
    """Bytes a training state keeps on the device between steps: the
    parameters of both models and their optimizer states."""
    n = 0
    for mod, opt in (("gen", "gen_opt"), ("disc", "disc_opt")):
        n += sum(p.numel() * p.element_size() for p in state[mod].parameters())
        n += sum(t.numel() * t.element_size() for st in state[opt].state.values()
                 for t in st.values() if torch.is_tensor(t) and t.is_cuda)
    return n


LOSS_KEYS = {"mel": ("loss_disc", "loss_gen", "loss_fm", "loss_mel", "loss_dur", "loss_kl",
                     "loss_kl_q", "loss_g_total", "grad_norm_d", "grad_norm_g"),
             "stft": ("loss_disc", "loss_gen", "loss_stft", "loss_dur", "loss_kl",
                      "loss_kl_q", "loss_g_total", "grad_norm_d", "grad_norm_g")}
# the step's numbers that do not depend on the MAS path: the decoder decodes a
# slice of the posterior latent, and D sees only that and the waveform
PATH_FREE = {"mel": ("loss_disc", "loss_gen", "loss_fm", "loss_mel", "grad_norm_d"),
             "stft": ("loss_disc", "loss_gen", "loss_stft", "grad_norm_d")}


def _card_vs_cpu(dev, step, opts, synth, disc, batch, noise, lr, dtype, keys):
    """One step at B = 2 on the card and on the CPU from the same weights and
    noise, dropout off (eval mode) so both run one function. Returns (cells
    on the card's MAS path, cells where the CPU's differs, {loss: (card,
    CPU)}, the CPU's seconds)."""
    from vits_tpu_torch.train.step import cast_call
    gen_opt, disc_opt = opts
    runs = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        g_m = copy.deepcopy(synth).to(d).eval()
        d_m = copy.deepcopy(disc).to(d).eval()
        b = {k: v.to(d) for k, v in batch.items()}
        nz = {k: v.to(d) for k, v in noise.items()}
        with torch.no_grad():
            attn = cast_call(g_m, dtype, b["x"].to(dtype), b["x_lengths"], b["spec"].to(dtype),
                             b["spec_lengths"], b["emo"].to(dtype), b["sid"], nz,
                             align_noise=0.01)["attn"].float().cpu()
        st = {"gen": g_m, "disc": d_m, "gen_opt": gen_opt.init(g_m.parameters()),
              "disc_opt": disc_opt.init(d_m.parameters()), "step": 0, "rng": None}
        t0 = time.perf_counter()
        _, mt = step(st, b, nz, lr, lr, 0.01)
        runs[where] = (attn, {k: v.float().cpu() for k, v in mt.items()},
                       time.perf_counter() - t0)
        del g_m, d_m, st
    (a_gpu, m_gpu, _), (a_cpu, m_cpu, cpu_s) = runs["cuda"], runs["cpu"]
    return (int(a_gpu.sum()), int((a_gpu != a_cpu).sum()),
            {k: (float(m_gpu[k]), float(m_cpu[k])) for k in keys}, cpu_s)


def _u_buffers(module):
    """Spectral norm's u of more than one element (a one-element u is +-1)."""
    return [b for n, b in module.named_buffers() if n.endswith("weight_u") and b.numel() > 1]


def phase_training(dev, variant="mel", mel_med=None):
    """The base config's step of `variant` (the mel/MPD one, or the
    stft/MRD one against `mel_med`, the mel step's medians in this call) at
    full width in both precisions, in turns: the configured bf16 step
    (train.bf16_run) and the fp32 one, each from the same seeded weights; K2
    launches once per step."""
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.train.loop import (align_noise_at, build_models, build_optimizers,
                                           build_step, count_params, init_state)
    from vits_tpu_torch.train.step import TrainStepConfig

    tag = "[training]" if variant == "mel" else "[training_stft]"
    hps = get_hparams_from_file(default_config_path("base"))
    B, T_x, T_y = TRAIN_B, TRAIN_TX, TRAIN_TY
    if TrainStepConfig.from_hps(hps).compute_dtype != torch.bfloat16:
        raise RuntimeError("configs/base.json's bf16_run did not give a bf16 step")
    t0 = time.perf_counter()
    runs = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", None)):
        synth, disc, _ = build_models(hps, variant)
        gen_opt, disc_opt, _ = build_optimizers(hps, variant)
        state = init_state(hps, synth, disc, None, gen_opt, disc_opt, None, seed=SEED,
                           device=dev)
        runs[name] = {"state": state, "step": build_step(hps, dtype, variant), "times": [],
                      "peak": 0.0, "work": 0.0,
                      "u0": [u.clone() for u in _u_buffers(state["disc"])]}
    synth = runs["fp32"]["state"]["gen"]
    m = hps.model
    disc = runs["fp32"]["state"]["disc"]
    d_name = ("MPD periods 2/3/5/7/11" if variant == "mel" else
              f"MRD of 5 wave levels and 5 STFT resolutions (ffts 128-2048) over the "
              f"{hps.train.segment_size}-sample segment, spectral-normed, RAdam")
    log(f"{tag} base config at full width (gin {m.gin_channels}, "
        f"{hps.data.n_speakers} speakers, posterior {m.n_layers_q} layers, decoder "
        f"{m.upsample_initial_channel}->{m.upsample_initial_channel // 16} channels, "
        f"{d_name}): G {count_params(synth)} parameters (+ enc_q and weight-norm "
        f"gains: {count_params(synth, exclude=())}), D {count_params(disc)} (with weight-norm "
        f"gains: {count_params(disc, exclude=())}); two states (fp32 and the configured bf16 "
        f"step) built and initialised in {time.perf_counter() - t0:.1f} s")
    batch = _bench_batch(hps, dev, B, T_x, T_y)
    hop, sr = hps.data.hop_length, hps.data.sampling_rate
    audio_s = float(batch["spec_lengths"].sum()) * hop / sr
    noise_gen = torch.Generator(device=dev).manual_seed(SEED)
    lr = hps.train.learning_rate
    mas.counter.launches = 0                 # main path starts here
    for i in range(1 + TRAIN_STEPS):
        noise = synth.draw_noise(B, T_x, T_y, noise_gen)
        for name, run in runs.items():
            state = run["state"]
            params = {k: [p.detach().clone() for p in state[k].parameters()]
                      for k in ("gen", "disc")}
            params["u"] = [u.clone() for u in _u_buffers(state["disc"])]
            before = mas.counter.launches
            torch.cuda.synchronize()
            start_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = run["step"](state, batch, noise, lr, lr,
                                         align_noise_at(hps, state["step"]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched = mas.counter.launches - before
            moved = {k: any(not torch.equal(a, p) for a, p in zip(params[k],
                                                                  state[k].parameters()))
                     for k in ("gen", "disc")}
            # the MRD's u advance by their power iteration each step (a u that
            # has converged stays put; every u has moved over the phase, below)
            moved["u"] = not params["u"] or any(
                not torch.equal(a, u) for a, u in zip(params["u"], _u_buffers(state["disc"])))
            if launched != 1:
                raise RuntimeError(f"{name} {variant} step {i}: K2 launched {launched} times, "
                                   f"expected 1")
            if not _finite(metrics):
                raise RuntimeError(f"{name} {variant} step {i}: non-finite losses "
                                   f"{ {k: float(v) for k, v in metrics.items() if v.ndim == 0} }")
            if not all(moved.values()):
                raise RuntimeError(f"{name} {variant} step {i}: parameters or u did not "
                                   f"change: {moved}")
            run["resident"] = _state_bytes(state) / 2 ** 30
            if i:
                run["times"].append(ms)
                run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated() / 2 ** 30)
                run["work"] = max(run["work"], (torch.cuda.max_memory_allocated()
                                                - start_bytes) / 2 ** 30)
            rec = "loss_mel" if variant == "mel" else "loss_stft"
            log(f"{tag} {name} step {i} {'warm-up' if i == 0 else 'timed  '}: {ms:.1f} ms, "
                f"K2 launches {launched}, loss_g_total {float(metrics['loss_g_total']):.4f}, "
                f"loss_disc {float(metrics['loss_disc']):.4f}, {rec} "
                f"{float(metrics[rec]):.4f}, grad_norm_g "
                f"{float(metrics['grad_norm_g']):.4f} (losses finite)")
            del params
    main_launches = mas.counter.launches     # main path ends here
    for name, run in runs.items():
        still = [i for i, (a, u) in enumerate(zip(run["u0"], _u_buffers(run["state"]["disc"])))
                 if torch.equal(a, u)]
        if still:
            raise RuntimeError(f"{name} {variant}: u {still} of {len(run['u0'])} never moved")
    if variant == "stft":
        log(f"{tag} every spectral-norm u of more than one element moved over the steps "
            f"({len(runs['fp32']['u0'])} in each state)")
    med = {}
    for name, run in runs.items():
        t = run["times"]
        med[name] = float(np.median(t))
        log(f"{tag} {name}: {TRAIN_STEPS} timed steps, median {med[name]:.1f} ms (min "
            f"{min(t):.1f}, max {max(t):.1f}), {audio_s / (med[name] / 1e3):.1f} audio-s/s "
            f"({audio_s:.2f} audio s per step); peak memory {run['peak']:.2f} GiB with both "
            f"states resident, the step's own {run['resident'] + run['work']:.2f} GiB (its "
            f"state {run['resident']:.2f} + the step's working memory {run['work']:.2f})")
    log(f"{tag} bf16 against fp32, in turns: median {med['bf16']:.1f} against "
        f"{med['fp32']:.1f} ms ({med['fp32'] / med['bf16']:.2f}x); K2 launches on the main "
        f"path {main_launches} in {2 * (1 + TRAIN_STEPS)} steps")
    if mel_med:
        log(f"{tag} against the mel step in this call: fp32 {med['fp32']:.1f} against "
            f"{mel_med['fp32']:.1f} ms ({med['fp32'] / mel_med['fp32']:.2f}x), bf16 "
            f"{med['bf16']:.1f} against {mel_med['bf16']:.1f} ms "
            f"({med['bf16'] / mel_med['bf16']:.2f}x)")

    # one step of each precision on the card against the same step on the
    # CPU: B = 2, the same weights (the fp32 run's) and noise. In fp32 every
    # loss holds and the paths are equal. In bf16, neg_cent is a sum over 192
    # channels of magnitude ~1e2-1e3 at these random weights, where bf16's
    # step is 0.5-8, so cuBLAS's and the CPU's roundings of its einsums (the
    # JAX package computes it in bf16 too) move the path: the numbers that
    # do not depend on it are held, the others are printed
    small = {k: v[:2] for k, v in batch.items()}
    noise = {k: v[:2] for k, v in synth.draw_noise(B, T_x, T_y, noise_gen).items()}
    all_keys = LOSS_KEYS[variant]
    for name, dtype, rtol, atol, keys in (
            ("fp32", torch.float32, LOSS_RTOL, LOSS_ATOL, all_keys),
            ("bf16", torch.bfloat16, BF16_LOSS_RTOL, BF16_LOSS_ATOL, PATH_FREE[variant])):
        cells, differ, losses, cpu_s = _card_vs_cpu(
            dev, runs[name]["step"], build_optimizers(hps, variant)[:2], synth, disc, small,
            noise, lr, dtype, all_keys)
        rel = {k: abs(a - c) / max(abs(c), atol / rtol) for k, (a, c) in losses.items()}
        bad = [k for k in keys if not abs(losses[k][0] - losses[k][1])
               <= atol + rtol * abs(losses[k][1])]
        if bad or (name == "fp32" and differ):
            raise RuntimeError(f"card vs CPU {name} step: {bad} outside rtol {rtol} "
                               f"({ {k: losses[k] for k in bad} }), {differ} path cells differ")
        worst = max(keys, key=rel.get)
        held = "the losses" if name == "fp32" else "the path-free losses " + "/".join(keys)
        log(f"{tag} {name} step, card vs CPU at B = 2 (CPU {cpu_s:.1f} s): MAS paths "
            f"{'equal' if not differ else f'differ in {differ} cells'} ({cells} cells on the "
            f"card's path); largest relative difference of {held} {rel[worst]:.2e} ({worst}; "
            f"tol {rtol:.0e})"
            + ("" if name == "fp32" else "; path-dependent: " + ", ".join(
                f"{k} {rel[k]:.2e}" for k in all_keys if k not in keys)))
    return main_launches, med, audio_s, {k: r["peak"] for k, r in runs.items()}


RUN_UTTS, RUN_VALID = 96, 4  # the [run] phase's corpus: 2-12 s utterances, and eval ones
RUN_SECONDS = (2.0, 11.9)     # below the base config's max_wav_len of 12 s
RUN_STEPS, RUN_RESUME = 4, 2  # the run's steps (one eval and one save, at its last), the resume's
RUN_LOG_INTERVAL = 2
CLI_UTTS, CLI_SECONDS = 16, (2.0, 3.5)  # the CLI's corpus: one bucket, one step an epoch
BARE_STEPS = 3                # the bare step at the run's largest bucket, after 1 warm-up


def write_corpus(dirpath, hps, n, seconds, seed, prefix="u"):
    """n synthetic utterances at the config's widths, as the data pipeline
    reads them: a 16-bit wav of `seconds` (uniform), a .vec of
    text_channels-wide float32 vectors (about one per 6 frames, 40-200), a
    1024-d .emo and a speaker id under n_speakers. Returns the scp lines."""
    from vits_tpu_torch.utils.audio import write_wav
    rng = np.random.RandomState(seed)
    d = hps.data
    lines = []
    for i in range(n):
        T = int(rng.uniform(*seconds) * d.sampling_rate)
        stem = os.path.join(dirpath, f"{prefix}{i}")
        t = np.arange(T) / d.sampling_rate
        f0 = rng.uniform(90, 250)
        wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * rng.randn(T)
        write_wav(stem + ".wav", wav.astype(np.float32), d.sampling_rate)
        n_vec = int(np.clip(T // d.hop_length // 6 + rng.randint(-5, 6), 40, 200))
        rng.randn(n_vec, d.text_channels).astype(np.float32).tofile(stem + ".vec")
        rng.randn(1024).astype(np.float32).tofile(stem + ".emo")
        lines.append(f"{stem}.vec|{stem}.wav|{stem}.emo|{rng.randint(0, d.n_speakers)}")
    return lines


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}//{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        elif k != "__empty__":
            out[key] = np.asarray(v)
    return out


def _checkpoint_equals_state(model_dir, state, step) -> int:
    """Every leaf of G/D/P_<step>.npz, read back, equals the live state's
    (parameters and AdamW state in the JAX layout). Returns the leaves."""
    from vits_tpu_torch.convert import optimizer_to_jax, params_to_jax
    from vits_tpu_torch.utils.checkpoint import read_checkpoint
    n = 0
    for prefix, key in (("G", "gen"), ("D", "disc"), ("P", "dur")):
        tree, s, _ = read_checkpoint(os.path.join(model_dir, f"{prefix}_{step}.npz"))
        live = _flat({"model": params_to_jax(state[key].state_dict()),
                      "optimizer": optimizer_to_jax(state[f"{key}_opt"], state[key])})
        got = _flat(tree)
        bad = [k for k in live if k not in got or not np.array_equal(got[k], live[k])]
        if s != step or bad or set(got) != set(live):
            raise RuntimeError(f"{prefix}_{step}.npz (step {s}) differs from the live state: "
                               f"{bad[:5]}, {sorted(set(got) ^ set(live))[:5]}")
        n += len(live)
    return n


def _run_mas_equal_plain(dev, calls, launches, tag="[run]") -> float:
    """The run's K2 launches (inputs and paths recorded on the host) against
    the plain search on the same inputs: each path bit-exact, one path step a
    frame; then each distinct shape's plan and device time. Launches made
    here are outside the main path's count. Returns the largest difference."""
    from vits_tpu_torch.ops import mas
    torch.cuda.synchronize()
    if len(calls) != launches:
        raise RuntimeError(f"{len(calls)} K2 launches recorded of the runs' {launches}")
    err, shapes = 0.0, {}
    for i, (neg, ty, tx, path) in enumerate(calls):
        neg, ty, tx, path = (t.to(dev) for t in (neg, ty, tx, path))
        ref = mas.maximum_path_plain(neg, ty, tx)
        e = float((path - ref).abs().max())
        if not (torch.equal(path, ref) and torch.equal(path.sum(dim=(1, 2)), ty.float())):
            raise RuntimeError(f"K2's path at the run's launch {i}, shape {tuple(neg.shape)}, "
                               f"differs from the plain search (max_abs_err {e:.1e})")
        err = max(err, e)
        shapes.setdefault(tuple(neg.shape), (neg, ty, tx))
    for (B, T_y, T_x), (neg, ty, tx) in sorted(shapes.items()):
        p = mas.plan(B, T_y, T_x)
        ms = graph_ms(lambda: mas.maximum_path_cuda(neg, ty, tx))
        bound = mas.mas_bytes(ty, tx, T_y, T_x) / HBM_BW * 1e3
        log(f"{tag} K2 at ({B}, {T_y}, {T_x}): form {p.form} R={p.R} D={p.D}: kernel "
            f"{ms:.4f} ms, bound {bound:.3e} ms (bytes; {100 * bound / ms:.1f}% of it)")
    log(f"{tag} K2's {len(calls)} launches of the runs, at {len(shapes)} shapes "
        f"{sorted(shapes)}, bit-exact against the plain search (max_abs_err {err:.1e})")
    return err


def phase_run(dev, workdir, variant="mel"):
    """`loop.run` of `variant` on the card at the base config's full width
    with the duration discriminator, in the configured bf16, batch 32, over
    a synthetic corpus (written once into `workdir`): RUN_STEPS steps with
    one eval and one save at the last, its checkpoints read back equal to
    the live state, then a resume for RUN_RESUME steps; K2 launched once per
    step of each; the bare step
    at the run's largest bucket shape timed on the resumed state; then the
    CLI (`python -m vits_tpu_torch.train -d`, or `vits_tpu_torch.train_stft`)
    as a subprocess for one epoch of a small corpus. Every K2 launch of the
    two runs is held against the plain search on the same input, bit-exact
    (`_run_mas_equal_plain`). Returns K2's launches in the two runs, as
    counted, and its largest difference from the plain search."""
    from vits_tpu_torch.config import HParams, default_config_path, get_hparams_from_file
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.train import loop
    from vits_tpu_torch.train.data import (DEFAULT_BOUNDARIES, BucketSampler, Prefetcher,
                                           TextAudioSpeakerDataset)

    tag, suffix = ("[run]", "") if variant == "mel" else ("[run_stft]", "_stft")
    hps = get_hparams_from_file(default_config_path("base"))
    t0 = time.perf_counter()
    scp = {name: os.path.join(workdir, f"{name}.scp") for name in ("train", "valid")}
    if not os.path.exists(scp["train"]):
        lines = write_corpus(workdir, hps, RUN_UTTS + RUN_VALID, RUN_SECONDS, SEED)
        for name, part in (("train", lines[:RUN_UTTS]), ("valid", lines[RUN_UTTS:])):
            with open(scp[name], "w") as f:
                f.write("\n".join(part))
    hps.data.training_files, hps.data.validation_files = scp["train"], scp["valid"]
    hps.train.log_interval, hps.train.eval_interval = RUN_LOG_INTERVAL, RUN_STEPS
    hps.model_dir = os.path.join(workdir, "logs", "run" + suffix)
    os.makedirs(hps.model_dir)
    hps.use_dur_dis = True
    dataset = TextAudioSpeakerDataset(scp["train"], hps, load_spec=False)
    sampler = BucketSampler(dataset.lengths, hps.train.batch_size, DEFAULT_BOUNDARIES)
    audio_h = sum(dataset.lengths) * hps.data.hop_length / hps.data.sampling_rate / 3600
    log(f"{tag} corpus: {len(dataset)} training utterances ({audio_h * 60:.1f} audio min, "
        f"{min(dataset.lengths)}-{max(dataset.lengths)} frames, text "
        f"{min(dataset.text_lengths)}-{max(dataset.text_lengths)} vectors) in "
        f"{len(sampler.buckets)} buckets (bounds {sampler.boundaries}), {len(sampler)} "
        f"batches of {hps.train.batch_size} an epoch, {RUN_VALID} eval utterances; ready "
        f"in {time.perf_counter() - t0:.1f} s")

    timed = {"save_all": [], "evaluate": []}
    real = {k: getattr(loop, k) for k in timed}
    kernel = mas.maximum_path_cuda
    k2_calls = []  # each K2 launch of the runs: its inputs and its path, copied to the host

    def recording(neg, t_ys, t_xs):
        path = kernel(neg, t_ys, t_xs)
        # non-blocking copies into pinned memory: no sync, no device memory held
        k2_calls.append(tuple(t.to("cpu", non_blocking=True) for t in (neg, t_ys, t_xs, path)))
        return path

    def timing(name):
        def call(*a, **k):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = real[name](*a, **k)
            torch.cuda.synchronize()
            timed[name].append(time.perf_counter() - start)
            return out
        return call

    def drive(max_steps):
        seen = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mas.counter.launches = 0                          # main path starts here
        start = time.perf_counter()
        state, steps = loop.run(hps, variant=variant, max_steps=max_steps, device=dev,
                                log_cb=lambda s, m: seen.append((time.perf_counter(), s, m)))
        torch.cuda.synchronize()
        launches = mas.counter.launches                   # main path ends here
        wall = time.perf_counter() - start
        bad = [(s, k) for _, s, m in seen for k, v in m.items() if not np.isfinite(v)]
        need = {"loss_disc_p", "loss_gen_p", "grad_norm_p", "loss_g_total", "loss_disc"}
        if bad or not seen or any(need - set(m) for _, _, m in seen):
            raise RuntimeError(f"run to step {max_steps}: non-finite or missing metrics {bad}")
        return state, steps, launches, seen, wall, torch.cuda.max_memory_allocated() / 2 ** 30

    for k in timed:
        setattr(loop, k, timing(k))
    mas.maximum_path_cuda = recording
    try:
        state, steps, launches_run, seen, wall, peak = drive(RUN_STEPS)
        if steps != RUN_STEPS or state["step"] != RUN_STEPS or launches_run != RUN_STEPS:
            raise RuntimeError(f"the run took {steps} steps (state {state['step']}), K2 "
                               f"launched {launches_run} times; expected {RUN_STEPS} each")
        window = [(b[0] - a[0]) * 1e3 / (b[1] - a[1]) for a, b in zip(seen, seen[1:])]
        loop_ms = float(np.median(window))
        for _, s, m in seen:
            log(f"{tag} step {s}: loss_g_total {m['loss_g_total']:.4f}, loss_disc "
                f"{m['loss_disc']:.4f}, loss_disc_p {m['loss_disc_p']:.4f}, loss_gen_p "
                f"{m['loss_gen_p']:.4f}, grad_norm_p {m['grad_norm_p']:.4f}; "
                f"{m['audio_sec_per_s']:.1f} audio-s/s, input stall "
                f"{m['input_stall_pct']:.2f}% over its {RUN_LOG_INTERVAL} steps")
        leaves = _checkpoint_equals_state(hps.model_dir, state, RUN_STEPS)
        opts = "AdamW" if variant == "mel" else "AdamW for G, RAdam for D and P, and u"
        log(f"{tag} {steps} steps in {wall:.1f} s (the run's build, data, eval and save "
            f"included), K2 launches {launches_run}; step ms by window after the first "
            f"{[round(w, 1) for w in window]}, median {loop_ms:.1f}; eval "
            f"{timed['evaluate'][0]:.2f} s, save (G, D, P with {opts} state) "
            f"{timed['save_all'][0]:.2f} s; peak memory {peak:.2f} GiB; G/D/P_{RUN_STEPS}.npz "
            f"read back equal to the live state ({leaves} leaves)")
        del state
        torch.cuda.empty_cache()

        state, steps, launches, seen_r, wall, _ = drive(RUN_STEPS + RUN_RESUME)
        if steps != RUN_STEPS + RUN_RESUME or state["step"] != steps or launches != RUN_RESUME:
            raise RuntimeError(f"the resume ended at step {steps} (state {state['step']}) with "
                               f"{launches} K2 launches; expected step "
                               f"{RUN_STEPS + RUN_RESUME}, {RUN_RESUME} launches")
        log(f"{tag} resumed at step {RUN_STEPS}, ended at {steps} in {wall:.1f} s (build, "
            f"load and save included), K2 launches {launches}; step {seen_r[-1][1]} "
            f"loss_g_total {seen_r[-1][2]['loss_g_total']:.4f}, loss_disc_p "
            f"{seen_r[-1][2]['loss_disc_p']:.4f}; save {timed['save_all'][-1]:.2f} s")
    finally:
        for k, fn in real.items():
            setattr(loop, k, fn)
        mas.maximum_path_cuda = kernel
    run_launches = launches_run + launches
    mas_err = _run_mas_equal_plain(dev, k2_calls, run_launches, tag)

    # the bare step on the resumed state at the run's largest bucket shape
    pf = Prefetcher(dataset, sampler, compact=True)
    biggest = max(pf.epoch(1), key=lambda b: b["wav"].shape[1])
    frames = (biggest["wav"].shape[1] - hps.data.filter_length) // hps.data.hop_length
    audio_s = float(biggest.pop("wav_lengths").sum()) / hps.data.sampling_rate
    batch = {k: v.to(dev) for k, v in biggest.items()}
    step = loop.build_step(hps, variant=variant)
    noise_gen = torch.Generator(device=dev).manual_seed(SEED)
    times = []
    for i in range(1 + BARE_STEPS):
        noise = state["gen"].draw_noise(batch["x"].shape[0], batch["x"].shape[1], frames,
                                        noise_gen)
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, metrics = step(state, batch, noise, 1e-4, 1e-4, 1e-4, 1e-4)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - start) * 1e3)
        if not _finite(metrics):
            raise RuntimeError("the bare step at the largest bucket gave non-finite losses")
    bare_ms = float(np.median(times))
    log(f"{tag} the loop's median step {loop_ms:.1f} ms against the bare step at the run's "
        f"largest bucket shape (B {batch['x'].shape[0]}, T_x {batch['x'].shape[1]}, "
        f"{frames} frames, compact) {bare_ms:.1f} ms (median of {BARE_STEPS}, "
        f"{audio_s / (bare_ms / 1e3):.1f} audio-s/s)")
    del state, batch, step
    torch.cuda.empty_cache()

    # the CLI in a subprocess: one epoch of a small corpus, from scratch
    cli_dir = os.path.join(workdir, "cli" + suffix)
    os.makedirs(cli_dir)
    module = "vits_tpu_torch.train" + suffix
    cfg = get_hparams_from_file(default_config_path("base")).to_dict()
    cfg["data"]["training_files"] = os.path.join(cli_dir, "train.scp")
    cfg["data"]["validation_files"] = os.path.join(cli_dir, "valid.scp")
    cfg["train"]["epochs"] = 1
    with open(cfg["data"]["training_files"], "w") as f:
        f.write("\n".join(write_corpus(cli_dir, hps, CLI_UTTS, CLI_SECONDS, SEED + 1, "c")))
    with open(os.path.join(cli_dir, "cli.json"), "w") as f:
        json.dump(cfg, f)
    env = {**os.environ, "PYTHONPATH": ROOT}
    start = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, "-m", "cli", "-d", "-c",
                        os.path.join(cli_dir, "cli.json")], cwd=cli_dir, env=env,
                       capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - start
    cli_steps = len(BucketSampler(TextAudioSpeakerDataset(
        cfg["data"]["training_files"], HParams(**cfg), load_spec=False).lengths,
        hps.train.batch_size, DEFAULT_BOUNDARIES))
    g = os.path.join(cli_dir, "logs", "cli", f"G_{cli_steps}.npz")
    if r.returncode != 0 or not os.path.exists(g):
        raise RuntimeError(f"the CLI exited {r.returncode}, {g} "
                           f"{'written' if os.path.exists(g) else 'missing'}:\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    written = sorted(f for f in os.listdir(os.path.dirname(g)) if f.endswith(".npz"))
    log(f"{tag} CLI `python -m {module} -m cli -d -c cli.json` (cuda, epochs 1, "
        f"{CLI_UTTS} utterances of {CLI_SECONDS[0]}-{CLI_SECONDS[1]} s): exit 0 in "
        f"{cli_s:.1f} s, {cli_steps} step(s), wrote {written}")
    return run_launches, mas_err


def _write_checkpoint(dirpath, hps_dict, dev_gen_seed):
    from vits_tpu_torch.config import HParams
    from vits_tpu_torch.convert import params_to_jax
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.nn.core import init_weights
    from vits_tpu_torch.utils.checkpoint import save_checkpoint

    synth = Synthesizer.from_hps(HParams(**hps_dict))
    init_weights(synth, torch.Generator().manual_seed(dev_gen_seed))
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(hps_dict, f)
    path = os.path.join(dirpath, "checkpoint.npz")
    save_checkpoint(path, {"model": params_to_jax(synth.state_dict())})
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
                torch.from_numpy(text[None]).to(dev, model.compute_dtype),
                torch.from_numpy(emo[None]).to(dev, model.compute_dtype),
                torch.tensor([spk], device=dev))
        base = float(torch.exp(logw.float()).sum())
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


def phase_serving(dev, workdir):
    """Two-phase int8 serving (`_infer_two_phase`): the calibration, the
    freeze and its gate, K1 on every int8 decode. Returns the K1 launches,
    the latencies, the calibrated model, its requests and its checkpoint."""
    from vits_tpu_torch.config import default_config_path
    from vits_tpu_torch.infer import EmoVITS
    from vits_tpu_torch.nn import rb_chain

    with open(default_config_path("base")) as f:
        hps_dict = json.load(f)
    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    ckpt = _write_checkpoint(workdir, hps_dict, SEED)
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
        wav, _ = model._infer_two_phase(spk, text, emo, duration_rate=rate)
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
            wav_f, _ = model._infer_two_phase(spk, text, emo, duration_rate=rate)
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
    return main_launches, lat, audio_s, model, reqs, ckpt


def _timed_call(fn, *a, **k):
    """fn(*a, **k) and its host-clock ms; every serving entry point ends in a
    host copy of the waveform, so the clock stops after the device's work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **k)
    return out, (time.perf_counter() - t0) * 1e3


def _env(**values):
    """Set environment variables (None unsets); returns the old values."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return old


def _corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def phase_fused(dev, model, ckpt):
    """The calibrated model serves N_FUSED requests of 256-2048 frames in
    three modes in turns, each request in each mode before the next request:
    two-phase int8, fused float (the default of `infer` once the int8
    decoder is frozen) and fused int8 (VITS_TPU_FUSED_Q8=1), with the same
    seed. Checks: the fused pass served every request (frames below its
    budget) at two-phase's length; K1 launches per fused int8 request equal
    the plans at the budget (the decoder runs over the budget, not the
    request), none in fused float; fused int8 against fused float. Then one
    fused float request on the card against a CPU copy of the model, and one
    request whose clipped budget sends it through the two-phase retry."""
    from vits_tpu_torch.infer import EmoVITS
    from vits_tpu_torch.nn import rb_chain

    m, hop, sr = model.hps.model, model.hop_size, model.sampling_rate
    up = int(np.prod(m.upsample_rates))     # samples per frame at the last stage
    reqs = _requests(model, N_FUSED, np.random.RandomState(SEED + 1), dev)
    modes = ("two-phase int8", "fused float", "fused int8")
    lat = {mode: [] for mode in modes}
    audio_s, lengths = 0.0, []
    saved = _env(VITS_TPU_FUSED_Q8=None, VITS_TPU_FUSED_FRAMES_PER_TOKEN=None)
    rb_chain.counter.launches = 0           # main path starts here
    # one untimed round of the first request in each mode: the fused pass's
    # shapes (the 4096-frame budget) are new to this process; two-phase's
    # change with every request's frame bucket, as they do in service
    spk, text, emo, rate = reqs[0]
    for mode in modes:
        _env(VITS_TPU_FUSED_Q8="1" if mode == "fused int8" else "0")
        fn = model._infer_two_phase if mode.startswith("two") else model.infer_fused
        (_, _), ms = _timed_call(fn, spk, text, emo, duration_rate=rate)
        log(f"[fused] warm-up, request 0, {mode}: {ms:.2f} ms")
    for i, (spk, text, emo, rate) in enumerate(reqs):
        budget = model.fused_frames(len(text), rate)
        out = {}
        for mode in modes:
            _env(VITS_TPU_FUSED_Q8="1" if mode == "fused int8" else "0")
            fn = model._infer_two_phase if mode.startswith("two") else model.infer_fused
            before = rb_chain.counter.launches
            rb_chain.counter.last = None
            np.random.seed(SEED + 200 + i)
            (wav, _), ms = _timed_call(fn, spk, text, emo, duration_rate=rate)
            out[mode] = (wav, ms, rb_chain.counter.launches - before, rb_chain.counter.last)
            lat[mode].append(ms)
        frames = len(out["two-phase int8"][0]) // hop
        lengths.append(frames * hop)
        audio_s += frames * hop / sr
        if frames >= budget:
            raise RuntimeError(f"fused phase, request {i}: {frames} frames fill the budget "
                               f"{budget}; the two-phase retry served it, not the fused pass")
        want_2p = k1_launches_per_decode(m, frames, dev)
        want_fused = k1_launches_per_decode(m, budget, dev)
        # the last chain's M is the decoded frames': the budget's in the fused
        # pass, the frame bucket's in two-phase; its valid is the request's
        want_m = {"two-phase int8": model._quantize(frames, model.frame_quantum) * up,
                  "fused int8": budget * up}
        for mode, (wav, ms, launched, last) in out.items():
            if len(wav) != frames * hop or not np.all(np.isfinite(wav)):
                raise RuntimeError(f"fused phase, request {i}, {mode}: {len(wav)} samples, "
                                   f"two-phase {frames * hop}, or a non-finite value")
            want = {"two-phase int8": want_2p, "fused float": 0, "fused int8": want_fused}[mode]
            if launched != want:
                raise RuntimeError(f"fused phase, request {i}, {mode}: K1 launched {launched} "
                                   f"times, expected {want}")
            if mode in want_m and (last[0] != want_m[mode] or
                                   int(last[1][0]) != frames * up):
                raise RuntimeError(f"fused phase, request {i}, {mode}: K1's last launch had "
                                   f"M {last[0]}, valid {int(last[1][0])}; expected M "
                                   f"{want_m[mode]}, valid {frames * up}")
        corr = _corr(out["fused int8"][0], out["fused float"][0])
        if not corr > MIN_REQUEST_CORR:
            raise RuntimeError(f"fused phase, request {i}: fused int8 vs fused float corr {corr}")
        log(f"[fused] request {i}: {len(text):3d} tokens, {frames:4d} frames, budget {budget:4d}"
            f" frames: " + ", ".join(f"{mode} {out[mode][1]:.2f} ms (K1 {out[mode][2]})"
                                     for mode in modes)
            + f"; fused int8 vs float corr {corr:.6f}; K1's last M: two-phase "
            f"{out['two-phase int8'][3][0]}, fused {out['fused int8'][3][0]}")
    launches = rb_chain.counter.launches    # main path ends here
    for mode in modes:
        v = np.array(lat[mode])
        log(f"[fused] {mode:14s}: {len(v)} requests, latency mean {v.mean():.2f} ms median "
            f"{np.median(v):.2f} ms, {audio_s / (v.sum() / 1e3):.1f} audio-s/s")

    # one fused float request on the card against a CPU copy of the model:
    # 64 tokens at the rate that gives about 128 frames, to keep the CPU's
    # decode over the budget short
    spk, text, emo, _ = reqs[0]
    text = text[:64]
    with torch.inference_mode():
        _, _, logw, _ = model.synth.infer_p1(
            torch.from_numpy(text[None]).to(dev), torch.from_numpy(emo[None]).to(dev),
            torch.tensor([spk], device=dev))
    rate = 128.0 / float(torch.exp(logw).sum())
    _env(VITS_TPU_FUSED_Q8="0")
    cpu_model = EmoVITS(ckpt, device="cpu")
    np.random.seed(SEED + 300)
    wav_gpu, _ = model.infer_fused(spk, text, emo, duration_rate=rate)
    np.random.seed(SEED + 300)
    t0 = time.perf_counter()
    wav_cpu, _ = cpu_model.infer_fused(spk, text, emo, duration_rate=rate)
    cpu_s = time.perf_counter() - t0
    budget = model.fused_frames(len(text), rate)
    if len(wav_gpu) != len(wav_cpu) or len(wav_gpu) // hop >= budget:
        raise RuntimeError(f"fused float, card vs CPU: {len(wav_gpu)} against {len(wav_cpu)} "
                           f"samples (budget {budget} frames)")
    err = float(np.abs(wav_gpu - wav_cpu).max())
    corr = _corr(wav_gpu, wav_cpu)
    log(f"[fused] fused float, card vs CPU, {len(wav_gpu) // hop} frames in a {budget}-frame "
        f"budget (CPU {cpu_s:.1f} s): max_abs_err {err:.3e} (tol 2e-3), corr {corr:.8f} "
        f"(> 0.99999)")
    if not (err <= 2e-3 and corr > 0.99999):
        raise RuntimeError("the fused float request on the card disagrees with the CPU")
    del cpu_model

    # a clipped budget: the request is served again by the exact two-phase path
    spk, text, emo, rate = reqs[0]
    _env(VITS_TPU_FUSED_Q8="1", VITS_TPU_FUSED_FRAMES_PER_TOKEN="0.1")
    budget = model.fused_frames(len(text), rate)
    rb_chain.counter.launches = 0           # main path starts here
    np.random.seed(SEED + 400)
    (wav, _), ms = _timed_call(model.infer, spk, text, emo, duration_rate=rate)
    retry_launches = rb_chain.counter.launches  # main path ends here
    launches += retry_launches
    _env(**saved)
    # the fused pass's int8 decode over the budget, then the two-phase one
    want = k1_launches_per_decode(m, budget, dev) + k1_launches_per_decode(m, lengths[0] // hop,
                                                                         dev)
    if len(wav) != lengths[0] or budget * hop > len(wav) or retry_launches != want:
        raise RuntimeError(f"the two-phase retry gave {len(wav)} samples, two-phase "
                           f"{lengths[0]} (budget {budget} frames), K1 launches "
                           f"{retry_launches}, expected {want}")
    log(f"[fused] budget clipped to {budget} frames: the two-phase retry served "
        f"{len(wav) // hop} frames, as two-phase does, in {ms:.2f} ms (the fused pass, then "
        f"two-phase int8), K1 launches {retry_launches}")
    return launches, lat


def phase_stream(dev, model, req):
    """One full-width request through `infer_stream` (float decoder,
    windows of the frame quantum with a 24-frame halo) against the two-phase
    float output of the same request: the concatenation within 1e-4 (cuDNN
    may pick other algorithms per window). The request streams twice: cold
    (the first use of the windows' shapes in this process) and warm. Prints
    the time to the first chunk and to the whole utterance of each."""
    spk, text, emo, rate = req
    dec_q8 = model.dec_q8
    model.dec_q8, model.quantize = None, False
    np.random.seed(SEED + 500)
    (ref, _), ms_2p = _timed_call(model._infer_two_phase, spk, text, emo, duration_rate=rate)
    frames = len(ref) // model.hop_size
    times = {}
    for run in ("cold", "warm"):
        np.random.seed(SEED + 500)
        chunks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for chunk in model.infer_stream(spk, text, emo, duration_rate=rate):
            if not chunks:
                first_ms = (time.perf_counter() - t0) * 1e3
            chunks.append(chunk)
        total_ms = (time.perf_counter() - t0) * 1e3
        wav = np.concatenate(chunks)
        err = float(np.abs(wav - ref).max()) if wav.shape == ref.shape else float("inf")
        times[run] = (first_ms, total_ms)
        log(f"[stream] {run}: {len(text)} tokens, {frames} frames in {len(chunks)} chunks of "
            f"{model.frame_quantum} frames: first chunk {first_ms:.2f} ms, whole utterance "
            f"{total_ms:.2f} ms (two-phase float {ms_2p:.2f} ms); against two-phase float: "
            f"max_abs_err {err:.3e} (tol 1e-4)")
        if not err <= 1e-4:
            raise RuntimeError("the streamed request differs from the two-phase float output")
    model.dec_q8, model.quantize = dec_q8, True
    return times, ms_2p


BF16_MODES = ("fp32 two-phase int8", "bf16 two-phase float", "bf16 fused float",
              "bf16 two-phase int8", "bf16 fused int8", "bf16 stream")


def _serve(model, mode, spk, text, emo, rate):
    """One request in one of BF16_MODES: (wav, ms, first-chunk ms or None)."""
    _env(VITS_TPU_FUSED_Q8="1" if mode.endswith("fused int8") else "0")
    if mode.endswith("stream"):
        chunks, first = [], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for chunk in model.infer_stream(spk, text, emo, duration_rate=rate):
            first = first or (time.perf_counter() - t0) * 1e3
            chunks.append(chunk)
        return np.concatenate(chunks), (time.perf_counter() - t0) * 1e3, first
    if "fused" in mode:
        fn = model.infer_fused
    else:
        fn = model._infer_two_phase
        if mode.endswith("float"):  # the float decoder of an int8 engine
            model.quantize, dec_q8, model.dec_q8 = False, model.dec_q8, None
    try:
        (wav, _), ms = _timed_call(fn, spk, text, emo, duration_rate=rate)
    finally:
        if mode.endswith("two-phase float"):
            model.quantize, model.dec_q8 = True, dec_q8
    return wav, ms, None


def phase_bf16(dev, model32, ckpt):
    """bf16 serving at full width: EmoVITS(compute_dtype="bf16",
    quantize=True) on the same checkpoint calibrates its int8 decoder on
    N_CALIB two-phase bf16 requests, then N_BF16 requests of 256-2048 frames
    run in turns in BF16_MODES, the fp32 engine's two-phase int8 first, after
    one untimed round of them all. Checks per request: every bf16 path serves the
    request's bf16 frames (the fused ones below their budget); K1's float32
    form launches only in the fp32 mode and its bf16 form only in the bf16
    int8 modes, as many times as the plans of the decoder's chains (at the
    frames' bucket two-phase, at the budget fused), its last launch over that
    M with the request's frames valid; int8 against float above
    MIN_REQUEST_CORR, two-phase and fused; the stream against the two-phase
    float output. Then one request decoded by both engines from the fp32
    engine's alignment: the bf16-vs-fp32 waveform correlation."""
    from vits_tpu_torch.infer import EmoVITS
    from vits_tpu_torch.nn import rb_chain
    from vits_tpu_torch.ops.seq import infer_path

    m, hop, sr = model32.hps.model, model32.hop_size, model32.sampling_rate
    up = int(np.prod(m.upsample_rates))
    saved = _env(VITS_TPU_FUSED_Q8=None, VITS_TPU_FUSED_FRAMES_PER_TOKEN=None,
                 VITS_TPU_Q8_CALIB_REQUESTS=str(N_CALIB), VITS_TPU_DTYPE=None)
    t0 = time.perf_counter()
    model = EmoVITS(ckpt, device=str(dev), compute_dtype="bf16", quantize=True)
    if model.synth.dec.conv_pre.weight.dtype != torch.bfloat16:
        raise RuntimeError("the bf16 engine's weights are not bf16")
    reqs = _requests(model32, N_CALIB + N_BF16, np.random.RandomState(SEED + 700), dev)
    for i, (spk, text, emo, rate) in enumerate(reqs[:N_CALIB]):
        np.random.seed(SEED + 700 + i)
        model._infer_two_phase(spk, text, emo, duration_rate=rate)
    if model.dec_q8 is None:
        raise RuntimeError(f"the bf16 int8 decoder failed its correlation gate "
                           f"(corr {model.q8_corr}); K1's bf16 form would never run")
    log(f"[bf16] engine loaded, {N_CALIB} bf16 calibration requests served, int8 gate passed "
        f"(corr {model.q8_corr:.6f}) in {time.perf_counter() - t0:.1f} s")
    engines = {mode: model32 if mode.startswith("fp32") else model for mode in BF16_MODES}
    # one untimed round of every request in every mode: each request's frame
    # bucket (and its last stream window) is a shape new to this process,
    # whose first cuDNN convolutions cost ~150 ms of setup in either precision
    warm = {mode: 0.0 for mode in BF16_MODES}
    for i, (spk, text, emo, rate) in enumerate(reqs[N_CALIB:]):
        for mode in BF16_MODES:
            np.random.seed(SEED + 800 + i)
            warm[mode] += _serve(engines[mode], mode, spk, text, emo, rate)[1] / N_BF16
    log("[bf16] untimed round (cold shapes), mean ms: "
        + ", ".join(f"{mode} {ms:.2f}" for mode, ms in warm.items()))
    lat = {mode: [] for mode in BF16_MODES}
    first_ms, audio_s = [], 0.0
    rb_chain.counter.launches = rb_chain.counter_bf16.launches = 0  # main path starts here
    for i, (spk, text, emo, rate) in enumerate(reqs[N_CALIB:]):
        budget = model.fused_frames(len(text), rate)
        out = {}
        for mode in BF16_MODES:
            before = (rb_chain.counter.launches, rb_chain.counter_bf16.launches)
            rb_chain.counter_bf16.last = None
            np.random.seed(SEED + 800 + i)
            wav, ms, first = _serve(engines[mode], mode, spk, text, emo, rate)
            out[mode] = (wav, ms, rb_chain.counter.launches - before[0],
                         rb_chain.counter_bf16.launches - before[1], rb_chain.counter_bf16.last)
            lat[mode].append(ms)
            if first is not None:
                first_ms.append(first)
        # the frames each path decodes: the fused pass takes its durations'
        # exp in bf16 on the device, two-phase in f32 on the host (as the JAX
        # engine does), so a ceil may land on another frame
        frames32 = len(out["fp32 two-phase int8"][0]) // hop
        frames = len(out["bf16 two-phase float"][0]) // hop
        frames_f = len(out["bf16 fused float"][0]) // hop
        n_of = {mode: frames_f if "fused" in mode else frames for mode in BF16_MODES}
        n_of["fp32 two-phase int8"] = frames32
        audio_s += frames * hop / sr
        if frames_f >= budget:
            raise RuntimeError(f"bf16 phase, request {i}: {frames_f} frames fill the budget "
                               f"{budget}")
        want_m = {"bf16 two-phase int8": (model._quantize(frames, model.frame_quantum) * up,
                                          frames * up),
                  "bf16 fused int8": (budget * up, frames_f * up)}
        for mode, (wav, ms, l32, l16, last) in out.items():
            n = n_of[mode]
            if len(wav) != n * hop or not np.all(np.isfinite(wav)) or np.abs(wav).max() > 1.0:
                raise RuntimeError(f"bf16 phase, request {i}, {mode}: {len(wav)} samples "
                                   f"(expected {n * hop}), or a value not finite or past 1")
            want32 = k1_launches_per_decode(m, frames32, dev) if mode.startswith("fp32") else 0
            want16 = {"bf16 two-phase int8": k1_launches_per_decode(m, frames, dev),
                      "bf16 fused int8": k1_launches_per_decode(m, budget, dev)}.get(mode, 0)
            if (l32, l16) != (want32, want16):
                raise RuntimeError(f"bf16 phase, request {i}, {mode}: K1 launched {l32} times "
                                   f"in float32 and {l16} in bf16, expected {want32}, {want16}")
            if mode in want_m and (last[0], int(last[1][0])) != want_m[mode]:
                raise RuntimeError(f"bf16 phase, request {i}, {mode}: K1's last launch had M "
                                   f"{last[0]}, valid {int(last[1][0])}; expected "
                                   f"{want_m[mode]}")
        corr_2p = _corr(out["bf16 two-phase int8"][0], out["bf16 two-phase float"][0])
        corr_f = _corr(out["bf16 fused int8"][0], out["bf16 fused float"][0])
        corr_s = _corr(out["bf16 stream"][0], out["bf16 two-phase float"][0])
        err_s = float(np.abs(out["bf16 stream"][0] - out["bf16 two-phase float"][0]).max())
        if not (corr_2p > MIN_REQUEST_CORR and corr_f > MIN_REQUEST_CORR
                and corr_s > BF16_STREAM_CORR):
            raise RuntimeError(f"bf16 phase, request {i}: int8 vs float corr two-phase "
                               f"{corr_2p}, fused {corr_f}; stream vs two-phase {corr_s}")
        log(f"[bf16] request {i}: {len(text):3d} tokens, {frames:4d} frames (fused {frames_f}, "
            f"fp32 {frames32}), budget {budget}: " + ", ".join(f"{mode} {out[mode][1]:.2f} ms"
                                             for mode in BF16_MODES)
            + f"; K1 bf16 launches two-phase {out['bf16 two-phase int8'][3]}, fused "
            f"{out['bf16 fused int8'][3]}; int8 vs float corr two-phase {corr_2p:.6f}, fused "
            f"{corr_f:.6f}; stream vs two-phase corr {corr_s:.8f}, max_abs_err {err_s:.3e}")
    launches = rb_chain.counter_bf16.launches  # main path ends here
    for mode in BF16_MODES:
        v = np.array(lat[mode])
        log(f"[bf16] {mode:20s}: {len(v)} requests, latency mean {v.mean():.2f} ms median "
            f"{np.median(v):.2f} ms, {audio_s / (v.sum() / 1e3):.1f} audio-s/s")
    log(f"[bf16] stream: first chunk mean {np.mean(first_ms):.2f} ms median "
        f"{np.median(first_ms):.2f} ms")

    # bf16 against fp32 on one request, both decoded from the fp32 engine's
    # alignment and noise (a bf16 duration may round to another frame count)
    spk, text, emo, rate = reqs[N_CALIB]
    with torch.inference_mode():
        args = (torch.from_numpy(text[None]).to(dev), torch.from_numpy(emo[None]).to(dev),
                torch.tensor([spk], device=dev))
        m_p, s_p, logw, g = model32.synth.infer_p1(*args)
        w = torch.ceil(torch.exp(logw[..., 0]) * rate)
        attn = infer_path(w, max(int(w.sum()), 1))
        noise = torch.from_numpy(np.random.RandomState(SEED).randn(
            1, attn.shape[1], model32.inter_channels).astype(np.float32)
            * model32.noise_scale).to(dev)
        ref = model32.synth.infer_p2(attn, m_p, s_p, g, noise).float().cpu().numpy()
        b = model.synth.infer_p1(args[0].bfloat16(), args[1].bfloat16(), args[2])
        got = model.synth.infer_p2(attn, b[0], b[1], b[3], noise)
    corr = _corr(got.float().cpu().numpy(), ref)
    log(f"[bf16] bf16 against fp32 on one request ({attn.shape[1]} frames, the fp32 "
        f"alignment): waveform corr {corr:.6f}, max_abs_err "
        f"{float(np.abs(got.float().cpu().numpy() - ref).max()):.3e}, output {got.dtype}")
    if got.dtype != torch.bfloat16 or not corr > MIN_REQUEST_CORR:
        raise RuntimeError(f"the bf16 decode disagrees with the fp32 one (corr {corr})")
    _env(**saved)
    del model
    return launches, lat


def _pcm(wav_bytes) -> np.ndarray:
    """The samples of a 16-bit PCM RIFF WAV reply, its header checked."""
    import struct
    if len(wav_bytes) <= 44 or wav_bytes[:4] != b"RIFF" or wav_bytes[8:12] != b"WAVE" \
            or struct.unpack("<I", wav_bytes[40:44])[0] != len(wav_bytes) - 44:
        raise RuntimeError(f"not a RIFF WAV reply ({len(wav_bytes)} bytes)")
    return np.frombuffer(wav_bytes[44:], np.int16)


def phase_servers(dev, ckpt):
    """The socket server and the HTTP gateway at full width:
    TTServer(port=0, device="cuda", quantize=True) with SERVER_CALIB
    calibration requests and VITS_TPU_FUSED_Q8=1, so that after the freeze
    its requests run the fused pass with the int8 decoder. Sends requests
    through `protocol.synthesize` until the int8 decoder is frozen and
    SERVER_INT8 more (K1 must launch on each of those), one
    `synthesize_stream` request and one POST through the gateway on a free
    port; prints the client-side latency of each and stops both servers."""
    import threading
    from vits_tpu_torch.nn import rb_chain
    from vits_tpu_torch.serve import http_server
    from vits_tpu_torch.serve.protocol import synthesize, synthesize_stream
    from vits_tpu_torch.serve.socket_server import TTServer

    saved = _env(VITS_TPU_Q8_CALIB_REQUESTS=str(SERVER_CALIB), VITS_TPU_FUSED_Q8="1",
                 VITS_TPU_FUSED=None, VITS_TPU_FUSED_FRAMES_PER_TOKEN=None)
    t0 = time.perf_counter()
    srv = TTServer(port=0, device=str(dev), quantize=True, ckpt_path=ckpt)
    httpd = None
    try:
        remote = ("127.0.0.1", srv.start())
        speecher = srv.tts.speecher
        log(f"[servers] socket server on port {remote[1]}, model on {speecher.device}, "
            f"calibration {speecher.q8_calib_requests} requests; started in "
            f"{time.perf_counter() - t0:.1f} s")
        # each fused pass the server makes: its budget, frames, and K1's launches
        # and last launch (an int8 request decodes over the budget, not its frames)
        passes, infer_fused = [], speecher.infer_fused

        def recorded_infer_fused(spkid, text, emo=None, *, duration_rate=1.0):
            before = rb_chain.counter.launches
            rb_chain.counter.last = None
            wav, emo_vec = infer_fused(spkid, text, emo, duration_rate=duration_rate)
            passes.append((speecher.fused_frames(len(text), duration_rate),
                           len(wav) // speecher.hop_size, rb_chain.counter.launches - before,
                           rb_chain.counter.last))
            return wav, emo_vec

        speecher.infer_fused = recorded_infer_fused
        m = speecher.hps.model
        up = int(np.prod(m.upsample_rates))
        emo = np.random.RandomState(SEED + 600).randn(1024).astype(np.float32).tolist()
        texts = ["The quick brown fox jumps over the lazy dog, again and again.",
                 "Speech served through the socket server at full width, twice.",
                 "A third request: the int8 decoder is frozen after this one.",
                 "Served by the fused pass with the int8 decoder on the card.",
                 "Another int8 request, a little shorter than the one before.",
                 "And the last int8 request of this phase, then streaming."]
        texts = texts[:SERVER_CALIB + SERVER_INT8]
        rb_chain.counter.launches = 0       # main path starts here
        int8_launches = []
        for i, text in enumerate(texts):
            frozen = speecher.dec_q8 is not None
            before = rb_chain.counter.launches
            n_passes = len(passes)
            t0 = time.perf_counter()
            out = synthesize({"text": text, "spkid": i + 1, "speed": 2.0,
                              "emotion": np.asarray(emo, np.float32)}, remote)
            ms = (time.perf_counter() - t0) * 1e3
            launched = rb_chain.counter.launches - before
            if out is None:
                raise RuntimeError(f"server request {i}: no reply")
            pcm = _pcm(out["wav"])
            kind = "int8" if frozen else "freeze" if speecher.dec_q8 is not None else "calib"
            note = ""
            if kind == "int8":
                # one fused int8 pass: the plans' launches at its budget, the
                # last chain over the budget with the request's frames valid
                if len(passes) != n_passes + 1:
                    raise RuntimeError(f"server request {i}: {len(passes) - n_passes} fused "
                                       f"passes, expected 1")
                budget, frames, pass_launches, last = passes[-1]
                want = k1_launches_per_decode(m, budget, dev)
                if launched != want or pass_launches != want or last is None or \
                        last[0] != budget * up or int(last[1][0]) != frames * up:
                    raise RuntimeError(
                        f"server request {i}: K1 launched {launched} times, expected {want}; "
                        f"its last launch M {last and last[0]}, valid "
                        f"{last and int(last[1][0])}, expected {budget * up}, {frames * up}")
                int8_launches.append(launched)
                note = f" (the plans at the {budget}-frame budget; {frames} frames valid)"
            log(f"[servers] socket request {i} ({kind}): {len(text)} characters, "
                f"{len(pcm) / out['sr']:.3f} audio s, client latency {ms:.2f} ms, frontend "
                f"{out['time_used_frontend']:.2f} ms, backend {out['time_used_backend']:.2f} ms, "
                f"K1 launches {launched}{note}")
        launches = rb_chain.counter.launches  # main path ends here
        if speecher.dec_q8 is None or len(int8_launches) != SERVER_INT8:
            raise RuntimeError(f"the server's int8 requests launched K1 {int8_launches} times")

        t0 = time.perf_counter()
        first_ms, pcm = None, b""
        for msg in synthesize_stream({"text": texts[0], "spkid": 1, "speed": 2.0,
                                      "emotion": np.asarray(emo, np.float32)}, remote):
            if "pcm" in msg:
                first_ms = first_ms or (time.perf_counter() - t0) * 1e3
                pcm += msg["pcm"]
        ms = (time.perf_counter() - t0) * 1e3
        if not pcm or not msg.get("final"):
            raise RuntimeError("the streamed server request returned no audio or no final dict")
        log(f"[servers] socket stream: {len(pcm) // 2} samples, first chunk {first_ms:.2f} ms, "
            f"whole {ms:.2f} ms (client side)")

        httpd = http_server.serve("127.0.0.1", 0, remote)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        import urllib.request
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/text2speech",
            data=json.dumps({"tex": texts[1], "per": 2, "spd": -12, "emo": emo}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
        ms = (time.perf_counter() - t0) * 1e3
        pcm = _pcm(body)
        log(f"[servers] HTTP gateway POST: {len(pcm)} samples, client latency {ms:.2f} ms")
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        srv.stop()
        _env(**saved)
    return launches


SAT_SPEAKERS = (10001, 10002)  # external ids; run_adapt reserves 1023 and 1022 for them
SAT_UTTS, SAT_SECONDS = 6, (2.0, 8.0)  # each speaker's synthetic 8 kHz utterances
SAT_STEPS = 4                  # adapt steps, one K2 launch each
SAT_TEXT_BUCKETS, SAT_FRAME_BUCKETS = (64, 128), (256, 512, 1024)  # the AOT export's
N_SAT_INT8 = 4                 # the clone's int8 requests after the calibration
N_AOT = 6                      # in-bucket requests, AOT against eager two-phase float
AOT_ROUNDS = 3                 # timed rounds of the N_AOT requests in both modes, in turns
# an AOT bucket against the eager two-phase float decode of the same request at
# the same padded shapes and noise: the same ops on the same weights, replayed
AOT_ATOL = 1e-4
SAT_WORDS = ("ni", "hao", "shi", "jie", "yu", "yin", "he", "cheng", "ke", "long", "a")


def write_sat_dir(sat_dir, seed):
    """The layout run_adapt reads, at configs/adapt.json's full width:
    seeded random pretrain/G_0.npz (the training synthesizer, weight norm)
    and D_0.npz (the multi-period discriminator), configs/adapt.json (the
    repo's, logging every step so that the step times can be read), and
    data/<spkid>/ with SAT_UTTS synthetic utterances at 8 kHz of SAT_SECONDS
    (a gliding tone in noise, written as write_corpus writes its wavs) and a
    transcript each, about one character per 6 frames. Returns the config."""
    from vits_tpu_torch.config import HParams, default_config_path
    from vits_tpu_torch.convert import params_to_jax
    from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.nn.core import init_weights
    from vits_tpu_torch.utils.audio import write_wav
    from vits_tpu_torch.utils.checkpoint import save_checkpoint

    with open(default_config_path("adapt")) as f:
        cfg = json.load(f)
    cfg["train"]["log_interval"] = 1
    for sub in ("configs", "pretrain"):
        os.makedirs(os.path.join(sat_dir, sub))
    with open(os.path.join(sat_dir, "configs", "adapt.json"), "w") as f:
        json.dump(cfg, f)
    hps = HParams(**cfg)
    gen = torch.Generator().manual_seed(seed)
    for name, model in (("G_0.npz", Synthesizer.from_hps(hps, train=True)),
                        ("D_0.npz", MultiPeriodDiscriminator(hps.model.use_spectral_norm))):
        init_weights(model, gen)
        save_checkpoint(os.path.join(sat_dir, "pretrain", name),
                        {"model": params_to_jax(model.state_dict())})
    rng = np.random.RandomState(seed)
    sr, hop = hps.data.sampling_rate, hps.data.hop_length
    for spk in SAT_SPEAKERS:
        d = os.path.join(sat_dir, "data", str(spk))
        os.makedirs(d)
        f0 = rng.uniform(90, 250)
        for u in range(SAT_UTTS):
            T = int(rng.uniform(*SAT_SECONDS) * sr)
            t = np.arange(T) / sr
            wav = 0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.05 * np.sin(np.pi * t))) \
                + 0.05 * rng.randn(T)
            write_wav(os.path.join(d, f"u{u}.wav"), wav.astype(np.float32), sr)
            n_chars = T // hop // 6
            text = " ".join(rng.choice(SAT_WORDS, n_chars))[:n_chars]
            with open(os.path.join(d, f"u{u}.txt"), "w") as f:
                f.write(text + "\n")
    return cfg


def _sat_requests(model, n, rng, dev, tokens, frames):
    """n (external spkid, text, (spkid, bank row), rate): the clone's two
    voices in turn with a row of their emotion banks, `tokens` text vectors
    (a range), the rate chosen so the request decodes about `frames` frames
    (a range)."""
    out = []
    targets = np.linspace(*frames, n).astype(int)
    rng.shuffle(targets)
    for i, target in enumerate(targets):
        ext = SAT_SPEAKERS[i % len(SAT_SPEAKERS)]
        sid = model.spkid_mapping[ext]
        bank = model._load_spk_emo_embed(sid)
        row = int(rng.randint(len(bank)))
        text = rng.randn(int(rng.randint(*tokens)), model.text_channels).astype(np.float32)
        with torch.inference_mode():
            _, _, logw, _ = model.synth.infer_p1(
                torch.from_numpy(text[None]).to(dev),
                torch.from_numpy(bank[row][None]).to(dev), torch.tensor([sid], device=dev))
        out.append((ext, text, (ext, row), target / float(torch.exp(logw.float()).sum())))
    return out


class _EagerPhases:
    """Stands in for an AOTBundle with the same buckets whose phases run
    eagerly: the eager two-phase decode at the bucket's padded shapes."""

    def __init__(self, bundle, synth):
        self.bundle, self.synth = bundle, synth
        self.pick_text_bucket = bundle.pick_text_bucket
        self.pick_frame_bucket = bundle.pick_frame_bucket

    def call_p1(self, t_bucket, x, x_mask, emo, sid):
        return self.synth.infer_p1(x, emo, sid, x_mask=x_mask)

    def call_p2(self, t_bucket, f_bucket, *args):
        return self.synth.infer_p2(*args)


def _k1_at(dev, shapes, gin, tag):
    """K1 at each chain shape against its plain version (chip_smoke's
    tolerance), with its device time from a CUDA graph, the plain version's
    and the bound. Returns the totals and the largest difference."""
    from vits_tpu_torch.nn import rb_chain
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 12)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "launches": 0}
    worst = 0.0
    for C, k, dil, M, v in shapes:
        qp, x, gs, valid = k1_case(dev, gen, C, k, dil, gin, [v], M)
        out = rb_chain.chain_q8_cuda(qp, x, gs, valid)
        ref = rb_chain.chain_q8_plain(qp, x, gs, valid)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err, peak = float(diff.max()), float(ref.abs().max())
        off = float((diff > 1e-3 * peak).float().mean())
        if not (torch.isfinite(out).all() and err <= 0.05 * max(1.0, peak) and off < 0.01):
            raise RuntimeError(f"{tag} K1 at C={C} k={k} M={M}: max_abs_err {err:.3e}, "
                               f"{100 * off:.3f}% off")
        worst = max(worst, err)
        p = rb_chain.plan(1, M, C, k, dil, n_sm)
        ms = graph_ms(lambda: rb_chain.chain_q8_cuda(qp, x, gs, valid))
        plain_ms = cuda_ms(lambda: rb_chain.chain_q8_plain(qp, x, gs, valid), iters=3, warmup=1)
        ops, nbytes = rb_chain.chain_ops_bytes(1, M, C, k, len(dil))
        bound = max(ops / INT8_PEAK, nbytes / HBM_BW) * 1e3
        log(f"{tag} K1 C={C:3d} k={k:2d} M={M:5d} valid={v}: {p.form} T={p.T} launches "
            f"{p.launches}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({'ops' if ops / INT8_PEAK > nbytes / HBM_BW else 'bytes'}; "
            f"{100 * bound / ms:.1f}% of it), max_abs_err {err:.3e}"
            f"{', bit-equal' if torch.equal(out, ref) else ''}")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        tot["launches"] += p.launches
        del qp, x, out, ref
    return tot, worst


def phase_sat(dev, workdir):
    """SAT voice cloning at configs/adapt.json's full width, then its
    deployment: `run_adapt` on the card in the config's bf16 (data prep,
    SAT_STEPS adapt steps from the seeded pretrained G_0/D_0, pruning, the
    greedy-soup export, spkid.map and the banks), every K2 launch held
    bit-exact against the plain search; `python -m vits_tpu_torch.export
    --convert 1` as a subprocess at a few buckets; the clone served by its
    external ids through EmoVITS(quantize=True) (N_CALIB calibration
    requests, then N_SAT_INT8 int8 ones, K1's launches = the plans, each
    correlating with its float decode), through EmoVITS(aot=True) (in-bucket
    requests against the eager two-phase float decode at the same shapes
    and noise, one request past the buckets, the latency of both in turns,
    the capture seconds of each bucket), and reloaded from a `.pth` written
    by save_torch_checkpoint; K1 timed at the 12 adapt-config chains of a
    CHAIN_FRAMES-frame request. Returns (K1 launches, K2 launches, K2's and
    K1's largest differences from their plain versions)."""
    import shutil

    import vits_tpu_torch.export as export_mod
    from vits_tpu_torch import sat as sat_mod
    from vits_tpu_torch.infer import EmoVITS
    from vits_tpu_torch.nn import rb_chain
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.train import loop
    from vits_tpu_torch.utils.checkpoint import read_checkpoint
    from vits_tpu_torch.utils.torch_compat import save_torch_checkpoint

    sat_dir, out = os.path.join(workdir, "sat"), os.path.join(workdir, "deploy")
    t0 = time.perf_counter()
    cfg = write_sat_dir(sat_dir, SEED + 5)
    m, d = cfg["model"], cfg["data"]
    log(f"[sat] configs/adapt.json at full width ({d['sampling_rate']} Hz, hop "
        f"{d['hop_length']}, upsampling {m['upsample_rates']}, gin {m['gin_channels']}, text "
        f"{d['text_channels']}, {d['n_speakers']} speakers, n_layers_q {m['n_layers_q']}, "
        f"batch {cfg['train']['batch_size']}, bf16_run {cfg['train']['bf16_run']}); pretrained "
        f"G_0/D_0 and {len(SAT_SPEAKERS)} x {SAT_UTTS} utterances of {SAT_SECONDS[0]}-"
        f"{SAT_SECONDS[1]} s written in {time.perf_counter() - t0:.1f} s")

    # run_adapt, its parts timed, every K2 launch recorded
    timed, seen, k2_calls = {}, [], []
    real = {"prep": sat_mod.prepare_speaker_data, "train": loop.run, "export": export_mod.main}
    kernel = mas.maximum_path_cuda

    def recording(neg, t_ys, t_xs):
        path = kernel(neg, t_ys, t_xs)
        k2_calls.append(tuple(t.to("cpu", non_blocking=True) for t in (neg, t_ys, t_xs, path)))
        return path

    def timing(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            start = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                timed[name] = timed.get(name, 0.0) + time.perf_counter() - start
        return call

    def train_logged(hps, **kw):
        return real["train"](hps, log_cb=lambda s, mt: seen.append((time.perf_counter(), s, mt)),
                             **kw)

    sat_mod.prepare_speaker_data = timing("prep", real["prep"])
    loop.run = timing("train", train_logged)
    export_mod.main = timing("export", real["export"])
    mas.maximum_path_cuda = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mas.counter.launches = 0                          # main path starts here
        start = time.perf_counter()
        mapping = sat_mod.run_adapt(sat_dir, out, max_steps=SAT_STEPS, device=dev)
        torch.cuda.synchronize()
        k2_launches = mas.counter.launches                # main path ends here
        wall = time.perf_counter() - start
    finally:
        sat_mod.prepare_speaker_data = real["prep"]
        loop.run = real["train"]
        export_mod.main = real["export"]
        mas.maximum_path_cuda = kernel
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want_map = {str(s): 1023 - i for i, s in enumerate(SAT_SPEAKERS)}
    bad = [(s, k) for _, s, mt in seen for k, v in mt.items() if not np.isfinite(v)]
    if mapping != want_map or k2_launches != SAT_STEPS or [s for _, s, _ in seen] != \
            list(range(1, SAT_STEPS + 1)) or bad:
        raise RuntimeError(f"run_adapt: mapping {mapping}, K2 launches {k2_launches}, logged "
                           f"steps {[s for _, s, _ in seen]}, non-finite {bad}")
    files = set(os.listdir(out))
    need = {"checkpoint.npz", "config.json", "spkid.map"} | \
        {f"{v}.emo" for v in mapping.values()} | {f"{k}.emo" for k in mapping}
    if need - files or any(not os.path.islink(os.path.join(out, f"{k}.emo")) for k in mapping):
        raise RuntimeError(f"run_adapt's output lacks {sorted(need - files)} or its links")
    window = [(b[0] - a[0]) * 1e3 / (b[1] - a[1]) for a, b in zip(seen, seen[1:])]
    for _, s, mt in seen:
        log(f"[sat] adapt step {s}: loss_g_total {mt['loss_g_total']:.4f}, loss_disc "
            f"{mt['loss_disc']:.4f}, loss_mel {mt['loss_mel']:.4f}, loss_dur "
            f"{mt['loss_dur']:.4f}")
    log(f"[sat] run_adapt on the card in {wall:.1f} s: data prep {timed['prep']:.1f} s, "
        f"training {timed['train']:.1f} s ({SAT_STEPS} steps, the build and the save "
        f"included; step ms by window after the first {[round(w, 1) for w in window]}, median "
        f"{np.median(window):.1f}), prune + greedy-soup export {timed['export']:.1f} s; K2 "
        f"launches {k2_launches}; peak memory {peak:.2f} GiB; mapping {mapping}; wrote "
        f"{sorted(files)}")
    mas_err = _run_mas_equal_plain(dev, k2_calls, k2_launches, "[sat]")
    del k2_calls
    torch.cuda.empty_cache()

    # the AOT export, as a user runs it
    ckpt = os.path.join(out, "checkpoint.npz")
    start = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vits_tpu_torch.export", "-o", out, "--checkpoint", ckpt,
         "--convert", "1", "--text-buckets", ",".join(map(str, SAT_TEXT_BUCKETS)),
         "--frame-buckets", ",".join(map(str, SAT_FRAME_BUCKETS)), "--device", "cuda",
         "--verbose", "0"], env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
        text=True, timeout=600)
    export_s = time.perf_counter() - start
    programs = sorted(f for f in os.listdir(out) if f.endswith(".pt2"))
    n_want = len(SAT_TEXT_BUCKETS) * (1 + len(SAT_FRAME_BUCKETS))
    if r.returncode != 0 or len(programs) != n_want:
        raise RuntimeError(f"the export exited {r.returncode} with {len(programs)} of {n_want} "
                           f"programs:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    sizes = [os.path.getsize(os.path.join(out, f)) for f in programs]
    log(f"[sat] `python -m vits_tpu_torch.export --convert 1 --device cuda` (text buckets "
        f"{SAT_TEXT_BUCKETS}, frame buckets {SAT_FRAME_BUCKETS}): exit 0 in {export_s:.1f} s, "
        f"{len(programs)} programs of {min(sizes) / 1e6:.2f}-{max(sizes) / 1e6:.2f} MB "
        f"(checkpoint.npz {os.path.getsize(ckpt) / 1e6:.1f} MB)")

    # the clone served in int8 by its external ids
    rng = np.random.RandomState(SEED + 12)
    model = EmoVITS(ckpt, device=str(dev), quantize=True)
    if {k: model.spkid_mapping.get(k) for k in SAT_SPEAKERS} != \
            {int(k): v for k, v in mapping.items()}:
        raise RuntimeError(f"the engine's speaker map {model.spkid_mapping} is not {mapping}")
    reqs = _sat_requests(model, N_CALIB + N_SAT_INT8, rng, dev, (40, 121), (250, 1000))
    hop = model.hop_size
    rb_chain.counter.launches = 0                       # main path starts here
    served = []
    for i, (spk, text, emo, rate) in enumerate(reqs):
        before = rb_chain.counter.launches
        np.random.seed(SEED + i)
        wav, _ = model._infer_two_phase(spk, text, emo, duration_rate=rate)
        served.append((wav, rb_chain.counter.launches - before))
    k1_launches = rb_chain.counter.launches             # main path ends here
    if model.dec_q8 is None:
        raise RuntimeError(f"the clone's int8 decoder failed its gate (corr {model.q8_corr})")
    dec_q8 = model.dec_q8
    for i, ((wav_q, launched), (spk, text, emo, rate)) in enumerate(zip(served, reqs)):
        frames = len(wav_q) // hop
        if len(wav_q) % hop or not np.all(np.isfinite(wav_q)):
            raise RuntimeError(f"[sat] request {i}: {len(wav_q)} samples, finite "
                               f"{np.all(np.isfinite(wav_q))}")
        if i < N_CALIB:
            continue
        want = k1_launches_per_decode(model.hps.model, frames, dev)
        model.dec_q8, model.quantize = None, False
        np.random.seed(SEED + i)
        wav_f, _ = model._infer_two_phase(spk, text, emo, duration_rate=rate)
        model.dec_q8, model.quantize = dec_q8, True
        corr = _corr(wav_q, wav_f)
        log(f"[sat] int8 request {i - N_CALIB}: speaker {spk} -> {model.spkid_mapping[spk]}, "
            f"bank row {emo[1]}, {len(text)} tokens, {frames} frames, K1 launches {launched} "
            f"(the plans: {want}), int8-vs-float corr {corr:.6f}")
        if launched != want or not corr >= MIN_REQUEST_CORR:
            raise RuntimeError(f"[sat] int8 request {i - N_CALIB}: K1 launches {launched} "
                               f"(want {want}), corr {corr:.6f} (min {MIN_REQUEST_CORR})")
    log(f"[sat] the clone in int8: gate corr {model.q8_corr:.6f} after {N_CALIB} calibration "
        f"requests, {N_SAT_INT8} int8 requests, K1 launches {k1_launches}")
    del model
    torch.cuda.empty_cache()

    # the AOT engine against eager two-phase float
    aot = EmoVITS(ckpt, device=str(dev), aot=True)
    eager = EmoVITS(ckpt, device=str(dev))
    bundle = aot.aot
    if bundle is None or bundle.text_buckets() != list(SAT_TEXT_BUCKETS) or any(
            bundle.frame_buckets(t) != list(SAT_FRAME_BUCKETS) for t in SAT_TEXT_BUCKETS):
        raise RuntimeError(f"the AOT engine found no bundle of the exported buckets in {out}")
    shadow = _EagerPhases(bundle, aot.synth)
    areqs = _sat_requests(aot, N_AOT, rng, dev, (20, 128), (150, 880))  # < 1024 frames
    worst = 0.0
    for i, (spk, text, emo, rate) in enumerate(areqs):
        np.random.seed(SEED + 100 + i)
        wav_a, _ = aot.infer(spk, text, emo, duration_rate=rate)
        aot.aot = shadow
        np.random.seed(SEED + 100 + i)
        wav_e, _ = aot._infer_two_phase(spk, text, emo, duration_rate=rate)
        aot.aot = bundle
        err = float(np.abs(wav_a - wav_e).max()) if len(wav_a) == len(wav_e) else float("inf")
        worst = max(worst, err)
        if not err <= AOT_ATOL:
            raise RuntimeError(f"[sat] AOT request {i}: {len(wav_a)} samples against "
                               f"{len(wav_e)}, max_abs_err {err:.3e} (atol {AOT_ATOL})")
    n_graphs = len(bundle.graphs)
    spk, text, emo, rate = areqs[0]
    long_text = np.concatenate([text] * (SAT_TEXT_BUCKETS[-1] // len(text) + 1))
    np.random.seed(SEED + 99)
    wav_a, _ = aot.infer(spk, long_text, emo, duration_rate=rate)
    np.random.seed(SEED + 99)
    wav_e, _ = eager._infer_two_phase(spk, long_text, emo, duration_rate=rate)
    err_long = float(np.abs(wav_a - wav_e).max()) if len(wav_a) == len(wav_e) else float("inf")
    if len(bundle.graphs) != n_graphs or not err_long <= AOT_ATOL:
        raise RuntimeError(f"[sat] the {len(long_text)}-token request: {len(bundle.graphs)} "
                           f"graphs (was {n_graphs}), max_abs_err {err_long:.3e} against eager")
    log(f"[sat] AOT: {N_AOT} in-bucket requests of {[len(r[1]) for r in areqs]} tokens equal "
        f"the eager two-phase float decode at the buckets' shapes (max_abs_err {worst:.3e}, "
        f"atol {AOT_ATOL}); a {len(long_text)}-token request past the text buckets went eager "
        f"(max_abs_err {err_long:.3e} against the eager engine, no new graph); "
        f"{n_graphs} bucket graphs captured: "
        + ", ".join(f"{'/'.join(map(str, k))} {v:.2f} s" for k, v in
                    sorted(bundle.capture_s.items())))
    lat = {"aot": [], "eager": []}
    for rnd in range(AOT_ROUNDS):
        for i, (spk, text, emo, rate) in enumerate(areqs):
            for mode, fn in (("aot", aot.infer), ("eager", eager._infer_two_phase)):
                np.random.seed(SEED + 100 + i)
                (_, _), ms = _timed_call(fn, spk, text, emo, duration_rate=rate)
                lat[mode].append(ms)
    a, e = np.array(lat["aot"]), np.array(lat["eager"])
    log(f"[sat] latency over {AOT_ROUNDS} rounds of the {N_AOT} requests in turns (fp32, "
        f"two-phase float): AOT mean {a.mean():.2f} ms median {np.median(a):.2f} ms; eager "
        f"mean {e.mean():.2f} ms median {np.median(e):.2f} ms; eager / AOT {e.mean() / a.mean():.2f}")

    # the deployment reloaded through a .pth
    pdir = os.path.join(workdir, "deploy_pth")
    os.makedirs(pdir)
    for fn in os.listdir(out):
        if fn.endswith((".json", ".map", ".emo")):
            shutil.copyfile(os.path.join(out, fn), os.path.join(pdir, fn))
    save_torch_checkpoint(os.path.join(pdir, "clone.pth"), read_checkpoint(ckpt)[0]["model"])
    pth = EmoVITS(os.path.join(pdir, "clone.pth"), device=str(dev))
    spk, text, emo, rate = areqs[1]
    np.random.seed(SEED + 7)
    wav_p, _ = pth._infer_two_phase(spk, text, emo, duration_rate=rate)
    np.random.seed(SEED + 7)
    wav_n, _ = eager._infer_two_phase(spk, text, emo, duration_rate=rate)
    err_pth = float(np.abs(wav_p - wav_n).max()) if len(wav_p) == len(wav_n) else float("inf")
    log(f"[sat] the deployment reloaded from save_torch_checkpoint's .pth "
        f"({os.path.getsize(os.path.join(pdir, 'clone.pth')) / 1e6:.1f} MB): {len(wav_p)} "
        f"samples, max_abs_err {err_pth:.3e} against the .npz")
    if not err_pth <= 1e-6:
        raise RuntimeError("the .pth deployment serves another waveform than the .npz")
    del aot, eager, pth
    torch.cuda.empty_cache()

    shapes, gin = k1_shapes("adapt")
    tot, k1_err = _k1_at(dev, shapes, gin, "[sat]")
    log(f"[sat] K1 at the 12 adapt-config chains of a {CHAIN_FRAMES}-frame request: kernel "
        f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
        f"({100 * tot['bound_ms'] / tot['ms']:.1f}% of it), {tot['launches']} launches")
    return k1_launches, k2_launches, mas_err, k1_err


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

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    seconds = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        log(f"[{name}] phase took {seconds[name]:.1f} s")
        return out

    phase("build", phase_build)
    rows, worst, tot = phase("kernels", phase_kernels, dev)
    _, worst16, tot16 = phase("kernels_bf16", phase_kernels, dev, torch.bfloat16)
    mas_rows, mas_err = phase("mas", phase_mas, dev)
    with tempfile.TemporaryDirectory() as workdir:
        launches, lat, audio_s, model, reqs, ckpt = phase("serving", phase_serving, dev, workdir)
        if launches <= 0:
            raise RuntimeError("the serving path launched K1 no time")
        fused_launches, _ = phase("fused", phase_fused, dev, model, ckpt)
        if fused_launches <= 0:
            raise RuntimeError("the fused int8 path launched K1 no time")
        phase("stream", phase_stream, dev, model, reqs[N_CALIB])
        bf16_launches, _ = phase("bf16", phase_bf16, dev, model, ckpt)
        if bf16_launches <= 0:
            raise RuntimeError("the bf16 int8 paths launched K1's bf16 form no time")
        del model
        torch.cuda.empty_cache()
        server_launches = phase("servers", phase_servers, dev, ckpt)
    mas_launches, mel_med, _, _ = phase("training", phase_training, dev)
    if mas_launches <= 0:
        raise RuntimeError("the training path launched K2 no time")
    torch.cuda.empty_cache()
    stft_launches, _, _, _ = phase("training_stft", phase_training, dev, "stft", mel_med)
    if stft_launches <= 0:
        raise RuntimeError("the stft training path launched K2 no time")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        run_launches, run_mas_err = phase("run", phase_run, dev, workdir)
        torch.cuda.empty_cache()
        run_stft_launches, run_stft_mas_err = phase("run_stft", phase_run, dev, workdir,
                                                    "stft")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        sat_k1, sat_k2, sat_mas_err, sat_k1_err = phase("sat", phase_sat, dev, workdir)
    if sat_k1 <= 0 or sat_k2 <= 0:
        raise RuntimeError(f"the SAT path launched K1 {sat_k1} and K2 {sat_k2} times")
    card = card_line()
    main = mas_rows[0]  # the shape the training step gives K2
    kernels = {"kernels": [{
        "name": "rb2_chain_q8",
        "route": "cuda",
        "source": "vits_tpu_torch/csrc/rb_chain_q8.cu",
        "replaces": "vits_tpu/nn/pallas_rb.py:96",
        "launches": launches + fused_launches + server_launches + sat_k1,
        "max_abs_err": max(worst, sat_k1_err),
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["ops_s"] >= tot["bytes_s"] else "bytes",
        "library_ms": None,
    }, {
        "name": "rb2_chain_q8_bf16",
        "route": "cuda",
        "source": "vits_tpu_torch/csrc/rb_chain_q8.cu",
        "replaces": "vits_tpu/nn/pallas_rb.py:96",
        "launches": bf16_launches,
        "max_abs_err": worst16,
        "ms": tot16["ms"],
        "plain_ms": tot16["plain_ms"],
        "bound_ms": tot16["bound_ms"],
        "bound_by": "operations" if tot16["ops_s"] >= tot16["bytes_s"] else "bytes",
        "library_ms": None,
    }, {
        "name": "mas",
        "route": "cuda",
        "source": "vits_tpu_torch/csrc/mas.cu",
        "replaces": "vits_tpu/ops/mas.py:130",
        "launches": mas_launches + stft_launches + run_launches + run_stft_launches + sat_k2,
        "max_abs_err": max(mas_err, run_mas_err, run_stft_mas_err, sat_mas_err),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s; K1 launches on the main paths: "
        f"serving {launches}, fused {fused_launches}, servers {server_launches}, sat "
        f"{sat_k1}, bf16 form {bf16_launches}; K2 launches: training {mas_launches}, "
        f"training_stft {stft_launches}, run {run_launches}, run_stft {run_stft_launches}, "
        f"sat {sat_k2}; phases: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
