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
     glue     - the float decoder's glue kernels (`csrc/dec_glue.cu`: the
                gate and the epilogue) against their plain twins at every
                use the packed decoder body makes, at every stage shape of
                the base and VCTK decoders over 960 latent frames (B = 2,
                one utterance valid for 923 frames; T and a ragged T - 1),
                within 1e-6; each use's kernel ms (device time, from a CUDA
                graph of 20 calls), plain ms and bytes bound, and one
                decode's glue (each use times its count);
  3. serving  - write a seeded random base-config checkpoint at full width,
                serve it two-phase (`_infer_two_phase`) with
                EmoVITS(device="cuda", quantize=True): 8 calibration
                requests (float decodes, each through the packed body: one
                decode's glue launches), then int8 requests whose every
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
                request equal the plans and the glue's per fused float one a
                decode's, K1's last chain over the request's
                frames in whole quanta, not the frame budget, fused int8
                against fused float; one fused float request held against
                a CPU copy of the model; one request with a clipped budget
                through the two-phase retry;
  5. stream   - one request through `infer_stream` against the two-phase
                float output (atol 1e-4), each window one packed decode's
                glue launches; time to the first chunk and to the whole
                utterance;
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
                through `protocol.synthesize` (K1 must launch on each, the
                glue kernels on the float decodes before), one
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
                float in turns, the buckets captured; the
                deployment reloaded from save_torch_checkpoint's .pth, the
                same waveform; K1 at the 12 adapt chains of a 256-frame
                request, its time against its bound;
     ddp      - data-parallel training (parallel/dist.py): 2 ranks started
                by `python -m torch.distributed.run --nproc_per_node 2
                chip_smoke.py --ddp-rank job.json` (NCCL where there is a card
                a rank, else gloo with both ranks on cuda:0). The 2-rank step
                at 2 x 8 (T_x 96, 400 frames, rank 0's utterances long, rank
                1's short) against the float64 step of one process on the 16
                together (models, inputs and `TrainStepConfig.compute_dtype`
                in float64), same weights and noise: in float64, with cuDNN
                and without, summed losses and every summed gradient within
                1e-9 relative, MAS paths equal; in fp32 without cuDNN, summed
                losses within 1e-3, MAS paths equal, every summed gradient
                within 1e-5 + 1e-3 of its largest magnitude.
                Then the training CLI's calls on each rank
                (base config, full width, -d, batch 32 a rank) for 4 steps in
                fp32 and 4 in the configured bf16 over a synthetic corpus of
                one bucket: the ranks' parameter sha256 equal, rank 0 alone
                saving and evaluating, K2 once a step on each rank and
                bit-exact; step ms, gradient all-reduce ms (CUDA events
                around the step's three reductions), global audio-s/s and
                peak memory per rank. Then the bf16 run's G/D/P_4.npz
                resumed by a 1-process loop.run for one step;
 10. onnx     - the ONNX export at the base config's full width: `python -m
                vits_tpu_torch.export --convert 2 --device cuda` as a
                subprocess on a seeded training checkpoint (the deployable
                checkpoint.npz, .pt2 programs at one bucket pair, and
                model_p1.onnx / model_p2.onnx traced at 48 x 384): its seconds
                by part (trace, decompositions, conversion, write); both files
                checked structurally (sizes, node counts, the op histogram);
                model_p1.onnx evaluated by the port's runtime on the card at
                text lengths 48, 17 and 160 and model_p2.onnx at (48, 384),
                each against the eager infer_p1 / infer_p2 in fp32 with TF32
                off (atol 2e-4, rtol 2e-3), the ms of each;
     options  - the base config with resblock "1" and act_func_d "swish" at
                full width: one two-phase float request in fp32 and in bf16 in
                turns with the ResBlock2 model of [onnx] (latency of each), a
                decode on the card against the CPU and bf16 against fp32 on the
                same latent, quantize_decoder refused; 1 + 3 fp32 training
                steps with -d (B 16, T_x 96, 400 frames), K2 once a step, every
                launch bit-exact against the plain search, the step ms; its
                ONNX export at (32, 128) checked and evaluated as [onnx]'s;
 11. tp       - tensor parallelism and the graft entry points: (a) the
                base config's decoder split over 2 ranks started by `python
                -m torch.distributed.run --nproc_per_node 2 chip_smoke.py
                --tp-rank job.json` (`parallel/mesh.py`: the 57 kernels of
                JAX's rule at min_channels 128; gloo with both ranks on
                cuda:0, NCCL with a card a rank), seeded weight-normed
                weights folded and sliced by `make_tp_infer`: infer_p2 at
                (T_x 48, T_y 384) and (125, 1000) against the one-process
                infer_p2 on the card in fp32 with TF32 off (atol 2e-4, rtol
                2e-3), the ranks' outputs equal, each rank's decoder
                parameters (8,667,072 of the training tree in the JAX layout;
                8,647,520 of the folded decoder it serves from, whose split
                layers' biases are sliced too) and bytes, the memory the rank
                holds on the card (its synthesizer and nothing more:
                make_tp_infer replaces the whole decoder), the sharded p2's
                ms against the one-process p2's and the gathers' ms by CUDA
                events; (b)
                `graft_entry.dryrun_multichip(2)` (TINY data-parallel mel and
                stft steps and a tensor-parallel decode on 2 ranks); (c)
                `graft_entry.entry()` once (the base config's training
                forward at B 2, T_x 48, T_y 192); every K2 launch of (b) and
                (c) bit-exact against the plain search;
 12. card     - print the card's name and power limit.
The training phases also print each precision's useful TFLOP/s
(utils/flops.train_step_flops) and its share of the card's dense peak at
that precision (`mfu`: bf16 989.4, TF32 494.7 TFLOP/s, H100 SXM).
Each phase prints the seconds it took. K1's launches in the kernels line are
those of the serving, fused, server and sat phases, each read with the
counter set to 0 just before the path runs and read just after; its bf16
form's those of the bf16 phase, and K2's those of both precisions' training
steps of both variants, of both runs and their resumes, of both ranks' runs
and the resume in the ddp phase, of the adapt run, of the options
model's training steps, and of the dry-run and entry() in the tp phase.
The glue kernels' are those of the serving, fused and servers phases, read
the same way; their times are one base decode's at 960 frames.
The line before the card line is one JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}. Needs CUDA; with no GPU it
exits 2 and prints no result.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
INT8_PEAK = 1979e12   # H100 SXM dense int8 ops/s (NVIDIA data sheet)
# H100 SXM dense FLOP/s (NVIDIA data sheet): the training step's `mfu`
# divides its useful FLOP/s (utils/flops.py) by the peak of its precision
BF16_PEAK, TF32_PEAK, FP32_PEAK = 989.4e12, 494.7e12, 66.9e12
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
GLUE_FRAMES = 960     # the glue check's latent frames: the mean serve-b1 request's pad
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
    """Device time of one fn() call: `iters` calls captured in a CUDA graph
    (`serve/graphs.py::Graph`, after a warm-up on its side stream), the graph
    replayed and timed with CUDA events, so the host's launch cost (Python,
    ctypes) is not in the number. fn runs once first, outside."""
    from vits_tpu_torch.serve.graphs import Graph
    fn()
    graph = Graph(lambda _: [fn() for _ in range(iters)], [torch.zeros(1, device="cuda")])
    graph.capture(torch.cuda.graph_pool_handle(), warmups=1)
    graph.graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.graph.replay()
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
    # the batch case; and each chain over the longest fused budget, a long
    # masked tail (valid = a 700-frame request's samples, M the budget's)
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


def glue_launches_per_decode(m) -> int:
    """The glue launches of one decode through the packed float body:
    conv_pre's and conv_post's epilogues, and each stage's upsample
    epilogue and every dilation step's gate and residual epilogue."""
    steps = sum(len(d) for d in m.resblock_dilation_sizes)
    return 2 + len(m.upsample_rates) * (1 + 2 * steps)


def glue_uses(m, frames: int):
    """Each use the packed body makes of the glue kernels in one decode of
    `frames` latent frames, at its shape: (stage, C, T, vmul, name, count,
    kind, kwargs), kind "gate" (kwargs: glu) or "epilogue" (kwargs: the
    wrapper's, with x / acc / out_v as True where the use passes one).
    Stage 0 is conv_pre's output; conv_post's tanh is (1, T) at the last
    stage. The counts sum to `glue_launches_per_decode`."""
    nk, nd = len(m.resblock_kernel_sizes), len(m.resblock_dilation_sizes[0])
    uic, n = m.upsample_initial_channel, len(m.upsample_rates)
    uses = [(0, uic, frames, 1, "conv_pre", 1, "epilogue",
             dict(bias=True, act="lrelu", want_v=False, want_a=True))]
    vmul = 1
    for i, u in enumerate(m.upsample_rates):
        vmul *= u
        st = (i + 1, uic // 2 ** (i + 1), frames * vmul, vmul)
        slope = 0.1 if i < n - 1 else 0.01
        uses += [
            (*st, "upsample", 1, "epilogue", dict(bias=True, act="lrelu", want_a=True)),
            (*st, "gate", nk * nd, "gate", dict(glu=str(m.resblock) != "1")),
            (*st, "residual", nk * (nd - 1), "epilogue",
             dict(bias=True, x=True, act="lrelu", want_a=True, out_v="x")),
            (*st, "sum_first", 1, "epilogue", dict(bias=True, x=True)),
            (*st, "sum", nk - 2, "epilogue", dict(bias=True, x=True, acc=True, out_v="acc")),
            (*st, "mean", 1, "epilogue", dict(bias=True, x=True, acc=True, div=float(nk),
                                              act="lrelu", slope=slope, want_v=False,
                                              want_a=True))]
    uses.append((n, 1, frames * vmul, vmul, "post", 1, "epilogue",
                 dict(act="tanh", want_v=False, want_a=True, masked=False)))
    return [u for u in uses if u[5] > 0]


def phase_glue(dev):
    """The float decoder's glue kernels (`nn/dec_glue.py`) against their
    plain twins at every use the packed body makes, at every stage shape of
    the base (ResBlock2: the GLU gate) and VCTK (ResBlock1: tanh) decoders
    over GLUE_FRAMES latent frames: B = 2 with the first utterance valid for
    GLUE_FRAMES - 37 frames, at T and at a ragged T - 1 (the scalar path),
    within 1e-6; then each use at B = 1, every frame valid, timed from a
    CUDA graph of 20 calls against its bytes at 3.35 TB/s (each input read
    and each output written once: `dec_glue.counter.bytes`, exact where
    every frame is valid; the first stage's operands, 8 MB each, stay in
    the 50 MB L2 across the graph's calls and may beat it). Returns
    {config: one decode's glue kernel ms, plain ms and bound ms, each use's
    time times its count}, the launches and the largest difference from a
    twin."""
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.nn import dec_glue as dg

    def call(kind, kw, c, x, acc, s, valid, vmul, plain=False):
        if kind == "gate":
            fn = dg.gate_plain if plain else dg.gate
            return (fn(c, s, valid, vmul, kw["glu"]),)
        args = dict(kw)
        masked = args.pop("masked", True)
        args.update(bias=s if args.get("bias") else None, x=x if args.get("x") else None,
                    acc=acc if args.get("acc") else None, valid=valid if masked else None,
                    vmul=vmul)
        out_v = {"x": x, "acc": acc, None: None}[args.pop("out_v", None)]
        if plain:
            return dg.epilogue_plain(c, **args)
        return dg.epilogue(c, out_v=out_v, **args)

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def operands(B, C, t, kind, has_s):
        """c, x, acc (B, C, t) and s: a gate's (B, C), a column slice of a
        wider matrix as the packed body passes it, or an epilogue's bias."""
        s = (randn(B, 3 * C)[:, C:2 * C] if kind == "gate" else randn(C)) if has_s else None
        return randn(B, C, t), randn(B, C, t), randn(B, C, t), s

    with open(os.path.join(ROOT, "benchmark", "configs", "vctk.json")) as f:
        vctk = SimpleNamespace(**json.load(f)["model"])
    res, worst, launches0 = {}, 0.0, dg.counter.launches
    for config in ("base", "vctk"):
        m = vctk if config == "vctk" else get_hparams_from_file(default_config_path(config)).model
        uses = glue_uses(m, GLUE_FRAMES)
        if sum(u[5] for u in uses) != glue_launches_per_decode(m):
            raise RuntimeError(f"[glue] {config}: the uses' counts do not sum to a decode's")
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        for stage, C, T, vmul, name, count, kind, kw in uses:
            has_s = kind == "gate" or bool(kw.get("bias"))
            # the check: B = 2, valid < pad, at T and a ragged T - 1
            valid = torch.tensor([GLUE_FRAMES - 37, GLUE_FRAMES], dtype=torch.int32, device=dev)
            for t in (T, T - 1):
                c, x, acc, s = operands(2, C, t, kind, has_s)
                ref = call(kind, kw, c, x, acc, s, valid, vmul, plain=True)
                got = call(kind, kw, c, x.clone(), acc.clone(), s, valid, vmul)
                torch.cuda.synchronize()
                for g_, r_ in zip(got, ref):
                    if (g_ is None) != (r_ is None):
                        raise RuntimeError(f"[glue] {config} {name}: outputs differ in kind")
                    if g_ is None:
                        continue
                    err = float((g_ - r_).abs().max())
                    worst = max(worst, err)
                    if not torch.allclose(g_, r_, rtol=1e-6, atol=1e-6):
                        raise RuntimeError(f"[glue] {config} stage {stage} {name} C {C} T {t}: "
                                           f"max_abs_err {err:.3e} against the twin (1e-6)")
            # the time: B = 1, every frame valid (the counter's bytes are exact)
            valid = torch.tensor([GLUE_FRAMES], dtype=torch.int32, device=dev)
            c, x, acc, s = operands(1, C, T, kind, has_s)
            before = dg.counter.bytes
            call(kind, kw, c, x, acc, s, valid, vmul)
            nbytes = dg.counter.bytes - before
            ms = graph_ms(lambda: call(kind, kw, c, x, acc, s, valid, vmul))
            plain_ms = cuda_ms(lambda: call(kind, kw, c, x, acc, s, valid, vmul, plain=True),
                               iters=3, warmup=1)
            bound = nbytes / HBM_BW * 1e3
            log(f"[glue] {config} stage {stage} {name:9s} x{count:2d} C {C:3d} T {T:6d}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes; "
                f"{100 * bound / ms:.1f}% of it)")
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * bound
            del c, x, acc, s
        torch.cuda.empty_cache()
        res[config] = tot
        log(f"[glue] {config}: every use at every stage shape agrees with its twin; one "
            f"{GLUE_FRAMES}-frame decode's {glue_launches_per_decode(m)} glue launches: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({100 * tot['bound_ms'] / tot['ms']:.1f}% of it)")
    return res, dg.counter.launches - launches0, worst


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
    from vits_tpu_torch.utils.flops import train_step_flops

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
    useful = train_step_flops(synth, disc, TrainStepConfig.from_hps(hps, variant=variant),
                              B, T_x, T_y)
    card = card_line()
    for name, peak, prec in (("fp32", TF32_PEAK, "TF32"), ("bf16", BF16_PEAK, "bf16")):
        rate = useful / (med[name] / 1e3)
        log(f"{tag} {name}: useful work {useful / 1e12:.4f} TFLOP a step "
            f"(utils/flops.train_step_flops at B {B}, T_x {T_x}, T_y {T_y}), "
            f"{rate / 1e12:.2f} TFLOP/s, mfu {100 * rate / peak:.2f}% of the dense {prec} "
            f"peak {peak / 1e12:.1f} TFLOP/s (H100 SXM, NVIDIA data sheet; {card})"
            + ("" if name == "bf16" else
               f"; TF32 is off in this run, so also {100 * rate / FP32_PEAK:.2f}% of the "
               f"{FP32_PEAK / 1e12:.1f} TFLOP/s FP32 peak"))
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


def _k2_calls_exact(dev, calls, launches):
    """Recorded K2 launches (inputs and paths on the host) against the plain
    search on the same inputs: each path bit-exact, one path step a frame.
    Returns (the largest difference, {shape: inputs})."""
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
    return err, shapes


def _run_mas_equal_plain(dev, calls, launches, tag="[run]") -> float:
    """The run's K2 launches against the plain search (`_k2_calls_exact`),
    then each distinct shape's plan and device time. Launches made here are
    outside the main path's count. Returns the largest difference."""
    from vits_tpu_torch.ops import mas
    err, shapes = _k2_calls_exact(dev, calls, launches)
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
    k2_calls = []  # each K2 launch of the runs: its inputs and its path, copied to the host

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
    try:
        with mas.recorded(k2_calls):
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
                raise RuntimeError(f"the resume ended at step {steps} (state {state['step']}) "
                                   f"with {launches} K2 launches; expected step "
                                   f"{RUN_STEPS + RUN_RESUME}, {RUN_RESUME} launches")
            log(f"{tag} resumed at step {RUN_STEPS}, ended at {steps} in {wall:.1f} s (build, "
                f"load and save included), K2 launches {launches}; step {seen_r[-1][1]} "
                f"loss_g_total {seen_r[-1][2]['loss_g_total']:.4f}, loss_disc_p "
                f"{seen_r[-1][2]['loss_disc_p']:.4f}; save {timed['save_all'][-1]:.2f} s")
    finally:
        for k, fn in real.items():
            setattr(loop, k, fn)
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


DDP_RANKS = 2            # the [ddp] phase's ranks: one a card over NCCL, or sharing one over gloo
DDP_STEPS = 4            # each run's steps: one batch a rank an epoch, DDP_STEPS epochs
DDP_SECONDS = (3.7, 4.7)  # 308-391 frames: every utterance in the (300, 400] bucket
DDP_CMP_B = 8            # the step comparison: DDP_RANKS x 8 against one process on 16
DDP_TIMEOUT = 600        # the torchrun launch's seconds
# The step comparison's reference is the 1-process step on the global batch in
# float64 (models, step and inputs; MAS on neg_cent rounded to f32, as the
# kernel takes it), with cuDNN and without. The N-rank float64 step must
# take it within 1e-9 relative, with cuDNN and without: every summed loss,
# and every summed gradient within 1e-9 of its largest magnitude; float64
# leaves the summation order ~1e-16, so a rank split that changed the
# function shows far above it. The N-rank float32 step without cuDNN must
# take it within the float32 tolerance: the summed losses within LOSS_RTOL,
# the paths equal, every summed gradient within 1e-5 + 1e-3 of its largest
# magnitude. A float32 1-process step is no reference: at 4 ranks it stood
# 2.672 of that tolerance from float64 where the ranks stood 0.484, and with
# cuDNN both float32 sides stood 2.2-3.8 from it (its backward algorithms),
# so float32 with cuDNN is not compared (4 and 1 x NVIDIA H100 80GB HBM3,
# 700 W).
DDP_F64_RTOL = 1e-9
DDP_REF_RUNS = (("fp64", False), ("fp64", True))  # (precision, cuDNN): one process
DDP_CMP_RUNS = (("fp32", False),) + DDP_REF_RUNS  # the ranks'


def _ddp_compare_lengths(world: int):
    """(text lengths, frame lengths) of the step comparison's batch for
    `world` ranks: the even ranks' utterances long (text 89-96, 365-400
    frames at T_x 96, T_y 400), the odd ranks' short (49-56, 201-250)."""
    i = np.arange(DDP_CMP_B)
    long_, short = (TRAIN_TX - i, TRAIN_TY - 5 * i), (TRAIN_TX * 7 // 12 - i,
                                                      TRAIN_TY * 5 // 8 - 7 * i)
    ranks = [short if r % 2 else long_ for r in range(world)]
    return tuple(np.concatenate([r[j] for r in ranks]).astype(np.int32) for j in (0, 1))


def _ddp_compare_inputs(hps, world: int):
    """The step comparison's global batch (numpy seed 1) of `world` x
    DDP_CMP_B utterances at (T_x TRAIN_TX, TRAIN_TY frames), spec shipped,
    with `_ddp_compare_lengths`, and its noise (torch seed SEED), on the
    host."""
    B, T_x, T_y = world * DDP_CMP_B, TRAIN_TX, TRAIN_TY
    rng = np.random.RandomState(1)
    x_lengths, spec_lengths = _ddp_compare_lengths(world)
    b = {
        "x": rng.randn(B, T_x, hps.data.text_channels).astype(np.float32),
        "x_lengths": x_lengths,
        "spec": np.abs(rng.randn(B, T_y, hps.data.filter_length // 2 + 1)).astype(np.float32),
        "spec_lengths": spec_lengths,
        "wav": rng.uniform(-0.5, 0.5, (B, T_y * hps.data.hop_length)).astype(np.float32),
        "emo": rng.randn(B, 1024).astype(np.float32),
        "sid": rng.randint(0, hps.data.n_speakers, B).astype(np.int64),
    }
    gen = torch.Generator().manual_seed(SEED)
    c = hps.model.inter_channels
    noise = {"post": torch.randn(B, T_y, c, generator=gen),
             "mas": torch.randn(B, T_y, T_x, generator=gen),
             "slice": torch.rand(B, generator=gen),
             "fwd": torch.randn(B, T_y, c, generator=gen)}
    return {k: torch.from_numpy(v) for k, v in b.items()}, noise


def _ddp_compare_steps(dev, world, group, rank, runs):
    """The base config's mel step at full width from the seeded weights
    (dropout off: eval mode, so both sides run one function) on the
    comparison's batch and noise for `world` ranks: rank `rank`'s part with
    `group`, or all of it with None; each of `runs`, (precision, cuDNN),
    from a copy of the same state: fp32, or fp64 (the models, the inputs and
    `TrainStepConfig.compute_dtype`), with cuDNN or without (PyTorch's own
    convolutions). Returns {(precision, cudnn): (metrics, {model: {name:
    gradient}}, K2's path)}, the losses summed over the ranks."""
    import dataclasses
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.parallel import dist
    from vits_tpu_torch.train.loop import build_models, build_optimizers, init_state
    from vits_tpu_torch.train.step import TrainStepConfig, make_train_step
    hps = get_hparams_from_file(default_config_path("base"))
    synth, disc, _ = build_models(hps)
    gen_opt, disc_opt, _ = build_optimizers(hps)
    state0 = init_state(hps, synth, disc, None, gen_opt, disc_opt, None, seed=SEED, device=dev)
    state0["gen"].eval()
    state0["disc"].eval()
    state0["rng"] = None
    dist.broadcast_state(state0, group)
    batch, noise = _ddp_compare_inputs(hps, world)
    parts = dist.world_size(group)
    batch, noise = ({k: v.chunk(parts)[rank].to(dev) for k, v in d.items()}
                    for d in (batch, noise))
    cfg = TrainStepConfig.from_hps(hps, torch.float32)
    steps = {"fp32": make_train_step(cfg, group),
             "fp64": make_train_step(dataclasses.replace(cfg, compute_dtype=torch.float64),
                                     group)}
    lr = hps.train.learning_rate
    out = {}
    for prec, cudnn in runs:
        state = copy.deepcopy(state0)
        b, n = batch, noise
        if prec == "fp64":
            for key in ("gen", "disc"):
                state[key].double()
            b, n = ({k: v.double() if v.is_floating_point() else v for k, v in d.items()}
                    for d in (batch, noise))
        calls = []
        with mas.recorded(calls), torch.backends.cudnn.flags(enabled=cudnn,
                                                             allow_tf32=False):
            _, m = steps[prec](state, b, n, lr, lr, 0.01)
        shares = dist.allreduce_metrics({k: v for k, v in m.items() if k.startswith("loss")},
                                        group)
        grads = {key: {n: p.grad.detach().cpu() for n, p in state[key].named_parameters()}
                 for key in ("gen", "disc")}
        torch.cuda.synchronize()
        out[(prec, cudnn)] = ({k: float(v) for k, v in {**m, **shares}.items() if v.ndim == 0},
                              grads, calls[0][3])
        del state, b, n
        torch.cuda.empty_cache()
    return out


def _grad_ratios(grads, ref_g, f32_tol: bool) -> dict:
    """{model.name: max|g - ref| over the tolerance unit}: 1e-5 + 1e-3
    max|ref| (the float32 check's), or max|ref| (the float64 check's; a
    zero gradient must then be matched exactly)."""
    out = {}
    for key, named in grads.items():
        for name, g in named.items():
            ref = ref_g[key][name].double()
            diff = float((g.double() - ref).abs().max())
            unit = (1e-5 + 1e-3 * float(ref.abs().max())) if f32_tol else float(ref.abs().max())
            out[f"{key}.{name}"] = diff / unit if unit else (0.0 if diff == 0 else float("inf"))
    return out


def _ddp_compare_rank(info, ref_path) -> dict:
    """This rank's side of the comparison: each N-rank step of DDP_CMP_RUNS
    against the 1-process fp64 step saved at `ref_path` with cuDNN as it
    ran: the summed losses within LOSS_RTOL (fp32) or DDP_F64_RTOL (fp64)
    relative, this rank's MAS path equal to its part of the 1-process path,
    and every summed gradient within 1e-5 + 1e-3 (fp32) or DDP_F64_RTOL
    (fp64) of the reference tensor's largest magnitude. Every run is
    compared before a miss raises, and the error states them all."""
    runs = _ddp_compare_steps(info.device, info.world, info.group, info.rank, DDP_CMP_RUNS)
    ref = torch.load(ref_path)
    res, misses = {}, []
    for (prec, cudnn), (metrics, grads, path) in runs.items():
        ref_m, ref_g, ref_path_all = ref[("fp64", cudnn)]
        f32 = prec == "fp32"
        rtol, atol = (LOSS_RTOL, LOSS_ATOL) if f32 else (DDP_F64_RTOL, 0.0)
        rel = {k: abs(metrics[k] - v) / max(abs(v), atol / rtol)
               for k, v in ref_m.items() if k in LOSS_KEYS["mel"]}
        bad = [k for k, r in rel.items() if r > rtol]
        differ = int((path != ref_path_all.chunk(info.world)[info.rank]).sum())
        ratios = _grad_ratios(grads, ref_g, f32)
        worst = max(ratios, key=ratios.get)
        bound = 1.0 if f32 else DDP_F64_RTOL
        name = prec + ("_cudnn" if cudnn else "")
        if bad or differ or ratios[worst] > bound:
            misses.append(f"{name}: losses {bad} ({ {k: rel[k] for k in bad} }), {differ} path "
                          f"cells, worst gradient {worst} at {ratios[worst]:.3e} of its "
                          f"tolerance (bound {bound})")
        k = max(rel, key=rel.get)
        res[name] = {"loss_rel": rel[k], "loss_worst": k, "path_cells": int(path.sum()),
                     "grad_ratio": ratios[worst], "grad_worst": worst, "grads": len(ratios),
                     "over_1": sum(r > 1.0 for r in ratios.values())}
    if misses:
        summary = "; ".join(f"{n}: worst gradient {e['grad_worst']} at {e['grad_ratio']:.3e}"
                            for n, e in res.items())
        raise RuntimeError(f"rank {info.rank}: the {info.world}-rank step differs from the "
                           f"1-process fp64 step: {' | '.join(misses)}. All runs: {summary}")
    return res


def ddp_rank(job_path: str) -> int:
    """One rank of the [ddp] phase, as torchrun starts it (`chip_smoke.py
    --ddp-rank job.json`): the process group from torchrun's environment
    (`parallel.dist.init_distributed`, the backend by its rule), the step
    comparison, then each training run of the job through the training CLI's
    own calls (`get_hparams(argv)`, `loop.run(hps, device=hps.device)`, as
    `python -m vits_tpu_torch.train` makes them), with K2's launches
    recorded, the three gradient reductions of each step timed with CUDA
    events, the loop's save and eval calls counted; then every K2 launch
    held bit-exact against the plain search. Writes this rank's numbers."""
    with open(job_path) as f:
        job = json.load(f)
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from vits_tpu_torch.config import get_hparams
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.parallel import dist
    from vits_tpu_torch.train import loop

    info = dist.init_distributed("cuda")
    out = {"rank": info.rank, "world": info.world, "backend": info.backend,
           "device": str(info.device), "compare": _ddp_compare_rank(info, job["reference"]),
           "runs": []}
    reductions, calls, counts = [], [], {"save_all": 0, "evaluate": 0}
    real_reduce = dist.allreduce_grads

    def timed_reduce(params, group):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        real_reduce(params, group)
        ev[1].record()
        reductions.append(ev)

    def counted(name):
        real = getattr(loop, name)

        def call(*a, **k):
            counts[name] += 1
            return real(*a, **k)
        return call

    dist.allreduce_grads = timed_reduce
    for name in counts:
        setattr(loop, name, counted(name))
    with mas.recorded(calls):
        for argv in job["runs"]:
            hps = get_hparams(argv)
            seen = []
            reductions.clear()
            calls.clear()
            counts.update(save_all=0, evaluate=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mas.counter.launches = 0                          # main path starts here
            state, steps = loop.run(hps, variant="mel", device=hps.device,
                                    log_cb=lambda s, m: seen.append((time.perf_counter(), s, m)))
            torch.cuda.synchronize()
            launches = mas.counter.launches                   # main path ends here
            err, _ = _k2_calls_exact(info.device, calls, launches)
            per_step = len(reductions) // steps
            reduce_ms = [sum(a.elapsed_time(b) for a, b in reductions[i:i + per_step])
                         for i in range(0, len(reductions), per_step)]
            out["runs"].append({
                "name": argv[1], "steps": steps, "launches": launches, "k2_err": err,
                "digest": dist.state_digest(state), "counts": dict(counts),
                "step_ms": [(b[0] - a[0]) * 1e3 / (b[1] - a[1]) for a, b in zip(seen, seen[1:])],
                "reductions_per_step": per_step, "reduce_ms": reduce_ms,
                "audio_s_per_s": [m["audio_sec_per_s"] for _, _, m in seen[1:]],
                "losses": {k: v for k, v in seen[-1][2].items() if k.startswith("loss")},
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
            del state
            torch.cuda.empty_cache()
    dist.shutdown()
    with open(job["out"].format(rank=info.rank), "w") as f:
        json.dump(out, f)
    return 0


def _run_group(cmd, timeout, **kw):
    """subprocess.run in a session of its own, the whole group killed if it
    outlives `timeout`, so that no rank outlives the phase."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True, **kw)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, stdout, stderr


def phase_ddp(dev, workdir):
    """Data-parallel training on the card (`parallel/dist.py`): DDP_RANKS
    ranks by `python -m torch.distributed.run --nproc_per_node DDP_RANKS
    chip_smoke.py --ddp-rank` (`ddp_rank`), NCCL where the host has a card a
    rank, else gloo with the ranks sharing cuda:0. First the N-rank steps
    of DDP_CMP_RUNS at N x DDP_CMP_B against the 1-process fp64 step on the
    concatenated batch (same weights and noise parts, unequal lengths across
    ranks; `_ddp_compare_rank`); then the base config at full width with -d, batch 32 a rank, for DDP_STEPS steps
    in fp32 and then in the configured bf16 over a synthetic corpus of one
    bucket: each rank's digest equal, rank 0 alone saving and evaluating,
    every K2 launch bit-exact, step ms, reduction ms, audio-s/s and peak
    memory per rank; then the bf16 run's checkpoints resumed by a
    1-process `loop.run` for one step. Returns K2's launches on the main
    paths (both ranks' runs and the resume) and the largest difference."""
    from vits_tpu_torch.config import HParams, default_config_path, get_hparams_from_dir
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.train import loop

    card = card_line()
    with open(default_config_path("base")) as f:
        cfg = json.load(f)
    batch = cfg["train"]["batch_size"]
    t0 = time.perf_counter()
    n = DDP_RANKS * batch
    lines = write_corpus(workdir, HParams(**cfg), n + 2, DDP_SECONDS, SEED + 2, "d")
    scp = {}
    for name, part in (("train", lines[:n]), ("valid", lines[n:])):
        scp[name] = os.path.join(workdir, f"{name}.scp")
        with open(scp[name], "w") as f:
            f.write("\n".join(part))
    cfg["data"].update(training_files=scp["train"], validation_files=scp["valid"])
    cfg["train"].update(epochs=DDP_STEPS, log_interval=1, eval_interval=DDP_STEPS)
    runs = []
    for name, bf16 in (("ddp_fp32", False), ("ddp_bf16", cfg["train"]["bf16_run"])):
        c = copy.deepcopy(cfg)
        c["train"]["bf16_run"] = bf16
        path = os.path.join(workdir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(c, f)
        runs.append(["-m", name, "-d", "-c", path])
    ref_path = os.path.join(workdir, "reference.pt")
    torch.save(_ddp_compare_steps(dev, DDP_RANKS, None, 0, DDP_REF_RUNS), ref_path)
    torch.cuda.empty_cache()
    job = os.path.join(workdir, "job.json")
    with open(job, "w") as f:
        json.dump({"reference": ref_path, "runs": runs,
                   "out": os.path.join(workdir, "rank{rank}.json")}, f)
    log(f"[ddp] corpus of {DDP_RANKS * batch} utterances of {DDP_SECONDS[0]}-"
        f"{DDP_SECONDS[1]} s (one bucket, one batch of {batch} a rank an epoch) and the "
        f"1-process reference step ready in {time.perf_counter() - t0:.1f} s")

    start = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "4"}
    rc, stdout, stderr = _run_group(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(DDP_RANKS), os.path.join(ROOT, "chip_smoke.py"), "--ddp-rank", job],
        DDP_TIMEOUT, cwd=workdir, env=env)
    launch_s = time.perf_counter() - start
    if rc != 0:
        ranks_said = "\n".join(ln for ln in stderr.splitlines() if ln.startswith("[rank"))
        raise RuntimeError(f"torchrun exited {rc}:\n{stdout[-3000:]}\n{ranks_said[-6000:]}\n"
                           f"{stderr[-2000:]}")
    ranks = []
    for r in range(DDP_RANKS):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    backend = [ln for ln in stdout.splitlines() if ln.startswith("backend ")]
    log(f"[ddp] `python -m torch.distributed.run --nproc_per_node {DDP_RANKS}` exit 0 in "
        f"{launch_s:.1f} s ({torch.cuda.device_count()} card(s): {backend[0] if backend else '?'}"
        f"; rank devices {[r['device'] for r in ranks]})")
    xl, yl = (v.reshape(DDP_RANKS, -1) for v in _ddp_compare_lengths(DDP_RANKS))
    lengths = "; ".join(f"rank {r}'s text {xl[r].min()}-{xl[r].max()}, {yl[r].min()}-"
                        f"{yl[r].max()} frames" for r in range(DDP_RANKS))
    for prec, cudnn in DDP_CMP_RUNS:
        name = prec + ("_cudnn" if cudnn else "")
        c0, f32 = ranks[0]["compare"][name], prec == "fp32"
        log(f"[ddp] {prec} step of {DDP_RANKS} x {DDP_CMP_B} (T_x {TRAIN_TX}, {TRAIN_TY} frames; "
            f"{lengths}) {'with cuDNN' if cudnn else 'without cuDNN'} against the fp64 step of "
            f"one process on the {DDP_RANKS * DDP_CMP_B} together, same weights and noise: "
            f"losses within {c0['loss_rel']:.2e} relative ({c0['loss_worst']}; tol "
            f"{LOSS_RTOL if f32 else DDP_F64_RTOL:.0e}), MAS paths equal on every rank "
            f"({[r['compare'][name]['path_cells'] for r in ranks]} cells), {c0['grads']} summed "
            f"gradients within {c0['grad_ratio']:.3e} of "
            f"{'1e-5 + 1e-3 max|g| (bound 1)' if f32 else f'max|g| (bound {DDP_F64_RTOL:.0e})'}"
            f" (worst {c0['grad_worst']})")

    launches, err = 0, 0.0
    scale = ("not a scaling figure: the ranks share one card over gloo"
             if ranks[0]["backend"] == "gloo" and torch.cuda.device_count() < DDP_RANKS
             else f"{DDP_RANKS} cards over {ranks[0]['backend']}")
    for i, argv in enumerate(runs):
        name = argv[1]
        rr = [r["runs"][i] for r in ranks]
        digests = {r["digest"] for r in rr}
        if len(digests) != 1 or any(r["steps"] != DDP_STEPS for r in rr):
            raise RuntimeError(f"{name}: rank digests {digests}, steps {[r['steps'] for r in rr]}")
        if any(r["launches"] != DDP_STEPS for r in rr):
            raise RuntimeError(f"{name}: K2 launched {[r['launches'] for r in rr]} times on the "
                               f"ranks, expected {DDP_STEPS} each")
        if rr[0]["counts"] != {"save_all": 1, "evaluate": 1} or \
                any(r["counts"] != {"save_all": 0, "evaluate": 0} for r in rr[1:]):
            raise RuntimeError(f"{name}: save and eval calls by rank {[r['counts'] for r in rr]}")
        run_dir = os.path.join(workdir, "logs", name)
        npz = sorted(f for f in os.listdir(run_dir) if f.endswith(".npz"))
        if npz != [f"{p}_{DDP_STEPS}.npz" for p in "DGP"]:
            raise RuntimeError(f"{name}: checkpoints {npz}")
        if any(not np.isfinite(v) for r in rr for v in r["losses"].values()):
            raise RuntimeError(f"{name}: non-finite losses {rr[0]['losses']}")
        launches += sum(r["launches"] for r in rr)
        err = max([err] + [r["k2_err"] for r in rr])
        log(f"[ddp] {name}: {DDP_RANKS} ranks x batch {batch} (global {DDP_RANKS * batch}), "
            f"{DDP_STEPS} steps, parameter sha256 equal on every rank "
            f"({next(iter(digests))[:16]}...), rank 0 alone saved ({', '.join(npz)}) and "
            f"evaluated, K2 launches {[r['launches'] for r in rr]} bit-exact; last step "
            f"loss_g_total {rr[0]['losses']['loss_g_total']:.4f}, loss_disc "
            f"{rr[0]['losses']['loss_disc']:.4f}")
        for r, rank in zip(rr, ranks):
            log(f"[ddp] {name} rank {rank['rank']} on {rank['device']} ({card}): step ms "
                f"{[round(v, 1) for v in r['step_ms']]} (median "
                f"{float(np.median(r['step_ms'])):.1f}), gradient all-reduce ms a step "
                f"({r['reductions_per_step']} reductions) {[round(v, 2) for v in r['reduce_ms']]}"
                f" (median of steps 2-{DDP_STEPS} {float(np.median(r['reduce_ms'][1:])):.2f}), "
                f"global audio-s/s {float(np.median(r['audio_s_per_s'])):.1f}, peak memory "
                f"{r['peak_gib']:.2f} GiB; {scale}")

    # the bf16 run's checkpoints (rank 0's) resumed in one process for a step
    hps = get_hparams_from_dir(os.path.join(workdir, "logs", runs[-1][1]))
    hps.use_dur_dis = True
    with mas.recorded([]) as calls:
        torch.cuda.synchronize()
        mas.counter.launches = 0                          # main path starts here
        state, steps = loop.run(hps, max_steps=DDP_STEPS + 1, device=dev)
        torch.cuda.synchronize()
        resumed = mas.counter.launches                    # main path ends here
    err = max(err, _k2_calls_exact(dev, calls, resumed)[0])
    with open(os.path.join(hps.model_dir, "train.log")) as f:
        log_text = f.read()
    if steps != DDP_STEPS + 1 or resumed != 1 or "Resumed P from" not in log_text:
        raise RuntimeError(f"the 1-process resume ended at step {steps} with {resumed} K2 "
                           f"launches")
    log(f"[ddp] {runs[-1][1]}'s G/D/P_{DDP_STEPS}.npz resumed by a 1-process loop.run for one "
        f"step (step {steps}, K2 launches {resumed}, bit-exact)")
    del state
    return launches + resumed, err


def _write_checkpoint(dirpath, hps_dict, dev_gen_seed, train: bool = False):
    """A seeded random checkpoint.npz and its config.json in `dirpath`: the
    serving tree (weight norm folded, no posterior encoder), or with `train`
    the training tree a trainer's G_*.npz holds."""
    from vits_tpu_torch.config import HParams
    from vits_tpu_torch.convert import params_to_jax
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.nn.core import init_weights
    from vits_tpu_torch.utils.checkpoint import save_checkpoint

    synth = Synthesizer.from_hps(HParams(**hps_dict), train=train)
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
    from vits_tpu_torch.nn import dec_glue, rb_chain

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
    glue_want = glue_launches_per_decode(model.hps.model)
    rb_chain.counter.launches = dec_glue.counter.launches = 0  # main path starts here
    per_request = []
    for i, (spk, text, emo, rate) in enumerate(reqs):
        before = rb_chain.counter.launches, dec_glue.counter.launches
        np.random.seed(SEED + i)
        t0 = time.perf_counter()
        wav, _ = model._infer_two_phase(spk, text, emo, duration_rate=rate)
        ms = (time.perf_counter() - t0) * 1e3
        launched = rb_chain.counter.launches - before[0]
        glued = dec_glue.counter.launches - before[1]
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
        # the float decodes take the packed body (the calibration's own
        # decode, with its record, the eager one): a calibration request's
        # served decode, the freezing request's gate decode, no int8 one
        if glued != (0 if kind == "int8" else glue_want):
            raise RuntimeError(f"request {i} ({kind}): the glue kernels launched {glued} "
                               f"times, expected {0 if kind == 'int8' else glue_want}")
        per_request.append((i, kind, frames, launched, ms, len(wav) / sr, wav))
        if kind != "freeze":
            lat[kind].append(ms)
            audio_s[kind] += len(wav) / sr
    main_launches = rb_chain.counter.launches  # main path ends here
    glue_launches = dec_glue.counter.launches
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
    log(f"[serving] glue launches {glue_launches}: {glue_want} a float decode, none an int8 one")
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
    return main_launches, glue_launches, lat, audio_s, model, reqs, ckpt


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
    the plans, its last chain over the request's frame bucket as two-phase's
    (the decoder runs over the frames in whole quanta, not over the budget),
    none in fused float; fused int8 against fused float. Then one
    fused float request on the card against a CPU copy of the model, and one
    request whose clipped budget sends it through the two-phase retry."""
    from vits_tpu_torch.infer import EmoVITS
    from vits_tpu_torch.nn import dec_glue, rb_chain

    m, hop, sr = model.hps.model, model.hop_size, model.sampling_rate
    up = int(np.prod(m.upsample_rates))     # samples per frame at the last stage
    reqs = _requests(model, N_FUSED, np.random.RandomState(SEED + 1), dev)
    modes = ("two-phase int8", "fused float", "fused int8")
    lat = {mode: [] for mode in modes}
    audio_s, lengths = 0.0, []
    saved = _env(VITS_TPU_FUSED_Q8=None, VITS_TPU_FUSED_FRAMES_PER_TOKEN=None)
    glue_want = glue_launches_per_decode(m)
    rb_chain.counter.launches = dec_glue.counter.launches = 0  # main path starts here
    # one untimed round of the first request in each mode: the fused pass's
    # text-encoder shapes are new to this process; the decoders' change with
    # every request's frame bucket, as they do in service
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
            before = rb_chain.counter.launches, dec_glue.counter.launches
            rb_chain.counter.last = None
            np.random.seed(SEED + 200 + i)
            (wav, _), ms = _timed_call(fn, spk, text, emo, duration_rate=rate)
            out[mode] = (wav, ms, rb_chain.counter.launches - before[0], rb_chain.counter.last)
            lat[mode].append(ms)
            glued = dec_glue.counter.launches - before[1]
            if glued != (glue_want if mode == "fused float" else 0):
                raise RuntimeError(f"fused phase, request {i}, {mode}: the glue kernels "
                                   f"launched {glued} times (a float decode makes {glue_want})")
        frames = len(out["two-phase int8"][0]) // hop
        lengths.append(frames * hop)
        audio_s += frames * hop / sr
        if frames >= budget:
            raise RuntimeError(f"fused phase, request {i}: {frames} frames fill the budget "
                               f"{budget}; the two-phase retry served it, not the fused pass")
        want_2p = want_fused = k1_launches_per_decode(m, frames, dev)
        # the last chain's M is the decoded frames', the frame bucket's in
        # both paths; its valid is the request's
        want_m = dict.fromkeys(("two-phase int8", "fused int8"),
                               model._quantize(frames, model.frame_quantum) * up)
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
    glue_launches = dec_glue.counter.launches
    log(f"[fused] glue launches {glue_launches}: {glue_want} a fused float request, none an "
        f"int8 one")
    for mode in modes:
        v = np.array(lat[mode])
        log(f"[fused] {mode:14s}: {len(v)} requests, latency mean {v.mean():.2f} ms median "
            f"{np.median(v):.2f} ms, {audio_s / (v.sum() / 1e3):.1f} audio-s/s")

    # one fused float request on the card against a CPU copy of the model:
    # 64 tokens at the rate that gives about 128 frames, to keep the CPU's
    # decode short
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
    # no decode in the fused pass (its frame count fills the budget), then
    # the two-phase one
    want = k1_launches_per_decode(m, lengths[0] // hop, dev)
    if len(wav) != lengths[0] or budget * hop > len(wav) or retry_launches != want:
        raise RuntimeError(f"the two-phase retry gave {len(wav)} samples, two-phase "
                           f"{lengths[0]} (budget {budget} frames), K1 launches "
                           f"{retry_launches}, expected {want}")
    log(f"[fused] budget clipped to {budget} frames: the two-phase retry served "
        f"{len(wav) // hop} frames, as two-phase does, in {ms:.2f} ms (the fused pass's "
        f"durations, then two-phase int8), K1 launches {retry_launches}")
    return launches, glue_launches, lat


def phase_stream(dev, model, req):
    """One full-width request through `infer_stream` (float decoder,
    windows of the frame quantum with a 24-frame halo) against the two-phase
    float output of the same request: the concatenation within 1e-4 (cuDNN
    may pick other algorithms per window); each window decoded through the
    packed body, as the two-phase output is (the glue kernels' launches of
    one decode a window). The request streams twice: cold
    (the first use of the windows' shapes in this process) and warm. Prints
    the time to the first chunk and to the whole utterance of each."""
    from vits_tpu_torch.nn import dec_glue
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
        glue0 = dec_glue.counter.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for chunk in model.infer_stream(spk, text, emo, duration_rate=rate):
            if not chunks:
                first_ms = (time.perf_counter() - t0) * 1e3
            chunks.append(chunk)
        total_ms = (time.perf_counter() - t0) * 1e3
        glued = dec_glue.counter.launches - glue0
        if glued != len(chunks) * glue_launches_per_decode(model.hps.model):
            raise RuntimeError(f"[stream] {len(chunks)} windows launched the glue kernels "
                               f"{glued} times, not once a decode each")
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
    int8 modes, as many times as the plans of the decoder's chains, its last
    launch over the frames' bucket with the request's frames valid; int8
    against float above
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
                  "bf16 fused int8": (model._quantize(frames_f, model.frame_quantum) * up,
                                      frames_f * up)}
        for mode, (wav, ms, l32, l16, last) in out.items():
            n = n_of[mode]
            if len(wav) != n * hop or not np.all(np.isfinite(wav)) or np.abs(wav).max() > 1.0:
                raise RuntimeError(f"bf16 phase, request {i}, {mode}: {len(wav)} samples "
                                   f"(expected {n * hop}), or a value not finite or past 1")
            want32 = k1_launches_per_decode(m, frames32, dev) if mode.startswith("fp32") else 0
            want16 = {"bf16 two-phase int8": k1_launches_per_decode(m, frames, dev),
                      "bf16 fused int8": k1_launches_per_decode(m, frames_f, dev)}.get(mode, 0)
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
    from vits_tpu_torch.nn import dec_glue, rb_chain
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
        # and last launch (an int8 request decodes over its frames in whole
        # quanta, not over the budget)
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
        glue_want = glue_launches_per_decode(m)
        rb_chain.counter.launches = dec_glue.counter.launches = 0  # main path starts here
        int8_launches = []
        for i, text in enumerate(texts):
            frozen = speecher.dec_q8 is not None
            before = rb_chain.counter.launches
            glue0 = dec_glue.counter.launches
            n_passes = len(passes)
            t0 = time.perf_counter()
            out = synthesize({"text": text, "spkid": i + 1, "speed": 2.0,
                              "emotion": np.asarray(emo, np.float32)}, remote)
            ms = (time.perf_counter() - t0) * 1e3
            launched = rb_chain.counter.launches - before
            glued = dec_glue.counter.launches - glue0
            if out is None:
                raise RuntimeError(f"server request {i}: no reply")
            pcm = _pcm(out["wav"])
            kind = "int8" if frozen else "freeze" if speecher.dec_q8 is not None else "calib"
            # the packed float body serves a calibration request and the
            # freezing request's gate; an int8 request decodes no float
            if glued != (0 if kind == "int8" else glue_want):
                raise RuntimeError(f"server request {i} ({kind}): the glue kernels launched "
                                   f"{glued} times, expected {0 if kind == 'int8' else glue_want}")
            note = ""
            if kind == "int8":
                # one fused int8 pass: the plans' launches, the last chain over
                # the frames in whole quanta with the request's frames valid
                if len(passes) != n_passes + 1:
                    raise RuntimeError(f"server request {i}: {len(passes) - n_passes} fused "
                                       f"passes, expected 1")
                budget, frames, pass_launches, last = passes[-1]
                y_pad = speecher._quantize(frames, speecher.frame_quantum)
                want = k1_launches_per_decode(m, frames, dev)
                if frames >= budget or launched != want or pass_launches != want or \
                        last is None or last[0] != y_pad * up or int(last[1][0]) != frames * up:
                    raise RuntimeError(
                        f"server request {i}: {frames} frames in a {budget}-frame budget, K1 "
                        f"launched {launched} times, expected {want}; its last launch M "
                        f"{last and last[0]}, valid {last and int(last[1][0])}, expected "
                        f"{y_pad * up}, {frames * up}")
                int8_launches.append(launched)
                note = (f" (the plans over {y_pad} of the {budget}-frame budget; {frames} "
                        f"frames valid)")
            log(f"[servers] socket request {i} ({kind}): {len(text)} characters, "
                f"{len(pcm) / out['sr']:.3f} audio s, client latency {ms:.2f} ms, frontend "
                f"{out['time_used_frontend']:.2f} ms, backend {out['time_used_backend']:.2f} ms, "
                f"K1 launches {launched}, glue launches {glued}{note}")
        launches = rb_chain.counter.launches  # main path ends here
        glue_launches = dec_glue.counter.launches
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
    return launches, glue_launches


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
    the buckets captured), and reloaded from a `.pth` written
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
    try:
        with mas.recorded(k2_calls):
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
        + ", ".join("/".join(map(str, k)) for k in sorted(bundle.graphs)))
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


ONNX_TX, ONNX_TY = 48, 384     # [onnx]: the export CLI's traced (t_x, t_y), its defaults
ONNX_LENGTHS = (48, 17, 160)   # ... p1 evaluated at the traced text length and two others
ONNX_ATOL, ONNX_RTOL = 2e-4, 2e-3  # tests/test_onnx.py's tolerance for the JAX package's files
OPT_ONNX = (32, 128)           # [options]: its export at a smaller (t_x, t_y)
OPT_LENGTHS = (32, 11)
OPT_STEPS = 3                  # [options]: fp32 -d steps timed after one warm-up
OPT_ROUNDS = 3                 # ... request rounds in turns over its four engines
OPT_FRAMES = 600               # ... the requests' frame count


def _runtime_ms(data, inputs, dev):
    """The port's ONNX runtime on the card: (outputs on the host, ms of the
    first call (parse and upload included), ms of a second)."""
    from vits_tpu_torch.onnx import runtime
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runtime.run_model(data, inputs, dev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {k: v.cpu().numpy() for k, v in out.items()}, ms[0], ms[1]


def _onnx_err(out, ref, what) -> float:
    """The largest |out - ref| over the outputs; raises where one lies
    outside atol ONNX_ATOL + rtol ONNX_RTOL or has another shape."""
    worst = 0.0
    for k, r in ref.items():
        o = out[k]
        if o.shape != r.shape or not np.all(np.abs(o - r) <= ONNX_ATOL + ONNX_RTOL * np.abs(r)):
            raise RuntimeError(f"{what}: {k} {o.shape} against {r.shape}, max_abs_err "
                               f"{float(np.abs(o - r).max()) if o.shape == r.shape else 'n/a'}")
        worst = max(worst, float(np.abs(o - r).max()))
    return worst


def onnx_check_and_eval(dev, synth, paths, lengths, t_x, t_y, tag):
    """Both files checked structurally (`python -m vits_tpu_torch.onnx`'s
    check), then evaluated by the port's runtime on the card: p1 at each
    text length of `lengths`, p2 at (t_x, t_y) on p1's eager outputs,
    against the eager `infer_p1` / `infer_p2` of `synth` in fp32 (TF32 off).
    Returns {file: (MB, nodes)} and [(what, first ms, ms, eager ms, err)]."""
    from vits_tpu_torch.onnx import proto
    from vits_tpu_torch.onnx.__main__ import check_model
    from vits_tpu_torch.ops.seq import infer_path
    files, sizes = {}, {}
    for name, path in zip(("p1", "p2"), paths):
        with open(path, "rb") as f:
            files[name] = f.read()
        m = proto.parse_model(files[name])
        problems = check_model(m)
        if problems or m["opset"] != 17:
            raise RuntimeError(f"{tag} {path}: opset {m['opset']}, problems {problems[:5]}")
        ops = {}
        for n in m["graph"]["node"]:
            ops[n["op_type"]] = ops.get(n["op_type"], 0) + 1
        sizes[name] = (len(files[name]) / 1e6, len(m["graph"]["node"]))
        log(f"{tag} {os.path.basename(path)}: {sizes[name][0]:.2f} MB, {sizes[name][1]} nodes, "
            f"{len(m['graph']['initializer'])} initializers, opset {m['opset']}, structure OK; "
            f"inputs {[(vi['name'], vi['shape']) for vi in m['graph']['input']]}; ops "
            + ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])))
    rng = np.random.RandomState(SEED + 40)
    tc, n_spk = synth.enc_p.emb["0"].in_features, synth.emb_g.weight.shape[0]
    evals, p1_at = [], {}
    for t in lengths:
        inp = {"input_text": rng.randn(1, t, tc).astype(np.float32),
               "input_emo": rng.randn(1, 1024).astype(np.float32),
               "input_g": np.array([rng.randint(n_spk)], np.int64)}
        out, first, ms = _runtime_ms(files["p1"], inp, dev)
        args = [torch.from_numpy(v).to(dev) for v in inp.values()]
        with torch.no_grad():
            (m_p, s_p, logw, g), eager = _timed_call(synth.infer_p1, *args)
        p1_at[t] = (m_p, s_p, g)
        ref = {"output_m_p": m_p.transpose(1, 2), "output_s_p": s_p.transpose(1, 2),
               "output_logw": logw.transpose(1, 2), "output_g": g}
        err = _onnx_err(out, {k: v.cpu().numpy() for k, v in ref.items()}, f"{tag} p1 T={t}")
        evals.append((f"p1 at text length {t}{' (traced)' if t == t_x else ''}", first, ms,
                      eager, err))
    m_p, s_p, g = p1_at[t_x] if t_x in p1_at else p1_at[lengths[0]]
    dur = torch.full((1, t_x), float(t_y // t_x), device=dev)
    dur[0, :t_y % t_x] += 1
    attn = infer_path(dur, t_y)
    noise = torch.from_numpy(0.667 * rng.randn(1, t_y, synth.inter_channels)
                             .astype(np.float32)).to(dev)
    inp = {"input_attn": attn.cpu().numpy(), "input_m_p": m_p.transpose(1, 2).cpu().numpy(),
           "input_s_p": s_p.transpose(1, 2).cpu().numpy(), "input_g": g.cpu().numpy(),
           "input_noise": noise.transpose(1, 2).cpu().numpy()}
    out, first, ms = _runtime_ms(files["p2"], inp, dev)
    with torch.no_grad():
        wav, eager = _timed_call(synth.infer_p2, attn, m_p, s_p, g, noise)
    err = _onnx_err(out, {"output_wav": wav.transpose(1, 2).cpu().numpy()}, f"{tag} p2")
    evals.append((f"p2 at ({t_x}, {t_y})", first, ms, eager, err))
    for what, first, ms, eager, err in evals:
        log(f"{tag} {what}: the port's runtime on the card {ms:.2f} ms (first call, parse "
            f"and upload included, {first:.2f} ms), eager {eager:.2f} ms; max_abs_err "
            f"{err:.3e} (atol {ONNX_ATOL}, rtol {ONNX_RTOL})")
    return sizes, evals


_EXPORT_LINE = (r"part(\d) to onnx: \[(.*?)\] \(trace ([\d.]+) s, decompositions ([\d.]+) s, "
                r"conversion ([\d.]+) s, write ([\d.]+) s\)")


def phase_onnx(dev, workdir):
    """The ONNX export at configs/base.json's full width: `python -m
    vits_tpu_torch.export --convert 2` as a subprocess on a seeded training
    checkpoint (its deployable checkpoint.npz, the .pt2 programs at one text
    and one frame bucket, and model_p1.onnx / model_p2.onnx traced at
    ONNX_TX x ONNX_TY), its seconds by part, then `onnx_check_and_eval`: p1
    at ONNX_LENGTHS and p2 against the eager phases of the exported
    checkpoint on the card. Returns that checkpoint, the sizes and the
    evaluations."""
    import re

    from vits_tpu_torch.config import get_hparams_from_file
    from vits_tpu_torch.convert import params_from_jax
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.utils.checkpoint import read_checkpoint

    with open(os.path.join(ROOT, "configs", "base.json")) as f:
        cfg = json.load(f)
    src, out = os.path.join(workdir, "onnx_src"), os.path.join(workdir, "onnx_out")
    os.makedirs(src)
    ckpt = _write_checkpoint(src, cfg, SEED + 30, train=True)
    start = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vits_tpu_torch.export", "-o", out, "--checkpoint", ckpt,
         "--convert", "2", "--text-buckets", "64", "--frame-buckets", "256",
         "--onnx-tx", str(ONNX_TX), "--onnx-ty", str(ONNX_TY), "--device", "cuda"],
        env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True, text=True, timeout=600)
    export_s = time.perf_counter() - start
    parts = re.findall(_EXPORT_LINE, r.stdout)
    paths = [os.path.join(out, f"model_p{i}.onnx") for i in (1, 2)]
    if r.returncode != 0 or len(parts) != 2 or not all(map(os.path.exists, paths)):
        raise RuntimeError(f"the export exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                           f"{r.stderr[-3000:]}")
    pt2 = sorted(f for f in os.listdir(out) if f.endswith(".pt2"))
    log(f"[onnx] `python -m vits_tpu_torch.export --convert 2 --device cuda` on the base "
        f"config's seeded training checkpoint: exit 0 in {export_s:.1f} s (the process, the "
        f"load and the .pt2 programs {pt2} included); "
        + "; ".join(f"model_p{p}.onnx: trace {float(a):.2f} s, decompositions {float(b):.2f} "
                    f"s, conversion {float(c):.2f} s, write {float(w):.2f} s"
                    for p, _, a, b, c, w in parts))
    ckpt = os.path.join(out, "checkpoint.npz")
    hps = get_hparams_from_file(os.path.join(out, "config.json"))
    synth = params_from_jax(read_checkpoint(ckpt)[0]["model"],
                            Synthesizer.from_hps(hps)).to(dev).eval()
    sizes, evals = onnx_check_and_eval(dev, synth, paths, ONNX_LENGTHS, ONNX_TX, ONNX_TY,
                                       "[onnx]")
    del synth
    torch.cuda.empty_cache()
    return ckpt, sizes, evals


def _rate_for(model, spk, text, emo, frames, dev) -> float:
    """The duration rate that gives `model` about `frames` frames for the
    request (sum(ceil(w * rate)) lies in [frames, frames + tokens])."""
    with torch.inference_mode():
        _, _, logw, _ = model.synth.infer_p1(
            torch.from_numpy(text[None]).to(dev, model.compute_dtype),
            torch.from_numpy(emo[None]).to(dev, model.compute_dtype),
            torch.tensor([spk], device=dev))
    return frames / float(torch.exp(logw.float()).sum())


def phase_options(dev, workdir, rb2_ckpt):
    """The model options at configs/base.json's full width: `resblock: "1"`
    (kernels 3/7/11, dilations 1/3/5) and `act_func_d: "swish"`. A seeded
    serving checkpoint served two-phase float by EmoVITS in fp32 and in
    bf16, the ResBlock2 model of [onnx] (`rb2_ckpt`) in both precisions in
    turns with it (OPT_ROUNDS rounds after an untimed one), one decode held
    against a CPU copy and one bf16 decode against fp32 on the same latent;
    its int8 quantization refused; OPT_STEPS + 1 fp32 training steps with -d
    (B 16, T_x 96, 400 frames), K2 once a step, every launch bit-exact
    against the plain search; its ONNX export at OPT_ONNX checked and
    evaluated on the card as [onnx]'s. Returns (K2 launches, K2's largest
    difference, the ONNX evaluations)."""
    from vits_tpu_torch.config import HParams
    from vits_tpu_torch.infer import EmoVITS
    from vits_tpu_torch.models.modules import ResBlock1
    from vits_tpu_torch.onnx import export_onnx
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.ops.seq import infer_path
    from vits_tpu_torch.train.loop import build_models, build_optimizers, build_step, init_state

    with open(os.path.join(ROOT, "configs", "base.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(resblock="1", act_func_d="swish")
    src = os.path.join(workdir, "options_src")
    os.makedirs(src)
    ckpt = _write_checkpoint(src, cfg, SEED + 31)
    engines = {}
    for dtype in ("fp32", "bf16"):
        engines[f"ResBlock1 {dtype}"] = EmoVITS(ckpt, device=str(dev), compute_dtype=dtype)
        engines[f"ResBlock2 {dtype}"] = EmoVITS(rb2_ckpt, device=str(dev), compute_dtype=dtype)
    rb1 = engines["ResBlock1 fp32"].synth
    if not all(isinstance(b, ResBlock1) for b in rb1.dec.resblocks.values()) or \
            not hasattr(rb1.dp, "act_2"):
        raise RuntimeError("the options model is not a ResBlock1 + Swish synthesizer")
    rng = np.random.RandomState(SEED + 32)
    n_tok = 120
    text = rng.randn(n_tok, rb1.enc_p.emb["0"].in_features).astype(np.float32)
    emo = rng.randn(1024).astype(np.float32)
    spk = int(rng.randint(0, rb1.emb_g.weight.shape[0]))
    rates = {k: _rate_for(e, spk, text, emo, OPT_FRAMES, dev) for k, e in engines.items()}
    lat = {k: [] for k in engines}
    frames = {}
    for rnd in range(OPT_ROUNDS + 1):
        for k, e in engines.items():
            np.random.seed(SEED + 33)
            (wav, _), ms = _timed_call(e._infer_two_phase, spk, text, emo,
                                       duration_rate=rates[k])
            if len(wav) % e.hop_size or not np.all(np.isfinite(wav)):
                raise RuntimeError(f"[options] {k}: {len(wav)} samples, finite "
                                   f"{np.all(np.isfinite(wav))}")
            frames[k] = len(wav) // e.hop_size
            if rnd:
                lat[k].append(ms)
    m = cfg["model"]
    log(f"[options] base config with resblock \"1\" (kernels {m['resblock_kernel_sizes']}, "
        f"dilations {m['resblock_dilation_sizes']}) and act_func_d \"swish\" at full width; "
        f"one {n_tok}-token request of ~{OPT_FRAMES} frames, two-phase float, {OPT_ROUNDS} "
        f"rounds in turns after an untimed one: "
        + ", ".join(f"{k} median {np.median(v):.2f} ms ({frames[k]} frames)"
                    for k, v in lat.items())
        + "; ResBlock1 / ResBlock2: fp32 "
        f"{np.median(lat['ResBlock1 fp32']) / np.median(lat['ResBlock2 fp32']):.2f}x, bf16 "
        f"{np.median(lat['ResBlock1 bf16']) / np.median(lat['ResBlock2 bf16']):.2f}x")

    # one decode on the card against a CPU copy, and bf16 against fp32 on the
    # same latent and alignment
    e32, e16 = engines["ResBlock1 fp32"], engines["ResBlock1 bf16"]
    with torch.inference_mode():
        args = (torch.from_numpy(text[None, :64]).to(dev), torch.from_numpy(emo[None]).to(dev),
                torch.tensor([spk], device=dev))
        m_p, s_p, logw, g = rb1.infer_p1(*args)
        w = torch.ceil(torch.exp(logw[..., 0]) * rates["ResBlock1 fp32"]).clamp(max=8.0)
        attn = infer_path(w, max(int(w.sum()), 1))
        noise = torch.from_numpy(np.random.RandomState(SEED).randn(
            1, attn.shape[1], e32.inter_channels).astype(np.float32) * e32.noise_scale).to(dev)
        gpu = rb1.infer_p2(attn, m_p, s_p, g, noise).cpu()
        cpu = copy.deepcopy(rb1).cpu()
        ref = cpu.infer_p2(*(t.cpu() for t in (attn, m_p, s_p, g, noise)))
        b = e16.synth.infer_p1(args[0].bfloat16(), args[1].bfloat16(), args[2])
        got16 = e16.synth.infer_p2(attn, b[0], b[1], b[3], noise)
    err = float((gpu - ref).abs().max())
    corr = _corr(gpu.numpy(), ref.numpy())
    corr16 = _corr(got16.float().cpu().numpy(), gpu.numpy())
    log(f"[options] ResBlock1 fp32 decode, card vs CPU, {attn.shape[1]} frames: max_abs_err "
        f"{err:.3e} (tol 2e-3), corr {corr:.8f} (> 0.99999); bf16 against fp32 on the same "
        f"latent: corr {corr16:.6f} (> {MIN_REQUEST_CORR})")
    if not (err <= 2e-3 and corr > 0.99999 and corr16 > MIN_REQUEST_CORR):
        raise RuntimeError("the ResBlock1 decode disagrees with the CPU or with fp32")
    try:
        rb1.quantize_decoder(torch.zeros(1, 8, e32.inter_channels, device=dev), g)
        raise RuntimeError("quantizing the ResBlock1 decoder did not raise")
    except NotImplementedError as e:
        log(f"[options] quantize_decoder on the ResBlock1 decoder raised, as the JAX package's "
            f"quantize does: NotImplementedError({str(e)!r})")
    del engines, cpu, e32, e16, rb1
    torch.cuda.empty_cache()

    # the fp32 training step with the duration discriminator
    hps = HParams(**cfg)
    hps.use_dur_dis = True
    synth, disc, dur = build_models(hps, "mel", use_dur_dis=True)
    opts = build_optimizers(hps, "mel", use_dur_dis=True)
    state = init_state(hps, synth, disc, dur, *opts, seed=SEED, device=dev)
    step = build_step(hps, torch.float32)
    B, T_x, T_y = TRAIN_B, TRAIN_TX, TRAIN_TY
    batch = _bench_batch(hps, dev, B, T_x, T_y)
    noise_gen = torch.Generator(device=dev).manual_seed(SEED)
    lr = hps.train.learning_rate
    times = []
    with mas.recorded([]) as calls:
        torch.cuda.synchronize()
        mas.counter.launches = 0                          # main path starts here
        for i in range(1 + OPT_STEPS):
            noise = synth.draw_noise(B, T_x, T_y, noise_gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, noise, lr, lr, 0.01, lr)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not _finite(metrics) or float(metrics["grad_norm_p"]) <= 0:
                raise RuntimeError(f"[options] step {i}: losses "
                                   f"{ {k: float(v) for k, v in metrics.items() if v.ndim == 0} }")
        launches = mas.counter.launches                   # main path ends here
    if launches != 1 + OPT_STEPS:
        raise RuntimeError(f"[options] K2 launched {launches} times in {1 + OPT_STEPS} steps")
    mas_err, _ = _k2_calls_exact(dev, calls, launches)
    log(f"[options] fp32 training step with -d (B {B}, T_x {T_x}, {T_y} frames): "
        f"{[round(t, 1) for t in times]} ms (median of the {OPT_STEPS} after the warm-up "
        f"{np.median(times[1:]):.1f}); K2 launches {launches}, each bit-exact against the "
        f"plain search; last loss_g_total {float(metrics['loss_g_total']):.4f}, loss_disc_p "
        f"{float(metrics['loss_disc_p']):.4f}, Swish scalars "
        f"{state['gen'].dp.act_1.weight.item():.6f}, {state['gen'].dp.act_2.weight.item():.6f}")
    del state, synth, disc, dur, batch
    torch.cuda.empty_cache()

    # the ONNX export of the options model at a smaller (t_x, t_y)
    serving = EmoVITS(ckpt, device=str(dev)).synth
    t0 = time.perf_counter()
    timings = {}
    paths = export_onnx(serving, os.path.join(workdir, "options_onnx"), *OPT_ONNX,
                        timings=timings)
    log(f"[options] ONNX export at {OPT_ONNX}: {time.perf_counter() - t0:.1f} s ("
        + "; ".join(f"{p}: " + ", ".join(f"{k} {v:.2f} s" for k, v in t.items())
                    for p, t in timings.items()) + ")")
    _, evals = onnx_check_and_eval(dev, serving, paths, OPT_LENGTHS, *OPT_ONNX, "[options]")
    del serving
    torch.cuda.empty_cache()
    return launches, mas_err, evals, float(np.median(times[1:]))


TP_RANKS = 2             # [tp]: the model axis of the sharded decode, the ranks sharing one card
TP_SHAPES = ((48, 384), (125, 1000))  # (T_x, T_y): [onnx]'s p2 shape and a ~1000-frame request
TP_ITERS = 3             # timed sharded and one-process p2 calls a shape, after one warm-up each
TP_TIMEOUT = 300         # the torchrun launch's seconds
# the sharded decode against the one-process infer_p2 on the card, fp32 with
# TF32 off: [onnx]'s tolerance (cuDNN picks its algorithms per output width,
# and a sharded conv computes half or a quarter of the channels)
TP_ATOL, TP_RTOL = 2e-4, 2e-3
# the base config's decoder in the JAX layout of the training tree: all its
# parameters, and the 57 kernels the rule splits at min_channels 128; the
# biases of those layers, which the port's sharded layers split too
TP_DEC_PARAMS, TP_DEC_SHARDED, TP_DEC_SPLIT_BIAS = 15_896_512, 14_458_880, 11_264


def _tp_inputs(synth, dev, t_x, t_y, seed):
    """One request's infer_p2 arguments at (t_x tokens, t_y frames): a seeded
    text, emotion and speaker through infer_p1, t_y / t_x frames a token."""
    from vits_tpu_torch.ops.seq import infer_path
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(1, t_x, synth.enc_p.emb["0"].in_features)
                         .astype(np.float32)).to(dev)
    emo = torch.from_numpy(rng.randn(1, 1024).astype(np.float32)).to(dev)
    sid = torch.tensor([int(rng.randint(0, synth.emb_g.weight.shape[0]))], device=dev)
    m_p, s_p, _, g = synth.infer_p1(x, emo, sid)
    attn = infer_path(torch.full((1, t_x), float(t_y // t_x), device=dev), t_y)
    noise = torch.from_numpy((0.667 * rng.randn(1, t_y, synth.inter_channels))
                             .astype(np.float32)).to(dev)
    return [t.contiguous() for t in (attn, m_p, s_p, g, noise)]  # broadcast sends the storage


def tp_rank(job_path: str) -> int:
    """One rank of the [tp] phase's sharded decode, as torchrun starts it
    (`chip_smoke.py --tp-rank job.json`): the process group from torchrun's
    environment (`dist.init_distributed`, the backend by its rule), a
    (world // model, model) mesh (`make_mesh`), the base config's seeded
    weight-normed training synthesizer (the same on every rank),
    `shard_generator_params` of its state (the JAX layout a rank holds) and
    `make_tp_infer` of it (folded, then sliced). At each of TP_SHAPES
    (rank 0's infer_p1 inputs broadcast to every rank): one warm-up and
    TP_ITERS timed sharded calls, each gather timed with CUDA events; rank 0
    then times the one-process infer_p2 of the serving synthesizer (the same
    weights folded) on the same inputs. Writes this rank's numbers and
    outputs."""
    with open(job_path) as f:
        job = json.load(f)
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as tdist
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.convert import params_from_jax, params_to_jax
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.nn.core import init_weights
    from vits_tpu_torch.parallel import dist
    from vits_tpu_torch.parallel.mesh import make_mesh, make_tp_infer, shard_generator_params

    info = dist.init_distributed(job["device"])
    dev = info.device
    hps = get_hparams_from_file(default_config_path("base"))
    train = init_weights(Synthesizer.from_hps(hps, train=True),
                         torch.Generator().manual_seed(SEED + 41)).eval()
    mesh = make_mesh(data=info.world // job["model"], model=job["model"], device=job["device"])
    held = shard_generator_params(mesh, train.state_dict())
    out = {"rank": info.rank, "world": info.world, "device": str(dev),
           "backend": mesh.backend, "at": [mesh.data_index, mesh.model_index],
           "jax_layout_params": sum(t.numel() for k, t in held.items() if k.startswith("dec.")),
           "shapes": []}
    del held
    serving = None
    if info.rank == 0:  # the one-process reference, on the card once the rank is measured
        serving = params_from_jax(params_to_jax(train.state_dict()),
                                  Synthesizer.from_hps(hps)).eval()
        out["whole_dec_params"] = sum(p.numel() for p in serving.dec.parameters())
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tp = make_tp_infer(train.to(dev), mesh, "p2")
    torch.cuda.synchronize(dev)
    out["build_s"] = time.perf_counter() - t0
    # what the rank holds on the card: the training synthesizer, its decoder
    # now the sharded one (make_tp_infer replaced train.dec)
    gc.collect()
    torch.cuda.empty_cache()
    dec = [p for n, p in train.named_parameters() if n.startswith("dec.")]
    out["held_params"] = sum(p.numel() for p in dec)
    out["held_bytes"] = sum(p.numel() * p.element_size() for p in dec)
    out["synth_bytes"] = sum(t.numel() * t.element_size()
                             for t in [*train.parameters(), *train.buffers()])
    out["allocated"] = torch.cuda.memory_allocated(dev)  # in the allocator's blocks
    out["requested"] = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    out["sharded"] = len(tp.dec.sharded)
    if serving is not None:
        serving.to(dev)
    events = []
    real_gather = mesh.gather

    def timed_gather(y):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        full = real_gather(y)
        ev[1].record()
        events.append((ev, full.numel() * full.element_size()))
        return full

    mesh.gather = timed_gather
    arrays = {}
    for i, (t_x, t_y) in enumerate(TP_SHAPES):
        c, gin = hps.model.inter_channels, hps.model.gin_channels
        with torch.no_grad():
            args = (_tp_inputs(serving, dev, t_x, t_y, SEED + 42 + i) if info.rank == 0 else
                    [torch.empty(s, device=dev) for s in
                     ((1, t_y, t_x), (1, t_x, c), (1, t_x, c), (1, gin), (1, t_y, c))])
        for a in args:
            tdist.broadcast(a, 0)
        rec = {"t_x": t_x, "t_y": t_y, "ms": [], "gather_ms": [], "ref_ms": []}
        tp(*args)
        for _ in range(TP_ITERS):
            tdist.barrier()
            events.clear()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            wav = tp(*args)
            torch.cuda.synchronize(dev)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["gather_ms"].append(sum(a.elapsed_time(b) for (a, b), _ in events))
        rec["gathers"] = len(events)
        rec["gather_bytes"] = sum(n for _, n in events)
        arrays[f"tp_{i}"] = wav.cpu().numpy()
        tdist.barrier()
        if info.rank == 0:
            with torch.inference_mode():
                serving.infer_p2(*args)
                for _ in range(TP_ITERS):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    ref = serving.infer_p2(*args)
                    torch.cuda.synchronize(dev)
                    rec["ref_ms"].append((time.perf_counter() - t0) * 1e3)
            arrays[f"ref_{i}"] = ref.cpu().numpy()
        tdist.barrier()
        out["shapes"].append(rec)
    dist.shutdown()
    np.savez(job["out"].format(rank=info.rank) + ".npz", **arrays)
    with open(job["out"].format(rank=info.rank), "w") as f:
        json.dump(out, f)
    return 0


def tp_sharded(workdir, ranks: int = TP_RANKS, model: int = TP_RANKS):
    """(a) of the [tp] phase: `ranks` ranks by `python -m
    torch.distributed.run --nproc_per_node ranks chip_smoke.py --tp-rank`
    (`tp_rank`), the decoder split over `model` of them at the base
    config's full width (min_channels 128): NCCL where the host has a card
    a rank, else gloo with the ranks sharing cuda:0. Each shape's sharded
    infer_p2 is held against the one-process infer_p2 within TP_ATOL +
    TP_RTOL |ref|, the ranks' outputs equal; every rank holds the expected
    decoder parameters."""
    card = card_line()
    job = os.path.join(workdir, "tp_job.json")
    with open(job, "w") as f:
        json.dump({"device": "cuda", "model": model,
                   "out": os.path.join(workdir, "tp_rank{rank}.json")}, f)
    start = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "4"}
    rc, stdout, stderr = _run_group(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(ranks), os.path.join(ROOT, "chip_smoke.py"), "--tp-rank", job],
        TP_TIMEOUT, cwd=workdir, env=env)
    launch_s = time.perf_counter() - start
    if rc != 0:
        raise RuntimeError(f"torchrun exited {rc}:\n{stdout[-3000:]}\n{stderr[-6000:]}")
    rr, arrays = [], []
    for r in range(ranks):
        path = os.path.join(workdir, f"tp_rank{r}.json")
        with open(path) as f:
            rr.append(json.load(f))
        arrays.append(dict(np.load(path + ".npz")))
    r0 = rr[0]
    scale = ("not a scaling figure: the ranks share one card over gloo"
             if r0["backend"] == "gloo" and torch.cuda.device_count() < ranks
             else f"{ranks} cards over {r0['backend']}")
    want = TP_DEC_PARAMS - TP_DEC_SHARDED + TP_DEC_SHARDED // model
    log(f"[tp] `python -m torch.distributed.run --nproc_per_node {ranks}` exit 0 in "
        f"{launch_s:.1f} s; mesh ({ranks // model}, {model}), backend {r0['backend']}, rank "
        f"devices {[r['device'] for r in rr]}; {r0['sharded']} decoder kernels split "
        f"(min_channels 128), each layer's output channels gathered by one all_gather of "
        f"CUDA tensors over {r0['backend']}")
    whole = r0["whole_dec_params"]
    for r in rr:
        if r["jax_layout_params"] != want or r["sharded"] != 57:
            raise RuntimeError(f"[tp] rank {r['rank']} holds {r['jax_layout_params']} decoder "
                               f"parameters of the training tree ({r['sharded']} kernels "
                               f"split), expected {want} (57)")
        split = TP_DEC_SHARDED + TP_DEC_SPLIT_BIAS
        if r["held_params"] != whole - split + split // model:
            raise RuntimeError(f"[tp] rank {r['rank']}'s synthesizer holds "
                               f"{r['held_params']} decoder parameters, not its slices of the "
                               f"{whole} of the folded decoder")
        # nothing but the synthesizer's own tensors is left on the card (a
        # whole decoder kept beside the slices would add ~60 MiB)
        if r["requested"] > r["synth_bytes"] + 2 ** 20:
            raise RuntimeError(f"[tp] rank {r['rank']} holds {r['requested']} bytes of tensors "
                               f"on the card against its synthesizer's {r['synth_bytes']}")
        log(f"[tp] rank {r['rank']} at {tuple(r['at'])}: decoder parameters in the JAX layout "
            f"of the training tree (shard_generator_params: v sliced, g whole) "
            f"{r['jax_layout_params']:,} of {TP_DEC_PARAMS:,} "
            f"({100 * r['jax_layout_params'] / TP_DEC_PARAMS:.1f}%); the folded sharded "
            f"decoder it serves from {r['held_params']:,} of the one-process decoder's "
            f"{whole:,} parameters ({100 * r['held_params'] / whole:.1f}%, "
            f"{r['held_bytes'] / 2 ** 20:.1f} MiB); on the card after sharding the rank's "
            f"tensors take {r['requested'] / 2 ** 20:.2f} MiB ({r['allocated'] / 2 ** 20:.2f} "
            f"MiB in the allocator's blocks), its whole training synthesizer "
            f"{r['synth_bytes'] / 2 ** 20:.2f} MiB; built in {r['build_s']:.2f} s")
    errs = []
    for i, (t_x, t_y) in enumerate(TP_SHAPES):
        ref = arrays[0][f"ref_{i}"]
        outs = [a[f"tp_{i}"] for a in arrays]
        if not all(np.array_equal(o, outs[0]) for o in outs[1:]):
            raise RuntimeError(f"[tp] ({t_x}, {t_y}): the ranks' outputs differ")
        if outs[0].shape != ref.shape or not np.all(np.isfinite(outs[0])):
            raise RuntimeError(f"[tp] ({t_x}, {t_y}): shape {outs[0].shape} against "
                               f"{ref.shape}, finite {np.all(np.isfinite(outs[0]))}")
        diff = np.abs(outs[0].astype(np.float64) - ref)
        err = float(diff.max())
        ratio = float((diff / (TP_ATOL + TP_RTOL * np.abs(ref))).max())
        errs.append(err)
        rec = [r["shapes"][i] for r in rr]
        ms, ref_ms = float(np.median(rec[0]["ms"])), float(np.median(rec[0]["ref_ms"]))
        log(f"[tp] infer_p2 at (T_x {t_x}, T_y {t_y}) -> {ref.shape[1]} samples, decoder split "
            f"over {model} ranks: equal on every rank; against the one-process infer_p2 on "
            f"the card (fp32, TF32 off): max_abs_err {err:.3e}, {ratio:.3f} of atol "
            f"{TP_ATOL:.0e} + rtol {TP_RTOL:.0e} |ref| (bound 1)")
        if ratio > 1.0:
            raise RuntimeError(f"[tp] ({t_x}, {t_y}): outside the tolerance ({ratio:.3f})")
        for r, x in zip(rr, rec):
            log(f"[tp]   rank {r['rank']} ({card}): sharded p2 ms "
                f"{[round(v, 2) for v in x['ms']]} (median {float(np.median(x['ms'])):.2f}), of "
                f"which {x['gathers']} gathers of {x['gather_bytes'] / 2 ** 20:.1f} MiB "
                f"(full tensors) took {[round(v, 2) for v in x['gather_ms']]} ms by CUDA "
                f"events")
        log(f"[tp]   one-process p2 on rank 0's card: {[round(v, 2) for v in rec[0]['ref_ms']]} "
            f"ms (median {ref_ms:.2f}); sharded / one-process {ms / ref_ms:.2f}x; {scale}")
    return max(errs)


def phase_tp(dev, workdir):
    """Tensor parallelism and the graft entry points on the card: (a)
    `tp_sharded` at the base config's full width, TP_RANKS ranks; (b)
    `graft_entry.dryrun_multichip(2)` (TINY data-parallel mel and stft
    steps and a tensor-parallel decode, its ranks started by the function);
    (c) `graft_entry.entry()` once, the base config's training forward.
    Every K2 launch of (b) and (c) is held bit-exact against the plain
    search. Returns (K2 launches of (b) and (c), the largest difference)."""
    from vits_tpu_torch import graft_entry
    from vits_tpu_torch.ops import mas

    tp_sharded(workdir)

    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(2)
    calls = [c for r in res for c in r["k2_calls"]]
    launches = sum(r["k2_launches"] for r in res)
    err, shapes = _k2_calls_exact(dev, calls, launches)
    if launches != 2 * len(res):
        raise RuntimeError(f"[tp] the dry-run's ranks launched K2 "
                           f"{[r['k2_launches'] for r in res]} times, expected 2 each")
    log(f"[tp] dryrun_multichip(2) on the card in {time.perf_counter() - t0:.1f} s: rank "
        f"devices {[r['device'] for r in res]}, backend {res[0]['backend']}, losses equal on "
        f"the ranks (mel {res[0]['loss_mel']:.4f}, stft {res[0]['loss_stft']:.4f}), TP wav "
        f"{tuple(res[0]['wav'].shape)} equal on the ranks "
        f"{all(torch.equal(r['wav'], res[0]['wav']) for r in res)}; K2 launches "
        f"{[r['k2_launches'] for r in res]} at {sorted(shapes)}, bit-exact against the plain "
        f"search (max_abs_err {err:.1e})")
    if not all(torch.equal(r["wav"], res[0]["wav"]) for r in res):
        raise RuntimeError("[tp] the dry-run's ranks decoded different waveforms")

    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    with mas.recorded([]) as calls:
        torch.cuda.synchronize()
        mas.counter.launches = 0                          # main path starts here
        y_hat, l_length, z_p = fn(*args)
        torch.cuda.synchronize()
        entry_launches = mas.counter.launches             # main path ends here
    e_err, _ = _k2_calls_exact(dev, calls, entry_launches)
    finite = all(bool(torch.isfinite(t).all()) for t in (y_hat, l_length, z_p))
    if entry_launches != 1 or not finite:
        raise RuntimeError(f"[tp] entry(): K2 launched {entry_launches} times, finite {finite}")
    log(f"[tp] graft_entry.entry() on the card in {time.perf_counter() - t0:.1f} s (the base "
        f"config's training forward at B 2, T_x 48, T_y 192): y_hat {tuple(y_hat.shape)}, "
        f"l_length {[round(v, 4) for v in l_length.tolist()]}, z_p {tuple(z_p.shape)}, finite; "
        f"K2 launches {entry_launches}, bit-exact (max_abs_err {e_err:.1e})")
    del fn, args, y_hat, z_p
    torch.cuda.empty_cache()
    return launches + entry_launches, max(err, e_err)


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
    glue, glue_check_launches, glue_err = phase("glue", phase_glue, dev)
    mas_rows, mas_err = phase("mas", phase_mas, dev)
    with tempfile.TemporaryDirectory() as workdir:
        launches, serving_glue, lat, audio_s, model, reqs, ckpt = phase(
            "serving", phase_serving, dev, workdir)
        if launches <= 0:
            raise RuntimeError("the serving path launched K1 no time")
        fused_launches, fused_glue, _ = phase("fused", phase_fused, dev, model, ckpt)
        if fused_launches <= 0:
            raise RuntimeError("the fused int8 path launched K1 no time")
        phase("stream", phase_stream, dev, model, reqs[N_CALIB])
        bf16_launches, _ = phase("bf16", phase_bf16, dev, model, ckpt)
        if bf16_launches <= 0:
            raise RuntimeError("the bf16 int8 paths launched K1's bf16 form no time")
        del model
        torch.cuda.empty_cache()
        server_launches, server_glue = phase("servers", phase_servers, dev, ckpt)
    if min(serving_glue, fused_glue, server_glue) <= 0:
        raise RuntimeError(f"the float serving paths launched the glue kernels {serving_glue}, "
                           f"{fused_glue} and {server_glue} times")
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
        ddp_launches, ddp_mas_err = phase("ddp", phase_ddp, dev, workdir)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        sat_k1, sat_k2, sat_mas_err, sat_k1_err = phase("sat", phase_sat, dev, workdir)
    if sat_k1 <= 0 or sat_k2 <= 0:
        raise RuntimeError(f"the SAT path launched K1 {sat_k1} and K2 {sat_k2} times")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        rb2_ckpt, _, _ = phase("onnx", phase_onnx, dev, workdir)
        opt_k2, opt_mas_err, _, _ = phase("options", phase_options, dev, workdir, rb2_ckpt)
    if opt_k2 <= 0:
        raise RuntimeError("the options model's training step launched K2 no time")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        tp_k2, tp_mas_err = phase("tp", phase_tp, dev, workdir)
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
        "name": "dec_glue",
        "route": "cuda",
        "source": "vits_tpu_torch/csrc/dec_glue.cu",
        "replaces": None,  # XLA fuses this glue on the TPU: no kernel of the JAX package
        "launches": serving_glue + fused_glue + server_glue,
        "max_abs_err": glue_err,
        "ms": glue["base"]["ms"],
        "plain_ms": glue["base"]["plain_ms"],
        "bound_ms": glue["base"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "mas",
        "route": "cuda",
        "source": "vits_tpu_torch/csrc/mas.cu",
        "replaces": "vits_tpu/ops/mas.py:130",
        "launches": (mas_launches + stft_launches + run_launches + run_stft_launches
                     + ddp_launches + sat_k2 + opt_k2 + tp_k2),
        "max_abs_err": max(mas_err, run_mas_err, run_stft_mas_err, ddp_mas_err, sat_mas_err,
                           opt_mas_err, tp_mas_err),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s; K1 launches on the main paths: "
        f"serving {launches}, fused {fused_launches}, servers {server_launches}, sat "
        f"{sat_k1}, bf16 form {bf16_launches}; glue launches on the main paths: serving "
        f"{serving_glue}, fused {fused_glue}, servers {server_glue} (the check's "
        f"{glue_check_launches}; one {GLUE_FRAMES}-frame decode's glue: base "
        f"{glue['base']['ms']:.4f} ms, VCTK {glue['vctk']['ms']:.4f} ms); K2 launches: training {mas_launches}, "
        f"training_stft {stft_launches}, run {run_launches}, run_stft {run_stft_launches}, "
        f"ddp {ddp_launches}, sat {sat_k2}, options {opt_k2}, tp {tp_k2}; phases: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ddp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank(sys.argv[2]))
    sys.exit(main())
