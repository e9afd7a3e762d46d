#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vits_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):
  1. build    - compile every CUDA kernel of the port from csrc/ with nvcc
                (sm_90a), print the build seconds and ptxas' resource report;
  2. kernels  - hold the int8 ResBlock2-chain kernel against its plain PyTorch
                version at the 12 base-config chain shapes (C = 256/128/64/32
                x k = 3/7/11, dilations 1/3/5, B = 1, 256 frames, ragged valid
                length); print kernel ms, plain ms, bound ms and errors;
  3. serving  - write a seeded random base-config checkpoint at full width,
                serve it with EmoVITS(device="cuda", quantize=True): 8
                calibration requests (float decodes), then int8 requests
                whose every ResBlock2 chain must go through the kernel
                (launch counts checked), each compared with the float decode
                of the same request; one request's float decode is also held
                against the CPU;
  4. card     - print the card's name and power limit.
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


def phase_kernels(dev):
    """K1 against its plain version at the 12 base-config chain shapes."""
    from vits_tpu_torch.models.modules import ResBlock2
    from vits_tpu_torch.nn import rb_chain
    from vits_tpu_torch.nn.core import init_weights
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file

    m = get_hparams_from_file(default_config_path("base")).model
    gin = m.gin_channels
    rows, worst = [], 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_s": 0.0, "bytes_s": 0.0}
    up = 1
    gen = torch.Generator().manual_seed(SEED)
    for s, u in enumerate(m.upsample_rates):
        up *= u
        C = m.upsample_initial_channel // 2 ** (s + 1)
        M = CHAIN_FRAMES * up
        for k, dil in zip(m.resblock_kernel_sizes, m.resblock_dilation_sizes):
            rb = init_weights(ResBlock2(C, k, tuple(dil), gin), gen).to(dev).eval()
            valid_n = M - 37 * up // 8 - 1  # ragged: not a multiple of the stage's upsampling
            x = torch.randn(1, M, C, generator=gen).to(dev)
            mask = (torch.arange(M, device=dev) < valid_n).float()[None, :, None]
            x = x * mask
            g = torch.randn(1, gin, generator=gen).to(dev)
            with torch.no_grad():
                rec = {}
                rb(x, g, x_mask=mask, record=rec)
                qp = rb.quantize_params(rec)
                gs = torch.stack([rb.conds[str(i)](g) for i in range(len(dil))], 1).float()
            valid = torch.tensor([valid_n], dtype=torch.int32, device=dev)
            out = rb_chain.chain_q8_cuda(qp, x, gs, valid)
            ref = rb_chain.chain_q8_plain(qp, x, gs, valid)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError(f"K1 C={C} k={k}: non-finite output")
            diff = (out - ref).abs()
            scale = max(1.0, float(ref.abs().max()))
            err = float(diff.max())
            off = float((diff > 1e-3 * float(ref.abs().max())).float().mean())
            ok = err <= 0.05 * scale and off < 0.01
            ms = cuda_ms(lambda: rb_chain.chain_q8_cuda(qp, x, gs, valid), iters=20)
            plain_ms = cuda_ms(lambda: rb_chain.chain_q8_plain(qp, x, gs, valid), iters=3, warmup=1)
            ops, nbytes = rb_chain.chain_ops_bytes(1, M, C, k, len(dil))
            bound = max(ops / INT8_PEAK, nbytes / HBM_BW) * 1e3
            log(f"[kernels] rb2_chain_q8 C={C:3d} k={k:2d} M={M:5d} valid={valid_n}: "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms "
                f"({'ops' if ops / INT8_PEAK > nbytes / HBM_BW else 'bytes'})  "
                f"max_abs_err {err:.3e} (tol {0.05 * scale:.3e})  "
                f"off>1e-3*max {100 * off:.3f}%  {'OK' if ok else 'FAIL'}")
            rows.append(dict(C=C, k=k, M=M, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             max_abs_err=err, frac_off=off, ok=ok))
            worst = max(worst, err)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bound
            tot["ops_s"] += ops / INT8_PEAK
            tot["bytes_s"] += nbytes / HBM_BW
            del rb, x, qp, out, ref
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"K1 disagrees with its plain version at {len(bad)} shape(s): {bad}")
    log(f"[kernels] rb2_chain_q8: all {len(rows)} shapes agree; the 12 chains of a "
        f"{CHAIN_FRAMES}-frame request: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    return rows, worst, tot


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
    n_chain = len(model.synth.dec.resblocks)
    per_chain = len(model.hps.model.resblock_dilation_sizes[0])
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
        want = n_chain * per_chain
        if kind == "freeze" and launched != 2 * want:
            raise RuntimeError(f"request {i}: K1 launched {launched} times, expected "
                               f"{2 * want} (the gate's int8 decode and the request's)")
        if kind == "int8":
            if launched != want:
                raise RuntimeError(f"request {i}: K1 launched {launched} times, expected "
                                   f"{want} ({n_chain} chains x {per_chain} dilations)")
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
    launches, lat, audio_s = phase_serving(dev)
    if launches <= 0:
        raise RuntimeError("the serving path launched K1 no time")
    card = card_line()
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
