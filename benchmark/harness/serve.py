"""Driver "serve": one client in a closed loop through the program's serving
entry, `EmoVITS.infer` on its default engine (fp32, not quantized, fused
float with its two-phase retry), batch 1.

Set-up: the weights drawn on the card from the seed (the frozen reference's
layers), written as the deployable checkpoint.npz and config.json the
engine loads, the engine built, and one block of requests served (every
token count the window sends). Window: requests back to back for the given
seconds; a request's latency runs from the call into `EmoVITS.infer` to its
waveform on the host. Its host draw (the noise ring's start) comes from
numpy's global generator, seeded per request from the run's seed. After
the window: the peak memory, the engine freed, then the reference serves a
seeded sample of the finished requests, the longest among them, and every
number compared is set beside its limit."""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import check as C
from benchmark.harness import common, trace
from benchmark.harness.traffic import hps_of, make_requests
from benchmark.harness.weights import build_serving_model, write_checkpoint


# The engine's default fused frame budget a token
# (VITS_TPU_FUSED_FRAMES_PER_TOKEN, cleared from the run's environment).
FUSED_FRAMES_PER_TOKEN = 8.0


def setup_engine(cell: Dict, seed: int, dev, workdir: str):
    """(engine, requests): the program's engine on the seeded checkpoint,
    and the client's requests."""
    cfg, tf = cell["config_file"], cell["traffic_file"]
    hps_dict = common.hparams(cfg)
    hps = hps_of(hps_dict)
    model = build_serving_model(hps, seed, dev, cfg["assumed"])
    ckpt = write_checkpoint(workdir, model, hps_dict)
    del model
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    from vits_tpu_torch.infer import EmoVITS
    engine = EmoVITS(ckpt, device=str(dev))
    reqs = make_requests(tf, seed, hps.data.text_channels, hps.data.n_speakers)
    return engine, reqs, hps


def engine_ring(hps) -> np.ndarray:
    """The serving engine's pre-sampled noise ring, worked out again by its
    rule: 4096 frames of RandomState(12345) normals times noise_scale."""
    rng = np.random.RandomState(12345)
    C = hps.model.inter_channels
    return (rng.randn(C * 4096) * hps.data.noise_scale).astype(np.float32)


@torch.inference_mode()
def warm_two_phase(engine, hps, dev):
    """Phase 2 of the two-phase path at every frame pad a retried request can
    take (64-frame quanta up to the noise ring's 4096 frames): a request
    whose durations fill the fused budget is served again there."""
    C, q = hps.model.inter_channels, engine.frame_quantum
    m_p = torch.zeros(1, 1, C, device=dev)
    g = engine.synth.emb_g(torch.zeros(1, dtype=torch.long, device=dev))
    for y_pad in range(q, engine.ring_frames + 1, q):
        attn = torch.ones(1, y_pad, 1, device=dev)
        engine.synth.infer_p2(attn, m_p, m_p + 1, g, torch.zeros(1, y_pad, C, device=dev),
                              torch.ones(1, y_pad, 1, device=dev))


def serve_one(engine, r: Dict) -> np.ndarray:
    np.random.seed(r["np_seed"])
    wav, _ = engine.infer(r["spk"], r["text"], r["emo"])
    return wav


def run(cell: Dict, args, clock, dev) -> tuple:
    tf = cell["traffic_file"]
    traced = bool(args.trace)
    workdir = tempfile.mkdtemp(prefix="bench-serve-")
    try:
        engine, reqs, hps = setup_engine(cell, args.seed, dev, workdir)
        for r in reqs[:tf["block"]]:
            serve_one(engine, r)
        warm_two_phase(engine, hps, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = clock()

        seconds = min(args.seconds, tf["trace_seconds"]) if traced else args.seconds
        served: List[Dict] = []
        record: Dict = {}
        sr, hop = engine.sampling_rate, engine.hop_size
        failed = 0
        with trace.profiled(traced, record):
            t_start = time.perf_counter()
            t_end = t_start + seconds
            i = 0
            while time.perf_counter() < t_end:
                r = reqs[i % len(reqs)]
                i += 1
                t0 = time.perf_counter()
                try:
                    with trace.span("request", traced):
                        wav = serve_one(engine, r)
                except (RuntimeError, ValueError):
                    failed += 1
                    served.append({"req": r, "wav": None, "ms": float("inf")})
                    continue
                served.append({"req": r, "wav": wav, "ms": (time.perf_counter() - t0) * 1e3})
            window_s = time.perf_counter() - t_start
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        del engine
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        ok = [s for s in served if s["wav"] is not None]
        lat = [s["ms"] for s in served]
        audio_s = sum(len(s["wav"]) for s in ok) / sr
        frames = sum(len(s["wav"]) // hop for s in ok)
        tokens = sum(s["req"]["tokens"] for s in ok)
        retried = sum(len(s["wav"]) // hop >= C.fused_budget(s["req"]["tokens"], hps)
                      for s in ok)
        common.note(f"{len(served)} requests in {window_s:.3f} s, {frames / max(tokens, 1):.3f} "
                    f"frames a token, {retried} served again two-phase (the budget filled), "
                    f"p50 {common.percentile(lat, 50):.3f} ms, max {max(lat):.3f} ms")
        result = {"attempted": len(served), "failed": failed,
                  "device": common.device_info(cell["chips"], peak, dev)}
        if not traced:
            result["metrics"] = {
                "serve_p95_ms": common.metric(common.percentile(lat, 95), "ms"),
                "synth_audio_s_per_s": common.metric(audio_s / window_s, "audio-s/s"),
                "setup_s": common.metric(setup_s, "s")}
        else:
            rec = {**record, "cell": cell, "hps": hps,
                   "synth_work": [(1, s["req"]["tokens"], len(s["wav"]) // hop, False)
                                  for s in ok],
                   "latencies_ms": lat}
            result["metrics"] = common.per_layer(cell, rec)
            result["device"].update(busy_s=record["busy_s"], window_s=record["window_s"])
            result["breakdown"] = record["breakdown"]

        sample = C.sample_served(ok, tf["check"]["sample"], args.seed,
                                 key=lambda s: len(s["wav"]))
        ref = build_serving_model(hps, args.seed, dev,
                                  cell["config_file"]["assumed"])
        readings = C.compare_served(ref, hps, engine_ring(hps), sample, FUSED_FRAMES_PER_TOKEN,
                                    dev)
        limits = tf["check"]["limits"]
        checks = [common.check("failed_requests", failed, 0)] + [
            common.check(k, readings[k], limits[k]) for k in ("dur_gap", "wav_rel_err")]
        return result, checks
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
