"""Driver "batch": offline batch synthesis through the two-phase contract the
port's AOT and ONNX exports serve, with the int8 decoder.

Set-up: the weights drawn on the card from the seed, loaded into the
program's serving synthesizer (`Synthesizer.from_hps`, `params_from_jax`, as
its engine loads them); its decoder quantized (`Synthesizer.quantize_decoder`)
on calibration batches drawn from the seed; one batch of every shape the
window runs. Requests are sorted by token count and cut into batches of
`batch` (a batch job sorts its work); a batch's text is padded to the text
quantum, its frames to the frame quantum. Per batch: `infer_p1`, one host
read of the durations, `ops.seq.infer_path`, `infer_p2(dec_q8=...)`, the
waveform to the host. The prior noise of a batch is a slice of a noise ring
the benchmark draws from the seed, at an offset drawn per batch.

After the window the reference redoes a seeded sample of the finished
batches, the longest among them, with its own quantization from the same
calibration inputs."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import check as C
from benchmark.harness import common, trace
from benchmark.harness.traffic import hps_of, make_requests
from benchmark.harness.weights import build_serving_model
from benchmark.harness.work import decoder_chains
from benchmark.reference.convert import params_to_jax

RING_FRAMES = 4096


def noise_ring(hps, seed: int, dev) -> torch.Tensor:
    """(RING_FRAMES * inter_channels,) standard normal noise times the
    config's noise_scale, drawn on the card from the seed."""
    gen = torch.Generator(device=dev).manual_seed(int(seed) + 7)
    n = RING_FRAMES * hps.model.inter_channels
    return torch.randn(n, generator=gen, device=dev) * hps.data.noise_scale


def make_batches(reqs: List[Dict], B: int, text_quantum: int, seed: int) -> List[Dict]:
    """The requests sorted by tokens, cut into batches of B, each padded to
    the text quantum, in a seeded order; each batch with its noise offset
    seed."""
    order = sorted(reqs, key=lambda r: (r["tokens"], r["i"]))
    batches = []
    for j in range(0, len(order) - B + 1, B):
        rs = order[j:j + B]
        T = C.quantize(max(r["tokens"] for r in rs), text_quantum)
        x = np.zeros((B, T, rs[0]["text"].shape[1]), np.float32)
        mask = np.zeros((B, T, 1), np.float32)
        for b, r in enumerate(rs):
            x[b, :r["tokens"]] = r["text"]
            mask[b, :r["tokens"]] = 1.0
        batches.append({"reqs": rs, "x": x, "mask": mask,
                        "emo": np.stack([r["emo"] for r in rs]),
                        "sid": np.array([r["spk"] for r in rs], np.int64),
                        "lens": np.array([r["tokens"] for r in rs], np.int64)})
    rng = np.random.default_rng([seed, 7])
    order = rng.permutation(len(batches))
    return [dict(batches[i], offset_seed=int(rng.integers(0, 2 ** 31))) for i in order]


def durations(logw: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """ceil(exp(logw)) of every valid token, zero past each length."""
    w = np.ceil(np.exp(logw[..., 0].astype(np.float32)))
    return w * (np.arange(w.shape[1])[None, :] < lens[:, None])


def noise_slice(ring: torch.Tensor, offset_seed: int, T_y: int, C_: int) -> torch.Tensor:
    """T_y frames of the ring from a seeded start, wrapping past its end."""
    n = T_y * C_
    start = int(np.random.default_rng(offset_seed).integers(0, ring.numel()))
    idx = (start + torch.arange(n, device=ring.device)) % ring.numel()
    return ring[idx].reshape(1, T_y, C_)


class Phases:
    """The program's (or the reference's) two phases on one batch, each
    bracketed by CUDA events when asked."""

    def __init__(self, synth, dec_q8, ring, hps, frame_quantum: int, dev, events: bool,
                 infer_path):
        self.synth, self.dec_q8, self.ring, self.hps = synth, dec_q8, ring, hps
        self.fq, self.dev, self.events, self.infer_path = frame_quantum, dev, events, infer_path
        self.ms = {"p1": [], "p2": []}
        self._pending = []

    def _ev(self):
        return torch.cuda.Event(enable_timing=True) if self.events else None

    def __call__(self, b: Dict, traced: bool = False):
        dev, hps = self.dev, self.hps
        a0, a1, a2 = self._ev(), self._ev(), self._ev()
        with trace.span("p1", traced):
            if a0:
                a0.record()
            m_p, s_p, logw, g = self.synth.infer_p1(
                torch.as_tensor(b["x"], device=dev), torch.as_tensor(b["emo"], device=dev),
                torch.as_tensor(b["sid"], device=dev),
                x_mask=torch.as_tensor(b["mask"], device=dev))
            if a1:
                a1.record()
        with trace.span("host_durations", traced):
            dur = durations(logw.float().cpu().numpy(), b["lens"])
        y_len = np.maximum(dur.sum(axis=1), 1).astype(np.int64)
        T_y = C.quantize(int(y_len.max()), self.fq)
        with trace.span("p2", traced):
            attn = self.infer_path(torch.as_tensor(dur, dtype=torch.float32, device=dev), T_y)
            y_mask = (torch.arange(T_y, device=dev)[None, :] <
                      torch.as_tensor(y_len, device=dev)[:, None]).float()[..., None]
            noise = noise_slice(self.ring, b["offset_seed"], T_y, hps.model.inter_channels)
            wav = self.synth.infer_p2(attn, m_p, s_p, g, noise.expand(len(y_len), -1, -1),
                                      y_mask, dec_q8=self.dec_q8)
            if a2:
                a2.record()
        with trace.span("to_host", traced):
            out = wav[..., 0].float().cpu().numpy()
        if a0:
            self._pending.append((a0, a1, a2))
        hop = hps.data.hop_length
        return [out[i, :y_len[i] * hop] for i in range(len(y_len))], y_len, T_y

    def event_ms(self):
        for a0, a1, a2 in self._pending:
            self.ms["p1"].append(a0.elapsed_time(a1))
            self.ms["p2"].append(a1.elapsed_time(a2))
        self._pending = []
        return self.ms


def calibration_batch(hps, tf: Dict, seed: int):
    """The calibration requests: their own draw from the seed, one batch."""
    reqs = make_requests({**tf, "blocks": 1}, seed + 11, hps.data.text_channels,
                         hps.data.n_speakers)
    return make_batches(reqs[:tf["batch"]], tf["batch"], tf["text_quantum"], seed + 11)


@torch.no_grad()
def quantize_on(synth, hps, cal: List[Dict], ring, dev, frame_quantum: int, infer_path):
    """`quantize_decoder` on the calibration batches' latents: phase 1,
    the durations, the path and the noise as a served batch takes them."""
    zs, gs, ms = [], [], []
    for b in cal:
        m_p, s_p, logw, g = synth.infer_p1(
            torch.as_tensor(b["x"], device=dev), torch.as_tensor(b["emo"], device=dev),
            torch.as_tensor(b["sid"], device=dev), x_mask=torch.as_tensor(b["mask"], device=dev))
        dur = durations(logw.float().cpu().numpy(), b["lens"])
        y_len = np.maximum(dur.sum(axis=1), 1).astype(np.int64)
        T_y = C.quantize(int(y_len.max()), frame_quantum)
        attn = infer_path(torch.as_tensor(dur, dtype=torch.float32, device=dev), T_y)
        y_mask = (torch.arange(T_y, device=dev)[None, :] <
                  torch.as_tensor(y_len, device=dev)[:, None]).float()[..., None]
        noise = noise_slice(ring, b["offset_seed"], T_y, hps.model.inter_channels)
        zs.append(synth.latent(attn, m_p, s_p, g, noise.expand(len(y_len), -1, -1), y_mask))
        gs.append(g)
        ms.append(y_mask)
    return synth.quantize_decoder(torch.cat(zs), torch.cat(gs), torch.cat(ms))


def run(cell: Dict, args, clock, dev) -> tuple:
    cfg, tf = cell["config_file"], cell["traffic_file"]
    traced = bool(args.trace)
    hps_dict = common.hparams(cfg)
    hps = hps_of(hps_dict)
    assumed = cfg["assumed"]

    from vits_tpu_torch.convert import params_from_jax
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.ops.seq import infer_path
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    weights = build_serving_model(hps, args.seed, dev, assumed)
    tree = params_to_jax(weights.state_dict())
    del weights
    synth = params_from_jax(tree, Synthesizer.from_hps(hps_of(hps_dict)))
    synth.to(dev).eval()
    del tree
    ring = noise_ring(hps, args.seed, dev)
    reqs = make_requests(tf, args.seed, hps.data.text_channels, hps.data.n_speakers)
    batches = make_batches(reqs, tf["batch"], tf["text_quantum"], args.seed)
    cal = calibration_batch(hps, tf, args.seed)
    dec_q8 = quantize_on(synth, hps, cal, ring, dev, tf["frame_quantum"], infer_path)
    run_batch = Phases(synth, dec_q8, ring, hps, tf["frame_quantum"], dev,
                       dev.type == "cuda" and traced, infer_path)
    with torch.no_grad():
        for b in batches:  # every batch the window cycles through, once
            run_batch(b)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    run_batch.ms = {"p1": [], "p2": []}
    run_batch._pending = []
    setup_s = clock()

    seconds = min(args.seconds, tf["trace_seconds"]) if traced else args.seconds
    done: List[Dict] = []
    record: Dict = {}
    sr = hps.data.sampling_rate
    with torch.no_grad(), trace.profiled(traced, record):
        t_start = time.perf_counter()
        t_end = t_start + seconds
        k = 0
        while time.perf_counter() < t_end:
            b = batches[k % len(batches)]
            k += 1
            wavs, y_len, T_y = run_batch(b, traced)
            done.append({"batch": b, "wavs": wavs, "y_len": y_len, "T_y": T_y})
        window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    events = run_batch.event_ms() if run_batch.events else {}
    del synth, dec_q8, run_batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    audio_s = sum(int(d["y_len"].sum()) for d in done) * hps.data.hop_length / sr
    n_utt = sum(len(d["wavs"]) for d in done)
    frames = sum(int(d["y_len"].sum()) for d in done)
    tokens = sum(int(d["batch"]["lens"].sum()) for d in done)
    decoded = sum(len(d["y_len"]) * d["T_y"] for d in done)
    common.note(f"{len(done)} batches, {n_utt} utterances, {frames / max(tokens, 1):.3f} frames "
                f"a token, {frames / max(decoded, 1):.4f} of the decoded frames served, "
                f"longest batch T_y {max((d['T_y'] for d in done), default=0)}")
    result = {"attempted": n_utt, "failed": 0,
              "device": common.device_info(cell["chips"], peak, dev)}
    if not traced:
        result["metrics"] = {
            "synth_audio_s_per_s": common.metric(audio_s / window_s, "audio-s/s"),
            "setup_s": common.metric(setup_s, "s")}
    else:
        rec = {**record, "cell": cell, "hps": hps, "events_ms": events,
               "synth_work": [(1, int(r["tokens"]), int(n), True) for d in done
                              for r, n in zip(d["batch"]["reqs"], d["y_len"])],
               "k1_chains": [c for d in done
                             for c in decoder_chains(hps, len(d["y_len"]), d["T_y"])]}
        result["metrics"] = common.per_layer(cell, rec)
        result["device"].update(busy_s=record["busy_s"], window_s=record["window_s"])
        result["breakdown"] = record["breakdown"]

    sample = C.sample_served(done, tf["check"]["sample"], args.seed,
                             key=lambda d: int(d["y_len"].sum()))
    readings = compare_batches(hps, args.seed, assumed, tf, sample, dev)
    limits = tf["check"]["limits"]
    checks = [common.check(k, readings[k], limits[k]) for k in ("dur_gap", "wav_rel_err")]
    return result, checks


@torch.no_grad()
def compare_batches(hps, seed: int, assumed: Dict, tf: Dict, sample: List[Dict], dev,
                    weight_qmax: int = 127) -> Dict:
    """The reference's phases over the sampled batches, its int8 decoder
    quantized from the same calibration inputs (weights to `weight_qmax`
    levels: 127 for int8, 7 for the int4 control), against the served
    waveforms: dur_gap and wav_rel_err, the worst utterance."""
    from benchmark.reference import quant
    from benchmark.reference.seq import infer_path as ref_infer_path
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = build_serving_model(hps, seed, dev, assumed)
    ring = noise_ring(hps, seed, dev)
    saved = quant.WEIGHT_QMAX
    quant.WEIGHT_QMAX = weight_qmax
    try:
        dec_q8 = quantize_on(ref, hps, calibration_batch(hps, tf, seed), ring, dev,
                             tf["frame_quantum"], ref_infer_path)
    finally:
        quant.WEIGHT_QMAX = saved
    worst = {"dur_gap": 0.0 if sample else float("inf"),
             "wav_rel_err": 0.0 if sample else float("inf")}
    hop = hps.data.hop_length
    for d in sample:
        b = d["batch"]
        m_p, s_p, logw, g = ref.infer_p1(
            torch.as_tensor(b["x"], device=dev), torch.as_tensor(b["emo"], device=dev),
            torch.as_tensor(b["sid"], device=dev), x_mask=torch.as_tensor(b["mask"], device=dev))
        w = np.exp(logw[..., 0].float().cpu().numpy())
        dur = np.zeros_like(w)
        for i, n in enumerate(b["lens"]):
            dur[i, :n], gap = C.served_durations(w[i, :n], int(d["y_len"][i]))
            worst["dur_gap"] = max(worst["dur_gap"], gap)
        T_y = d["T_y"]
        y_len = d["y_len"]
        attn = ref_infer_path(torch.as_tensor(dur, dtype=torch.float32, device=dev), T_y)
        y_mask = (torch.arange(T_y, device=dev)[None, :] <
                  torch.as_tensor(y_len, device=dev)[:, None]).float()[..., None]
        noise = noise_slice(ring, b["offset_seed"], T_y, hps.model.inter_channels)
        wav = ref.infer_p2(attn, m_p, s_p, g, noise.expand(len(y_len), -1, -1), y_mask,
                           dec_q8=dec_q8)[..., 0].float().cpu().numpy()
        for i, n in enumerate(y_len):
            worst["wav_rel_err"] = max(worst["wav_rel_err"],
                                       C.rel_err(d["wavs"][i], wav[i, :n * hop]))
    return worst
