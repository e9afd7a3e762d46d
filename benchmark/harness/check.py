"""The comparison that decides `correct`: the frozen reference, run after
the window on the inputs the benchmark made, against what the timed path
served.

Durations are the served model's discrete decisions, as tokens are a
language model's: the reference takes ceil(exp(logw)) of its own phase 1,
and where the served frame count differs from its sum, the reference moves
the tokens nearest an integer boundary to the served count. The number
compared is the farthest such a token lies from the boundary, in frames
(`dur_gap`, 0 where the counts agree). The waveform is compared as the
relative L2 error of each served request against the reference's decode
with those durations and the same noise (`wav_rel_err`, the worst of the
sample)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.seq import generate_path, infer_path, sequence_mask


def quantize(n: int, q: int, cap: int = 0) -> int:
    m = -(-n // q) * q
    return min(m, cap) if cap else m


def sample_served(served: List[Dict], k: int, seed: int, key) -> List[Dict]:
    """k of the served requests drawn from the seed, the longest (by `key`)
    always among them."""
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: key(served[i]))
    rng = np.random.default_rng([seed, 6])
    rest = [i for i in range(len(served)) if i != longest]
    pick = list(rng.choice(rest, size=min(k - 1, len(rest)), replace=False)) if rest else []
    return [served[i] for i in [longest] + sorted(pick)]


def served_durations(w: np.ndarray, total: int) -> Tuple[np.ndarray, float]:
    """(durations, gap): ceil(w), with the |d| tokens nearest a boundary
    moved by one frame so that they sum to `total` (d = total - sum); gap
    the farthest moved token's distance to its boundary (inf where it
    cannot be done)."""
    w = np.asarray(w, np.float64)
    dur = np.ceil(w)
    d = int(total - dur.sum())
    if d == 0:
        return dur, 0.0
    dist = (dur - w) if d > 0 else (w - (dur - 1))
    if abs(d) > len(w):
        return dur, float("inf")
    idx = np.argsort(dist, kind="stable")[:abs(d)]
    dur[idx] += np.sign(d)
    return dur, float(dist[idx].max())


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b||, or inf where the lengths differ."""
    if a.shape != b.shape:
        return float("inf")
    return float(np.linalg.norm(a.astype(np.float64) - b) / max(np.linalg.norm(b), 1e-30))


@torch.no_grad()
def ref_phase1(ref, x, x_len, emo, spk, dev):
    """The reference's text encoder and durations at the padded length:
    (m_p, logs_p, logw, g, x_mask), batch first."""
    x = torch.as_tensor(x, device=dev)
    x_lengths = torch.as_tensor(x_len, device=dev)
    x_mask = sequence_mask(x_lengths, x.shape[1])[..., None].to(x.dtype)
    g = ref.emb_g(torch.as_tensor(spk, device=dev))
    x_h, m_p, logs_p = ref.enc_p(x, x_mask, emo=torch.as_tensor(emo, device=dev), g=g)
    logw = ref.dp(x_h, x_mask, g=g)
    return m_p, logs_p, logw, g, x_mask


def fused_budget(tokens: int, hps, fused_fpt: float = 8.0, frame_quantum: int = 64) -> int:
    """The engine's fused frame budget for a request of `tokens` tokens: the
    frames a token in whole quanta, capped at the ring's 4096 frames."""
    return min(quantize(max(int(tokens * fused_fpt), frame_quantum), frame_quantum),
               (4096 // frame_quantum) * frame_quantum)


@torch.no_grad()
def ref_request(ref, hps, ring: np.ndarray, r: Dict, served_frames: int, fused_fpt: float,
                dev, text_quantum: int = 32, frame_quantum: int = 64):
    """The reference's waveform of one batch-1 request as the engine serves
    it: the fused pass over its frame budget, or, where the served count
    fills the budget, the two-phase path with the engine's second noise
    draw. Returns (wav, dur_gap)."""
    C = hps.model.inter_channels
    hop = hps.data.hop_length
    n = r["tokens"]
    x_pad = quantize(n, text_quantum, getattr(hps.data, "max_text_len", 384))
    budget = fused_budget(n, hps, fused_fpt, frame_quantum)
    x = np.zeros((1, x_pad, r["text"].shape[1]), np.float32)
    x[0, :n] = r["text"][:x_pad]
    m_p, logs_p, logw, g, x_mask = ref_phase1(ref, x, [n], r["emo"][None], [r["spk"]], dev)
    w = (torch.exp(logw) * x_mask).float()[0, :n, 0].cpu().numpy()
    dur, gap = served_durations(w, served_frames)
    F = served_frames
    rs = np.random.RandomState(r["np_seed"])
    start = rs.randint(max(ring.size - budget * C, 1))
    if F < budget:  # served by the fused pass
        ring_dev = torch.as_tensor(ring, device=dev)
        noise = ring_dev[start:start + budget * C].reshape(1, budget, C)
        w_ceil = torch.zeros(1, x_pad, device=dev)
        w_ceil[0, :n] = torch.as_tensor(dur, dtype=torch.float32, device=dev)
        y_mask = sequence_mask(torch.tensor([F], device=dev), budget)[..., None].float()
        attn = generate_path(w_ceil, y_mask * x_mask.transpose(1, 2))
        m_p_e = torch.einsum("byx,bxc->byc", attn, m_p)
        logs_p_e = torch.einsum("byx,bxc->byc", attn, logs_p)
        z = ref.flow(m_p_e + noise * torch.exp(logs_p_e), y_mask, g=g)
        o = ref.dec(z * y_mask, g=g, x_mask=y_mask)
        return o[0, :F * hop, 0].float().cpu().numpy(), gap
    y_pad = quantize(F, frame_quantum)
    nl = y_pad * C
    start = rs.randint(max(ring.size - nl, 1))
    noise = np.resize(ring[start:start + nl], (nl,)).reshape(1, y_pad, C)
    d = torch.zeros(1, x_pad, device=dev)
    d[0, :n] = torch.as_tensor(dur, dtype=torch.float32, device=dev)
    attn = infer_path(d, y_pad)
    y_mask = torch.zeros(1, y_pad, 1, device=dev)
    y_mask[0, :F] = 1.0
    wav = ref.infer_p2(attn, m_p, torch.exp(logs_p), g, torch.as_tensor(noise, device=dev),
                       y_mask)
    return wav[0, :F * hop, 0].float().cpu().numpy(), gap


def compare_served(ref, hps, ring, sample: List[Dict], fused_fpt: float, dev) -> Dict:
    """dur_gap and wav_rel_err, the worst over the sample; a sample that
    is empty reads inf."""
    hop = hps.data.hop_length
    worst = {"dur_gap": 0.0 if sample else float("inf"),
             "wav_rel_err": 0.0 if sample else float("inf")}
    for s in sample:
        wav = s["wav"]
        if len(wav) % hop:
            worst["wav_rel_err"] = float("inf")
            continue
        ref_wav, gap = ref_request(ref, hps, ring, s["req"], len(wav) // hop, fused_fpt, dev)
        worst["dur_gap"] = max(worst["dur_gap"], gap)
        worst["wav_rel_err"] = max(worst["wav_rel_err"], rel_err(wav, ref_wav))
    return worst
