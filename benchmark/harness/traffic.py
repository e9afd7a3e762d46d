"""The benchmark's traffic generators, driven by the parameters of a traffic
file. Sizes are fixed by the file: each block of requests holds the same
lengths, quantiles of the file's log-normal, and the seed only orders them
within a block and draws their contents. So every seed asks for the same
work in another order.

`write_corpus` is a frozen copy of chip_smoke.write_corpus's utterances
(a tone in noise, a .vec of text vectors, a .emo, a speaker id), with the
durations taken from the file's distribution."""

from __future__ import annotations

import math
import os
from types import SimpleNamespace
from typing import Dict, List

import numpy as np


def hps_of(d: Dict):
    """A config dict as the attribute tree the model builders read."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: hps_of(v) for k, v in d.items()})
    return d


def lognormal_sizes(spec: Dict, n: int) -> np.ndarray:
    """n sizes at the quantiles (i + 0.5) / n of a log-normal of the given
    median and sigma, truncated to [min, max] (its quantiles taken inside the
    truncated range), rounded to integers."""
    from statistics import NormalDist
    nd = NormalDist(math.log(spec["median"]), spec["sigma"])
    lo, hi = nd.cdf(math.log(spec["min"])), nd.cdf(math.log(spec["max"]))
    q = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return np.clip(np.rint(np.exp([nd.inv_cdf(float(x)) for x in q])),
                   spec["min"], spec["max"]).astype(np.int64)


def block_order(sizes: np.ndarray, n_blocks: int, seed: int) -> np.ndarray:
    """n_blocks permutations of `sizes`, one after another, from the seed."""
    rng = np.random.default_rng([seed, 1])
    return np.concatenate([sizes[rng.permutation(len(sizes))] for _ in range(n_blocks)])


def request_seed(seed: int, i: int) -> int:
    """The 32-bit seed of request i's host draws (the engine's noise start)."""
    return int(np.random.default_rng([seed, 2, i]).integers(0, 2 ** 32 - 1))


def make_requests(spec: Dict, seed: int, text_channels: int, n_speakers: int) -> List[Dict]:
    """Requests of one client: token counts from `spec["tokens"]` in blocks
    of `spec["block"]`, `spec["blocks"]` of them; per request standard
    normal text vectors (tokens, text_channels) and a 1024-d emotion vector,
    a speaker uniform over n_speakers, and the seed of its host draws."""
    sizes = lognormal_sizes(spec["tokens"], spec["block"])
    order = block_order(sizes, spec["blocks"], seed)
    out = []
    for i, n in enumerate(order):
        rng = np.random.default_rng([seed, 3, i])
        out.append({"i": i, "tokens": int(n),
                    "text": rng.standard_normal((int(n), text_channels), np.float32),
                    "emo": rng.standard_normal(1024, np.float32),
                    "spk": int(rng.integers(0, n_speakers)),
                    "np_seed": request_seed(seed, i)})
    return out


def write_wav16(path: str, wav: np.ndarray, sr: int):
    """A mono 16-bit PCM wav (the container the data pipeline reads)."""
    import wave
    pcm = np.clip(np.rint(wav * 32767.0), -32767, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def corpus_seconds(spec: Dict, data: Dict, batch: int) -> np.ndarray:
    """Utterance seconds of the corpus: the file's log-normal (median,
    sigma, truncated to [min, max]) split over the sampler's length buckets
    (`spec["buckets"]`, in frames), each bucket given its share of
    spec["utterances"] rounded to whole batches (at least one), its
    lengths the quantiles of the distribution inside it. No bucket then
    pads a batch with repeated utterances."""
    from statistics import NormalDist
    sec = spec["seconds"]
    nd = NormalDist(math.log(sec["median"]), sec["sigma"])
    f2s = data["hop_length"] / data["sampling_rate"]
    lo_all, hi_all = nd.cdf(math.log(sec["min"])), nd.cdf(math.log(sec["max"]))
    out = []
    for a, b in zip(spec["buckets"][:-1], spec["buckets"][1:]):
        lo = max(nd.cdf(math.log(max(a * f2s, 1e-9))), lo_all)
        hi = min(nd.cdf(math.log(b * f2s)), hi_all)
        if hi <= lo:
            continue
        share = spec["utterances"] * (hi - lo) / (hi_all - lo_all)
        n = max(1, int(round(share / batch))) * batch
        q = lo + (hi - lo) * (np.arange(n) + 0.5) / n
        out.append(np.exp([nd.inv_cdf(float(x)) for x in q]))
    return np.concatenate(out)


def write_corpus(dirpath: str, spec: Dict, data: Dict, seed: int, batch: int) -> List[str]:
    """The corpus of `corpus_seconds` in dirpath, in a seeded order, as the
    data pipeline reads it: a 16-bit wav (a tone of a seeded pitch in
    noise), about one text vector per spec["frames_per_vector"] frames in a
    .vec, a 1024-d .emo and a speaker under n_speakers. Returns the scp
    lines (vec|wav|emo|sid)."""
    os.makedirs(dirpath, exist_ok=True)
    secs = corpus_seconds(spec, data, batch)
    rng = np.random.default_rng([seed, 4])
    secs = secs[rng.permutation(len(secs))]
    sr, hop, C = data["sampling_rate"], data["hop_length"], data["text_channels"]
    lines = []
    for i, s in enumerate(secs):
        r = np.random.default_rng([seed, 5, i])
        T = int(s * sr)
        t = np.arange(T, dtype=np.float32) / sr
        f0 = r.uniform(90, 250)
        wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * r.standard_normal(T, np.float32)
        stem = os.path.join(dirpath, f"u{i}")
        write_wav16(stem + ".wav", wav.astype(np.float32), sr)
        n_vec = max(int(T // hop // spec["frames_per_vector"]) + int(r.integers(-5, 6)), 8)
        r.standard_normal((n_vec, C), np.float32).tofile(stem + ".vec")
        r.standard_normal(1024, np.float32).tofile(stem + ".emo")
        lines.append(f"{stem}.vec|{stem}.wav|{stem}.emo|{int(r.integers(0, data['n_speakers']))}")
    return lines
