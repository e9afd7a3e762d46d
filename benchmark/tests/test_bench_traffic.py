"""The benchmark's generators: deterministic per seed, inside the traffic
files' ranges, and the same sizes on every seed."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark.harness import traffic
from benchmark.harness.common import BENCH

SEEDS = (0, 2 ** 31 + 5, 2 ** 33 + 1)


def _traffic(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,config", [("serve-b1", "base"), ("batch-q8", "adapt")])
def test_requests_are_seeded_and_in_range(name, config):
    tf, data = _traffic(name), _config(config)["data"]
    small = {**tf, "blocks": 1}
    a = traffic.make_requests(small, SEEDS[1], data["text_channels"], data["n_speakers"])
    b = traffic.make_requests(small, SEEDS[1], data["text_channels"], data["n_speakers"])
    c = traffic.make_requests(small, SEEDS[2], data["text_channels"], data["n_speakers"])
    assert len(a) == tf["block"]
    for r, s in zip(a, b):
        assert r["tokens"] == s["tokens"] and r["spk"] == s["spk"]
        assert r["np_seed"] == s["np_seed"]
        np.testing.assert_array_equal(r["text"], s["text"])
        np.testing.assert_array_equal(r["emo"], s["emo"])
    toks = [r["tokens"] for r in a]
    assert min(toks) >= tf["tokens"]["min"] and max(toks) <= tf["tokens"]["max"]
    assert abs(np.median(toks) - tf["tokens"]["median"]) <= 0.1 * tf["tokens"]["median"]
    assert all(0 <= r["spk"] < data["n_speakers"] for r in a)
    assert all(r["text"].shape == (r["tokens"], data["text_channels"]) for r in a)
    # another seed: the same sizes in another order, other contents
    assert sorted(toks) == sorted(r["tokens"] for r in c)
    assert toks != [r["tokens"] for r in c]
    assert not np.array_equal(a[0]["emo"], c[0]["emo"])


def test_block_order_repeats_the_sizes_in_every_block():
    sizes = traffic.lognormal_sizes({"median": 150, "sigma": 0.45, "min": 48, "max": 384}, 64)
    order = traffic.block_order(sizes, 3, SEEDS[2])
    for k in range(3):
        assert sorted(order[64 * k:64 * (k + 1)]) == sorted(sizes)


def test_corpus_fills_every_bucket_with_whole_batches():
    tf, data = _traffic("train-b32"), _config("base")["data"]
    secs = traffic.corpus_seconds(tf["corpus"], data, 32)
    frames = (secs * data["sampling_rate"]).astype(int) // data["hop_length"]
    counts = np.histogram(frames, tf["corpus"]["buckets"])[0]
    assert all(c > 0 and c % 32 == 0 for c in counts)
    assert secs.min() >= tf["corpus"]["seconds"]["min"]
    assert secs.max() <= tf["corpus"]["seconds"]["max"]
    assert (secs * data["sampling_rate"]).max() < data["max_wav_len"]
    assert abs(np.median(secs) - tf["corpus"]["seconds"]["median"]) < 0.5


def test_corpus_is_seeded(tmp_path):
    from benchmark.tests.tiny import TINY_CONFIG, TRAFFIC
    spec, data = TRAFFIC["train"]["corpus"], TINY_CONFIG["data"]
    a = traffic.write_corpus(str(tmp_path / "a"), spec, data, SEEDS[1], 4)
    b = traffic.write_corpus(str(tmp_path / "b"), spec, data, SEEDS[1], 4)
    c = traffic.write_corpus(str(tmp_path / "c"), spec, data, SEEDS[2], 4)
    assert len(a) == len(b) == len(c) and len(a) % 4 == 0
    for la, lb in zip(a, b):
        for fa, fb in zip(la.split("|")[:3], lb.split("|")[:3]):
            with open(fa, "rb") as f1, open(fb, "rb") as f2:
                assert f1.read() == f2.read()
        assert la.split("|")[3] == lb.split("|")[3]
    sizes = lambda lines: sorted(os.path.getsize(ln.split("|")[1]) for ln in lines)  # noqa: E731
    assert sizes(a) == sizes(c)
