"""The port's data pipeline against the JAX package's on a synthetic corpus
(tests/test_loop.py's `make_corpus` and TINY `make_hps`, 20 utterances over
three length buckets).

Tolerance: none. Dataset items, cached spectrograms, the sampler's batches,
collated arrays (compact ones bit for bit: int16 equal, bfloat16 compared as
the int16 bit patterns of torch's and ml_dtypes' roundings) and the
prefetcher's stream are EQUAL. The JAX package reads wavs through its native
library when that is built (tests/test_native.py builds it), whose peak
normalization multiplies by the reciprocal where numpy divides; the port
copies the numpy paths, so the JAX side runs here with the library off.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import ml_dtypes

from test_loop import make_corpus, make_hps
from vits_tpu import native as j_native
from vits_tpu.train import data as J

from vits_tpu_torch.config import HParams
from vits_tpu_torch.train import data as T

N_UTT = 20


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    train_scp, valid_scp = make_corpus(tmp, n=N_UTT)
    hj = make_hps(tmp, train_scp, valid_scp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_load", lambda: None)
        yield tmp, train_scp, hj, HParams(**hj.to_dict())


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
    v = np.asarray(v)
    return v.view(np.int16) if v.dtype == ml_dtypes.bfloat16 else v


def _assert_batch_equal(bt, bj):
    assert set(bt) == set(bj)
    for k in bj:
        a, b = _np(bt[k]), _np(bj[k])
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("load_spec", [True, False])
def test_dataset_items_equal_jax(corpus, load_spec):
    tmp, scp, hj, ht = corpus
    dj = J.TextAudioSpeakerDataset(scp, hj, cache_spec=False, load_spec=load_spec)
    dt = T.TextAudioSpeakerDataset(scp, ht, cache_spec=False, load_spec=load_spec)
    assert dt.items == dj.items and dt.lengths == dj.lengths
    assert dt.text_lengths == dj.text_lengths and len(dt) == len(dj) > 0
    for i in range(len(dj)):
        it, ij = dt[i], dj[i]
        assert set(it) == set(ij) == ({"vec", "wav", "emo", "sid"} | ({"spec"} if load_spec
                                                                       else set()))
        assert it["sid"] == ij["sid"]
        for k in set(ij) - {"sid"}:
            assert it[k].dtype == ij[k].dtype, k
            np.testing.assert_array_equal(it[k], ij[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spec_cache_is_shared(corpus, tmp_path, writer):
    """A `.spec.npy` written beside the wav by one package is read, not
    recomputed, by the other: the cached file is scaled after it is written,
    and the reader returns the scaled array."""
    _, scp, hj, ht = corpus
    with open(scp) as f:
        lines = f.read().splitlines()[:3]
    local = []
    for ln in lines:
        vec, wav, emo, sid = ln.split("|")
        stem = tmp_path / wav.rsplit("/", 1)[1][:-len(".wav")]
        for src, ext in ((vec, ".vec"), (wav, ".wav"), (emo, ".emo")):
            shutil.copy(src, str(stem) + ext)
        local.append(f"{stem}.vec|{stem}.wav|{stem}.emo|{sid}")
    (tmp_path / "s.scp").write_text("\n".join(local))
    first, second = ((J, hj), (T, ht)) if writer == "jax" else ((T, ht), (J, hj))
    ds_w = first[0].TextAudioSpeakerDataset(str(tmp_path / "s.scp"), first[1])
    written = []
    for i in range(len(ds_w)):
        wav = ds_w.items[i][1]
        written.append(ds_w[i]["spec"])
        np.testing.assert_array_equal(np.load(wav[:-4] + ".spec.npy"), written[-1])
        np.save(wav[:-4] + ".spec.npy", written[-1] * 2)
    ds_r = second[0].TextAudioSpeakerDataset(str(tmp_path / "s.scp"), second[1])
    assert ds_r.items == ds_w.items
    for i in range(len(ds_r)):
        np.testing.assert_array_equal(ds_r[i]["spec"], written[i] * 2)


@pytest.mark.parametrize("replicas", [1, 2])
def test_bucket_sampler_batches_equal_jax(corpus, replicas):
    _, scp, hj, ht = corpus
    lengths = T.TextAudioSpeakerDataset(scp, ht, load_spec=False).lengths
    for rank in range(replicas):
        sj = J.BucketSampler(lengths, 2, hj.train.bucket_boundaries, replicas, rank)
        st = T.BucketSampler(lengths, 2, ht.train.bucket_boundaries, replicas, rank)
        assert st.buckets == sj.buckets and st.boundaries == sj.boundaries
        assert len(st) == len(sj) and len(st.buckets) > 1
        for epoch in (1, 2, 3):
            bt, bj = st.epoch_batches(epoch), sj.epoch_batches(epoch)
            assert [(b, [int(i) for i in ix]) for b, ix in bt] == \
                [(b, [int(i) for i in ix]) for b, ix in bj]


@pytest.mark.parametrize("case", ["spec", "no_spec", "truncated", "compact"])
def test_collate_equals_jax(corpus, case):
    """With the spec; without it (the reflect tail past each frame-count
    cut); without it at a bucket bound below the longest utterance (the
    source's samples past the cut, then the mirror); and compact."""
    _, scp, hj, ht = corpus
    ds = J.TextAudioSpeakerDataset(scp, hj, cache_spec=False, load_spec=case == "spec")
    samples = [ds[i] for i in range(5)]
    hop = hj.data.hop_length
    longest = max(len(s["wav"]) // hop for s in samples)
    spec_pad = longest - 7 if case == "truncated" else 64
    tail = 0 if case == "spec" else hj.data.filter_length
    kw = dict(reflect_tail=tail, compact=case == "compact")
    bj = J.collate(samples, 32, spec_pad, hop, **kw)
    bt = T.collate(samples, 32, spec_pad, hop, **kw)
    if case == "compact":
        assert bt["wav"].dtype == torch.int16 and bt["x"].dtype == torch.bfloat16
        assert bt["emo"].dtype == torch.bfloat16
    _assert_batch_equal(bt, bj)


def test_prefetcher_stream_equals_jax(corpus):
    """Two epochs through each package's Prefetcher (spec-less, compact):
    the same epochs, batches and static text pads, in order."""
    _, scp, hj, ht = corpus
    dj = J.TextAudioSpeakerDataset(scp, hj, load_spec=False)
    dt = T.TextAudioSpeakerDataset(scp, ht, load_spec=False)
    pj = J.Prefetcher(dj, J.BucketSampler(dj.lengths, 2, hj.train.bucket_boundaries),
                      workers=3, depth=1, compact=True)
    pt = T.Prefetcher(dt, T.BucketSampler(dt.lengths, 2, ht.train.bucket_boundaries),
                      workers=3, depth=1, compact=True)
    assert pt._text_pads() == pj._text_pads()
    sj, st = list(pj.stream(1, 2)), list(pt.stream(1, 2))
    assert [e for e, _ in st] == [e for e, _ in sj] and len(st) > 4
    for (_, bt), (_, bj) in zip(st, sj):
        _assert_batch_equal(bt, bj)


def test_prefetcher_places_batches_in_order(corpus):
    """With `place_batch` as its `place` (here onto the CPU), the stream
    yields the host stream's batches, equal array for array and in order."""
    _, scp, _, ht = corpus
    dt = T.TextAudioSpeakerDataset(scp, ht, load_spec=False)
    sampler = T.BucketSampler(dt.lengths, 2, ht.train.bucket_boundaries)
    host = list(T.Prefetcher(dt, sampler, workers=2, depth=1, compact=True).stream(1, 2))
    placed = list(T.Prefetcher(dt, sampler, workers=2, depth=1, compact=True,
                               place=functools.partial(T.place_batch, device="cpu"),
                               place_depth=1).stream(1, 2))
    assert [e for e, _ in placed] == [e for e, _ in host] and len(placed) > 4
    for (_, bp), (_, bh) in zip(placed, host):
        assert bp.keys() == bh.keys()
        for k in bh:
            assert bp[k].dtype == bh[k].dtype and torch.equal(bp[k], bh[k]), k


def test_quantize_text_len():
    for n in (1, 31, 32, 33, 383, 384, 500):
        assert T.quantize_text_len(n) == J.quantize_text_len(n)
        assert T.quantize_text_len(n, 16, 100) == J.quantize_text_len(n, 16, 100)
