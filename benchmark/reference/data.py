"""The training data pipeline (counterpart of vits_tpu/train/data.py): scp
datasets, length-bucketed sampling, static-shape batches, and a thread-pool
prefetcher that places batches on the device.

  * TextAudioSpeakerDataset: scp lines `vecfn|wavfn|emofn|sid`, float32 .vec
    text vectors, peak-normalized wavs, 1024-d .emo embeddings, the length
    filter, and the `.spec.npy` cache beside the wav in the JAX package's
    format (either package reads the other's).
  * BucketSampler: the JAX package's batches index for index (numpy
    `RandomState(epoch)`, pad-to-divisible replication, rank striding).
  * collate: zero pads to static shapes (text to a multiple of 32, spec to
    the bucket's bound), the reflect tail of spec-less batches, and compact
    batches (int16 wav, bfloat16 text and emotion vectors, rounded by torch
    as ml_dtypes rounds them). Returns CPU tensors.
  * Prefetcher: batches built in a thread pool, yielded in sampler order
    across epochs by one `stream`; `place` copies them to the device at most
    `place_depth` batches ahead (`place_batch`: pinned host buffers,
    non-blocking copies).
"""

from __future__ import annotations

import itertools
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.audio import load_wav_norm, spectrogram_np, wav_meta


def load_filepaths_and_sid(filename: str, split: str = "|") -> List[List[str]]:
    with open(filename, encoding="utf-8") as f:
        return [line.strip().split(split) for line in f if line.strip()]


def load_binfn(filename: str, dim: int) -> np.ndarray:
    return np.fromfile(filename, dtype=np.float32).reshape(-1, dim)


class TextAudioSpeakerDataset:
    """scp-driven dataset with the spectrogram cached beside each wav.
    load_spec=False computes no spectrogram on the host: the training step
    computes it on the device from the wav. Eval datasets keep it (their
    items' "spec" gives the ground-truth mel)."""

    def __init__(self, filepaths_sid_file: str, hps, cache_spec: bool = True,
                 load_spec: bool = True):
        self.items = load_filepaths_and_sid(filepaths_sid_file)
        self.load_spec = load_spec
        d, t = hps.data, hps.train
        self.sampling_rate = d.sampling_rate
        self.filter_length = d.filter_length
        self.hop_length = d.hop_length
        self.win_length = d.win_length
        self.text_channels = d.text_channels
        self.segment_size = t.segment_size
        self.min_text_len = getattr(d, "min_text_len", 2)
        self.max_text_len = getattr(d, "max_text_len", 384)
        self.min_wav_len = max(self.segment_size, getattr(d, "min_wav_len", 0))
        self.max_wav_len = getattr(d, "max_wav_len", 10 * self.sampling_rate)
        self.cache_spec = cache_spec
        self._filter()
        order = np.random.RandomState(1234).permutation(len(self.items))
        self.items = [self.items[i] for i in order]
        self.lengths = [self.lengths[i] for i in order]
        self.text_lengths = [self.text_lengths[i] for i in order]

    def _filter(self):
        """Length filters and spec-frame lengths for bucketing, from file
        sizes and wav headers alone."""
        kept, lengths, text_lengths = [], [], []
        for entry in self.items:
            vecfn, wavfn = entry[0], entry[1]
            try:
                vec_len = os.path.getsize(vecfn) // (4 * self.text_channels)
                wav_len, _ = wav_meta(wavfn)
            except (OSError, ValueError):
                continue
            if self.min_text_len < vec_len < self.max_text_len and \
               self.min_wav_len < wav_len < self.max_wav_len:
                kept.append(entry)
                lengths.append(wav_len // self.hop_length)
                text_lengths.append(vec_len)
        self.items = kept
        self.lengths = lengths
        self.text_lengths = text_lengths

    def __len__(self):
        return len(self.items)

    def _wav(self, wavfn: str) -> np.ndarray:
        wav, sr = load_wav_norm(wavfn)
        if sr != self.sampling_rate:
            raise ValueError(f"{wavfn}: {sr} != target {self.sampling_rate}")
        return wav

    def get_audio(self, wavfn: str) -> Tuple[np.ndarray, np.ndarray]:
        wav = self._wav(wavfn)
        spec_fn = wavfn[:-len(".wav")] + ".spec.npy"
        spec = None
        if self.cache_spec and os.path.exists(spec_fn):
            try:
                spec = np.load(spec_fn)
            except (OSError, ValueError, EOFError):
                spec = None
        if spec is None:
            spec = spectrogram_np(wav, self.filter_length, self.hop_length, self.win_length)
            if self.cache_spec:
                try:
                    np.save(spec_fn, spec)
                except OSError:
                    pass
        return spec, wav

    def __getitem__(self, index: int):
        vecfn, wavfn, emofn, sid = self.items[index][:4]
        vec = load_binfn(vecfn, self.text_channels)
        emo = load_binfn(emofn, 1024).reshape(-1)[:1024]
        if self.load_spec:
            spec, wav = self.get_audio(wavfn)
            return {"vec": vec, "spec": spec, "wav": wav, "emo": emo, "sid": int(sid)}
        return {"vec": vec, "wav": self._wav(wavfn), "emo": emo, "sid": int(sid)}


DEFAULT_BOUNDARIES = [32, 300, 400, 500, 600, 700, 800, 900, 1000]


class BucketSampler:
    """Deterministic length-bucketed batch sampler (the reference's
    DistributedBucketSampler): num_replicas/rank stride the batches over
    data-parallel processes."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 boundaries: Sequence[int] = DEFAULT_BOUNDARIES,
                 num_replicas: int = 1, rank: int = 0, shuffle: bool = True):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.buckets = self._create_buckets()
        total_bs = num_replicas * batch_size
        self.num_samples_per_bucket = [
            len(b) + ((total_bs - len(b) % total_bs) % total_bs) for b in self.buckets]
        self.total_size = sum(self.num_samples_per_bucket)
        self.num_samples = self.total_size // num_replicas

    def _bisect(self, x):
        for i in range(len(self.boundaries) - 1):
            if self.boundaries[i] < x <= self.boundaries[i + 1]:
                return i
        return -1

    def _create_buckets(self):
        buckets = [[] for _ in range(len(self.boundaries) - 1)]
        for i, l in enumerate(self.lengths):
            idx = self._bisect(l)
            if idx != -1:
                buckets[idx].append(i)
        for i in range(len(buckets) - 1, 0, -1):
            if len(buckets[i]) == 0:
                buckets.pop(i)
                self.boundaries.pop(i + 1)
        return buckets

    def bucket_upper_bound(self, bucket_idx: int) -> int:
        return self.boundaries[bucket_idx + 1]

    def epoch_batches(self, epoch: int) -> List[Tuple[int, List[int]]]:
        """[(bucket_idx, [dataset indices])] for this rank and epoch."""
        g = np.random.RandomState(epoch)
        batches = []
        for bi, bucket in enumerate(self.buckets):
            if not bucket:
                continue
            ids = list(g.permutation(len(bucket))) if self.shuffle else list(range(len(bucket)))
            num_samples = self.num_samples_per_bucket[bi]
            rem = num_samples - len(bucket)
            ids = ids + ids * (rem // len(bucket)) + ids[:rem % len(bucket)]
            ids = ids[self.rank::self.num_replicas]
            for j in range(len(ids) // self.batch_size):
                batch = [bucket[k] for k in ids[j * self.batch_size:(j + 1) * self.batch_size]]
                batches.append((bi, batch))
        if self.shuffle:
            order = g.permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches

    def __len__(self):
        return self.num_samples // self.batch_size


def collate(samples: List[dict], text_pad_to: int, spec_pad_to: int,
            hop_length: int, reflect_tail: int = 0,
            compact: bool = False) -> Dict[str, torch.Tensor]:
    """Zero-pad to static shapes, sorted by spec length, longest first: text
    to text_pad_to, spec frames to spec_pad_to, the wav to spec_pad_to * hop.

    Samples without "spec" give a batch without one, whose spectrogram the
    step computes on the device: the wav then carries `reflect_tail` (the
    STFT's n_fft) more samples past each utterance's frame-count cut, the
    source's own samples where it runs past the cut (an utterance longer
    than the bucket's bound) and a mirror at its true end, which is what a
    reflect-padded STFT of the whole utterance sees.

    compact: the wav as int16 PCM at 32767, the text and emotion vectors in
    bfloat16 (what a bf16 step computes in), about half the host-to-device
    bytes."""
    with_spec = "spec" in samples[0]
    frames = (lambda s: s["spec"].shape[0]) if with_spec \
        else (lambda s: len(s["wav"]) // hop_length)
    order = np.argsort([-frames(s) for s in samples])
    samples = [samples[i] for i in order]
    B = len(samples)
    C_text = samples[0]["vec"].shape[1]
    wav_pad_to = spec_pad_to * hop_length + (0 if with_spec else reflect_tail)
    out = {
        "x": np.zeros((B, text_pad_to, C_text), np.float32),
        "x_lengths": np.zeros((B,), np.int32),
        "spec_lengths": np.zeros((B,), np.int32),
        "wav": np.zeros((B, wav_pad_to), np.float32),
        "wav_lengths": np.zeros((B,), np.int32),
        "emo": np.zeros((B, 1024), np.float32),
        "sid": np.zeros((B,), np.int32),
    }
    if with_spec:
        F = samples[0]["spec"].shape[1]
        out["spec"] = np.zeros((B, spec_pad_to, F), np.float32)
    for i, s in enumerate(samples):
        tl = min(s["vec"].shape[0], text_pad_to)
        sl = min(frames(s), spec_pad_to)
        wl = min(len(s["wav"]), spec_pad_to * hop_length)
        out["x"][i, :tl] = s["vec"][:tl]
        out["x_lengths"][i] = tl
        if with_spec:
            out["spec"][i, :sl] = s["spec"][:sl]
        out["spec_lengths"][i] = sl
        out["wav"][i, :wl] = s["wav"][:wl]
        out["wav_lengths"][i] = wl
        if reflect_tail and wl >= 2:
            k = min(reflect_tail, wav_pad_to - wl)
            avail = min(k, len(s["wav"]) - wl)  # the source's samples past the cut first
            if avail > 0:
                out["wav"][i, wl:wl + avail] = s["wav"][wl:wl + avail]
            end = wl + max(avail, 0)
            kk = min(k - max(avail, 0), end - 1)
            if kk > 0:  # then the mirror at the source's true end
                out["wav"][i, end:end + kk] = s["wav"][end - 2 - np.arange(kk)]
        out["emo"][i] = s["emo"]
        out["sid"][i] = s["sid"]
    if compact:
        out["wav"] = np.clip(np.rint(out["wav"] * 32767.0), -32767, 32767).astype(np.int16)
    batch = {k: torch.from_numpy(v) for k, v in out.items()}
    if compact:
        batch["x"] = batch["x"].to(torch.bfloat16)
        batch["emo"] = batch["emo"].to(torch.bfloat16)
    return batch


def quantize_text_len(n: int, quantum: int = 32, cap: int = 384) -> int:
    return min(((n + quantum - 1) // quantum) * quantum, cap)


def pin_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch in page-locked host memory (the source of a non-blocking
    copy); `wav_lengths` stays pageable, as it never leaves the host."""
    return {k: v if k == "wav_lengths" else v.pin_memory() for k, v in batch.items()}


def place_batch(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """`place` for a CUDA device: a pinned batch (`pin_batch`) copied with
    `non_blocking=True` on the current stream; `wav_lengths` stays on the
    host. PyTorch's caching host allocator records an event for each such
    copy and reuses no pinned block before it completes, so the host
    tensors may be dropped at once."""
    return {k: v if k == "wav_lengths" else v.to(device, non_blocking=True)
            for k, v in batch.items()}


class Prefetcher:
    """Thread-pool batch producer: `workers` batches build concurrently
    (file reads and numpy release the GIL) and are yielded in sampler order.

    Text is padded statically per bucket (the bucket's longest text,
    quantized), so the step sees one shape per bucket. `transform` (host to
    host, e.g. `pin_batch`) runs in the worker threads; `place` (host to
    device, e.g. `place_batch`) runs in the consumer's thread at most
    `place_depth` batches ahead of it, so that few batches sit on the
    device at once while their copies overlap the steps before them."""

    def __init__(self, dataset, sampler: BucketSampler, text_quantum: int = 32,
                 depth: int = 2, transform=None, workers: int = 8,
                 compact: bool = False, place=None, place_depth: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.text_quantum = text_quantum
        self.depth = depth
        self.transform = transform
        self.workers = max(1, workers)
        self.compact = compact
        self.place = place
        self.place_depth = max(0, place_depth)
        self._bucket_text_pad = None

    def _text_pads(self):
        """bucket_idx -> static text pad (None when the dataset has no
        text-length metadata; collate then pads to the batch's longest)."""
        if self._bucket_text_pad is None:
            tl = getattr(self.dataset, "text_lengths", None)
            pads = {}
            for bi, bucket in enumerate(self.sampler.buckets):
                if tl and bucket:
                    mx = max(tl[i] for i in bucket)
                    pads[bi] = max(quantize_text_len(mx, self.text_quantum,
                                                     self.dataset.max_text_len),
                                   self.text_quantum)
                else:
                    pads[bi] = None
            self._bucket_text_pad = pads
        return self._bucket_text_pad

    def _build(self, bi: int, idxs: List[int]):
        samples = [self.dataset[i] for i in idxs]
        text_pad = self._text_pads().get(bi)
        if text_pad is None:
            text_pad = max(quantize_text_len(max(s["vec"].shape[0] for s in samples),
                                             self.text_quantum, self.dataset.max_text_len),
                           self.text_quantum)
        spec_pad = self.sampler.bucket_upper_bound(bi)
        tail = 0 if getattr(self.dataset, "load_spec", True) else self.dataset.filter_length
        b = collate(samples, text_pad, spec_pad, self.dataset.hop_length,
                    reflect_tail=tail, compact=self.compact)
        if self.transform is not None:
            b = self.transform(b)
        return b

    def _host_stream(self, start_epoch: int, end_epoch: int):
        def tasks():
            for epoch in range(start_epoch, end_epoch + 1):
                for bi, idxs in self.sampler.epoch_batches(epoch):
                    yield epoch, bi, idxs

        window = self.depth + self.workers
        ex = ThreadPoolExecutor(max_workers=self.workers, thread_name_prefix="vits-prefetch")
        try:
            pending = deque()
            it = tasks()
            for ep, bi, idxs in itertools.islice(it, window):
                pending.append((ep, ex.submit(self._build, bi, idxs)))
            for ep, bi, idxs in it:
                e0, fut = pending.popleft()
                yield e0, fut.result()
                pending.append((ep, ex.submit(self._build, bi, idxs)))
            while pending:
                e0, fut = pending.popleft()
                yield e0, fut.result()
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def stream(self, start_epoch: int, end_epoch: int):
        """Yields (epoch, batch) from start_epoch through end_epoch with one
        worker pool, so the window stays full across epoch boundaries.
        Batches are placed on the device (place_depth ahead) when a `place`
        was given, else they are the host's tensors."""
        host = self._host_stream(start_epoch, end_epoch)
        try:
            if self.place is None:
                yield from host
                return
            placed = deque()
            for ep, b in host:
                placed.append((ep, self.place(b)))
                if len(placed) > self.place_depth:
                    yield placed.popleft()
            while placed:
                yield placed.popleft()
        finally:
            host.close()  # a consumer that stops early shuts the worker pool down

    def epoch(self, epoch: int):
        """The batches of one epoch, in sampler order."""
        for _, b in self.stream(epoch, epoch):
            yield b
