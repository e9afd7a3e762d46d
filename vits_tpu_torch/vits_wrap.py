"""Text -> speech product pipeline on the port (counterpart of
vits_tpu/vits_wrap.py): a text frontend, punctuation-aware golden-ratio
sentence splitting for long inputs, per-segment synthesis through
`vits_tpu_torch.infer.EmoVITS`, prosody controls (volume, speed via the
duration rate, pitch via resampling, an optional bandwidth-extension hook,
tail silence), 16-bit WAV packing with its header, and RTF, frontend and
backend timing and per-segment metadata in the response.

The `textparser` frontend (text -> (N, text_channels) float vectors) is an
external package; any callable `frontend(utt_id, text) -> (utt_id, segtext,
vectors)` can stand in, and without one the deterministic `HashTextFrontend`
keeps the pipeline drivable end to end.

`VITSWrap` runs its model on `cuda` unless `device="cpu"` is passed.
"""

from __future__ import annotations

import os
import sys
import time
from fractions import Fraction
from typing import Callable, Optional

import numpy as np

from vits_tpu_torch.infer import EmoVITS
from vits_tpu_torch.utils.audio import wav_header
from vits_tpu_torch.version import __version__


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy), replacing librosa.resample."""
    if orig_sr == target_sr:
        return wav
    from scipy.signal import resample_poly
    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    return resample_poly(wav, frac.numerator, frac.denominator).astype(np.float32)


# Separator tiers for long-text splitting, strongest first. Tiers are tried
# in order; within a tier, each separator is tried backward-from-anchor then
# forward-from-anchor before moving to the next. `guard` marks separators
# that must not be cut when either neighbouring character is a digit, so
# decimals ("3.14"), clock times ("10:30"), and thousand groups ("1,000")
# stay intact.
_SPLIT_TIERS = (
    (("。", "！", "!", "？", "?", "；", ";", "，"), False),
    ((".", ",", ":", "："), True),
    (("——", "……", "、", "（", "）", "(", ")", "[", "]", "【", "】"), False),
    (("~", " ", "\t"), False),
)


def _digit_flanked(text: str, start: int, end: int, limit: int) -> bool:
    """True when the separator text[start:end] touches a digit on either side
    or sits at a boundary where a neighbour is missing (both neighbours must
    exist inside [0, limit) for the cut to be considered safe)."""
    if start - 1 < 0 or end >= limit:
        return True
    return text[start - 1].isdigit() or text[end].isdigit()


def _next_cut(text: str, window: int) -> int:
    """Index to cut `text` at for its next segment: the separator nearest the
    golden-ratio anchor of the window, searched tier by tier. Falls back to a
    hard cut at the window edge when no separator qualifies."""
    anchor = int(window * 0.618)
    if len(text) < anchor + 2:
        return len(text)
    # a double-width separator sitting exactly on the anchor wins outright
    if text[anchor:anchor + 2] in ("——", "……"):
        return anchor + 2
    for seps, guard in _SPLIT_TIERS:
        for sep in seps:
            w = len(sep)
            # nearest occurrence strictly inside the pre-anchor prefix
            i = text.rfind(sep, 0, anchor)
            if i >= 0 and not (guard and _digit_flanked(text, i, i + w, anchor)):
                return i + w
            # else nearest occurrence at/after the anchor, still in-window
            i = text.find(sep, anchor)
            if 0 <= i < window and not (guard and _digit_flanked(text, i, i + w, len(text))):
                return i + w
    return min(len(text), window)


def split_long_text(text: str, max_utt_length: int) -> list:
    """Split `text` into pieces no longer than max_utt_length (+1 for an
    appended comma on hard cuts), cutting at punctuation near the golden-ratio
    point of each window. Empty input becomes a single "。" stop."""
    text = (text or "。").strip()
    if len(text) <= max_utt_length:
        return [text]
    pieces = []
    while text:
        cut = _next_cut(text, max_utt_length)
        if cut > max_utt_length:  # double-width separator straddling the edge
            cut = max_utt_length - 1
            pieces.append(text[:cut] + "，")
        else:
            pieces.append(text[:cut])
        text = text[cut:]
    return pieces


class _SegText:
    """Minimal segtext carrier with the frontend's .printer() surface."""

    def __init__(self, text: str):
        self.text = text

    def printer(self):
        return self.text


class HashTextFrontend:
    """Deterministic text→vector stub standing in for the external
    `textparser` package (one frame per character, seeded by char codes).
    For production, install/point to a real frontend with the same signature."""

    max_utt_length = 64

    def __init__(self, text_channels: int = 256, loglv: int = 0):
        self.text_channels = text_channels

    def update(self):
        pass

    def __call__(self, utt_id: str, utt_text: str):
        n = max(len(utt_text), 1)
        vec = np.zeros((n, self.text_channels), np.float32)
        for i, ch in enumerate(utt_text):
            rng = np.random.RandomState(ord(ch) % (2 ** 31))
            vec[i] = rng.randn(self.text_channels).astype(np.float32) * 0.5
        return utt_id, _SegText(utt_text), vec


class VITSWrap:
    default_spkid = 1
    default_volume = 1.0
    default_speed = 1.0
    default_pitch = 1.0
    default_tail_silence = 0.0  # seconds

    def __init__(self, ckpt_path: Optional[str] = None, *, device=None, loglv: int = 0,
                 frontend: Optional[Callable] = None, bandwidth_ext=None,
                 compute_dtype=None, quantize: Optional[bool] = None):
        self.loglv = loglv
        self.speecher = EmoVITS(ckpt_path, device=device, loglv=loglv,
                                compute_dtype=compute_dtype, quantize=quantize)
        if frontend is None:
            try:
                from textparser import TextParser  # external, optional
                frontend = TextParser(loglv=loglv)
            except ImportError:
                frontend = HashTextFrontend(self.speecher.text_channels, loglv)
        self.textparser = frontend
        self.asv = bandwidth_ext  # fbandext equivalent hook
        self.default_sampling_rate = self.speecher.sampling_rate
        self.max_utt_length = getattr(frontend, "max_utt_length", 64)
        if loglv > 0:
            sys.stderr.write(f"VITSWrap: init Successful, version={__version__}!\n")

    def update(self):
        self.textparser.update()
        self.speecher.update()

    def _parse_input(self, inputs):
        volume = max(0.0, min(1.0, float(inputs.get("volume", self.default_volume))))
        speed = max(0.5, min(2.0, float(inputs.get("speed", self.default_speed))))
        pitch = max(0.5, min(2.0, float(inputs.get("pitch", self.default_pitch))))
        sampling_rate = min(48000, max(8000, int(inputs.get("sampling_rate", self.default_sampling_rate))))
        tail_silence = float(inputs.get("tail_silence", self.default_tail_silence))
        speed /= pitch  # pitch shift borrows duration then resamples back
        utt_id = inputs.get("id", str(time.time()).replace(".", "_"))
        utt_text = inputs.get("text", "。")
        spkid = int(inputs.get("spkid", self.default_spkid))
        emotion = inputs.get("emotion")
        return (inputs, utt_id, utt_text, spkid, volume, speed, pitch,
                sampling_rate, tail_silence, emotion)

    # --- long-text splitting ---
    # Behaviour contract (vits_tpu's, pinned by tests/test_split_golden.py;
    # tests/test_torch_wrap.py holds this copy to it): cut as close as
    # possible to the golden-ratio point of the window, preferring stronger
    # punctuation, never cutting inside a digit-flanked ./,/: (decimals,
    # times, thousand groups).
    def _split_utt_text(self, utt_id, utt_text):
        texts = split_long_text(utt_text, self.max_utt_length)
        if len(texts) == 1:
            return [utt_id], texts
        return [f"{utt_id}-{k}" for k in range(len(texts))], texts

    def _postprocess_rate(self, wav: np.ndarray, pitch: float,
                          sampling_rate: int) -> np.ndarray:
        """Pitch shift (the synthesis borrowed duration; resample restores
        pitch), optional bandwidth-extension hook, then target-rate
        conversion."""
        if pitch != 1.0:
            wav = resample(wav, orig_sr=int(self.default_sampling_rate / pitch),
                           target_sr=self.default_sampling_rate)
        sr = self.default_sampling_rate
        if sampling_rate > sr and self.asv is not None:
            wav, sr = self.asv.infer(wav[None], sr)
            wav = np.squeeze(wav, axis=0)
        if sampling_rate != sr:
            wav = resample(wav, orig_sr=sr, target_sr=sampling_rate)
        return wav

    def speaking(self, inputs: dict) -> dict:
        """One-shot synthesis: split → frontend → synthesize → post-process
        per segment, then pack a single WAV response with per-segment
        timestamps and frontend/backend timing."""
        (inputs, utt_id, utt_text, spkid, volume, speed, pitch,
         sampling_rate, tail_silence, emotion) = self._parse_input(inputs)

        ids, texts = self._split_utt_text(utt_id, utt_text)
        pcm_parts, marks = [], []
        native_samples = 0
        frontend_s = backend_s = 0.0
        cursor_ms = 0.0
        for uid, seg_text in zip(ids, texts):
            t0 = time.time()
            uid, segtext, vec = self.textparser(uid, seg_text)
            t1 = time.time()
            wav, emotion = self.speecher.infer(spkid, vec, emotion,
                                               duration_rate=speed)
            native_samples += len(wav)
            wav = self._postprocess_rate(wav, pitch, sampling_rate)
            pcm = np.clip(wav * volume * 32767, -32768, 32767).astype(np.int16)
            if tail_silence > 0:
                pcm = np.pad(pcm, (0, int(tail_silence * sampling_rate)))
            t2 = time.time()
            frontend_s += t1 - t0
            backend_s += t2 - t1
            pcm_parts.append(pcm)
            seg_ms = len(pcm) / sampling_rate * 1000
            marks.append({"start_ms": cursor_ms, "end_ms": cursor_ms + seg_ms,
                          "input_text": seg_text, "segtext": segtext.printer()})
            cursor_ms += seg_ms

        payload = b"".join(p.tobytes() for p in pcm_parts)
        outputs = dict(inputs)
        outputs["wav"] = wav_header(len(payload), sampling_rate, 16) + payload
        outputs["sr"] = sampling_rate
        outputs["segment_info"] = marks
        outputs["time_used_frontend"] = frontend_s * 1000
        outputs["time_used_backend"] = backend_s * 1000
        outputs["rtf"] = (frontend_s + backend_s) / max(
            native_samples / self.default_sampling_rate, 1e-9)
        return outputs

    def speaking_stream(self, inputs: dict):
        """Streaming synthesis: a generator of PCM16
        chunk dicts followed by one final metadata dict; concatenating the
        `pcm` fields reproduces `speaking()`'s WAV payload byte-for-byte at
        the model's native rate.

        Chunk granularity: at native sampling rate the audio streams at the
        decoder-window level (EmoVITS.infer_stream, time-to-first-audio ≈ one
        decode window). When pitch!=1 or a non-native sampling_rate is
        requested, resampling is stateless per call, so conversion happens on
        whole segments to avoid seam artifacts — granularity degrades to
        per-segment but long texts still stream segment-by-segment.

        Yields {"pcm": bytes, "sr": int, "seq": int, "segment_index": int},
        then {"final": True, "sr", "segment_info", "rtf", ...timings}.
        """
        (inputs, utt_id, utt_text, spkid, volume, speed, pitch,
         sampling_rate, tail_silence, emotion) = self._parse_input(inputs)

        batch_utt_id, batch_utt_text = self._split_utt_text(utt_id, utt_text)
        seq, total_samples = 0, 0
        segment_info, seg_start_ms, seg_end_ms = [], 0.0, 0.0
        frontend_s, backend_s = 0.0, 0.0
        native = (pitch == 1.0 and sampling_rate == self.default_sampling_rate)
        for seg_idx, (uid, text) in enumerate(zip(batch_utt_id, batch_utt_text)):
            start = time.time()
            uid, utt_segtext, utt_vector = self.textparser(uid, text)
            end = time.time()
            frontend_s += end - start

            start = end
            seg_samples = 0

            def emit(wav_f32):
                nonlocal seq, seg_samples
                pcm = np.clip(wav_f32 * volume * 32767, -32768, 32767).astype(np.int16)
                seg_samples += len(pcm)
                out = {"pcm": pcm.tobytes(), "sr": sampling_rate, "seq": seq,
                       "segment_index": seg_idx}
                seq += 1
                return out

            if native:
                for chunk in self.speecher.infer_stream(spkid, utt_vector,
                                                        emotion, duration_rate=speed):
                    total_samples += len(chunk)
                    t_emit = time.time()
                    yield emit(chunk)
                    start += time.time() - t_emit  # consumer time isn't backend time
            else:
                wav, emotion = self.speecher.infer(spkid, utt_vector, emotion,
                                                   duration_rate=speed)
                total_samples += len(wav)
                yield emit(self._postprocess_rate(wav, pitch, sampling_rate))
            if tail_silence > 0:
                yield emit(np.zeros(int(tail_silence * sampling_rate), np.float32))
            backend_s += time.time() - start

            seg_end_ms += seg_samples / sampling_rate * 1000
            segment_info.append({
                "start_ms": seg_start_ms, "end_ms": seg_end_ms,
                "input_text": text, "segtext": utt_segtext.printer(),
            })
            seg_start_ms = seg_end_ms

        rtf = (frontend_s + backend_s) / max(total_samples / self.default_sampling_rate, 1e-9)
        final = dict(inputs)
        final.pop("wav", None)
        final.update({"final": True, "sr": sampling_rate,
                      "segment_info": segment_info,
                      "time_used_frontend": frontend_s * 1000,
                      "time_used_backend": backend_s * 1000,
                      "rtf": rtf})
        yield final


def main(argv=None):
    """CLI synthesis: one utterance or a text file to WAV files."""
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", "-c", default=None, type=str)
    parser.add_argument("--emotion", "-e", default=None, type=str)
    parser.add_argument("--utterance", "-u", type=str)
    parser.add_argument("--textfile", "-t", type=str)
    parser.add_argument("--spkid", "--sid", "-i", type=int, default=1)
    parser.add_argument("--volume", "-v", type=float, default=1.0)
    parser.add_argument("--speed", "-s", type=float, default=1.0)
    parser.add_argument("--pitch", "-p", type=float, default=1.0)
    parser.add_argument("--tail-silence", "-a", type=float, default=0.0)
    parser.add_argument("--sampling-rate", "-r", type=int)
    parser.add_argument("--outdir", "-o", type=str, required=True)
    parser.add_argument("--outfn", "-n", type=str, required=True)
    parser.add_argument("--loglv", "-l", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    if args.utterance is None and args.textfile is None:
        raise ValueError("Please specify either --utterance or --textfile")
    os.makedirs(args.outdir, exist_ok=True)
    mytts = VITSWrap(args.checkpoint, device=args.device, loglv=args.loglv)

    emotion = args.emotion.split(":") if args.emotion is not None else None
    if emotion is not None:
        if os.path.exists(emotion[0]):
            emotion[0] = np.fromfile(emotion[0], dtype=np.float32).reshape(-1, 1024)
        else:
            emotion[0] = int(emotion[0])
        emotion = (emotion[0], int(emotion[1]) if len(emotion) > 1 else -1)

    inputs = {"spkid": args.spkid, "volume": args.volume, "speed": args.speed,
              "pitch": args.pitch, "emotion": emotion}
    if args.sampling_rate is not None:
        inputs["sampling_rate"] = args.sampling_rate
    if args.tail_silence is not None:
        inputs["tail_silence"] = max(0, args.tail_silence)

    utt_text = []
    if args.utterance is not None:
        utt_text.append(args.utterance)
    if args.textfile is not None:
        with open(args.textfile, "rt") as f:
            utt_text += [l.strip() for l in f if l.strip()]

    outfn = args.outfn or ""
    if outfn and not outfn.lower().endswith(".wav"):
        for idx, text in enumerate(utt_text, 1):
            inputs["text"] = text
            outputs = mytts.speaking(inputs)
            with open(os.path.join(args.outdir, f"{outfn}{idx:06d}.wav"), "wb") as f:
                f.write(outputs.pop("wav"))
    else:
        inputs["text"] = " ".join(utt_text)
        outputs = mytts.speaking(inputs)
        with open(os.path.join(args.outdir, outfn), "wb") as f:
            f.write(outputs.pop("wav"))
    print("Done!")


if __name__ == "__main__":
    main()
