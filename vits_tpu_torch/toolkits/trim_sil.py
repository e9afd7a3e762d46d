"""Silence trimming (counterpart of vits_tpu/toolkits/trim_sil.py): a
top_db = 40 energy trim with a 50 ms margin on each side and half-peak
normalization, librosa.effects.trim's semantics on centred RMS frames,
without librosa.

    python -m vits_tpu_torch.toolkits.trim_sil <in_wav_dir> <out_wav_dir> [--sr 8000]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from vits_tpu_torch.utils.audio import load_wav_norm, write_wav


def trim_bounds(x: np.ndarray, top_db: float = 40.0, frame_length: int = 2048,
                hop_length: int = 512):
    """(start, end) samples of the non-silent part: centred RMS frames, the
    bounds hop * first_above .. hop * (last_above + 1), clipped to len(x)."""
    if len(x) < hop_length:
        return 0, len(x)
    pad = frame_length // 2
    xp = np.pad(x, (pad, pad))
    n = 1 + (len(xp) - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(np.square(xp[idx]), axis=1) + 1e-12)
    db = 20.0 * np.log10(rms / (rms.max() + 1e-12) + 1e-12)
    above = np.nonzero(db > -top_db)[0]
    if len(above) == 0:
        return 0, len(x)
    return above[0] * hop_length, min(len(x), (above[-1] + 1) * hop_length)


def trim_silence_file(infn: str, outfn: str, top_db: float = 40.0,
                      margin_s: float = 0.05, target_sr: int = 8000):
    """Read a wav (peak-normalized), resample it to target_sr, trim its
    silence with margin_s on each side and write it at half peak."""
    x, sr = load_wav_norm(infn)
    if sr != target_sr:
        from vits_tpu_torch.vits_wrap import resample
        x = resample(x, sr, target_sr)
        sr = target_sr
    xs, xe = trim_bounds(x, top_db)
    xs = max(0, xs - int(margin_s * sr))
    xe = min(len(x), xe + int(margin_s * sr))
    x = x[xs:xe]
    peak = np.abs(x).max()
    if peak > 0:
        x = x / (peak * 2.0)
    write_wav(outfn, x, sr)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("in_wav_dir", type=str)
    parser.add_argument("out_wav_dir", type=str)
    parser.add_argument("--sr", type=int, default=8000)
    args = parser.parse_args(argv)
    os.makedirs(args.out_wav_dir, exist_ok=True)
    count = 0
    for root, _, files in os.walk(args.in_wav_dir, followlinks=True):
        for fn in files:
            if fn.endswith(".wav"):
                trim_silence_file(os.path.join(root, fn), os.path.join(args.out_wav_dir, fn),
                                  target_sr=args.sr)
                count += 1
    print(f"count={count}, Done!")


if __name__ == "__main__":
    main()
