"""WAV I/O and the host-side numpy spectrogram (own copy of
vits_tpu/utils/audio.py: `read_wav`, `wav_meta`, `load_wav_norm`,
`spectrogram_np`, `write_wav` at 16-bit PCM mono, `wav_header`).

numpy only. The JAX package loads wavs and frames signals through its
optional native library when that is built, else through these same numpy
paths; its native peak normalization multiplies by the reciprocal of the
peak where numpy divides, so the two may differ by an ulp. The port follows
the numpy paths, which the JAX package takes when the library is absent.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(float32 samples in [-1, 1] before normalization, sample rate) of a
    RIFF/WAVE file: PCM 16/24/32 bit or float32; several channels are
    averaged to mono."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 3 or (audio_format == 0xFFFE and bits == 32):
        x = np.frombuffer(raw, dtype=np.float32).astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif bits == 32:
        x = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"{path}: unsupported WAV format {audio_format}/{bits}bit")
    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    return x, sample_rate


def wav_meta(path: str) -> Tuple[int, int]:
    """(mono samples, sample rate) from the WAV header alone, seeking past
    every chunk but `fmt `: the dataset's length filter reads no payload."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data_size = None
        while True:
            ch = f.read(8)
            if len(ch) < 8:
                break
            cid, size = ch[:4], struct.unpack("<I", ch[4:8])[0]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", f.read(16))
                f.seek(size - 16 + (size & 1), 1)
            else:
                if cid == b"data":
                    data_size = size
                f.seek(size + (size & 1), 1)
            if fmt is not None and data_size is not None:
                break
    if fmt is None or data_size is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    _, n_channels, sample_rate, _, block_align, bits = fmt
    denom = block_align or (max(n_channels, 1) * (bits // 8))
    return data_size // max(denom, 1), sample_rate


def load_wav_norm(path: str) -> Tuple[np.ndarray, int]:
    """Peak-normalized float32 load (the reference's load_wav_to_torch)."""
    x, sr = read_wav(path)
    peak = np.abs(x).max()
    if peak > 0:
        x = x / peak
    return x.astype(np.float32), sr


def _hann(win_length: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def spectrogram_np(y: np.ndarray, n_fft: int, hop_length: int, win_length: int) -> np.ndarray:
    """y (T,) float32 -> (T', F) linear magnitudes: center=False after a
    reflect pre-pad of (n_fft - hop) / 2, sqrt(power + 1e-6), the training
    step's `spectrogram`."""
    window = np.zeros(n_fft, dtype=np.float32)
    lpad = (n_fft - win_length) // 2
    window[lpad:lpad + win_length] = _hann(win_length)
    pad = (n_fft - hop_length) // 2
    yp = np.pad(y, (pad, pad), mode="reflect")
    n_frames = (len(yp) - n_fft) // hop_length + 1
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(yp[idx] * window, axis=-1)
    return np.sqrt(spec.real.astype(np.float32) ** 2 + spec.imag.astype(np.float32) ** 2 + 1e-6)


def write_wav(path: str, x: np.ndarray, sample_rate: int):
    """Write mono float32 [-1, 1] samples as 16-bit PCM WAV."""
    x = np.round(np.clip(np.asarray(x, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
    raw = x.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                      sample_rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(raw)) + raw)


def wav_header(data_len: int, sample_rate: int, bits: int = 16, channels: int = 1) -> bytes:
    """Standalone 44-byte WAV header for responses built from PCM bytes."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return (b"RIFF" + struct.pack("<I", 36 + data_len) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                    byte_rate, block_align, bits)
            + b"data" + struct.pack("<I", data_len))
