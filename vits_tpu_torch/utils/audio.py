"""WAV output for the port's CLI and servers (own copy of
vits_tpu/utils/audio.py's write_wav, 16-bit PCM mono, and wav_header)."""

from __future__ import annotations

import struct

import numpy as np


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
