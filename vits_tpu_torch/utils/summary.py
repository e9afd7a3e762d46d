"""Logging and training summaries (own copy of vits_tpu/utils/summary.py):
`get_logger` (`train.log` in the run dir, and stdout), `SummaryWriter`
(TensorBoard through `torch.utils.tensorboard` where it imports, else a
JSONL event log with the last IMAGE_KEEP image renders per tag beside it as
`.npz`), `summarize`, `check_git_hash`, and the spectrogram and alignment
images as HWC uint8 arrays."""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger("vits_tpu_torch")


def get_logger(model_dir: str, filename: str = "train.log") -> logging.Logger:
    """A logger named after the run dir, writing to `<model_dir>/<filename>`
    and to stdout. Handlers of an earlier call for the same run dir are
    closed first, so a second run in one process logs each line once."""
    lg = logging.getLogger(os.path.basename(os.path.normpath(model_dir)))
    lg.setLevel(logging.DEBUG)
    for h in list(lg.handlers):
        lg.removeHandler(h)
        h.close()
    os.makedirs(model_dir, exist_ok=True)
    fmt = logging.Formatter("%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s")
    h = logging.FileHandler(os.path.join(model_dir, filename))
    h.setLevel(logging.DEBUG)
    h.setFormatter(fmt)
    lg.addHandler(h)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    lg.addHandler(sh)
    return lg


class SummaryWriter:
    """TensorBoard writer, or a JSONL event log where tensorboard does not
    import (audio is then not recorded, as in the JAX package)."""

    # JSONL fallback: rendered images kept on disk per tag (older ones deleted)
    IMAGE_KEEP = 4

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = None
        self._jsonl = None
        self._img_history: Dict[str, list] = {}
        try:
            from torch.utils.tensorboard import SummaryWriter as TB
            self._tb = TB(log_dir=log_dir)
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")

    def _event(self, record: dict):
        self._jsonl.write(json.dumps({"t": time.time(), **record}) + "\n")
        self._jsonl.flush()

    def add_scalar(self, tag, value, step):
        if self._tb:
            self._tb.add_scalar(tag, float(value), step)
        else:
            self._event({"step": int(step), "tag": tag, "value": float(value)})

    def add_image(self, tag, img_hwc, step):
        if self._tb:
            self._tb.add_image(tag, img_hwc, step, dataformats="HWC")
            return
        fn = f"img_{tag.replace('/', '_')}_{int(step)}.npz"
        try:
            np.savez_compressed(os.path.join(self.log_dir, fn), image=np.asarray(img_hwc))
            hist = self._img_history.setdefault(tag, [])
            hist.append(fn)
            while len(hist) > self.IMAGE_KEEP:
                try:
                    os.remove(os.path.join(self.log_dir, hist.pop(0)))
                except OSError:
                    pass
        except OSError:
            fn = None
        self._event({"step": int(step), "tag": tag, "image": fn})

    def add_audio(self, tag, audio, step, sample_rate):
        if self._tb:
            self._tb.add_audio(tag, np.asarray(audio).reshape(1, -1), step, sample_rate)

    def close(self):
        if self._tb:
            self._tb.close()
        elif self._jsonl is not None:
            self._jsonl.close()


def summarize(writer: SummaryWriter, global_step: int, scalars: Optional[Dict] = None,
              images: Optional[Dict] = None, audios: Optional[Dict] = None,
              audio_sampling_rate: int = 22050):
    for k, v in (scalars or {}).items():
        writer.add_scalar(k, v, global_step)
    for k, v in (images or {}).items():
        writer.add_image(k, v, global_step)
    for k, v in (audios or {}).items():
        writer.add_audio(k, v, global_step, audio_sampling_rate)


# viridis at five stops, interpolated linearly
_STOPS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98],
                   [253, 231, 37]], np.float32)


def _render(a: np.ndarray) -> np.ndarray:
    """(rows, cols) -> (rows, cols, 3) uint8, the first row at the bottom
    (matplotlib's origin="lower"), values scaled to their own range."""
    a = np.asarray(a, np.float32)[::-1]
    lo, hi = float(np.min(a)), float(np.max(a))
    u = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    pos = u * (len(_STOPS) - 1)
    i = np.clip(pos.astype(np.int64), 0, len(_STOPS) - 2)
    f = (pos - i)[..., None]
    return np.rint(_STOPS[i] * (1 - f) + _STOPS[i + 1] * f).astype(np.uint8)


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """spectrogram (C, T) -> an HWC uint8 image, frames along x, channels
    along y, one pixel per cell. A plain numpy render: the JAX package draws
    it with matplotlib (imported inside its function), which the port does
    not need; the tags and orientation are the same, the pixels are not."""
    return _render(spectrogram)


def plot_alignment_to_numpy(alignment: np.ndarray) -> np.ndarray:
    """alignment (T_y, T_x), the hard path -> an HWC uint8 image, decoder
    steps along x, encoder steps along y (a numpy render, as
    `plot_spectrogram_to_numpy`)."""
    return _render(np.asarray(alignment).T)


def check_git_hash(model_dir: str):
    """Record the source's git commit in `<model_dir>/githash`, or warn when
    it differs from the one recorded."""
    source_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.realpath(__file__))))
    if not os.path.exists(os.path.join(source_dir, ".git")):
        logger.warning("%s is not a git repository; hash comparison ignored", source_dir)
        return
    try:
        cur_hash = subprocess.run(["git", "rev-parse", "HEAD"], cwd=source_dir,
                                  capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        logger.warning("git is not available; hash comparison ignored")
        return
    path = os.path.join(model_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            saved = f.read()
        if saved != cur_hash:
            logger.warning("git hash mismatch: %s(saved) != %s(current)",
                           saved[:8], cur_hash[:8])
    else:
        os.makedirs(model_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(cur_hash)
