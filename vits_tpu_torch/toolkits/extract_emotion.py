"""Emotion embeddings, 1024-d per utterance (counterpart of
vits_tpu/toolkits/extract_emotion.py), written as float32 `.emo` files.

The production embedding is the mean-pooled hidden states of the audeering
wav2vec2 emotion model, read through `transformers` from a local copy
(`model_path`: a directory or a cached hub id; nothing is downloaded), or
an exported ONNX model through `onnxruntime` (a `.onnx` file, or a directory
holding `model.onnx`). Neither the weights nor onnxruntime are in the
repository; a missing package raises ImportError. Without `model_path` the
default model serves where it is in the local hub cache, and otherwise the
deterministic spectral-statistics fallback is taken, and logged: band log
energies and their modulation statistics tiled to 1024 dims, for pipeline
plumbing only. The cache is looked up before `transformers` is imported
(an import that can take tens of seconds). The wav2vec2 model runs on
`device` (`cuda` unless "cpu"); the ONNX session and the fallback run on
the host.

    python -m vits_tpu_torch.toolkits.extract_emotion --wavdir <dir> [--outdir <dir>] [--model <path>] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional

import numpy as np

from vits_tpu_torch.device import resolve_device
from vits_tpu_torch.utils.summary import logger

DEFAULT_MODEL = "audeering/wav2vec2-large-robust-12-ft-emotion-msp-dim"
_model_cache = {}


def _load_w2v2(model_path: str, device):
    key = (model_path, str(device))
    if key in _model_cache:
        return _model_cache[key]
    try:
        from transformers import Wav2Vec2FeatureExtractor, Wav2Vec2Model
    except ImportError as e:
        raise ImportError("the wav2vec2 emotion model needs the `transformers` package, "
                          "which is not installed") from e
    fe = Wav2Vec2FeatureExtractor.from_pretrained(model_path, local_files_only=True)
    model = Wav2Vec2Model.from_pretrained(model_path, local_files_only=True).to(device).eval()
    _model_cache[key] = (fe, model)
    return _model_cache[key]


def _in_hub_cache(model_id: str) -> bool:
    """Whether a hub model's config is in the local cache (no network)."""
    try:
        from huggingface_hub import try_to_load_from_cache
    except ImportError:
        return False
    return isinstance(try_to_load_from_cache(model_id, "config.json"), str)


def extract_w2v2(wav: np.ndarray, sr: int, model_path: str = DEFAULT_MODEL,
                 device=None) -> np.ndarray:
    """Mean-pooled wav2vec2 hidden states -> (1024,) float32, the model on
    `device` (`cuda` unless "cpu")."""
    import torch
    dev = resolve_device(device)
    fe, model = _load_w2v2(model_path, dev)
    inputs = fe(wav, sampling_rate=sr, return_tensors="pt")
    with torch.no_grad():
        emb = model(inputs.input_values.to(dev)).last_hidden_state.mean(dim=1)[0]
    return emb.float().cpu().numpy()


def _is_onnx_model(model_path: Optional[str]) -> bool:
    """A `.onnx` file, or an audonnx-style directory holding `model.onnx`."""
    if not model_path:
        return False
    if model_path.endswith(".onnx"):
        return True
    return os.path.isdir(model_path) and os.path.exists(os.path.join(model_path, "model.onnx"))


def _onnx_session(model_path: str):
    try:
        import onnxruntime
    except ImportError as e:
        raise ImportError(f"{model_path} is an ONNX model, which needs the `onnxruntime` "
                          "package, and it is not installed") from e
    onnx_file = model_path if model_path.endswith(".onnx") \
        else os.path.join(model_path, "model.onnx")
    return onnxruntime.InferenceSession(onnx_file, providers=["CPUExecutionProvider"])


def extract_onnx(wav: np.ndarray, sr: int, model_path: str, session=None) -> np.ndarray:
    """The embedding of an exported ONNX wav2vec2 model (16 kHz input,
    peak-normalized; the pooled `hidden_states` head where it has one, else
    its first output, mean-pooled over time if it is not pooled). `session`
    may be given; by default a CPU session of `model_path` is made and
    kept."""
    key = ("onnx", model_path)
    if session is None:
        if key not in _model_cache:
            _model_cache[key] = _onnx_session(model_path)
        session = _model_cache[key]
    if sr != 16000:
        raise ValueError(f"ONNX emotion model expects 16 kHz input, got {sr}")
    x = wav.astype(np.float32)
    peak = np.max(np.abs(x))
    if peak > 0:
        x = x / peak
    feed_name = session.get_inputs()[0].name
    out_names = [o.name for o in session.get_outputs()]
    pick = "hidden_states" if "hidden_states" in out_names else out_names[0]
    (out,) = session.run([pick], {feed_name: x[None, :]})
    out = np.asarray(out, np.float32)
    if out.ndim == 3:
        out = out.mean(axis=1)
    return out.reshape(-1).astype(np.float32)


def extract_fallback(wav: np.ndarray, sr: int) -> np.ndarray:
    """Model-free stand-in: per frequency bin of a 512-point spectrogram,
    the mean, the std and the mean absolute delta of the log magnitudes,
    tiled to 1024 dims and standardized. Deterministic."""
    from vits_tpu_torch.utils.audio import spectrogram_np
    n_fft = 512
    spec = spectrogram_np(wav.astype(np.float32), n_fft, n_fft // 4, n_fft)  # (T, F)
    logspec = np.log(spec + 1e-5)
    delta = np.abs(np.diff(logspec, axis=0)).mean(0) if len(logspec) > 1 else logspec.mean(0)
    v = np.resize(np.concatenate([logspec.mean(0), logspec.std(0), delta]), 1024)
    v = (v - v.mean()) / (v.std() + 1e-6)
    return v.astype(np.float32)


def extract_to_file(wav_path: str, emo_path: str, model_path: Optional[str] = None,
                    device=None) -> np.ndarray:
    """Embed one wav into `emo_path`: an ONNX `model_path` through
    onnxruntime, another `model_path` through transformers on `device`
    (`cuda` unless "cpu"), none through the default model there where it is
    in the local hub cache, else the fallback (logged)."""
    from vits_tpu_torch.utils.audio import load_wav_norm
    dev = resolve_device(device)
    wav, sr = load_wav_norm(wav_path)
    if _is_onnx_model(model_path):
        emb = extract_onnx(wav, sr, model_path)
    elif model_path:
        emb = extract_w2v2(wav, sr, model_path, dev)
    elif _in_hub_cache(DEFAULT_MODEL):
        emb = extract_w2v2(wav, sr, DEFAULT_MODEL, dev)
    else:
        logger.info("emotion model %s is not in the local cache; using the spectral-"
                    "statistics fallback for %s", DEFAULT_MODEL, wav_path)
        emb = extract_fallback(wav, sr)
    emb.astype(np.float32).tofile(emo_path)
    return emb


def main(argv=None):
    parser = argparse.ArgumentParser(description="Extract 1024-d emotion embeddings.")
    parser.add_argument("--wavdir", type=str, required=True)
    parser.add_argument("--outdir", type=str, default=None, help="default: beside each wav")
    parser.add_argument("--model", type=str, default=None,
                        help="local wav2vec2 emotion model (transformers), or a .onnx file / "
                             "audonnx model dir (onnxruntime)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the wav2vec2 model runs: cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    wavs = sorted(glob.glob(os.path.join(args.wavdir, "**", "*.wav"), recursive=True))
    for w in wavs:
        out = (os.path.join(args.outdir, os.path.basename(w)[:-4] + ".emo")
               if args.outdir else w[:-4] + ".emo")
        extract_to_file(w, out, args.model, dev)
        print(out)


if __name__ == "__main__":
    main()
