"""The port's SAT flow (`vits_tpu_torch.sat`) and the toolkits it calls
(`toolkits.trim_sil`, `toolkits.extract_emotion`,
`toolkits.cluster_emotion`) against the JAX package's on the CPU: the same
inputs through both, then `run_adapt` at TINY (tests/test_sat_toolkits.py's
config and corpus shape) with its checkpoint served by both packages'
engines. The JAX package's own `run_adapt` is its slow test and does not
run here; its emotion extractor is called through `extract_fallback` (its
default tries a hub model first).

The JAX side runs with its native library off (as tests/test_torch_data.py
pins it): that library peak-normalizes by multiplying with the reciprocal
of the peak where numpy divides, and the port follows the numpy path.

Tolerances: bounds, trimmed wavs, text vectors, embeddings and banks
exactly (the same numpy arithmetic); waveforms served from the adapted
checkpoint atol 1e-4, as tests/test_torch_serving.py holds the engines.
"""

import json
import logging
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax

from test_infer_wrap import TINY_JSON
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)
from vits_tpu import native as j_native
from vits_tpu import sat as jsat
from vits_tpu.config import get_hparams_from_file as jax_get_hparams
from vits_tpu.infer import EmoVITS as JEmoVITS
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.toolkits import cluster_emotion as jce
from vits_tpu.toolkits import extract_emotion as jee
from vits_tpu.toolkits import trim_sil as jts
from vits_tpu.utils.audio import load_wav_norm as j_load_wav_norm

from vits_tpu_torch import sat as tsat
from vits_tpu_torch.config import get_hparams_from_file
from vits_tpu_torch.convert import params_to_jax
from vits_tpu_torch.infer import EmoVITS as TEmoVITS
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from vits_tpu_torch.models.synthesizer import Synthesizer
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.toolkits import cluster_emotion as tce
from vits_tpu_torch.toolkits import extract_emotion as tee
from vits_tpu_torch.toolkits import trim_sil as tts
from vits_tpu_torch.utils import checkpoint as tck
from vits_tpu_torch.utils.audio import load_wav_norm, read_wav, write_wav

SR = 1600  # TINY's sampling rate


@pytest.fixture(autouse=True)
def jax_numpy_audio(monkeypatch):
    monkeypatch.setattr(j_native, "_load", lambda: None)


def _tone(sr, seconds, lead, tail, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    tone = 0.8 * np.sin(2 * np.pi * rng.uniform(50, 300) * t) + 0.05 * rng.randn(len(t))
    return np.concatenate([np.zeros(int(lead * sr)), tone,
                           np.zeros(int(tail * sr))]).astype(np.float32)


@pytest.mark.parametrize("case", ["tone", "silent", "short", "noise"])
def test_trim_bounds_equals_jax(case):
    x = {"tone": _tone(8000, 1.0, 0.5, 0.3, 0), "silent": np.zeros(9000, np.float32),
         "short": _tone(8000, 0.05, 0.0, 0.0, 1),
         "noise": np.random.RandomState(2).uniform(-0.5, 0.5, 20000).astype(np.float32)}[case]
    got, want = tts.trim_bounds(x), jts.trim_bounds(x)
    assert tuple(map(int, got)) == tuple(map(int, want))
    if case == "tone":
        assert 0 < got[0] < got[1] < len(x)


@pytest.mark.parametrize("sr_in", [8000, 16000])
def test_trim_silence_file_equals_jax(tmp_path, sr_in):
    """Trimmed, resampled to 8 kHz where it was 16 kHz, written at half
    peak: the same samples."""
    x = _tone(sr_in, 0.8, 0.4, 0.6, sr_in)
    write_wav(str(tmp_path / "in.wav"), x, sr_in)
    tts.trim_silence_file(str(tmp_path / "in.wav"), str(tmp_path / "t.wav"), target_sr=8000)
    jts.trim_silence_file(str(tmp_path / "in.wav"), str(tmp_path / "j.wav"), target_sr=8000)
    (got, sr_t), (want, sr_j) = (read_wav(str(tmp_path / fn)) for fn in ("t.wav", "j.wav"))
    assert sr_t == sr_j == 8000
    assert len(got) == len(want) and 0.8 * 8000 < len(got) < 1.25 * 8000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seconds", [0.02, 1.0, 3.0])
def test_extract_fallback_equals_jax(seconds):
    wav = np.random.RandomState(3).uniform(-0.5, 0.5, int(seconds * 8000)).astype(np.float32)
    got = tee.extract_fallback(wav, 8000)
    assert got.shape == (1024,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jee.extract_fallback(wav, 8000))


def test_extract_to_file_dispatch(tmp_path, caplog, monkeypatch):
    """Without model_path (and no local copy of the default model) the
    fallback is taken and logged, and transformers is not imported; an ONNX
    model_path goes through the session, as the JAX package's does, and
    raises ImportError without onnxruntime."""
    monkeypatch.setattr(tee, "_in_hub_cache", lambda model_id: False)
    wav = np.random.RandomState(4).uniform(-0.5, 0.5, 8000).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), wav, 8000)
    with caplog.at_level(logging.INFO, logger="vits_tpu_torch"):
        emb = tee.extract_to_file(str(tmp_path / "a.wav"), str(tmp_path / "a.emo"),
                                  device="cpu")
    assert any("fallback" in r.getMessage() for r in caplog.records)
    np.testing.assert_array_equal(emb, np.fromfile(str(tmp_path / "a.emo"), np.float32))
    np.testing.assert_array_equal(emb, tee.extract_fallback(load_wav_norm(
        str(tmp_path / "a.wav"))[0], 8000))

    from test_sat_toolkits import _FakeOnnxSession
    wav16 = np.random.RandomState(5).uniform(-0.3, 0.3, 16000).astype(np.float32)
    got = tee.extract_onnx(wav16, 16000, "m.onnx", session=_FakeOnnxSession())
    np.testing.assert_array_equal(
        got, jee.extract_onnx(wav16, 16000, "m.onnx", session=_FakeOnnxSession()))
    with pytest.raises(ValueError):
        tee.extract_onnx(wav16, 22050, "m.onnx", session=_FakeOnnxSession())
    mdir = tmp_path / "w2v2-onnx"
    mdir.mkdir()
    (mdir / "model.onnx").write_bytes(b"\x08\x07")
    assert tee._is_onnx_model(str(mdir)) and not tee._is_onnx_model(str(tmp_path))
    try:
        import onnxruntime  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="onnxruntime"):
            tee.extract_to_file(str(tmp_path / "a.wav"), str(tmp_path / "b.emo"), str(mdir),
                                device="cpu")


class _FakeW2V2:
    """Stands in for transformers' wav2vec2 classes: records the device the
    model is moved to and the device of the input it is called on."""

    def __init__(self, seen):
        self.seen = seen

    def from_pretrained(self, path, local_files_only):
        assert local_files_only
        return self

    def to(self, device):
        self.seen["model"] = torch.device(device)
        return self

    def eval(self):
        return self

    def __call__(self, wav, sampling_rate=None, return_tensors=None):
        if return_tensors is not None:  # the feature extractor
            return types.SimpleNamespace(input_values=torch.from_numpy(wav)[None] * 2)
        self.seen["input"] = wav.device
        hidden = wav[..., None].repeat(1, 1, 1024)[:, ::100]
        return types.SimpleNamespace(last_hidden_state=hidden)


def test_extract_emotion_runs_its_model_on_the_device_asked(tmp_path, monkeypatch):
    """The wav2vec2 model and its input go to `device`; without a card,
    `device=None` (the default of extract_to_file, of the CLI's `--device`
    and of SAT's default extractor) raises instead of running on the CPU,
    the numpy fallback included, and `--device cpu` runs."""
    seen = {}
    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        Wav2Vec2FeatureExtractor=_FakeW2V2(seen), Wav2Vec2Model=_FakeW2V2(seen)))
    monkeypatch.setattr(tee, "_model_cache", {})
    wav = np.random.RandomState(6).uniform(-0.5, 0.5, 8000).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), wav, 8000)
    emb = tee.extract_to_file(str(tmp_path / "a.wav"), str(tmp_path / "a.emo"), "w2v2",
                              device="cpu")
    assert seen == {"model": torch.device("cpu"), "input": torch.device("cpu")}
    x = load_wav_norm(str(tmp_path / "a.wav"))[0] * 2
    np.testing.assert_allclose(emb, np.full(1024, x[::100].mean(), np.float32), rtol=1e-6)
    np.testing.assert_array_equal(emb, np.fromfile(str(tmp_path / "a.emo"), np.float32))

    monkeypatch.setattr(tee, "_in_hub_cache", lambda model_id: False)
    if not torch.cuda.is_available():
        for call in (lambda: tee.extract_to_file(str(tmp_path / "a.wav"),
                                                 str(tmp_path / "b.emo")),
                     lambda: tee.extract_to_file(str(tmp_path / "a.wav"),
                                                 str(tmp_path / "b.emo"), "w2v2"),
                     lambda: tee.extract_w2v2(wav, 8000, "w2v2"),
                     lambda: tsat.default_emotion_extractor(str(tmp_path / "a.wav"),
                                                            str(tmp_path / "b.emo")),
                     lambda: tee.main(["--wavdir", str(tmp_path), "--outdir",
                                       str(tmp_path / "out")])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert not os.path.exists(tmp_path / "b.emo")
    (tmp_path / "out").mkdir()
    tee.main(["--wavdir", str(tmp_path), "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    np.testing.assert_array_equal(np.fromfile(str(tmp_path / "out" / "a.emo"), np.float32),
                                  tee.extract_fallback(x / 2, 8000))


def test_cluster_emotions_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i in range(14):
        p = str(tmp_path / f"{i}.emo")
        center = np.zeros(1024)
        center[i % 3] = 5.0
        (center + rng.randn(1024) * 0.1).astype(np.float32).tofile(p)
        paths.append(p)
    for k, keep in ((3, 0.9), (2, 1.0), (20, 0.5)):
        got = tce.cluster_emotions(paths, k=k, keep_fraction=keep)
        np.testing.assert_array_equal(got, jce.cluster_emotions(paths, k=k, keep_fraction=keep))
    assert got.dtype == np.float32 and got.shape == (7, 1024)


def _speaker_dir(d, seed, n=3, sr=SR):
    d.mkdir(parents=True)
    for u in range(n):
        x = _tone(sr, 0.2 + 0.05 * u, 0.1, 0.1, seed + u)
        write_wav(str(d / f"u{u}.wav"), x, sr)
        with open(d / f"u{u}.txt", "w") as f:
            f.write(f"hello tiny world {u}\n")
    with open(d / "orphan.wav", "wb") as f:  # no transcript: skipped
        f.write(b"")


def _jax_fallback_extractor(wav_path, emo_path):
    wav, sr = j_load_wav_norm(wav_path)
    jee.extract_fallback(wav, sr).tofile(emo_path)


def test_prepare_speaker_data_equals_jax(tmp_path, monkeypatch):
    """The same scp lines (up to the work dir) and the same files: trimmed
    wavs, text vectors, embeddings and the speaker's bank."""
    monkeypatch.setattr(tee, "_in_hub_cache", lambda model_id: False)
    _speaker_dir(tmp_path / "data" / "10001", 7)
    hps_t = get_hparams_from_file_dict(tmp_path, TINY_JSON)
    lines_t = tsat.prepare_speaker_data(str(tmp_path / "data" / "10001"),
                                        str(tmp_path / "work_t"), "10001", hps_t,
                                        device="cpu")
    lines_j = jsat.prepare_speaker_data(str(tmp_path / "data" / "10001"),
                                        str(tmp_path / "work_j"), "10001",
                                        jax_get_hparams(str(tmp_path / "cfg.json")),
                                        emotion_extractor=_jax_fallback_extractor)
    assert len(lines_t) == 3
    assert [line.replace("work_t", "work_j") for line in lines_t] == lines_j
    td, jd = tmp_path / "work_t" / "10001", tmp_path / "work_j" / "10001"
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for fn in sorted(os.listdir(td)):
        if fn.endswith(".wav"):
            np.testing.assert_array_equal(read_wav(str(td / fn))[0], read_wav(str(jd / fn))[0])
        else:
            got, want = (np.fromfile(str(p / fn), np.float32) for p in (td, jd))
            np.testing.assert_array_equal(got, want, err_msg=fn)
    # 3 embeddings, the farthest trimmed (keep 0.9): 2 centroids
    assert np.fromfile(str(td / "10001.emo"), np.float32).shape == (2 * 1024,)


def get_hparams_from_file_dict(tmp_path, cfg):
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    return get_hparams_from_file(str(tmp_path / "cfg.json"))


@pytest.fixture(scope="module")
def adapted(tmp_path_factory):
    """run_adapt at TINY on the CPU for 2 steps, from a seeded G_0/D_0 the
    port wrote: two speakers of 3 utterances each (1.6 kHz)."""
    tmp = tmp_path_factory.mktemp("sat")
    sat_dir = tmp / "sat"
    (sat_dir / "configs").mkdir(parents=True)
    (sat_dir / "pretrain").mkdir()
    cfg = json.loads(json.dumps(TINY_JSON))
    cfg["train"].update(log_interval=1, eval_interval=100, epochs=1, lr_decay=0.996,
                        bucket_boundaries=[4, 40, 80])
    with open(sat_dir / "configs" / "adapt.json", "w") as f:
        json.dump(cfg, f)
    hps = get_hparams_from_file(str(sat_dir / "configs" / "adapt.json"))
    gen = torch.Generator().manual_seed(0)
    synth = init_weights(Synthesizer.from_hps(hps, train=True), gen)
    disc = init_weights(MultiPeriodDiscriminator(False), gen)
    for name, model in (("G_0.npz", synth), ("D_0.npz", disc)):
        tck.save_checkpoint(str(sat_dir / "pretrain" / name),
                            {"model": params_to_jax(model.state_dict())})
    for i, spk in enumerate((10001, 10002)):
        _speaker_dir(sat_dir / "data" / str(spk), 10 * i)
    out_dir = tmp / "checkpoint"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tee, "_in_hub_cache", lambda model_id: False)
        mapping = tsat.run_adapt(str(sat_dir), str(out_dir), max_steps=2, device="cpu")
    return sat_dir, str(out_dir), mapping


def test_run_adapt_writes_map_banks_and_checkpoint(adapted):
    """Reserved ids count down from n_speakers - 1 = 7; the scp holds at
    least 50 lines; the run's pruned checkpoints are exported beside the
    config; spkid.map, each bank under its map id and the external id's
    symlink to it."""
    sat_dir, out, mapping = adapted
    assert mapping == {"10001": 7, "10002": 6}
    with open(sat_dir / "work" / "train.scp") as f:
        train = f.read().splitlines()
    assert len(train) >= tsat.MIN_TRAIN_LINES and len(train) % 6 == 0
    assert {line.split("|")[3] for line in train} == {"7", "6"}
    run = sat_dir / "work" / "adapt_run"
    assert sorted(f for f in os.listdir(run) if f.endswith(".npz")) == ["D_2.npz", "G_2.npz"]
    assert {"checkpoint.npz", "config.json", "spkid.map", "7.emo", "6.emo", "10001.emo",
            "10002.emo"} <= set(os.listdir(out))
    with open(os.path.join(out, "spkid.map")) as f:
        assert f.read() == "10001 7\n10002 6\n"
    for ext, mid in mapping.items():
        link = os.path.join(out, f"{ext}.emo")
        assert os.path.islink(link) and os.readlink(link) == f"{mid}.emo"
        np.testing.assert_array_equal(
            np.fromfile(link, np.float32),
            np.fromfile(str(sat_dir / "work" / ext / f"{ext}.emo"), np.float32))
    g2 = tck.read_checkpoint(str(run / "G_2.npz"))[0]["model"]
    got = tck.read_checkpoint(os.path.join(out, "checkpoint.npz"))[0]["model"]
    np.testing.assert_array_equal(got["emb_g"]["embedding"], g2["emb_g"]["embedding"])


def test_adapted_checkpoint_serves_in_both_packages(adapted, monkeypatch):
    """Speaker 10001 through spkid.map (-> 7) and its bank: the port's engine
    and the JAX package's on the adapted checkpoint, the same np.random
    seed, the same waveform to 1e-4."""
    _, out, _ = adapted
    ckpt = os.path.join(out, "checkpoint.npz")
    tree = tck.read_checkpoint(ckpt)[0]["model"]
    monkeypatch.setattr(JSynth, "init_params", lambda self, key: tree)
    for k in ("VITS_TPU_FUSED", "VITS_TPU_QUANTIZE", "VITS_TPU_AOT", "VITS_TPU_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    port, ref = TEmoVITS(ckpt, device="cpu"), JEmoVITS(ckpt)
    assert port.spkid_mapping[10001] == ref.spkid_mapping[10001] == 7
    text = np.random.RandomState(9).randn(14, 16).astype(np.float32)
    np.random.seed(21)
    wav_t, emo_t = port.infer(10001, text, None)
    np.random.seed(21)
    wav_j, emo_j = ref.infer(10001, text, None)
    np.testing.assert_array_equal(emo_t, emo_j)
    assert len(wav_t) == len(wav_j) > 0
    np.testing.assert_allclose(wav_t, wav_j, atol=1e-4, rtol=0)
