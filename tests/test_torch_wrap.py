"""The port's product front against the JAX package on the CPU: the long-text
splitter, `VITSWrap.speaking` and `speaking_stream`, the socket server and
its client, and the HTTP gateway. Deployments are written by the JAX package
at TINY; both wrappers serve them with the same `np.random` seed.

Tolerances: PCM within 1 LSB (the float waveforms agree to 1e-4; int16
truncation may land on either side of a step), segment metadata equal.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from test_infer_wrap import TINY_JSON
from vits_tpu.config import get_hparams_from_file as jax_get_hparams
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.utils import checkpoint as jax_ckpt
from vits_tpu.vits_wrap import VITSWrap as JVITSWrap
from vits_tpu.vits_wrap import split_long_text as jax_split_long_text

from vits_tpu_torch.serve import http_server as http_mod
from vits_tpu_torch.serve import protocol
from vits_tpu_torch.serve.protocol import synthesize, synthesize_stream
from vits_tpu_torch.serve.socket_server import TTServer
from vits_tpu_torch.vits_wrap import VITSWrap, split_long_text


def _deploy(d, sampling_rate=None):
    cfg = json.loads(json.dumps(TINY_JSON))
    if sampling_rate:
        cfg["data"]["sampling_rate"] = sampling_rate
    with open(d / "config.json", "w") as f:
        json.dump(cfg, f)
    js = JSynth.from_hps(jax_get_hparams(str(d / "config.json")))
    params = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jax.jit(js.init_params)(jax.random.PRNGKey(7))))
    jax_ckpt.save_checkpoint(str(d / "checkpoint.npz"), {"model": params})
    np.random.RandomState(5).randn(2, 1024).astype(np.float32).tofile(str(d / "1.emo"))
    return str(d / "checkpoint.npz"), params


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    """The TINY deployment at its native 1600 Hz (VITSWrap resamples to the
    8 kHz floor), and its parameter tree."""
    return _deploy(tmp_path_factory.mktemp("wrap_deploy"))


@pytest.fixture(scope="module")
def deploy_8k(tmp_path_factory):
    """A deployment whose native rate survives the >= 8000 Hz clamp, so
    speaking_stream streams at the decoder-window level."""
    return _deploy(tmp_path_factory.mktemp("wrap_deploy8k"), sampling_rate=8000)[0]


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    for k in ("VITS_TPU_FUSED", "VITS_TPU_FUSED_Q8", "VITS_TPU_FUSED_FRAMES_PER_TOKEN",
              "VITS_TPU_Q8_CALIB_REQUESTS", "VITS_TPU_QUANTIZE", "VITS_TPU_AOT"):
        monkeypatch.delenv(k, raising=False)


def _pcm(wav_bytes):
    assert wav_bytes[:4] == b"RIFF" and wav_bytes[8:12] == b"WAVE"
    return np.frombuffer(wav_bytes[44:], np.int16).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_long_text_matches_jax(seed):
    rng = np.random.RandomState(seed)
    alphabet = list("你好世界天气今日很多") + list("abc xyz") + list("0123456789") + \
        ["。", "！", "，", ",", ".", ":", "：", "——", "……", "、", "(", ")", " ", "?"]
    for _ in range(20):
        text = "".join(rng.choice(alphabet, rng.randint(0, 400)))
        for max_len in (16, 64):
            assert split_long_text(text, max_len) == jax_split_long_text(text, max_len)


def test_speaking_matches_jax(deploy, monkeypatch):
    """One segment, many segments, and the pitch/resample branch: the same
    PCM (within 1 LSB) and segment metadata as the JAX wrapper."""
    ckpt, params = deploy
    monkeypatch.setattr(JSynth, "init_params", lambda self, key: params)
    tts = VITSWrap(ckpt, device="cpu")
    jtts = JVITSWrap(ckpt)
    assert tts.speecher.device.type == "cpu"
    zeros = np.zeros(1024, np.float32)
    requests = [{"text": "hello world, this is a test.", "spkid": 1, "emotion": zeros,
                 "volume": 0.8, "tail_silence": 0.1},
                {"text": "你好。" * 40, "spkid": 1, "emotion": zeros},
                {"text": "abc", "spkid": 1, "pitch": 1.2, "sampling_rate": 16000,
                 "emotion": (1, 1)}]
    for i, inputs in enumerate(requests):
        np.random.seed(600 + i)
        out = tts.speaking(dict(inputs))
        np.random.seed(600 + i)
        ref = jtts.speaking(dict(inputs))
        assert out["sr"] == ref["sr"]
        got, want = _pcm(out["wav"]), _pcm(ref["wav"])
        assert got.shape == want.shape and np.abs(got - want).max() <= 1
        assert out["segment_info"] == ref["segment_info"]
        assert out["rtf"] > 0
        assert (len(out["segment_info"]) > 1) == (i == 1)
    assert out["sr"] == 16000


def test_speaking_stream_matches_speaking(deploy_8k):
    """speaking_stream's concatenated PCM is speaking()'s WAV payload at the
    native rate (the tail-silence chunk included), both on the two-phase
    path and on the fused default (whose seeded noise-ring start coincides
    with two-phase's here), and the final dict carries the metadata."""
    inputs = {"text": "hello world, this is a streaming test.", "spkid": 1,
              "emotion": np.zeros(1024, np.float32), "volume": 0.8, "tail_silence": 0.05}
    for fused in (False, True):
        tts = VITSWrap(deploy_8k, device="cpu")
        tts.speecher._prefer_fused = fused
        np.random.seed(4)
        ref = tts.speaking(dict(inputs))
        np.random.seed(4)
        msgs = list(tts.speaking_stream(dict(inputs)))
        final = msgs[-1]
        assert final.get("final") is True and "wav" not in final
        chunks = msgs[:-1]
        assert len(chunks) > 1 and all(m["sr"] == 8000 for m in chunks)
        assert [m["seq"] for m in chunks] == list(range(len(chunks)))
        got = np.frombuffer(b"".join(m["pcm"] for m in chunks), np.int16).astype(np.int32)
        want = _pcm(ref["wav"])
        assert got.shape == want.shape and np.abs(got - want).max() <= 1
        assert np.abs(want).max() > 100  # not a silent model
        assert final["segment_info"] == ref["segment_info"] and final["rtf"] > 0


@pytest.fixture(scope="module")
def server(deploy):
    srv = TTServer(port=0, num_workers=2, ckpt_path=deploy[0], device="cpu")
    port = srv.start()
    assert srv.tts.speecher.device.type == "cpu"
    yield ("127.0.0.1", port)
    srv.stop()


def test_socket_roundtrip(server):
    out = synthesize({"text": "hello there", "spkid": 1,
                      "emotion": np.zeros(1024, np.float32)}, server)
    assert out is not None and out["rtf"] > 0
    assert len(_pcm(out["wav"])) > 0


def test_socket_persistent_connection(server):
    out1, sock = synthesize({"text": "one", "spkid": 1,
                             "emotion": np.zeros(1024, np.float32)}, server, None, True)
    assert out1 is not None and sock is not None
    out2, sock = synthesize({"text": "two", "spkid": 1,
                             "emotion": np.zeros(1024, np.float32)}, server, sock, True)
    assert out2 is not None and out2["wav"][:4] == b"RIFF"
    if sock:
        sock.close()


def test_socket_streaming(server):
    """stream=True: framed PCM chunk dicts, then the final metadata dict."""
    msgs = list(synthesize_stream({"text": "stream me please. " * 3, "spkid": 1,
                                   "emotion": np.zeros(1024, np.float32)}, server))
    assert msgs and msgs[-1].get("final") is True
    chunks = msgs[:-1]
    assert chunks and all(isinstance(m["pcm"], bytes) and m["sr"] > 0 for m in chunks)
    assert [m["seq"] for m in chunks] == list(range(len(chunks)))
    assert sum(len(m["pcm"]) for m in chunks) > 0 and msgs[-1]["rtf"] > 0


def test_socket_server_under_concurrent_clients(deploy, monkeypatch):
    """Eight clients at once against four worker threads sharing one model:
    every reply is whole, one request at a time reaches the engine (the
    server's lock), and the engine's calibration record, updated on each
    request, counts every request once."""
    import sys
    monkeypatch.setenv("VITS_TPU_Q8_CALIB_REQUESTS", "1000")  # calibrate throughout
    srv = TTServer(port=0, num_workers=4, ckpt_path=deploy[0], device="cpu", quantize=True)
    remote = ("127.0.0.1", srv.start())
    speecher = srv.tts.speecher
    inside, guard, orig = [0, 0], threading.Lock(), speecher.infer

    def counted(*a, **k):
        with guard:
            inside[0] += 1
            inside[1] = max(inside[1], inside[0])
        try:
            return orig(*a, **k)
        finally:
            with guard:
                inside[0] -= 1

    monkeypatch.setattr(speecher, "infer", counted)
    request = {"text": "client says hello", "spkid": 1, "emotion": np.zeros(1024, np.float32)}
    want = len(_pcm(synthesize(request, remote)["wav"]))
    replies, interval = [], sys.getswitchinterval()

    def client():
        for _ in range(2):
            out = synthesize(request, remote)
            replies.append(None if out is None else len(_pcm(out["wav"])))

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        srv.stop()
    assert replies == [want] * 16  # the durations fix the length; the noise does not
    assert inside[1] == 1
    assert speecher._q8_seen == 1 + 16 and speecher.dec_q8 is None


@pytest.fixture
def gateway(server):
    httpd = http_mod.serve(host="127.0.0.1", port=0, remote=server)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/api/text2speech"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_http_gateway(gateway):
    # GET with semitone params; emotion id 1 resolves through the bank
    with urllib.request.urlopen(f"{gateway}?tex=hi+there&per=1&vol=90&spd=2&pit=-1&emo=1",
                                timeout=60) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        assert r.read()[:4] == b"RIFF"
    # POST with an explicit emotion vector
    req = urllib.request.Request(gateway, data=json.dumps(
        {"tex": "post test", "per": 1, "emo": [0.0] * 1024}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.read()[:4] == b"RIFF"
    # a bad emotion vector is a 400 with a JSON message
    req = urllib.request.Request(gateway, data=json.dumps({"tex": "x", "emo": [0.0] * 3}).encode(),
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400


def test_http_gateway_streaming(gateway):
    with urllib.request.urlopen(f"{gateway}?tex=streaming+hello&per=1&emo=0&stm=1",
                                timeout=60) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        assert r.headers["Transfer-Encoding"] == "chunked"
        body = r.read()  # urllib reassembles the chunks
    assert body[:4] == b"RIFF" and len(body) > 44
    assert body[40:44] == b"\xd3\xff\xff\xff"  # unknown length: 0xFFFFFFFF - 44


def test_socket_client_cli(server, tmp_path):
    """The client CLI: a text file in, WAV files out, one-shot and streamed."""
    host, port = server
    tf = tmp_path / "lines.txt"
    tf.write_text("hello there\n\nsecond line\n", encoding="utf-8")
    protocol.main(["--host", host, "--port", str(port), "-t", str(tf), "-i", "1",
                   "-o", str(tmp_path / "out1")])
    assert sorted(os.listdir(tmp_path / "out1")) == ["000001.wav", "000002.wav"]
    assert len(_pcm((tmp_path / "out1" / "000001.wav").read_bytes())) > 0
    protocol.main(["--host", host, "--port", str(port), "-u", "streamed hello", "-i", "1",
                   "--stream", "-o", str(tmp_path / "out2")])
    assert len(_pcm((tmp_path / "out2" / "000001.wav").read_bytes())) > 0
