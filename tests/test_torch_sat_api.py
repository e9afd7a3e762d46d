"""The port's SAT management API (`vits_tpu_torch.serve.sat_api`) against the
JAX package's (`vits_tpu.serve.sat_api`): both servers on port 0, each over
its own copy of one SAT directory, take the same requests in the same
order, and every reply (HTTP status and JSON body) is the same.

The processes they would start (the TTS servers, adapt training) are
recorded, argv and all, and stood in for by `sleep`s, so the pidfile
control (start, kill by process group, restart) runs for real. The port's
argv run this interpreter on `vits_tpu_torch` modules only.

A defect of the reference is pinned, not copied: the JAX API keeps no
handle on its children, so one that exits stays a zombie that its signal-0
probe finds alive; its adapt worker would wait forever and every kill
would wait out its 10 s timeout. The test reaps the JAX API's children for
it; the port's service polls its own.
"""

import json
import os
import sys
import threading
import urllib.error
import urllib.request
import uuid

import pytest

import vits_tpu.serve.sat_api as japi

import vits_tpu_torch.serve.sat_api as tapi


def _sat_dir(root):
    (root / "configs").mkdir(parents=True)
    (root / "pretrain").mkdir()
    (root / "configs" / "adapt.json").write_text("{}")
    (root / "pretrain" / "G_0.npz").write_bytes(b"not a checkpoint")
    return str(root)


_REAL_T = tapi.SatService._spawn
_REAL_J = japi._spawn


def _sleeper(name):
    """What starts in a recorded process's place: adapt ends at once, the
    TTS servers live until killed."""
    return [sys.executable, "-c", f"import time; time.sleep({0.3 if name == 'sat_adapt' else 60})"]


@pytest.fixture
def servers(tmp_path, monkeypatch):
    """(port base URL, JAX base URL, the port's service, argv records)."""
    rec_t, rec_j, jax_pids, done = [], [], [], threading.Event()

    def spawn_t(self, name, argv):
        rec_t.append((name, argv))
        return _REAL_T(self, name, _sleeper(name))

    def spawn_j(name, argv, cwd=None):
        rec_j.append((name, argv))
        pid = _REAL_J(name, _sleeper(name), cwd)
        jax_pids.append(pid)
        return pid

    def reap_jax_children():
        while not done.wait(0.05):
            for pid in list(jax_pids):
                try:
                    if os.waitpid(pid, os.WNOHANG)[0]:
                        jax_pids.remove(pid)
                except ChildProcessError:
                    jax_pids.remove(pid)

    monkeypatch.setattr(tapi.SatService, "_spawn", spawn_t)
    monkeypatch.setattr(japi, "_spawn", spawn_j)
    t = tapi.serve("127.0.0.1", 0, _sat_dir(tmp_path / "t" / "sat"), str(tmp_path / "t" / "out"),
                   str(tmp_path / "t" / "run"), device="cpu")
    j = japi.serve("127.0.0.1", 0, _sat_dir(tmp_path / "j" / "sat"), str(tmp_path / "j" / "out"),
                   str(tmp_path / "j" / "run"))
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in (t, j)]
    threads.append(threading.Thread(target=reap_jax_children, daemon=True))
    for th in threads:
        th.start()
    try:
        yield (f"http://127.0.0.1:{t.server_address[1]}",
               f"http://127.0.0.1:{j.server_address[1]}", t.service, rec_t, rec_j)
    finally:
        for s in (t, j):
            s.shutdown()
            s.server_close()
        t.service.stop_tts()
        japi.stop_tts()
        done.set()


def _call(base, path, body=None, ctype=None):
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _multipart(filename, data, text):
    b = uuid.uuid4().hex
    body = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"{filename}\"\r\n"
            f"Content-Type: audio/wav\r\n\r\n").encode() + data + \
        (f"\r\n--{b}\r\nContent-Disposition: form-data; name=\"text\"\r\n\r\n{text}\r\n"
         f"--{b}--\r\n").encode()
    return body, f"multipart/form-data; boundary={b}"


def _wait_adapt(svc):
    for th in (svc.sat_thread, japi._sat_thread):
        th.join(timeout=30)
        assert not th.is_alive()


def test_routes_answer_as_the_jax_api(servers):
    tbase, jbase, svc, rec_t, rec_j = servers

    def both(path, *a, expect=None):
        got, want = _call(tbase, path, *a), _call(jbase, path, *a)
        assert got == want, path
        if expect is not None:
            assert got[1]["code"] == expect, (path, got)
        return got

    both("/api/sat/spkinfo", expect=400)
    both("/api/sat/status", expect=202)
    both("/api/sat/uploadfile/9999", *_multipart("a.wav", b"RIFF", "hi"), expect=400)
    both("/api/sat/uploadfile/10001", b"", "multipart/form-data; boundary=x", expect=400)
    for spk, fn in ((10001, "a.wav"), (10001, "b.wav"), (10002, "c.wav")):
        both(f"/api/sat/uploadfile/{spk}", *_multipart(fn, b"RIFF....WAVE", f"text {fn}"),
             expect=200)
    assert both("/api/sat/spkinfo", expect=200)[1]["data"] == {"10001": 2, "10002": 1}
    with open(os.path.join(svc.sat_dir, "data", "10001", "a.txt")) as f:
        assert f.read() == "text a.wav\n"
    both("/api/sat/clean/10003", expect=400)
    both("/api/sat/clean/10002", expect=200)
    both("/api/sat/start/tts", expect=200)  # G_0 and the adapt config copied first
    assert svc.has_tts() and os.path.exists(os.path.join(svc.out_dir, "config.json"))
    both("/api/sat/start", expect=200)
    both("/api/sat/status", expect=201)  # training
    both("/api/sat/start", expect=400)
    both("/api/sat/clean/10001", expect=400)
    both("/api/sat/start/tts", expect=400)
    _wait_adapt(svc)
    both("/api/sat/status", expect=202)  # no bank for 10001 in the output
    both("/api/sat/stop", expect=200)
    both("/api/other", expect=404)
    both("/api/sat/nothing", expect=404)

    # the processes: the same ones in the same order, the port's on this
    # interpreter and its own modules
    assert [n for n, _ in rec_t] == [n for n, _ in rec_j] == [
        "socket_server", "http_server", "sat_adapt", "socket_server", "http_server"]
    for (name, argv), (_, jargv) in zip(rec_t, rec_j):
        assert argv[0] == sys.executable
        text = " ".join(argv)
        assert "vits_tpu_torch" in text and "vits_tpu." not in text, argv
        assert "vits_tpu." in " ".join(jargv)
    assert rec_t[0][1][1:4] == ["-m", "vits_tpu_torch.serve.socket_server", "--checkpoint"]
    assert rec_t[0][1][-2:] == ["--device", "cpu"]
    assert "s.run_adapt(" in rec_t[2][1][-1] and "device='cpu'" in rec_t[2][1][-1]
