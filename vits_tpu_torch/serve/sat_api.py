"""SAT (speaker-adaptive training) management REST API (counterpart of
vits_tpu/serve/sat_api.py, the reference's web_api/sat.py): the same routes
and JSON shapes ({"code", "data", "msg"}):

  POST /api/sat/uploadfile/<spkid>   multipart `file` (a wav) + `text`; spkid >= 10000
  GET  /api/sat/clean/<spkid>        delete a speaker's uploads
  GET  /api/sat/spkinfo              {spkid: number of wavs}
  GET  /api/sat/start                adapt in the background (TTS stopped meanwhile)
  GET  /api/sat/stop                 stop adapting, restart TTS
  GET  /api/sat/status               200 done, 201 training, 202 failed
  GET  /api/sat/start/tts            start the TTS servers

The processes it manages are the port's, on this interpreter
(`sys.executable`): `vits_tpu_torch.serve.socket_server` on the deployment's
checkpoint, `vits_tpu_torch.serve.http_server`, and
`vits_tpu_torch.sat.run_adapt`. Each records a pidfile in the run directory
and is signalled by exact PID (its own process group), never by matching a
process list. The service keeps each child's handle and polls it, which
reaps a child that exited (the JAX package's API keeps none, so an exited
child stays a zombie that a signal-0 probe finds alive: its adapt worker
never sees the end, and each kill waits out its timeout). Standard library
HTTP server; the state lives in the `SatService` that `serve` attaches to
the server.

    python -m vits_tpu_torch.serve.sat_api [--host 0.0.0.0] [--port 6768]
        [--sat-dir sat] [--out-dir checkpoint] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.parse
from email.parser import BytesParser
from email.policy import default as email_default_policy
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class SatService:
    """The SAT directories and the processes the API manages: pidfiles and
    logs under `run_dir`, the adapt worker thread and its stop flag."""

    def __init__(self, sat_dir: str, out_dir: str, run_dir: str, device: str = "cuda"):
        self.sat_dir, self.out_dir, self.run_dir = sat_dir, out_dir, run_dir
        self.device = device
        self.sat_thread = None
        self.stop_flag = threading.Event()
        self.children: Dict[int, subprocess.Popen] = {}  # pid -> the handle of our child
        os.makedirs(run_dir, exist_ok=True)

    # ---------------- processes ----------------
    def _pidfile(self, name):
        return os.path.join(self.run_dir, f"{name}.pid")

    def _read_pid(self, name):
        try:
            with open(self._pidfile(name)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _alive(self, pid):
        if pid is None:
            return False
        child = self.children.get(pid)
        if child is not None:
            return child.poll() is None  # reaps it once it has exited
        try:
            os.kill(pid, 0)
            return True
        except OSError:
            return False

    def _spawn(self, name, argv):
        with open(os.path.join(self.run_dir, f"{name}.log"), "ab") as log:
            p = subprocess.Popen(argv, cwd=REPO, stdout=log, stderr=log,
                                 start_new_session=True)
        self.children[p.pid] = p
        with open(self._pidfile(name), "w") as f:
            f.write(str(p.pid))
        return p.pid

    def _kill(self, name, timeout=10.0):
        pid = self._read_pid(name)
        if pid is None:
            return
        try:
            os.killpg(os.getpgid(pid), signal.SIGTERM)
        except OSError:
            pass
        t0 = time.time()
        while self._alive(pid) and time.time() - t0 < timeout:
            time.sleep(0.2)
        if self._alive(pid):
            try:
                os.killpg(os.getpgid(pid), signal.SIGKILL)
            except OSError:
                pass
        self.children.pop(pid, None)
        try:
            os.remove(self._pidfile(name))
        except OSError:
            pass

    # ---------------- TTS and SAT ----------------
    def has_tts(self):
        return self._alive(self._read_pid("socket_server")) or \
            self._alive(self._read_pid("http_server"))

    def stop_tts(self):
        self._kill("http_server")
        self._kill("socket_server")

    def start_tts(self):
        """Start the servers on out_dir/checkpoint.npz; before the first
        adapt, the pretrained G_0.npz and adapt config are copied there."""
        ckpt1 = os.path.join(self.out_dir, "checkpoint.npz")
        ckpt2 = os.path.join(self.sat_dir, "pretrain", "G_0.npz")
        if not os.path.exists(ckpt1) and os.path.exists(ckpt2):
            os.makedirs(self.out_dir, exist_ok=True)
            shutil.copyfile(ckpt2, ckpt1)
            shutil.copyfile(os.path.join(self.sat_dir, "configs", "adapt.json"),
                            os.path.join(self.out_dir, "config.json"))
        if not self._alive(self._read_pid("socket_server")):
            self._spawn("socket_server",
                        [sys.executable, "-m", "vits_tpu_torch.serve.socket_server",
                         "--checkpoint", ckpt1, "--device", self.device])
        if not self._alive(self._read_pid("http_server")):
            self._spawn("http_server", [sys.executable, "-m", "vits_tpu_torch.serve.http_server"])

    def has_sat(self):
        if self.sat_thread is not None and self.sat_thread.is_alive():
            return True
        self.sat_thread = None
        return self._alive(self._read_pid("sat_adapt"))

    def _sat_worker(self):
        """Stop TTS (frees the card), run adapt as a child process, restart
        TTS."""
        was_tts = self.has_tts()
        if was_tts:
            self.stop_tts()
        try:
            self._spawn("sat_adapt", [
                sys.executable, "-c",
                "import vits_tpu_torch.sat as s; s.run_adapt(%r, %r, device=%r)"
                % (self.sat_dir, self.out_dir, self.device)])
            pid = self._read_pid("sat_adapt")
            while self._alive(pid) and not self.stop_flag.is_set():
                time.sleep(1.0)
            if self.stop_flag.is_set():
                self._kill("sat_adapt")
        finally:
            try:
                os.remove(self._pidfile("sat_adapt"))
            except OSError:
                pass
            if was_tts:
                self.start_tts()

    def start_sat(self):
        self.stop_flag.clear()
        self.sat_thread = threading.Thread(target=self._sat_worker, daemon=True)
        self.sat_thread.start()


class Handler(BaseHTTPRequestHandler):
    @property
    def svc(self) -> SatService:
        return self.server.service

    def _json(self, code, data=None, msg="", status=None):
        body = json.dumps({"code": code, "data": data or {}, "msg": msg}).encode()
        self.send_response(status or (200 if code < 400 else 400))
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _upload(self, spkid):
        if spkid < 10000:
            return self._json(400, msg=f"error: spkid={spkid} must more than 10000")
        length = int(self.headers.get("Content-Length", 0))
        ctype = self.headers.get("Content-Type", "")
        raw = self.rfile.read(length)
        msg = BytesParser(policy=email_default_policy).parsebytes(
            b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + raw)
        filename, file_data, text = None, None, None
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name == "file":
                filename = part.get_filename()
                file_data = part.get_payload(decode=True)
            elif name == "text":
                text = part.get_payload(decode=True).decode("utf-8").strip()
        if not filename or file_data is None or text is None:
            return self._json(400, msg="error: need multipart `file` and `text`")
        data_dir = os.path.join(self.svc.sat_dir, "data", str(spkid))
        os.makedirs(data_dir, exist_ok=True)
        with open(os.path.join(data_dir, filename), "wb") as f:
            f.write(file_data)
        with open(os.path.join(data_dir, filename.replace(".wav", ".txt")), "wt",
                  encoding="utf-8") as f:
            f.write(text + "\n")
        return self._json(200, msg="save file ok!")

    def _clean(self, spkid):
        data_dir = os.path.join(self.svc.sat_dir, "data", str(spkid))
        if not os.path.exists(data_dir):
            return self._json(400, msg=f"error: there is no any data for spkid={spkid}")
        if self.svc.has_sat():
            return self._json(400, msg="error: sat is training")
        shutil.rmtree(data_dir, ignore_errors=True)
        return self._json(200, msg=f"sat clean success, spkid={spkid}")

    def _spkinfo(self):
        data_dir = os.path.join(self.svc.sat_dir, "data")
        spkid = {}
        if os.path.exists(data_dir):
            for spkdir in glob.glob(f"{data_dir}/*"):
                sid = os.path.basename(spkdir)
                if os.path.isdir(spkdir) and sid.isdigit():
                    spkid[sid] = len(glob.glob(spkdir + "/*.wav"))
        if not spkid:
            return self._json(400, msg="error: there is no any speaker record data")
        return self._json(200, data=spkid, msg=f"sat speaker number={len(spkid)}")

    def _start(self):
        if self.svc.has_sat():
            return self._json(400, msg="error: sat is training")
        self.svc.start_sat()
        return self._json(200, msg="sat start training success!")

    def _stop(self):
        self.svc.stop_flag.set()
        self.svc._kill("sat_adapt")
        self.svc.start_tts()
        return self._json(200, msg="sat stop training success!")

    def _status(self):
        if self.svc.has_sat():
            return self._json(201, msg="sat is training!", status=200)
        out_dir = self.svc.out_dir
        data_dir = os.path.join(self.svc.sat_dir, "data")
        spkid1 = sorted(os.path.basename(d) for d in glob.glob(f"{data_dir}/*"))
        spkid2 = sorted(os.path.splitext(os.path.basename(p))[0]
                        for p in glob.glob(f"{out_dir}/*.emo"))
        if not os.path.exists(os.path.join(out_dir, "checkpoint.npz")) or \
                any(x not in spkid2 for x in spkid1):
            return self._json(202, msg="sat training failure!", status=200)
        return self._json(200, msg="sat training success!")

    def _start_tts(self):
        if self.svc.has_sat():
            return self._json(400, msg="error: sat is training!")
        self.svc.start_tts()
        if self.svc.has_tts():
            return self._json(200, msg="start tts success!")
        return self._json(400, msg="error: start tts failure!")

    def _route(self):
        path = urllib.parse.urlparse(self.path).path
        parts = [p for p in path.split("/") if p]
        if parts[:2] != ["api", "sat"]:
            return self._json(404, msg="not found", status=404)
        rest = parts[2:]
        if rest[:1] == ["uploadfile"] and len(rest) == 2 and self.command == "POST":
            return self._upload(int(rest[1]))
        if rest[:1] == ["clean"] and len(rest) == 2:
            return self._clean(int(rest[1]))
        if rest == ["spkinfo"]:
            return self._spkinfo()
        if rest == ["start"]:
            return self._start()
        if rest == ["stop"]:
            return self._stop()
        if rest == ["status"]:
            return self._status()
        if rest == ["start", "tts"]:
            return self._start_tts()
        return self._json(404, msg="not found", status=404)

    def do_GET(self):
        self._route()

    def do_POST(self):
        self._route()

    def log_message(self, fmt, *args):
        pass


def serve(host="0.0.0.0", port=6768, sat_dir=None, out_dir=None, run_dir=None,
          device="cuda") -> ThreadingHTTPServer:
    """The API's server (not yet serving), its `SatService` as `.service`.
    Directories default to the repository's sat/, checkpoint/ and
    web_api/run/."""
    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.service = SatService(os.path.abspath(sat_dir or os.path.join(REPO, "sat")),
                               os.path.abspath(out_dir or os.path.join(REPO, "checkpoint")),
                               os.path.abspath(run_dir or os.path.join(REPO, "web_api", "run")),
                               device)
    return httpd


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6768)
    parser.add_argument("--sat-dir", type=str, default=None)
    parser.add_argument("--out-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the TTS server and of adapt training")
    args = parser.parse_args(argv)
    httpd = serve(args.host, args.port, args.sat_dir, args.out_dir, device=args.device)
    svc = httpd.service
    print(f"sat api on {args.host}:{args.port} (sat={svc.sat_dir} out={svc.out_dir})")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
