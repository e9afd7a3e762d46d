"""HTTP gateway of the port: GET/POST /api/text2speech -> the socket server
(counterpart of vits_tpu/serve/http_server.py). Query parameters
tex/per/vol/spd/pit/emo/stm; semitones map to ratios (speed 2^(-spd/12),
pitch 2^(pit/12)); a persistent upstream socket per handler thread with one
retry on a fresh connection; audio/wav responses, chunked when stm is set.
Built on the standard library's ThreadingHTTPServer.

    python -m vits_tpu_torch.serve.http_server --port 6767 --tts-port 5959
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from vits_tpu_torch.serve.protocol import synthesize, synthesize_stream
from vits_tpu_torch.utils.audio import wav_header

REMOTE = ("127.0.0.1", 5959)


class Gateway(ThreadingHTTPServer):
    """The HTTP server with its upstream socket server's address and one
    upstream connection per handler thread."""

    def __init__(self, addr, remote=REMOTE):
        super().__init__(addr, Handler)
        self.remote = tuple(remote)
        self.tls = threading.local()

    def call_upstream(self, inputs):
        sock = getattr(self.tls, "sock", None)
        outputs, sock = synthesize(inputs, self.remote, sock, True)
        if outputs is None:  # retry once with a fresh connection
            outputs, sock = synthesize(inputs, self.remote, None, True)
        self.tls.sock = sock
        return outputs


def _build_inputs(tex, per, vol, spd, pit, emo):
    if isinstance(emo, list):
        if len(emo) != 1024:
            return None, {"msg": "emo must be int or list[float] with length=1024 !"}
        emotion = (np.asarray(emo, np.float32), -1)
    else:
        emotion = (int(emo), -1)
    return {
        "text": tex,
        "spkid": int(per),
        "volume": max(0, min(100, int(vol))) / 100.0,
        "speed": 2 ** (-max(-12, min(12, int(spd))) / 12.0),
        "pitch": 2 ** (max(-12, min(12, int(pit))) / 12.0),
        "emotion": emotion,
    }, None


class Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 so the streaming mode can use chunked transfer-encoding;
    # non-streaming responses all carry explicit Content-Length.
    protocol_version = "HTTP/1.1"

    def _json(self, obj, status=200):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _wav(self, wav: bytes):
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(wav)))
        self.end_headers()
        self.wfile.write(wav)

    def _wav_stream(self, chunks):
        """Chunked-transfer streaming WAV: a header with the 0xFFFFFFFF
        unknown-length convention, then PCM chunks as they are synthesized."""
        def w(b):
            self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
        started = False
        for msg in chunks:
            if msg.get("final"):
                break
            if not started:
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                w(wav_header(0xFFFFFFFF - 44, msg["sr"], 16))
                started = True
            w(msg["pcm"])
        if not started:
            return self._json({"msg": "synthesis failure!"})
        self.wfile.write(b"0\r\n\r\n")

    def _serve(self, tex, per, vol, spd, pit, emo, stream=False):
        if not tex or len(tex) > 100 * 1024:
            return self._json({"msg": "tex length out of range"}, 400)
        inputs, err = _build_inputs(tex, per, vol, spd, pit, emo)
        if err:
            return self._json(err, 400)
        if stream:
            return self._wav_stream(synthesize_stream(inputs, self.server.remote))
        outputs = self.server.call_upstream(inputs)
        if outputs is None:
            return self._json({"msg": "synthesis failure!"})
        self._wav(outputs.pop("wav"))

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        if url.path != "/api/text2speech":
            return self._json({"msg": "not found"}, 404)
        q = urllib.parse.parse_qs(url.query)

        def get(k, d):
            return q.get(k, [d])[0]

        self._serve(get("tex", ""), get("per", 1), get("vol", 100),
                    get("spd", 0), get("pit", 0), int(get("emo", 0)),
                    stream=get("stm", "0") not in ("0", "", "false"))

    def do_POST(self):
        url = urllib.parse.urlparse(self.path)
        if url.path != "/api/text2speech":
            return self._json({"msg": "not found"}, 404)
        length = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return self._json({"msg": "invalid JSON"}, 400)
        self._serve(body.get("tex", ""), body.get("per", 1), body.get("vol", 100),
                    body.get("spd", 0), body.get("pit", 0), body.get("emo", 0),
                    stream=bool(body.get("stm", False)))

    def log_message(self, fmt, *args):  # quiet by default
        pass


def serve(host="0.0.0.0", port=6767, remote=REMOTE) -> Gateway:
    """The gateway bound to (host, port) (port 0 picks a free one), not yet
    serving: call `serve_forever()`, and `shutdown()` to stop."""
    return Gateway((host, port), remote)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6767)
    parser.add_argument("--tts-host", type=str, default="127.0.0.1")
    parser.add_argument("--tts-port", type=int, default=5959)
    args = parser.parse_args(argv)
    httpd = serve(args.host, args.port, (args.tts_host, args.tts_port))
    print(f"http gateway on {args.host}:{args.port} -> {args.tts_host}:{args.tts_port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
