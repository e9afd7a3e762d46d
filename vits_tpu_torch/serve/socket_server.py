"""TTS socket server of the port (counterpart of
vits_tpu/serve/socket_server.py): a TCP listener serving length-prefixed
pickle requests (`vits_tpu_torch.serve.protocol`), N worker threads sharing
one listen socket and one `VITSWrap` behind a lock (the card runs one
request at a time; threads overlap the host's socket work), per-request
`tts.update()` hot reload, and RTF logging. Several cards of a host scale by
one server process per card on the same port with SO_REUSEPORT (the kernel
balances accepts).

    python -m vits_tpu_torch.serve.socket_server --device cuda -c <dir>/checkpoint.npz

The model runs on `cuda` unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import struct
import threading
import time
from typing import Optional


def strftime():
    return time.strftime("%Y-%m-%d %H:%M:%S")


def tts_worker(server_socket: socket.socket, tts, lock: threading.Lock,
               max_input_size: int, work: int, loglv: int = 0):
    from vits_tpu_torch.serve.protocol import recv_exact, send_msg

    func_name = f"tts_worker: work{work}(pid={os.getpid()})"
    while True:
        try:
            conn, addr = server_socket.accept()
        except OSError:
            break
        if loglv > 0:
            print(f"{strftime()} {func_name}, client connected {addr}")
        try:
            while True:
                header = conn.recv(4)
                if not header or len(header) < 4:
                    break
                (size,) = struct.unpack("<i", header)
                if size <= 0 or size > max_input_size:
                    print(f"{strftime()} {func_name}, refusing request size={size}")
                    break
                inputs = pickle.loads(recv_exact(conn, size))
                t0 = time.time()
                if inputs.get("stream"):
                    # one framed pickle per PCM chunk, then the final metadata
                    # dict ({"final": True, ...}): VITSWrap.speaking_stream
                    outputs = None
                    with lock:
                        for outputs in tts.speaking_stream(inputs):
                            send_msg(conn, outputs)
                        tts.update()
                else:
                    with lock:
                        outputs = tts.speaking(inputs)
                        tts.update()
                    send_msg(conn, outputs)
                if loglv > 0:
                    rtf = (outputs or {}).get("rtf", 1.0)
                    print(f"{strftime()} {func_name}, served {addr} in "
                          f"{time.time()-t0:.3f}s rtf={rtf:.3f}")
        except Exception as e:  # noqa: BLE001 - a failed request must not stop the worker
            print(f"{strftime()} {func_name}, Exception: {e!r}")
        finally:
            conn.close()


class TTServer:
    """`start()` loads the model (on `device`, default cuda), binds (port 0
    picks a free port) and starts the workers; `stop()` closes the listener,
    which ends them."""

    def __init__(self, host="127.0.0.1", port=5959, num_workers=1,
                 max_input_size=100 * 1024, ckpt_path: Optional[str] = None,
                 loglv=0, reuse_port=False, tts=None, device=None,
                 quantize: Optional[bool] = None):
        self.host = host
        self.port = port
        self.num_workers = num_workers
        self.max_input_size = max_input_size
        self.ckpt_path = ckpt_path
        self.loglv = loglv
        self.reuse_port = reuse_port
        self.device = device
        self.quantize = quantize
        self._tts = tts
        self._sock: Optional[socket.socket] = None
        self._threads = []

    @property
    def tts(self):
        return self._tts

    def start(self):
        """Load the model, bind, spawn the worker threads; returns the bound port."""
        if self._tts is None:
            from vits_tpu_torch.vits_wrap import VITSWrap
            print(f"{strftime()} TTServer: loading tts model ...")
            self._tts = VITSWrap(self.ckpt_path, device=self.device, loglv=self.loglv,
                                 quantize=self.quantize)
            print(f"{strftime()} TTServer: model loaded on {self._tts.speecher.device}, "
                  f"ckpt root={self._tts.speecher.res_root_path}")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self.reuse_port and hasattr(socket, "SO_REUSEPORT"):
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((self.host, self.port))
        s.listen(16)
        self._sock = s
        self.port = s.getsockname()[1]
        lock = threading.Lock()
        for work in range(self.num_workers):
            t = threading.Thread(
                target=tts_worker,
                args=(s, self._tts, lock, self.max_input_size, work, self.loglv),
                daemon=True)
            t.start()
            self._threads.append(t)
        return self.port

    def run(self):
        self.start()
        try:
            for t in self._threads:
                t.join()
        finally:
            self.stop()

    def stop(self):
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)  # wakes the workers' accept()
            except OSError:
                pass
            self._sock.close()
            self._sock = None


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5959)
    parser.add_argument("--n-jobs", "-j", type=int, default=1,
                        help="handler threads sharing the model")
    parser.add_argument("--max-input", "-m", type=int, default=100 * 1024)
    parser.add_argument("--checkpoint", "-c", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the model ('cpu' to run on the CPU)")
    parser.add_argument("--quantize", action="store_true", default=None,
                        help="int8 decoder serving mode")
    parser.add_argument("--reuse-port", action="store_true",
                        help="SO_REUSEPORT for one process per card")
    parser.add_argument("--loglv", "-d", type=int, default=0)
    args = parser.parse_args(argv)
    TTServer(args.host, args.port, args.n_jobs, args.max_input, args.checkpoint, args.loglv,
             args.reuse_port, device=args.device, quantize=args.quantize).run()


if __name__ == "__main__":
    main()
