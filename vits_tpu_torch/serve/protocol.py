"""Socket wire protocol and client of the port's TTS server (counterpart of
vits_tpu/serve/protocol.py): a 4-byte little-endian length prefix and a
pickled request or response dict per frame over TCP, frames sized by their
exact byte length. Pickle runs code as it loads: the server and this client
trust each other, as the JAX package's pair does.
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Optional, Tuple


def send_msg(sock: socket.socket, obj) -> None:
    body = pickle.dumps(obj)
    sock.sendall(struct.pack("<i", len(body)))
    sock.sendall(body)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def recv_msg(sock: socket.socket):
    header = sock.recv(4)
    if not header or len(header) < 4:
        return None
    (size,) = struct.unpack("<i", header)
    if size <= 0:
        return None
    return pickle.loads(recv_exact(sock, size))


def synthesize_stream(inputs: dict, remote: Tuple[str, int] = ("localhost", 5959),
                      timeout: float = 60):
    """Streaming client call: sends the request with `stream=True` and yields
    each framed response — PCM chunk dicts ({"pcm", "sr", "seq", ...}) followed
    by the final metadata dict ({"final": True, ...}). The connection is
    per-request (the server ends the stream with the final dict)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    try:
        sock.connect(remote)
        send_msg(sock, {**inputs, "stream": True})
        while True:
            msg = recv_msg(sock)
            if msg is None:
                break
            yield msg
            if msg.get("final"):
                break
    finally:
        sock.close()


def synthesize(inputs: dict, remote: Tuple[str, int] = ("localhost", 5959),
               tcp_client_socket: Optional[socket.socket] = None,
               return_socket: bool = False):
    """Client call: one request, one response; optionally keeps the
    connection alive for reuse."""
    outputs = None
    try:
        if tcp_client_socket is None:
            tcp_client_socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            tcp_client_socket.settimeout(60)
            tcp_client_socket.connect(remote)
        send_msg(tcp_client_socket, inputs)
        outputs = recv_msg(tcp_client_socket)
    except (OSError, EOFError, pickle.UnpicklingError) as e:  # the caller gets None
        print("synthesize:: Exception:", e)
        outputs = None
    finally:
        if not return_socket or outputs is None:
            if tcp_client_socket is not None:
                tcp_client_socket.close()
            tcp_client_socket = None
    return (outputs, tcp_client_socket) if return_socket else outputs


def main(argv=None):
    """Ad-hoc synthesis client CLI: send one utterance or a text file line by
    line to a running socket server and write the returned WAV payloads to
    --outdir. Use --stream to exercise the chunked-streaming protocol instead
    (frames are concatenated into the same WAV payload)."""
    import argparse
    import os

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5959)
    parser.add_argument("--utterance", "-u", help="one UTF-8 utterance")
    parser.add_argument("--textfile", "-t", help="UTF-8 text file, one utterance per line")
    parser.add_argument("--spkid", "-i", type=int, default=1)
    parser.add_argument("--volume", "-v", type=float, default=1.0)
    parser.add_argument("--speed", "-s", type=float, default=1.0)
    parser.add_argument("--pitch", "-p", type=float, default=1.0)
    parser.add_argument("--sampling-rate", "-r", type=int)
    parser.add_argument("--stream", action="store_true",
                        help="use the chunked streaming protocol")
    parser.add_argument("--outdir", "-o", required=True)
    args = parser.parse_args(argv)

    texts = []
    if args.utterance:
        texts.append(args.utterance)
    if args.textfile:
        with open(args.textfile, "rt", encoding="utf-8") as f:
            texts.extend(line.strip() for line in f if line.strip())
    if not texts:
        parser.error("specify --utterance and/or --textfile")
    os.makedirs(args.outdir, exist_ok=True)

    remote = (args.host, args.port)
    base = {"spkid": args.spkid, "volume": args.volume, "speed": args.speed,
            "pitch": args.pitch}
    if args.sampling_rate:
        base["sampling_rate"] = args.sampling_rate
    for idx, text in enumerate(texts, 1):
        inputs = dict(base, text=text)
        if args.stream:
            from vits_tpu_torch.utils.audio import wav_header
            pcm, meta = b"", {}
            for msg in synthesize_stream(inputs, remote):
                if isinstance(msg, dict) and "pcm" in msg:
                    pcm += msg["pcm"]
                elif isinstance(msg, dict):
                    meta = msg
            if not pcm:
                print(f"[{idx}] synthesis failure")
                continue
            sr = meta.get("sr", base.get("sampling_rate", 16000))
            wav = wav_header(len(pcm), sr, 16) + pcm
            print(f"[{idx}]", {k: v for k, v in meta.items() if k != "wav"})
        else:
            outputs = synthesize(inputs, remote)
            if outputs is None:
                print(f"[{idx}] synthesis failure")
                continue
            wav = outputs.pop("wav")
            print(f"[{idx}]", {k: v for k, v in outputs.items()
                               if k not in ("text", "segment_info")})
        with open(os.path.join(args.outdir, f"{idx:06d}.wav"), "wb") as f:
            f.write(wav)


if __name__ == "__main__":
    main()
