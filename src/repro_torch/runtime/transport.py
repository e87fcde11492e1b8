"""Length-prefixed JSON-over-TCP messaging (the control-plane fabric).

Wire format: an 8-byte header `!II` = (json_len, payload_len), then the
JSON document, then `payload_len` raw bytes. Control messages set
payload_len=0 and cost nothing extra; bulk data (checkpoint frames) rides
the payload channel untouched — no base64 inflation, no json escaping,
and sendall() works straight from a memoryview of the source buffer.
Receivers find the payload under msg["_payload"].

The base64 helpers are kept for small blobs embedded in control fields.

Lossy-link injection (`install_lossy`): the `lossy` gray-failure
mechanism degrades this layer in-process — every send_msg pays a fixed
delay, and a seeded fraction pays it twice (a modeled drop+retransmit;
the message itself is never lost, so the protocol stays exact while the
*timing* degrades). Seeded `random.Random` keeps runs reproducible.
"""
from __future__ import annotations

import base64
import json
import random
import socket
import struct
import time
from typing import Any, Optional

_HDR = struct.Struct("!II")
MAX_MSG = 512 * 1024 * 1024

# process-global lossy-link model, armed by install_lossy() in a worker
# whose scenario carries an active how="lossy" fault.
# [rng, delay, drop, sock-or-None]
_LOSSY: Optional[list] = None


def install_lossy(seed: int, delay_s: float, drop_frac: float = 0.2,
                  sock: Optional[socket.socket] = None):
    """Degrade subsequent send_msg calls in this process: +delay_s, and
    a seeded drop_frac of sends pay it doubled (drop + retransmit).
    With `sock` given only that channel degrades (one bad link, e.g.
    the victim's uplink to its daemon) — other fabrics stay healthy so
    the lateness is attributable to the victim alone."""
    global _LOSSY
    _LOSSY = [random.Random(seed), delay_s, drop_frac, sock]


def clear_lossy():
    global _LOSSY
    _LOSSY = None


def send_msg(sock: socket.socket, msg: dict,
             payload: bytes | bytearray | memoryview | None = None):
    if _LOSSY is not None:
        rng, delay_s, drop_frac, only = _LOSSY
        if only is None or sock is only:
            time.sleep(delay_s * (2.0 if rng.random() < drop_frac else 1.0))
    data = json.dumps(msg, separators=(",", ":")).encode()
    plen = 0 if payload is None else len(payload)
    sock.sendall(_HDR.pack(len(data), plen) + data)
    if plen:
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_msg(sock: socket.socket) -> Optional[dict]:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    n, plen = _HDR.unpack(hdr)
    if n > MAX_MSG or plen > MAX_MSG:
        raise IOError(f"message too large: {n}+{plen}")
    data = _recv_exact(sock, n)
    if data is None:
        return None
    msg = json.loads(data)
    if plen:
        payload = _recv_exact(sock, plen)
        if payload is None:
            return None
        msg["_payload"] = payload
    return msg


def connect(host: str, port: int, timeout: float = 10.0) -> socket.socket:
    s = socket.create_connection((host, port), timeout=timeout)
    s.settimeout(None)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def listener(host: str = "127.0.0.1", port: int = 0) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(128)
    return s


def pack_bytes(b: bytes) -> str:
    return base64.b64encode(b).decode()


def unpack_bytes(s: str) -> bytes:
    return base64.b64decode(s.encode())
