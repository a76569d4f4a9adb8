"""Minimal OSC 1.0 over UDP (counterpart of `vampnet_tpu/serve/osc.py`), a
stdlib stand-in for `python-osc`.

What the unloop protocol needs: messages with int32, float32, string, blob
and boolean arguments, a dispatcher-based threaded UDP server, and a client.
Bundles are not used by unloop and are not implemented.
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Any, Callable, Dict, List, Tuple


def _pad(b: bytes) -> bytes:
    return b + b"\x00" * ((4 - len(b) % 4) % 4)


def encode_message(address: str, args: List[Any] | None = None) -> bytes:
    args = args or []
    out = _pad(address.encode() + b"\x00")
    tags = ","
    payload = b""
    for a in args:
        if isinstance(a, bool):
            tags += "T" if a else "F"
        elif isinstance(a, int):
            tags += "i"
            payload += struct.pack(">i", a)
        elif isinstance(a, float):
            tags += "f"
            payload += struct.pack(">f", a)
        elif isinstance(a, str):
            tags += "s"
            payload += _pad(a.encode() + b"\x00")
        elif isinstance(a, (bytes, bytearray)):
            tags += "b"
            payload += struct.pack(">i", len(a)) + _pad(bytes(a))
        else:
            raise TypeError(f"unsupported OSC argument type {type(a)}")
    return out + _pad(tags.encode() + b"\x00") + payload


def decode_message(data: bytes) -> Tuple[str, List[Any]]:
    def read_string(off):
        end = data.index(b"\x00", off)
        s = data[off:end].decode()
        off = end + 1
        off += (4 - off % 4) % 4
        return s, off

    address, off = read_string(0)
    if off >= len(data):
        return address, []
    tags, off = read_string(off)
    args: List[Any] = []
    for t in tags.lstrip(","):
        if t == "i":
            args.append(struct.unpack(">i", data[off : off + 4])[0])
            off += 4
        elif t == "f":
            args.append(struct.unpack(">f", data[off : off + 4])[0])
            off += 4
        elif t == "s":
            s, off = read_string(off)
            args.append(s)
        elif t == "b":
            n = struct.unpack(">i", data[off : off + 4])[0]
            off += 4
            args.append(data[off : off + n])
            off += n + (4 - n % 4) % 4
        elif t == "T":
            args.append(True)
        elif t == "F":
            args.append(False)
        else:
            raise ValueError(f"unsupported OSC type tag {t}")
    return address, args


class Dispatcher:
    """python-osc-compatible address -> handler mapping."""

    def __init__(self):
        self._handlers: Dict[str, Callable] = {}
        self._default: Callable | None = None

    def map(self, address: str, handler: Callable, *extra):
        self._handlers[address] = (handler, extra)

    def set_default_handler(self, handler: Callable):
        self._default = handler

    def dispatch(self, address: str, args: List[Any]):
        entry = self._handlers.get(address)
        if entry is not None:
            handler, extra = entry
            return handler(address, *extra, *args)
        if self._default is not None:
            return self._default(address, *args)
        return None


class OSCServer:
    """Threaded UDP OSC server (python-osc ThreadingOSCUDPServer surface)."""

    def __init__(self, addr: Tuple[str, int], dispatcher: Dispatcher):
        self.dispatcher = dispatcher

        class Handler(socketserver.BaseRequestHandler):
            def handle(hself):
                data = hself.request[0]
                try:
                    address, args = decode_message(data)
                except Exception:
                    return
                dispatcher.dispatch(address, args)

        self._server = socketserver.ThreadingUDPServer(addr, Handler)
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def serve_forever(self):
        self._server.serve_forever()

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


class OSCClient:
    """UDP OSC sender (python-osc SimpleUDPClient surface)."""

    def __init__(self, host: str, port: int):
        self.addr = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send_message(self, address: str, args: Any = None):
        if args is None:
            args = []
        elif not isinstance(args, (list, tuple)):
            args = [args]
        self._sock.sendto(encode_message(address, list(args)), self.addr)

    def close(self):
        self._sock.close()
