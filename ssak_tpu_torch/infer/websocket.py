"""A minimal WebSocket (RFC 6455) on asyncio streams, for the streaming
server (infer.streaming) and its client (remote.client).

The port carries this instead of the `websockets` package, which ssak_tpu
uses, so that `sak-stream` needs nothing beyond the standard library. It
has the opening handshake (Sec-WebSocket-Key -> Sec-WebSocket-Accept),
masked client frames and unmasked server frames, 7-, 16- and 64-bit payload
lengths, fragmented messages received (continuation frames, with control
frames between them; it sends each message as one frame), text, binary,
ping / pong and the close handshake; no extensions and no subprotocols. A
frame or a fragmented message above MAX_SIZE bytes (1 MiB, `websockets`'
default) is refused before it is read: the connection closes with 1009.
The connection object mirrors the part of `websockets`' API that the two
callers use: `send`, `recv`, `async for`, `close`, `ConnectionClosed` /
`ConnectionClosedOK`.

    server = await serve(handler, "127.0.0.1", 0)   # handler(ws) is a coroutine
    async with connect("ws://127.0.0.1:2700") as ws:
        await ws.send(b"...")
        reply = await ws.recv()
"""

import asyncio
import base64
import hashlib
import os
import struct
from urllib.parse import urlsplit

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
CLOSE_TIMEOUT = 10.0
MAX_SIZE = 2**20  # bytes of one received message
_OK_CODES = (1000, 1001, 1005)  # normal, going away, no status given


class ConnectionClosed(Exception):
    """The connection is closed; `code` and `reason` are the close frame's
    (1005: no code given; 1006: closed without a close frame)."""

    def __init__(self, code: int, reason: str = ""):
        super().__init__(f"connection closed: {code} {reason}".strip())
        self.code, self.reason = code, reason


class ConnectionClosedOK(ConnectionClosed):
    """Closed by a normal close handshake (code 1000, 1001 or none)."""


class ProtocolError(Exception):
    pass


class PayloadTooBig(ProtocolError):
    """A frame, or a fragmented message so far, longer than MAX_SIZE."""


def accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a Sec-WebSocket-Key (RFC 6455 §4.2.2)."""
    return base64.b64encode(hashlib.sha1((key + GUID).encode("ascii")).digest()).decode("ascii")


def apply_mask(data: bytes, key: bytes) -> bytes:
    """XOR `data` with the 4-byte masking key repeated (masking and
    unmasking are the same operation)."""
    n = len(data)
    if not n:
        return b""
    pad = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(pad, "little")).to_bytes(n, "little")


def encode_frame(opcode: int, payload: bytes, mask: bool, fin: bool = True) -> bytes:
    """One frame: FIN and opcode, the payload length in 7, 16 or 64 bits,
    and, for a client (`mask`), a random masking key and the masked
    payload."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    n, m = len(payload), 0x80 if mask else 0
    if n < 126:
        head.append(m | n)
    elif n < 1 << 16:
        head += bytes([m | 126]) + struct.pack("!H", n)
    else:
        head += bytes([m | 127]) + struct.pack("!Q", n)
    if mask:
        key = os.urandom(4)
        return bytes(head) + key + apply_mask(payload, key)
    return bytes(head) + bytes(payload)


async def read_frame(reader, limit=None) -> tuple:
    """(fin, opcode, payload, masked) of the next frame on `reader`;
    the payload unmasked. A data frame longer than `limit` bytes
    raises PayloadTooBig before its payload is read; a control frame may
    carry 125 bytes at most (RFC 6455 §5.5)."""
    b0, b1 = await reader.readexactly(2)
    if b0 & 0x70:
        raise ProtocolError("reserved bits set: no extension was negotiated")
    n = b1 & 0x7F
    if b0 & 0x08 and n > 125:
        raise ProtocolError("a control frame longer than 125 bytes")
    if n == 126:
        (n,) = struct.unpack("!H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack("!Q", await reader.readexactly(8))
    if limit is not None and n > limit:
        raise PayloadTooBig(f"a frame of {n} bytes, over the {limit} left of the message's {MAX_SIZE}")
    masked = bool(b1 & 0x80)
    key = await reader.readexactly(4) if masked else b""
    payload = await reader.readexactly(n) if n else b""
    return bool(b0 & 0x80), b0 & 0x0F, apply_mask(payload, key) if masked else payload, masked


class WebSocket:
    """One open connection. A background task reads frames into a queue of
    whole messages (so a cancelled `recv` loses nothing), answers pings and
    the peer's close frame, and closes with 1009 on a message above
    MAX_SIZE bytes."""

    def __init__(self, reader, writer, client: bool):
        self._reader, self._writer, self._client = reader, writer, client
        self._messages = asyncio.Queue()
        self._close_sent = False
        self._closed = None  # the ConnectionClosed once the connection is over
        self._write_lock = asyncio.Lock()
        self._read_task = asyncio.ensure_future(self._read_loop())

    async def _write(self, opcode: int, payload: bytes):
        async with self._write_lock:
            self._writer.write(encode_frame(opcode, payload, self._client))
            await self._writer.drain()

    async def _send_close(self, code: int, reason: str = ""):
        if self._close_sent:
            return
        self._close_sent = True
        payload = b"" if code == 1005 else struct.pack("!H", code) + reason.encode("utf-8")
        try:
            await self._write(OP_CLOSE, payload)
        except (ConnectionError, RuntimeError):
            pass

    async def _read_loop(self):
        code, reason, parts, kind, size = 1006, "", [], None, 0
        try:
            while True:
                fin, op, payload, masked = await read_frame(self._reader, MAX_SIZE - size)
                if masked == self._client:
                    raise ProtocolError("a client masks its frames and a server does not")
                if op == OP_CLOSE:
                    code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1005
                    reason = payload[2:].decode("utf-8", "replace")
                    await self._send_close(code)
                    break
                if op == OP_PING:
                    await self._write(OP_PONG, payload)
                    continue
                if op == OP_PONG:
                    continue
                if op in (OP_TEXT, OP_BINARY):
                    if kind is not None:
                        raise ProtocolError("a new message inside a fragmented one")
                    kind, parts = op, [payload]
                elif op == OP_CONT:
                    if kind is None:
                        raise ProtocolError("a continuation frame outside a message")
                    parts.append(payload)
                else:
                    raise ProtocolError(f"unknown opcode {op}")
                size += len(payload)
                if fin:
                    data = b"".join(parts)
                    self._messages.put_nowait(data.decode("utf-8") if kind == OP_TEXT else data)
                    kind, parts, size = None, [], 0
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except (ProtocolError, UnicodeDecodeError) as e:
            code = 1007 if isinstance(e, UnicodeDecodeError) else 1009 if isinstance(e, PayloadTooBig) else 1002
            reason = str(e)
            await self._send_close(code, reason[:120])
        finally:
            ok = code in _OK_CODES and self._close_sent
            self._closed = (ConnectionClosedOK if ok else ConnectionClosed)(code, reason)
            self._messages.put_nowait(self._closed)
            if not self._client:  # the server closes the TCP connection first (RFC 6455 §7.1.1)
                self._writer.close()

    async def send(self, message):
        """Send a str as one text frame, bytes as one binary frame."""
        if self._closed is not None or self._close_sent:
            raise self._closed or ConnectionClosed(1006, "closing")
        if isinstance(message, str):
            await self._write(OP_TEXT, message.encode("utf-8"))
        else:
            await self._write(OP_BINARY, bytes(message))

    async def recv(self):
        """The next message, str (text) or bytes (binary); raises
        ConnectionClosed(OK) once the connection is closed."""
        item = await self._messages.get()
        if isinstance(item, ConnectionClosed):
            self._messages.put_nowait(item)
            raise item
        return item

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self.recv()
        except ConnectionClosedOK:
            raise StopAsyncIteration from None

    async def close(self, code: int = 1000, reason: str = ""):
        """The close handshake: send a close frame, wait for the peer's
        (and, as a client, for the server to end the TCP connection)."""
        if self._closed is None:
            await self._send_close(code, reason)
            try:
                await asyncio.wait_for(asyncio.shield(self._read_task), CLOSE_TIMEOUT)
            except asyncio.TimeoutError:
                self._read_task.cancel()
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass


def _parse_headers(block: bytes) -> tuple:
    lines = block.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return lines[0], headers


async def _server_handshake(reader, writer) -> bool:
    request, headers = _parse_headers(await reader.readuntil(b"\r\n\r\n"))
    key = headers.get("sec-websocket-key", "")
    ok = (request.startswith("GET ") and headers.get("upgrade", "").lower() == "websocket"
          and "upgrade" in headers.get("connection", "").lower() and headers.get("sec-websocket-version") == "13"
          and len(base64.b64decode(key.encode("ascii"), validate=False) if key else b"") == 16)
    if not ok:
        writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\nConnection: close\r\n\r\n")
        await writer.drain()
        writer.close()
        return False
    writer.write(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n").encode("ascii"))
    await writer.drain()
    return True


async def serve(handler, host: str = "127.0.0.1", port: int = 0):
    """Start a WebSocket server; `handler(ws)` runs for each connection,
    which is closed (code 1000) when it returns; a handler ended by the
    connection's closing ends quietly. Returns the asyncio.Server
    (server.sockets[0].getsockname() for the bound port)."""

    async def on_connect(reader, writer):
        try:
            if not await _server_handshake(reader, writer):
                return
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ConnectionError, ValueError):
            writer.close()
            return
        ws = WebSocket(reader, writer, client=False)
        try:
            await handler(ws)
        except ConnectionClosed:
            pass
        finally:
            await ws.close()

    return await asyncio.start_server(on_connect, host, port)


class connect:
    """`async with connect("ws://host:port/path") as ws`: opens the TCP
    connection, runs the opening handshake (checking the server's
    Sec-WebSocket-Accept) and closes the connection on exit."""

    def __init__(self, url: str):
        self.url = urlsplit(url)
        if self.url.scheme != "ws":
            raise ValueError(f"only ws:// URLs are supported, got {url}")
        self.ws = None

    async def __aenter__(self) -> WebSocket:
        host, port = self.url.hostname, self.url.port or 80
        reader, writer = await asyncio.open_connection(host, port)
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        path = (self.url.path or "/") + (f"?{self.url.query}" if self.url.query else "")
        writer.write((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode("ascii"))
        await writer.drain()
        status, headers = _parse_headers(await reader.readuntil(b"\r\n\r\n"))
        if status.split()[1:2] != ["101"] or headers.get("sec-websocket-accept") != accept_key(key):
            writer.close()
            raise ProtocolError(f"the server refused the WebSocket handshake: {status}")
        self.ws = WebSocket(reader, writer, client=True)
        return self.ws

    async def __aexit__(self, *exc):
        await self.ws.close()
