"""A small RFC 6455 websocket server and client on asyncio streams.

The JAX package's viewer serves its websocket through the `websockets`
package (`websockets.serve(..., max_size=None)`), which the card's machine
does not have and cannot install. This module is the port's own, with the
standard library alone (`asyncio`, `hashlib.sha1`, `base64`, `os.urandom`),
and covers what the viewer and its clients use:

- the opening handshake (`Sec-WebSocket-Accept` from the key and the RFC's
  GUID); no extension or subprotocol is negotiated, so a client that
  offers permessage-deflate talks uncompressed;
- text and binary messages of any size (7-, 16- and 64-bit frame lengths;
  a 1920x1080 JPEG is well over 65,535 bytes), fragmented messages
  reassembled from continuation frames, and control frames between the
  fragments;
- masking: a client masks every frame it sends, a server masks none, and
  each side closes with 1002 (protocol error) on a frame masked the wrong
  way;
- ping (answered with a pong of the same payload; pongs are ignored)
  and the closing handshake (`close()`; a close frame is echoed).

`serve(handler, host, port)` returns the listening `asyncio.Server`, and
calls `handler(connection)` for each client once the handshake is done;
`connect("ws://host:port/")` is the client. A connection is an async
iterator over its messages (str for text, bytes for binary) that stops
when the peer closes; `recv()` raises `ConnectionClosed` then, as `send()`
does on a closed connection.
"""

import asyncio
import base64
import hashlib
import os
import struct
from typing import Awaitable, Callable, Dict, Optional, Tuple, Union
from urllib.parse import urlparse

GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONTINUATION, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA

Message = Union[str, bytes]


class ConnectionClosed(Exception):
    """The connection is closed: `code` and `reason` are the peer's close
    frame's (1006 when the stream ended without one)."""

    def __init__(self, code: int = 1006, reason: str = ""):
        super().__init__(f"websocket closed ({code}{': ' + reason if reason else ''})")
        self.code = code
        self.reason = reason


def accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key."""
    return base64.b64encode(hashlib.sha1(key.encode() + GUID).digest()).decode()


def mask_payload(payload: bytes, mask: bytes) -> bytes:
    """XOR the payload with the repeated 4-byte mask (its own inverse)."""
    if not payload:
        return payload
    n = len(payload)
    key = int.from_bytes((mask * (n // 4 + 1))[:n], "little")
    return (int.from_bytes(payload, "little") ^ key).to_bytes(n, "little")


def encode_frame(opcode: int, payload: bytes, masked: bool, fin: bool = True) -> bytes:
    """One frame: FIN and opcode, the 7-, 16- or 64-bit length, and with
    `masked` a fresh mask key and the masked payload."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    bit = 0x80 if masked else 0
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if masked:
        mask = os.urandom(4)
        return bytes(head) + mask + mask_payload(payload, mask)
    return bytes(head) + payload


async def _read_headers(reader: asyncio.StreamReader) -> Tuple[str, Dict[str, str]]:
    raw = await reader.readuntil(b"\r\n\r\n")
    lines = raw.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return lines[0], headers


class Connection:
    """One side of an open websocket. `client` is True for the side that
    masks its frames."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, client: bool):
        self.reader = reader
        self.writer = writer
        self.client = client
        self.closed: Optional[ConnectionClosed] = None
        self._close_sent = False
        self._reading = False  # a coroutine waits in _read_frame
        self._write_lock = asyncio.Lock()

    async def _write(self, frame: bytes) -> None:
        async with self._write_lock:
            self.writer.write(frame)
            await self.writer.drain()

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self.closed is not None or self._close_sent:
            raise self.closed or ConnectionClosed(1000)
        try:
            await self._write(encode_frame(opcode, payload, masked=self.client))
        except (ConnectionError, OSError) as e:
            self.closed = self.closed or ConnectionClosed(1006, str(e))
            raise self.closed from e

    async def send(self, message: Message) -> None:
        """A text (str) or binary (bytes) message, in one frame."""
        if isinstance(message, str):
            await self._send_frame(OP_TEXT, message.encode())
        else:
            await self._send_frame(OP_BINARY, bytes(message))

    async def close(self, code: int = 1000, reason: str = "") -> None:
        """Send a close frame (once), wait briefly for the peer's, and
        close the stream."""
        if not self._close_sent and self.closed is None:
            self._close_sent = True
            try:
                await self._write(encode_frame(OP_CLOSE, struct.pack("!H", code) + reason.encode(), self.client))
                await asyncio.wait_for(self._drain_until_closed(), 2.0)
            except (asyncio.TimeoutError, ConnectionError, OSError):
                pass
        self.closed = self.closed or ConnectionClosed(code, reason)
        self._abort()

    async def _drain_until_closed(self) -> None:
        while self.closed is None:
            if self._reading:  # the reading coroutine will see the reply
                await asyncio.sleep(0.01)
            else:
                try:
                    await self._read_frame()
                except ConnectionClosed:
                    return

    def _abort(self) -> None:
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001 — the transport may be gone already
            pass

    async def _read_frame(self) -> Tuple[bool, int, bytes]:
        self._reading = True
        try:
            b0, b1 = await self.reader.readexactly(2)
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack("!H", await self.reader.readexactly(2))
            elif n == 127:
                (n,) = struct.unpack("!Q", await self.reader.readexactly(8))
            mask = await self.reader.readexactly(4) if b1 & 0x80 else None
            payload = await self.reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self.closed = self.closed or ConnectionClosed(1006, "stream ended")
            self._abort()
            raise self.closed from e
        finally:
            self._reading = False
        if (mask is not None) == self.client:
            # RFC 6455 5.1: clients mask every frame, servers none
            await self._fail(1002, "frame masked the wrong way")
        if mask is not None:
            payload = mask_payload(payload, mask)
        fin, opcode = bool(b0 & 0x80), b0 & 0x0F
        if opcode == OP_CLOSE:
            code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1005
            reason = payload[2:].decode(errors="replace")
            if not self._close_sent:
                self._close_sent = True
                try:
                    await self._write(encode_frame(OP_CLOSE, payload[:2], self.client))
                except (ConnectionError, OSError):
                    pass
            self.closed = ConnectionClosed(code, reason)
            self._abort()
            raise self.closed
        return fin, opcode, payload

    async def _fail(self, code: int, reason: str) -> None:
        await self.close(code, reason)
        raise self.closed

    async def recv(self) -> Message:
        """The next message: str for text, bytes for binary. Pings are
        answered on the way."""
        if self.closed is not None:
            raise self.closed
        parts, kind = [], None
        while True:
            fin, opcode, payload = await self._read_frame()
            if opcode == OP_PING:
                try:
                    await self._send_frame(OP_PONG, payload)
                except ConnectionClosed:
                    pass
                continue
            if opcode == OP_PONG:
                continue
            if opcode in (OP_TEXT, OP_BINARY):
                if kind is not None:
                    await self._fail(1002, "new message inside a fragmented one")
                kind = opcode
            elif opcode == OP_CONTINUATION:
                if kind is None:
                    await self._fail(1002, "continuation without a message")
            else:
                await self._fail(1002, f"unknown opcode {opcode}")
            parts.append(payload)
            if fin:
                data = b"".join(parts)
                return data.decode() if kind == OP_TEXT else data

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        try:
            return await self.recv()
        except ConnectionClosed:
            raise StopAsyncIteration from None


async def serve(handler: Callable[[Connection], Awaitable[None]], host: str, port: int) -> asyncio.Server:
    """Listen on (host, port); each client that completes the handshake is
    handed to `handler` as a server-side Connection, closed when the
    handler returns."""

    async def on_client(reader, writer):
        try:
            request, headers = await _read_headers(reader)
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ConnectionError, OSError):
            writer.close()
            return
        key = headers.get("sec-websocket-key")
        if (not request.startswith("GET ") or "websocket" not in headers.get("upgrade", "").lower()
                or key is None):
            writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\nConnection: close\r\n\r\n")
            writer.close()
            return
        writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
            + f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n".encode()
        )
        conn = Connection(reader, writer, client=False)
        try:
            await writer.drain()
            await handler(conn)
        except (ConnectionClosed, ConnectionError, OSError):
            pass
        finally:
            await conn.close()

    return await asyncio.start_server(on_client, host, port)


async def connect(uri: str, open_timeout: float = 30.0) -> Connection:
    """Open a client connection to ws://host:port/path."""
    url = urlparse(uri)
    if url.scheme != "ws":
        raise ValueError(f"only ws:// URIs are supported, got {uri!r}")
    host, port = url.hostname, url.port or 80

    async def handshake():
        reader, writer = await asyncio.open_connection(host, port)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write(
            f"GET {url.path or '/'} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n".encode()
        )
        await writer.drain()
        status, headers = await _read_headers(reader)
        if " 101 " not in status + " " or headers.get("sec-websocket-accept") != accept_key(key):
            writer.close()
            raise ConnectionError(f"websocket handshake with {uri} failed: {status}")
        return Connection(reader, writer, client=True)

    return await asyncio.wait_for(handshake(), open_timeout)
