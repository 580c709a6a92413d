"""The port's websocket (viewer/websocket.py) and the viewer's protocol
(viewer/server.py) on the CPU, with stub renders.

- Interoperation with the `websockets` package (present on this CPU box,
  absent on the card's machine) in both directions: the port's server
  against a websockets client and the port's client against a websockets
  server, through text and binary messages with 7-, 16- and 64-bit frame
  lengths (a 1080p JPEG is over 65,535 bytes), fragmented messages to the
  port's side, pings both ways, and the closing handshake with its code.
  A websockets server drops a client whose frames are not masked, so the
  round trips also hold the client's masking; a raw unmasked frame sent to
  the port's server is answered with close code 1002.
- The viewer's protocol with a stub render_fn: the `outputs` greeting, the
  whole resolution ladder of a 16:9 camera at width 1920 (256, 512, 1024,
  1920, `final` on the last, each JPEG the size its stats message names),
  stale refinements dropped when a second camera arrives mid-ladder, the
  control messages without a trainer or exporter (their errors), a
  `train_control` hook, `train_stats` pushed from another thread, and the
  page on the HTTP port (the JAX package's client, byte for byte).
"""

import asyncio
import json
import socket
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest
import websockets

from nerfstudio_thermal_tpu.viewer.client_html import CLIENT_HTML as JAX_CLIENT_HTML

from nerfstudio_thermal_torch.data.jpeg import decode_jpeg_bytes
from nerfstudio_thermal_torch.viewer import websocket as ws
from nerfstudio_thermal_torch.viewer.client_html import CLIENT_HTML
from nerfstudio_thermal_torch.viewer.server import RESOLUTION_BUCKETS, ViewerServer, free_port_pair

TIMEOUT = 30.0


SIZES = (0, 10, 125, 126, 1000, 65535, 65536, 200_000)


def payloads():
    rng = np.random.default_rng(0)
    for n in SIZES:
        yield rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        yield "t" * n


@pytest.mark.parametrize("n, head", [(125, b"\x82\x7d"), (126, b"\x82\x7e\x00\x7e"), (65535, b"\x82\x7e\xff\xff"),
                                     (65536, b"\x82\x7f" + struct.pack("!Q", 65536))])
def test_frame_lengths_and_masking(n, head):
    payload = bytes(range(256)) * (n // 256) + bytes(n % 256)
    frame = ws.encode_frame(ws.OP_BINARY, payload, masked=False)
    assert frame == head + payload
    masked = ws.encode_frame(ws.OP_BINARY, payload, masked=True)
    assert masked[1] & 0x80 and masked[:1] == head[:1]
    mask = masked[len(head):len(head) + 4]
    assert ws.mask_payload(masked[len(head) + 4:], mask) == payload
    # RFC 6455 1.3's example key
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_port_server_with_a_websockets_client():
    async def echo(conn):
        async for message in conn:
            await conn.send(message)

    async def drive():
        server = await ws.serve(echo, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        async with server:
            async with websockets.connect(f"ws://127.0.0.1:{port}", max_size=None) as client:
                for p in payloads():
                    await client.send(p)
                    assert await asyncio.wait_for(client.recv(), TIMEOUT) == p
                # a fragmented message, text and binary
                await client.send(["frag", "mented", "!"])
                assert await asyncio.wait_for(client.recv(), TIMEOUT) == "fragmented!"
                await client.send([b"\x00" * 70000, b"\x01" * 3])
                assert await asyncio.wait_for(client.recv(), TIMEOUT) == b"\x00" * 70000 + b"\x01" * 3
                pong = await client.ping(b"abcd")
                await asyncio.wait_for(pong, TIMEOUT)
                await client.close(code=1000)
            assert client.close_code == 1000

    asyncio.run(asyncio.wait_for(drive(), 120))


def test_port_client_with_a_websockets_server():
    seen = {}

    async def handler(conn):
        async for message in conn:
            if message == "fragments":
                await conn.send(["a" * 10, "b" * 70000])
            elif message == "ping me":
                pong = await conn.ping(b"wxyz")
                await conn.send("pinging")
                await asyncio.wait_for(pong, TIMEOUT)
                await conn.send("pong seen")
            else:
                await conn.send(message)
        seen["code"] = conn.close_code

    async def drive():
        async with websockets.serve(handler, "127.0.0.1", 0, max_size=None) as server:
            port = next(iter(server.sockets)).getsockname()[1]
            client = await ws.connect(f"ws://127.0.0.1:{port}/")
            for p in payloads():
                await client.send(p)
                assert await asyncio.wait_for(client.recv(), TIMEOUT) == p
            await client.send("fragments")
            assert await asyncio.wait_for(client.recv(), TIMEOUT) == "a" * 10 + "b" * 70000
            await client.send("ping me")  # answered inside recv()
            assert await asyncio.wait_for(client.recv(), TIMEOUT) == "pinging"
            assert await asyncio.wait_for(client.recv(), TIMEOUT) == "pong seen"
            await client.close(1000)
            assert client.closed is not None
            with pytest.raises(ws.ConnectionClosed):
                await client.send("after close")
            for _ in range(100):
                if "code" in seen:
                    break
                await asyncio.sleep(0.05)
        assert seen["code"] == 1000

    asyncio.run(asyncio.wait_for(drive(), 120))


def test_port_server_closes_on_an_unmasked_client_frame():
    async def echo(conn):
        async for message in conn:
            await conn.send(message)

    async def drive():
        server = await ws.serve(echo, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        async with server:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                         b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\nSec-WebSocket-Version: 13\r\n\r\n")
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), TIMEOUT)
            assert b" 101 " in head and b"s3pPLMBiTxaQ9kYGzzhZRbK+xOo=" in head
            writer.write(ws.encode_frame(ws.OP_TEXT, b"unmasked", masked=False))
            frame = await asyncio.wait_for(reader.readexactly(4), TIMEOUT)
            assert frame[0] == 0x80 | ws.OP_CLOSE and struct.unpack("!H", frame[2:4])[0] == 1002
            writer.close()

    asyncio.run(asyncio.wait_for(drive(), 60))


class StubRender:
    """A render_fn that paints each request's width into the red channel
    and can be slowed down; it records its calls."""

    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.calls = []

    def __call__(self, c2w, width, height, output, crop=None, fov=60.0, **kw):
        self.calls.append((width, height, output))
        time.sleep(self.delay)
        img = np.zeros((height, width, 3), np.float32)
        img[..., 0] = width / 2000.0
        img[..., 1] = 0.5 if output == "rgb" else 0.25
        return img


def _camera(width, **extra):
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[0, 3] = 2.0
    return json.dumps({"type": "camera", "c2w": c2w.tolist(), "width": width, "aspect": 16 / 9, **extra})


async def _frame(client):
    stats = json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))
    assert stats["type"] == "stats" and "error" not in stats, stats
    jpeg = await asyncio.wait_for(client.recv(), TIMEOUT)
    return stats, decode_jpeg_bytes(jpeg)


def _started(render, **kw):
    server = ViewerServer(render, ["rgb", "depth"], port=free_port_pair(), **kw)
    server.start()
    return server


def test_ladder_and_stale_refinements():
    render = StubRender(delay=0.3)
    server = _started(render)

    async def drive():
        client = await ws.connect(f"ws://127.0.0.1:{server.port + 1}/")
        hello = json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))
        assert hello == {"type": "outputs", "names": ["rgb", "depth"]}
        await client.send(_camera(1920))
        for width in RESOLUTION_BUCKETS:
            stats, img = await _frame(client)
            assert (stats["width"], stats["seq"], stats["final"]) == (width, 1, width == 1920)
            assert img.shape == (stats["height"], width, 3) and stats["height"] == int(width / (16 / 9)) // 8 * 8
            assert set(stats["bucket_render_ms"]) == {str(b) for b in RESOLUTION_BUCKETS if b <= width}
        # a second camera while the first climbs: its refinements are dropped
        await client.send(_camera(1920))
        stats, _ = await _frame(client)
        assert (stats["width"], stats["seq"]) == (256, 2)
        await client.send(_camera(1920))  # arrives while 512 of seq 2 renders
        got = []
        while not got or not got[-1]["final"]:
            got.append((await _frame(client))[0])
        assert [(s["seq"], s["width"]) for s in got] == [(3, w) for w in RESOLUTION_BUCKETS]
        # an intermediate target stops the climb there
        await client.send(_camera(600))
        assert [(await _frame(client))[0]["width"] for _ in range(2)] == [256, 512]
        await client.close()

    try:
        asyncio.run(asyncio.wait_for(drive(), 120))
    finally:
        server.stop()
    # seq 2's 512 refinement was rendered but not sent; nothing larger ran
    widths = [c[0] for c in render.calls]
    assert widths == [256, 512, 1024, 1920, 256, 512, 256, 512, 1024, 1920, 256, 512]


def test_control_messages_and_train_stats(tmp_path):
    actions = []

    def control(action):
        if action == "bogus":
            raise ValueError("unknown train_control action 'bogus'")
        actions.append(action)
        return {"paused": action == "pause", "step": 3}

    bare = _started(StubRender())
    hooked = _started(StubRender(), train_control=control, save_dir=tmp_path,
                      export_fn=lambda kind, crop=None: tmp_path / f"{kind}.ply")

    async def drive():
        client = await ws.connect(f"ws://127.0.0.1:{bare.port + 1}/")
        await asyncio.wait_for(client.recv(), TIMEOUT)
        for msg, reply in (({"type": "train_control", "action": "pause"}, "train_state"),
                           ({"type": "export", "kind": "pointcloud"}, "exported")):
            await client.send(json.dumps(msg))
            got = json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))
            assert got["type"] == reply and "error" in got
        await client.close()

        client = await ws.connect(f"ws://127.0.0.1:{hooked.port + 1}/")
        await asyncio.wait_for(client.recv(), TIMEOUT)
        for action in ("pause", "step", "bogus", "resume"):
            await client.send(json.dumps({"type": "train_control", "action": action}))
            got = json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))
            assert got["type"] == "train_state"
            assert got == ({"type": "train_state", "error": "unknown train_control action 'bogus'"}
                           if action == "bogus" else {"type": "train_state", "paused": action == "pause", "step": 3})
        await client.send(json.dumps({"type": "export", "kind": "tsdf", "crop": [[0, 0, 0], [1, 1, 1]]}))
        got = json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))
        assert got == {"type": "exported", "path": str(tmp_path / "tsdf.ply")}
        c2w = np.eye(4)[:3].tolist()
        await client.send(json.dumps({"type": "save_path", "keyframes": [c2w, c2w], "seconds": 1.0, "fps": 4}))
        got = json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))
        assert got["type"] == "saved" and len(json.loads(open(got["path"]).read())["camera_path"]) == 4
        await client.send(json.dumps({"type": "save_path", "keyframes": []}))
        assert "error" in json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))
        # train_stats from another thread, to every client
        threading.Thread(target=hooked.update_train_stats, args=({"step": 9, "loss": 0.5},)).start()
        got = json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))
        assert got == {"type": "train_stats", "step": 9, "loss": 0.5}
        await client.close()
        # a new client is greeted with the last stats
        client = await ws.connect(f"ws://127.0.0.1:{hooked.port + 1}/")
        assert json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))["type"] == "outputs"
        assert json.loads(await asyncio.wait_for(client.recv(), TIMEOUT))["step"] == 9
        await client.close()

    try:
        asyncio.run(asyncio.wait_for(drive(), 120))
        page = urllib.request.urlopen(f"http://127.0.0.1:{hooked.port}/", timeout=TIMEOUT).read()
        assert page == CLIENT_HTML.encode() == JAX_CLIENT_HTML.encode()
    finally:
        bare.stop()
        hooked.stop()
    assert actions == ["pause", "step", "resume"]


def test_a_busy_port_fails_to_start():
    port = free_port_pair()
    with socket.socket() as s:
        s.bind(("0.0.0.0", port + 1))
        s.listen()
        server = ViewerServer(StubRender(), ["rgb"], port=port)
        with pytest.raises(RuntimeError, match="did not start"):
            server.start()
