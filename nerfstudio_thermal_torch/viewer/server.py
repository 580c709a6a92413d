"""Real-time web viewer: HTTP page + websocket render loop
(counterpart of nerfstudio_thermal_tpu/viewer/server.py).

A browser client orbits a camera; the server renders through the model on
its device and streams JPEGs back, dropping to a lower resolution while the
camera moves and climbing back to the requested one while it stays still
(reference `nerfstudio/viewer/viewer.py:55`, `render_state_machine.py:54-236`).
The page is served on `port` and the websocket on `port + 1`, with the JAX
package's protocol and client page.

Progressive refinement: each camera message renders the coarsest
resolution bucket first, then climbs `RESOLUTION_BUCKETS` toward the
requested width while no newer camera message arrives; a newer message
drops the stale refinements (a stale coarse frame is still sent: it is the
freshest complete frame). `bucket_render_ms` keeps the last render time of
each bucket and rides in every stats message.

Two dependencies of the JAX server are replaced, since the card's machine
has neither: the websocket is `viewer/websocket.py` (the port's own RFC
6455 server) instead of `websockets`, and frames are encoded by the port's
baseline JPEG encoder (`data/jpeg.encode_jpeg`, Pillow's bytes at quality
85) instead of Pillow.

Renders run in the event loop's worker threads, each under its own
`torch.inference_mode()` (grad mode is thread-local) and under
`train_lock`, which the trainer holds around each training step; a render
copies its displayed output to the host before the lock is released.
"""

import asyncio
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerfstudio_thermal_torch.data.jpeg import encode_jpeg
from nerfstudio_thermal_torch.viewer import websocket
from nerfstudio_thermal_torch.viewer.client_html import CLIENT_HTML

RESOLUTION_BUCKETS = (256, 512, 1024, 1920)
START_TIMEOUT = 30.0  # seconds for the websocket server to listen


def free_port_pair() -> int:
    """A port p with p and p + 1 free now (the page and the websocket), for
    a viewer started beside other servers."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("", 0))
            p = s.getsockname()[1]
        if p >= 65535:
            continue
        try:
            with socket.socket() as a, socket.socket() as b:
                a.bind(("", p))
                b.bind(("", p + 1))
            return p
        except OSError:
            continue
    raise RuntimeError("no free pair of ports")


class _PageHandler(BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.end_headers()
        self.wfile.write(CLIENT_HTML.encode())

    def log_message(self, *args):
        pass


class ViewerServer:
    """Serves the client page on `port` and websockets on `port + 1`."""

    def __init__(
        self,
        render_fn: Callable[..., np.ndarray],
        output_names,
        port: int = 7007,
        train_lock: Optional[threading.Lock] = None,
        save_dir=None,
        export_fn: Optional[Callable[..., str]] = None,
        train_control: Optional[Callable[[str], dict]] = None,
    ):
        """render_fn(c2w [3,4], width, height, output_name, crop=None,
        fov=60.0) -> image [H,W,C] in [0, 1]; crop is an optional [2,3]
        world AABB, fov the vertical field of view in degrees.
        save_dir: where camera paths are written (default cwd).
        export_fn(kind, crop=None) -> path: a geometry export
        (pointcloud / tsdf).
        train_control(action) -> status dict: the pause / resume / step /
        status hook into a live trainer."""
        self.render_fn = render_fn
        self.output_names = list(output_names)
        self.port = port
        self.train_lock = train_lock or threading.Lock()
        self.save_dir = save_dir
        self.export_fn = export_fn
        self.train_control = train_control
        self._http = None
        self._thread = None
        self._loop = None  # the websocket event loop (for cross-thread broadcast)
        self._stop = None
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._clients = set()
        self._sends = set()  # broadcast tasks, held until done
        self._train_stats: Dict[str, float] = {}
        # last measured render wall time per resolution bucket (ms)
        self.bucket_render_ms: Dict[int, float] = {}

    def start(self):
        """Serve in daemon threads; returns once the websocket listens
        (raises if it could not bind)."""
        self._http = ThreadingHTTPServer(("0.0.0.0", self.port), _PageHandler)
        threading.Thread(target=self._http.serve_forever, daemon=True).start()
        self._thread = threading.Thread(target=self._run_ws, daemon=True)
        self._thread.start()
        if not self._ready.wait(START_TIMEOUT) or self._error is not None:
            self.stop()
            raise RuntimeError(f"viewer websocket on port {self.port + 1} did not start: {self._error}")
        print(f"viewer running at http://localhost:{self.port} (websocket on {self.port + 1})")

    def wait(self) -> None:
        """Block until the websocket server stops."""
        self._thread.join()

    def stop(self) -> None:
        """Close the websocket server and its connections, and the page."""
        if self._loop is not None and self._stop is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop.set)
            except RuntimeError:
                pass  # loop already closed
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(10.0)
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None

    def _run_ws(self):
        try:
            asyncio.run(self._ws_main())
        except BaseException as e:  # noqa: BLE001 — reported by start()
            self._error = e
        finally:
            self._ready.set()

    def update_train_stats(self, stats: Dict[str, float]):
        """Called by the trainer (any thread) at log cadence; pushes a live
        train_stats message to every connected client."""
        self._train_stats = dict(stats)
        if self._loop is None:
            return
        payload = json.dumps({"type": "train_stats", **self._train_stats})

        def _broadcast():
            for ws in list(self._clients):
                task = asyncio.ensure_future(self._safe_send(ws, payload))
                self._sends.add(task)
                task.add_done_callback(self._sends.discard)

        try:
            self._loop.call_soon_threadsafe(_broadcast)
        except RuntimeError:
            pass  # loop shut down

    @staticmethod
    async def _safe_send(ws, payload):
        try:
            await ws.send(payload)
        except Exception:  # noqa: BLE001 — a gone client must not raise
            pass

    async def _ws_main(self):
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()

        async def handler(ws):
            self._clients.add(ws)
            await ws.send(json.dumps({"type": "outputs", "names": self.output_names}))
            if self._train_stats:
                await ws.send(json.dumps({"type": "train_stats", **self._train_stats}))
            # latest-wins camera state consumed by a per-connection
            # progressive render task
            state = {"seq": 0, "cam": None}
            wake = asyncio.Event()
            render_task = asyncio.create_task(self._progressive_loop(ws, state, wake))
            try:
                async for message in ws:
                    try:
                        msg = json.loads(message)
                    except json.JSONDecodeError:
                        continue
                    if msg.get("type") == "camera":
                        state["seq"] += 1
                        state["cam"] = msg
                        wake.set()
                        continue
                    await self._handle_control(ws, msg)
            finally:
                self._clients.discard(ws)
                render_task.cancel()

        server = await websocket.serve(handler, "0.0.0.0", self.port + 1)
        self._ready.set()
        async with server:
            await self._stop.wait()
            for ws in list(self._clients):
                await ws.close(1001, "server stopping")

    async def _handle_control(self, ws, msg):
        if msg.get("type") == "train_control":
            if self.train_control is None:
                await ws.send(json.dumps({"type": "train_state", "error": "no trainer attached"}))
                return
            try:
                status = self.train_control(msg.get("action", "status"))
                await ws.send(json.dumps({"type": "train_state", **status}))
            except Exception as e:  # noqa: BLE001 — keep the ws alive
                await ws.send(json.dumps({"type": "train_state", "error": str(e)}))
            return
        if msg.get("type") == "save_path":
            try:
                path = self.save_camera_path(msg)
                await ws.send(json.dumps({"type": "saved", "path": str(path)}))
            except Exception as e:  # noqa: BLE001
                await ws.send(json.dumps({"type": "saved", "error": str(e)}))
            return
        if msg.get("type") == "export":
            if self.export_fn is None:
                await ws.send(json.dumps({"type": "exported", "error": "no exporter wired"}))
                return
            kind = msg.get("kind", "pointcloud")
            crop = msg.get("crop")
            loop = asyncio.get_running_loop()
            try:
                path = await loop.run_in_executor(None, self._export, kind, crop)
                await ws.send(json.dumps({"type": "exported", "path": str(path)}))
            except Exception as e:  # noqa: BLE001
                await ws.send(json.dumps({"type": "exported", "error": str(e)}))

    async def _progressive_loop(self, ws, state, wake):
        """Consume the latest camera state; render the coarsest bucket first,
        then climb toward the requested bucket while no newer camera message
        arrives. Stale refinements are dropped; a stale coarse frame is still
        sent."""
        loop = asyncio.get_running_loop()
        try:
            await self._progressive_body(ws, state, wake, loop)
        except (websocket.ConnectionClosed, OSError):
            return  # client went away mid-render

    async def _progressive_body(self, ws, state, wake, loop):
        while True:
            await wake.wait()
            wake.clear()
            seq, msg = state["seq"], state["cam"]
            c2w = np.asarray(msg["c2w"], np.float32)
            target = min(RESOLUTION_BUCKETS, key=lambda b: abs(b - int(msg.get("width", 512))))
            aspect = float(msg.get("aspect", 16 / 9))
            output = msg.get("output", "rgb")
            crop = msg.get("crop")  # [[minx,y,z],[maxx,y,z]] or None
            fov = float(msg.get("fov", 60.0))
            # split-screen compare: a second output composited left|right
            split_output = msg.get("output_split") or None
            split_frac = float(msg.get("split_fraction", 0.5))
            colormap = msg.get("colormap") or None
            time_val = msg.get("time")
            ladder = [b for b in RESOLUTION_BUCKETS if b <= target] or [target]
            for width in ladder:
                height = max(int(width / max(aspect, 1e-3)) // 8 * 8, 8)
                t0 = time.perf_counter()
                try:
                    img = await loop.run_in_executor(
                        None, self._render_split, c2w, width, height, output,
                        crop, fov, split_output, split_frac, colormap, time_val,
                    )
                except Exception as e:  # noqa: BLE001 — keep the loop alive
                    await ws.send(json.dumps({"type": "stats", "error": str(e), "width": width, "height": height}))
                    break
                dt = (time.perf_counter() - t0) * 1000
                self.bucket_render_ms[width] = dt
                stale = state["seq"] != seq
                if stale and width != ladder[0]:
                    break  # a fresher coarse frame is about to render
                jpeg = to_jpeg(img)
                await ws.send(json.dumps({
                    "type": "stats", "render_ms": dt, "width": width,
                    "height": height, "seq": seq,
                    "final": width == target,
                    "bucket_render_ms": {str(k): round(v, 1) for k, v in sorted(self.bucket_render_ms.items())},
                }))
                await ws.send(jpeg)
                if stale:
                    break

    def _render(self, c2w, width, height, output, crop=None, fov=60.0, colormap=None, time=None):
        # serialized against training (reference trainer.py:113,239 train_lock)
        with self.train_lock:
            kwargs = {"crop": crop, "fov": fov}
            # optional controls: only forwarded when set, so plain
            # (c2w, w, h, output, crop, fov) render fns keep working
            if colormap is not None:
                kwargs["colormap"] = colormap
            if time is not None:
                kwargs["time"] = time
            return self.render_fn(c2w, width, height, output, **kwargs)

    def _render_split(self, c2w, width, height, output, crop, fov, split_output=None, split_frac=0.5,
                      colormap=None, time=None):
        """Render `output`, and when a second output is selected composite
        the two left|right at `split_frac` with a 2px divider."""
        img = np.asarray(self._render(c2w, width, height, output, crop, fov, colormap, time))
        if not split_output or split_output == output:
            return img
        other = np.asarray(self._render(c2w, width, height, split_output, crop, fov, colormap, time))
        if img.shape[-1] != other.shape[-1]:  # e.g. rgb vs 1-ch depth map
            if img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            if other.shape[-1] == 1:
                other = np.repeat(other, 3, axis=-1)
        col = int(np.clip(split_frac, 0.0, 1.0) * img.shape[1])
        out = np.concatenate([img[:, :col], other[:, col:]], axis=1)
        out[:, max(col - 1, 0):min(col + 1, out.shape[1])] = 1.0
        return out

    def _export(self, kind, crop=None):
        with self.train_lock:
            return self.export_fn(kind, crop=crop)

    def save_camera_path(self, msg: dict):
        """Spline-interpolate the recorded keyframes (Kochanek-Bartels
        position + fov splines, spherical squad orientation spline,
        per-keyframe transition durations, optional loop) into a
        camera_path.json for `ns-render camera-path`."""
        from nerfstudio_thermal_torch.cameras.camera_paths import interpolate_camera_path_spline

        keyframes = [np.asarray(k, np.float32) for k in msg["keyframes"]]
        if not keyframes:
            raise ValueError("no keyframes recorded")
        fps = float(msg.get("fps", 24.0))
        seconds = float(msg.get("seconds", 4.0))
        default_fov = float(msg.get("fov", 60.0))
        fovs = msg.get("fovs")  # per-keyframe overrides (render panel)
        if fovs is None:
            fovs = [default_fov] * len(keyframes)
        width = int(msg.get("width", 1920))
        height = int(msg.get("height", 1080))
        loop = bool(msg.get("loop", False))

        durations = msg.get("durations") or None  # [] -> uniform fallback
        poses, out_fovs = interpolate_camera_path_spline(
            keyframes, fovs=fovs, durations=durations, fps=fps, seconds=seconds, loop=loop,
            tension=float(msg.get("tension", 0.0)),
        )

        def to16(p):
            m = np.eye(4, dtype=np.float32)
            m[:3, :4] = p[:3, :4]
            return m.reshape(-1).tolist()

        payload = {
            "camera_type": "perspective",
            "render_height": height,
            "render_width": width,
            "fps": fps,
            "seconds": seconds,
            "loop": loop,
            "camera_path": [{"camera_to_world": to16(p), "fov": float(f)} for p, f in zip(poses, out_fovs)],
        }
        out_dir = Path(self.save_dir or ".") / "camera_paths"
        out_dir.mkdir(parents=True, exist_ok=True)
        dest = out_dir / f"viewer_path_{int(time.time())}.json"
        dest.write_text(json.dumps(payload, indent=2))
        print(f"viewer: wrote camera path {dest} ({len(poses)} frames)")
        return dest


def to_jpeg(img: np.ndarray) -> bytes:
    """An image in [0, 1] as the JPEG the viewer streams: truncated to
    uint8, 1 channel repeated to 3 (encode_jpeg), quality 85."""
    return encode_jpeg((np.clip(img, 0, 1) * 255).astype(np.uint8), quality=85)


def _synthetic_camera():
    """A 16x16 perspective camera at (2, 0, 0), for probing a model that
    has no cameras of its own."""
    from nerfstudio_thermal_torch.cameras.cameras import Cameras, CameraType

    c2w = np.eye(4, dtype=np.float32)[:3][None]
    c2w[:, 0, 3] = 2.0
    return Cameras(
        camera_to_worlds=torch.as_tensor(c2w),
        fx=torch.tensor([16.0]), fy=torch.tensor([16.0]),
        cx=torch.tensor([8.0]), cy=torch.tensor([8.0]),
        width=torch.tensor([16], dtype=torch.int32),
        height=torch.tensor([16], dtype=torch.int32),
        camera_type=torch.tensor([CameraType.PERSPECTIVE.value], dtype=torch.int32),
    )


def probe_output_names(model, cameras=None) -> list:
    """The model's displayable render outputs, found by rendering one tiny
    image ([h, w, 1 | 3 | 4] outputs but the proposal networks'), "rgb"
    first; ["rgb"] when probing fails."""
    try:
        if cameras is None or len(cameras) == 0:
            cameras = _synthetic_camera()  # also for an empty eval split
        out = model.get_outputs_for_camera(cameras, 0, width=16, height=16)
        names = [
            k for k, v in out.items()
            if np.asarray(v).ndim == 3 and np.asarray(v).shape[-1] in (1, 3, 4) and not k.startswith("prop_")
        ]
        names.sort(key=lambda k: (k != "rgb", k))
        return names or ["rgb"]
    except Exception as e:  # noqa: BLE001
        print(f"viewer: output probe failed ({e}); defaulting to rgb")
        return ["rgb"]


def make_model_export_fn(model, cameras, out_dir):
    """The viewer's export tab: a point cloud or a TSDF mesh of the model's
    current parameters, written under out_dir/exports; returns the path."""

    @torch.inference_mode()
    def export(kind: str, crop=None):
        dest = Path(out_dir) / "exports"
        dest.mkdir(parents=True, exist_ok=True)
        stamp = int(time.time())
        if kind == "pointcloud":
            from nerfstudio_thermal_torch.exporter.exporter_utils import generate_point_cloud, write_ply

            pts, cols = generate_point_cloud(model, cameras, num_cameras=4, stride=4)[:2]
            if crop is not None:
                box = np.asarray(crop, np.float32).reshape(2, 3)
                keep = np.all((pts >= box[0]) & (pts <= box[1]), axis=-1)
                pts, cols = pts[keep], cols[keep]
            path = dest / f"point_cloud_{stamp}.ply"
            write_ply(path, pts, cols)
            return path
        if kind == "tsdf":
            from nerfstudio_thermal_torch.exporter.tsdf_utils import export_tsdf_mesh

            kw = {}
            if crop is not None:
                box = np.asarray(crop, np.float32).reshape(2, 3)
                kw = dict(bounding_box_min=tuple(box[0]), bounding_box_max=tuple(box[1]))
            return export_tsdf_mesh(model, cameras, dest, resolution=64, filename=f"tsdf_mesh_{stamp}.ply", **kw)
        raise ValueError(f"unknown export kind '{kind}' (pointcloud|tsdf)")

    return export


def make_model_render_fn(model, fov_degrees: float = 60.0):
    """Bridge a model to the viewer: one camera per request, rendered on
    the model's device by `render_camera_device`; only the displayed
    output (and the accumulation a depth colormap needs) is copied to the
    host."""
    from nerfstudio_thermal_torch.cameras.cameras import Cameras, CameraType
    from nerfstudio_thermal_torch.utils import colormaps

    @torch.inference_mode()
    def render(c2w, width, height, output, crop=None, fov=None, colormap=None, time=None):
        focal = height / (2 * np.tan(np.radians(fov or fov_degrees) / 2))
        cameras = Cameras(
            camera_to_worlds=torch.as_tensor(np.asarray(c2w, np.float32))[None],
            fx=torch.tensor([focal], dtype=torch.float32),
            fy=torch.tensor([focal], dtype=torch.float32),
            cx=torch.tensor([width / 2], dtype=torch.float32),
            cy=torch.tensor([height / 2], dtype=torch.float32),
            width=torch.tensor([width], dtype=torch.int32),
            height=torch.tensor([height], dtype=torch.int32),
            camera_type=torch.tensor([CameraType.PERSPECTIVE.value], dtype=torch.int32),
            # time-conditioned scenes: the viewer's time slider renders at t in [0, 1]
            times=None if time is None else torch.tensor([float(np.clip(time, 0.0, 1.0))], dtype=torch.float32),
        )
        dev = model.render_camera_device(cameras, 0, width=width, height=height, crop_aabb=crop)
        key = output if output in dev else "rgb"

        def fetch(v):
            # ray models return flat [h*w, C]; splat / generative models
            # [h, w, C] images at their own resolution: kept as they are
            a = v.float().cpu().numpy()
            return a if a.ndim == 3 else a.reshape(height, width, -1)

        img = fetch(dev[key])
        opts = colormaps.ColormapOptions()
        if colormap:
            opts = colormaps.ColormapOptions(
                colormap=str(colormap.get("name", "default")),
                normalize=bool(colormap.get("normalize", False)),
                colormap_min=float(colormap.get("min", 0.0)),
                colormap_max=float(colormap.get("max", 1.0)),
                invert=bool(colormap.get("invert", False)),
            )
        # the colormap keys off the resolved output: a requested
        # 'depth_thermal' that fell back to 'rgb' is not depth-colormapped
        if "depth" in key:
            suffix = "_thermal" if key.endswith("_thermal") else ""
            acc = dev.get(f"accumulation{suffix}")
            img = colormaps.apply_depth_colormap(
                img, accumulation=None if acc is None else fetch(acc), colormap_options=opts
            )
        elif img.ndim == 3 and img.shape[-1] == 1:
            try:
                img = colormaps.apply_colormap(np.asarray(img, np.float32), opts)
            except Exception:  # noqa: BLE001 — unknown map name: raw image
                pass
        return img

    return render
