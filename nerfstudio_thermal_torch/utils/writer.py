"""Event and metric writers (counterpart of nerfstudio_thermal_tpu/utils/writer.py).

A console line every `steps_per_log` steps, a JSONL event log under the
run's directory with the reference's metric names, and eval images as
`images/<name>/step-<N>.png`. The PNGs are written with the standard
library (`write_png`), since the card's machine has no Pillow. TensorBoard,
W&B and Comet raise: those writers are ROADMAP A9.
"""

import json
import time
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class EventName:
    ITER_TRAIN_TIME = "Train Iter (time)"
    TRAIN_RAYS_PER_SEC = "Train Rays / Sec"
    ETA = "ETA (time)"


def write_png(path: Path, img: np.ndarray) -> None:
    """uint8 [H, W, 1 or 3] as an 8-bit grey or RGB PNG."""
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(img).reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return len(body).to_bytes(4, "big") + kind + body + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big")

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, {1: 0, 3: 2}[c], 0, 0, 0])
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b"")
    )


class Writer:
    """Console + JSONL metric writer."""

    def __init__(
        self,
        log_dir: Optional[Path] = None,
        steps_per_log: int = 10,
        use_tensorboard: bool = False,
        use_wandb: bool = False,
        use_comet: bool = False,
        experiment_name: str = "experiment",
    ):
        if use_tensorboard or use_wandb or use_comet:
            raise NotImplementedError(
                "the TensorBoard, W&B and Comet writers are not ported yet (ROADMAP A9)"
            )
        self.log_dir = Path(log_dir) if log_dir else None
        self.steps_per_log = steps_per_log
        self._jsonl = None
        if self.log_dir is not None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.log_dir / "events.jsonl", "a")

    def write_scalar_dict(self, scalars: Dict[str, float], step: int, group: str = ""):
        record = {"step": step, "time": time.time()}
        prefix = f"{group}/" if group else ""
        for k, v in scalars.items():
            record[f"{prefix}{k}"] = float(v)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def write_image(self, name: str, image, step: int):
        """An eval image (HxW, HxWx1 or HxWx3; float in [0, 1] or uint8) as
        `log_dir/images/<name with / as _>/step-<N>.png`, grey repeated to RGB."""
        if self.log_dir is None:
            return
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        out_dir = self.log_dir / "images" / name.replace("/", "_")
        out_dir.mkdir(parents=True, exist_ok=True)
        write_png(out_dir / f"step-{step:09d}.png", img)

    def console_log(self, step: int, scalars: Dict[str, float]):
        if step % self.steps_per_log != 0:
            return
        parts = [f"step {step}"] + [f"{k}={v:.5g}" for k, v in scalars.items()]
        print("  ".join(parts), flush=True)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
