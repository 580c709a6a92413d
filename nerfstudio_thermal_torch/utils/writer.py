"""Event and metric writers (counterpart of nerfstudio_thermal_tpu/utils/writer.py).

A console line every `steps_per_log` steps, a JSONL event log under the
run's directory with the reference's metric names, and eval images as
`images/<name>/step-<N>.png`. The PNGs are written with the standard
library (`write_png`), since the card's machine has no Pillow. As in the
JAX package, `use_tensorboard` also writes scalars and images to a
TensorBoard event file in the run's directory (`torch.utils.tensorboard`;
dropped silently when it cannot be made), and `use_wandb` / `use_comet`
log them to a W&B run or a Comet experiment of the project
"nerfstudio-thermal-tpu" (a printed "... unavailable (...); skipping"
when the package or its login is missing). Each of those packages is
imported only when asked for. The trainer opens them on the main rank
only.
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
    TEST_RAYS_PER_SEC = "Test Rays / Sec"
    ETA = "ETA (time)"
    CURR_TEST_PSNR = "Eval PSNR"


def write_png(path: Path, img: np.ndarray) -> None:
    """uint8 [H, W, 1 or 3] as an 8-bit grey or RGB PNG; uint16 [H, W, 1]
    as a 16-bit grey one (a depth map in millimetres)."""
    h, w, c = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    if depth == 16 and c != 1:
        raise ValueError("16-bit PNGs are written grey only")
    data = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8).reshape(h, -1)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), data], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return len(body).to_bytes(4, "big") + kind + body + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big")

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([depth, {1: 0, 3: 2}[c], 0, 0, 0])
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b"")
    )


class Writer:
    """Console + JSONL (+ TensorBoard, W&B, Comet on request) metric writer."""

    def __init__(
        self,
        log_dir: Optional[Path] = None,
        steps_per_log: int = 10,
        use_tensorboard: bool = False,
        use_wandb: bool = False,
        use_comet: bool = False,
        experiment_name: str = "experiment",
    ):
        self.log_dir = Path(log_dir) if log_dir else None
        self.steps_per_log = steps_per_log
        self._jsonl = None
        self._tb = None
        self._wandb = None
        self._comet = None
        if self.log_dir is not None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.log_dir / "events.jsonl", "a")
            if use_tensorboard:
                try:
                    # the tensorboard package; not known to be on the card's machine
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(log_dir=str(self.log_dir))
                except Exception:
                    self._tb = None
        if use_wandb:
            try:
                import wandb  # not known to be on the card's machine

                self._wandb = wandb.init(
                    project="nerfstudio-thermal-tpu", name=experiment_name,
                    dir=str(self.log_dir) if self.log_dir else None,
                )
            except Exception as e:
                print(f"wandb unavailable ({e}); skipping")
        if use_comet:
            try:
                import comet_ml  # not known to be on the card's machine

                self._comet = comet_ml.Experiment(project_name="nerfstudio-thermal-tpu")
            except Exception as e:
                print(f"comet unavailable ({e}); skipping")

    def write_scalar_dict(self, scalars: Dict[str, float], step: int, group: str = ""):
        record = {"step": step, "time": time.time()}
        prefix = f"{group}/" if group else ""
        for k, v in scalars.items():
            record[f"{prefix}{k}"] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(f"{prefix}{k}", float(v), step)
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "time"}, step=step)
        if self._comet is not None:
            self._comet.log_metrics({k: v for k, v in record.items() if k not in ("time", "step")}, step=step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def write_image(self, name: str, image, step: int):
        """An eval image (HxW, HxWx1 or HxWx3; float in [0, 1] or uint8) as
        `log_dir/images/<name with / as _>/step-<N>.png`, grey repeated to
        RGB, and to TensorBoard / W&B / Comet where they are open (a
        failing backend call is skipped, as in the JAX package)."""
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if self.log_dir is not None:
            out_dir = self.log_dir / "images" / name.replace("/", "_")
            out_dir.mkdir(parents=True, exist_ok=True)
            write_png(out_dir / f"step-{step:09d}.png", img)
        if self._tb is not None:
            try:
                self._tb.add_image(name, img, step, dataformats="HWC")
            except Exception:
                pass
        if self._wandb is not None:
            try:
                import wandb

                self._wandb.log({name: wandb.Image(img)}, step=step)
            except Exception:
                pass
        if self._comet is not None:
            try:
                self._comet.log_image(img, name=name, step=step)
            except Exception:
                pass

    def console_log(self, step: int, scalars: Dict[str, float]):
        if step % self.steps_per_log != 0:
            return
        parts = [f"step {step}"] + [f"{k}={v:.5g}" for k, v in scalars.items()]
        print("  ".join(parts), flush=True)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
