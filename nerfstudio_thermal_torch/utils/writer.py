"""Event and metric writers, the console part
(counterpart of nerfstudio_thermal_tpu/utils/writer.py).

A console line every `steps_per_log` steps and a JSONL event log under the
run's directory, with the reference's metric names. TensorBoard, W&B,
Comet and image writing wait for the eval-surface slice and raise.
"""

import json
import time
from pathlib import Path
from typing import Dict, Optional


class EventName:
    ITER_TRAIN_TIME = "Train Iter (time)"
    TRAIN_RAYS_PER_SEC = "Train Rays / Sec"
    ETA = "ETA (time)"


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
                "TensorBoard, W&B and Comet writers arrive with the eval-surface slice of the port"
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

    def console_log(self, step: int, scalars: Dict[str, float]):
        if step % self.steps_per_log != 0:
            return
        parts = [f"step {step}"] + [f"{k}={v:.5g}" for k, v in scalars.items()]
        print("  ".join(parts), flush=True)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
