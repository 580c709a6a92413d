"""The port's event writer (utils/writer.py) against the JAX package's,
which imports no JAX, on the CPU.

W&B and Comet are faked in sys.modules (neither is installed here, nor
known to be on the card's machine): on the same scalars and images both
writers make the same calls in the same order. Without the packages both
print the same "unavailable (...); skipping" lines and write on. With
TensorBoard (installed here) the port's event file reads back the
scalars of its events.jsonl, and the JAX writer's file the same tags,
steps and values, and both hold the eval image.
"""

import json
import struct
import sys
import types

import numpy as np

from nerfstudio_thermal_tpu.utils import writer as jax_writer
from nerfstudio_thermal_torch.utils import writer

SCALARS = [({"loss": 0.25, "psnr": np.float32(12.5), "Train Rays / Sec": 4096.0}, 0, "train"),
           ({"loss": 0.125, "psnr": 13.0}, 1, "train"), ({"psnr": 11.75}, 1, "eval")]


def images():
    rng = np.random.default_rng(0)
    return [("eval/img", rng.uniform(size=(6, 5, 3)).astype(np.float32)),
            ("eval/depth", rng.uniform(size=(6, 5, 1)).astype(np.float32)),
            ("eval/mask", rng.integers(0, 255, (6, 5), dtype=np.uint8))]


def fake_backends(calls: list):
    """wandb and comet_ml modules that record every call."""

    def plain(x):
        return x.tolist() if isinstance(x, np.ndarray) else x

    class Run:
        def log(self, data, step=None):
            calls.append(("wandb.log", {k: plain(v) for k, v in data.items()}, step))

    class Experiment:
        def __init__(self, **kwargs):
            calls.append(("comet.Experiment", kwargs))

        def log_metrics(self, data, step=None):
            calls.append(("comet.log_metrics", dict(data), step))

        def log_image(self, img, name=None, step=None):
            calls.append(("comet.log_image", img.tolist(), name, step))

    def init(**kwargs):
        calls.append(("wandb.init", {k: v for k, v in kwargs.items() if k != "dir"}, kwargs["dir"] is not None))
        return Run()

    wandb = types.ModuleType("wandb")
    wandb.init, wandb.Image = init, lambda img: ("Image", img.tolist())
    comet = types.ModuleType("comet_ml")
    comet.Experiment = Experiment
    return wandb, comet


def drive(cls, log_dir, **kwargs):
    w = cls(log_dir, steps_per_log=1, experiment_name="exp", **kwargs)
    for scalars, step, group in SCALARS:
        w.write_scalar_dict(scalars, step, group=group)
    for name, img in images():
        w.write_image(name, img, 2)
    w.close()
    return w


def test_wandb_and_comet_calls_match_jax(tmp_path, monkeypatch):
    calls = {}
    for label, cls in (("jax", jax_writer.Writer), ("port", writer.Writer)):
        calls[label] = []
        wandb, comet = fake_backends(calls[label])
        monkeypatch.setitem(sys.modules, "wandb", wandb)
        monkeypatch.setitem(sys.modules, "comet_ml", comet)
        drive(cls, tmp_path / label, use_wandb=True, use_comet=True)
    assert calls["port"] == calls["jax"]
    kinds = [c[0] for c in calls["port"]]
    assert kinds[:2] == ["wandb.init", "comet.Experiment"]
    assert kinds.count("wandb.log") == len(SCALARS) + len(images())
    assert kinds.count("comet.log_image") == len(images())
    assert calls["port"][0][1] == {"project": "nerfstudio-thermal-tpu", "name": "exp"}
    # the PNGs and the JSONL log are written besides
    assert sorted(p.name for p in (tmp_path / "port" / "images").iterdir()) == ["eval_depth", "eval_img", "eval_mask"]
    assert len((tmp_path / "port" / "events.jsonl").read_text().splitlines()) == len(SCALARS)


def test_missing_backends_are_skipped_as_in_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises
    monkeypatch.setitem(sys.modules, "comet_ml", None)
    out = {}
    for label, cls in (("jax", jax_writer.Writer), ("port", writer.Writer)):
        drive(cls, tmp_path / label, use_wandb=True, use_comet=True)
        out[label] = capsys.readouterr().out.splitlines()
    assert out["port"] == out["jax"]
    assert [line.split(" (")[0] for line in out["port"]] == ["wandb unavailable", "comet unavailable"]
    assert all(line.endswith("; skipping") for line in out["port"])
    assert (tmp_path / "port" / "events.jsonl").exists()


def read_events(run_dir):
    """(tag, step, value) of every scalar and the image tags of a
    TensorBoard event file (TFRecord framing: length, its CRC, the Event
    proto, its CRC)."""
    from tensorboard.compat.proto import event_pb2

    (path,) = run_dir.glob("events.out.tfevents.*")
    data, pos, scalars, image_tags = path.read_bytes(), 0, [], []
    while pos < len(data):
        (n,) = struct.unpack("<Q", data[pos:pos + 8])
        event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
        pos += 12 + n + 4
        for v in event.summary.value:
            if v.HasField("image"):
                image_tags.append(v.tag)
            else:
                scalars.append((v.tag, event.step, v.simple_value))
    return scalars, image_tags


def test_tensorboard_reads_back_the_jsonl_scalars(tmp_path):
    for label, cls in (("jax", jax_writer.Writer), ("port", writer.Writer)):
        drive(cls, tmp_path / label, use_tensorboard=True)
    got, got_images = read_events(tmp_path / "port")
    want = [(k, r["step"], v) for r in map(json.loads, (tmp_path / "port" / "events.jsonl").read_text().splitlines())
            for k, v in r.items() if k not in ("step", "time")]
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    np.testing.assert_allclose([v for *_, v in got], [v for *_, v in want], rtol=1e-7)
    assert got_images == [name for name, _ in images()]
    assert read_events(tmp_path / "jax") == (got, got_images)
