"""ns-benchmark (scripts/benchmarking.py) of the port against the JAX
package's, on the CPU.

- With ns-train and ns-eval replaced in both packages by recorders that
  write a run directory and a fixed metrics JSON: the same ns-train argv
  per scene (the port's ends with the `blender-data` dataparser
  subcommand, which the JAX script lacks, see below), the same ns-eval
  argv, and the same benchmark.json (timestamp aside), error entries for a
  failed ns-train or ns-eval included; the same usage, flag errors and
  return codes.
- One real run of the port alone (`device="cpu"`): a tiny nerfacto, 2
  iterations, one 2-frame 32 x 32 Blender scene (ns-eval scores LPIPS,
  whose VGG needs more than 16 pixels a side). It returns 0, benchmark.json
  holds ns-eval's results for the scene and a finite mean PSNR, and the run
  trained with the Blender parser and the benchmark overrides. No JAX
  trainer is built: the port's step is held to JAX's by
  tests/test_torch_nerfacto_family.py.

The JAX script passes no dataparser, so its nerfacto reads the scene with
the Nerfstudio parser, which looks for a transforms.json that a Blender
scene does not have; the reference's launch_train_blender.sh ends ns-train
with `blender-data`, and so does the port's script.
"""

import json
import math
import time
from pathlib import Path

import pytest
import torch

from nerfstudio_thermal_tpu.scripts import benchmarking as jax_bench
from nerfstudio_thermal_tpu.scripts import eval as jax_eval
from nerfstudio_thermal_tpu.scripts import train as jax_train

from nerfstudio_thermal_torch.configs.serialization import load_config
from nerfstudio_thermal_torch.scripts import benchmarking
from nerfstudio_thermal_torch.scripts import eval as port_eval
from nerfstudio_thermal_torch.scripts import train as port_train
from tests.torch_benchmark_scene import patched_method_config, write_blender_scene

torch.set_num_threads(1)

METRICS = {"psnr_rgb": 21.5, "psnr_rgb_std": 0.5, "ssim_rgb": 0.75, "fps": 3.0}


def _recorders(calls: list, train_rc: dict, eval_rc: dict):
    """ns-train / ns-eval stand-ins: record argv, write config.yml under
    the run directory (train) or the metrics JSON (eval)."""

    def train(argv, **kw):
        calls.append(("train", list(argv), kw))
        flags = dict(zip(argv[1::2], argv[2::2]))
        scene = flags["--experiment-name"]
        run = Path(flags["--output-dir"]) / scene / argv[0] / "run"
        run.mkdir(parents=True)
        (run / "config.yml").write_text("x: 1\n")
        return train_rc.get(scene, 0)

    def evaluate(argv, **kw):
        calls.append(("eval", list(argv), kw))
        out = Path(argv[argv.index("--output-path") + 1])
        scene = out.name.split("_metrics")[0]
        out.write_text(json.dumps({"results": {**METRICS, "psnr_rgb": METRICS["psnr_rgb"] + len(scene)}}))
        return eval_rc.get(scene, 0)

    return train, evaluate


CASES = {
    "nerfacto": ("nerfacto", {}, {}),
    "thermal-nerfacto-tpu": ("thermal-nerfacto-tpu", {}, {}),
    "vanilla-nerf": ("vanilla-nerf", {}, {}),
    "train_fails": ("nerfacto", {"chair": 1}, {}),
    "eval_fails": ("nerfacto", {}, {"lego": 3}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_benchmark_matches_jax(tmp_path, monkeypatch, case):
    method, train_rc, eval_rc = CASES[case]
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "2026-01-01_000000")
    data = tmp_path / "blender"
    for scene in ("chair", "lego", "ship"):
        (data / scene).mkdir(parents=True)
    calls, summaries = {}, {}
    for name, module, train_mod, eval_mod in (("port", benchmarking, port_train, port_eval),
                                              ("jax", jax_bench, jax_train, jax_eval)):
        calls[name] = []
        train, evaluate = _recorders(calls[name], train_rc, eval_rc)
        monkeypatch.setattr(train_mod, "main", train)
        monkeypatch.setattr(eval_mod, "main", evaluate)
        out = tmp_path / name
        argv = ["--method", method, "--data-dir", str(data), "--scenes", "lego,chair,ship", "--output-dir", str(out),
                "--", "--max-num-iterations", "7"]
        kw = {"device": "cpu"} if name == "port" else {}
        assert module.main(argv, **kw) == 0
        summaries[name] = json.loads((out / "2026-01-01_000000" / "benchmark.json").read_text())
    assert summaries["port"] == summaries["jax"]
    assert ("error" in summaries["port"]["scenes"]["chair"]) == ("chair" in train_rc)
    assert ("error" in summaries["port"]["scenes"]["lego"]) == ("lego" in eval_rc)
    assert len(calls["port"]) == len(calls["jax"]) == 6 - len(train_rc)
    for (kind, got, kw), (jkind, want, _) in zip(calls["port"], calls["jax"]):
        assert kind == jkind and kw == {"device": "cpu"}
        want = [a.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for a in want]
        assert got == (want + ["blender-data"] if kind == "train" else want)
        if kind == "train" and "nerfacto" in method:
            assert "--pipeline.model.camera-optimizer.mode" in got


def test_benchmark_usage_and_errors_match_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for argv, rc in ((["--help"], 0), (["--bogus"], 2), (["--data-dir", str(tmp_path / "none")], 1)):
        assert benchmarking.main(argv, device="cpu") == jax_bench.main(argv) == rc
    out = capsys.readouterr()
    assert out.out.count("usage: ns-benchmark") == 2
    assert out.err.count("error: unknown flag --bogus") == out.err.count("error: no blender scenes") == 2
    assert not (tmp_path / "benchmarks").exists()  # nothing is written before a scene trains


def test_benchmark_trains_and_scores_nerfacto_on_cpu(tmp_path):
    write_blender_scene(tmp_path / "blender" / "lego")
    out = tmp_path / "out"
    with patched_method_config():
        rc = benchmarking.main(["--method", "nerfacto", "--data-dir", str(tmp_path / "blender"), "--scenes", "lego",
                                "--output-dir", str(out), "--", "--max-num-iterations", "2"], device="cpu")
    assert rc == 0
    (summary_path,) = out.glob("*/benchmark.json")
    summary = json.loads(summary_path.read_text())
    metrics = json.loads((summary_path.parent / "lego_metrics.json").read_text())
    assert summary["method"] == "nerfacto" and summary["scenes"] == {"lego": metrics["results"]}
    assert math.isfinite(summary["mean_psnr"]) and summary["mean_psnr"] == metrics["results"]["psnr_rgb"]
    (config_path,) = summary_path.parent.glob("lego/nerfacto/*/config.yml")
    config = load_config(config_path)
    assert type(config.dataparser).__name__ == "BlenderDataParserConfig"
    m = config.model
    assert (m.background_color, m.proposal_initial_sampler, m.near_plane, m.far_plane, m.camera_optimizer.mode,
            m.use_average_appearance_embedding, m.distortion_loss_mult, m.disable_scene_contraction) == (
        "white", "uniform", 2.0, 6.0, "off", False, 0.0, True)
    assert config.trainer.max_num_iterations == 2
    records = [json.loads(line) for line in (config_path.parent / "events.jsonl").read_text().splitlines()]
    train_losses = [v for r in records for k, v in r.items() if k.startswith("train/") and k.endswith("loss")]
    assert train_losses and all(math.isfinite(v) for v in train_losses)
