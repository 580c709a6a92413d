"""The trainer's profilers (counterpart of the JAX package's
utils/profiler.py and its trainer hook), on the CPU: "basic" records the
host time of the loop's spans and prints their table; "xla" (the JAX
config's name) writes a torch.profiler Chrome trace of steps 10-15 under
the run's profiler_traces/."""

import json

import pytest
import torch

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.utils import profiler
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_render import tiny

torch.set_num_threads(1)


@pytest.fixture
def clean_profiler(monkeypatch):
    """Leave the process's profiler as it was: off, no records."""
    monkeypatch.setattr(profiler, "PROFILER_ENABLED", False)
    yield
    profiler._records.clear()


def _trainer(tmp_path, mode, steps):
    method = get_method_config("thermal-nerfacto-tpu")
    tiny(method.model, "float32")
    method.data = make_synthetic_rgbt_dataset(tmp_path / "scene", num_pairs=4)
    method.datamanager.train_num_rays_per_batch = 16
    method.datamanager.use_native_sampler = False
    method.trainer.max_num_iterations = steps
    method.trainer.profiler = mode
    trainer = setup_trainer(method, base_dir=tmp_path / "run", device="cpu")
    trainer.setup()
    return trainer


def test_basic_profiler_prints_its_table(tmp_path, capsys, clean_profiler):
    trainer = _trainer(tmp_path, "basic", 3)
    assert profiler.PROFILER_ENABLED
    trainer.train()
    capsys.readouterr()
    profiler.flush_profiler()
    out = capsys.readouterr().out
    assert "Profiler results (avg duration):" in out
    rows = {line.split()[0]: line.split()[-1] for line in out.splitlines()[2:]}
    assert rows["Trainer.train_iteration"] == "x3"
    assert rows["Trainer.save_checkpoint"] == "x1"


def test_time_function_forms(clean_profiler):
    profiler.setup_profiler(True)

    @profiler.time_function
    def timed(x):
        return x + 1

    @profiler.time_function("named")
    def named(x):
        with profiler.time_function("inner"):
            return timed(x) * 2

    assert named(1) == 4 and timed(2) == 3
    assert {k: v[1] for k, v in profiler._records.items()} == {
        "named": 1, "inner": 1, "test_time_function_forms.<locals>.timed": 2,
    }
    profiler.setup_profiler(False)
    timed(0)
    assert profiler._records["test_time_function_forms.<locals>.timed"][1] == 2


def test_xla_profiler_writes_a_trace(tmp_path, clean_profiler):
    trainer = _trainer(tmp_path, "xla", 16)
    trainer.train()
    trace = tmp_path / "run" / "profiler_traces" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(name.startswith("aten::") for name in names)
    assert not profiler.PROFILER_ENABLED  # "xla" leaves the host timer off


def test_unknown_profiler_raises(tmp_path):
    with pytest.raises(ValueError, match="profiler="):
        _trainer(tmp_path, "pytorch", 1)
