"""The port's plugin registry, colours and misc helpers against the JAX
package's, on the CPU.

- `plugins/registry.discover_methods` reads the same entry-point group and
  $NERFSTUDIO_METHOD_CONFIGS: a "name=module:callable" entry reaches
  `get_method_config`, `method_names` and ns-train's --help; an entry that
  fails to load is reported and skipped, as in JAX; an entry that is not
  one of the port's MethodConfig raises TypeError when it is asked for.
- `utils/colors.py` and `utils/misc.py` are copies: the same constants and
  results, and the same errors.
"""

import numpy as np
import pytest

from nerfstudio_thermal_tpu.plugins import registry as jax_registry
from nerfstudio_thermal_tpu.utils import colors as jax_colors
from nerfstudio_thermal_tpu.utils import misc as jax_misc

from nerfstudio_thermal_torch.configs import method_configs
from nerfstudio_thermal_torch.plugins import registry
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils import colors, misc


def plugin_method():
    """A plugin's factory: a renamed thermal-nerfacto-tpu config."""
    cfg = method_configs.get_method_config("thermal-nerfacto-tpu")
    cfg.method_name = "my-plugin"
    cfg.description = "A plugin method."
    return cfg


def not_a_config():
    return {"method_name": "odd"}


@pytest.fixture
def fresh_registry(monkeypatch):
    monkeypatch.setattr(registry, "_discovered", False)
    monkeypatch.setattr(method_configs, "_PLUGINS", {})
    monkeypatch.setattr(jax_registry, "_discovered", False)
    return monkeypatch


def test_env_var_plugins_are_discovered(fresh_registry, capsys):
    assert registry.ENTRYPOINT_GROUP == jax_registry.ENTRYPOINT_GROUP == "nerfstudio.method_configs"
    assert registry.ENV_VAR == jax_registry.ENV_VAR == "NERFSTUDIO_METHOD_CONFIGS"
    fresh_registry.setenv(registry.ENV_VAR, f"my-plugin={__name__}:plugin_method, odd={__name__}:not_a_config, "
                                            "broken=no_such_module:make")
    cfg = method_configs.get_method_config("my-plugin")
    assert cfg.method_name == "my-plugin" and cfg is not method_configs._PLUGINS["my-plugin"]
    assert method_configs.method_names()["my-plugin"] == "A plugin method."
    assert "broken" not in method_configs._PLUGINS
    assert "failed to load method from NERFSTUDIO_METHOD_CONFIGS (broken=no_such_module:make)" in capsys.readouterr().err
    with pytest.raises(TypeError, match="not a MethodConfig"):
        method_configs.get_method_config("odd")
    with pytest.raises(KeyError, match="unknown method 'missing'"):
        method_configs.get_method_config("missing")
    # the JAX package's registry takes the same entries
    jax_found = {}
    jax_registry.discover_methods(jax_found)
    assert sorted(jax_found) == sorted(method_configs._PLUGINS) == ["my-plugin", "odd"]
    capsys.readouterr()
    assert ns_train.main(["--help"]) == 0
    assert f"  {'my-plugin':24s} A plugin method." in capsys.readouterr().out


def test_discovery_runs_once(fresh_registry):
    found = {}
    registry.discover_methods(found)
    fresh_registry.setenv(registry.ENV_VAR, f"late={__name__}:plugin_method")
    registry.discover_methods(found)
    assert "late" not in found


def test_colors_match_jax():
    for name in ("WHITE", "BLACK", "RED", "GREEN", "BLUE", "WHITE_RGBT", "BLACK_RGBT", "RED_RGBT", "GREEN_RGBT",
                 "BLUE_RGBT"):
        np.testing.assert_array_equal(getattr(colors, name), getattr(jax_colors, name))
        assert getattr(colors, name).dtype == np.float32
    assert sorted(colors.COLORS_DICT) == sorted(jax_colors.COLORS_DICT)
    assert sorted(colors.COLORS_RGBT_DICT) == sorted(jax_colors.COLORS_RGBT_DICT)
    for c in ("white", "Red", [0.1, 0.2, 0.3], (1, 0, 0)):
        np.testing.assert_array_equal(colors.get_color(c), jax_colors.get_color(c))
    for bad in ("purple", [1, 2], 3):
        with pytest.raises(ValueError):
            colors.get_color(bad)
        with pytest.raises(ValueError):
            jax_colors.get_color(bad)


def test_misc_matches_jax():
    for args in ((0, 10), (0, 10, True), (20, 10), (21, 10), (5, 0)):
        assert misc.step_check(*args) == jax_misc.step_check(*args)
    d = {"a": 2.0, "b": 3.0}
    assert misc.scale_dict(dict(d), {"a": 0.5}) == jax_misc.scale_dict(dict(d), {"a": 0.5}) == {"a": 1.0, "b": 3.0}
    for n in (0, 999, 1234, 1234567, -5.5e9, 1e21):
        assert misc.human_format(n) == jax_misc.human_format(n)
