"""Third-party method discovery
(counterpart of nerfstudio_thermal_tpu/plugins/registry.py).

Methods register through the entry-point group `nerfstudio.method_configs`
(the reference's name, reference `nerfstudio/plugins/registry.py:34-81`)
or the environment variable `NERFSTUDIO_METHOD_CONFIGS`
("name=module:callable", comma-separated). An entry is a MethodConfig, or
a callable that returns one; `configs/method_configs.get_method_config`
accepts only this package's MethodConfig. A plugin that fails to load is
reported and skipped: it must not break the CLI.
"""

import importlib
import os
import sys
from typing import Dict

ENTRYPOINT_GROUP = "nerfstudio.method_configs"
ENV_VAR = "NERFSTUDIO_METHOD_CONFIGS"

_discovered = False


def discover_methods(registry: Dict) -> None:
    """Add every plugin method to `registry` (name -> config), once per
    process."""
    global _discovered
    if _discovered:
        return
    _discovered = True

    try:
        from importlib.metadata import entry_points

        eps = entry_points()
        group = eps.select(group=ENTRYPOINT_GROUP) if hasattr(eps, "select") else eps.get(ENTRYPOINT_GROUP, [])
        for ep in group:
            try:
                cfg = ep.load()
                registry[ep.name] = cfg() if callable(cfg) else cfg
            except Exception as e:  # plugin failures must not break the CLI
                print(f"warning: failed to load method plugin {ep.name}: {e}", file=sys.stderr)
    except Exception:
        pass

    spec = os.environ.get(ENV_VAR, "")
    for item in filter(None, (s.strip() for s in spec.split(","))):
        try:
            name, target = item.split("=", 1)
            module, attr = target.split(":", 1)
            obj = getattr(importlib.import_module(module), attr)
            registry[name] = obj() if callable(obj) else obj
        except Exception as e:
            print(f"warning: failed to load method from {ENV_VAR} ({item}): {e}", file=sys.stderr)
