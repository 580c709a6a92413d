"""Dataclass-tree CLI: flags like `--pipeline.model.density-mode separate`
(the port's copy of nerfstudio_thermal_tpu/configs/cli.py).

A small parser over nested dataclasses in place of the reference's tyro
(reference scripts/train.py:258-267). Reference-style paths with a
`pipeline.` prefix are aliased onto the flatter MethodConfig layout, so
the public flag surface matches (`--pipeline.model.X` == `--model.X`,
`--pipeline.datamanager.X` == `--datamanager.X`,
`--pipeline.datamanager.dataparser.X` == `--dataparser.X`), and a
TrainerConfig field is also a top-level flag (`--steps-per-save`).
"""

import dataclasses
from pathlib import Path
from typing import Any, List, Tuple, get_args, get_origin, get_type_hints


class CLIError(Exception):
    pass


_ALIASES = (
    ("pipeline.datamanager.dataparser.", "dataparser."),
    ("pipeline.datamanager.", "datamanager."),
    ("pipeline.model.", "model."),
    ("pipeline.", ""),
)


def _normalize(flag: str) -> str:
    norm = flag.lstrip("-")
    for pref, repl in _ALIASES:
        if norm.startswith(pref):
            return (repl + norm[len(pref):]).replace("-", "_")
    return norm.replace("-", "_")


def _coerce(value: str, typ) -> Any:
    origin = get_origin(typ)
    if origin is not None:
        if origin in (list, tuple):
            # accept "32,24", "32 24", "(32, 24)" and "[32, 24]" alike
            stripped = value.strip()
            if stripped[:1] in "([" and stripped[-1:] in ")]":
                stripped = stripped[1:-1]
            parts = [p for p in stripped.replace(",", " ").split() if p]
            inner = get_args(typ)[0] if get_args(typ) else str
            seq = [_coerce(p, inner) for p in parts]
            return tuple(seq) if origin is tuple else seq
        # Optional[X] / Union
        args = [a for a in get_args(typ) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        return _coerce(value, args[0]) if args else value
    if typ is bool:
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise CLIError(f"invalid bool: {value}")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is Path:
        return Path(value)
    if typ is str or typ is Any:
        return value
    if isinstance(typ, type) and issubclass(typ, Path):
        return Path(value)
    # Literal
    if str(typ).startswith("typing.Literal"):
        return value
    return value


def set_nested(obj: Any, dotted: str, value: str) -> None:
    """Set a (possibly dotted) field on a dataclass tree from a string."""
    parts = dotted.split(".")
    target = obj
    for p in parts[:-1]:
        if dataclasses.is_dataclass(target) and hasattr(target, p):
            target = getattr(target, p)
        elif isinstance(target, dict) and p in target:
            target = target[p]
        else:
            raise CLIError(f"unknown config path: {dotted} (at '{p}')")
    leaf = parts[-1]
    if dataclasses.is_dataclass(target):
        if not hasattr(target, leaf):
            raise CLIError(f"unknown config field: {dotted}")
        try:
            hints = get_type_hints(type(target))
            typ = hints.get(leaf, str)
        except Exception:
            typ = str
        setattr(target, leaf, _coerce(value, typ))
    elif isinstance(target, dict):
        target[leaf] = value
    else:
        raise CLIError(f"cannot set {dotted}")


def apply_cli_overrides(config: Any, argv: List[str]) -> Tuple[Any, List[str]]:
    """Apply `--a.b.c value` pairs to the config tree. Returns (config,
    leftover positional args)."""
    positionals: List[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            if "=" in tok:
                flag, value = tok.split("=", 1)
            else:
                if i + 1 >= len(argv):
                    raise CLIError(f"flag {tok} expects a value")
                flag, value = tok, argv[i + 1]
                i += 1
            path = _normalize(flag)
            try:
                set_nested(config, path, value)
            except CLIError:
                # TrainerConfig fields are top-level flags in the reference
                # CLI (--steps-per-save etc.); fall back to trainer.<path>.
                if "." not in path:
                    set_nested(config, f"trainer.{path}", value)
                else:
                    raise
        else:
            positionals.append(tok)
        i += 1
    return config, positionals


def print_config_help(config: Any, prefix: str = "") -> None:
    """Enumerate EVERY addressable nested flag (the tyro-generated surface of
    reference scripts/train.py:258-267), including dict groups such as
    optimizers.<group>.optimizer.lr."""
    for f in dataclasses.fields(config):
        val = getattr(config, f.name)
        dotted = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(val):
            print_config_help(val, prefix=dotted + ".")
        elif isinstance(val, dict) and val and all(
            dataclasses.is_dataclass(v) for v in val.values()
        ):
            for k, v in val.items():
                print_config_help(v, prefix=f"{dotted}.{k}.")
        else:
            typ = getattr(f.type, "__name__", str(f.type))
            print(f"  --{dotted.replace('_', '-')} {typ} (default: {val})")
