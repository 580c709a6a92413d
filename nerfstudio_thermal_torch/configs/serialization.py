"""Config YAML round trip (counterpart of nerfstudio_thermal_tpu/configs/serialization.py).

ns-train saves the whole MethodConfig as `config.yml`, and ns-eval loads it
back. As in the JAX package, each dataclass node carries its class path
(`__class__: module:QualName`) and each Path is `{__path__: str}`, so
`from_dict` rebuilds the same classes.

The JAX package writes the file with PyYAML, which the card's machine may
not have, so this module writes and reads the subset `to_dict` produces
with its own code: block mappings (string keys) and block lists; str, int,
float (.inf, -.inf, .nan), bool and null scalars; `{}` and `[]` for empty
containers. Every string that a YAML 1.1 reader would take for something
else is double-quoted with JSON escapes (a subset of YAML's), so the file is
valid YAML that `yaml.safe_load` reads back to the same tree.
"""

import dataclasses
import importlib
import json
import math
import re
import typing
from pathlib import Path
from typing import Any, List, Tuple


def to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__class__": f"{type(obj).__module__}:{type(obj).__qualname__}"}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, Path):
        return {"__path__": str(obj)}
    return obj


def from_dict(data: Any) -> Any:
    if isinstance(data, dict):
        if "__path__" in data:
            return Path(data["__path__"])
        if "__class__" in data:
            module, qualname = data["__class__"].split(":")
            cls = importlib.import_module(module)
            for part in qualname.split("."):
                cls = getattr(cls, part)
            kwargs = {k: from_dict(v) for k, v in data.items() if k != "__class__"}
            field_names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in kwargs.items() if k in field_names})
        return {k: from_dict(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_dict(v) for v in data]
    return data


def save_config(config: Any, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dump_yaml(to_dict(config)))


def load_config(path: Path) -> Any:
    # dataclass fields declared as tuples arrive as lists
    return _fix_tuples(from_dict(load_yaml(Path(path).read_text())))


def _fix_tuples(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        hints = typing.get_type_hints(type(obj))
        for f in dataclasses.fields(obj):
            val = _fix_tuples(getattr(obj, f.name))
            if isinstance(val, list) and typing.get_origin(hints.get(f.name)) is tuple:
                val = tuple(val)
            setattr(obj, f.name, val)
        return obj
    if isinstance(obj, dict):
        return {k: _fix_tuples(v) for k, v in obj.items()}
    return obj


# YAML subset -----------------------------------------------------------

_INDENT = 2
# strings written plain: a YAML 1.1 reader takes these for strings as long
# as they are not one of its reserved words or a number
_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*\Z")
_RESERVED = {"y", "n", "yes", "no", "true", "false", "on", "off", "null"}


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        # YAML 1.1 floats need a dot: 1e-15 -> 1.0e-15
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(v, str):
        if _PLAIN.match(v) and v.lower() not in _RESERVED:
            return v
        return json.dumps(v)
    raise TypeError(f"cannot write {type(v).__name__} {v!r} to config.yml")


def _dump(node: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for k, v in node.items():
            if not isinstance(k, str):
                raise TypeError(f"config.yml keys are strings, not {k!r}")
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{_scalar(k)}:")
                _dump(v, indent + _INDENT, out)
            else:
                out.append(f"{pad}{_scalar(k)}: {_inline(v)}")
    else:
        for v in node:
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}-")
                _dump(v, indent + _INDENT, out)
            else:
                out.append(f"{pad}- {_inline(v)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dump_yaml(tree: Any) -> str:
    """A dict or list of dicts, lists and scalars as block YAML."""
    if not tree:
        return _inline(tree) + "\n"
    out: List[str] = []
    _dump(tree, 0, out)
    return "\n".join(out) + "\n"


_INT = re.compile(r"[-+]?[0-9]+\Z")
_FLOAT = re.compile(r"[-+]?([0-9][0-9]*)?\.[0-9]*([eE][-+][0-9]+)?\Z")
_SPECIAL = {"null": None, "~": None, "true": True, "false": False, ".inf": math.inf, "-.inf": -math.inf,
            "+.inf": math.inf, ".nan": math.nan, "{}": {}, "[]": []}


def _parse_scalar(text: str) -> Any:
    if text.startswith('"'):
        return json.loads(text)
    if text in _SPECIAL:
        value = _SPECIAL[text]
        return type(value)() if isinstance(value, (dict, list)) else value
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text)
    return text


def _split_key(line: str) -> Tuple[str, str]:
    """'key: value' -> (key, value) with a plain or double-quoted key."""
    if line.startswith('"'):
        decoder = json.JSONDecoder()
        key, end = decoder.raw_decode(line)
        rest = line[end:]
    else:
        end = line.index(":")
        key, rest = line[:end], line[end:]
    if not rest.startswith(":"):
        raise ValueError(f"config.yml: expected 'key: value', got {line!r}")
    return key, rest[1:].strip()


def load_yaml(text: str) -> Any:
    """Read back what `dump_yaml` writes."""
    lines = [(len(ln) - len(ln.lstrip(" ")), ln.strip()) for ln in text.splitlines() if ln.strip()]
    if [text for _, text in lines] in (["{}"], ["[]"]):
        return _parse_scalar(lines[0][1])
    node, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"config.yml: unexpected indentation at {lines[pos][1]!r}")
    return node


def _parse_block(lines, pos: int, indent: int) -> Tuple[Any, int]:
    is_list = lines[pos][1] == "-" or lines[pos][1].startswith("- ")
    node: Any = [] if is_list else {}
    while pos < len(lines) and lines[pos][0] == indent:
        text = lines[pos][1]
        if is_list:
            if not (text == "-" or text.startswith("- ")):
                raise ValueError(f"config.yml: expected a list item, got {text!r}")
            rest = text[1:].strip()
            key = None
        else:
            key, rest = _split_key(text)
        pos += 1
        if rest:
            value = _parse_scalar(rest)
        elif pos < len(lines) and lines[pos][0] > indent:
            value, pos = _parse_block(lines, pos, lines[pos][0])
        else:
            value = None
        if is_list:
            node.append(value)
        else:
            node[key] = value
    if pos < len(lines) and lines[pos][0] > indent:
        raise ValueError(f"config.yml: unexpected indentation at {lines[pos][1]!r}")
    return node, pos
