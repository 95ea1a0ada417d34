"""Dotted-flag command line over the frozen config dataclasses (port of
``nrhints_tpu/configs/cli.py``, with the same spellings):

    python -m nrhints_torch config:nr-hints --config.data.path /data/Scene --config.model.lr 2e-4

* The first positional argument picks the preset (``config:<name>`` or a
  bare ``<name>``); without one, the default preset.
* Every dataclass leaf is ``--config.<dotted.path> <value>`` or
  ``--config.<dotted.path>=<value>``; dashes in a path read as
  underscores.
* Booleans take an explicit ``True`` / ``False``; ``Literal`` fields check
  their choices, tuples split on commas, ``Optional`` fields take ``None``.
* ``--help`` lists the presets and every flag with its default.

``config_to_dict`` turns a config into the nested dict the trainer writes
to its run directory as ``config.json``.
"""
from __future__ import annotations

import dataclasses
import enum
import sys
import typing
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple


def _is_dataclass_type(t) -> bool:
    return dataclasses.is_dataclass(t) and isinstance(t, type)


def _leaf_paths(cfg) -> Dict[str, Any]:
    """Flatten a (nested) dataclass instance to {dotted_path: value}."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            for sub, sv in _leaf_paths(v).items():
                out[f"{f.name}.{sub}"] = sv
        else:
            out[f.name] = v
    return out


def _field_type(cfg_type, path: str):
    """Resolve the declared type of a dotted path in a dataclass type."""
    parts = path.split(".")
    t = cfg_type
    for i, p in enumerate(parts):
        hints = typing.get_type_hints(t)
        if p not in hints:
            raise KeyError(f"unknown config field: {path}")
        t = hints[p]
        # Unwrap Optional only mid-path (to traverse into the dataclass);
        # keep the Union at the leaf so _convert can parse "None".
        if i + 1 < len(parts):
            origin = typing.get_origin(t)
            if origin is typing.Union:
                args = [a for a in typing.get_args(t) if a is not type(None)]
                if len(args) == 1:
                    t = args[0]
    return t


def _convert(value: str, t) -> Any:
    origin = typing.get_origin(t)
    if origin is typing.Union:
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        t = args[0]
        origin = typing.get_origin(t)
    if origin is typing.Literal:
        choices = typing.get_args(t)
        if value not in choices:
            raise ValueError(f"invalid choice {value!r}; options: {choices}")
        return value
    if origin in (tuple, Tuple):
        elem_t = typing.get_args(t)[0]
        items = [v for v in value.replace("[", "").replace("]", "").split(",") if v]
        return tuple(_convert(v.strip(), elem_t) for v in items)
    if isinstance(t, type) and issubclass(t, enum.Enum):
        try:
            return t(value)
        except ValueError:
            return t[value]
    if t is bool:
        if value.lower() in ("true", "1", "yes"):
            return True
        if value.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"invalid boolean: {value!r} (use True/False)")
    if t is int:
        return int(value)
    if t is float:
        return float(value)
    if t is str:
        return value
    # Fall back to the constructor.
    return t(value)


def _set_path(cfg, path: str, value):
    """Functionally replace a dotted-path leaf in a frozen dataclass tree."""
    parts = path.split(".")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    child = getattr(cfg, parts[0])
    new_child = _set_path(child, ".".join(parts[1:]), value)
    return dataclasses.replace(cfg, **{parts[0]: new_child})


def config_to_dict(cfg) -> dict:
    """Nested dict (JSON/YAML-serializable) from a dataclass config."""

    def conv(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, enum.Enum):
            return v.value
        if isinstance(v, tuple):
            return list(v)
        return v

    return conv(cfg)


def _print_help(presets: Mapping[str, Callable], default_preset: str, example_cfg):
    print("usage: python -m nrhints_torch [config:<preset>] [--config.<path> <value>]...\n")
    print("presets:")
    for name, fn in presets.items():
        doc = (fn.__doc__ or "").strip().splitlines()
        doc = doc[0] if doc else ""
        mark = " (default)" if name == default_preset else ""
        print(f"  config:{name}{mark}  {doc}")
    print("\nflags (with defaults from the selected preset):")
    for path, v in sorted(_leaf_paths(example_cfg).items()):
        print(f"  --config.{path} = {v!r}")


def parse_cli(
    presets: Mapping[str, Callable],
    default_preset: str,
    argv: Optional[Sequence[str]] = None,
):
    """Parse argv -> a SystemConfig (or whatever the preset builds)."""
    argv = list(sys.argv[1:] if argv is None else argv)

    preset_name = default_preset
    if argv and not argv[0].startswith("-"):
        token = argv.pop(0)
        preset_name = token[len("config:") :] if token.startswith("config:") else token
        if preset_name not in presets:
            raise SystemExit(
                f"unknown preset {preset_name!r}; options: {sorted(presets)}"
            )
    cfg = presets[preset_name]()

    if "--help" in argv or "-h" in argv:
        _print_help(presets, default_preset, cfg)
        raise SystemExit(0)

    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--config."):
            raise SystemExit(f"unrecognized argument: {arg}")
        body = arg[len("--config.") :]
        if "=" in body:
            path, value = body.split("=", 1)
            i += 1
        else:
            path = body
            if i + 1 >= len(argv):
                raise SystemExit(f"flag {arg} needs a value")
            value = argv[i + 1]
            i += 2
        # Reference flag spelling uses dashes; accept both.
        path = path.replace("-", "_")
        t = _field_type(type(cfg), path)
        cfg = _set_path(cfg, path, _convert(value, t))
    return cfg
