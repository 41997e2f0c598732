"""Structured-config CLI.

Rebuild of the reference's config system (reference: realhf/api/cli_args.py —
~30 dataclasses with help metadata parsed by hydra/OmegaConf; the resolved
config is dumped to the log dir).  Without hydra in the image, this module
implements the same surface natively: a dataclass tree built from an optional
YAML file plus ``a.b.c=value`` dotted overrides, with ``--help`` flag listing
and resolved-config dump.

The port's copy of ``areal_tpu/api/cli_args.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import typing
from typing import Any, Dict, List, Optional, Type, Union


def _is_dataclass_type(t) -> bool:
    return isinstance(t, type) and dataclasses.is_dataclass(t)


def _unwrap_optional(t):
    origin = typing.get_origin(t)
    if origin is Union:
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return t


def _coerce(value: Any, t) -> Any:
    """Coerce a YAML/string value to the annotated type."""
    t = _unwrap_optional(t)
    if value is None:
        return None
    if _is_dataclass_type(t):
        return from_dict(t, value)
    origin = typing.get_origin(t)
    if origin in (list, List):
        (et,) = typing.get_args(t) or (str,)
        if isinstance(value, str):
            value = [v for v in value.split(",") if v]
        return [_coerce(v, et) for v in value]
    if origin in (dict, Dict):
        return dict(value)
    if origin in (tuple,):
        ets = typing.get_args(t)
        if isinstance(value, str):
            value = [v for v in value.split(",") if v]
        if ets and ets[-1] is Ellipsis:
            return tuple(_coerce(v, ets[0]) for v in value)
        return tuple(_coerce(v, et) for v, et in zip(value, ets))
    if t is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if t is int:
        return int(value)
    if t is float:
        return float(value)
    if t is str:
        return str(value)
    # special-case: MeshSpec accepts compact strings like "d2f2m2"
    from areal_tpu_torch.base.topology import MeshSpec

    if t is MeshSpec and isinstance(value, str):
        return MeshSpec.from_str(value)
    return value


def from_dict(cls: Type, d: Any):
    """Build a (possibly nested) dataclass from a plain dict."""
    if d is None:
        return None
    if isinstance(d, cls):
        return d
    from areal_tpu_torch.base.topology import MeshSpec

    if cls is MeshSpec and isinstance(d, str):
        return MeshSpec.from_str(d)
    if not isinstance(d, dict):
        raise TypeError(f"cannot build {cls.__name__} from {d!r}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    field_names = {f.name for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in field_names:
            raise KeyError(
                f"{cls.__name__} has no field {k!r} "
                f"(valid: {sorted(field_names)})"
            )
        kwargs[k] = _coerce(v, hints[k])
    return cls(**kwargs)


def _set_dotted(tree: Dict, key: str, value: Any):
    parts = key.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ValueError(f"override {key}: {p} is not a section")
    node[parts[-1]] = value


def _parse_scalar(s: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(s)
    except Exception:
        return s


def _flag_help(cls: Type, prefix: str = "") -> List[str]:
    lines = []
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        t = _unwrap_optional(hints[f.name])
        name = f"{prefix}{f.name}"
        if _is_dataclass_type(t):
            lines.extend(_flag_help(t, prefix=name + "."))
        else:
            default = (
                f.default
                if f.default is not dataclasses.MISSING
                else (
                    "<factory>"
                    if f.default_factory is not dataclasses.MISSING
                    else "<required>"
                )
            )
            h = f.metadata.get("help", "") if f.metadata else ""
            tname = getattr(t, "__name__", str(t))
            lines.append(f"  {name}={default!r}  ({tname}) {h}")
    return lines


def parse_cli(
    cls: Type,
    argv: Optional[List[str]] = None,
    defaults: Optional[Dict] = None,
):
    """``prog [--config file.yaml] [a.b.c=value ...]`` -> cls instance."""
    import yaml

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(f"usage: --config FILE.yaml  and/or  dotted.key=value overrides")
        print(f"flags for {cls.__name__}:")
        print("\n".join(_flag_help(cls)))
        sys.exit(0)

    tree: Dict = dict(defaults or {})
    if "--config" in argv:
        i = argv.index("--config")
        path = argv[i + 1]
        del argv[i : i + 2]
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        for k, v in loaded.items():
            tree[k] = v
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"unrecognized argument {arg!r}")
        k, _, v = arg.partition("=")
        _set_dotted(tree, k, _parse_scalar(v))
    return from_dict(cls, tree)


def dump_config(obj, path: str):
    """Write the resolved config as YAML (reference saves config.yaml)."""
    import enum

    import yaml

    def enc(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {f.name: enc(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, enum.Enum):
            return o.value
        if isinstance(o, (list, tuple)):
            return [enc(v) for v in o]
        if isinstance(o, dict):
            return {k: enc(v) for k, v in o.items()}
        return o

    with open(path, "w") as f:
        yaml.safe_dump(enc(obj), f, sort_keys=False)
