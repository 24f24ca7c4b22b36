"""Tiny dataclass-CLI bridge: one config tree + ``--key value`` overrides.

Counterpart of ``dgraph_tpu/utils/cli.py``: a dataclass is the schema, the
command line overrides its fields by name (dotted for nesting, ``--a.b
value`` or ``a.b=value``; a bare ``--flag`` sets a field to true). Stdlib
only. The reference's re-assertion of
``JAX_PLATFORMS`` has no counterpart: the port's entry points take their
device from ``--device``.
"""

from __future__ import annotations

import dataclasses
import sys
import types
import typing


def parse_config(config_cls, argv=None):
    """``config_cls()`` with ``--field value`` / ``--data.field value`` (or
    ``key=value``) overrides, coerced to the annotated field type."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = config_cls()
    if "--help" in argv or "-h" in argv:
        print(config_cls.__doc__)
        for f in dataclasses.fields(cfg):
            val = getattr(cfg, f.name)
            if dataclasses.is_dataclass(val):
                for g in dataclasses.fields(val):
                    print(f"  --{f.name}.{g.name} (default {getattr(val, g.name)!r})")
            else:
                print(f"  --{f.name} (default {val!r})")
        raise SystemExit(0)
    pairs, i = [], 0
    while i < len(argv):
        tok = argv[i]
        i += 1
        if tok.startswith("--"):
            key = tok[2:]
            if "=" in key:
                pairs.append(key.split("=", 1))
            elif i < len(argv) and not argv[i].startswith("--"):
                pairs.append((key, argv[i]))
                i += 1
            else:  # a bare flag: --selftest
                pairs.append((key, "true"))
        elif "=" in tok:
            pairs.append(tok.split("=", 1))
        else:
            raise SystemExit(f"override must be key=value or --key value, got {tok!r}")
    for key, raw in pairs:
        obj, parts = cfg, key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        hints = typing.get_type_hints(type(obj))
        if parts[-1] not in hints:
            raise SystemExit(f"unknown config field: {key}")
        setattr(obj, parts[-1], _coerce(raw, hints[parts[-1]]))
    return cfg


def _coerce(raw: str, ann):
    if typing.get_origin(ann) in (typing.Union, types.UnionType):  # Optional[X]
        if raw.lower() in ("none", "null"):
            return None
        ann = next(a for a in typing.get_args(ann) if a is not type(None))
    if ann is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if ann in (int, float, str):
        return ann(raw)
    return raw
