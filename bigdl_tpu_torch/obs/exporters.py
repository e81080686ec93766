"""Exporters (``bigdl_tpu/obs/exporters.py``): a registry snapshot as
Prometheus text or JSON.

Prometheus text exposition format (version 0.0.4):

- metric names are ``<prefix>_<key>`` with every character outside
  ``[a-zA-Z0-9_]`` mapped to ``_``; the prefix gives a legal first
  character;
- only numeric values export (bools as 0/1); strings and Nones stay in
  the registry and the JSON;
- every metric renders once: a collision after sanitizing (``a.b`` and
  ``a_b``) keeps the first key in the registry's order;
- everything is typed ``gauge`` with the raw dotted key as HELP.

The JSON exporter is the registry's flat dict verbatim; timestamps and
run metadata belong to the caller's envelope.
"""


from __future__ import annotations

import json
import math
import re
from typing import Any, Dict

_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def prometheus_name(key: str, prefix: str = "bigdl") -> str:
    """Registry key -> legal exposition metric name."""
    return f"{prefix}_{_SANITIZE.sub('_', str(key))}"


def _format_value(v) -> str:
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


def to_prometheus(flat: Dict[str, Any], prefix: str = "bigdl") -> str:
    """Render a flat registry snapshot as text exposition format."""
    lines = []
    seen = set()
    for key, v in flat.items():
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, (int, float)):
            continue  # strings/None stay JSON-only
        name = prometheus_name(key, prefix)
        if name in seen:
            continue  # first key wins (registry insertion order)
        seen.add(name)
        lines.append(f"# HELP {name} {key}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_format_value(v)}")
    return "\n".join(lines) + "\n"


def to_json(flat: Dict[str, Any], indent=None) -> str:
    """Render a flat registry snapshot as JSON (non-JSON-able values
    stringify rather than fail the dump)."""
    return json.dumps(flat, indent=indent, default=str)
