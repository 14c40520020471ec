"""Shareable state strings and settings persistence.

Counterpart of ``blackhole_simulation_tpu/app/state.py``:

 - ``encode_state`` / ``decode_state``: a SimulationParams as a shareable
   ``#mass=...&spin=...`` hash fragment (floats by repr, bools as 1/0,
   only the fields that differ from the defaults unless ``full``), parsed
   tolerantly and clamped through the schema;
 - ``SettingsStorage``: durable settings in a JSON file, written
   atomically; corrupt or partially valid content degrades to the
   defaults field by field instead of raising.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

from blackhole_simulation_tpu_torch.configs.simulation import (
    PARAMETER_SCHEMA,
    PRESETS,
    QUALITY_RAY_STEPS,
    SimulationParams,
    clamp_params,
)

_BOOL_FIELDS = [
    f.name for f in dataclasses.fields(SimulationParams) if f.type == "bool"
]
_FLOAT_FIELDS = list(PARAMETER_SCHEMA)


def _fmt(v: float) -> str:
    """Shortest exact float representation — repr round-trips in Python 3,
    so encode/decode is lossless while staying compact for typical values."""
    return repr(v)


def encode_state(params: SimulationParams, full: bool = False) -> str:
    """SimulationParams -> '#mass=2&spin=0.999&...' hash fragment.

    Only fields differing from the defaults are emitted (useUrlState writes
    a minimal hash) unless ``full``.
    """
    defaults = SimulationParams()
    parts: list[str] = []
    for f in dataclasses.fields(SimulationParams):
        v = getattr(params, f.name)
        if not full and v == getattr(defaults, f.name):
            continue
        if isinstance(v, bool):
            parts.append(f"{f.name}={1 if v else 0}")
        elif isinstance(v, float):
            parts.append(f"{f.name}={_fmt(v)}")
        else:
            parts.append(f"{f.name}={v}")
    return "#" + "&".join(parts)


def decode_state(fragment: str) -> SimulationParams:
    """'#mass=2&spin=0.999' -> validated SimulationParams.

    Unknown keys and malformed values are ignored (the reference's hash
    parser is tolerant); everything is clamped through the schema.
    """
    frag = fragment.lstrip("#")
    updates: dict[str, Any] = {}
    valid = {f.name: f for f in dataclasses.fields(SimulationParams)}
    for part in frag.split("&"):
        if "=" not in part:
            continue
        key, _, raw = part.partition("=")
        if key not in valid:
            continue
        try:
            if key in _BOOL_FIELDS:
                updates[key] = raw.strip() in ("1", "true", "True")
            elif key == "quality":
                if raw in QUALITY_RAY_STEPS:
                    updates[key] = raw
            else:
                v = float(raw)
                if math.isfinite(v):
                    updates[key] = v
        except ValueError:
            continue
    return clamp_params(dataclasses.replace(SimulationParams(), **updates))


class SettingsStorage:
    """JSON-file settings persistence with corruption recovery
    (storage/settings.ts:20-196).

    Stored shape: {"version": 1, "params": {...}, "preset": name|None}.
    Any read failure — missing file, bad JSON, wrong types — returns
    defaults; partially-valid dicts keep their valid fields.
    """

    VERSION = 1

    def __init__(self, path: str):
        self.path = path

    def save(self, params: SimulationParams, preset: str | None = None) -> None:
        payload = {
            "version": self.VERSION,
            "params": dataclasses.asdict(clamp_params(params)),
            "preset": preset if preset in PRESETS else None,
        }
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, self.path)  # atomic: no torn files on crash

    def load(self) -> tuple[SimulationParams, str | None]:
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return SimulationParams(), None
        if not isinstance(payload, dict) or payload.get("version") != self.VERSION:
            return SimulationParams(), None
        raw = payload.get("params")
        updates: dict[str, Any] = {}
        if isinstance(raw, dict):
            for f in dataclasses.fields(SimulationParams):
                v = raw.get(f.name)
                if f.type == "bool" and isinstance(v, bool):
                    updates[f.name] = v
                elif f.type == "float" and isinstance(v, (int, float)) and math.isfinite(v):
                    updates[f.name] = float(v)
                elif f.type == "str" and isinstance(v, str):
                    updates[f.name] = v
        params = clamp_params(
            dataclasses.replace(SimulationParams(), **updates)
        )
        preset = payload.get("preset")
        return params, preset if preset in PRESETS else None
