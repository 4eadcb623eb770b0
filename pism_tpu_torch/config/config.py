"""Typed run-time configuration.

Mirrors PISM's ``ConfigInterface`` (``src/util/ConfigInterface.cc``): typed
getters with unit conversion, override files, and tracking of parameters that
were actually read (PISM reports unused overrides). The config is a plain
host-side object read when components are built.

A copy of ``pism_tpu/config/config.py``; ``parameters.py`` beside it is the
port's own copy of the JAX package's parameter database (names, defaults,
units and documentation kept identical, which a test checks key for key).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Optional

from ..util.units import convert
from .parameters import PARAMETERS


def require(config: "Config", name: str, allowed: Iterable[Any]) -> None:
    """Raise NotImplementedError unless ``name`` has one of the ``allowed``
    values: the port implements only the branches its chain runs and never
    silently does something else for the rest."""
    allowed = tuple(allowed)
    value = config._get(name)
    if value not in allowed:
        raise NotImplementedError(
            f"{name} = {value!r} is not implemented in pism_tpu_torch "
            f"(supported: {', '.join(map(repr, allowed))})")


class Config:
    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {k: v[0] for k, v in PARAMETERS.items()}
        self._units: Dict[str, Optional[str]] = {k: v[1] for k, v in PARAMETERS.items()}
        self._docs: Dict[str, str] = {k: v[2] for k, v in PARAMETERS.items()}
        self._used: set = set()
        self._explicit: set = set()
        if overrides:
            self.update(overrides)

    # -- mutation (host-side only, before tracing) ---------------------------
    def update(self, overrides: Dict[str, Any]) -> "Config":
        for k, v in overrides.items():
            if k not in self._values:
                raise KeyError(f"unknown config parameter: {k!r}")
            self._values[k] = v
            self._explicit.add(k)
        return self

    def set_number(self, name: str, value: float, units: Optional[str] = None):
        if name not in self._values:
            raise KeyError(f"unknown config parameter: {name!r}")
        if units is not None and self._units[name] is not None:
            value = convert(value, units, self._units[name])
        self._values[name] = float(value)
        self._explicit.add(name)

    def set_string(self, name: str, value: str):
        self.update({name: value})

    def set_flag(self, name: str, value: bool):
        self.update({name: bool(value)})

    # -- typed getters -------------------------------------------------------
    def get_number(self, name: str, units: Optional[str] = None) -> float:
        v = self._get(name)
        if units is not None:
            stored = self._units[name]
            if stored is None:
                raise ValueError(f"{name!r} has no units; cannot convert to {units!r}")
            v = convert(float(v), stored, units)
        return float(v)

    def get_string(self, name: str) -> str:
        return str(self._get(name))

    def get_flag(self, name: str) -> bool:
        return bool(self._get(name))

    def get_int(self, name: str) -> int:
        return int(self._get(name))

    def units(self, name: str) -> Optional[str]:
        return self._units[name]

    def doc(self, name: str) -> str:
        return self._docs[name]

    def _get(self, name: str):
        if name not in self._values:
            raise KeyError(f"unknown config parameter: {name!r}")
        self._used.add(name)
        return self._values[name]

    def is_set(self, name: str) -> bool:
        """True when the parameter was explicitly set (override/CLI/file),
        as opposed to sitting at its database default.  Used for parameters
        whose default is "inherit from a sibling" (e.g.
        ``stress_balance.blatter.Glen_exponent`` inherits the ssa value)."""
        if name not in self._values:
            raise KeyError(f"unknown config parameter: {name!r}")
        return name in self._explicit

    # -- introspection / provenance ------------------------------------------
    def used_parameters(self) -> Dict[str, Any]:
        return {k: self._values[k] for k in sorted(self._used)}

    def non_default(self) -> Dict[str, Any]:
        return {
            k: v for k, v in self._values.items() if v != PARAMETERS[k][0]
        }

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def to_json(self) -> str:
        """Full config dump, stored in output files (PISM stores its config
        in output attributes; see SURVEY.md §5.6)."""
        return json.dumps(self._values, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Config":
        cfg = Config()
        data = json.loads(s)
        # A full dump contains every parameter; only values that differ from
        # the database default are treated as explicit so that inherit-from-
        # sibling defaults (see is_set) survive a dump/load round trip.
        known = {k: v for k, v in data.items()
                 if k in cfg._values and v != PARAMETERS[k][0]}
        cfg.update(known)
        return cfg

    def copy(self) -> "Config":
        c = Config()
        c._values = dict(self._values)
        c._explicit = set(self._explicit)
        return c
