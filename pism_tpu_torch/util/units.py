"""Minimal unit system (UDUNITS-2 replacement).

The reference (PISM, ``src/util/Units.cc``) wraps UDUNITS-2 to parse and
convert the units attached to every I/O variable and config parameter. We
implement the subset PISM actually exercises: products of named units with
integer exponents (``"kg m-2 year-1"``, ``"Pa-3 s-1"``, ``"m second-1"``),
SI prefixes, and the affine Celsius<->Kelvin special case.

Pure Python, used only at setup time - never on tensors.

A copy of ``pism_tpu/util/units.py`` (numpy-free, torch-free), kept here
because the JAX package's ``__init__`` imports jax.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction

# Dimension exponents over base dimensions (m, kg, s, K, mol, A, cd).
_DIMS = ("m", "kg", "s", "K", "mol", "A", "cd")

#: Seconds in one (astronomical/udunits) year. PISM's exact-solution C code
#: (``src/verification/tests/exactTestsABCD.c``) and UDUNITS both use this.
SEC_PER_YEAR = 3.15569259747e7


def _dim(**kw) -> tuple:
    return tuple(kw.get(d, 0) for d in _DIMS)


# name -> (scale_to_SI, dimension_tuple)
_BASE_UNITS: dict = {
    "m": (1.0, _dim(m=1)),
    "meter": (1.0, _dim(m=1)),
    "meters": (1.0, _dim(m=1)),
    "g": (1e-3, _dim(kg=1)),
    "kg": (1.0, _dim(kg=1)),
    "s": (1.0, _dim(s=1)),
    "second": (1.0, _dim(s=1)),
    "seconds": (1.0, _dim(s=1)),
    "sec": (1.0, _dim(s=1)),
    "minute": (60.0, _dim(s=1)),
    "hour": (3600.0, _dim(s=1)),
    "hours": (3600.0, _dim(s=1)),
    "day": (86400.0, _dim(s=1)),
    "days": (86400.0, _dim(s=1)),
    "year": (SEC_PER_YEAR, _dim(s=1)),
    "years": (SEC_PER_YEAR, _dim(s=1)),
    "yr": (SEC_PER_YEAR, _dim(s=1)),
    "a": (SEC_PER_YEAR, _dim(s=1)),  # annum
    "common_year": (365.0 * 86400.0, _dim(s=1)),
    "K": (1.0, _dim(K=1)),
    "Kelvin": (1.0, _dim(K=1)),
    "kelvin": (1.0, _dim(K=1)),
    "N": (1.0, _dim(kg=1, m=1, s=-2)),
    "Pa": (1.0, _dim(kg=1, m=-1, s=-2)),
    "J": (1.0, _dim(kg=1, m=2, s=-2)),
    "W": (1.0, _dim(kg=1, m=2, s=-3)),
    "Hz": (1.0, _dim(s=-1)),
    "mol": (1.0, _dim(mol=1)),
    "A": (1.0, _dim(A=1)),
    "1": (1.0, _dim()),
    "": (1.0, _dim()),
    "count": (1.0, _dim()),
    "percent": (0.01, _dim()),
    "%": (0.01, _dim()),
    "degree": (1.0, _dim()),  # angle, dimensionless here
    "degrees": (1.0, _dim()),
    "radian": (57.29577951308232, _dim()),
}

_PREFIXES = {
    "Y": 1e24, "Z": 1e21, "E": 1e18, "P": 1e15, "T": 1e12, "G": 1e9,
    "M": 1e6, "k": 1e3, "h": 1e2, "da": 1e1, "d": 1e-1, "c": 1e-2,
    "m": 1e-3, "u": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15,
}

_AFFINE = {"degC", "Celsius", "celsius", "degree_Celsius"}

_TOKEN_RE = re.compile(r"^([A-Za-z%_]+|1)(?:\^)?(-?\d+)?$")


def _lookup(name: str):
    if name in _BASE_UNITS:
        return _BASE_UNITS[name]
    # try SI prefix
    for plen in (2, 1):
        p, rest = name[:plen], name[plen:]
        if p in _PREFIXES and rest in _BASE_UNITS:
            scale, dims = _BASE_UNITS[rest]
            if rest in ("kg",):  # no prefixed kg
                continue
            return (_PREFIXES[p] * scale, dims)
    raise ValueError(f"unknown unit: {name!r}")


@dataclass(frozen=True)
class Unit:
    """A parsed unit: SI scale factor + dimension vector (+offset for degC)."""

    scale: float
    dims: tuple
    offset: float = 0.0  # only for affine temperature units

    @staticmethod
    def parse(spec) -> "Unit":
        if isinstance(spec, Unit):
            return spec
        s = str(spec).strip()
        if s in _AFFINE:
            return Unit(1.0, _dim(K=1), offset=273.15)
        if s in ("", "1", "-"):
            return Unit(1.0, _dim())
        # normalize: "a/b" -> "a b-1" only for single '/'
        parts = re.split(r"\s*/\s*", s)
        scale = 1.0
        dims = [Fraction(0)] * len(_DIMS)
        for pi, part in enumerate(parts):
            sign = 1 if pi == 0 else -1
            for tok in re.split(r"[\s*]+", part.strip()):
                if not tok:
                    continue
                m = _TOKEN_RE.match(tok)
                if m is None:
                    raise ValueError(f"cannot parse unit token {tok!r} in {spec!r}")
                name, exp = m.group(1), int(m.group(2) or 1) * sign
                uscale, udims = _lookup(name)
                scale *= uscale ** exp
                dims = [d + Fraction(e * exp) for d, e in zip(dims, udims)]
        return Unit(scale, tuple(int(d) if d.denominator == 1 else d for d in dims))

    def is_convertible(self, other: "Unit") -> bool:
        return self.dims == other.dims


def convert(value, from_units, to_units):
    """Convert ``value`` (scalar or array) between unit strings."""
    fu, tu = Unit.parse(from_units), Unit.parse(to_units)
    if not fu.is_convertible(tu):
        raise ValueError(
            f"units not convertible: {from_units!r} ({fu.dims}) -> {to_units!r} ({tu.dims})"
        )
    return (value * fu.scale + fu.offset - tu.offset) / tu.scale


def conversion_factor(from_units, to_units) -> float:
    """Multiplicative factor (errors on affine units)."""
    fu, tu = Unit.parse(from_units), Unit.parse(to_units)
    if not fu.is_convertible(tu):
        raise ValueError(f"units not convertible: {from_units!r} -> {to_units!r}")
    if fu.offset != 0.0 or tu.offset != 0.0:
        raise ValueError("affine units have no pure conversion factor")
    return fu.scale / tu.scale
