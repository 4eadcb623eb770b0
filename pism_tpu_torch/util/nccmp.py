"""Tolerance-based NetCDF comparison (port of ``pism_tpu/util/nccmp.py``;
the ``nccmp.py`` of PISM's regression suite): two files compared variable
by variable with absolute/relative tolerances, reporting the first
differences. It reads through ``io/nc4.py``, so either file may be
NetCDF-4 or classic. As a library (the tests, ``chip_smoke.py``) and as a
command::

    python -m pism_tpu_torch.util.nccmp a.nc b.nc [-v thk,usurf] [-t 1e-12] [-r 0]

Exit status 0 when the files match within tolerance, 1 otherwise.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np


class Mismatch:
    def __init__(self, name, kind, detail):
        self.name, self.kind, self.detail = name, kind, detail

    def __str__(self):
        return f"{self.name}: {self.kind} ({self.detail})"


def compare(path_a: str, path_b: str, variables: Optional[Sequence[str]] = None,
            atol: float = 0.0, rtol: float = 0.0) -> List[Mismatch]:
    """Compare variables of two NetCDF files; return a list of mismatches
    (empty = files agree within tolerance).

    ``variables=None`` compares the intersection-checked union: a variable
    present in only one file is itself a mismatch.
    """
    from ..io.nc4 import File

    out: List[Mismatch] = []
    with File(path_a, "r") as fa, File(path_b, "r") as fb:
        va, vb = set(fa.variables()), set(fb.variables())
        if variables is None:
            for name in sorted(va ^ vb):
                where = path_a if name in va else path_b
                out.append(Mismatch(name, "only in one file", where))
            names = sorted(va & vb)
        else:
            names = list(variables)
            for name in names:
                if name not in va or name not in vb:
                    out.append(Mismatch(name, "missing",
                                        "absent from one of the files"))
            names = [n for n in names if n in va and n in vb]
        for name in names:
            a, b = fa.read(name), fb.read(name)
            if a.shape != b.shape:
                out.append(Mismatch(name, "shape", f"{a.shape} vs {b.shape}"))
                continue
            if a.dtype.kind in "SU" or b.dtype.kind in "SU":
                if not np.array_equal(a, b):
                    out.append(Mismatch(name, "string values differ", ""))
                continue
            a = np.asarray(a, np.float64)
            b = np.asarray(b, np.float64)
            nan_a, nan_b = np.isnan(a), np.isnan(b)
            if not np.array_equal(nan_a, nan_b):
                out.append(Mismatch(name, "NaN pattern",
                                    f"{nan_a.sum()} vs {nan_b.sum()} NaNs"))
                continue
            d = np.abs(a - b)
            d = np.where(a == b, 0.0, d)   # equal Infs: |inf-inf| is NaN
            ok = d <= atol + rtol * np.abs(b)
            ok |= nan_a
            if not ok.all():
                i = np.unravel_index(np.nanargmax(np.where(ok, -np.inf, d)),
                                     d.shape)
                out.append(Mismatch(
                    name, "values differ",
                    f"max |diff| = {np.nanmax(d):.6g} at {tuple(int(k) for k in i)}, "
                    f"{int((~ok).sum())} of {d.size} cells over tolerance"))
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="pism_tpu_torch.util.nccmp",
        description="compare two NetCDF files within tolerances")
    ap.add_argument("file_a")
    ap.add_argument("file_b")
    ap.add_argument("-v", "--variables", default=None,
                    help="comma list (default: all common variables)")
    ap.add_argument("-t", "--atol", type=float, default=0.0)
    ap.add_argument("-r", "--rtol", type=float, default=0.0)
    args = ap.parse_args(argv)
    names = args.variables.split(",") if args.variables else None
    mismatches = compare(args.file_a, args.file_b, names,
                         atol=args.atol, rtol=args.rtol)
    for m in mismatches:
        print(m)
    if not mismatches:
        print("files are identical within tolerance "
              f"(atol={args.atol}, rtol={args.rtol})")
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
