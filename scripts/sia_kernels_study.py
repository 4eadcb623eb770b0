"""The SIA flux kernels K3 (thermomechanical) and K4 (isothermal) on one
CUDA card.

    python3 scripts/sia_kernels_study.py [--parent DIR] [--rounds N]
                                         [--sass DIR]

``pism_tpu_torch/csrc/sia_thermo.cu`` (K3) and ``sia_iso.cu`` (K4) each
take the max of D in their own launch. This script:

1. compiles both sources with ``-Xptxas -v`` and prints the registers,
   shared memory and spills of every kernel in them;
2. prints each kernel's SASS instruction count (``cuobjdump -sass``, a
   static count: all, and those before the slow-path subroutines of
   division and the like), per K4 cell, split into its pow calls, its
   divisions and the rest, and for K3 per evaluation of the integrand; with
   the card's largest SM clock that gives K3's bound by the issue of
   instructions (132 SMs, 4 warp instructions a clock each), with
   ``--sass DIR`` the listings;
3. checks on every float32 bit pattern that pow(x, 1) returns x, which
   K4 relies on for n = 3 in float32, and counts the float64 patterns for
   which it does not;
4. builds ``scripts/sia_thermo_study.cu`` and ``sia_iso_study.cu``, which
   include the sources: K3's level kernel at six block shapes and its
   column kernel, with and without the skip of the integrand above the
   ice, K4 at nine tiles with and without its pow shortcuts;
5. with ``--parent DIR`` (an unpacked checkout of an earlier commit), also
   builds ``DIR/pism_tpu_torch/csrc/sia_thermo.cu`` and ``sia_iso.cu`` and
   holds the source's kernels and every variant against them to the bit
   (a NaN equal to a NaN), and their max of D against
   torch.maximum(torch.max(De), torch.max(Dn)) of the parent's faces, in
   float32 and float64, for the Paterson-Budd and GPBLD laws (K3), n = 3
   and 1 (K4), with d_cap None and binding, on the shapes of
   ``chip_smoke.py`` phase 1, of the card tests, of the shards of its
   meshes and ragged ones, Mz from 1 to 401, K3's E contiguous and
   level-major, and a case with negative and NaN enthalpies and a NaN
   thickness;
6. prints the device time of the smallest launch (a one-element
   ``zero_()``), the launch floor;
7. times each variant and the parent's kernel in turns (the profiler's
   device time, float32, ``--rounds`` times, the order reversed in every
   other round) at the paths' shapes: K3 at 61x61x61 (EISMINT II A, path
   B) and 561x301x41 with E level-major and contiguous, at 141x76x41 and
   281x151x41 level-major (where the route changes), and on one 33x33x61
   shard (path B on a 2x2 mesh), K4 at 601x601 (Halfar B, path
   C), 61x61 and on one 303x303 shard (path C on a 2x2 mesh); beside them
   the whole call (the parent's kernel after E's copy where E is
   level-major, and before its three max ops; the source's one launch).

Everything it measures goes to standard output. It needs a CUDA card and
``nvcc``; it exits non-zero on any difference.
"""

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ssa_matvec_tiles import _demangle, device_us  # noqa: E402

THERMO_SHAPES = ((32, 8), (32, 16), (16, 16), (16, 32), (8, 32), (8, 64))
ISO_SHAPES = ((32, 8, 1), (32, 4, 1), (16, 8, 1), (32, 4, 2), (32, 8, 2),
              (32, 4, 4), (32, 16, 1), (32, 8, 4), (64, 4, 2))
# (My, Mx, Mz), Lz, grid spacing in km
THERMO_CASES = (((61, 61, 61), 5000.0, 25), ((561, 301, 41), 4000.0, 5),
                ((30, 17, 5), 5000.0, 25), ((33, 33, 61), 5000.0, 25),
                ((9, 33, 13), 5000.0, 25), ((33, 9, 7), 5000.0, 25),
                ((12, 20, 1), 5000.0, 25), ((12, 20, 2), 5000.0, 25),
                ((12, 20, 401), 5000.0, 25))
ISO_CASES = ((61, 61), (601, 601), (303, 303), (17, 30), (9, 33), (33, 9),
             (2, 70), (1, 1))
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
DP = ctypes.POINTER(ctypes.c_double)


def _nvcc_all(jobs, tmp):
    """Build {label: (source, extra flags)} with ``-Xptxas -v``, one
    ``nvcc`` each, all started together: ({label: library}, {label: log})."""
    from pism_tpu_torch.ops.kernels import _build
    libs, procs, logs = {}, {}, {}
    for label, (src, extra) in jobs.items():
        libs[label] = tmp / f"lib{label.replace(' ', '_')}.so"
        procs[label] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *extra,
             "-o", str(libs[label]), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for label, proc in procs.items():
        logs[label], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {jobs[label][0]}:\n"
                               f"{logs[label]}")
    return libs, logs


def _tool(name):
    exe = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    return exe if pathlib.Path(exe).exists() else None


def ptxas_report(log, label, keep):
    """Print the registers, shared memory and spills of the kernels whose
    names contain one of ``keep`` in an ``-Xptxas -v`` log."""
    rows, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            rows[name] = {}
        elif name and "spill" in line:
            rows[name]["spill"] = line.strip()
        elif name and "Used" in line and "registers" in line:
            rows[name]["used"] = line.split(":", 1)[1].strip()
    names = [n for n in rows if any(k in n for k in keep)]
    for n, pretty in zip(names, _demangle(names)):
        print(f"ptxas {label}: {_short(pretty)}: {rows[n].get('used')}; "
              f"{rows[n].get('spill')}")


def _short(pretty):
    """A demangled kernel name without its namespace and parameters."""
    pretty = re.sub(r"\(bool\)1", "true", re.sub(r"\(bool\)0", "false",
                                                  pretty))
    pretty = re.sub(r"\((?:unsigned )?(?:int|long)\)", "", pretty)
    for ns in ("(anonymous namespace)::", "<unnamed>::", "void "):
        pretty = pretty.replace(ns, "")
    return pretty.split("(")[0]


def sass_counts(lib, listing=None):
    """{kernel name: (SASS instructions other than NOP, those before the
    first subroutine that a CALL reaches)} of a built library, from
    ``cuobjdump -sass``; the subroutines are the slow paths of division and
    the like. ``listing``: a file to write the listing to."""
    exe = _tool("cuobjdump")
    if exe is None:
        return {}
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    if listing is not None:
        pathlib.Path(listing).write_text(out)
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = ([], [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][\w.]*)(.*)", line)
        if name and m and m.group(2) != "NOP":
            funcs[name][0].append(int(m.group(1), 16))
            if m.group(2).startswith("CALL"):
                t = re.search(r"0x([0-9a-f]+)", m.group(3))
                if t:
                    funcs[name][1].append(int(t.group(1), 16))
    names = list(funcs)
    counts = {}
    for n, pretty in zip(names, _demangle(names)):
        addrs, calls = funcs[n]
        first = min(calls) if calls else float("inf")
        counts[_short(pretty)] = (len(addrs),
                                  sum(1 for a in addrs if a < first))
    return counts


def _find(counts, *parts):
    """The count of the one kernel whose name holds every part."""
    hits = [v for k, v in counts.items() if all(p in k for p in parts)]
    return hits[0] if len(hits) == 1 else None


def _prec(t):
    import torch
    return "f32" if t.dtype == torch.float32 else "f64"


def _stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def _dbl(consts):
    return (ctypes.c_double * len(consts))(*consts)


class Kernel:
    """One build's entry point of K3 or K4. ``parent``: the earlier C
    interface (no max, E contiguous)."""

    def __init__(self, label, lib, name, k3, parent=False):
        self.label, self.lib, self.name = label, lib, name
        self.parent, self.k3 = parent, k3
        for prec in ("f32", "f64"):
            fn = self.fn(prec)
            if k3:
                fn.argtypes = ([P] * 8 + [I, I, I, DP, P] if parent else
                               [P] * 10 + [I, I, I, LL, LL, LL, DP, P])
            else:
                fn.argtypes = ([P] * 6 + [I, I, DP, P] if parent else
                               [P] * 8 + [I, I, DP, P])
            fn.restype = I

    def fn(self, prec):
        return getattr(self.lib, self.name.format(prec=prec))


class Call:
    """A launch of ``kern`` on fixed inputs with its outputs allocated once:
    ``()`` runs it, ``out`` holds (qe, qn, De, Dn) and ``max_D``."""

    def __init__(self, kern, ins, consts, work, with_max=True):
        import torch
        self.kern = kern
        H = ins[0]
        My, Mx = H.shape
        self.out = [torch.empty_like(H) for _ in range(4)]
        self.max_D = None
        scratch = (None, None)
        if not kern.parent and with_max:
            self.max_D = torch.empty((), dtype=H.dtype, device=H.device)
            scratch = (work.data_ptr(), self.max_D.data_ptr())
        ptrs = [t.data_ptr() for t in ins] + [o.data_ptr()
                                              for o in self.out]
        c = _dbl(consts)
        self._c = c
        fn = kern.fn(_prec(H))
        if kern.k3:
            E = ins[2]
            if kern.parent:
                E = E.contiguous()
                self._keep = E
                ptrs[2] = E.data_ptr()
                self.args = (*ptrs, My, Mx, E.shape[2], c)
            else:
                self.args = (*ptrs, *scratch, My, Mx, E.shape[2],
                             *E.stride(), c)
        else:
            self.args = ((*ptrs, My, Mx, c) if kern.parent
                         else (*ptrs, *scratch, My, Mx, c))
        self.fn = fn

    def __call__(self):
        err = self.fn(*self.args, _stream())
        if err:
            raise RuntimeError(f"{self.kern.label}: launch failed ({err})")


def _bits_equal(a, b):
    """Equal in every bit, a NaN equal to a NaN."""
    import torch
    ia = a.view(torch.int32 if a.dtype == torch.float32 else torch.int64)
    ib = b.view(torch.int32 if b.dtype == torch.float32 else torch.int64)
    return bool(((ia == ib) | (torch.isnan(a) & torch.isnan(b))).all())


def thermo_fields(rng, shape, Lz, dtype, dev, extreme=False):
    """H (a dome with an ice-free margin), s (H plus noise on the ice), E
    contiguous and level-major ((Mz, My, Mx) in memory), z, as in
    chip_smoke.py phase 1; ``extreme``: negative enthalpies above the ice,
    a NaN enthalpy above and one in the ice, a NaN thickness."""
    import numpy as np
    import torch
    from pism_tpu_torch.grid import vertical_levels
    My, Mx, Mz = shape
    Y, X = np.meshgrid(np.linspace(-1, 1, My), np.linspace(-1, 1, Mx),
                       indexing="ij")
    H = np.maximum(3000.0 * (1.0 - X ** 2 - Y ** 2), 0.0)
    s = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
    E = 1.0e5 + rng.uniform(0.0, 8e4, size=shape)
    z = vertical_levels(Mz, Lz)
    if extreme:
        E[..., -3:] = -rng.uniform(0.0, 5e5, size=(My, Mx, 3))
        E[1, 2, -1] = np.nan
        E[My // 2, Mx // 2, 1] = np.nan
        H[My // 3, Mx // 3] = np.nan
    t = [torch.tensor(x, dtype=dtype, device=dev) for x in (H, s, E, z)]
    lm = torch.tensor(np.ascontiguousarray(np.moveaxis(E, -1, 0)),
                      dtype=dtype, device=dev).movedim(0, -1)
    return t[0], t[1], t[2], lm, t[3]


def thermo_consts(law, km, d_cap):
    from pism_tpu_torch.ops.kernels import sia_thermo as K3
    from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter
    from pism_tpu_torch.physics.rheology import GPBLD, PatersonBudd
    EC = EnthalpyConverter()
    pb = {"pb": PatersonBudd, "gpbld": GPBLD}[law](EC=EC)
    return K3._constants(3.0, 1.5, 910.0, 9.81, km * 1e3, km * 1e3, EC, pb,
                         d_cap)


def iso_fields(rng, shape, dtype, dev, nan=False):
    """A Halfar-like dome over the inner 70% of the square, an ice-free
    margin, surface noise on the ice (the card tests' ``_dome``)."""
    import numpy as np
    import torch
    My, Mx = shape
    Y, X = np.meshgrid(np.linspace(-1, 1, My), np.linspace(-1, 1, Mx),
                       indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2) / 0.7
    H = 3600.0 * np.maximum(1.0 - r ** (4.0 / 3.0), 0.0) ** (3.0 / 7.0)
    s = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
    if nan:
        H[My // 3, Mx // 3] = np.nan
    return [torch.tensor(x, dtype=dtype, device=dev) for x in (H, s)]


def iso_consts(n, dx, d_cap):
    from pism_tpu_torch.ops.kernels import sia_iso as K4
    return K4._constants(K4.gamma(4e-25, n, 1.5), n, dx, dx, d_cap)


def _check_case(label, new, ref, ref_max):
    """``new`` Call against the parent's faces ``ref`` and their max."""
    import torch
    torch.cuda.synchronize()
    for a, b, nm in zip(new.out, ref, ("qe", "qn", "De", "Dn")):
        if not _bits_equal(a, b):
            diff = float((a - b).abs().nan_to_num(0.0).max())
            raise AssertionError(f"{label}: {nm} differs from the parent's "
                                 f"(max |diff| {diff:.3e})")
    if new.max_D is not None and not _bits_equal(new.max_D, ref_max):
        raise AssertionError(f"{label}: max_D {float(new.max_D)!r} is not "
                             f"the faces' max {float(ref_max)!r}")


def check_thermo(kernels, parent, dev, rng, work):
    import torch
    ref_kern = parent or kernels[0]
    cases = 0
    plan = [(shape, Lz, km, False) for shape, Lz, km in THERMO_CASES]
    plan.append(((61, 61, 61), 5000.0, 25, True))
    for dtype in (torch.float64, torch.float32):
        for shape, Lz, km, extreme in plan:
            H, s, E, Elm, z = thermo_fields(rng, shape, Lz, dtype, dev,
                                            extreme)
            for law in ("pb", "gpbld"):
                for cap in (None, "half"):
                    d_cap = None
                    if cap:
                        r = Call(ref_kern, (H, s, E, z),
                                 thermo_consts(law, km, None), work)
                        r()
                        torch.cuda.synchronize()
                        m = torch.maximum(r.out[2].nan_to_num(0).max(),
                                          r.out[3].nan_to_num(0).max())
                        d_cap = 0.5 * float(m) if float(m) > 0 else 1.0
                    consts = thermo_consts(law, km, d_cap)
                    ref = Call(ref_kern, (H, s, E, z), consts, work)
                    ref()
                    torch.cuda.synchronize()
                    ref_max = torch.maximum(torch.max(ref.out[2]),
                                            torch.max(ref.out[3]))
                    for kern in kernels:
                        for lay, EE in (("contiguous", E),
                                        ("level-major", Elm)):
                            c = Call(kern, (H, s, EE, z), consts, work)
                            c()
                            _check_case(
                                f"K3 {kern.label} {shape} {dtype} {law} "
                                f"d_cap={cap} {lay}"
                                + (" extreme" if extreme else ""),
                                c, ref.out, ref_max)
                            cases += 1
    print(f"bits: K3 {cases} cases equal to {ref_kern.label} to the bit "
          f"({len(kernels)} kernels; {[c[0] for c in THERMO_CASES]} and 61^3 "
          "with negative and NaN enthalpies and a NaN thickness; float64 and "
          "float32, Paterson-Budd and GPBLD, d_cap None and binding, E "
          "contiguous and level-major; max_D against the faces' max)")


def check_iso(kernels, parent, dev, rng, work):
    import torch
    ref_kern = parent or kernels[0]
    cases = 0
    plan = [(shape, False) for shape in ISO_CASES] + [((601, 601), True)]
    for dtype in (torch.float64, torch.float32):
        for shape, nan in plan:
            H, s = iso_fields(rng, shape, dtype, dev, nan)
            dx = 1800e3 / max(shape[1] - 1, 1)
            for n in (3.0, 1.0):
                for cap in (None, "half"):
                    d_cap = None
                    if cap:
                        r = Call(ref_kern, (H, s), iso_consts(n, dx, None),
                                 work)
                        r()
                        torch.cuda.synchronize()
                        m = torch.maximum(r.out[2].nan_to_num(0).max(),
                                          r.out[3].nan_to_num(0).max())
                        d_cap = 0.5 * float(m) if float(m) > 0 else 1.0
                    consts = iso_consts(n, dx, d_cap)
                    ref = Call(ref_kern, (H, s), consts, work)
                    ref()
                    torch.cuda.synchronize()
                    ref_max = torch.maximum(torch.max(ref.out[2]),
                                            torch.max(ref.out[3]))
                    for kern in kernels:
                        c = Call(kern, (H, s), consts, work)
                        c()
                        _check_case(f"K4 {kern.label} {shape} {dtype} n={n} "
                                    f"d_cap={cap}" + (" NaN" if nan else ""),
                                    c, ref.out, ref_max)
                        cases += 1
    print(f"bits: K4 {cases} cases equal to {ref_kern.label} to the bit "
          f"({len(kernels)} kernels; {list(ISO_CASES)} and 601x601 with a NaN "
          "thickness; float64 and float32, n = 3 and 1, d_cap None and "
          "binding; max_D against the faces' max)")


def check_pow1(lib):
    """pow(x, 1) against x on every float32 pattern (K4 relies on it in
    float32; it raises if one differs) and on 2^32 float64 patterns, half
    of them from all doubles and half from [2^-60, 2^10) (reported)."""
    import torch
    lib.pow1_check_f32.argtypes = [P, P]
    lib.pow1_check_f64.argtypes = [ctypes.c_ulonglong, I, P, P]
    for prec, mode, what in (("f32", 0, "every float32 pattern"),
                             ("f64", 0, "2^31 float64 patterns"),
                             ("f64", 1, "2^31 float64 patterns in "
                                        "[2^-60, 2^10)")):
        counts = torch.zeros(2, dtype=torch.int64, device="cuda")
        fn = getattr(lib, f"pow1_check_{prec}")
        args = ((counts.data_ptr(),) if prec == "f32"
                else (1 << 31, mode, counts.data_ptr()))
        if fn(*args, _stream()):
            raise RuntimeError("pow1 check launch failed")
        torch.cuda.synchronize()
        bad, nan_bits = (int(x) for x in counts.cpu())
        print(f"pow1: pow(x, 1) against x on {what}: {bad} differ, {nan_bits} "
              "NaNs come back as another NaN")
        if bad and prec == "f32":
            raise AssertionError("pow(x, 1) is not x in float32")


def sass_report(libs, clock_mhz, listings):
    """Print the SASS counts of the kernels in ``libs`` ({label: library})
    and return K3's instructions per integrand evaluation outside the slow
    paths (float32), or None. ``listings``: a directory for the listings,
    or None."""
    counts = {}
    for label, lib in libs.items():
        out = (None if listings is None else
               pathlib.Path(listings) / f"{label.replace(' ', '_')}.sass")
        counts[label] = sass_counts(lib, out)
    for label, c in counts.items():
        for name, (n, main) in c.items():
            if "sia_" in name or "probe" in name:
                print(f"sass {label}: {name}: {n} instructions, {main} "
                      "before the slow-path subroutines")
    ci, ct = counts.get("iso study", {}), counts.get("thermo study", {})
    per_f = {}
    for prec, T in (("f32", "float"), ("f64", "double")):
        got = [_find(c, f"{probe}<{T}>") for c, probe in (
            (ci, "probe_base_kernel"), (ci, "probe_pow_kernel"),
            (ci, "probe_div_kernel"), (ci, "probe_exp_kernel"),
            (ct, "probe_f_level_kernel"), (ct, "probe_f_base_kernel"))]
        if None in got:
            print(f"sass {prec}: not measured (no cuobjdump or no probe)")
            continue
        (base, powc, divc, expc, fl, fb) = got
        d = [(x[0] - base[0], x[1] - base[1]) for x in (powc, divc, expc)]
        (pw, pwm), (dv, dvm), (ex, exm) = d
        per_f[prec] = fl[1] - fb[1]
        print(f"sass {prec}: probe minus baseline, all / before the slow "
              f"paths: one pow {pw} / {pwm}, one exp {ex} / {exm}, one IEEE "
              f"division {dv} / {dvm}; the integrand f_level {fl[0] - fb[0]}"
              f" / {fl[1] - fb[1]}")
        for name, (n, main) in ci.items():
            m = re.search(rf"sia_iso_kernel<{T}, (\d+), (\d+), (\d+), "
                          r"(true|false)>", name)
            if not m:
                continue
            ry, pow1 = int(m.group(3)), m.group(4) == "true"
            npow = 2 if pow1 else 4
            cell = main / ry
            print(f"sass {prec}: K4 {m.group(1)}x{m.group(2)}x{ry} "
                  f"{'pow1' if pow1 else 'pow'} per cell before the slow "
                  f"paths {cell:.1f}: {npow} pow {npow * pwm}, 4 divisions "
                  f"{4 * dvm}, the rest {cell - npow * pwm - 4 * dvm:.1f}")
    if clock_mhz:
        print(f"sass: issue rate 132 SMs x 4 warp instructions x 32 lanes at "
              f"{clock_mhz:.0f} MHz = {132 * 4 * 32 * clock_mhz * 1e6:.3e} "
              "thread instructions/s")
    return per_f.get("f32")


def _face_levels(H, E, z):
    """(all, evaluated by the skip) face-levels of a K3 launch: the skip
    leaves out depth 0 with E >= 0 (NaN is evaluated)."""
    import torch
    Hp = torch.nn.functional.pad(H[None, None], (0, 1, 0, 1),
                                 mode="replicate")[0, 0]
    Ep = torch.cat([E, E[:, -1:]], 1)
    Ep = torch.cat([Ep, Ep[-1:]], 0)
    tot = ev = 0
    for Hf, Ef in ((0.5 * (H + Hp[:-1, 1:]), 0.5 * (E + Ep[:-1, 1:])),
                   (0.5 * (H + Hp[1:, :-1]), 0.5 * (E + Ep[1:, :-1]))):
        depth = torch.clamp(Hf[..., None] - z, min=0.0)
        skip = (depth == 0) & (Ef >= 0)
        tot += skip.numel()
        ev += int((~skip).sum())
    return tot, ev


def time_all(thermo, iso, parents, dev, rng, rounds, work, per_f,
             clock_mhz):
    """Device µs of each kernel alone at the paths' shapes, in turns, and
    of the whole call of the source and the parent."""
    import torch
    from pism_tpu_torch.ops import sharded as S
    from pism_tpu_torch.parallel import make_mesh
    mesh = make_mesh([dev] * 4, (2, 2))
    rows = []   # (label, {kernel label: callable})
    for shape, Lz, km in (((61, 61, 61), 5000.0, 25),
                          ((141, 76, 41), 4000.0, 20),
                          ((281, 151, 41), 4000.0, 10),
                          ((561, 301, 41), 4000.0, 5)):
        H, s, E, Elm, z = thermo_fields(rng, shape, Lz, torch.float32, dev)
        consts = thermo_consts("pb", km, None)
        tot, ev = _face_levels(H, Elm, z)
        bound = ""
        if per_f and clock_mhz:
            rate = 132 * 4 * 32 * clock_mhz * 1e6
            bound = (f"; issue bound {1e6 * tot * per_f / rate:.2f} us for "
                     f"{tot} face-levels, {1e6 * ev * per_f / rate:.2f} us "
                     f"for the {ev} the skip evaluates ({per_f} "
                     "instructions each)")
        print(f"time: K3 {'x'.join(map(str, shape))}: {tot} face-levels, "
              f"{ev} evaluated with the skip{bound}")
        layouts = (("level-major", Elm), ("contiguous", E)) \
            if shape[0] in (61, 561) else (("level-major", Elm),)
        for lay, EE in layouts:
            fns = {k.label: Call(k, (H, s, EE, z), consts, work)
                   for k in thermo + parents["K3"]}
            rows.append((f"K3 {'x'.join(map(str, shape))} {lay}", fns))
            if shape == (61, 61, 61) and lay == "level-major":
                rows.append(("K3 61x61x61 level-major without the max", {
                    k.label: Call(k, (H, s, EE, z), consts, work,
                                  with_max=False) for k in thermo}))
            if parents["K3"]:
                from pism_tpu_torch.ops.kernels import sia_thermo as K3
                from pism_tpu_torch.physics.enthalpy_converter import \
                    EnthalpyConverter
                from pism_tpu_torch.physics.rheology import PatersonBudd
                EC = EnthalpyConverter()
                kw = dict(enhancement=1.5, dx=km * 1e3, dy=km * 1e3, EC=EC,
                          pb_law=PatersonBudd(EC=EC))
                pk = parents["K3"][0]
                pc = Call(pk, (H, s, E, z), consts, work)

                def parent_call(pc=pc, EE=EE, lay=lay):
                    if lay == "level-major":
                        Ec = EE.contiguous()
                        pc.args = (*pc.args[:2], Ec.data_ptr(), *pc.args[3:])
                    pc()
                    torch.maximum(torch.max(pc.out[2]), torch.max(pc.out[3]))

                rows.append((f"K3 call {'x'.join(map(str, shape))} {lay}", {
                    "parent call (copy of E, kernel, 3 max ops)"
                    if lay == "level-major" else
                    "parent call (kernel, 3 max ops)": parent_call,
                    "source call (sia_flux_thermo)":
                    lambda H=H, s=s, EE=EE, z=z, kw=kw:
                    K3.sia_flux_thermo(H, s, EE, z, **kw)}))
    # one shard of 61x61x61 on 2x2: contiguous one-ghost blocks, no max
    H, s, E, _, z = thermo_fields(rng, (61, 61, 61), 5000.0, torch.float32,
                                  dev)
    blocks = [b[1][1] for b in S._blocks((H, s, E), 1, mesh,
                                         *S._pad_amounts(H.shape, mesh))]
    consts = thermo_consts("pb", 25, None)
    rows.append(("K3 33x33x61 shard", {
        k.label: Call(k, (*blocks, z), consts, work, with_max=False)
        for k in thermo + parents["K3"]}))
    for shape in ((601, 601), (61, 61)):
        H, s = iso_fields(rng, shape, torch.float32, dev)
        consts = iso_consts(3.0, 1800e3 / (shape[1] - 1), None)
        fns = {k.label: Call(k, (H, s), consts, work)
               for k in iso + parents["K4"]}
        rows.append((f"K4 {shape[0]}x{shape[1]}", fns))
        if shape == (601, 601):
            rows.append(("K4 601x601 without the max", {
                k.label: Call(k, (H, s), consts, work, with_max=False)
                for k in iso}))
        if parents["K4"]:
            from pism_tpu_torch.ops.kernels import sia_iso as K4
            pc = Call(parents["K4"][0], (H, s), consts, work)

            def parent_call(pc=pc):
                pc()
                torch.maximum(torch.max(pc.out[2]), torch.max(pc.out[3]))

            kw = dict(A=4e-25, enhancement=1.5, dx=1800e3 / (shape[1] - 1),
                      dy=1800e3 / (shape[1] - 1))
            rows.append((f"K4 call {shape[0]}x{shape[1]}", {
                "parent call (kernel, 3 max ops)": parent_call,
                "source call (sia_flux)":
                lambda H=H, s=s, kw=kw: K4.sia_flux(H, s, **kw)}))
    H, s = iso_fields(rng, (601, 601), torch.float32, dev)
    blocks = [b[1][1] for b in S._blocks((H, s), 1, mesh,
                                         *S._pad_amounts(H.shape, mesh))]
    consts = iso_consts(3.0, 3e3, None)
    rows.append(("K4 303x303 shard", {
        k.label: Call(k, blocks, consts, work, with_max=False)
        for k in iso + parents["K4"]}))

    times = {label: {k: [] for k in fns} for label, fns in rows}
    for r in range(rounds):
        for label, fns in rows:
            order = list(fns) if r % 2 == 0 else list(fns)[::-1]
            for k in order:
                times[label][k].append(device_us(fns[k], reps=100))
    for label, fns in rows:
        for k in fns:
            ts = [t for t in times[label][k] if t is not None]
            print(f"time: {label} {k}: "
                  + (f"mean {sum(ts) / len(ts):.3f} us, min {min(ts):.3f}, "
                     f"max {max(ts):.3f} over {len(ts)} rounds"
                     if ts else "not measured"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="an unpacked checkout of an earlier commit")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--sass", type=pathlib.Path, default=None,
                    help="a directory to write the SASS listings to")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sia_kernels_study: needs a CUDA card")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.strip()
    clock_mhz = float(clock.splitlines()[0]) if clock else None
    print(f"card: {smi}; largest SM clock {clock} MHz; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    csrc = ROOT / "pism_tpu_torch" / "csrc"
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sia_kernels_study_",
                                        dir=ROOT / "build"))
    jobs = {"thermo": (csrc / "sia_thermo.cu", ()),
            "iso": (csrc / "sia_iso.cu", ()),
            "thermo study": (ROOT / "scripts" / "sia_thermo_study.cu",
                             ("-I", str(csrc))),
            "iso study": (ROOT / "scripts" / "sia_iso_study.cu",
                          ("-I", str(csrc)))}
    if args.parent is not None:
        pc = args.parent / "pism_tpu_torch" / "csrc"
        jobs["parent thermo"] = (pc / "sia_thermo.cu", ())
        jobs["parent iso"] = (pc / "sia_iso.cu", ())
    libs, logs = _nvcc_all(jobs, tmp)
    for label in ("thermo", "iso", "parent thermo", "parent iso"):
        if label in logs:
            ptxas_report(logs[label], label, ("sia_",))
    per_f = sass_report(libs, clock_mhz, args.sass)

    L = {k: ctypes.CDLL(str(v)) for k, v in libs.items()}
    check_pow1(L["iso study"])
    thermo = [Kernel("source", L["thermo"], "pism_sia_flux_thermo_{prec}",
                     True)]
    thermo += [Kernel(f"{name} {kind}", L["thermo study"],
                      f"study_thermo_{name}_{kind}_{{prec}}", True)
               for name in [f"{tx}x{ty}" for tx, ty in THERMO_SHAPES]
               + ["column"] for kind in ("skip", "full")]
    iso = [Kernel("source", L["iso"], "pism_sia_flux_{prec}", False)]
    iso += [Kernel(f"{bx}x{by}x{ry} {kind}", L["iso study"],
                   f"study_iso_{bx}x{by}x{ry}_{kind}_{{prec}}", False)
            for bx, by, ry in ISO_SHAPES for kind in ("fast", "pow")]
    parents = {"K3": [], "K4": []}
    if args.parent is not None:
        parents["K3"] = [Kernel("parent", L["parent thermo"],
                                "pism_sia_flux_thermo_{prec}", True,
                                parent=True)]
        parents["K4"] = [Kernel("parent", L["parent iso"],
                                "pism_sia_flux_{prec}", False, parent=True)]
    # grid_max's words: a ticket and the max's key, as every launch leaves them
    work = torch.tensor([0, -2 ** 63], dtype=torch.int64, device=dev)
    rng = np.random.default_rng(20261017)
    check_thermo(thermo, (parents["K3"] or [None])[0], dev, rng, work)
    check_iso(iso, (parents["K4"] or [None])[0], dev, rng, work)
    if work.tolist() != [0, -2 ** 63]:
        raise AssertionError(f"grid_max left its work at {work.tolist()}")
    x = torch.zeros(1, device=dev)
    floor = device_us(lambda: x.zero_())
    print("launch floor: a one-element zero_() "
          + ("not measured" if floor is None else f"{floor:.3f} us")
          + " of device time")
    time_all(thermo, iso, parents, dev, rng, args.rounds, work, per_f,
             clock_mhz)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
