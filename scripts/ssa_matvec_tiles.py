"""Tile shapes of the SSA operator matvec (K1, K5) on one CUDA card.

    python3 scripts/ssa_matvec_tiles.py [--parent DIR] [--rounds N]

``pism_tpu_torch/csrc/ssa_matvec.cu`` runs K1 (whole field, clamped edges)
and K5 (one shard of a mesh, halo-padded blocks) through one tiled kernel
template. This script:

1. compiles that source with ``-Xptxas -v`` and prints the registers,
   shared memory and spills of every matvec kernel in it;
2. builds ``scripts/ssa_matvec_study.cu``, which includes the source: its
   kernel ("regs": a thread per cell, the neighbourhood in registers) and
   a variant that stages the tile in shared memory ("smem"), at the tile
   shapes 32x8, 32x4, 16x8 and 16x4, for both layouts;
3. with ``--parent DIR`` (an unpacked checkout of an earlier commit), also
   builds ``DIR/pism_tpu_torch/csrc/ssa_matvec.cu`` and holds the source's
   K1, K5 (every shard) and Newton matvec, and every study shape, against
   that build to the bit, in float32 and float64, on the cases of
   ``chip_smoke.py`` phase 1 and the ragged ones of the card tests;
4. prints the device time of the smallest launch (a one-element
   ``zero_()``), the launch floor;
5. times the kernel alone (the profiler's device time, float32) at the
   paths' shapes: K1 at 141x76 (20 km) and 561x301 (5 km), K5 on one shard
   of 71x38 and 281x151 (those grids on a 2x2 mesh), each variant and the
   parent's kernel in turns, ``--rounds`` times, the order reversed in
   every other round.

Everything it measures goes to standard output. It needs a CUDA card and
``nvcc``; it exits non-zero on any difference.
"""

import argparse
import ctypes
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = ((32, 8), (32, 4), (16, 8), (16, 4))
K1_CASES = ((141, 76), (561, 301), (24, 40), (9, 33), (33, 9), (2, 70))
K5_CASES = (((142, 76), (2, 2)), ((561, 301), (2, 2)), ((29, 37), (2, 4)),
            ((40, 24), (1, 8)), ((9, 33), (1, 4)), ((33, 9), (4, 1)))
TIMED = (("K1 141x76", (141, 76), None), ("K1 561x301", (561, 301), None),
         ("K5 71x38 shard", (142, 76), (2, 2)),
         ("K5 281x151 shard", (561, 301), (2, 2)))

P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def _nvcc(src, out, extra=()):
    from pism_tpu_torch.ops.kernels import _build
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _demangle(names):
    for tool in ("cu++filt", "c++filt"):
        exe = shutil.which(tool) or (f"/usr/local/cuda/bin/{tool}"
                                     if tool == "cu++filt" else None)
        if exe and pathlib.Path(exe).exists():
            out = subprocess.run([exe], input="\n".join(names),
                                 capture_output=True, text=True).stdout
            return out.splitlines()
    return list(names)


def ptxas_report(log, label):
    """Print the registers, shared memory and spills of the matvec kernels
    in an ``-Xptxas -v`` log."""
    rows, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            rows[name] = {}
        elif name and "spill" in line:
            rows[name]["spill"] = line.strip()
        elif name and "Used" in line and "registers" in line:
            rows[name]["used"] = line.split(":", 1)[1].strip()
    names = [n for n in rows if "matvec" in n]
    for n, pretty in zip(names, _demangle(names)):
        pretty = pretty.replace("(anonymous namespace)::", "")
        pretty = pretty.split("(")[0]
        print(f"ptxas {label}: {pretty}: {rows[n].get('used')}; "
              f"{rows[n].get('spill')}")


class Variant:
    """One build's K1 and K5 entry points: ``k1(prec)`` and ``k5(prec)``
    are the C functions."""

    def __init__(self, label, lib, k1_name, k5_name):
        self.label, self.lib = label, lib
        self.k1_name, self.k5_name = k1_name, k5_name
        for prec in ("f32", "f64"):
            self.k1(prec).argtypes = [P] * 7 + [I, I, D, D, P]
            self.k1(prec).restype = I
            self.k5(prec).argtypes = [P] * 7 + [I, I, I, I, D, D, P]
            self.k5(prec).restype = I

    def k1(self, prec):
        return getattr(self.lib, self.k1_name.format(prec=prec))

    def k5(self, prec):
        return getattr(self.lib, self.k5_name.format(prec=prec))


def _prec(t):
    import torch
    return "f32" if t.dtype == torch.float32 else "f64"


def _stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def call_k1(var, ins, outs, dx, dy):
    err = var.k1(_prec(ins[0]))(*[t.data_ptr() for t in (*ins, *outs)],
                                *ins[0].shape, dx, dy, _stream())
    if err:
        raise RuntimeError(f"{var.label}: K1 launch failed ({err})")


def call_k5(var, west, south, ins, outs, dx, dy):
    err = var.k5(_prec(ins[0]))(*[t.data_ptr() for t in (*ins, *outs)],
                                *outs[0].shape, int(west), int(south), dx,
                                dy, _stream())
    if err:
        raise RuntimeError(f"{var.label}: K5 launch failed ({err})")


def fields(rng, shape, dtype, dev):
    """u, v, nuH_e, nuH_n, beta at chip_smoke.py phase 1's scales."""
    import torch
    a = [rng.normal(size=shape) * 1e-5, rng.normal(size=shape) * 1e-5,
         rng.uniform(1e13, 1e16, size=shape),
         rng.uniform(1e13, 1e16, size=shape),
         rng.uniform(0.0, 1e10, size=shape)]
    return [torch.tensor(x, dtype=dtype, device=dev) for x in a]


def shard_blocks(x, mesh_shape, dev):
    """{(iy, ix): (west, south, (up, vp, nuHe, nuHn, beta))} of every shard."""
    from pism_tpu_torch.ops import sharded as S
    from pism_tpu_torch.parallel import make_mesh
    ny, nx = mesh_shape
    mesh = make_mesh([dev] * (ny * nx), mesh_shape)
    py, px = S._pad_amounts(x[0].shape, mesh)
    b = (S._blocks(x[:2], 2, mesh, py, px) + S._blocks(x[2:4], 1, mesh, py, px)
         + S._blocks(x[4:], 0, mesh, py, px))
    return {(iy, ix): (ix == 0, iy == 0, [f[iy][ix] for f in b])
            for iy in range(ny) for ix in range(nx)}


def run_k1(var, x):
    import torch
    out = (torch.empty_like(x[0]), torch.empty_like(x[0]))
    call_k1(var, x, out, 20e3, 20e3)
    return out


def run_k5(var, shards):
    import torch
    res = {}
    for key, (west, south, ins) in shards.items():
        out = (torch.empty_like(ins[4]), torch.empty_like(ins[4]))
        call_k5(var, west, south, ins, out, 20e3, 20e3)
        res[key] = out
    return res


def check_bits(variants, parent, dev, rng):
    """Every variant's K1 and K5 against the parent's build (or, without
    one, against the first variant) and K5 against K1, to the bit; the
    source's Newton matvec against the parent's."""
    import torch
    import chip_smoke
    from pism_tpu_torch.ops.kernels import ssa_matvec as K
    ref = parent or variants[0]
    cases = 0
    for dtype in (torch.float64, torch.float32):
        for shape in K1_CASES:
            x = fields(rng, shape, dtype, dev)
            want = run_k1(ref, x)
            for var in variants:
                got = run_k1(var, x)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"K1 {var.label} {shape} {dtype} "
                                         f"differs from {ref.label}")
                cases += 1
        for shape, mesh_shape in K5_CASES:
            x = fields(rng, shape, dtype, dev)
            shards = shard_blocks(x, mesh_shape, dev)
            want = run_k5(ref, shards)
            whole = run_k1(ref, x)
            for var in variants:
                got = run_k5(var, shards)
                torch.cuda.synchronize()
                for key in got:
                    if not all(torch.equal(a, b)
                               for a, b in zip(got[key], want[key])):
                        raise AssertionError(
                            f"K5 {var.label} {shape} on {mesh_shape} shard "
                            f"{key} {dtype} differs from {ref.label}")
                # the shards' interiors put together give K1's whole field
                ny, nx = mesh_shape
                for k in range(2):
                    full = torch.cat([torch.cat([got[(iy, ix)][k]
                                                 for ix in range(nx)], 1)
                                      for iy in range(ny)], 0)
                    if not torch.equal(full[:shape[0], :shape[1]], whole[k]):
                        raise AssertionError(f"K5 {var.label} {shape} on "
                                             f"{mesh_shape} {dtype} != K1")
                cases += 1
        if parent is not None:
            for shape in ((141, 76), (561, 301)):
                args = chip_smoke._newton_args(rng, shape, dtype, dev)
                got = K.ssa_newton_matvec(*args, 20e3, 20e3)
                fn = getattr(parent.lib,
                             f"pism_ssa_newton_matvec_{_prec(args[0])}")
                fn.argtypes = [P] * 12 + [I, I, D, D, P]
                want = (torch.empty_like(args[0]), torch.empty_like(args[0]))
                if fn(*[t.data_ptr() for t in (*args, *want)], *shape, 20e3,
                      20e3, _stream()):
                    raise RuntimeError("parent Newton matvec launch failed")
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"Newton matvec {shape} {dtype} "
                                         "differs from the parent's")
                cases += 1
    print(f"bits: {cases} cases equal to {ref.label} to the bit "
          f"({len(variants)} variants; K1 at {K1_CASES}, K5 on every shard "
          f"of {K5_CASES}, float64 and float32"
          + ("; the Newton matvec at 141x76 and 561x301" if parent else "")
          + ")")


def device_us(fn, reps=200):
    """Mean device µs per call of the kernels in ``fn`` (the profiler's
    CUDA activity), or None if the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        total = sum(e.time_range.elapsed_us() for e in ev)
        if ev and total > 0:
            return total / reps
    return None


def time_variants(variants, dev, rng, rounds):
    """Print each variant's device µs at each of TIMED, float32: mean,
    min and max over the rounds."""
    import torch
    times = {label: {v.label: [] for v in variants} for label, _, _ in TIMED}
    setups = {}
    for label, shape, mesh_shape in TIMED:
        x = fields(rng, shape, torch.float32, dev)
        if mesh_shape is None:
            out = (torch.empty_like(x[0]), torch.empty_like(x[0]))
            setups[label] = lambda var, x=x, out=out: call_k1(
                var, x, out, 20e3, 20e3)
        else:
            _, _, ins = shard_blocks(x, mesh_shape, dev)[(1, 1)]
            out = (torch.empty_like(ins[4]), torch.empty_like(ins[4]))
            setups[label] = lambda var, ins=ins, out=out: call_k5(
                var, False, False, ins, out, 20e3, 20e3)
    for r in range(rounds):
        order = variants if r % 2 == 0 else variants[::-1]
        for label, _, _ in TIMED:
            for var in order:
                us = device_us(lambda: setups[label](var))
                times[label][var.label].append(us)
    for label, _, _ in TIMED:
        for var in variants:
            ts = [t for t in times[label][var.label] if t is not None]
            print(f"time: {label} {var.label}: "
                  + (f"mean {sum(ts) / len(ts):.3f} us, min {min(ts):.3f}, "
                     f"max {max(ts):.3f} over {len(ts)} rounds"
                     if ts else "not measured"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="an unpacked checkout of an earlier commit")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ssa_matvec_tiles: needs a CUDA card")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    src = ROOT / "pism_tpu_torch" / "csrc" / "ssa_matvec.cu"
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="ssa_matvec_tiles_",
                                        dir=ROOT / "build"))
    lib_new = tmp / "libnew.so"
    ptxas_report(_nvcc(src, lib_new, ("-Xptxas", "-v")), "source")
    _nvcc(ROOT / "scripts" / "ssa_matvec_study.cu", tmp / "libstudy.so",
          ("-I", str(src.parent)))
    lib_study = ctypes.CDLL(str(tmp / "libstudy.so"))
    variants = [Variant(f"{kind} {bx}x{by}", lib_study,
                        f"study_{kind}_{bx}x{by}_matvec_{{prec}}",
                        f"study_{kind}_{bx}x{by}_halo_{{prec}}")
                for kind in ("regs", "smem") for bx, by in SHAPES]
    variants.insert(0, Variant("source", ctypes.CDLL(str(lib_new)),
                               "pism_ssa_matvec_{prec}",
                               "pism_ssa_matvec_halo_{prec}"))
    parent = None
    if args.parent is not None:
        psrc = args.parent / "pism_tpu_torch" / "csrc" / "ssa_matvec.cu"
        lib_parent = tmp / "libparent.so"
        ptxas_report(_nvcc(psrc, lib_parent, ("-Xptxas", "-v")), "parent")
        parent = Variant("parent", ctypes.CDLL(str(lib_parent)),
                         "pism_ssa_matvec_{prec}",
                         "pism_ssa_matvec_halo_{prec}")

    rng = np.random.default_rng(20261017)
    check_bits(variants, parent, dev, rng)
    x = torch.zeros(1, device=dev)
    floor = device_us(lambda: x.zero_())
    print("launch floor: a one-element zero_() "
          + ("not measured" if floor is None else f"{floor:.3f} us")
          + " of device time")
    time_variants(([parent] if parent else []) + variants, dev, rng,
                  args.rounds)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
