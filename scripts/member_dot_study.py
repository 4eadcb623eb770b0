"""The member dot, dots and sum (``csrc/member_dot.cu``) on one CUDA card.

    python3 scripts/member_dot_study.py [--parent DIR] [--rounds N]

This script:

1. compiles ``pism_tpu_torch/csrc/member_dot.cu`` with ``-Xptxas -v`` and
   prints the registers, shared memory and spills of its kernels;
2. with ``--parent DIR`` (an unpacked checkout of an earlier commit whose
   ``member_dot.cu`` has the one-block-a-member C interface), builds that
   source too;
3. times, in float32 at the ensembles' shapes (100 x 141 x 76, the 20 km
   hybrid ensemble; 100 x 251 x 251, the 16 km Antarctic one; and 1 and 3
   members of each), the member dot, the member dots and the member sum
   (on 300 x 251 x 251, PICO's basin rows of 100 members): the kernel
   alone (the profiler's device time), one call through its binding (CUDA
   events around 200 back-to-back calls, host path included) and from a
   CUDA-graph replay; beside it its bound (bytes in and out over 3.35
   TB/s), its yardstick, the one PyTorch call for the same function
   (``torch.linalg.vecdot``, over the pairs of the dots for the member
   dots, and ``torch.sum``), and the
   parent's kernel on the same inputs (two or three of its dots for the
   dots, its ``ones_like`` and dot for the sum), in turns (parent, source,
   source, parent), ``--rounds`` times;
4. holds each result to the plain version (1e-5) and the source's members
   to their single launches to the bit;
5. breaks the host path of a launch down (``time.perf_counter`` over
   2,000 calls of each step on one member of 141 x 76, whose kernel takes
   less device time than the host path).

Everything it measures goes to standard output, beside the card's name and
power limit. It needs a CUDA card and ``nvcc``; it exits non-zero on any
difference.
"""

import argparse
import ctypes
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

DOT_SHAPES = ((100, 141, 76), (100, 251, 251), (3, 251, 251), (1, 251, 251),
              (3, 141, 76), (1, 141, 76))
DOTS_SHAPES = ((100, 141, 76), (100, 251, 251), (1, 251, 251))
SUM_SHAPES = ((300, 251, 251), (3, 251, 251))
P, I, Q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _nvcc(src, out, extra=()):
    from pism_tpu_torch.ops.kernels import _build
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def ptxas_report(src, tmp):
    log = _nvcc(src, pathlib.Path(tmp) / "ptxas.so", ("-Xptxas", "-v"))
    for line in log.splitlines():
        if "Compiling entry function" in line or "Used" in line \
                or "spill" in line:
            print(f"ptxas: {line.strip()}")


def parent_dot(src, tmp):
    """The parent's float32 member dot, (a0, b0, a1, b1) -> (B,), one block
    a member."""
    import torch
    lib_path = pathlib.Path(tmp) / "libparent_member_dot.so"
    _nvcc(src, lib_path)
    fn = ctypes.CDLL(str(lib_path)).pism_member_dot_f32
    fn.argtypes = [P] * 5 + [Q, I, P]
    fn.restype = I

    def dot(a, b):
        out = torch.empty(a[0].shape[0], dtype=a[0].dtype,
                          device=a[0].device)
        err = fn(a[0].data_ptr(), b[0].data_ptr(), a[1].data_ptr(),
                 b[1].data_ptr(), out.data_ptr(),
                 a[0].shape[1] * a[0].shape[2], a[0].shape[0],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent member dot failed ({err})")
        return out
    return dot


def host_breakdown(KD):
    """Host µs per call of each step of ``member_dot``'s path on one member
    of 141 x 76, and of ``torch.linalg.vecdot`` on the same pair."""
    import time
    import torch
    from pism_tpu_torch.ops.kernels import _build
    dev = torch.device("cuda", torch.cuda.current_device())
    shape = (1, 141, 76)
    x = tuple(torch.randn(shape, device=dev) for _ in range(2))
    y = tuple(torch.randn(shape, device=dev) for _ in range(2))
    KD.member_dot(x, y)
    B, n = 1, shape[1] * shape[2]
    out = torch.empty(B, device=dev)
    work = next(w for k, w in _build._WORK.items()
                if k[0] == "member_dot" and k[2] == B)
    fn = KD._FN["member_dot", "f32"]
    args = (x[0].data_ptr(), y[0].data_ptr(), x[1].data_ptr(),
            y[1].data_ptr(), out.data_ptr(), n, B, work.data_ptr())
    current, raw = _build._cuda_calls()
    stream = raw(dev.index)
    cpu = tuple(torch.zeros(shape) for _ in range(4))

    def context():
        with torch.cuda.device(dev.index):
            pass
    xy = torch.cat((x[0].flatten(1), x[1].flatten(1)), 1)
    yy = torch.cat((y[0].flatten(1), y[1].flatten(1)), 1)
    steps = (
        ("member_dot, the whole call", lambda: KD.member_dot(x, y)),
        ("member_dots (xx, xy), the whole call",
         lambda: KD.member_dots(x, y, None, ("xx", "xy"))),
        ("the checks (_check, on CPU tensors of the shape)",
         lambda: KD._check("member_dot", cpu, None)),
        ("torch.empty(B)", lambda: torch.empty(B, device=dev)),
        ("five data_ptr", lambda: (x[0].data_ptr(), y[0].data_ptr(),
                                   x[1].data_ptr(), y[1].data_ptr(),
                                   out.data_ptr())),
        ("the current device", current),
        ("the current stream (raw)", lambda: raw(dev.index)),
        ("the current stream (torch.cuda.current_stream)",
         lambda: torch.cuda.current_stream(dev.index).cuda_stream),
        ("a device context (torch.cuda.device)", context),
        ("the ctypes call, launch included", lambda: fn(*args, stream)),
        ("_build.launch of it (device, stream, call)",
         lambda: _build.launch(fn, "member_dot", dev.index, *args)),
        ("torch.linalg.vecdot", lambda: torch.linalg.vecdot(xy, yy)),
    )
    for label, step in steps:
        for _ in range(100):
            step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(2000):
            step()
        torch.cuda.synchronize()
        print(f"host: {label}: {(time.perf_counter() - t) / 2e-3:.2f} us "
              "a call")


def _same_bits(a, b):
    import torch
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    return torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype]))


def _device_us(fn, match, launches):
    us, ops = CS._device_profile(fn, 20, match)
    if us is None or round(ops * 20) != launches * 20:
        return "not measured"
    return f"{us:.2f} us"


def study(name, shape, call, plain, single, lib, lib_what, parent, rounds):
    """One case: checks, then times in turns. ``parent``: (call, kernel
    name, launches a call) or None."""
    import torch
    got = call()
    got = got if isinstance(got, tuple) else (got,)
    ref = plain()
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(CS._rel_err(g, r) for g, r in zip(got, ref))
    if not err <= 1e-5:
        raise AssertionError(f"{name} {shape}: rel err {err:.3e} > 1e-5")
    B = shape[0]
    for b in (0, B // 2, B - 1):
        one = single(b)
        one = one if isinstance(one, tuple) else (one,)
        if not all(_same_bits(g[b:b + 1], o) for g, o in zip(got, one)):
            raise AssertionError(f"{name} {shape}: member {b} differs from "
                                 "its single launch")
    if parent is not None:
        old = parent[0]()
        old = old if isinstance(old, tuple) else (old,)
        perr = max(CS._rel_err(g, r) for g, r in zip(got, old))
        print(f"{name} {shape}: the parent's result within {perr:.3e}")
    fields = 1 if name.startswith("member_sum") else 4
    nbytes = (fields * shape[1] * shape[2] + len(got)) * B * 4
    bound_ms, _ = CS._bound(nbytes, 0)
    lib_ms = CS._time_ms(lib, 200)
    lib_dev = CS._device_profile(lib, 20)[0]
    rows = []
    runs = {"source": (call, "member_sums_kernel", 1)}
    if parent is not None:
        runs["parent"] = parent
    for r in range(rounds):
        order = list(runs) if r % 2 == 0 else list(runs)[::-1]
        for who in order + order[::-1]:
            fn, match, n = runs[who]
            ev = CS._time_ms(fn, 200)
            dev = _device_us(fn, match, n)
            graph = CS._graph_us(fn)
            rows.append(f"{who} events {1e3 * ev:.2f} us, device {dev}, "
                        f"graph {graph:.2f} us")
    print(f"{name} {'x'.join(map(str, shape))} float32: bound "
          f"{1e3 * bound_ms:.2f} us ({nbytes} bytes); {lib_what} events "
          f"{1e3 * lib_ms:.2f} us, device "
          + ("not measured" if lib_dev is None else f"{lib_dev:.2f} us")
          + f"; rel err {err:.3e}; in turns: " + "; ".join(rows))
    torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    torch = CS._require_cuda()
    from pism_tpu_torch.ops.kernels import member_dot as KD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        ptxas_report(ROOT / "pism_tpu_torch/csrc/member_dot.cu", tmp)
        pdot = None if args.parent is None else parent_dot(
            args.parent / "pism_tpu_torch/csrc/member_dot.cu", tmp)
        KD.build()
        g = torch.Generator(device="cuda").manual_seed(16)
        dev = torch.device("cuda")

        def rand(shape, lo=None):
            if lo is not None:
                return torch.rand(shape, generator=g, device=dev) + lo
            return torch.randn(shape, generator=g, device=dev)

        def per(b, p):
            return tuple(f[b:b + 1] for f in p)

        pair = ("xx", "xy")   # the Krylov loop's pairs
        for shape in DOT_SHAPES:
            x = (rand(shape), rand(shape))
            y = (x[0] + 0.1 * rand(shape), x[1] + 0.1 * rand(shape))
            xy = torch.cat((x[0].flatten(1), x[1].flatten(1)), 1)
            yy = torch.cat((y[0].flatten(1), y[1].flatten(1)), 1)
            call = (lambda x=x, y=y: KD.member_dot(x, y))
            study("member_dot", shape, call,
                  lambda x=x, y=y: KD.member_dot_plain(x, y),
                  lambda b, x=x, y=y: KD.member_dot(per(b, x), per(b, y)),
                  lambda xy=xy, yy=yy: torch.linalg.vecdot(xy, yy),
                  "torch.linalg.vecdot",
                  None if pdot is None else (
                      lambda x=x, y=y: pdot(x, y), "member_dot_kernel", 1),
                  args.rounds)
        for shape in DOTS_SHAPES:
            x = (rand(shape), rand(shape))
            y = (x[0] + 0.1 * rand(shape), x[1] + 0.1 * rand(shape))
            # the pairs of the dots asked for, x.x and x.y, as (B, 2, 2N)
            xf = torch.cat((x[0].flatten(1), x[1].flatten(1)), 1)
            yf = torch.cat((y[0].flatten(1), y[1].flatten(1)), 1)
            L, R = torch.stack((xf, xf), 1), torch.stack((xf, yf), 1)
            call = (lambda x=x, y=y: KD.member_dots(x, y, None, pair))
            study("member_dots (xx, xy)", shape, call,
                  lambda x=x, y=y: KD.member_dots_plain(x, y, None, pair),
                  lambda b, x=x, y=y: KD.member_dots(per(b, x), per(b, y),
                                                     None, pair),
                  lambda L=L, R=R: torch.linalg.vecdot(L, R),
                  "torch.linalg.vecdot over the (B, 2, 2N) pairs",
                  None if pdot is None else (
                      lambda x=x, y=y: (pdot(x, x), pdot(x, y)),
                      "member_dot_kernel", 2),
                  args.rounds)
        for shape in SUM_SHAPES:
            x = rand(shape, 0.5)

            def parent_sum(x=x):
                ones = torch.ones_like(x)
                return 0.5 * pdot((x, x), (ones, ones))
            call = (lambda x=x: KD.member_sum(x))
            study("member_sum", shape, call,
                  lambda x=x: KD.member_sum_plain(x),
                  lambda b, x=x: KD.member_sum(x[b:b + 1]),
                  lambda x=x: torch.sum(x, dim=(-2, -1)), "torch.sum",
                  None if pdot is None else (parent_sum,
                                             "member_dot_kernel", 1),
                  args.rounds)
        host_breakdown(KD)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
