"""GPU smoke run of the PyTorch port (pism_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the kernels from ``pism_tpu_torch/csrc`` (one ``nvcc`` per
source, all started together) and holds each against its plain torch
version on the card, relative max-norm error:
  K1 ``ssa_matvec`` and ``ssa_matvec_jvp`` at the 20 km (141x76) and 5 km
  (301x561) grids, 1e-12 in float64 and 1e-5 in float32, and
  ``ssa_matvec`` at 9x33, 33x9 and 2x70, which no tile of its kernel
  divides; the Newton matvec
  ``ssa_newton_matvec`` there too, against its plain version (K1's
  tolerances) and against the composition it replaced on the card (the
  plain torch tangent, the fused JVP launch and the Dirichlet selects),
  asserted equal to the bit and timed beside it;
  K2b ``pcr_lines`` and K2 ``pcr_lines_sub`` on random diagonally dominant
  unit-diagonal systems, lines of n = 76, 141, 301, 561 over batches of 141,
  76, 561, 301, both layouts: the one-shot form (a factor and an apply
  launch) in both dtypes, and in float32 the apply launch alone (with the
  row scale) and the factor launch alone (unit diagonal implicit), all
  asserted equal to the bit; beside them ``torch.linalg.solve`` on the dense
  batched matrices, the one PyTorch call that solves the same systems;
  K3 ``sia_flux_thermo`` at 61x61x61, 141x76x41 and 561x301x41 (the
  three routes of its kernel) with E level-major (as the energy step
  leaves it, the path's layout) and contiguous, 1e-12 / 1e-4;
  K4 ``sia_flux`` at 61x61 and 601x601 on a dome with an ice-free margin,
  with and without a binding diffusivity cap, 1e-12 / 2e-5;
  for K3 and K4 the max of D from the launch against the faces' max,
  asserted equal to the bit;
  K5 ``ssa_matvec_halo``, ``ssa_matvec_halo_jvp`` and
  ``ssa_newton_matvec_halo``, per shard of a mesh of this one card, at
  142x76 and 561x301 on 2x2, 29x37 on 2x4, and 9x33 on 1x4 and 33x9 on
  4x1 (9x9 shards, smaller than one tile): one shard's launch against
  its plain version (K1's tolerances), and the whole sharded call (halo
  exchange, launches, gather; for the Newton matvec the direction's only,
  the frozen fields padded once) against the plain sharded call and
  against the unsharded kernel (asserted equal to the bit);
  K6, K3 per shard (61x61x61 on 2x2) and K4 per shard (601x601 on 2x2),
  against unsharded K3/K4 (asserted equal to the bit).
It times each with CUDA events and the profiler's device time and computes
its bound (the larger of its bytes over 3.35 TB/s and its operations over
67 TFLOP/s, float32); beside the bounds it prints the launch floor, the
device time of the smallest launch the card runs (a one-element
``zero_()``). Then it runs the 100 km chain with the PCR kernels for
one model year in float64 on the card and on the CPU (plain torch path) and
compares the two.

Every path below is driven through ``IceModel.step_once`` with the kernels'
launch counters set to 0 just before it and read just after:
  phase 2: the default config (``line_pcr_impl = xla``, plain torch PCR),
    20 km float32 for 2 model years (cut from 10 to keep the script's time);
  phase 2b: path A (``line_pcr_impl = pallas_sublane``), 20 km for 10 model
    years as two calls, 2 a then 8 a; after 2 a its steps and dt-limit hits
    equal phase 2's and the ice volume is within 2e-4. Then one
    preconditioner application, the kernels against ``xla``, on its state,
    the Newton matvec on the chain's own linearization against its plain
    version and the replaced composition, one Krylov iteration profiled
    with each preconditioner route, the Krylov iterations of one step
    profiled, one profiled step and a timed breakdown of 1 a;
  phase 3: path A at 5 km for 0.5 model years;
  phase 4: path B, EISMINT II A at 61x61x61 float32 from zero ice, 5000
    model years, then 2000 timed, a few steps profiled and a timed
    breakdown of 100 a; then 1000 more
    with ``sia.pallas = off`` against the same 1000 on K3;
  phase 5: path C, the isothermal SIA (Halfar test B, K4): (a) 61x61
    float64 for 1000 model years with ``sia.pallas = on``, the card against
    the CPU, and its errors against the exact solution; (b) 601x601 float32
    (3 km) under ``auto`` for 200 model years from t0, timed, then a few
    steps profiled and a timed breakdown of 2 a; (c) the same 200 a with ``sia.pallas = off`` against
    (b); (d) Halfar test C and the runner's letters A, D, H and L at 61x61
    float64 on the card, under the JAX package's test thresholds.

Every failure raises, so the script exits non-zero. Without a CUDA card it
exits non-zero before printing any result. The second-to-last line is the
JSON kernel record; the last line is the device record.
"""

import json
import math
import os
import subprocess
import sys
import time

SPY = 3.15569259747e7
PATH_A = {"stress_balance.ssa.fd.line_pcr_impl": "pallas_sublane"}
# one NVIDIA H100 SXM at its full power limit (NVIDIA's data sheet): device
# memory rate, and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# path C at full width: Halfar test B at 3 km over the 1800 km square
HALFAR_MX, HALFAR_YEARS = 601, 200.0
# operations of each kernel, counted from its plain version's arithmetic:
# per cell (K1, K1 JVP without a drag tangent, K4), per element and round
# of cyclic reduction (K2/K2b: 10 in the factor's a, b, c recurrences, 4 in
# the apply's d recurrence), per face and level of the softness integral
# plus per face (K3)
# (the Newton matvec: the JVP's 102, the tangent's 19 a face and 4 selects)
OPS = {"ssa_matvec": 52, "ssa_matvec_jvp": 102, "ssa_newton_matvec": 144,
       "pcr_factor_round": 10,
       "pcr_apply_round": 4, "sia_thermo_level": 37, "sia_thermo_face": 15,
       "sia_flux": 36}


def _require_cuda():
    # the script drives one card: show the process only the first one
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if visible is None \
        else visible.split(",")[0]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    return torch


def _rel_err(a, b):
    """max |a - b| / max |b| (b is the plain reference)."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_profile(fn, reps, match=None):
    """(device µs per call, device ops per call) from the profiler's CUDA
    activity, of the ops whose name contains ``match`` if given; (None,
    None) if the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):   # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and (match is None or match in e.name)]
        total = sum(e.time_range.elapsed_us() for e in dev)
        if dev and total > 0:
            return total / reps, len(dev) / reps
    return None, None


def _bound(nbytes, nops):
    """(ms, "bytes" or "operations"): the least time the card could take
    for a float32 function that moves ``nbytes`` and does ``nops``."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _counters():
    from pism_tpu_torch.ops.kernels import pcr, sia_iso, sia_thermo, ssa_matvec
    from pism_tpu_torch.util import hostsync
    return ((ssa_matvec, "LAUNCHES", "ssa_matvec"),
            (ssa_matvec, "JVP_LAUNCHES", "ssa_matvec_jvp"),
            (ssa_matvec, "HALO_LAUNCHES", "ssa_matvec_halo"),
            (ssa_matvec, "HALO_JVP_LAUNCHES", "ssa_matvec_halo_jvp"),
            (ssa_matvec, "NEWTON_LAUNCHES", "ssa_newton_matvec"),
            (ssa_matvec, "HALO_NEWTON_LAUNCHES", "ssa_newton_matvec_halo"),
            (pcr, "LAUNCHES", "pcr_lines"),
            (pcr, "SUB_LAUNCHES", "pcr_lines_sub"),
            (pcr, "FACTOR_LAUNCHES", "pcr_factor_lines"),
            (pcr, "SUB_FACTOR_LAUNCHES", "pcr_factor_lines_sub"),
            (sia_thermo, "LAUNCHES", "sia_flux_thermo"),
            (sia_iso, "LAUNCHES", "sia_flux"),
            (hostsync, "COUNT", "host_syncs"))


KERNELS = ("ssa_matvec", "ssa_matvec_jvp", "ssa_newton_matvec",
           "ssa_matvec_halo", "ssa_matvec_halo_jvp", "ssa_newton_matvec_halo",
           "pcr_lines", "pcr_lines_sub",
           "pcr_factor_lines", "pcr_factor_lines_sub",
           "sia_flux_thermo", "sia_flux")


def reset_counts():
    for mod, attr, _ in _counters():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr) for mod, attr, name in _counters()}


def _check_launches(label, counts, launched, idle):
    for name in launched:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: {name} was never launched")
    for name in idle:
        if counts[name] != 0:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 "times off its path")


def _kernel_case(name, kern, plain, args, tol, label, nops, reps=200,
                 match=None, nbytes=None, unpack=None):
    """Kernel against plain version on the same inputs, then both timed,
    and the kernel's bound from ``nbytes`` (by default the bytes of its
    tensor inputs and outputs, each counted once) and ``nops`` operations.
    ``match`` names the CUDA kernel, whose device time alone is printed
    too; ``unpack`` turns a result that is no tensor into the tensors to
    compare. Returns the kernel's record: events ms, plain events ms, max
    abs err, bound ms and what sets the bound."""
    import torch
    got = kern(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    if unpack is not None:
        got, ref = unpack(got), unpack(ref)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(_rel_err(g, r) for g, r in zip(got, ref) if g.numel())
    abs_err = max(float((g - r).abs().max())
                  for g, r in zip(got, ref) if g.numel())
    if not err <= tol:
        raise AssertionError(f"{name} {label}: relative error {err:.3e} > "
                             f"{tol:.0e}")
    if nbytes is None:
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*args, *got) if torch.is_tensor(t))
    bound_ms, bound_by = _bound(nbytes, nops)
    ms = _time_ms(lambda: kern(*args), reps)
    plain_ms = _time_ms(lambda: plain(*args), reps)
    dev_us, _ = _device_profile(lambda: kern(*args), 50)
    plain_us, plain_ops = _device_profile(lambda: plain(*args), 50)
    dev = "not measured" if dev_us is None or plain_us is None else (
        f"{dev_us:.2f} us / {plain_us:.2f} us in {plain_ops:.0f} ops")
    if match is not None:
        alone, _ = _device_profile(lambda: kern(*args), 50, match)
        dev += (", the kernel alone not measured" if alone is None
                else f", the kernel alone {alone:.2f} us")
    print(f"phase1: {name} {label} rel_err {err:.3e} (tol {tol:.0e}) events "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms; device {dev}; "
          f"bound {1e3 * bound_ms:.2f} us ({bound_by}: {nbytes} bytes, "
          f"{nops:.0f} operations)")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": abs_err,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _check_max(name, label, result):
    """The max_D of one SIA launch (De, Dn, qe, qn, max_D) against
    torch.maximum(torch.max(De), torch.max(Dn)) of its faces: equal to the
    bit."""
    import torch
    De, Dn, max_D = result[0], result[1], result[4]
    ref = torch.maximum(torch.max(De), torch.max(Dn))
    bits = torch.int32 if ref.dtype == torch.float32 else torch.int64
    same = bool(max_D.view(bits) == ref.view(bits))
    print(f"phase1: {name} {label}: max_D from the launch {float(max_D)!r}, "
          f"the faces' max {float(ref)!r}, equal to the bit {same}")
    if not same:
        raise AssertionError(f"{name} {label}: max_D differs from the faces' "
                             "max")


def _dense_solve_ms(a, c, d, sub, x, label):
    """ms of ``torch.linalg.solve`` on the dense batched matrices of the
    unit-diagonal line systems, the one PyTorch call that solves them (a
    yardstick: the port never calls it). ``sub``: the systems run along
    axis -2. Its solution must agree with the kernels' ``x`` to 1e-4."""
    import torch
    if sub:
        a, c, d, x = a.T, c.T, d.T, x.T
    A = (torch.diag_embed(torch.ones_like(d))
         + torch.diag_embed(a[:, 1:], offset=-1)
         + torch.diag_embed(c[:, :-1], offset=1))
    rhs = d.unsqueeze(-1).contiguous()
    err = _rel_err(torch.linalg.solve(A, rhs).squeeze(-1), x)
    if not err <= 1e-4:
        raise AssertionError(f"torch.linalg.solve {label}: {err:.3e} > 1e-4")
    ms = _time_ms(lambda: torch.linalg.solve(A, rhs), 5)
    print(f"phase1: torch.linalg.solve on {tuple(A.shape)} dense matrices "
          f"({'axis -2' if sub else 'last axis'} lines, {label}): events "
          f"{ms:.4f} ms, rel_err against the kernels {err:.3e}")
    return ms


def _newton_args(rng, shape, dtype, dev):
    """A frozen Newton system and a direction, as ``ssa_newton_matvec``
    takes them (u, v, du, dv, nuH_e, nuH_n, coef_e, coef_n, beta, bc):
    coefficients (a1, a2, a3, k) that give dnuH ~ 1e14 with k zero on a
    tenth of the faces (the icy-face mask), and a Dirichlet mask holding
    the grid's edges and a tenth of the cells."""
    import numpy as np
    import torch
    a = [rng.normal(size=shape) * s for s in (1e-5, 1e-5, 1e-6, 1e-6)]
    a += [rng.uniform(1e13, 1e16, size=shape) for _ in range(2)]
    for _ in range(2):
        c = rng.normal(size=(*shape, 4)) * 1e10
        c[..., 3] = rng.uniform(1e13, 1e15, size=shape) \
            * (rng.uniform(size=shape) > 0.1)
        a.append(c)
    a.append(rng.uniform(0.0, 1e10, size=shape))
    bc = rng.uniform(size=shape) < 0.1
    bc[0, :] = bc[-1, :] = bc[:, 0] = bc[:, -1] = True
    return tuple(torch.tensor(x, dtype=dtype, device=dev) for x in a) \
        + (torch.tensor(bc, device=dev),)


def _replaced_composition(u, v, du, dv, nuH_e, nuH_n, coef_e, coef_n, beta,
                          bc, dx, dy, mesh=None):
    """The Newton matvec as the parent composed it on the card: free the
    direction, the plain torch tangent, one fused JVP launch (per shard
    under ``mesh``), free, the Dirichlet rows."""
    import torch
    from pism_tpu_torch.ops import sharded as S
    from pism_tpu_torch.ops import ssa as ssa_ops
    from pism_tpu_torch.ops.kernels import ssa_matvec as K
    from pism_tpu_torch.ops.stencils import shift
    fu, fv = torch.where(bc, 0.0, du), torch.where(bc, 0.0, dv)
    dn = ssa_ops.NuHTangent(coef_e.unbind(-1), coef_n.unbind(-1), dx, dy,
                            shift)(fu, fv)
    jvp_args = (u, v, fu, fv, nuH_e, nuH_n, dn.e, dn.n, beta, None)
    Ju, Jv = (K.ssa_matvec_jvp(*jvp_args, dx, dy) if mesh is None
              else S.ssa_matvec_sharded_jvp(*jvp_args, mesh, dx, dy))
    return (torch.where(bc, 0.0, Ju) + torch.where(bc, du, 0.0),
            torch.where(bc, 0.0, Jv) + torch.where(bc, dv, 0.0))


def _check_replaced(name, label, got, args, mesh=None):
    """``got`` against the replaced composition on the same inputs: equal
    to the bit; both timed (CUDA events, the profiler's device time)."""
    import torch
    ref = _replaced_composition(*args, mesh=mesh)
    torch.cuda.synchronize()
    same = all(torch.equal(g, r) for g, r in zip(got, ref))
    diff = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    ms = _time_ms(lambda: _replaced_composition(*args, mesh=mesh), 50)
    print(f"phase1: {name} {label}: the replaced composition (plain tangent, "
          f"{'ssa_matvec_jvp' if mesh is None else 'ssa_matvec_sharded_jvp'}"
          f", selects) events {ms:.4f} ms, device "
          f"{_us(lambda: _replaced_composition(*args, mesh=mesh))}; equal to "
          f"it to the bit {same} (max |diff| {diff:.3e})")
    if not same:
        raise AssertionError(f"{name} {label}: differs from the composition "
                             f"it replaces by {diff:.3e}")


def _newton_case(label, args, tol):
    """The Newton matvec against its plain version (``_kernel_case``) and
    against the composition it replaces; returns the kernel's record."""
    from pism_tpu_torch.ops.kernels import ssa_matvec as K
    r = _kernel_case("ssa_newton_matvec", K.ssa_newton_matvec,
                     K.ssa_newton_matvec_plain, args, tol, label,
                     OPS["ssa_newton_matvec"] * args[0].numel(),
                     match="newton")
    _check_replaced("ssa_newton_matvec", label, K.ssa_newton_matvec(*args),
                    args)
    return r


def phase1_kernels(dev):
    """Every kernel against its plain version at the paths' shapes; returns
    {kernel name: record of ``_kernel_case``} at the 20 km f32 shapes (K3:
    EISMINT II's 61x61x61 f32; K4: path C's 601x601 f32)."""
    import numpy as np
    import torch
    import pism_tpu_torch as pt
    from pism_tpu_torch.ops.kernels import _build
    from pism_tpu_torch.ops.kernels import pcr as K2
    from pism_tpu_torch.ops.kernels import sia_iso as K4
    from pism_tpu_torch.ops.kernels import sia_thermo as K3
    from pism_tpu_torch.ops.kernels import ssa_matvec as K
    from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter
    from pism_tpu_torch.physics.rheology import PatersonBudd
    from pism_tpu_torch.verification import halfar

    t0 = time.time()
    _build.build("ssa_matvec", "pcr", "sia_thermo", "sia_iso")
    print(f"phase1: built ssa_matvec, pcr, sia_thermo, sia_iso in "
          f"{time.time() - t0:.1f} s")
    one = torch.zeros(1, device=dev)
    floor_us, _ = _device_profile(one.zero_, 50)
    print("phase1: launch floor, the device time of the smallest launch the "
          "card runs (a one-element zero_()), for information beside the "
          "bounds: " + ("not measured" if floor_us is None
                        else f"{floor_us:.3f} us"))
    out = {}
    rng = np.random.default_rng(20240601)
    tols = ((torch.float64, 1e-12), (torch.float32, 1e-5))

    # K1 and the Newton matvec -----------------------------------------
    nrng = np.random.default_rng(20261016)
    for (My, Mx), km in (((141, 76), 20), ((561, 301), 5)):
        dx = dy = km * 1e3
        arrs = {k: rng.normal(size=(My, Mx)) * 1e-5
                for k in ("u", "v", "du", "dv")}
        arrs["nuH_e"] = rng.uniform(1e13, 1e16, size=(My, Mx))
        arrs["nuH_n"] = rng.uniform(1e13, 1e16, size=(My, Mx))
        arrs["dnuH_e"] = rng.normal(size=(My, Mx)) * 1e14
        arrs["dnuH_n"] = rng.normal(size=(My, Mx)) * 1e14
        arrs["beta"] = rng.uniform(0.0, 1e10, size=(My, Mx))
        for dtype, tol in tols:
            t = {k: torch.tensor(a, dtype=dtype, device=dev)
                 for k, a in arrs.items()}
            mv = (t["u"], t["v"], t["nuH_e"], t["nuH_n"], t["beta"], dx, dy)
            jv = (t["u"], t["v"], t["du"], t["dv"], t["nuH_e"], t["nuH_n"],
                  t["dnuH_e"], t["dnuH_n"], t["beta"], None, dx, dy)
            for name, kern, plain, args in (
                    ("ssa_matvec", K.ssa_matvec, K.ssa_matvec_plain, mv),
                    ("ssa_matvec_jvp", K.ssa_matvec_jvp,
                     K.ssa_matvec_jvp_plain, jv)):
                r = _kernel_case(name, kern, plain, args, tol,
                                 f"{My}x{Mx} {str(dtype)[6:]}",
                                 OPS[name] * My * Mx,
                                 match="ssa_matvec_tile"
                                 if name == "ssa_matvec" else None)
                if km == 20 and dtype == torch.float32:
                    out[name] = r
            r = _newton_case(f"{My}x{Mx} {str(dtype)[6:]}",
                             _newton_args(nrng, (My, Mx), dtype, dev)
                             + (dx, dy), tol)
            if km == 20 and dtype == torch.float32:
                out["ssa_newton_matvec"] = r
    # K1 at shapes that no tile of its kernel divides: narrower or shorter
    # than one tile, ragged on either axis
    rrng = np.random.default_rng(20261018)
    for My, Mx in ((9, 33), (33, 9), (2, 70)):
        arrs = [rrng.normal(size=(My, Mx)) * 1e-5 for _ in range(2)] \
            + [rrng.uniform(1e13, 1e16, size=(My, Mx)) for _ in range(2)] \
            + [rrng.uniform(0.0, 1e10, size=(My, Mx))]
        for dtype, tol in tols:
            mv = [torch.tensor(a, dtype=dtype, device=dev) for a in arrs]
            _kernel_case("ssa_matvec", K.ssa_matvec, K.ssa_matvec_plain,
                         (*mv, 20e3, 20e3), tol,
                         f"{My}x{Mx} {str(dtype)[6:]}",
                         OPS["ssa_matvec"] * My * Mx, reps=50,
                         match="ssa_matvec_tile")

    # K2 / K2b: (n, batch) of the u-lines (lanes) and v-lines (sub): the
    # one-shot form in both dtypes, then in float32 the apply launch alone
    # (unit diagonal implicit, with the row scale: the path's call) and the
    # factor launch alone, all equal to the bit (tolerance 0) ------------
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    for n, batch in ((76, 141), (141, 76), (301, 561), (561, 301)):
        a = rng.uniform(-0.45, 0.0, size=(n, batch))
        c = rng.uniform(-0.45, 0.0, size=(n, batch))
        d = rng.normal(size=(n, batch))
        scale = rng.uniform(0.5, 2.0, size=(n, batch))
        rounds = math.ceil(math.log2(n))
        for dtype in (torch.float64, torch.float32):
            sub = [torch.tensor(x, dtype=dtype, device=dev)
                   for x in (a, np.ones((n, batch)), c, d, scale)]
            lanes = [x.T.contiguous() for x in sub]
            label = f"n={n} batch={batch} {str(dtype)[6:]}"
            nops = (OPS["pcr_factor_round"] + OPS["pcr_apply_round"]) \
                * n * batch * rounds
            _kernel_case("pcr_lines_sub", K2.pcr_lines_sub,
                         K2.pcr_lines_sub_plain, sub[:4], 0.0, label, nops)
            _kernel_case("pcr_lines", K2.pcr_lines, K2.pcr_lines_plain,
                         lanes[:4], 0.0, label, nops)
            if dtype != torch.float32:
                continue
            field = n * batch * sub[0].element_size()
            for name, ts, make, make_plain, shape20 in (
                    ("pcr_lines_sub", sub, K2.pcr_factor_lines_sub,
                     K2.pcr_factor_lines_sub_plain, (141, 76)),   # v-lines
                    ("pcr_lines", lanes, K2.pcr_factor_lines,
                     K2.pcr_factor_lines_plain, (76, 141))):      # u-lines
                ta, _, tc, td, ts_ = ts
                f, fp = make(ta, None, tc), make_plain(ta, None, tc)
                # the function's own bytes: a, c, scale and r in, x out
                r = _kernel_case(
                    name, lambda r_, s_: K2.pcr_apply(f, r_, s_),
                    lambda r_, s_: K2.pcr_apply_plain(fp, r_, s_), (td, ts_),
                    0.0, f"apply {label}",
                    (OPS["pcr_apply_round"] * rounds + 2) * n * batch,
                    match="pcr_apply_kernel", nbytes=5 * field)
                # the same launch after 256 MB of other writes, which
                # leave none of the factor's table in the 50 MB L2
                def cold():
                    flush.zero_()
                    K2.pcr_apply(f, td, ts_)
                cold_us, _ = _device_profile(cold, 30, "pcr_apply_kernel")
                print(f"phase1: {name} apply {label}: the kernel alone after "
                      "256 MB of other writes "
                      + ("not measured" if cold_us is None
                         else f"{cold_us:.2f} us"))
                lib_ms = _dense_solve_ms(ta, tc, td / ts_,
                                         name == "pcr_lines_sub",
                                         K2.pcr_apply(f, td, ts_), label)
                if (n, batch) == shape20:
                    out[name] = {**r, "library_ms": lib_ms}
                fname = name.replace("pcr_", "pcr_factor_")
                r = _kernel_case(
                    fname, lambda a_, c_: make(a_, None, c_),
                    lambda a_, c_: make_plain(a_, None, c_), (ta, tc), 0.0,
                    f"{label}; table {f.table.numel() * 4} bytes",
                    OPS["pcr_factor_round"] * rounds * n * batch,
                    match="pcr_factor_kernel",
                    nbytes=2 * field + f.table.numel() * 4,
                    unpack=lambda f_: f_.coefficients())
                if (n, batch) == shape20:
                    out[fname] = r

    # K3 ---------------------------------------------------------------
    EC = EnthalpyConverter()
    # 61^3 and 141x76x41 take the level kernel (narrow and wide blocks),
    # 561x301x41 the column kernel
    for (My, Mx, Mz), Lz, km in (((61, 61, 61), 5000.0, 25),
                                 ((141, 76, 41), 4000.0, 20),
                                 ((561, 301, 41), 4000.0, 5)):
        Y, X = np.meshgrid(np.linspace(-1, 1, My), np.linspace(-1, 1, Mx),
                           indexing="ij")
        H = np.maximum(3000.0 * (1.0 - X ** 2 - Y ** 2), 0.0)
        s = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
        E = 1.0e5 + rng.uniform(0.0, 8e4, size=(My, Mx, Mz))
        z = pt.Grid(Mx=Mx, My=My, Lx=1e5, Ly=1e5, Mz=Mz, Lz=Lz).z
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
            args = [torch.tensor(x, dtype=dtype, device=dev)
                    for x in (H, s, E, z)]
            # E as the energy step leaves it: (Mz, My, Mx) in memory
            lm = args[2].movedim(-1, 0).contiguous().movedim(0, -1)
            kw = dict(enhancement=1.0, dx=km * 1e3, dy=km * 1e3, EC=EC,
                      pb_law=PatersonBudd(EC=EC))
            for layout, E_ in (("level-major", lm), ("contiguous", args[2])):
                a = [args[0], args[1], E_, args[3]]
                label = f"{My}x{Mx}x{Mz} {str(dtype)[6:]} E {layout}"
                r = _kernel_case(
                    "sia_flux_thermo",
                    lambda *x: K3.sia_flux_thermo(*x, **kw)[:4],
                    lambda *x: tuple(K3.sia_flux_thermo_plain(*x, **kw)[i]
                                     for i in (2, 3, 0, 1)),
                    a, tol, label,
                    2 * My * Mx * (OPS["sia_thermo_level"] * Mz
                                   + OPS["sia_thermo_face"]), reps=50)
                _check_max("sia_flux_thermo", label,
                           K3.sia_flux_thermo(*a, **kw))
                if Mz == 61 and dtype == torch.float32 \
                        and layout == "level-major":
                    out["sia_flux_thermo"] = r

    # K4: the Halfar dome at t0 (an ice-free margin around it) with surface
    # noise on the ice, at path C's spacing for each grid ----------------
    sol = halfar.test_B()
    for M in (61, HALFAR_MX):
        grid = pt.Grid(Mx=M, My=M, Lx=900e3, Ly=900e3)
        H = sol.thickness(sol.t0, grid.radius)
        s = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 2e-5)):
            args = [torch.tensor(x, dtype=dtype, device=dev) for x in (H, s)]
            for d_cap in (None, 0.5):
                kw = dict(A=halfar.A_SOFTNESS, dx=grid.dx, dy=grid.dy,
                          d_cap=d_cap)
                gam = K4.gamma(halfar.A_SOFTNESS)
                label = f"{M}x{M} {str(dtype)[6:]} d_cap={d_cap}"
                r = _kernel_case(
                    "sia_flux", lambda *x: K4.sia_flux(*x, **kw)[:4],
                    lambda *x: tuple(K4.sia_flux_plain(
                        *x, gamma=gam, dx=grid.dx, dy=grid.dy,
                        d_cap=d_cap)[i] for i in (2, 3, 0, 1)),
                    args, tol, label, OPS["sia_flux"] * M * M,
                    match="sia_iso_kernel")
                _check_max("sia_flux", label, K4.sia_flux(*args, **kw))
                if M == HALFAR_MX and dtype == torch.float32 and d_cap is None:
                    out["sia_flux"] = r
    out.update(phase1_sharded(dev, rng))
    return out


def _us(fn, reps=50):
    """'<device us> us in <ops> ops' of one call, from the profiler."""
    us, ops = _device_profile(fn, reps)
    return "not measured" if us is None else f"{us:.2f} us in {ops:.0f} ops"


def phase1_sharded(dev, rng):
    """K5 and K6 on meshes of the one card. K5: one shard's launch against
    its plain version (the record, at the 20 km f32 shard), then the whole
    sharded call against the plain sharded call (K1's tolerances) and
    against K1 on the whole field (equal to the bit), timed against K1's one
    launch. K6: K3 and K4 per shard against the unsharded kernels, equal
    to the bit."""
    import numpy as np
    import torch
    import pism_tpu_torch as pt
    from pism_tpu_torch.ops import sharded as S
    from pism_tpu_torch.ops.kernels import sia_iso as K4
    from pism_tpu_torch.ops.kernels import sia_thermo as K3
    from pism_tpu_torch.ops.kernels import ssa_matvec as K
    from pism_tpu_torch.parallel import make_mesh
    from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter
    from pism_tpu_torch.physics.rheology import PatersonBudd
    from pism_tpu_torch.verification import halfar

    out = {}
    nrng = np.random.default_rng(20261017)
    tols = ((torch.float64, 1e-12), (torch.float32, 1e-5))
    for (My, Mx), km, mshape in (((142, 76), 20, (2, 2)),
                                 ((561, 301), 5, (2, 2)),
                                 ((29, 37), 20, (2, 4)),
                                 ((9, 33), 20, (1, 4)),
                                 ((33, 9), 20, (4, 1))):
        ny, nx = mshape
        mesh = make_mesh([dev] * (ny * nx), mshape)
        py, px = S._pad_amounts((My, Mx), mesh)
        dx = dy = km * 1e3
        arrs = {k: rng.normal(size=(My, Mx)) * 1e-5
                for k in ("u", "v", "du", "dv")}
        arrs["nuH_e"] = rng.uniform(1e13, 1e16, size=(My, Mx))
        arrs["nuH_n"] = rng.uniform(1e13, 1e16, size=(My, Mx))
        arrs["dnuH_e"] = rng.normal(size=(My, Mx)) * 1e14
        arrs["dnuH_n"] = rng.normal(size=(My, Mx)) * 1e14
        arrs["beta"] = rng.uniform(0.0, 1e10, size=(My, Mx))
        for dtype, tol in tols:
            t = {k: torch.tensor(a, dtype=dtype, device=dev)
                 for k, a in arrs.items()}
            label = (f"{My}x{Mx} on {ny}x{nx} ({(My + py) // ny}x"
                     f"{(Mx + px) // nx} shards) {str(dtype)[6:]}")
            # the blocks of the last shard (its ghosts come from neighbours)
            b2 = S._blocks([t[k] for k in ("u", "v", "du", "dv")], 2, mesh,
                           py, px)
            b1 = S._blocks([t[k] for k in ("nuH_e", "nuH_n", "dnuH_e",
                                           "dnuH_n")], 1, mesh, py, px)
            b0 = S._blocks([t["beta"]], 0, mesh, py, px)
            up, vp, dup, dvp = (b[-1][-1] for b in b2)
            ne, nn, dne, dnn = (b[-1][-1] for b in b1)
            beta = b0[0][-1][-1]
            my, mx = beta.shape
            k1_mv = (t["u"], t["v"], t["nuH_e"], t["nuH_n"], t["beta"], dx, dy)
            k1_jv = (t["u"], t["v"], t["du"], t["dv"], t["nuH_e"], t["nuH_n"],
                     t["dnuH_e"], t["dnuH_n"], t["beta"], None, dx, dy)
            for name, kern, plain, args, whole, whole_plain, k1, k1_args in (
                    ("ssa_matvec_halo", K.ssa_matvec_halo,
                     K.ssa_matvec_halo_plain,
                     (nx == 1, ny == 1, up, vp, ne, nn, beta, dx, dy),
                     S.ssa_matvec_sharded, S.ssa_matvec_sharded_plain,
                     K.ssa_matvec, k1_mv),
                    ("ssa_matvec_halo_jvp", K.ssa_matvec_halo_jvp,
                     K.ssa_matvec_halo_jvp_plain,
                     (nx == 1, ny == 1, up, vp, dup, dvp, ne, nn, dne, dnn,
                      beta, None, dx, dy),
                     S.ssa_matvec_sharded_jvp, S.ssa_matvec_sharded_jvp_plain,
                     K.ssa_matvec_jvp, k1_jv)):
                base = "ssa_matvec" if name == "ssa_matvec_halo" \
                    else "ssa_matvec_jvp"
                r = _kernel_case(name, kern, plain, args, tol,
                                 f"one shard of {label}",
                                 OPS[base] * my * mx,
                                 match="ssa_matvec_tile" if base == "ssa_matvec"
                                 else "halo_jvp")
                if km == 20 and mshape == (2, 2) and dtype == torch.float32:
                    out[name] = r
                wargs = k1_args[:-2] + (mesh,) + k1_args[-2:]
                got, ref, one = whole(*wargs), whole_plain(*wargs), k1(*k1_args)
                torch.cuda.synchronize()
                err = max(_rel_err(g, q) for g, q in zip(got, ref))
                diff = max(float((g - q).abs().max()) for g, q in zip(got, one))
                ms = _time_ms(lambda: whole(*wargs), 100)
                ms1 = _time_ms(lambda: k1(*k1_args), 100)
                print(f"phase1: {name} {label}: the sharded call against the "
                      f"plain sharded call rel_err {err:.3e} (tol {tol:.0e}), "
                      f"max |K5 - K1| {diff:.3e}; events {ms:.4f} ms against "
                      f"K1 {ms1:.4f} ms; device {_us(lambda: whole(*wargs))} "
                      f"against K1 {_us(lambda: k1(*k1_args))}")
                if not err <= tol:
                    raise AssertionError(f"{name} {label}: sharded call "
                                         f"against its plain version {err:.3e}")
                if diff != 0.0:
                    raise AssertionError(f"{name} {label}: K5 differs from K1 "
                                         f"by {diff:.3e}")
            _newton_sharded(nrng, dev, mesh, (My, Mx), dtype, tol, label,
                            dx, dy, out if km == 20 and mshape == (2, 2)
                            and dtype == torch.float32 else {})

    # K6: K3 and K4 per shard of a 2x2 mesh against the unsharded kernels
    mesh = make_mesh([dev] * 4, (2, 2))
    EC = EnthalpyConverter()
    M, Mz = 61, 61
    Y, X = np.meshgrid(np.linspace(-1, 1, M), np.linspace(-1, 1, M),
                       indexing="ij")
    H = np.maximum(3000.0 * (1.0 - X ** 2 - Y ** 2), 0.0)
    sfc = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
    E = 1.0e5 + rng.uniform(0.0, 8e4, size=(M, M, Mz))
    z = pt.Grid(Mx=M, My=M, Lx=1e5, Ly=1e5, Mz=Mz, Lz=5000.0).z
    sol = halfar.test_B()
    grid = pt.Grid(Mx=HALFAR_MX, My=HALFAR_MX, Lx=900e3, Ly=900e3)
    Hh = sol.thickness(sol.t0, grid.radius)
    sh = Hh + rng.uniform(0.0, 5.0, size=Hh.shape) * (Hh > 0)
    for dtype in (torch.float64, torch.float32):
        a3 = [torch.tensor(x, dtype=dtype, device=dev) for x in (H, sfc, E, z)]
        kw3 = dict(enhancement=1.0, dx=25e3, dy=25e3, EC=EC,
                   pb_law=PatersonBudd(EC=EC), d_cap=None)
        a4 = [torch.tensor(x, dtype=dtype, device=dev) for x in (Hh, sh)]
        kw4 = dict(A=halfar.A_SOFTNESS, dx=grid.dx, dy=grid.dy, d_cap=None)
        for name, label, fields, whole, sharded in (
                ("sia_flux_thermo", f"{M}x{M}x{Mz}", a3[:3],
                 lambda: K3.sia_flux_thermo(*a3, **kw3),
                 lambda: S.sia_flux_thermo_sharded(*a3, mesh, **kw3)),
                ("sia_flux", f"{HALFAR_MX}x{HALFAR_MX}", a4,
                 lambda: K4.sia_flux(*a4, **kw4),
                 lambda: S.sia_flux_sharded(*a4, mesh, **kw4))):
            ref, got = whole(), sharded()
            torch.cuda.synchronize()
            same = all(torch.equal(g, q) for g, q in zip(got, ref))
            # one shard's launch: its one-ghost blocks in, four faces out
            blocks = [b[0][0] for b in S._blocks(
                fields, 1, mesh, *S._pad_amounts(fields[0].shape, mesh))]
            cells = blocks[0].numel()
            nbytes = (sum(b.numel() for b in blocks) + 4 * cells
                      + (Mz if name == "sia_flux_thermo" else 0)) \
                * blocks[0].element_size()
            nops = cells * (2 * (OPS["sia_thermo_level"] * Mz
                                 + OPS["sia_thermo_face"])
                            if name == "sia_flux_thermo" else OPS["sia_flux"])
            bound_ms, bound_by = _bound(nbytes, nops)
            print(f"phase1: K6 {name} {label} {str(dtype)[6:]} per shard of "
                  f"2x2 against unsharded: equal {same}; events "
                  f"{_time_ms(sharded, 50):.4f} ms against "
                  f"{_time_ms(whole, 50):.4f} ms; device {_us(sharded)} "
                  f"against {_us(whole)}; one shard's launch on "
                  f"{tuple(blocks[0].shape)} blocks bound "
                  f"{1e3 * bound_ms:.3f} us ({bound_by}: {nbytes} bytes, "
                  f"{nops} operations)")
            if not same:
                raise AssertionError(f"K6 {name} {label}: per-shard result "
                                     "differs from the unsharded kernel")
    return out


def _newton_sharded(rng, dev, mesh, shape, dtype, tol, label, dx, dy, out):
    """The Newton matvec per shard: the last shard's launch against its
    plain version (its record into ``out["ssa_newton_matvec_halo"]``), then one prepared system's matvec against
    the plain sharded one, the unsharded kernel and the replaced sharded
    composition (the last two equal to the bit), the preparation timed
    apart."""
    import torch
    from pism_tpu_torch.ops import sharded as S
    from pism_tpu_torch.ops.kernels import ssa_matvec as K
    args = _newton_args(rng, shape, dtype, dev)
    u, v, du, dv, ne, nn, ce, cn, beta, bc = args
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    py, px = S._pad_amounts(shape, mesh)
    two = [b[-1][-1] for b in S._blocks((u, v, du, dv, bc), 2, mesh, py, px)]
    one = [b[-1][-1] for b in S._blocks((ne, nn, ce, cn), 1, mesh, py, px)]
    b0 = S._blocks((beta,), 0, mesh, py, px)[0][-1][-1]
    r = _kernel_case("ssa_newton_matvec_halo", K.ssa_newton_matvec_halo,
                     K.ssa_newton_matvec_halo_plain,
                     (nx == 1, ny == 1, *two[:4], *one, b0, two[4], dx, dy),
                     tol, f"one shard of {label}",
                     OPS["ssa_newton_matvec"] * b0.numel(), match="newton")
    out["ssa_newton_matvec_halo"] = r
    frozen = (u, v, ne, nn, ce, cn, beta, bc)
    mv = S.ssa_newton_matvec_sharded(*frozen, mesh, dx, dy)
    got = mv(du, dv)
    ref = S.ssa_newton_matvec_sharded_plain(*frozen, mesh, dx, dy)(du, dv)
    whole = K.ssa_newton_matvec(*args, dx, dy)
    torch.cuda.synchronize()
    err = max(_rel_err(g, q) for g, q in zip(got, ref))
    same = all(torch.equal(g, w) for g, w in zip(got, whole))
    print(f"phase1: ssa_newton_matvec_halo {label}: the sharded matvec "
          f"against the plain sharded one rel_err {err:.3e} (tol {tol:.0e}),"
          f" equal to the unsharded kernel {same}; events per matvec "
          f"{_time_ms(lambda: mv(du, dv), 100):.4f} ms against the unsharded"
          f" {_time_ms(lambda: K.ssa_newton_matvec(*args, dx, dy), 100):.4f}"
          f" ms, the preparation once per sweep "
          f"{_time_ms(lambda: S.ssa_newton_matvec_sharded(*frozen, mesh, dx, dy), 20):.4f}"
          f" ms; device per matvec {_us(lambda: mv(du, dv))}, the "
          f"preparation {_us(lambda: S.ssa_newton_matvec_sharded(*frozen, mesh, dx, dy))}")
    if not err <= tol or not same:
        raise AssertionError(f"ssa_newton_matvec_halo {label}: sharded "
                             f"{err:.3e} from plain, equal to unsharded "
                             f"{same}")
    _check_replaced("ssa_newton_matvec_halo", label, got, (*args, dx, dy),
                    mesh)


def check_newton_matvec(model, state, t):
    """The Newton matvec on the 20 km chain's own linearization at the
    state's velocity (coefficients across float32's range), a random
    direction of the velocity's size: the kernel against its plain version
    and against the composition it replaces."""
    import torch
    tau_c = model.yield_stress.compute(state, t=t)
    P = model.ssa.build_problem(state, tau_c)
    u, v = P["free"]((state.u_ssa, state.v_ssa))
    nuH, coefs = P["linearize_nuH"](u, v)
    g = torch.Generator(device=u.device).manual_seed(11)
    d = tuple(torch.randn(u.shape, generator=g, device=u.device,
                          dtype=u.dtype) * u.abs().max() for _ in range(2))
    spans = []
    for face, c in zip("en", coefs):
        for k, name in enumerate(("a1", "a2", "a3", "k")):
            a = c[..., k].abs()
            spans.append(f"{name}_{face} {float(a[a > 0].min()):.1e}.."
                         f"{float(a.max()):.1e}")
    print(f"phase2b: the chain's tangent coefficients (nonzero |.|): "
          + ", ".join(spans))
    _newton_case("on the 20 km chain's linearization",
                 (u, v, *d, nuH.e, nuH.n, *coefs, P["beta_fn"](u, v),
                  P["bc_mask"], model.grid.dx, model.grid.dy), 1e-5)


def phase1_chain_reference(dev):
    """The 100 km chain on path A, one model year in float64: the card
    (kernels) against the CPU (plain torch path) on identical inputs."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.convert import state_to_numpy

    runs = {}
    for where in ("cpu", dev):
        model, state, _ = setups.hybrid_greenland_model(
            "float64", 100.0, device=where, extra_cfg=PATH_A)
        state, t, stats = model.step_once(state, 0.0, SPY)
        runs[str(where)] = (state_to_numpy(state), stats.nsteps)
    (a, na), (b, nb) = runs["cpu"], runs[str(dev)]
    if na != nb:
        raise AssertionError(f"100 km chain: {nb} steps on the card, {na} on cpu")
    H_err = float(abs(a["ice_thickness"] - b["ice_thickness"]).max()
                  / abs(a["ice_thickness"]).max())
    vol_err = abs(float(a["ice_thickness"].sum()) - float(b["ice_thickness"].sum())) \
        / float(a["ice_thickness"].sum())
    print(f"phase1: 100 km chain (path A) 1 a float64, card vs cpu: steps {nb} "
          f"H max err {H_err:.3e} of max H, volume rel err {vol_err:.3e}")
    # the SSA solve amplifies roundoff (a 1e-15 input change moves u by
    # ~1e-5), so H agrees to ~1e-6 of max H and the volume to ~1e-9
    if not (H_err < 1e-5 and vol_err < 1e-8):
        raise AssertionError("100 km chain: card and cpu disagree")


def _check_hybrid_state(label, state, grid, stats, t, t_want):
    import torch
    fields = {"ice_thickness": state.geometry.ice_thickness,
              "enthalpy": state.enthalpy, "u_ssa": state.u_ssa,
              "v_ssa": state.v_ssa, "basal_melt_rate": state.basal_melt_rate}
    for name, f in fields.items():
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    if tuple(state.enthalpy.shape) != grid.shape3:
        raise AssertionError(f"{label}: enthalpy shape {tuple(state.enthalpy.shape)}")
    if stats.nsteps <= 0 or abs(t - t_want) > 1e-3:
        raise AssertionError(f"{label}: {stats.nsteps} steps reached t = {t}")


def _report(label, grid, years, stats, wall, counts, H):
    n = stats.nsteps
    volume = float(H.double().sum()) * grid.dx * grid.dy
    print(f"{label}: grid {grid.My}x{grid.Mx}x{grid.Mz} {str(H.dtype)[6:]}, "
          f"{years} a: steps {n}, wall {wall:.3f} s, {1e3 * wall / n:.2f} ms/step, "
          f"Newton sweeps {stats.ssa_newton_iters} ({stats.ssa_newton_iters / n:.2f}/step), "
          f"Krylov its {stats.ssa_krylov_iters} ({stats.ssa_krylov_iters / n:.2f}/step), "
          f"host syncs {stats.host_syncs} ({stats.host_syncs / n:.1f}/step), "
          f"launches {counts}, dt-limit hits {stats.limit_hits_dict()}, "
          f"ice volume {volume:.6e} m^3, max H {float(H.max()):.2f} m")
    return volume


def run_hybrid(dev, km, segments, label, extra_cfg, launched, idle):
    """The hybrid chain through consecutive step_once calls of
    ``segments`` model years each; returns (model, state, t, [(stats,
    wall, volume) per segment], counts)."""
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.model.icemodel import _merge_stats

    model, state, grid = setups.hybrid_greenland_model(
        "float32", km, device=dev, extra_cfg=extra_cfg)
    torch.cuda.synchronize()
    reset_counts()
    t, out, total, wall_total = 0.0, [], None, 0.0
    for years in segments:
        t0 = time.time()
        state, t, stats = model.step_once(state, t, years * SPY)
        torch.cuda.synchronize()
        wall = time.time() - t0
        total, wall_total = _merge_stats(total, stats), wall_total + wall
        out.append((stats, wall, float(state.geometry.ice_thickness.double().sum())
                    * grid.dx * grid.dy))
        if len(segments) > 1:
            print(f"{label}: segment of {years} a: steps {stats.nsteps}, wall "
                  f"{wall:.3f} s, {1e3 * wall / stats.nsteps:.2f} ms/step, "
                  f"Krylov its {stats.ssa_krylov_iters}")
    counts = read_counts()
    _check_hybrid_state(label, state, grid, total, t, sum(segments) * SPY)
    _check_launches(label, counts, launched, idle)
    _report(label, grid, sum(segments), total, wall_total, counts,
            state.geometry.ice_thickness)
    return model, state, t, out, counts


def check_preconditioner(model, state, t):
    """One preconditioner application on the chain's own nuH and beta:
    the PCR kernels (pallas_sublane) against the plain torch PCR (xla)."""
    import torch
    from pism_tpu_torch.ops import ssa as ssa_ops

    tau_c = model.yield_stress.compute(state, t=t)
    P = model.ssa.build_problem(state, tau_c)
    u, v = P["free"]((state.u_ssa, state.v_ssa))
    nuH, beta = P["make_nuH"](u, v), P["beta_fn"](u, v)
    g = torch.Generator(device=state.u_ssa.device).manual_seed(7)
    r = tuple(torch.randn(u.shape, generator=g, device=u.device, dtype=u.dtype)
              for _ in range(2))
    pre = {impl: ssa_ops.make_line_preconditioner(
        nuH, beta, P["bc_mask"], model.grid.dx, model.grid.dy, model.sh, impl)
        for impl in ("xla", "pallas_sublane")}
    got, ref = pre["pallas_sublane"](r), pre["xla"](r)
    torch.cuda.synchronize()
    err = max(_rel_err(a, b) for a, b in zip(got, ref))
    if not err <= 1e-5:
        raise AssertionError(f"preconditioner: pallas_sublane against xla "
                             f"relative error {err:.3e} > 1e-5")
    line = []
    for impl in ("xla", "pallas_sublane"):
        ms = _time_ms(lambda: pre[impl](r), 50)
        dev_us, ops = _device_profile(lambda: pre[impl](r), 20)
        line.append(f"{impl} {ms:.4f} ms, device {dev_us:.2f} us in "
                    f"{ops:.0f} ops" if dev_us is not None else
                    f"{impl} {ms:.4f} ms, device not measured")
    print(f"phase2b: preconditioner on the 20 km state at the end of the run, "
          f"pallas_sublane vs xla rel_err {err:.3e} (tol 1e-5); "
          + "; ".join(line))


def profile_steps(model, state, t, years, label):
    """Steps under the profiler's CUDA activity: device ops (launches),
    device time and the busy share of the profiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, _, stats = model.step_once(state, t, years * SPY)
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    n = stats.nsteps
    print(f"{label}: profiled {n} step(s): {len(dev)} device ops "
          f"({len(dev) / n:.0f} per step), Krylov its "
          f"{stats.ssa_krylov_iters}, device time {busy:.1f} ms of "
          f"{1e3 * wall:.1f} ms profiled wall, busy share "
          f"{busy / (1e3 * wall):.3f}")


def _patched(targets, wrap):
    """Context: each (object, attribute) in ``targets`` replaced by
    ``wrap(label, original)`` for the duration."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
        try:
            for (obj, name, label), (_, _, orig) in zip(targets, saved):
                setattr(obj, name, wrap(label, orig))
            yield
        finally:
            for obj, name, orig in saved:
                setattr(obj, name, orig)
    return ctx()


def breakdown(model, state, t, years, label):
    """Inclusive ms per step of the step's components, from host timers
    around each call with the card synchronised on entry and exit (the
    synchronisation itself lengthens the step a little)."""
    import torch
    from pism_tpu_torch.ops import ssa as ssa_ops

    targets = [(model.stress_balance, "update", "stress balance"),
               (model, "_mass_substep", "mass transport")]
    if model.energy_model is not None:
        targets += [(model.energy_model, "step", "energy")]
    if model.ssa is not None:
        targets += [(model.ssa, "solve", "SSA solve"),
                    (ssa_ops, "bicgstab_solve", "BiCGStab"),
                    (model.surface, "update", "surface (PDD)"),
                    (model.calving, "step", "calving")]
    acc = {lab: 0.0 for _, _, lab in targets}

    def wrap(lab, orig):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            acc[lab] += time.perf_counter() - t0
            return out
        return timed

    with _patched(targets, wrap):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, stats = model.step_once(state, t, years * SPY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = stats.nsteps
    parts = ", ".join(f"{lab} {1e3 * v / n:.1f}" for lab, v in acc.items())
    print(f"{label}: timed {n} steps, {1e3 * wall / n:.1f} ms/step "
          f"(Krylov its {stats.ssa_krylov_iters / n:.1f}/step); inclusive "
          f"ms/step: {parts}")


def profile_bicgstab(model, state, t, years, label):
    """Device ops per Krylov iteration inside the chain's own Newton
    solves: each BiCGStab call of the steps runs under the profiler.
    Returns (device ops, device us, profiled host ms) per iteration."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pism_tpu_torch.ops import ssa as ssa_ops

    acc = {"ops": 0, "its": 0, "us": 0.0, "host": 0.0}

    def wrap(lab, orig):
        def profiled(*a, **k):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = orig(*a, **k)
                torch.cuda.synchronize()
                acc["host"] += time.perf_counter() - t0
            dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            acc["ops"] += len(dev)
            acc["us"] += sum(e.time_range.elapsed_us() for e in dev)
            acc["its"] += out[1]
            return out
        return profiled

    with _patched([(ssa_ops, "bicgstab_solve", "BiCGStab")], wrap):
        model.step_once(state, t, years * SPY)
    k = max(acc["its"], 1)
    print(f"{label}: inside the Newton solves: {acc['its']} Krylov its, "
          f"{acc['ops'] / k:.0f} device ops and {acc['us'] / k:.1f} us of "
          f"device time per Krylov it, {1e3 * acc['host'] / k:.3f} ms of "
          f"profiled host time per Krylov it")
    return acc["ops"] / k, acc["us"] / k, 1e3 * acc["host"] / k


def profile_krylov(model, state, t):
    """Device ops, device time and host time per BiCGStab iteration on the
    chain's frozen Picard system, with each preconditioner route: the
    difference between solves capped at 21 and at 1 iterations (rtol 0)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pism_tpu_torch.ops import ssa as ssa_ops

    tau_c = model.yield_stress.compute(state, t=t)
    P = model.ssa.build_problem(state, tau_c)
    bc = P["bc_mask"]
    u, v = P["free"]((state.u_ssa, state.v_ssa))
    nuH, beta = P["make_nuH"](u, v), P["beta_fn"](u, v)

    def matvec(x):
        Au, Av = P["apply"](*P["free"](x), nuH, beta)
        return torch.where(bc, x[0], Au), torch.where(bc, x[1], Av)

    b = P["free"]((P["bx"], P["by"]))
    x0 = (torch.zeros_like(b[0]), torch.zeros_like(b[1]))
    for impl in ("xla", "pallas_sublane"):
        pre = ssa_ops.make_line_preconditioner(
            nuH, beta, bc, model.grid.dx, model.grid.dy, model.sh, impl)
        res = {}
        for k in (1, 21):
            ssa_ops.bicgstab_solve(matvec, b, x0, pre, rtol=0.0, max_iter=k)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                _, its, _ = ssa_ops.bicgstab_solve(matvec, b, x0, pre,
                                                   rtol=0.0, max_iter=k)
                torch.cuda.synchronize()
                wall = time.time() - t0
            dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            res[k] = (its, len(dev), sum(e.time_range.elapsed_us() for e in dev),
                      wall)
        (i1, n1, d1, w1), (i21, n21, d21, w21) = res[1], res[21]
        m = max(i21 - i1, 1)
        print(f"phase2b: one Krylov iteration ({impl}) on the 20 km frozen "
              f"Picard system: {(n21 - n1) / m:.0f} device ops, device "
              f"{(d21 - d1) / m:.1f} us, profiled host {1e3 * (w21 - w1) / m:.3f} "
              f"ms ({i21} - {i1} iterations)")


def phase4_eismint(dev):
    """Path B: EISMINT II A at 61x61x61 float32 from zero ice. Returns the
    launch counts of the timed 2000 a, the state and time at 7 ka, and the
    K3 run of the last 1000 a (state, stats)."""
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.verification.eismint2 import EXPECTED_A

    model, state, grid = setups.eismint2_model("float32", device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state, t, warm = model.step_once(state, 0.0, 5000.0 * SPY)
    torch.cuda.synchronize()
    warm_wall = time.time() - t0
    t0 = time.time()
    state, t, stats = model.step_once(state, t, 2000.0 * SPY)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    for name, f in (("ice_thickness", state.geometry.ice_thickness),
                    ("enthalpy", state.enthalpy),
                    ("basal_melt_rate", state.basal_melt_rate)):
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"phase4: non-finite {name}")
    if abs(t - 7000.0 * SPY) > 1e-3 or stats.nsteps <= 0:
        raise AssertionError(f"phase4: {stats.nsteps} steps reached t = {t}")
    _check_launches("phase4", counts, ("sia_flux_thermo",),
                    tuple(k for k in KERNELS if k != "sia_flux_thermo"))
    H = state.geometry.ice_thickness.double()
    cell = grid.dx * grid.dy
    n = stats.nsteps
    print(f"phase4: EISMINT II A {grid.My}x{grid.Mx}x{grid.Mz} float32: "
          f"warm-up 5000 a in {warm.nsteps} steps, {warm_wall:.3f} s; timed "
          f"2000 a: steps {n}, dt-limit hits {stats.limit_hits_dict()}, wall "
          f"{wall:.3f} s, {1e3 * wall / n:.3f} ms/step, "
          f"{2000.0 / wall * 3600.0:.1f} model years per wall hour, "
          f"host syncs {stats.host_syncs / n:.1f}/step, launches {counts}")
    print(f"phase4: at 7 ka (not steady state; for information): volume "
          f"{float(H.sum()) * cell / 1e9:.4e} km^3 (EXPECTED_A "
          f"{EXPECTED_A['volume_km3']:.4e}), area "
          f"{float((H > 0).sum()) * cell / 1e6:.4e} km^2 "
          f"({EXPECTED_A['area_km2']:.4e}), divide thickness "
          f"{float(H[grid.My // 2, grid.Mx // 2]):.1f} m "
          f"({EXPECTED_A['divide_thickness_m']:.1f})")

    profile_steps(model, state, t, 10.0, "phase4")
    breakdown(model, state, t, 100.0, "phase4")

    # the same 1000 a on K3 and on the plain path
    off, _, _ = setups.eismint2_model(
        "float32", device=dev, extra_cfg={"stress_balance.sia.pallas": "off"})
    res = {}
    for name, m in (("K3", model), ("off", off)):
        reset_counts()
        s1, _, st1 = m.step_once(state, t, 1000.0 * SPY)
        torch.cuda.synchronize()
        res[name] = (st1, float(s1.geometry.ice_thickness.double().sum()),
                     read_counts()["sia_flux_thermo"], s1)
    (sk, vk, lk, k3_state), (so, vo, lo, _) = res["K3"], res["off"]
    rel = abs(vk - vo) / vo
    print(f"phase4: 1000 a K3 against sia.pallas=off: steps {sk.nsteps} / "
          f"{so.nsteps}, dt-limit hits {sk.limit_hits_dict()} / "
          f"{so.limit_hits_dict()}, volume rel diff {rel:.3e} (tol 2e-4), "
          f"K3 launches {lk} / {lo}")
    if sk.nsteps != so.nsteps or not rel <= 2e-4 or lk <= 0 or lo != 0:
        raise AssertionError("phase4: K3 and the plain path disagree")
    return counts, (state, t), (k3_state, sk)


def _halfar_errors(label, errs, limits):
    """Raise unless every error norm is under its limit."""
    over = {k: (errs[k], v) for k, v in limits.items() if not errs[k] < v}
    if over:
        raise AssertionError(f"{label}: errors over their limits {over}")


def _volume_drift(state, V0):
    return abs(float(state.geometry.ice_thickness.double().sum()) - V0) / V0


def phase5_halfar(dev):
    """Path C: Halfar test B through K4, and the isothermal verification
    letters. Returns the launch counts of (b), the main path."""
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.convert import state_to_numpy
    from pism_tpu_torch.verification import exact_steady as es
    from pism_tpu_torch.verification import halfar, runner

    # (a) 61x61 float64, 1000 a, K4 on the card against its plain version
    # on the CPU; the errors under tests/test_halfar.py's thresholds
    on = {"stress_balance.sia.pallas": "on"}
    runs = {}
    for where in ("cpu", dev):
        model, state, grid, sol = setups.halfar_model(
            "B", 61, "float64", device=where, extra_cfg=on)
        state, t, stats = model.step_once(state, sol.t0, 1000.0 * SPY)
        runs[str(where)] = (state, t, stats)
    (sa, ta, sta), (sb, tb, stb) = runs["cpu"], runs[str(dev)]
    Ha = state_to_numpy(sa)["ice_thickness"]
    Hb = state_to_numpy(sb)["ice_thickness"]
    H_err = float(abs(Hb - Ha).max() / abs(Ha).max())
    print(f"phase5a: Halfar B 61x61 float64 1000 a, card (K4) vs cpu: steps "
          f"{stb.nsteps} / {sta.nsteps}, dt-limit hits {stb.limit_hits_dict()}"
          f" / {sta.limit_hits_dict()}, H max err {H_err:.3e} of max H")
    if stb.nsteps != sta.nsteps or stb.limit_hits_dict() != sta.limit_hits_dict() \
            or not H_err <= 1e-7:
        raise AssertionError("phase5a: card and cpu disagree")
    _halfar_errors("phase5a", setups.halfar_report(sol, sb, grid, tb),
                   {"dome_H": 5.0, "avg_H": 15.0, "max_H": 400.0})

    # (b) the main path: 601x601 float32 under auto (K4) ------------------
    model, state, grid, sol = setups.halfar_model(
        "B", HALFAR_MX, "float32", device=dev)
    V0 = float(state.geometry.ice_thickness.double().sum())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    s_k4, t, stats = model.step_once(state, sol.t0, HALFAR_YEARS * SPY)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    H = s_k4.geometry.ice_thickness
    if not bool(torch.isfinite(H).all()) or tuple(H.shape) != grid.shape2 \
            or H.dtype != torch.float32:
        raise AssertionError("phase5b: non-finite or misshapen thickness")
    if stats.nsteps <= 0 or abs(t - sol.t0 - HALFAR_YEARS * SPY) > 1e-3:
        raise AssertionError(f"phase5b: {stats.nsteps} steps reached t = {t}")
    _check_launches("phase5b", counts, ("sia_flux",),
                    tuple(k for k in KERNELS if k != "sia_flux"))
    n = stats.nsteps
    drift_k4 = _volume_drift(s_k4, V0)
    print(f"phase5b: Halfar B {grid.My}x{grid.Mx} float32 (sia.pallas = auto)"
          f", {HALFAR_YEARS} a from t0: steps {n}, dt-limit hits "
          f"{stats.limit_hits_dict()}, wall {wall:.3f} s, "
          f"{1e3 * wall / n:.3f} ms/step, "
          f"{HALFAR_YEARS / wall * 3600.0:.1f} model years per wall hour, "
          f"host syncs {stats.host_syncs / n:.2f}/step, K4 launches "
          f"{counts['sia_flux']} ({counts['sia_flux'] / n:.2f}/step), "
          f"launches {counts}, volume drift {drift_k4:.3e}")
    setups.halfar_report(sol, s_k4, grid, t)
    profile_steps(model, s_k4, t, 0.2, "phase5b")
    breakdown(model, s_k4, t, 2.0, "phase5b")

    # (c) the same on the plain path --------------------------------------
    off, state, _, _ = setups.halfar_model(
        "B", HALFAR_MX, "float32", device=dev,
        extra_cfg={"stress_balance.sia.pallas": "off"})
    reset_counts()
    t0 = time.time()
    s_off, t_off, st_off = off.step_once(state, sol.t0, HALFAR_YEARS * SPY)
    torch.cuda.synchronize()
    wall_off = time.time() - t0
    k4_off = read_counts()["sia_flux"]
    H_err = float((s_off.geometry.ice_thickness - H).abs().max() / H.abs().max())
    drift_off = _volume_drift(s_off, V0)
    # zero SMB: the flux form conserves volume up to float32 rounding, at
    # most 1e-8 of it per step (3.3e-10 per step measured at 201x201)
    drift_tol = 1e-8 * max(n, st_off.nsteps)
    print(f"phase5c: the same {HALFAR_YEARS} a with sia.pallas = off: steps "
          f"{st_off.nsteps} / {n}, dt-limit hits {st_off.limit_hits_dict()}, "
          f"{1e3 * wall_off / st_off.nsteps:.3f} ms/step, K4 launches "
          f"{k4_off}, H max diff {H_err:.3e} of max H (tol 1e-4), volume "
          f"drift {drift_off:.3e} (K4 {drift_k4:.3e}; tol {drift_tol:.1e})")
    if abs(st_off.nsteps - n) > 1 or not H_err <= 1e-4 or k4_off != 0 \
            or not max(drift_k4, drift_off) <= drift_tol:
        raise AssertionError("phase5c: K4 and the plain path disagree")

    # (d) test C (0.6 t0 to t0) and the runner's letters at 61x61 float64
    # on the card, under tests/test_halfar.py's and
    # tests/test_exact_steady.py's thresholds -----------------------------
    t0 = time.time()
    c_t0 = halfar.test_C().t0
    model, state, grid, sol = setups.halfar_model(
        "C", 61, "float64", device=dev, t_start=0.6 * c_t0)
    state, t, stats = model.step_once(state, 0.6 * c_t0, 0.4 * c_t0)
    _halfar_errors("phase5d C", setups.halfar_report(sol, state, grid, t),
                   {"dome_H": 40.0, "avg_H": 30.0})
    steps, final = {"C": stats.nsteps}, {}
    real = runner._run_sia

    def run_sia(*a, **k):
        final["state"], final["stats"] = out = real(*a, **k)
        return out
    limits = {"A": (2000.0, {"dome_H": 30.0, "avg_H": 100.0, "max_H": 1500.0}),
              "D": (2500.0, {"dome_H": 35.0, "avg_H": 110.0}),
              "H": (None, {"dome_H": 60.0, "avg_H": 40.0, "bed": 1e-6}),
              "L": (1000.0, {"dome_H": 15.0, "avg_H": 160.0, "max_H": 1600.0})}
    runner._run_sia = run_sia
    try:
        for letter, (years, lim) in limits.items():
            errs = runner.run_test(letter, Mx=61, years=years, device=dev)
            steps[letter] = final["stats"].nsteps
            if letter == "H":
                # the bed must be -f H wherever there is ice (isostasy)
                g = final["state"].geometry
                icy = g.ice_thickness > 1.0
                errs["bed"] = float((g.bed_elevation + es.test_H().f
                                     * g.ice_thickness)[icy].abs().max())
            _halfar_errors(f"phase5d {letter}", errs, lim)
    finally:
        runner._run_sia = real
    print(f"phase5d: Halfar C and letters A, D, H, L at 61x61 float64 on the "
          f"card under their thresholds: steps {steps}, "
          f"{time.time() - t0:.1f} s")
    return counts


def _compare_meshed(label, ref, got, H_tol):
    """Equal steps and dt-limit hits, H within ``H_tol`` of max H; prints
    whether H is equal to the bit. ``ref``/``got``: (state, stats)."""
    import torch
    (sa, sta), (sb, stb) = ref, got
    Ha, Hb = sa.geometry.ice_thickness, sb.geometry.ice_thickness
    H_err = float((Hb - Ha).abs().max() / Ha.abs().max())
    va, vb = float(Ha.double().sum()), float(Hb.double().sum())
    rel = abs(vb - va) / va
    print(f"{label}: meshed against unmeshed: steps {stb.nsteps} / "
          f"{sta.nsteps}, dt-limit hits {stb.limit_hits_dict()} / "
          f"{sta.limit_hits_dict()}, H max diff {H_err:.3e} of max H (tol "
          f"{H_tol:.0e}), H bit-equal {torch.equal(Ha, Hb)}, volume rel diff "
          f"{rel:.3e}")
    if not bool(torch.isfinite(Hb).all()):
        raise AssertionError(f"{label}: non-finite thickness")
    if stb.nsteps != sta.nsteps \
            or stb.limit_hits_dict() != sta.limit_hits_dict() \
            or not H_err <= H_tol:
        raise AssertionError(f"{label}: the meshed run and the unmeshed run "
                             "disagree")
    return rel


def _ms_per_step(wall, stats):
    return 1e3 * wall / max(stats.nsteps, 1)


def _in_turns(label, run, unmeshed, meshed):
    """``run(model) -> (state, t, stats)`` in turns, unmeshed, meshed,
    meshed, unmeshed (the two compared within one call), each with the
    launch counts set to 0 just before it and read just after. Prints the
    ms/step of each; returns {name: [(state, t, stats, wall, counts)]}."""
    import torch
    out = {"unmeshed": [], "meshed": []}
    for name in ("unmeshed", "meshed", "meshed", "unmeshed"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        state, t, stats = run(unmeshed if name == "unmeshed" else meshed)
        torch.cuda.synchronize()
        out[name].append((state, t, stats, time.time() - t0, read_counts()))
    ms = {name: [_ms_per_step(r[3], r[2]) for r in runs]
          for name, runs in out.items()}
    mean = {name: sum(v) / len(v) for name, v in ms.items()}
    print(f"{label}: ms/step in turns, unmeshed {ms['unmeshed'][0]:.3f}, "
          f"meshed {ms['meshed'][0]:.3f}, meshed {ms['meshed'][1]:.3f}, "
          f"unmeshed {ms['unmeshed'][1]:.3f}; meshed / unmeshed "
          f"{mean['meshed'] / mean['unmeshed']:.3f}")
    return out


def phase6_meshed_hybrid(dev, mesh):
    """Path D: the 20 km hybrid chain on path A on a 2x2 mesh of the one
    card (K5 per shard) for 2 a, against an unmeshed IceModel on the same
    142x76x41 grid, config, surface and ocean, in turns. Returns the first
    meshed run's launch counts."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.model.icemodel import IceModel

    model, state0, grid = setups.hybrid_greenland_model(
        "float32", 20.0, device=dev, extra_cfg=PATH_A, mesh=mesh)
    ref = IceModel(grid=grid, config=model.config, surface=model.surface,
                   ocean=model.ocean, device=dev)
    runs = _in_turns("phase6", lambda m: m.step_once(state0, 0.0, 2.0 * SPY),
                     ref, model)
    for name in ("unmeshed", "meshed"):
        state, t, stats, wall, counts = runs[name][0]
        _check_hybrid_state(f"phase6 {name}", state, grid, stats, t, 2.0 * SPY)
        n = stats.nsteps
        print(f"phase6: {name} 20 km path A {grid.My}x{grid.Mx}x{grid.Mz} "
              f"float32, 2 a: steps {n}, Newton sweeps "
              f"{stats.ssa_newton_iters / n:.2f}/step, Krylov its "
              f"{stats.ssa_krylov_iters / n:.2f}/step, host syncs "
              f"{stats.host_syncs / n:.1f}/step, launches {counts} "
              f"({counts['ssa_matvec_halo'] / n:.1f} K5 and "
              f"{counts['ssa_newton_matvec_halo'] / n:.1f} Newton matvec "
              f"launches per step)")
    _check_launches("phase6", runs["unmeshed"][0][4],
                    ("ssa_matvec", "ssa_newton_matvec"),
                    ("ssa_matvec_jvp", "ssa_matvec_halo",
                     "ssa_matvec_halo_jvp", "ssa_newton_matvec_halo"))
    counts = runs["meshed"][0][4]
    _check_launches("phase6", counts,
                    ("ssa_matvec_halo", "ssa_newton_matvec_halo",
                     "pcr_lines", "pcr_lines_sub", "pcr_factor_lines",
                     "pcr_factor_lines_sub"),
                    ("ssa_matvec", "ssa_matvec_jvp", "ssa_newton_matvec",
                     "ssa_matvec_halo_jvp", "sia_flux_thermo", "sia_flux"))
    (sa, _, sta, _, _), (sb, tb, stb, _, _) = \
        runs["unmeshed"][0], runs["meshed"][0]
    rel = _compare_meshed("phase6", (sa, sta), (sb, stb), 1e-5)
    if not rel <= 2e-4:
        raise AssertionError(f"phase6: volume rel diff {rel:.3e} > 2e-4")
    profile_steps(ref, sa, tb, 0.01, "phase6 unmeshed")
    profile_steps(model, sb, tb, 0.01, "phase6 meshed")
    per = {name: profile_bicgstab(m, s, tb, 0.01, f"phase6 {name}")
           for name, m, s in (("unmeshed", ref, sa), ("meshed", model, sb))}
    (oa, ua, ha), (ob, ub, hb) = per["unmeshed"], per["meshed"]
    print(f"phase6: the decomposition's share of a Krylov iteration (1 - "
          f"unmeshed / meshed): device ops {1 - oa / ob:.3f}, device time "
          f"{1 - ua / ub:.3f}, profiled host time {1 - ha / hb:.3f}")
    return counts


def phase6b_eismint(dev, mesh, start, k3_run):
    """EISMINT II A on the 2x2 mesh (K3 per shard) over phase 4's last
    1000 a, in turns with an unmeshed model; both against phase 4's
    unmeshed K3 run of the same 1000 a."""
    import torch
    from pism_tpu_torch import setups

    state, t = start
    k3_state, k3_stats = k3_run
    ref, _, grid = setups.eismint2_model("float32", device=dev)
    model, _, _ = setups.eismint2_model("float32", device=dev, mesh=mesh)
    runs = _in_turns("phase6b", lambda m: m.step_once(state, t, 1000.0 * SPY),
                     ref, model)
    s, _, st, _, counts = runs["meshed"][0]
    _check_launches("phase6b", counts, ("sia_flux_thermo",),
                    tuple(k for k in KERNELS if k != "sia_flux_thermo"))
    print(f"phase6b: EISMINT II A {grid.My}x{grid.Mx}x{grid.Mz} float32 on "
          f"2x2, 1000 a: steps {st.nsteps}, K3 launches "
          f"{counts['sia_flux_thermo'] / st.nsteps:.2f}/step")
    if not torch.equal(runs["unmeshed"][0][0].geometry.ice_thickness,
                       k3_state.geometry.ice_thickness):
        raise AssertionError("phase6b: the unmeshed run differs from phase 4's")
    _compare_meshed("phase6b", (k3_state, k3_stats), (s, st), 1e-6)


def phase6c_halfar(dev, mesh):
    """Halfar B at 601x601 float32 on the 2x2 mesh (K4 per shard) for 20 a
    from t0, in turns with the unmeshed run of the same 20 a."""
    from pism_tpu_torch import setups

    ref, state, grid, sol = setups.halfar_model("B", HALFAR_MX, "float32",
                                                device=dev)
    model, _, _, _ = setups.halfar_model("B", HALFAR_MX, "float32",
                                         device=dev, mesh=mesh)
    runs = _in_turns("phase6c",
                     lambda m: m.step_once(state, sol.t0, 20.0 * SPY),
                     ref, model)
    for name in ("unmeshed", "meshed"):
        _, _, st, _, counts = runs[name][0]
        _check_launches(f"phase6c {name}", counts, ("sia_flux",),
                        tuple(k for k in KERNELS if k != "sia_flux"))
        print(f"phase6c: Halfar B {grid.My}x{grid.Mx} float32 {name}, 20 a "
              f"from t0: steps {st.nsteps}, K4 launches "
              f"{counts['sia_flux'] / st.nsteps:.2f}/step")
    (sa, _, sta, _, _), (sb, _, stb, _, _) = \
        runs["unmeshed"][0], runs["meshed"][0]
    _compare_meshed("phase6c", (sa, sta), (sb, stb), 1e-6)


def main():
    torch = _require_cuda()
    dev = torch.device("cuda:0")
    # float32 reference arithmetic stays float32 (no TF32 anywhere)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"versions: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    start = time.time()

    timings = phase1_kernels(dev)
    phase1_chain_reference(dev)

    pcr_names = ("pcr_lines", "pcr_lines_sub", "pcr_factor_lines",
                 "pcr_factor_lines_sub")
    k1 = ("ssa_matvec", "ssa_newton_matvec")
    # the old JVP kernels and the per-shard ones are off these paths
    off = ("ssa_matvec_jvp", "ssa_matvec_halo", "ssa_matvec_halo_jvp",
           "ssa_newton_matvec_halo", "sia_flux_thermo", "sia_flux")
    _, _, _, (p2,), _ = run_hybrid(dev, 20.0, (2.0,), "phase2", None, k1,
                                   pcr_names + off)
    model, state, t, (a2, a8), counts_a = run_hybrid(
        dev, 20.0, (2.0, 8.0), "phase2b", PATH_A, k1 + pcr_names, off)
    (s2, _, v2), (sa, _, va) = p2, a2
    rel = abs(va - v2) / v2
    print(f"phase2b: after 2 a against phase 2: steps {sa.nsteps} / "
          f"{s2.nsteps}, dt-limit hits {sa.limit_hits_dict()} / "
          f"{s2.limit_hits_dict()}, volume rel diff {rel:.3e} (tol 2e-4)")
    if sa.nsteps != s2.nsteps or sa.limit_hits_dict() != s2.limit_hits_dict() \
            or not rel <= 2e-4:
        raise AssertionError("phase2b: path A and the default path disagree")
    check_preconditioner(model, state, t)
    check_newton_matvec(model, state, t)
    profile_krylov(model, state, t)
    profile_bicgstab(model, state, t, 0.01, "phase2b")
    profile_steps(model, state, t, 0.01, "phase2b")
    breakdown(model, state, t, 1.0, "phase2b")
    model, state, t, _, _ = run_hybrid(dev, 5.0, (0.5,), "phase3", PATH_A,
                                       k1 + pcr_names, off)
    profile_bicgstab(model, state, t, 0.01, "phase3")
    breakdown(model, state, t, 0.25, "phase3")
    counts_b, eismint_7ka, k3_run = phase4_eismint(dev)
    t5 = time.time()
    counts_c = phase5_halfar(dev)
    print(f"phase5: {time.time() - t5:.1f} s")
    from pism_tpu_torch.parallel import make_mesh
    mesh = make_mesh([dev] * 4, (2, 2))
    t6 = time.time()
    counts_d = phase6_meshed_hybrid(dev, mesh)
    phase6b_eismint(dev, mesh, eismint_7ka, k3_run)
    phase6c_halfar(dev, mesh)
    print(f"phase6: {time.time() - t6:.1f} s")
    print(f"chip_smoke: all phases passed in {time.time() - start:.1f} s")

    # library_ms: torch.linalg.solve on the dense matrices for the line
    # solves; no single PyTorch call computes any of the other functions
    kernels = []
    for name, source, replaces, counts in (
            ("ssa_matvec", "ssa_matvec.cu", "pism_tpu/ops/pallas_kernels.py:325", counts_a),
            ("ssa_matvec_jvp", "ssa_matvec.cu", "pism_tpu/ops/pallas_kernels.py:407", counts_a),
            ("ssa_newton_matvec", "ssa_matvec.cu", "pism_tpu/ops/pallas_kernels.py:407", counts_a),
            ("pcr_lines", "pcr.cu", "pism_tpu/ops/pallas_kernels.py:482", counts_a),
            ("pcr_lines_sub", "pcr.cu", "pism_tpu/ops/pallas_kernels.py:539", counts_a),
            ("pcr_factor_lines", "pcr.cu", "pism_tpu/ops/pallas_kernels.py:482", counts_a),
            ("pcr_factor_lines_sub", "pcr.cu", "pism_tpu/ops/pallas_kernels.py:539", counts_a),
            ("sia_flux_thermo", "sia_thermo.cu", "pism_tpu/ops/pallas_kernels.py:195", counts_b),
            ("sia_flux", "sia_iso.cu", "pism_tpu/ops/pallas_kernels.py:300", counts_c),
            ("ssa_matvec_halo", "ssa_matvec.cu", "pism_tpu/ops/pallas_sharded.py:108", counts_d),
            ("ssa_matvec_halo_jvp", "ssa_matvec.cu", "pism_tpu/ops/pallas_sharded.py:225", counts_d),
            ("ssa_newton_matvec_halo", "ssa_matvec.cu", "pism_tpu/ops/pallas_sharded.py:225", counts_d)):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"pism_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": counts[name],
                        "library_ms": None, **timings[name]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    # the run drives one card (cuda:0), which CUDA_VISIBLE_DEVICES restricts
    # the process to, so this count is 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
