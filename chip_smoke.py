"""GPU smoke run of the PyTorch port (pism_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the kernels from ``pism_tpu_torch/csrc`` (one ``nvcc`` per
source, all started together) and holds each against its plain torch
version on the card, relative max-norm error (the paths' cases, float32 at
their shapes and layouts, also timed):
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
    (3 km) under ``auto`` for 50 model years from t0 (cut from 200 to keep
    the script's time), timed, then a few steps profiled and a timed
    breakdown of 2 a; (c) the same 50 a with ``sia.pallas = off`` against
    (b); (d) Halfar test C and the runner's letters A, D, H and L at 61x61
    float64 on the card, under the JAX package's test thresholds.

  phase 7: the command line (``pism_tpu_torch.cli.main``, every file
    netcdf3): (a) EISMINT II A 61x61x61 float32 on K3 for 1000 a with
    scalar and spatial series, a snapshot and ``-o_size medium``, equal to
    the bit (steps, dt-limit hits, H, E) to ``setups.eismint2_model`` run
    by ``IceModel.run`` with the same output times, its file read back to
    the bit, then ``python -m pism_tpu_torch -eisII B -i`` for 200 a;
    (b) Halfar B 61x61 float64 for 1000 a on the card against
    ``-platform cpu`` (equal steps, H within 1e-10 of max) and the exact
    solution, then K4's route at 601x601 float32 for 20 a, equal to the bit
    to ``setups.halfar_model`` run by ``IceModel.run``; (c) phase 2b's end
    state saved and continued by ``-i`` for 0.5 a, equal to the bit (H, E,
    u, steps, Newton sweeps, Krylov iterations) to an in-memory run with
    zero SMB. Each run prints its wall time, ms per step, launches per
    step, output seconds and file sizes; (a) and (b) also the device ops
    per step through ``step_once`` and through ``IceModel.run``.
  phase 8: the std-greenland workflow through the command line (float32,
    every file netcdf3): the data file synthesized at 5 km (301x561) with
    SeaRISE's polar-stereographic ``proj``; (a) ``io.bootstrap.bootstrap``
    onto the 20 km grid (141x76x41) on the card against the CPU (the
    regridded fields to the bit, E within 4 float32 ulps), and of a copy
    with a climatic_mass_balance (the smb heuristic's Robin profile, E
    within 4 float32 ulps of T times c_i), then stage 1 (``-bootstrap``,
    SIA, 10 a), stage 2 (no mass, 10 a) and stage 3 (``ssa+sia``
    pseudo-plastic, skip 10, path A, 1 a), each restarting from the last
    and equal to the bit (H, E, u, steps, Newton and Krylov counts) to the
    same stage driven from Python (the factory and ``IceModel.run``; stage
    3's SSA solves print their Newton sweeps and final residual against
    the tolerance); stage 2's H equals stage 1's, stage 3 launches K1, the
    Newton matvec, K2 and K2b, and the outputs carry lat/lon from the
    projection; then a ``stress_balance.ssa.dirichlet_bc`` run from stage
    3's state with a strip of fixed velocities (equal to the BC to the
    bit, the lift one K1 launch per Picard sweep); (b) the bootstrap at
    5 km (the identity regrid, H equal to the file's) and 0.05 a of stage
    3 on path A. Each run prints its wall time, ms and launches per step,
    steps, dt-limit hits and file sizes; the bootstraps their host seconds.

  phase 9: the PISM-PIK Antarctic chain (BASELINE config 4,
    ``setups.antarctica_pik_model``): (a) 251x251x31 float32 on path A,
    the JAX example's first 10 a, a timed 5 a (cut from 10 to make room
    for phase 13) and 3 a with PICO, calving
    and Lingle-Clark timed apart (and the host syncs of a PICO call);
    finite fields, a shelf with PICO melt, K1, the Newton matvec, K2 and
    K2b launched; (b) 125 km float64 on the card against the CPU: one step
    across the Lingle-Clark update held close, three to 12 a by steps,
    dt-limit hits and volume, PICO's box index and distances equal on the
    initial and end geometry, one Lingle-Clark solve (cuFFT against
    pocketFFT) within 1e-12; (c) the command line: a 16 km data file
    (dry ocean, warm shelf water, two basins), ``-bootstrap`` with the PIK
    flags for 1 a, equal to the bit to the same run from Python, and a
    plain ``-i`` restart for 1 a equal to the bit to the run continued in
    memory, with eigen calving acting.
  phase 10: MISMIP3d and MISMIP experiment 1 (BASELINE config 2,
    ``setups.mismip3d_model``, ``setups.mismip_model``): (a) MISMIP3d at
    1 km (1601x101) float32 on path A through ``IceModel.run``: Stnd from
    the Vialov start for 5 a, a timed 30 a, then P75S and P75R for 10 a
    each with ``GivenYieldStress`` fields as the example builds them; ms
    per step, steps per model year, dt-limit hits, Newton sweeps, Krylov
    iterations, host syncs and launches per step, the grounding line on
    the centre and edge rows after each phase; finite fields, K1, the
    Newton matvec and K2/K2b launched, K3, K4 and K5 idle; on the state
    after the timed Stnd window, K1 and the Newton matvec (1e-5) and the
    PCR factor and apply on the 1601-long u-lines and the 101-long v-lines
    (to the bit) against their plain versions; (b) MISMIP3d at
    50 km float64 on the card against the CPU (equal steps and dt-limit
    hits, volume within 1e-10); (c) MISMIP experiment 1 on its periodic-y
    grid at 151x7: float32 through the periodic route (the padded-block K1
    and Newton matvec launch, the whole-field ones stay idle), float64 on
    the card against the CPU (the first step within 1e-12, 10 a by steps,
    dt-limit hits and volume), the route against the plain periodic
    stencils on the card's state in both dtypes (K1's tolerances), and the
    route timed at 151x7 and 1601x101.
  phase 11: the ensemble (BASELINE config 5, ``parallel/ensemble.py``,
    ``setups.paleo_ensemble_model``): (a) the paleo ensemble at its
    published width, 100 members at 41x41x21 float32 through
    ``EnsembleRunner``, 50 a then a timed 450 a: member-years per wall
    hour, lockstep steps and each member's, ms, host syncs and kernel
    launches per lockstep step, the busy share of a profiled window, the
    volume range and the volume-dT correlation (above 0.9), and the
    coldest, middle and warmest members against solo runs on the card
    (equal steps and hits, H within 1e-4 of max H, printed whether equal
    to the bit); (b) the same with Mahaffy gradients and no bed smoother,
    16 members, 100 a, so that K3 launches once a lockstep step for all
    members, and on its state K3's member-axis launch against its plain
    version (1e-4), against one launch per member (to the bit, the (B,)
    max(D) against each member's faces' max) and timed against them; (c)
    Halfar B ensembles at 601x601 float32 (SMB scales 0..7, 20 a), K4 the
    same way (2e-5); (d) 4 members at 100 km float64 on the card against
    the CPU (equal steps and hits, volumes within 1e-10).
  phase 12: the ssa+sia ensemble (``setups.hybrid_ensemble_model``, the
    hybrid chain's members differing in their till friction angle, 15-40
    degrees): (a) 100 members at 141x76x41 float32 on path A through
    ``EnsembleRunner``, 2 a then a timed 3 a: lockstep steps and each
    member's, Newton sweeps and Krylov iterations per lockstep step (the
    lockstep's, and each member's min / median / max), host syncs and
    kernel launches per lockstep step, ms per lockstep step, member-years
    per wall hour, the busy share of a profiled window; every SSA kernel
    launched on the member axis and none singly; the members' median
    sliding speed over grounded ice against the till angle (correlation
    below -0.9; the mean is printed too, set by a few margin cells at the
    speed clamp); (b) members 0, 50 and 99 over the 2 a: equal to the bit to
    their runs as 1-member ensembles (H, E, u_ssa, steps, hits, Newton and
    Krylov counts) and within phase 2b's envelope of their solo chains
    (equal steps and hits, volume within 2e-4); (c) on the ensemble's
    linearization K1, the Newton matvec, K2b and K2 factor and apply, the
    member dot and the member dots (the Krylov loop's paired dots) against
    100 single launches (to the bit) and their plain versions, timed
    against them, each of the member dots against the member dot of its
    pair (to the bit), the member dot and dots against
    ``torch.linalg.vecdot``; (d) 4 members at 100 km float64, 2 a, card
    against CPU (equal steps and hits, volumes within 1e-7).
  phase 13: the Antarctic ensemble (BASELINE config 5's "100-member
    Antarctic paleo ensemble", ``setups.antarctica_pik_ensemble_model``:
    the PISM-PIK chain from its data file, members differing in PICO's
    ocean temperature, 0-2 K warmer): (a) 100 members at 251x251x31
    float32 on path A through ``EnsembleRunner``, 1 a then a timed 2 a:
    phase 12's lockstep figures, the peak device memory, the busy share of
    a profiled window, and PICO's, calving's and Lingle-Clark's ms per
    lockstep step with PICO's host syncs per call; finite fields, every
    SSA kernel launched on the member axis and none singly (K3, K4, K5
    idle), calving in every member, the bed moved in every member, a shelf
    with PICO melt in every member, the members' sub-shelf and basal melt
    against dT (correlation above 0.9); (b) members 0, 50 and 99 over the
    1 a: equal to the bit to their 1-member ensembles (H, Href, E, u_ssa,
    the bed, the viscous displacement, PICO's box index, steps, hits,
    Newton and Krylov counts) and within phase 2b's envelope of their solo
    chains; (c) on the 3 a state, ``Pico.members`` against 100 single PICO
    calls (its melt within 1e-4 of the single form's, whose basin sums
    add in torch's order) and one member-axis Lingle-Clark solve against
    100 single solves, to the bit, timed; (e) (c) of phase 12 on that
    state (100x251x251: K2b's and K2's lines of n = 251), and PICO's basin
    sums (``member_sum`` over 300 basin rows) against one launch per row
    (to the bit) and torch's sum (its plain version and its yardstick); the kernel record's member-axis entries are phase
    13's; (d) 4 members at 125 km float64, 2 a, card against CPU (equal
    steps and hits, volumes within 1e-7).

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
HALFAR_MX, HALFAR_YEARS = 601, 50.0
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
    from pism_tpu_torch.ops.kernels import (member_dot, pcr, sia_iso,
                                            sia_thermo, ssa_matvec)
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
            (sia_thermo, "MEMBER_LAUNCHES", "sia_flux_thermo_members"),
            (sia_iso, "MEMBER_LAUNCHES", "sia_flux_members"),
            (ssa_matvec, "MEMBER_LAUNCHES", "ssa_matvec_members"),
            (ssa_matvec, "NEWTON_MEMBER_LAUNCHES",
             "ssa_newton_matvec_members"),
            (pcr, "MEMBER_LAUNCHES", "pcr_lines_members"),
            (pcr, "SUB_MEMBER_LAUNCHES", "pcr_lines_sub_members"),
            (pcr, "MEMBER_FACTOR_LAUNCHES", "pcr_factor_lines_members"),
            (pcr, "SUB_MEMBER_FACTOR_LAUNCHES",
             "pcr_factor_lines_sub_members"),
            (member_dot, "LAUNCHES", "member_dot"),
            (member_dot, "DOTS_LAUNCHES", "member_dots"),
            (member_dot, "SUM_LAUNCHES", "member_sum"),
            (hostsync, "COUNT", "host_syncs"))


KERNELS = ("ssa_matvec", "ssa_matvec_jvp", "ssa_newton_matvec",
           "ssa_matvec_halo", "ssa_matvec_halo_jvp", "ssa_newton_matvec_halo",
           "pcr_lines", "pcr_lines_sub",
           "pcr_factor_lines", "pcr_factor_lines_sub",
           "sia_flux_thermo", "sia_flux", "sia_flux_thermo_members",
           "sia_flux_members", "ssa_matvec_members",
           "ssa_newton_matvec_members", "pcr_lines_members",
           "pcr_lines_sub_members", "pcr_factor_lines_members",
           "pcr_factor_lines_sub_members", "member_dot", "member_dots",
           "member_sum")


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
                 match=None, nbytes=None, unpack=None, phase="phase1",
                 timed=True):
    """Kernel against plain version on the same inputs, then (if
    ``timed``) both timed, and the kernel's bound from ``nbytes`` (by
    default the bytes of its tensor inputs and outputs, each counted once)
    and ``nops`` operations. ``match`` names the CUDA kernel, whose device
    time alone is printed too; ``unpack`` turns a result that is no tensor
    into the tensors to compare. Returns the kernel's record: events ms,
    plain events ms, max abs err, bound ms and what sets the bound (the
    error alone if not timed). Phase 1 times the paths' cases only
    (float32, their shapes and layouts); the others are checked."""
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
    if not timed:
        print(f"{phase}: {name} {label} rel_err {err:.3e} (tol {tol:.0e}); "
              "not timed")
        return {"max_abs_err": abs_err}
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
    print(f"{phase}: {name} {label} rel_err {err:.3e} (tol {tol:.0e}) events "
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


def _dense_solve_ms(a, c, d, sub, x, label, phase="phase1"):
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
    print(f"{phase}: torch.linalg.solve on {tuple(A.shape)} dense matrices "
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


def _check_replaced(name, label, got, args, mesh=None, phase="phase1",
                    timed=True):
    """``got`` against the replaced composition on the same inputs: equal
    to the bit; if ``timed``, the composition timed (CUDA events, the
    profiler's device time)."""
    import torch
    ref = _replaced_composition(*args, mesh=mesh)
    torch.cuda.synchronize()
    same = all(torch.equal(g, r) for g, r in zip(got, ref))
    diff = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    times = ""
    if timed:
        ms = _time_ms(lambda: _replaced_composition(*args, mesh=mesh), 50)
        times = (f" events {ms:.4f} ms, device "
                 f"{_us(lambda: _replaced_composition(*args, mesh=mesh))};")
    print(f"{phase}: {name} {label}: the replaced composition (plain tangent, "
          f"{'ssa_matvec_jvp' if mesh is None else 'ssa_matvec_sharded_jvp'}"
          f", selects){times} equal to it to the bit {same} (max |diff| "
          f"{diff:.3e})")
    if not same:
        raise AssertionError(f"{name} {label}: differs from the composition "
                             f"it replaces by {diff:.3e}")


def _newton_case(label, args, tol, phase="phase1", timed=True):
    """The Newton matvec against its plain version (``_kernel_case``) and
    against the composition it replaces; returns the kernel's record."""
    from pism_tpu_torch.ops.kernels import ssa_matvec as K
    r = _kernel_case("ssa_newton_matvec", K.ssa_newton_matvec,
                     K.ssa_newton_matvec_plain, args, tol, label,
                     OPS["ssa_newton_matvec"] * args[0].numel(),
                     match="newton", phase=phase, timed=timed)
    _check_replaced("ssa_newton_matvec", label, K.ssa_newton_matvec(*args),
                    args, phase=phase, timed=timed)
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
    _build.build("ssa_matvec", "pcr", "sia_thermo", "sia_iso", "member_dot")
    print(f"phase1: built ssa_matvec, pcr, sia_thermo, sia_iso, member_dot in "
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
                                 if name == "ssa_matvec" else None,
                                 timed=dtype == torch.float32)
                if km == 20 and dtype == torch.float32:
                    out[name] = r
            r = _newton_case(f"{My}x{Mx} {str(dtype)[6:]}",
                             _newton_args(nrng, (My, Mx), dtype, dev)
                             + (dx, dy), tol, timed=dtype == torch.float32)
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
                         match="ssa_matvec_tile", timed=False)

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
            f32 = dtype == torch.float32
            _kernel_case("pcr_lines_sub", K2.pcr_lines_sub,
                         K2.pcr_lines_sub_plain, sub[:4], 0.0, label, nops,
                         timed=f32)
            _kernel_case("pcr_lines", K2.pcr_lines, K2.pcr_lines_plain,
                         lanes[:4], 0.0, label, nops, timed=f32)
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
                                   + OPS["sia_thermo_face"]), reps=50,
                    timed=dtype == torch.float32 and layout == "level-major")
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
                    match="sia_iso_kernel",
                    timed=dtype == torch.float32 and d_cap is None)
                _check_max("sia_flux", label, K4.sia_flux(*args, **kw))
                if M == HALFAR_MX and dtype == torch.float32 and d_cap is None:
                    out["sia_flux"] = r
    print(f"phase1: the single-card kernels {time.time() - t0:.1f} s")
    out.update(_timed("phase1 sharded", phase1_sharded, dev, rng))
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
            # the paths' shards (20 and 5 km on 2x2) timed, float32
            timed = dtype == torch.float32 and mshape == (2, 2)
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
                                 else "halo_jvp", timed=timed)
                if km == 20 and mshape == (2, 2) and dtype == torch.float32:
                    out[name] = r
                wargs = k1_args[:-2] + (mesh,) + k1_args[-2:]
                got, ref, one = whole(*wargs), whole_plain(*wargs), k1(*k1_args)
                torch.cuda.synchronize()
                err = max(_rel_err(g, q) for g, q in zip(got, ref))
                diff = max(float((g - q).abs().max()) for g, q in zip(got, one))
                times = ""
                if timed:
                    ms = _time_ms(lambda: whole(*wargs), 100)
                    ms1 = _time_ms(lambda: k1(*k1_args), 100)
                    times = (f"; events {ms:.4f} ms against K1 {ms1:.4f} ms; "
                             f"device {_us(lambda: whole(*wargs))} against K1 "
                             f"{_us(lambda: k1(*k1_args))}")
                print(f"phase1: {name} {label}: the sharded call against the "
                      f"plain sharded call rel_err {err:.3e} (tol {tol:.0e}), "
                      f"max |K5 - K1| {diff:.3e}{times}")
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
            times = "" if dtype != torch.float32 else (
                f"; events {_time_ms(sharded, 50):.4f} ms against "
                f"{_time_ms(whole, 50):.4f} ms; device {_us(sharded)} "
                f"against {_us(whole)}")
            print(f"phase1: K6 {name} {label} {str(dtype)[6:]} per shard of "
                  f"2x2 against unsharded: equal {same}{times}; one shard's "
                  f"launch on {tuple(blocks[0].shape)} blocks bound "
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
    timed = dtype == torch.float32 and (ny, nx) == (2, 2)
    r = _kernel_case("ssa_newton_matvec_halo", K.ssa_newton_matvec_halo,
                     K.ssa_newton_matvec_halo_plain,
                     (nx == 1, ny == 1, *two[:4], *one, b0, two[4], dx, dy),
                     tol, f"one shard of {label}",
                     OPS["ssa_newton_matvec"] * b0.numel(), match="newton",
                     timed=timed)
    out["ssa_newton_matvec_halo"] = r
    frozen = (u, v, ne, nn, ce, cn, beta, bc)
    mv = S.ssa_newton_matvec_sharded(*frozen, mesh, dx, dy)
    got = mv(du, dv)
    ref = S.ssa_newton_matvec_sharded_plain(*frozen, mesh, dx, dy)(du, dv)
    whole = K.ssa_newton_matvec(*args, dx, dy)
    torch.cuda.synchronize()
    err = max(_rel_err(g, q) for g, q in zip(got, ref))
    same = all(torch.equal(g, w) for g, w in zip(got, whole))

    def prepare():
        return S.ssa_newton_matvec_sharded(*frozen, mesh, dx, dy)
    times = "" if not timed else (
        f"; events per matvec {_time_ms(lambda: mv(du, dv), 100):.4f} ms "
        "against the unsharded "
        f"{_time_ms(lambda: K.ssa_newton_matvec(*args, dx, dy), 100):.4f} "
        f"ms, the preparation once per sweep {_time_ms(prepare, 20):.4f} ms;"
        f" device per matvec {_us(lambda: mv(du, dv))}, the preparation "
        f"{_us(prepare)}")
    print(f"phase1: ssa_newton_matvec_halo {label}: the sharded matvec "
          f"against the plain sharded one rel_err {err:.3e} (tol {tol:.0e}),"
          f" equal to the unsharded kernel {same}{times}")
    if not err <= tol or not same:
        raise AssertionError(f"ssa_newton_matvec_halo {label}: sharded "
                             f"{err:.3e} from plain, equal to unsharded "
                             f"{same}")
    _check_replaced("ssa_newton_matvec_halo", label, got, (*args, dx, dy),
                    mesh, timed=timed)


def check_newton_matvec(model, state, t, label="on the 20 km chain's "
                        "linearization", phase="phase2b"):
    """The Newton matvec on a chain's own linearization at the state's
    velocity (coefficients across float32's range), a random direction of
    the velocity's size: the kernel against its plain version and against
    the composition it replaces."""
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
    print(f"{phase}: the chain's tangent coefficients (nonzero |.|): "
          + ", ".join(spans))
    _newton_case(label, (u, v, *d, nuH.e, nuH.n, *coefs, P["beta_fn"](u, v),
                         P["bc_mask"], model.grid.dx, model.grid.dy), 1e-5,
                 phase=phase)


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


# -- phase 7: the command line --------------------------------------------

def _recording_run(records):
    """Context: ``IceModel.run`` appends (model, output, state, stats, run
    wall seconds) of every call to ``records``."""
    import torch
    from pism_tpu_torch.model.icemodel import IceModel

    def wrap(label, orig):
        def run(self, state, run_time, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, stats = orig(self, state, run_time, *a, **k)
            torch.cuda.synchronize()
            records.append((self, k.get("output"), st, stats,
                            time.perf_counter() - t0))
            return st, stats
        return run

    return _patched([(IceModel, "run", "run")], wrap)


def _cli(label, argv, files=()):
    """``pism_tpu_torch.cli.main(argv)`` with the launch counters set to 0
    just before and read just after; prints its wall time, ms per step,
    launches per step, the output's seconds and the files' sizes. Returns
    (model, state, stats, counts)."""
    import torch
    from pism_tpu_torch import cli

    records = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with _recording_run(records):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0 or len(records) != 1:
        raise AssertionError(f"{label}: main returned {rc}, {len(records)} runs")
    model, out, state, stats, run_wall = records[0]
    n = stats.nsteps
    per = {k: round(v / n, 2) for k, v in counts.items() if v} if n else {}
    per_step = f"{1e3 * run_wall / n:.2f} ms/step" if n else "no steps"
    sizes = {os.path.basename(f): os.path.getsize(f) for f in files}
    print(f"{label}: {' '.join(argv[:4])} ...: steps {n}, dt-limit hits "
          f"{stats.limit_hits_dict()}, main() wall {wall:.3f} s, run wall "
          f"{run_wall:.3f} s, {per_step}, launches per "
          f"step {per}; output: {out.main_seconds:.3f} s on the main thread "
          f"inside the run, {out.writer_seconds:.3f} s on the writer thread, "
          f"{wall - run_wall:.3f} s of main() outside the run (set-up, "
          f"close, final write); files {sizes}")
    return model, state, stats, counts


def _equal(label, pairs):
    import torch
    bad = [name for name, a, b in pairs if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"{label}: not equal to the bit: {bad}")


def _records(path):
    from pism_tpu_torch.io.nc4 import File
    with File(path, "r") as f:
        return len(f.read("time"))


def profile_run(model, state, t, years, label):
    """The same window through ``step_once`` and through ``IceModel.run``
    (no output) under the profiler's CUDA activity: device ops per step of
    each, and what run adds (its segment-boundary checks)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pism_tpu_torch.util.timecal import Time

    ops = {}
    for name in ("step_once", "run"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if name == "run":
                _, stats = model.run(state, Time(t, t + years * SPY))
            else:
                _, _, stats = model.step_once(state, t, years * SPY)
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ops[name] = (len(dev), stats.nsteps)
    (a, n), (b, m) = ops["step_once"], ops["run"]
    print(f"{label}: {years} a profiled: step_once {n} steps, {a} device ops "
          f"({a / n:.1f} per step); IceModel.run without output {m} steps, "
          f"{b} device ops ({b / m:.1f} per step); run adds {b - a} ops "
          f"over the window (prepare_state, the segment-boundary checks)")


def phase7a_eismint(dev, d):
    """EISMINT II A at 61x61x61 float32 on K3 through the CLI with all three
    series and -o_size medium, against setups.eismint2_model run by
    IceModel.run with the same output times; then -eisII B -i."""
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.cli import parse_times
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.model.output import OutputManager
    from pism_tpu_torch.util.timecal import Time

    f = {k: os.path.join(d, k + ".nc") for k in ("a", "ts", "ex", "snap", "b")}
    argv = ["-eisII", "A", "-Mx", "61", "-Mz", "61", "-y", "1000",
            "-config", "runtime.float_dtype=float32",
            "-config", "stress_balance.sia.bed_smoother.range=0",
            "-ts_file", f["ts"], "-ts_times", "0:100:1000",
            "-extra_file", f["ex"], "-extra_times", "0:500:1000",
            "-save_times", "500", "-save_file", f["snap"],
            "-o_size", "medium", "-o_format", "netcdf3", "-o", f["a"],
            "-verbose", "1"]
    model, state, stats, counts = _cli(
        "phase7a", argv, [f["a"], f["ts"], f["ex"], f["snap"]])
    _check_launches("phase7a", counts, ("sia_flux_thermo",),
                    tuple(k for k in KERNELS if k != "sia_flux_thermo"))

    ref, s0, grid = setups.eismint2_model("float32", device=dev)
    out = OutputManager(
        grid=grid, config=ref.config, format="netcdf3",
        ts_times=parse_times("0:100:1000", SPY), ts_file=f["ts"] + ".ref",
        extra_times=parse_times("0:500:1000", SPY), extra_file=f["ex"] + ".ref",
        snapshot_times=[500 * SPY], snapshot_file=f["snap"] + ".ref")
    t0 = time.perf_counter()
    rs, rst = ref.run(s0, Time(0.0, 1000 * SPY), output=out)
    out.close()
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    loaded, t_end = ckpt.load_state(f["a"], device=dev)
    n_ts, n_ex = _records(f["ts"]), _records(f["ex"])
    print(f"phase7a: against setups.eismint2_model + IceModel.run "
          f"({ref_wall:.3f} s): steps {stats.nsteps} / {rst.nsteps}, "
          f"dt-limit hits {stats.limit_hits_dict()} / "
          f"{rst.limit_hits_dict()}; ts records {n_ts} (11), ex records "
          f"{n_ex} (3); state dtype {str(state.geometry.ice_thickness.dtype)[6:]}")
    if stats.nsteps != rst.nsteps \
            or stats.limit_hits_dict() != rst.limit_hits_dict() \
            or (n_ts, n_ex) != (11, 3) or abs(t_end - 1000 * SPY) > 1e-3:
        raise AssertionError("phase7a: the CLI run and the reference differ")
    _equal("phase7a run", [
        ("thk", state.geometry.ice_thickness, rs.geometry.ice_thickness),
        ("enthalpy", state.enthalpy, rs.enthalpy)])
    _equal("phase7a load_state", [
        ("thk", loaded.geometry.ice_thickness, state.geometry.ice_thickness),
        ("enthalpy", loaded.enthalpy, state.enthalpy)])
    profile_run(model, state, t_end, 100.0, "phase7a")

    # the continuation of experiment B from A's file, as a module run
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pism_tpu_torch", "-eisII", "B", "-i", f["a"],
         "-y", "200", "-config", "runtime.float_dtype=float32",
         "-config", "stress_balance.sia.bed_smoother.range=0",
         "-o", f["b"], "-o_format", "netcdf3", "-verbose", "1"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        raise AssertionError(f"phase7a: python -m pism_tpu_torch -eisII B "
                             f"failed: {out.stderr[-2000:]}")
    sb, tb = ckpt.load_state(f["b"], device=dev)
    H = sb.geometry.ice_thickness
    if not bool(torch.isfinite(H).all()) or abs(tb - 1200 * SPY) > 1e-3:
        raise AssertionError(f"phase7a: -eisII B reached t = {tb}")
    print(f"phase7a: python -m pism_tpu_torch -eisII B -i a.nc -y 200: "
          f"{time.perf_counter() - t0:.1f} s (a new process), max H "
          f"{float(H.max()):.1f} m at {tb / SPY:.1f} a")


def phase7b_halfar(dev, d):
    """Halfar B through the CLI: 61x61 float64 on the card against
    -platform cpu and the exact solution; then K4's route at 601x601
    float32 against setups.halfar_model run by IceModel.run."""
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.util.timecal import Time
    from pism_tpu_torch.verification import halfar

    runs = {}
    for plat in ("cuda", "cpu"):
        f = os.path.join(d, f"b61_{plat}.nc")
        argv = ["-test", "B", "-Mx", "61", "-y", "1000", "-o", f,
                "-o_format", "netcdf3", "-verbose", "1"]
        if plat == "cpu":
            argv += ["-platform", "cpu"]
        runs[plat] = _cli(f"phase7b {plat}", argv, [f])
    (_, sg, stg, _), (_, sc, stc, _) = runs["cuda"], runs["cpu"]
    Hg = sg.geometry.ice_thickness.cpu()
    Hc = sc.geometry.ice_thickness
    rel = float((Hg - Hc).abs().max() / Hc.abs().max())
    sol = halfar.test_B()
    grid = runs["cuda"][0].grid
    t_end = sol.t0 + 1000 * SPY
    errs = halfar.error_norms(Hg.numpy(), sol.thickness(t_end, grid.radius))
    print(f"phase7b: 61x61 float64 card / cpu: steps {stg.nsteps} / "
          f"{stc.nsteps}, dt-limit hits {stg.limit_hits_dict()} / "
          f"{stc.limit_hits_dict()}, H max diff {rel:.3e} of max H (tol "
          f"1e-10); errors {errs}")
    if stg.nsteps != stc.nsteps \
            or stg.limit_hits_dict() != stc.limit_hits_dict() or not rel <= 1e-10:
        raise AssertionError("phase7b: the card and the cpu disagree")
    _halfar_errors("phase7b", errs, {"dome_H": 5.0, "avg_H": 15.0,
                                     "rel_volume": 0.01})

    f = os.path.join(d, "b601.nc")
    argv = ["-test", "B", "-Mx", "601", "-y", "20",
            "-config", "stress_balance.sia.surface_gradient_method=mahaffy",
            "-config", "stress_balance.sia.bed_smoother.range=0",
            "-config", "runtime.float_dtype=float32",
            "-o", f, "-o_format", "netcdf3", "-verbose", "1"]
    model, state, stats, counts = _cli("phase7b K4", argv, [f])
    _check_launches("phase7b K4", counts, ("sia_flux",),
                    tuple(k for k in KERNELS if k != "sia_flux"))
    ref, s0, _, sol = setups.halfar_model("B", Mx=601, dtype="float32",
                                          device=dev)
    rs, rst = ref.run(s0, Time(sol.t0, sol.t0 + 20 * SPY))
    print(f"phase7b K4: against setups.halfar_model + IceModel.run: steps "
          f"{stats.nsteps} / {rst.nsteps}, K4 launches {counts['sia_flux']} "
          f"(once per step)")
    if stats.nsteps != rst.nsteps or counts["sia_flux"] != stats.nsteps:
        raise AssertionError("phase7b K4: the CLI run and the reference differ")
    _equal("phase7b K4", [("thk", state.geometry.ice_thickness,
                           rs.geometry.ice_thickness)])
    profile_run(model, state, sol.t0 + 20 * SPY, 0.5, "phase7b K4")


def phase7c_restart(dev, d, model, state, t):
    """Phase 2b's end state (20 km, path A) saved and continued for 0.5 a
    by ``-i``, against an in-memory IceModel with zero SMB from the same
    state."""
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.util.timecal import Time

    f, g = os.path.join(d, "p2b.nc"), os.path.join(d, "p2b_cont.nc")
    ckpt.save_state(f, state, model.grid, t, config=model.config,
                    format="netcdf3")
    argv = ["-i", f, "-y", "0.5", "-o", g, "-o_format", "netcdf3",
            "-verbose", "1"]
    _, sc, stc, counts = _cli("phase7c", argv, [f, g])
    _check_launches("phase7c", counts,
                    ("ssa_matvec", "ssa_newton_matvec", "pcr_lines",
                     "pcr_lines_sub", "pcr_factor_lines",
                     "pcr_factor_lines_sub"),
                    ("ssa_matvec_jvp", "ssa_matvec_halo", "ssa_matvec_halo_jvp",
                     "ssa_newton_matvec_halo", "sia_flux_thermo", "sia_flux"))
    ref = IceModel(grid=model.grid, config=model.config,
                   surface=Uniform(smb=0.0), device=dev)
    rs, rst = ref.run(state, Time(t, t + 0.5 * SPY))
    print(f"phase7c: -i of the 20 km path A state at {t / SPY:.1f} a, 0.5 a "
          f"against IceModel(surface=Uniform(0)).run: steps {stc.nsteps} / "
          f"{rst.nsteps}, Newton sweeps {stc.ssa_newton_iters} / "
          f"{rst.ssa_newton_iters}, Krylov its {stc.ssa_krylov_iters} / "
          f"{rst.ssa_krylov_iters}")
    if (stc.nsteps, stc.ssa_newton_iters, stc.ssa_krylov_iters) != \
            (rst.nsteps, rst.ssa_newton_iters, rst.ssa_krylov_iters):
        raise AssertionError("phase7c: the restart and the reference differ")
    _equal("phase7c", [
        ("thk", sc.geometry.ice_thickness, rs.geometry.ice_thickness),
        ("enthalpy", sc.enthalpy, rs.enthalpy), ("u_ssa", sc.u_ssa, rs.u_ssa)])


def phase7_cli(dev, path_a):
    """The command line on the card (every file netcdf3, in a temporary
    directory): 7a EISMINT II A on K3, 7b Halfar B (K4), 7c the 20 km
    path A restart (K1, the Newton matvec, K2, K2b)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        phase7a_eismint(dev, d)
        phase7b_halfar(dev, d)
        phase7c_restart(dev, d, *path_a)


# -- phase 8: the std-greenland workflow ----------------------------------

def _same_bits(label, pairs):
    _equal(label, pairs)
    print(f"{label}: equal to the bit: {', '.join(n for n, _, _ in pairs)}")


def _python_stage(dev, cfg_path, grid, state, t0, years):
    """The stage a command line ran, driven from Python: its config (read
    back from its output), the coupler chains through the factory,
    ``IceModel.run`` from ``state``. Returns (state, stats)."""
    from pism_tpu_torch.coupler import factory as cf
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.util.timecal import Time

    cfg = ckpt.load_config(cfg_path)
    atm = cf.atmosphere_from_config(
        cfg, cf.inputs_from_files(cfg, grid, "atmosphere", dev), grid=grid)
    surface = cf.surface_from_config(
        cfg, cf.inputs_from_files(cfg, grid, "surface", dev), atmosphere=atm)
    model = IceModel(grid=grid, config=cfg, surface=surface, device=dev)
    return model.run(state, Time(t0, t0 + years * SPY))


def _with_climatic_mass_balance(src, dst):
    """A classic copy of the data file ``src`` with a climatic_mass_balance
    field, its precipitation less 300 kg m-2 year-1 (accumulation in the
    wet south, ablation in the dry north), so that the smb heuristic of
    io.bootstrap takes the Robin profile."""
    from pism_tpu_torch.io.nc4 import File

    with File(src, "r") as f:
        x, y = f.read("x"), f.read("y")
        fields = {n: (f.read(n), f.read_attrs(n)) for n in f.variables()}
        proj = f.get_global_attr("proj")
    with File(dst, "w", format="netcdf3") as f:
        f.define_dimension("y", len(y), y, attrs={"units": "m"})
        f.define_dimension("x", len(x), x, attrs={"units": "m"})
        for name, (a, attrs) in fields.items():
            f.write(name, a, ("y", "x"), attrs)
        f.write("climatic_mass_balance", fields["precipitation"][0] - 300.0,
                ("y", "x"), {"units": "kg m-2 year-1"})
        if proj:
            f.set_global_attr("proj", proj)


def _bootstrap_card_vs_cpu(dev, boot, grid, cfg, label, robin=False):
    """io.bootstrap.bootstrap on the card against the same on the CPU moved
    to the card: the regridded fields to the bit, E within float32
    rounding (``robin``: the file has a climatic_mass_balance, so E comes
    from the erf chain of the Robin profile); prints the host seconds of
    its parts. Returns the card's state."""
    import torch
    from pism_tpu_torch.io.bootstrap import bootstrap, read_and_regrid

    t0 = time.perf_counter()
    read_and_regrid(boot, grid)
    t_regrid = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg = bootstrap(boot, grid, cfg, device=dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = bootstrap(boot, grid, cfg, device="cpu")
    t_cpu = time.perf_counter() - t0
    g, c = sg.geometry, sc.geometry
    _same_bits(f"{label} bootstrap card / cpu", [
        ("thk", g.ice_thickness, c.ice_thickness.to(dev)),
        ("topg", g.bed_elevation, c.bed_elevation.to(dev)),
        ("bmelt", sg.basal_melt_rate, sc.basal_melt_rate.to(dev)),
        ("usurf", g.ice_surface_elevation, c.ice_surface_elevation.to(dev)),
        ("mask", g.cell_type, c.cell_type.to(dev))])
    Ec = sc.enthalpy.to(dev)
    if robin:
        # T = T_s + (G/k)(sqrt(pi)/2) q [erf(H/q) - erf(z/q)]: CUDA's erff
        # (2 ulps) and the CPU's (1 ulp) differ, which moves T by at most
        # 3 ulps of erf times (G/k)(sqrt(pi)/2) q, below (G/k) H ulps ~ one
        # ulp of T; with T's own roundings, 4 float32 ulps of T at the
        # melting point (2^-15 K each), times c_i into E [J/kg]
        c_i = cfg.get_number("constants.ice.specific_heat_capacity")
        tol = 4 * 2.0 ** -15 * c_i
        err = float((sg.enthalpy - Ec).abs().max())
        what = (f"E card / cpu max abs err {err:.4e} J/kg (tol {tol:.4e}, 4 "
                "float32 ulps of T at 273.15 K times c_i; the erf chain)")
    else:
        # E = enthalpy(min(T_s + G/k depth, T_m(p)), 0, p): a few float32
        # operations on each device, whose contraction may differ: 4 ulps
        tol = 4 * 2.0 ** -23
        err = _rel_err(sg.enthalpy, Ec)
        what = (f"E card / cpu max rel err {err:.3e} (tol {tol:.3e}, 4 "
                "float32 ulps)")
    n_diff = int((sg.enthalpy != Ec).sum())
    print(f"{label} bootstrap: {grid.My}x{grid.Mx}x{grid.Mz} from the "
          f"data file: host read + regrid {t_regrid:.3f} s, bootstrap on the "
          f"card {t_card:.3f} s (heuristic and the rest "
          f"{t_card - t_regrid:.3f} s), on the CPU {t_cpu:.3f} s; {what}, "
          f"{n_diff} of {sg.enthalpy.numel()} values differ")
    if not err <= tol:
        raise AssertionError(f"{label}: bootstrap E card / cpu {err:.3e}")
    return sg


def _recording_solve(orig, solves):
    """SSAFD.solve that keeps each solve's diagnostics (device scalars, read
    after the run) and returns what it returns."""
    def solve(*a, **k):
        out = orig(*a, **k)
        if k.get("diagnostics"):
            solves.append(out[2])
        return out
    return solve


def _print_solves(label, solves, nsteps):
    """Newton sweeps and the final |F|^2 against the tolerance of each SSA
    solve of a run."""
    sweeps = [int(i["newton_iters"]) for i in solves]
    ratio = [float(i["F2_final"] / i["tol2"]) for i in solves]
    met = sum(r <= 1.0 for r in ratio)
    print(f"{label}: {len(solves)} SSA solves over {nsteps} steps, Newton "
          f"sweeps {sweeps} ({sum(sweeps) / max(nsteps, 1):.2f} a step), "
          f"final |F|^2 / tolerance {[f'{r:.3e}' for r in ratio]}; "
          f"{met} of {len(solves)} reached the tolerance")


def _dirichlet_run(dev, d, src_state, grid, t, cfg):
    """The 20 km state with a strip of cells held at non-zero velocities
    (bc_mask, u_bc, v_bc in the -i file, stress_balance.ssa.dirichlet_bc),
    a cold SSA start: the velocity equals the BC there to the bit, and the
    lift of the BC values is a K1 launch per Picard sweep."""
    import numpy as np
    import torch
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.ops import ssa as ssa_ops

    H = src_state.geometry.ice_thickness.double().cpu().numpy()
    mask = np.zeros(H.shape)
    My, Mx = H.shape
    mask[int(0.3 * My):int(0.7 * My), int(0.4 * Mx)] = 1.0
    mask[H < 100.0] = 0.0
    u_bc = np.where(mask > 0, 100.0, 0.0)
    v_bc = np.where(mask > 0, -40.0, 0.0)
    f, g = os.path.join(d, "g_bc.nc"), os.path.join(d, "g_bc_out.nc")
    ckpt.save_state(f, src_state, grid, t, config=cfg, format="netcdf3",
                    extra_2d={"bc_mask": (mask, {}),
                              "u_bc": (u_bc, {"units": "m year-1"}),
                              "v_bc": (v_bc, {"units": "m year-1"})})
    fixed = torch.tensor(mask > 0, device=dev)
    bcu = torch.where(fixed, torch.tensor(u_bc / SPY, device=dev).float(), 0.0)
    seen = {"lift": 0, "picard": 0}

    def wrap(label, orig):
        def fn(*a, **k):
            # the lift: K1 on the BC values, called by the Picard sweep
            # itself (not through its matvec or the residual)
            if label == "apply" and sys._getframe(2).f_code.co_name == \
                    "picard_iter" and torch.equal(a[0], bcu):
                seen["lift"] += 1
            if label == "krylov" and getattr(a[0], "__name__", "") == "matvec":
                seen["picard"] += 1
            return orig(*a, **k)
        return fn

    argv = ["-i", f, "-y", "0.1", "-o", g, "-o_format", "netcdf3",
            "-config", "stress_balance.ssa.dirichlet_bc=true",
            "-config", "stress_balance.ssa.read_initial_guess=false",
            "-verbose", "1"]
    with _patched([(ssa_ops, "apply_operator", "apply"),
                   (ssa_ops, "bicgstab_solve", "krylov")], wrap):
        _, st, stats, counts = _cli("phase8a dirichlet", argv, [f, g])
    on = fixed
    _same_bits("phase8a dirichlet u, v on the BC strip", [
        ("u", st.u_ssa[on], bcu[on]),
        ("v", st.v_ssa[on], torch.where(
            fixed, torch.tensor(v_bc / SPY, device=dev).float(), 0.0)[on])])
    print(f"phase8a dirichlet: {int(on.sum())} BC cells; K1 launches "
          f"{counts['ssa_matvec']}, of which {seen['lift']} the lift, one per "
          f"Picard sweep ({seen['picard']} sweeps); Newton sweeps "
          f"{stats.ssa_newton_iters}, Krylov its {stats.ssa_krylov_iters}")
    if seen["lift"] != seen["picard"] or seen["lift"] == 0:
        raise AssertionError("phase8a dirichlet: the lift is not one K1 "
                             "launch per Picard sweep")


def phase8_workflow(dev, d, data_km=5.0, model_km=20.0,
                    years=(10.0, 10.0, 1.0), years_b=(0.01, 0.05)):
    """The std-greenland workflow through the command line at published
    widths, float32, every file netcdf3: (a) the 5 km data file bootstrapped
    onto the 20 km grid, stages 1-3 (``years``), each equal to the bit to
    the same stage driven from Python, and a -ssa_dirichlet_bc run; (b) the
    5 km bootstrap (the identity regrid) and a short stage 3 (``years_b``:
    the bootstrap stage's and stage 3's lengths)."""
    import numpy as np
    import torch
    from pism_tpu_torch import Config, Grid
    from pism_tpu_torch.examples.std_greenland_workflow import (
        SEARISE_PROJ, stage_argv, synthesize_bootstrap_file, volume_of)
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.io.nc4 import File
    from pism_tpu_torch.model.ssa import SSAFD
    from pism_tpu_torch.util import nccmp

    boot = os.path.join(d, "g_boot.nc")
    t0 = time.perf_counter()
    nx, ny = synthesize_bootstrap_file(boot, data_km, "netcdf3", SEARISE_PROJ)
    print(f"phase8: data file {nx}x{ny} ({data_km:g} km) written in "
          f"{time.perf_counter() - t0:.3f} s, {os.path.getsize(boot)} bytes")
    files = tuple(os.path.join(d, n) for n in
                  ("g_pre.nc", "g_nomass.nc", "g_spunup.nc"))
    argv = stage_argv(boot, files, model_km, years, "netcdf3")
    argv[2].extend(["-config",
                    "stress_balance.ssa.fd.line_pcr_impl=pallas_sublane"])
    grid = Grid(Mx=int(1500 / model_km) + 1, My=int(2800 / model_km) + 1,
                Mz=41, Lx=750e3, Ly=1400e3, Lz=4000.0)
    cfg = Config({"runtime.float_dtype": "float32",
                  "atmosphere.searise_greenland.file": boot})
    s_boot = _bootstrap_card_vs_cpu(dev, boot, grid, cfg, "phase8a")
    # the smb heuristic's Robin profile, from a copy with an SMB field
    boot_cmb = os.path.join(d, "g_boot_cmb.nc")
    _with_climatic_mass_balance(boot, boot_cmb)
    s_robin = _bootstrap_card_vs_cpu(dev, boot_cmb, grid, cfg,
                                     "phase8a smb", robin=True)
    if torch.equal(s_robin.enthalpy, s_boot.enthalpy):
        raise AssertionError("phase8a smb: the bootstrap did not take the "
                             "Robin profile")

    pcr = ("pcr_lines", "pcr_lines_sub", "pcr_factor_lines",
           "pcr_factor_lines_sub")
    k1 = ("ssa_matvec", "ssa_newton_matvec")
    off = ("ssa_matvec_jvp", "ssa_matvec_halo", "ssa_matvec_halo_jvp",
           "ssa_newton_matvec_halo", "sia_flux_thermo", "sia_flux")
    results, t_prev, prev = [], 0.0, s_boot
    for k, label in enumerate(("phase8a stage1", "phase8a stage2",
                               "phase8a stage3")):
        model, st, stats, counts = _cli(label, argv[k], [files[k]])
        if k < 2:
            _check_launches(label, counts, (), k1 + pcr + off)
        else:
            _check_launches(label, counts, k1 + pcr, off)
        solves = []
        with _patched([(SSAFD, "solve", "solve")],
                      lambda _, orig: _recording_solve(orig, solves)):
            ref, rst = _python_stage(dev, files[k], grid, prev, t_prev,
                                     years[k])
        if solves:
            _print_solves(label, solves, rst.nsteps)
        pairs = [("thk", st.geometry.ice_thickness, ref.geometry.ice_thickness),
                 ("enthalpy", st.enthalpy, ref.enthalpy)]
        if k == 2:
            pairs += [("u_ssa", st.u_ssa, ref.u_ssa)]
        counts_py = (rst.nsteps, rst.ssa_newton_iters, rst.ssa_krylov_iters)
        if (stats.nsteps, stats.ssa_newton_iters, stats.ssa_krylov_iters) \
                != counts_py:
            raise AssertionError(f"{label}: the CLI and Python differ")
        _same_bits(f"{label} CLI / io.bootstrap + factory + IceModel.run "
                   f"(steps, Newton, Krylov {counts_py})", pairs)
        for name, f in (("thk", st.geometry.ice_thickness),
                        ("enthalpy", st.enthalpy)):
            if not bool(torch.isfinite(f).all()):
                raise AssertionError(f"{label}: non-finite {name}")
        results.append((st, stats, volume_of(files[k])[0]))
        prev, t_prev = ckpt.load_state(files[k], device=dev)
    _same_bits("phase8a stage2 thk / stage1 thk", [
        ("thk", results[1][0].geometry.ice_thickness,
         results[0][0].geometry.ice_thickness)])
    v1, v2, v3 = (r[2] for r in results)
    print(f"phase8a: volumes {v1:.1f} / {v2:.1f} / {v3:.1f} km^3 (stage 3 "
          f"above 0.2x stage 1: {v3 > 0.2 * v1})")
    if not (v3 > 0.2 * v1 and abs(v2 - v1) < 0.02 * v1):
        raise AssertionError("phase8a: the workflow's check failed")
    st3 = results[2][0]
    _check_hybrid_state("phase8a stage3", st3, grid, results[2][1],
                        t_prev, sum(years) * SPY)
    with File(files[2], "r") as f:
        if f.get_global_attr("proj") != SEARISE_PROJ \
                or not f.has_variable("lat_bnds"):
            raise AssertionError("phase8a: no projection in the output")
    # the stage-1 output's lat/lon as util/projection.py gives them
    from pism_tpu_torch.util import projection as prj
    lon, lat = prj.lonlat_for_grid(grid, prj.from_proj_string(SEARISE_PROJ))
    with File(files[0], "r") as f:
        if not (np.array_equal(f.read("lat"), lat)
                and np.array_equal(f.read("lon"), lon)):
            raise AssertionError("phase8a: lat/lon differ from the projection")
    if nccmp.compare(files[0], files[1], ["lat", "lon", "lat_bnds"]):
        raise AssertionError("phase8a: lat/lon changed between stages")
    _dirichlet_run(dev, d, st3, grid, t_prev, ckpt.load_config(files[2]))

    # 8b: the 5 km bootstrap (the identity regrid) and a short stage 3
    g5 = Grid(Mx=nx, My=ny, Mz=41, Lx=750e3, Ly=1400e3, Lz=4000.0)
    s5 = _bootstrap_card_vs_cpu(dev, boot, g5, cfg, "phase8b")
    with File(boot, "r") as f:
        thk = np.maximum(np.nan_to_num(f.read("thk")), 0.0)
    _same_bits("phase8b identity regrid thk", [
        ("thk", s5.geometry.ice_thickness,
         torch.tensor(thk, device=dev).float())])
    f5 = tuple(os.path.join(d, n) for n in ("g5_boot.nc", "", "g5_spun.nc"))
    a5 = stage_argv(boot, f5, data_km, (years_b[0], 0.0, years_b[1]),
                    "netcdf3")
    _cli("phase8b bootstrap", a5[0], [f5[0]])
    a5[2][a5[2].index("-i") + 1] = f5[0]
    a5[2].extend(["-config",
                  "stress_balance.ssa.fd.line_pcr_impl=pallas_sublane"])
    _, st5, stats5, counts5 = _cli("phase8b stage3", a5[2], [f5[0], f5[2]])
    _check_launches("phase8b stage3", counts5, k1 + pcr, off)
    _, t5 = ckpt.load_state(f5[2], device=dev)
    _check_hybrid_state("phase8b stage3", st5, g5, stats5, t5,
                        sum(years_b) * SPY)


# -- phase 9: the PISM-PIK Antarctic chain -------------------------------

#: the JAX example's width (251 x 251 x 31) and first segment; the timed
#: window after it and the components' window
PIK_KM, PIK_FIRST, PIK_WINDOW, PIK_PARTS = 16.0, 10.0, 5.0, 3.0
#: the card-against-CPU chain: 125 km (33 x 33 x 31); at 50-100 km the
#: reference's PICO gives non-finite melt on the initial state
PIK_CHECK_KM = 125.0


def _pik_fields(state):
    return {"thk": state.geometry.ice_thickness, "enthalpy": state.enthalpy,
            "u_ssa": state.u_ssa, "v_ssa": state.v_ssa,
            "topg": state.geometry.bed_elevation,
            "viscous_bed_displacement": state.bed_uplift}


def _pik_check(label, model, state, grid, stats, t, t_want):
    """Finite fields of the expected shapes, the steps reached ``t_want``,
    a shelf with PICO melt under it. Returns the floating mask."""
    import torch
    from pism_tpu_torch import state as S
    for name, f in _pik_fields(state).items():
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    if tuple(state.enthalpy.shape) != grid.shape3 \
            or tuple(state.bed_uplift.shape) != grid.shape2:
        raise AssertionError(f"{label}: field shapes")
    if stats.nsteps <= 0 or abs(t - t_want) > 1e-3:
        raise AssertionError(f"{label}: {stats.nsteps} steps reached t = {t}")
    floating = S.floating_ice(state.geometry.cell_type)
    melt = model.ocean(state.geometry, t)
    if not bool(floating.any()) or not float(melt[floating].max()) > 0.0:
        raise AssertionError(f"{label}: no shelf with PICO melt under it")
    return floating


def _pik_report(label, grid, years, stats, wall, counts, state, floating):
    """The JAX example's keys (volume, shelf area, max speed) beside ms per
    step, steps per model year, the solver counts and launches per step."""
    n = stats.nsteps
    H = state.geometry.ice_thickness.double()
    per = {k: round(v / n, 2) for k, v in counts.items() if v} if counts \
        else {}
    print(f"{label}: grid {grid.My}x{grid.Mx}x{grid.Mz} "
          f"{str(state.geometry.ice_thickness.dtype)[6:]}, {years:g} a: steps "
          f"{n}, wall {wall:.3f} s, {1e3 * wall / n:.2f} ms/step, "
          f"{n / years:.2f} steps per model year, dt-limit hits "
          f"{stats.limit_hits_dict()}, Newton sweeps {stats.ssa_newton_iters / n:.2f}"
          f"/step, Krylov its {stats.ssa_krylov_iters / n:.2f}/step, host syncs "
          f"{stats.host_syncs / n:.1f}/step, launches per step {per}; "
          f"volume_1e6_km3 {float(H.sum()) * grid.dx * grid.dy / 1e15:.6f}, "
          f"shelf_area_1e3_km2 "
          f"{float(floating.sum()) * grid.dx * grid.dy / 1e9:.1f}, "
          f"max_speed_m_a {float(state.u_ssa.abs().max()) * SPY:.2f}, "
          f"calving {float(stats.sum_calving) / 1e9:.3f} km^3, discharge "
          f"{float(stats.sum_discharge) / 1e9:.3f} km^3, sub-shelf and basal "
          f"melt {float(stats.sum_bmb) / 1e9:.3f} km^3")


def _component_times(targets, run):
    """``run()`` with each (object, attribute, label) of ``targets`` timed
    inclusively by host timers, the card synchronised on entry and exit
    of every call; the label "PICO" also counts its calls and host syncs.
    Returns (run's result, seconds per label, {"n", "syncs"}, wall s)."""
    import torch
    from pism_tpu_torch.util import hostsync

    acc = {lab: 0.0 for _, _, lab in targets}
    calls = {"n": 0, "syncs": 0}

    def wrap(lab, orig):
        def timed(*a, **k):
            torch.cuda.synchronize()
            s0, t0 = hostsync.COUNT, time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            acc[lab] += time.perf_counter() - t0
            if lab == "PICO":
                calls["n"] += 1
                calls["syncs"] += hostsync.COUNT - s0
            return out
        return timed

    with _patched(targets, wrap):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, acc, calls, wall


def pik_components(model, state, t, years, label):
    """Inclusive ms per step of PICO, calving and Lingle-Clark (and the
    stress balance and mass transport around them), from host timers with
    the card synchronised on entry and exit, and the host syncs one PICO
    call takes."""
    import torch

    targets = [(model.stress_balance, "update", "stress balance"),
               (model, "_mass_substep", "mass transport (PICO inside)"),
               (model.ocean, "inputs", "PICO"),
               (model.calving, "step", "calving"),
               (model.bed_deformation, "step", "Lingle-Clark")]
    (state, t, stats), acc, calls, wall = _component_times(
        targets, lambda: model.step_once(state, t, years * SPY))
    n = stats.nsteps
    parts = ", ".join(f"{lab} {1e3 * v / n:.1f}" for lab, v in acc.items())
    # the bed solves once per update interval: one solve alone
    lc = model.bed_deformation
    lc._solve(state, lc.update_interval)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lc._solve(state, lc.update_interval)
    torch.cuda.synchronize()
    lc_ms = 1e3 * (time.perf_counter() - t0)
    print(f"{label}: timed {n} steps, {1e3 * wall / n:.1f} ms/step; inclusive "
          f"ms/step: {parts}; PICO {calls['n']} calls ({calls['n'] / n:.0f} "
          f"per step), {calls['syncs'] / max(calls['n'], 1):.1f} host syncs "
          f"per call; one Lingle-Clark solve {lc_ms:.2f} ms (one per "
          f"{lc.update_interval / SPY:g} a)")
    return state, t


def phase9a_pik(dev, k1, pcr, off):
    """The PIK chain at 16 km float32 on path A: the JAX example's first
    10 a, a timed window, the components' window; PICO melting the shelf.
    Returns the first segment's launch counts."""
    import torch
    from pism_tpu_torch import setups

    model, state, grid = setups.antarctica_pik_model(
        "float32", PIK_KM, device=dev, extra_cfg=PATH_A)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, t, s1 = model.step_once(state, 0.0, PIK_FIRST * SPY)
    torch.cuda.synchronize()
    w1 = time.perf_counter() - t0
    counts = read_counts()
    _check_launches("phase9a", counts, k1 + pcr, off)
    floating = _pik_check("phase9a", model, state, grid, s1, t,
                          PIK_FIRST * SPY)
    _pik_report(f"phase9a first {PIK_FIRST:g} a", grid, PIK_FIRST, s1, w1,
                counts, state, floating)
    reset_counts()
    t0 = time.perf_counter()
    state, t, s2 = model.step_once(state, t, PIK_WINDOW * SPY)
    torch.cuda.synchronize()
    w2 = time.perf_counter() - t0
    c2 = read_counts()
    floating = _pik_check("phase9a", model, state, grid, s2, t,
                          (PIK_FIRST + PIK_WINDOW) * SPY)
    _pik_report(f"phase9a timed {PIK_WINDOW:g} a", grid, PIK_WINDOW, s2, w2,
                c2, state, floating)
    # the example's uniform atmosphere rains on the ocean too: the mass
    # step turns every ocean cell into a floating film, no front is left
    # (phase 9c's data file keeps the ocean dry and calves)
    _pik_calving("phase9a", model, state, t,
                 float(s1.sum_calving) + float(s2.sum_calving))
    pik_components(model, state, t, PIK_PARTS, "phase9a components")
    return counts


def _pik_calving(label, model, state, t, calved):
    """Prints the calving volume, the eigen-calving rate at the front, the
    ice-free ocean cells and the thinnest floating ice; returns (calving
    volume, max eigen-calving rate)."""
    from pism_tpu_torch import state as S
    from pism_tpu_torch.model import diagnostics as dg
    eigen = dg.SPATIAL["eigen_calving_rate"].func(state, model, t)
    g = state.geometry
    floating = S.floating_ice(g.cell_type)
    print(f"{label}: calving {calved / 1e9:.3f} km^3, eigen-calving rate at "
          f"the front up to {float(eigen.max()) * SPY:.1f} m/a on "
          f"{int((eigen > 0).sum())} cells; ice-free ocean cells "
          f"{int((g.cell_type == S.MASK_ICE_FREE_OCEAN).sum())}, floating "
          f"cells {int(floating.sum())}, the thinnest "
          f"{float(g.ice_thickness[floating].min()):.3f} m")
    return calved, float(eigen.max())


def phase9b_card_vs_cpu(dev):
    """The chain at PIK_CHECK_KM in float64 on path A, on the card and on
    the CPU from the same state: one step from 9.5 a (across the
    Lingle-Clark update at 10 a; its SSA solve starts from equal states)
    with the fields held close, then on to 12 a with equal steps and
    dt-limit hits and the volume in the 2e-4 envelope (the chain's later
    solves stop on stagnation, so the trajectories part as rounding
    decides); then on the CPU's end geometry PICO's box index, d_gl and
    d_if equal on card and CPU, and one Lingle-Clark solve (cuFFT against
    pocketFFT) within 1e-12."""
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.convert import state_to_numpy
    from pism_tpu_torch.state import map_tensors

    def rel(a, b, name):
        return float(abs(a[name] - b[name]).max() / abs(a[name]).max())

    runs = {}
    for where in ("cpu", dev):
        model, state, grid = setups.antarctica_pik_model(
            "float64", PIK_CHECK_KM, device=where, extra_cfg=PATH_A)
        init = map_tensors(state, lambda x: x.cpu())
        state, t, s1 = model.step_once(state, 9.5 * SPY, 1.0 * SPY)
        one = state_to_numpy(state)
        state, t, s2 = model.step_once(state, t, 12.0 * SPY - t)
        runs[str(where)] = (model, state, (s1, s2), one)
    (mc, sc, stc, a1), (md, sd, std, b1) = runs["cpu"], runs[str(dev)]
    errs = {n: rel(a1, b1, n) for n in ("ice_thickness", "enthalpy", "u_ssa",
                                        "bed_elevation", "bed_uplift")}
    vol = [abs(float(x["ice_thickness"].sum()) - float(y["ice_thickness"].sum()))
           / float(x["ice_thickness"].sum())
           for x, y in ((a1, b1), (state_to_numpy(sc), state_to_numpy(sd)))]
    tol = {"ice_thickness": 1e-8, "enthalpy": 1e-8, "u_ssa": 1e-6,
           "bed_elevation": 1e-8, "bed_uplift": 1e-8}
    print(f"phase9b: {PIK_CHECK_KM:g} km float64, card vs cpu: one step "
          f"9.5-10.5 a: steps {std[0].nsteps} / {stc[0].nsteps}, errors of "
          f"max {', '.join(f'{n} {e:.3e} (tol {tol[n]:.0e})' for n, e in errs.items())}, "
          f"volume {vol[0]:.3e} (tol 1e-10); to 12 a: steps {std[1].nsteps} / "
          f"{stc[1].nsteps}, dt-limit hits {std[1].limit_hits_dict()} / "
          f"{stc[1].limit_hits_dict()}, volume {vol[1]:.3e} (tol 2e-4)")
    if any(x.nsteps != y.nsteps or x.limit_hits_dict() != y.limit_hits_dict()
           for x, y in zip(std, stc)) \
            or any(errs[n] > tol[n] for n in tol) \
            or not (vol[0] <= 1e-10 and vol[1] <= 2e-4):
        raise AssertionError("phase9b: the card and the CPU disagree")
    for name, src in (("initial", init), ("end", sc)):
        geom = {str(w): map_tensors(src, lambda x: x.to(w))
                for w in ("cpu", dev)}
        pc = mc.ocean.boxes(geom["cpu"].geometry)
        pd = md.ocean.boxes(geom[str(dev)].geometry)
        same = [torch.equal(x, y.cpu()) for x, y in zip(pc, pd)]
        nb = torch.bincount(pc.box.flatten(), minlength=6).tolist()
        print(f"phase9b: PICO on the CPU's {name} geometry, card vs cpu: box, "
              f"d_gl, d_if equal {same}; cells per box {nb}")
        if not all(same):
            raise AssertionError("phase9b: PICO's boxes differ on the card")
    load = geom["cpu"].geometry.ice_thickness * 1.05
    beds = []
    for w in ("cpu", dev):
        st = geom[str(w)]
        st = st.replace(geometry=st.geometry.replace(
            ice_thickness=load.to(w)))
        out = runs[str(w)][0].bed_deformation._solve(st, 10.0 * SPY)
        beds.append((out.geometry.bed_elevation.cpu(), out.bed_uplift.cpu()))
    errs = [float((x - y).abs().max() / x.abs().max())
            for x, y in zip(*beds)]
    print(f"phase9b: one Lingle-Clark solve (10 a, load +5%), cuFFT vs "
          f"pocketFFT: bed {errs[0]:.3e}, viscous displacement {errs[1]:.3e} "
          f"of their max (tol 1e-12)")
    if not max(errs) <= 1e-12:
        raise AssertionError("phase9b: the Lingle-Clark solves differ")


def phase9c_cli(dev, d, k1, pcr, off, years=1.0, km=PIK_KM, platform=()):
    """The PIK chain's command line at 16 km float32 on path A from a
    synthetic data file (netcdf3, its ocean dry): -bootstrap with the PIK
    flags for ``years`` (the bed updated every year), equal to the bit to
    the same run driven from Python; then a plain -i restart for
    ``years``, equal to the bit to the first run continued in memory; eigen
    calving acting on the fronts over both."""
    import torch
    from pism_tpu_torch.examples.antarctica_pik import (
        bootstrap_argv, couplers, model_grid, synthesize_data_file)
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.io.bootstrap import bootstrap
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.util.timecal import Time

    data = os.path.join(d, "ant.nc")
    t0 = time.perf_counter()
    synthesize_data_file(data, km, "netcdf3")
    print(f"phase9c: data file {os.path.getsize(data)} bytes written in "
          f"{time.perf_counter() - t0:.3f} s")
    o1, o2 = os.path.join(d, "ant_1.nc"), os.path.join(d, "ant_2.nc")
    argv = bootstrap_argv(data, o1, km, years, "netcdf3", extra=(
        "-config", "bed_deformation.update_interval=1",
        "-config", "stress_balance.ssa.fd.line_pcr_impl=pallas_sublane",
        *platform))
    model, st1, stats1, counts = _cli("phase9c bootstrap", argv, [o1])
    _check_launches("phase9c bootstrap", counts, k1 + pcr, off)
    _pik_check("phase9c bootstrap", model, st1, model.grid, stats1,
               years * SPY, years * SPY)
    # the same run from Python
    cfg = ckpt.load_config(o1)
    grid = model_grid(km)
    surface, ocean = couplers(cfg, grid, data, dev)
    twin = IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean,
                    device=dev)
    st, stats = twin.run(bootstrap(data, grid, cfg, device=dev),
                         Time(0.0, years * SPY))
    if (stats.nsteps, stats.ssa_newton_iters, stats.ssa_krylov_iters) != \
            (stats1.nsteps, stats1.ssa_newton_iters, stats1.ssa_krylov_iters):
        raise AssertionError("phase9c: the CLI and Python differ in counts")
    _same_bits(f"phase9c CLI / io.bootstrap + factory + IceModel.run (steps "
               f"{stats.nsteps})", [(k, v, _pik_fields(st)[k])
                                    for k, v in _pik_fields(st1).items()])
    # a plain -i restart against the run continued in memory
    _, st2, stats2, counts2 = _cli(
        "phase9c restart", ["-i", o1, "-y", f"{years:g}", "-o", o2,
                            "-o_format", "netcdf3", "-verbose", "1",
                            *platform], [o1, o2])
    _check_launches("phase9c restart", counts2, k1 + pcr, off)
    cont, stc = model.run(st1, Time(years * SPY, 2.0 * years * SPY))
    if stc.nsteps != stats2.nsteps:
        raise AssertionError("phase9c: the restart took other steps")
    _same_bits(f"phase9c -i restart / in-memory continuation (steps "
               f"{stc.nsteps})", [(k, v, _pik_fields(cont)[k])
                                  for k, v in _pik_fields(st2).items()])
    if torch.equal(st2.bed_uplift, st1.bed_uplift):
        raise AssertionError("phase9c: the restart did not move the bed")
    calved, eigen = _pik_calving(
        "phase9c", model, st2, 2.0 * years * SPY,
        float(stats1.sum_calving) + float(stats2.sum_calving))
    if not (calved < 0.0 and eigen > 0.0):
        raise AssertionError("phase9c: no calving, or no eigen-calving rate")
    _eigen_retreat("phase9c", model, st2, 2.0 * years * SPY)


def _eigen_retreat(label, model, state, t):
    """One calving step on ``state`` over the dt that moves the fastest
    front cell half a cell, with the model's eigen-calving K and with K =
    0: the eigen run holds no more ice anywhere (H + Href), and less at
    the front cells where eigen_calving_rate * dt > 0 or at their
    neighbours (part-grid turns a front cell facing open water into a
    partial cell, and shrinks the partial cells seaward of it first)."""
    from types import SimpleNamespace

    from pism_tpu_torch.model import diagnostics as dg
    cm = model.calving
    rate = dg.SPATIAL["eigen_calving_rate"].func(state, model, t)
    dt = 0.5 * model.grid.dx / float(rate.max())
    sb = SimpleNamespace(u_ssa=state.u_ssa, v_ssa=state.v_ssa)
    hard = model._calving_hardness(state)
    content = []
    K = cm.eigen_K
    for k in (K, 0.0):
        cm.eigen_K = k
        try:
            g = cm.step(state.geometry, sb, dt, t=t, hardness_B=hard)
        finally:
            cm.eigen_K = K
        content.append(g.ice_thickness + g.ice_area_specific_volume)
    loss = content[1] - content[0]
    acting = rate * dt > 0.0
    sh = model.sh
    near = acting | sh(acting, 0, 1) | sh(acting, 0, -1) \
        | sh(acting, 1, 0) | sh(acting, -1, 0)
    fell = near & (loss > 0.0)
    print(f"{label}: one calving step of {dt / SPY:.4f} a against K = 0: "
          f"{int(acting.sum())} front cells with eigen_calving_rate * dt > "
          f"0, {int(fell.sum())} cells at or next to them lost ice, "
          f"{float(loss.sum()) * model.grid.dx * model.grid.dy / 1e9:.3f} "
          f"km^3 in all, min loss {float(loss.min()):.3e} m")
    if not (bool(fell.any()) and float(loss.min()) >= 0.0):
        raise AssertionError(f"{label}: eigen calving removes no ice at the "
                             f"front")


def phase9_pik(dev, k1, pcr, off):
    import tempfile
    counts = phase9a_pik(dev, k1, pcr, off)
    phase9b_card_vs_cpu(dev)
    with tempfile.TemporaryDirectory() as d:
        phase9c_cli(dev, d, k1, pcr, off)
    return counts


# -- phase 10: MISMIP3d and MISMIP experiment 1 (BASELINE config 2) --------

#: model years of phase 10a at 1 km: Stnd's first window, its timed window,
#: P75S, P75R (cut from the protocol's 15,000 + 100 + 2,000 a)
MISMIP3D_YEARS = (5.0, 30.0, 10.0, 10.0)
#: phase 10b's span at 50 km and phase 10c's spans at 151x7 (f32, f64)
MISMIP3D_CHECK_YEARS, MISMIP1_YEARS = 30.0, (10.0, 10.0)


def _mismip_check(label, state, grid, dtype):
    """Finite fields of the run's shape and dtype."""
    import torch
    g = state.geometry
    for name, f in (("ice_thickness", g.ice_thickness),
                    ("ice_area_specific_volume", g.ice_area_specific_volume),
                    ("cell_grounded_fraction", g.cell_grounded_fraction),
                    ("u_ssa", state.u_ssa), ("v_ssa", state.v_ssa)):
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{label}: non-finite {name}")
        if tuple(f.shape) != grid.shape2 or f.dtype != dtype:
            raise AssertionError(f"{label}: {name} is {tuple(f.shape)} "
                                 f"{f.dtype}")
    if state.enthalpy is not None:
        raise AssertionError(f"{label}: an enthalpy field without energy")


def _mismip_run(model, state, t, years):
    """``years`` of ``IceModel.run`` from t: (state, t, stats, wall s)."""
    import torch
    from pism_tpu_torch import Time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = model.run(state, Time(t, t + years * SPY))
    torch.cuda.synchronize()
    return state, t + years * SPY, stats, time.perf_counter() - t0


def _mismip_report(label, grid, years, stats, wall, counts, state):
    n = stats.nsteps
    H = state.geometry.ice_thickness.double()
    per = {k: round(v / n, 2) for k, v in counts.items() if v}
    print(f"{label}: {grid.My}x{grid.Mx} {str(state.geometry.ice_thickness.dtype)[6:]}, "
          f"{years:g} a: steps {n} ({n / years:.2f} per model year), wall "
          f"{wall:.3f} s, {1e3 * wall / n:.2f} ms/step, dt-limit hits "
          f"{stats.limit_hits_dict()}, Newton sweeps "
          f"{stats.ssa_newton_iters / n:.2f}/step, Krylov its "
          f"{stats.ssa_krylov_iters / n:.2f}/step, host syncs "
          f"{stats.host_syncs / n:.1f}/step, launches per step {per}, "
          f"volume {float(H.sum()) * grid.dx * grid.dy / 1e9:.6f} km^3, "
          f"max |u| {float(state.u_ssa.abs().max()) * SPY:.2f} m/a")


def check_path_kernels(model, state, t, label, phase):
    """K1 and the line kernels K2/K2b on a state's own linearization and
    preconditioner systems, at the shapes its path gives them (the u-lines
    along x, the v-lines along y), each against its plain version: K1 at
    1e-5 in float32 on a random direction of the velocity's size, the PCR
    factor and apply to the bit; then the Newton matvec
    (``check_newton_matvec``)."""
    import math
    import torch
    from pism_tpu_torch.ops import ssa as ssa_ops
    from pism_tpu_torch.ops.kernels import pcr as K2
    from pism_tpu_torch.ops.kernels import ssa_matvec as K

    grid = model.grid
    P = model.ssa.build_problem(state, model.yield_stress.compute(state, t=t))
    u, v = P["free"]((state.u_ssa, state.v_ssa))
    nuH, beta = P["make_nuH"](u, v), P["beta_fn"](u, v)
    g = torch.Generator(device=u.device).manual_seed(13)
    du, dv, ru, rv = (torch.randn(u.shape, generator=g, device=u.device,
                                  dtype=u.dtype) for _ in range(4))
    du, dv = du * u.abs().max(), dv * u.abs().max()
    shape = f"{grid.My}x{grid.Mx} {str(u.dtype)[6:]} {label}"
    _kernel_case("ssa_matvec", K.ssa_matvec, K.ssa_matvec_plain,
                 (du, dv, nuH.e, nuH.n, beta, grid.dx, grid.dy), 1e-5, shape,
                 OPS["ssa_matvec"] * grid.My * grid.Mx, reps=50,
                 match="ssa_matvec_tile", phase=phase)
    au, cu, bu, av, cv, bv = ssa_ops.line_systems(
        nuH, beta, P["bc_mask"], grid.dx, grid.dy, model.ssa.sh)
    field = grid.My * grid.Mx * u.element_size()
    for name, make, make_plain, a, c, r, b, n in (
            ("pcr_lines", K2.pcr_factor_lines, K2.pcr_factor_lines_plain,
             au, cu, ru, bu, grid.Mx),
            ("pcr_lines_sub", K2.pcr_factor_lines_sub,
             K2.pcr_factor_lines_sub_plain, av, cv, rv, bv, grid.My)):
        rounds = math.ceil(math.log2(n))
        lines = f"n={n} batch={grid.My * grid.Mx // n} {shape}"
        f, fp = make(a, None, c), make_plain(a, None, c)
        _kernel_case(name, lambda r_, s_: K2.pcr_apply(f, r_, s_),
                     lambda r_, s_: K2.pcr_apply_plain(fp, r_, s_), (r, b),
                     0.0, f"apply {lines}",
                     (OPS["pcr_apply_round"] * rounds + 2) * grid.My * grid.Mx,
                     reps=50, match="pcr_apply_kernel", nbytes=5 * field,
                     phase=phase)
        _kernel_case(name.replace("pcr_", "pcr_factor_"),
                     lambda a_, c_: make(a_, None, c_),
                     lambda a_, c_: make_plain(a_, None, c_), (a, c), 0.0,
                     f"{lines}; table {f.table.numel() * 4} bytes",
                     OPS["pcr_factor_round"] * rounds * grid.My * grid.Mx,
                     reps=50, match="pcr_factor_kernel",
                     nbytes=2 * field + f.table.numel() * 4,
                     unpack=lambda f_: f_.coefficients(), phase=phase)
    check_newton_matvec(model, state, t, f"{grid.My}x{grid.Mx} {label}",
                        phase)


def phase10a_mismip3d(dev, k1, pcr, off):
    """MISMIP3d at 1 km (1601 x 101) float32 on path A through
    ``IceModel.run``: Stnd from the Vialov start, a timed Stnd window, then
    P75S and P75R with ``GivenYieldStress`` fields as the example builds
    them; the grounding line on the centre and edge rows after each
    phase. After the timed Stnd window, K1, the Newton matvec and K2/K2b
    are held against their plain versions on that state's own systems
    (``check_path_kernels``)."""
    import dataclasses
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.physics.basal import GivenYieldStress
    from pism_tpu_torch.verification import mismip as m3

    model, state, grid = setups.mismip3d_model("float32", km=1.0, device=dev,
                                               extra_cfg=PATH_A)
    mid, edge = grid.My // 2, 0
    first, timed, p75s, p75r = MISMIP3D_YEARS
    print(f"phase10a: MISMIP3d {grid.Mx}x{grid.My} (dx {grid.dx:.0f} m), "
          f"tau_c0 {m3.TAU_C0:.1f} Pa; grounding line at the start: centre "
          f"{m3.gl_x(state, grid, mid) / 1e3:.3f} km, edge "
          f"{m3.gl_x(state, grid, edge) / 1e3:.3f} km")
    t, gl_stnd = 0.0, None
    for label, years, ys in (
            ("Stnd first", first, None), ("Stnd timed", timed, None),
            ("P75S", p75s, "pert"), ("P75R", p75r, None)):
        m = model
        if ys == "pert":
            m = dataclasses.replace(model, yield_stress=GivenYieldStress(
                model.config, tau_c=m3.tau_c_perturbed(grid, m3.TAU_C0,
                                                       gl_stnd)))
        reset_counts()
        state, t, stats, wall = _mismip_run(m, state, t, years)
        counts = read_counts()
        _mismip_check(f"phase10a {label}", state, grid, torch.float32)
        _check_launches(f"phase10a {label}", counts, k1 + pcr, off)
        _mismip_report(f"phase10a {label}", grid, years, stats, wall, counts,
                       state)
        gl_c, gl_e = m3.gl_x(state, grid, mid), m3.gl_x(state, grid, edge)
        print(f"phase10a {label}: grounding line centre {gl_c / 1e3:.3f} km, "
              f"edge {gl_e / 1e3:.3f} km")
        if not (0.0 < gl_e and 0.0 < gl_c < 800e3):
            raise AssertionError(f"phase10a {label}: no grounding line")
        if label == "Stnd timed":
            gl_stnd = gl_c
            check_path_kernels(model, state, t, "on the 1 km Stnd state",
                               "phase10a")


def phase10b_card_vs_cpu(dev):
    """MISMIP3d at 50 km (33 x 3) float64 on the card and on the CPU from
    the same state: equal steps and dt-limit hits, the volume within 1e-10
    (the SSA solves stop on the velocity-change test, so the kernels'
    one-ulp differences from the plain versions grow over the steps:
    1.55e-12 after 30 a measured on an H100)."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.convert import state_to_numpy

    runs = {}
    for where in ("cpu", dev):
        model, state, grid = setups.mismip3d_model("float64", km=50.0,
                                                   device=where)
        state, t, stats = model.step_once(state, 0.0,
                                          MISMIP3D_CHECK_YEARS * SPY)
        runs[str(where)] = (state_to_numpy(state), stats)
    (a, sa), (b, sb) = runs["cpu"], runs[str(dev)]
    V = a["ice_thickness"].sum()
    rel = abs(b["ice_thickness"].sum() - V) / V
    H_err = abs(b["ice_thickness"] - a["ice_thickness"]).max() \
        / abs(a["ice_thickness"]).max()
    print(f"phase10b: MISMIP3d {grid.Mx}x{grid.My} float64 "
          f"{MISMIP3D_CHECK_YEARS:g} a, card vs cpu: steps {sb.nsteps} / "
          f"{sa.nsteps}, dt-limit hits {sb.limit_hits_dict()} / "
          f"{sa.limit_hits_dict()}, volume rel diff {rel:.3e} (tol 1e-10), "
          f"H max diff {H_err:.3e} of max H")
    if sb.nsteps != sa.nsteps or sb.limit_hits_dict() != sa.limit_hits_dict() \
            or not rel <= 1e-10:
        raise AssertionError("phase10b: card and cpu disagree")


def _periodic_route_case(label, state, model, dtype, rng, timed):
    """On ``state`` (cast to ``dtype``) the SSA's periodic route, the
    operator and the Newton matvec of the state's own linearization
    applied to a random direction (the operator applied to the state's own
    velocity is the driving stress, a sum that cancels to 1e-4 of its
    terms in float32), against the plain periodic stencils on the card
    (K1's tolerances); timed as a kernel record when ``timed``."""
    import torch
    from pism_tpu_torch.ops import ssa as ssa_ops
    from pism_tpu_torch.setups import to_dtype

    s = to_dtype(state, dtype)
    ssa, grid = model.ssa, model.grid
    dx, dy, sh, periodic = grid.dx, grid.dy, ssa.sh, ssa.periodic
    P = ssa.build_problem(s, model.yield_stress.compute(s))
    u, v = s.u_ssa, s.v_ssa
    nuH, coefs = P["linearize_nuH"](u, v)
    beta = P["beta_fn"](u, v)
    tangent = ssa_ops.NuHTangent(coefs[0].unbind(-1), coefs[1].unbind(-1),
                                 dx, dy, sh)
    bc = P["bc_mask"]
    du, dv = (torch.tensor(rng.normal(size=grid.shape2) * 1e-6, dtype=dtype,
                           device=u.device) for _ in range(2))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    mv = ssa_ops.ssa_newton_matvec_periodic(u, v, nuH.e, nuH.n, *coefs, beta,
                                            bc, dx, dy, periodic)
    got = mv(du, dv)
    ref = ssa_ops.newton_matvec_stencil(u, v, du, dv, nuH, tangent, beta, bc,
                                        dx, dy, sh)
    err = max(_rel_err(g, r) for g, r in zip(got, ref))
    print(f"phase10c: the Newton matvec's periodic route on the state, "
          f"{str(dtype)[6:]}: rel_err {err:.3e} (tol {tol:.0e}) against the "
          "plain periodic stencils")
    if not err <= tol:
        raise AssertionError(f"phase10c: Newton matvec route {err:.3e}")
    return _kernel_case(
        "ssa_matvec_halo (periodic route)",
        lambda *a: ssa_ops.apply_operator(*a, dx, dy, periodic),
        lambda *a: ssa_ops.apply_operator_stencil(*a, dx, dy, sh),
        (du, dv, nuH, beta), tol, f"{label} {str(dtype)[6:]}",
        OPS["ssa_matvec"] * grid.My * grid.Mx, match="ssa_matvec_tile",
        nbytes=7 * grid.My * grid.Mx * u.element_size(),
        reps=200 if timed else 3, phase="phase10c")


def phase10c_mismip_periodic(dev, pcr):
    """MISMIP experiment 1 on its periodic-y grid (151 x 7): float32 on the
    card through the periodic route (the padded-block K1 and Newton matvec
    launch, K1's whole-field instances stay idle), float64 card against
    CPU, and the route against the plain periodic operator on the card's
    state in both dtypes; then the route alone at 1601 x 101."""
    import numpy as np
    import torch
    from pism_tpu_torch import Grid, setups
    from pism_tpu_torch.convert import state_to_numpy
    from pism_tpu_torch.ops import ssa as ssa_ops
    from pism_tpu_torch.ops.stencils import Shifter
    from pism_tpu_torch.verification import mismip

    y32, y64 = MISMIP1_YEARS
    model, state, grid = setups.mismip_model("float32", 151, 7, device=dev)
    reset_counts()
    state, t, stats, wall = _mismip_run(model, state, 0.0, y32)
    counts = read_counts()
    _mismip_check("phase10c", state, grid, torch.float32)
    _check_launches("phase10c", counts,
                    ("ssa_matvec_halo", "ssa_newton_matvec_halo"),
                    ("ssa_matvec", "ssa_newton_matvec", "ssa_matvec_jvp",
                     "ssa_matvec_halo_jvp", "sia_flux_thermo", "sia_flux")
                    + pcr)
    _mismip_report("phase10c periodic", grid, y32, stats, wall, counts, state)
    print(f"phase10c: grounding line (centre row) "
          f"{mismip.grounding_line_position(state.geometry, grid) / 1e3:.1f} "
          "km")

    # float64, card against CPU: the first step (1 a, from equal states)
    # held close, then on to y64 a by steps, dt-limit hits and volume (the
    # 2e-4 envelope: the chain's solves stop on stagnation, and one of them
    # turns a one-ulp difference into 2.6e-4 of max |u|, measured on an
    # H100, so the trajectories part)
    runs = {}
    for where in ("cpu", dev):
        m, s, _ = setups.mismip_model("float64", 151, 7, device=where)
        s1, t1, st1 = m.step_once(s, 0.0, 1.0 * SPY)
        s, _, st = m.step_once(s1, t1, (y64 - 1.0) * SPY)
        runs[str(where)] = (state_to_numpy(s1), st1, s, st, m)
    (a1, sta1, sa, sta, _), (b1, stb1, sb, stb, mb) = runs["cpu"], runs[str(dev)]
    errs = {k: float(abs(b1[k] - a1[k]).max() / abs(a1[k]).max())
            for k in ("ice_thickness", "u_ssa")}
    a, b = state_to_numpy(sa), state_to_numpy(sb)
    V = a["ice_thickness"].sum()
    rel = abs(b["ice_thickness"].sum() - V) / V
    print(f"phase10c: 151x7 float64 card vs cpu: the first step "
          f"({stb1.nsteps} / {sta1.nsteps}, Newton sweeps "
          f"{stb1.ssa_newton_iters} / {sta1.ssa_newton_iters}) H {errs['ice_thickness']:.3e}, "
          f"u {errs['u_ssa']:.3e} of their max (tol 1e-12); to {y64:g} a: "
          f"steps {stb.nsteps} / {sta.nsteps}, dt-limit hits "
          f"{stb.limit_hits_dict()} / {sta.limit_hits_dict()}, volume rel "
          f"diff {rel:.3e} (tol 2e-4)")
    if stb1.nsteps != sta1.nsteps or max(errs.values()) > 1e-12 \
            or stb.nsteps != sta.nsteps \
            or stb.limit_hits_dict() != sta.limit_hits_dict() or not rel <= 2e-4:
        raise AssertionError("phase10c: card and cpu disagree")

    rng = np.random.default_rng(20261017)
    for dtype in (torch.float32, torch.float64):
        _periodic_route_case("151x7 on the card's state", sb, mb, dtype, rng,
                             dtype == torch.float32)
    # the route alone at 1601 x 101 (periodic in y) on random fields
    g = Grid(Mx=1601, My=101, Lx=800e3, Ly=50e3, periodicity="y")
    f = {k: torch.tensor(rng.normal(size=g.shape2) * 1e-5,
                         dtype=torch.float32, device=dev) for k in ("u", "v")}
    nuH = ssa_ops.NuH(*(torch.tensor(rng.uniform(1e13, 1e16, size=g.shape2),
                                     dtype=torch.float32, device=dev)
                        for _ in range(2)))
    beta = torch.tensor(rng.uniform(0.0, 1e10, size=g.shape2),
                        dtype=torch.float32, device=dev)
    sh = Shifter(g)
    _kernel_case("ssa_matvec_halo (periodic route)",
                 lambda *a: ssa_ops.apply_operator(*a, g.dx, g.dy, (True, False)),
                 lambda *a: ssa_ops.apply_operator_stencil(*a, g.dx, g.dy, sh),
                 (f["u"], f["v"], nuH, beta), 1e-5, "1601x101 float32",
                 OPS["ssa_matvec"] * g.My * g.Mx, match="ssa_matvec_tile",
                 nbytes=7 * g.My * g.Mx * 4, phase="phase10c")


def phase10_mismip(dev, k1, pcr, off):
    t = time.time()
    phase10a_mismip3d(dev, k1, pcr, off)
    print(f"phase10a: {time.time() - t:.1f} s")
    t = time.time()
    phase10b_card_vs_cpu(dev)
    phase10c_mismip_periodic(dev, pcr)
    print(f"phase10bc: {time.time() - t:.1f} s")


# -- phase 11: the ensemble (BASELINE config 5) ----------------------------

#: the paleo ensemble at its published width (examples/paleo_ensemble.py):
#: members, km, the first segment and the end [a]
PALEO_MEMBERS, PALEO_KM, PALEO_FIRST, PALEO_YEARS = 100, 40.0, 50.0, 500.0
#: the K3 route (Mahaffy gradients, no bed smoother): members and years
K3_MEMBERS, K3_YEARS = 16, 100.0
#: the K4 route (Halfar B at path C's 601x601): members and years
K4_MEMBERS, K4_YEARS = 8, 20.0
K3_ROUTE = {"stress_balance.sia.surface_gradient_method": "mahaffy",
            "stress_balance.sia.bed_smoother.range": 0.0}


def _sync():
    import torch
    torch.cuda.synchronize()


def _timed(label, fn, *args):
    """``fn(*args)``, its wall time printed under ``label``."""
    t = time.time()
    result = fn(*args)
    print(f"{label}: {time.time() - t:.1f} s")
    return result


def _lockstep(stats):
    """Lockstep steps of a segment: the most any member took (a member
    steps from the segment's start until it is done)."""
    return max(s.nsteps for s in stats)


def _ensemble_check(label, state, stats, years):
    """Finite fields of every member, each member's last step bound by the
    segment's end (so each reached it)."""
    import torch
    for name in ("ice_thickness", "enthalpy", "basal_melt_rate"):
        f = getattr(state.geometry, name, None) if name == "ice_thickness" \
            else getattr(state, name)
        if f is not None and not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    short = [b for b, s in enumerate(stats)
             if s.limit_hits_dict().get("end_of_segment") != 1]
    if short:
        raise AssertionError(f"{label}: members {short} did not reach the "
                             f"end of the {years} a segment")


def _ensemble_report(label, n, stats, wall, years, counts):
    """Prints and returns (lockstep steps, ms per lockstep step)."""
    lock = _lockstep(stats)
    steps = [s.nsteps for s in stats]
    syncs = stats[0].host_syncs
    per_step = {k: round(counts[k] / lock, 2) for k in KERNELS if counts[k]}
    print(f"{label}: {n} members, {years} a: lockstep steps {lock}, member "
          f"steps {min(steps)}-{max(steps)}, wall {wall:.3f} s, "
          f"{1e3 * wall / lock:.2f} ms per lockstep step, "
          f"{n * years / wall * 3600.0:.1f} member-years per wall hour, host "
          f"syncs {syncs} ({syncs / lock:.2f} per lockstep step), kernel "
          f"launches per lockstep step {per_step} (the segments' counts "
          f"together), dt-limit hits of member 0 "
          f"{stats[0].limit_hits_dict()}")
    return lock, 1e3 * wall / lock


def _profile_ensemble(runner, state, t0, years, label):
    """One segment under the profiler's CUDA activity: device ops per
    lockstep step and the busy share of the profiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.time()
        _, stats = runner.run_segment(state, t0, t0 + years * SPY)
        _sync()
        wall = time.time() - w0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    lock = _lockstep(stats)
    print(f"{label}: profiled {years} a, {lock} lockstep steps: {len(dev)} "
          f"device ops ({len(dev) / lock:.0f} per lockstep step), device "
          f"time {busy:.1f} ms of {1e3 * wall:.1f} ms profiled wall, busy "
          f"share {busy / (1e3 * wall):.3f}")


def _member_vs_solo(label, model, batched, out, seg_stats, members, bounds,
                    tol):
    """Members of an ensemble against solo runs of the same members on the
    card over the same segments ``bounds`` [s]: equal steps and dt-limit
    hits per segment; H to the bit, else within ``tol`` of max H."""
    import torch
    from pism_tpu_torch.parallel.ensemble import member
    for b in members:
        st = member(batched, b)
        t = bounds[0]
        for k, t_end in enumerate(bounds[1:]):
            st, t, solo = model.step_once(st, t, t_end - t)
            ens = seg_stats[k][b]
            if solo.nsteps != ens.nsteps \
                    or solo.limit_hits_dict() != ens.limit_hits_dict():
                raise AssertionError(
                    f"{label}: member {b} segment {k}: steps {ens.nsteps} / "
                    f"solo {solo.nsteps}, hits {ens.limit_hits_dict()} / "
                    f"{solo.limit_hits_dict()}")
        H, Hs = out.geometry.ice_thickness[b], st.geometry.ice_thickness
        same = torch.equal(H, Hs)
        err = float((H - Hs).abs().max() / Hs.abs().max())
        print(f"{label}: member {b} against its solo run on the card: steps "
              f"{[s[b].nsteps for s in seg_stats]}, hits equal, H equal to "
              f"the bit {same} (max diff {err:.3e} of max H, tol {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"{label}: member {b} differs from its solo "
                                 f"run by {err:.3e} of max H")


def _members_kernel_case(name, label, batched_fn, single_fn, plain_fn, args,
                         tol, nops, match):
    """A member-axis launch against its plain version (``_kernel_case``),
    against one launch per member (to the bit, (B,) max(D) included) and
    its max(D) against each member's faces' max (to the bit); one batched
    launch timed against the B single launches. Returns the record."""
    import torch
    r = _kernel_case(name, lambda *x: batched_fn(*x)[:4],
                     lambda *x: tuple(plain_fn(*x)[i] for i in (2, 3, 0, 1)),
                     args, tol, label, nops, reps=50, phase="phase11")
    got = batched_fn(*args)
    B = got[0].shape[0]
    singles = [single_fn(*(a[b] if a.dim() > 1 else a for a in args))
               for b in range(B)]
    _sync()
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    for b, one in enumerate(singles):
        for k, (g, o) in enumerate(zip(got, one)):
            gb = g[b]
            if not torch.equal(gb.view(bits[gb.dtype]), o.view(bits[o.dtype])):
                raise AssertionError(f"{name} {label}: member {b} output {k} "
                                     "differs from its single launch")
        De, Dn = got[0][b], got[1][b]
        ref = torch.maximum(torch.max(De), torch.max(Dn))
        if not torch.equal(got[4][b].view(bits[ref.dtype]),
                           ref.view(bits[ref.dtype])):
            raise AssertionError(f"{name} {label}: member {b}'s max(D) is not "
                                 "its faces' max")
    def singles():
        for b in range(B):
            single_fn(*(a[b] if a.dim() > 1 else a for a in args))

    batched_ms = _time_ms(lambda: batched_fn(*args), 50)
    singles_ms = _time_ms(singles, 20)
    one_us = _kernel_us(lambda: batched_fn(*args), match, 1)
    many_us = _kernel_us(singles, match, B)
    one_g, many_g = _graph_us(lambda: batched_fn(*args)), _graph_us(singles)
    print(f"phase11: {name} {label}: one launch for {B} members equal to the "
          f"bit to {B} single launches, (B,) max(D) equal to each member's "
          f"faces' max; events one launch {batched_ms:.4f} ms, {B} launches "
          f"{singles_ms:.4f} ms; the kernel alone {one_us} against {many_us} "
          f"in {B} launches (profiler); replayed from a CUDA graph, without "
          f"the host, {one_g:.2f} us against {many_g:.2f} us")
    return r


def _graph_us(fn, reps=20):
    """Device µs per call of ``fn`` replayed from a CUDA graph of ``reps``
    calls (CUDA events around the replay): the launches' device time
    without the host's, gaps between them included."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    _sync()
    return 1e3 * start.elapsed_time(end) / (5 * reps)


def _kernel_us(fn, match, launches, reps=20):
    """The profiler's device time of the kernels named ``match`` per call
    of ``fn``, which launches them ``launches`` times, as text; a trace that
    holds another count of them (the profiler drops events now and then)
    is taken again, up to three times, else "not measured"."""
    for _ in range(3):
        us, ops = _device_profile(fn, reps, match)
        if ops is not None and round(ops * reps) == launches * reps:
            return f"{us:.2f} us"
    return "not measured"


def phase11a_paleo(dev, smi):
    """The paleo ensemble at its published width through EnsembleRunner:
    100 members at 41x41x21 float32, 50 a then 450 a timed; the coldest,
    middle and warmest members against solo runs on the card."""
    import numpy as np
    from pism_tpu_torch import setups
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    model, batched, grid, dT = setups.paleo_ensemble_model(
        PALEO_MEMBERS, PALEO_KM, device=dev)
    runner = EnsembleRunner(model)
    _sync()
    reset_counts()
    w0 = time.time()
    s50, st50 = runner.run_segment(batched, 0.0, PALEO_FIRST * SPY)
    _sync()
    wall50 = time.time() - w0
    w0 = time.time()
    out, st = runner.run_segment(s50, PALEO_FIRST * SPY, PALEO_YEARS * SPY)
    _sync()
    wall = time.time() - w0
    counts = read_counts()
    # Haseloff gradients and the 5 km bed smoother: the plain SIA path, as
    # the JAX example takes on the TPU
    _check_launches("phase11a", counts, (), KERNELS)
    _ensemble_check("phase11a first", s50, st50, PALEO_FIRST)
    _ensemble_check("phase11a", out, st, PALEO_YEARS - PALEO_FIRST)
    print(f"phase11a: {smi}")
    _ensemble_report(f"phase11a first {PALEO_FIRST} a (untimed warm-up)",
                     PALEO_MEMBERS, st50, wall50, PALEO_FIRST, counts)
    _ensemble_report(f"phase11a timed {grid.Mx}x{grid.My}x{grid.Mz} float32",
                     PALEO_MEMBERS, st, wall, PALEO_YEARS - PALEO_FIRST,
                     counts)
    vols = out.geometry.ice_thickness.double().sum(dim=(1, 2)).cpu().numpy() \
        * grid.dx * grid.dy / 1e15
    corr = float(np.corrcoef(dT, vols)[0, 1])
    print(f"phase11a: volume range {vols.min():.4f}-{vols.max():.4f} 1e6 "
          f"km^3, volume-dT correlation {corr:.4f}")
    if not corr > 0.9:
        raise AssertionError(f"phase11a: volume-dT correlation {corr:.3f}")
    _profile_ensemble(runner, out, PALEO_YEARS * SPY, 40.0, "phase11a")
    _member_vs_solo("phase11a", model, batched, out, (st50, st),
                    (0, PALEO_MEMBERS // 2, PALEO_MEMBERS - 1),
                    (0.0, PALEO_FIRST * SPY, PALEO_YEARS * SPY), 1e-4)


def phase11b_k3(dev):
    """The K3 route: the paleo ensemble with Mahaffy gradients and no bed
    smoother, 16 members, 100 a; then K3 on the ensemble's own state.
    Returns (K3's member-axis record, launch counts of the run)."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.ops.kernels import sia_thermo as K3
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    model, batched, grid, _ = setups.paleo_ensemble_model(
        K3_MEMBERS, PALEO_KM, device=dev, extra_cfg=K3_ROUTE)
    runner = EnsembleRunner(model)
    _sync()
    reset_counts()
    w0 = time.time()
    out, st = runner.run_segment(batched, 0.0, K3_YEARS * SPY)
    _sync()
    wall = time.time() - w0
    counts = read_counts()
    path = ("sia_flux_thermo", "sia_flux_thermo_members")
    _check_launches("phase11b", counts, path,
                    tuple(k for k in KERNELS if k not in path))
    _ensemble_check("phase11b", out, st, K3_YEARS)
    lock, _ = _ensemble_report("phase11b (K3 route)", K3_MEMBERS, st, wall,
                               K3_YEARS, counts)
    if counts["sia_flux_thermo_members"] != lock:
        raise AssertionError("phase11b: K3 was not launched once a lockstep "
                             "step")
    sb = model.stress_balance
    kw = dict(n=sb.n_sia, enhancement=sb.e_sia, rho=sb.rho, g=sb.g,
              dx=grid.dx, dy=grid.dy, EC=sb.sia_flow_law.EC,
              pb_law=sb.sia_flow_law, d_cap=sb.d_limit)
    H = out.geometry.ice_thickness
    import torch
    z = torch.as_tensor(grid.z, dtype=H.dtype, device=H.device)
    args = (H, out.geometry.ice_surface_elevation, out.enthalpy, z)
    B, My, Mx, Mz = out.enthalpy.shape
    r = _members_kernel_case(
        "sia_flux_thermo_members", f"{B}x{My}x{Mx}x{Mz} float32 E level-major "
        "(the ensemble's state)",
        lambda *x: K3.sia_flux_thermo(*x, **kw),
        lambda *x: K3.sia_flux_thermo(*x, **kw),
        lambda *x: K3.sia_flux_thermo_plain(*x, **kw), args, 1e-4,
        2 * B * My * Mx * (OPS["sia_thermo_level"] * Mz
                           + OPS["sia_thermo_face"]), "sia_thermo")
    return r, counts


def phase11c_k4(dev):
    """The K4 route: Halfar B ensembles at 601x601 float32 (SMB scales
    0..7), 20 a; then K4 on the ensemble's own state. Returns (K4's
    member-axis record, launch counts of the run)."""
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.ops.kernels import sia_iso as K4
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    # one segment of 20 a (~0.5k steps) whatever the steps per segment
    model, batched, grid, sol, scales = setups.halfar_ensemble_model(
        K4_MEMBERS, HALFAR_MX, "float32", device=dev,
        extra_cfg={"time_stepping.max_steps_per_segment": 5000})
    runner = EnsembleRunner(model)
    _sync()
    reset_counts()
    w0 = time.time()
    out, st = runner.run_segment(batched, sol.t0, sol.t0 + K4_YEARS * SPY)
    _sync()
    wall = time.time() - w0
    counts = read_counts()
    path = ("sia_flux", "sia_flux_members")
    _check_launches("phase11c", counts, path,
                    tuple(k for k in KERNELS if k not in path))
    _ensemble_check("phase11c", out, st, K4_YEARS)
    lock, _ = _ensemble_report("phase11c (K4 route)", K4_MEMBERS, st, wall,
                               K4_YEARS, counts)
    if counts["sia_flux_members"] != lock:
        raise AssertionError("phase11c: K4 was not launched once a lockstep "
                             "step")
    V = out.geometry.ice_thickness.double().sum(dim=(1, 2)).cpu()
    print(f"phase11c: member volumes {[f'{float(v):.6e}' for v in V]} m "
          "(cell sums, SMB scales 0..7)")
    if not bool((V[1:] > V[:-1]).all()):
        raise AssertionError("phase11c: more accumulation, not more volume")
    sb = model.stress_balance
    A = float(torch.tensor(sb.sia_flow_law.A, dtype=torch.float32))
    kw = dict(A=A, n=sb.n_sia, enhancement=sb.e_sia, rho=sb.rho, g=sb.g,
              dx=grid.dx, dy=grid.dy, d_cap=sb.d_limit)
    gam = K4.gamma(A, sb.n_sia, sb.e_sia, sb.rho, sb.g)
    H = out.geometry.ice_thickness
    args = (H, out.geometry.ice_surface_elevation)
    B, My, Mx = H.shape
    return _members_kernel_case(
        "sia_flux_members", f"{B}x{My}x{Mx} float32 (the ensemble's state)",
        lambda *x: K4.sia_flux(*x, **kw), lambda *x: K4.sia_flux(*x, **kw),
        lambda *x: K4.sia_flux_plain(*x, gamma=gam, n=sb.n_sia, dx=grid.dx,
                                     dy=grid.dy, d_cap=sb.d_limit),
        args, 2e-5, OPS["sia_flux"] * B * My * Mx, "sia_iso_kernel"), counts


def phase11d_card_vs_cpu(dev):
    """A 4-member paleo ensemble at 100 km in float64 on the card and on
    the CPU: equal steps and hits per member, volumes within 1e-10."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    runs = {}
    for where in ("cpu", dev):
        model, batched, grid, _ = setups.paleo_ensemble_model(
            4, 100.0, dtype="float64", device=where)
        out, st = EnsembleRunner(model).run_segment(batched, 0.0, 300.0 * SPY)
        runs[str(where)] = (out.geometry.ice_thickness.sum(dim=(1, 2)).cpu(),
                            st)
    (va, sa), (vb, sb) = runs["cpu"], runs[str(dev)]
    rel = float(((vb - va).abs() / va.abs()).max())
    same = [a.nsteps == b.nsteps and a.limit_hits == b.limit_hits
            for a, b in zip(sa, sb)]
    print(f"phase11d: 4-member paleo ensemble 100 km float64, 300 a, card "
          f"against CPU: member steps {[s.nsteps for s in sb]} / "
          f"{[s.nsteps for s in sa]}, hits equal {all(same)}, volume max rel "
          f"diff {rel:.3e} (tol 1e-10)")
    if not all(same) or not rel <= 1e-10:
        raise AssertionError("phase11d: the card and the CPU disagree")


def phase11_ensemble(dev, smi):
    t = time.time()
    phase11a_paleo(dev, smi)
    print(f"phase11a: {time.time() - t:.1f} s")
    k3, counts_k3 = phase11b_k3(dev)
    k4, counts_k4 = phase11c_k4(dev)
    phase11d_card_vs_cpu(dev)
    return (k3, counts_k3), (k4, counts_k4)


# -- phase 12: the ssa+sia ensemble (the hybrid chain on a member axis) ----

#: the hybrid chain's ensemble: members, km, the warm-up and the timed
#: segment [a], the members held against their own runs
HYB_MEMBERS, HYB_KM, HYB_FIRST, HYB_TIMED = 100, 20.0, 2.0, 3.0
HYB_SOLO = (0, 50, 99)
#: the member-axis kernels of the SSA solve (and their single launches,
#: which the ensemble must not take)
SSA_MEMBER_KERNELS = ("ssa_matvec_members", "ssa_newton_matvec_members",
                      "pcr_lines_members", "pcr_lines_sub_members",
                      "pcr_factor_lines_members",
                      "pcr_factor_lines_sub_members", "member_dot",
                      "member_dots")


def _hybrid_report(label, n, stats, wall, years, counts):
    """Prints the lockstep figures of a segment of the hybrid ensemble;
    returns (lockstep steps, ms per lockstep step)."""
    import numpy as np
    lock = _lockstep(stats)
    steps = [s.nsteps for s in stats]
    syncs = stats[0].host_syncs
    newton = np.array([s.ssa_newton_iters / s.nsteps for s in stats])
    krylov = np.array([s.ssa_krylov_iters / s.nsteps for s in stats])
    per_step = {k: round(counts[k] / lock, 2) for k in KERNELS if counts[k]}

    def spread(x):
        return f"{x.min():.2f} / {np.median(x):.2f} / {x.max():.2f}"

    print(f"{label}: {n} members, {years} a: lockstep steps {lock}, member "
          f"steps {min(steps)}-{max(steps)} (median {np.median(steps):g}); "
          f"Newton sweeps per lockstep step "
          f"{stats[0].ssa_lockstep_newton / lock:.2f} (the lockstep's), each "
          f"member's per own step min / median / max {spread(newton)}; "
          f"Krylov iterations per lockstep step "
          f"{stats[0].ssa_lockstep_krylov / lock:.2f} (the lockstep's), each "
          f"member's {spread(krylov)}; host syncs {syncs} "
          f"({syncs / lock:.2f} per lockstep step); kernel launches per "
          f"lockstep step {per_step}; wall {wall:.3f} s, "
          f"{1e3 * wall / lock:.2f} ms per lockstep step, "
          f"{n * years / wall * 3600.0:.1f} member-years per wall hour; "
          f"dt-limit hits of member 0 {stats[0].limit_hits_dict()}")
    return lock, 1e3 * wall / lock


def _hybrid_run(runner, state, t0, years, label, launched=SSA_MEMBER_KERNELS):
    """One segment with the launch counts set to 0 before it and read after
    it: (state, stats, wall, counts); the kernels ``launched`` (the SSA's
    member-axis kernels) must launch and no other."""
    _sync()
    reset_counts()
    w0 = time.time()
    out, st = runner.run_segment(state, t0 * SPY, (t0 + years) * SPY)
    _sync()
    wall = time.time() - w0
    counts = read_counts()
    _check_launches(label, counts, launched,
                    tuple(k for k in KERNELS if k not in launched))
    _ensemble_check(label, out, st, years)
    import torch
    if not bool(torch.isfinite(out.u_ssa).all()):
        raise AssertionError(f"{label}: non-finite u_ssa")
    return out, st, wall, counts


def phase12a_hybrid(dev, smi):
    """The hybrid chain's ensemble at its width: 100 members at 141x76x41
    float32 on path A through EnsembleRunner, 2 a then 3 a timed; the
    sliding speed against the till angle. Returns (model, runner, initial
    batched state, the 2 a state and stats)."""
    import numpy as np
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    model, batched, grid, phi = setups.hybrid_ensemble_model(
        HYB_MEMBERS, HYB_KM, device=dev, extra_cfg=PATH_A)
    runner = EnsembleRunner(model)
    s2, st2, wall2, counts2 = _hybrid_run(runner, batched, 0.0, HYB_FIRST,
                                          "phase12a first")
    out, st, wall, counts = _hybrid_run(runner, s2, HYB_FIRST, HYB_TIMED,
                                        "phase12a")
    print(f"phase12a: {smi}")
    _hybrid_report(f"phase12a first {HYB_FIRST} a (untimed warm-up)",
                   HYB_MEMBERS, st2, wall2, HYB_FIRST, counts2)
    _hybrid_report(f"phase12a timed {grid.My}x{grid.Mx}x{grid.Mz} float32 "
                   "path A", HYB_MEMBERS, st, wall, HYB_TIMED, counts)
    # velbase_mag over grounded ice per member: its median, and its mean,
    # which a few thin margin cells at the SSA's speed clamp (50 km/a a
    # component) set, whatever the till angle
    grounded = out.geometry.cell_type == 2
    speed = torch.sqrt(out.u_ssa.double() ** 2
                       + out.v_ssa.double() ** 2) * SPY
    median = np.array([float(torch.median(speed[b][grounded[b]]))
                       for b in range(HYB_MEMBERS)])
    mean = ((speed * grounded).sum(dim=(1, 2))
            / grounded.sum(dim=(1, 2))).cpu().numpy()
    clamped = (speed >= 0.99 * model.ssa.max_speed * SPY) & grounded
    corr = float(np.corrcoef(phi, median)[0, 1])
    vols = out.geometry.ice_thickness.double().sum(dim=(1, 2)).cpu().numpy() \
        * grid.dx * grid.dy / 1e15
    print(f"phase12a: members' median sliding speed over grounded ice "
          f"{median[0]:.4e} (phi {phi[0]:.1f}) to {median[-1]:.4e} m/a (phi "
          f"{phi[-1]:.1f}), correlation with phi {corr:.4f} (must be below "
          f"-0.9); the mean {mean[0]:.4g} to {mean[-1]:.4g} m/a, correlation "
          f"{float(np.corrcoef(phi, mean)[0, 1]):.4f}, set by "
          f"{int(clamped.sum(dim=(1, 2)).min())}-"
          f"{int(clamped.sum(dim=(1, 2)).max())} grounded cells a member at "
          f"the speed clamp; volumes {vols.min():.6f}-{vols.max():.6f} 1e6 "
          "km^3")
    if not corr < -0.9:
        raise AssertionError(f"phase12a: sliding-phi correlation {corr:.3f}")
    _profile_ensemble(runner, out, (HYB_FIRST + HYB_TIMED) * SPY, 0.25,
                      "phase12a")
    return model, runner, batched, s2, st2


def phase12b_members(model, runner, batched, s2, st2):
    """Members 0, 50 and 99 over the 2 a warm-up: each equal to the bit to
    its run as a 1-member ensemble (H, E, u_ssa, steps, hits, Newton and
    Krylov counts), and within phase 2b's envelope of its solo chain
    (equal steps and dt-limit hits, volume within 2e-4)."""
    import torch
    from pism_tpu_torch.parallel.ensemble import member, stack_states

    for b in HYB_SOLO:
        one, (so,) = runner.run_segment(stack_states([member(batched, b)]),
                                        0.0, HYB_FIRST * SPY)
        e = st2[b]
        same = {name: torch.equal(getattr(one, name)[0],
                                  getattr(s2, name)[b])
                for name in ("enthalpy", "u_ssa", "v_ssa", "snow_depth")}
        same["H"] = torch.equal(one.geometry.ice_thickness[0],
                                s2.geometry.ice_thickness[b])
        counts = ((so.nsteps, so.limit_hits, so.ssa_newton_iters,
                   so.ssa_krylov_iters)
                  == (e.nsteps, e.limit_hits, e.ssa_newton_iters,
                      e.ssa_krylov_iters))
        st, t, solo = model.step_once(member(batched, b), 0.0,
                                      HYB_FIRST * SPY)
        V = float(st.geometry.ice_thickness.double().sum())
        Ve = float(s2.geometry.ice_thickness[b].double().sum())
        rel = abs(Ve - V) / V
        print(f"phase12b: member {b}: as a 1-member ensemble equal to the "
              f"bit {same}, counts (steps, hits, Newton {e.ssa_newton_iters},"
              f" Krylov {e.ssa_krylov_iters}) equal {counts}; solo chain: "
              f"steps {solo.nsteps} / {e.nsteps}, hits "
              f"{solo.limit_hits_dict()} / {e.limit_hits_dict()}, Newton "
              f"{solo.ssa_newton_iters}, Krylov {solo.ssa_krylov_iters}, "
              f"volume rel diff {rel:.3e} (tol 2e-4)")
        if not (all(same.values()) and counts):
            raise AssertionError(f"phase12b: member {b} differs from its "
                                 "1-member ensemble")
        if solo.nsteps != e.nsteps \
                or solo.limit_hits_dict() != e.limit_hits_dict() \
                or not rel <= 2e-4:
            raise AssertionError(f"phase12b: member {b} and its solo chain "
                                 "disagree")


def _member_ssa_case(name, label, fn, plain, args, single, tol, nops, match,
                     unpack=None, nbytes=None, phase="phase12c",
                     singles_timed=True):
    """A member-axis launch ``fn(*args)`` against its plain version
    (``_kernel_case``: error, events, profiler, bound) and against member
    b's single launch ``single(b)``, to the bit for every member; one launch
    timed against the B single launches (the profiler, a CUDA-graph
    replay) if ``singles_timed``. ``unpack`` turns a result into tensors
    with the members leading. Returns the record."""
    import torch
    r = _kernel_case(name, fn, plain, args, tol, label, nops, reps=50,
                     unpack=unpack, nbytes=nbytes, phase=phase)
    unpack = unpack or (lambda x: x if isinstance(x, tuple) else (x,))
    got = unpack(fn(*args))
    B = got[0].shape[0]
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    for b in range(B):
        for k, (g, o) in enumerate(zip(got, unpack(single(b)))):
            g = g[b].reshape(o.shape)
            if not torch.equal(g.view(bits[g.dtype]), o.view(bits[o.dtype])):
                raise AssertionError(f"{name} {label}: member {b} output {k} "
                                     "differs from its single launch")
    if not singles_timed:
        print(f"{phase}: {name} {label}: one launch for {B} members equal to "
              f"the bit to {B} single launches")
        return r

    def singles():
        for b in range(B):
            single(b)

    one_us = _kernel_us(lambda: fn(*args), match, 1)
    many_us = _kernel_us(singles, match, B)
    one_g, many_g = _graph_us(lambda: fn(*args)), _graph_us(singles)
    print(f"{phase}: {name} {label}: one launch for {B} members equal to "
          f"the bit to {B} single launches; the kernel alone {one_us} "
          f"against {many_us} in {B} launches (profiler); from a CUDA graph "
          f"{one_g:.2f} us against {many_g:.2f} us")
    return r


def _member_dots_pairs(phase, label, KD, x, y):
    """Each dot of ``member_dots(x, y)`` equal to the bit to ``member_dot``
    of its pair (x.y also to y.x)."""
    import torch
    got = KD.member_dots(x, y)
    pairs = ((x, x), (x, y), (y, y), (y, x))
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    for g, (p, q) in zip((*got, got[1]), pairs):
        one = KD.member_dot(p, q)
        if not torch.equal(g.view(bits[g.dtype]), one.view(bits[one.dtype])):
            raise AssertionError(f"{phase}: member_dots {label}) differs "
                                 "from member_dot of its pairs")
    print(f"{phase}: member_dots {label}): x.x, x.y, y.y equal to the bit to "
          "member_dot of each pair (x.y to y.x too)")


def _yardstick(phase, name, label, rec, kern, what, call, ref, rounds=3):
    """The one PyTorch call ``call`` for kernel ``name``'s function beside
    the kernel's call ``kern``: CUDA events of each, 100 calls at a time,
    in turns (kernel, library, library, kernel, then the other way round)
    ``rounds`` times, since both are host-bound at these sizes and the
    host drifts; sets the record ``rec``'s ``ms`` and ``library_ms`` to the
    medians. Also the library call's profiler time and its error against
    the plain result ``ref``."""
    import statistics
    lib = call()
    times = {"kernel": [], "library": []}
    for r in range(rounds):
        order = ("kernel", "library") if r % 2 == 0 else ("library",
                                                          "kernel")
        for who in order + order[::-1]:
            times[who].append(_time_ms(kern if who == "kernel" else call,
                                       100))
    rec["ms"] = statistics.median(times["kernel"])
    rec["library_ms"] = statistics.median(times["library"])
    dev_us, _ = _device_profile(call, 50)
    dev = "not measured" if dev_us is None else f"{dev_us:.2f} us"
    verdict = "no slower" if rec["ms"] <= rec["library_ms"] else "slower"

    def spread(v):
        return f"{1e3 * min(v):.2f}-{1e3 * max(v):.2f}"

    print(f"{phase}: {name} {label}: {what}: device {dev}, rel err "
          f"{_rel_err(lib, ref):.3e} against the plain version; events a "
          f"call in turns, median (min-max) of {2 * rounds}: the kernel "
          f"{1e3 * rec['ms']:.2f} ({spread(times['kernel'])}) us, the "
          f"library {1e3 * rec['library_ms']:.2f} "
          f"({spread(times['library'])}) us: the kernel {verdict} than it")


def phase12c_kernels(model, state, phase="phase12c"):
    """On an ensemble's linearization at its state (every member's
    operator, drag and line systems of a Newton sweep): K1, the Newton
    matvec, K2b and K2 factor and apply, the member dot and the member
    dots against B single launches (to the bit) and their plain versions
    (to the tolerances stated), each dot of the member dots against the
    member dot of its pair (to the bit), the dot and the dots against
    ``torch.linalg.vecdot``.
    ``phase`` labels the lines. Returns their records."""
    import torch
    from pism_tpu_torch.ops import ssa as ssa_ops
    from pism_tpu_torch.ops.kernels import member_dot as KD
    from pism_tpu_torch.ops.kernels import pcr as K2
    from pism_tpu_torch.ops.kernels import ssa_matvec as K1
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    ssa = EnsembleRunner(model).twin(state.u_ssa.device).ssa
    P = ssa.build_problem(state, model.yield_stress.compute(state))
    u, v = P["full"]((state.u_ssa, state.v_ssa))
    nuH, (ce, cn) = P["linearize_nuH"](u, v)
    beta, bc = P["beta_fn"](u, v), P["bc_mask"]
    dx, dy = ssa.grid.dx, ssa.grid.dy
    au, cu, bu, av, cv, bv = ssa_ops.line_systems(nuH, beta, bc, dx, dy,
                                                  ssa.sh)
    B, My, Mx = u.shape
    g = torch.Generator(device=u.device).manual_seed(12)

    def rand(s=1.0):
        return torch.randn(u.shape, generator=g, device=u.device,
                           dtype=u.dtype) * s

    scale = float(u.abs().max())
    du, dv, ru, rv = rand(scale), rand(scale), rand(), rand()
    label = f"{B}x{My}x{Mx} float32 (the ensemble's linearization"
    n = B * My * Mx
    out = {}
    a1 = (du, dv, nuH.e, nuH.n, beta)
    out["ssa_matvec_members"] = _member_ssa_case(
        "ssa_matvec_members", label + ")",
        lambda *a: K1.ssa_matvec(*a, dx, dy),
        lambda *a: K1.ssa_matvec_plain(*a, dx, dy), a1,
        lambda b: K1.ssa_matvec(*(x[b] for x in a1), dx, dy), 1e-5,
        OPS["ssa_matvec"] * n, "ssa_matvec_tile", phase=phase)
    a2 = (u, v, du, dv, nuH.e, nuH.n, ce, cn, beta, bc)
    out["ssa_newton_matvec_members"] = _member_ssa_case(
        "ssa_newton_matvec_members", label + ")",
        lambda *a: K1.ssa_newton_matvec(*a, dx, dy),
        lambda *a: K1.ssa_newton_matvec_plain(*a, dx, dy), a2,
        lambda b: K1.ssa_newton_matvec(*(x[b] for x in a2), dx, dy), 1e-5,
        OPS["ssa_newton_matvec"] * n, "newton", phase=phase)
    a3 = (u, v, du, dv)
    out["member_dot"] = _member_ssa_case(
        "member_dot", label + ")",
        lambda a0, a1_, b0, b1: KD.member_dot((a0, a1_), (b0, b1)),
        lambda a0, a1_, b0, b1: KD.member_dot_plain((a0, a1_), (b0, b1)),
        a3, lambda b: KD.member_dot(*(tuple(x[b:b + 1] for x in p)
                                      for p in ((u, v), (du, dv)))),
        1e-5, 4 * n, "member_sums_kernel", phase=phase)
    out["member_dots"] = _member_ssa_case(
        "member_dots", label + ", x = (u, v), y = (du, dv))",
        lambda x0, x1, y0, y1: KD.member_dots((x0, x1), (y0, y1)),
        lambda x0, x1, y0, y1: KD.member_dots_plain((x0, x1), (y0, y1)),
        a3, lambda b: KD.member_dots(*(tuple(x[b:b + 1] for x in p)
                                       for p in ((u, v), (du, dv)))),
        1e-5, 12 * n, "member_sums_kernel", phase=phase)
    _member_dots_pairs(phase, label, KD, (u, v), (du, dv))
    # the one PyTorch call for the same (B,) dots: torch.linalg.vecdot over
    # each member's u and v halves, prepared as one (B, 2 My Mx) pair (its
    # order of addition is torch's, which the kernel's fixed order is not);
    # for the three dots of two pairs, the same call over the prepared
    # (B, 3, 2 My Mx) stacks of their pairs
    uv = torch.cat((u.flatten(1), v.flatten(1)), 1)
    duv = torch.cat((du.flatten(1), dv.flatten(1)), 1)
    _yardstick(phase, "member_dot", label + ")", out["member_dot"],
               lambda: KD.member_dot((u, v), (du, dv)),
               "torch.linalg.vecdot on the (B, 2 My Mx) pair",
               lambda: torch.linalg.vecdot(uv, duv),
               KD.member_dot_plain((u, v), (du, dv)))
    L, R = torch.stack((uv, uv, duv), 1), torch.stack((uv, duv, duv), 1)
    _yardstick(phase, "member_dots", label + ")", out["member_dots"],
               lambda: KD.member_dots((u, v), (du, dv)),
               "torch.linalg.vecdot over the (B, 3, 2 My Mx) pairs (x, x, y) "
               "and (x, y, y)", lambda: torch.linalg.vecdot(L, R),
               torch.stack(KD.member_dots_plain((u, v), (du, dv)), 1))

    def members_first(f):
        return tuple(x.movedim(-3, 0) if x.dim() == 4 else x
                     for x in f.coefficients())

    for sub, (a, c, r, s) in ((False, (au, cu, ru, bu)),
                              (True, (av, cv, rv, bv))):
        factor = K2.pcr_factor_lines_sub if sub else K2.pcr_factor_lines
        plain = K2.pcr_factor_lines_sub_plain if sub \
            else K2.pcr_factor_lines_plain
        lines = "v-lines (axis -2)" if sub else "u-lines (last axis)"
        rounds = math.ceil(math.log2(My if sub else Mx))
        name = "pcr_lines_sub_members" if sub else "pcr_lines_members"
        fname = name.replace("pcr_lines", "pcr_factor_lines")
        singles = [factor(a[b], None, c[b]) for b in range(B)]
        out[fname] = _member_ssa_case(
            fname, f"{label}, {lines})",
            lambda a_, c_, f=factor: f(a_, None, c_),
            lambda a_, c_, f=plain: f(a_, None, c_), (a, c),
            lambda b, f=factor, a=a, c=c: f(a[b], None, c[b]), 0.0,
            OPS["pcr_factor_round"] * n * rounds, "pcr_factor",
            unpack=members_first, phase=phase)
        fac = factor(a, None, c)
        pfac = plain(a, None, c)
        rec = _member_ssa_case(
            name, f"{label}, {lines})",
            lambda r_, s_, f=fac: K2.pcr_apply(f, r_, s_),
            lambda r_, s_, f=pfac: K2.pcr_apply_plain(f, r_, s_), (r, s),
            lambda b, fs=singles, r=r, s=s: K2.pcr_apply(fs[b], r[b], s[b]),
            0.0, OPS["pcr_apply_round"] * n * rounds, "pcr_apply",
            nbytes=5 * n * r.element_size(), phase=phase)
        x = K2.pcr_apply(fac, r, s)
        fold = (lambda t: t.transpose(1, 2).reshape(B * Mx, My)) if sub \
            else (lambda t: t.reshape(B * My, Mx))
        rec["library_ms"] = _dense_solve_ms(
            fold(a), fold(c), fold(r / s), False, fold(x),
            f"{B} members, {lines}", phase=phase)
        out[name] = rec
    return out


def phase12d_card_vs_cpu(dev):
    """A 4-member hybrid ensemble at 100 km in float64, path A, 2 a on the
    card and on the CPU: equal steps and dt-limit hits per member, volumes
    within 1e-7. The SSA solve amplifies the two devices' rounding (their
    dot products sum in another order): phase 1 holds the 100 km chain's
    default member to 1e-8 over 1 a; on an NVIDIA H100 the member with
    till_phi 15 took 34 Newton sweeps on the card and 32 on the CPU over
    these 2 a and ended 1.5e-8 apart in volume."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    runs = {}
    for where in ("cpu", dev):
        model, batched, grid, _ = setups.hybrid_ensemble_model(
            4, 100.0, dtype="float64", device=where, extra_cfg=PATH_A)
        out, st = EnsembleRunner(model).run_segment(batched, 0.0, 2.0 * SPY)
        runs[str(where)] = (out.geometry.ice_thickness.sum(dim=(1, 2)).cpu(),
                            st)
    (va, sa), (vb, sb) = runs["cpu"], runs[str(dev)]
    rel = float(((vb - va).abs() / va.abs()).max())
    same = [a.nsteps == b.nsteps and a.limit_hits == b.limit_hits
            for a, b in zip(sa, sb)]
    print(f"phase12d: 4-member hybrid ensemble 100 km float64, 2 a, card "
          f"against CPU: member steps {[s.nsteps for s in sb]} / "
          f"{[s.nsteps for s in sa]}, hits equal {all(same)}, Newton sweeps "
          f"{[s.ssa_newton_iters for s in sb]} / "
          f"{[s.ssa_newton_iters for s in sa]}, Krylov iterations "
          f"{[s.ssa_krylov_iters for s in sb]} / "
          f"{[s.ssa_krylov_iters for s in sa]}, volume max rel diff "
          f"{rel:.3e} (tol 1e-7)")
    if not all(same) or not rel <= 1e-7:
        raise AssertionError("phase12d: the card and the CPU disagree")


def phase12_hybrid_ensemble(dev, smi):
    """Phase 12 (its member-axis kernels' records and launches print; the
    kernels line takes phase 13's)."""
    t = time.time()
    model, runner, batched, s2, st2 = phase12a_hybrid(dev, smi)
    print(f"phase12a: {time.time() - t:.1f} s")
    phase12b_members(model, runner, batched, s2, st2)
    phase12c_kernels(model, s2)
    phase12d_card_vs_cpu(dev)


# -- phase 13: the Antarctic ensemble (BASELINE config 5 on the PIK chain) -

#: the PISM-PIK chain's ensemble from its data file: members, the warm-up
#: and the timed segment [a], the members held against their own runs, the
#: profiled and the components' windows [a] (one lockstep step each)
PIKE_MEMBERS, PIKE_FIRST, PIKE_TIMED = 100, 1.0, 2.0
PIKE_SOLO = (0, 50, 99)
PIKE_PROFILE, PIKE_PARTS = 0.25, 0.25


def _member_pico(pico, b, solo):
    """PICO with member b's water, for its solo chain (``temperature_ocean``)
    or its 1-member ensemble (``member_temperature``)."""
    import dataclasses
    mt = pico.member_temperature
    return dataclasses.replace(pico, **(
        {"temperature_ocean": mt[b]} if solo
        else {"member_temperature": mt[b:b + 1]}))


def _member_model(model, b, solo):
    import dataclasses
    return dataclasses.replace(model, ocean=_member_pico(model.ocean, b, solo))


def _pike_components(runner, state, t0, years, label):
    """Inclusive ms per lockstep step of the twin's stress balance, mass
    transport (PICO inside), PICO, calving and Lingle-Clark (host timers,
    the card synchronised on entry and exit), and PICO's host syncs per
    call. Returns (state, PICO's share of the step)."""
    twin = runner.twin(state.geometry.ice_thickness.device)
    targets = [(twin.stress_balance, "update", "stress balance"),
               (twin, "_mass_substep", "mass transport (PICO inside)"),
               (twin.ocean, "members", "PICO"),
               (twin.calving, "step", "calving"),
               (twin.bed_deformation, "members_step", "Lingle-Clark")]
    (state, stats), acc, calls, wall = _component_times(
        targets, lambda: runner.run_segment(state, t0, t0 + years * SPY))
    lock = _lockstep(stats)
    parts = ", ".join(f"{lab} {1e3 * v / lock:.1f}" for lab, v in acc.items())
    print(f"{label}: {years} a, {lock} lockstep steps, "
          f"{1e3 * wall / lock:.1f} ms per lockstep step with the timers; "
          f"inclusive ms per lockstep step: {parts}; PICO {calls['n']} calls "
          f"({calls['n'] / lock:.0f} per lockstep step), "
          f"{calls['syncs'] / max(calls['n'], 1):.1f} host syncs per call "
          "(phase 9a prints a solo call's)")
    return state, acc["PICO"] / wall


def phase13a_antarctic(dev, smi):
    """The PISM-PIK chain's ensemble at its width: 100 members at 251x251x31
    float32 on path A from the data file, members differing in PICO's
    ocean temperature (0-2 K warmer), 1 a then 2 a timed. Returns (model,
    runner, initial batched state, the 1 a state and stats, the 3 a state,
    dT, counts of the timed run)."""
    import numpy as np
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch import state as S
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    torch.cuda.reset_peak_memory_stats()
    w0 = time.perf_counter()
    model, batched, grid, dT = setups.antarctica_pik_ensemble_model(
        PIKE_MEMBERS, PIK_KM, device=dev, extra_cfg=PATH_A)
    _sync()
    print(f"phase13a: {smi}; setup (data file, bootstrap, couplers, "
          f"{PIKE_MEMBERS} copies) {time.perf_counter() - w0:.2f} s")
    runner = EnsembleRunner(model)
    # PICO's basin sums: member_sum
    launched = SSA_MEMBER_KERNELS + ("member_sum",)
    s1, st1, wall1, counts1 = _hybrid_run(runner, batched, 0.0, PIKE_FIRST,
                                          "phase13a first", launched)
    out, st, wall, counts = _hybrid_run(runner, s1, PIKE_FIRST, PIKE_TIMED,
                                        "phase13a", launched)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _hybrid_report(f"phase13a first {PIKE_FIRST} a (untimed warm-up)",
                   PIKE_MEMBERS, st1, wall1, PIKE_FIRST, counts1)
    _hybrid_report(f"phase13a timed {grid.My}x{grid.Mx}x{grid.Mz} float32 "
                   "path A", PIKE_MEMBERS, st, wall, PIKE_TIMED, counts)
    print(f"phase13a: peak device memory {peak:.2f} GiB "
          "(torch.cuda.max_memory_allocated)")
    for name in ("bed_elevation", "ice_area_specific_volume"):
        if not bool(torch.isfinite(getattr(out.geometry, name)).all()):
            raise AssertionError(f"phase13a: non-finite {name}")
    if not bool(torch.isfinite(out.bed_uplift).all()):
        raise AssertionError("phase13a: non-finite bed_uplift")
    calved = np.array([float(a.sum_calving) + float(b.sum_calving)
                       for a, b in zip(st1, st)])
    melted = np.array([float(a.sum_bmb) + float(b.sum_bmb)
                       for a, b in zip(st1, st)])
    moved = (out.bed_uplift != batched.bed_uplift).flatten(1).any(1)
    floating = S.floating_ice(out.geometry.cell_type)
    melt = model.ocean.members(out.geometry, None)
    shelf_melt = torch.where(floating, melt, 0.0).amax(dim=(1, 2))
    vols = out.geometry.ice_thickness.double().sum(dim=(1, 2)).cpu().numpy() \
        * grid.dx * grid.dy / 1e15
    corr = float(np.corrcoef(dT, melted)[0, 1])
    print(f"phase13a: over the {PIKE_FIRST + PIKE_TIMED} a, calving "
          f"{calved.max() / 1e9:.3f} to {calved.min() / 1e9:.3f} km^3 a "
          f"member, bed moved in {int(moved.sum())} members, shelf cells "
          f"{int(floating.sum(dim=(1, 2)).min())}-"
          f"{int(floating.sum(dim=(1, 2)).max())}, max PICO melt "
          f"{float(shelf_melt.min()) * SPY:.3f}-"
          f"{float(shelf_melt.max()) * SPY:.3f} m/a; sub-shelf and basal "
          f"melt {melted[0] / 1e9:.3f} km^3 (dT {dT[0]:g} K) to "
          f"{melted[-1] / 1e9:.3f} km^3 (dT {dT[-1]:g} K), correlation with "
          f"dT {corr:.4f} (must be above 0.9); volumes "
          f"{vols.min():.6f}-{vols.max():.6f} 1e6 km^3, volume-dT "
          f"correlation {float(np.corrcoef(dT, vols)[0, 1]):.4f}")
    if not (calved < 0.0).all():
        raise AssertionError("phase13a: a member did not calve")
    if not bool(moved.all()):
        raise AssertionError("phase13a: Lingle-Clark left a member's bed")
    if not (bool(floating.any(dim=(1, 2)).all())
            and bool((shelf_melt > 0.0).all())):
        raise AssertionError("phase13a: a member has no shelf with PICO melt")
    if not corr > 0.9:
        raise AssertionError(f"phase13a: melt-dT correlation {corr:.3f}")
    t3 = (PIKE_FIRST + PIKE_TIMED) * SPY
    _profile_ensemble(runner, out, t3, PIKE_PROFILE, "phase13a")
    _, share = _pike_components(runner, out, t3, PIKE_PARTS,
                                "phase13a components")
    print(f"phase13a: PICO's share of a lockstep step {share:.3f}")
    return model, runner, batched, s1, st1, out, dT, counts


def phase13b_members(model, runner, batched, s1, st1):
    """Members 0, 50 and 99 over the 1 a warm-up: each equal to the bit to
    its run as a 1-member ensemble (H, Href, E, u_ssa, the bed, the viscous
    displacement, PICO's box index, steps, hits, Newton and Krylov
    counts), and within phase 2b's envelope of its solo chain (equal steps
    and dt-limit hits, volume within 2e-4)."""
    import torch
    from pism_tpu_torch.parallel.ensemble import (EnsembleRunner, member,
                                                  stack_states)

    pico = model.ocean
    for b in PIKE_SOLO:
        one_model = _member_model(model, b, solo=False)
        one, (so,) = EnsembleRunner(one_model).run_segment(
            stack_states([member(batched, b)]), 0.0, PIKE_FIRST * SPY)
        same = {n: torch.equal(getattr(one.geometry, n)[0],
                               getattr(s1.geometry, n)[b])
                for n in ("ice_thickness", "ice_area_specific_volume",
                          "bed_elevation")}
        same.update({n: torch.equal(getattr(one, n)[0], getattr(s1, n)[b])
                     for n in ("enthalpy", "u_ssa", "v_ssa", "bed_uplift")})
        same["box"] = torch.equal(
            one_model.ocean.boxes(one.geometry, 1).box[0],
            pico.boxes(s1.geometry, 1).box[b])
        e = st1[b]
        counts = ((so.nsteps, so.limit_hits, so.ssa_newton_iters,
                   so.ssa_krylov_iters)
                  == (e.nsteps, e.limit_hits, e.ssa_newton_iters,
                      e.ssa_krylov_iters))
        solo = _member_model(model, b, solo=True)
        st, _, ss = solo.step_once(member(batched, b), 0.0, PIKE_FIRST * SPY)
        V = float(st.geometry.ice_thickness.double().sum())
        Ve = float(s1.geometry.ice_thickness[b].double().sum())
        rel = abs(Ve - V) / V
        print(f"phase13b: member {b}: as a 1-member ensemble equal to the "
              f"bit {same}, counts (steps {e.nsteps}, hits, Newton "
              f"{e.ssa_newton_iters}, Krylov {e.ssa_krylov_iters}) equal "
              f"{counts}; solo chain: steps {ss.nsteps} / {e.nsteps}, hits "
              f"{ss.limit_hits_dict()} / {e.limit_hits_dict()}, Newton "
              f"{ss.ssa_newton_iters}, Krylov {ss.ssa_krylov_iters}, volume "
              f"rel diff {rel:.3e} (tol 2e-4)")
        if not (all(same.values()) and counts):
            raise AssertionError(f"phase13b: member {b} differs from its "
                                 "1-member ensemble")
        if ss.nsteps != e.nsteps \
                or ss.limit_hits_dict() != e.limit_hits_dict() \
                or not rel <= 2e-4:
            raise AssertionError(f"phase13b: member {b} and its solo chain "
                                 "disagree")


#: PICO's member form against its single form, whose basin sums add in
#: torch's order: the largest difference in melt, of each member's max
#: melt (3.1e-5-3.2e-5 measured on an NVIDIA H100 80GB HBM3, 700.00 W)
PICO_SOLO_TOL = 1e-4


def _wall_ms(fn, reps=3):
    """ms per call of ``fn`` on the host's clock, the card synchronised
    before and after."""
    _sync()
    w0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync()
    return 1e3 * (time.perf_counter() - w0) / reps


def phase13c_components(model, state):
    """On the ensemble's 3 a state: ``Pico.members`` against 100 single
    PICO calls (box index and distances equal to the single form's, the
    melt to the bit to each member's 1-member call, and within
    ``PICO_SOLO_TOL`` of the single form's, which differs by its basin
    sums' order) and one member-axis Lingle-Clark solve (a dt per member)
    against 100 single solves, to the bit; each timed against the single
    calls."""
    import torch
    from pism_tpu_torch.parallel.ensemble import member

    pico, lc = model.ocean, model.bed_deformation
    B = state.geometry.ice_thickness.shape[0]
    geoms = [member(state, b).geometry for b in range(B)]
    singles = [_member_pico(pico, b, solo=True) for b in range(B)]
    ones = [_member_pico(pico, b, solo=False) for b in range(B)]
    one_ms = _wall_ms(lambda: pico.members(state.geometry, None))
    melt = pico.members(state.geometry, None)
    boxes = pico.boxes(state.geometry, 1)
    pfs = []
    many_ms = _wall_ms(lambda: pfs.extend(singles[b].solve(geoms[b], 0.0)
                                          for b in range(B)), 1)
    solo_diff = 0.0
    for b, pf in enumerate(pfs):
        g1 = member(state, slice(b, b + 1)).geometry
        if not (torch.equal(melt[b], ones[b].members(g1, None)[0])
                and all(torch.equal(x[b], y) for x, y in
                        zip(boxes, (pf.box, pf.d_gl, pf.d_if)))):
            raise AssertionError(f"phase13c: PICO member {b} differs from "
                                 "its single call")
        scale = float(pf.melt.abs().max())
        solo_diff = max(solo_diff,
                        float((melt[b] - pf.melt).abs().max()) / scale)
    print(f"phase13c: Pico.members of {B} members: box index and distances "
          f"equal to {B} single calls, melt equal to the bit to each "
          f"member's 1-member call and within {solo_diff:.3e} of the single "
          f"form's max melt (its basin sums in torch's order; tol "
          f"{PICO_SOLO_TOL:.0e}); {one_ms:.1f} ms against {many_ms:.1f} ms "
          f"for {B} single calls (synchronised host timers)")
    if not solo_diff <= PICO_SOLO_TOL:
        raise AssertionError(f"phase13c: PICO's member form is {solo_diff:.3e}"
                             " of the max melt from its single form")
    dts = [(1.0 + b / B) * SPY for b in range(B)]
    U = state.bed_uplift
    dt = torch.tensor(dts, dtype=torch.float64, device=U.device).to(
        U.dtype).view(-1, 1, 1)
    got = lc._solve(state, dt)
    members = [member(state, b) for b in range(B)]
    for b in range(B):
        want = lc._solve(members[b], dts[b])
        if not (torch.equal(got.bed_uplift[b], want.bed_uplift)
                and torch.equal(got.geometry.bed_elevation[b],
                                want.geometry.bed_elevation)):
            raise AssertionError(f"phase13c: Lingle-Clark member {b} differs "
                                 "from its single solve")

    def lc_singles():
        for b in range(B):
            lc._solve(members[b], dts[b])

    one_ms = _wall_ms(lambda: lc._solve(state, dt))
    many_ms = _wall_ms(lc_singles, 1)
    print(f"phase13c: one Lingle-Clark solve of {B} members (batched cuFFT, "
          f"a dt each) equal to the bit to {B} single solves; {one_ms:.2f} ms "
          f"against {many_ms:.2f} ms (synchronised host timers)")


def phase13e_kernels(model, state):
    """Phase 12c's holds on the Antarctic ensemble's 3 a state, 100 x 251 x
    251 (K2b's and K2's lines of n = 251 on the member axis), and PICO's
    basin sums: ``member_sum`` over the (B nb, My, Mx) basin rows of the
    members' water under their shelves against one launch per row (to the
    bit) and its plain version, torch's sum of the same rows (1e-5), which
    is also its yardstick. Returns the records."""
    import torch
    from pism_tpu_torch import state as S
    from pism_tpu_torch.ops.kernels import member_dot as KD

    out = phase12c_kernels(model, state, "phase13e")
    pico = model.ocean
    shelf = S.floating_ice(state.geometry.cell_type)
    x = pico.member_temperature * shelf.to(pico.member_temperature.dtype)
    rows = torch.where(pico.onehot, x[:, None], 0.0).reshape(
        -1, *x.shape[-2:])
    R, My, Mx = rows.shape
    label = (f"{R}x{My}x{Mx} float32 (PICO's basin rows of {x.shape[0]} "
             "members)")
    out["member_sum"] = _member_ssa_case(
        "member_sum", label, KD.member_sum, KD.member_sum_plain, (rows,),
        lambda b: KD.member_sum(rows[b:b + 1]), 1e-5, rows.numel(),
        "member_sums_kernel", phase="phase13e", singles_timed=False)
    _yardstick("phase13e", "member_sum", label, out["member_sum"],
               lambda: KD.member_sum(rows), "torch's one sum of the rows",
               lambda: torch.sum(rows, dim=(-2, -1)),
               KD.member_sum_plain(rows))
    return out


def phase13d_card_vs_cpu(dev):
    """A 4-member Antarctic ensemble at 125 km (phase 9b's size) in float64,
    path A, 2 a on the card and on the CPU: equal steps and dt-limit hits
    per member, volumes within 1e-7."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    runs = {}
    for where in ("cpu", dev):
        model, batched, grid, _ = setups.antarctica_pik_ensemble_model(
            4, PIK_CHECK_KM, "float64", device=where, extra_cfg=PATH_A)
        out, st = EnsembleRunner(model).run_segment(batched, 0.0, 2.0 * SPY)
        runs[str(where)] = (out.geometry.ice_thickness.sum(dim=(1, 2)).cpu(),
                            st)
    (va, sa), (vb, sb) = runs["cpu"], runs[str(dev)]
    rel = float(((vb - va).abs() / va.abs()).max())
    same = [a.nsteps == b.nsteps and a.limit_hits == b.limit_hits
            for a, b in zip(sa, sb)]
    print(f"phase13d: 4-member Antarctic ensemble {PIK_CHECK_KM:g} km "
          f"float64, 2 a, card against CPU: member steps "
          f"{[s.nsteps for s in sb]} / {[s.nsteps for s in sa]}, hits equal "
          f"{all(same)}, Newton sweeps {[s.ssa_newton_iters for s in sb]} / "
          f"{[s.ssa_newton_iters for s in sa]}, volume max rel diff "
          f"{rel:.3e} (tol 1e-7)")
    if not all(same) or not rel <= 1e-7:
        raise AssertionError("phase13d: the card and the CPU disagree")


def phase13_antarctic_ensemble(dev, smi):
    """Phase 13; returns (the member-axis kernels' records, the timed run's
    launch counts)."""
    t = time.time()
    model, runner, batched, s1, st1, out, _, counts = phase13a_antarctic(
        dev, smi)
    print(f"phase13a: {time.time() - t:.1f} s")
    _timed("phase13b", phase13b_members, model, runner, batched, s1, st1)
    _timed("phase13c", phase13c_components, model, out)
    records = _timed("phase13e", phase13e_kernels, model, out)
    _timed("phase13d", phase13d_card_vs_cpu, dev)
    return records, counts


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

    timings = _timed("phase1 kernels", phase1_kernels, dev)
    _timed("phase1 chain reference", phase1_chain_reference, dev)
    t2 = time.time()

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
    path_a = (model, state, t)
    (s2, _, v2), (sa, _, va) = p2, a2
    rel = abs(va - v2) / v2
    print(f"phase2b: after 2 a against phase 2: steps {sa.nsteps} / "
          f"{s2.nsteps}, dt-limit hits {sa.limit_hits_dict()} / "
          f"{s2.limit_hits_dict()}, volume rel diff {rel:.3e} (tol 2e-4)")
    if sa.nsteps != s2.nsteps or sa.limit_hits_dict() != s2.limit_hits_dict() \
            or not rel <= 2e-4:
        raise AssertionError("phase2b: path A and the default path disagree")
    print(f"phase2: the runs {time.time() - t2:.1f} s")
    t2 = time.time()
    check_preconditioner(model, state, t)
    check_newton_matvec(model, state, t)
    profile_krylov(model, state, t)
    profile_bicgstab(model, state, t, 0.01, "phase2b")
    profile_steps(model, state, t, 0.01, "phase2b")
    breakdown(model, state, t, 1.0, "phase2b")
    print(f"phase2b: the checks and profiles {time.time() - t2:.1f} s")
    t3 = time.time()
    model, state, t, _, _ = run_hybrid(dev, 5.0, (0.5,), "phase3", PATH_A,
                                       k1 + pcr_names, off)
    profile_bicgstab(model, state, t, 0.01, "phase3")
    breakdown(model, state, t, 0.25, "phase3")
    print(f"phase3: {time.time() - t3:.1f} s")
    counts_b, eismint_7ka, k3_run = _timed("phase4", phase4_eismint, dev)
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
    t7 = time.time()
    phase7_cli(dev, path_a)
    print(f"phase7: {time.time() - t7:.1f} s")
    import tempfile
    t8 = time.time()
    print(f"phase8: {smi}")
    with tempfile.TemporaryDirectory() as d:
        phase8_workflow(dev, d)
    print(f"phase8: {time.time() - t8:.1f} s")
    t9 = time.time()
    print(f"phase9: {smi}")
    phase9_pik(dev, k1, pcr_names, off)
    print(f"phase9: {time.time() - t9:.1f} s")
    t10 = time.time()
    print(f"phase10: {smi}")
    phase10_mismip(dev, k1, pcr_names, off)
    print(f"phase10: {time.time() - t10:.1f} s")
    t11 = time.time()
    print(f"phase11: {smi}")
    (k3m, counts_k3m), (k4m, counts_k4m) = phase11_ensemble(dev, smi)
    timings["sia_flux_thermo_members"], timings["sia_flux_members"] = k3m, k4m
    print(f"phase11: {time.time() - t11:.1f} s")
    t12 = time.time()
    print(f"phase12: {smi}")
    phase12_hybrid_ensemble(dev, smi)
    print(f"phase12: {time.time() - t12:.1f} s")
    t13 = time.time()
    print(f"phase13: {smi}")
    records13, counts13 = phase13_antarctic_ensemble(dev, smi)
    # the member-axis kernels' entries are this slice's path's: phase 13's
    # records at 100x251x251 and its timed run's launches (phase 12c's
    # records at 100x141x76 are in its lines above)
    timings.update(records13)
    print(f"phase13: {time.time() - t13:.1f} s")
    print(f"chip_smoke: all phases passed in {time.time() - start:.1f} s")

    # library_ms: torch.linalg.solve on the dense matrices for the line
    # solves, torch.linalg.vecdot for the member dot and the member dots,
    # torch.sum for the member sum; no single PyTorch call
    # computes any of the other functions
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
            ("ssa_newton_matvec_halo", "ssa_matvec.cu", "pism_tpu/ops/pallas_sharded.py:225", counts_d),
            ("sia_flux_thermo_members", "sia_thermo.cu", "pism_tpu/ops/pallas_kernels.py:195", counts_k3m),
            ("sia_flux_members", "sia_iso.cu", "pism_tpu/ops/pallas_kernels.py:300", counts_k4m),
            ("ssa_matvec_members", "ssa_matvec.cu", "pism_tpu/ops/pallas_kernels.py:325", counts13),
            ("ssa_newton_matvec_members", "ssa_matvec.cu", "pism_tpu/ops/pallas_kernels.py:407", counts13),
            ("pcr_lines_members", "pcr.cu", "pism_tpu/ops/pallas_kernels.py:482", counts13),
            ("pcr_lines_sub_members", "pcr.cu", "pism_tpu/ops/pallas_kernels.py:539", counts13),
            ("pcr_factor_lines_members", "pcr.cu", "pism_tpu/ops/pallas_kernels.py:482", counts13),
            ("pcr_factor_lines_sub_members", "pcr.cu", "pism_tpu/ops/pallas_kernels.py:539", counts13),
            ("member_dot", "member_dot.cu", "pism_tpu/ops/ssa.py:332", counts13),
            ("member_dots", "member_dot.cu", "pism_tpu/ops/ssa.py:332", counts13),
            ("member_sum", "member_dot.cu", "pism_tpu/coupler/pico.py:209", counts13)):
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
