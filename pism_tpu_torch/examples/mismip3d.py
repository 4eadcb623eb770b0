"""MISMIP3d grounding-line experiments (Pattyn et al. 2013, BASELINE
config 2), twin of the JAX package's ``examples/mismip3d.py``.

  Stnd  — spin a marine ice sheet on the linear bed b = -100 - |x|/1 km
          to a steady grounding line (uniform Weertman friction
          C |u|^(1/3), through the pseudo-plastic law: q = 1/3,
          tau_c = C u_threshold^q).
  P75S  — reduce the basal friction by 75% in a Gaussian patch centred on
          the steady grounding line at the channel's centre line
          (x_c = 150 km, y_c = 10 km) and run 100 years: the centre
          grounding line advances, the lateral one retreats.
  P75R  — restore uniform friction and run on: the grounding line must
          return toward its Stnd position (reversibility).

The friction is prescribed through ``GivenYieldStress`` (PISM's
``-yield_stress given``). The domain is [-800, 800] x [-50, 50] km with an
odd My, so that one row lies on the centre line: 1601 x 101 at 1 km. The
setup, the P75S patch and the grounding line are
``verification/mismip.py``'s ``setup_3d``, ``tau_c_perturbed`` and
``gl_x``; this script runs the protocol and prints its JSON summary.

Usage: python -m pism_tpu_torch.examples.mismip3d [--dx-km 10]
           [--stnd-years 15000] [--perturb-years 100]
           [--recovery-years 2000] [--float32] [--device cpu]
"""

import argparse
import json
import time

SPY = 3.15569259747e7


def run_phase(model, state, years, label):
    """``years`` of ``model.run`` from t = 0; returns (state, stats)."""
    from pism_tpu_torch import Time
    tic = time.time()
    state, stats = model.run(state, Time(0.0, years * SPY))
    print(f"  {label}: {years:.0f} a in {time.time() - tic:.1f} s "
          f"({int(stats.nsteps)} steps)")
    return state, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dx-km", type=float, default=10.0)
    ap.add_argument("--stnd-years", type=float, default=15000.0)
    ap.add_argument("--perturb-years", type=float, default=100.0)
    ap.add_argument("--recovery-years", type=float, default=2000.0)
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cpu without a card)")
    args = ap.parse_args(argv)

    import dataclasses

    from pism_tpu_torch import setups
    from pism_tpu_torch.physics.basal import GivenYieldStress
    from pism_tpu_torch.verification.mismip import (TAU_C0, gl_x,
                                                    tau_c_perturbed)

    model, state, grid = setups.mismip3d_model(
        "float32" if args.float32 else "float64", km=args.dx_km,
        device=args.device)
    mid, edge = grid.My // 2, 0

    def model_with(tau_c):
        return dataclasses.replace(model, yield_stress=GivenYieldStress(
            model.config, tau_c=tau_c))

    print(f"MISMIP3d at dx = {args.dx_km:g} km "
          f"({grid.Mx}x{grid.My}); tau_c0 = {TAU_C0:.0f} Pa; "
          f"Schoof semi-analytic steady GL ~ 606 km")
    state, _ = run_phase(model, state, args.stnd_years, "Stnd ")
    gl_stnd = gl_x(state, grid, mid)
    print(f"  Stnd grounding line: x = {gl_stnd / 1e3:.1f} km")

    state, _ = run_phase(model_with(tau_c_perturbed(grid, TAU_C0, gl_stnd)),
                         state, args.perturb_years, "P75S ")
    gl_c, gl_e = gl_x(state, grid, mid), gl_x(state, grid, edge)
    print(f"  P75S grounding line: center {gl_c / 1e3:.1f} km, "
          f"edge {gl_e / 1e3:.1f} km (center - edge = "
          f"{(gl_c - gl_e) / 1e3:.1f} km)")

    state, _ = run_phase(model, state, args.recovery_years, "P75R ")
    gl_r = gl_x(state, grid, mid)
    print(f"  P75R grounding line: x = {gl_r / 1e3:.1f} km "
          f"(Stnd {gl_stnd / 1e3:.1f} km; residual "
          f"{abs(gl_r - gl_stnd) / 1e3:.2f} km)")

    print(json.dumps({
        "dx_km": args.dx_km,
        "gl_stnd_km": gl_stnd / 1e3,
        "gl_p75s_center_km": gl_c / 1e3,
        "gl_p75s_edge_km": gl_e / 1e3,
        "gl_p75r_km": gl_r / 1e3,
        "reversibility_residual_km": abs(gl_r - gl_stnd) / 1e3,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
