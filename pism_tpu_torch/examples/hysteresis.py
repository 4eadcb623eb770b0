"""Ice-sheet hysteresis sweep (Garbe et al. 2020, "The hysteresis of the
Antarctic Ice Sheet"), twin of the JAX package's
``examples/hysteresis.py``.

A synthetic marine ice sheet (50 km: 33x33x21) is run under a ramp of
uniform warming offsets applied to the surface climate (the PDD over a
lapse-rate-corrected uniform atmosphere with ``delta_T``) and to the ocean
(``delta_T`` over the PIK melt), up and then back down; the two branches
of the volume against the forcing separate where marine thresholds are
crossed.

As in the JAX example, level i advances by ``t_i + years_per_level``
(``IceModel.step_once``'s third argument is a duration, and the example
passes the end time), so the levels grow longer; and the ocean ``delta_T``
shifts only the shelf-base temperature, so the PIK melt does not see the
warming. Both are kept to give the JAX example's output (ROADMAP,
"Reference quirks").

Usage: python -m pism_tpu_torch.examples.hysteresis [--km 50]
           [--years-per-level 1500] [--dT-max 8] [--levels 5] [--float32]
           [--platform cpu]
"""

import argparse
import json

import numpy as np

SPY = 3.15569259747e7


def setup(km: float = 50.0, dtype: str = "float64", device="cuda"):
    """(grid, initial state, build_model): ``build_model(dT)`` is the
    IceModel of one forcing level, the state prepared in float64 and cast
    to ``dtype`` as the JAX example casts it."""
    import torch

    from pism_tpu_torch import Config, Grid
    from pism_tpu_torch.coupler import atmosphere as atm
    from pism_tpu_torch.coupler.ocean import PIK
    from pism_tpu_torch.coupler.ocean import DeltaT as OceanDeltaT
    from pism_tpu_torch.coupler.pdd import TemperatureIndex
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.setups import to_dtype
    from pism_tpu_torch.state import ModelState, new_geometry

    device = torch.device(device)
    dx = km * 1e3
    L = 800e3
    M = int(2 * L / dx) + 1
    grid = Grid(Mx=M, My=M, Lx=L, Ly=L, Mz=21, Lz=4500.0)
    cfg = Config({
        "stress_balance.model": "ssa+sia",
        "energy.model": "none",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "stress_balance.ssa.flow_law": "isothermal_glen",
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_yield_stress.model": "mohr_coulomb",
        "calving.methods": "thickness_calving,float_kill",
        "geometry.remove_icebergs": True,
        "runtime.float_dtype": dtype,
        "runtime.device_loop": True,
    })
    # marine bed: the interior above sea level, deepening outward with an
    # overdeepened band where the grounding line can jump
    X, Y = np.meshgrid(grid.x, grid.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    bed = 500.0 - 1.3e-3 * r + 250.0 * np.sin(np.pi * r / 500e3)
    H = np.maximum(3200.0 * (1.0 - (r / 650e3) ** 2), 0.0) * (bed > -800.0)

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    def build_model(dT):
        a = atm.DeltaT(
            inner=atm.ElevationChange(
                inner=atm.Uniform(temperature=252.15, temperature_july=263.15,
                                  precipitation=0.25 / SPY),
                reference_surface=torch.zeros(grid.shape2,
                                              dtype=torch.float64,
                                              device=device),
                lapse_rate=8e-3),
            offset=lambda t, d=dT: d)
        surface = TemperatureIndex(atmosphere=a, config=cfg)
        ocean = OceanDeltaT(inner=PIK(config=cfg),
                            offset=lambda t, d=dT: 0.25 * d)
        return IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean,
                        device=device)

    state = build_model(0.0).prepare_state(ModelState(geometry=new_geometry(
        t64(H), t64(bed))))
    if dtype == "float32":
        state = to_dtype(state, torch.float32)
    return grid, state, build_model


def levels(dT_max: float, n: int):
    """The forcing levels: n up to dT_max, then back down."""
    up = list(np.linspace(0.0, dT_max, n))
    return up, up + up[-2::-1]


def record(grid, state, stats, dT, up):
    """The example's JSON record of a level."""
    H = state.geometry.ice_thickness.double()
    return {"dT": round(float(dT), 2), "branch": "up" if up else "down",
            "volume_1e6_km3": round(float(H.sum()) * grid.dx * grid.dy
                                    / 1e15, 4),
            "steps": int(stats.nsteps)}


def sweep(grid, state, build_model, dTs, n_up, years_per_level):
    """Run the levels ``dTs`` (the first ``n_up`` the up branch) as the
    JAX example does, level i advancing by ``t_i + years_per_level``;
    yields per level (record, state, t, stats)."""
    t = 0.0
    for i, dT in enumerate(dTs):
        state, t, stats = build_model(float(dT)).step_once(
            state, t, t + years_per_level * SPY)
        yield record(grid, state, stats, dT, i < n_up), state, t, stats


def gaps(results):
    """The volume gap between the branches at each level both visit."""
    up = {r["dT"]: r["volume_1e6_km3"] for r in results if r["branch"] == "up"}
    down = {r["dT"]: r["volume_1e6_km3"]
            for r in results if r["branch"] == "down"}
    return {dT: round(up[dT] - down[dT], 4) for dT in down if dT in up}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=50.0)
    ap.add_argument("--years-per-level", type=float, default=1500.0)
    ap.add_argument("--dT-max", type=float, default=8.0)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--platform", default=None,
                    help="cpu runs on the CPU; the default is the card")
    ap.add_argument("--float32", action="store_true")
    args = ap.parse_args(argv)

    device = "cpu" if args.platform == "cpu" else "cuda"
    grid, state, build_model = setup(
        args.km, "float32" if args.float32 else "float64", device)
    up, dTs = levels(args.dT_max, args.levels)
    results = []
    for rec, *_ in sweep(grid, state, build_model, dTs, len(up),
                         args.years_per_level):
        results.append(rec)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"hysteresis_gap_by_dT": gaps(results)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
