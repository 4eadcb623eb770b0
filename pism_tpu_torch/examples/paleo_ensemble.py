"""Paleo-climate parameter ensemble (BASELINE config 5), the port of
``examples/paleo_ensemble.py``: thermo-coupled SIA members that differ in
a temperature offset dT and a precipitation scaling exp(0.07 dT), run in
lockstep on a member axis by ``parallel.ensemble.EnsembleRunner`` (each
member with its own adaptive dt; the SIA kernels launched once for all
members). A 50 a first segment, then the rest timed; it prints what the
JAX example prints.

    python -m pism_tpu_torch.examples.paleo_ensemble --members 100 --years 500
    python -m pism_tpu_torch.examples.paleo_ensemble --device cpu --km 100 \\
        --members 4 --years 60          # a CPU run, float64
"""

import argparse
import json
import time

import numpy as np
import torch

SPY = 3.15569259747e7


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--years", type=float, default=500.0)
    ap.add_argument("--km", type=float, default=40.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from pism_tpu_torch import setups
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    model, batched, grid, dT = setups.paleo_ensemble_model(
        args.members, args.km, device=args.device)
    n = args.members
    print(f"{n} members on a {grid.Mx} x {grid.My} x {grid.Mz} grid "
          f"({args.device}, {model.config.get_string('runtime.float_dtype')})")
    runner = EnsembleRunner(model=model)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    tic = time.time()
    out, stats = runner.run_segment(batched, 0.0, 50.0 * SPY)
    sync()
    print(f"first 50 a: {time.time() - tic:.0f} s")

    tic = time.time()
    out, stats = runner.run_segment(out, 50.0 * SPY, args.years * SPY)
    sync()
    wall = time.time() - tic

    vols = out.geometry.ice_thickness.double().sum(dim=(1, 2)).cpu().numpy() \
        * grid.dx * grid.dy / 1e15
    print(json.dumps({
        "members": n,
        "model_years": args.years,
        "wall_s": round(wall, 1),
        "member_years_per_hour": round(n * (args.years - 50.0) / wall * 3600.0,
                                       1),
        "volume_range_1e6_km3": [round(float(vols.min()), 3),
                                 round(float(vols.max()), 3)],
        # physical sanity: warmer members (larger dT) should hold less ice
        "volume_dT_correlation": round(float(np.corrcoef(dT, vols)[0, 1]), 3),
    }))
    return out, stats


if __name__ == "__main__":
    main()
