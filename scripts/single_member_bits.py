"""The single-member chains of the port, run briefly on the card and kept to
the bit, so that a change can be held to an earlier checkout's results.

    python3 scripts/single_member_bits.py --out change.npz
    python3 scripts/single_member_bits.py --root <dir> --out parent.npz
    python3 scripts/single_member_bits.py --compare parent.npz change.npz

``--root`` runs the ``pism_tpu_torch`` of another checkout unpacked in
``<dir>`` (e.g. ``git archive <commit> | tar -x -C .scratch/parent``); its
kernels build under that checkout. Each chain runs through
``IceModel.step_once`` in float32 on the card: EISMINT II A at 61x61x61
from zero ice (path B, K3) for 1,000 a, Halfar B at 601x601 (path C, K4)
for 2 a, the 20 km hybrid chain on the default path and on path A for 1 a,
the PIK chain at 125 km for 1 a, the PIK chain from its data file at 100 km
on path A for 2 a (the bed updated every year, PICO on two basins, eigen
calving acting), MISMIP3d at 50 km for 5 a and MISMIP 1 on its periodic
151x7 grid for 2 a. The file keeps each chain's final thickness, enthalpy
and bed, its steps and dt-limit hits and its volume sums;
``--compare`` prints, per chain, whether every one of them is equal to the
bit, and exits non-zero if one is not.
"""

import argparse
import json
import pathlib
import sys
import time

SPY = 3.15569259747e7


def _pik_data_file(device, km=100.0):
    """The PIK chain as the command line runs it from its data file
    (``examples/antarctica_pik.py``): the config of a zero-length bootstrap
    run, ``io.bootstrap.bootstrap`` and the factory's couplers. The config
    comes from the run's output file, the one route that every checkout's
    ``cli`` has (``--root`` runs an earlier one)."""
    import contextlib
    import io
    import os
    import tempfile

    from pism_tpu_torch import cli
    from pism_tpu_torch.examples.antarctica_pik import (
        bootstrap_argv, couplers, model_grid, synthesize_data_file)
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.io.bootstrap import bootstrap
    from pism_tpu_torch.model.icemodel import IceModel

    with tempfile.TemporaryDirectory() as d:
        data, out = os.path.join(d, "ant.nc"), os.path.join(d, "b0.nc")
        synthesize_data_file(data, km, "netcdf3")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(bootstrap_argv(data, out, km, 0.0, "netcdf3", extra=(
                "-config", "bed_deformation.update_interval=1", "-config",
                "stress_balance.ssa.fd.line_pcr_impl=pallas_sublane",
                *(("-platform", "cpu") if str(device) == "cpu" else ()))))
        cfg, grid = ckpt.load_config(out), model_grid(km)
        surface, ocean = couplers(cfg, grid, data, device)
        model = IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean,
                         device=device)
        return model, model.prepare_state(bootstrap(data, grid, cfg,
                                                    device=device))


def _chains(setups):
    return {
        "eismint2_A_61": (lambda d: setups.eismint2_model("float32", device=d),
                          0.0, 1000.0),
        "halfar_B_601": (lambda d: setups.halfar_model("B", 601, "float32",
                                                       device=d), None, 2.0),
        "hybrid_20km": (lambda d: setups.hybrid_greenland_model(
            "float32", 20.0, device=d), 0.0, 1.0),
        "hybrid_20km_path_A": (lambda d: setups.hybrid_greenland_model(
            "float32", 20.0, device=d, extra_cfg={
                "stress_balance.ssa.fd.line_pcr_impl": "pallas_sublane"}),
            0.0, 1.0),
        "pik_125km": (lambda d: setups.antarctica_pik_model(
            "float32", km=125.0, device=d), 0.0, 1.0),
        "pik_data_100km_path_A": (_pik_data_file, 0.0, 2.0),
        "mismip3d_50km": (lambda d: setups.mismip3d_model(
            "float32", km=50.0, device=d), 0.0, 5.0),
        "mismip1_151x7": (lambda d: setups.mismip_model("float32", device=d),
                          0.0, 2.0),
    }


def run(out_path):
    import numpy as np
    import torch
    from pism_tpu_torch import setups

    if not torch.cuda.is_available():
        raise SystemExit("single_member_bits: needs a CUDA card")
    dev = torch.device("cuda:0")
    arrays, meta = {}, {}
    for name, (build, t0, years) in _chains(setups).items():
        w0 = time.time()
        built = build(dev)
        model, state = built[0], built[1]
        if t0 is None:   # the Halfar dome starts at its solution's t0
            t0 = built[3].t0
        state, t, stats = model.step_once(state, t0, years * SPY)
        torch.cuda.synchronize()
        arrays[f"{name}/H"] = state.geometry.ice_thickness.cpu().numpy()
        if state.enthalpy is not None:
            arrays[f"{name}/E"] = state.enthalpy.contiguous().cpu().numpy()
        arrays[f"{name}/bed"] = state.geometry.bed_elevation.cpu().numpy()
        meta[name] = {
            "t": t, "nsteps": stats.nsteps,
            "limit_hits": stats.limit_hits_dict(),
            "sums": [float(getattr(stats, k)) for k in (
                "sum_div_flux", "sum_smb", "sum_bmb", "sum_nonneg",
                "sum_discharge")],
            "newton": stats.ssa_newton_iters, "krylov": stats.ssa_krylov_iters}
        print(f"{name}: {years} a, {stats.nsteps} steps, hits "
              f"{stats.limit_hits_dict()}, {time.time() - w0:.1f} s",
              flush=True)
    np.savez(out_path, meta=np.array(json.dumps(meta)), **arrays)


def compare(a_path, b_path):
    import numpy as np

    a, b = np.load(a_path), np.load(b_path)
    ma, mb = json.loads(str(a["meta"])), json.loads(str(b["meta"]))
    ok = True
    for name in ma:
        keys = [k for k in a.files if k.startswith(name + "/")]
        fields = {k.split("/")[1]: (a[k].tobytes() == b[k].tobytes()
                                    if k in b.files else False) for k in keys}
        same = ma[name] == mb.get(name) and all(fields.values())
        ok &= same
        print(f"{name}: equal to the bit {same} (fields {fields}; steps "
              f"{ma[name]['nsteps']} / {mb.get(name, {}).get('nsteps')}, "
              f"hits {ma[name]['limit_hits']} / "
              f"{mb.get(name, {}).get('limit_hits')})")
    if not ok:
        raise SystemExit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="checkout whose pism_tpu_torch runs")
    ap.add_argument("--out", help="file the chains' results go to (.npz)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    sys.path.insert(0, args.root or str(pathlib.Path(__file__).resolve()
                                        .parents[1]))
    run(args.out)


if __name__ == "__main__":
    main()
