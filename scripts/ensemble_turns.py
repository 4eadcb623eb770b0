"""Two checkouts' ensembles timed in turns on one CUDA card.

    python3 scripts/ensemble_turns.py --roots DIR_A DIR_B [--rounds N]
        [--chains hybrid antarctic]

Runs ``chip_smoke.py``'s phase 12a segment (the ``ssa+sia`` ensemble:
100 members at 20 km, path A, 2 a untimed then 3 a timed) and phase 13a's
(the Antarctic PIK ensemble: 100 members at 16 km, path A, 1 a untimed
then 2 a timed) of each checkout unpacked in ``DIR_A`` and ``DIR_B``
(e.g. ``git archive <commit> | tar -x -C .scratch/parent``), each in a
process of its own that imports that checkout's ``pism_tpu_torch`` and
builds its kernels, in turns (A, B, B, A, then again) ``--rounds`` times.
Each run prints the timed segment's ms per lockstep step, its lockstep
Krylov iterations and its launches of the member dot kernels per
lockstep step, beside the card's name and power limit. It needs a CUDA
card.
"""

import argparse
import json
import pathlib
import subprocess
import sys

RUN = r"""
import json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as CS
from pism_tpu_torch import setups
from pism_tpu_torch.parallel.ensemble import EnsembleRunner
chain = sys.argv[1]
dev = torch.device("cuda:0")
if chain == "hybrid":
    model, state, grid, _ = setups.hybrid_ensemble_model(
        100, 20.0, device=dev, extra_cfg=CS.PATH_A)
    first, timed = 2.0, 3.0
else:
    model, state, grid, _ = setups.antarctica_pik_ensemble_model(
        100, 16.0, device=dev, extra_cfg=CS.PATH_A)
    first, timed = 1.0, 2.0
runner = EnsembleRunner(model)
state, _ = runner.run_segment(state, 0.0, first * CS.SPY)
torch.cuda.synchronize()
CS.reset_counts()
w0 = time.time()
state, st = runner.run_segment(state, first * CS.SPY, (first + timed) * CS.SPY)
torch.cuda.synchronize()
wall = time.time() - w0
counts = CS.read_counts()
lock = CS._lockstep(st)
dots = {k: round(v / lock, 2) for k, v in counts.items()
        if k.startswith("member")}
print(json.dumps({"chain": chain, "ms_per_lockstep_step": 1e3 * wall / lock,
                  "lockstep_steps": lock,
                  "krylov_per_lockstep_step":
                      st[0].ssa_lockstep_krylov / lock,
                  "member_launches_per_lockstep_step": dots}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs=2, type=pathlib.Path, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--chains", nargs="+", default=["hybrid", "antarctic"])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    a, b = args.roots
    for chain in args.chains:
        for r in range(args.rounds):
            for root in (a, b, b, a) if r % 2 == 0 else (b, a, a, b):
                out = subprocess.run([sys.executable, "-c", RUN, chain],
                                     cwd=root, capture_output=True,
                                     text=True)
                if out.returncode != 0:
                    raise SystemExit(f"{root} {chain} failed:\n"
                                     f"{out.stdout}{out.stderr}")
                line = json.loads(out.stdout.strip().splitlines()[-1])
                print(f"{root}: {json.dumps(line)}", flush=True)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
