"""The Blatter and SSAFEM solves on the synthetic-Greenland initial state
(``setups.hybrid_greenland_model``, float64) through both packages on the
CPU, to tell the port's behaviour on real margins and masks from the
algorithm's:

- the residual and its Newton matvec at the initial state and at a seeded
  iterate, the port's against the JAX package's (``jax.jvp``);
- one Blatter solve with the Newton cap of ``chip_smoke.py`` phase 17f:
  sweeps, BiCGStab iterations of each solve, |F|^2 / tol and the
  velocities' distance;
- one SSAFEM solve (``stress_balance.ssa.method = fem``), the same, with
  the JAX package both compiled (as it runs) and, with ``--eager``, op by
  op (``jax.disable_jit``), whose rounding is the port's nearer twin.

Run from the repository's root (100 km: ~1 min; ``--eager`` adds ~3
min; 20 km Blatter: ~2 min):

    JAX_PLATFORMS=cpu python scripts/greenland_solvers_vs_jax.py --km 100
    JAX_PLATFORMS=cpu python scripts/greenland_solvers_vs_jax.py --km 20 \\
        --solvers blatter
"""

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
import pism_tpu.model.blatter as j_blatter  # noqa: E402
import pism_tpu.model.ssafem as j_ssafem  # noqa: E402
import pism_tpu_torch.model.blatter as t_blatter  # noqa: E402
import pism_tpu_torch.model.ssafem as t_ssafem  # noqa: E402
from fem_krylov_rounding import counting  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402

SPY = 3.15569259747e7
#: chip_smoke.py phase 17f's Newton cap
BLATTER_NEWTON = 8


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def models(km, extra):
    jm, js, _ = bench.hybrid_greenland_model("float64", km=km,
                                             extra_cfg=extra)
    tm, ts, grid = setups.hybrid_greenland_model("float64", km=km,
                                                 device="cpu",
                                                 extra_cfg=extra)
    jtau = jm.yield_stress.compute(js)
    ttau = tm.yield_stress.compute(ts, t=0.0)
    print(f"  {grid.My}x{grid.Mx}x{grid.Mz}; tau_c {rel(jtau, ttau):.1e} of "
          "max apart", flush=True)
    return (jm, js, jtau), (tm, ts, ttau), grid


def report(label, seq, it, F2, tol2, u, v, ref=None):
    line = (f"  {label}: Newton {it}, BiCGStab {sum(seq)} {seq}, "
            f"|F|^2/tol {F2 / tol2:.6e}, max|u| "
            f"{np.abs(u).max() * SPY:.6e} m/a")
    if ref is not None:
        sc = max(np.abs(ref[0]).max(), 1e-300)
        line += (f", u {np.abs(u - ref[0]).max() / sc:.3e} and v "
                 f"{np.abs(v - ref[1]).max() / sc:.3e} of max|u| from the "
                 "JAX compiled solve's")
    print(line, flush=True)


def blatter(km, newton):
    print(f"Blatter at {km:g} km, Newton cap {newton}:")
    (jm, js, jtau), (tm, ts, ttau), grid = models(
        km, {"stress_balance.model": "blatter",
             "stress_balance.blatter.newton_max_iterations": newton})
    seq_j, seq_t = [], []
    undo = counting(j_blatter, seq_j)
    try:
        t0 = time.perf_counter()
        uj, vj, ij = jm.blatter.solve(js, jtau, diagnostics=True)
        jax.block_until_ready(uj)
        jax.effects_barrier()
        tj = time.perf_counter() - t0
    finally:
        undo()
    undo = counting(t_blatter, seq_t)
    try:
        t0 = time.perf_counter()
        ut, vt, it = tm.blatter.solve(ts, ttau, diagnostics=True)
        tt = time.perf_counter() - t0
    finally:
        undo()
    rng = np.random.default_rng(0)
    shape = (grid.My, grid.Mx, grid.Mz)
    for scale in (0.0, 100.0):
        uv = tuple(rng.normal(size=shape) * scale / SPY for _ in range(2))
        d = tuple(rng.normal(size=shape) / SPY for _ in range(2))
        Fj = ij["residual_fn"](tuple(jnp.asarray(a) for a in uv))
        Ft = it["residual_fn"](tuple(torch.as_tensor(a) for a in uv))
        _, Jj = jax.jvp(ij["residual_fn"], (tuple(jnp.asarray(a)
                                                  for a in uv),),
                        (tuple(jnp.asarray(a) for a in d),))
        Jt = it["jacobian_fn"](tuple(torch.as_tensor(a) for a in uv),
                               tuple(torch.as_tensor(a) for a in d))
        print(f"  at |u| ~ {scale:g} m/a: residual "
              f"{max(rel(a, b) for a, b in zip(Fj, Ft)):.1e}, Newton "
              f"matvec {max(rel(a, b) for a, b in zip(Jj, Jt)):.1e} of max "
              "apart")
    uj, vj = np.asarray(uj), np.asarray(vj)
    report(f"JAX compiled ({tj:.1f} s)", seq_j, int(ij["newton_iters"]),
           float(ij["F2_final"]), float(ij["tol2"]), uj, vj)
    report(f"port ({tt:.1f} s)", seq_t, it["newton_iters"],
           float(it["F2_final"]), float(it["tol2"]), ut.numpy(), vt.numpy(),
           (uj, vj))


def ssafem(km, eager):
    print(f"SSAFEM at {km:g} km:")
    (jm, js, jtau), (tm, ts, ttau), grid = models(
        km, {"stress_balance.ssa.method": "fem"})
    Pj = jm.ssa.build_problem(js, jtau)
    Pt = tm.ssa.build_problem(ts, ttau)
    rng = np.random.default_rng(0)
    for scale in (0.0, 100.0):
        u0, v0, du, dv = (rng.normal(size=grid.shape2) * s / SPY
                          for s in (scale, scale, 1.0, 1.0))
        uvj = Pj["free"]((jnp.asarray(u0), jnp.asarray(v0)))
        uvt = Pt["free"]((torch.as_tensor(u0), torch.as_tensor(v0)))
        Fr = max(rel(a, b) for a, b in zip(Pj["residual"](uvj),
                                          Pt["residual"](uvt)))
        _, Jj = jax.jvp(Pj["residual"], (uvj,),
                        (Pj["free"]((jnp.asarray(du), jnp.asarray(dv))),))
        u, v = Pt["full"](uvt)
        Jt = Pt["linearized"](u, v, Pt["beta_fn"](u, v))(
            *Pt["free"]((torch.as_tensor(du), torch.as_tensor(dv))))
        print(f"  at |u| ~ {scale:g} m/a: residual {Fr:.1e}, Newton matvec "
              f"{max(rel(a, b) for a, b in zip(Jj, Jt)):.1e} of max apart")
    runs = [("JAX compiled", False)] + ([("JAX op by op", True)]
                                        if eager else [])
    ref = None
    for label, op_by_op in runs:
        seq = []
        undo = counting(j_ssafem, seq)
        try:
            t0 = time.perf_counter()
            if op_by_op:
                with jax.disable_jit():
                    uj, vj, ij = jm.ssa.solve(js, jtau, diagnostics=True)
            else:
                uj, vj, ij = jm.ssa.solve(js, jtau, diagnostics=True)
            jax.block_until_ready(uj)
            jax.effects_barrier()
            wall = time.perf_counter() - t0
        finally:
            undo()
        uj, vj = np.asarray(uj), np.asarray(vj)
        report(f"{label} ({wall:.1f} s)", seq, int(ij["iterations"]),
               float(ij["residual2"]), float(ij["tol2"]), uj, vj, ref)
        ref = ref or (uj, vj)
    seq = []
    undo = counting(t_ssafem, seq)
    try:
        t0 = time.perf_counter()
        ut, vt, it = tm.ssa.solve(ts, ttau, diagnostics=True)
        wall = time.perf_counter() - t0
    finally:
        undo()
    report(f"port ({wall:.1f} s)", seq, it["newton_iters"],
           float(it["residual2"]), float(it["tol2"]), ut.numpy(), vt.numpy(),
           ref)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--km", type=float, default=100.0)
    p.add_argument("--solvers", default="blatter,fem")
    p.add_argument("--newton", type=int, default=BLATTER_NEWTON,
                   help="the Blatter solve's Newton cap")
    p.add_argument("--eager", action="store_true",
                   help="also run the JAX SSAFEM solve op by op")
    p.add_argument("--threads", type=int, default=4)
    a = p.parse_args()
    torch.set_num_threads(a.threads)
    for s in a.solvers.split(","):
        blatter(a.km, a.newton) if s == "blatter" else ssafem(a.km, a.eager)


if __name__ == "__main__":
    main()
