"""How SSAFEM's Krylov totals move with the rounding, on the CPU: test I
at 11 x 31 (``tests/test_ssafem.py``'s problem, float64) solved by

- the JAX package as it runs (its loops compiled by XLA),
- the JAX package op by op (``jax.disable_jit``), capped at 2 Newton
  sweeps (an uncapped op-by-op solve takes ~10 s a sweep),
- the port, uncapped and capped alike,
- the port with every Krylov matvec perturbed by a seeded relative 1e-15.

Prints the Newton sweeps, the BiCGStab iterations of each solve and their
totals, and the velocities' distance to the JAX solve's. Run from the
repository's root (~3 min):

    JAX_PLATFORMS=cpu python scripts/fem_krylov_rounding.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import pism_tpu.model.ssafem as j_ssafem  # noqa: E402
import pism_tpu_torch.model.ssafem as t_ssafem  # noqa: E402
from test_torch_fem import _test_I  # noqa: E402


def counting(module, seq, perturb=None):
    """Patch ``module.ssa_ops.bicgstab_solve`` to record each solve's
    iterations (and to perturb the matvec); returns the restore call."""
    orig = module.ssa_ops.bicgstab_solve

    def solve(matvec, *a, **k):
        if perturb is not None:
            def matvec_p(x, mv=matvec):
                return tuple(y * (1 + perturb * torch.randn(
                    y.shape, generator=gen, dtype=y.dtype)) for y in mv(x))
            matvec = matvec_p
        out = orig(matvec, *a, **k)
        if isinstance(out[1], int):
            seq.append(out[1])
        else:
            jax.debug.callback(lambda n: seq.append(int(n)), out[1])
        return out

    gen = torch.Generator().manual_seed(0)
    module.ssa_ops.bicgstab_solve = solve
    return lambda: setattr(module.ssa_ops, "bicgstab_solve", orig)


def main():
    runs = {}
    for label, cap in (("uncapped", None), ("2 sweeps", 2)):
        over = None if cap is None else {
            "stress_balance.ssa.fd.newton_max_iterations": cap}
        ti, gj, gt, kj, kt, sj, st, tj, tt = _test_I(31, over=over)
        cases = [("JAX compiled", None)] if cap is None \
            else [("JAX op by op", None)]
        cases += [("port", None)]
        if cap is None:
            cases += [("port, matvec x (1 + 1e-15 N(0,1))", 1e-15)]
        for name, perturb in cases:
            seq = []
            if name.startswith("JAX"):
                undo = counting(j_ssafem, seq)
                try:
                    if name == "JAX op by op":
                        with jax.disable_jit():
                            u, v, info = j_ssafem.SSAFEM(**kj).solve(
                                sj, tj, diagnostics=True)
                    else:
                        u, v, info = j_ssafem.SSAFEM(**kj).solve(
                            sj, tj, diagnostics=True)
                finally:
                    undo()
                sweeps, u = int(info["iterations"]), np.asarray(u)
            else:
                undo = counting(t_ssafem, seq, perturb)
                try:
                    u, v, info = t_ssafem.SSAFEM(**kt).solve(
                        st, tt, diagnostics=True)
                finally:
                    undo()
                sweeps, u = info["newton_iters"], u.numpy()
            runs[(label, name)] = u
            ref = runs.get((label, "JAX compiled"),
                           runs.get((label, "JAX op by op")))
            dist = np.abs(u - ref).max() / np.abs(ref).max()
            print(f"test I 11x31 {label}, {name}: {sweeps} Newton sweeps, "
                  f"{sum(seq)} Krylov iterations in {len(seq)} solves "
                  f"(first ten {seq[:10]}); u {dist:.2e} of max from JAX's")


if __name__ == "__main__":
    main()
