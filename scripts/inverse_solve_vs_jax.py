"""The SSA inversion's forward solve (the full-convergence solve of
``inverse_solver``: no velocity-change stop, ``newton_rtol`` 1e-8) on the
synthetic-Greenland initial state (``setups.hybrid_greenland_model``,
float64, path A's config) at its Mohr-Coulomb yield stress, through both
packages on the CPU: Newton sweeps, BiCGStab iterations, |F|^2 / tol and
the velocities' distance. It tells whether that state's solve reaches
``newton_rtol`` in both packages (``chip_smoke.py`` phase 18b inverts
tau_c on it at 20 km on the card). Also, with ``--gradient``, one
misfit gradient of each package at 0.5 tau_c against observations from
the solve at tau_c, and their distance. ``--stream``: the same solves of
both packages on ``tests/test_inverse.py``'s plastic-till stream (24x8)
at its true till and at tau_c = 1e4, with the default (Picard) drag
Jacobian. ``--sliding``: the port's 100 km chain after 0.5 a (float32,
path A): the yield stress and the driving stress over the grounded ice,
and the sliding speeds of full-convergence solves at fractions of the
yield stress (the exact drag Jacobian). ``--clamp``: the port's misfit
gradient on the 100 km initial state at 0.8 of 0.03 of its yield stress
(``chip_smoke.py`` phase 18c's problem) against a central finite
difference, with the SSA's speed clamp (50 km/a, which a few floating
cells exceed) and without it.

Run from the repository's root (100 km: ~1 min; 20 km: several min;
--stream, --sliding, --clamp ~1 min each):

    JAX_PLATFORMS=cpu python scripts/inverse_solve_vs_jax.py --km 100 --gradient
    JAX_PLATFORMS=cpu python scripts/inverse_solve_vs_jax.py --km 20
    JAX_PLATFORMS=cpu python scripts/inverse_solve_vs_jax.py --stream
    JAX_PLATFORMS=cpu python scripts/inverse_solve_vs_jax.py --sliding
    JAX_PLATFORMS=cpu python scripts/inverse_solve_vs_jax.py --clamp
"""

import argparse
import dataclasses
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
from pism_tpu.config.config import Config as JConfig  # noqa: E402
from pism_tpu.inverse import ssa_inverse as j_inv  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch.inverse import ssa_inverse as t_inv  # noqa: E402

PATH_A = {"stress_balance.ssa.fd.line_pcr_impl": "pallas_sublane"}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def j_tight(ssa):
    """The JAX solver as its ``make_differentiable_solve`` clones it."""
    cfg = JConfig.from_json(ssa.config.to_json())
    cfg.update({"stress_balance.ssa.fd.velocity_change_rtol": 0.0,
                "stress_balance.ssa.fd.newton_rtol": min(
                    cfg.get_number("stress_balance.ssa.fd.newton_rtol"),
                    1e-8)})
    return dataclasses.replace(ssa, config=cfg)


def _print_solve(name, solve):
    t0 = time.time()
    u, v, info = solve()
    F2, tol2 = float(info["F2_final"]), float(info["tol2"])
    print(f"  {name}: Newton {int(info['newton_iters'])}, BiCGStab "
          f"{int(info['krylov_iters'])}, |F|^2/tol {F2 / tol2:.3e} "
          f"({'reached' if F2 <= tol2 else 'NOT reached'}), "
          f"{time.time() - t0:.1f} s", flush=True)
    return np.asarray(u), np.asarray(v)


def stream():
    """The stream of tests/test_inverse.py through both packages."""
    from pism_tpu import Config as JC, Grid as JG
    from pism_tpu.model.ssa import SSAFD as JS
    from pism_tpu.physics.rheology import IsothermalGlen as JL
    from pism_tpu.state import ModelState as JM, new_geometry as jg
    from pism_tpu_torch import Config as TC, Grid as TG
    from pism_tpu_torch.model.ssa import SSAFD as TS
    from pism_tpu_torch.physics.rheology import IsothermalGlen as TL
    from pism_tpu_torch.state import ModelState as TM, new_geometry as tg

    My, Mx = 24, 8
    f = 910.0 * 9.81 * 2000.0 * 0.001
    bc = np.zeros((My, Mx), bool)
    bc[0, :] = bc[-1, :] = True
    z = np.zeros((My, Mx))
    kw = dict(Mx=Mx, My=My, Lx=8e3, Ly=48e3, periodicity="x")
    jgrid, A = JG(**kw), (3.7e8) ** -3.0
    y = jgrid.y
    tau = np.tile((0.6 * f + 1.2 * f * (np.abs(y) / 40e3) ** 4)[:, None],
                  (1, Mx))
    a = jnp.asarray
    jssa = j_tight(JS(grid=jgrid, config=JC(), flow_law=JL(A=A),
                      bc_mask=a(bc), bc_u=a(z), bc_v=a(z),
                      taud_x=a(z + f), taud_y=a(z)))
    js = JM(geometry=jg(a(z + 2000.0), a(z)))
    t = torch.tensor
    tssa = t_inv.inverse_solver(TS(
        grid=TG(**kw), config=TC(), flow_law=TL(A=A), bc_mask=t(bc),
        bc_u=t(z), bc_v=t(z), taud_x=t(z + f), taud_y=t(z)))
    ts = TM(geometry=tg(t(z + 2000.0), t(z)))
    for label, tc in (("true till", tau), ("tau_c = 1e4", z + 1e4)):
        print(f"stream 24x8, {label}:")
        _print_solve("jax", lambda: jssa.solve(js, a(tc), diagnostics=True))
        _print_solve("port", lambda: tssa.solve(ts, t(tc), diagnostics=True))


def sliding():
    """The port's 100 km chain after 0.5 a: yield stress against driving
    stress, and sliding speeds at fractions of the yield stress."""
    from pism_tpu_torch import state as S
    from pism_tpu_torch.state import map_tensors
    SPY = 3.15569259747e7
    exact = dict(PATH_A, **{"stress_balance.ssa.fd.drag_jacobian": "exact"})
    m, s, _ = setups.hybrid_greenland_model("float32", 100.0, device="cpu",
                                            extra_cfg=PATH_A)
    s, t, _ = m.step_once(s, 0.0, 0.5 * SPY)
    m, _, _ = setups.hybrid_greenland_model("float64", 100.0, device="cpu",
                                            extra_cfg=exact)
    s = map_tensors(s, lambda x: x.double() if x.is_floating_point() else x)
    tau = m.yield_stress.compute(s, t=t)
    gi = S.grounded_ice(s.geometry.cell_type)
    P = m.ssa.build_problem(s, tau)
    taud = torch.sqrt(P["bx"] ** 2 + P["by"] ** 2)
    q = [0, 0.1, 0.5, 0.9, 1]
    print(f"100 km after 0.5 a, over the grounded ice: yield stress [Pa] "
          f"quantiles {q}: {np.quantile(tau[gi].numpy(), q)}; driving "
          f"stress {np.quantile(taud[gi].numpy(), q)}")
    for f in (1.0, 0.1, 0.03, 0.01):
        u, v = _print_solve(f"{f} of it", lambda: t_inv.inverse_solver(
            m.ssa).solve(s, f * tau, diagnostics=True))
        sp = np.hypot(u, v)[gi.numpy()] * SPY
        print(f"    speed over the grounded ice [m/a], quantiles "
              f"[0.5, 0.9, 0.99, 1]: {np.quantile(sp, [0.5, 0.9, 0.99, 1])}")


def clamp():
    """The gradient against a finite difference with and without the
    speed clamp (phase 18c's 100 km problem, on the CPU)."""
    from pism_tpu_torch import state as S
    SPY = 3.15569259747e7
    for max_speed in (50e3, 1e7):
        cfg = dict(PATH_A, **{"stress_balance.ssa.fd.drag_jacobian": "exact",
                              "stress_balance.ssa.fd.max_speed": max_speed})
        m, s, grid = setups.hybrid_greenland_model("float64", 100.0,
                                                   device="cpu",
                                                   extra_cfg=cfg)
        tau = 0.03 * m.yield_stress.compute(s, t=0.0)
        u, v = t_inv.inverse_solver(m.ssa).solve(s, tau)
        fast = int((torch.hypot(u, v) * SPY >= 50e3 * (1 - 1e-12)).sum())
        inv = t_inv.TaucInversion(
            ssa=m.ssa, state=s, u_obs=u, v_obs=v,
            obs_mask=S.grounded_ice(s.geometry.cell_type), reg_weight=0.0)
        tc = 0.8 * tau
        _, g = t_inv.value_and_grad(inv.misfit, tc)
        X, Y = np.meshgrid(grid.x, grid.y)
        d = tc * torch.tensor(np.sin(2 * np.pi * X / grid.Lx)
                              * np.cos(np.pi * Y / grid.Ly))
        with torch.no_grad():
            uu, vv = t_inv.inverse_solver(m.ssa).solve(s, tc)
            near = dataclasses.replace(inv, state=s.replace(u_ssa=uu,
                                                            v_ssa=vv))
            fd = (float(near.misfit(tc + 1e-3 * d))
                  - float(near.misfit(tc - 1e-3 * d))) / 2e-3
        ad = float(torch.sum(g * d))
        print(f"max_speed {max_speed / 1e3:g} km/a: {fast} cells at or above "
              f"50 km/a; adjoint {ad:.9e}, finite difference {fd:.9e}, rel "
              f"diff {abs(ad - fd) / abs(fd):.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=100.0)
    ap.add_argument("--gradient", action="store_true")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--sliding", action="store_true")
    ap.add_argument("--clamp", action="store_true")
    args = ap.parse_args()
    if args.clamp:
        return clamp()
    if args.stream:
        return stream()
    if args.sliding:
        return sliding()
    jm, js, _ = bench.hybrid_greenland_model("float64", km=args.km,
                                             extra_cfg=PATH_A)
    tm, ts, grid = setups.hybrid_greenland_model(
        "float64", km=args.km, device="cpu", extra_cfg=PATH_A)
    jtau = jm.yield_stress.compute(js)
    ttau = tm.yield_stress.compute(ts, t=0.0)
    print(f"{grid.My}x{grid.Mx}; tau_c {rel(jtau, ttau):.1e} of max apart",
          flush=True)
    out = {}
    for name, solve in (
            ("jax", lambda: j_tight(jm.ssa).solve(js, jtau,
                                                  diagnostics=True)),
            ("port", lambda: t_inv.inverse_solver(tm.ssa).solve(
                ts, ttau, diagnostics=True))):
        t0 = time.time()
        u, v, info = solve()
        wall = time.time() - t0
        F2, tol2 = float(info["F2_final"]), float(info["tol2"])
        out[name] = (np.asarray(u), np.asarray(v))
        print(f"  {name}: Newton {int(info['newton_iters'])}, BiCGStab "
              f"{int(info['krylov_iters'])}, |F|^2/tol {F2 / tol2:.3e} "
              f"({'reached' if F2 <= tol2 else 'NOT reached'}), "
              f"{wall:.1f} s", flush=True)
    print(f"  u {rel(out['jax'][0], out['port'][0]):.3e}, v "
          f"{rel(out['jax'][1], out['port'][1]):.3e} of max apart")
    if not args.gradient:
        return
    u_obs, v_obs = out["jax"]
    j = j_inv.TaucInversion(ssa=jm.ssa, state=js, u_obs=jnp.asarray(u_obs),
                            v_obs=jnp.asarray(v_obs), reg_weight=0.0)
    t0 = time.time()
    Jj, gj = jax.jit(jax.value_and_grad(j.misfit))(0.5 * jtau)
    print(f"  jax: J {float(Jj):.10e}, {time.time() - t0:.1f} s", flush=True)
    t = t_inv.TaucInversion(ssa=tm.ssa, state=ts,
                            u_obs=torch.tensor(u_obs),
                            v_obs=torch.tensor(v_obs), reg_weight=0.0)
    t0 = time.time()
    Jt, gt = t_inv.value_and_grad(t.misfit, 0.5 * ttau)
    print(f"  port: J {float(Jt):.10e}, {time.time() - t0:.1f} s; counts "
          f"{t_inv.COUNTS}")
    gj = np.asarray(gj)
    print(f"  gradient: {np.abs(gt.numpy() - gj).max() / np.abs(gj).max():.3e}"
          " of its max-norm apart")


if __name__ == "__main__":
    main()
