"""The flow laws, the eta-transform surface gradient, the Goldsby-Kohlstedt
SIA and the upstream vertical velocity: ``pism_tpu_torch`` against
``pism_tpu`` on the CPU in float64, the same numpy inputs (seeded) to
both.

- Every law of the factory (``isothermal_glen``, ``pb``, ``pb_cold``,
  ``pb_warm``, ``hooke``, ``gpbld``, and ``gk`` through
  ``flow_law.grain_aware_GK``): ``softness``, ``hardness``, ``flow`` on a
  grid of E (cold to temperate) and p, and ``averaged_hardness`` on
  columns, within 1e-12 relative; the laws' refusals (Goldsby-Kohlstedt
  has no softness, hardness or SSA; an unknown name) raise as in JAX.
- ``surface_gradient_eta``, the SIA diffusivity with the eta method and
  with the Goldsby-Kohlstedt law (``_flow_integral``), and ``sia_3d``
  with ``w_approximation = "upstream"`` (Paterson-Budd and
  Goldsby-Kohlstedt), within 1e-12 of each field's max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.ops import sia as j_sia  # noqa: E402
from pism_tpu.ops import sia3d as j_sia3d  # noqa: E402
from pism_tpu.ops.stencils import Shifter as JShifter  # noqa: E402
from pism_tpu.physics import rheology as j_rh  # noqa: E402
from pism_tpu.state import new_geometry as j_new_geometry  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch.ops import sia as t_sia  # noqa: E402
from pism_tpu_torch.ops import sia3d as t_sia3d  # noqa: E402
from pism_tpu_torch.ops.stencils import Shifter  # noqa: E402
from pism_tpu_torch.physics import rheology as t_rh  # noqa: E402
from pism_tpu_torch.state import new_geometry  # noqa: E402

LAWS = ("isothermal_glen", "pb", "pb_cold", "pb_warm", "hooke", "gpbld")
GRID = dict(Mx=25, My=21, Lx=300e3, Ly=250e3, Mz=11, Lz=3500.0)


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _laws(over):
    return (j_rh.flow_law_from_config(JConfig(over["cfg"]), over["which"]),
            t_rh.flow_law_from_config(pt.Config(over["cfg"]), over["which"]))


def _E_p(law):
    """A grid of enthalpies from 230 K cold ice to 2% water and of
    pressures from the surface to 3 km of ice, as numpy arrays."""
    EC = law.EC
    p = np.linspace(0.0, 910.0 * 9.81 * 3000.0, 7)[:, None]
    E_cold = np.asarray(EC.enthalpy(jnp.asarray(230.0), 0.0, jnp.asarray(p)))
    E_s = np.asarray(EC.enthalpy_cts(jnp.asarray(p)))
    E = E_cold + (E_s + 0.02 * 3.34e5 - E_cold) \
        * np.linspace(0.0, 1.0, 23)[None, :]
    return E, np.broadcast_to(p, E.shape).copy()


@pytest.mark.parametrize("name", LAWS)
@pytest.mark.parametrize("which", ["sia", "ssa"])
def test_law_methods_match(name, which):
    cfg = {f"stress_balance.{which}.flow_law": name,
           "flow_law.Hooke.A": 4.0e-9, "flow_law.Paterson_Budd.Q_cold": 6.1e4}
    jl, tl = _laws({"cfg": cfg, "which": which})
    assert type(tl).__name__ == type(jl).__name__
    E, p = _E_p(jl)
    sigma = np.logspace(3.0, 5.5, E.size).reshape(E.shape)
    T = torch.as_tensor
    for meth, args in (("softness", (E, p)), ("hardness", (E, p)),
                       ("flow", (sigma, E, p))):
        want = getattr(jl, meth)(*(jnp.asarray(a) for a in args))
        got = getattr(tl, meth)(*(T(a) for a in args))
        assert got.dtype == torch.float64
        assert _rel(got, want) <= 1e-12, meth
    # averaged_hardness on columns of several thicknesses
    grid = JGrid(**GRID)
    z = np.asarray(grid.z)
    H = np.array([0.0, 500.0, 1800.0, 3400.0])
    E3 = np.repeat(E[3:4, :11], 4, axis=0)
    want = jl.averaged_hardness(jnp.asarray(H), jnp.asarray(E3),
                                jnp.asarray(z))
    got = tl.averaged_hardness(T(H), T(E3), T(z))
    assert _rel(got, want) <= 1e-12


def test_paterson_budd_cold_temp_from_softness():
    cfg = {"stress_balance.sia.flow_law": "pb_cold"}
    jl, tl = _laws({"cfg": cfg, "which": "sia"})
    A = np.logspace(-26.0, -23.0, 9)
    assert _rel(tl.tempFromSoftness(torch.as_tensor(A)),
                jl.tempFromSoftness(jnp.asarray(A))) <= 1e-12


def test_goldsby_kohlstedt_law():
    """grain_aware_GK builds the GK law for the SIA (the grain size from
    flow_law.gk.grain_size when set); its flow matches on the grid; it has
    no softness, hardness or SSA, as in JAX."""
    cfg = {"flow_law.grain_aware_GK": True, "flow_law.gk.grain_size": 2e-3}
    jl, tl = _laws({"cfg": cfg, "which": "sia"})
    assert isinstance(tl, t_rh.GoldsbyKohlstedt) and tl.generalized
    assert tl.grain_size == jl.grain_size == 2e-3
    E, p = _E_p(jl)
    sigma = np.logspace(2.0, 5.5, E.size).reshape(E.shape)
    got = tl.flow(torch.as_tensor(sigma), torch.as_tensor(E),
                  torch.as_tensor(p))
    want = jl.flow(jnp.asarray(sigma), jnp.asarray(E), jnp.asarray(p))
    assert _rel(got, want) <= 1e-12
    x = torch.ones(3, dtype=torch.float64)
    for meth, args in (("softness", (x, x)), ("hardness", (x, x)),
                       ("averaged_hardness", (x, x[None], x))):
        with pytest.raises(RuntimeError):
            getattr(tl, meth)(*args)
    for pkg in (JConfig, pt.Config):
        mod = j_rh if pkg is JConfig else t_rh
        with pytest.raises(ValueError):
            mod.flow_law_from_config(pkg({"stress_balance.ssa.flow_law":
                                          "gk"}), "ssa")
        with pytest.raises(ValueError):
            mod.flow_law_from_config(pkg({"stress_balance.sia.flow_law":
                                          "nonesuch"}), "sia")


def _dome(seed=23):
    """A rough dome on a bumpy bed with an ice-free margin, and a
    polythermal enthalpy field (numpy, float64)."""
    grid = JGrid(**GRID)
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.asarray(grid.x), np.asarray(grid.y))
    r2 = (X / 260e3) ** 2 + (Y / 220e3) ** 2
    bed = 200.0 * np.sin(X / 60e3) * np.cos(Y / 45e3) \
        + rng.uniform(-20.0, 20.0, X.shape)
    H = 3000.0 * np.maximum(1.0 - r2, 0.0) ** 0.5
    H = H + rng.uniform(0.0, 30.0, H.shape) * (H > 0)
    EC = j_rh.flow_law_from_config(JConfig({}), "sia").EC
    z = np.asarray(grid.z)
    depth = np.maximum(H[..., None] - z, 0.0)
    p = np.asarray(EC.pressure(jnp.asarray(depth)))
    T = 250.0 + 20.0 * depth / 3000.0 + rng.uniform(0.0, 2.0, depth.shape)
    T = np.minimum(T, np.asarray(EC.melting_temperature(jnp.asarray(p))))
    E = np.array(EC.enthalpy(jnp.asarray(T), 0.0, jnp.asarray(p)))
    u_b = 1e-6 * rng.standard_normal(H.shape)
    v_b = 1e-6 * rng.standard_normal(H.shape)
    return grid, H, bed, E, u_b, v_b


def _both(H, bed, E):
    grid = JGrid(**GRID)
    jg = j_new_geometry(jnp.asarray(H), jnp.asarray(bed))
    tg = new_geometry(torch.as_tensor(H), torch.as_tensor(bed))
    return grid, jg, tg, jnp.asarray(E), torch.as_tensor(E)


def test_surface_gradient_eta_matches():
    grid, H, bed, E, _, _ = _dome()
    _, jg, tg, _, _ = _both(H, bed, E)
    want = j_sia.surface_gradient_eta(jg.ice_thickness, jg.bed_elevation,
                                      grid, JShifter(grid), 3.0)
    got = t_sia.surface_gradient(tg, grid, Shifter(grid), "eta", 3.0)
    for a, b, name in zip(got, want, want._fields):
        assert _rel(a, b) <= 1e-12, name


@pytest.mark.parametrize("law,method", [("pb", "eta"), ("gk", "mahaffy"),
                                        ("gk", "eta")])
def test_diffusivity_eta_and_goldsby_kohlstedt(law, method):
    cfg = {"stress_balance.sia.flow_law": law} if law != "gk" \
        else {"flow_law.grain_aware_GK": True}
    jl, tl = _laws({"cfg": cfg, "which": "sia"})
    grid, H, bed, E, _, _ = _dome()
    _, jg, tg, jE, tE = _both(H, bed, E)
    want = j_sia.diffusivity(jl, jg, jE, grid, JShifter(grid),
                             enhancement=2.0, gradient_method=method,
                             pallas=False)
    got = t_sia.diffusivity(tl, tg, tE, grid, Shifter(grid), enhancement=2.0,
                            gradient_method=method)
    for a, b, name in zip(got, want, want._fields):
        assert _rel(a, b) <= 1e-12, name
    assert float(got.max_D) > 0.0


@pytest.mark.parametrize("law", ["pb", "gk"])
@pytest.mark.parametrize("w_approx", ["centered", "upstream"])
def test_sia_3d_upstream_matches(law, w_approx):
    cfg = {"stress_balance.sia.flow_law": law} if law != "gk" \
        else {"flow_law.grain_aware_GK": True}
    jl, tl = _laws({"cfg": cfg, "which": "sia"})
    grid, H, bed, E, ub, vb = _dome()
    _, jg, tg, jE, tE = _both(H, bed, E)
    bmelt = np.full(H.shape, 3e-10)
    want = j_sia3d.sia_3d(jl, jg, jE, grid, JShifter(grid), enhancement=1.5,
                          u_base=jnp.asarray(ub), v_base=jnp.asarray(vb),
                          basal_melt_rate=jnp.asarray(bmelt),
                          w_approximation=w_approx)
    got = t_sia3d.sia_3d(tl, tg, tE, grid, Shifter(grid), enhancement=1.5,
                         u_base=torch.as_tensor(ub), v_base=torch.as_tensor(vb),
                         basal_melt_rate=torch.as_tensor(bmelt),
                         w_approximation=w_approx)
    for a, b, name in zip(got, want, want._fields):
        assert _rel(a, b) <= 1e-12, name
    if w_approx == "upstream":
        # the upstream divergence is not the centered one
        cen = t_sia3d.sia_3d(tl, tg, tE, grid, Shifter(grid),
                             enhancement=1.5, u_base=torch.as_tensor(ub),
                             v_base=torch.as_tensor(vb),
                             basal_melt_rate=torch.as_tensor(bmelt))
        assert _rel(got.w, cen.w) > 1e-6


@pytest.mark.parametrize("name,eligible", [
    ("pb", True), ("gpbld", True), ("pb_cold", False), ("pb_warm", False),
    ("hooke", False), ("gk", False)])
def test_kernel_routes_take_only_their_laws(name, eligible):
    """``auto`` takes K3 only for the laws whose softness it computes (the
    Paterson-Budd and GPBLD laws; the cold, warm and Hooke laws carry the
    Paterson-Budd constants too), and K4 never for a law with no Glen
    softness; a fake card tensor stands for the field."""
    import types
    cfg = {"stress_balance.sia.flow_law": name} if name != "gk" \
        else {"flow_law.grain_aware_GK": True}
    _, law = _laws({"cfg": cfg, "which": "sia"})
    H = types.SimpleNamespace(device=torch.device("cuda"),
                              dtype=torch.float32)
    grid = pt.Grid(**GRID)
    assert t_sia._kernel_eligible(law, torch.ones(1), grid, H, "mahaffy",
                                  None, None, 1.0) is eligible
    assert t_sia._iso_kernel_eligible(grid, H, "mahaffy", None, None, 1.0,
                                      law) is (name != "gk")
