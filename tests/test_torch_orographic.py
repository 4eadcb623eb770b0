"""Orographic precipitation (``coupler/orographic.py``), pism_tpu_torch
against pism_tpu on the CPU: the Smith-Barstad field from the same numpy
surface within 1e-11 of max|P| in float64 (both FFTs on the CPU; cuFFT
rounds differently, so the card is held to the CPU in ``chip_smoke.py``),
within the float32 field's rounding in float32 (complex64 spectra in both
packages), with padding, rotation and an untruncated field; the parameters
from the config; the modifier through the factory; the cached transfer
function equal to the bit to the per-call form; and the JAX package's own
rain-shadow case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig
from pism_tpu import Grid as JGrid
from pism_tpu.coupler import orographic as j_oro
from pism_tpu.state import new_geometry as j_geom
from pism_tpu_torch import Config, Grid, new_geometry
from pism_tpu_torch.coupler import orographic as t_oro

torch.set_num_threads(2)

SPY = 3.15569259747e7
GRID = dict(Mx=31, My=25, Lx=300e3, Ly=240e3)


def _surface(seed=4):
    g = Grid(**GRID)
    X, Y = np.meshgrid(g.x, g.y)
    rng = np.random.default_rng(seed)
    s = 1800.0 * np.exp(-((X / 90e3) ** 2 + (Y / 70e3) ** 2)) \
        + rng.uniform(0.0, 150.0, g.shape2)
    return s


CASES = {
    "default": {},
    "diagonal_rotated": {"wind_u": 7.0, "wind_v": -6.0, "f_cor": 1.3e-4},
    "padded_untruncated": {"pad_factor": 2, "truncate": False,
                           "scale_factor": 1.7},
    "slow_moist": {"wind_u": -3.0, "wind_v": 2.0, "Nm": 0.01, "Hw": 3000.0,
                   "tau_c": 1500.0, "tau_f": 800.0},
}


@pytest.mark.parametrize("case", list(CASES))
def test_field_matches_float64(case):
    s = _surface()
    kw = dict(CASES[case], background_precip=0.4 / SPY)
    jm = j_oro.OrographicPrecipitation(grid=JGrid(**GRID), **kw)
    tm = t_oro.OrographicPrecipitation(grid=Grid(**GRID), **kw)
    want = np.asarray(jm.precipitation_field(jnp.asarray(s)))
    got = tm.precipitation_field(torch.tensor(s)).numpy()
    assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()
    # the second call, on the cached transfer function, the same
    again = tm.precipitation_field(torch.tensor(s)).numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("case", ["default", "padded_untruncated"])
def test_field_matches_float32(case):
    s = _surface().astype(np.float32)
    kw = dict(CASES[case], background_precip=0.4 / SPY)
    jm = j_oro.OrographicPrecipitation(grid=JGrid(**GRID), **kw)
    tm = t_oro.OrographicPrecipitation(grid=Grid(**GRID), **kw)
    want = np.asarray(jm.precipitation_field(jnp.asarray(s)))
    got = tm.precipitation_field(torch.tensor(s))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tm._transfer_function(torch.float32, torch.device("cpu"))[1].dtype \
        == torch.complex64
    # a sum over 775 modes in float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_cached_transfer_equals_per_call_form():
    """The transfer function built once equals, to the bit, the JAX
    package's per-call expression written out in torch."""
    s = torch.tensor(_surface())
    tm = t_oro.OrographicPrecipitation(grid=Grid(**GRID), wind_v=3.0,
                                       f_cor=1e-4)
    got = tm.precipitation_field(s)
    g = tm.grid
    h = s - torch.mean(s)
    kx, ky = torch.tensor(tm._KX), torch.tensor(tm._KY)
    sigma = tm.wind_u * kx + tm.wind_v * ky
    k2 = kx ** 2 + ky ** 2
    sr = torch.where(torch.abs(sigma) < 1e-10, torch.sign(sigma) * 1e-10
                     + (sigma == 0).double() * 1e-10, sigma)
    ds = sr ** 2 - tm.f_cor ** 2
    ds = torch.where(torch.abs(ds) < 1e-18, torch.sign(ds) * 1e-18
                     + (ds == 0).double() * 1e-18, ds)
    m2 = (tm.Nm ** 2 - sr ** 2) / ds * k2
    m = torch.where(m2 >= 0, torch.sqrt(torch.abs(m2)) * torch.sign(sr)
                    + 0j, 1j * torch.sqrt(torch.abs(m2)))
    denom = ((1.0 - 1j * m * tm.Hw) * (1.0 + 1j * sigma * tm.tau_c)
             * (1.0 + 1j * sigma * tm.tau_f))
    P_hat = tm.Cw * 1j * sigma * torch.fft.rfft2(h) / denom
    P = tm.scale_factor * torch.fft.irfft2(P_hat, s=h.shape) / tm.rho_water
    want = torch.clamp(tm.background_precip + P, min=0.0)
    assert g.My == want.shape[0]
    assert torch.equal(got, want)


def test_parameters_from_config():
    over = {"atmosphere.orographic_precipitation.wind_direction": 200.0,
            "atmosphere.orographic_precipitation.wind_speed": 12.0,
            "atmosphere.orographic_precipitation.coriolis_latitude": 65.0,
            "atmosphere.orographic_precipitation.grid_size_factor": 2,
            "atmosphere.orographic_precipitation.lapse_rate": -5.8}
    for cfg in ({}, over):
        j = j_oro.orographic_from_config(JGrid(**GRID), JConfig(cfg))
        t = t_oro.orographic_from_config(Grid(**GRID), Config(cfg))
        for name in ("wind_u", "wind_v", "tau_c", "tau_f", "Hw", "Nm", "Cw",
                     "background_precip", "f_cor", "scale_factor",
                     "truncate", "pad_factor"):
            assert getattr(t, name) == getattr(j, name), name


def test_modifier_through_the_factory():
    from pism_tpu.coupler import factory as j_cf
    from pism_tpu_torch.coupler import factory as t_cf
    s = _surface()
    H = np.maximum(s - 200.0, 0.0)
    bed = s - H
    cfg = {"atmosphere.models": "uniform,orographic_precipitation",
           "atmosphere.uniform.temperature": 255.0}
    jm = j_cf.atmosphere_from_config(JConfig(cfg), {}, grid=JGrid(**GRID))
    tm = t_cf.atmosphere_from_config(Config(cfg), {}, grid=Grid(**GRID))
    a = tm(new_geometry(torch.tensor(H), torch.tensor(bed)), 0.0)
    b = jm(j_geom(jnp.asarray(H), jnp.asarray(bed)), 0.0)
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert np.abs(x.numpy() - y).max() <= 1e-11 * np.abs(y).max()
    with pytest.raises(ValueError, match="grid"):
        t_cf.atmosphere_from_config(Config(cfg), {})


def test_orographic_precipitation_pattern():
    """Rain on the windward flank of a bump, a rain shadow in its lee."""
    grid = Grid(Mx=31, My=31, Lx=155e3, Ly=155e3)
    X, Y = np.meshgrid(grid.x, grid.y)
    bump = 1500.0 * np.exp(-((X / 40e3) ** 2 + (Y / 40e3) ** 2))
    geom = new_geometry(torch.zeros(grid.shape2, dtype=torch.float64),
                        torch.tensor(bump))
    op = t_oro.OrographicPrecipitation(grid=grid, wind_u=10.0,
                                       background_precip=0.5 / SPY)
    P = op(geom, 0.0).precipitation.numpy() * SPY
    assert (P >= 0).all()
    c = 15
    up, down = P[c, 9:15].mean(), P[c, 16:22].mean()
    assert up > down and up > 0.5
