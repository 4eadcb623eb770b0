"""The float32 production path of pism_tpu_torch (the pure-f32 SSA solve
with its velocity-change stop, the branch the card runs) against the
float64 path on the 100 km chain, two model years on the CPU.

An f32 SSA solve stops at a residual floor of 1e-4 to 3e-4 relative, so
the two trajectories agree at that envelope, not pointwise. Measured over
these two years: ice volume 3e-6 relative apart, H 6e-4 of max H; the
bounds are 1e-4 and 5e-3. Velocities are not compared pointwise: the
reference's own float32 and float64 runs of this chain end 0.32 of max|u|
apart on ice thicker than 100 m (measured with pism_tpu on the CPU; the
port's spread is 0.33)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch.convert import state_to_numpy  # noqa: E402

SPY = 3.15569259747e7


@pytest.fixture(scope="module")
def runs():
    out = {}
    for dtype in ("float32", "float64"):
        model, state, _ = setups.hybrid_greenland_model(dtype, km=100,
                                                        device="cpu")
        state, t, stats = model.step_once(state, 0.0, 2.0 * SPY)
        out[dtype] = (state_to_numpy(state), t, stats)
    return out


def test_float32_state_is_float32_and_finite(runs):
    d, t, stats = runs["float32"]
    for name in ("ice_thickness", "enthalpy", "u_ssa", "v_ssa",
                 "basal_melt_rate", "snow_depth", "firn_depth"):
        assert d[name].dtype == np.float32, name
        assert np.all(np.isfinite(d[name])), name
    assert t == pytest.approx(2.0 * SPY, abs=1e-6)


def test_float32_newton_sweeps_run_krylov(runs):
    """Every f32 Newton sweep solves its linear system (a float32 overflow
    in the linearization once made them all stop at iteration 0)."""
    _, _, stats = runs["float32"]
    assert stats.ssa_newton_iters > 0
    assert stats.ssa_krylov_iters >= stats.ssa_newton_iters


def test_float32_tracks_float64(runs):
    (a, _, sa), (b, _, sb) = runs["float32"], runs["float64"]
    assert sa.nsteps == sb.nsteps
    assert sa.limit_hits_dict() == sb.limit_hits_dict()
    va = float(a["ice_thickness"].astype(np.float64).sum())
    vb = float(b["ice_thickness"].sum())
    assert abs(va - vb) <= 1e-4 * vb
    Hb = b["ice_thickness"]
    assert np.abs(a["ice_thickness"] - Hb).max() <= 5e-3 * Hb.max()
