"""Batched tridiagonal solvers of pism_tpu_torch against pism_tpu's on the
diagonally dominant systems of tests/test_age_btu.py (1e-12)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu.util import tridiag as j_tri  # noqa: E402
from pism_tpu_torch.util import tridiag as t_tri  # noqa: E402


def _system(n, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((5, 6, n)) * 0.3
    c = rng.standard_normal((5, 6, n)) * 0.3
    b = 2.0 + np.abs(a) + np.abs(c) + rng.random((5, 6, n))
    d = rng.standard_normal((5, 6, n))
    return a, b, c, d


@pytest.mark.parametrize("n", [2, 3, 41, 76])
@pytest.mark.parametrize("name", ["solve_batched_thomas", "solve_batched_pcr",
                                  "solve_batched"])
def test_solver_matches_reference(name, n):
    a, b, c, d = _system(n)
    ref = np.asarray(getattr(j_tri, name)(a, b, c, d))
    got = getattr(t_tri, name)(*(torch.from_numpy(x) for x in (a, b, c, d)))
    assert np.abs(got.numpy() - ref).max() < 1e-12 * np.abs(ref).max() + 1e-14


def test_pcr_matches_thomas():
    for n in (2, 3, 41):
        a, b, c, d = (torch.from_numpy(x) for x in _system(n))
        x1 = t_tri.solve_batched_thomas(a, b, c, d)
        x2 = t_tri.solve_batched_pcr(a, b, c, d)
        assert (x1 - x2).abs().max() < 1e-12 * x1.abs().max() + 1e-14


def test_ignored_corners_and_inputs_untouched():
    a, b, c, d = (torch.from_numpy(x) for x in _system(9))
    a0, c0 = a.clone(), c.clone()
    x = t_tri.solve_batched_pcr(a, b, c, d)
    assert torch.equal(a, a0) and torch.equal(c, c0)
    a2, c2 = a.clone(), c.clone()
    a2[..., 0] = 123.0
    c2[..., -1] = -77.0
    for solve in (t_tri.solve_batched_thomas, t_tri.solve_batched_pcr):
        assert torch.allclose(solve(a2, b, c2, d), x, rtol=1e-12, atol=1e-14)
