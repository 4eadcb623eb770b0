"""The port's device mesh and halo exchange (``pism_tpu_torch/parallel``)
against the JAX package's (``pism_tpu/parallel``) on the 8-device CPU mesh:
``best_factorization``, the mesh's shape, and ghost cells for widths 1 and
2, every ``periodic`` combination and the mesh shapes (1, 8), (8, 1), (2, 4)
and (4, 2), as tests/test_sharding.py:74-98 checks the JAX halo.

The port's meshes name the CPU eight times (``make_mesh(["cpu"] * 8,
shape)``); JAX's are its 8 virtual CPU devices (tests/conftest.py).
Ghosts are copies, so the reassembled blocks, and a stencil over them,
equal the padded global field and its stencil exactly; the stencil through
both packages agrees to 1e-12 of its largest value (float64 rounding of
the two frameworks' sums).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu.parallel import halo as j_halo  # noqa: E402
from pism_tpu.parallel.mesh import (best_factorization as j_best,  # noqa: E402
                                    make_mesh as j_make_mesh)
from pism_tpu_torch import ModelState, new_geometry  # noqa: E402
from pism_tpu_torch.parallel import (Mesh, best_factorization,  # noqa: E402
                                     make_mesh, shard_state)
from pism_tpu_torch.parallel import halo  # noqa: E402

SHAPES = [(1, 8), (8, 1), (2, 4), (4, 2)]
PERIODIC = list(itertools.product([False, True], repeat=2))


@pytest.fixture(autouse=True, scope="module")
def _fresh_compile_state():
    """Drop the compiled executables of earlier tests in this process
    before the shard_map compilations (tests/test_sharding.py:23-33)."""
    jax.clear_caches()
    yield


@pytest.fixture(scope="module")
def jax_devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return d


@pytest.mark.parametrize("n", range(1, 17))
def test_best_factorization_matches(n):
    assert best_factorization(n) == j_best(n)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_shape_matches(jax_devices, shape):
    m = make_mesh(["cpu"] * 8, shape)
    jm = j_make_mesh(jax_devices, shape)
    assert m.axis_names == tuple(jm.axis_names) == ("y", "x")
    assert (m.shape["y"], m.shape["x"]) == (jm.shape["y"], jm.shape["x"])
    assert m.size == jm.size == 8
    assert all(d == torch.device("cpu") for row in m.devices for d in row)


def test_default_mesh_is_the_cards():
    """``make_mesh()`` takes every CUDA device and never falls back to the
    CPU: without a card it raises."""
    if torch.cuda.is_available():
        m = make_mesh()
        assert m.size == torch.cuda.device_count()
        assert m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            make_mesh()


def test_mesh_rejects_what_it_cannot_be():
    assert make_mesh(["cpu"] * 6).shape == {"y": 2, "x": 3}
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 6, (4, 2))
    with pytest.raises(NotImplementedError):
        make_mesh(["cpu"] * 8, (2, 2), ensemble=2)
    with pytest.raises(ValueError):
        Mesh([["cpu", "cpu"], ["cpu"]])


def test_shard_state_keeps_fields_whole_on_the_first_device():
    H = torch.ones(6, 8, dtype=torch.float64)
    state = ModelState(geometry=new_geometry(H, torch.zeros_like(H)))
    out = shard_state(state, make_mesh(["cpu"] * 4, (2, 2)))
    assert out.geometry.ice_thickness.shape == (6, 8)
    assert out.geometry.ice_thickness.device == torch.device("cpu")


def test_split_and_gather_round_trip():
    rng = np.random.default_rng(3)
    mesh = make_mesh(["cpu"] * 8, (2, 4))
    a = torch.tensor(rng.normal(size=(6, 8, 5)))
    blocks = halo.split_blocks(a, mesh)
    assert [[tuple(b.shape) for b in row] for row in blocks] == \
        [[(3, 2, 5)] * 4] * 2
    assert torch.equal(halo.gather_blocks(blocks), a)
    with pytest.raises(ValueError):
        halo.split_blocks(a[:5], mesh)


def _padded(a, width, periodic):
    """The global field with ``width`` ghosts: repeated edges, or wrapped
    along a periodic axis."""
    for axis, per in enumerate(periodic):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (width, width)
        a = np.pad(a, pad, mode="wrap" if per else "edge")
    return a


def _stencil(width):
    """A 5-point Laplacian of spacing ``width`` plus a diagonal difference,
    so that the corner ghosts count too."""
    w = width

    def fn(p):
        return (p[2 * w:, w:-w] + p[:-2 * w, w:-w] + p[w:-w, 2 * w:]
                + p[w:-w, :-2 * w] - 4.0 * p[w:-w, w:-w]
                + 0.5 * (p[2 * w:, 2 * w:] - p[:-2 * w, :-2 * w]))
    return fn


@pytest.mark.parametrize("periodic", PERIODIC)
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_halo_matches_the_padded_field(shape, width, periodic):
    """Every block's ghosts are the padded global field's cells around it,
    and a stencil over the blocks is the stencil of the padded field."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(16, 32))
    mesh = make_mesh(["cpu"] * 8, shape)
    ny, nx = shape
    by, bx = 16 // ny, 32 // nx
    ref = _padded(a, width, periodic)
    blocks = halo.halo_pad(halo.split_blocks(torch.tensor(a), mesh), width,
                           mesh, periodic)
    for iy in range(ny):
        for ix in range(nx):
            want = ref[iy * by:(iy + 1) * by + 2 * width,
                       ix * bx:(ix + 1) * bx + 2 * width]
            np.testing.assert_array_equal(blocks[iy][ix].numpy(), want)
            np.testing.assert_array_equal(
                halo.crop(blocks[iy][ix], width).numpy(),
                a[iy * by:(iy + 1) * by, ix * bx:(ix + 1) * bx])
    fn = _stencil(width)
    got = halo.stencil_shard_map(fn, mesh, width, periodic)(torch.tensor(a))
    np.testing.assert_array_equal(got.numpy(), fn(ref))


# each case compiles a shard_map program (~2 s): every mesh shape at both
# widths, clamped at width 1 and periodic at width 2, and the two mixed
# periodicities
@pytest.mark.parametrize("shape,width,periodic",
                         [(s, 1, (False, False)) for s in SHAPES]
                         + [(s, 2, (True, True)) for s in SHAPES]
                         + [((2, 4), 1, (True, False)),
                            ((2, 4), 2, (False, True))])
def test_stencil_matches_jax(jax_devices, shape, width, periodic):
    """The port's ``stencil_shard_map`` against JAX's
    ``halo.stencil_shard_map`` on the same field and mesh shape."""
    a = np.random.default_rng(8).normal(size=(16, 32))
    fn = _stencil(width)
    got = halo.stencil_shard_map(fn, make_mesh(["cpu"] * 8, shape), width,
                                 periodic)(torch.tensor(a))
    want = np.asarray(j_halo.stencil_shard_map(
        fn, j_make_mesh(jax_devices, shape), width, periodic)(jnp.asarray(a)))
    assert got.shape == want.shape == a.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_halo_needs_blocks_as_wide_as_the_ghosts():
    mesh = make_mesh(["cpu"] * 8, (1, 8))
    with pytest.raises(ValueError):
        halo.halo_pad(halo.split_blocks(torch.zeros(4, 8), mesh), 2, mesh)
