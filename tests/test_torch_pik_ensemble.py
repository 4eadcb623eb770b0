"""The PISM-PIK chain on an ensemble's member axis (``setups.
antarctica_pik_ensemble_model``: PICO, eigen and thickness calving,
Lingle-Clark, the PIK surface), pism_tpu_torch against pism_tpu on the
CPU, and the member forms against per-member calls.

Inputs: the chain's synthetic data file at 200 km (21x21x11, float64), as
``tests/test_torch_cli.py``'s ``pik`` fixture builds it (the bed updated
every year), one file per member with its ocean ``theta_offset`` dT = 0, 1
and 2 K; the port's bootstrap of the first, its enthalpies tied at the
pressure-melting value moved 1 J/kg below it (the JAX package decides
those ties at random under ``jit``). Random fields from numpy seeds.

Tolerances. Each member's 2 a against the JAX command line's run of its
own data file from the untied state: equal steps and dt-limit hits, H and
the viscous bed displacement within 5e-7 of their max, the bed within
1e-9 of its max (``test_pik_run_matches``'s bounds, for the reasons given
there). Against the port's own solo runs of the members' files, the
members' 1-member ensembles and per-member calls of the member forms:
equal to the bit (the same operations on the same float64 values; a
member's basin sums and fills are its own).
"""

import contextlib
import dataclasses
import io
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import cli as j_cli  # noqa: E402
from pism_tpu_torch import Config, new_geometry  # noqa: E402
from pism_tpu_torch import cli as t_cli  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch import state as S  # noqa: E402
from pism_tpu_torch.coupler import atmosphere as t_atm  # noqa: E402
from pism_tpu_torch.coupler import ocean as t_ocean  # noqa: E402
from pism_tpu_torch.coupler import surface as t_surface  # noqa: E402
from pism_tpu_torch.coupler.pico import Pico  # noqa: E402
from pism_tpu_torch.examples.antarctica_pik import (  # noqa: E402
    bootstrap_argv, couplers, synthesize_data_file)
from pism_tpu_torch.io import checkpoint as t_ckpt  # noqa: E402
from pism_tpu_torch.io.nc4 import File  # noqa: E402
from pism_tpu_torch.model.icemodel import IceModel  # noqa: E402
from pism_tpu_torch.parallel.ensemble import (  # noqa: E402
    EnsembleRunner, broadcast_state, member, stack_states)
from pism_tpu_torch.physics.enthalpy_converter import (  # noqa: E402
    EnthalpyConverter)
from pism_tpu_torch.util import hostsync  # noqa: E402
from test_torch_cuda import shelf as _shelf  # noqa: E402

SPY = 3.15569259747e7
KM, MZ, YEARS = 200.0, 11, 2.0
DTS = (0.0, 1.0, 2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module's comparisons to the bit on one intra-op thread: with two,
    torch splits a batched tensor's elementwise math (MKL's vector exp and
    pow) into chunks at other offsets than a member's own tensor, and the
    chunk a worker thread computes can round otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _untie(src, dst):
    """``src``'s state with the enthalpies at the pressure-melting value
    moved 1 J/kg below it, written to ``dst``."""
    cfg = t_ckpt.load_config(src)
    st, t = t_ckpt.load_state(src, device="cpu")
    grid = t_ckpt.load_grid(src)
    EC = EnthalpyConverter.from_config(cfg)
    depth = torch.clamp(st.geometry.ice_thickness[..., None]
                        - torch.as_tensor(grid.z), min=0.0)
    Es = EC.enthalpy_cts(EC.pressure(depth))
    tie = (st.enthalpy - Es).abs() <= 1e-9 * Es.abs()
    st = st.replace(enthalpy=torch.where(tie, st.enthalpy - 1.0, st.enthalpy))
    t_ckpt.save_state(dst, st, grid, t, config=cfg, format="netcdf3")
    return int(tie.sum())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three members' 2 a: through the JAX command line (each from its
    own data file), as one port ensemble, as the port's solo runs of the
    files and as 1-member ensembles; all from the untied bootstrap."""
    d = tmp_path_factory.mktemp("pik_ensemble")
    data = [str(d / f"ant_{k}.nc") for k in range(len(DTS))]
    for path, dT in zip(data, DTS):
        synthesize_data_file(path, KM, "netcdf4", theta_offset=dT)

    def argv(k, out, y, fmt, src=None):
        a = bootstrap_argv(data[k], out, KM, y, fmt, Mz=MZ, dtype="float64",
                           extra=("-config",
                                  "bed_deformation.update_interval=1"))
        i = a.index("-verbose")
        del a[i:i + 2]
        if src is not None:   # the same flags on a -i of ``src``
            a = ["-i", src] + a[a.index("-stress_balance"):]
        return a

    b0, tie = str(d / "b0.nc"), str(d / "tie0.nc")
    with contextlib.redirect_stdout(io.StringIO()):
        assert t_cli.main(argv(0, b0, 0.0, "netcdf3")
                          + ["-platform", "cpu"]) == 0
    assert _untie(b0, tie) > 0
    jax = []
    for k in range(len(DTS)):
        out = str(d / f"jax_{k}.nc")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert j_cli.main(argv(k, out, YEARS, "netcdf4", src=tie) + [
                "-config", "time_stepping.count_time_steps=true"]) == 0
        m = re.search(r"count_time_steps: (\d+) adaptive steps \(binding "
                      r"limits: (\{.*\})\)", buf.getvalue())
        jax.append(((int(m.group(1)), eval(m.group(2))), out))

    model, _, grid, dT = setups.antarctica_pik_ensemble_model(
        len(DTS), KM, "float64", device="cpu", data=data[0], Mz=MZ)
    assert list(dT) == list(DTS)
    st0, t0 = t_ckpt.load_state(tie, config=model.config, device="cpu")
    st0 = model.prepare_state(st0.replace(u_ssa=None, v_ssa=None))
    t1 = t0 + YEARS * SPY
    out, stats = EnsembleRunner(model).run_segment(
        broadcast_state(st0, len(DTS)), t0, t1)
    solo, ones = [], []
    for k in range(len(DTS)):
        cfg = model.config.copy().update({"ocean.pico.file": data[k]})
        surface, ocean = couplers(cfg, grid, data[k], "cpu")
        one = IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean,
                       device="cpu")
        solo.append(one.step_once(st0, t0, YEARS * SPY))
        mk = dataclasses.replace(model, ocean=dataclasses.replace(
            model.ocean,
            member_temperature=model.ocean.member_temperature[k:k + 1]))
        ones.append(EnsembleRunner(mk).run_segment(stack_states([st0]), t0,
                                                   t1))
    return dict(model=model, grid=grid, st0=st0, out=out, stats=stats,
                jax=jax, solo=solo, ones=ones)


def test_members_match_the_jax_package_runs_of_their_files(runs):
    """Each member against the JAX command line's run of its own data file:
    equal steps and dt-limit hits, H and the viscous displacement within
    5e-7 of their max, the bed within 1e-9."""
    out = runs["out"]
    for k, ((steps, hits), path) in enumerate(runs["jax"]):
        st = runs["stats"][k]
        assert (st.nsteps, st.limit_hits_dict()) == (steps, hits) and steps
        with File(path, "r") as f:
            for name, got, tol in (
                    ("thk", out.geometry.ice_thickness[k], 5e-7),
                    ("viscous_bed_displacement", out.bed_uplift[k], 5e-7),
                    ("topg", out.geometry.bed_elevation[k], 1e-9)):
                want = np.asarray(f.read(name), float).reshape(got.shape)
                err = np.abs(got.numpy() - want).max()
                assert err <= tol * np.abs(want).max(), (k, name, err)


def test_members_equal_their_solo_and_one_member_runs(runs):
    """Each member equals, to the bit, the port's solo run of its data file
    (steps, hits, Newton and Krylov counts, every field) and its run as a
    1-member ensemble."""
    out, stats = runs["out"], runs["stats"]
    geo = ("ice_thickness", "bed_elevation", "ice_area_specific_volume",
           "cell_type", "cell_grounded_fraction")
    fields = ("enthalpy", "u_ssa", "v_ssa", "bed_uplift", "tillwat",
              "basal_melt_rate")
    for k in range(len(DTS)):
        st, _, ss = runs["solo"][k]
        one, (so,) = runs["ones"][k]
        e = stats[k]
        for s in (ss, so):
            assert (s.nsteps, s.limit_hits, s.ssa_newton_iters,
                    s.ssa_krylov_iters) == (e.nsteps, e.limit_hits,
                                            e.ssa_newton_iters,
                                            e.ssa_krylov_iters)
        for name in geo:
            assert torch.equal(getattr(st.geometry, name),
                         getattr(out.geometry, name)[k]), (k, name)
            assert torch.equal(getattr(one.geometry, name)[0],
                         getattr(out.geometry, name)[k]), (k, name)
        for name in fields:
            assert torch.equal(getattr(st, name), getattr(out, name)[k]), (k, name)
            assert torch.equal(getattr(one, name)[0], getattr(out, name)[k]), \
                (k, name)


def test_members_move_the_bed_and_melt_by_their_water(runs):
    """Lingle-Clark moved every member's bed, and the members' sub-shelf
    melt grows with their ocean temperature."""
    out, st0 = runs["out"], runs["st0"]
    for k in range(len(DTS)):
        assert not torch.equal(out.bed_uplift[k], st0.bed_uplift)
    bmb = [float(s.sum_bmb) for s in runs["stats"]]
    assert bmb[0] > 0.0 and bmb[0] < bmb[1] < bmb[2]


# -- the member forms against per-member calls ------------------------------

def _members_geometry(H, bed, scales):
    """Member geometries with H scaled per member, stacked."""
    gs = [new_geometry(torch.tensor(H * s), torch.tensor(bed))
          for s in scales]
    return gs, S.Geometry(**{f.name: torch.stack([getattr(g, f.name)
                                                  for g in gs])
                             for f in dataclasses.fields(S.Geometry)})


@pytest.mark.parametrize("basins", [False, True])
def test_pico_members_equal_per_member_calls(basins):
    """``Pico.members`` (``exclude_ice_rises`` on, the ice-rise seed each
    member's own thickest ice; both basins and one without shelf data)
    against a ``Pico.solve`` per member with the member's temperature:
    melt, box index and distances equal to the bit; the member call's host
    syncs are no more than the slowest member's fills take."""
    g, H, bed, T0, S0, b, _, _ = _shelf()
    cfg = Config({"runtime.float_dtype": "float64"})
    assert cfg.get_flag("ocean.pico.exclude_ice_rises")
    scales = (0.9, 1.0, 1.15)
    gs, gB = _members_geometry(H, bed, scales)
    TB = torch.tensor(T0)[None] + torch.tensor([0.0, 0.7, 1.4])[:, None, None]
    pico = Pico(temperature_ocean=torch.tensor(T0),
                salinity_ocean=torch.tensor(S0), config=cfg, grid=g,
                basin_mask=torch.tensor(b) if basins else None,
                member_temperature=TB)
    s0 = hostsync.COUNT
    melt = pico.members(gB, None)
    syncs = hostsync.COUNT - s0
    boxes = pico.boxes(gB, lead=1)
    single = []
    for k, gk in enumerate(gs):
        one = dataclasses.replace(pico, temperature_ocean=TB[k])
        s0 = hostsync.COUNT
        pf = one.solve(gk, 0.0)
        single.append(hostsync.COUNT - s0)
        assert torch.equal(melt[k], pf.melt), k
        for got, want in zip(boxes, (pf.box, pf.d_gl, pf.d_if)):
            assert torch.equal(got[k], want), k
    assert syncs <= sum(single) and syncs >= max(single)
    assert bool((boxes.box > 0).any(dim=(1, 2)).all())
    with pytest.raises(ValueError):
        pico.members(S.Geometry(**{f.name: getattr(gB, f.name)[:2]
                                   for f in dataclasses.fields(S.Geometry)}),
                     None)


def test_ocean_and_surface_member_forms_equal_per_member_calls():
    """``ocean.PIK.members``, ``ocean.DeltaT.members`` (over PICO) and
    ``surface.PIK.members`` (on the PIK atmosphere) against per-member
    calls, to the bit."""
    g, H, bed, T0, S0, _, X, Y = _shelf()
    cfg = Config({"runtime.float_dtype": "float64"})
    gs, gB = _members_geometry(H, bed, (0.8, 1.0, 1.2))
    lat = torch.tensor(-60.0 - 20.0 * (1.0 - np.hypot(X, Y) / 1e6))
    pico = Pico(temperature_ocean=torch.tensor(T0),
                salinity_ocean=torch.tensor(S0), config=cfg, grid=g)
    atm = t_atm.PIK(latitude=lat, precipitation=torch.full(
        lat.shape, 0.3 / SPY, dtype=torch.float64))
    models = [(t_ocean.PIK(config=cfg), "ocean"),
              (t_ocean.DeltaT(inner=pico, offset=lambda t: 1.5), "ocean"),
              (t_surface.PIK(atmosphere=atm, latitude=lat), "surface")]
    for m, kind in models:
        got = m.members(gB, torch.zeros(3, dtype=torch.float64))
        for k, gk in enumerate(gs):
            want = m(gk, 0.0)
            if kind == "ocean":
                assert torch.equal(got[k], want), type(m).__name__
            else:
                shape = gB.ice_thickness.shape
                assert torch.equal(torch.broadcast_to(got.smb, shape)[k], want.smb)
                assert torch.equal(got.temperature[k], want.temperature)


def _pik_twins(extra_cfg=None, members=3, km=KM):
    """The ensemble setup's solo model, its member-axis twin, the batched
    state and the members' temperatures."""
    model, bs, grid, _ = setups.antarctica_pik_ensemble_model(
        members, km, "float64", device="cpu", Mz=MZ, extra_cfg=extra_cfg)
    return model, EnsembleRunner(model).twin("cpu"), bs, grid


def test_lingle_clark_members_equal_per_member_steps():
    """``LingleClark.members_step``: members with their own loads, steps
    and step ends, the gate open for some only (and not for a frozen
    member whose step would cross), against ``step`` per member: bed and
    viscous displacement to the bit; no solve when no gate opens."""
    model, _, bs, _ = _pik_twins()
    lc = model.bed_deformation
    assert lc.update_interval == SPY
    rng = np.random.default_rng(7)
    H = bs.geometry.ice_thickness * torch.tensor(
        1.0 + 0.1 * rng.uniform(-1, 1, bs.geometry.ice_thickness.shape))
    bs = bs.replace(geometry=bs.geometry.replace(ice_thickness=H))
    # (steps, step ends [a], active, whose gate opens)
    cases = [([0.6, 1.3, 0.9], [1.2, 2.5, 3.95], [True, True, True],
              [True, True, False]),
             ([0.6, 1.3, 0.9], [1.2, 2.5, 4.1], [True, False, True],
              [True, False, True])]
    for dts, ends, active, opens in cases:
        dts = [d * SPY for d in dts]
        ends = [e * SPY for e in ends]
        got = lc.members_step(bs, dts, ends, active)
        for k in range(3):
            want = lc.step(member(bs, k), dts[k], t=ends[k]) if active[k] \
                else member(bs, k)
            assert torch.equal(got.bed_uplift[k], want.bed_uplift), k
            assert torch.equal(got.geometry.bed_elevation[k],
                         want.geometry.bed_elevation), k
            assert torch.equal(got.bed_uplift[k], bs.bed_uplift[k]) \
                == (not opens[k]), k
    closed = lc.members_step(bs, [0.3 * SPY] * 3, [0.5 * SPY] * 3,
                             [True] * 3)
    assert closed is bs


def test_eigen_calving_members_equal_per_member_steps():
    """The calving step (eigen and thickness calving, part-grid retreat,
    iceberg removal) on the member axis with a (B, 1, 1) dt against the
    solo step per member with its host dt, on spreading shelves (radial
    velocities from a seed, so both strain eigenvalues are positive at the
    fronts): the geometry to the bit; ``max_rate`` per member."""
    model, twin, bs, grid = _pik_twins({"calving.front_retreat.use_cfl":
                                        True})
    assert twin.front_retreat_cfl and twin.calving.lead == 1
    X, Y = np.meshgrid(grid.x, grid.y)
    rng = np.random.default_rng(11)
    us, vs = [], []
    for c in (1.0, 2.0, 3.0):
        us.append(c * 1e-9 * X * (1 + 0.1 * rng.uniform(-1, 1, X.shape)))
        vs.append(c * 1e-9 * Y * (1 + 0.1 * rng.uniform(-1, 1, X.shape)))
    sb = SimpleNamespace(u_ssa=torch.tensor(np.stack(us)),
                         v_ssa=torch.tensor(np.stack(vs)))
    rates = twin.calving.max_rate(bs.geometry, sb)
    assert rates.shape == (3,) and bool((rates > 0).all())
    dts = [0.4 * grid.dx / float(r) for r in rates]
    got = twin.calving.step(bs.geometry, sb, torch.tensor(
        dts, dtype=torch.float64).view(3, 1, 1))
    for k in range(3):
        sbk = SimpleNamespace(u_ssa=sb.u_ssa[k], v_ssa=sb.v_ssa[k])
        gk = member(bs, k).geometry
        assert torch.equal(model.calving.max_rate(gk, sbk), rates[k])
        want = model.calving.step(gk, sbk, dts[k])
        for name in ("ice_thickness", "ice_area_specific_volume"):
            assert torch.equal(getattr(got, name)[k], getattr(want, name)), name
        assert not torch.equal(got.ice_area_specific_volume[k],
                               gk.ice_area_specific_volume)


def test_front_retreat_limit_on_the_member_axis():
    """``calving.front_retreat.use_cfl`` on the member axis: the front
    retreat rate enters each member's row of maxima, and every member
    takes the steps, dt-limit hits (front_retreat among them) and fields
    of its solo run, as ``test_front_retreat_limit_matches`` holds the
    solo route to the JAX package. At 100 km from the ensemble's 2 a state,
    where the eigen rate acts on the fronts (from the bootstrap it does not
    yet)."""
    model, _, bs, _ = _pik_twins(members=2, km=100.0)
    s2, _ = EnsembleRunner(model).run_segment(bs, 0.0, 2.0 * SPY)
    # as the solo runs start: prepared (the sub-grid grounded fraction that
    # the step's bed update drops, recomputed)
    s2 = stack_states([model.prepare_state(member(s2, k)) for k in range(2)])
    cfg = model.config.copy().update({"calving.front_retreat.use_cfl": True})
    model = dataclasses.replace(model, config=cfg,
                                calving=dataclasses.replace(model.calving,
                                                            config=cfg))
    t0, t1 = 2.0 * SPY, 2.2 * SPY
    out, stats = EnsembleRunner(model).run_segment(s2, t0, t1)
    assert all("front_retreat" in s.limit_hits_dict() for s in stats)
    for k in range(2):
        solo = dataclasses.replace(model, ocean=dataclasses.replace(
            model.ocean, temperature_ocean=model.ocean.member_temperature[k]))
        st, _, ss = solo.step_once(member(s2, k), t0, t1 - t0)
        assert (ss.nsteps, ss.limit_hits) == (stats[k].nsteps,
                                              stats[k].limit_hits)
        assert ss.dt_min == stats[k].dt_min
        assert torch.equal(st.geometry.ice_thickness, out.geometry.ice_thickness[k])


def test_select_members_carries_the_bed_fields():
    """``broadcast_state``, ``stack_states`` and ``select_members`` carry
    the Lingle-Clark fields and the grounded fraction per member."""
    _, _, bs, _ = _pik_twins(members=2)
    names = ("bed_uplift", "bed_reference", "bed_load_reference")
    for n in names:
        assert getattr(bs, n).shape[0] == 2
    other = S.map_tensors(bs, lambda x: x + 1 if x.is_floating_point()
                          else x)
    sel = S.select_members(torch.tensor([True, False]), other, bs)
    st = stack_states([member(other, 0), member(bs, 1)])
    for s in (sel, st):
        for n in names:
            assert torch.equal(getattr(s, n)[0], getattr(other, n)[0])
            assert torch.equal(getattr(s, n)[1], getattr(bs, n)[1])
        assert torch.equal(s.geometry.cell_grounded_fraction[0],
                           other.geometry.cell_grounded_fraction[0])
        assert torch.equal(s.geometry.cell_grounded_fraction[1],
                           bs.geometry.cell_grounded_fraction[1])
