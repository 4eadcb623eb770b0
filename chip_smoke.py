"""GPU smoke run of the PyTorch port (pism_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the SSA matvec kernels from ``pism_tpu_torch/csrc`` and
holds them against their plain torch versions on the card, value and JVP,
at the 20 km (76x141) and 5 km (301x561) grid shapes: relative max-norm
error 1e-12 in float64 and 1e-5 in float32. It times both with CUDA events.
It then runs the 100 km chain for one model year in float64 on the card
and on the CPU (plain torch path) and compares the two.

Phase 2 drives the main path: the 20 km synthetic-Greenland hybrid chain
in float32 for 10 model years through ``IceModel.step_once``, with the
kernels' launch counters reset just before and read just after.
Phase 3 runs the 5 km chain for 0.5 model years.

Every failure raises, so the script exits non-zero. Without a CUDA card it
exits non-zero before printing any result. The second-to-last line is the
JSON kernel record; the last line is the device record.
"""

import json
import subprocess
import sys
import time

SPY = 3.15569259747e7


def _require_cuda():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    return torch


def _rel_err(a, b):
    """max |a - b| / max |b| (b is the plain reference)."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase1_kernels(dev):
    """Kernel against plain version at the chain's shapes; returns timings
    {kernel name: (ms, plain_ms, max_abs_err)} at the 20 km shape, f32."""
    import numpy as np
    import torch
    from pism_tpu_torch.ops.kernels import ssa_matvec as K

    t0 = time.time()
    K.build()
    print(f"phase1: built ssa_matvec kernels in {time.time() - t0:.1f} s")
    out = {}
    rng = np.random.default_rng(20240601)
    for (My, Mx), km in (((141, 76), 20), ((561, 301), 5)):
        dx = dy = km * 1e3
        arrs = {k: rng.normal(size=(My, Mx)) * 1e-5
                for k in ("u", "v", "du", "dv")}
        arrs["nuH_e"] = rng.uniform(1e13, 1e16, size=(My, Mx))
        arrs["nuH_n"] = rng.uniform(1e13, 1e16, size=(My, Mx))
        arrs["dnuH_e"] = rng.normal(size=(My, Mx)) * 1e14
        arrs["dnuH_n"] = rng.normal(size=(My, Mx)) * 1e14
        arrs["beta"] = rng.uniform(0.0, 1e10, size=(My, Mx))
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            t = {k: torch.tensor(a, dtype=dtype, device=dev)
                 for k, a in arrs.items()}
            mv = (t["u"], t["v"], t["nuH_e"], t["nuH_n"], t["beta"], dx, dy)
            jv = (t["u"], t["v"], t["du"], t["dv"], t["nuH_e"], t["nuH_n"],
                  t["dnuH_e"], t["dnuH_n"], t["beta"], None, dx, dy)
            res = {}
            for name, kern, plain, args in (
                    ("ssa_matvec", K.ssa_matvec, K.ssa_matvec_plain, mv),
                    ("ssa_matvec_jvp", K.ssa_matvec_jvp,
                     K.ssa_matvec_jvp_plain, jv)):
                got = kern(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                err = max(_rel_err(got[0], ref[0]), _rel_err(got[1], ref[1]))
                abs_err = max(float((got[i] - ref[i]).abs().max())
                              for i in range(2))
                if not err <= tol:
                    raise AssertionError(
                        f"{name} {tuple(t['u'].shape)} {dtype}: relative "
                        f"error {err:.3e} > {tol:.0e}")
                ms = _time_ms(lambda: kern(*args), 200)
                plain_ms = _time_ms(lambda: plain(*args), 200)
                res[name] = (ms, plain_ms, abs_err)
                print(f"phase1: {name} {My}x{Mx} {str(dtype)[6:]} "
                      f"rel_err {err:.3e} (tol {tol:.0e}) kernel {ms:.4f} ms "
                      f"plain {plain_ms:.4f} ms")
            if km == 20 and dtype == torch.float32:
                out = res
    return out


def phase1_chain_reference(dev):
    """The 100 km chain, one model year in float64: the card (kernels)
    against the CPU (plain torch path) on identical inputs."""
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.convert import state_to_numpy

    runs = {}
    for where in ("cpu", dev):
        model, state, _ = setups.hybrid_greenland_model("float64", 100.0,
                                                        device=where)
        state, t, stats = model.step_once(state, 0.0, SPY)
        runs[str(where)] = (state_to_numpy(state), stats.nsteps)
    (a, na), (b, nb) = runs["cpu"], runs[str(dev)]
    if na != nb:
        raise AssertionError(f"100 km chain: {nb} steps on the card, {na} on cpu")
    H_err = float(abs(a["ice_thickness"] - b["ice_thickness"]).max()
                  / abs(a["ice_thickness"]).max())
    vol_err = abs(float(a["ice_thickness"].sum()) - float(b["ice_thickness"].sum())) \
        / float(a["ice_thickness"].sum())
    print(f"phase1: 100 km chain 1 a float64, card vs cpu: steps {nb} "
          f"H max err {H_err:.3e} of max H, volume rel err {vol_err:.3e}")
    # the SSA solve amplifies roundoff (a 1e-15 input change moves u by
    # ~1e-5), so H agrees to ~1e-6 of max H and the volume to ~1e-9
    if not (H_err < 1e-5 and vol_err < 1e-8):
        raise AssertionError("100 km chain: card and cpu disagree")


def run_chain(dev, km, years, label):
    """One chain run through step_once; returns its stats and wall time."""
    import torch
    from pism_tpu_torch import setups
    from pism_tpu_torch.ops.kernels import ssa_matvec as K
    from pism_tpu_torch.util import hostsync

    model, state, grid = setups.hybrid_greenland_model("float32", km, device=dev)
    torch.cuda.synchronize()
    K.LAUNCHES = 0
    K.JVP_LAUNCHES = 0
    hostsync.COUNT = 0
    t0 = time.time()
    state, t, stats = model.step_once(state, 0.0, years * SPY)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"ssa_matvec": K.LAUNCHES, "ssa_matvec_jvp": K.JVP_LAUNCHES}

    H = state.geometry.ice_thickness
    fields = {"ice_thickness": H, "enthalpy": state.enthalpy,
              "u_ssa": state.u_ssa, "v_ssa": state.v_ssa,
              "basal_melt_rate": state.basal_melt_rate}
    for name, f in fields.items():
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    if tuple(state.enthalpy.shape) != grid.shape3:
        raise AssertionError(f"{label}: enthalpy shape {tuple(state.enthalpy.shape)}")
    if stats.nsteps <= 0 or abs(t - years * SPY) > 1e-3:
        raise AssertionError(f"{label}: {stats.nsteps} steps reached t = {t}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{label}: {name} was never launched")
    n = stats.nsteps
    volume = float(H.double().sum()) * grid.dx * grid.dy
    print(f"{label}: grid {grid.My}x{grid.Mx}x{grid.Mz} float32, {years} a: "
          f"steps {n}, wall {wall:.3f} s, {1e3 * wall / n:.2f} ms/step, "
          f"Newton sweeps {stats.ssa_newton_iters} ({stats.ssa_newton_iters / n:.2f}/step), "
          f"Krylov its {stats.ssa_krylov_iters} ({stats.ssa_krylov_iters / n:.2f}/step), "
          f"host syncs {stats.host_syncs} ({stats.host_syncs / n:.1f}/step), "
          f"launches {launches}, dt-limit hits {stats.limit_hits_dict()}, "
          f"ice volume {volume:.6e} m^3, max H {float(H.max()):.2f} m")
    return stats, wall, launches


def main():
    torch = _require_cuda()
    dev = torch.device("cuda:0")
    # float32 reference arithmetic stays float32 (no TF32 anywhere)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"versions: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    timings = phase1_kernels(dev)
    phase1_chain_reference(dev)
    _, _, launches = run_chain(dev, 20.0, 10.0, "phase2")
    run_chain(dev, 5.0, 0.5, "phase3")

    kernels = []
    for name, replaces in (
            ("ssa_matvec", "pism_tpu/ops/pallas_kernels.py:325"),
            ("ssa_matvec_jvp", "pism_tpu/ops/pallas_kernels.py:407")):
        ms, plain_ms, err = timings[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": "pism_tpu_torch/csrc/ssa_matvec.cu",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
