"""Where one phase of ``chip_smoke.py`` spends its time, on a CUDA card.

Times an empty profiler session (5 of each, one tiny launch inside, 1, 10
and 50 times), then runs the phase function named on the command line
(one of ``chip_smoke``'s that takes only the device, by default
``phase1_kernels``) under ``cProfile`` and prints the 60 costliest calls
by cumulative and the 40 by own time. cProfile slows the Python side by
about a third. Run from the repository's root:

    python3 scripts/smoke_phase_profile.py [phase1_kernels]
"""

import cProfile
import pathlib
import pstats
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "phase1_kernels"
    torch = chip_smoke._require_cuda()
    dev = torch.device("cuda:0")
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device=dev)
    for reps in (1, 10, 50):
        t = time.perf_counter()
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    x.zero_()
                torch.cuda.synchronize()
            prof.events()
        print(f"a profiler session of {reps} one-element launches: "
              f"{(time.perf_counter() - t) / 5 * 1e3:.1f} ms", flush=True)
    pr = cProfile.Profile()
    t = time.time()
    pr.enable()
    getattr(chip_smoke, name)(dev)
    pr.disable()
    print(f"{name}: {time.time() - t:.1f} s under cProfile")
    stats = pstats.Stats(pr)
    stats.sort_stats("cumulative").print_stats(60)
    stats.sort_stats("tottime").print_stats(40)


if __name__ == "__main__":
    main()
