#!/usr/bin/env python3
"""End-to-end solver throughput on a REFINED real watershed.

Refines ccw (1147 cells, real DEM/parameters/forcing/rivers) by 4:1
subdivision to the requested level and times the production fused driver on
the available accelerator — the real-topography counterpart of the
synthetic-mesh rows in docs/PERF.md and BASELINE.json's "synthetic 10M-cell
refined mesh" configuration.

    python tools/bench_refined.py [levels] [windows]   (default 5 -> 1.17M cells)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    levels = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    n_win = int(sys.argv[2]) if len(sys.argv) > 2 else 24

    import shud_tpu  # noqa: F401
    from shud_tpu.driver.fused import FusedSimulation
    from shud_tpu.io.project import load_project
    from shud_tpu.utils.refine import refine_project

    t0 = time.time()
    inp = refine_project(load_project("ccw", base="/root/reference"), levels)
    ne = inp.tri.shape[0]
    if ne >= 16384:
        # RCM renumbering keeps each cell's neighbours close in memory
        from shud_tpu.utils.reorder import localize_project

        inp, _perm = localize_project(inp)
    print(f"refined ccw x{4**levels}: {ne} cells "
          f"(prep {time.time()-t0:.1f}s)", flush=True)

    t0 = time.time()
    sim = FusedSimulation.create("ccw", inp=inp)
    print(f"build+device: {time.time()-t0:.1f}s", flush=True)

    # warmup: compile (n_windows is static -> warm with the bench shape)
    win = sim.inp.control.solver_step
    sim.advance_interval(n_win * win)
    _ = int(sim.bdf.nfe)

    best = 0.0
    for _ in range(3):
        nfe0 = int(sim.bdf.nfe)
        t0 = time.time()
        sim.advance_interval(n_win * win)
        nfe = int(sim.bdf.nfe) - nfe0  # host fetch = true sync
        wall = time.time() - t0
        rate = ne * nfe / wall
        print(f"  {nfe} NFE in {wall:.2f}s -> {rate/1e6:.1f}M cell-steps/s",
              flush=True)
        best = max(best, rate)
    print(f"BEST: {best/1e6:.1f}M cell-steps/s on {ne} real-topography cells")


if __name__ == "__main__":
    main()
