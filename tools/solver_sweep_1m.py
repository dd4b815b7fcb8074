#!/usr/bin/env python3
"""Newton/Krylov constant sweep at the 1M-cell scale under a storm pulse.

VERDICT r2 item 9: the solver constants (krylov_m=3, newton_iters=3,
newton_tol=0.5) were tuned on ccw-class meshes; this records the
krylov_m x newton_iters grid on a 1M-cell synthetic watershed driven by
a 100 mm/day storm (days 0.5-1.5) — the stiff regime where a larger
Krylov space might pay.  NFE, steps, convergence failures and wall time
per simulated day, plus trajectory deviation vs the default config.

    python tools/solver_sweep_1m.py [nx] [ny] [days]
    (default 724 724 2.0 ~ 1.05M cells, f64, on the default device)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 724
    ny = int(sys.argv[2]) if len(sys.argv) > 2 else 724
    days = float(sys.argv[3]) if len(sys.argv) > 3 else 2.0

    import shud_tpu  # noqa: F401
    from shud_tpu.driver.fused import FusedSimulation
    from shud_tpu.solver.bdf import bdf_init
    from shud_tpu.utils.synthetic import make_synthetic_project

    def run(**cfg_over):
        inp = make_synthetic_project(nx, ny, end_day=days,
                                     storm_mm_day=100.0)
        sim = FusedSimulation.create("synthetic", base=".", inp=inp)
        sim.cfg = sim.cfg._replace(**cfg_over)
        sim.bdf = bdf_init(sim.t, sim.bdf.y, sim.cfg)
        # warmup interval compiles; timed from day 0 (includes the storm).
        # 3-hour dispatches keep each device program under a minute at 1M
        # cells under the storm
        t0 = time.time()
        for _ in range(int(days * 8)):
            sim.advance_interval(180.0)
        nfe = int(sim.bdf.nfe)  # host fetch = sync
        wall = time.time() - t0
        return (np.asarray(sim.bdf.y, dtype=np.float64), nfe,
                int(sim.bdf.nsteps), int(sim.bdf.nnifails), wall)

    y0, nfe0, ns0, nf0, w0 = run()
    print(f"default (ni=3 m=3 hist): nfe={nfe0} nsteps={ns0} ncfn={nf0} "
          f"wall={w0:.0f}s", flush=True)
    for label, over in [
        ("m=5", dict(krylov_m=5)),
        ("ni=2", dict(newton_iters=2)),
        ("ni=4 m=5", dict(newton_iters=4, krylov_m=5)),
    ]:
        y, nfe, ns, nf, w = run(**over)
        d = np.abs(y - y0).max()
        print(f"{label:10s}: nfe={nfe} nsteps={ns} ncfn={nf} "
              f"wall={w:.0f}s dNFE={100*(nfe-nfe0)/nfe0:+.1f}% "
              f"dwall={100*(w-w0)/w0:+.1f}% max|dy|={d:.2e}", flush=True)


if __name__ == "__main__":
    main()
