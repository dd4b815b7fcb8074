#!/usr/bin/env python3
"""Benchmark: fused-driver throughput on the seeded ccw-scale basin, on a GPU.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": "wall_s_per_day_ccw_scale", "value": S, "unit": "s/day",
   "cell_steps_per_s": N, "repeats": [...], "device": {...}}

The basin is chip_smoke.py's P1 basin (1,152 cells with a lake, shuffled
and RCM-renumbered, made from a seed), solved in f64.  Wall per simulated
day is the headline; cell-steps/s = NumEle x NFE / wall is a layer figure
beside it.  The first day (compile) is set-up and is not timed.  Refuses
to run without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_DAYS = 20  # simulated days per timed repeat (after 1 warm-up day)
REPEATS = 5


def main():
    import jax

    from chip_smoke import card_line, require_gpu, seeded_basin
    from shud_tpu.driver.fused import FusedSimulation

    kind = require_gpu(jax.devices())
    print(f"nvidia-smi: {card_line()}", flush=True)

    inp = seeded_basin(24, 24, with_lake=True, end_day=N_DAYS * REPEATS + 1)
    sim = FusedSimulation.create("synthetic", inp=inp)
    ne = sim.md.num_ele
    t0 = time.perf_counter()
    sim.advance_interval(1440.0)
    jax.block_until_ready(sim.bdf.y)
    setup = time.perf_counter() - t0

    per_day, rates = [], []
    for _ in range(REPEATS):
        nfe0 = int(sim.bdf.nfe)
        t0 = time.perf_counter()
        for _ in range(N_DAYS):
            sim.advance_interval(1440.0)
        jax.block_until_ready(sim.bdf.y)
        wall = time.perf_counter() - t0
        per_day.append(wall / N_DAYS)
        rates.append(ne * (int(sim.bdf.nfe) - nfe0) / wall)
    print(json.dumps({
        "metric": "wall_s_per_day_ccw_scale",
        "value": min(per_day),
        "unit": "s/day",
        "repeats": per_day,
        "cell_steps_per_s": rates,
        "setup_s": setup,
        "device": {"platform": jax.devices()[0].platform, "kind": kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
