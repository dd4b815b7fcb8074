#!/usr/bin/env python3
"""Weak-scaling harness for the domain-decomposed solver.

Runs one solver window on a synthetic watershed with a FIXED per-device
cell count while the device count grows, and reports per-window wall time +
the halo/communication sizes.  On real multi-chip hardware this measures
weak-scaling efficiency (BASELINE target >= 80% 1 -> N devices) over the
devices JAX reports; with virtual CPU devices the absolute times are
meaningless but the harness, shardings and collectives are exactly what
would run on several cards.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/bench_scaling.py [cells_per_device]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    cells_per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 8192

    import jax

    import shud_tpu  # noqa: F401
    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.driver.init import initial_state
    from shud_tpu.parallel.partition import build_sharded_mesh, shard_state
    from shud_tpu.parallel.runtime import sharded_window_step
    from shud_tpu.utils.synthetic import make_synthetic_project

    ndev = len(jax.devices())
    results = []
    p = 1
    while p <= ndev:
        # nx*ny*2 cells total; scale nx with p for fixed per-device load
        ny = max(int(np.sqrt(cells_per_dev / 2)), 2)
        nx = max(cells_per_dev * p // (2 * ny), p)
        inp = make_synthetic_project(nx, ny)
        md = build_mesh(inp)
        sm = build_sharded_mesh(md, p)
        y0 = initial_state(inp, md)
        ys = shard_state(sm, y0)
        t0 = time.time()
        st = sharded_window_step(inp, md, sm, ys, t0=0.0, tout=10.0)
        jax.block_until_ready(st.y)
        compile_s = time.time() - t0
        t0 = time.time()
        st = sharded_window_step(inp, md, sm, ys, t0=0.0, tout=10.0)
        jax.block_until_ready(st.y)
        wall = time.time() - t0
        plan = sm.plan
        ppm = plan.bytes_per_eval()
        agb = plan.allgather_bytes_per_eval(p)
        results.append((p, md.num_ele, ppm, wall, int(st.nfe)))
        print(
            f"P={p:3d}  cells={md.num_ele:9d}  rounds={plan.k:2d}"
            f"  halo {ppm/1024:8.1f} KiB/dev/eval"
            f"  (all_gather design: {agb/1024:8.1f} KiB,"
            f" {agb/max(ppm,1):5.1f}x)"
            f"  window={wall*1e3:8.1f} ms  nfe={int(st.nfe)}"
            f"  (compile {compile_s:.1f}s)",
            flush=True,
        )
        p *= 2
    if len(results) > 1:
        base = results[0][3] / results[0][4]
        last = results[-1][3] / results[-1][4]
        print(f"weak-scaling time-per-nfe ratio P={results[-1][0]} vs P=1: "
              f"{base/last:.2f} (1.0 = perfect)")
        print("comm-volume model: ppermute halo payload is O(edge-cut) per "
              "device (constant under weak scaling); the all_gather column "
              "grows O(P).")


if __name__ == "__main__":
    main()
