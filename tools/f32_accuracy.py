#!/usr/bin/env python3
"""f32-vs-f64 trajectory deviation on all three reference watersheds.

BASELINE.md's correctness bar is "prognostic fields allclose to the
reference after 1000 steps"; the f64 path is oracle-pinned (tests/), so
the f32 local-datum path must be pinned against f64 on every watershed —
VERDICT r2 item 6 ("the claim that f32 meets the correctness bar on all
three watersheds is currently an extrapolation").

Runs each project in f64 and f32 for >= 1000 solver steps and prints
max |Δ| per state component.  Results are recorded in
docs/VALIDATION.md; tests/test_f32.py pins the ccw/heihe/qhh bounds in
the slow tier.

    python tools/f32_accuracy.py [days]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    days = float(args[0]) if args else 10.0
    # --sharded[=P]: run the harness through ShardedSimulation (the
    # domain-decomposed composed path) instead of the fused single-chip
    # driver — VERDICT r3 item 9.  P defaults to 8 (virtual CPU mesh via
    # tests-style XLA flags, or real chips when present).
    shard_p = 0
    for a in sys.argv[1:]:
        if a.startswith("--sharded"):
            shard_p = int(a.split("=", 1)[1]) if "=" in a else 8

    import jax.numpy as jnp
    import numpy as np

    from shud_tpu.driver.fused import FusedSimulation

    projects = os.environ.get("SHUD_F32_PROJECTS", "ccw,heihe,qhh").split(",")
    for project in projects:
        ys = {}
        meta = {}
        for fd in (jnp.float64, jnp.float32):
            t0 = time.time()
            if shard_p:
                from shud_tpu.core.mesh import build_mesh
                from shud_tpu.io.project import load_project
                from shud_tpu.parallel.runtime import ShardedSimulation

                inp = load_project(project, base="/root/reference")
                inp.control.day_end = days + 1.0
                md = build_mesh(inp)
                ssim = ShardedSimulation(inp, md, shard_p, float_dtype=fd)
                ssim.run(days * 1440.0)
                y = np.asarray(ssim.y_full(), dtype=np.float64)
                ys[fd] = y
                meta[fd] = (int(ssim.state.nsteps), int(ssim.state.nfe),
                            time.time() - t0, False)

                class _S:  # minimal attrs for the shared reporting below
                    pass

                sim = _S()
                sim.md = md
                continue
            sim = FusedSimulation.create(project, base="/root/reference",
                                         float_dtype=fd, day_end=days + 1.0)
            nd = int(days)
            for _ in range(nd):
                sim.advance_interval(1440.0)
            y = np.asarray(sim.bdf.y, dtype=np.float64)
            ys[fd] = y
            meta[fd] = (int(sim.bdf.nsteps), int(sim.bdf.nfe),
                        time.time() - t0)
        ne, nr = sim.md.num_ele, sim.md.num_riv
        nl = sim.md.num_lake
        d = np.abs(ys[jnp.float64] - ys[jnp.float32])
        parts = {
            "surf": d[:ne].max(), "unsat": d[ne:2 * ne].max(),
            "gw": d[2 * ne:3 * ne].max(),
            "riv": d[3 * ne:3 * ne + nr].max(),
        }
        if nl:
            parts["lake"] = d[3 * ne + nr:].max()
        ns64, nfe64, w64 = meta[jnp.float64]
        ns32, nfe32, w32 = meta[jnp.float32]
        tag = f"{project}[sharded P={shard_p}]" if shard_p else project
        print(f"{tag}: {days:.0f} days | f64 nsteps={ns64} nfe={nfe64} "
              f"wall={w64:.0f}s | f32 nsteps={ns32} nfe={nfe32} "
              f"wall={w32:.0f}s | " +
              " ".join(f"max|d{k}|={v:.2e}" for k, v in parts.items()),
              flush=True)


if __name__ == "__main__":
    main()
