#!/usr/bin/env python3
"""Two-process `jax.distributed` dryrun of the sharded solver — window
mode AND full-driver mode.

VERDICT r3 item 5: `init_distributed` (parallel/runtime.py) had never been
executed.  This tool runs the REAL multi-host code path on this one-box
image: a coordinator + 2 CPU processes, each exposing 4 virtual devices
(8 global), the RCB partition built over the GLOBAL device count, the
`shard_map` RHS with its cross-process `ppermute` halo rounds, and one
full adaptive solver window.  The window-end state's global checksum is
compared against a single-process 8-virtual-device run of the identical
window (must agree to reduction-order round-off).

VERDICT r4 item 1 (`--driver`): the same 2-process topology runs
`run_project_sharded` END-TO-END — every rank executes the production
driver, the per-interval fetch all-gathers via `device_get_global`, and
only rank 0 writes files.  The resulting output DIRECTORY is compared
file-by-file against a single-process P=8 run of the identical project
(reference contract: identical outputs under the parallel mode,
shud.cpp:91-155 + Model_Control.cpp:930-962).  No parent-precomputed
side channels: each rank builds its own forcing windows on device.

Usage:
    python tools/dryrun_distributed.py            # window-checksum mode
    python tools/dryrun_distributed.py --driver   # full-driver mode
    (internal) SHUD_DR_RANK=k ... dryrun_distributed.py --rank [--driver]

Exit 0 + "DISTRIBUTED DRYRUN OK" / "DISTRIBUTED DRIVER DRYRUN OK".
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = int(os.environ.get("SHUD_DR_PORT", "8476"))
NPROC = 2
LOCAL_DEV = 4


def build_problem():
    import numpy as np

    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.utils.synthetic import make_synthetic_project

    inp = make_synthetic_project(16, 8, end_day=1.0)
    md = build_mesh(inp)
    rng = np.random.default_rng(7)
    ne, nr = md.num_ele, md.num_riv
    y = np.concatenate([
        rng.uniform(0, 0.02, ne), rng.uniform(0, 0.5, ne),
        rng.uniform(0, 8.0, ne), rng.uniform(0, 1.0, nr),
    ])
    return inp, md, y


def forcing_blocks_file(inp, md, p):
    """Host-side forcing blocks, precomputed by the PARENT process: the
    host prep path runs jitted transforms, and in a multi-process context
    jit outputs span all global devices (unfetchable per process) — the
    children only exercise the solver-window collectives."""
    import numpy as np

    from shud_tpu.core.device import to_device
    from shud_tpu.driver.forcing import build_forcing
    from shud_tpu.parallel.partition import build_sharded_mesh
    from shud_tpu.parallel.runtime import compute_forcing_blocks

    sm = build_sharded_mesh(md, p)
    fr = build_forcing(inp, md)
    dm = to_device(md)
    fs_cell, fs_riv, _, _ = compute_forcing_blocks(
        inp, md, sm, 0.0, 10.0, fr=fr, dm=dm)
    out = {f"c/{k}": np.asarray(v) for k, v in fs_cell.items()}
    out.update({f"r/{k}": np.asarray(v) for k, v in fs_riv.items()})
    np.savez("/tmp/shud_dr_fs.npz", **out)


def run_window(inp, md, y, p):
    """One sharded adaptive solver window; returns the end-state checksum."""
    import jax
    import jax.numpy as jnp

    from shud_tpu.parallel.partition import build_sharded_mesh, shard_state
    from shud_tpu.parallel.sharded import AXIS, make_sharded_rhs
    from shud_tpu.solver.bdf import SolverConfig, bdf_init, solve_to
    from jax.sharding import NamedSharding, PartitionSpec as P

    import numpy as np

    sm = build_sharded_mesh(md, p)
    mesh, rhs_fn, params = make_sharded_rhs(sm)
    cell_sh = NamedSharding(mesh, P(AXIS))
    rep_sh = NamedSharding(mesh, P())

    # multi-process-safe placement: device_put of a host array onto a
    # sharding that spans non-addressable devices is illegal; build the
    # jax.Array from per-shard callbacks instead (every process holds the
    # full host copy, so the callback just slices it)
    def put(v, sh):
        v = np.asarray(v)
        return jax.make_array_from_callback(
            v.shape, sh, lambda idx: v[idx])

    z = np.load("/tmp/shud_dr_fs.npz")
    fs_cell = {k[2:]: put(z[k], cell_sh) for k in z.files
               if k.startswith("c/")}
    fs_riv = {k[2:]: put(z[k], cell_sh) for k in z.files
              if k.startswith("r/")}

    from shud_tpu.parallel.sharded import _SHARDED_LAKE_KEYS

    cell, edge, seg, riv, halo, lake = params

    def put_tree(tree):
        return {k: put(v, cell_sh) for k, v in tree.items()}

    params_dev = (put_tree(cell), put_tree(edge), put_tree(seg),
                  put_tree(riv), put_tree(halo),
                  {k: put(v, cell_sh if k in _SHARDED_LAKE_KEYS else rep_sh)
                   for k, v in lake.items()})

    ys = shard_state(sm, y)
    y_dev = {
        "sf": put(ys["sf"], cell_sh), "us": put(ys["us"], cell_sh),
        "gw": put(ys["gw"], cell_sh), "riv": put(ys["riv"], cell_sh),
        "lake": put(ys["lake"], rep_sh),
    }
    cfg = SolverConfig(rtol=1e-3, atol=1e-4, h_init=0.01, h_max=10.0)
    st = bdf_init(0.0, y_dev, cfg)
    st = solve_to(rhs_fn, st, 10.0, params_dev + (fs_cell, fs_riv), cfg)

    @jax.jit
    def checksum(yt):
        return sum(jnp.sum(v) for v in yt.values()), yt["gw"].max()

    s, mx = checksum(st.y)
    return float(s), float(mx), int(st.nfe), sm.plan.k


def build_driver_project():
    """Full-driver mode fixture: a lake-bearing synthetic watershed with
    every output channel on a 360-min interval (the test_sharded_driver
    twin, plus a lake for the replicated-lake collectives)."""
    import dataclasses

    from shud_tpu.utils.synthetic import make_synthetic_project

    inp = make_synthetic_project(16, 8, end_day=0.25, with_lake=True)
    cs = inp.control
    for f in dataclasses.fields(cs):
        if f.name.startswith("dt_") and getattr(cs, f.name):
            setattr(cs, f.name, 360)
    cs.dt_ye_surf = cs.dt_ye_unsat = cs.dt_ye_gw = 360
    cs.dt_qe_et = cs.dt_qe_etp = cs.dt_qe_eta = 360
    cs.dt_Qr_down = cs.dt_yr_stage = cs.dt_Qe_sub = 360
    cs.dt_lake = 360
    cs.update_ic_step = 360
    return inp


def run_driver(outdir: str, verbose: bool):
    """`run_project_sharded` end-to-end over whatever device topology the
    calling process sees (P = 8 global in both layouts).  SHUD_WB_DIAG=1
    exercises the quadrature collectives too."""
    os.environ["SHUD_WB_DIAG"] = "1"
    from shud_tpu.parallel.runtime import run_project_sharded

    run_project_sharded("synthetic", inp=build_driver_project(), p=8,
                        outpath=outdir, verbose=verbose)


def compare_driver_dirs(sp_dir: str, mp_dir: str):
    """The multi-process run's output directory must match the
    single-process one: identical file sets, byte-identical .dat
    headers/timestamps, payloads at reduction-order round-off."""
    import numpy as np

    from shud_tpu.io.output import read_dat

    sp = sorted(os.listdir(sp_dir))
    mp = sorted(os.listdir(mp_dir))
    assert sp == mp, f"file sets differ:\n sp={sp}\n mp={mp}"
    worst = ("", 0.0)
    for fn in sp:
        if fn.endswith(".dat"):
            s0, c0, t0, d0 = read_dat(os.path.join(sp_dir, fn))
            s1, c1, t1, d1 = read_dat(os.path.join(mp_dir, fn))
            assert s0 == s1 and (c0 == c1).all() and (t0 == t1).all(), fn
            scale = max(1.0, np.abs(d0).max())
            err = np.abs(d0 - d1).max() / scale
            worst = max(worst, (fn, err), key=lambda x: x[1])
            assert err < 1e-9, f"{fn}: rel maxabs {err:.3e}"
        elif fn.endswith("wb.basin.csv") or fn.endswith("flood.csv"):
            with open(os.path.join(sp_dir, fn)) as f:
                n0 = len(f.readlines())
            with open(os.path.join(mp_dir, fn)) as f:
                n1 = len(f.readlines())
            assert n0 == n1, f"{fn}: {n0} vs {n1} rows"
        elif fn.endswith(".cfg.ic.update"):
            with open(os.path.join(sp_dir, fn)) as f:
                a = f.read()
            with open(os.path.join(mp_dir, fn)) as f:
                b = f.read()
            assert a == b, f"{fn}: restart text differs"
    print(f"driver outputs match ({len(sp)} files); worst .dat: "
          f"{worst[0]} rel {worst[1]:.2e}")


def child(rank: int):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEV}"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from shud_tpu.parallel.runtime import init_distributed

    pid, ndev = init_distributed(coordinator=f"localhost:{PORT}",
                                 num_processes=NPROC, process_id=rank)
    assert ndev == NPROC * LOCAL_DEV, f"global devices {ndev}"
    assert len(jax.local_devices()) == LOCAL_DEV
    if "--driver" in sys.argv:
        run_driver("/tmp/shud_dr_drv_mp", verbose=(rank == 0))
        print(f"[rank {pid}] driver run complete", flush=True)
        return
    inp, md, y = build_problem()
    s, mx, nfe, rounds = run_window(inp, md, y, p=ndev)
    print(f"[rank {pid}] checksum={s:.12e} gw_max={mx:.6f} nfe={nfe} "
          f"halo_rounds={rounds}", flush=True)
    if rank == 0:
        with open("/tmp/shud_dr_rank0.txt", "w") as f:
            f.write(f"{s:.17e} {nfe}\n")


def single_process_reference():
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={NPROC * LOCAL_DEV}"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if "--driver" in sys.argv:
        run_driver("/tmp/shud_dr_drv_sp", verbose=False)
        print("[single-proc ref] driver run complete", flush=True)
        return
    inp, md, y = build_problem()
    forcing_blocks_file(inp, md, NPROC * LOCAL_DEV)
    s, mx, nfe, rounds = run_window(inp, md, y, p=NPROC * LOCAL_DEV)
    print(f"[single-proc ref] checksum={s:.12e} nfe={nfe}", flush=True)
    with open("/tmp/shud_dr_ref.txt", "w") as f:
        f.write(f"{s:.17e} {nfe}\n")


if __name__ == "__main__":
    driver_mode = "--driver" in sys.argv
    if "--rank" in sys.argv:
        child(int(os.environ["SHUD_DR_RANK"]))
    elif "--ref" in sys.argv:
        single_process_reference()
    else:
        # parent: single-process reference first, then the 2-process run
        import shutil

        if driver_mode:
            for d in ("/tmp/shud_dr_drv_sp", "/tmp/shud_dr_drv_mp"):
                shutil.rmtree(d, ignore_errors=True)
        extra = ["--driver"] if driver_mode else []
        env = dict(os.environ)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--ref"] + extra, env=env, cwd=REPO)
        assert r.returncode == 0, "single-process reference failed"
        procs = []
        logs = []
        for k in range(NPROC):
            e = dict(os.environ, SHUD_DR_RANK=str(k))
            lf = open(f"/tmp/shud_dr_rank{k}.log", "w")
            logs.append(lf)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank"]
                + extra,
                env=e, cwd=REPO, stdout=lf, stderr=subprocess.STDOUT))
        rcs = [q.wait(timeout=1800) for q in procs]
        for lf in logs:
            lf.close()
        for k in range(NPROC):
            with open(f"/tmp/shud_dr_rank{k}.log") as f:
                tail = f.read().splitlines()[-12:]
            print(f"--- rank {k} log tail ---")
            print("\n".join(tail))
        assert all(rc == 0 for rc in rcs), f"child exit codes {rcs}"
        if driver_mode:
            compare_driver_dirs("/tmp/shud_dr_drv_sp", "/tmp/shud_dr_drv_mp")
            print("DISTRIBUTED DRIVER DRYRUN OK")
            sys.exit(0)
        with open("/tmp/shud_dr_rank0.txt") as f:
            s_mp, nfe_mp = f.read().split()
        with open("/tmp/shud_dr_ref.txt") as f:
            s_sp, nfe_sp = f.read().split()
        ds = abs(float(s_mp) - float(s_sp))
        rel = ds / max(1.0, abs(float(s_sp)))
        print(f"2-proc vs 1-proc checksum delta: {ds:.3e} (rel {rel:.3e}); "
              f"nfe {nfe_mp} vs {nfe_sp}")
        assert rel < 1e-9, "distributed window diverged from single-process"
        assert nfe_mp == nfe_sp, "NFE mismatch across process layouts"
        print("DISTRIBUTED DRYRUN OK")
