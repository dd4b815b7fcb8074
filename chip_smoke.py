#!/usr/bin/env python3
"""On-card smoke test of the production drivers.

    python chip_smoke.py              # one GPU: phases P0-P4
    python chip_smoke.py --cards 4    # four GPUs: the sharded driver and
                                      # what it is compared with, only

P0  device gate: a GPU or nothing (no CPU fallback); card name and power
    limit from nvidia-smi.
P1  seeded ccw-scale basin (24x24 quads + lake = 1,152 cells, shuffled,
    then RCM-renumbered) through ``run_project_fast`` for 3 days with every
    output channel on, in f64 and f32.
P2  seeded continental-scale unstructured mesh (724x724 quads = 1,048,352
    cells, shuffled, then RCM-renumbered), one day in f64 and f32 at 6-h
    output intervals.
P3  plain-path timing: one RHS evaluation and one J·v per call at both
    meshes and precisions, with the compulsory bytes per cell per
    evaluation and the share of the card's HBM peak.
P4  correctness on the card against the f64 XLA path on this process's
    CPU backend: RHS and J·v, the P1 one-day trajectory, f32 against f64,
    and whether two f64 runs are bitwise equal.

Every check prints its value beside its bound; any failure exits nonzero
and suppresses the result line.  The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Phases are functions of their sizes, so the tests run them on the CPU at a
tiny size; only ``main()`` insists on a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "output", "chip_smoke")

# Published HBM bandwidth per device kind, bytes/s.  A kind that is not
# listed is an error, never a default.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": (3.35e12, "NVIDIA H100 SXM5 data sheet"),
}

# quads per side: P1 is 2*24*24 = 1,152 cells (with a lake), P2 is
# 2*724*724 = 1,048,352 cells
P1_GRID = (24, 24)
P2_GRID = (724, 724)

# f32-vs-f64 bounds per state class [m] (docs/VALIDATION.md "f32 accuracy")
F32_BOUNDS = {"surf": 0.05, "unsat": 0.05, "gw": 0.05, "riv": 1e-3,
              "lake": 0.01}
# GPU-vs-CPU f64 one-day trajectory bound [m]: ten times the basin's
# rtol/atol of 1e-4
TRAJ_BOUND = 1e-3
# RHS / J·v: GPU f64 against CPU f64, relative to max|dY| (reduction order)
RHS_REL_BOUND = 1e-9


class Checks:
    """Collects (name, value, bound) rows; a row over its bound fails the
    run after every row has been printed."""

    def __init__(self):
        self.failed = []

    def check(self, name, value, bound):
        ok = bool(value <= bound)
        print(f"  [{'ok' if ok else 'FAIL'}] {name}: {value!r} "
              f"(bound {bound!r})", flush=True)
        if not ok:
            self.failed.append(name)


def require_gpu(devices) -> str:
    """The device kind of ``devices[0]``; raises unless it is a GPU."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise RuntimeError(f"chip_smoke needs a GPU; JAX's first device is "
                           f"{plat}")
    return devices[0].device_kind


def card_line() -> str:
    """``nvidia-smi`` name and power limit, read without touching JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip()


def hbm_peak(kind: str) -> "tuple[float, str]":
    if kind not in HBM_PEAK:
        raise KeyError(f"no HBM peak recorded for device kind {kind!r}")
    return HBM_PEAK[kind]


# ---------------------------------------------------------------- basins

def seeded_basin(nx: int, ny: int, seed: int = 0, with_lake: bool = False,
                 end_day: float = 3.0, interval: int = 1440,
                 outdir: str = OUT):
    """Synthetic watershed of 2*nx*ny cells, shuffled by a seeded
    permutation and then RCM-renumbered (the structure of a real
    unstructured mesh: generic neighbour gathers, no roll shortcut), with
    every output channel at *interval* minutes, reading and writing only
    under *outdir*."""
    from shud_tpu.io.project import FilePaths
    from shud_tpu.utils.reorder import localize_project, permute_project
    from shud_tpu.utils.synthetic import make_synthetic_project

    inp = make_synthetic_project(nx, ny, end_day=end_day, seed=seed,
                                 with_lake=with_lake)
    ne = inp.tri.shape[0]
    inp = permute_project(inp, np.random.default_rng(seed).permutation(ne))
    inp, _ = localize_project(inp)
    inp.paths = FilePaths(project="synthetic", inpath=outdir, outpath=outdir)
    cs = inp.control
    for name in vars(cs):
        if name.startswith("dt_"):
            setattr(cs, name, interval)
    return inp


def state_classes(md) -> dict:
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    parts = {"surf": slice(0, ne), "unsat": slice(ne, 2 * ne),
             "gw": slice(2 * ne, 3 * ne), "riv": slice(3 * ne, 3 * ne + nr)}
    if nl:
        parts["lake"] = slice(3 * ne + nr, 3 * ne + nr + nl)
    return parts


def class_maxdiff(md, a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {k: float(d[s].max()) for k, s in state_classes(md).items()}


def seeded_forcing(md, seed: int, dtype):
    """A plausible forcing slice (rain, PET, canopy and LAI) from a seed."""
    import jax.numpy as jnp

    from shud_tpu.core.state import ForcingSlice

    rng = np.random.default_rng(seed)
    ne, nr = md.num_ele, md.num_riv
    vals = dict(
        net_prcp=rng.uniform(0, 2e-5, ne), prcp=rng.uniform(0, 2e-5, ne),
        pot_evap=rng.uniform(0, 3e-6, ne), pot_tran=rng.uniform(0, 3e-6, ne),
        e_ic=rng.uniform(0, 2e-6, ne), lai=rng.uniform(0, 4, ne),
        fu_surf=np.ones(ne), fu_sub=np.ones(ne),
        ele_ybc=np.zeros(ne), ele_qbc=np.zeros(ne), ele_qss=np.zeros(ne),
        riv_ybc=np.zeros(nr), riv_qbc=np.zeros(nr),
    )
    return ForcingSlice(**{k: jnp.asarray(v, dtype) for k, v in vals.items()})


def peak_bytes(device) -> "int | None":
    stats = device.memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


def _time_log(path):
    """(t_min, cumulative wall seconds) rows of a run's prj.time.csv."""
    rows = np.atleast_2d(np.loadtxt(path, skiprows=1))
    return rows[:, 0], rows[:, 4]


def run_basin(inp, label: str, float_dtype, outdir: str) -> dict:
    """One ``run_project_fast`` call (full output stack) with its set-up
    time, warm wall per simulated day, solver counters, daily water
    balance and peak device memory.  The driver fetches every interval's
    results to the host, so each logged wall time is after the device
    finished."""
    import jax

    from shud_tpu.driver.run_fast import run_project_fast

    t0 = time.perf_counter()
    sim = run_project_fast("synthetic", inp=inp, float_dtype=float_dtype,
                           verbose=False, outpath=outdir)
    total = time.perf_counter() - t0
    t_min, wall = _time_log(os.path.join(outdir, "synthetic.time.csv"))
    days = (t_min[-1] - sim.inp.control.start_time) / 1440.0
    warm_per_day = ((wall[-1] - wall[0]) / ((t_min[-1] - t_min[0]) / 1440.0)
                    if len(t_min) > 1 else float("nan"))
    wb = np.genfromtxt(os.path.join(outdir, "synthetic.wb.basin.csv"),
                       delimiter=",", names=True)
    b = sim.bdf
    res = dict(
        sim=sim, y=np.asarray(b.y), days=days,
        setup_s=float(total - (wall[-1] - wall[0])),
        warm_s_per_day=float(warm_per_day),
        nsteps=int(b.nsteps), nfe=int(b.nfe), netf=int(b.nfails),
        ncfn=int(b.nnifails),
        residual_relative=np.atleast_1d(wb["residual_rel"]).tolist(),
        peak_bytes=peak_bytes(jax.devices()[0]),
    )
    print(f"  {label}: {sim.md.num_ele} cells, {days:g} days; set-up "
          f"(build + compile + first interval) {res['setup_s']!r} s; warm "
          f"{res['warm_s_per_day']!r} s per simulated day (log resolution "
          f"10 ms); nsteps={res['nsteps']} nfe={res['nfe']} "
          f"netf={res['netf']} ncfn={res['ncfn']}; water-balance "
          f"residual_relative per interval {res['residual_relative']}; "
          f"peak_bytes_in_use={res['peak_bytes']}", flush=True)
    return res


def phase_basins(nx, ny, with_lake, days, interval, label, outdir=OUT):
    """P1/P2: the basin in f64 and in f32; returns both results."""
    import jax.numpy as jnp

    out = {}
    for fd, tag in ((jnp.float64, "f64"), (jnp.float32, "f32")):
        inp = seeded_basin(nx, ny, with_lake=with_lake, end_day=days,
                           interval=interval, outdir=outdir)
        d = os.path.join(outdir, f"{label}_{tag}")
        out[tag] = run_basin(inp, f"{label} {tag}", fd, d)
    return out


# ------------------------------------------------------------ P3 timing

def streamed_bytes(fn, *args) -> int:
    """Compulsory bytes of one call of *fn*: every input or captured array
    the traced program uses, read once, plus every output, written once."""
    closed = __import__("jax").make_jaxpr(fn)(*args)
    jaxpr = closed.jaxpr
    used = {v for e in jaxpr.eqns for v in e.invars
            if type(v).__name__ == "Var"}
    used |= {v for v in jaxpr.outvars if type(v).__name__ == "Var"}

    def nbytes(v):
        return int(np.prod(v.aval.shape)) * v.aval.dtype.itemsize

    ins = sum(nbytes(v) for v in jaxpr.invars + jaxpr.constvars if v in used)
    return ins + sum(nbytes(v) for v in jaxpr.outvars)


def bytes_per_cell_per_eval(md, dm, fs, y, close_boundary: bool) -> dict:
    """Compulsory bytes per cell of one RHS evaluation and of one J·v
    (the tangent program alone: its linearisation residuals, v and J·v)."""
    import jax

    from shud_tpu.core.rhs import rhs

    def f(dm_, fs_, y_):
        return rhs(dm_, fs_, 0.0, y_, close_boundary=close_boundary)

    _, jvp = jax.linearize(lambda yy: f(dm, fs, yy), y)
    return {"rhs": streamed_bytes(f, dm, fs, y) / md.num_ele,
            "jv": streamed_bytes(jvp, y) / md.num_ele}


def _chains(close_boundary: bool):
    """Jitted chains of data-dependent evaluations with a traced trip
    count (one compile serves every length)."""
    import jax
    from jax import lax

    from shud_tpu.core.rhs import rhs

    def f(dm, fs, y):
        return rhs(dm, fs, 0.0, y, close_boundary=close_boundary)

    @jax.jit
    def chain_rhs(dm, fs, y, n):
        return lax.fori_loop(0, n, lambda i, yy: yy + 1e-30 * f(dm, fs, yy),
                             y)

    @jax.jit
    def chain_jv(dm, fs, y, v, n):
        _, jvp = jax.linearize(lambda yy: f(dm, fs, yy), y)
        return lax.fori_loop(0, n, lambda i, vv: vv + 1e-30 * jvp(vv), v)

    return chain_rhs, chain_jv


def _per_call(run, n: int, repeats: int = 3) -> float:
    """Seconds per evaluation: (T(2n) - T(n)) / n, best of *repeats*,
    which cancels the fixed launch and linearisation cost."""
    import jax

    jax.block_until_ready(run(1))  # compile
    best = {}
    for k in (n, 2 * n):
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run(k))
            ts.append(time.perf_counter() - t0)
        best[k] = min(ts)
    return (best[2 * n] - best[n]) / n


def copy_rate(n_bytes: int = 1 << 30) -> float:
    """Bytes/s of a large plain float32 read-and-write on the default
    device (the practical ceiling the P3 shares compare with)."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones(n_bytes // 4, jnp.float32)
    f = jax.jit(lambda a: a * 1.0001)
    jax.block_until_ready(f(x))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        ts.append(time.perf_counter() - t0)
    return 2 * x.nbytes / min(ts)


def phase_plain_timing(inp, y, label, float_dtype, peak=None) -> dict:
    """P3 at one mesh and precision: seconds per RHS and per J·v, bytes per
    cell per evaluation, and (with *peak*, bytes/s) the HBM roofline share
    (compulsory bytes / peak / time)."""
    import jax.numpy as jnp

    from shud_tpu.core.device import to_device
    from shud_tpu.core.mesh import build_mesh

    md = build_mesh(inp)
    dm = to_device(md, float_dtype)
    fs = seeded_forcing(md, 1, float_dtype)
    yd = jnp.asarray(y, float_dtype)
    v = jnp.asarray(np.random.default_rng(2).standard_normal(yd.shape),
                    float_dtype)
    cb = bool(inp.control.close_boundary)
    chain_rhs, chain_jv = _chains(cb)
    n = int(max(50, min(2000, 2e8 // md.num_ele)))
    t_rhs = _per_call(lambda k: chain_rhs(dm, fs, yd, k), n)
    t_jv = _per_call(lambda k: chain_jv(dm, fs, yd, v, k), n)
    bpc = bytes_per_cell_per_eval(md, dm, fs, yd, cb)
    out = {"rhs_s": t_rhs, "jv_s": t_jv, "bytes_per_cell_per_eval": bpc}
    line = (f"  {label} {jnp.dtype(float_dtype).name}: {md.num_ele} cells; "
            f"RHS {t_rhs * 1e3!r} ms/eval, J·v {t_jv * 1e3!r} ms/eval; "
            f"bytes_per_cell_per_eval rhs={bpc['rhs']!r} jv={bpc['jv']!r}")
    if peak is not None:
        out["rhs_share"] = bpc["rhs"] * md.num_ele / peak / t_rhs
        out["jv_share"] = bpc["jv"] * md.num_ele / peak / t_jv
        line += (f"; HBM roofline share rhs={out['rhs_share']!r} "
                 f"jv={out['jv_share']!r}")
    print(line, flush=True)
    return out


# ------------------------------------------------------- P4 correctness

def rhs_jv_pair(inp, y, device, seed: int = 3):
    """f64 RHS and J·v at state *y* on *device* (host arrays)."""
    import jax
    import jax.numpy as jnp

    from shud_tpu.core.device import to_device
    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.core.rhs import rhs

    md = build_mesh(inp)
    cb = bool(inp.control.close_boundary)
    with jax.default_device(device):
        dm = to_device(md, jnp.float64)
        fs = seeded_forcing(md, seed, jnp.float64)
        yd = jnp.asarray(y, jnp.float64)
        v = jnp.asarray(np.random.default_rng(seed).standard_normal(
            yd.shape))

        @jax.jit
        def both(dm_, fs_, y_, v_):
            return jax.jvp(lambda yy: rhs(dm_, fs_, 0.0, yy,
                                          close_boundary=cb), (y_,), (v_,))

        dy, jv = both(dm, fs, yd, v)
        return np.asarray(dy), np.asarray(jv)


def check_rhs_jv(checks: Checks, inp, y, label, gpu, cpu):
    """RHS and J·v, GPU f64 against CPU f64, relative to max|dY|."""
    dy_g, jv_g = rhs_jv_pair(inp, y, gpu)
    dy_c, jv_c = rhs_jv_pair(inp, y, cpu)
    for name, a, b in (("RHS", dy_g, dy_c), ("J·v", jv_g, jv_c)):
        scale = float(np.abs(b).max()) or 1.0
        checks.check(f"{label} {name} device vs CPU f64 max|d|/max|ref|",
                     float(np.abs(a - b).max()) / scale, RHS_REL_BOUND)


def one_day_state(inp, device) -> "tuple[np.ndarray, int]":
    """The f64 state after one simulated day on *device* (fused driver)."""
    import jax
    import jax.numpy as jnp

    from shud_tpu.driver.fused import FusedSimulation

    with jax.default_device(device):
        sim = FusedSimulation.create("synthetic", inp=inp,
                                     float_dtype=jnp.float64)
        sim.advance_interval(1440.0)
        return np.asarray(sim.bdf.y), int(sim.bdf.nfe)


def check_trajectory(checks: Checks, make_inp, gpu, cpu) -> bool:
    """P1 one-day trajectory, GPU f64 against CPU f64, per state class;
    returns whether two GPU runs were bitwise equal (printed, not
    checked: sums may lower to atomics on the GPU)."""
    from shud_tpu.core.mesh import build_mesh

    md = build_mesh(make_inp())
    y_g, nfe_g = one_day_state(make_inp(), gpu)
    y_g2, nfe_g2 = one_day_state(make_inp(), gpu)
    y_c, nfe_c = one_day_state(make_inp(), cpu)
    for k, v in class_maxdiff(md, y_g, y_c).items():
        checks.check(f"P1 one-day f64 device vs CPU max|d{k}| [m]", v,
                     TRAJ_BOUND)
    same = bool(np.array_equal(y_g, y_g2))
    print(f"  P1 one-day nfe: device {nfe_g}, device again {nfe_g2}, CPU "
          f"{nfe_c}; two device f64 runs bitwise equal: {same} "
          f"(max|d| {float(np.abs(y_g - y_g2).max())!r})", flush=True)
    return same


def check_f32(checks: Checks, label, md, y64, y32, report_only=None):
    """f32 against f64 per state class; classes in *report_only* (name ->
    reason) are printed beside the reason instead of checked."""
    report_only = report_only or {}
    for k, v in class_maxdiff(md, y64, y32).items():
        name = f"{label} f32 vs f64 max|d{k}| [m]"
        if k in report_only:
            print(f"  [info] {name}: {v!r} (bound {F32_BOUNDS[k]!r} not "
                  f"applied: {report_only[k]})", flush=True)
        else:
            checks.check(name, v, F32_BOUNDS[k])


def tight_pair(make_inp, tol: float, days: float = 1.0,
               interval: float = 360.0) -> dict:
    """The basin solved in f64 and f32 at rtol = atol = *tol* (no output
    stack), so that the solver's own tolerance error sits far below the
    f32 bounds and the f32-vs-f64 gap measures f32 alone."""
    import jax.numpy as jnp

    from shud_tpu.driver.fused import FusedSimulation

    out = {}
    for fd, tag in ((jnp.float64, "f64"), (jnp.float32, "f32")):
        inp = make_inp()
        inp.control.reltol = inp.control.abstol = tol
        sim = FusedSimulation.create("synthetic", inp=inp, float_dtype=fd)
        for _ in range(int(round(days * 1440.0 / interval))):
            sim.advance_interval(interval)
        out[tag] = np.asarray(sim.bdf.y)
        print(f"  rtol=atol={tol:g} {tag}: nsteps={int(sim.bdf.nsteps)} "
              f"nfe={int(sim.bdf.nfe)}", flush=True)
    return out


def checksums(label, md, y):
    sums = {k: float(np.asarray(y, np.float64)[s].sum())
            for k, s in state_classes(md).items()}
    print(f"  {label} final-state sums {sums}", flush=True)


# ---------------------------------------------------------- four cards

def collective_seconds(trace_dir: str) -> dict:
    """Per device-trace line, the summed duration of collective events
    (collective-permute / all-reduce and the NCCL kernels behind them)."""
    import glob
    import re

    import jax

    pat = re.compile(r"collective-permute|all-reduce|nccl|SendRecv|AllReduce",
                     re.I)
    out = {}
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        pd = jax.profiler.ProfileData.from_file(path)
        for plane in pd.planes:
            if "GPU" not in plane.name:
                continue
            for line in plane.lines:
                ns = sum(ev.duration_ns for ev in line.events
                         if pat.search(ev.name))
                if ns:
                    key = f"{plane.name}/{line.name}"
                    out[key] = out.get(key, 0.0) + ns * 1e-9
    return out


def phase_sharded(checks: Checks, nx, ny, p, days=1.0, interval=360,
                  outdir=OUT, trace_windows=6) -> None:
    """The domain-decomposed driver over *p* devices against the
    single-device fused driver on device 0, plus the sharded RHS against
    the single-device RHS at one state."""
    import jax
    import jax.numpy as jnp

    from shud_tpu.core.device import to_device
    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.core.rhs import rhs
    from shud_tpu.driver.run_fast import run_project_fast
    from shud_tpu.parallel.partition import (riv_blocks, shard_state,
                                             unshard_state)
    from shud_tpu.parallel.runtime import run_project_sharded
    from shud_tpu.parallel.sharded import make_sharded_rhs

    def make():
        return seeded_basin(nx, ny, end_day=days, interval=interval,
                            outdir=outdir)

    d_sh = os.path.join(outdir, f"sharded_p{p}")
    t0 = time.perf_counter()
    sim_s = run_project_sharded("synthetic", inp=make(), p=p,
                                verbose=False, outpath=d_sh)
    total = time.perf_counter() - t0
    t_min, wall = _time_log(os.path.join(d_sh, "synthetic.time.csv"))
    warm = float((wall[-1] - wall[0]) / ((t_min[-1] - t_min[0]) / 1440.0)
                 if len(t_min) > 1 else float("nan"))
    devs = {s.device for s in sim_s.state.y["sf"].addressable_shards}
    print(f"  sharded P={p}: {sim_s.md.num_ele} cells, {days:g} day(s); "
          f"set-up (partition + compile + first interval) "
          f"{float(total - (wall[-1] - wall[0]))!r} s; warm {warm!r} s per "
          f"simulated day; nsteps={int(sim_s.state.nsteps)} "
          f"nfe={int(sim_s.state.nfe)}; halo rounds {sim_s.sm.plan.k}; "
          f"shards on {sorted(str(d) for d in devs)}", flush=True)
    checks.check("sharded state spread over distinct devices (missing)",
                 p - len(devs), 0)

    fused = run_basin(make(), "fused single device", jnp.float64,
                      os.path.join(outdir, "fused_ref"))
    md = fused["sim"].md
    for k, v in class_maxdiff(md, sim_s.y_full(), fused["y"]).items():
        name = f"sharded P={p} vs single device max|d{k}| [m]"
        if k == "riv":
            # reduction order changes the Newton/GMRES iterates, and on the
            # long river chain the stage then moves within the solver's
            # tolerance (the one-card run measures that error at P2)
            print(f"  [info] {name}: {v!r} (bound {TRAJ_BOUND!r} not "
                  f"applied: tolerance-class gap)", flush=True)
        else:
            checks.check(name, v, TRAJ_BOUND)

    # RHS equivalence at one state
    y = fused["y"]
    fs = seeded_forcing(md, 4, jnp.float64)
    dy_ref = np.asarray(rhs(to_device(md), fs, 0.0, jnp.asarray(y)))
    sm = sim_s.sm
    _, rhs_fn, params = make_sharded_rhs(sm)

    def blocks(v):
        buf = np.zeros((sm.p, sm.np_cells))
        buf[sm.old_to_shard, sm.old_to_slot] = np.asarray(v)
        return jnp.asarray(buf)

    fs_cell = {k: blocks(getattr(fs, k)) for k in (
        "net_prcp", "prcp", "pot_evap", "pot_tran", "e_ic", "lai",
        "fu_surf", "fu_sub", "ele_ybc", "ele_qbc", "ele_qss")}
    fs_riv = {k: jnp.asarray(riv_blocks(sm, np.asarray(getattr(fs, k))))
              for k in ("riv_ybc", "riv_qbc")}
    ys = {k: jnp.asarray(v) for k, v in shard_state(sm, y).items()}
    dy_sh = rhs_fn(0.0, ys, params + (fs_cell, fs_riv))
    flat = unshard_state(sm, {k: np.asarray(v) for k, v in dy_sh.items()})
    scale = float(np.abs(dy_ref).max()) or 1.0
    checks.check(f"sharded P={p} RHS vs single-device max|d|/max|ref|",
                 float(np.abs(flat - dy_ref).max()) / scale, RHS_REL_BOUND)

    if trace_windows:
        # a short traced run of its own (the timings above ran untraced)
        trace = os.path.join(outdir, "trace_sharded")
        win = sim_s.inp.control.solver_step
        jax.block_until_ready(sim_s.state.y)
        t0 = time.perf_counter()
        with jax.profiler.trace(trace):
            for _ in range(trace_windows):
                sim_s.advance_window(sim_s.t + win)
            jax.block_until_ready(sim_s.state.y)
        span = time.perf_counter() - t0
        coll = collective_seconds(trace)
        print(f"  traced {trace_windows} sharded windows in {span!r} s; "
              f"collective time per device-trace line [s]: {coll}",
              flush=True)


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cards = 1
    if argv[:1] == ["--cards"] and len(argv) == 2:
        cards = int(argv[1])
    elif argv:
        raise SystemExit("usage: chip_smoke.py [--cards N]")

    # the CPU backend serves the f64 reference of P4
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, HERE)
    import shud_tpu

    if os.path.dirname(os.path.dirname(os.path.abspath(
            shud_tpu.__file__))) != HERE:
        raise RuntimeError("shud_tpu must come from this checkout")
    import jax
    import jax.numpy as jnp

    from shud_tpu import native
    from shud_tpu.cli import setup_compile_cache

    # ---- P0 ----
    print("P0 device", flush=True)
    kind = require_gpu(jax.devices())
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    if len(jax.devices()) < cards:
        raise RuntimeError(f"--cards {cards}: only {len(jax.devices())} "
                           f"device(s)")
    card = card_line()
    print(f"  device_kind={kind!r} count={len(jax.devices())} "
          f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}",
          flush=True)
    print("  nvidia-smi --query-gpu=name,power.limit:", flush=True)
    print(card, flush=True)
    print(f"  compile cache: {setup_compile_cache()}", flush=True)
    t0 = time.perf_counter()
    print(f"  mesh preprocessing: {native.status()} (set-up "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    checks = Checks()

    if cards > 1:
        print(f"P-sharded: {cards} cards", flush=True)
        phase_sharded(checks, *P2_GRID, cards)
    else:
        peak, source = hbm_peak(kind)
        print("P1 small basin (1,152 cells)", flush=True)
        p1 = phase_basins(*P1_GRID, True, 3.0, 1440, "P1")
        md1 = p1["f64"]["sim"].md
        print("P2 unstructured mesh (1,048,352 cells)", flush=True)
        t0 = time.perf_counter()
        p2 = phase_basins(*P2_GRID, False, 1.0, 360, "P2")
        md2 = p2["f64"]["sim"].md
        print(f"  P2 total {time.perf_counter() - t0!r} s", flush=True)
        checksums("P2 f64", md2, p2["f64"]["y"])
        checksums("P2 f32", md2, p2["f32"]["y"])

        print(f"P3 plain-path timing (HBM peak {peak:.3e} B/s, {source}; "
              f"card {card})", flush=True)
        print(f"  plain float32 copy: {copy_rate()!r} B/s", flush=True)
        for label, res, grid, lake in (("P1", p1, P1_GRID, True),
                                       ("P2", p2, P2_GRID, False)):
            inp = seeded_basin(*grid, with_lake=lake)
            for fd in (jnp.float64, jnp.float32):
                tag = "f64" if fd == jnp.float64 else "f32"
                phase_plain_timing(inp, res[tag]["y"], label, fd, peak)

        print("P4 correctness", flush=True)
        check_rhs_jv(checks, seeded_basin(*P1_GRID, with_lake=True),
                     p1["f64"]["y"], "P1", gpu, cpu)
        check_rhs_jv(checks, seeded_basin(*P2_GRID), p2["f64"]["y"], "P2",
                     gpu, cpu)
        check_trajectory(checks, lambda: seeded_basin(*P1_GRID,
                                                      with_lake=True,
                                                      end_day=1.0), gpu, cpu)
        check_f32(checks, "P1", md1, p1["f64"]["y"], p1["f32"]["y"])
        # on the long P2 river chain the f32/f64 gap in stage is of the
        # size of the solver's own tolerance error (the WRMS norm averages
        # the few river components over ~3M cell components); measure that
        # error, and hold f32 to the bounds where tolerance is not the limit
        tight = tight_pair(lambda: seeded_basin(*P2_GRID, end_day=1.0,
                                                interval=360), 1e-6)
        tol_err = class_maxdiff(md2, p2["f64"]["y"], tight["f64"])
        print(f"  P2 f64 at the basin's tolerance vs f64 at 1e-6, max|d| "
              f"[m]: {tol_err}", flush=True)
        check_f32(checks, "P2", md2, p2["f64"]["y"], p2["f32"]["y"],
                  report_only={"riv": "tolerance-class gap; f64's own "
                                      "tolerance error here is "
                                      f"{tol_err['riv']!r} m"})
        check_f32(checks, "P2 at rtol=atol=1e-6", md2, tight["f64"],
                  tight["f32"])

    if checks.failed:
        raise SystemExit(f"failed checks: {checks.failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": kind, "count": cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
