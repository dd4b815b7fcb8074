#!/usr/bin/env python3
"""Self-contained autocalibration against observed outlet discharge.

The reference's calibration workflow drives an external CMA-ES through
the `-e dir_cmaes` CLI hook + the `globalCal::copy(varname[], x[])`
vector API (CommandIn.cpp:210-212, ModelConfigure.cpp:368-375); this
tool closes the loop in-process: CMA-ES (utils/calibrate.py) proposes
calibration vectors, each candidate runs the fused driver for
``--days`` simulated days (same array shapes -> the jitted solver is
compiled ONCE and reused across all candidates), and the objective is
-NSE of daily outlet discharge vs the project's ``tsd.obs``.

    python tools/autocalibrate.py ccw --days 60 --gens 8 \
        --params geol_ksath,soil_kinf,lc_rough

Writes the best calibration to output/<prj>.out/<prj>.cfg.calib.opt
(same format as .cfg.calib — usable directly with `-c`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("project")
    ap.add_argument("-b", "--base", default="/root/reference")
    ap.add_argument("--days", type=float, default=60.0)
    ap.add_argument("--gens", type=int, default=8)
    ap.add_argument("--popsize", type=int, default=None)
    ap.add_argument("--params", default="geol_ksath,soil_kinf,lc_rough",
                    help="comma-separated calibration keys to optimise")
    ap.add_argument("--sigma0", type=float, default=0.3)
    ap.add_argument("--log", action="store_true",
                    help="search multiplicative keys in log10 space with "
                         "wide bounds (10^[-2.5, 2.5]); `*_add` keys stay "
                         "linear.  Conductivity multipliers span orders of "
                         "magnitude — log search reaches them.")
    ap.add_argument("--log-bound", type=float, default=2.5,
                    help="half-width of the log10 search box for "
                         "multiplicative keys under --log (default 2.5 "
                         "decades)")
    ap.add_argument("--bound", action="append", default=[],
                    help="per-key search-box override 'key=lo:hi' in the "
                         "key's search space (log10 for multiplicative "
                         "keys under --log, linear otherwise); e.g. "
                         "'et_etp=-0.5:0.5' keeps the ET multiplier "
                         "physically plausible (0.3-3.2x)")
    ap.add_argument("--nfe-budget-per-day", type=int, default=0,
                    help="abort a candidate once its RHS-eval count "
                         "exceeds budget*days (pathological parameter "
                         "combinations go 100-200x stiffer than normal; "
                         "fail fast with a penalty score instead of "
                         "running multi-minute device dispatches). "
                         "0 = no budget")
    ap.add_argument("--best-file", default=None,
                    help="path to persist the best vector as it improves "
                         "(one line: NSE,x1,x2,...) — lets a watchdog "
                         "resume via --x0 after a worker crash")
    ap.add_argument("--x0", default=None,
                    help="comma-separated initial vector (same order as "
                         "--params) to seed from a previous round")
    ap.add_argument("--chunk-days", type=int, default=30,
                    help="days advanced per device dispatch (one fetch "
                         "per chunk; daily discharge from the per-window "
                         "qdowns trajectory)")
    ap.add_argument("--warmup", type=float, default=0.0,
                    help="spin-up days excluded from the NSE score "
                         "(simulated but not fitted)")
    ap.add_argument("--wb-penalty", type=float, default=0.0,
                    help="multi-objective water-balance term: subtract "
                         "LAMBDA*max(0,(AET-P)/P) from the NSE score, "
                         "where AET/P are basin means over the window — "
                         "rejects the effective-parameter regime that "
                         "sustains AET > precipitation by storage "
                         "drawdown (docs/VALIDATION.md round-3 note)")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("-o", "--output", default=None,
                    help="directory for the optimised calib "
                         "(default ./output/<prj>.out — NEVER under "
                         "a read-only --base)")
    args = ap.parse_args()

    import jax.numpy as jnp

    from shud_tpu.analysis import ts2daily
    from shud_tpu.io.project import _CALIB_KEYS, load_project
    from shud_tpu.utils.calibrate import (
        calib_from_vector,
        cma_es,
        nse,
        run_with_calib,
    )

    names = [s.strip() for s in args.params.split(",") if s.strip()]
    from shud_tpu.io.project import _CALIB_KEYS as _CK
    bad = [n for n in names if n.lower() not in _CK]
    if bad:
        ap.error(f"unknown calibration key(s): {', '.join(bad)}")
    fd = jnp.float32 if args.f32 else jnp.float64

    inp0 = load_project(args.project, base=args.base)
    from shud_tpu.io.project import read_tsd_csv

    obs_path = os.path.join(inp0.paths.inpath,
                            f"{args.project}.tsd.obs")
    if not os.path.exists(obs_path):
        raise SystemExit(f"{args.project} has no tsd.obs — nothing to fit")
    _, obs_t, obs_data = read_tsd_csv(obs_path)
    obs_q = obs_data[:, 0]  # gauge discharge [m3/day] (Q_cmd column)
    # observed daily means over the calibration window [0, days)
    obs_day = np.floor(obs_t / 1440.0).astype(int)
    ndays = int(args.days)
    obs_daily = np.full(ndays, np.nan)
    for d in range(ndays):
        m = (obs_day == d)
        if m.any():
            obs_daily[d] = np.nanmean(obs_q[m])

    base_calib = inp0.calib
    n_eval = [0]
    best_seen = [-np.inf]
    fr_cache = [None]  # forcing/TSR tables reused across candidates

    # multiplicative scalars (conductivities etc. span orders of magnitude)
    # are searched in log10 space; additive keys (reference naming `*+`,
    # attribute naming `*_add`) stay linear
    log_mask = np.array([not (n.endswith("_add") or n.endswith("+"))
                         for n in names])

    def decode(z):
        x = np.asarray(z, dtype=float).copy()
        if args.log:
            x[log_mask] = 10.0 ** x[log_mask]
        return x

    def objective(z):
        x = decode(z)
        gc = calib_from_vector(names, x, base=base_calib)
        sim = run_with_calib(args.project, args.base, gc, ndays,
                             float_dtype=fd, inp=inp0, fr=fr_cache[0])
        fr_cache[0] = sim.fr
        md = sim.md
        outlet = np.flatnonzero((np.asarray(md.riv_down) < 0)
                                & (np.asarray(md.riv_to_lake) < 0))
        # advance in multi-day chunks: run_interval's per-window qdowns
        # trajectory gives window-end outlet discharge, so daily means
        # need only ONE device fetch per chunk instead of one per day
        chunk = int(args.chunk_days)
        wpd = int(round(1440.0 / sim.inp.control.solver_step))
        budget = int(args.nfe_budget_per_day) * ndays
        qd = np.zeros(ndays)
        area = np.asarray(md.area)
        aet_sum = p_sum = 0.0  # basin m3/min, day-weighted
        d0 = 0
        while d0 < ndays:
            nd = min(chunk, ndays - d0)
            mean_e, _, _, qdowns = sim.advance_interval(nd * 1440.0)
            if args.wb_penalty:
                aet_sum += float(np.asarray(mean_e["eta"]) @ area) * nd
                p_sum += float(np.asarray(mean_e["prcp"]) @ area) * nd
            qn = np.asarray(qdowns)[:, outlet].sum(axis=1)
            qd[d0 : d0 + nd] = np.abs(qn).reshape(nd, wpd).mean(axis=1)
            d0 += nd
            # prorated: a 100x-stiff candidate aborts after its first chunk
            if budget and int(sim.bdf.nfe) > args.nfe_budget_per_day * d0:
                n_eval[0] += 1
                print(f"    eval {n_eval[0]}: " +
                      " ".join(f"{n}={v:.3f}" for n, v in zip(names, x)) +
                      f"  ABORT nfe={int(sim.bdf.nfe)} "
                      f"(> {args.nfe_budget_per_day}/day) at day {d0}",
                      flush=True)
                return 5.0  # pathological-stiffness penalty (NSE <= 1)
        sim_daily = qd * 1440.0  # m3/min window samples -> m3/day
        w0 = int(args.warmup)
        score = nse(sim_daily[w0:], obs_daily[w0:])
        wb_note = ""
        if args.wb_penalty:
            tot_area = area.sum()
            aet_mm = aet_sum / ndays * 1440e3 / tot_area
            p_mm = p_sum / ndays * 1440e3 / tot_area
            pen = args.wb_penalty * max(0.0, (aet_mm - p_mm) / max(p_mm, 1e-9))
            score -= pen
            wb_note = (f"  AET={aet_mm:.2f} P={p_mm:.2f} mm/d"
                       + (f" pen={pen:.3f}" if pen > 0 else ""))
        n_eval[0] += 1
        print(f"    eval {n_eval[0]}: " +
              " ".join(f"{n}={v:.3f}" for n, v in zip(names, x)) +
              f"  NSE={score:.4f}{wb_note}", flush=True)
        if args.best_file and score > best_seen[0]:
            best_seen[0] = score
            with open(args.best_file, "w") as f:
                f.write(f"{score:.6f}," +
                        ",".join(f"{v:.6g}" for v in x) + "\n")
        return -score

    x0 = np.array([getattr(base_calib, _CALIB_KEYS[n.lower()])
                   for n in names], dtype=float)
    if args.x0:
        x0 = np.array([float(s) for s in args.x0.split(",")], dtype=float)
        if x0.shape[0] != len(names):
            ap.error(f"--x0 has {x0.shape[0]} values but --params names "
                     f"{len(names)} keys")
        if not args.log and (np.any(x0 < 0.05) or np.any(x0 > 20.0)):
            print("warning: --x0 outside the linear search bounds "
                  "[0.05, 20]; values will be clipped by CMA-ES "
                  "(use --log for wide-range search)", flush=True)
    if args.log:
        z0 = x0.copy()
        z0[log_mask] = np.log10(np.maximum(x0[log_mask], 1e-6))
        # multiplicative: 10^[-b, b]; additive: linear [-5, 5]
        b = float(args.log_bound)
        lo = np.where(log_mask, -b, -5.0)
        hi = np.where(log_mask, b, 5.0)
    else:
        z0 = x0
        lo = np.full(len(names), 0.05)
        hi = np.full(len(names), 20.0)
    for spec in args.bound:
        key, rng = spec.split("=", 1)
        if key.strip().lower() not in [n.lower() for n in names]:
            ap.error(f"--bound key {key!r} not in --params")
        i = [n.lower() for n in names].index(key.strip().lower())
        blo, bhi = (float(v) for v in rng.split(":"))
        lo[i], hi[i] = blo, bhi
        z0[i] = np.clip(z0[i], blo, bhi)
    t0 = time.time()
    z_best, f_best, hist = cma_es(
        objective, z0, sigma0=args.sigma0, bounds=(lo, hi),
        popsize=args.popsize, max_gen=args.gens, seed=1, verbose=True,
    )
    x_best = decode(z_best)
    print(f"\nbest NSE {-f_best:.4f} after {n_eval[0]} runs "
          f"({time.time()-t0:.0f}s):")
    for n, v in zip(names, x_best):
        print(f"  {n} = {v:.4f}")

    from shud_tpu.io.project import write_calib

    gc = calib_from_vector(names, x_best, base=base_calib)
    outdir = args.output or os.path.join(
        os.getcwd(), "output", f"{args.project}.out")
    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, f"{args.project}.cfg.calib.opt")
    write_calib(gc, out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
