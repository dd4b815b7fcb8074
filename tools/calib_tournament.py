#!/usr/bin/env python3
"""Final calibration tournament: score candidate vectors at full length.

The CMA-ES searches run on a 360/365-day window for speed; this tool
re-scores the short-window winners over the FULL record (default the
canonical 1827-day ccw run, warmup excluded) and prints NSE + the basin
water balance, so the published calibration is validated on the whole
period, not the search window.  Dispatches stay short (chunked), so even
stiff candidates keep each device program brief.

    python tools/calib_tournament.py ccw --days 1827 --warmup 60 \
        --cand "label:x1,x2,..." --cand "label2:..." \
        --params geol_ksath,...

Writes the winner to output/<prj>.out/<prj>.cfg.calib.opt.
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
    ap.add_argument("--days", type=float, default=1827.0)
    ap.add_argument("--warmup", type=float, default=60.0)
    ap.add_argument("--chunk-days", type=int, default=3)
    ap.add_argument("--params", required=True)
    ap.add_argument("--cand", action="append", required=True,
                    help='"label:x1,x2,..." (repeatable)')
    ap.add_argument("--f32", action="store_true", default=True)
    ap.add_argument("--f64", dest="f32", action="store_false")
    args = ap.parse_args()

    import jax.numpy as jnp

    from shud_tpu.io.project import load_project, read_tsd_csv, write_calib
    from shud_tpu.utils.calibrate import calib_from_vector, nse, \
        run_with_calib

    names = [s.strip() for s in args.params.split(",") if s.strip()]
    fd = jnp.float32 if args.f32 else jnp.float64
    inp0 = load_project(args.project, base=args.base)
    obs_path = os.path.join(inp0.paths.inpath, f"{args.project}.tsd.obs")
    _, obs_t, obs_data = read_tsd_csv(obs_path)
    obs_q = obs_data[:, 0]
    obs_day = np.floor(obs_t / 1440.0).astype(int)
    ndays = int(args.days)
    obs_daily = np.full(ndays, np.nan)
    for d in range(ndays):
        m = obs_day == d
        if m.any():
            obs_daily[d] = np.nanmean(obs_q[m])

    fr = None
    results = []
    for cand in args.cand:
        label, vec = cand.split(":", 1)
        x = np.array([float(s) for s in vec.split(",")])
        gc = calib_from_vector(names, x, base=inp0.calib)
        sim = run_with_calib(args.project, args.base, gc, ndays,
                             float_dtype=fd, inp=inp0, fr=fr)
        fr = sim.fr
        md = sim.md
        outlet = np.flatnonzero((np.asarray(md.riv_down) < 0)
                                & (np.asarray(md.riv_to_lake) < 0))
        wpd = int(round(1440.0 / sim.inp.control.solver_step))
        qd = np.zeros(ndays)
        area = np.asarray(md.area)
        aet_sum = p_sum = 0.0
        d0 = 0
        t0 = time.time()
        while d0 < ndays:
            nd = min(int(args.chunk_days), ndays - d0)
            mean_e, _, _, qdowns = sim.advance_interval(nd * 1440.0)
            aet_sum += float(np.asarray(mean_e["eta"]) @ area) * nd
            p_sum += float(np.asarray(mean_e["prcp"]) @ area) * nd
            qn = np.asarray(qdowns)[:, outlet].sum(axis=1)
            qd[d0 : d0 + nd] = np.abs(qn).reshape(nd, wpd).mean(axis=1)
            d0 += nd
        sim_daily = qd * 1440.0
        w0 = int(args.warmup)
        score = nse(sim_daily[w0:], obs_daily[w0:])
        nfe = int(sim.bdf.nfe)
        ta = area.sum()
        print(f"{label}: NSE={score:.4f} over days {w0}..{ndays} "
              f"AET={aet_sum/ndays*1440e3/ta:.2f} "
              f"P={p_sum/ndays*1440e3/ta:.2f} mm/d "
              f"nfe={nfe} ({nfe/ndays:.0f}/day) "
              f"wall={time.time()-t0:.0f}s", flush=True)
        results.append((score, label, x, gc))

    results.sort(key=lambda r: -r[0])
    score, label, x, gc = results[0]
    print(f"\nwinner: {label} NSE={score:.4f}")
    for n, v in zip(names, x):
        print(f"  {n} = {v:.4f}")
    outdir = os.path.join(os.getcwd(), "output", f"{args.project}.out")
    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, f"{args.project}.cfg.calib.opt")
    write_calib(gc, out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
