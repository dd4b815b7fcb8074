#!/usr/bin/env python3
"""Generate golden test fixtures from the reference oracle.

Run from anywhere:  python3 tools/gen_golden.py [project ...]
Requires tools/build_oracle.sh to have been run (oracle in /tmp/oracle).
Each oracle process handles ONE project (the reference uses global state),
so this script re-execs itself per project.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")

ELE_FIELDS = [
    "area", "x", "y", "z_surf", "z_bottom", "AquiferDepth", "WetlandLevel",
    "RootReachLevel", "MacporeLevel", "FixPressure", "infKsatV", "ThetaS",
    "ThetaFC", "ThetaR", "Alpha", "Beta", "hAreaF", "macKsatV", "infD",
    "KsatH", "KsatV", "Sy", "geo_ThetaS", "geo_ThetaR", "geo_vAreaF",
    "macKsatH", "macD", "VegFrac", "Albedo", "Rough", "RzD", "nx", "ny",
    "nz", "slopeAngle", "aspect", "depression",
    "edge0", "edge1", "edge2", "Dist2Edge0", "Dist2Edge1", "Dist2Edge2",
    "Dist2Nabor0", "Dist2Nabor1", "Dist2Nabor2",
    "avgRough0", "avgRough1", "avgRough2",
    "nabr0", "nabr1", "nabr2", "lakenabr0", "lakenabr1", "lakenabr2",
    "iLake", "iBC", "iSS",
]
RIV_FIELDS = [
    "down", "BC", "toLake", "Length", "BedSlope", "depth", "bankslope",
    "BottomWidth", "Sinuosity", "rivRough", "Cwr", "KsatH", "BedThick",
    "avgRough", "Dist2DownStream",
]
SEG_FIELDS = ["iRiv", "iEle", "length", "eqDistance", "Cwr", "KsatH"]

RHS_DIAGS = [
    "qEleInfil", "qEleExfil", "qEleRecharge", "qEs", "qEu", "qEg", "qTu",
    "qTg", "qEleE_IC", "QsegSurf", "QsegSub", "QrivSurf", "QrivSub",
    "QrivDown", "QrivUp", "Qe2r_Surf", "Qe2r_Sub", "QeleSurfTot",
    "QeleSubTot", "iBeta",
]
LAKE_DIAGS = [
    "QLakeSurf", "QLakeSub", "QLakeRivIn", "qLakePrcp", "qLakeEvap",
    "y2LakeArea",
]
FORC_FIELDS = [
    "t_prcp", "t_temp", "t_rh", "t_wind", "t_rn", "t_lai", "t_mf",
    "qPotEvap", "qPotTran", "qEleETP", "ele_rn_factor", "ele_rn_h_wm2",
    "ele_rn_t_wm2",
]


def _heihe_patched_ws() -> str:
    """Workspace with heihe's tsd.lai padded to 14 data columns.

    Upstream heihe is malformed: `.sp.att` references land-cover types
    13/14 but `tsd.lai` ships only 11 data columns, so the reference's
    own forcing path reads out of bounds (TimeSeriesData::getX).  The
    JAX loader clamps the LC index to the last available column
    (landsurface.py); padding the missing columns with copies of the
    LAST column makes the reference read exactly what the clamp reads,
    so forced-RHS fixtures can be generated for heihe too."""
    ws = "/tmp/oracle/ws_heihe"
    src = "/root/reference/input/heihe"
    d = os.path.join(ws, "input", "heihe")
    os.makedirs(d, exist_ok=True)
    os.makedirs(os.path.join(ws, "output"), exist_ok=True)
    for fn in os.listdir(src):
        dst = os.path.join(d, fn)
        if fn in ("heihe.tsd.lai", "heihe.cfg.para") or os.path.lexists(dst):
            continue
        os.symlink(os.path.join(src, fn), dst)
    # second upstream malformation: cfg.para END (9861 d) exceeds the
    # forcing coverage (9496 d), tripping the reference's own
    # validateTimeStamps fail-fast; the fixtures only need day <= 201
    with open(os.path.join(src, "heihe.cfg.para")) as f:
        para = f.read().splitlines()
    para = ["END\t400" if ln.split() and ln.split()[0].upper() == "END"
            else ln for ln in para]
    with open(os.path.join(d, "heihe.cfg.para"), "w") as f:
        f.write("\n".join(para) + "\n")
    with open(os.path.join(src, "heihe.tsd.lai")) as f:
        lines = f.read().splitlines()
    nrow, ncol_old, *rest = lines[0].split()
    ncol = 14
    out = [" ".join([nrow, str(ncol)] + rest)]
    hdr = lines[1].split()
    out.append("\t".join(hdr + [f"Xp{j}" for j in range(ncol - len(hdr) + 1)]))
    for ln in lines[2:]:
        v = ln.split()
        if not v:
            continue
        out.append("\t".join(v + [v[-1]] * (ncol + 1 - len(v))))
    with open(os.path.join(d, "heihe.tsd.lai"), "w") as f:
        f.write("\n".join(out) + "\n")
    return ws


def gen_project(project: str) -> None:
    sys.path.insert(0, REPO)
    from tools.oracle import Oracle, WS_PATH

    ws = _heihe_patched_ws() if project == "heihe" else WS_PATH
    o = Oracle(project, ws=ws)
    ne, nr, ns, nl = o.ne, o.nr, o.ns, o.nl
    rng = np.random.default_rng(42)

    out = {"dims": np.array([ne, nr, ns, nl, o.ny])}
    for f in ELE_FIELDS:
        out[f"ele/{f}"] = o.ele_field(f)
    for f in RIV_FIELDS:
        out[f"riv/{f}"] = o.riv_field(f)
    for f in SEG_FIELDS:
        out[f"seg/{f}"] = o.seg_field(f)
    out["y0"] = o.y0()

    # ---- forcing + ET-bucket + RHS at a sequence of times ----
    # fixed bucket ICs so the ET comparison is deterministic
    snow0 = rng.uniform(0.0, 0.01, ne)
    ic0 = rng.uniform(0.0, 0.0002, ne)
    out["et/snow0"] = snow0
    out["et/ic0"] = ic0
    o.set("yEleSnow", snow0)
    o.set("yEleIS", ic0)

    aqd = o.ele_field("AquiferDepth")
    depth = o.riv_field("depth")

    # ---- synthetic-forcing RHS fixtures (no forcing files involved) ----
    # exercises the flux math on states/forcings the real run may not reach;
    # also the only option for projects whose forcing inputs the reference
    # itself cannot read (heihe: .att iLC=13 vs 11-column tsd.lai).
    for k in range(3):
        fs = {
            "qEleNetPrep": rng.uniform(0.0, 2e-5, ne) * (rng.random(ne) < 0.5),
            "qElePrep": rng.uniform(0.0, 2e-5, ne),
            "qPotEvap": rng.uniform(0.0, 3e-6, ne),
            "qPotTran": rng.uniform(0.0, 3e-6, ne),
            "qEleE_IC": rng.uniform(0.0, 2e-6, ne),
            "t_lai": rng.uniform(0.0, 4.0, ne) * (rng.random(ne) < 0.8),
            "fu_Surf": np.ones(ne),
            "fu_Sub": np.ones(ne),
        }
        for name, v in fs.items():
            o.set(name, v)
        sf = rng.uniform(-0.001, 0.05, ne)
        us = rng.uniform(0.0, 0.6, ne) * aqd
        gw = rng.uniform(0.0, 1.2, ne) * aqd
        riv = rng.uniform(0.0, 2.5, nr) * np.maximum(depth, 0.5)
        lake = rng.uniform(0.0, 5.0, nl)
        y = np.concatenate([sf, us, gw, riv, lake])
        t = 0.0
        o.f(t, y)
        out[f"syn{k}/e_ic_in"] = o.get("qEleE_IC", ne)
        for name, v in fs.items():
            if name != "qEleE_IC":
                out[f"syn{k}/{name}"] = v
        dy = o.f(t, y)
        out[f"syn{k}/y"] = y
        out[f"syn{k}/dy"] = dy
        qs, qb = o.qele_edges()
        out[f"syn{k}/QeleSurf"] = qs
        out[f"syn{k}/QeleSub"] = qb
        for f in RHS_DIAGS:
            out[f"syn{k}/{f}"] = o.get(f)
        if nl > 0:
            for f in LAKE_DIAGS:
                out[f"syn{k}/{f}"] = o.get(f)
    out["num_syn"] = np.array(3)

    times = [0.0, 360.0, 1440.0 * 30 + 60.0, 1440.0 * 30 + 720.0,
             1440.0 * 200 + 600.0]
    dt = 10.0
    for k, t in enumerate(times):
        o.update_forcing(t)
        for f in FORC_FIELDS:
            out[f"forc{k}/{f}"] = o.get(f, ne)
        o.et(t, t + dt)
        for f in ["yEleSnow", "yEleIS", "qEleNetPrep", "qEleE_IC"]:
            out[f"et{k}/{f}"] = o.get(f, ne)

        # states: IC for k=0, random plausible otherwise
        if k == 0:
            y = o.y0()
        else:
            sf = rng.uniform(-0.001, 0.02, ne)
            us = rng.uniform(0.0, 0.5, ne) * aqd
            gw = rng.uniform(0.0, 1.2, ne) * aqd
            riv = rng.uniform(0.0, 2.0, nr) * np.maximum(depth, 0.5)
            lake = rng.uniform(0.0, 5.0, nl)
            y = np.concatenate([sf, us, gw, riv, lake])
        # double-call protocol: first call warms the stale satn/E_IC caches
        o.f(t, y)
        # capture post-first-call E_IC (the RHS input for call 2)
        out[f"rhs{k}/e_ic_in"] = o.get("qEleE_IC", ne)
        out[f"rhs{k}/net_prcp"] = o.get("qEleNetPrep", ne)
        out[f"rhs{k}/prcp"] = o.get("qElePrep", ne)
        out[f"rhs{k}/pot_evap"] = o.get("qPotEvap", ne)
        out[f"rhs{k}/pot_tran"] = o.get("qPotTran", ne)
        out[f"rhs{k}/lai"] = o.get("t_lai", ne)
        out[f"rhs{k}/fu_surf"] = o.get("fu_Surf", ne)
        out[f"rhs{k}/fu_sub"] = o.get("fu_Sub", ne)
        dy = o.f(t, y)
        out[f"rhs{k}/t"] = np.array(t)
        out[f"rhs{k}/y"] = y
        out[f"rhs{k}/dy"] = dy
        qs, qb = o.qele_edges()
        out[f"rhs{k}/QeleSurf"] = qs
        out[f"rhs{k}/QeleSub"] = qb
        for f in RHS_DIAGS:
            out[f"rhs{k}/{f}"] = o.get(f)
        if nl > 0:
            for f in LAKE_DIAGS:
                out[f"rhs{k}/{f}"] = o.get(f)
    out["times"] = np.array(times)
    out["et_dt"] = np.array(dt)

    # ---- solar samples ----
    ts = np.arange(0.0, 4320.0, 37.0)
    sol = np.array([o.solar(t, 39.195, -122.71) for t in ts]).reshape(-1, 3)
    out["solar/t"] = ts
    out["solar/cosz"] = sol[:, 0]
    out["solar/az"] = sol[:, 1]
    out["solar/decl"] = sol[:, 2]

    os.makedirs(GOLDEN, exist_ok=True)
    np.savez_compressed(os.path.join(GOLDEN, f"{project}.npz"), **out)
    print(f"wrote tests/golden/{project}.npz  ({ne} cells, {nr} reaches, "
          f"{nl} lakes)")


if __name__ == "__main__":
    args = sys.argv[1:]
    if args and args[0] == "--one":
        os.chdir("/tmp/oracle/ws")
        gen_project(args[1])
    else:
        projects = args or ["ccw", "heihe", "qhh"]
        for p in projects:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", p],
                cwd="/tmp/oracle/ws",
            )
            if r.returncode != 0:
                print(f"FAILED: {p}")
