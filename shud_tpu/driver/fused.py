"""Fused driver: an entire output interval of solver windows in ONE
device dispatch.

The per-window chain (forcing gather → TSR factor → PET → bucket update →
adaptive implicit solve → diagnostics accumulation) runs as a
``lax.scan`` over windows inside one jit; the host loop executes once per
output interval (daily for the reference configs), receiving only the
interval-mean channel values and the per-window river stages (for flood
alerting).  This removes the per-window dispatch latency that dominates
small-mesh wall time.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from shud_tpu.core import solar as solar_mod
from shud_tpu.core.device import to_device
from shud_tpu.core.landsurface import (
    BucketState,
    cell_forcing,
    et_bucket_step,
)
from shud_tpu.core.mesh import MeshData, build_mesh
from shud_tpu.core.rhs import rhs, rhs_full
from shud_tpu.core.state import ForcingSlice
from shud_tpu.driver.forcing import ForcingRuntime, build_forcing
from shud_tpu.driver.init import initial_buckets, initial_state
from shud_tpu.io.project import ProjectInput, load_project
from shud_tpu.solver.bdf import BDFState, SolverConfig, bdf_init, solve_to


class ChunkTables(NamedTuple):
    """Device-resident forcing tables for the whole run."""

    fvals: jnp.ndarray  # [K, S, 5]
    station_z: jnp.ndarray  # [S]
    lai_vals: jnp.ndarray  # [Kl, C]
    mf_vals: jnp.ndarray  # [Km, C]
    tsr_sx: jnp.ndarray  # [K, n]
    tsr_sy: jnp.ndarray
    tsr_sz: jnp.ndarray
    tsr_wdt: jnp.ndarray
    tsr_den: jnp.ndarray  # [K]


# diagnostics accumulated over each output interval (sum over windows)
ACCUM_KEYS = [
    "y_ic", "y_snow", "y_surf", "y_unsat", "y_gw", "prcp", "net_prcp",
    "etp", "eta", "rn_h", "rn_t", "rn_factor", "q_rech", "q_sub_tot",
    "q_surf_tot", "q_e2r_sub", "q_e2r_surf", "q_infil", "q_exfil", "e_ic",
    "trans", "evapo",
]
# per-edge flux channels, accumulated only when dt_Qe_subx/surfx are on
# (Model_Control.cpp:460-465 + MD_initialize.cpp:283-296)
PER_EDGE_KEYS = ["q_esub0", "q_esub1", "q_esub2",
                 "q_esurf0", "q_esurf1", "q_esurf2"]
ACCUM_RIV_KEYS = ["q_riv_up", "q_riv_down", "q_riv_sub", "q_riv_surf",
                  "y_riv"]
ACCUM_LAKE_KEYS = ["y_lake", "lake_area", "q_lake_evap", "q_lake_prcp",
                   "q_lake_rivin", "q_lake_surf", "q_lake_sub",
                   # always-zero river outflow: the reference registers the
                   # channel (MD_initialize.cpp:339) but never accumulates
                   # QLakeRivOut (zeroed at MD_update.cpp:184) — emitted as
                   # zeros for reference file-set parity (IO.cpp:177)
                   "q_lake_rivout"]


@partial(jax.jit, static_argnames=("cfg", "n_windows", "win_minutes",
                                   "close_boundary", "terrain_radiation",
                                   "swnet_mode", "cryosphere", "et_mode",
                                   "per_edge_out"))
def run_interval(
    dm: MeshData,
    tables: ChunkTables,
    bdf_state: BDFState,
    buckets: BucketState,
    cal,
    t0,
    forc_idx,  # [W] int32
    lai_idx,  # [W]
    mf_idx,  # [W]
    rad_cap,
    rad_cosz_min,
    cfg: SolverConfig,
    n_windows: int,
    win_minutes: float,
    close_boundary: bool = True,
    terrain_radiation: bool = True,
    swnet_mode: bool = False,
    cryosphere: bool = False,
    cryo_state=None,
    cryo_bounds=(-1.0, -5.0, -3.0, -10.0),
    bc_tables=None,  # optional dict: per-window BC value arrays [W, ...]
    et_mode: int = 0,
    per_edge_out: bool = False,  # accumulate QeleSub/Surf per-edge means
):
    ne, nr, nl = dm.num_ele, dm.num_riv, dm.num_lake
    dtype = bdf_state.t.dtype
    zeros_e = jnp.zeros(ne, dtype=dtype)
    zeros_r = jnp.zeros(nr, dtype=dtype)
    zeros_l = jnp.zeros(nl, dtype=dtype)
    if bc_tables is None:
        bc_tables = {
            "ele_ybc": jnp.zeros((n_windows, 1), dtype=dtype),
            "ele_qbc": jnp.zeros((n_windows, 1), dtype=dtype),
            "ele_qss": jnp.zeros((n_windows, 1), dtype=dtype),
            "riv_ybc": jnp.zeros((n_windows, 1), dtype=dtype),
            "riv_qbc": jnp.zeros((n_windows, 1), dtype=dtype),
        }
        bc_maps = None
    else:
        bc_tables, bc_maps = bc_tables

    def window(carry, xs):
        st, bk, cryo, acc_e, acc_r, acc_l = carry
        ki, li, mi, w, bc_row = xs
        t = t0 + w * win_minutes
        tout = t + win_minutes

        if terrain_radiation:
            factor = solar_mod.tsr_factor(
                dm.nx, dm.ny, dm.nz,
                tables.tsr_sx[ki], tables.tsr_sy[ki], tables.tsr_sz[ki],
                tables.tsr_wdt[ki], tables.tsr_den[ki],
                rad_cap, rad_cosz_min,
            )
        else:
            factor = jnp.ones_like(dm.nx)
        cf = cell_forcing(
            dm, tables.fvals[ki], tables.station_z,
            tables.lai_vals[li], tables.mf_vals[mi], factor, cal,
            swnet_mode=swnet_mode, terrain_radiation=terrain_radiation,
            et_mode=et_mode,
        )
        out = et_bucket_step(dm, cf, bk, win_minutes, cal.c_ismax)
        ones = jnp.ones_like(dm.nx)
        if cryosphere:
            from shud_tpu.core.cryo import cryo_step

            cryo, fu_surf, fu_sub = cryo_step(
                cryo, cf.temp, t, *cryo_bounds
            )
        else:
            fu_surf = fu_sub = ones
        if bc_maps is None:
            ele_ybc, ele_qbc, ele_qss = zeros_e, zeros_e, zeros_e
            riv_ybc, riv_qbc = zeros_r, zeros_r
        else:
            ele_ybc = jnp.where(
                dm.i_bc > 0,
                bc_tables["ele_ybc"][bc_row][bc_maps["ele_y"]], 0.0)
            ele_qbc = jnp.where(
                dm.i_bc < 0,
                bc_tables["ele_qbc"][bc_row][bc_maps["ele_q"]], 0.0)
            ele_qss = jnp.where(
                dm.i_ss != 0,
                bc_tables["ele_qss"][bc_row][bc_maps["ele_ss"]], 0.0)
            riv_ybc = jnp.where(
                dm.riv_bc > 0,
                bc_tables["riv_ybc"][bc_row][bc_maps["riv_y"]], 0.0)
            riv_qbc = jnp.where(
                dm.riv_bc < 0,
                bc_tables["riv_qbc"][bc_row][bc_maps["riv_q"]], 0.0)
        fs = ForcingSlice(
            net_prcp=out.net_prcp, prcp=cf.prcp, pot_evap=cf.pot_evap,
            pot_tran=cf.pot_tran, e_ic=out.e_ic, lai=cf.lai,
            fu_surf=fu_surf, fu_sub=fu_sub,
            ele_ybc=ele_ybc, ele_qbc=ele_qbc, ele_qss=ele_qss,
            riv_ybc=riv_ybc, riv_qbc=riv_qbc,
        )

        def quad_rates(tt, yy):
            """Basin budget rates [m3/min] along the trajectory (exact
            water-balance quadrature): ET, outlet discharge, open-boundary
            edge drainage, flux-BC/SS injection, lake precip/evap, and the
            river non-conservation rate — the reference WaterBalanceDiag's
            basin columns (WaterBalanceDiag.cpp:440-530) plus lake terms.

            Reuses the production RHS's own diagnostics (rhs_full) so the
            budget can never drift from the physics actually integrated —
            one extra RHS evaluation per accepted step, opt-in via
            SHUD_WB_DIAG=1 like the reference (shud.cpp:70-75)."""
            mesh, slc = dm, fs
            from shud_tpu.core import physics as _ph
            from shud_tpu.core.rhs import rhs_full as _rhs_full
            from shud_tpu.core.state import split_y

            nl_ = mesh.num_lake if mesh.num_lake > 0 else 0
            sfq, usq, gwq, rivq, lkq = split_y(yy, ne, nr, nl_)
            _dy, dg = _rhs_full(mesh, slc, tt, yy,
                                close_boundary=close_boundary)
            fdty = yy.dtype

            # canopy evaporation: the BUCKET's rate (slc.e_ic) is the mass
            # actually removed from interception storage; the RHS-internal
            # overwrite (dg["e_ic"]) is a reporting quirk of the reference
            e_ic_q = slc.e_ic
            if nl_ > 0:
                is_lake = mesh.i_lake > 0
                # lake cells are inert columns (dsf=dus=dgw=0); the lake
                # bucket takes P/E directly (accounted below)
                e_ic_q = jnp.where(is_lake, 0.0, e_ic_q)
            eta = (e_ic_q + dg["es"] + dg["eu"] + dg["eg"]
                   + dg["tu"] + dg["tg"])

            is_outlet = (mesh.riv_down < 0) & (mesh.riv_to_lake < 0)
            qout = jnp.sum(jnp.where(is_outlet, dg["q_riv_down"], 0.0))

            # open-boundary kinematic edge drainage (boundary edges only;
            # WaterBalanceDiag::basinBoundaryEdgeOutflow_m3min)
            if close_boundary:
                qedge = jnp.zeros((), dtype=fdty)
            else:
                is_bnd = mesh.nabr < 0
                if nl_ > 0:
                    is_bnd = is_bnd & (mesh.lakenabr < 0)
                qedge = jnp.sum(jnp.where(
                    is_bnd, dg["q_esurf"] + dg["q_esub"], 0.0))

            # flux BCs and source/sink terms (head BCs excluded, matching
            # WaterBalanceDiag.cpp:476-494)
            qbc = jnp.sum(jnp.where(mesh.i_bc < 0, slc.ele_qbc, 0.0)) \
                + jnp.sum(slc.riv_qbc)
            qss = jnp.sum(jnp.where(mesh.i_ss != 0, slc.ele_qss, 0.0))

            # river non-conservation: the dA >= -CSarea clamp
            # (MD_f.cpp:162-166) and the quadratic dA->dStage conversion
            # (fun_dAtodY, functions.hpp:141-153) make the realised
            # dV/dt = topw * dStage/dt * L deviate from the flux sum; the
            # budget carries the deviation as its own column (the
            # reference's noncons diagnostics, WaterBalanceDiag.cpp:470-530)
            rs = jnp.where(mesh.riv_bc > 0, slc.riv_ybc, rivq)
            csa = jnp.maximum(
                rs * (mesh.riv_bottom_width + rs * mesh.riv_bank_slope), 0.0
            )
            topw = jnp.maximum(
                rs * mesh.riv_bank_slope * 2.0 + mesh.riv_bottom_width, 0.0
            )
            d_nat = (
                -dg["q_riv_up"] - dg["q_riv_surf"] - dg["q_riv_sub"]
                - dg["q_riv_down"] + slc.riv_qbc
            ) / mesh.riv_length
            d_cl = jnp.maximum(d_nat, -csa)
            drv = _ph.fun_da_to_dy(d_cl, topw, mesh.riv_bank_slope)
            drv = jnp.where(mesh.riv_bc > 0, 0.0, drv)
            nc = jnp.sum((topw * drv - d_nat) * mesh.riv_length)
            if nl_ > 0:
                # the reference runs river-segment fluxes against lake
                # cells and then zeroes those cells' DY (MD_f.cpp:146-150)
                # — the discarded exchange is non-conservation too
                nc = nc + jnp.sum(jnp.where(
                    is_lake, dg["q_surf_tot"] + dg["q_sub_tot"], 0.0))

            # lake external exchange on the bathymetry area (goes beyond the
            # reference, which leaves lakes out of its basin budget)
            if nl_ > 0:
                lake_p = jnp.sum(dg["q_lake_prcp"] * dg["lake_area"])
                lake_e = jnp.sum(dg["q_lake_evap"] * dg["lake_area"])
            else:
                lake_p = jnp.zeros((), dtype=fdty)
                lake_e = jnp.zeros((), dtype=fdty)

            return {
                "et": jnp.sum(eta * mesh.area),
                "qout": qout,
                "qedge": qedge,
                "qbc": qbc,
                "qss": qss,
                "nc": nc,
                "lake_p": lake_p,
                "lake_e": lake_e,
            }

        def f(tt, yy, params):
            mesh, slc = params
            return rhs(mesh, slc, tt, yy, close_boundary=close_boundary)

        qfn = ((lambda tt, yy, _p: quad_rates(tt, yy))
               if st.quad is not None else None)
        st = solve_to(f, st, tout, (dm, fs), cfg, qfn)
        y = st.y

        # diagnostics at the accepted state (one extra RHS eval)
        _, diag = rhs_full(dm, fs, tout, y, close_boundary=close_boundary)
        es, eu, eg = diag["es"], diag["eu"], diag["eg"]
        tu, tg, e_ic = diag["tu"], diag["tg"], diag["e_ic"]
        vals_e = {
            "y_ic": out.state.ic_stg, "y_snow": out.state.snow,
            "y_surf": y[:ne], "y_unsat": y[ne : 2 * ne],
            "y_gw": y[2 * ne : 3 * ne],
            "prcp": cf.prcp, "net_prcp": out.net_prcp, "etp": cf.etp,
            "eta": e_ic + es + eu + eg + tu + tg,
            "rn_h": cf.rn_h, "rn_t": cf.rn_t, "rn_factor": cf.rn_factor,
            "q_rech": diag["q_rech"], "q_sub_tot": diag["q_sub_tot"],
            "q_surf_tot": diag["q_surf_tot"],
            "q_e2r_sub": diag["q_e2r_sub"], "q_e2r_surf": diag["q_e2r_surf"],
            "q_infil": diag["q_infil"], "q_exfil": diag["q_exfil"],
            "e_ic": e_ic, "trans": tu + tg, "evapo": es + eu + eg,
        }
        if per_edge_out:
            for j in range(3):
                vals_e[f"q_esub{j}"] = diag["q_esub"][:, j]
                vals_e[f"q_esurf{j}"] = diag["q_esurf"][:, j]
        riv_stage = y[3 * ne : 3 * ne + nr]
        vals_r = {
            "q_riv_up": diag["q_riv_up"], "q_riv_down": diag["q_riv_down"],
            "q_riv_sub": diag["q_riv_sub"], "q_riv_surf": diag["q_riv_surf"],
            "y_riv": riv_stage,
        }
        acc_e = {k: acc_e[k] + vals_e[k] for k in accum_keys}
        acc_r = {k: acc_r[k] + vals_r[k] for k in ACCUM_RIV_KEYS}
        if nl > 0:
            vals_l = {
                "y_lake": y[3 * ne + nr :], "lake_area": diag["lake_area"],
                "q_lake_evap": diag["q_lake_evap"],
                "q_lake_prcp": diag["q_lake_prcp"],
                "q_lake_rivin": diag["q_lake_rivin"],
                "q_lake_surf": diag["q_lake_surf"],
                "q_lake_sub": diag["q_lake_sub"],
                "q_lake_rivout": jnp.zeros_like(diag["lake_area"]),
            }
            acc_l = {k: acc_l[k] + vals_l[k] for k in ACCUM_LAKE_KEYS}
        return (st, out.state, cryo, acc_e, acc_r, acc_l), (riv_stage,
                                                            diag["q_riv_down"])

    accum_keys = ACCUM_KEYS + PER_EDGE_KEYS if per_edge_out else ACCUM_KEYS
    acc_e0 = {k: zeros_e for k in accum_keys}
    acc_r0 = {k: zeros_r for k in ACCUM_RIV_KEYS}
    acc_l0 = {k: zeros_l for k in ACCUM_LAKE_KEYS}
    ws = jnp.arange(n_windows, dtype=dtype)
    if cryo_state is None:
        from shud_tpu.core.cryo import cryo_init

        cryo_state = cryo_init(1, 1, 1, dtype)
    bc_rows = bc_tables.get("rows") if isinstance(bc_tables, dict) else None
    if bc_maps is None:
        bc_rows = jnp.zeros(n_windows, dtype=jnp.int32)
    else:
        bc_rows = bc_tables["rows"]
    (st, bk, cryo_state, acc_e, acc_r, acc_l), (stages, qdowns) = lax.scan(
        window, (bdf_state, buckets, cryo_state, acc_e0, acc_r0, acc_l0),
        (forc_idx, lai_idx, mf_idx, ws, bc_rows),
    )
    mean_e = {k: v / n_windows for k, v in acc_e.items()}
    mean_r = {k: v / n_windows for k, v in acc_r.items()}
    mean_l = {k: v / n_windows for k, v in acc_l.items()}
    return st, bk, cryo_state, mean_e, mean_r, mean_l, stages, qdowns


@dataclasses.dataclass
class FusedSimulation:
    inp: ProjectInput
    md: MeshData
    dm: MeshData
    fr: ForcingRuntime
    tables: ChunkTables
    cfg: SolverConfig
    bdf: BDFState
    buckets: BucketState
    t: float
    cryo: object = None
    bc_dev: object = None  # (tables dict incl. per-window rows, col maps)
    last_mean_l: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, project: str, base: str = ".", float_dtype=jnp.float64,
               calib=None, inp: "ProjectInput | None" = None,
               wb_exact: "bool | None" = None,
               fr: "ForcingRuntime | None" = None,
               **control_overrides):
        if inp is None:
            inp = load_project(project, base=base)
        if calib is not None:
            inp.calib = calib
        for k, v in control_overrides.items():
            setattr(inp.control, k, v)
        from shud_tpu.io.validate import check_input

        check_input(inp)
        md = build_mesh(inp)
        dm = to_device(md, float_dtype)
        fd = float_dtype
        if fr is None:
            fr = build_forcing(inp, md)
        else:
            # reuse the expensive station/TSR tables, refresh the
            # calibration scalars (autocalibration loops; forcing.py)
            from shud_tpu.driver.forcing import rebuild_cal

            fr = rebuild_cal(fr, inp.calib)
        cs = inp.control
        cfg = SolverConfig(rtol=cs.reltol, atol=cs.abstol,
                           h_init=cs.init_step, h_max=cs.max_step)
        tables = ChunkTables(
            fvals=jnp.asarray(fr.fvals, dtype=fd),
            station_z=jnp.asarray(fr.station_z, dtype=fd),
            lai_vals=jnp.asarray(fr.lai_vals, dtype=fd),
            mf_vals=jnp.asarray(fr.mf_vals, dtype=fd),
            tsr_sx=jnp.asarray(fr.tsr_sx, dtype=fd),
            tsr_sy=jnp.asarray(fr.tsr_sy, dtype=fd),
            tsr_sz=jnp.asarray(fr.tsr_sz, dtype=fd),
            tsr_wdt=jnp.asarray(fr.tsr_wdt, dtype=fd),
            tsr_den=jnp.asarray(fr.tsr_den, dtype=fd),
        )
        cal = fr.cal.__class__(*[jnp.asarray(v, dtype=fd) for v in fr.cal])
        fr.cal = cal
        y0 = jnp.asarray(initial_state(inp, md), dtype=fd)
        ic0, snow0 = initial_buckets(inp, md)
        cryo = None
        if cs.cryosphere:
            from shud_tpu.core.cryo import cryo_init

            gc = inp.calib
            cryo = cryo_init(md.num_ele, int(gc.fzn_surfday),
                             int(gc.fzn_subday), fd)
        # exact water-balance quadrature along the solver trajectory is
        # OPT-IN, mirroring the reference (WB diagnostics only run under
        # SHUD_WB_DIAG=1, shud.cpp:70-75); the default daily budget uses
        # window-end sampled means (docs/VALIDATION.md).  Integrating the
        # ET/outlet rates on every accepted step costs a partial RHS.
        if wb_exact is None:
            wb_exact = os.environ.get("SHUD_WB_DIAG", "0") not in ("0", "")
        quad0 = ({k: jnp.zeros((), dtype=fd)
                  for k in ("et", "qout", "qedge", "qbc", "qss", "nc",
                            "lake_p", "lake_e")} if wb_exact else None)
        return cls(
            inp=inp, md=md, dm=dm, fr=fr, tables=tables, cfg=cfg,
            bdf=bdf_init(cs.start_time, y0, cfg, quad0=quad0),
            buckets=BucketState(ic_stg=jnp.asarray(ic0, dtype=fd),
                                snow=jnp.asarray(snow0, dtype=fd)),
            t=cs.start_time, cryo=cryo,
        )

    def window_indices(self, t0: float, n_windows: int, win: float):
        ts = t0 + np.arange(n_windows) * win
        fi = np.searchsorted(self.fr.t_axis, ts + 1e-9, side="right") - 1
        li = np.searchsorted(self.fr.lai_t, ts + 1e-9, side="right") - 1
        mi = np.searchsorted(self.fr.mf_t, ts + 1e-9, side="right") - 1
        return (jnp.asarray(fi, dtype=jnp.int32),
                jnp.asarray(np.maximum(li, 0), dtype=jnp.int32),
                jnp.asarray(np.maximum(mi, 0), dtype=jnp.int32))

    def advance_interval(self, interval_minutes: float):
        """Advance one output interval; returns (mean_e, mean_r, stages,
        qdowns) as host arrays."""
        cs = self.inp.control
        win = cs.solver_step
        n_windows = int(round(interval_minutes / win))
        fi, li, mi = self.window_indices(self.t, n_windows, win)
        bc_arg = self._bc_tables(self.t, n_windows, win)
        gc = self.inp.calib
        st, bk, cryo, mean_e, mean_r, mean_l, stages, qdowns = run_interval(
            self.dm, self.tables, self.bdf, self.buckets, self.fr.cal,
            self.t, fi, li, mi,
            self.fr.rad_factor_cap, self.fr.rad_cosz_min,
            self.cfg, n_windows, float(win),
            close_boundary=bool(cs.close_boundary),
            terrain_radiation=self.fr.terrain_radiation,
            swnet_mode=self.fr.swnet_mode,
            cryosphere=bool(cs.cryosphere),
            cryo_state=self.cryo,
            cryo_bounds=(gc.fzn_surfmax, gc.fzn_surfmin,
                         gc.fzn_submax, gc.fzn_submin),
            bc_tables=bc_arg,
            et_mode=int(self.fr.et_mode),
            per_edge_out=bool(cs.dt_Qe_subx > 0 or cs.dt_Qe_surfx > 0),
        )
        self.bdf = st
        self.buckets = bk
        if bool(cs.cryosphere):
            self.cryo = cryo
        self.t += interval_minutes
        self.last_mean_l = mean_l
        return mean_e, mean_r, stages, qdowns

    def _bc_tables(self, t0, n_windows, win):
        """Per-window BC value tables (None when the project has no BC/SS
        time series)."""
        if not self.fr.bc:
            return None
        md = self.md
        dtype = self.bdf.t.dtype
        ts = t0 + np.arange(n_windows) * win

        def rows_of(key, ncol_needed):
            if key in self.fr.bc:
                bt, bv = self.fr.bc[key]
                idx = np.clip(
                    np.searchsorted(bt, ts + 1e-9, side="right") - 1, 0, None
                )
                return jnp.asarray(bv[idx], dtype=dtype)
            return jnp.zeros((n_windows, max(ncol_needed, 1)), dtype=dtype)

        tables = {
            "ele_ybc": rows_of("ele_y", int(max(md.i_bc.max(), 0))),
            "ele_qbc": rows_of("ele_q", int(max(-md.i_bc.min(), 0))),
            "ele_qss": rows_of("ele_ss", int(np.abs(md.i_ss).max())),
            "riv_ybc": rows_of("riv_y", int(max(md.riv_bc.max(), 0))),
            "riv_qbc": rows_of("riv_q", int(max(-md.riv_bc.min(), 0))),
            "rows": jnp.arange(n_windows, dtype=jnp.int32),
        }
        maps = {
            "ele_y": jnp.asarray(np.maximum(md.i_bc - 1, 0), jnp.int32),
            "ele_q": jnp.asarray(np.maximum(-md.i_bc - 1, 0), jnp.int32),
            "ele_ss": jnp.asarray(np.maximum(np.abs(md.i_ss) - 1, 0),
                                  jnp.int32),
            "riv_y": jnp.asarray(np.maximum(md.riv_bc - 1, 0), jnp.int32),
            "riv_q": jnp.asarray(np.maximum(-md.riv_bc - 1, 0), jnp.int32),
        }
        return (tables, maps)
