"""Multi-chip runtime: sharded solver windows.

Glues the domain-decomposed RHS (``parallel.sharded``) to the pytree-native
adaptive solver: cell and river blocks live sharded over the device mesh,
lake state is replicated, and ``solve_to`` runs unchanged — its dot
products become cross-device ``psum``s under GSPMD.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from shud_tpu.core import solar as solar_mod
from shud_tpu.core.device import to_device
from shud_tpu.core.landsurface import BucketState, cell_forcing, et_bucket_step
from shud_tpu.core.mesh import MeshData
from shud_tpu.driver.forcing import build_forcing
from shud_tpu.io.project import ProjectInput
from shud_tpu.parallel.partition import ShardedMesh, riv_blocks
from shud_tpu.parallel.sharded import AXIS, make_sharded_rhs, place_params
from shud_tpu.solver.bdf import SolverConfig, bdf_init, solve_to


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_ids=None):
    """Multi-process initialisation (SURVEY §2.4: DP across hosts via
    ``jax.distributed``).

    Call once per process before any jax use; afterwards ``jax.devices()``
    spans every process's devices and every sharded construct in this
    package (RCB partition over the global device count, `shard_map` RHS,
    psum reductions) works unchanged — XLA routes the neighbour-wise halo
    `ppermute`s between processes.  The coordinator (`"host0:8476"`), the
    total process count and this process's rank are explicit arguments: no
    cluster is autodetected.  ``local_device_ids`` lists the
    cards this process drives; give each process on a host its own, so
    that no two processes open the same card (default: all of the host's
    cards, i.e. one process per host).

    Returns (process_index, global_device_count)."""
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    return jax.process_index(), len(jax.devices())


def compute_forcing_blocks(inp: ProjectInput, md: MeshData, sm: ShardedMesh,
                           t: float, tout: float,
                           buckets: BucketState | None = None,
                           fr=None, dm=None, cryo=None,
                           cryo_bounds=(-1.0, -5.0, -3.0, -10.0)):
    """Host-side forcing slice for window [t, tout), scattered to shard
    blocks.  Pass prebuilt ``fr``/``dm`` to amortise across windows (the
    multi-window driver does); otherwise built per call (dry run, tests).

    BC/SS time series (MD_update.cpp:102-189) and the cryosphere frozen
    fractions (MD_ET.cpp:301-311) are applied exactly as the single-chip
    fused driver does: per-window step-semantics row lookup for the BCs,
    and one ``cryo_step`` per window when a ``cryo`` state is passed.
    Returns (fs_cell, fs_riv, new_buckets, new_cryo)."""
    if fr is None:
        fr = build_forcing(inp, md)
    if dm is None:
        dm = to_device(md)
    sv = jnp.asarray(fr.station_values(t))
    sx, sy, sz, wdt, den = [jnp.asarray(a) for a in fr.tsr_sample(t)]
    fac = solar_mod.tsr_factor(dm.nx, dm.ny, dm.nz, sx, sy, sz, wdt, den,
                               fr.rad_factor_cap, fr.rad_cosz_min)
    cf = cell_forcing(dm, sv, fr.station_z, jnp.asarray(fr.lai_at(t)),
                      jnp.asarray(fr.mf_at(t)), fac, fr.cal,
                      swnet_mode=fr.swnet_mode, et_mode=fr.et_mode)
    if buckets is None:
        buckets = BucketState(
            ic_stg=jnp.zeros(md.num_ele), snow=jnp.zeros(md.num_ele)
        )
    out = et_bucket_step(dm, cf, buckets, tout - t, fr.cal.c_ismax)

    def blocks(v):
        v = np.asarray(v)
        buf = np.zeros((sm.p, sm.np_cells))
        sizes = sm.valid.sum(axis=1)
        flat = v[sm.perm]
        pos = 0
        for q in range(sm.p):
            buf[q, : sizes[q]] = flat[pos : pos + sizes[q]]
            pos += sizes[q]
        return buf

    ne = md.num_ele
    if cryo is not None:
        from shud_tpu.core.cryo import cryo_step

        cryo, fu_surf, fu_sub = cryo_step(cryo, cf.temp, t, *cryo_bounds)
        fu_surf = np.asarray(fu_surf)
        fu_sub = np.asarray(fu_sub)
    else:
        fu_surf = fu_sub = np.ones(ne)
    bc = fr.bc_values(md, t)
    fs_cell = {
        "net_prcp": blocks(out.net_prcp), "prcp": blocks(cf.prcp),
        "pot_evap": blocks(cf.pot_evap), "pot_tran": blocks(cf.pot_tran),
        "e_ic": blocks(out.e_ic), "lai": blocks(cf.lai),
        "fu_surf": blocks(fu_surf), "fu_sub": blocks(fu_sub),
        "ele_ybc": blocks(bc["ele_ybc"]), "ele_qbc": blocks(bc["ele_qbc"]),
        "ele_qss": blocks(bc["ele_qss"]),
    }
    fs_riv = {"riv_ybc": riv_blocks(sm, bc["riv_ybc"]),
              "riv_qbc": riv_blocks(sm, bc["riv_qbc"])}
    return fs_cell, fs_riv, out.state, cryo


# interval accumulator layout (window-end samples summed over windows;
# interval means = /n, matching the fused driver's Print_Ctrl semantics)
_ACC_BLK = ("q_rech", "q_sub_tot", "q_surf_tot", "q_e2r_sub", "q_e2r_surf",
            "q_infil", "q_exfil", "e_ic", "trans", "evapo", "eta",
            "y_surf", "y_unsat", "y_gw")
_ACC_RIV = ("q_riv_up", "q_riv_down", "q_riv_sub", "q_riv_surf", "y_riv")
_ACC_LAKE = ("y_lake", "lake_area", "q_lake_evap", "q_lake_prcp",
             "q_lake_rivin", "q_lake_surf", "q_lake_sub",
             # always-zero in the reference (dead accumulation,
             # MD_update.cpp:184); emitted for file-set parity
             "q_lake_rivout")
_ACC_DENSE = ("prcp", "net_prcp", "etp", "rn_h", "rn_t", "rn_factor",
              "y_ic", "y_snow")


def _accum_interval(tree, diag, extras, y, buckets):
    """One window's contribution to the interval accumulators (jitted)."""
    b = tree["blk"]
    blk = {
        k: b[k] + diag[k]
        for k in ("q_rech", "q_sub_tot", "q_surf_tot", "q_e2r_sub",
                  "q_e2r_surf", "q_infil", "q_exfil", "e_ic")
    }
    blk["trans"] = b["trans"] + diag["tu"] + diag["tg"]
    blk["evapo"] = b["evapo"] + diag["es"] + diag["eu"] + diag["eg"]
    blk["eta"] = (b["eta"] + diag["e_ic"] + diag["es"] + diag["eu"]
                  + diag["eg"] + diag["tu"] + diag["tg"])
    blk["y_surf"] = b["y_surf"] + y["sf"]
    blk["y_unsat"] = b["y_unsat"] + y["us"]
    blk["y_gw"] = b["y_gw"] + y["gw"]
    edge = {k: tree["edge"][k] + diag[k] for k in ("q_esub", "q_esurf")}
    riv = {k: tree["riv"][k] + diag[k] for k in _ACC_RIV if k != "y_riv"}
    riv["y_riv"] = tree["riv"]["y_riv"] + y["riv"]
    lake = {k: tree["lake"][k] + diag[k] for k in _ACC_LAKE
            if k not in ("y_lake", "q_lake_rivout")}
    lake["y_lake"] = tree["lake"]["y_lake"] + y["lake"]
    lake["q_lake_rivout"] = tree["lake"]["q_lake_rivout"]  # stays zero
    d = tree["dense"]
    dense = {k: d[k] + extras[k] for k in _ACC_DENSE
             if k not in ("y_ic", "y_snow")}
    dense["y_ic"] = d["y_ic"] + buckets.ic_stg
    dense["y_snow"] = d["y_snow"] + buckets.snow
    return {"blk": blk, "edge": edge, "riv": riv, "lake": lake,
            "dense": dense}


# make_sharded_rhs returns a fresh closure each call; reuse it per ShardedMesh
# so solve_to's jit cache hits across windows (stable function identity).
_RHS_CACHE: dict[tuple, tuple] = {}


def _cached_sharded_rhs(sm: ShardedMesh, float_dtype=None,
                        close_boundary: bool = True):
    key = (id(sm), str(float_dtype), close_boundary)
    if key not in _RHS_CACHE:
        _RHS_CACHE.clear()  # keep at most one mesh alive (avoid id reuse bugs)
        _RHS_CACHE[key] = (
            sm,
            make_sharded_rhs(sm, float_dtype=float_dtype, with_diag=True,
                             close_boundary=close_boundary),
        )
    return _RHS_CACHE[key][1]


def _make_quad_fn(diag_fn, close_boundary: bool = True):
    """Basin water-balance quadrature rates [m3/min] for the SHARDED block
    layout — the sharded twin of ``driver/fused.py``'s ``quad_rates``
    (reference basin columns, WaterBalanceDiag.cpp:440-530 + lake terms).
    Reuses the sharded RHS's own diagnostics so the budget integrates the
    physics actually solved; each scalar is a masked global sum, which
    GSPMD lowers to per-shard partials + one psum."""
    from shud_tpu.core import physics as _ph

    def quad_fn(t, y, params):
        cell, _edge, _seg, riv, _halo, lake, fs_cell, fs_riv = params
        _dy, dg = diag_fn(t, y, params)
        fd = y["sf"].dtype
        valid = cell["valid"]
        rvalid = riv["valid"]
        area = jnp.where(valid, cell["area"], 0.0)
        nl = lake["zmin"].shape[0] if lake else 0

        # canopy evaporation: the bucket's rate is the mass actually
        # removed from interception storage (fused.py quad_rates)
        e_ic_q = fs_cell["e_ic"]
        if nl > 0:
            is_lake = cell["i_lake"] > 0
            e_ic_q = jnp.where(is_lake, 0.0, e_ic_q)
        eta = (e_ic_q + dg["es"] + dg["eu"] + dg["eg"]
               + dg["tu"] + dg["tg"])
        et = jnp.sum(jnp.where(valid, eta, 0.0) * area)

        is_outlet = (~riv["has_down"]) & (riv["riv_to_lake"] < 0) & rvalid
        qout = jnp.sum(jnp.where(is_outlet, dg["q_riv_down"], 0.0))

        if close_boundary:
            qedge = jnp.zeros((), fd)
        else:
            is_bnd = ~_edge["has_nb"]
            if nl > 0:
                is_bnd = is_bnd & (lake["lakenabr"] < 0)
            is_bnd = is_bnd & valid[..., None]
            qedge = jnp.sum(jnp.where(
                is_bnd, dg["q_esurf"] + dg["q_esub"], 0.0))

        qbc = jnp.sum(jnp.where((cell["i_bc"] < 0) & valid,
                                fs_cell["ele_qbc"], 0.0)) \
            + jnp.sum(jnp.where(rvalid, fs_riv["riv_qbc"], 0.0))
        qss = jnp.sum(jnp.where((cell["i_ss"] != 0) & valid,
                                fs_cell["ele_qss"], 0.0))

        # river non-conservation: the dA clamp + fun_dAtodY conversion
        # (MD_f.cpp:162-166, functions.hpp:141-153)
        rs = jnp.where(riv["riv_bc"] > 0, fs_riv["riv_ybc"], y["riv"])
        bw, bs = riv["riv_bottom_width"], riv["riv_bank_slope"]
        csa = jnp.maximum(rs * (bw + rs * bs), 0.0)
        topw = jnp.maximum(rs * bs * 2.0 + bw, 0.0)
        rlen = jnp.where(rvalid, riv["riv_length"], 1.0)
        d_nat = (-dg["q_riv_up"] - dg["q_riv_surf"] - dg["q_riv_sub"]
                 - dg["q_riv_down"] + fs_riv["riv_qbc"]) / rlen
        d_cl = jnp.maximum(d_nat, -csa)
        drv = _ph.fun_da_to_dy(d_cl, topw, bs)
        drv = jnp.where(riv["riv_bc"] > 0, 0.0, drv)
        nc = jnp.sum(jnp.where(rvalid, (topw * drv - d_nat) * rlen, 0.0))
        if nl > 0:
            # fluxes run against lake cells and then their DY is zeroed
            # (MD_f.cpp:146-150) — discarded exchange is non-conservation
            nc = nc + jnp.sum(jnp.where(
                is_lake & valid, dg["q_surf_tot"] + dg["q_sub_tot"], 0.0))
            lake_p = jnp.sum(dg["q_lake_prcp"] * dg["lake_area"])
            lake_e = jnp.sum(dg["q_lake_evap"] * dg["lake_area"])
        else:
            lake_p = jnp.zeros((), fd)
            lake_e = jnp.zeros((), fd)
        return {"et": et, "qout": qout, "qedge": qedge, "qbc": qbc,
                "qss": qss, "nc": nc, "lake_p": lake_p, "lake_e": lake_e}

    return quad_fn


def _window_forcing_impl(dm, sv, station_z, lai, mf, sx, sy, sz, wdt, den,
                         rad_cap, rad_cosz_min, cal, buckets, dt_min,
                         cryo_state, t, cryo_bounds, bc_dense,
                         idx, valid, rividx, rivvalid,
                         swnet_mode, et_mode, cryo_on, fd,
                         terrain_radiation=True):
    """Whole-window forcing transform ON DEVICE, blocks included.

    The round-3 path rebuilt the forcing blocks host-side every window
    (numpy scatter + per-field device_put) — per-window host latency the
    single-chip driver had already eliminated (docs/PERF.md
    "Production-loop host round-trips").  Everything here runs in one jit:
    TSR factor → PET/forcing transform → bucket update → cryosphere step →
    BC overlay → ONE gather per field into the [P, Np] shard blocks."""
    if terrain_radiation:
        fac = solar_mod.tsr_factor(dm.nx, dm.ny, dm.nz, sx, sy, sz, wdt,
                                   den, rad_cap, rad_cosz_min)
    else:
        fac = jnp.ones_like(dm.nx)
    cf = cell_forcing(dm, sv, station_z, lai, mf, fac, cal,
                      swnet_mode=swnet_mode, et_mode=et_mode,
                      terrain_radiation=terrain_radiation)
    out = et_bucket_step(dm, cf, buckets, dt_min, cal.c_ismax)
    if cryo_on:
        from shud_tpu.core.cryo import cryo_step

        cryo_state, fu_surf, fu_sub = cryo_step(
            cryo_state, cf.temp, t,
            cryo_bounds[0], cryo_bounds[1], cryo_bounds[2], cryo_bounds[3],
        )
    else:
        fu_surf = fu_sub = jnp.ones_like(dm.nx)

    def blocks(v):
        return jnp.where(valid, jnp.asarray(v, fd)[idx], 0.0)

    def rblocks(v):
        return jnp.where(rivvalid, jnp.asarray(v, fd)[rividx], 0.0)

    fs_cell = {
        "net_prcp": blocks(out.net_prcp), "prcp": blocks(cf.prcp),
        "pot_evap": blocks(cf.pot_evap), "pot_tran": blocks(cf.pot_tran),
        "e_ic": blocks(out.e_ic), "lai": blocks(cf.lai),
        "fu_surf": blocks(fu_surf), "fu_sub": blocks(fu_sub),
        "ele_ybc": blocks(bc_dense["ele_ybc"]),
        "ele_qbc": blocks(bc_dense["ele_qbc"]),
        "ele_qss": blocks(bc_dense["ele_qss"]),
    }
    fs_riv = {"riv_ybc": rblocks(bc_dense["riv_ybc"]),
              "riv_qbc": rblocks(bc_dense["riv_qbc"])}
    extras = {"prcp": cf.prcp, "net_prcp": out.net_prcp, "etp": cf.etp,
              "rn_h": cf.rn_h, "rn_t": cf.rn_t, "rn_factor": cf.rn_factor}
    return fs_cell, fs_riv, out.state, cryo_state, extras


def sharded_window_step(inp: ProjectInput, md: MeshData, sm: ShardedMesh,
                        ys: dict, t0: float, tout: float,
                        cfg: SolverConfig | None = None):
    """One solver window on the device mesh; returns the final BDFState."""
    mesh, rhs_fn, _diag_fn, params = _cached_sharded_rhs(sm)
    cell_sh = NamedSharding(mesh, P(AXIS))
    rep_sh = NamedSharding(mesh, P())

    def put_cell(v):
        return jax.device_put(jnp.asarray(v), cell_sh)

    def put_rep(v):
        return jax.device_put(jnp.asarray(v), rep_sh)

    fs_cell, fs_riv, _, _ = compute_forcing_blocks(inp, md, sm, t0, tout)
    fs_cell = {k: put_cell(v) for k, v in fs_cell.items()}
    fs_riv = {k: put_cell(v) for k, v in fs_riv.items()}
    params_dev = place_params(mesh, params)

    y_dev = {
        "sf": put_cell(ys["sf"]), "us": put_cell(ys["us"]),
        "gw": put_cell(ys["gw"]), "riv": put_cell(ys["riv"]),
        "lake": put_rep(ys["lake"]),
    }
    if cfg is None:
        cs = inp.control
        cfg = SolverConfig(rtol=cs.reltol, atol=cs.abstol,
                           h_init=cs.init_step, h_max=cs.max_step)
    state = bdf_init(t0, y_dev, cfg)
    return solve_to(rhs_fn, state, tout, params_dev + (fs_cell, fs_riv), cfg)


class ShardedSimulation:
    """Multi-window domain-decomposed simulation (the multi-chip production
    driver).

    The single-device ``driver.simulate.Simulation`` equivalent for a
    ``jax.sharding.Mesh`` of P devices: cell and river blocks live sharded,
    lakes replicated, one BDF state persists across windows (multistep
    history survives, as in the fused driver), and each window re-binds only
    the forcing tables.  The reference has no counterpart — its only
    parallelism is OpenMP threads (SURVEY §2.4/§5.7)."""

    def __init__(self, inp: ProjectInput, md: MeshData, p: int,
                 cfg: SolverConfig | None = None, float_dtype=None,
                 wb_exact: "bool | None" = None):
        import os as _os

        import jax.numpy as jnp

        from shud_tpu.driver.init import initial_buckets, initial_state
        from shud_tpu.parallel.partition import build_sharded_mesh, shard_state

        self.inp = inp
        self.md = md
        self.fd = float_dtype or jnp.float64
        self.sm = build_sharded_mesh(md, p)
        self.fr = build_forcing(inp, md)
        self.dm = to_device(md)
        cs = inp.control
        self.cfg = cfg or SolverConfig(rtol=cs.reltol, atol=cs.abstol,
                                       h_init=cs.init_step, h_max=cs.max_step)
        self.mesh, self.rhs_fn, self.diag_fn, params = _cached_sharded_rhs(
            self.sm, float_dtype=float_dtype,
            close_boundary=bool(cs.close_boundary))
        self.cell_sh = NamedSharding(self.mesh, P(AXIS))
        self.rep_sh = NamedSharding(self.mesh, P())
        self.params_dev = place_params(self.mesh, params)
        ic0, snow0 = initial_buckets(inp, md)
        self.buckets = BucketState(ic_stg=jnp.asarray(ic0),
                                   snow=jnp.asarray(snow0))
        gc = inp.calib
        self.cryo = None
        self.cryo_bounds = (gc.fzn_surfmax, gc.fzn_surfmin,
                            gc.fzn_submax, gc.fzn_submin)
        if cs.cryosphere:
            from shud_tpu.core.cryo import cryo_init

            self.cryo = cryo_init(md.num_ele, int(gc.fzn_surfday),
                                  int(gc.fzn_subday), jnp.float64)
        ys = shard_state(self.sm, initial_state(inp, md))
        y_dev = {
            "sf": self._put_cell(ys["sf"]), "us": self._put_cell(ys["us"]),
            "gw": self._put_cell(ys["gw"]), "riv": self._put_cell(ys["riv"]),
            "lake": self._put_rep(ys["lake"]),
        }
        # exact flux quadrature along the trajectory: OPT-IN like the
        # reference (SHUD_WB_DIAG=1, shud.cpp:70-75) and the fused driver
        # (FusedSimulation.create wb_exact); one diag RHS per accepted step
        if wb_exact is None:
            wb_exact = _os.environ.get("SHUD_WB_DIAG", "0") not in ("0", "")
        self.quad_fn = None
        quad0 = None
        if wb_exact:
            quad0 = {k: jnp.zeros((), dtype=self.fd)
                     for k in ("et", "qout", "qedge", "qbc", "qss", "nc",
                               "lake_p", "lake_e")}
            self.quad_fn = _make_quad_fn(
                self.diag_fn, close_boundary=bool(cs.close_boundary))
        self.state = bdf_init(cs.start_time, y_dev, self.cfg, quad0=quad0)
        self.t = cs.start_time

        # device-side forcing-block tables: one gather per field replaces
        # the host-side numpy scatter + per-field device_put per window
        sm_ = self.sm
        idx = np.zeros((sm_.p, sm_.np_cells), np.int32)
        idx[sm_.old_to_shard, sm_.old_to_slot] = np.arange(md.num_ele)
        rividx = np.zeros((sm_.p, sm_.nr_riv), np.int32)
        rivvalid = np.zeros((sm_.p, sm_.nr_riv), bool)
        if md.num_riv:
            rividx[sm_.riv_owner, sm_.riv_slot_of] = np.arange(md.num_riv)
            rivvalid[sm_.riv_owner, sm_.riv_slot_of] = True
        put_c = lambda v: jax.device_put(jnp.asarray(v), self.cell_sh)  # noqa: E731
        self._blk_idx = put_c(idx)
        self._blk_valid = put_c(np.asarray(sm_.valid))
        self._riv_idx = put_c(rividx)
        self._riv_valid = put_c(rivvalid)
        self._bc_zeros = {
            "ele_ybc": jnp.zeros(md.num_ele), "ele_qbc": jnp.zeros(md.num_ele),
            "ele_qss": jnp.zeros(md.num_ele),
            "riv_ybc": jnp.zeros(md.num_riv), "riv_qbc": jnp.zeros(md.num_riv),
        }
        from functools import partial as _partial

        cell_tree = {k: self.cell_sh for k in (
            "net_prcp", "prcp", "pot_evap", "pot_tran", "e_ic", "lai",
            "fu_surf", "fu_sub", "ele_ybc", "ele_qbc", "ele_qss")}
        riv_tree = {"riv_ybc": self.cell_sh, "riv_qbc": self.cell_sh}
        self._winforc = jax.jit(
            _partial(_window_forcing_impl,
                     swnet_mode=self.fr.swnet_mode,
                     et_mode=int(self.fr.et_mode),
                     cryo_on=bool(cs.cryosphere), fd=self.fd,
                     terrain_radiation=self.fr.terrain_radiation),
            out_shardings=(cell_tree, riv_tree, None, None, None),
        )
        if self.cryo is None:
            from shud_tpu.core.cryo import cryo_init as _ci

            self._cryo_dummy = _ci(1, 1, 1)
        self._accum_fn = jax.jit(_accum_interval)
        self._diag_jit = jax.jit(self.diag_fn)

    def _put_cell(self, v):
        import jax.numpy as jnp

        v = jnp.asarray(v)
        if v.dtype.kind == "f":
            v = v.astype(self.fd)
        return jax.device_put(v, self.cell_sh)

    def _put_rep(self, v):
        import jax.numpy as jnp

        v = jnp.asarray(v)
        if v.dtype.kind == "f":
            v = v.astype(self.fd)
        return jax.device_put(v, self.rep_sh)

    def _forcing_dev(self, tout: float):
        """Per-window forcing, entirely on device (one jit + tiny host
        lookups); advances buckets and the cryosphere state."""
        fr, t = self.fr, self.t
        sv = jnp.asarray(fr.station_values(t))
        sx, sy, sz, wdt, den = [jnp.asarray(a) for a in fr.tsr_sample(t)]
        if fr.bc:
            bc = {k: jnp.asarray(v)
                  for k, v in fr.bc_values(self.md, t).items()}
        else:
            bc = self._bc_zeros
        cryo = self.cryo if self.cryo is not None else self._cryo_dummy
        fs_cell, fs_riv, buckets, cryo, extras = self._winforc(
            self.dm, sv, jnp.asarray(fr.station_z),
            jnp.asarray(fr.lai_at(t)), jnp.asarray(fr.mf_at(t)),
            sx, sy, sz, wdt, den,
            fr.rad_factor_cap, fr.rad_cosz_min, fr.cal, self.buckets,
            tout - t, cryo, t, jnp.asarray(self.cryo_bounds), bc,
            self._blk_idx, self._blk_valid, self._riv_idx, self._riv_valid,
        )
        self.buckets = buckets
        if self.cryo is not None:
            self.cryo = cryo
        return fs_cell, fs_riv, extras

    def advance_window(self, tout: float, acc=None):
        """Advance the sharded solver to ``tout``; state updates in place.

        ``acc``: optional interval accumulator (``acc_zero``) — when given,
        one extra diag RHS eval at the accepted state accumulates the full
        output-channel set on device and the per-window river stage +
        Qdown are stacked for flood alerting; returns the new acc."""
        fs_cell, fs_riv, extras = self._forcing_dev(tout)
        self.state = solve_to(self.rhs_fn, self.state, tout,
                              self.params_dev + (fs_cell, fs_riv), self.cfg,
                              self.quad_fn)
        self.t = tout
        if acc is None:
            return None
        _, diag = self._diag_jit(tout, self.state.y,
                                 self.params_dev + (fs_cell, fs_riv))
        tree = self._accum_fn(acc["tree"], diag, extras, self.state.y,
                              self.buckets)
        stages = acc["stages"] + [self.state.y["riv"]]
        qdowns = acc["qdowns"] + [diag["q_riv_down"]]
        return {"tree": tree, "stages": stages, "qdowns": qdowns,
                "n": acc["n"] + 1}

    def acc_zero(self):
        """Fresh interval accumulator (device zeros in the block layout)."""
        sm, md, fd = self.sm, self.md, self.fd
        zb = jnp.zeros((sm.p, sm.np_cells), dtype=fd)
        ze = jnp.zeros((sm.p, sm.np_cells, 3), dtype=fd)
        zr = jnp.zeros((sm.p, sm.nr_riv), dtype=fd)
        zl = jnp.zeros((md.num_lake,), dtype=fd)
        zd = jnp.zeros((md.num_ele,))
        tree = {
            "blk": {k: zb for k in _ACC_BLK},
            "edge": {k: ze for k in ("q_esub", "q_esurf")},
            "riv": {k: zr for k in _ACC_RIV},
            "lake": {k: zl for k in _ACC_LAKE},
            "dense": {k: zd for k in _ACC_DENSE},
        }
        return {"tree": tree, "stages": [], "qdowns": [], "n": 0}

    def y_full(self) -> np.ndarray:
        """Gather the global state vector to host (reference Y layout)."""
        from shud_tpu.parallel.partition import unshard_state

        y = self.state.y
        return unshard_state(self.sm, {k: np.asarray(v)
                                       for k, v in y.items()})

    @property
    def bdf(self):
        """Solver-state alias so io/checkpoint.py works unchanged."""
        return self.state

    @bdf.setter
    def bdf(self, st):
        def place(v):
            v = jnp.asarray(v)
            sh = self.cell_sh if v.ndim >= 2 else self.rep_sh
            return jax.device_put(v, sh)

        self.state = jax.tree_util.tree_map(place, st)

    @property
    def nfe(self) -> int:
        return int(self.state.nfe)

    def run(self, t_end: float, observer=None):
        step = self.inp.control.solver_step
        while self.t < t_end - 1e-9:
            tout = min(self.t + step, t_end)
            self.advance_window(tout)
            if observer is not None:
                observer(self)


def run_project_sharded(project: str, base: str = ".", p: int | None = None,
                        end_day: float | None = None, verbose: bool = True,
                        outpath: str | None = None, float_dtype=None,
                        resume: str | None = None,
                        inp=None, calib=None, **overrides):
    """Multi-chip production driver: ``./shud <prj>`` over a P-device mesh
    with the FULL output stack of the single-chip driver (run_fast.py) —
    every Print_Ctrl channel run_fast registers, flood alert, basin
    water-balance budget, reference-format restart + binary checkpoint,
    time log — and ONE batched ``jax.device_get`` per output interval
    (channel means, flood stages, state, counters all ride one fetch).

    Reference: the C++ driver applies the identical
    output subsystem under its OpenMP mode (Model_Control.cpp:930-962,
    FloodAlert.cpp:115-131).

    MULTI-HOST: under ``jax.distributed`` (``--distributed``) every rank
    executes this function; all device work (window solves, forcing jits,
    interval accumulators) is collective over the global mesh, the
    per-interval fetch replicates the sharded arrays (one all-gather,
    ``device_get_global``), and ONLY process 0 owns the output files.
    Proven end-to-end by ``tools/dryrun_distributed.py --driver`` (2
    CPU processes x 4 devices vs the single-process P=8 run)."""
    import os as _os
    import time as _time

    from shud_tpu.core.device import device_get_global
    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.diag.waterbalance import WaterBalance
    from shud_tpu.driver.run_fast import IntervalWriter
    from shud_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from shud_tpu.io.output import (
        FloodAlert,
        PrintCtrl,
        TimeLog,
        write_restart,
    )
    from shud_tpu.io.project import load_project, write_calib
    from shud_tpu.io.validate import check_input
    from shud_tpu.utils.errors import NanError
    from shud_tpu.utils.timectx import TimeContext

    if inp is None:
        inp = load_project(project, base=base)
    if calib is not None:
        inp.calib = calib
    if end_day is not None:
        inp.control.day_end = end_day
    for k, v in overrides.items():
        setattr(inp.control, k, v)
    if outpath:
        inp.paths.outpath = outpath
    check_input(inp)
    md = build_mesh(inp)
    if p is None:
        p = len(jax.devices())
        while p & (p - 1):
            p -= 1  # largest power of two <= device count
    is_main = jax.process_index() == 0
    verbose = verbose and is_main
    sim = ShardedSimulation(inp, md, p, float_dtype=float_dtype)
    if resume:
        load_checkpoint(resume, sim)
        if verbose:
            print(f"resumed from {resume} at t={sim.t/1440.0:.2f} days")
    cs = inp.control
    paths = inp.paths
    sm = sim.sm
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    t_end = cs.end_time if end_day is None else end_day * 1440.0
    if is_main:
        _os.makedirs(paths.outpath, exist_ok=True)

    writer = IntervalWriter(sim, io_enabled=is_main)
    interval = writer.interval
    flood = tlog = wb = wb_ele = None
    if is_main:
        flood = FloodAlert(
            _os.path.join(paths.outpath, f"{paths.project}.flood.csv"),
            md.riv_depth,
        )
        tlog = TimeLog(
            _os.path.join(paths.outpath, f"{paths.project}.time.csv"))
        wb = WaterBalance(
            md, _os.path.join(paths.outpath, f"{paths.project}.wb.basin.csv")
        )
        # per-element residual channel, opt-in like the reference's
        # SHUD_WB_DIAG=1 (WaterBalanceDiag.cpp:258-370) — run_fast parity
        if _os.environ.get("SHUD_WB_DIAG", "0") not in ("0", ""):
            wb_ele = PrintCtrl(
                _os.path.join(paths.outpath, f"{paths.project}.elevwbres"),
                inp.forc.start_yyyymmdd, int(interval), False, ne,
            )
        write_calib(inp.calib, _os.path.join(
            paths.outpath, f"{paths.project}.cfg.calib.bak"))
        paths.save_project_file()
        if _os.environ.get("SHUD_DEBUG_TABLES", "0") not in ("0", ""):
            from shud_tpu.io.debugtables import write_debug_tables

            write_debug_tables(md, inp, paths.outpath)

    def uc(b):  # unshard a [P, Np(,3)] cell block
        return np.asarray(b)[sm.old_to_shard, sm.old_to_slot]

    def ur(b):
        b = np.asarray(b)
        return (b[sm.riv_owner, sm.riv_slot_of] if nr
                else b.reshape(0))

    def _fetch(acc=None):
        """ONE batched device->host transfer per interval (collective
        all-gather first when running multi-process)."""
        tree = {"y": sim.state.y, "ic": sim.buckets.ic_stg,
                "snow": sim.buckets.snow, "nfe": sim.state.nfe,
                "quad": sim.state.quad}
        if acc is not None:
            tree["acc"] = acc["tree"]
            tree["stages"] = acc["stages"]
            tree["qdowns"] = acc["qdowns"]
        return device_get_global(tree)

    def _dense_y(host):
        yb = host["y"]
        return np.concatenate([
            uc(yb["sf"]), uc(yb["us"]), uc(yb["gw"]), ur(yb["riv"]),
            np.asarray(yb["lake"]),
        ])

    def _means(host, n):
        a = host["acc"]
        mean_e = {k: uc(v) / n for k, v in a["blk"].items()}
        mean_e.update({k: np.asarray(v) / n for k, v in a["dense"].items()})
        for j in range(3):
            mean_e[f"q_esub{j}"] = uc(a["edge"]["q_esub"])[:, j] / n
            mean_e[f"q_esurf{j}"] = uc(a["edge"]["q_esurf"])[:, j] / n
        mean_r = {k: ur(v) / n for k, v in a["riv"].items()}
        mean_l = {k: np.asarray(v) / n for k, v in a["lake"].items()}
        return mean_e, mean_r, mean_l

    host = _fetch()
    y_host = _dense_y(host)
    if is_main:
        write_restart(
            _os.path.join(paths.outpath, f"{paths.project}.cfg.ic.bak"), 0.0,
            host["ic"], host["snow"],
            y_host[:ne], y_host[ne:2*ne], y_host[2*ne:3*ne],
            y_host[3*ne:3*ne+nr], y_host[3*ne+nr:] if nl else None,
        )

    tc = TimeContext(inp.forc.start_yyyymmdd)
    wall0 = _time.time()
    cpu0 = _time.process_time()
    last_nfe = int(host["nfe"])
    win = cs.solver_step
    while sim.t < t_end - 1e-9:
        this_int = min(interval, t_end - sim.t)
        y0 = y_host
        bk0 = (host["ic"], host["snow"])
        quad0 = ({k: float(v) for k, v in host["quad"].items()}
                 if host["quad"] is not None else None)
        t0 = sim.t
        acc = sim.acc_zero()
        while sim.t < t0 + this_int - 1e-9:
            acc = sim.advance_window(
                min(sim.t + win, t0 + this_int), acc)
        host = _fetch(acc)
        y_host = _dense_y(host)
        mean_e, mean_r, mean_l = _means(host, acc["n"])
        if is_main:
            writer.write(sim.t, mean_e, mean_r, mean_l)
            for w in range(acc["n"]):
                flood.check(t0 + (w + 1) * win, ur(host["stages"][w]),
                            ur(host["qdowns"][w]))
            # exact trajectory quadrature when SHUD_WB_DIAG=1 (run_fast
            # parity; the sampled means carry the documented switching
            # bias, docs/VALIDATION.md)
            quad_kwargs = {}
            if quad0 is not None:
                q1 = {k: float(v) for k, v in host["quad"].items()}
                quad_kwargs = dict(
                    et_m3=q1["et"] - quad0["et"],
                    qout_m3=q1["qout"] - quad0["qout"],
                    qedge_m3=q1["qedge"] - quad0["qedge"],
                    qbc_m3=q1["qbc"] - quad0["qbc"],
                    qss_m3=q1["qss"] - quad0["qss"],
                    nc_m3=q1["nc"] - quad0["nc"],
                    lake_p_m3=q1["lake_p"] - quad0["lake_p"],
                    lake_e_m3=q1["lake_e"] - quad0["lake_e"],
                )
            wb.interval(t0, sim.t, y0, y_host, mean_e, mean_r,
                        buckets0=bk0, buckets1=(host["ic"], host["snow"]),
                        mean_lake=mean_l, **quad_kwargs)
            if wb_ele is not None:
                wb_ele.push(sim.t, wb.element_residuals(
                    t0, sim.t, y0, y_host, mean_e))
        nfe = int(host["nfe"])
        perc = 100.0 * (sim.t - cs.start_time) / (t_end - cs.start_time)
        if verbose:
            print(f"{tc.iso(sim.t)}\t{sim.t/1440.0:8.2f} day\t{perc:6.2f}%"
                  f"\t{_time.time()-wall0:8.2f} s\t{nfe - last_nfe}"
                  f"\t({p} shards)", flush=True)
        if is_main:
            tlog.write(sim.t, perc, _time.process_time() - cpu0,
                       _time.time() - wall0, nfe - last_nfe)
        last_nfe = nfe
        if int(sim.t) % cs.update_ic_step == 0 or sim.t >= t_end - 1e-9:
            if not np.isfinite(y_host).all():
                bad = int(np.flatnonzero(~np.isfinite(y_host))[0])
                raise NanError(
                    f"non-finite state at t={sim.t:.1f} min (index {bad})"
                )
            if is_main:
                write_restart(
                    _os.path.join(paths.outpath,
                                  f"{paths.project}.cfg.ic.update"),
                    sim.t, host["ic"], host["snow"],
                    y_host[:ne], y_host[ne:2*ne], y_host[2*ne:3*ne],
                    y_host[3*ne:3*ne+nr], y_host[3*ne+nr:] if nl else None,
                )
            # collective (all ranks gather; rank 0 writes)
            save_checkpoint(
                _os.path.join(paths.outpath, f"{paths.project}.ckpt.npz"),
                sim,
            )
    writer.close()
    if is_main:
        flood.close()
        tlog.close()
        wb.close()
        if wb_ele is not None:
            wb_ele.close()
    if verbose:
        b = sim.state
        print(f"\nFinal stats: nsteps={int(b.nsteps)} nfe={int(b.nfe)} "
              f"netf={int(b.nfails)} ncfn={int(b.nnifails)}; wall "
              f"{_time.time()-wall0:.1f} s")
    return sim
