"""Sharded RHS: the full dY/dt under ``shard_map`` domain decomposition.

Each device owns one contiguous cell block AND one block of river reaches
(each reach owned by the shard holding most of its segments' elements).
Communication per RHS evaluation is **neighbour-wise** over the shard
adjacency graph (SURVEY §5.7/§5.8): the partition pre-computes an
edge-coloured round schedule (``partition.ExchangePlan``) and each round is
one ``lax.ppermute`` in which a shard exchanges packed boundary blocks with
exactly one neighbour shard — payload O(edge-cut), not the O(P·B) of an
``all_gather``.  Three exchanges ride the same K rounds:

* forward cells: (sf, gw, effKH) of exported boundary cells;
* forward rivers: stage of reaches referenced by remote segments or remote
  upstream reaches;
* reverse rivers: per-remote-reach flux partials (Qsurf, Qsub, Qup) sent
  back to the reach owner — the distributed counterpart of the reference's
  serial ``PassValue`` scatter-reduction (MD_f.cpp:217-257).

Lakes stay replicated (Nlake is tiny); per-lake reductions complete with
``psum``.  The only other global communication is the solver's dot
products — the same communication structure CVODE+MPI would have, as
XLA collectives.

Physics is shared with the single-chip path (``shud_tpu.core.rhs``
elementwise kernels); parity is enforced by the sharded-vs-unsharded
equivalence test (tests/test_sharding.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.ops import segment_sum
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shud_tpu.config import GRAV, MAXYSURF, ZERO
from shud_tpu.core import physics as ph
from shud_tpu.core.rhs import (
    _lake_toparea,
    et_flux,
    flux_infiltration,
    flux_recharge,
    lake_cell_update,
    update_element,
)
from shud_tpu.parallel.partition import ExchangePlan, ShardedMesh

AXIS = "shards"


class _CellView:
    """Adapter presenting per-shard cell dicts with MeshData attribute names
    so the core elementwise kernels run unchanged on local blocks."""

    _MAP = {
        "aq_depth": "aq_depth", "mac_d": "mac_d", "mac_ksat_h": "mac_ksat_h",
        "geo_v_area_f": "geo_v_area_f", "ksat_h": "ksat_h",
        "inf_ksat_v": "inf_ksat_v", "mac_ksat_v": "mac_ksat_v",
        "h_area_f": "h_area_f", "theta_s": "theta_s", "theta_r": "theta_r",
        "theta_fc": "theta_fc", "beta": "beta", "inf_d": "inf_d",
        "ksat_v": "ksat_v", "veg_frac": "veg_frac", "imp_af": "imp_af",
        "wetland_level": "wetland_level", "rootreach_level": "rootreach_level",
        "sy": "sy", "area": "area", "z_surf": "z_surf",
        "z_bottom": "z_bottom", "depression": "depression",
        "rough": "rough", "i_bc": "i_bc", "i_ss": "i_ss", "i_lake": "i_lake",
    }

    def __init__(self, cell: dict):
        self._cell = cell

    def __getattr__(self, name):
        try:
            return self._cell[self._MAP[name]]
        except KeyError as e:
            raise AttributeError(name) from e


def _halo_forward(plan: ExchangePlan, halo, exports_c, riv_stage):
    """K neighbour-wise ppermute rounds -> (cell ghost [Gc,3], river ghost
    [Gr]).  Rounds with zero payload of a kind are skipped entirely."""
    gc_parts, gr_parts = [], []
    for k in range(plan.k):
        sc, sr = plan.s_cell[k], plan.s_riv[k]
        if sc:
            buf = exports_c[halo["cell_send"][k, :sc]]
            gc_parts.append(lax.ppermute(buf, AXIS, plan.perms[k]))
        if sr:
            rbuf = riv_stage[halo["riv_send"][k, :sr]]
            gr_parts.append(lax.ppermute(rbuf, AXIS, plan.perms[k]))
    dt = exports_c.dtype
    ghost_c = (jnp.concatenate(gc_parts, axis=0) if gc_parts
               else jnp.zeros((1, 3), dtype=dt))
    ghost_r = (jnp.concatenate(gr_parts, axis=0) if gr_parts
               else jnp.zeros((1,), dtype=dt))
    return ghost_c, ghost_r


def _halo_reverse(plan: ExchangePlan, halo, partials, nr_local):
    """Send per-remote-reach flux partials [Gr, 3] back to their owners
    (inverted perms) and scatter-add onto the owner's local reach blocks.
    Returns [Rp, 3] of (Qsurf, Qsub, Qup) received sums."""
    acc = jnp.zeros((nr_local, 3), dtype=partials.dtype)
    for k in range(plan.k):
        sr = plan.s_riv[k]
        if not sr:
            continue
        off = plan.off_riv[k]
        recv = lax.ppermute(partials[off : off + sr], AXIS,
                            plan.rev_perms[k])
        # padded lanes carry zeros (sender's ghost buffer is zero except at
        # real import positions) and scatter harmlessly onto slot 0
        acc = acc + segment_sum(recv, halo["riv_send"][k, :sr],
                                num_segments=nr_local)
    return acc


def _local_rhs(plan, cell, edge, seg, riv, lake_tbl, halo, t,
               y_local, fs_local, fs_riv, close_boundary: bool,
               want_diag: bool = False):
    """RHS for one shard's cell + river blocks (runs inside shard_map)."""
    sf, us, gw_raw = y_local["sf"], y_local["us"], y_local["gw"]
    riv_y = y_local["riv"]
    lake_stg = y_local["lake"]
    nl = lake_stg.shape[0]
    m = _CellView(cell)
    valid = cell["valid"]
    rvalid = riv["valid"]

    gw = jnp.where(m.i_bc > 0, fs_local["ele_ybc"], gw_raw)
    riv_stage = jnp.where(riv["riv_bc"] > 0, fs_riv["riv_ybc"], riv_y)

    # river geometry (local reaches; River.cpp:49-62)
    r_topw = jnp.maximum(
        riv_stage * riv["riv_bank_slope"] * 2.0 + riv["riv_bottom_width"], 0.0
    )
    r_csa = jnp.maximum(
        riv_stage * (riv["riv_bottom_width"] + riv_stage * riv["riv_bank_slope"]),
        0.0,
    )
    r_per = jnp.maximum(
        2.0 * jnp.abs(riv_stage) * jnp.sqrt(1.0 + riv["riv_bank_slope"] ** 2)
        + riv["riv_bottom_width"],
        0.0,
    )

    cu = update_element(m, sf, us, gw)
    if nl > 0:
        cu = lake_cell_update(m, cu)
        is_lake_cell = m.i_lake > 0
    es, eu, eg, tu, tg, e_ic_out, _ = et_flux(
        m, fs_local["fs"], sf, us, gw, cu.satn
    )
    qi, qex = flux_infiltration(m, cu, sf, us, gw, fs_local["fs"].net_prcp)
    q_infil = qi * fs_local["fs"].fu_surf
    q_exfil = qex * fs_local["fs"].fu_surf
    q_rech = flux_recharge(m, cu, us, gw) * fs_local["fs"].fu_sub
    if nl > 0:
        q_infil = jnp.where(is_lake_cell, 0.0, q_infil)
        q_exfil = jnp.where(is_lake_cell, 0.0, q_exfil)
        q_rech = jnp.where(is_lake_cell, 0.0, q_rech)
        es = jnp.where(is_lake_cell, 0.0, es)
        eu = jnp.where(is_lake_cell, 0.0, eu)
        eg = jnp.where(is_lake_cell, 0.0, eg)
        tu = jnp.where(is_lake_cell, 0.0, tu)
        tg = jnp.where(is_lake_cell, 0.0, tg)

    # ---- forward halo: boundary cell values + remote-referenced stages ----
    exports_c = jnp.stack([sf, gw, cu.eff_kh], axis=-1)  # [Np, 3]
    ghost_c, ghost_r = _halo_forward(plan, halo, exports_c, riv_stage)

    np_cells = sf.shape[0]
    nb_remote = halo["nb_remote"]  # [Np,3] bool
    nb_local = halo["nb_local"]
    nb_gpos = halo["nb_gpos"]
    has_nb = edge["has_nb"]

    # ONE stacked gather for all three neighbour fields (same trick as
    # the single-chip fast path — three separate dense gathers cost
    # 3x the HBM sweeps; exports_c is already the stacked array)
    nb_stack = jnp.where(
        nb_remote[..., None], ghost_c[nb_gpos], exports_c[nb_local]
    )  # [Np, 3, (sf, gw, effKH)]
    nsf = jnp.maximum(nb_stack[..., 0], 0.0)
    gw_nb = nb_stack[..., 1]
    effkh_nb = nb_stack[..., 2]

    isf = jnp.maximum(sf, 0.0)[:, None]
    B = edge["edge"]
    dist = edge["dist2nabor"]

    dh = (isf - nsf) + edge["dz_surf"]
    up1 = jnp.where(isf > m.depression[:, None], isf, 0.0)
    up2 = jnp.where(nsf > m.depression[:, None], nsf, 0.0)
    ymean = jnp.where(dh > 0.0, jnp.broadcast_to(up1, up2.shape), up2)
    ymean = jnp.minimum(ymean, MAXYSURF)
    s = dh / dist
    q_int = ph.manning_equation(ymean * B, edge["avg_rough"], ymean, s)
    q_int = jnp.where((s > 0) & (isf <= 0.0), 0.0, q_int)
    q_int = jnp.where((s < 0) & (nsf <= 0.0), 0.0, q_int)
    q_int = jnp.where(ymean <= 0.0, 0.0, q_int)

    # lake-bank branches (weir + darcy against the replicated lake stage)
    if nl > 0:
        lakenb = lake_tbl["lakenabr"]  # [Np,3] 0-based, -1 none
        has_lk = lakenb >= 0
        lki = jnp.where(has_lk, lakenb, 0)
        lake_nsf = jnp.maximum(lake_stg[lki], 0.0)
        # local-datum form (same as the single-chip fast path): the
        # km-scale elevation is cancelled in f64 at partition build
        q_surf_lake = ph.weir_flow_jtoi_local(
            lake_nsf + lake_tbl["dzl"], isf, lake_nsf, 0.6, B, 0.01,
        )
    if close_boundary:
        q_bnd = jnp.zeros_like(B)
    else:
        sb = isf / edge["dist2edge"] * 0.5
        isf5 = jnp.cbrt(jnp.maximum(isf, 1e-30) ** 5)
        qb = jnp.sqrt(jnp.maximum(sb, 1e-30)) * isf5 * B / m.rough[:, None]
        q_bnd = jnp.where((isf > m.depression[:, None]) & (sb > 0.0),
                          qb, 0.0)
    if nl > 0:
        q_esurf = jnp.where(has_lk, q_surf_lake,
                            jnp.where(has_nb, q_int, q_bnd))
    else:
        q_esurf = jnp.where(has_nb, q_int, q_bnd)

    gw_col = gw[:, None]
    dh_s = (gw_col - gw_nb) + edge["dz_bottom"]
    ymean_s = ph.avg_y_gw(gw_col, gw_nb)
    grad_s = dh_s / dist
    kmean = 0.5 * (cu.eff_kh[:, None] + effkh_nb)
    q_sub_int = kmean * grad_s * ymean_s * B
    q_sub_int = jnp.where(
        ((dh_s > 0.0) & (gw_col <= 0.02))
        | ((dh_s < 0.0) & (gw_nb <= 0.02)),
        0.0, q_sub_int,
    )
    if close_boundary:
        q_sub_bnd = jnp.zeros_like(B)
    else:
        grad_b = gw_col / edge["dist2edge"] * 0.5
        q_sub_bnd = jnp.where(
            (gw_col > m.depression[:, None] * 10.0) & (grad_b > 0.0),
            cu.eff_kh[:, None] * grad_b, 0.0,
        )
    if nl > 0:
        dh_lk = (gw_col - lake_stg[lki]) + lake_tbl["dzb"]
        ymean_lk = ph.avg_y_gw(gw_col, lake_stg[lki])
        kmean_lk = 0.5 * (cu.eff_kh[:, None] + effkh_nb)
        q_sub_lake = kmean_lk * (dh_lk / dist) * ymean_lk * B
        q_sub_lake = jnp.where(
            ((dh_lk > 0.0) & (gw_col <= 0.02))
            | ((dh_lk < 0.0) & (lake_stg[lki] <= 0.02)),
            0.0, q_sub_lake,
        )
        q_esub0 = jnp.where(has_lk, q_sub_lake,
                            jnp.where(has_nb, q_sub_int, q_sub_bnd))
    else:
        q_esub0 = jnp.where(has_nb, q_sub_int, q_sub_bnd)
    if nl > 0:
        lk_mask = has_lk & ~is_lake_cell[:, None]
        lk_surf_loc = segment_sum(
            jnp.where(lk_mask, q_esurf, 0.0).ravel(), lki.ravel(),
            num_segments=nl,
        )
        lk_sub_loc = segment_sum(
            jnp.where(lk_mask, q_esub0, 0.0).ravel(), lki.ravel(),
            num_segments=nl,
        )
    q_esub = q_esub0 * fs_local["fs"].fu_sub[:, None]
    if nl > 0:
        q_esurf = jnp.where(is_lake_cell[:, None], 0.0, q_esurf)
        q_esub = jnp.where(is_lake_cell[:, None], 0.0, q_esub)
    q_surf_row = q_esurf.sum(axis=1)
    q_sub_row = q_esub.sum(axis=1)

    # ---- segments (local elements; river stage local or from the halo) ----
    nr_local = riv_stage.shape[0]
    se = seg["ele_slot"]
    sr_local = seg["riv_local"]
    sval = seg["valid"]
    seg_stage = jnp.where(
        sr_local, riv_stage[seg["riv_slot"]], ghost_r[seg["riv_gpos"]]
    )
    seg_isf = jnp.maximum(0.0, sf[se] - q_infil[se] + q_exfil[se])
    # local-datum form (identical to rhs_full's low_prec branch):
    # subtract z_surf (weir) / z_bottom (bed Darcy) — algebraically
    # identical in f64, f32-safe against km-scale elevations
    zero_e = jnp.zeros_like(seg_isf)
    q_seg_surf = ph.weir_flow_jtoi(
        zero_e, seg_isf, -seg["rdepth"], seg_stage,
        zero_e, seg["cwr"], seg["length"], m.depression[se],
    )
    q_seg_sub = ph.flux_r2e_gw(
        seg_stage, m.aq_depth[se] - seg["rdepth"], gw[se], zero_e,
        cu.eff_kh[se], seg["rksat"], seg["length"], seg["rbed"],
    ) * fs_local["fs"].fu_sub[se]
    q_seg_surf = jnp.where(sval, q_seg_surf, 0.0)
    q_seg_sub = jnp.where(sval, q_seg_sub, 0.0)

    q_riv_surf = segment_sum(
        jnp.where(sr_local, q_seg_surf, 0.0), seg["riv_slot"],
        num_segments=nr_local,
    )
    q_riv_sub = segment_sum(
        jnp.where(sr_local, q_seg_sub, 0.0), seg["riv_slot"],
        num_segments=nr_local,
    )
    q_e2r_surf = segment_sum(-q_seg_surf, se, num_segments=np_cells)
    q_e2r_sub = segment_sum(-q_seg_sub, se, num_segments=np_cells)

    # ---- river chain (owner-computed; downstream stage local or halo) ----
    has_down = riv["has_down"]
    to_lake = riv["riv_to_lake"] >= 0
    stage_dn = jnp.where(
        riv["down_local"], riv_stage[riv["down_slot"]],
        ghost_r[riv["down_gpos"]],
    )
    s_mean = 0.5 * (riv["riv_bed_slope"] + riv["down_bedslope"])
    s_down = (
        (riv_stage - riv["riv_depth"]) - (stage_dn - riv["down_depth"])
    ) / riv["riv_dist2down"] + s_mean
    r_hyd = jnp.where(r_per <= ZERO, 0.0,
                      r_csa / jnp.where(r_per <= ZERO, 1.0, r_per))
    q_down_int = ph.manning_equation(r_csa, riv["riv_avg_rough"],
                                     r_hyd, s_down)
    s_out = riv["riv_bed_slope"] + riv_stage * 2.0 / riv["riv_length"]
    q_out_zdg = ph.manning_equation(r_csa, riv["riv_avg_rough"],
                                    r_hyd, s_out)
    q_out_crit = (r_csa * jnp.sqrt(GRAV * jnp.maximum(riv_stage, 1e-30))
                  * 60.0)
    q_riv_down = jnp.where(
        to_lake, q_out_zdg,
        jnp.where(has_down, q_down_int,
                  jnp.where(riv["riv_outlet_code"] == -4, q_out_crit,
                            q_out_zdg)),
    )
    q_riv_down = jnp.where(rvalid, q_riv_down, 0.0)
    q_riv_up = segment_sum(
        jnp.where(has_down & riv["down_local"], -q_riv_down, 0.0),
        riv["down_slot"], num_segments=nr_local,
    )

    # ---- reverse halo: flux partials for remote reaches -> owners ----
    gr = plan.g_riv
    p_surf = segment_sum(
        jnp.where(sr_local, 0.0, q_seg_surf), seg["riv_gpos"],
        num_segments=gr,
    )
    p_sub = segment_sum(
        jnp.where(sr_local, 0.0, q_seg_sub), seg["riv_gpos"],
        num_segments=gr,
    )
    p_up = segment_sum(
        jnp.where(has_down & ~riv["down_local"], -q_riv_down, 0.0),
        riv["down_gpos"], num_segments=gr,
    )
    partials = jnp.stack([p_surf, p_sub, p_up], axis=-1)  # [Gr, 3]
    recv = _halo_reverse(plan, halo, partials, nr_local)
    q_riv_surf = q_riv_surf + recv[:, 0]
    q_riv_sub = q_riv_sub + recv[:, 1]
    q_riv_up = q_riv_up + recv[:, 2]

    # ---- assembly ----
    area = m.area
    q_surf_tot = q_e2r_surf + q_surf_row
    q_sub_tot = q_e2r_sub + q_sub_row
    fs = fs_local["fs"]
    dsf = fs.net_prcp - q_infil + q_exfil - q_surf_tot / area - es
    dus = q_infil - q_rech - eu - tu
    dgw = q_rech - q_exfil - q_sub_tot / area - eg - tg
    dgw = jnp.where(m.i_bc > 0, 0.0, dgw)
    dgw = dgw + jnp.where(m.i_bc < 0, fs_local["ele_qbc"] / area, 0.0)
    dsf = dsf + jnp.where(m.i_ss > 0, fs_local["ele_qss"] / area, 0.0)
    dgw = dgw + jnp.where(m.i_ss < 0, fs_local["ele_qss"] / area, 0.0)
    dus = dus / m.sy
    dgw = dgw / m.sy
    if nl > 0:
        dsf = jnp.where(is_lake_cell, 0.0, dsf)
        dus = jnp.where(is_lake_cell, 0.0, dus)
        dgw = jnp.where(is_lake_cell, 0.0, dgw)
    dsf = jnp.where(valid, dsf, 0.0)
    dus = jnp.where(valid, dus, 0.0)
    dgw = jnp.where(valid, dgw, 0.0)

    d_area = (
        -q_riv_up - q_riv_surf - q_riv_sub - q_riv_down + fs_riv["riv_qbc"]
    ) / riv["riv_length"]
    d_area = jnp.maximum(d_area, -r_csa)
    driv = ph.fun_da_to_dy(d_area, r_topw, riv["riv_bank_slope"])
    driv = jnp.where(riv["riv_bc"] > 0, 0.0, driv)
    driv = jnp.where(rvalid, driv, 0.0)

    # ---- lake stage (replicated; psum over shards, MD_f.cpp:180-191) ----
    if nl > 0:
        lk_cell = jnp.where(is_lake_cell, m.i_lake - 1, 0)
        inv_nele = 1.0 / jnp.maximum(
            lake_tbl["num_ele"].astype(dsf.dtype), 1.0
        )
        q_lake_evap = jax.lax.psum(segment_sum(
            jnp.where(is_lake_cell & valid,
                      fs.pot_evap * inv_nele[lk_cell], 0.0),
            lk_cell, num_segments=nl), AXIS)
        q_lake_prcp = jax.lax.psum(segment_sum(
            jnp.where(is_lake_cell & valid,
                      fs.prcp * inv_nele[lk_cell], 0.0),
            lk_cell, num_segments=nl), AXIS)
        q_lake_evap = jnp.maximum(
            0.0, jnp.minimum(q_lake_evap, q_lake_prcp + lake_stg)
        )
        q_lake_surf = jax.lax.psum(lk_surf_loc, AXIS)
        q_lake_sub = jax.lax.psum(lk_sub_loc, AXIS)
        tl = jnp.where(to_lake, riv["riv_to_lake"], 0)
        q_lake_rivin = jax.lax.psum(segment_sum(
            jnp.where(to_lake & rvalid, q_riv_down, 0.0), tl,
            num_segments=nl), AXIS)

        class _LakeView:
            lake_zmin = lake_tbl["zmin"]
            lake_bathy_y = lake_tbl["bathy_y"]
            lake_bathy_a = lake_tbl["bathy_a"]

        lake_area = _lake_toparea(_LakeView, lake_stg)
        dlake = q_lake_prcp - q_lake_evap + (
            q_lake_rivin + q_lake_sub + q_lake_surf
        ) / lake_area
    else:
        dlake = jnp.zeros_like(y_local["lake"])

    dy = {"sf": dsf, "us": dus, "gw": dgw, "riv": driv, "lake": dlake}
    if not want_diag:
        return dy
    # per-window output diagnostics — the same field set rhs_full's diag
    # provides to the fused single-chip driver (fused.py ACCUM_KEYS), in
    # the sharded block layout (cell [Np], edge [Np,3], river [Rp], lake
    # replicated [Nl] post-psum)
    if nl == 0:
        zl = jnp.zeros((0,), dtype=dsf.dtype)
        q_lake_evap = q_lake_prcp = q_lake_surf = q_lake_sub = zl
        q_lake_rivin = lake_area = zl
    diag = dict(
        q_infil=q_infil, q_exfil=q_exfil, q_rech=q_rech,
        q_esurf=q_esurf, q_esub=q_esub,
        q_surf_tot=q_surf_tot, q_sub_tot=q_sub_tot,
        q_riv_surf=q_riv_surf, q_riv_sub=q_riv_sub,
        q_riv_down=q_riv_down, q_riv_up=q_riv_up,
        q_e2r_surf=q_e2r_surf, q_e2r_sub=q_e2r_sub,
        es=es, eu=eu, eg=eg, tu=tu, tg=tg, e_ic=e_ic_out,
        q_lake_evap=q_lake_evap, q_lake_prcp=q_lake_prcp,
        q_lake_surf=q_lake_surf, q_lake_sub=q_lake_sub,
        q_lake_rivin=q_lake_rivin, lake_area=lake_area,
    )
    return dy, diag


_SHARDED_LAKE_KEYS = ("lakenabr", "dzl", "dzb")


def make_sharded_rhs(sm: ShardedMesh, devices=None, close_boundary=True,
                     float_dtype=None, with_diag: bool = False):
    """Build (mesh, rhs_fn, device_arrays).

    ``rhs_fn(t, y, params)`` takes the sharded state pytree
    {sf,us,gw:[P,Np], riv:[P,Rp], lake:[Nl]} and returns dY in the same
    layout; cell and river blocks are sharded over the device mesh axis,
    lakes replicated.

    ``float_dtype``: f64 (default, oracle-parity) or f32 (local-datum dz
    arrays keep mm-scale gradients)."""
    if devices is None:
        avail = jax.devices()
        if len(avail) < sm.p:
            raise ValueError(
                f"partition has {sm.p} shards but only {len(avail)} "
                f"device(s) are visible ({avail[0].platform}); for a "
                f"virtual CPU mesh run with --cpu and XLA_FLAGS="
                f"--xla_force_host_platform_device_count={sm.p} "
                f"(an undersized mesh would fail later with an opaque "
                f"ppermute error)"
            )
        devices = np.array(avail[: sm.p])
    elif len(np.asarray(devices).ravel()) < sm.p:
        raise ValueError(
            f"partition has {sm.p} shards but only "
            f"{len(np.asarray(devices).ravel())} device(s) were passed "
            f"explicitly (an undersized mesh would fail later with an "
            f"opaque ppermute error)"
        )
    mesh = Mesh(devices, (AXIS,))
    plan = sm.plan

    fd = float_dtype or jnp.float64
    cell = {
        k: jnp.asarray(v, dtype=fd if v.dtype.kind == "f" else jnp.int32)
        for k, v in sm.cell.items()
    }
    cell["valid"] = jnp.asarray(sm.cell["valid"])

    def conv(v):
        v = np.asarray(v)
        if v.dtype.kind == "b":
            return jnp.asarray(v)
        if v.dtype.kind in "iu":
            return jnp.asarray(v, dtype=jnp.int32)
        return jnp.asarray(v, dtype=fd)

    edge = {k: conv(v) for k, v in sm.edge.items()}
    seg = {k: conv(v) for k, v in sm.seg.items()}
    riv = {k: conv(v) for k, v in sm.riv.items()}
    halo = {k: conv(v) for k, v in sm.halo.items()}
    lake_tbl = {}
    if sm.num_lake > 0:
        lake_tbl = {
            "lakenabr": jnp.asarray(sm.lake["lakenabr"], dtype=jnp.int32),
            "dzl": jnp.asarray(sm.lake["dzl"], dtype=fd),
            "dzb": jnp.asarray(sm.lake["dzb"], dtype=fd),
            "zmin": jnp.asarray(sm.lake["zmin"], dtype=fd),
            "bathy_y": jnp.asarray(sm.lake["bathy_y"], dtype=fd),
            "bathy_a": jnp.asarray(sm.lake["bathy_a"], dtype=fd),
            "num_ele": jnp.asarray(sm.lake["num_ele"], dtype=jnp.int32),
        }

    shard_specs = {
        "cell": {k: P(AXIS) for k in cell},
        "edge": {k: P(AXIS) for k in edge},
        "seg": {k: P(AXIS) for k in seg},
        "riv": {k: P(AXIS) for k in riv},
        "halo": {k: P(AXIS) for k in halo},
        "lake": {k: (P(AXIS) if k in _SHARDED_LAKE_KEYS else P())
                 for k in lake_tbl},
    }
    y_spec = {"sf": P(AXIS), "us": P(AXIS), "gw": P(AXIS),
              "riv": P(AXIS), "lake": P()}
    fs_cell_spec = P(AXIS)

    _DIAG_CELL = ("q_infil", "q_exfil", "q_rech", "q_surf_tot", "q_sub_tot",
                  "q_e2r_surf", "q_e2r_sub", "es", "eu", "eg", "tu", "tg",
                  "e_ic")
    _DIAG_EDGE = ("q_esurf", "q_esub")
    _DIAG_RIV = ("q_riv_surf", "q_riv_sub", "q_riv_down", "q_riv_up")
    _DIAG_LAKE = ("q_lake_evap", "q_lake_prcp", "q_lake_surf", "q_lake_sub",
                  "q_lake_rivin", "lake_area")

    def _make_fn(want_diag):
        def rhs_fn(t, y, params):
            (cellp, edgep, segp, rivp, halop, lakep, fs_cell, fs_rivp) = params

            def body(cell_l, edge_l, seg_l, riv_l, halo_l, lake_l, fsc_l,
                     fsr_l, y_l, t_l):
                # strip the leading size-1 shard axis from sharded blocks
                cell_1 = {k: v[0] for k, v in cell_l.items()}
                edge_1 = {k: v[0] for k, v in edge_l.items()}
                seg_1 = {k: v[0] for k, v in seg_l.items()}
                riv_1 = {k: v[0] for k, v in riv_l.items()}
                halo_1 = {k: v[0] for k, v in halo_l.items()}
                lake_1 = {
                    k: (v[0] if k in _SHARDED_LAKE_KEYS else v)
                    for k, v in lake_l.items()
                }
                y_1 = {
                    "sf": y_l["sf"][0], "us": y_l["us"][0],
                    "gw": y_l["gw"][0],
                    "riv": y_l["riv"][0], "lake": y_l["lake"],
                }
                fsc_1 = {k: v[0] for k, v in fsc_l.items()}
                fsr_1 = {k: v[0] for k, v in fsr_l.items()}

                from shud_tpu.core.state import ForcingSlice

                fs_obj = ForcingSlice(**{
                    k: fsc_1[k] for k in (
                        "net_prcp", "prcp", "pot_evap", "pot_tran", "e_ic",
                        "lai", "fu_surf", "fu_sub",
                    )
                }, ele_ybc=fsc_1["ele_ybc"], ele_qbc=fsc_1["ele_qbc"],
                   ele_qss=fsc_1["ele_qss"],
                   riv_ybc=fsr_1["riv_ybc"], riv_qbc=fsr_1["riv_qbc"])
                fs_local = {
                    "fs": fs_obj, "ele_ybc": fsc_1["ele_ybc"],
                    "ele_qbc": fsc_1["ele_qbc"], "ele_qss": fsc_1["ele_qss"],
                }
                out = _local_rhs(
                    plan, cell_1, edge_1, seg_1, riv_1, lake_1, halo_1, t_l,
                    y_1, fs_local, fsr_1, close_boundary,
                    want_diag=want_diag,
                )
                dy = out[0] if want_diag else out
                dy_out = {
                    "sf": dy["sf"][None], "us": dy["us"][None],
                    "gw": dy["gw"][None], "riv": dy["riv"][None],
                    "lake": dy["lake"],
                }
                if not want_diag:
                    return dy_out
                diag = out[1]
                diag_out = {
                    k: (diag[k] if k in _DIAG_LAKE else diag[k][None])
                    for k in diag
                }
                return dy_out, diag_out

            diag_spec = {k: P(AXIS)
                         for k in _DIAG_CELL + _DIAG_EDGE + _DIAG_RIV}
            diag_spec.update({k: P() for k in _DIAG_LAKE})
            return jax.shard_map(
                body, mesh=mesh,
                in_specs=(
                    shard_specs["cell"], shard_specs["edge"],
                    shard_specs["seg"],
                    shard_specs["riv"], shard_specs["halo"],
                    shard_specs["lake"],
                    {k: fs_cell_spec for k in fs_cell},
                    {"riv_ybc": P(AXIS), "riv_qbc": P(AXIS)},
                    y_spec, P(),
                ),
                out_specs=(y_spec, diag_spec) if want_diag else y_spec,
                check_vma=False,
            )(cellp, edgep, segp, rivp, halop, lakep, fs_cell, fs_rivp, y,
              jnp.asarray(t))

        return rhs_fn

    rhs_fn = _make_fn(False)
    params = (cell, edge, seg, riv, halo, lake_tbl)
    if with_diag:
        return mesh, rhs_fn, _make_fn(True), params
    return mesh, rhs_fn, params


def place_params(mesh: Mesh, params):
    """device_put the make_sharded_rhs params tuple with its natural
    shardings (everything shard-blocked except the replicated lake
    tables)."""
    cell, edge, seg, riv, halo, lake = params
    sh = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())

    def put(tree, s):
        return jax.tree_util.tree_map(lambda v: jax.device_put(v, s), tree)

    lake_placed = {
        k: jax.device_put(v, sh if k in _SHARDED_LAKE_KEYS else rep)
        for k, v in lake.items()
    }
    return (put(cell, sh), put(edge, sh), put(seg, sh), put(riv, sh),
            put(halo, sh), lake_placed)
