"""The fused right-hand side: dY/dt = f(t, Y) as one pure XLA program.

Reproduces the reference RHS dataflow (``src/ModelData/MD_f.cpp``,
``MD_ElementFlux.cpp``, ``MD_RiverFlux.cpp``, ``MD_update.cpp``,
``MD_ET.cpp:343-404``) as: pointwise cell update → 3-edge neighbour gather →
bipartite segment stencil → river-chain stencil → ``segment_sum``
scatter-reductions → pointwise assembly.  Race-free and deterministic by
construction (the reference needed owner-computed edges plus a serial
``PassValue`` pass; here every reduction is a ``segment_sum``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax.ops import segment_sum

from shud_tpu.config import EPSILON, GRAV, MAXYSURF, ZERO
from shud_tpu.core import physics as ph
from shud_tpu.core.state import ForcingSlice, split_y


class CellUpdate(NamedTuple):
    eff_kh: jnp.ndarray
    deficit: jnp.ndarray
    satn: jnp.ndarray
    sat_kr: jnp.ndarray
    theta: jnp.ndarray
    kmax: jnp.ndarray


def update_element(m, sf, us, gw):
    """Vectorised ``_Element::updateElement`` (Element.cpp:384-432)."""
    effkh = ph.eff_kh(gw, m.aq_depth, m.mac_d, m.mac_ksat_h, m.geo_v_area_f,
                      m.ksat_h)
    deficit = m.aq_depth - gw
    kmax = m.inf_ksat_v * (1.0 - m.h_area_f) + m.mac_ksat_v * m.h_area_f

    saturated = deficit <= 0.0
    deficit = jnp.maximum(deficit, 0.0)
    theta_raw = us / jnp.where(saturated, 1.0, deficit) * m.theta_s
    theta = jnp.where(saturated, m.theta_s, theta_raw)
    satn = jnp.where(
        saturated, 1.0, (theta - m.theta_r) / (m.theta_s - m.theta_r)
    )

    hi = satn > 0.99
    lo = satn <= ZERO
    satn_mid = jnp.clip(satn, 1e-12, 1.0 - 1e-12)  # safe for pow branches
    sat_kr_mid = ph.sat_k_fun(satn_mid, m.beta)
    satn = jnp.where(hi, 1.0, jnp.where(lo, 0.0, satn))
    sat_kr = jnp.where(hi, 1.0, jnp.where(lo, 0.0, sat_kr_mid))
    theta = jnp.where(hi, m.theta_s, jnp.where(lo, m.theta_r, theta))
    return CellUpdate(effkh, deficit, satn, sat_kr, theta, kmax)


def lake_cell_update(m, cu: CellUpdate) -> CellUpdate:
    """``updateLakeElement`` overrides for cells inside a lake
    (Element.cpp:373-383)."""
    is_lake = m.i_lake > 0
    return CellUpdate(
        eff_kh=jnp.where(is_lake, m.ksat_h, cu.eff_kh),
        deficit=jnp.where(is_lake, 0.0, cu.deficit),
        satn=jnp.where(is_lake, 1.0, cu.satn),
        sat_kr=jnp.where(is_lake, 1.0, cu.sat_kr),
        theta=jnp.where(is_lake, m.theta_s, cu.theta),
        kmax=jnp.where(is_lake, m.inf_ksat_v, cu.kmax),
    )


def et_flux(m, fs: ForcingSlice, sf, us, gw, satn):
    """Vectorised ``f_etFlux`` (MD_ET.cpp:343-404).

    Returns (Es, Eu, Eg, Tu, Tg, e_ic_out); ``e_ic_out`` reproduces the
    in-call overwrite of qEleE_IC."""
    va = m.veg_frac
    vb = 1.0 - m.veg_frac
    pj = 1.0 - m.imp_af
    # SoilMoistureStress (is_sm_et.cpp:175-188); soil-table thetas == cell
    fc = m.theta_s * 0.75
    beta_s = (satn * (m.theta_s - m.theta_r) - m.theta_r) / (fc - m.theta_r)
    beta_s = jnp.clip(beta_s, 0.0, 1.0)
    # the reference uses its truncated PI macro here (Macros.hpp:46)
    ibeta = 0.5 * (1.0 - jnp.cos(3.1415926 * beta_s))

    es = jnp.minimum(jnp.maximum(0.0, sf), fs.pot_evap) * vb
    rem = fs.pot_evap - es
    some_left = es < fs.pot_evap
    gw_high = gw > m.wetland_level
    eg = jnp.where(
        some_left & gw_high, jnp.minimum(jnp.maximum(0.0, gw), rem) * pj * vb, 0.0
    )
    eu = jnp.where(
        some_left & ~gw_high,
        jnp.minimum(jnp.maximum(0.0, us), ibeta * rem) * pj * vb,
        0.0,
    )

    has_veg = fs.lai > ZERO
    ic_dominates = fs.e_ic >= fs.pot_tran
    root_deep = gw > m.rootreach_level
    tg = jnp.where(
        has_veg & ~ic_dominates & root_deep,
        jnp.minimum(jnp.maximum(0.0, gw), fs.pot_tran - fs.e_ic) * pj * va,
        0.0,
    )
    tu = jnp.where(
        has_veg & ~ic_dominates & ~root_deep,
        jnp.minimum(jnp.maximum(0.0, us), ibeta * (fs.pot_tran - fs.e_ic))
        * pj * va,
        0.0,
    )
    e_ic_out = jnp.where(
        has_veg,
        jnp.where(ic_dominates, fs.pot_tran * pj * va, fs.e_ic),
        0.0,
    )
    return es, eu, eg, tu, tg, e_ic_out, ibeta


def flux_infiltration(m, cu: CellUpdate, sf, us, gw, net_prcp):
    """``_Element::Flux_Infiltration`` (Element.cpp:273-303)."""
    av = sf + net_prcp
    gw_at_surface = (gw + us > m.aq_depth) | (cu.deficit < us)
    qex = jnp.abs(gw + us - m.aq_depth) / m.aq_depth * cu.kmax

    grad = 1.0 + av / m.inf_d
    heavy = av > cu.kmax
    medium = av > m.inf_ksat_v
    effk = jnp.where(
        heavy,
        m.inf_ksat_v * (1.0 - m.h_area_f) + m.h_area_f * m.mac_ksat_v * cu.satn,
        jnp.where(
            medium,
            cu.sat_kr * m.inf_ksat_v * (1.0 - m.h_area_f)
            + m.h_area_f * m.mac_ksat_v * cu.satn,
            cu.sat_kr * m.inf_ksat_v * (1.0 - m.h_area_f),
        ),
    )
    qi = jnp.minimum(av, jnp.maximum(0.0, grad * effk))
    qi = jnp.where((av > 0.0) & (cu.deficit > m.inf_d), qi, 0.0)

    qi = jnp.where(gw_at_surface, 0.0, qi)
    qex = jnp.where(gw_at_surface, qex, 0.0)
    return qi, qex


def flux_recharge(m, cu: CellUpdate, us, gw):
    """``_Element::Flux_Recharge`` (Element.cpp:304-334)."""
    skip = (gw > m.aq_depth - m.inf_d) & (us < cu.deficit)
    grad = jnp.where(
        (cu.theta > m.theta_r) & (us > EPSILON),
        jnp.maximum((cu.theta - m.theta_r) / (m.theta_fc - m.theta_r), 0.0),
        0.0,
    )
    ku = m.inf_ksat_v * cu.sat_kr
    # harmonic mean with safe denominator (meanHarmonic, Equations.hpp:44-48)
    denom = cu.deficit * m.ksat_v + gw * ku
    ke = ku * m.ksat_v * (cu.deficit + gw) / jnp.where(denom == 0.0, 1.0, denom)
    ke = jnp.where(denom == 0.0, 0.0, ke)
    qr = jnp.where(
        (m.inf_ksat_v <= 0.0) | (m.ksat_v <= 0.0), 0.0, grad * ke
    )
    return jnp.where(skip, 0.0, qr)


def edge_fluxes(m, cu: CellUpdate, sf, gw, lake_stg, close_boundary: bool,
                exact_parity: bool = False):
    """3-edge lateral surface + subsurface fluxes
    (``fun_Ele_surface``/``fun_Ele_sub``, MD_ElementFlux.cpp:35-156).

    Returns (QeleSurf[Ne,3], QeleSub[Ne,3], QLakeSurf_contrib[Ne,3],
    QLakeSub_contrib[Ne,3]).  Lake contributions are per-edge values to be
    segment-summed into per-lake totals (no fu_sub factor, matching the
    reference asymmetry at MD_ElementFlux.cpp:122 vs :153).

    Two gather strategies:
    * fast (default): ONE stacked gather of the dynamic neighbour fields
      (sf, gw, effKH), or K rolls when the mesh is a structured grid
      (``m.roll_offsets``); head differences use f64-precomputed edge dz
      (also what makes the f32 mode accurate);
    * exact_parity: separate gathers with the reference's exact operation
      order (bit-parity against the C++ oracle; used by the golden tests).
    """
    nabr = m.nabr  # [Ne,3] 0-based, -1 none
    has_nabr = nabr >= 0
    lakenb = m.lakenabr  # [Ne,3] 0-based lake id, -1 none
    has_lake = lakenb >= 0
    nb = jnp.where(has_nabr, nabr, 0)
    lk = jnp.where(has_lake, lakenb, 0)

    low_prec = (sf.dtype == jnp.float32) or not exact_parity

    isf = jnp.maximum(sf, 0.0)[:, None]  # [Ne,1]
    z = m.z_surf[:, None]
    B = m.edge
    if exact_parity:
        nsf = jnp.maximum(sf[nb], 0.0)  # [Ne,3]
        zn = m.z_surf[nb]
        gw_nb = gw[nb]
        zb_nb = m.z_bottom[nb]
        effkh_nb = cu.eff_kh[nb]
    else:
        stacked = jnp.stack([sf, gw, cu.eff_kh], axis=-1)  # [Ne, 3]
        if m.roll_offsets is not None:
            # roll-gather: K rolls + one-hot selects replace the gather
            # (structured meshes; see MeshData.roll_offsets)
            k_idx = m.roll_k_idx  # [Ne,3]
            nbv = jnp.zeros(
                (stacked.shape[0], 3, 3), dtype=stacked.dtype
            )
            for k, off in enumerate(m.roll_offsets):
                rolled = jnp.roll(stacked, -off, axis=0)
                nbv = nbv + jnp.where(
                    (k_idx == k)[:, :, None], rolled[:, None, :], 0.0
                )
        else:
            nbv = stacked[nb]  # [Ne, 3edges, 3fields] — single gather
        nsf = jnp.maximum(nbv[:, :, 0], 0.0)
        gw_nb = nbv[:, :, 1]
        effkh_nb = nbv[:, :, 2]
        zn = None
        zb_nb = None

    # ---- surface: lake-bank branch (weir into lake) ----
    lake_nsf = jnp.maximum(lake_stg[lk], 0.0) if lake_stg.shape[0] else jnp.zeros_like(B)
    if lake_stg.shape[0] and low_prec:
        # local-datum form: f64-precomputed edge_lake_dzl keeps mm-scale
        # heads accurate in f32 (identical algebra; see physics helper)
        q_surf_lake = ph.weir_flow_jtoi_local(
            lake_nsf + m.edge_lake_dzl, isf, lake_nsf, 0.6, B, 0.01,
        )
    else:
        q_surf_lake = ph.weir_flow_jtoi(
            m.lake_zmin[lk] if lake_stg.shape[0] else jnp.zeros_like(B),
            lake_nsf, z, isf, z, 0.6, B, 0.01,
        )

    # ---- surface: interior neighbour branch ----
    if low_prec:
        dh = (isf - nsf) + m.edge_dz_surf
    else:
        dh = (isf + z) - (nsf + zn)
    # upwinded depth from the head difference (avgY_sf, Equations.cpp:8-50)
    up1 = jnp.where(isf > m.depression[:, None], isf, 0.0)
    up2 = jnp.where(nsf > m.depression[:, None], nsf, 0.0)
    ymean = jnp.where(dh > 0.0, jnp.broadcast_to(up1, up2.shape), up2)
    ymean = jnp.minimum(ymean, MAXYSURF)
    dist = jnp.where(has_nabr, m.dist2nabor, 1.0)
    s = dh / dist
    cross_a = ymean * B
    q_int = ph.manning_equation(cross_a, m.avg_rough, ymean, s)
    q_int = jnp.where((s > 0) & (isf <= 0.0), 0.0, q_int)
    q_int = jnp.where((s < 0) & (nsf <= 0.0), 0.0, q_int)
    q_int = jnp.where(ymean <= 0.0, 0.0, q_int)

    # ---- surface: boundary branch (kinematic free drainage) ----
    if close_boundary:
        q_bnd = jnp.zeros_like(B)
    else:
        sb = isf / m.dist2edge * 0.5
        isf5 = jnp.cbrt(isf * isf * isf * isf * isf)
        qb = jnp.sqrt(jnp.maximum(sb, 0.0)) * isf5 * B / m.rough[:, None]
        q_bnd = jnp.where((isf > m.depression[:, None]) & (sb > 0.0), qb, 0.0)

    # reference order: lake branch first, then neighbour, then boundary
    q_surf = jnp.where(has_lake, q_surf_lake,
                       jnp.where(has_nabr, q_int, q_bnd))

    # ---- subsurface ----
    gw_col = gw[:, None]
    zb = m.z_bottom[:, None]

    # lake-bank: against lake stage over lake bottom (bathy yi[0])
    if lake_stg.shape[0]:
        if low_prec:
            dh_lk = (gw_col - lake_stg[lk]) + m.edge_lake_dzb
        else:
            lake_bot = m.lake_bathy_y[lk, 0]
            dh_lk = (gw_col + zb) - (lake_stg[lk] + lake_bot)
        ymean_lk = ph.avg_y_gw(gw_col, lake_stg[lk])
        grad_lk = dh_lk / dist
        kmean_lk = 0.5 * (cu.eff_kh[:, None] + effkh_nb)
        q_sub_lake = kmean_lk * grad_lk * ymean_lk * B
        q_sub_lake = jnp.where(
            ((dh_lk > 0.0) & (gw_col <= 0.02))
            | ((dh_lk < 0.0) & (lake_stg[lk] <= 0.02)),
            0.0,
            q_sub_lake,
        )
    else:
        q_sub_lake = jnp.zeros_like(B)

    if low_prec:
        dh_s = (gw_col - gw_nb) + m.edge_dz_bottom
    else:
        dh_s = (gw_col + zb) - (gw_nb + zb_nb)
    ymean_s = ph.avg_y_gw(gw_col, gw_nb)
    grad_s = dh_s / dist
    kmean = 0.5 * (cu.eff_kh[:, None] + effkh_nb)
    q_sub_int = kmean * grad_s * ymean_s * B
    q_sub_int = jnp.where(
        ((dh_s > 0.0) & (gw_col <= 0.02)) | ((dh_s < 0.0) & (gw_nb <= 0.02)),
        0.0,
        q_sub_int,
    )

    if close_boundary:
        q_sub_bnd = jnp.zeros_like(B)
    else:
        grad_b = gw_col / m.dist2edge * 0.5
        q_sub_bnd = jnp.where(
            (gw_col > m.depression[:, None] * 10.0) & (grad_b > 0.0),
            cu.eff_kh[:, None] * grad_b,
            0.0,
        )

    q_sub = jnp.where(has_lake, q_sub_lake,
                      jnp.where(has_nabr, q_sub_int, q_sub_bnd))

    return q_surf, q_sub, jnp.where(has_lake, q_surf, 0.0), jnp.where(
        has_lake, q_sub, 0.0
    )


def rhs_full(m, fs: ForcingSlice, t, y, close_boundary: bool = True,
             exact_parity: bool = False):
    """Full RHS with diagnostics.

    ``m`` is the on-device mesh (``shud_tpu.core.mesh.MeshData`` converted to
    jnp arrays), ``fs`` the forcing slice.  Returns (dy, diag dict).
    """
    ne, nr, nl = m.area.shape[0], m.riv_length.shape[0], m.lake_zmin.shape[0]
    if m.num_lake == 0:
        nl = 0
    sf, us, gw_raw, riv, lake_stg = split_y(y, ne, nr, nl)

    # --- f_update: BC overrides (MD_update.cpp:102-189) ---
    gw = jnp.where(m.i_bc > 0, fs.ele_ybc, gw_raw)
    riv_stage = jnp.where(m.riv_bc > 0, fs.riv_ybc, riv)

    # river geometry (River.cpp:49-62)
    r_topw = jnp.maximum(
        riv_stage * m.riv_bank_slope * 2.0 + m.riv_bottom_width, 0.0
    )
    r_csa = jnp.maximum(
        riv_stage * (m.riv_bottom_width + riv_stage * m.riv_bank_slope), 0.0
    )
    # 2*sqrt(y^2 + (y s)^2) == 2|y| sqrt(1+s^2): identical value, JVP-safe
    r_per = jnp.maximum(
        2.0 * jnp.abs(riv_stage) * jnp.sqrt(1.0 + m.riv_bank_slope**2)
        + m.riv_bottom_width,
        0.0,
    )

    # --- pointwise cell update ---
    cu = update_element(m, sf, us, gw)
    if m.num_lake > 0:
        cu = lake_cell_update(m, cu)
    es, eu, eg, tu, tg, e_ic_out, ibeta = et_flux(m, fs, sf, us, gw, cu.satn)
    qi, qex = flux_infiltration(m, cu, sf, us, gw, fs.net_prcp)
    q_infil = qi * fs.fu_surf
    q_exfil = qex * fs.fu_surf
    q_rech = flux_recharge(m, cu, us, gw) * fs.fu_sub

    if m.num_lake > 0:
        is_lake_cell = m.i_lake > 0
        # lake cells: vertical terms zeroed, evap = potential open water
        q_infil = jnp.where(is_lake_cell, 0.0, q_infil)
        q_exfil = jnp.where(is_lake_cell, 0.0, q_exfil)
        q_rech = jnp.where(is_lake_cell, 0.0, q_rech)
        es = jnp.where(is_lake_cell, 0.0, es)
        eu = jnp.where(is_lake_cell, 0.0, eu)
        eg = jnp.where(is_lake_cell, 0.0, eg)
        tu = jnp.where(is_lake_cell, 0.0, tu)
        tg = jnp.where(is_lake_cell, 0.0, tg)
        e_ic_out = jnp.where(is_lake_cell, 0.0, e_ic_out)

    # --- edge stencil ---
    q_esurf, q_esub0, q_lake_surf_e, q_lake_sub_e = edge_fluxes(
        m, cu, sf, gw, lake_stg, close_boundary, exact_parity
    )
    q_esub = q_esub0 * fs.fu_sub[:, None]
    if m.num_lake > 0:
        # lake cells have no lateral fluxes (fun_Ele_lakeHorizon)
        q_esurf = jnp.where(is_lake_cell[:, None], 0.0, q_esurf)
        q_esub = jnp.where(is_lake_cell[:, None], 0.0, q_esub)
        q_lake_surf_e = jnp.where(is_lake_cell[:, None], 0.0, q_lake_surf_e)
        q_lake_sub_e = jnp.where(is_lake_cell[:, None], 0.0, q_lake_sub_e)

    # --- segment stencil (fun_Seg_surface / fun_Seg_sub) ---
    se, sr = m.seg_ele, m.seg_riv
    seg_isf = jnp.maximum(0.0, sf[se] - q_infil[se] + q_exfil[se])
    low_prec = (y.dtype == jnp.float32) or not exact_parity
    if low_prec:
        # local-datum form: subtract z_surf (weir) / z_bottom (bed Darcy) —
        # algebraically identical, f32-safe against km-scale elevations
        zero_e = jnp.zeros_like(seg_isf)
        q_seg_surf = ph.weir_flow_jtoi(
            zero_e, seg_isf,
            -m.riv_depth[sr], riv_stage[sr],
            zero_e, m.seg_cwr, m.seg_length, m.depression[se],
        )
        q_seg_sub = ph.flux_r2e_gw(
            riv_stage[sr], m.aq_depth[se] - m.riv_depth[sr],
            gw[se], zero_e,
            cu.eff_kh[se], m.riv_ksat_h[sr],
            m.seg_length, m.riv_bed_thick[sr],
        ) * fs.fu_sub[se]
    else:
        zs_e = m.z_surf[se]
        q_seg_surf = ph.weir_flow_jtoi(
            zs_e, seg_isf,
            zs_e - m.riv_depth[sr], riv_stage[sr],
            zs_e, m.seg_cwr, m.seg_length, m.depression[se],
        )
        q_seg_sub = ph.flux_r2e_gw(
            riv_stage[sr], zs_e - m.riv_depth[sr],
            gw[se], m.z_bottom[se],
            cu.eff_kh[se], m.riv_ksat_h[sr],
            m.seg_length, m.riv_bed_thick[sr],
        ) * fs.fu_sub[se]

    # --- river chain stencil (Flux_RiverDown, MD_RiverFlux.cpp:5-63) ---
    down = m.riv_down
    has_down = down >= 0
    dn = jnp.where(has_down, down, 0)
    s_mean = 0.5 * (m.riv_bed_slope + m.riv_bed_slope[dn])
    s_down = (
        (riv_stage - m.riv_depth) - (riv_stage[dn] - m.riv_depth[dn])
    ) / m.riv_dist2down + s_mean
    r_hyd = jnp.where(r_per <= ZERO, 0.0, r_csa / jnp.where(r_per <= ZERO, 1.0, r_per))
    q_down_int = ph.manning_equation(r_csa, m.riv_avg_rough, r_hyd, s_down)

    # outlets: codes -1/-2/-3 zero-depth-gradient; -4.. lake / critical depth
    s_out = m.riv_bed_slope + riv_stage * 2.0 / m.riv_length
    q_out_zdg = ph.manning_equation(r_csa, m.riv_avg_rough, r_hyd, s_out)
    q_out_crit = r_csa * jnp.sqrt(GRAV * jnp.maximum(riv_stage, 1e-30)) * 60.0
    to_lake = m.riv_to_lake >= 0
    q_riv_down = jnp.where(
        to_lake,
        q_out_zdg,  # lake-bound: same zero-depth-gradient Manning form
        jnp.where(
            has_down,
            q_down_int,
            jnp.where(m.riv_outlet_code == -4, q_out_crit, q_out_zdg),
        ),
    )

    # --- reductions (PassValue, MD_f.cpp:217-257) ---
    q_riv_surf = segment_sum(q_seg_surf, sr, num_segments=nr)
    q_riv_sub = segment_sum(q_seg_sub, sr, num_segments=nr)
    q_e2r_surf = segment_sum(-q_seg_surf, se, num_segments=ne)
    q_e2r_sub = segment_sum(-q_seg_sub, se, num_segments=ne)
    q_riv_up = segment_sum(
        jnp.where(has_down, -q_riv_down, 0.0), dn, num_segments=nr
    )

    # --- assembly (f_applyDY, MD_f.cpp:52-215) ---
    q_surf_tot = q_e2r_surf + q_esurf.sum(axis=1)
    q_sub_tot = q_e2r_sub + q_esub.sum(axis=1)
    area = m.area

    dsf = fs.net_prcp - q_infil + q_exfil - q_surf_tot / area - es
    dus = q_infil - q_rech - eu - tu
    dgw = q_rech - q_exfil - q_sub_tot / area - eg - tg

    # BC / SS terms
    dgw = jnp.where(m.i_bc > 0, 0.0, dgw)
    dgw = dgw + jnp.where(m.i_bc < 0, fs.ele_qbc / area, 0.0)
    dsf = dsf + jnp.where(m.i_ss > 0, fs.ele_qss / area, 0.0)
    dgw = dgw + jnp.where(m.i_ss < 0, fs.ele_qss / area, 0.0)

    dus = dus / m.sy
    dgw = dgw / m.sy

    if m.num_lake > 0:
        dsf = jnp.where(is_lake_cell, 0.0, dsf)
        dus = jnp.where(is_lake_cell, 0.0, dus)
        dgw = jnp.where(is_lake_cell, 0.0, dgw)

    # river
    d_area = (
        -q_riv_up - q_riv_surf - q_riv_sub - q_riv_down + fs.riv_qbc
    ) / m.riv_length
    d_area = jnp.maximum(d_area, -r_csa)
    driv = ph.fun_da_to_dy(d_area, r_topw, m.riv_bank_slope)
    driv = jnp.where(m.riv_bc > 0, 0.0, driv)

    # lake
    if m.num_lake > 0:
        lk_cell = jnp.where(is_lake_cell, m.i_lake - 1, 0)
        inv_nele = 1.0 / jnp.maximum(m.lake_num_ele.astype(y.dtype), 1.0)
        q_lake_evap = segment_sum(
            jnp.where(is_lake_cell, fs.pot_evap * inv_nele[lk_cell], 0.0),
            lk_cell, num_segments=nl,
        )
        q_lake_prcp = segment_sum(
            jnp.where(is_lake_cell, fs.prcp * inv_nele[lk_cell], 0.0),
            lk_cell, num_segments=nl,
        )
        # clamp (f_loop, MD_f.cpp:44-47): min first, then max — NOT jnp.clip
        q_lake_evap = jnp.maximum(
            0.0, jnp.minimum(q_lake_evap, q_lake_prcp + lake_stg)
        )

        lk_e = jnp.where(m.lakenabr >= 0, m.lakenabr, 0)
        q_lake_surf = segment_sum(
            q_lake_surf_e.ravel(), lk_e.ravel(), num_segments=nl
        )
        q_lake_sub = segment_sum(
            q_lake_sub_e.ravel(), lk_e.ravel(), num_segments=nl
        )
        tl = jnp.where(to_lake, m.riv_to_lake, 0)
        q_lake_rivin = segment_sum(
            jnp.where(to_lake, q_riv_down, 0.0), tl, num_segments=nl
        )
        # lake stage -> top area via bathymetry interpolation
        lake_area = _lake_toparea(m, lake_stg)
        dlake = q_lake_prcp - q_lake_evap + (
            q_lake_rivin + q_lake_sub + q_lake_surf
        ) / lake_area
    else:
        dlake = jnp.zeros((0,), dtype=y.dtype)
        q_lake_evap = q_lake_prcp = q_lake_surf = q_lake_sub = dlake
        q_lake_rivin = dlake
        lake_area = dlake

    dy = jnp.concatenate([dsf, dus, dgw, driv, dlake])
    diag = dict(
        q_infil=q_infil, q_exfil=q_exfil, q_rech=q_rech,
        q_esurf=q_esurf, q_esub=q_esub,
        q_surf_tot=q_surf_tot, q_sub_tot=q_sub_tot,
        q_seg_surf=q_seg_surf, q_seg_sub=q_seg_sub,
        q_riv_surf=q_riv_surf, q_riv_sub=q_riv_sub,
        q_riv_down=q_riv_down, q_riv_up=q_riv_up,
        q_e2r_surf=q_e2r_surf, q_e2r_sub=q_e2r_sub,
        es=es, eu=eu, eg=eg, tu=tu, tg=tg, e_ic=e_ic_out, ibeta=ibeta,
        eff_kh=cu.eff_kh, satn=cu.satn, theta=cu.theta,
        q_lake_evap=q_lake_evap, q_lake_prcp=q_lake_prcp,
        q_lake_surf=q_lake_surf, q_lake_sub=q_lake_sub,
        q_lake_rivin=q_lake_rivin, lake_area=lake_area,
    )
    return dy, diag


def _lake_toparea(m, lake_stg):
    """Piecewise-linear stage->area lookup (Lake.cpp:toparea:59-78).

    The reference looks up at absolute elevation ``yStage + zmin``."""
    yq = lake_stg + m.lake_zmin  # [Nl]
    yi = m.lake_bathy_y  # [Nl, K]
    ai = m.lake_bathy_a
    k = yi.shape[1]
    # replicate the sequential scan: ta starts at ai[0]; for i in 1..K-1:
    # if y < yi[i]: ta = (ai[i]-ta)/(yi[i]-y)*(y-yi[i-1]) + ta; break
    # else ta = ai[i]
    ta = ai[:, 0]
    done = yq <= yi[:, 0]
    for i in range(1, k):
        below = yq < yi[:, i]
        interp = (ai[:, i] - ta) / jnp.where(
            yi[:, i] == yq, 1.0, yi[:, i] - yq
        ) * (yq - yi[:, i - 1]) + ta
        new_ta = jnp.where(below, interp, ai[:, i])
        ta = jnp.where(done, ta, new_ta)
        done = done | below
    return ta


def rhs(m, fs: ForcingSlice, t, y, close_boundary: bool = True,
        exact_parity: bool = False):
    dy, _ = rhs_full(m, fs, t, y, close_boundary, exact_parity)
    return dy
