"""Land-surface forcing transform, potential ET, and bucket stores.

Vectorises ``Model_Data::tReadForcing`` (MD_ET.cpp:21-281: per-cell forcing
with lapse-rate temperature, TSR-scaled shortwave, Penman–Monteith PET) and
``Model_Data::ET`` (MD_ET.cpp:282-342: snow + canopy-interception buckets,
explicit step at the forcing cadence).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from shud_tpu.config import (
    CONST_RH,
    CP_AIR,
    DTDZ,
    IC_MAX,
    NA_VALUE,
    ROUGHNESS_WATER,
    SEC_A_DAY,
    T0_MELT,
    TRAIN,
    TSNOW,
    ZERO,
)


class CalibScalars(NamedTuple):
    c_prcp: jnp.ndarray
    c_temp: jnp.ndarray
    c_lai: jnp.ndarray
    c_mf: jnp.ndarray
    c_etp: jnp.ndarray
    c_ismax: jnp.ndarray


class CellForcing(NamedTuple):
    """Per-cell forcing at one step (the t_* arrays of the reference)."""

    prcp: jnp.ndarray  # [m/min]
    temp: jnp.ndarray  # [C]
    rh: jnp.ndarray
    wind: jnp.ndarray  # [m/s]
    rn: jnp.ndarray  # net MJ/m2/s
    lai: jnp.ndarray
    mf: jnp.ndarray  # [m/min/C]
    pot_evap: jnp.ndarray  # [m/min]
    pot_tran: jnp.ndarray  # [m/min]
    etp: jnp.ndarray  # [m/min]
    rn_h: jnp.ndarray  # diagnostic: horizontal-plane SW [W/m2]
    rn_t: jnp.ndarray  # diagnostic: terrain-corrected SW [W/m2]
    rn_factor: jnp.ndarray  # diagnostic: TSR factor


def cell_forcing(
    m,
    forc_vals,  # [S, 5] station (prcp mm/d, temp C, rh, wind, rn W/m2);
    #            [S, 8] with ET_MODE=1 (+ tmax C, tmin C, H0 MJ/m2/d)
    station_z,  # [S]
    lai_vals,  # [C_lai] LAI columns (1-based LC index selects col iLC-1)
    mf_vals,  # [C_mf]
    factor,  # [Ne] TSR factor for the current forcing interval (1.0 if off)
    cal: CalibScalars,
    swnet_mode: bool = False,
    terrain_radiation: bool = True,
    et_mode: int = 0,  # 0 Penman-Monteith | 1 Hargreaves | 2 Priestley-
    # Taylor.  The reference DECLARES these (Model_Control.hpp:184-187,
    # PET_Hargreaves/PET_Priestley_Taylor is_sm_et.cpp:3-30) but only ever
    # wires the PM path in tReadForcing; here all three are functional.
) -> CellForcing:
    # Station/class lookups are per-cell gathers from TINY tables with
    # STATIC indices; a one-hot contraction turns each into fused
    # elementwise work instead of a generic gather.
    def _onehot_pick(table, idx0):
        """table[idx0] via one-hot: [K,...] table, [Ne] static indices."""
        k = table.shape[0]
        if k == 1:
            return jnp.broadcast_to(table[0], idx0.shape + table.shape[1:])
        oh = idx0[:, None] == jnp.arange(k, dtype=idx0.dtype)[None, :]
        if table.ndim == 1:
            return jnp.where(oh, table[None, :], 0.0).sum(axis=1)
        return jnp.where(oh[:, :, None], table[None], 0.0).sum(axis=1)

    ifc = m.i_forc - 1  # [Ne] 0-based station
    sv = _onehot_pick(forc_vals, ifc)  # [Ne, 5 (or 8)]
    prcp_mmday = sv[:, 0] * cal.c_prcp
    t0 = sv[:, 1]
    zt = _onehot_pick(station_z, ifc)
    # TemperatureOnElevation (Equations.hpp:66-73): NA station z -> no lapse
    lapse_ok = (zt != NA_VALUE) & (m.z_surf != NA_VALUE)
    temp = jnp.where(lapse_ok, t0 + (zt - m.z_surf) * DTDZ, t0) + cal.c_temp

    # clamp column lookups: some shipped projects (heihe) have more
    # landcover classes than LAI columns — the reference reads out of
    # bounds there (UB); we clamp to the last column instead
    lai = _onehot_pick(
        lai_vals, jnp.clip(m.i_lc - 1, 0, lai_vals.shape[0] - 1)) * cal.c_lai
    mf = _onehot_pick(
        mf_vals, jnp.clip(m.i_mf - 1, 0, mf_vals.shape[0] - 1)
    ) * cal.c_mf / 1440.0

    dswrf_h = sv[:, 4]
    if terrain_radiation:
        dswrf_t = dswrf_h * factor
    else:
        factor = jnp.ones_like(dswrf_h)
        dswrf_t = dswrf_h
    if swnet_mode:
        rn = dswrf_t
    else:
        rn = dswrf_t * (1.0 - m.albedo)

    wind = jnp.abs(sv[:, 3]) + 0.001
    rh = jnp.clip(sv[:, 2], CONST_RH, 1.0)
    prcp = prcp_mmday * 0.001 / 1440.0
    rn = rn * 1.0e-6  # W/m2 -> MJ/m2/s

    # Penman-Monteith pieces (is_sm_et.hpp; Maidment Handbook eq 4.2.x)
    lam = 2.501 - 0.002361 * temp
    gamma = 0.0016286 * m.fix_pressure / lam
    es = 0.6108 * jnp.exp(17.27 * temp / (temp + 237.3))
    ed = es * (1.0 - rh)
    delta = 4098.0 * es / (temp + 237.3) ** 2
    rho = 3.486 * m.fix_pressure / (275.0 + temp)

    is_lake = m.i_lake > 0
    ghf = jnp.where(
        is_lake,
        0.0,
        jnp.where(lai > 0.0, 0.4 * jnp.exp(-0.5 * lai) * rn, 0.1 * rn),
    )
    rg = rn - ghf

    # open-water PET (eq 4.2.30), wind at 2 m via log profile
    u2 = wind * jnp.log(2.0 / ROUGHNESS_WATER) / jnp.log(
        m.wind_h / ROUGHNESS_WATER
    )
    pet_ow = (
        (delta * rg * SEC_A_DAY + gamma * 6.43 * (1.0 + 0.536 * u2) * ed)
        / (delta + gamma)
    ) / lam * 0.001 / SEC_A_DAY  # [m/s]
    pot_evap = cal.c_etp * pet_ow * 60.0  # [m/min]

    # vegetation PM transpiration (eq 4.2.27)
    hc = lai * 0.5
    zm = hc * 1.3333
    d = 0.67 * hc
    z_om = 0.123 * hc
    z_ov = 0.0123 * hc
    safe = lai > 0.0
    z_om_s = jnp.where(safe, z_om, 1.0)
    z_ov_s = jnp.where(safe, z_ov, 1.0)
    ra = (
        jnp.log(jnp.abs(zm - d) / z_om_s)
        * jnp.log(jnp.abs(zm - d) / z_ov_s)
        / (0.4 * 0.4 * wind)
    )
    rs = 200.0 / jnp.where(safe, lai, 1.0)
    e_rad = delta * rg
    e_air = rho * CP_AIR * ed / jnp.where(safe, ra, 1.0)
    pm = (e_rad + e_air) / (delta + gamma * (1.0 + rs / jnp.where(safe, ra, 1.0)))
    pot_tran_raw = cal.c_etp * (pm / lam * 0.001) * 60.0

    veg = safe & ~is_lake
    pot_tran = jnp.where(veg, pot_tran_raw, 0.0)

    if et_mode == 1:
        # Hargreaves (SWAT 2:2.2.24, PET_Hargreaves is_sm_et.cpp:3-15):
        # Eo = 0.023 H0 sqrt(Tmax-Tmin) (Tavg-17.8) / lambda  [mm/d], with
        # H0 the extraterrestrial radiation and daily station Tmax/Tmin
        # precomputed into forcing columns 5-7 (driver/forcing.py).
        tmax = sv[:, 5]
        tmin = sv[:, 6]
        h0 = sv[:, 7]
        # daily formula: Tavg = (Tmax+Tmin)/2 (FAO-56), carried to the cell
        # with the same lapse-rate/calibration offset as the instantaneous
        # temperature (temp - t0)
        tavg = 0.5 * (tmax + tmin) + (temp - t0)
        pet_mmday = (
            0.023 * h0 * jnp.sqrt(jnp.maximum(tmax - tmin, 0.0))
            * jnp.maximum(tavg - 17.8, 0.0) / lam
        )
        pet = cal.c_etp * pet_mmday * 0.001 / 1440.0  # [m/min]
        pot_evap = pet
        pot_tran = jnp.where(veg, pet, 0.0)
    elif et_mode == 2:
        # Priestley-Taylor (SWAT 2:2.2.23, PET_Priestley_Taylor
        # is_sm_et.cpp:16-30): Eo = a D/(D+g) (Hnet-G)/lambda, a=1.26
        pet_mmday = jnp.maximum(
            1.26 * delta / (delta + gamma) * (rg * SEC_A_DAY) / lam, 0.0
        )
        pet = cal.c_etp * pet_mmday * 0.001 / 1440.0  # [m/min]
        pot_evap = pet
        pot_tran = jnp.where(veg, pet, 0.0)

    etp = jnp.where(
        veg,
        pot_tran * m.veg_frac + pot_evap * (1.0 - m.veg_frac),
        pot_evap,
    )

    return CellForcing(
        prcp=prcp, temp=temp, rh=rh, wind=wind, rn=rn, lai=lai, mf=mf,
        pot_evap=pot_evap, pot_tran=pot_tran, etp=etp,
        rn_h=dswrf_h, rn_t=dswrf_t, rn_factor=factor,
    )


class BucketState(NamedTuple):
    ic_stg: jnp.ndarray  # yEleIS canopy interception [m]
    snow: jnp.ndarray  # yEleSnow [m SWE]


class BucketOut(NamedTuple):
    state: BucketState
    net_prcp: jnp.ndarray  # qEleNetPrep [m/min]
    e_ic: jnp.ndarray  # qEleE_IC [m/min]
    sn_frac: jnp.ndarray


def frozen_fraction(t, high, low):
    x = (high - t) / (high - low)
    return jnp.where(t > high, 0.0, jnp.where(t < low, 1.0, jnp.clip(x, 0.0, 1.0)))


def et_bucket_step(
    m, cf: CellForcing, bs: BucketState, dt_min, c_ismax
) -> BucketOut:
    """Snow + interception bucket update (``Model_Data::ET``,
    MD_ET.cpp:282-342).  Explicit step over ``dt_min`` minutes."""
    t = cf.temp
    prcp = cf.prcp
    sn_frac = frozen_fraction(t, TRAIN, TSNOW)
    sn_acc = sn_frac * prcp
    sn_melt = jnp.where(t > T0_MELT, (t - T0_MELT) * cf.mf, 0.0)
    sn_melt = jnp.minimum(
        jnp.maximum(0.0, bs.snow / dt_min), jnp.maximum(0.0, sn_melt)
    )
    snow = bs.snow + (sn_acc - sn_melt) * dt_min

    vg = m.veg_frac
    ic_stg = jnp.where(vg > ZERO, bs.ic_stg / jnp.where(vg > ZERO, vg, 1.0), 0.0)
    has_lai = cf.lai > ZERO
    ic_max = c_ismax * IC_MAX * cf.lai
    ic_acc = jnp.where(
        has_lai,
        jnp.minimum(prcp - sn_acc, jnp.maximum(0.0, (ic_max - ic_stg) / dt_min)),
        0.0,
    )
    ic_evap = jnp.where(
        has_lai,
        jnp.minimum(jnp.maximum(0.0, ic_stg / dt_min), cf.pot_evap),
        0.0,
    )
    ic_stg = ic_stg + (ic_acc - ic_evap) * dt_min

    return BucketOut(
        state=BucketState(ic_stg=ic_stg * vg, snow=snow),
        net_prcp=(1.0 - sn_frac) * prcp + sn_melt - ic_acc * vg,
        e_ic=ic_evap * vg,
        sn_frac=sn_frac,
    )
