"""Solar geometry and terrain solar radiation (TSR).

Reimplements the reference's NOAA-style solar position
(``src/Equations/SolarRadiation.cpp:95-180``) and the per-forcing-interval
cosZ-weighted equivalent terrain factor (``src/ModelData/MD_ET.cpp:62-204``)
as vectorised jnp code.  The per-interval solar samples are shared across
elements (as in the reference's bucket cache); here they are precomputed for
ALL forcing intervals up front and evaluate the per-cell factor inside the
jitted step.
"""

from __future__ import annotations

import datetime

import jax
import jax.numpy as jnp
import numpy as np


def day_of_year_table(base_yyyymmdd: int, num_days: int) -> np.ndarray:
    """Day-of-year for each simulated day since the forcing base date."""
    y = base_yyyymmdd // 10000
    m = (base_yyyymmdd // 100) % 100
    d = base_yyyymmdd % 100
    base = datetime.date(y, m, d)
    out = np.empty(num_days, dtype=np.int32)
    for i in range(num_days):
        out[i] = (base + datetime.timedelta(days=i)).timetuple().tm_yday
    return out


def solar_position(t_min, doy, lat_deg, lon_deg, timezone_hours=0.0):
    """Vectorised solarPosition (SolarRadiation.cpp:95-180), UTC.

    Returns (cosZ, azimuth [rad, North=0 East=pi/2], declination)."""
    lat = jnp.clip(lat_deg, -90.0, 90.0)
    lon = lon_deg  # assumed already in [-180, 180]

    mod_min = jnp.mod(t_min, 1440.0)
    hour = mod_min / 60.0

    two_pi = 2.0 * jnp.pi
    gamma = (two_pi / 365.0) * ((doy - 1).astype(t_min.dtype) + (hour - 12.0) / 24.0)
    sin_g, cos_g = jnp.sin(gamma), jnp.cos(gamma)
    sin_2g, cos_2g = jnp.sin(2 * gamma), jnp.cos(2 * gamma)
    sin_3g, cos_3g = jnp.sin(3 * gamma), jnp.cos(3 * gamma)

    eq_time = 229.18 * (
        0.000075 + 0.001868 * cos_g - 0.032077 * sin_g
        - 0.014615 * cos_2g - 0.040849 * sin_2g
    )
    decl = (
        0.006918 - 0.399912 * cos_g + 0.070257 * sin_g - 0.006758 * cos_2g
        + 0.000907 * sin_2g - 0.002697 * cos_3g + 0.00148 * sin_3g
    )
    time_offset = eq_time + 4.0 * lon - 60.0 * timezone_hours
    tst = jnp.mod(mod_min + time_offset, 1440.0)
    ha = (tst / 4.0 - 180.0) * (jnp.pi / 180.0)

    lat_r = lat * (jnp.pi / 180.0)
    cosz = jnp.clip(
        jnp.sin(lat_r) * jnp.sin(decl)
        + jnp.cos(lat_r) * jnp.cos(decl) * jnp.cos(ha),
        -1.0, 1.0,
    )
    east = -jnp.cos(decl) * jnp.sin(ha)
    north = jnp.cos(lat_r) * jnp.sin(decl) - jnp.sin(lat_r) * jnp.cos(decl) * jnp.cos(ha)
    az = jnp.mod(jnp.arctan2(east, north), 2.0 * jnp.pi)
    return cosz, az, decl


def interval_samples(
    t0: np.ndarray,
    t1: np.ndarray,
    dt_int_min: int,
    lat_deg: float,
    lon_deg: float,
    base_yyyymmdd: int,
):
    """Precompute per-forcing-interval solar sample vectors.

    Mirrors the bucket fill at MD_ET.cpp:94-160: for interval k the factor
    integrand is sampled at ``n = ceil((t1-t0)/dt_int)`` midpoints, each with
    weight ``max(cosZ,0)*dt_seg``.

    Returns (sx, sy, sz, wdt) each [K, nmax] plus den [K]."""
    t0 = np.asarray(t0, dtype=np.float64)
    t1 = np.asarray(t1, dtype=np.float64)
    k = len(t0)
    dt_forc = t1 - t0
    dt_int = np.minimum(float(dt_int_min), dt_forc)
    n = np.maximum(np.ceil(dt_forc / dt_int).astype(int), 1)
    nmax = int(n.max())
    dt_seg = dt_forc / n

    # sample times [K, nmax]
    ks = np.arange(nmax)[None, :]
    tk = t0[:, None] + (ks + 0.5) * dt_seg[:, None]
    valid = ks < n[:, None]

    max_day = int(np.ceil(t1.max() / 1440.0)) + 2
    doy_tab = day_of_year_table(base_yyyymmdd, max_day)
    day_idx = np.clip((tk // 1440.0).astype(int), 0, max_day - 1)
    doy = doy_tab[day_idx]

    # host-side precompute MUST run on a LOCAL CPU device: eager per-op
    # dispatch to an accelerator would turn this setup step into minutes,
    # and under multi-process execution jax.devices() includes
    # other ranks' devices whose values this process cannot fetch
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        cosz, az, _ = solar_position(
            jnp.asarray(tk), jnp.asarray(doy), lat_deg, lon_deg, 0.0
        )
        cosz = np.asarray(cosz)
        az = np.asarray(az)

    cosz_cl = np.clip(cosz, -1.0, 1.0)
    sinz = np.sqrt(np.maximum(0.0, 1.0 - cosz_cl**2))
    sx = sinz * np.sin(az)
    sy = sinz * np.cos(az)
    sz = cosz_cl
    wdt = np.maximum(0.0, cosz_cl) * dt_seg[:, None]
    wdt = np.where(valid & (cosz > 0.0) & (wdt > 0.0), wdt, 0.0)
    den = wdt.sum(axis=1)
    return sx, sy, sz, wdt, den


def tsr_factor(nx, ny, nz, sx, sy, sz, wdt, den, cap, cosz_min):
    """Per-cell equivalent terrain factor for one forcing interval.

    nx/ny/nz: [Ne]; sx/sy/sz/wdt: [n] samples; den: scalar.
    Mirrors MD_ET.cpp:163-204."""
    cosi = (
        nx[:, None] * sx[None, :]
        + ny[:, None] * sy[None, :]
        + nz[:, None] * sz[None, :]
    )  # [Ne, n]
    denom = jnp.maximum(sz, cosz_min)[None, :]
    fk = cosi / denom
    fk = jnp.where((cosi > 0.0) & (fk > 0.0), jnp.minimum(fk, cap), 0.0)
    num = jnp.sum(wdt[None, :] * fk, axis=1)
    feff = jnp.where(den > 0.0, num / jnp.where(den > 0.0, den, 1.0), 0.0)
    feff = jnp.where(feff > 0.0, jnp.minimum(feff, cap), 0.0)
    return feff
