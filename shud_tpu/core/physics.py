"""Pure elementwise physics (jnp), mirroring the reference flux laws.

Every function here is a direct, branch-for-branch vectorisation of the
reference equation library (``src/Equations/Equations.cpp``,
``src/classes/Element.cpp``, ``src/Equations/Flux_RiverElement.cpp``,
``src/ModelData/MD_RiverFlux.cpp``).  Branches become ``jnp.where`` chains in
the same order, so the JAX build is pointwise-identical to the C++ (verified
at 1e-12 by tests/test_rhs.py against the compiled reference oracle).
"""

from __future__ import annotations

import jax.numpy as jnp

from shud_tpu.config import EPSILON, GRAV, MINPSI, ZERO

__all__ = [
    "pow23",
    "mean_harmonic",
    "manning_equation",
    "avg_y_sf",
    "avg_y_gw",
    "eff_kh",
    "sat_k_fun",
    "sat2psi",
    "weir_flow_jtoi",
    "flux_r2e_gw",
    "fun_da_to_dy",
]


# Tiny positive floor used to keep sqrt/cbrt JVP-safe at exactly-zero
# arguments (d sqrt(x)/dx -> inf at 0 poisons Newton's exact JVPs).  The
# floors are value-neutral at f64 (relative value error < 1e-15).
_TINY = 1.0e-30


def pow23(x):
    t = jnp.cbrt(jnp.maximum(x, _TINY))
    return t * t


def mean_harmonic(k1, k2, d1, d2):
    return (k1 * k2) * (d1 + d2) / (d1 * k2 + d2 * k1)


def manning_equation(area, rough, r, s):
    """Signed-slope Manning (Equations.hpp:54-63). Q in m^3/min."""
    q_pos = jnp.sqrt(jnp.maximum(jnp.abs(s), _TINY)) * area * pow23(r) / rough
    return jnp.where(s > 0, q_pos, -q_pos)


def avg_y_sf(z1, y1, z2, y2, threshold):
    """Upwinded surface depth (Equations.cpp:8-50)."""
    h1 = z1 + y1
    h2 = z2 + y2
    up1 = jnp.where(y1 > threshold, y1, 0.0)
    up2 = jnp.where(y2 > threshold, y2, 0.0)
    return jnp.where(h1 > h2, up1, up2)


def avg_y_gw(y1, y2):
    """Arithmetic mean saturated thickness (Equations.cpp:52-69)."""
    return 0.5 * (jnp.maximum(y1, 0.0) + jnp.maximum(y2, 0.0))


def eff_kh(ygw, aq_depth, mac_d, k_mac, af, k_mx):
    """Effective horizontal conductivity (Equations.cpp:116-134)."""
    below_mac = (mac_d <= ZERO) | (ygw < aq_depth - mac_d)
    full = (k_mac * mac_d * af + k_mx * (aq_depth - mac_d * af)) / aq_depth
    part_num = k_mac * (ygw - (aq_depth - mac_d)) * af + k_mx * (
        aq_depth - mac_d + (ygw - (aq_depth - mac_d)) * (1.0 - af)
    )
    # guard ygw==0 division; branch is unused there
    part = part_num / jnp.where(ygw == 0.0, 1.0, ygw)
    return jnp.where(below_mac, k_mx, jnp.where(ygw > aq_depth, full, part))


def sat_k_fun(satn, n):
    """van Genuchten relative conductivity (Equations.cpp:136-141)."""
    temp = -1.0 + (1.0 - satn ** (n / (n - 1.0))) ** ((n - 1.0) / n)
    return jnp.sqrt(satn) * temp * temp


def sat2psi(satn, alpha, n):
    """van Genuchten pressure head (Equations.hpp:31-33)."""
    return -((satn ** (n / (1.0 - n)) - 1.0) ** (1.0 / n)) / alpha


def weir_flow_jtoi(zi, yi, zj, yj, zbank, cwr, width, threshold):
    """Broad-crested weir flow, positive j->i (MD_RiverFlux.cpp:65-98)."""
    hi = yi + zi
    hj = yj + zj
    dh = hj - hi
    y0 = hi - zbank

    # dh > 0 branch (j -> i, positive)
    y_pos = jnp.where(hi > zbank, dh, y0)
    q_pos = jnp.where(
        (y0 > 0.0) & (yj > threshold),
        cwr * jnp.sqrt(2.0 * GRAV * jnp.maximum(y_pos, _TINY)) * width
        * y_pos * 60.0,
        0.0,
    )
    # dh <= 0 branch (i -> j, negative)
    y_neg = jnp.where(hj > zbank, -dh, y0)
    q_neg = jnp.where(
        (y0 > 0.0) & (yi > threshold),
        -cwr * jnp.sqrt(2.0 * GRAV * jnp.maximum(y_neg, _TINY)) * width
        * y_neg * 60.0,
        0.0,
    )
    return jnp.where(dh > 0.0, q_pos, q_neg)


def weir_flow_jtoi_local(y0, yj, yi, cwr, width, threshold):
    """``weir_flow_jtoi`` in local-datum form for the reduced-precision
    path: ``y0 = yi + (zi - zbank)`` precomputed in f64, ``yj`` measured
    above the bank (``zj == zbank``).  Algebraically identical to
    ``weir_flow_jtoi(zi, yi, zbank, yj, zbank, ...)`` but f32-safe against
    km-scale absolute elevations (same trick as edge_dz_surf)."""
    dh = yj - y0
    y_pos = jnp.where(y0 > 0.0, dh, y0)
    q_pos = jnp.where(
        (y0 > 0.0) & (yj > threshold),
        cwr * jnp.sqrt(2.0 * GRAV * jnp.maximum(y_pos, _TINY)) * width
        * y_pos * 60.0,
        0.0,
    )
    y_neg = jnp.where(yj > 0.0, -dh, y0)
    q_neg = jnp.where(
        (y0 > 0.0) & (yi > threshold),
        -cwr * jnp.sqrt(2.0 * GRAV * jnp.maximum(y_neg, _TINY)) * width
        * y_neg * 60.0,
        0.0,
    )
    return jnp.where(dh > 0.0, q_pos, q_neg)


def flux_r2e_gw(yr, zr, ye, ze, k_ele, k_riv, length, d_riv):
    """River-bed Darcy exchange, positive river->element
    (Flux_RiverElement.cpp:11-55)."""
    k = 0.5 * (k_ele + k_riv)  # meanArithmetic(. , ., 1, 1)
    he = ye + ze
    hr = yr + zr
    dh = hr - he
    g = dh / d_riv

    a_r2e = jnp.where(he > zr, (yr + (he - zr)) * 0.5 * length, yr * length)
    q_r2e = jnp.where(yr < EPSILON, 0.0, a_r2e * k * g)

    a_e2r = (yr + (he - zr)) * 0.5 * length
    q_e2r = jnp.where(ye > ZERO, a_e2r * k * g, 0.0)

    q = jnp.where(dh > ZERO, q_r2e, jnp.where(dh < -ZERO, q_e2r, 0.0))
    return jnp.where((k_ele < ZERO) | (k_riv < ZERO), 0.0, q)


def fun_da_to_dy(da, w_top, s):
    """Cross-section area change -> stage change via the bank-slope
    quadratic (functions.hpp:117-155).

    Uses the citardauq form ``2·da / (w + sqrt(w² + 4s·da))`` — identical
    algebra to the reference's ``(-w + sqrt(w² + 4s·da)) / (2s)`` but
    without the w-vs-sqrt cancellation, which costs ~ulp(w²)/(4ws)
    absolute noise (≈4e-6 m/min in f32 at w≈8, s≈0.06) in the naive
    form."""
    s_abs = jnp.abs(s)
    cc = w_top * w_top + 4.0 * s_abs * da
    denom = w_top + jnp.sqrt(jnp.maximum(cc, _TINY))
    quad = jnp.where(
        cc < ZERO,
        -w_top / (2.0 * s_abs),
        2.0 * da / jnp.where(denom <= 0.0, 1.0, denom),
    )
    EPS_SLOPE = 0.05e-6
    dy = jnp.where(s_abs < EPS_SLOPE, da / w_top, quad)
    return jnp.where(da == 0.0, 0.0, dy)
