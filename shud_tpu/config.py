"""Global numeric configuration.

The prognostic heads require f64-class precision (CVODE-class tolerances of
1e-4 m against elevations of ~1e3 m); diagnostics and forcing can be f32.
The f32 mode moves half the bytes and relies on precomputed neighbour
elevation *differences* (local-datum trick) — see ``shud_tpu.core.mesh``.
"""

from __future__ import annotations

import jax
import numpy as np

_X64_ENABLED = False


def enable_x64() -> None:
    global _X64_ENABLED
    if not _X64_ENABLED:
        jax.config.update("jax_enable_x64", True)
        _X64_ENABLED = True


#: dtype of the prognostic state vector
STATE_DTYPE = np.float64
#: dtype of static geometry / parameter arrays
GEOM_DTYPE = np.float64
#: dtype of index arrays
INDEX_DTYPE = np.int32

# ---------------------------------------------------------------------------
# Physical and numerical constants (reference: src/Model/Macros.hpp)
# ---------------------------------------------------------------------------
EPSILON = 0.005
ZERO = 1.0e-10
EPS_SLOPE = 0.05e-6
MINPSI = -1000000.0
FIELD_CAPACITY_RATIO = 0.75
PI = 3.1415926  # the reference's truncated pi (Macros.hpp:46); kept for parity
MINRIVSLOPE = 4e-4
DTDZ = 0.0065  # adiabatic lapse rate [K/m]
GRAV = 9.8  # [m/s^2]
TSNOW = -3.0  # threshold temperature for snow [C]
TRAIN = 1.0
T0_MELT = 0.0
ROUGHNESS_WATER = 0.00137
CONST_RH = 0.01
IC_MAX = 0.0002  # maximum canopy interception per unit LAI [m]
MAXYSURF = 0.5  # hard cap on upwinded surface depth [m] (stabiliser)
VON_KARMAN = 0.4
HEIGHT_WIND_MEASURE = 10.0
CP_AIR = 1.013e-3  # specific heat of air [MJ kg-1 C-1]
SEC_A_DAY = 86400.0
NA_VALUE = -9999
