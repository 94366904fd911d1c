"""E3SM physical constants used by the ported path.

A copy of the values in ``climsim_tpu/constants.py`` (E3SM
``share/util/shr_const_mod.F90`` as used by ClimSim), kept here so the
port imports nothing of the JAX package.
"""

GRAV = 9.80616        # acceleration of gravity            [m s-2]
CP = 1.00464e3        # specific heat of dry air           [J kg-1 K-1]
LV = 2.501e6          # latent heat of evaporation         [J kg-1]
LF = 3.337e5          # latent heat of fusion              [J kg-1]
LSUB = LV + LF        # latent heat of sublimation         [J kg-1]
RHO_AIR = 101325.0 / (6.02214e26 * 1.38065e-23 / 28.966) / 273.15
#                     density of dry air at STP ~ 1.29231  [kg m-3]
RHO_H2O = 1.0e3       # density of fresh water             [kg m-3]

RD = 287.0            # specific gas constant, dry air     [J kg-1 K-1]
RV = 461.0            # specific gas constant, water vapor [J kg-1 K-1]

T0_FREEZE = 273.16    # freezing temperature (triple point)        [K]
T_ICE_RAMP = 253.16   # below this: pure-ice saturation / ramp low [K]

EARTH_RADIUS = 6.37122e6  # SHR_CONST_REARTH                       [m]

P0 = 1.0e5            # hybrid-coordinate reference pressure       [Pa]
DT_STEP = 1200.0      # E3SM-MMF coupling timestep (20 minutes)    [s]

NCOL_LOWRES = 384     # ne4pg2 grid columns (low-res ClimSim)
NCOL_HIGHRES = 21600  # high-res real-geography columns
NLEV = 60             # vertical levels
