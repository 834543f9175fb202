"""WGS-84 ellipsoid conversions between geodetic (lat, lon, alt) and ECEF (x, y, z).

The formulas of `spnerf_tpu/geo/ellipsoid.py` (the reference SP-NeRF's
`modules/utils.py:80-122`), float64 numpy on the host, so that ray origins and
DSM altitudes agree with the JAX package bit for bit.
"""

import numpy as np

# WGS-84 parameters
WGS84_A = 6378137.0  # semi-major axis [m]
WGS84_B = 6356752.314245  # semi-minor axis [m]
WGS84_E2 = 1.0 - (WGS84_B**2 / WGS84_A**2)  # first eccentricity squared


def geodetic_to_ecef(lat, lon, alt):
    """Geodetic (degrees, degrees, meters) -> ECEF (meters).

    Reference semantics: SP-NeRF `modules/utils.py:80-100`.
    """
    lat_rad = np.radians(lat)
    lon_rad = np.radians(lon)
    sin_lat = np.sin(lat_rad)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
    x = (n + alt) * np.cos(lat_rad) * np.cos(lon_rad)
    y = (n + alt) * np.cos(lat_rad) * np.sin(lon_rad)
    z = ((WGS84_B**2 / WGS84_A**2) * n + alt) * sin_lat
    return x, y, z


def ecef_to_latlon(x, y, z):
    """ECEF (meters) -> geodetic (lat deg, lon deg, alt m), closed form (Bowring).

    Reference semantics: SP-NeRF `modules/utils.py:103-122` (the "custom"
    non-iterative conversion used for the DSM pipeline). Accuracy is sub-millimeter
    for near-surface points, which is what the predicted point clouds are.
    """
    a = WGS84_A
    e = 8.1819190842622e-2
    asq = a**2
    esq = e**2
    b = np.sqrt(asq * (1.0 - esq))
    bsq = b**2
    ep = np.sqrt((asq - bsq) / bsq)
    p = np.sqrt(x**2 + y**2)
    th = np.arctan2(a * z, b * p)
    lon = np.arctan2(y, x)
    lat = np.arctan2(z + ep**2 * b * np.sin(th) ** 3, p - esq * a * np.cos(th) ** 3)
    n = a / np.sqrt(1.0 - esq * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    return np.degrees(lat), np.degrees(lon), alt
