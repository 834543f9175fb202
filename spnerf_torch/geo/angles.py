"""View / solar incidence angles and image sorting.

The JAX package's `geo/angles.py`, after the reference SP-NeRF's
dataset-inspection helpers (`modules/utils.py:248-275`): rank the AOI's images by view
incidence angle (how far the look direction tilts from the local vertical at
the AOI center) or by solar incidence angle.

The reference gets the view angle from rpcm's `incidence_angles`; here it is
derived from the RPC directly: localize the AOI-center pixel at two altitudes,
form the look direction in ECEF, and measure its angle against the geodetic
up vector — the same geometry without the dependency.
"""

import glob
import json
import os

import numpy as np

from .ellipsoid import geodetic_to_ecef
from .rpc import RPCModel


def _geodetic_up(lat_deg, lon_deg):
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    return np.array([
        np.cos(lat) * np.cos(lon),
        np.cos(lat) * np.sin(lon),
        np.sin(lat),
    ])


def view_incidence_angle(rpc: RPCModel, lon, lat, z=0.0, dz=100.0):
    """Angle (degrees) between the viewing ray through (lon, lat, z) and the
    local vertical."""
    col, row = rpc.projection(np.array([lon]), np.array([lat]), np.array([z]))
    lo1, la1 = rpc.localization(col, row, np.array([z]))
    lo2, la2 = rpc.localization(col, row, np.array([z + dz]))
    p1 = np.array(geodetic_to_ecef(la1[0], lo1[0], z))
    p2 = np.array(geodetic_to_ecef(la2[0], lo2[0], z + dz))
    look_up = (p2 - p1) / np.linalg.norm(p2 - p1)  # toward the sensor
    up = _geodetic_up(lat, lon)
    cosang = float(np.clip(np.dot(look_up, up), -1.0, 1.0))
    return float(np.degrees(np.arccos(cosang)))


def solar_incidence_angle(sun_elevation_deg, sun_azimuth_deg):
    """Angle (degrees) between the sun direction and the surface normal
    (reference modules/utils.py:261-275 with normal = +z)."""
    el = np.radians(float(sun_elevation_deg))
    az = np.radians(float(sun_azimuth_deg))
    sun_d = np.array([np.sin(az) * np.cos(el), np.cos(az) * np.cos(el),
                      np.sin(el)])
    sun_d /= np.linalg.norm(sun_d)
    return float(np.degrees(np.arccos(np.clip(sun_d[2], -1.0, 1.0))))


def sort_by_increasing_view_incidence_angle(json_dir):
    """Json paths sorted by view incidence angle at the geojson center."""
    out = []
    for json_p in glob.glob(os.path.join(json_dir, "*.json")):
        with open(json_p) as f:
            d = json.load(f)
        rpc = RPCModel.from_dict(d["rpc"])
        lon_c, lat_c = d["geojson"]["center"][:2]
        out.append((view_incidence_angle(rpc, lon_c, lat_c), json_p))
    return [p for _, p in sorted(out)]


def sort_by_increasing_solar_incidence_angle(json_dir):
    out = []
    for json_p in glob.glob(os.path.join(json_dir, "*.json")):
        with open(json_p) as f:
            d = json.load(f)
        out.append((solar_incidence_angle(d["sun_elevation"],
                                          d["sun_azimuth"]), json_p))
    return [p for _, p in sorted(out)]
