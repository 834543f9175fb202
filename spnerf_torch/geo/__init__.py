from .angles import (
    solar_incidence_angle,
    sort_by_increasing_solar_incidence_angle,
    sort_by_increasing_view_incidence_angle,
    view_incidence_angle,
)
from .ellipsoid import ecef_to_latlon, geodetic_to_ecef
from .rpc import RPCModel
from .utm import latlon_to_utm, utm_epsg, utm_to_latlon, utm_zone

__all__ = [
    "geodetic_to_ecef",
    "ecef_to_latlon",
    "RPCModel",
    "latlon_to_utm",
    "utm_to_latlon",
    "utm_zone",
    "utm_epsg",
    "view_incidence_angle",
    "solar_incidence_angle",
    "sort_by_increasing_view_incidence_angle",
    "sort_by_increasing_solar_incidence_angle",
]
