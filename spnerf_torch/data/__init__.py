from .dataset import SatelliteScene, load_scene
from .rays import SceneNorm, cast_rays, sun_direction

__all__ = [
    "SatelliteScene",
    "load_scene",
    "cast_rays",
    "sun_direction",
    "SceneNorm",
]
