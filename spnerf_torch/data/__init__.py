from .dataset import SatelliteScene, load_scene
from .multi import FRAME_SPACING, MultiScene, load_scenes
from .rays import SceneNorm, cast_rays, sun_direction

__all__ = [
    "SatelliteScene",
    "load_scene",
    "load_scenes",
    "MultiScene",
    "FRAME_SPACING",
    "cast_rays",
    "sun_direction",
    "SceneNorm",
]
