from .depth import (
    overlay_depth_on_image,
    padded_depth_image,
    visualize_depth_points,
    visualize_dsm,
)

__all__ = [
    "padded_depth_image",
    "visualize_depth_points",
    "overlay_depth_on_image",
    "visualize_dsm",
]
