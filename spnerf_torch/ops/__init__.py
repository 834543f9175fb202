from .compositing import composite
from .render import render_rays
from .sampling import (
    compute_samples_around_depth,
    guided_samples,
    sample_3sigma,
    sample_pdf,
    stratified_z_vals,
)

__all__ = [
    "sample_pdf",
    "sample_3sigma",
    "compute_samples_around_depth",
    "guided_samples",
    "stratified_z_vals",
    "composite",
    "render_rays",
]
