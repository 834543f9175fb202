"""Static configuration of the field and the renderer.

Plain frozen dataclasses holding the fields of the JAX package's
`ModelConfig` and `RenderConfig` that the port reads, under the same names
and defaults. The fields of the hash encoding, the proposal sampler and the
occupancy grid arrive with the slices that port them; the loss configuration
and the command line arrive with the training slice.
"""

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the SP-NeRF field."""

    fc_layers: int = 8
    fc_units: int = 512
    skips: Tuple[int, ...] = (4,)
    mapping: bool = False
    mapping_sizes: Tuple[int, int] = (10, 4)
    siren: bool = True
    num_sem_classes: int = 5
    s_embedding_factor: int = 1
    t_embedding_dims: int = 4
    beta: bool = False
    sem: bool = False
    encoding: str = "siren"  # "siren" (SP-NeRF flagship) | "hash" (not ported yet)


@dataclass(frozen=True)
class RenderConfig:
    """Rendering parameters."""

    n_samples: int = 64
    n_importance: int = 0
    guidedsample: bool = False
    solar_correction: bool = False  # derived from sc_lambda > 0
    beta: bool = False
    sem: bool = False
    perturb: float = 1.0
    compute_dtype: str = "float32"  # "bfloat16" for the flagship
    proposal: bool = False
    occ_grid: bool = False
