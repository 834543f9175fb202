"""Static configuration of the field, the renderer and the losses.

Plain frozen dataclasses holding the fields of the JAX package's
`ModelConfig`, `RenderConfig` and `LossConfig` that the port reads, under the
same names and defaults (`LossConfig.margin` and `stdscale` are read by the
depth loaders of the data slice). The fields of the proposal sampler and the
occupancy grid arrive with the slices that port them; the command line
arrives with the CLI slice.
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
    encoding: str = "siren"  # "siren" (SP-NeRF flagship) | "hash" (NGP-style)
    # hash-grid geometry (encoding="hash" only)
    hash_levels: int = 8
    hash_features: int = 4
    hash_log2T: int = 19
    hash_hidden: int = 64  # width of the hash trunk and head MLPs
    hash_frames: int = 1  # multi-AOI frames; only 1 is ported
    # levels whose dense grid fits the table index it directly
    hash_direct_coarse: bool = True
    # "auto" | "xla" | "sorted_vjp" | "matmul_vjp" | "fused_vjp": the JAX
    # package's lookup implementations. In the port every impl computes the
    # same function; the impl only decides the table's layout (below)
    hash_impl: str = "auto"
    # each level's table is one flat feature-major row, row[f * T + t], when
    # this is set and the impl is "auto", "xla" or "matmul_vjp"; else the
    # table is (L, T, F) (--no_hash_flat_table, older checkpoints)
    hash_flat_table: bool = True
    # coarse-to-fine level annealing over the first N steps; 0 = off
    hash_anneal_steps: int = 0


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


@dataclass(frozen=True)
class LossConfig:
    """Loss parameters."""

    sc_lambda: float = 0.0
    beta: bool = False
    ds_lambda: float = 0.0
    depth: bool = False
    gnll: bool = False
    usealldepth: bool = False
    margin: float = 0.0001
    stdscale: float = 1.0
    sem: bool = False
    ss_lambda: float = 4e-2
    first_beta_epoch: int = 2
