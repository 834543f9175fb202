import torch

from .hashgrid import HashGridEncoding, HashSPNeRF, init_hash_spnerf
from .spnerf import (
    SPNeRF,
    TransientEmbedding,
    as_dtype,
    init_spnerf,
    positional_mapping,
)


def load_model(cfg, compute_dtype=None, device=None, generator=None):
    """The field module for the configuration, initialised from `generator`
    and placed on `device`. encoding="siren" is the SP-NeRF flagship,
    encoding="hash" the hash-grid family, whose table gradient runs through
    the hand-written kernels on CUDA (the JAX package's "matmul_vjp" impl on
    an accelerator); cfg.hash_flat_table and cfg.hash_impl choose its
    table's layout."""
    from ..device import resolve_device

    device = resolve_device(device)
    dtype = as_dtype(compute_dtype) if compute_dtype else torch.float32
    cls = HashSPNeRF if getattr(cfg, "encoding", "siren") == "hash" else SPNeRF
    return cls(cfg, dtype, generator).to(device)


__all__ = [
    "SPNeRF",
    "HashSPNeRF",
    "HashGridEncoding",
    "TransientEmbedding",
    "init_spnerf",
    "init_hash_spnerf",
    "positional_mapping",
    "load_model",
]
