import torch

from .spnerf import (
    SPNeRF,
    TransientEmbedding,
    as_dtype,
    init_spnerf,
    positional_mapping,
)


def load_model(cfg, compute_dtype=None, device=None, generator=None):
    """The field module for the configuration, initialised from `generator`
    and placed on `device`. encoding="siren" is the SP-NeRF flagship."""
    from ..device import resolve_device

    if getattr(cfg, "encoding", "siren") == "hash":
        raise NotImplementedError(
            "encoding='hash' is not ported yet (ROADMAP A10)")
    device = resolve_device(device)
    dtype = as_dtype(compute_dtype) if compute_dtype else torch.float32
    return SPNeRF(cfg, dtype, generator).to(device)


__all__ = [
    "SPNeRF",
    "TransientEmbedding",
    "init_spnerf",
    "positional_mapping",
    "load_model",
]
