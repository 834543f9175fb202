"""Weight bridge between the JAX package's flax parameter trees and the
port's state dicts.

Flax names the field's dense layers `TorchDense_i` in creation order (trunk,
sigma, feats, rgb x2, sun x4, sky x2, [beta x2], [sem x2]); the port keeps
them at `dense.i` in the same order. Both store a dense kernel as
(fan_in, out), so kernels and biases are copied as they are. The semantic
table keeps its zero pad row at index `num_sem_classes`.
"""

import re

import numpy as np
import torch

_DENSE = re.compile(r"TorchDense_(\d+)$")


def field_state_dict(params):
    """flax field params (a nested mapping of arrays) -> `SPNeRF` state dict."""
    sd = {}
    for name, leaf in params.items():
        m = _DENSE.match(name)
        if m:
            i = int(m.group(1))
            sd[f"dense.{i}.kernel"] = torch.from_numpy(
                np.array(leaf["kernel"], np.float32))
            sd[f"dense.{i}.bias"] = torch.from_numpy(
                np.array(leaf["bias"], np.float32))
        elif name == "semantic_embedding":
            sd["semantic_embedding"] = torch.from_numpy(
                np.array(leaf, np.float32))
        else:
            raise KeyError(f"unexpected field parameter {name!r}")
    return sd


def transient_state_dict(params_t):
    """flax `params["t"]` -> `TransientEmbedding` state dict."""
    return {"embedding": torch.from_numpy(
        np.array(params_t["embedding"], np.float32))}


def flax_field_params(state_dict):
    """`SPNeRF` state dict -> flax field params (numpy arrays)."""
    params = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy()
        if key == "semantic_embedding":
            params[key] = arr
            continue
        _, i, leaf = key.split(".")
        params.setdefault(f"TorchDense_{i}", {})[leaf] = arr
    return params
