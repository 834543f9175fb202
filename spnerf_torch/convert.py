"""Weight bridge between the JAX package's flax parameter trees and the
port's state dicts.

Flax names the field's dense layers `TorchDense_i` in creation order; the
port keeps them at `dense.i` in the same order. For `SPNeRF` that order is
trunk, sigma, feats, rgb x2, sun x4, sky x2, [beta x2], [sem x2]; for
`HashSPNeRF` it is trunk x2, sigma, feats, rgb x2, sun x3, sky x2,
[beta x2], [sem x2]. Both store a dense kernel as (fan_in, out), so kernels
and biases are copied as they are. The semantic table keeps its zero pad row
at index `num_sem_classes`. The hash table, `HashGridEncoding_0/table` in
flax and `encoding.table` in the port, has the same layout in both, the
(L, T * F) flat feature-major row or the (L, T, F) table, and is copied
unchanged either way.
"""

import re

import numpy as np
import torch

_DENSE = re.compile(r"TorchDense_(\d+)$")
_HASH = "HashGridEncoding_0"


def _tensor(leaf):
    return torch.from_numpy(np.array(leaf, np.float32))


def field_state_dict(params):
    """flax field params (a nested mapping of arrays) -> `SPNeRF` or
    `HashSPNeRF` state dict."""
    sd = {}
    for name, leaf in params.items():
        m = _DENSE.match(name)
        if m:
            i = int(m.group(1))
            sd[f"dense.{i}.kernel"] = _tensor(leaf["kernel"])
            sd[f"dense.{i}.bias"] = _tensor(leaf["bias"])
        elif name == "semantic_embedding":
            sd["semantic_embedding"] = _tensor(leaf)
        elif name == _HASH and set(leaf) == {"table"}:
            sd["encoding.table"] = _tensor(leaf["table"])
        else:
            raise KeyError(f"unexpected field parameter {name!r}")
    return sd


def transient_state_dict(params_t):
    """flax `params["t"]` -> `TransientEmbedding` state dict."""
    return {"embedding": _tensor(params_t["embedding"])}


def flax_field_params(state_dict):
    """`SPNeRF` or `HashSPNeRF` state dict (or a dict of gradients under the
    same names) -> flax field params (numpy arrays)."""
    params = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().float().numpy()
        if key == "semantic_embedding":
            params[key] = arr
        elif key == "encoding.table":
            params[_HASH] = {"table": arr}
        else:
            _, i, leaf = key.split(".")
            params.setdefault(f"TorchDense_{i}", {})[leaf] = arr
    return params
