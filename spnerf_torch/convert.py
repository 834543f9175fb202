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
unchanged either way. The fine field (`params["fine"]`) is a second field
of the same configuration; the proposal field (`params["proposal"]`,
`HashGridEncoding_0` and `TorchDense_0..1`) maps onto `ProposalField`'s
`encoding.table` and `dense.0..1` by the same rule.

`load_jax_train_state` carries a whole JAX `TrainState` across: the
weights of every module, the optimizer's state, the step and the occupancy
grid, so that a JAX run saved at
step k and the port restored at step k continue the same trajectory. The
optax state holds one `ScaleByAdamState` (count, mu, nu over the params
tree), alone under `optax.adam` or inside the chain of the optimizer
options; `torch.optim.Adam` keeps mu and nu as `exp_avg` and `exp_avg_sq`
with the count as each parameter's `step`, `AdamChain` as `mu` and `nu`
with one `count`.
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
    """`SPNeRF`, `HashSPNeRF` or `ProposalField` state dict (or a dict of
    gradients under the same names) -> flax field params (numpy arrays)."""
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


def _adam_state(opt_state):
    """The ScaleByAdamState (count, mu, nu) inside an optax state."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if all(hasattr(node, k) for k in ("count", "mu", "nu")):
            return node
        if isinstance(node, (tuple, list)):
            stack.extend(node)
    raise ValueError("the optax state holds no ScaleByAdamState")


# flax params key -> the port's TrainState prefix and state-dict converter
_MODULES = {"coarse": ("", field_state_dict),
            "fine": ("fine.", field_state_dict),
            "t": ("t_embed.", transient_state_dict),
            "proposal": ("proposal.", field_state_dict)}


def _by_port_name(tree):
    """flax params-shaped tree {"coarse": field, ["fine": field],
    ["t": transient], ["proposal": proposal]} -> {the port's
    `TrainState.named_parameters` name: tensor}."""
    unknown = set(tree) - set(_MODULES)
    if unknown:
        raise KeyError(f"unexpected parameter trees {sorted(unknown)}")
    named = {}
    for key, sub in tree.items():
        prefix, convert = _MODULES[key]
        named.update({prefix + k: v for k, v in convert(sub).items()})
    return named


def load_jax_train_state(state, params, opt_state, step, occ=None):
    """Carry a JAX `TrainState` (its params, opt_state, step and occ, as
    numpy trees) into the port's `TrainState` `state`, in place: the
    weights of every module, the optimizer's moments and count, the step
    and the occupancy grid."""
    modules = dict(state.modules())
    for key, (prefix, convert) in _MODULES.items():
        if (key in params) != (prefix in modules):
            raise KeyError(f"the JAX state and the port's disagree on "
                           f"{key!r}")
        if key in params:
            modules[prefix].load_state_dict(convert(params[key]))
    names = [n for n, _ in state.named_parameters()]
    if (occ is None) != (state.occ is None):
        raise KeyError("the JAX state and the port's disagree on the "
                       "occupancy grid")
    if occ is not None:
        state.occ.copy_(torch.from_numpy(np.array(occ, np.float32)))
    adam = _adam_state(opt_state)
    mu, nu = _by_port_name(adam.mu), _by_port_name(adam.nu)
    if set(mu) != set(names):
        raise KeyError(f"optimizer state {sorted(mu)} against parameters "
                       f"{sorted(names)}")
    count = int(np.asarray(adam.count))
    sd = state.optimizer.state_dict()
    if isinstance(state.optimizer, torch.optim.Adam):
        sd["state"] = {i: {"step": torch.tensor(float(count)),
                           "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                       for i, n in enumerate(names)}
    else:
        sd["state"] = {i: {"mu": mu[n], "nu": nu[n]}
                       for i, n in enumerate(names)}
        sd["count"] = count
    state.optimizer.load_state_dict(sd)
    state.step = int(np.asarray(step))
    return state
