"""The system under test: `spnerf_torch` through its normal entry points,
`train.loop.Trainer` and `render.build_render_fn`, handed the benchmark's
weights and inputs. Nothing else of the benchmark imports the port.
"""

from contextlib import contextmanager

import torch

from . import flops


def port_configs(cfg):
    """(ModelConfig, RenderConfig, LossConfig) of a configuration file."""
    from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig

    model = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cfg["model"].items()}
    return (ModelConfig(**model), RenderConfig(**cfg["render"]),
            LossConfig(**cfg["loss"]))


def port_names(model):
    """The benchmark's weight names -> the port's parameter names: dense
    layer i of the field's creation order is `dense.<i>`."""
    names = {}
    for i, (layer, *_rest) in enumerate(flops.layer_specs(model)):
        names[f"{layer}.kernel"] = f"dense.{i}.kernel"
        names[f"{layer}.bias"] = f"dense.{i}.bias"
    if model["sem"]:
        names["sem_table"] = "semantic_embedding"
    return names


@torch.no_grad()
def load_weights(module, model, weights):
    """Copy the benchmark's weights into the port's field, in place (an
    optimizer built over its parameters keeps them)."""
    params = dict(module.named_parameters())
    names = port_names(model)
    if set(names.values()) != set(params):
        raise ValueError(f"the port's field has parameters "
                         f"{sorted(set(params) ^ set(names.values()))} "
                         f"that the configuration does not lay out alike")
    for ours, theirs in names.items():
        params[theirs].copy_(weights[ours])


class TrainProgram:
    """The port's training step over the benchmark's scene and weights."""

    def __init__(self, cfg, weights, scene, device):
        from spnerf_torch.train.loop import Trainer

        mc, rc, lc = port_configs(cfg)
        tc = cfg["train"]
        self.model_cfg = cfg["model"]
        self.trainer = Trainer(mc, rc, lc, lr=tc["lr"],
                               lr_gamma=tc["lr_gamma"],
                               steps_per_epoch=tc["steps_per_epoch"],
                               max_steps=tc["max_steps"], device=device)
        self.state = self.trainer.init_state(torch.Generator().manual_seed(0))
        load_weights(self.state.model, cfg["model"], weights)
        self.scene = scene
        self.beta1 = tc["adam_betas"][0]

    def step(self, batch_size, seed):
        """One step of the window's own call; returns its loss (a device
        scalar)."""
        return self.trainer.train_step(self.state, self.scene, batch_size,
                                       seed)["loss"]

    def _ours(self, theirs):
        names = {v: k for k, v in port_names(self.model_cfg).items()}
        return {names[n]: t for n, t in theirs.items()}

    def params(self):
        """The field's parameters by the benchmark's names (copies)."""
        return self._ours({n: p.detach().clone() for n, p in
                           self.state.model.named_parameters()})

    def first_gradients(self):
        """The gradient each parameter's optimizer got on the first step,
        from Adam's first moment after one step: m = (1 - beta1) g. A
        parameter with no moment in the optimizer's state is left out (the
        check reads it as missing)."""
        opt = self.state.optimizer
        grads = {}
        for n, p in self.state.model.named_parameters():
            st = opt.state.get(p, {})
            m = st.get("exp_avg", st.get("mu"))
            if m is not None:
                grads[n] = m.detach().float() / (1.0 - self.beta1)
        return self._ours(grads)


class RenderProgram:
    """The port's whole-image eval renderer over the benchmark's weights."""

    def __init__(self, cfg, weights, device):
        from spnerf_torch.models import load_model
        from spnerf_torch.render import build_render_fn

        mc, rc, _ = port_configs(cfg)
        model = load_model(mc, rc.compute_dtype, device=device,
                           generator=torch.Generator().manual_seed(0))
        load_weights(model, cfg["model"], weights)
        self.render_image = build_render_fn(model, rc)

    def view(self, rays, sems):
        """One view's per-ray outputs, read to the host: {name: tensor}."""
        out = self.render_image(rays, 0, sems=sems)
        return {k.removesuffix("_coarse"): v.float().cpu()
                for k, v in out.items()}


@contextmanager
def count_field_points(counts):
    """Count, into counts[heads], the points each call of the port's fused
    field evaluates on the card, for the field kernel's roofline."""
    from spnerf_torch.ops.field_eval import FusedField

    call = FusedField.__call__

    def counted(self, xyz, sun_d, t_emb=None, sem_labels=None, heads=None):
        if xyz.is_cuda:
            key = flops.ALL_HEADS if heads is None else tuple(heads)
            counts[key] = counts.get(key, 0) + xyz.shape[0]
        return call(self, xyz, sun_d, t_emb, sem_labels, heads)

    FusedField.__call__ = counted
    try:
        yield counts
    finally:
        FusedField.__call__ = call
