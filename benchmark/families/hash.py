"""The hash family: SP-NeRF with the multiresolution hash-grid encoding of
Instant-NGP in place of the Siren trunk (`--encoding hash`), the port's
`models/hashgrid.py`, at the configuration's levels, features, table size
and hidden width.

Its weights are laid out by the port's own parameter names
("encoding.table" (L, F T) feature-major, "dense.<i>.kernel" and
"dense.<i>.bias" in the field's layer order, "semantic_embedding"), its
programs drive the port's `Trainer` and whole-image renderer (which runs
the field through its modules: no fused kernel takes this field), its
reference is `reference_hash.py`, and its counts are the MLPs' products and
the encoding's least traffic. What a family gives is listed in
benchmark/README.md ("A model family").
"""

from contextlib import contextmanager

import torch

from benchmark import flops, program, reference_hash, traffic

LOWER = reference_hash.LOWER  # the control's precision, by the stated one
# The table's draw: uniform in +-TABLE_BOUND, of unit variance as the
# semantic embedding's entries, so that every level's four features move the
# trunk's input as much as the embedding does (Instant-NGP starts its table
# at +-1e-4, where the outputs would hardly depend on the encoding and a
# wrong hash would pass the check).
TABLE_BOUND = 3.0 ** 0.5
ENCODED = "hash.encode"  # the key of the window's encoded points

reference_train = reference_hash.train
reference_eval_rows = reference_hash.eval_rows


def counted_encoding():
    """The port's hash encoding, which this family needs with its point
    counter `HashGridEncoding.points` (and the `hash.encode` span beside
    it). A port without them runs the encoding with blocking host-to-device
    copies at every call and is not the program this configuration
    measures, so loading the family there fails at once, naming what is
    missing."""
    from spnerf_torch.models.hashgrid import HashGridEncoding

    if not isinstance(getattr(HashGridEncoding, "points", None), int):
        raise RuntimeError(
            "the hash family needs spnerf_torch.models.hashgrid."
            "HashGridEncoding.points, the port's count of encoded points, "
            "which this port lacks")
    return HashGridEncoding


counted_encoding()  # a port that cannot run the configuration fails here


def make_weights(model, seed, device):
    """The field's float32 weights by the port's names, from the seed: the
    table uniform in +-TABLE_BOUND, each dense kernel and bias uniform
    within torch's default bound 1 / sqrt(fan_in), and a normal semantic
    table whose last row, the IGNORE label's, is zero."""
    g = traffic.generator(seed, traffic.WEIGHTS, device)
    levels, n_feat = model["hash_levels"], model["hash_features"]
    shape = (levels, 2 ** model["hash_log2T"] * n_feat)
    table = torch.rand(shape, generator=g, device=device)
    weights = {"encoding.table": table.mul_(2.0 * TABLE_BOUND)
               .sub_(TABLE_BOUND)}
    for i, (_, fan_in, out) in enumerate(reference_hash.layer_specs(model)):
        bound = fan_in ** -0.5
        for name, shape in (("kernel", (fan_in, out)), ("bias", (out,))):
            u = torch.rand(shape, generator=g, device=device)
            weights[f"dense.{i}.{name}"] = u.mul_(2.0 * bound).sub_(bound)
    if model["sem"]:
        c = model["num_sem_classes"]
        emb = torch.randn((c + 1, c * model["s_embedding_factor"]),
                          generator=g, device=device)
        emb[c] = 0.0
        weights["semantic_embedding"] = emb
    return weights


def label_classes(model):
    """The semantic classes a scene's and a view's labels are drawn from."""
    return model["num_sem_classes"]


@torch.no_grad()
def load_weights(module, weights):
    """Copy the weights into the port's field by name, in place."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the port's hash field has parameters "
                         f"{sorted(set(params) ^ set(weights))} that the "
                         f"configuration does not lay out alike")
    for name, w in weights.items():
        params[name].copy_(w)


class TrainProgram(program.TrainProgram):
    """The port's training step over the benchmark's scene and weights."""

    def __init__(self, cfg, weights, scene, device):
        from spnerf_torch.train.loop import Trainer

        mc, rc, lc = program.port_configs(cfg)
        tc = cfg["train"]
        self.trainer = Trainer(mc, rc, lc, lr=tc["lr"],
                               lr_gamma=tc["lr_gamma"],
                               steps_per_epoch=tc["steps_per_epoch"],
                               max_steps=tc["max_steps"], device=device)
        self.state = self.trainer.init_state(torch.Generator().manual_seed(0))
        load_weights(self.state.model, weights)
        self.scene = scene
        self.beta1 = tc["adam_betas"][0]

    def _ours(self, theirs):
        return dict(theirs)  # the weights go by the port's names


class RenderProgram(program.RenderProgram):
    """The port's whole-image eval renderer over the benchmark's weights."""

    def __init__(self, cfg, weights, device):
        from spnerf_torch.models import load_model
        from spnerf_torch.render import build_render_fn

        mc, rc, _ = program.port_configs(cfg)
        model = load_model(mc, rc.compute_dtype, device=device,
                           generator=torch.Generator().manual_seed(0))
        load_weights(model, weights)
        self.render_image = build_render_fn(model, rc)


def train_flops_per_ray(cfg):
    """Forward and backward products a trained ray needs: three times the
    forward's view pass (every head) and solar pass (the sun head)."""
    m, r = cfg["model"], cfg["render"]
    return 3 * (flops.view_points_per_ray(r)
                * reference_hash.flops_per_point(m)
                + flops.solar_points_per_ray(r)
                * reference_hash.flops_per_point(m, reference_hash.SUN_HEADS))


def render_flops_per_ray(cfg):
    """Products an eval-rendered ray needs for its outputs: the view pass
    with every head (the eval outputs drop the solar pass)."""
    m, r = cfg["model"], cfg["render"]
    return flops.view_points_per_ray(r) * reference_hash.flops_per_point(m)


@contextmanager
def count_points(counts):
    """counts[ENCODED]: the points the port's hash encoding took during the
    block, from its counter `HashGridEncoding.points`."""
    encoding = counted_encoding()
    start = encoding.points
    try:
        yield counts
    finally:
        counts[ENCODED] = encoding.points - start


def encode_work(model, points, compute_dtype):
    """(operations, bytes) the least any encoding of `points` points must
    do: the trilinear interpolation's seven lerps a feature and level (3
    operations each), each point's position read once in float32 and its
    L F features written once in the compute dtype. No table read is
    counted: a level's corners may come from the cache."""
    feats = model["hash_levels"] * model["hash_features"]
    ops = points * feats * 7 * 3
    nbytes = points * (3 * 4 + feats * flops.DTYPE_BYTES[compute_dtype])
    return ops, nbytes
