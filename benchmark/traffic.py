"""The general generator: a training scene and eval views from a traffic
mix's parameters, and the Siren family's weights from its configuration,
all from the run's seed on the device.

Every draw comes from a `torch.Generator` on the run's device seeded from
(seed, purpose), in a few large calls, so the same seed gives the same
inputs and the two sides of a comparison are handed the same tensors. The
rays follow the recipe of the port's synthetic scene (`utils/synth.py`
`fake_batch`): origins normal with a small spread, unit directions and sun
directions drawn uniformly on the sphere, near and far from the mix.
"""

import math

import numpy as np
import torch

from . import flops

# purposes of the sub-seeds drawn from one run seed
WEIGHTS, SCENE, VIEWS, SAMPLE = 1, 2, 3, 4

BOUNDS = {  # the three uniform inits of the field, by fan-in
    "torch": lambda fan_in: 1.0 / math.sqrt(fan_in),
    "sine": lambda fan_in: math.sqrt(6.0 / fan_in),
    "first_sine": lambda fan_in: 1.0 / fan_in,
}


def sub_seed(seed, purpose):
    """A 63-bit seed for one purpose of run seed `seed` (any integer)."""
    hi, lo = np.random.SeedSequence([int(seed), purpose]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) & (2 ** 63 - 1)


def generator(seed, purpose, device):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return g


def make_weights(model, seed, device):
    """The field's float32 weights by name ("<layer>.kernel" (fan_in, out),
    "<layer>.bias", "sem_table"): one uniform draw cut into leaves, each
    scaled to its init's bound (Siren's for the sine layers, torch's
    default elsewhere and for every bias), and a normal semantic table whose
    last row, the IGNORE label's, is zero."""
    g = generator(seed, WEIGHTS, device)
    specs = flops.layer_specs(model)
    total = sum((sum(segs) + 1) * out for _, segs, out, _ in specs)
    flat = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    weights, ofs = {}, 0
    for name, segs, out, init in specs:
        fan_in = sum(segs)
        k = flat[ofs:ofs + fan_in * out].view(fan_in, out)
        ofs += fan_in * out
        b = flat[ofs:ofs + out]
        ofs += out
        weights[f"{name}.kernel"] = k.mul_(BOUNDS[init](fan_in))
        weights[f"{name}.bias"] = b.mul_(BOUNDS["torch"](fan_in))
    if model["sem"]:
        c = model["num_sem_classes"]
        table = torch.randn((c + 1, c * model["s_embedding_factor"]),
                            generator=g, device=device)
        table[c] = 0.0
        weights["sem_table"] = table
    return weights


def make_rays(n, mix, g, device):
    """(n, 11) rays: origin, unit direction, near, far, unit sun direction."""
    o = torch.randn((n, 3), generator=g, device=device) * mix["origin_std"]
    d = torch.randn((n, 3), generator=g, device=device)
    sun = torch.randn((n, 3), generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    sun = sun / sun.norm(dim=-1, keepdim=True)
    near = torch.full((n, 1), float(mix["near"]), device=device)
    far = torch.full((n, 1), float(mix["far"]), device=device)
    return torch.cat([o, d, near, far, sun], dim=-1)


def make_scene(mix, classes, seed, device):
    """A training scene of mix["scene_rays"] rows: rays, colours, image ids,
    stereo depth [depth, weight], its validity and std, semantic labels in
    [0, classes)."""
    g = generator(seed, SCENE, device)
    n = int(mix["scene_rays"])
    rays = make_rays(n, mix, g, device)
    u = torch.rand((n, 6), generator=g, device=device)
    sems = torch.randint(0, classes, (n,), generator=g,
                         device=device, dtype=torch.int32)
    return {
        "rays": rays,
        "rgbs": u[:, :3].contiguous(),
        "ids": torch.zeros(n, dtype=torch.int32, device=device),
        "depths": torch.stack([torch.full((n,), float(mix["target_depth"]),
                                          device=device), u[:, 3]], dim=-1),
        "valid_depth": (u[:, 4] < float(mix["valid_share"])).float(),
        "depth_std": torch.full((n,), float(mix["depth_std"]), device=device),
        "sems": sems,
    }


def view_rays(mix):
    """Rays a view holds: its pixels."""
    return int(mix["view_w"]) * int(mix["view_h"])


def make_views(mix, classes, seed, device):
    """mix["views"] views, each (rays (n, 11), labels (n,) int64 in
    [0, classes))."""
    g = generator(seed, VIEWS, device)
    n = view_rays(mix)
    return [(make_rays(n, mix, g, device),
             torch.randint(0, classes, (n,), generator=g, device=device))
            for _ in range(int(mix["views"]))]
