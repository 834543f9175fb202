"""Operation counts of the SP-NeRF field and the H100's published peaks.

A frozen copy of the port's `models.spnerf.layer_specs` and
`ops.field_eval.layers_run` / `flops_per_point` as they stood when the
benchmark was defined: the port's copy may change, this one does not. Every
count is taken from a configuration file's "model" and "render" sections
(plain dicts), whatever implements them.
"""

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet, 700 W)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
ALL_HEADS = ("rgb", "sun", "sky", "beta", "sem")
SUN_HEADS = ("sun",)  # the solar pass reads sigma and sun_v alone
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def in_width(model):
    """Width of the trunk input: mapped position plus semantic embedding."""
    k0 = 3 * 2 * model["mapping_sizes"][0] if model["mapping"] else 3
    if model["sem"]:
        k0 += model["num_sem_classes"] * model["s_embedding_factor"]
    return k0


def layer_specs(model):
    """(name, input segment widths, output width, init) of every dense
    layer, in the field's creation order."""
    w, h = model["fc_units"], model["fc_units"] // 2
    k0 = in_width(model)
    first = "first_sine" if model["siren"] else "torch"
    trunk = "sine" if model["siren"] else "torch"
    specs = [("trunk0", (k0,), w, first)]
    for i in range(1, model["fc_layers"]):
        specs.append((f"trunk{i}", (w, k0) if i in model["skips"] else (w,),
                      w, trunk))
    specs += [("sigma", (w,), 1, "torch"), ("feats", (w,), w, "torch"),
              ("rgb0", (w,), h, "torch"), ("rgb1", (h,), 3, "torch"),
              ("sun0", (w, 3), h, first), ("sun1", (h,), h, trunk),
              ("sun2", (h,), h, trunk), ("sun3", (h,), 1, trunk),
              ("sky0", (3,), h, "torch"), ("sky1", (h,), 3, "torch")]
    if model["beta"]:
        specs += [("beta0", (w, model["t_embedding_dims"]), h, "torch"),
                  ("beta1", (h,), 1, "torch")]
    if model["sem"]:
        specs += [("sem0", (w,), h, "torch"),
                  ("sem1", (h,), model["num_sem_classes"], "torch")]
    return specs


def layers_run(model, heads):
    """Names of the dense layers a field call with `heads` evaluates."""
    names = [f"trunk{k}" for k in range(model["fc_layers"])] + ["sigma"]
    if {"rgb", "sun", "beta"} & set(heads):
        names.append("feats")
    if "rgb" in heads:
        names += ["rgb0", "rgb1"]
    if "sun" in heads:
        names += ["sun0", "sun1", "sun2", "sun3"]
    if "sky" in heads:
        names += ["sky0", "sky1"]
    if model["beta"] and "beta" in heads:
        names += ["beta0", "beta1"]
    if model["sem"] and "sem" in heads:
        names += ["sem0", "sem1"]
    return names


def flops_per_point(model, heads=ALL_HEADS):
    """Matrix-product operations a point (2 per weight the call uses)."""
    widths = {n: (sum(segs), out) for n, segs, out, _ in layer_specs(model)}
    return sum(2 * widths[n][0] * widths[n][1]
               for n in layers_run(model, heads))


def weight_count(model, heads=ALL_HEADS):
    """Weights and biases of the layers a call with `heads` uses."""
    widths = {n: (sum(segs), out) for n, segs, out, _ in layer_specs(model)}
    return sum((widths[n][0] + 1) * widths[n][1]
               for n in layers_run(model, heads))


def outputs_per_point(model, heads):
    """Output values a point for a head subset (sigma always)."""
    n = 1 + 3 * ("rgb" in heads) + ("sun" in heads) + 3 * ("sky" in heads)
    n += bool(model["beta"] and "beta" in heads)
    if model["sem"] and "sem" in heads:
        n += model["num_sem_classes"]
    return n


def view_points_per_ray(render):
    """Field points a ray's view pass evaluates with every head: the
    stratified samples and, with guided sampling, as many again."""
    return render["n_samples"] * (2 if render["guidedsample"] else 1)


def solar_points_per_ray(render):
    """Field points a ray's solar pass evaluates with the sun head alone:
    the view pass's merged samples, along the sun direction."""
    return view_points_per_ray(render) if render["solar_correction"] else 0


def train_flops_per_ray(cfg):
    """Forward and backward products a trained ray needs: three times the
    forward's view pass (every head) and solar pass (the sun head)."""
    m, r = cfg["model"], cfg["render"]
    return 3 * (view_points_per_ray(r) * flops_per_point(m)
                + solar_points_per_ray(r) * flops_per_point(m, SUN_HEADS))


def render_flops_per_ray(cfg):
    """Products an eval-rendered ray needs for its outputs: the view pass
    with every head. The eval render's outputs drop the solar pass, so its
    products are not counted."""
    m, r = cfg["model"], cfg["render"]
    return view_points_per_ray(r) * flops_per_point(m)


def field_call_work(model, points, heads, compute_dtype):
    """(operations, bytes) of one field call over `points` points with
    `heads`: its products, and its raw inputs (position, sun direction,
    label), outputs (float32) and weights (compute dtype) each moved once."""
    flops = points * flops_per_point(model, heads)
    per_point = 3 * 4 + 3 * 4 + 8 + 4 * outputs_per_point(model, heads)
    nbytes = (points * per_point
              + weight_count(model, heads) * DTYPE_BYTES[compute_dtype])
    return flops, nbytes
