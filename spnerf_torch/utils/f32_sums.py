"""The wide route's float32 sums: how far a deep K-sum on the tensor cores
drifts, emulated on the CPU and read from the kernel on the card.

Usage (from the repository root):

    python -m spnerf_torch.utils.f32_sums emulate
    python -m spnerf_torch.utils.f32_sums card [--parent DIR]

`emulate` (any machine, a few seconds): one layer's product of (n, K)
activations in [-1, 1] with a (K, N) weight of the Siren's hidden
initialisation, at each depth of `--depths`, summed as three TF32 products
(`tc_sum`) in the tensor cores' rounding model: each wgmma adds its 8-deep
k step's exact products to its accumulator and rounds the sum toward zero
to float32. Once with one accumulator through the whole K (the wide
kernel up to 1,024 wide, and field_eval_f32.cu), once with a fresh partial
sum every 16-deep slab added to the accumulator with one rounding to
nearest (the wide kernel past 1,024 wide), beside float32 sums rounded to
nearest (the CPU's matmul, as cuBLAS with TF32 off). Prints one JSON line:
each one's largest distance from the float64 product.

`card` (a CUDA device): the wide kernel's float32 launch of the flagship
family (all heads, random weights) against the plain version with TF32
off, the way `chip_smoke.py` holds it: the 1024-wide field packed for
clusters of 2, 4 and 8 CTAs (`pack_params(cluster=)`: each CTA owns
another share of every layer; the trunk's sums keep their K order, the
heads' partial sums are split by share, and past two CTAs the kernel sums
slab by slab), then 1536, 2048, 3072 and 4096 wide on their own clusters;
whether each 1024 launch equals the 2-CTA one bit for bit is recorded.
With `--parent DIR`, the wide kernel of that
checkout (e.g. one unpacked with `git archive`) is built and launched on
the same packs beside it (`utils/time_wide_variants.py`). Prints one JSON
line with the card's name and power limit.
"""

import argparse
import json
import math
import os

import numpy as np
import torch

SLAB = 16  # the float32 policy's K rows a stage, as the kernel's Policy
KSTEP = 8  # one TF32 wgmma's K


def toward_zero(x):
    """float64 `x` rounded toward zero to float32."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tc_sum(a, w, slab=None):
    """(n, K) @ (K, N) of float32 `a` and `w` as the wide kernel's float32
    policy computes it, in the rounding model above: both split into TF32
    hi and lo, per k step lo_a hi_w, hi_a lo_w, hi_a hi_w (three wgmmas),
    each added to its accumulator and rounded toward zero. `slab` None: one
    accumulator through the whole K; an int: a fresh partial sum every
    `slab` rows of K, added to the float32 accumulator rounded to nearest.
    K must be a multiple of KSTEP (and of `slab`)."""
    from ..ops.field_eval import tf32_rna

    n, k = a.shape
    a_hi, w_hi = tf32_rna(a), tf32_rna(w)
    a_lo, w_lo = tf32_rna(a - a_hi), tf32_rna(w - w_hi)
    steps = k // KSTEP

    def by_step(x, y):
        # (steps, n, N): each k step's exact products, summed in float64
        return torch.einsum("nsk,skm->snm", x.double().view(n, steps, KSTEP),
                            y.double().view(steps, KSTEP, -1))

    terms = [by_step(a_lo, w_hi), by_step(a_hi, w_lo), by_step(a_hi, w_hi)]
    acc = torch.zeros(n, w.shape[1])
    per = steps if slab is None else slab // KSTEP
    for s0 in range(0, steps, per):
        part = acc if slab is None else torch.zeros_like(acc)
        for s in range(s0, min(s0 + per, steps)):
            for t in terms:
                part = toward_zero(part.double() + t[s])
        acc = part if slab is None else (acc.double() + part.double()).float()
    return acc


def emulate(depths, n=64, width=64, seed=0):
    """{depth: {"one_accumulator", "per_slab", "float32_rn": largest
    distance from the float64 product, "magnitude": the product's largest
    entry}} on seeded random operands."""
    g = np.random.default_rng(seed)
    res = {}
    for k in depths:
        a = torch.from_numpy(g.uniform(-1, 1, (n, k)).astype(np.float32))
        bound = math.sqrt(6.0 / k)
        w = torch.from_numpy(g.uniform(-bound, bound,
                                       (k, width)).astype(np.float32))
        ref = a.double() @ w.double()

        def dist(x):
            return (x.double() - ref).abs().max().item()

        res[k] = {"one_accumulator": dist(tc_sum(a, w)),
                  "per_slab": dist(tc_sum(a, w, SLAB)),
                  "float32_rn": dist(a @ w),
                  "magnitude": ref.abs().max().item()}
    return res


def card(parent=None, n=65_536):
    """The record `card` prints (see the module docstring)."""
    from ..config import ModelConfig
    from ..device import card_info
    from ..models import load_model
    from ..ops import field_eval as fe
    from .hold_b1 import F32_ATOL, tf32
    from .time_wide_variants import build_variant, launch

    dev = torch.device("cuda", 0)
    g = np.random.default_rng(1)
    xyz = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32)
                           * 0.3).to(dev)
    sun = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(n, 3)).astype(np.float32)), dim=-1).to(dev)
    sems = torch.from_numpy(g.integers(0, 3, size=n)).to(dev)
    libs = {}
    if parent:
        libs["parent"], _ = build_variant("parent", source=os.path.join(
            parent, "spnerf_torch", "csrc", "field_eval_wide.cu"))
    rec = {"card": ", ".join(card_info(dev)), "points": n,
           "f32_atol": F32_ATOL, "runs": {}}
    cases = [(1024, c) for c in (2, 4, 8)] + [
        (w, None) for w in (1536, 2048, 3072, 4096)]
    first = {}
    for width, cluster in cases:
        mc = ModelConfig(mapping=True, sem=True, num_sem_classes=3,
                         fc_units=width)
        model = load_model(mc, "float32", device=dev,
                           generator=torch.Generator().manual_seed(width))
        pk = fe.pack_params(model, "float32", kernel="wgmma_wide",
                            cluster=cluster)
        field = fe.FusedField(pk, "float32")
        x_in, sn, _ = field.inputs(xyz, sun, None, sems)
        with tf32(False):
            ref = fe.fused_field_plain(pk, x_in, sn, None, fe.ALL_HEADS,
                                       "float32")
            outs = {"route": field(xyz, sun, None, sems)}
            for name, lib in libs.items():
                outs[name] = launch(lib, pk, x_in, sn)
        r = rec["runs"][f"{width} on {pk.cluster}"] = {}
        for name, out in outs.items():
            r[name] = {k: (out[k] - ref[k]).abs().max().item() for k in ref}
            r[name]["max"] = max(r[name].values())
            if width == 1024:
                if name not in first:
                    first[name] = out
                else:
                    r[name]["bits_equal_to_2_ctas"] = all(
                        torch.equal(out[k], first[name][k]) for k in ref)
        print(json.dumps({f"{width} on {pk.cluster}": r}), flush=True)
        del model, pk, field, ref, outs
        torch.cuda.empty_cache()
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("emulate")
    e.add_argument("--depths", type=int, nargs="+",
                   default=[512, 1024, 2048, 4096])
    e.add_argument("--points", type=int, default=64)
    c = sub.add_parser("card")
    c.add_argument("--parent", default=None)
    c.add_argument("--points", type=int, default=65_536)
    args = p.parse_args(argv)
    if args.cmd == "emulate":
        rec = {"emulate": emulate(args.depths, n=args.points)}
    else:
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA device")
        rec = {"card": card(args.parent, args.points)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
