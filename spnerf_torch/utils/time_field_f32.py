"""Time B1's kernels across field widths in turns on the card.

Usage (from the repository root, on a machine with a CUDA device):

    python -m spnerf_torch.utils.time_field_f32 --widths 544 768 896 1024
    python -m spnerf_torch.utils.time_field_f32 --dtype bfloat16
    python -m spnerf_torch.utils.time_field_f32 --widths 128 256 384 512

At each width, the flagship family (10-frequency mapping, 3-class
semantic embedding, 8 layers with the skip at 4; random weights, seed 0)
evaluates all heads on `--points` points (the eval render's all-head
launch: 5,859 chunk x 64 samples) at `--dtype` through the kernel `route`
picks (wgmma_f32 up to 512 in float32, wgmma within its envelope in bf16,
else the two-CTA wgmma_wide kernel, `csrc/field_eval_wide.cu`) and through
the general kernel (`csrc/field_eval_general.cu`, weights packed for it),
each timed with CUDA events over `--reps` launches after a warm-up, in the
order route, general, general, route. Prints one JSON line: per width each
kernel's times, its rate, its share of its tensor-core bound (three TF32
products at 495 TFLOP/s in float32, bf16 at 989) and of the FFMA bound (67
TFLOP/s), the ring depth and the K slabs a tile runs on the tensor-core
route, and the card's name and power limit. The share against the width
says whether a fixed cost per slab or the products hold a kernel.
"""

import argparse
import json

import numpy as np
import torch

PEAK_TF32 = 495e12  # H100 SXM dense TF32 FLOP/s
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_F32 = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores


def main(argv=None):
    from ..config import ModelConfig
    from ..device import card_info
    from ..models import load_model
    from ..ops import field_eval as fe

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--widths", type=int, nargs="+",
                   default=[544, 768, 896, 1024])
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--points", type=int, default=374_976)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = ", ".join(card_info(dev))
    g = np.random.default_rng(0)
    n = args.points
    xyz = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32)
                           * 0.3).to(dev)
    sun = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(n, 3)).astype(np.float32)), dim=-1).to(dev)
    sems = torch.from_numpy(g.integers(0, 3, size=n)).to(dev)
    bf16 = args.dtype == "bfloat16"

    def ms(field):
        field(xyz, sun, None, sems)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            field(xyz, sun, None, sems)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    rec = {"card": card, "points": n, "dtype": args.dtype, "widths": {}}
    for width in args.widths:
        mc = ModelConfig(mapping=True, sem=True, num_sem_classes=3,
                         fc_units=width)
        model = load_model(mc, args.dtype, device=dev,
                           generator=torch.Generator().manual_seed(0))
        tensor = fe.route(mc, args.dtype)
        fields = {tensor: fe.FusedField(fe.pack_params(
                      model, args.dtype), args.dtype),
                  "general": fe.FusedField(fe.pack_params(
                      model, args.dtype, kernel="general"), args.dtype)}
        runs = {k: [] for k in fields}
        for k in (tensor, "general", "general", tensor):
            runs[k].append(ms(fields[k]))
        flops = fe.flops_per_point(mc) * n
        bound_tensor = (flops / PEAK_BF16 if bf16
                        else 3 * flops / PEAK_TF32) * 1e3
        bound_ffma = flops / PEAK_F32 * 1e3
        w = rec["widths"][width] = {"bound_ms_tensor": bound_tensor,
                                    "bound_ms_ffma": bound_ffma}
        for k, times in runs.items():
            best = min(times)
            w[k] = {"ms": times, "tflops": flops / best / 1e9,
                    "share_of_tensor_bound": bound_tensor / best,
                    "share_of_ffma_bound": bound_ffma / best}
        if tensor in ("wgmma_f32", "wgmma_wide"):
            ks = fe.wide_ks(args.dtype) if tensor == "wgmma_wide" else (
                fe.F32_KS)
            prog = fe.program(fields[tensor].packed, fe.ALL_HEADS)
            w[tensor]["slabs"] = int(sum((r[2] + r[3]) // ks for r in prog
                                         if r[10] < 0))
            w[tensor]["stages"] = (fe.wide_stages(width)
                                   if tensor == "wgmma_wide"
                                   else fe.f32_stages(width))
        print(json.dumps({width: w}), flush=True)
        del fields, model
        torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
