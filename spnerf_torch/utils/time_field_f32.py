"""Time B1's two float32 kernels across field widths in turns on the card.

Usage (from the repository root, on a machine with a CUDA device):

    python -m spnerf_torch.utils.time_field_f32 --widths 128 256 384 512

At each width, the flagship family (10-frequency mapping, 3-class
semantic embedding, 8 layers with the skip at 4; random weights, seed 0)
evaluates all heads on `--points` points (the eval render's all-head
launch: 5,859 chunk x 64 samples) through the wgmma_f32 kernel
(`csrc/field_eval_f32.cu`) and the general kernel
(`csrc/field_eval_general.cu`, weights packed for it), each timed with
CUDA events over `--reps` launches after a warm-up, in the order wgmma_f32,
general, general, wgmma_f32. Prints one JSON line: per width the times,
the ring depth and the slabs (16-deep K steps of a layer) a tile runs on
the wgmma_f32 kernel, the TF32 rate (three products) and its share of 495
TFLOP/s, and the card's name and power limit. The share against the width
says whether a fixed cost per slab or the products hold the kernel.
"""

import argparse
import json

import numpy as np
import torch

PEAK_TF32 = 495e12  # H100 SXM dense TF32 FLOP/s


def main(argv=None):
    from ..config import ModelConfig
    from ..device import card_info
    from ..models import load_model
    from ..ops import field_eval as fe

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--widths", type=int, nargs="+",
                   default=[128, 256, 384, 512])
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

    rec = {"card": card, "points": n, "widths": {}}
    for width in args.widths:
        mc = ModelConfig(mapping=True, sem=True, num_sem_classes=3,
                         fc_units=width)
        model = load_model(mc, "float32", device=dev,
                           generator=torch.Generator().manual_seed(0))
        fields = {"wgmma_f32": fe.FusedField(fe.pack_params(
                      model, "float32"), "float32"),
                  "general": fe.FusedField(fe.pack_params(
                      model, "float32", kernel="general"), "float32")}
        runs = {k: [] for k in fields}
        for k in ("wgmma_f32", "general", "general", "wgmma_f32"):
            runs[k].append(ms(fields[k]))
        prog = fe.program(fields["wgmma_f32"].packed, fe.ALL_HEADS)
        slabs = int(sum((r[2] + r[3]) // fe.F32_KS for r in prog
                        if r[10] < 0))
        best = min(runs["wgmma_f32"])
        rate = 3 * fe.flops_per_point(mc) * n / best * 1e3
        rec["widths"][width] = {
            "ms": runs, "stages": fe.f32_stages(width), "slabs": slabs,
            "tf32_tflops": rate / 1e12, "share_of_tf32_peak": rate / PEAK_TF32}
        print(json.dumps({width: rec["widths"][width]}), flush=True)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
