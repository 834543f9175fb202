"""Time B1's wide kernel against copies of it built here, in turns on the
card.

Usage (from the repository root, on a machine with a CUDA device):

    python -m spnerf_torch.utils.time_wide_variants
    python -m spnerf_torch.utils.time_wide_variants --widths 768 1024 --dtypes bfloat16
    python -m spnerf_torch.utils.time_wide_variants --parent DIR

"route" is `csrc/field_eval_wide.cu` as the route builds and loads it;
"local_a" is the same source built here as a library of its own with
WIDE_LOCAL_A=1: every A fragment comes from the CTA's own half of the
buffer, a wrong answer and only a floor for what reading the peer's half
through distributed shared memory costs. With `--parent DIR`, "parent"
takes local_a's place: `DIR/spnerf_torch/csrc/field_eval_wide.cu`
(another checkout, e.g. one unpacked with `git archive`) built the same
way; its entry's arguments are read from the library (a kernel of
two-CTA clusters only takes widths up to 1,024). Both
are launched through the same C entry from here, so neither adds to
`FusedField`'s counts. At each
width and dtype, the flagship family (random weights, seed 0) evaluates
all heads on `--points` points (the eval render's all-head launch)
through each, timed with CUDA events over `--reps` launches after a
warm-up, in turns (route, copy, copy, route). Prints each build's ptxas
register and spill lines and one JSON line: the times, each one's max abs
error from the plain version (large for local_a by design), and the
card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch


def _ptxas_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def build_variant(tag, defines=(), source=None):
    """`source` (default csrc/field_eval_wide.cu) built with `defines`
    ("NAME=VALUE" strings) as a library of its own under _build/, loaded;
    (library, ptxas lines). The file is removed once loaded."""
    from ..ops import _build

    _build.BUILD.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD / f"libfield_eval_wide-{tag}-{os.getpid()}.so"
    src = source or _build.CSRC / "field_eval_wide.cu"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
           *(f"-D{d}" for d in defines), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the {tag} copy:\n"
                           f"{proc.stdout}{proc.stderr}")
    try:
        lib = ctypes.CDLL(str(out))
    finally:
        out.unlink()
    return lib, _ptxas_lines(proc.stdout + proc.stderr)


def launch(lib, packed, x_in, sun, heads=None):
    """`heads` (all by default) of `packed` through `lib`'s wide entry on
    CUDA tensors, as `fused_field_wide` launches it, without counting the
    launch. A library without `spnerf_field_eval_wide_cluster` is of a
    checkout whose kernel runs clusters of two CTAs only and whose entry
    takes no cluster argument: it takes packs of two only."""
    from ..ops import field_eval as fe

    heads = fe.ALL_HEADS if heads is None else heads
    cfg = packed.cfg
    prog = fe._check_launch(packed, "wgmma_wide", x_in, sun, None, heads)
    n = x_in.shape[0]
    res = {nm: torch.empty((n, wd), dtype=torch.float32, device=x_in.device)
           for nm, wd in fe.active_outputs(cfg, heads)}
    xin, sn, _ = fe._float32_inputs(cfg, x_in, sun, None, False)
    two_cta_entry = not hasattr(lib, "spnerf_field_eval_wide_cluster")
    if two_cta_entry and packed.cluster != 2:
        raise ValueError("the two-CTA entry takes packs of two CTAs only")
    ints = (() if two_cta_entry else (packed.cluster,))
    fe._launch(lib, fe._declare(lib, "spnerf_field_eval_wide",
                                6 + len(ints)), (
        fe._ptr(xin), fe._ptr(sn), None, fe._ptr(packed.w_all),
        fe._ptr(packed.b_all), prog.ctypes.data, len(prog), cfg.fc_units,
        xin.shape[1], 0, n, int(packed.compute_dtype == torch.bfloat16),
        *ints, *(fe._ptr(res.get(k)) for k in fe.OUTPUTS)), x_in.device,
        "field_eval_wide")
    res["sigma"] = res["sigma"][:, 0]
    return res


def main(argv=None):
    from ..config import ModelConfig
    from ..device import card_info
    from ..models import load_model
    from ..ops import _build
    from ..ops import field_eval as fe

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--widths", type=int, nargs="+", default=[1024])
    p.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"],
                   choices=("bfloat16", "float32"))
    p.add_argument("--points", type=int, default=374_976)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--parent", default=None,
                   help="a checkout whose wide kernel is timed in place of "
                        "local_a")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rec = {"card": ", ".join(card_info(dev)), "points": args.points,
           "ptxas": {}, "runs": {}}
    rec["ptxas"]["route"] = _ptxas_lines(_build.build("field_eval_wide"))
    libs = {"route": _build.load("field_eval_wide")}
    if args.parent:
        libs["parent"], rec["ptxas"]["parent"] = build_variant(
            "parent", source=os.path.join(
                args.parent, "spnerf_torch", "csrc", "field_eval_wide.cu"))
    else:
        libs["local_a"], rec["ptxas"]["local_a"] = build_variant(
            "local_a", ["WIDE_LOCAL_A=1"])
    print(json.dumps({"ptxas": rec["ptxas"]}), flush=True)
    g = np.random.default_rng(0)
    n = args.points
    xyz = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32)
                           * 0.3).to(dev)
    sun = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(n, 3)).astype(np.float32)), dim=-1).to(dev)
    sems = torch.from_numpy(g.integers(0, 3, size=n)).to(dev)

    def ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    for dtype in args.dtypes:
        for width in args.widths:
            mc = ModelConfig(mapping=True, sem=True, num_sem_classes=3,
                             fc_units=width)
            model = load_model(mc, dtype, device=dev,
                               generator=torch.Generator().manual_seed(0))
            packed = fe.pack_params(model, dtype, kernel="wgmma_wide")
            x_in, sn, _ = fe.FusedField(packed, dtype).inputs(xyz, sun, None,
                                                              sems)
            ref = fe.fused_field_plain(packed, x_in, sn, None, fe.ALL_HEADS,
                                       dtype)
            r = rec["runs"][f"{dtype} {width}"] = {
                name: {"ms": []} for name in libs}
            for name, lib in libs.items():
                out = launch(lib, packed, x_in, sn)
                r[name]["max_abs_err"] = max(
                    (out[k] - ref[k]).abs().max().item() for k in ref)
                del out
            copy = next(k for k in libs if k != "route")
            for name in ["route", copy, copy, "route"]:
                lib = libs[name]
                r[name]["ms"].append(ms(lambda: launch(lib, packed, x_in,
                                                       sn)))
            print(json.dumps({f"{dtype} {width}": r}), flush=True)
            del model, packed, ref
            torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
