"""Run one cell of BENCHMARK.json once on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints the result as one JSON line, the last
of standard output, and the numbers compared with their limits as the last
lines of standard error. Exits non-zero and prints no result when there is
no CUDA card, fewer cards than the cell asks for, or when the run has
loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, leads the import path
sys.path[0] = str(ROOT)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "spnerf_tpu"}


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"

    import torch

    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA device; the benchmark runs on the card "
                 "only")
    if torch.cuda.device_count() < cell.chips:
        sys.exit(f"benchmark: {cell.name} needs {cell.chips} cards, this "
                 f"machine has {torch.cuda.device_count()}")
    out = harness.run_cell(cell, args.seed, args.seconds, args.trace,
                           "cuda:0", t_start=T_START)
    found = forbidden_modules()
    if found:
        sys.exit(f"benchmark: the run loaded {', '.join(found)}")
    lines = out.pop("_lines")
    print(json.dumps(out), flush=True)
    print(f"card {out['card']}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()


if __name__ == "__main__":
    main()
