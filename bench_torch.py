#!/usr/bin/env python
"""Benchmark of the PyTorch port: flagship sp-nerf training throughput
(rays/s on one GPU), the program of `bench.py` on `spnerf_torch`.

Runs the full flagship training step (64 coarse samples, depth-guided
resampling -> 128-sample second pass, two solar-correction passes, semantic
head, depth + semantic losses, Adam update) at batch 1024 on a 65,536-ray
synthetic scene on the device (`spnerf_torch.utils.synth.bench_setup`):
one warm-up window of 100 steps, then 2 timed windows of 100 steps, each
ended by reading its loss on the host. A loss that is not finite raises.

    python3 bench_torch.py [--device cuda:N]

The device is the current card unless --device names another; without CUDA
this raises. `main` takes the sizes as keywords (a CPU test runs it small
with device="cpu"); the command line runs only the full program.

Prints ONE JSON line: {"metric", "value", "unit", "ms_per_step",
"window_ms", "loss", "peak_mem_gb", "device", "power_limit"}. The metric's
name differs from `bench.py`'s, so the two packages' numbers never read as
one series.
"""

import argparse
import json
import math
import time

import torch

METRIC = "flagship_train_rays_per_sec_per_gpu"
SEED = 1  # the windows' draws, as bench.py's PRNGKey(1)
N_GROUPS = 2  # timed windows, as bench.py's n_groups


def read_loss(ld, state):
    """The window's last loss on the host (the read waits for the window's
    work on the device); raises if it is not finite."""
    loss = ld["loss"].item()
    if not math.isfinite(loss):
        raise RuntimeError(f"bench: loss {loss} at step {state.step}")
    return loss


def main(argv=None, device=None, batch_size=1024, n_inner=100, n_rays=65536):
    """Run the bench and print its JSON line; returns the record. `device`
    overrides the command line's --device (argv, sys.argv[1:] when None)."""
    from spnerf_torch.device import card_info, resolve_device
    from spnerf_torch.utils.synth import bench_setup

    if device is None:
        p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
        p.add_argument("--device", default=None,
                       help="torch device (default: the current CUDA card)")
        device = p.parse_args(argv).device
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    _, state, data, run = bench_setup(batch_size, n_inner, n_rays,
                                      device=device)
    state, ld = run(state, data, SEED)
    read_loss(ld, state)  # warm-up
    window_ms = []
    t0 = time.perf_counter()
    for _ in range(N_GROUPS):
        tw = time.perf_counter()
        state, ld = run(state, data, SEED)
        loss = read_loss(ld, state)
        window_ms.append((time.perf_counter() - tw) * 1e3)
    dt = time.perf_counter() - t0
    n_steps = N_GROUPS * n_inner
    info = card_info(device) if cuda else None
    rec = {
        "metric": METRIC,
        "value": n_steps * batch_size / dt,
        "unit": "rays/s",
        "ms_per_step": dt * 1e3 / n_steps,
        "window_ms": window_ms,
        "loss": loss,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if cuda else None),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "power_limit": info[1] if info else None,
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
