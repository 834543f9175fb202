"""Build the PyTorch port's CUDA kernels and drive its main path on one GPU.

Usage: python3 chip_smoke.py   (from the repository root, on a machine with
an NVIDIA H100 and the CUDA toolkit)

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the path from spnerf_torch/csrc with nvcc;
  3. hold the fused-field kernel against its plain PyTorch version at the
     flagship width (8x512 Siren, bf16) on a ragged 131,195-point batch, for
     all heads and for the solar pass's ("sun",);
  4. render a synthetic 256x256 view (65,536 rays) through the eval renderer
     at the flagship configuration with random weights from seed 0: outputs
     finite and in range, every chunk's three field passes launched the
     kernel, a 1,024-ray subset agrees with the same render through the plain
     field, and the view is timed (median of 3 after a warm-up). The same
     subset rendered through the plain field in float32 is printed beside it
     as a control: the size of a change of the rounding policy, which the
     render limits must sit below;
  5. at the main path's shapes (chunk x n_samples points for the coarse and
     guided passes, chunk x the merged samples per ray for the solar pass),
     hold each launch against its plain version, time both, and print the
     `kernels` line.

The last line of standard output is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

KERNEL_ATOL = 2e-2  # bf16: sum order may flip one bf16 ulp of an activation
# per-ray outputs, kernel vs plain field: 99th percentile and max. The sound
# render reads at most 3.1e-4 and 6.1e-4; the plain float32 render of the
# same rays differs from it by up to 1.8e-3 and 2.8e-3.
RENDER_P99 = 1e-3
RENDER_MAX = 2e-3
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
N_CHECK = 131_072 + 123
N_VIEW = 256 * 256


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def field_inputs(n, seed, device, num_sem_classes):
    g = np.random.default_rng(seed)
    xyz = g.normal(size=(n, 3)).astype(np.float32) * 0.3
    sun = g.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    sems = g.integers(-1, num_sem_classes, size=n)
    sems = np.where(sems < 0, -100, sems)
    return (torch.from_numpy(xyz).to(device), torch.from_numpy(sun).to(device),
            torch.from_numpy(sems).to(device))


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from spnerf_torch.models import load_model
        from spnerf_torch.ops import _build
        from spnerf_torch.ops import field_eval as fe
        from spnerf_torch.render import build_render_fn, chunk_size
        from spnerf_torch.utils.synth import fake_batch, flagship_configs
    except ImportError as e:
        fail(f"the spnerf_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    device = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build the path's kernel source
    t0 = time.time()
    text = _build.build("field_eval")
    log(f"build: {time.time() - t0:.1f} s")
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  field_eval: {line.strip()}")

    # 3. the kernel against its plain version at flagship width
    mc, rc = flagship_configs()
    model = load_model(mc, rc.compute_dtype, device=device,
                       generator=torch.Generator().manual_seed(0))
    packed = fe.pack_params(model)
    xyz, sun, sems = field_inputs(N_CHECK, 1, device, mc.num_sem_classes)
    kernel_err = 0.0
    for heads in (fe.ALL_HEADS, ("sun",)):
        field = fe.FusedField(packed)
        out = field(xyz, sun, None, sems, heads=heads)
        torch.cuda.synchronize()
        ref = fe.PlainField(packed)(xyz, sun, None, sems, heads=heads)
        if set(out) != set(ref):
            fail(f"kernel outputs {sorted(out)} != plain {sorted(ref)}")
        errs = {k: (out[k] - ref[k]).abs().max().item() for k in ref}
        log(f"kernel vs plain, heads={heads}, n={N_CHECK}: max abs err "
            + json.dumps({k: round(v, 6) for k, v in errs.items()}))
        for k, v in errs.items():
            if not (v <= KERNEL_ATOL) or not torch.isfinite(out[k]).all():
                fail(f"kernel {k}: max abs err {v} > {KERNEL_ATOL}")
        kernel_err = max(kernel_err, max(errs.values()))
        ms = cuda_ms(lambda: field(xyz, sun, None, sems, heads=heads), 5)
        log(f"  kernel at n={N_CHECK}: {ms:.3f} ms, "
            f"{fe.flops_per_point(mc, heads) * N_CHECK / ms / 1e9:.1f} TFLOP/s")
    del xyz, sun, sems, out, ref

    # 4. the main path: one synthetic view through the eval renderer
    batch = fake_batch(np.random.default_rng(0), N_VIEW)
    rays = torch.from_numpy(batch["rays"]).to(device)
    vsems = torch.from_numpy(batch["sems"]).to(device)
    render = build_render_fn(model, rc)
    chunk = chunk_size(rc)
    n_chunks = -(-N_VIEW // chunk)
    fe.FusedField.launches = 0
    view = render(rays, 0, vsems)
    torch.cuda.synchronize()
    launches = fe.FusedField.launches
    log(f"view: {N_VIEW} rays, chunk {chunk} rays, {n_chunks} chunks, "
        f"field kernel launches {launches}")
    if launches != 3 * n_chunks:
        fail(f"expected {3 * n_chunks} kernel launches, got {launches}")
    for k, v in view.items():
        if v.shape[0] != N_VIEW or not torch.isfinite(v).all():
            fail(f"{k}: shape {tuple(v.shape)} or non-finite values")
    rgb, depth = view["rgb_coarse"], view["depth_coarse"]
    if rgb.min() < 0 or rgb.max() > 1:
        fail("rgb_coarse outside [0, 1]")
    if depth.min() < rays[:, 6].min() - 1e-4 or depth.max() > rays[:, 7].max() + 1e-4:
        fail("depth_coarse outside [near, far]")
    sub = (rays[:1024], 0, vsems[:1024])
    plain = build_render_fn(model, rc, field="plain")(*sub)
    plain32 = build_render_fn(model, replace(rc, compute_dtype="float32"),
                              field="plain")(*sub)

    def p99_max(a, b):
        err = (a - b).abs().flatten().float()
        return torch.quantile(err, 0.99).item(), err.max().item()

    for k, v in plain.items():
        p99, mx = p99_max(view[k][:1024], v)
        c99, cmx = p99_max(view[k][:1024], plain32[k])
        log(f"  {k}: kernel vs plain render, p99 {p99:.3g}, max {mx:.3g}; "
            f"control (vs plain float32) p99 {c99:.3g}, max {cmx:.3g}")
        if not (p99 <= RENDER_P99 and mx <= RENDER_MAX):
            fail(f"{k}: kernel render disagrees with the plain render")

    times = []
    for _ in range(4):  # one warm-up, then 3 timed
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render(rays, 0, vsems)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    view_ms = float(np.median(times[1:]))
    log(json.dumps({"view_ms": view_ms, "rays_per_s": N_VIEW / view_ms * 1e3,
                    "view_ms_runs": times[1:], "card": card}))

    # 5. each launch of the path at its shapes: the coarse and guided passes
    #    (all heads) on chunk x n_samples points, the solar pass ("sun",) on
    #    the merged samples, chunk x n_samples x (2 if guided)
    merged = rc.n_samples * (2 if rc.guidedsample else 1)
    field, plain_field = fe.FusedField(packed), fe.PlainField(packed)
    rec = {}
    for tag, heads, n_pts in (("all", fe.ALL_HEADS, chunk * rc.n_samples),
                              ("sun", ("sun",), chunk * merged)):
        xyz, sun, sems = field_inputs(n_pts, 2, device, mc.num_sem_classes)
        out = field(xyz, sun, None, sems, heads=heads)
        ref = plain_field(xyz, sun, None, sems, heads=heads)
        errs = {k: (out[k] - ref[k]).abs().max().item() for k in ref}
        log(f"kernel vs plain, heads={tag}, n={n_pts}: max abs err "
            + json.dumps({k: round(v, 6) for k, v in errs.items()}))
        for k, v in errs.items():
            if not (v <= KERNEL_ATOL) or not torch.isfinite(out[k]).all():
                fail(f"kernel {k}: max abs err {v} > {KERNEL_ATOL}")
        kernel_err = max(kernel_err, max(errs.values()))
        del out, ref
        ms = cuda_ms(lambda: field(xyz, sun, None, sems, heads=heads), 10)
        plain_ms = cuda_ms(lambda: plain_field(xyz, sun, None, sems,
                                               heads=heads), 3)
        flops = fe.flops_per_point(mc, heads) * n_pts
        outs = sum(w for _, w in fe.active_outputs(mc, heads))
        nbytes = (n_pts * (packed.k0_pad + fe.KPAD) * 2 + n_pts * outs * 4
                  + packed.w_all.numel() * 2 + packed.b_all.numel() * 4)
        rec[tag] = dict(n=n_pts, ms=ms, plain_ms=plain_ms,
                        bound_ms=max(flops / PEAK_BF16, nbytes / PEAK_BYTES)
                        * 1e3,
                        bound_by=("operations" if flops / PEAK_BF16
                                  >= nbytes / PEAK_BYTES else "bytes"))
        log(f"field_eval heads={tag}: {n_pts} points, kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
            f"bound {rec[tag]['bound_ms']:.3f} ms")
        del xyz, sun, sems
    per_view = {"all": 2 * n_chunks, "sun": n_chunks}
    kernel_view_ms = sum(per_view[t] * rec[t]["ms"] for t in rec)
    bound_view_ms = sum(per_view[t] * rec[t]["bound_ms"] for t in rec)
    log(f"field kernel time per view (from the per-launch times): "
        f"{kernel_view_ms:.1f} ms of {view_ms:.1f} ms; "
        f"bound {bound_view_ms:.1f} ms")
    a = rec["all"]
    print(json.dumps({"kernels": [{
        "name": "field_eval",
        "route": "cuda",
        "source": "spnerf_torch/csrc/field_eval.cu",
        "replaces": "spnerf_tpu/ops/pallas/field_eval.py:104",
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": None,
        "points_per_launch": {t: rec[t]["n"] for t in rec},
        "heads": "all",
        "ms_sun": rec["sun"]["ms"],
        "plain_ms_sun": rec["sun"]["plain_ms"],
        "bound_ms_sun": rec["sun"]["bound_ms"],
        "launches_per_view": per_view,
        "ms_per_view": kernel_view_ms,
        "bound_ms_per_view": bound_view_ms,
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
