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
     hold each launch against its plain version and time both;
  6. the table-gradient kernels B2 (dtab_dense) and B3 (dtab_sorted) on the
     inputs of the hash train step: one backward of the hash configuration
     (L8 F4 T=2^19, batch 1024, 64 + 64 + 128 samples) through the plain
     version records the 24 (ids, cotangent) pairs the step hands the table
     gradient; each is sent to the kernel the router picks and held against
     the plain version, plus a skewed case (half the rows on 64 ids) for
     both kernels; B3 must give the same bits twice. Every call is timed
     (CUDA events, host launches included) beside the plain version, the
     library call `index_add_` and its bytes bound, and the kernels' own
     device time is read from torch.profiler;
  7. the hash train step at full width on a 65,536-ray synthetic scene
     (seed 0): the same step's table gradient and loss through the kernels
     and through the plain version agree; one step through the trainer
     launches B2 3 times and B3 21 times; then 1 warm-up and 10 timed
     steps;
  8. the flagship Siren train step (8x512, bf16, batch 1024; no kernel):
     1 warm-up and 3 timed steps;
  and print the `kernels` line.

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
# table gradient, kernel vs plain on the same inputs: max abs error over the
# largest entry (the step's cotangents are small, so the limit is relative),
# float32 sums of up to thousands of rows in another order
DTAB_RTOL = 1e-5
# the hash step through the kernels vs through the plain version: the
# cotangents reaching the table differ in their last bits too (the
# renderer's gathers have atomic backwards), so the table gradient is held
# to 1e-4 of its largest entry and the loss, a forward quantity, to 1e-6
STEP_GRAD_RTOL = 1e-4
STEP_LOSS_RTOL = 1e-6
BATCH = 1024
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
        from spnerf_torch.models import hashgrid as hg
        from spnerf_torch.ops import dtab as dt
        from spnerf_torch.utils.synth import (fake_batch, flagship_configs,
                                              train_setup)
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

    # 2. build the path's kernel sources, one nvcc each, in parallel
    t0 = time.time()
    texts = _build.build_all(["field_eval", "dtab"])
    log(f"build: {time.time() - t0:.1f} s")
    for name, text in texts.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

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
    field_entry = {
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
    }
    del render, view, plain, plain32, model, packed, field, plain_field
    torch.cuda.empty_cache()

    # 6. the table-gradient kernels on the hash train step's own inputs
    htr, hdata = train_setup("hash", device=device)
    hstate = htr.init_state(torch.Generator().manual_seed(0))
    enc = hstate.model.encoding
    n_feat = htr.mc.hash_features

    def step_grads(impl):
        """Loss and table gradient of step 0's batch and draws, with the
        table gradient through `impl` (None: the kernels)."""
        enc.dtab_impl = impl
        hstate.optimizer.zero_grad(set_to_none=True)
        g = htr.step_generator(0, seed=1)
        batch = htr.sample_batch(hdata, BATCH, g)
        loss, _ = htr.loss_fn(hstate, batch, 0, generator=g)
        loss.backward()
        enc.dtab_impl = None
        torch.cuda.synchronize()
        return loss.detach(), enc.table.grad.clone()

    calls = []  # (ids, ct_fm, t_eff) of every table gradient of the step
    real_dtab = hg.dtab

    def recording_dtab(ids, ct_fm, t_eff, F, impl=None):
        calls.append((ids, ct_fm.contiguous(), t_eff))
        return real_dtab(ids, ct_fm, t_eff, F, impl=impl)

    hg.dtab = recording_dtab
    try:
        loss_plain, grad_plain = step_grads("plain")
    finally:
        hg.dtab = real_dtab
    if len(calls) != 3 * htr.mc.hash_levels:
        fail(f"expected {3 * htr.mc.hash_levels} table gradients per step, "
             f"recorded {len(calls)}")

    def bound_ms(M, t_eff):
        return (M * (4 + 4 * n_feat) + n_feat * t_eff * 4) / PEAK_BYTES * 1e3

    kernels = {"dense": dt.dtab_dense, "sorted": dt.dtab_sorted}

    def check(name, ids, ct, t_eff, tag):
        """Kernel vs plain on one call; returns the max abs error and that
        error over the largest entry."""
        out = kernels[name](ids, ct, t_eff)
        ref = dt.dtab_plain(ids, ct, t_eff)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not (err <= DTAB_RTOL * scale) or not torch.isfinite(out).all():
            fail(f"dtab_{name} {tag}: max abs err {err} against max "
                 f"|dtab| {scale}")
        if name == "sorted":
            again = kernels[name](ids, ct, t_eff)
            if not torch.equal(out, again):
                fail(f"dtab_sorted {tag}: two calls differ")
        return err, (err / scale if scale else 0.0)

    per = {"dense": [], "sorted": []}
    for ids, ct, t_eff in calls:
        M = ids.shape[0]
        name = dt.route(t_eff, n_feat, M)
        tag = f"t_eff={t_eff} M={M}"
        err, rel = check(name, ids, ct, t_eff, tag)
        ids_long = ids.long()
        lib_out = torch.zeros((n_feat, t_eff), device=device)
        rec_c = dict(t_eff=t_eff, M=M, err=err, rel=rel,
                     ms=cuda_ms(lambda: kernels[name](ids, ct, t_eff), 5),
                     plain_ms=cuda_ms(lambda: dt.dtab_plain(ids, ct, t_eff),
                                      3),
                     library_ms=cuda_ms(
                         lambda: lib_out.index_add_(1, ids_long, ct), 3),
                     bound_ms=bound_ms(M, t_eff))
        if name == "sorted":
            ids_s, perm = dt.sort_ids(ids)
            rec_c["kernel_only_ms"] = cuda_ms(
                lambda: dt.dtab_sorted_kernel(ids_s, perm, ct, t_eff), 5)
        per[name].append(rec_c)
        log(f"dtab_{name} {tag}: max abs err {err:.3g} ({rel:.3g} of the "
            f"largest entry), kernel "
            f"{rec_c['ms']:.3f} ms"
            + (f" ({rec_c['kernel_only_ms']:.3f} ms without its sort)"
               if name == "sorted" else "")
            + f", plain {rec_c['plain_ms']:.3f} ms, index_add_ "
            f"{rec_c['library_ms']:.3f} ms, bound {rec_c['bound_ms']:.4f} ms")
    # the same calls under the profiler: device time of the kernels alone and
    # of B3's sort (the event times above include the host's launches)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ids, ct, t_eff in calls:
            kernels[dt.route(t_eff, n_feat, ids.shape[0])](ids, ct, t_eff)
        torch.cuda.synchronize()
    dev_us = {"dense": 0.0, "sorted": 0.0, "sort": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        d = e.time_range.end - e.time_range.start
        if "dtab_dense" in e.name:
            dev_us["dense"] += d
        elif "seg_sum" in e.name:
            dev_us["sorted"] += d
        elif "adix" in e.name or "Sort" in e.name:
            dev_us["sort"] += d
    device_ms = {k: (dev_us[k] / 1e3 / len(per["sorted" if k == "sort"
                                                 else k])
                     if any(dev_us.values()) else None) for k in dev_us}
    log(f"device time per launch (profiler): {json.dumps(device_ms)}")
    # skewed ids: half the rows of a hashed level's view-pass call on 64 ids
    ids, ct, t_eff = next(c for c in calls if c[2] == enc.table_size
                          and c[0].shape[0] == BATCH * 64 * 8)
    skew = ids.clone()
    half = skew.shape[0] // 2
    skew[:half] = torch.randint(0, 64, (half,), device=device,
                                generator=torch.Generator(device).manual_seed(3))
    skew_err = {name: check(name, skew, ct, t_eff, "skewed")
                for name in kernels}
    log(f"skewed (half the rows on 64 ids), t_eff={t_eff} M={ids.shape[0]}: "
        f"(max abs err, over the largest entry) {json.dumps(skew_err)}")
    del calls
    torch.cuda.empty_cache()

    # 7. the hash train step: kernels vs plain, launches, time
    loss_k, grad_k = step_grads(None)
    gerr = ((grad_k - grad_plain).abs().max()
            / grad_plain.abs().max()).item()
    lerr = (abs(loss_k - loss_plain) / abs(loss_plain)).item()
    log(f"hash step, kernels vs plain: table gradient max abs err / max "
        f"{gerr:.3g}, loss rel err {lerr:.3g} (loss {loss_k.item():.6f})")
    if not (gerr <= STEP_GRAD_RTOL and lerr <= STEP_LOSS_RTOL):
        fail("the hash step through the kernels disagrees with the plain "
             "version")
    del grad_k, grad_plain
    for k in dt.launches:
        dt.launches[k] = 0
    ld = htr.train_step(hstate, hdata, BATCH, seed=1)
    torch.cuda.synchronize()
    step_launches = dict(dt.launches)
    log(f"hash train step launches: {json.dumps(step_launches)}")
    if step_launches != {"dtab_dense": 3, "dtab_sorted": 21}:
        fail("expected 3 dtab_dense and 21 dtab_sorted launches per step")

    def time_steps(tr, state, data, n):
        tr.train_step(state, data, BATCH, seed=1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            ld = tr.train_step(state, data, BATCH, seed=1)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / n
        loss = ld["loss"].item()
        if not np.isfinite(loss):
            fail(f"train step loss {loss}")
        return {"ms_per_step": ms, "rays_per_s": BATCH / ms * 1e3,
                "loss": loss, "steps": n,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "card": card}

    hash_rec = time_steps(htr, hstate, hdata, 10)
    log("hash train step: " + json.dumps(hash_rec))
    del htr, hdata, hstate, enc
    torch.cuda.empty_cache()

    # 8. the flagship Siren train step
    s_tr, s_data = train_setup("siren", device=device)
    s_state = s_tr.init_state(torch.Generator().manual_seed(0))
    siren_rec = time_steps(s_tr, s_state, s_data, 3)
    log("siren train step: " + json.dumps(siren_rec))

    def entry(name, source_line):
        recs = per[name]
        n = len(recs)
        tot = {k: sum(r[k] for r in recs)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        e = {
            "name": f"dtab_{name}",
            "route": "cuda",
            "source": "spnerf_torch/csrc/dtab.cu",
            "replaces": source_line,
            "launches": step_launches[f"dtab_{name}"],
            "max_abs_err": max([r["err"] for r in recs]
                               + [skew_err[name][0]]),
            "max_rel_err": max([r["rel"] for r in recs]
                               + [skew_err[name][1]]),
            "ms": tot["ms"] / n,
            "plain_ms": tot["plain_ms"] / n,
            "bound_ms": tot["bound_ms"] / n,
            "bound_by": "bytes",
            "library_ms": tot["library_ms"] / n,
            "per_launch": "mean over the step's launches at their own ids",
            "ms_per_step": tot["ms"],
            "plain_ms_per_step": tot["plain_ms"],
            "library_ms_per_step": tot["library_ms"],
            "bound_ms_per_step": tot["bound_ms"],
            "calls": [{k: r[k] for k in ("t_eff", "M", "ms", "plain_ms",
                                         "library_ms", "bound_ms")}
                      for r in recs],
            "card": card,
        }
        e["device_ms"] = device_ms[name]
        if name == "sorted":
            e["kernel_only_ms"] = sum(r["kernel_only_ms"] for r in recs) / n
            e["sort_device_ms"] = device_ms["sort"]
        return e

    print(json.dumps({
        "kernels": [field_entry,
                    entry("dense", "spnerf_tpu/ops/pallas/dtab.py:127"),
                    entry("sorted", "spnerf_tpu/ops/pallas/dtab.py:307")],
        "train_steps": {"hash": hash_rec, "siren": siren_rec}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
