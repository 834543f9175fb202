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
     hold each launch against its plain version and time both (CUDA events,
     and the kernel's device time from torch.profiler);
  6. the table-gradient kernels B2 (dtab_dense) and B3 (dtab_sorted) on the
     inputs of the hash train step: one backward of the hash configuration
     (L8 F4 T=2^19, batch 1024, 64 + 64 + 128 samples) through the plain
     version records the 24 (ids, cotangent) pairs the step hands the table
     gradient; each is sent to the kernel the router picks and held against
     the plain version, plus a skewed case (half the rows on 64 ids) for
     both kernels and the edge cases (`spnerf_torch/utils/dtab_cases.py`:
     every row on one id, ids outside [0, t_eff) at both ends, int64 ones
     at -2^40 included, M = 1 and 0, M not a multiple of the partition
     tile, t_eff not a multiple of a slice, F = 1, 3 and 8, more table
     windows than slices with split slices; int64 and int32 ids) for B3 in
     both layouts and B2 in the flat table's feature-major one; B3 must give
     the same bits twice. Every call is timed (CUDA events, host launches
     included) beside the plain version, the library call `index_add_` into
     a zeroed table and with its zero fill, and its bytes bound, and the
     kernels' own device time and device launches per call are read from
     torch.profiler (B2's zero-fill memset, in its C call, included);
  7. the hash train step at full width on a 65,536-ray synthetic scene
     (seed 0): the same step's table gradient and loss through the kernels
     and through the plain version agree; one step through the trainer
     launches B2 3 times and B3 21 times; then 1 warm-up and 10 timed
     steps;
  8. the flagship Siren train step (8x512, bf16, batch 1024; no kernel):
     1 warm-up and 3 timed steps;
  9. the hash step with the (L, T, F) table (hash_flat_table=False): its
     24 t-major table gradients recorded and held on B2 and B3 (t-major
     layout) against the plain version and timed, B2 also on the edge cases
     in the t-major layout; the step's loss and table
     gradient through the kernels agree with the plain run; one step
     launches B2 3 times and B3 21 times; then 1 warm-up and 10 timed steps;
 10. SPNERF_HASH_SW_ACC=0 on the flat step: B3′ (dtab_sorted_partials) held
     against the plain version on the step's own 21 window-route inputs,
     the skewed case and the edge cases of phase 6, timed beside the plain
     version, `index_add_` and its bound, with profiler device times (its
     zero fill, a memset in the same C call, included);
     the step through the kernels agrees with the plain step; one step
     launches B2 3 times and B3′ 21 times; then timed;
 11. SPNERF_HASH_SW_BATCHED=1 on the (L, T, F) step: B4 (dtab_batched) held
     against dtab_batched_plain on the step's 3 recorded batched inputs, a
     skewed level and a level of direct-coarse ids, and the batched edge
     cases of `dtab_cases.py` (L = 1, M = 0 and 1, M not a multiple of 32,
     ids at -2^40, -1, T and T + 2^32 in one level, a level of one id,
     F = 1, 3 and 8; int64 and int32 ids), two calls within DTAB_RTOL of
     each other (float atomics); timed as in 10 (`index_add_` on the
     flattened table, with and without its zero fill), with profiler device
     times, the memset included; the step through the kernels agrees with
     the plain step; one step launches B4 3 times and no B2, B3 or B3′; then
     timed;
  and print the `kernels` line. The env of phases 10 and 11 is set around
  its phase only and restored after.

The last line of standard output is {"ok": true, "device": {...}}.
"""

import contextlib
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


def rel_check(out, ref, tag):
    """Max abs error of out against ref, and that error over ref's largest
    entry; fails above DTAB_RTOL of it or on a non-finite value."""
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not (err <= DTAB_RTOL * scale) or not torch.isfinite(out).all():
        fail(f"{tag}: max abs err {err} against max |dtab| {scale}")
    return err, (err / scale if scale else 0.0)


# names of the port's table-gradient kernels (the zero fill of B2, B3′ and
# B4, a memset in their C call, counts as their own)
PORT_KERNEL_KEYS = ("dtab_scatter", "slice_", "tile_agg")
MEMSET_KEYS = ("Memset",)


def device_ms(run, n_calls, keys=PORT_KERNEL_KEYS, attempts=3):
    """Device time and device launches per call of `run` (which makes
    n_calls calls) under torch.profiler: {"kernel": ms of the kernels whose
    names hold one of `keys`, "launches": those kernels' launches, "names":
    launches per call by kernel name}. Each pass opens with a fill of its own,
    synchronised, because the first device activity of a pass now and then
    goes unrecorded. A profiling pass that records no device activity (seen
    now and then after several passes in one process) is run again, up to
    `attempts` times; then every value is None ("not measured")."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        us, n, names = 0.0, 0, {}
        seen = False
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            seen = True
            if any(k in e.name for k in keys):
                us += e.time_range.end - e.time_range.start
                n += 1
                name = e.name.split("(")[0].removeprefix("void ")
                names[name] = names.get(name, 0) + 1 / n_calls
        if seen:
            return {"kernel": us / 1e3 / n_calls, "launches": n / n_calls,
                    "names": names}
    return dict.fromkeys(("kernel", "launches", "names"))


@contextlib.contextmanager
def env_set(name, value):
    """os.environ[name] = value inside the block, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


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
        from spnerf_torch.utils.dtab_cases import (BATCHED_CASES, EDGE_CASES,
                                                   batched_edge_case,
                                                   dtab_plain_kept, edge_case)
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
        dev = device_ms(lambda: field(xyz, sun, None, sems, heads=heads), 1,
                        keys=("field_eval",))["kernel"]
        rec[tag] = dict(n=n_pts, ms=ms, plain_ms=plain_ms, device_ms=dev,
                        bound_ms=max(flops / PEAK_BF16, nbytes / PEAK_BYTES)
                        * 1e3,
                        bound_by=("operations" if flops / PEAK_BF16
                                  >= nbytes / PEAK_BYTES else "bytes"))
        log(f"field_eval heads={tag}: {n_pts} points, kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), device {dev} ms, plain "
            f"{plain_ms:.3f} ms, bound {rec[tag]['bound_ms']:.3f} ms")
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
        "device_ms": a["device_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": None,
        "points_per_launch": {t: rec[t]["n"] for t in rec},
        "heads": "all",
        "ms_sun": rec["sun"]["ms"],
        "device_ms_sun": rec["sun"]["device_ms"],
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
    n_feat = htr.mc.hash_features
    n_levels = htr.mc.hash_levels
    T = hstate.model.encoding.table_size

    def step_grads(tr, state, data, impl):
        """Loss and table gradient of step 0's batch and draws, with the
        table gradient through `impl` (None: the kernels)."""
        enc = state.model.encoding
        enc.dtab_impl = impl
        state.optimizer.zero_grad(set_to_none=True)
        g = tr.step_generator(0, seed=1)
        batch = tr.sample_batch(data, BATCH, g)
        loss, _ = tr.loss_fn(state, batch, 0, generator=g)
        loss.backward()
        enc.dtab_impl = None
        torch.cuda.synchronize()
        return loss.detach(), enc.table.grad.clone()

    def record_plain(tr, state, data, batched=False):
        """step_grads through the plain version, with the table-gradient
        router wrapped: (the inputs of every call, loss, table gradient).
        Per-level calls record (ids, ct, t_eff, fmajor), batched calls
        (ids, ct, T)."""
        calls = []
        name = "dtab_levels" if batched else "dtab"
        real = getattr(hg, name)

        def recording_levels(ids, ct, T_, impl=None):
            calls.append((ids, ct.contiguous(), T_))
            return real(ids, ct, T_, impl=impl)

        def recording(ids, ct, t_eff, F, impl=None, fmajor=True, sw_acc=None):
            calls.append((ids, ct.contiguous(), t_eff, fmajor))
            return real(ids, ct, t_eff, F, impl=impl, fmajor=fmajor,
                        sw_acc=sw_acc)

        setattr(hg, name, recording_levels if batched else recording)
        try:
            loss, grad = step_grads(tr, state, data, "plain")
        finally:
            setattr(hg, name, real)
        return calls, loss, grad

    def bound_ms(M, t_eff, F=None, id_bytes=8):
        """Each input read once (the ids at their own width, int64 from the
        step) and the table written once, at the card's memory rate."""
        F = n_feat if F is None else F
        return (M * (id_bytes + 4 * F) + F * t_eff * 4) / PEAK_BYTES * 1e3

    kernels = {"dense": dt.dtab_dense, "sorted": dt.dtab_sorted,
               "partials": dt.dtab_sorted_partials}

    def hold(name, ids, ct, t_eff, fmajor, tag, timed=True):
        """Kernel `name` against the plain version on one call (B3 also
        against itself), then timed beside the plain version, `index_add_`
        into a zeroed table, `index_add_` with its zero fill (the function
        the wrapper computes) and the bytes bound. Ids outside [0, t_eff)
        go to an extra row of the plain version's table, which is cut."""
        fn = kernels[name]
        out = fn(ids, ct, t_eff, fmajor)
        ref = dtab_plain_kept(ids, ct, t_eff, fmajor)
        err, rel = rel_check(out, ref, f"dtab_{name} {tag}")
        if name == "sorted" and not torch.equal(out, fn(ids, ct, t_eff,
                                                        fmajor)):
            fail(f"dtab_sorted {tag}: two calls differ")
        M = ids.shape[0]
        rec = dict(t_eff=t_eff, M=M, err=err, rel=rel)
        if not timed:
            return rec
        ids_long = ids.long()
        dim = 1 if fmajor else 0
        lib_out = torch.zeros_like(ref)
        rec.update(
            ms=cuda_ms(lambda: fn(ids, ct, t_eff, fmajor), 5),
            plain_ms=cuda_ms(lambda: dt.dtab_plain(ids, ct, t_eff, fmajor), 3),
            library_ms=cuda_ms(lambda: lib_out.index_add_(dim, ids_long, ct),
                               3),
            library_zero_ms=cuda_ms(lambda: torch.zeros_like(ref).index_add_(
                dim, ids_long, ct), 3),
            bound_ms=bound_ms(M, t_eff, id_bytes=ids.element_size()))
        log(f"dtab_{name} {tag}: max abs err {err:.3g} ({rel:.3g} of the "
            f"largest entry), kernel {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, index_add_ {rec['library_ms']:.3f} ms"
            f" ({rec['library_zero_ms']:.3f} ms with its zero fill), bound "
            f"{rec['bound_ms']:.4f} ms")
        return rec

    def hold_edges(name, layouts=(True, False)):
        """Kernel `name` on every edge case of `utils/dtab_cases.py` in the
        layouts given (fmajor flags), int64 and int32 ids; {kind: max
        relative error}."""
        rels = {}
        for kind in EDGE_CASES:
            for fmajor in layouts:
                for ids64 in (True, False):
                    ids, ct, t_eff = edge_case(kind, device, fmajor, ids64)
                    r = hold(name, ids, ct, t_eff, fmajor, f"edge {kind}",
                             timed=False)
                    rels[kind] = max(rels.get(kind, 0.0), r["rel"])
        log(f"dtab_{name} edge cases, fmajor {layouts}, int64 and int32 ids, "
            f"max err / largest entry: {json.dumps(rels)}")
        return rels

    def hold_calls(calls, sw_acc, names):
        """Every recorded per-level call on the kernel its route names, held
        and timed; {route: [records]} and the profiler's device times."""
        per = {n: [] for n in names}
        by = {n: [] for n in names}
        for ids, ct, t_eff, fmajor in calls:
            name = dt.route(t_eff, n_feat, ids.shape[0], sw_acc)
            if name not in per:
                continue
            layout = "f-major" if fmajor else "t-major"
            per[name].append(hold(name, ids, ct, t_eff, fmajor,
                                  f"{layout} t_eff={t_eff} M={ids.shape[0]}"))
            by[name].append((ids, ct, t_eff, fmajor))
        dev = {n: device_ms(lambda: [kernels[n](*c) for c in by[n]],
                            len(by[n]), keys=PORT_KERNEL_KEYS
                            + (MEMSET_KEYS if n != "sorted" else ()))
               for n in names}
        log(f"device time per launch (profiler): {json.dumps(dev)}")
        return per, dev

    def step_match(tag, tr, state, data, loss_plain, grad_plain):
        loss_k, grad_k = step_grads(tr, state, data, None)
        gerr = ((grad_k - grad_plain).abs().max()
                / grad_plain.abs().max()).item()
        lerr = (abs(loss_k - loss_plain) / abs(loss_plain)).item()
        log(f"{tag}, kernels vs plain: table gradient max abs err / max "
            f"{gerr:.3g}, loss rel err {lerr:.3g} (loss {loss_k.item():.6f})")
        if not (gerr <= STEP_GRAD_RTOL and lerr <= STEP_LOSS_RTOL):
            fail(f"{tag} through the kernels disagrees with the plain version")
        return {"grad_rel_err": gerr, "loss_rel_err": lerr}

    def step_launches(tag, tr, state, data, expect):
        """The kernel launches of one train step (counts set to 0 just
        before it and read just after)."""
        for k in dt.launches:
            dt.launches[k] = 0
        tr.train_step(state, data, BATCH, seed=1)
        torch.cuda.synchronize()
        got = dict(dt.launches)
        log(f"{tag} launches: {json.dumps(got)}")
        want = dict.fromkeys(dt.launches, 0)
        want.update(expect)
        if got != want:
            fail(f"{tag}: expected launches {want}, got {got}")
        return got

    def time_steps(tr, state, data, n, blocks=3):
        """1 warm-up, then `blocks` runs of n steps, each timed with CUDA
        events: ms/step is the median run's, and every run is kept (the
        host-bound steps vary)."""
        tr.train_step(state, data, BATCH, seed=1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(blocks):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                ld = tr.train_step(state, data, BATCH, seed=1)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / n)
            loss = ld["loss"].item()
            if not np.isfinite(loss):
                fail(f"train step loss {loss}")
        ms = float(np.median(runs))
        return {"ms_per_step": ms, "rays_per_s": BATCH / ms * 1e3,
                "ms_per_step_runs": runs, "loss": loss, "steps": n * blocks,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "card": card}

    calls, loss_plain, grad_plain = record_plain(htr, hstate, hdata)
    if len(calls) != 3 * n_levels:
        fail(f"expected {3 * n_levels} table gradients per step, "
             f"recorded {len(calls)}")
    per, dev6 = hold_calls(calls, True, ("dense", "sorted"))
    # skewed ids: half the rows of a hashed level's view-pass call on 64 ids
    ids, ct6, t_eff6, _ = next(c for c in calls if c[2] == T
                               and c[0].shape[0] == BATCH * 64 * 8)
    skew = ids.clone()
    half = skew.shape[0] // 2
    skew[:half] = torch.randint(0, 64, (half,), device=device,
                                generator=torch.Generator(device).manual_seed(3))
    skew_err = {name: hold(name, skew, ct6, t_eff6, True, "skewed",
                           timed=False) for name in ("dense", "sorted")}
    log(f"skewed (half the rows on 64 ids), t_eff={t_eff6} "
        f"M={skew.shape[0]}: " + json.dumps(skew_err))
    edge6 = hold_edges("sorted")
    edge6_dense = hold_edges("dense", (True,))
    del calls, ids
    torch.cuda.empty_cache()

    # 7. the hash train step: kernels vs plain, launches, time
    step_match("hash step", htr, hstate, hdata, loss_plain, grad_plain)
    del grad_plain
    launches7 = step_launches("hash train step", htr, hstate, hdata,
                              {"dtab_dense": 3, "dtab_sorted": 21})
    hash_rec = time_steps(htr, hstate, hdata, 10)
    log("hash train step: " + json.dumps(hash_rec))
    del htr, hdata, hstate
    torch.cuda.empty_cache()

    # 8. the flagship Siren train step
    s_tr, s_data = train_setup("siren", device=device)
    s_state = s_tr.init_state(torch.Generator().manual_seed(0))
    siren_rec = time_steps(s_tr, s_state, s_data, 3)
    log("siren train step: " + json.dumps(siren_rec))
    del s_tr, s_data, s_state
    torch.cuda.empty_cache()

    # 9. the (L, T, F) table: t-major B2 and B3, the step
    ttr, tdata = train_setup("hash", device=device, flat_table=False)
    tstate = ttr.init_state(torch.Generator().manual_seed(0))
    shape = tuple(tstate.model.encoding.table.shape)
    if shape != (n_levels, T, n_feat):
        fail(f"(L, T, F) table has shape {shape}")
    calls, loss_plain, grad_plain = record_plain(ttr, tstate, tdata)
    if len(calls) != 3 * n_levels or any(c[3] for c in calls):
        fail(f"expected {3 * n_levels} t-major table gradients per step")
    per9, dev9 = hold_calls(calls, True, ("dense", "sorted"))
    edge9_dense = hold_edges("dense", (False,))
    del calls
    match9 = step_match("(L, T, F) hash step", ttr, tstate, tdata, loss_plain,
                        grad_plain)
    del grad_plain
    launches9 = step_launches("(L, T, F) hash train step", ttr, tstate, tdata,
                              {"dtab_dense": 3, "dtab_sorted": 21})
    tlf_rec = time_steps(ttr, tstate, tdata, 10)
    tlf_rec.update(match9)
    log("(L, T, F) hash train step: " + json.dumps(tlf_rec))
    del ttr, tdata, tstate
    torch.cuda.empty_cache()

    # 10. SPNERF_HASH_SW_ACC=0 on the flat step: B3'
    with env_set("SPNERF_HASH_SW_ACC", "0"):
        htr, hdata = train_setup("hash", device=device)
        hstate = htr.init_state(torch.Generator().manual_seed(0))
        calls, loss_plain, grad_plain = record_plain(htr, hstate, hdata)
        per10, dev10 = hold_calls(calls, False, ("partials",))
        if len(per10["partials"]) != 21:
            fail(f"expected 21 window-route calls, got "
                 f"{len(per10['partials'])}")
        skew10 = hold("partials", skew, ct6, t_eff6, True, "skewed",
                      timed=False)
        log(f"dtab_sorted_partials skewed: {json.dumps(skew10)}")
        edge10 = hold_edges("partials")
        del calls
        match10 = step_match("hash step, SW_ACC=0", htr, hstate, hdata,
                             loss_plain, grad_plain)
        del grad_plain
        launches10 = step_launches(
            "hash train step, SW_ACC=0", htr, hstate, hdata,
            {"dtab_dense": 3, "dtab_sorted_partials": 21})
        acc0_rec = time_steps(htr, hstate, hdata, 10)
        acc0_rec.update(match10)
        log("hash train step, SW_ACC=0: " + json.dumps(acc0_rec))
        del htr, hdata, hstate
    del skew, ct6
    torch.cuda.empty_cache()

    # 11. SPNERF_HASH_SW_BATCHED=1 on the (L, T, F) step: B4
    def hold_batched(ids, ct, T_, tag, timed=True):
        """B4 against dtab_batched_plain and against a second call of
        itself (float atomics: within DTAB_RTOL, not bitwise), then timed
        beside the plain version, `index_add_` on the flattened (L * T, F)
        table with and without its zero fill, and the bytes bound."""
        out = dt.dtab_batched(ids, ct, T_)
        ref = dt.dtab_batched_plain(ids, ct, T_)
        err, rel = rel_check(out, ref, f"dtab_batched {tag}")
        _, rel2 = rel_check(dt.dtab_batched(ids, ct, T_), out,
                            f"dtab_batched {tag}, a second call")
        L_, M = ids.shape
        F = ct.shape[2]
        rec = dict(L=L_, M=M, t_eff=T_, err=err, rel=rel)
        if timed:
            keys = (ids.long() + torch.arange(L_, device=device)[:, None]
                    * T_).reshape(-1)
            flat_ct = ct.reshape(L_ * M, F)
            lib_out = torch.zeros((L_ * T_, F), device=device)
            rec.update(
                ms=cuda_ms(lambda: dt.dtab_batched(ids, ct, T_), 5),
                plain_ms=cuda_ms(lambda: dt.dtab_batched_plain(ids, ct, T_),
                                 3),
                library_ms=cuda_ms(lambda: lib_out.index_add_(0, keys,
                                                              flat_ct), 3),
                library_zero_ms=cuda_ms(lambda: torch.zeros_like(
                    lib_out).index_add_(0, keys, flat_ct), 3),
                bound_ms=L_ * bound_ms(M, T_, F, ids.element_size()))
            log(f"dtab_batched {tag}: max abs err {err:.3g} ({rel:.3g} of "
                f"the largest entry), kernel {rec['ms']:.3f} ms, plain "
                f"{rec['plain_ms']:.3f} ms, index_add_ "
                f"{rec['library_ms']:.3f} ms ({rec['library_zero_ms']:.3f} "
                f"ms with its zero fill), bound {rec['bound_ms']:.4f} ms")
        else:
            log(f"dtab_batched {tag}: max abs err {err:.3g} ({rel:.3g} of "
                f"the largest entry); two calls within {rel2:.3g}")
        return rec

    def hold_batched_edges():
        """B4 on every batched edge case of `utils/dtab_cases.py`, int64
        and int32 ids; {kind: max relative error}."""
        rels = {}
        for kind in BATCHED_CASES:
            for ids64 in (True, False):
                ids, ct, T_ = batched_edge_case(kind, device, ids64)
                r = hold_batched(ids, ct, T_, f"edge {kind}", timed=False)
                rels[kind] = max(rels.get(kind, 0.0), r["rel"])
        log(f"dtab_batched edge cases, int64 and int32 ids, max err / "
            f"largest entry: {json.dumps(rels)}")
        return rels

    with env_set("SPNERF_HASH_SW_BATCHED", "1"):
        ttr, tdata = train_setup("hash", device=device, flat_table=False)
        tstate = ttr.init_state(torch.Generator().manual_seed(0))
        bcalls, loss_plain, grad_plain = record_plain(ttr, tstate, tdata,
                                                      batched=True)
        if len(bcalls) != 3:
            fail(f"expected 3 batched table gradients, got {len(bcalls)}")
        per11 = [hold_batched(ids, ct, T_,
                              f"L={ids.shape[0]} M={ids.shape[1]}")
                 for ids, ct, T_ in bcalls]
        # a skewed level (half its rows on 64 ids) and a level of
        # direct-coarse ids (below 4,913) in the coarse pass's call
        ids, ct, T_ = bcalls[0]
        extra = ids.clone()
        M = extra.shape[1]
        gen = torch.Generator(device).manual_seed(4)
        extra[1] = torch.randint(0, 4913, (M,), device=device, generator=gen)
        extra[2, :M // 2] = torch.randint(0, 64, (M // 2,), device=device,
                                          generator=gen)
        extra11 = hold_batched(extra, ct, T_, "skewed and direct-coarse "
                               "levels", timed=False)
        edge11 = hold_batched_edges()
        dev11 = device_ms(lambda: [dt.dtab_batched(*c) for c in bcalls],
                          len(bcalls), keys=PORT_KERNEL_KEYS + MEMSET_KEYS)
        log(f"device time per launch (profiler): {json.dumps(dev11)}")
        del bcalls, ids, ct, extra
        match11 = step_match("(L, T, F) hash step, SW_BATCHED=1", ttr, tstate,
                             tdata, loss_plain, grad_plain)
        del grad_plain
        launches11 = step_launches(
            "(L, T, F) hash train step, SW_BATCHED=1", ttr, tstate, tdata,
            {"dtab_batched": 3})
        bat_rec = time_steps(ttr, tstate, tdata, 10)
        bat_rec.update(match11)
        log("(L, T, F) hash train step, SW_BATCHED=1: " + json.dumps(bat_rec))
        del ttr, tdata, tstate
    torch.cuda.empty_cache()

    def entry(name, source_line, recs, launches, extra_recs, dev, **more):
        n = len(recs)
        tot = {k: sum(r[k] for r in recs)
               for k in ("ms", "plain_ms", "library_ms", "library_zero_ms",
                         "bound_ms")}
        e = {
            "name": name,
            "route": "cuda",
            "source": "spnerf_torch/csrc/dtab.cu",
            "replaces": source_line,
            "launches": launches,
            "max_abs_err": max(r["err"] for r in recs + extra_recs),
            "max_rel_err": max(r["rel"] for r in recs + extra_recs),
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
            "device_ms": dev["kernel"],
            "kernel_launches_per_call": dev["launches"],
            "kernels_per_call": dev["names"],
            "library_zero_ms": tot["library_zero_ms"] / n,
            "calls": [{k: v for k, v in r.items() if k not in ("err", "rel")}
                      for r in recs],
            "card": card,
        }
        e.update(more)
        return e

    def tmajor(recs, dev):
        """The same kernel's numbers on the (L, T, F) step's t-major calls."""
        n = len(recs)
        return {k: sum(r[k] for r in recs) / n
                for k in ("ms", "library_ms", "library_zero_ms", "bound_ms")
                } | {"device_ms": dev["kernel"],
                     "kernel_launches_per_call": dev["launches"],
                     "max_rel_err": max(r["rel"] for r in recs)}

    src = "spnerf_tpu/ops/pallas/dtab.py"
    dense = entry("dtab_dense", f"{src}:127", per["dense"],
                  launches7["dtab_dense"], [skew_err["dense"]], dev6["dense"],
                  edge_rel_err={"fmajor": edge6_dense,
                                "tmajor": edge9_dense},
                  tmajor=tmajor(per9["dense"], dev9["dense"]))
    sorted_ = entry("dtab_sorted", f"{src}:307", per["sorted"],
                    launches7["dtab_sorted"], [skew_err["sorted"]],
                    dev6["sorted"], edge_rel_err=edge6,
                    tmajor=tmajor(per9["sorted"], dev9["sorted"]))
    partials = entry("dtab_sorted_partials", f"{src}:307 (branch :475)",
                     per10["partials"], launches10["dtab_sorted_partials"],
                     [skew10], dev10["partials"], edge_rel_err=edge10)
    batched = entry("dtab_batched", f"{src}:584", per11,
                    launches11["dtab_batched"], [extra11], dev11,
                    edge_rel_err=edge11)
    print(json.dumps({
        "kernels": [field_entry, dense, sorted_, partials, batched],
        "train_steps": {"hash": hash_rec, "siren": siren_rec,
                        "hash_tlf": tlf_rec, "hash_sw_acc0": acc0_rec,
                        "hash_tlf_batched": bat_rec},
        "launches_per_step": {"hash": launches7, "hash_tlf": launches9,
                              "hash_sw_acc0": launches10,
                              "hash_tlf_batched": launches11}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
