"""One run of one cell: set-up, the measured window, the trace when asked
for, the check against the reference, and the result line's fields.

Everything that depends on the model goes through the cell's family
(`benchmark/families/<family>.py`): its weights, its program over the port,
its reference and its operation counts. Two kinds of traffic (a mix's
"kind"), each a loop over the port:

- "train": set-up makes the weights and the device-resident scene from the
  seed, builds the family's training program over them (for the Siren
  family, the port's Trainer) and takes its first `check_steps` steps
  through the window's own call (the port draws each step's batch from its
  generator of (seed, step)); the window then takes steps of the same
  object back to back, from a synchronised start to a synchronised end.
  The rate is every ray trained over the whole window.
- "render": set-up makes the weights and a pool of views from the seed and
  renders one view (the warm-up); the window renders the pool in turn, each
  view ending when its per-ray outputs are read to the host. The window
  closes at the end of the first view to end past `seconds`, so it counts
  whole views only; the rate is their real rays (the renderer's padding
  not counted) over the whole window.
"""

import gc
import subprocess
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from types import ModuleType
from typing import Optional

import torch

from . import check, devtrace, spec, traffic


@dataclass
class Context:
    """What a per-layer metric's reader reads (see benchmark/metrics/)."""

    kind: str  # the traffic mix's kind: "train" or "render"
    config: dict
    traffic: dict
    window_s: float  # the measured window, host clock
    units: int  # steps or whole views in the window
    rays: int  # real rays trained or rendered in the window
    trace: Optional[devtrace.Trace] = None
    field_points: Optional[dict] = None  # heads -> points through the kernel
    unit_s: Optional[list] = None  # each view's seconds (each ends synced)
    family: Optional[ModuleType] = None  # the model family: its counts


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(work, seconds, clock, sync_fn):
    """Call work(i) for i = 0, 1, ... from a synchronised start until
    `seconds` have passed, then synchronise. Returns (calls, window s, the
    host clock's reading after each call, from the start)."""
    sync_fn()
    t0, ends = clock(), []
    while True:
        work(len(ends))
        ends.append(clock() - t0)
        if ends[-1] >= seconds:
            break
    sync_fn()
    return len(ends), clock() - t0, ends


@contextmanager
def traced(on):
    """A torch.profiler session (host and device activity) around the
    window, marked by a devtrace.WINDOW record; None when `on` is false."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW):
            yield prof


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def device_info(device, chips):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def card(device):
    """The card's name and power limit as nvidia-smi reads them."""
    if device.type != "cuda":
        return "cpu"
    idx = device.index if device.index is not None else 0
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"{torch.cuda.get_device_name(device)}, power limit not read " \
               f"({type(err).__name__})"


class Phases:
    """Set-up's phases, each timed to a synchronised end: [name, s]."""

    def __init__(self, device, clock, start):
        self.device, self.clock, self.last = device, clock, start
        self.done = []

    def mark(self, name):
        sync(self.device)
        now = self.clock()
        self.done.append([name, now - self.last])
        self.last = now


def train_setup(cell, seed, device, phases):
    """The port's training object after its first check_steps steps, with
    what the check keeps of them: (program, weights, scene, (losses, first
    gradients, parameters after the steps))."""
    cfg, mix, family = cell.config, cell.traffic, cell.family
    weights = family.make_weights(cfg["model"], seed, device)
    scene = traffic.make_scene(mix, family.label_classes(cfg["model"]), seed,
                               device)
    phases.mark("inputs")
    prog = family.TrainProgram(cfg, weights, scene, device)
    phases.mark("program")
    losses, grads = [], None
    for k in range(int(mix["check_steps"])):
        losses.append(prog.step(int(mix["batch_rays"]), seed))
        if k == 0:
            grads = prog.first_gradients()
        phases.mark(f"step {k}")
    kept = ([float(x) for x in losses], grads, prog.params())
    return prog, weights, scene, kept


def train_reference(cell, weights, scene, seed, precision, half_batch=False):
    mix = cell.traffic
    return cell.family.reference_train(
        cell.config, weights, scene, int(mix["batch_rays"]), seed,
        int(mix["check_steps"]), precision, half_batch=half_batch)


def run_train(cell, seed, seconds, trace, device, phases, clock):
    batch = int(cell.traffic["batch_rays"])
    prog, weights, scene, kept = train_setup(cell, seed, device, phases)
    phases.mark("kept")
    setup_s = sum(t for _, t in phases.done)
    losses = []
    with traced(trace) as prof:
        n, window_s, _ = window(
            lambda i: losses.append(prog.step(batch, seed)), seconds, clock,
            lambda: sync(device))
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    dev = device_info(device, cell.chips)
    tr = devtrace.read(prof) if trace else None
    del prog, losses
    free(device)
    ref = train_reference(cell, weights, scene, seed,
                          cell.config["render"]["compute_dtype"])
    numbers = check.train_numbers(kept, ref, weights)
    ctx = Context("train", cell.config, cell.traffic, window_s, n, n * batch,
                  tr, family=cell.family)
    e2e = {cell.traffic["rate_metric"]: n * batch / window_s,
           "setup_s": setup_s}
    return result(cell, ctx, e2e, failed, dev, numbers, device, phases)


def render_sample(outs, views, seed, count):
    """A sample of `count` (view, ray) pairs of the window's views, drawn
    from the seed: the program's outputs there and the view inputs."""
    n_rays = views[0][0].shape[0]
    g = torch.Generator().manual_seed(traffic.sub_seed(seed, traffic.SAMPLE))
    picks = torch.randint(0, len(outs) * n_rays, (count,), generator=g)
    prog, rays, sems = {k: [] for k in outs[0]}, [], []
    for v in picks.div(n_rays, rounding_mode="floor").unique().tolist():
        r = picks[picks // n_rays == v] % n_rays
        for k in prog:
            prog[k].append(outs[v][k][r])
        rv, sv = views[v % len(views)]
        rays.append(rv[r.to(rv.device)])
        sems.append(sv[r.to(sv.device)])
    return ({k: torch.cat(p) for k, p in prog.items()}, torch.cat(rays),
            torch.cat(sems))


def run_render(cell, seed, seconds, trace, device, phases, clock):
    cfg, mix, family = cell.config, cell.traffic, cell.family
    weights = family.make_weights(cfg["model"], seed, device)
    views = traffic.make_views(mix, family.label_classes(cfg["model"]), seed,
                               device)
    phases.mark("inputs")
    prog = family.RenderProgram(cfg, weights, device)
    phases.mark("program")
    prog.view(*views[0])
    phases.mark("view 0")
    setup_s = sum(t for _, t in phases.done)
    outs = []
    # the field kernel's points, where the family counts them
    count_points = getattr(family, "count_points", None) if trace else None
    counts = {} if count_points else None
    counting = count_points(counts) if count_points else nullcontext()
    with counting, traced(trace) as prof:
        n, window_s, ends = window(
            lambda i: outs.append(prog.view(*views[i % len(views)])),
            seconds, clock, lambda: sync(device))
    failed = sum(not all(bool(torch.isfinite(v).all()) for v in o.values())
                 for o in outs)
    dev = device_info(device, cell.chips)
    tr = devtrace.read(prof) if trace else None
    del prog
    free(device)
    got, rays, sems = render_sample(outs, views, seed, int(mix["check_rays"]))
    ref = family.reference_eval_rows(cfg, weights, rays, sems,
                                     cfg["render"]["compute_dtype"])
    numbers = check.render_numbers(got, {k: v.cpu() for k, v in ref.items()})
    n_rays = traffic.view_rays(mix)
    ctx = Context("render", cfg, mix, window_s, n, n * n_rays, tr, counts,
                  [b - a for a, b in zip([0.0] + ends, ends)], family)
    e2e = {mix["rate_metric"]: n * n_rays / window_s, "setup_s": setup_s}
    return result(cell, ctx, e2e, failed, dev, numbers, device, phases)


def result(cell, ctx, e2e, failed, dev, numbers, device, phases):
    """The result line's fields, `checks` last."""
    out = {"correct": check.judge(numbers, cell.limits) and failed == 0,
           "attempted": ctx.units, "failed": failed}
    metrics = {}
    if ctx.trace is None:
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise KeyError(f"cell {cell.name} lists {m['name']}, which a "
                               f"{ctx.kind} run does not measure")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = dict(dev, busy_s=ctx.trace.busy_s(),
                   window_s=ctx.trace.window_s)
    out["metrics"] = metrics
    out["device"] = dev
    if ctx.trace is not None:
        out["breakdown"] = devtrace.breakdown(ctx.trace)
    out["card"] = card(device)
    out["setup_phases"] = phases.done
    if ctx.unit_s is not None:
        out["view_s"] = ctx.unit_s
    out["readings"] = {k: check.plain(v) for k, v in numbers.items()}
    out["checks"] = check.report(numbers, cell.limits)
    out["_lines"] = check.lines(numbers, cell.limits)
    return out


def run_cell(cell, seed, seconds, trace, device, t_start=None,
             clock=time.perf_counter):
    """Run `cell` once; returns the result's fields (and "_lines", the
    checks as text, which the caller prints last on standard error)."""
    device = torch.device(device)
    phases = Phases(device, clock, clock() if t_start is None else t_start)
    phases.mark("imports")
    torch.zeros(1, device=device)
    phases.mark("card")
    run = {"train": run_train, "render": run_render}[cell.traffic["kind"]]
    return run(cell, int(seed), float(seconds), bool(trace), device, phases,
               clock)
