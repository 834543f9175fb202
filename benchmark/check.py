"""The numbers that decide `correct`, and their judgement against a cell's
limits (`benchmark/limits/<workload>.json`; PERF.md gives the readings each
limit was set from).

Training (the first `check_steps` steps of the object the window drives):
  loss    the largest gap of a step's loss from the reference's, relative
          to the reference's;
  grad    the first step's gradient, by the worst leaf: the gap between
          the program's norm and the reference's, over the larger of the
          reference's norm of that leaf and of the median leaf;
  change  the parameters' change over the steps, by the worst leaf, the
          same way; leaves whose reference gradient is under a thousandth of
          the median leaf's are left out (Adam moves them by round-off).
Rendering (a sample of rays, drawn from the seed, of the views the window
completed): for each per-ray output, the largest absolute gap from the
reference over the sample.
"""

import math
import statistics

NEGLIGIBLE = 1e-3  # a leaf's gradient under this share of the median's


def _norms(tensors):
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf(prog, ref, keep=None):
    """max over leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    gaps = [abs(pn.get(k, math.inf) - r) / max(r, med)
            for k, r in rn.items() if keep is None or k in keep]
    return math.nan if any(map(math.isnan, gaps)) else max(gaps)


def train_numbers(prog, ref, start):
    """prog, ref: (losses, first gradients, weights after the steps);
    start: the weights both began from."""
    losses_p, grads_p, end_p = prog
    losses_r, grads_r, end_r = ref
    loss = (max(abs(p - r) / abs(r) for p, r in zip(losses_p, losses_r))
            if len(losses_p) == len(losses_r) else math.inf)
    gn = _norms(grads_r)
    med = statistics.median(gn.values())
    moved = {k for k, n in gn.items() if n >= NEGLIGIBLE * med}
    change_p = {k: v.float() - start[k] for k, v in end_p.items()}
    change_r = {k: v - start[k] for k, v in end_r.items()}
    steps = {f"loss_step{i + 1}": abs(p - r) / abs(r)
             for i, (p, r) in enumerate(zip(losses_p, losses_r))}
    return {"loss": loss, "grad": worst_leaf(grads_p, grads_r),
            "change": worst_leaf(change_p, change_r, keep=moved), **steps}


def render_numbers(prog, ref):
    """prog, ref: {output: (n, ...) tensors} of the same rays."""
    out = {}
    for k, r in ref.items():
        p = prog.get(k)
        ok = p is not None and p.shape == r.shape
        out[k] = float((p.float() - r.float()).abs().max()) if ok else math.inf
    return out


def judge(numbers, limits):
    """Whether every limited number was read, is finite and within its
    limit."""
    return all(math.isfinite(numbers.get(k, math.nan)) and numbers[k] <= lim
               for k, lim in limits.items())


def lines(numbers, limits):
    """One line a number: name, value, limit."""
    return [f"check {k} {numbers.get(k, math.nan):.6g} limit {lim:.6g}"
            for k, lim in limits.items()]


def plain(v):
    """A number for a JSON line: as it is where finite, else as a string."""
    return v if v is not None and math.isfinite(v) else str(v)


def report(numbers, limits):
    """The result line's last key: each number with its limit."""
    return {k: {"value": plain(numbers.get(k)), "limit": lim}
            for k, lim in limits.items()}
