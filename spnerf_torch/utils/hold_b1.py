"""B1's launches held against the plain version, beside the controls that
size what a rounding policy and the tensor cores' sums move.

`hold_b1_launches(run, tag, ...)` records the field inputs of every
`FusedField` launch that `run()` makes, launches each again and holds it
against `PlainField` at the launch's compute dtype with TF32 off, within
KERNEL_ATOL (bf16) or F32_ATOL (float32). With `controls`, every bf16
launch also gets two controls on the same inputs:

- the float32 control: the plain field in float32 with TF32 off. Its
  distance from the plain bf16 field is the size of the bf16 rounding
  policy itself;
- the tensor-core control: the plain bf16 field with TF32 on. Its
  operands are bf16 values, which TF32 holds exactly, so its products are
  the plain version's and only their sums move onto the tensor cores
  (cuBLAS). Its distance from the plain bf16 field is the size of a
  tensor-core sum of the same products. It is independent of the kernels.

The record then lists, launch by launch and output by output, the
kernel's distance from the plain version, each control's, and the two
ratios. With `control_share`, a bf16 output past KERNEL_ATOL passes where
it lies within `control_share` of its float32 control and, with
`tc_share`, within `tc_share` of its tensor-core control; without, every
output keeps KERNEL_ATOL. A share alone takes the controls (two more
plain fields) only for a launch with an output past KERNEL_ATOL; with
`controls` every bf16 launch gets them. Float32 launches keep F32_ATOL.
Runs on any
device: on the CPU the plain version stands in for the kernel and TF32
changes nothing.

`chip_smoke.py` and `utils/wide_checks.py` both hold B1 through this
module.
"""

import contextlib
import math
from dataclasses import dataclass

import torch

KERNEL_ATOL = 2e-2  # bf16: sum order may flip one bf16 ulp of an activation
# float32 (the wgmma_f32, wgmma_wide and general routes against the plain
# version with TF32 off): the same float32 products summed in another order,
# or as three TF32 products without lo x lo (2^-22 of each), through eight
# layers
F32_ATOL = 1e-4
# The bar of a bf16 launch on a trained field (chip_smoke.py phases 19 and
# 21, utils/wide_checks.py): every output past KERNEL_ATOL lies within
# WIDE_CONTROL_SHARE of its plain float32 control on the same launch and
# within TC_CONTROL_SHARE of its tensor-core control; both must hold.
#
# WIDE_CONTROL_SHARE. After 10 steps at 1024 the tensor cores' bf16 sums
# put sun visibility up to 3.9e-2 and the semantic logits up to 2.2e-2 from
# plain bf16, at 0.20 of the float32 control and below (the largest such
# reading). A ratio of 1 is a kernel as far from plain bf16 as float32 is.
# The share is the geometric mean of 0.20 and 1, so it has the same room,
# 2.2x, to either side.
WIDE_CONTROL_SHARE = 0.45
# TC_CONTROL_SHARE. On an H100 at 700 W (`utils/wide_checks.py trained`,
# chip_smoke.py phases 16 and 19) the outputs of the wide and the one-CTA
# wgmma kernel sat at 0.74 to 1.51 of the tensor-core control: on a
# 704-wide field after 10 steps (both kernels on the same launches, output
# by output within 7% of each other), on a 1024-wide field after 300 steps
# (sigma, rgb, sun visibility and the semantic logits all exceed
# KERNEL_ATOL, up to 0.36, at 0.96-1.49 of this control and 0.04-0.27 of
# the float32 one) and on phase 19's field (1.02-1.51 past KERNEL_ATOL):
# the kernels' sums are the tensor cores' own. A ratio of 1 is a kernel as
# far from plain bf16 as cuBLAS's tensor-core sums of the same products
# are. The share is about twice the largest reading, 1.51; a kernel three
# times as far as the tensor cores' own sums has a fault of its own.
#
# Until the 300-step reading only sun visibility and the semantic logits
# went to the controls, and sigma and rgb kept KERNEL_ATOL, which that
# field's sigma (0.360) and rgb (0.121) exceed although they sit at 1.00
# and 0.96 of the tensor-core control: the bar held the kernel to a
# tolerance the tensor cores' own sums do not meet. Every output now goes
# to both controls, sky and beta too.
TC_CONTROL_SHARE = 3.0


class B1Mismatch(AssertionError):
    """A B1 launch outside its bar."""


@contextlib.contextmanager
def tf32(on):
    """`torch.backends.cuda.matmul.allow_tf32` set to `on` inside, restored
    after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@dataclass
class Launch:
    """One `FusedField` launch's weights, compute dtype and inputs."""
    packed: object
    compute_dtype: object
    xyz: torch.Tensor
    sun: torch.Tensor
    t_emb: object
    sem: object
    heads: object

    def args(self):
        return self.xyz, self.sun, self.t_emb, self.sem

    @property
    def bf16(self):
        return not str(self.compute_dtype).endswith("float32")


def record_launches(run):
    """The launches of `FusedField` that `run()` makes, in order."""
    from ..ops import field_eval as fe

    seen = []
    real = fe.FusedField.__call__

    def recording(self, xyz, sun_d, t_emb=None, sem_labels=None, heads=None):
        seen.append(Launch(self.packed, self.compute_dtype, xyz, sun_d, t_emb,
                           sem_labels, heads))
        return real(self, xyz, sun_d, t_emb, sem_labels, heads=heads)

    fe.FusedField.__call__ = recording
    try:
        run()
    finally:
        fe.FusedField.__call__ = real
    return seen


def max_abs(a, b):
    """{output: max abs difference} over the outputs of `b`."""
    return {k: (a[k] - b[k]).abs().max().item() for k in b}


def controls_of(launch):
    """(plain float32 field, plain bf16 field with TF32 on) on the
    launch's inputs: the two controls."""
    from ..ops import field_eval as fe

    with tf32(False):
        ctl32 = fe.PlainField(launch.packed, "float32")(
            *launch.args(), heads=launch.heads)
    with tf32(True):
        ctltc = fe.PlainField(launch.packed, launch.compute_dtype)(
            *launch.args(), heads=launch.heads)
    return ctl32, ctltc


def output_row(err, ctl32, ctltc):
    """One output's record: the kernel's distance from the plain version,
    each control's distance from it, and the kernel's over each control's
    (None where a control is 0)."""
    return {"err": err, "control_f32": ctl32,
            "ratio_f32": err / ctl32 if ctl32 else None,
            "control_tc": ctltc, "ratio_tc": err / ctltc if ctltc else None}


def verdict(row, atol, control_share=None, tc_share=None):
    """None where an output's `row` meets its bar, else why not:
    KERNEL_ATOL (or `atol`), or past it with `control_share`, that share of
    its float32 control and, with `tc_share`, that share of its
    tensor-core control."""
    e = row["err"]
    if e <= atol:
        return None
    if control_share is None:
        return f"max abs err {e} > {atol}"
    if not e <= control_share * row["control_f32"]:
        return (f"max abs err {e} > {atol} and > {control_share} of the "
                f"plain float32 control {row['control_f32']}")
    if tc_share is not None and not e <= tc_share * row["control_tc"]:
        return (f"max abs err {e} > {atol} and > {tc_share} of the "
                f"tensor-core control {row['control_tc']}")
    return None


def hold_launch(launch, tag, controls=False, control_share=None,
                tc_share=None, packed=None, check=True):
    """`launch` through the kernel its weights are packed for (or `packed`'s,
    the same field packed for another route) against the plain version;
    with `check`, raises B1Mismatch outside the bar. Returns {"err": max
    abs error, "route": ..., "outputs": {output: row}} (rows on a bf16
    launch with `controls`, or with a share and an output past
    KERNEL_ATOL; else None)."""
    from ..ops import field_eval as fe

    pk = launch.packed if packed is None else packed
    with tf32(False):
        out = fe.FusedField(pk, launch.compute_dtype)(*launch.args(),
                                                      heads=launch.heads)
        ref = fe.PlainField(launch.packed, launch.compute_dtype)(
            *launch.args(), heads=launch.heads)
    err = max_abs(out, ref)
    where = (f"{tag}: B1 launch on {launch.xyz.shape[0]} points, heads "
             f"{launch.heads}")
    atol = KERNEL_ATOL if launch.bf16 else F32_ATOL
    past = not all(e <= atol for e in err.values())  # a NaN is past it
    rows = None
    if launch.bf16 and (controls or (control_share is not None and past)):
        ctl32, ctltc = controls_of(launch)
        c32, ctc = max_abs(ctl32, ref), max_abs(ctltc, ref)
        rows = {k: output_row(e, c32[k], ctc[k]) for k, e in err.items()}
        for k, row in rows.items():
            why = verdict(row, atol, control_share, tc_share)
            if why and check:
                raise B1Mismatch(f"{where}, {k}: {why}")
    elif check and past:
        raise B1Mismatch(f"{where}: max abs err {max(err.values())} > {atol}")
    return {"err": max(err.values()), "route": pk.route, "outputs": rows}


def largest_ratios(outputs, atol=KERNEL_ATOL):
    """The largest float32 and tensor-core ratio of an output past `atol`
    over the launches' rows (None where every output met it)."""
    past = [row for rows in outputs if rows for row in rows.values()
            if row["err"] > atol]

    def top(key):
        return max((r[key] if r[key] is not None else math.inf
                    for r in past), default=None)

    return top("ratio_f32"), top("ratio_tc")


def by_output(outputs):
    """The launches' rows summed up output by output: the largest distance
    of the kernel and of each control from the plain version over the
    launches, and the kernel's largest over each control's largest."""
    keys = dict.fromkeys(k for rows in outputs if rows for k in rows)
    res = {}
    for k in keys:
        rows = [r[k] for r in outputs if r and k in r]
        e, c32, ctc = (max(r[f] for r in rows)
                       for f in ("err", "control_f32", "control_tc"))
        res[k] = output_row(e, c32, ctc)
    return res


def hold_b1_launches(run, tag, control_share=None, tc_share=None,
                     controls=False):
    """B1 against its plain version on the field inputs of every launch
    that `run()` makes, at the launch's compute dtype, within KERNEL_ATOL
    (F32_ATOL in float32); raises B1Mismatch outside the bar. Returns
    {"launches_held", "points", "routes", "max_abs_err"} and, with
    `controls` or `control_share`, "outputs" (each bf16 launch's rows, see
    `output_row`; None for a launch that took no controls),
    "max_ratio_past_atol" and "max_tc_ratio_past_atol" (the
    largest ratios of an output past KERNEL_ATOL, the ones the shares
    hold; None where every output met KERNEL_ATOL)."""
    seen = record_launches(run)
    if not seen:
        raise B1Mismatch(f"{tag}: no B1 launch")
    held = [hold_launch(s, tag, controls, control_share, tc_share)
            for s in seen]
    rec = {"launches_held": len(held),
           "points": [s.xyz.shape[0] for s in seen],
           "routes": sorted({h["route"] for h in held}),
           "max_abs_err": max(h["err"] for h in held)}
    if controls or control_share is not None:
        rec["outputs"] = [h["outputs"] for h in held]
        rec["max_ratio_past_atol"], rec["max_tc_ratio_past_atol"] = (
            largest_ratios(rec["outputs"]))
        rec["by_output"] = by_output(rec["outputs"])
    return rec


def p99_max(a, b):
    """The 99th percentile and the largest of |a - b|."""
    err = (a - b).abs().flatten().float()
    return torch.quantile(err, 0.99).item(), err.max().item()


def render_rows(out, plain, plain32, *args):
    """A render's record beside its controls: `out` rendered through the
    kernels, `plain(*args)` and `plain32(*args)` the same render through
    the plain field at the render's compute dtype and in float32. Per
    output, the p99 and max of the kernel's distance from the plain render
    (TF32 off), the float32 control's and the tensor-core control's (the
    plain render with TF32 on) distances from it, and the ratios of the
    maxima."""
    with tf32(False):
        ref, c32 = plain(*args), plain32(*args)
    with tf32(True):
        ctc = plain(*args)
    rows = {}
    for k, v in ref.items():
        (p99, mx), (c99, cmx), (t99, tmx) = (p99_max(x[k], v)
                                             for x in (out, c32, ctc))
        rows[k] = {"p99": p99, "max": mx, "control_f32_p99": c99,
                   "control_f32_max": cmx, "control_tc_p99": t99,
                   "control_tc_max": tmx,
                   "ratio_f32": mx / cmx if cmx else None,
                   "ratio_tc": mx / tmx if tmx else None}
    return rows
