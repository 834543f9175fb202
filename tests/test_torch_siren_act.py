"""The Siren layer's epilogue (`SineLayer`, `csrc/siren_act.cu`) on the CPU.

`SineLayer` on CPU tensors runs its plain version; it must give the bits of
the unfused composition the field module ran before it (the bias add, the
cast, the w0 product and a sine Function saving its input, differentiated
by autograd), outputs and gradients, `torch.equal`. The kernel cannot run
here: its constants are held equal to the Python ones, and a float32 model
of its per-element chain (one rounding an operation, in the source's order)
to the plain version. The card tests (`tests/test_torch_cuda.py`) hold the
kernel itself.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spnerf_torch.models import spnerf
from spnerf_torch.models.spnerf import (SPNeRF, SineLayer, _fast_sin_grad,
                                        fast_sin, sine_layer_grad_plain,
                                        sine_layer_plain)
from spnerf_torch.utils.synth import flagship_configs

SOURCE = (Path(spnerf.__file__).resolve().parent.parent / "csrc"
          / "siren_act.cu")


class UnfusedSine(torch.autograd.Function):
    """The field module's sine before `SineLayer`: fast_sin in float32 on a
    compute-dtype input, rounded back, saving its input."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return fast_sin(y.float()).to(y.dtype)

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return (grad.float() * _fast_sin_grad(y.float())).to(y.dtype)


def unfused(y, bias, w0, compute_dtype):
    """The module's Siren epilogue before `SineLayer`, op by op."""
    h = (y + bias).to(compute_dtype)
    return UnfusedSine.apply(w0 * h if w0 != 1.0 else h)


def epilogue_inputs(n, width, dtype, seed=0):
    """Products over a wide range of magnitudes (the trunk's first layer
    reaches hundreds after w0), a bias, and an incoming gradient."""
    g = torch.Generator().manual_seed(seed)
    scale = 10.0 ** torch.randint(-3, 3, (n, 1), generator=g).float()
    y = torch.randn(n, width, generator=g) * scale
    bias = torch.randn(width, generator=g) * 0.1
    gs = torch.randn(n, width, generator=g).to(dtype)
    return y, bias, gs


def run(fn, y, bias, gs, w0, dtype):
    y = y.clone().requires_grad_()
    bias = bias.clone().requires_grad_()
    s = fn(y, bias, w0, dtype)
    s.backward(gs)
    return s, y.grad, bias.grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("w0", [30.0, 1.0])
@pytest.mark.parametrize("width", [256, 24, 6])
def test_sine_layer_matches_the_unfused_composition(dtype, w0, width):
    y, bias, gs = epilogue_inputs(203, width, dtype)
    before = dict(SineLayer.plain_calls)
    got = run(SineLayer.apply, y, bias, gs, w0, dtype)
    want = run(unfused, y, bias, gs, w0, dtype)
    assert got[0].dtype == dtype
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert SineLayer.plain_calls["forward"] == before["forward"] + 1
    assert SineLayer.plain_calls["backward"] == before["backward"] + 1


def source_constants():
    """name -> the float32 value of each `static_cast<float>(...)` constant
    of the kernel's source."""
    text = SOURCE.read_text()
    found = re.findall(
        r"constexpr float (\w+) = static_cast<float>\(([-+*/. 0-9]+)\);",
        text)
    return {name: np.float32(eval(expr)) for name, expr in found}


def test_kernel_constants_are_the_plain_versions():
    c = source_constants()
    want = {"INV_PI": 1.0 / np.pi, "PI": np.pi, "C1": spnerf._SIN_C1,
            "C3": spnerf._SIN_C3, "C5": spnerf._SIN_C5, "C7": spnerf._SIN_C7,
            "D3": 3.0 * spnerf._SIN_C3, "D5": 5.0 * spnerf._SIN_C5,
            "D7": 7.0 * spnerf._SIN_C7}
    assert set(c) == set(want)
    for name, value in want.items():
        # torch rounds a Python scalar operand to float32 once
        assert c[name] == torch.tensor(value, dtype=torch.float32).item()


def kernel_model(z, gs):
    """The kernel's per-element chain on float32 numpy arrays, each
    operation rounded once, in the source's order: fast_sin(z) and
    gs * fast_sin'(z), both before their rounding to the compute dtype."""
    c = source_constants()
    f = np.float32
    k = np.rint(z * c["INV_PI"])
    r = z - k * c["PI"]
    odd = k - f(2.0) * np.floor(k * f(0.5))
    sign = f(1.0) - f(2.0) * np.abs(odd)
    r2 = r * r
    p = c["C3"] + r2 * (c["C5"] + r2 * c["C7"])
    s = sign * (r * (c["C1"] + r2 * p))
    d = c["D3"] + r2 * (c["D5"] + r2 * c["D7"])
    d = sign * (c["C1"] + r2 * d)
    return s, gs * d


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("w0", [30.0, 1.0])
def test_kernel_arithmetic_matches_the_plain_version(dtype, w0):
    y, bias, gs = epilogue_inputs(512, 64, dtype, seed=1)
    y[0, :8] = torch.tensor([0.0, -0.0, np.pi / 2, -np.pi / 2, np.pi,
                             2.5 * np.pi, 1e-30, 3e4])
    s_plain, z = sine_layer_plain(y, bias, w0, dtype)
    gy_plain = sine_layer_grad_plain(gs, z, w0)

    def rnd(a):  # round_cd on a float32 numpy array
        return torch.from_numpy(a).to(dtype).float().numpy()

    v = rnd(y.numpy() + bias.numpy())
    if w0 != 1.0:
        v = rnd(np.float32(w0) * v)
    s, g = kernel_model(v, gs.float().numpy())
    g = rnd(g)
    if w0 != 1.0:
        g = rnd(g * np.float32(w0))
    assert np.array_equal(v, z.float().numpy())
    assert np.array_equal(rnd(s), s_plain.float().numpy())
    assert np.array_equal(g, gy_plain.numpy())


class UnfusedSineLayer:
    """Stands in for `SineLayer` in the field module: `unfused`."""

    apply = staticmethod(unfused)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_field_matches_the_unfused_field(dtype, monkeypatch):
    """A flagship-configuration field (32 wide) with a solar tail, forward
    and backward: every output and every parameter's gradient equal to the
    unfused composition's. One `SineLayer` each way per Siren activation:
    13 with every head (8 trunk, rgb0, sun0-2, sem0), 11 pruned to the sun
    head."""
    mc, _ = flagship_configs(fc_units=32)
    field = SPNeRF(mc, dtype, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    n, n_tail = 40, 16
    xyz = torch.randn(n, 3, generator=g) * 0.3
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    sems = torch.randint(0, 3, (n,), generator=g)

    def step(heads, tail):
        field.zero_grad()
        out = field(xyz, sun, None, sems, heads=heads, solar_tail=tail)
        sum((k + 1) * v.float().square().mean()
            for k, v in enumerate(out.values())).backward()
        return out, {k: p.grad.clone() for k, p in field.named_parameters()
                     if p.grad is not None}

    for heads, tail, acts in ((None, n_tail, 13), (("sun",), 0, 11)):
        before = dict(SineLayer.plain_calls)
        out, grads = step(heads, tail)
        for way in ("forward", "backward"):
            assert SineLayer.plain_calls[way] - before[way] == acts
        with monkeypatch.context() as m:
            m.setattr(spnerf, "SineLayer", UnfusedSineLayer)
            want_out, want_grads = step(heads, tail)
        assert out.keys() == want_out.keys()
        assert grads.keys() == want_grads.keys()
        for k in out:
            assert torch.equal(out[k], want_out[k]), k
        for k in grads:
            assert torch.equal(grads[k], want_grads[k]), k
