"""The port's bench program (`bench_torch.py`, `utils/synth.bench_setup`)
against the JAX package's `bench_setup`, on the CPU.

* The configs field by field, except `RenderConfig.use_pallas`: the JAX
  package reads it from SPNERF_USE_PALLAS, and it chooses the eval
  renderer only (no Pallas kernel runs in the train step); the port has no
  such field. The trainer's epoch length, step count, drop steps and
  learning rate at steps 0, 999, 1000 and 29,999 (1e-6 relative: float32
  against float64 powers, as `test_lr_schedule_matches_optax`).
* The synthetic scene bit for bit, dtypes included.
* A window of `run` takes n_inner steps on the state it is given, the
  step count advancing inside it, and returns the loss terms of the JAX
  package's window (names and shapes from `jax.eval_shape` of its `run`),
  finite.
* `bench_torch.main` prints one JSON line; without CUDA and without a
  device it raises.
* `device.card_info`, which gives the line its power limit, reads the
  nvidia-smi row of the card's own UUID (not of torch's index), and None
  where no row matches or nvidia-smi does not answer.

The starting weights differ from the JAX package's (torch cannot replay
`jax.random`). The step's own parity with the JAX package is held by
`tests/test_torch_train.py`: `test_one_step_loss_and_grads_match_jax`
(one step's loss and gradients on shared weights) and
`test_five_adam_steps_track_jax` (a five-step trajectory at 1e-4).
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import bench_torch
from spnerf_torch.utils.synth import bench_setup
from spnerf_tpu.utils import synth as jax_synth

SIZES = dict(batch_size=8, n_inner=2, n_rays=256)


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX package's (trainer, state, data, run) at SIZES."""
    return jax_synth.bench_setup(SIZES["batch_size"], SIZES["n_inner"],
                                 SIZES["n_rays"])


def port_bench():
    return bench_setup(SIZES["batch_size"], SIZES["n_inner"],
                       SIZES["n_rays"], device="cpu")


def test_configs_and_schedule_match_jax(jax_bench):
    jtr = jax_bench[0]
    tr = port_bench()[0]
    assert dataclasses.asdict(tr.mc) == dataclasses.asdict(jtr.mc)
    assert dataclasses.asdict(tr.lc) == dataclasses.asdict(jtr.lc)
    jrc = dataclasses.asdict(jtr.rc)
    del jrc["use_pallas"]
    assert dataclasses.asdict(tr.rc) == jrc
    for name in ("steps_per_epoch", "max_steps", "ds_drop_step",
                 "ss_drop_step", "beta_warmup_step"):
        assert getattr(tr, name) == getattr(jtr, name), name
    assert (tr.steps_per_epoch, tr.max_steps) == (1000, 30000)
    for step in (0, 999, 1000, 29999):
        np.testing.assert_allclose(tr.lr_schedule(step),
                                   float(jtr.lr_schedule(step)), rtol=1e-6,
                                   err_msg=str(step))


def test_scene_matches_jax_bit_for_bit(jax_bench):
    jdata = jax_bench[2]
    data = port_bench()[2]
    assert sorted(data) == sorted(jdata)
    for k, v in data.items():
        ref = np.asarray(jdata[k])
        got = v.numpy()
        assert got.dtype == ref.dtype, k
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(got, ref, err_msg=k)
    assert data["ids"].dtype == data["sems"].dtype == torch.int32
    assert data["rays"].shape == (SIZES["n_rays"], 11)


def test_window_takes_n_inner_steps_with_jax_loss_terms(jax_bench):
    import jax

    _, jstate, jdata, jrun = jax_bench
    _, jld = jax.eval_shape(jrun, jstate, jdata, jax.random.PRNGKey(1))
    _, state, data, run = port_bench()
    start = {k: p.detach().clone() for k, p in state.named_parameters()}
    for window in (1, 2):
        out, ld = run(state, data, 1)
        assert out is state
        assert state.step == window * SIZES["n_inner"]
        assert sorted(ld) == sorted(jld)
        for k, v in ld.items():
            v = torch.as_tensor(v)
            assert tuple(v.shape) == jld[k].shape, k
            assert torch.isfinite(v).all(), (window, k)
    assert any(not torch.equal(p, start[k])
               for k, p in state.named_parameters())


def test_bench_prints_one_json_line(capsys):
    rec = bench_torch.main(device="cpu", **SIZES)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out == rec
    assert set(out) == {"metric", "value", "unit", "ms_per_step",
                        "window_ms", "loss", "peak_mem_gb", "device",
                        "power_limit"}
    assert out["metric"] == "flagship_train_rays_per_sec_per_gpu"
    assert out["unit"] == "rays/s"
    assert math.isfinite(out["value"]) and out["value"] > 0
    assert math.isfinite(out["loss"])
    assert len(out["window_ms"]) == bench_torch.N_GROUPS == 2
    np.testing.assert_allclose(
        out["value"], SIZES["batch_size"] * 1e3 / out["ms_per_step"],
        rtol=1e-9)
    assert out["device"] == "cpu"
    assert out["power_limit"] is None and out["peak_mem_gb"] is None


def test_bench_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_torch.main(argv)


def test_card_info_reads_the_row_of_the_cards_uuid(monkeypatch):
    import subprocess
    import types

    from spnerf_torch import device as dev

    rows = ("GPU-aaaa-0000, NVIDIA H100 80GB HBM3, 700.00 W\n"
            "GPU-BBBB-1111, NVIDIA H100 80GB HBM3, 500.00 W\n")
    uuid = {"cuda:0": "bbbb-1111"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid=uuid[str(d)]))
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw:
                        types.SimpleNamespace(stdout=rows))
    assert dev.card_info("cuda:0") == ("NVIDIA H100 80GB HBM3", "500.00 W")
    uuid["cuda:0"] = "cccc-2222"
    assert dev.card_info("cuda:0") is None

    def absent(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(subprocess, "run", absent)
    assert dev.card_info("cuda:0") is None
