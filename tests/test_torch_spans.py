"""The port's spans (`spnerf_torch.spans`): the six spans of the train step
and the renderer recorded under a profiler, none of them a user annotation
(which kineto would mirror onto the device timeline), nothing kept and one
shared no-op context without a profiler. On the card (marked `cuda`): no
device operation of the trace carries a span's name, every span has device
time, and the step's three spans fit in its synchronised wall time."""

import inspect
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from spnerf_torch import render, spans
from spnerf_torch.ops.field_eval import FusedField
from spnerf_torch.train.loop import Trainer
from spnerf_torch.utils.synth import (fake_batch, flagship_configs,
                                      flagship_loss_config)

TRAIN_SPANS = ("train.forward", "train.backward", "train.optimizer")
RENDER_SPANS = ("render.chunk", "render.solar", "field.inputs")
N_RAYS, CHUNK = 2500, 1024  # three chunks, the last one padded


@pytest.fixture(autouse=True)
def no_kept_spans():
    spans.reset()
    yield
    spans.reset()


def small_trainer(device):
    """The flagship step (guided samples, solar pass, semantics) at 32 wide
    and 8 samples, on 4,096 synthetic rays."""
    mc, rc = flagship_configs(n_samples=8, fc_units=32)
    tr = Trainer(mc, rc, flagship_loss_config(), lr=5e-4,
                 steps_per_epoch=1000, max_steps=100, device=device)
    data = tr.shard_data(fake_batch(np.random.default_rng(0), 4096))
    return tr, tr.init_state(torch.Generator().manual_seed(0)), data


def view_rays(device):
    batch = fake_batch(np.random.default_rng(1), N_RAYS)
    return (torch.from_numpy(batch["rays"]).to(device),
            torch.from_numpy(batch["sems"]).long().to(device))


def fused_render(tr, state, monkeypatch):
    """render_image through `FusedField` (its plain version on the CPU)."""
    monkeypatch.setattr(render, "uses_fused_kernel", lambda *a: True)
    return render.build_render_fn(state.model, tr.rc, chunk=CHUNK)


def kineto_events(prof):
    return list(prof.profiler.kineto_results.events())


def test_train_step_records_its_spans():
    tr, state, data = small_trainer("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(state, data, 64)
    tot = spans.totals()
    assert set(tot) == set(TRAIN_SPANS) | {"render.solar"}
    for name in TRAIN_SPANS:
        assert tot[name]["n"] == 1 and tot[name]["parents"] == [None]
        assert tot[name]["host_s"] > 0
        assert tot[name]["device_s"] is None  # no CUDA here
    # the solar pass runs inside the forward loss
    assert tot["render.solar"] == dict(tot["render.solar"], n=1,
                                       parents=["train.forward"])
    host = [e.name() for e in kineto_events(prof)]
    assert all(host.count(name) == 1 for name in TRAIN_SPANS)


def test_render_image_records_its_spans(monkeypatch):
    tr, state, _ = small_trainer("cpu")
    render_image = fused_render(tr, state, monkeypatch)
    rays, sems = view_rays("cpu")
    calls = []
    inputs = FusedField.inputs
    monkeypatch.setattr(FusedField, "inputs", lambda self, *a: (
        calls.append(1), inputs(self, *a))[1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = render_image(rays, 0, sems=sems)
    assert out["rgb_coarse"].shape == (N_RAYS, 3)
    tot = spans.totals()
    chunks = -(-N_RAYS // CHUNK)
    assert set(tot) == set(RENDER_SPANS)
    assert tot["render.chunk"]["n"] == chunks
    assert tot["render.chunk"]["parents"] == [None]
    assert tot["render.solar"]["n"] == chunks
    assert tot["render.solar"]["parents"] == ["render.chunk"]
    # coarse, guided and solar field calls: each takes its inputs once
    assert tot["field.inputs"]["n"] == len(calls) == 3 * chunks
    assert sorted(tot["field.inputs"]["parents"], key=str) == [
        "render.chunk", "render.solar"]
    names = [e.name() for e in kineto_events(prof)]
    assert names.count("render.chunk") == chunks


@pytest.mark.parametrize("work", ["train", "render"])
def test_no_span_is_a_user_annotation(work, monkeypatch):
    tr, state, data = small_trainer("cpu")
    if work == "render":
        render_image = fused_render(tr, state, monkeypatch)
        rays, sems = view_rays("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("control.annotation"):
            if work == "train":
                tr.train_step(state, data, 64)
            else:
                render_image(rays, 0, sems=sems)
    ours = TRAIN_SPANS + RENDER_SPANS
    events = kineto_events(prof)
    found = [e for e in events if e.name() in ours]
    assert {e.name() for e in found} == (
        set(TRAIN_SPANS) | {"render.solar"} if work == "train"
        else set(RENDER_SPANS))
    assert not any(e.is_user_annotation() for e in found)
    # the check can see an annotation: record_function's is one
    control = [e for e in events if e.name() == "control.annotation"]
    assert control and all(e.is_user_annotation() for e in control)


def test_without_a_profiler_a_span_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("train.forward") is spans.span("render.chunk")
    with spans.span("train.forward") as s:
        assert s is None
    tr, state, data = small_trainer("cpu")
    tr.train_step(state, data, 64)
    assert spans.totals() == {}


def test_totals_keep_until_reset():
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            with spans.span("inner"):
                pass
            with spans.span("inner"):
                pass
    first = spans.totals()
    assert first["outer"]["n"] == 1 and first["outer"]["parents"] == [None]
    assert first["inner"]["n"] == 2 and first["inner"]["parents"] == ["outer"]
    assert first["outer"]["host_s"] >= 0
    assert spans.totals() == first  # nothing cleared
    spans.reset()
    assert spans.totals() == {}


def test_fused_field_call_keeps_its_positional_signature():
    """The benchmark's point counter calls it positionally."""
    params = list(inspect.signature(FusedField.__call__).parameters)
    assert params == ["self", "xyz", "sun_d", "t_emb", "sem_labels", "heads"]


@pytest.mark.cuda
def test_spans_on_the_card_stay_off_the_device_timeline(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda")
    tr, state, data = small_trainer(device)
    render_image = render.build_render_fn(state.model, tr.rc, chunk=CHUNK)
    rays, sems = view_rays(device)
    tr.train_step(state, data, 256)  # warm-up: first launches, the build
    render_image(rays, 0, sems=sems)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("control.annotation"):
            t0 = time.perf_counter()
            tr.train_step(state, data, 256)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        render_image(rays, 0, sems=sems)
        torch.cuda.synchronize()
    tot = spans.totals()
    assert set(tot) == set(TRAIN_SPANS + RENDER_SPANS)
    assert all(t["device_s"] > 0 for t in tot.values()), tot
    assert sum(tot[n]["device_s"] for n in TRAIN_SPANS) <= step_s
    device_names = {e.name() for e in kineto_events(prof)
                    if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert any("field_eval" in n for n in device_names)  # B1 on the card
    assert not device_names & set(tot)
    # an annotation would be mirrored there: the check can see one
    assert "control.annotation" in device_names


def test_cli_profile_writes_the_span_totals(tmp_path):
    """`--profile` records the second window: 4 steps' spans beside the
    trace, in `<logs>/profile/spans.json`."""
    import json

    from spnerf_torch.cli.train import main
    from spnerf_torch.utils.synth_scene import write_synthetic_aoi

    write_synthetic_aoi(str(tmp_path / "dataset" / "DFC2019_269"), width=40,
                        height=36, roi_size=24, seed=5)
    main(["--aoi_id", "JAX_269", "--model", "sp-nerf", "--project_dir",
          str(tmp_path), "--exp_name", "prof", "--no_timestamp_exp_name",
          "--n_samples", "8", "--fc_units", "32", "--fc_layers", "4",
          "--mapping", "--guidedsample", "--sem", "--num_sem_classes", "3",
          "--sc_lambda", "0.1", "--batch_size", "64", "--log_every", "4",
          "--max_train_steps", "8", "--chunk", "1024", "--profile",
          "--data_axis", "1", "--device", "cpu"])
    prof = tmp_path / "output" / "prof" / "logs" / "profile"
    assert (prof / "trace.json").is_file()
    kept = json.loads((prof / "spans.json").read_text())
    assert set(kept) == set(TRAIN_SPANS) | {"render.solar"}
    assert all(kept[n]["n"] == 4 for n in kept)
    assert spans.totals() == kept  # nothing kept after the window
