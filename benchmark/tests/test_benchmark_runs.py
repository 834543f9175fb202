"""Runs of the harness without its look for a card, at a size the CPU
holds: the window's arithmetic on a fake clock, a sound run of each kind
judged correct against the cells' own limits, each fault the cells can
have judged not correct, and the control (the reference one precision step
lower) failing the limits. On a card, the control at the cells' own
sizes."""

import copy

import pytest
import torch

from benchmark import calibrate, check, harness, reference, spec, traffic

SEED = 2 ** 33 + 12345  # more than 32 signed bits hold


def tiny(name, **mix):
    """Cell `name` with its own limits at a size the CPU holds: training at
    256 wide, 16 samples, 128 rays a batch (narrower fields read the bf16
    step's gaps above the cells' limits); rendering at 16 wide, 4 samples,
    views of 8 x 6 rays (on the CPU the renderer runs the module, whose
    rounding the reference repeats)."""
    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    train = cell.traffic["kind"] == "train"
    cell.config["model"]["fc_units"] = 256 if train else 16
    cell.config["render"]["n_samples"] = 16 if train else 4
    small = ({"batch_rays": 128, "scene_rays": 1024} if train
             else {"view_w": 8, "view_h": 6, "check_rays": 40})
    cell.traffic = dict(cell.traffic, **small, **mix)
    return cell


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_counts_whole_calls_on_a_fake_clock():
    clock = FakeClock()

    def view(i):
        clock.t += 1.4

    n, w, ends = harness.window(view, 10.0, clock, lambda: None)
    assert (n, w) == (8, pytest.approx(11.2))
    assert ends == pytest.approx([1.4 * (i + 1) for i in range(8)])


def test_render_rate_counts_whole_views_and_real_rays(monkeypatch):
    """Views of 1.4 s on a fake clock, the renderer padding each to 64
    rays: 8 whole views of 8 x 6 rays in an 11.2 s window."""
    cell = tiny("flagship.render")
    clock = FakeClock()
    rendered = []

    class Padded:
        def __init__(self, cfg, weights, device):
            self.cfg, self.weights = cfg, weights

        def view(self, rays, sems):
            pad = 64 - rays.shape[0]
            rays = torch.cat([rays, rays[-1:].expand(pad, -1)])
            sems = torch.cat([sems, sems[-1:].expand(pad)])
            rendered.append(rays.shape[0])
            clock.t += 1.4
            out = reference.eval_rows(self.cfg, self.weights, rays, sems,
                                      "bfloat16")
            return {k: v[:48] for k, v in out.items()}

    monkeypatch.setattr(cell.family, "RenderProgram", Padded)
    out = harness.run_cell(cell, SEED, 10.0, 0, "cpu", clock=clock)
    assert out["attempted"] == 8 and out["correct"]
    rate = out["metrics"]["render_rays_per_s"]["value"]
    assert rate == pytest.approx(8 * 48 / 11.2)
    assert rendered == [64] * 9  # the warm-up view and the window's 8
    assert out["view_s"] == pytest.approx([1.4] * 8)


@pytest.mark.parametrize("name", ["flagship.train", "flagship.render",
                                  "wide1024.train", "wide1024.render"])
def test_sound_run_is_correct(name):
    out = harness.run_cell(tiny(name), SEED, 0.0, 0, "cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


def unchanged_state(monkeypatch):
    from spnerf_torch.train.loop import Trainer

    def apply_gradients(self, state, loss):
        state.step += 1

    monkeypatch.setattr(Trainer, "apply_gradients", apply_gradients)


def half_batch(monkeypatch):
    from spnerf_torch.train.loop import Trainer

    sample = Trainer.sample_batch

    def first_half(self, data, batch_size, generator):
        batch = sample(self, data, batch_size, generator)
        return {k: v[:batch_size // 2] for k, v in batch.items()}

    monkeypatch.setattr(Trainer, "sample_batch", first_half)


def altered_answer(monkeypatch):
    import spnerf_torch.render as port_render

    render_rays = port_render.render_rays

    def altered(*args, **kw):
        out = render_rays(*args, **kw)
        out["depth_coarse"] = out["depth_coarse"] + 0.05
        return out

    monkeypatch.setattr(port_render, "render_rays", altered)


@pytest.mark.parametrize("name,fault", [
    ("flagship.train", unchanged_state), ("flagship.train", half_batch),
    ("wide1024.train", unchanged_state), ("wide1024.train", half_batch),
    ("flagship.render", altered_answer), ("wide1024.render", altered_answer)],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = harness.run_cell(tiny(name), SEED, 0.0, 0, "cpu")
    assert not out["correct"], out["checks"]


def control_numbers(cell, seed, device):
    if cell.traffic["kind"] == "train":
        return calibrate.control_train(cell, seed, device)["control"]
    return calibrate.control_render(cell, seed, device)["control"]


@pytest.mark.parametrize("name", ["flagship.train", "flagship.render"])
def test_control_fails_the_limits(name):
    """The control at the flagship's width on a few rays."""
    cell = tiny(name)
    cell.config["model"]["fc_units"] = 512
    cell.config["render"]["n_samples"] = 16
    numbers = control_numbers(cell, SEED, torch.device("cpu"))
    assert not check.judge(numbers, cell.limits), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship.train", "flagship.render",
                                  "wide1024.train", "wide1024.render"])
def test_control_fails_the_limits_on_the_card(name, card):
    """The control at the cell's own sizes, on three seeds."""
    cell = spec.load_cell(name)
    for seed in (SEED, SEED + 1, SEED + 2):
        numbers = control_numbers(cell, seed, card)
        assert not check.judge(numbers, cell.limits), numbers


def test_seeds_give_the_same_inputs():
    model = spec.load_cell("flagship.train").config["model"]
    a = traffic.make_weights(model, SEED, "cpu")
    b = traffic.make_weights(model, SEED, "cpu")
    c = traffic.make_weights(model, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trunk1.kernel"], c["trunk1.kernel"])
