"""Model families: the Siren family gives what the harness took from its
Siren modules before families existed, a second family runs from new files
alone, and a family with no file fails naming the file looked for."""

import hashlib
import itertools
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import devtrace, flops, harness, reference, spec, traffic

from test_benchmark_runs import SEED, tiny

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
CELLS = ["flagship.train", "flagship.render", "wide1024.train",
         "wide1024.render"]
# SHA-256 of the weights and of the scene or views at the `tiny` sizes and
# SEED, as the benchmark drew them before it had families, on the CPU:
# `digest(traffic.make_weights(model, SEED, "cpu"))` and
# `digest(traffic.make_scene(mix, model, SEED, "cpu"))`, or for views
# `digest(named_views(traffic.make_views(mix, model, SEED, "cpu")))`, with
# `tiny(name)`'s model and mix (the flagship's and the wide field's tiny
# sizes are the same, so are their digests).
DIGESTS = {  # kind: (weights, scene or views)
    "train": (
        "dd543aca03e2c8c6d4fa07fa14bd4998de12e1ce7310f81889b38aefbafb0178",
        "9de45273414ed5dc0c4ec0244974f16a2bd75eccf2f4bd7afc8b273bc1d35193"),
    "render": (
        "bca72417f0be9b8457a1c746591999fd51e174371e3e86daed31fbfc01b5e32c",
        "f009fb24b6845316f60f55bfb1fb53e39870ea2de7c52796726ff9a55674a057"),
}


def digest(tensors):
    """SHA-256 over each tensor's name and bytes, in name order."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def named_views(views):
    return {f"{i}.{k}": t for i, v in enumerate(views)
            for k, t in zip(("rays", "labels"), v)}


def equal(a, b):
    """Dicts of tensors (or lists of floats) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
    return a == b


@pytest.mark.parametrize("name", CELLS)
def test_siren_family_gives_what_the_siren_modules_give(name):
    cell = tiny(name)
    family, cfg, mix = cell.family, cell.config, cell.traffic
    model, dtype = cfg["model"], cfg["render"]["compute_dtype"]
    assert cell.family.__file__ == str(ROOT / "benchmark/families/siren.py")
    weights = family.make_weights(model, SEED, "cpu")
    assert equal(weights, traffic.make_weights(model, SEED, "cpu"))
    classes = family.label_classes(model)
    assert classes == model["num_sem_classes"]
    kind = mix["kind"]
    if kind == "train":
        inputs = traffic.make_scene(mix, classes, SEED, "cpu")
        ref = family.reference_train(cfg, weights, inputs, 128, SEED, 3,
                                     dtype)
        direct = reference.train(cfg, weights, inputs, 128, SEED, 3, dtype)
        assert all(equal(a, b) for a, b in zip(ref, direct))
    else:
        views = traffic.make_views(mix, classes, SEED, "cpu")
        inputs = named_views(views)
        rays, sems = views[0]
        assert equal(family.reference_eval_rows(cfg, weights, rays, sems,
                                                dtype),
                     reference.eval_rows(cfg, weights, rays, sems, dtype))
    assert (digest(weights), digest(inputs)) == DIGESTS[kind]
    assert family.LOWER == reference.LOWER

    trace = devtrace.Trace(device=[("field_eval_kernel", 0.0, 0.4),
                                   ("elementwise", 0.4, 0.5)],
                           window=(0.0, 1.0))
    points = {flops.ALL_HEADS: 374_976, flops.SUN_HEADS: 749_952}
    ctx = harness.Context(kind, cfg, mix, 30.0, 7, 7 * 1024, trace, points,
                          None, family)
    peak = 30.0 * flops.PEAK_BF16_FLOPS
    train = spec.load_reader("train.mfu_pct")(ctx)
    render = spec.load_reader("render.mfu_pct")(ctx)
    b1 = spec.load_reader("b1.roofline_pct")(ctx)
    if kind == "train":
        work = 7 * 1024 * flops.train_flops_per_ray(cfg)
        assert train == 100.0 * work / peak
        assert render is None and b1 is None
    else:
        work = 7 * 1024 * flops.render_flops_per_ray(cfg)
        assert render == 100.0 * work / peak
        least = 0.0
        for heads, n in points.items():
            ops, nbytes = flops.field_call_work(model, n, heads, dtype)
            least += max(ops / flops.PEAK_BF16_FLOPS,
                         nbytes / flops.PEAK_HBM_BYTES)
        assert b1 == 100.0 * least / 0.4
        assert train is None


TOY_CONFIG = {
    "name": "toy", "family": "toy",
    "source": "https://arxiv.org/abs/2003.08934",
    "model": {"width": 32, "hidden_layers": 2},
    "render": {"n_samples": 8, "compute_dtype": "float32"},
    "train": {"lr": 0.01, "adam_betas": [0.9, 0.999], "adam_eps": 1e-08},
    "reduced": [], "assumed": [],
}
TOY_TRAFFIC = {
    "toy_train": {"kind": "train", "rate_metric": "train_rays_per_s",
                  "batch_rays": 64, "scene_rays": 512, "check_steps": 3,
                  "origin_std": 0.1, "near": 0.0, "far": 1.5,
                  "target_depth": 0.7, "depth_std": 0.05,
                  "valid_share": 0.5},
    "toy_render": {"kind": "render", "rate_metric": "render_rays_per_s",
                   "view_w": 8, "view_h": 6, "views": 2, "check_rays": 40,
                   "origin_std": 0.1, "near": 0.0, "far": 1.5},
}
TOY_LIMITS = {"toy.train": {"loss": 1e-5, "grad": 1e-4, "change": 1e-4},
              "toy.render": {"rgb": 1e-5, "depth": 1e-5}}


def files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def toy_tree(tmp_path):
    """A benchmark tree with the toy family added as new files and entries
    in BENCHMARK.json, and nothing of the benchmark's own files edited."""
    ignore = shutil.ignore_patterns("tests", "__pycache__")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=ignore)
    bench_dir = tmp_path / "benchmark"
    before = files(bench_dir)
    shutil.copy(HERE / "toy_family.py", bench_dir / "families/toy.py")
    (bench_dir / "configs/toy.json").write_text(json.dumps(TOY_CONFIG))
    for name, mix in TOY_TRAFFIC.items():
        (bench_dir / f"traffic/{name}.json").write_text(json.dumps(mix))
    for name, limits in TOY_LIMITS.items():
        (bench_dir / f"limits/{name}.json").write_text(
            json.dumps({"limits": limits}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy", "source": TOY_CONFIG["source"],
        "file": "benchmark/configs/toy.json", "reduced": [],
        "why": "a ReLU MLP field: a second family"})
    cells = {"train": "toy.train", "render": "toy.render"}
    for kind, cell in cells.items():
        bench["workloads"].append({"name": cell, "config": "toy",
                                   "traffic": f"toy_{kind}", "chips": 1,
                                   "why": f"the toy field's {kind} loop"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_rays_per_s", "train.mfu_pct"):
            m["workloads"].append(cells["train"])
        if m["name"] in ("render_rays_per_s", "render.mfu_pct",
                         "b1.roofline_pct"):
            m["workloads"].append(cells["render"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = files(bench_dir)
    assert {k: after[k] for k in before} == before
    return tmp_path


def toy_cell(tree, name):
    return spec.load_cell(name, tree / "BENCHMARK.json", tree / "benchmark")


def test_second_family_is_new_files_only(toy_tree, monkeypatch):
    """The toy family's train and render cells run end to end through the
    harness and are judged correct; its program's field with its outputs
    scaled by 1.1 is judged not correct in both."""
    for name in ("toy.train", "toy.render"):
        cell = toy_cell(toy_tree, name)
        assert cell.family.__file__ == str(
            toy_tree / "benchmark/families/toy.py")
        out = harness.run_cell(cell, SEED, 0.0, 0, "cpu")
        assert out["correct"], out["checks"]
        assert out["failed"] == 0 and out["attempted"] >= 1
        assert set(out["readings"]) >= set(cell.limits)
    # traced, on a clock that reads 1 s later at each look: one view in a
    # 2 s window; the family's count, and no field points counted
    cell = toy_cell(toy_tree, "toy.render")
    out = harness.run_cell(cell, SEED, 0.0, 1, "cpu",
                           clock=itertools.count().__next__)
    assert out["correct"], out["checks"]
    work = 48 * 8 * 2 * (3 * 32 + 2 * 32 * 32 + 32 * 4)
    assert out["metrics"]["render.mfu_pct"]["value"] == (
        100.0 * work / (2.0 * flops.PEAK_BF16_FLOPS))
    assert "b1.roofline_pct" not in out["metrics"]

    for name in ("toy.train", "toy.render"):
        cell = toy_cell(toy_tree, name)
        forward = cell.family.ToyField.forward
        monkeypatch.setattr(cell.family.ToyField, "forward",
                            lambda self, x, f=forward: 1.1 * f(self, x))
        out = harness.run_cell(cell, SEED, 0.0, 0, "cpu")
        assert not out["correct"], out["checks"]


def test_unknown_family_fails_naming_the_file(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = spec.read_json(ROOT / "benchmark/configs/flagship.json")
    cfg["family"] = "no_such_family"
    (tmp_path / "benchmark/configs").mkdir(parents=True)
    (tmp_path / "benchmark/configs/flagship.json").write_text(json.dumps(cfg))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    looked_for = ROOT / "benchmark/families/no_such_family.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(looked_for))):
        spec.load_cell("flagship.train", tmp_path / "BENCHMARK.json")
