"""BENCHMARK.json against the benchmark's contract, the files it names found
by name, a cell and a metric added as new files picked up with no edit, and
the frozen operation count."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import flops, harness, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))


def test_configs_files_and_cells():
    cells = BENCH["workloads"]
    used = {w["config"] for w in cells}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in cells)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.traffic["rate_metric"] in e2e
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.load_reader(m["name"]))
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


def test_metric_workloads_report_what_they_move():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            c = spec.load_cell(cell)
            assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    """A traffic mix, a cell's limits and a per-layer metric added as files,
    with entries in BENCHMARK.json, run with no code changed."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    mix = dict(json.loads(
        (ROOT / "benchmark/traffic/train.json").read_text()), batch_rays=4096)
    (tmp_path / "benchmark/traffic/train_b4096.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark/limits/flagship.train_b4096.json").write_text(
        json.dumps({"limits": {"loss": 0.5}}))
    (tmp_path / "benchmark/metrics/train.steps.py").write_text(
        "def read(ctx):\n    return ctx.units if ctx.kind == 'train' "
        "else None\n")
    bench["workloads"].append({"name": "flagship.train_b4096",
                               "config": "flagship", "traffic": "train_b4096",
                               "chips": 1, "why": "a larger batch"})
    bench["end_to_end"][0]["workloads"].append("flagship.train_b4096")
    bench["per_layer"].append({
        "name": "train.steps", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "train step",
        "moves": "train_rays_per_s", "workloads": ["flagship.train_b4096"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("flagship.train_b4096", tmp_path / "BENCHMARK.json",
                          tmp_path / "benchmark")
    assert cell.traffic["batch_rays"] == 4096
    assert cell.limits == {"loss": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["train.steps"]
    read = spec.load_reader("train.steps", tmp_path / "benchmark")
    ctx = harness.Context("train", cell.config, cell.traffic, 10.0, 7,
                          7 * 4096)
    assert read(ctx) == 7


@pytest.mark.parametrize("width,all_heads,sun", [
    (512, 5_381_120, 4_850_688), (1024, 21_248_000, 19_138_560)])
def test_frozen_operation_count(width, all_heads, sun):
    model = spec.read_json(ROOT / "benchmark/configs/flagship.json")["model"]
    model = dict(model, fc_units=width)
    assert flops.flops_per_point(model) == all_heads
    assert flops.flops_per_point(model, flops.SUN_HEADS) == sun


def test_per_ray_work_of_the_cells():
    cfg = spec.read_json(ROOT / "benchmark/configs/flagship.json")
    assert flops.train_flops_per_ray(cfg) == 3 * 128 * (5_381_120 + 4_850_688)
    assert flops.render_flops_per_ray(cfg) == 128 * 5_381_120
