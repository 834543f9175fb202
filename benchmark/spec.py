"""`BENCHMARK.json` and the files it names, found by name.

- a configuration: the file its entry names (`benchmark/configs/<name>.json`);
- a traffic mix: `benchmark/traffic/<traffic>.json`;
- a cell's correctness limits: `benchmark/limits/<workload>.json`;
- a per-layer metric's reader: `benchmark/metrics/<metric>.py`, a module
  with `read(ctx)` that returns the metric's value, or None where the run
  holds nothing to read;
- a model family: `benchmark/families/<family>.py`, named by the
  configuration's "family" ("siren" where it names none), the module that
  makes the family's weights, drives its program, computes its reference
  and counts its operations (see `families/siren.py`).

A new configuration, model family, traffic mix, cell or metric is a new
file and a new entry in `BENCHMARK.json`; nothing here changes.
"""

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_FAMILY = "siren"


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it runs from."""

    name: str
    chips: int
    config: dict  # the configuration file, parsed
    traffic: dict  # the traffic mix file, parsed
    limits: dict  # number compared -> its limit
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # metric entries this cell reports with --trace 1
    family: ModuleType  # the configuration's model family (families/)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def reports(metric, cell_name):
    """Whether a metric entry is reported in cell `cell_name` by its own
    `workloads` key (None: the key is absent)."""
    listed = metric.get("workloads")
    return None if listed is None else cell_name in listed


def load_cell(name, bench_file=ROOT / "BENCHMARK.json", bench_dir=HERE):
    """The Cell of workload `name`; KeyError where BENCHMARK.json has none."""
    bench = read_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(bench_file.parent / configs[w["config"]]["file"])
    traffic = read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = read_json(bench_dir / "limits" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if reports(m, name) is not False]
    e2e_names = {m["name"] for m in e2e}
    per_layer = []
    for m in bench["per_layer"]:
        listed = reports(m, name)
        if listed or (listed is None and m["moves"] in e2e_names):
            per_layer.append(m)
    family = load_family(config.get("family", DEFAULT_FAMILY), bench_dir)
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer,
                family)


def load_module(path, prefix, name):
    """The module of file `path`, loaded by file under a name of its own."""
    mod_name = prefix + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric_name, bench_dir=HERE):
    """The `read(ctx)` function of a per-layer metric's own file."""
    return load_module(bench_dir / "metrics" / f"{metric_name}.py",
                       "benchmark_metric_", metric_name).read


def load_family(name, bench_dir=HERE):
    """The module of model family `name`, from its own file."""
    path = bench_dir / "families" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no model family {name!r}: {path} does not "
                                f"exist")
    return load_module(path, "benchmark_family_", name)
