"""The JAX package's environment switches in the port
(`spnerf_torch/switches.py`).

* Each switch that changes what the JAX package computes (bfloat16 table
  gathers and cotangents, a dropped table-gradient tail, the t-major flat
  table, the one-hot matmul bin lookup) is refused with a message naming it
  where the port would read it: the hash encoding's forward (the field's
  and the proposal's) and `sample_pdf`. Set to its other values, the
  output equals the unset run bit for bit.
* README's switch table names every SPNERF_* switch that `spnerf_tpu`
  reads.
"""

import os
import re

import pytest
import torch

from spnerf_torch.models.hashgrid import HashGridEncoding
from spnerf_torch.ops.sampling import sample_pdf
from spnerf_torch.switches import HASH_SWITCHES, REFUSED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANGING = {"SPNERF_HASH_BF16_GATHER": {"1"}, "SPNERF_HASH_BF16_E2E": {"1"},
            "SPNERF_HASH_SW_BF16SORT": {"1"}, "SPNERF_HASH_SW_TAIL": {"0"},
            "SPNERF_HASH_FMAJOR": {"0"}, "SPNERF_HASH_MATMUL_PALLAS": {"0"},
            "SPNERF_PDF_LOOKUP": {"matmul"}}
HARMLESS = {"SPNERF_HASH_BF16_GATHER": "0", "SPNERF_HASH_BF16_E2E": "0",
            "SPNERF_HASH_SW_BF16SORT": "0", "SPNERF_HASH_SW_TAIL": "1",
            "SPNERF_HASH_FMAJOR": "1", "SPNERF_PDF_LOOKUP": "reduce"}


def run(name):
    """The output of the code that reads `name`, on fixed inputs."""
    g = torch.Generator().manual_seed(0)
    if name in HASH_SWITCHES:
        enc = HashGridEncoding(n_levels=2, n_features=2, log2_table_size=8,
                               generator=g)
        return enc(torch.rand(50, 3, generator=g) * 2 - 1)
    bins = torch.sort(torch.rand(7, 9, generator=g), dim=-1).values
    return sample_pdf(bins, torch.rand(7, 8, generator=g), 5,
                      u=torch.rand(7, 5, generator=g))


def test_the_refused_switches_are_the_changing_ones():
    assert set(REFUSED) == set(CHANGING)


@pytest.mark.parametrize("name", sorted(CHANGING))
def test_changing_switch_is_refused(name, monkeypatch):
    ref = run(name)
    for value in CHANGING[name]:
        monkeypatch.setenv(name, value)
        with pytest.raises(ValueError, match=f"{name}={value}"):
            run(name)
    if name in HARMLESS:
        monkeypatch.setenv(name, HARMLESS[name])
        assert torch.equal(run(name), ref)
    monkeypatch.delenv(name)
    assert torch.equal(run(name), ref)


def test_matmul_pallas_off_with_float32_cotangents_is_taken(monkeypatch):
    ref = run("SPNERF_HASH_MATMUL_PALLAS")
    monkeypatch.setenv("SPNERF_HASH_MATMUL_PALLAS", "0")
    monkeypatch.setenv("SPNERF_HASH_MATMUL_F32", "1")
    assert torch.equal(run("SPNERF_HASH_MATMUL_PALLAS"), ref)


def test_readme_classifies_every_switch_of_the_jax_package():
    names = set()
    for dirpath, _, files in os.walk(os.path.join(ROOT, "spnerf_tpu")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    names |= set(re.findall(r"SPNERF_[A-Z0-9_]*[A-Z0-9]",
                                            fh.read()))
    with open(os.path.join(ROOT, "README.md")) as f:
        rows = {m for line in f if line.startswith("| `SPNERF_")
                for m in re.findall(r"`(SPNERF_[A-Z0-9_]+)`",
                                    line.split("|")[1])}
    assert len(names) > 30
    assert names <= rows, sorted(names - rows)
    assert set(REFUSED) <= rows
