"""`dryrun_torch.py`, the port's twin of `__graft_entry__.py`, on the CPU.

* `entry(device="cpu")`: the flagship forward on 256 rays; with the JAX
  entry's weights (converted) and the same rays its colours equal the JAX
  entry's within 2e-2, the bf16 bar of `tests/test_torch_field_eval.py`
  (both render in bfloat16, the deterministic render; 2.9e-3 measured).
* `dryrun_multichip(2)` in `tests/test_torch_ranks.py`'s Gloo harness: the
  eight programs of the JAX dry run (flagship window, sharded eval render,
  hash step, grid window, beta step, beta + fine window, proposal step,
  dual-frame hash step) each give a finite loss (the render finite
  colours), and the two ranks' parameters (the render's colours) are equal
  bit for bit.
* Given a mesh of another world size, it refuses.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import dryrun_torch
from spnerf_torch.convert import field_state_dict

from test_torch_ranks import run_ranks


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_the_jax_entry():
    fn, (model, rays, sems) = dryrun_torch.entry(device="cpu")
    jfn, (params, jrays, jsems) = jax_entry.entry()
    ref = np.asarray(jax.jit(jfn)(params, jrays, jsems))
    np.testing.assert_array_equal(rays.numpy(), np.asarray(jrays))
    out = fn(model, rays, sems)
    assert tuple(out.shape) == (256, 3) and torch.isfinite(out).all()
    model.load_state_dict(field_state_dict(params["coarse"]))
    out = fn(model, rays, sems)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-2)


def test_dryrun_multichip_over_two_ranks(tmp_path):
    ranks = run_ranks("dryrun", 2, {}, tmp_path)
    assert [r["program"] for r in ranks[0]] == list(dryrun_torch.PROGRAMS)
    for a, b in zip(*ranks):
        assert a["program"] == b["program"]
        if a["program"] == "sharded eval render":
            assert a["loss"] is None and a["params"].shape == (300, 3)
        else:
            assert np.isfinite(a["loss"]) and a["loss"] == b["loss"]
        assert torch.isfinite(a["params"]).all()
        assert torch.equal(a["params"], b["params"]), a["program"]


def test_dryrun_multichip_refuses_a_mismatched_mesh():
    from spnerf_torch.parallel import DataMesh

    mesh = DataMesh(rank=0, world=1, group=None, backend="gloo",
                    device=torch.device("cpu"))
    with pytest.raises(ValueError, match="1 ranks, not 2"):
        dryrun_torch.dryrun_multichip(2, mesh=mesh)
