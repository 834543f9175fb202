"""The port's `CheckpointManager` (`spnerf_torch/train/checkpoints.py`)
against the JAX package's orbax manager, and `convert.load_jax_train_state`
against the JAX Trainer, on the CPU.

* A save and restore round trip of the field, the transient embedding, the
  optimizer (`torch.optim.Adam` and `AdamChain`) and the step, bit for bit,
  into a state drawn from another seed.
* For the same sequence of saves (a -inf val_psnr, a tie, a later best),
  `best_step`, `latest_step` and `all_steps` equal the orbax manager's.
* Saving a step that exists raises; restoring into another width raises
  RuntimeError with the advice to pass the original flags.
* The JAX Trainer takes 3 steps on a fixed batch with the deterministic
  render; its state (weights, Adam or the optax chain of `grad_clip`, step)
  is carried across; then both take 2 more steps and their losses agree
  within 1e-4 relative (the trajectory bar of tests/test_torch_train.py).
  The same with the fine field and the proposal field, and with the
  occupancy grid, whose moments and grid are carried too.
* The fine field, the proposal field and the grid round trip bit for bit;
  a checkpoint of the layout without them restores into a run without
  them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.train.checkpoints import CheckpointManager as JaxManager
from spnerf_tpu.train.loop import Trainer as JaxTrainer
from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
from spnerf_torch.convert import field_state_dict, load_jax_train_state
from spnerf_torch.train.checkpoints import (CheckpointManager,
                                            StepAlreadyExistsError)
from spnerf_torch.train.loop import AdamChain, Trainer
from spnerf_torch.utils.synth import fake_batch

MC = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=32,
          fc_layers=4, skips=(2,))
RC = dict(n_samples=8, guidedsample=True, solar_correction=True, sem=True)
LC = dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0, sem=True,
          ss_lambda=1.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 command runs six test processes on
    the machine's cores, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trainer(beta=False, fc_units=32, **opts):
    return Trainer(ModelConfig(**{**MC, "beta": beta, "fc_units": fc_units}),
                   RenderConfig(**{**RC, "beta": beta}), LossConfig(**LC),
                   lr=1e-2, steps_per_epoch=3, device="cpu", **opts)


def trained_state(tr, steps=2):
    state = tr.init_state(torch.Generator().manual_seed(0))
    data = tr.to_device(fake_batch(np.random.default_rng(0), 256))
    tr.train_steps(state, data, steps, batch_size=32)
    return state


def tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.t_embed is not None:
        out.update({f"t.{k}": v for k, v in state.t_embed.state_dict().items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("opts", [{}, {"grad_clip": 1e-3, "table_wd": 0.1}],
                         ids=["adam", "adam_chain"])
def test_round_trip_is_bit_exact(tmp_path, opts):
    tr = trainer(beta=True, **opts)
    state = trained_state(tr)
    assert isinstance(state.optimizer, AdamChain) == bool(opts)
    mgr = CheckpointManager(tmp_path / "ckpts")
    mgr.save(state.step, state, metrics={"val_psnr": 12.5})
    other = tr.init_state(torch.Generator().manual_seed(7))
    assert other.step == 0
    assert mgr.restore(other) is other
    a, b = tensors(state), tensors(other)
    assert set(a) == set(b) and len(a) > 10
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert other.step == state.step == 2
    if opts:
        assert other.optimizer.count == state.optimizer.count == 2
    assert mgr.metrics(2) == {"val_psnr": 12.5}
    # the restored state steps on exactly as the saved one does
    data = tr.to_device(fake_batch(np.random.default_rng(1), 256))
    la = tr.train_step(state, data, 32)["loss"]
    lb = tr.train_step(other, data, 32)["loss"]
    assert torch.equal(la, lb)


SAVES = [(2, 10.0), (4, float("-inf")), (6, 12.0), (8, 12.0), (10, 11.0)]


def test_best_latest_and_all_steps_match_orbax(tmp_path):
    tr = trainer()
    state = tr.init_state(torch.Generator().manual_seed(0))
    ours = CheckpointManager(tmp_path / "port")
    ref = JaxManager(str(tmp_path / "jax"))
    assert ours.latest_step() is ours.best_step() is None
    assert ref.latest_step() is ref.best_step() is None
    tree = {"w": np.zeros(3, np.float32), "step": np.int32(0)}
    for i, (step, v) in enumerate(SAVES):
        state.step = step
        ours.save(step, state, metrics={"val_psnr": v})
        ref.save(step, tree, metrics={"val_psnr": v})
        assert ours.all_steps() == list(ref.all_steps())
        assert ours.latest_step() == ref.latest_step() == step
        assert ours.best_step() == ref.best_step(), SAVES[:i + 1]
    assert ours.best_step() == 8
    ref.close()


def test_resaving_a_step_raises(tmp_path):
    tr = trainer()
    state = tr.init_state(torch.Generator().manual_seed(0))
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, state)
    with pytest.raises(StepAlreadyExistsError):
        mgr.save(3, state, metrics={"val_psnr": 1.0})
    assert mgr.all_steps() == [3] and mgr.best_step() is None
    assert mgr.restore(state, step=5) is None


@pytest.mark.parametrize("other", [{"fc_units": 48}, {"grad_clip": 1.0},
                                   {"beta": True}],
                         ids=["width", "optimizer", "beta"])
def test_restore_into_another_architecture_raises(tmp_path, other):
    state = trainer().init_state(torch.Generator().manual_seed(0))
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)
    target = trainer(**other).init_state(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="opts.json"):
        mgr.restore(target)


@pytest.mark.parametrize("opts", [{}, {"grad_clip": 1e-5}],
                         ids=["adam", "adam_chain"])
def test_jax_state_carried_across_continues_its_trajectory(opts):
    jtr = JaxTrainer(jconfig.ModelConfig(**MC), jconfig.RenderConfig(**RC),
                     jconfig.LossConfig(**LC), lr=1e-2, steps_per_epoch=3,
                     **opts)
    b = fake_batch(np.random.default_rng(0), 64)
    b["sems"][:4] = -100
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    params = jtr.init_state(jax.random.PRNGKey(0)).params
    opt = jtr.tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))
    jlosses = []
    for step in range(5):
        if step == 3:
            tr = trainer(**opts)
            state = tr.init_state(torch.Generator().manual_seed(5))
            load_jax_train_state(state, jax.device_get(params),
                                 jax.device_get(opt), 3)
            assert state.step == 3
            for k, v in field_state_dict(jax.device_get(params["coarse"])
                                         ).items():
                assert torch.equal(state.model.state_dict()[k], v), k
        (jloss, _), g = grad_fn(params, jb, None, jnp.int32(step))
        updates, opt = jtr.tx.update(g, opt, params)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(jloss))
    tlosses = []
    for _ in range(2):
        loss, _ = tr.loss_fn(state, tb, state.step)
        tr.apply_gradients(state, loss)
        tlosses.append(loss.item())
    assert state.step == 5
    np.testing.assert_allclose(tlosses, jlosses[3:], rtol=1e-4)


OTHER_PATHS = {"occ": dict(occ_grid=True, occ_res=8),
               "fine_proposal": dict(n_importance=8, proposal=True,
                                     n_proposal=8)}


def path_trainer(path, **opts):
    return Trainer(ModelConfig(**MC), RenderConfig(**RC, **OTHER_PATHS[path]),
                   LossConfig(**LC), lr=1e-2, steps_per_epoch=3,
                   occ_rows=128, device="cpu", **opts)


def all_tensors(state):
    out = {f"param.{k}": v for k, v in state.named_parameters()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    if state.occ is not None:
        out["occ"] = state.occ
    return out


@pytest.mark.parametrize("path", sorted(OTHER_PATHS))
def test_round_trip_with_the_other_paths(tmp_path, path):
    """The fine field, the proposal field and the occupancy grid come back
    bit for bit, and the restored state steps on as the saved one does."""
    tr = path_trainer(path)
    state = trained_state(tr)
    assert (state.occ is not None) == (path == "occ")
    mgr = CheckpointManager(tmp_path)
    mgr.save(state.step, state)
    other = tr.init_state(torch.Generator().manual_seed(7))
    mgr.restore(other)
    a, b = all_tensors(state), all_tensors(other)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    data = tr.to_device(fake_batch(np.random.default_rng(1), 256))
    assert torch.equal(tr.train_step(state, data, 32)["loss"],
                       tr.train_step(other, data, 32)["loss"])
    if state.occ is not None:
        assert torch.equal(state.occ, other.occ)
    # a run without the module or the grid refuses the checkpoint
    with pytest.raises(RuntimeError, match="opts.json"):
        mgr.restore(trainer().init_state(torch.Generator().manual_seed(0)))


def test_restores_a_checkpoint_without_the_other_paths(tmp_path):
    """A `state.pt` of the layout written before the fine field, the
    proposal field and the grid were ported (no such keys) restores into
    a run without them, and is refused by a run with the grid."""
    tr = trainer()
    state = trained_state(tr)
    path = tmp_path / "2"
    path.mkdir()
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "t_embed": None, "optimizer": state.optimizer.state_dict(),
                "optimizer_class": "Adam"}, path / "state.pt")
    mgr = CheckpointManager(tmp_path)
    other = tr.init_state(torch.Generator().manual_seed(7))
    assert mgr.restore(other) is other and other.step == 2
    a, b = tensors(state), tensors(other)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(RuntimeError, match="occupancy grid"):
        mgr.restore(path_trainer("occ").init_state(
            torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("path", sorted(OTHER_PATHS))
def test_jax_state_with_the_other_paths_carried_across(path):
    """The JAX Trainer's state with its fine field, proposal field, grid
    and their Adam moments, carried across at step 3; 2 more steps of both
    agree within 1e-4 relative."""
    rc = dict(RC, **OTHER_PATHS[path])
    jtr = JaxTrainer(jconfig.ModelConfig(**MC), jconfig.RenderConfig(**rc),
                     jconfig.LossConfig(**LC), lr=1e-2, steps_per_epoch=3,
                     occ_rows=128)
    b = fake_batch(np.random.default_rng(0), 64)
    b["sems"][:4] = -100
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    params, occ = jstate.params, jstate.occ
    if occ is not None:
        occ = jnp.asarray(np.random.default_rng(2).uniform(
            0, 5, occ.shape).astype(np.float32))
    opt = jtr.tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))
    jlosses = []
    for step in range(5):
        if step == 3:
            tr = path_trainer(path)
            state = tr.init_state(torch.Generator().manual_seed(5))
            load_jax_train_state(state, jax.device_get(params),
                                 jax.device_get(opt), 3,
                                 occ=None if occ is None
                                 else jax.device_get(occ))
            assert state.step == 3
            for key, module in (("coarse", state.model),
                                ("fine", state.fine),
                                ("proposal", state.proposal)):
                if key not in params:
                    assert module is None
                    continue
                for k, v in field_state_dict(jax.device_get(params[key])
                                             ).items():
                    assert torch.equal(module.state_dict()[k], v), (key, k)
            if occ is not None:
                assert torch.equal(state.occ, torch.from_numpy(
                    np.asarray(occ)))
        (jloss, _), g = grad_fn(params, jb, None, jnp.int32(step), occ)
        updates, opt = jtr.tx.update(g, opt, params)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(jloss))
    tlosses = []
    for _ in range(2):
        loss, _ = tr.loss_fn(state, tb, state.step)
        tr.apply_gradients(state, loss)
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses[3:], rtol=1e-4)
