"""Multi-AOI frames in the port against the JAX package, on the CPU: the
hash encoding and field at 2 frames, `load_scenes`, and `run_validation`
on two AOIs side by side.

* Hash encoding at 2 frames, both table layouts: output and table gradient
  within 1e-5 (`tests/test_torch_hashgrid.py`'s bar), on points in both
  frames, between them and beyond the last. (4, 2, 2^14): level 0 direct
  with t_eff 16,384 (8,192 at one frame); (3, 4, 2^13): level 0 direct at
  one frame and hashed at two (17^3 * 2 > 2^13), the frame XORed into the
  hash. The hash field at 2 frames within 2e-5.
* `load_scenes` on two synthetic AOIs (40 x 36 px, written to disk under
  the DFC2019 naming): rays within 1e-6, transient ids and validation `t`
  exact, the second AOI's rays translated by FRAME_SPACING.
* `run_validation` on the two AOIs: with the same rendered outputs in both
  packages (the JAX render handed to the port), each AOI's MAE, in its own
  frame against its own truth, within 1e-6 m, PSNR within 1e-5 dB and SSIM
  within 1e-6 (float32 metrics of the same images);
  then with the port's own render, within `tests/test_torch_validate.py`'s
  bars (PSNR 1e-3 dB, SSIM 1e-4, MAE 0.05 m).
"""

import argparse
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.cli import train as jcli
from spnerf_tpu.config import ModelConfig as JaxModelConfig
from spnerf_tpu.data.multi import load_scenes as jax_load_scenes
from spnerf_tpu.models import HashGridEncoding as JaxEncoding
from spnerf_tpu.models import load_model as jax_load_model
from spnerf_tpu.train.loop import Trainer as JaxTrainer
from spnerf_tpu.utils.logging import MetricLogger as JaxMetricLogger
from spnerf_torch.cli import train as tcli
from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
from spnerf_torch.convert import field_state_dict
from spnerf_torch.data import FRAME_SPACING, load_scenes
from spnerf_torch.models import HashSPNeRF
from spnerf_torch.models.hashgrid import HashGridEncoding
from spnerf_torch.train.loop import Trainer
from spnerf_torch.utils.logging import MetricLogger
from spnerf_torch.utils.synth_scene import write_synthetic_aoi

AOIS = ("JAX_269", "JAX_270")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 command runs six test processes on
    the machine's cores, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame_points(rng, n, frames=2):
    """Points in both frames' boxes (partly outside), between the frames
    and beyond the last."""
    xyz = rng.uniform(-1.2, 1.2, size=(n, 3)).astype(np.float32)
    xyz[:, 0] += FRAME_SPACING * rng.integers(0, frames, n)
    xyz[: n // 10, 0] = 1.5
    xyz[n // 10: n // 5, 0] = FRAME_SPACING * frames + 0.4
    xyz[n // 5: n // 4] = np.array([4.0, 1.0, 1.0], np.float32)
    return xyz


@pytest.mark.parametrize("flat_table", [True, False])
@pytest.mark.parametrize("L,F,log2T,sizes", [
    (4, 2, 14, [16384] + [2 ** 14] * 3),
    (3, 4, 13, [2 ** 13] * 3)])
def test_encoding_two_frames_matches_jax(rng, L, F, log2T, sizes,
                                         flat_table):
    jenc = JaxEncoding(n_levels=L, n_features=F, log2_table_size=log2T,
                       impl="xla", frames=2, flat_table=flat_table)
    params = jenc.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)))
    table = (rng.normal(size=params["params"]["table"].shape) * 0.5
             ).astype(np.float32)
    params = {"params": {"table": jnp.asarray(table)}}
    tenc = HashGridEncoding(n_levels=L, n_features=F, log2_table_size=log2T,
                            flat_table=flat_table, frames=2)
    with torch.no_grad():
        tenc.table.copy_(torch.from_numpy(table))
    assert tenc.level_table_sizes() == sizes
    xyz = frame_points(rng, 800)
    w = rng.normal(size=(800, L * F)).astype(np.float32)

    def jloss(p):
        out = jenc.apply(p, jnp.asarray(xyz))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), g = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tenc(torch.from_numpy(xyz))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    gref = np.asarray(g["params"]["table"])
    assert np.abs(gref).max() > 1.0
    np.testing.assert_allclose(tenc.table.grad.numpy(), gref, atol=1e-5,
                               rtol=1e-6)
    # the frames are not one another's copies
    one = HashGridEncoding(n_levels=L, n_features=F, log2_table_size=log2T,
                           flat_table=flat_table, frames=1)
    with torch.no_grad():
        one.table.copy_(torch.from_numpy(table))
        far = torch.from_numpy(xyz[xyz[:, 0] > 2.0])
        shifted = far - torch.tensor([FRAME_SPACING, 0.0, 0.0])
        assert (tenc(far) - one(shifted)).abs().max() > 1e-2


@pytest.mark.parametrize("flat_table", [True, False])
def test_hash_field_two_frames_matches_jax(rng, flat_table):
    kw = dict(encoding="hash", hash_levels=4, hash_features=2, hash_log2T=14,
              hash_hidden=32, hash_flat_table=flat_table, sem=True,
              num_sem_classes=3, hash_frames=2)
    jmodel = jax_load_model(JaxModelConfig(**kw), hash_impl="xla")
    params = dict(jmodel.init(jax.random.PRNGKey(1), jnp.zeros((2, 3)),
                              jnp.zeros((2, 3)), None,
                              jnp.zeros((2,), jnp.int32))["params"])
    params["HashGridEncoding_0"] = {"table": jnp.asarray(
        rng.normal(size=params["HashGridEncoding_0"]["table"].shape)
        .astype(np.float32) * 0.5)}
    tmodel = HashSPNeRF(ModelConfig(**kw))
    assert tmodel.encoding.frames == 2
    tmodel.load_state_dict(field_state_dict(params))
    n = 400
    xyz = frame_points(rng, n)
    sun = rng.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    sems = rng.integers(0, 3, n).astype(np.int32)
    ref = jmodel.apply({"params": params}, jnp.asarray(xyz),
                       jnp.asarray(sun), None, jnp.asarray(sems))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(xyz), torch.from_numpy(sun), None,
                     torch.from_numpy(sems))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-5, rtol=0, err_msg=k)


MC = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=32,
          fc_layers=8, skips=(4,))
RC = dict(n_samples=8, guidedsample=True, solar_correction=True, sem=True,
          compute_dtype="float32")
LC = dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0, sem=True,
          ss_lambda=1.0)


def cli_args(root):
    """The CLI's namespace for a run over both AOIs under `root`."""
    return argparse.Namespace(
        aoi_id=",".join(AOIS), project_dir=str(root), dataset_dir=None,
        gt_dir=str(root / "unused"), chunk=1024, sem=True, num_sem_classes=3,
        logs_dir=str(root / "logs"))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two AOIs written under each package's own project (the first load
    writes scene.loc) and loaded by each package's `load_scenes`."""
    root = tmp_path_factory.mktemp("multi")
    for i, aoi in enumerate(AOIS):
        write_synthetic_aoi(
            str(root / "port" / "dataset" / f"DFC2019_{aoi.split('_')[1]}"),
            aoi_id=aoi, width=40, height=36, roi_size=24, seed=5 + i)
    shutil.copytree(root / "port", root / "jax")
    out = {}
    kw = dict(sem=True, num_sem_classes=3, verbose=False)
    for pkg, loader, dirs in (("port", load_scenes, tcli._aoi_dirs),
                              ("jax", jax_load_scenes, jcli._aoi_dirs)):
        args = cli_args(root / pkg)
        out[pkg] = dict(args=args, scene=loader(
            list(AOIS), lambda a, d=dirs, g=args: d(g, a), **kw))
    return out


def test_aoi_dirs_match_jax(tmp_path):
    for aoi_id, aoi in ((",".join(AOIS), AOIS[1]), ("JAX_269", "JAX_269")):
        args = argparse.Namespace(
            aoi_id=aoi_id, project_dir=str(tmp_path), dataset_dir=None,
            json_dir="j", img_dir="i", depth_dir="d", sem_dir="s",
            gt_dir="g")
        assert tcli._aoi_dirs(args, aoi) == jcli._aoi_dirs(args, aoi)
        args.dataset_dir = str(tmp_path / "{aoi}")
        assert tcli._aoi_dirs(args, aoi) == jcli._aoi_dirs(args, aoi)


def test_load_scenes_matches_jax(scenes):
    ms, jms = scenes["port"]["scene"], scenes["jax"]["scene"]
    assert ms.aoi_ids == jms.aoi_ids == list(AOIS) and len(ms) == len(jms)
    np.testing.assert_allclose(ms.rays, jms.rays, rtol=0, atol=1e-6)
    for name in ("ids", "sems", "valid_depth", "valid_sem"):
        np.testing.assert_array_equal(getattr(ms, name), getattr(jms, name),
                                      err_msg=name)
    for name in ("rgbs", "depths", "depth_std"):
        np.testing.assert_allclose(getattr(ms, name), getattr(jms, name),
                                   rtol=0, atol=1e-6, err_msg=name)
    items = list(ms.validation_items())
    jitems = list(jms.validation_items())
    assert ([(a, r.img_id, r.t) for a, _, r in items]
            == [(a, r.img_id, r.t) for a, _, r in jitems])
    # ids are unique across the AOIs; the second AOI's rays lie in frame 1
    n0 = len(ms.scenes[0])
    assert ms.ids[n0:].min() > ms.ids[:n0].max()
    assert np.all(np.round(ms.rays[n0:, 0] / FRAME_SPACING) == 1)
    assert np.all(np.round(ms.rays[:n0, 0] / FRAME_SPACING) == 0)
    assert tcli._scene_t_vocab(ms) == jcli._scene_t_vocab(jms)


def rows(args):
    with open(os.path.join(args.logs_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def validated(scenes):
    jtr = JaxTrainer(jconfig.ModelConfig(**MC), jconfig.RenderConfig(**RC),
                     jconfig.LossConfig(**LC), lr=5e-4, steps_per_epoch=3,
                     t_vocab=12)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    ttr = Trainer(ModelConfig(**MC), RenderConfig(**RC), LossConfig(**LC),
                  lr=5e-4, steps_per_epoch=3, t_vocab=12, device="cpu")
    state = ttr.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(field_state_dict(jstate.params["coarse"]))
    jargs = scenes["jax"]["args"]
    log = JaxMetricLogger(jargs.logs_dir, tensorboard=False)
    jcli.run_validation(jtr, scenes["jax"]["scene"], jstate, jargs, 1, log,
                        False)
    log.close()
    return jtr, jstate, ttr, state


def run_port(scenes, validated, logs_dir, shared_render):
    jtr, jstate, ttr, state = validated
    args = argparse.Namespace(**{**vars(scenes["port"]["args"]),
                                 "logs_dir": logs_dir})
    real = tcli.build_render_fn
    if shared_render:
        jrender = jtr.build_render_fn(chunk=1024)
        params = jax.device_get(jstate.params)

        def build(*a, **kw):
            def render(rays, t, sems=None, occ=None):
                out = jrender(params, np.asarray(rays), t, sems)
                return {k: torch.from_numpy(np.array(v))
                        for k, v in out.items()}
            return render

        tcli.build_render_fn = build
    try:
        log = MetricLogger(logs_dir, tensorboard=False)
        tcli.run_validation(ttr, scenes["port"]["scene"], state, args, 1,
                            log, False)
        log.close()
    finally:
        tcli.build_render_fn = real
    return rows(args), rows(scenes["jax"]["args"])


@pytest.mark.parametrize("shared_render", [True, False])
def test_multi_aoi_validation_matches_jax(scenes, validated, tmp_path,
                                          shared_render):
    """Per AOI: each view's MAE from its own frame and its own truth."""
    ours, ref = run_port(scenes, validated, str(tmp_path / "logs"),
                         shared_render)
    # only the first view of the run is the train-debug view
    splits = [f"train_{AOIS[0]}_000_RGB", f"val_{AOIS[0]}_003_RGB",
              f"val_{AOIS[1]}_000_RGB", f"val_{AOIS[1]}_003_RGB", "val"]
    assert [r["split"] for r in ours] == [r["split"] for r in ref] == splits
    tol = (dict(psnr=1e-5, ssim=1e-6, mae=1e-6) if shared_render
           else dict(psnr=1e-3, ssim=1e-4, mae=0.05))
    for a, b in zip(ours, ref):
        for k, bound in tol.items():
            assert np.isfinite(a[k]) and np.isfinite(b[k]), (a, b)
            assert abs(a[k] - b[k]) <= bound, (a["split"], k, a[k], b[k])
    # the two AOIs are scored apart: their truths differ
    assert ours[1]["mae"] != ours[3]["mae"]
