"""The port's command line (`spnerf_torch/config.py`) against the JAX
package's, exactly (no tolerance: flags, paths and dataclass fields).

* For a set of argvs (the defaults, the flagship, hash, hash on the
  (L, T, F) table, beta, fp32), `vars(args)` equals the JAX parser's apart
  from the port's `--device`, and `finalize_args(make_dirs=False)` derives
  the same paths and --lr.
* The three `*_config_from_args` give the JAX dataclasses' values on every
  field the port's dataclasses keep; the flagship argv gives
  `flagship_configs()` and `flagship_loss_config()`.
* `finalize_args` writes opts.json with the resolved values.
* The flags of the other render paths and of multi-AOI runs (--proposal,
  --occgrid, --n_importance, a comma-separated --aoi_id) are taken and
  reach the configs as the JAX package's take them; --data_axis > 1 (a
  device mesh) raises NotImplementedError naming its ROADMAP item; a
  non-empty --xla_opts raises as XLA-only.
"""

import dataclasses
import json

import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_torch import config
from spnerf_torch.utils.synth import flagship_configs, flagship_loss_config

BASE = ["--aoi_id", "JAX_269", "--project_dir", "/data/proj"]
FLAGSHIP = ["--model", "sp-nerf", "--mapping", "--guidedsample", "--sem",
            "--num_sem_classes", "3", "--sc_lambda", "0.1", "--depth",
            "--ds_lambda", "1.0", "--ss_lambda", "1.0"]
ARGVS = {
    "defaults": [],
    "flagship": FLAGSHIP + ["--exp_name", "flag", "--no_timestamp_exp_name"],
    "hash": FLAGSHIP + ["--encoding", "hash", "--hash_levels", "6",
                        "--hash_log2T", "15", "--hash_hidden", "128",
                        "--hash_table_wd", "0.1", "--img_downscale", "4"],
    "hash_lft": FLAGSHIP + ["--encoding", "hash", "--no_hash_flat_table",
                            "--no_hash_direct_coarse", "--hash_impl",
                            "sorted_vjp", "--hash_anneal_steps", "100"],
    "beta": ["--beta", "--first_beta_epoch", "3", "--t_embbeding_tau", "6",
             "--t_embbeding_vocab", "40", "--GNLL", "--usealldepth",
             "--dataset_dir", "/elsewhere/DFC", "--auto_resume"],
    "fp32": ["--precision", "fp32", "--lr", "3e-3", "--fc_units", "256",
             "--fc_layers", "6", "--n_samples", "32", "--chunk", "2048",
             "--grad_clip", "1.0", "--weight_decay", "1e-4",
             "--use_pallas", "--profile", "--seed", "4"],
    "occgrid_multi": FLAGSHIP + ["--occgrid", "--occ_res", "32",
                                 "--occ_bins", "64", "--occ_floor", "0.02",
                                 "--occ_rows", "1000", "--occ_decay", "0.7",
                                 "--aoi_id", "JAX_269,JAX_270"],
    "fine_proposal": ["--n_importance", "16", "--proposal", "--n_proposal",
                      "32", "--prop_lambda", "0.5"],
}


def parse_both(argv):
    return (config.build_train_parser().parse_args(BASE + argv),
            jconfig.build_train_parser().parse_args(BASE + argv))


def port_fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parser_and_paths_match_jax(name):
    ours, ref = parse_both(ARGVS[name])
    got = dict(vars(ours))
    assert got.pop("device") is None
    assert got == vars(ref)
    for args in (ours, ref):
        args.no_timestamp_exp_name = True  # no clock in the comparison
    config.finalize_args(ours, make_dirs=False)
    jconfig.finalize_args(ref, make_dirs=False)
    got = dict(vars(ours))
    got.pop("device")
    assert got == vars(ref)
    assert ours.lr == (1e-2 if "hash" in name else 3e-3 if name == "fp32"
                       else 5e-4)


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_configs_match_jax_on_every_kept_field(name):
    ours, ref = parse_both(ARGVS[name])
    for fn, cls in (("model_config_from_args", config.ModelConfig),
                    ("render_config_from_args", config.RenderConfig),
                    ("loss_config_from_args", config.LossConfig)):
        got = config.asdict(getattr(config, fn)(ours))
        want = jconfig.asdict(getattr(jconfig, fn)(ref))
        assert list(got) == port_fields(cls)
        assert got == {k: want[k] for k in got}, fn


def test_flagship_argv_gives_the_flagship_configs():
    args = config.build_train_parser().parse_args(BASE + FLAGSHIP)
    mc, rc = flagship_configs()
    assert config.model_config_from_args(args) == mc
    assert config.render_config_from_args(args) == rc
    assert config.loss_config_from_args(args) == flagship_loss_config()


def test_finalize_args_writes_opts_json(tmp_path):
    args = config.build_train_parser().parse_args(
        ["--aoi_id", "JAX_269", "--project_dir", str(tmp_path),
         "--encoding", "hash", "--exp_name", "e"])
    config.finalize_args(args)
    assert args.exp_name.startswith("e-")  # timestamped by default
    opts = json.loads((tmp_path / "output" / args.exp_name / "logs"
                       / "opts.json").read_text())
    assert opts["lr"] == 1e-2 and opts["device"] is None
    assert opts["ckpts_dir"] == str(tmp_path / "output" / args.exp_name
                                    / "ckpts")


@pytest.mark.parametrize("argv,item", [
    (["--proposal"], "A5"),
    (["--occgrid"], "A5"),
    (["--n_importance", "32"], "A5"),
    (["--aoi_id", "JAX_269,JAX_270"], "A5"),
    (["--data_axis", "2"], "A6"),
])
def test_unported_flags_name_their_roadmap_item(argv, item, tmp_path):
    """The paths of A5 and the device mesh of A6 are ported: their flags
    are taken, the run's files are written, and each flag reaches the
    configs (A5) or the run's rank count (A6, `cli.train.run_world`)."""
    from spnerf_torch.cli.train import run_world

    args = config.build_train_parser().parse_args(BASE + argv)
    args.project_dir = str(tmp_path)
    config.finalize_args(args)
    assert (tmp_path / "output").exists()
    mc = config.model_config_from_args(args)
    rc = config.render_config_from_args(args)
    got = {"--proposal": rc.proposal, "--occgrid": rc.occ_grid,
           "--n_importance": rc.n_importance == 32,
           "--aoi_id": mc.hash_frames == rc.occ_frames == 2,
           "--data_axis": run_world(args, torch.device("cpu")) == 2}
    assert got[argv[0]] and sum(got.values()) == 1


def test_xla_opts_is_refused_as_xla_only():
    args = config.build_train_parser().parse_args(
        BASE + ["--xla_opts", "xla_tpu_scoped_vmem_limit_kib=16384"])
    with pytest.raises(NotImplementedError, match="XLA-only"):
        config.finalize_args(args, make_dirs=False)
    args = config.build_train_parser().parse_args(
        BASE + ["--data_axis", "1", "--use_pallas"])
    config.finalize_args(args, make_dirs=False)
