"""Configuration: the training command line, its derived paths, the static
configuration of the field, the renderer and the losses, and the DFC2019
class tables.

`build_train_parser` has every flag of the JAX package's parser
(`spnerf_tpu/config.py`), with its default, plus `--device`, which picks
the card (the JAX package picks its backend by `JAX_PLATFORMS`).
`finalize_args` derives the same directory layout and `opts.json`; it
raises NotImplementedError for the XLA-only `--xla_opts`. The frozen dataclasses hold the fields
of the JAX package's `ModelConfig`, `RenderConfig` and `LossConfig` that the
port reads, under the same names and defaults (`LossConfig.margin` and
`stdscale` are read by the depth loaders); the `*_config_from_args`
functions fill those fields as the JAX package's do. `SEMANTIC_CONFIG` and
`IGNORE_LABEL` are the JAX package's DFC2019 class tables.
"""

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass
from datetime import datetime
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the SP-NeRF field."""

    fc_layers: int = 8
    fc_units: int = 512
    skips: Tuple[int, ...] = (4,)
    mapping: bool = False
    mapping_sizes: Tuple[int, int] = (10, 4)
    siren: bool = True
    num_sem_classes: int = 5
    s_embedding_factor: int = 1
    t_embedding_dims: int = 4
    beta: bool = False
    sem: bool = False
    encoding: str = "siren"  # "siren" (SP-NeRF flagship) | "hash" (NGP-style)
    # hash-grid geometry (encoding="hash" only)
    hash_levels: int = 8
    hash_features: int = 4
    hash_log2T: int = 19
    hash_hidden: int = 64  # width of the hash trunk and head MLPs
    hash_frames: int = 1  # disjoint multi-AOI frames (data/multi.py)
    # levels whose dense grid fits the table index it directly
    hash_direct_coarse: bool = True
    # "auto" | "xla" | "sorted_vjp" | "matmul_vjp" | "fused_vjp": the JAX
    # package's lookup implementations. In the port every impl computes the
    # same function; the impl only decides the table's layout (below)
    hash_impl: str = "auto"
    # each level's table is one flat feature-major row, row[f * T + t], when
    # this is set and the impl is "auto", "xla" or "matmul_vjp"; else the
    # table is (L, T, F) (--no_hash_flat_table, older checkpoints)
    hash_flat_table: bool = True
    # coarse-to-fine level annealing over the first N steps; 0 = off
    hash_anneal_steps: int = 0


@dataclass(frozen=True)
class RenderConfig:
    """Rendering parameters."""

    n_samples: int = 64
    n_importance: int = 0
    guidedsample: bool = False
    solar_correction: bool = False  # derived from sc_lambda > 0
    beta: bool = False
    sem: bool = False
    perturb: float = 1.0
    compute_dtype: str = "float32"  # "bfloat16" for the flagship
    proposal: bool = False  # density-only proposal sampler
    n_proposal: int = 64  # proposal samples per ray
    # occupancy-grid guided coarse sampling (--occgrid, ops/occgrid.py);
    # mutually exclusive with proposal
    occ_grid: bool = False
    occ_res: int = 64  # grid resolution per axis (res^3 cells per frame)
    occ_bins: int = 128  # per-ray depth bins weighted by the grid
    occ_floor: float = 0.01  # uniform exploration floor per bin
    occ_frames: int = 1  # multi-AOI: one res^3 block per translated frame


@dataclass(frozen=True)
class LossConfig:
    """Loss parameters."""

    sc_lambda: float = 0.0
    beta: bool = False
    ds_lambda: float = 0.0
    depth: bool = False
    gnll: bool = False
    usealldepth: bool = False
    margin: float = 0.0001
    stdscale: float = 1.0
    sem: bool = False
    ss_lambda: float = 4e-2
    first_beta_epoch: int = 2
    prop_lambda: float = 1.0  # proposal interlevel loss weight


# DFC2019 class ids (2 ground, 5 trees, 6 buildings, 9 water, 17 bridges) and
# the port's class indices, per number of semantic classes
SEMANTIC_CONFIG = {
    3: {
        "color_mapping": {0: [0, 255, 0], 1: [255, 0, 0], 2: [0, 0, 255]},
        "class_mapping": {0: 2, 1: 6, 2: 9},
        "semantic_names": {0: "Ground", 1: "Buildings", 2: "Water"},
        "label_mapping": {2: 0, 6: 1, 9: 2},
    },
    4: {
        "color_mapping": {0: [0, 255, 0], 1: [0, 128, 0], 2: [255, 0, 0],
                          3: [0, 0, 255]},
        "class_mapping": {0: 2, 1: 5, 2: 6, 3: 9},
        "semantic_names": {0: "Ground", 1: "Trees", 2: "Buildings",
                           3: "Water"},
        "label_mapping": {2: 0, 5: 1, 6: 2, 9: 3},
    },
    5: {
        "color_mapping": {
            0: [0, 255, 0],
            1: [0, 128, 0],
            2: [255, 0, 0],
            3: [0, 0, 255],
            4: [255, 255, 0],
        },
        "class_mapping": {0: 2, 1: 5, 2: 6, 3: 9, 4: 17},
        "semantic_names": {
            0: "Ground",
            1: "Trees",
            2: "Buildings",
            3: "Water",
            4: "Bridge/Elevated Road",
        },
        "label_mapping": {2: 0, 5: 1, 6: 2, 9: 3, 17: 4},
    },
}

IGNORE_LABEL = -100


def build_train_parser():
    """The training command line: the JAX package's flags, with their
    defaults, plus --device."""
    p = argparse.ArgumentParser(description="Train SP-NeRF (PyTorch/CUDA)")
    # input / output paths
    p.add_argument("--project_dir", type=str, required=True)
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="resume from the newest checkpoint under this "
                        "checkpoint directory")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from this experiment's newest checkpoint if "
                        "one exists (--ckpt_path takes precedence)")
    p.add_argument("--watchdog", type=int, default=0,
                   help="seconds of training silence (no metrics.jsonl "
                        "progress) after which the run is killed and "
                        "relaunched with --auto_resume; 0 disables. The "
                        "start-up (imports, data load, first window) gets "
                        "three times as long")
    p.add_argument("--watchdog_max_restarts", type=int, default=20,
                   help="give up after this many watchdog relaunches")
    p.add_argument("--dataset_name", type=str, default="DFC2019_269",
                   help="dataset directory name under <project_dir>/dataset")
    p.add_argument("--dataset_dir", type=str, default=None,
                   help="explicit dataset dir (overrides --dataset_name)")
    # basic
    p.add_argument("--aoi_id", type=str, required=True)
    p.add_argument("--model", type=str, default="sp-nerf")
    p.add_argument("--exp_name", type=str, default=None)
    p.add_argument("--gpu_id", type=int, default=0,
                   help="the CUDA card to run on (--device defaults to "
                        "cuda:<gpu_id>)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the run: cuda:<gpu_id> by default; "
                        "'cpu' runs on the CPU (without CUDA the run stops "
                        "unless this is given)")
    # training / network
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default: 5e-4 for siren, "
                        "1e-2 for --encoding hash)")
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--img_downscale", type=float, default=1.0)
    p.add_argument("--max_train_steps", type=int, default=500000)
    p.add_argument("--save_every_n_epochs", type=int, default=2)
    p.add_argument("--fc_units", type=int, default=512)
    p.add_argument("--fc_layers", type=int, default=8)
    p.add_argument("--n_samples", type=int, default=64)
    p.add_argument("--n_importance", type=int, default=0)
    p.add_argument("--noise_std", type=float, default=0.0)
    p.add_argument("--chunk", type=int, default=1024 * 5)
    # solar correction
    p.add_argument("--sc_lambda", type=float, default=0.0)
    # uncertainty
    p.add_argument("--beta", action="store_true")
    p.add_argument("--first_beta_epoch", type=int, default=2)
    p.add_argument("--t_embbeding_tau", type=int, default=4)
    p.add_argument("--t_embbeding_vocab", type=int, default=30)
    # depth supervision
    p.add_argument("--depth", action="store_true")
    p.add_argument("--ds_lambda", type=float, default=0.0)
    p.add_argument("--ds_drop", type=float, default=0.25)
    p.add_argument("--GNLL", action="store_true")
    p.add_argument("--usealldepth", action="store_true")
    p.add_argument("--margin", type=float, default=0.0001)
    p.add_argument("--stdscale", type=float, default=1.0)
    # semantic supervision
    p.add_argument("--sem", action="store_true")
    p.add_argument("--num_sem_classes", type=int, default=5)
    p.add_argument("--s_embedding_factor", type=int, default=1)
    p.add_argument("--sem_downscale", type=float, default=8.0)
    p.add_argument("--ignore_label", type=int, default=-100)
    p.add_argument("--dense_ss", action="store_true")
    p.add_argument("--ss_lambda", type=float, default=4e-2)
    p.add_argument("--ss_drop", type=float, default=1.0)
    # strategies
    p.add_argument("--mapping", action="store_true")
    p.add_argument("--guidedsample", action="store_true")
    p.add_argument("--encoding", type=str, default="siren",
                   choices=["siren", "hash"],
                   help="field trunk: siren (SP-NeRF flagship) or hash "
                        "(Instant-NGP-style multiresolution hash grid)")
    p.add_argument("--hash_levels", type=int, default=8,
                   help="hash encoding: number of resolution levels")
    p.add_argument("--hash_features", type=int, default=4,
                   help="hash encoding: features per level")
    p.add_argument("--hash_log2T", type=int, default=19,
                   help="hash encoding: log2 of the per-level table size")
    p.add_argument("--hash_hidden", type=int, default=64,
                   help="hash trunk/head MLP width (NGP-classic 64)")
    p.add_argument("--hash_impl", type=str, default="auto",
                   choices=["auto", "xla", "sorted_vjp", "matmul_vjp",
                            "fused_vjp"],
                   help="the JAX package's lookup backward; in the port "
                        "every choice computes the same function and only "
                        "sets the table's layout")
    p.add_argument("--hash_anneal_steps", type=int, default=0,
                   help="coarse-to-fine: ramp the fine hash levels in over "
                        "the first N steps (0 = off; the 2 coarsest levels "
                        "are always active)")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping before Adam (0 = "
                        "off, the reference behavior)")
    p.add_argument("--lr_gamma", type=float, default=0.9,
                   help="per-EPOCH StepLR decay factor (the reference "
                        "hard-codes 0.9)")
    p.add_argument("--weight_decay", type=float, default=0.0,
                   help="AdamW-style decoupled weight decay on ALL "
                        "parameters (0 = off, the reference's plain Adam)")
    p.add_argument("--hash_table_wd", type=float, default=0.0,
                   help="AdamW-style decoupled weight decay on the hash "
                        "TABLE rows only (0 = off)")
    p.add_argument("--hash_level_lr_decay", type=float, default=1.0,
                   help="per-level lr decay on the hash table: level l "
                        "steps at lr * gamma**l (1.0 = off)")
    p.add_argument("--no_hash_direct_coarse", action="store_true",
                   help="hash every level even when the dense grid fits the "
                        "table (checkpoints trained before direct coarse "
                        "indexing)")
    p.add_argument("--no_hash_flat_table", action="store_true",
                   help="store hash tables as (T, F) instead of flat (T*F,) "
                        "rows (checkpoints trained before flat tables)")
    p.add_argument("--proposal", action="store_true",
                   help="density-only proposal network places the main "
                        "field's samples (ops/proposal.py)")
    p.add_argument("--n_proposal", type=int, default=64)
    p.add_argument("--prop_lambda", type=float, default=1.0)
    p.add_argument("--occgrid", action="store_true",
                   help="occupancy-grid guided coarse sampling "
                        "(ops/occgrid.py). Mutually exclusive with "
                        "--proposal")
    p.add_argument("--occ_res", type=int, default=64,
                   help="occupancy grid resolution per axis (res^3 cells)")
    p.add_argument("--occ_bins", type=int, default=128,
                   help="per-ray depth bins weighted by the grid")
    p.add_argument("--occ_floor", type=float, default=0.01,
                   help="uniform exploration floor per bin")
    p.add_argument("--occ_rows", type=int, default=4096,
                   help="grid cells refreshed per train step")
    p.add_argument("--occ_decay", type=float, default=0.8,
                   help="per-visit EMA decay of cached cell densities")
    p.add_argument("--xla_opts", type=str, default="",
                   help="XLA compiler options of the JAX package; XLA-only, "
                        "so the port refuses a non-empty value")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "fp32"],
                   help="MLP matmul precision (reference uses AMP fp16)")
    p.add_argument("--data_axis", type=int, default=0,
                   help="ranks for ray data-parallelism, one device each; "
                        "0 = every visible card (1 on the CPU). N > 1 "
                        "without a launcher starts N ranks; under torchrun "
                        "0 or the launcher's world size")
    p.add_argument("--no_timestamp_exp_name", action="store_true")
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for compatibility: on CUDA the eval "
                        "render takes the fused field kernel in bf16 by "
                        "default")
    p.add_argument("--check_val_every_n_epoch", type=int, default=2)
    p.add_argument("--log_every", type=int, default=100,
                   help="steps per training window (one log line)")
    p.add_argument("--profile", action="store_true",
                   help="record the second training window with "
                        "torch.profiler into <logs>/profile")
    return p


def check_ported(args):
    """Raise NotImplementedError for a flag whose path the port lacks."""
    if getattr(args, "xla_opts", ""):
        raise NotImplementedError(
            "--xla_opts sets XLA compiler options; it is XLA-only and has no "
            "counterpart in spnerf_torch")


def finalize_args(args, make_dirs=True):
    """Derive the dataset and output paths and the per-encoding --lr default
    as the JAX package does, and write <logs>/opts.json. Refuses the flags
    `check_ported` names."""
    if getattr(args, "lr", None) is None:
        # resolved here so that opts.json records the value the run used
        args.lr = 1e-2 if getattr(args, "encoding", "siren") == "hash" \
            else 5e-4
    if getattr(args, "occgrid", False) and getattr(args, "proposal", False):
        raise SystemExit("--occgrid and --proposal are mutually exclusive "
                         "(both own coarse sample placement)")
    check_ported(args)
    if args.dataset_dir is None:
        args.dataset_dir = os.path.join(args.project_dir, "dataset", args.dataset_name)
    args.depth_dir = os.path.join(args.dataset_dir, "Depth")
    args.json_dir = os.path.join(args.dataset_dir, "JSON")
    args.img_dir = os.path.join(args.dataset_dir, "RGB", args.aoi_id)
    args.sem_dir = os.path.join(args.dataset_dir, "Semantic")
    args.gt_dir = os.path.join(args.dataset_dir, "Truth")

    if args.exp_name is None:
        args.exp_name = args.aoi_id
    if getattr(args, "auto_resume", False):
        # a timestamped exp dir would make every relaunch start afresh
        args.no_timestamp_exp_name = True
    if not getattr(args, "no_timestamp_exp_name", False):
        args.exp_name = f"{args.exp_name}-{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}"

    args.output_dir = os.path.join(args.project_dir, "output", args.exp_name)
    args.cache_dir = os.path.join(args.output_dir, "cache")
    args.ckpts_dir = os.path.join(args.output_dir, "ckpts")
    args.logs_dir = os.path.join(args.output_dir, "logs")
    if make_dirs:
        write_opts(args)
    return args


def write_opts(args):
    """<logs>/opts.json: every flag and derived path of the run."""
    os.makedirs(args.logs_dir, exist_ok=True)
    with open(os.path.join(args.logs_dir, "opts.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()}, f, indent=2, default=str)


def _aoi_frames(args) -> int:
    """Number of translated multi-AOI frames (comma-separated --aoi_id)."""
    return max(1, len(str(getattr(args, "aoi_id", "") or "").split(",")))


def model_config_from_args(args) -> ModelConfig:
    return ModelConfig(
        fc_layers=args.fc_layers,
        fc_units=args.fc_units,
        mapping=args.mapping,
        num_sem_classes=args.num_sem_classes,
        s_embedding_factor=args.s_embedding_factor,
        t_embedding_dims=args.t_embbeding_tau,
        beta=args.beta,
        sem=args.sem,
        encoding=getattr(args, "encoding", "siren"),
        hash_levels=getattr(args, "hash_levels", 8),
        hash_features=getattr(args, "hash_features", 4),
        hash_log2T=getattr(args, "hash_log2T", 19),
        hash_hidden=getattr(args, "hash_hidden", 64),
        hash_impl=getattr(args, "hash_impl", "auto"),
        hash_direct_coarse=not getattr(args, "no_hash_direct_coarse", False),
        hash_flat_table=not getattr(args, "no_hash_flat_table", False),
        hash_anneal_steps=getattr(args, "hash_anneal_steps", 0),
        hash_frames=_aoi_frames(args),
    )


def render_config_from_args(args) -> RenderConfig:
    return RenderConfig(
        n_samples=args.n_samples,
        n_importance=args.n_importance,
        guidedsample=args.guidedsample,
        solar_correction=args.sc_lambda > 0,
        beta=args.beta,
        sem=args.sem,
        compute_dtype="bfloat16" if args.precision == "bf16" else "float32",
        proposal=getattr(args, "proposal", False),
        n_proposal=getattr(args, "n_proposal", 64),
        occ_grid=getattr(args, "occgrid", False),
        occ_res=getattr(args, "occ_res", 64),
        occ_bins=getattr(args, "occ_bins", 128),
        occ_floor=getattr(args, "occ_floor", 0.01),
        # one grid block per translated AOI frame (as hash_frames)
        occ_frames=_aoi_frames(args),
    )


def loss_config_from_args(args) -> LossConfig:
    return LossConfig(
        sc_lambda=args.sc_lambda,
        beta=args.beta,
        ds_lambda=args.ds_lambda,
        depth=args.depth,
        gnll=args.GNLL,
        usealldepth=args.usealldepth,
        margin=args.margin,
        stdscale=args.stdscale,
        sem=args.sem,
        ss_lambda=args.ss_lambda,
        first_beta_epoch=args.first_beta_epoch,
        prop_lambda=getattr(args, "prop_lambda", 1.0),
    )


def asdict(cfg):
    return dataclasses.asdict(cfg)
