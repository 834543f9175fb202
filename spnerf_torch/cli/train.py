"""Training entry point: the PyTorch version of the JAX package's
`cli/train.py`, command-line compatible with `python main.py ...`.

A run lays out output/<exp>/{ckpts, logs, cache}: logs/opts.json records
the flags, train/test.txt are copied beside it, logs/metrics.jsonl (and
TensorBoard where it imports) takes the scalars, logs/{val,train}/... the
validation images on save epochs, and ckpts/<step>/ the checkpoints
(`train/checkpoints.py`), ranked by val_psnr. `main` keeps the JAX run's
schedule: training windows of `min(log_every, max_train_steps)` steps (the
hash family's windows shortened by the JAX package's sparse-op budget, so
both packages log and validate at the same steps), validation at
`check_val_every_n_epoch` with images every `save_every_n_epochs`, a save
after each validation, and a final validation and save. `--auto_resume`
and `--ckpt_path` resume; `--watchdog` supervises the run in a child
process.

`run_validation` renders every validation view through the eval renderer
(`render.build_render_fn`: B1 on CUDA in bf16), computes PSNR and SSIM on
the trainer's device, turns the predicted depth into a lat/lon/alt point
cloud and a DSM (splatted on the trainer's device), registers that DSM on
the lidar truth and logs the altitude MAE. As in the JAX package and the
reference, a failure of the MAE or of the image grid is printed and the
run goes on.

A comma-separated --aoi_id trains one field on several AOIs side by side
(`data/multi.py`): each AOI's dataset under <project>/dataset/DFC2019_<n>
(or an explicit --dataset_dir with an {aoi} placeholder), each validated
and scored in its own frame. With --occgrid, validation places its samples
by the trained grid.

Data parallelism (`parallel/mesh.py`): the run's ranks are the
launcher's (`torchrun --nproc_per_node N main_torch.py ...`, where
--data_axis is 0 or N), else --data_axis (0: every visible card, 1 on the
CPU); N > 1 without a launcher starts N ranks of this command on this host
(spawned, with the launcher's variables and a file store). Each rank trains
on its block of the rays and renders its share of every validation view;
rank 0 alone prints, logs and writes opts.json, metrics.jsonl, the
checkpoints, the images and the DSMs, and loads the scene first (it writes
the ray cache). Every rank restores on --ckpt_path/--auto_resume. With
--watchdog the watchdog supervises the process that starts the ranks and
relaunches the whole group; under a launcher, --watchdog is refused (the
launcher restarts). A rank that fails fails the run.

Entry points run on the card (`--device`, default cuda:<gpu_id>; rank r
of a mesh takes cuda:(local rank mod the cards)) and raise without CUDA
unless given `--device cpu`.
"""

import json
import os
import shutil
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import spans
from ..config import (build_train_parser, finalize_args,
                      loss_config_from_args, model_config_from_args,
                      render_config_from_args, write_opts)
from ..data import load_scene, load_scenes
from ..device import resolve_device
from ..evaluation.dsm import dsm_from_latlonalt
from ..evaluation.mae import compute_mae_and_save_dsm_diff
from ..evaluation.metrics import miou, overall_accuracy, psnr, ssim
from ..evaluation.outputs import save_nerf_output_to_images
from ..parallel import data_mesh, device_count
from ..parallel.mesh import launcher_world
from ..render import build_render_fn
from ..train.checkpoints import CheckpointManager
from ..train.loop import Trainer, scene_to_device_arrays
from ..utils.logging import MetricLogger


def predefined_val_ts(img_id):
    """Transient-embedding index used at test time (reference eval.py:23-24)."""
    return 0


def _aoi_dirs(args, aoi):
    """Dataset directories of one AOI: the run's own for a single-AOI run;
    for a multi-AOI run <project>/dataset/DFC2019_<n> by the DFC2019
    naming; or those under an explicit --dataset_dir holding an {aoi}
    placeholder."""
    if args.dataset_dir and "{aoi}" in args.dataset_dir:
        base = args.dataset_dir.format(aoi=aoi)
    elif "," not in args.aoi_id:
        return {"json_dir": args.json_dir, "img_dir": args.img_dir,
                "depth_dir": args.depth_dir, "sem_dir": args.sem_dir,
                "gt_dir": args.gt_dir}
    else:
        base = os.path.join(args.project_dir, "dataset",
                            f"DFC2019_{aoi.split('_')[-1]}")
    return {
        "json_dir": os.path.join(base, "JSON"),
        "img_dir": os.path.join(base, "RGB", aoi),
        "depth_dir": os.path.join(base, "Depth"),
        "sem_dir": os.path.join(base, "Semantic"),
        "gt_dir": os.path.join(base, "Truth"),
    }


def build_trainer_and_scene(args, device, mesh=None):
    """(trainer on `device` over `mesh`, the loaded scene, steps per epoch)
    for the flags `args` (after `finalize_args`, or a run's opts.json). A
    comma-separated --aoi_id loads a `MultiScene`."""
    kwargs = dict(
        img_downscale=args.img_downscale, stdscale=args.stdscale,
        margin=args.margin, sem=args.sem, num_sem_classes=args.num_sem_classes,
        dense_ss=args.dense_ss, sem_downscale=args.sem_downscale,
        load_depth=args.depth or args.model == "sp-nerf",
        cache_dir=args.cache_dir,
    )
    aois = [a.strip() for a in args.aoi_id.split(",") if a.strip()]
    if len(aois) > 1:
        scene = load_scenes(aois, lambda a: _aoi_dirs(args, a), **kwargs)
    else:
        dirs = _aoi_dirs(args, args.aoi_id)
        scene = load_scene(dirs["json_dir"], dirs["img_dir"],
                           dirs["depth_dir"], dirs["sem_dir"], args.aoi_id,
                           **kwargs)
    steps_per_epoch = max(len(scene) // args.batch_size, 1)
    trainer = Trainer(
        model_config_from_args(args),
        render_config_from_args(args),
        loss_config_from_args(args),
        lr=args.lr,
        lr_gamma=getattr(args, "lr_gamma", 0.9),
        steps_per_epoch=steps_per_epoch,
        max_steps=args.max_train_steps,
        ds_drop=args.ds_drop,
        ss_drop=args.ss_drop,
        noise_std=args.noise_std,
        # an embedding lookup past the vocab raises in torch (jnp.take
        # clamps it onto the last row): size the vocab to the scene
        t_vocab=max(args.t_embbeding_vocab, _scene_t_vocab(scene)),
        table_wd=getattr(args, "hash_table_wd", 0.0),
        table_level_lr_decay=getattr(args, "hash_level_lr_decay", 1.0),
        weight_decay=getattr(args, "weight_decay", 0.0),
        grad_clip=getattr(args, "grad_clip", 0.0),
        occ_rows=getattr(args, "occ_rows", 4096),
        occ_decay=getattr(args, "occ_decay", 0.8),
        mesh=mesh,
        device=device,
    )
    return trainer, scene, steps_per_epoch


def _validation_items(scene, aoi_id):
    """(aoi_id, scene, record) of every validation image of a
    `SatelliteScene` or a `MultiScene`."""
    if hasattr(scene, "validation_items"):
        return list(scene.validation_items())
    return [(aoi_id, scene, rec) for rec in scene.val_images]


def _scene_t_vocab(scene):
    """Smallest transient-embedding vocab covering every train ray id and
    validation record of the scene (of every AOI of a multi-AOI one)."""
    need = int(np.max(scene.ids)) + 1
    for _, _, rec in _validation_items(scene, None):
        need = max(need, int(rec.t) + 1)
    return need


def _val_metrics(mean):
    """Checkpoint metrics dict from a validation summary. A NaN val_psnr
    (validation produced no val rows) would rank above real metrics;
    substitute -inf so metric-less saves never outrank real ones."""
    psnr_v = mean.get("psnr", float("nan"))
    if psnr_v != psnr_v:  # NaN
        psnr_v = float("-inf")
    return {"val_psnr": float(psnr_v)}


def _val_labels(items):
    """Per-item log labels for validation records (aoi_id, scene, record):
    an image id that repeats gets a frame index suffix so its rows stay
    distinguishable. Unique ids are unchanged."""
    frame_of, counts = {}, {}
    for _, sub, rec in items:
        frame_of.setdefault(id(sub), len(frame_of))
        counts[rec.img_id] = counts.get(rec.img_id, 0) + 1
    return [rec.img_id if counts[rec.img_id] == 1
            else f"{rec.img_id}.f{frame_of[id(sub)]}"
            for _, sub, rec in items]


def run_validation(trainer, scene, state, args, epoch, logger, save_images):
    """Render every validation image of `scene` (a `SatelliteScene` or a
    `MultiScene`); log PSNR/SSIM/MAE (reference validation_step,
    main.py:188-299) and return their means over the test views. Each AOI's
    DSM is scored against its own truth, in its own frame.

    args: a namespace with aoi_id, gt_dir, logs_dir, chunk, sem and
    num_sem_classes (the training CLI's names; a multi-AOI run also
    project_dir and dataset_dir). The field renders from `state` on the
    trainer's device, with its occupancy grid where it has one.

    Under the trainer's mesh every rank calls this and renders its share of
    each view; rank 0 alone scores, logs and writes, and the others return
    {}."""
    device = trainer.device
    mesh = trainer.mesh
    render = build_render_fn(state.model, trainer.rc, state.t_embed,
                             chunk=args.chunk, fine=state.fine,
                             proposal=state.proposal, mesh=mesh)
    all_scalars = []
    items = _validation_items(scene, args.aoi_id)
    labels = _val_labels(items)
    for i, (aoi_id, sub_scene, rec) in enumerate(items):
        gt_dir = (_aoi_dirs(args, aoi_id)["gt_dir"]
                  if "," in args.aoi_id else args.gt_dir)
        sample = sub_scene.load_val_image(rec, with_sem=args.sem)
        t = predefined_val_ts(rec.img_id)
        # with the occupancy grid, validation places its samples by the
        # trained grid, as the run was trained
        out = render(sample["rays"], t, sample.get("sems"), occ=state.occ)
        if mesh is not None and not mesh.is_main:
            continue
        typ = "fine" if "rgb_fine" in out else "coarse"
        h, w = sample["h"], sample["w"]
        img_t = out[f"rgb_{typ}"].float().reshape(h, w, 3)
        gt_t = torch.as_tensor(sample["rgbs"], device=device).reshape(h, w, 3)
        psnr_v = float(psnr(img_t, gt_t))
        ssim_v = float(ssim(img_t, gt_t))
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        img = out[f"rgb_{typ}"].reshape(h, w, 3)
        gt = sample["rgbs"].reshape(h, w, 3)

        split = "train" if i == 0 else "val"  # image 0 is the train-debug view
        out_dir = os.path.join(args.logs_dir, split)
        mae_v = float("nan")
        try:
            depth = out[f"depth_{typ}"]
            lats, lons, alts = sub_scene.latlonalt_from_depth(sample["rays"],
                                                              depth)
            tmp_dsm = os.path.join(out_dir, "dsm",
                                   f"tmp_pred_dsm_{rec.img_id}.tif")
            os.makedirs(os.path.dirname(tmp_dsm), exist_ok=True)
            dsm_from_latlonalt(lats, lons, alts, dsm_path=tmp_dsm,
                               device=device)
            mae_v = compute_mae_and_save_dsm_diff(
                tmp_dsm, rec.img_id, aoi_id, gt_dir,
                os.path.join(out_dir, "dsm"), epoch, save=False,
            )
            os.remove(tmp_dsm)
        except Exception as exc:  # reference swallows MAE failures (main.py:272-287)
            print(f"MAE computation failed for {rec.img_id}: {exc}")

        if save_images:
            save_nerf_output_to_images(sub_scene, sample, out, out_dir, epoch,
                                       args.num_sem_classes, label=labels[i],
                                       device=device)

        # TensorBoard image grid: GT / prediction / depth (+ sem colors),
        # like reference main.py:221-250
        try:
            from ..evaluation.outputs import (
                convert_semantic_to_color,
                visualize_depth,
            )

            grid = [np.moveaxis(gt, -1, 0), np.moveaxis(img, -1, 0),
                    np.moveaxis(
                        visualize_depth(
                            out[f"depth_{typ}"].reshape(h, w)
                        ).astype(np.float32) / 255.0, -1, 0)]
            if f"sem_logits_{typ}" in out and "sems" in sample:
                pred_sem = np.argmax(out[f"sem_logits_{typ}"], -1).reshape(h, w)
                gt_sem = np.asarray(sample["sems"]).reshape(h, w)
                for sm in (gt_sem, pred_sem):
                    grid.append(np.moveaxis(
                        convert_semantic_to_color(
                            sm, args.num_sem_classes
                        ).astype(np.float32) / 255.0, -1, 0))
            logger.log_images(int(state.step),
                              f"{split}_{i}/GT_pred_depth_sems",
                              np.stack(grid))
        except Exception as exc:
            # image grids are best-effort, but never fail silently
            print(f"validation image grid failed for {rec.img_id}: {exc!r}")
        scalars = {"psnr": psnr_v, "ssim": ssim_v, "mae": mae_v}
        # semantic quality over the pixels with a ground-truth label (>= 0)
        if f"sem_logits_{typ}" in out and "sems" in sample:
            pred_sem = np.argmax(out[f"sem_logits_{typ}"], -1).ravel()
            gt_sem = np.asarray(sample["sems"]).ravel()
            labeled = gt_sem >= 0
            if labeled.any():
                scalars["miou"] = float(miou(pred_sem[labeled],
                                             gt_sem[labeled],
                                             args.num_sem_classes))
                scalars["oa"] = float(overall_accuracy(pred_sem[labeled],
                                                       gt_sem[labeled]))
        logger.log(int(state.step), scalars, split=f"{split}_{labels[i]}")
        if split == "val":
            all_scalars.append(scalars)
        sem_str = (f" miou {scalars['miou']:.3f} oa {scalars['oa']:.3f}"
                   if "miou" in scalars else "")
        print(f"[val e{epoch}] {labels[i]}: psnr {psnr_v:.2f} ssim {ssim_v:.3f} "
              f"mae {mae_v:.3f}{sem_str}")

    keys = ("psnr", "ssim", "mae") + (
        ("miou", "oa") if any("miou" in s for s in all_scalars) else ())
    mean = {k: float(np.nanmean([s[k] for s in all_scalars if k in s]))
            for k in keys} if all_scalars else {}
    if mean:
        logger.log(int(state.step), mean, split="val")
    return mean


def _watchdog_supervise(args, argv):
    """--watchdog N: run the training CLI in a child process and relaunch
    it with --auto_resume whenever metrics.jsonl stops advancing for N
    seconds (3N before the child's first line) or the child exits nonzero.
    Returns 0 once a child completes. The child runs in a session of its
    own, so that a kill reaches the ranks it started."""
    import signal
    import subprocess

    # pin the RESOLVED exp name: a timestamped one would give every child
    # a fresh directory, defeating both resume and progress monitoring
    cmd = ([sys.executable, "-m", "spnerf_torch.cli.train"]
           + pinned_argv(argv, args.exp_name))
    if "--auto_resume" not in cmd:
        cmd.append("--auto_resume")
    env = dict(os.environ, SPNERF_WATCHDOG_CHILD="1")
    # the package must import whatever the directory main was started from
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    metrics_path = os.path.join(args.logs_dir, "metrics.jsonl")
    poll_s = max(min(args.watchdog / 10.0, 5.0), 0.05)

    for attempt in range(args.watchdog_max_restarts + 1):
        if attempt:
            print(f"[watchdog] relaunch {attempt}/{args.watchdog_max_restarts}",
                  flush=True)
        child = subprocess.Popen(cmd, env=env, start_new_session=True)
        last_progress = time.time()
        try:
            last_mtime = os.path.getmtime(metrics_path)
        except OSError:
            last_mtime = None
        progressed = False
        killed = False
        try:  # the child's session does not get this one's signals
            while True:
                rc = child.poll()
                if rc is not None:
                    break
                try:
                    mtime = os.path.getmtime(metrics_path)
                except OSError:
                    mtime = None
                if mtime is not None and mtime != last_mtime:
                    last_mtime = mtime
                    last_progress = time.time()
                    progressed = True
                # start-up (imports, data load, restore, first window) writes
                # no metrics: it gets three times as long
                limit = args.watchdog if progressed else 3 * args.watchdog
                if time.time() - last_progress > limit:
                    print(f"[watchdog] no progress for {limit}s; "
                          f"killing pid {child.pid}", flush=True)
                    os.killpg(child.pid, signal.SIGKILL)
                    child.wait()
                    killed = True
                    break
                time.sleep(poll_s)
        except BaseException:
            if child.poll() is None:
                os.killpg(child.pid, signal.SIGKILL)
            raise
        if not killed and rc == 0:
            return 0
        if not killed:
            print(f"[watchdog] child exited rc={rc}; relaunching", flush=True)
    raise SystemExit(
        f"watchdog: giving up after {args.watchdog_max_restarts} relaunches")


def _window_len(args):
    """Steps per training window: min(log_every, max_train_steps), and for
    the hash family the JAX package's cap of 2,400 sparse ops (gathers and
    scatters) a window. The cap is a limit of the TPU's runtime, kept so
    that both packages log and validate at the same steps."""
    window_len = max(1, min(getattr(args, "log_every", 100),
                            args.max_train_steps))
    if args.encoding == "hash":
        # the coarse pass, the guided and the solar passes each encode, and
        # the fine pass twice (view and solar); 8 more sparse ops a step
        # outside the encoding (the batch gathers and the
        # transient-embedding gather); the occupancy grid adds its lookup
        # and the grid refresh's encoding
        n_enc_passes = (1 + int(args.guidedsample) + int(args.sc_lambda > 0)
                        + 2 * int(args.n_importance > 0))
        sparse_per_step = (n_enc_passes * (2 * args.hash_levels + 2) + 8
                           + (1 + args.hash_levels)
                           * int(getattr(args, "occgrid", False)))
        window_len = min(window_len, max(1, 2400 // sparse_per_step))
    return window_len


def pinned_argv(argv, exp_name):
    """`argv` with the run's resolved --exp_name (a timestamped one would
    differ between processes started apart)."""
    base = []
    it = iter(list(argv))
    for a in it:
        if a == "--exp_name":
            next(it, None)
            continue
        if a.startswith("--exp_name="):
            continue
        base.append(a)
    return base + ["--exp_name", exp_name, "--no_timestamp_exp_name"]


def run_world(args, device):
    """The run's ranks: the launcher's world size, else --data_axis (0:
    every visible card, 1 on the CPU)."""
    launcher = launcher_world()
    if launcher is None:
        return args.data_axis or device_count(device.type)
    if args.data_axis not in (0, launcher):
        raise SystemExit(f"--data_axis {args.data_axis} under a launcher of "
                         f"{launcher} ranks: give 0 or {launcher}")
    return launcher


def _rank_main(local_rank, argv, world, device_type, init_method):
    """One rank started by `launch_ranks`: the launcher's variables, the
    process group on the file store, then `main`."""
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    if "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)  # as torchrun does for several ranks
    mesh = data_mesh(world, device_type, init_method=init_method)
    try:
        main(argv)
    finally:
        mesh.close()


def launch_ranks(argv, world, device_type):
    """Run `world` ranks of the command line `argv` on this host, as a
    launcher would (spawned processes, a file store in a temporary
    directory); raises when a rank fails, after stopping the others."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="spnerf-ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_main, args=(argv, world, device_type, init),
                           nprocs=world, join=True, start_method="spawn")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_train_parser().parse_args(argv)
    # the card unless --device says otherwise; raises without CUDA
    device = resolve_device(args.device, args.gpu_id)
    world = run_world(args, device)
    watchdog = (args.watchdog > 0
                and os.environ.get("SPNERF_WATCHDOG_CHILD") != "1")
    if world > 1 and launcher_world() is None:
        # this process starts the ranks (under the watchdog, its child does)
        finalize_args(args, make_dirs=False)
        if watchdog:
            return _watchdog_supervise(args, argv)
        print(f"devices: {device_count(device.type)} visible, {world} ranks "
              f"on {device.type}")
        launch_ranks(pinned_argv(argv, args.exp_name), world, device.type)
        return None
    mesh, own_group = None, False
    if world > 1:
        if watchdog:
            raise SystemExit("--watchdog supervises the ranks this command "
                             "starts; under a launcher use its restarts")
        own_group = not dist.is_initialized()
        mesh = data_mesh(world, device.type)
        device = mesh.device
        finalize_args(args, make_dirs=False)
        # rank 0's names and paths on every rank
        vars(args).update(mesh.broadcast_object(vars(args)))
        if mesh.is_main:
            write_opts(args)
    else:
        finalize_args(args)
        if watchdog:
            return _watchdog_supervise(args, argv)
    try:
        return _train(args, device, mesh)
    finally:
        if own_group:
            mesh.close()


def _train(args, device, mesh):
    """The run of `main` on this rank (mesh None: the only one)."""
    is_main = mesh is None or mesh.is_main
    say = print if is_main else (lambda *a, **k: None)
    if is_main:
        for split_file in ("train.txt", "test.txt"):
            src = os.path.join(args.json_dir, split_file)
            if os.path.exists(src):
                shutil.copyfile(src, os.path.join(args.logs_dir, split_file))
    if device.type == "cuda" and device.index is not None:
        # the kernels launch on the current card's stream
        torch.cuda.set_device(device)
    rank = "" if mesh is None else f"rank {mesh.rank}/{mesh.world} "
    print(f"{rank}device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + ("" if mesh is None else f", {mesh.backend}"))

    # rank 0 loads the scene first: the first load writes the ray cache
    if mesh is not None and not mesh.is_main:
        mesh.barrier()
    trainer, scene, steps_per_epoch = build_trainer_and_scene(args, device,
                                                              mesh)
    if mesh is not None and mesh.is_main:
        mesh.barrier()
    say(f"scene: {len(scene)} rays, {steps_per_epoch} steps/epoch")

    state = trainer.init_state(torch.Generator().manual_seed(args.seed))
    ckpt = CheckpointManager(args.ckpts_dir, mesh)
    if args.ckpt_path:
        if CheckpointManager(args.ckpt_path).restore(state) is not None:
            say(f"resumed from {args.ckpt_path} at step {state.step}")
    elif args.auto_resume:
        if ckpt.restore(state) is not None:
            say(f"auto-resumed {args.exp_name} at step {state.step}")
        else:
            say(f"auto-resume: no checkpoint under {args.ckpts_dir}, "
                "starting fresh")
    state = trainer.replicate_state(state)

    data = trainer.shard_data(scene_to_device_arrays(scene))
    window_len = _window_len(args)
    logger = MetricLogger(args.logs_dir) if is_main else None

    start_step = state.step
    if start_step >= args.max_train_steps:
        # a finished run re-invoked: no re-validation, no second save
        say(f"already trained to step {start_step} >= "
            f"{args.max_train_steps}; nothing to do")
        if logger is not None:
            logger.close()
        return state
    last_epoch_validated = -1
    last_saved_step = -1
    t0 = time.time()
    step = start_step
    profiler = None
    while step < args.max_train_steps:
        # record the second window (the first pays the warm-up)
        profiling = (args.profile and profiler is None
                     and step >= start_step + window_len)
        if profiling:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            profiler = profile(activities=activities)
            spans.reset()
            profiler.__enter__()
        done = min(window_len, args.max_train_steps - step)
        # the step's draws are seeded by (seed + 1, step), as the JAX
        # package's run key is PRNGKey(seed + 1)
        loss_dict = trainer.train_steps(state, data, done,
                                        batch_size=args.batch_size,
                                        seed=args.seed + 1)
        step += done
        ld = {k: float(v) for k, v in loss_dict.items()}  # the window's sync
        if profiling:
            profiler.__exit__(None, None, None)
            if is_main:
                prof_dir = os.path.join(args.logs_dir, "profile")
                os.makedirs(prof_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(prof_dir,
                                                          "trace.json"))
                with open(os.path.join(prof_dir, "spans.json"), "w") as f:
                    json.dump(spans.totals(), f, indent=1)
        dt = time.time() - t0
        rays_s = done * args.batch_size / max(dt, 1e-9)
        if logger is not None:
            logger.log(step, {**ld, "rays_per_sec": rays_s})
        say(f"step {step}: loss {ld['loss']:.5f} "
            f"psnr {ld['psnr']:.2f} | {rays_s:,.0f} rays/s")

        # test hook: the first process to get here simulates a hang (the
        # failure the watchdog exists for); relaunches go on normally
        hang_marker = os.environ.get("SPNERF_TEST_HANG_ONCE")
        if hang_marker and not os.path.exists(hang_marker):
            with open(hang_marker, "w"):
                pass
            print("[test-hook] simulating hang", flush=True)
            while True:
                time.sleep(3600)

        # validation when an eligible epoch boundary was crossed in this
        # window (boundaries align to the window start within window_len)
        epoch = step // steps_per_epoch
        if (epoch > 0 and epoch != last_epoch_validated
                and epoch % args.check_val_every_n_epoch == 0
                and step % steps_per_epoch < window_len):
            last_epoch_validated = epoch
            save_images = epoch % args.save_every_n_epochs == 0
            mean = run_validation(trainer, scene, state, args, epoch, logger,
                                  save_images)
            ckpt.save(step, state, metrics=_val_metrics(mean))
            last_saved_step = step
        t0 = time.time()

    # the final validation and save, unless the last window saved at
    # max_train_steps already (a second save of the step would raise)
    if last_saved_step != args.max_train_steps:
        mean = run_validation(trainer, scene, state, args,
                              args.max_train_steps // steps_per_epoch, logger,
                              True)
        ckpt.save(args.max_train_steps, state, metrics=_val_metrics(mean))
    if logger is not None:
        logger.close()
    best = ckpt.best_step()
    latest = ckpt.latest_step()
    if latest is not None:
        say(f"latest checkpoint: step {latest} ({ckpt.step_path(latest)})")
    if best is not None:
        say(f"best checkpoint (val_psnr): step {best} "
            f"({ckpt.step_path(best)}) — render it offline with "
            f"`python -m spnerf_torch.tools render --run_dir "
            f"{os.path.dirname(args.ckpts_dir)} --step best`")
    say("training complete")
    return state


if __name__ == "__main__":
    main()
