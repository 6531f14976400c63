"""Evaluation CLI: motion completion, interpolation, generation (port of
``hm_vae_tpu.cli.eval_recovery``):

    python -m hm_vae_torch.cli.eval_recovery --config configs/len_64_test_interpolation.yaml \\
        --test_model gen_00250000.pt --final_try_long_seq_interpolation \\
        [--max_seqs N] [--chunk N] [--device cpu]

Tasks: ``--final_try_long_seq_interpolation`` (``--batch_across_seqs``
flattens a chunk's windows into one solve), ``--final_motion_completion_long_seq``,
``--try_final_long_seq_generation``, ``--final_motion_completion`` (one
window per sequence, random per-frame joint masks or ``--mask_dir``),
``--try_interpolation_w_trajectory_single_window`` (one window per sequence
under the keyframe trajectory loss, against the ground truth's root
translation from ``root_v``; needs ``--trajectory_config``) and
``--test_model_rec`` (posterior-mean reconstruction quality, no solve).  Each
writes ``<name>_rot_opt_res.npy`` per sequence and ``summary.json`` under
``<output_path>/<task dir>/<config name>/``; with ``--trajectory_config``
(and ``--trajectory_test_model``, a ``gen_*.pt``) also the trajectory
model's world-space poses, ``<name>_root_trans_opt_res.npy``.  ``--device``
defaults to ``cuda`` and raises without CUDA unless ``--device cpu`` is
given.

The solver's modes: ``--finetune_scope`` (``full``, ``lora``, ``last_conv``,
``heads``), ``--lora_rank`` and ``--lora_lr_mult`` for the lora scope,
``--opt_param_dtype`` (the bf16 stochastically rounded clone) and
``--opt_moment_dtype``, each overriding the config's ``latent_opt``.  A
training config's execution keys (``steps_per_call``, ``async_checkpoint``,
``param_dtype``, ``compact_transfer``, ``wire_format``, ...) do not reach
the evaluation: the model is built at the defaults, f32, so that
``configs/len64_production.yaml`` evaluates as it solves (its bf16 clone
and moments).

``--gen_vis`` also renders each sequence (``<name>.mp4``, or a gif without
ffmpeg; it needs matplotlib): the trajectory model's world-space poses where
one is given, else the result's FK poses.

``--data_parallel N`` splits every batched solve's window batch (and
``--test_model_rec``'s batches of 128) over N ranks, each a process started
by torchrun with ``HMVAE_DIST=1``; the results are gathered to every rank
and the primary rank writes the files:

    HMVAE_DIST=1 python -m torch.distributed.run --nproc_per_node N \
        -m hm_vae_torch.cli.eval_recovery --data_parallel N ...

Each rank runs on ``cuda:{LOCAL_RANK % device count}`` (or the CPU); ranks
that share a card use gloo, as on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description="Latent-optimization evaluations")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--output_path", type=str, default="./")
    p.add_argument("--test_model", type=str, default="",
                   help="reference-format gen_*.pt (the port's training checkpoints are)")
    p.add_argument("--trajectory_config", type=str, default="")
    p.add_argument("--trajectory_test_model", type=str, default="")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--max_seqs", type=int, default=-1,
                   help="number of test sequences to evaluate (-1 = all)")
    p.add_argument("--chunk", type=int, default=32,
                   help="sequences per batched solve")
    p.add_argument("--missing_joint_prob", type=float, default=None,
                   help="per-frame random joint-drop probability for "
                        "--final_motion_completion (default: the config's, or 0.3)")
    p.add_argument("--mask_dir", type=str, default=None,
                   help="precomputed per-frame mask npys (overrides random)")
    p.add_argument("--gen_vis", action="store_true")
    p.add_argument("--input_gt", action="store_true")
    p.add_argument("--vis_iters", type=int, default=None)
    p.add_argument("--vis_bs", type=int, default=None)
    p.add_argument("--out_tag", type=str, default="")
    p.add_argument("--batch_across_seqs", action="store_true",
                   help="long-seq interpolation: one batched solve per chunk of sequences")
    p.add_argument("--shared_decoder_clone", action="store_true",
                   help="latent_opt.per_window_decoder=False: one decoder clone shared by "
                        "each batched solve (default: a clone per window)")
    p.add_argument("--finetune_scope", default=None,
                   choices=["full", "lora", "last_conv", "heads"],
                   help="decoder part the fine-tune phase optimizes (lora: rank-r adapters, "
                        "conv biases and latent heads)")
    p.add_argument("--lora_rank", type=int, default=None,
                   help="adapter rank of --finetune_scope lora (latent_opt.lora_rank)")
    p.add_argument("--lora_lr_mult", type=float, default=None,
                   help="learning-rate multiplier of the adapters (latent_opt.lora_lr_mult)")
    p.add_argument("--opt_param_dtype", default=None, choices=["float32", "bfloat16"],
                   help="storage dtype of the solver's decoder clone (bfloat16: stochastically "
                        "rounded write-back)")
    p.add_argument("--opt_moment_dtype", default=None, choices=["float32", "bfloat16"],
                   help="the solver's Adam moment storage dtype")
    p.add_argument("--final_motion_completion_long_seq", action="store_true")
    p.add_argument("--final_try_long_seq_interpolation", action="store_true")
    p.add_argument("--try_final_long_seq_generation", action="store_true")
    p.add_argument("--final_motion_completion", action="store_true")
    p.add_argument("--try_interpolation_w_trajectory_single_window", action="store_true")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="split each batched solve's window batch over N ranks (torchrun "
                        "with HMVAE_DIST=1; windows padded by cycling, so the summary is "
                        "the one-process run's)")
    p.add_argument("--test_model_rec", action="store_true",
                   help="posterior-mean reconstruction quality over the test split")
    p.add_argument("--seed", type=int, default=None, help="default: the config's run.seed")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from ..apps.tasks import LatentOptApps
    from ..data.dataset import EvalMotionDataset, resolve_split_json
    from ..train.trainer import build_trainer
    from ..utils.config import load_config
    from ..parallel import multihost as mh
    from . import start

    device = start(args.device)
    if mh.process_count() != args.data_parallel:
        raise ValueError(
            f"--data_parallel {args.data_parallel} needs as many ranks, this run has "
            f"{mh.process_count()}: start it as HMVAE_DIST=1 python -m torch.distributed.run "
            f"--nproc_per_node {args.data_parallel} -m hm_vae_torch.cli.eval_recovery ...")
    group = mh.process_group()
    cfg = eval_config(load_config(args.config))
    lat_kw = {k: v for k, v in (
        ("per_window_decoder", False if args.shared_decoder_clone else None),
        ("finetune_scope", args.finetune_scope), ("lora_rank", args.lora_rank),
        ("lora_lr_mult", args.lora_lr_mult), ("opt_param_dtype", args.opt_param_dtype),
        ("opt_moment_dtype", args.opt_moment_dtype)) if v is not None}
    cfg = dataclasses.replace(cfg, latent_opt=dataclasses.replace(cfg.latent_opt, **lat_kw))
    if args.data_root:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                data_root=args.data_root))
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, seed=args.seed))
    # the reference's literal flags: --vis_iters x --vis_bs bounds the
    # sequences (--max_seqs wins), --vis_bs sets the chunk, --out_tag
    # suffixes the output directory
    if args.max_seqs < 0 and args.vis_iters is not None:
        args.max_seqs = args.vis_iters * (args.vis_bs or 32)
    if args.vis_bs:
        args.chunk = args.vis_bs

    model_name = os.path.splitext(os.path.basename(args.config))[0]
    if args.out_tag:
        model_name = f"{model_name}_{args.out_tag}"
    tasks = (("final_try_long_seq_interpolation", "interpolation",
              "eval_long_seq_interpolation"),
             ("final_motion_completion_long_seq", "completion", "eval_long_seq_completion"),
             ("try_final_long_seq_generation", "generation", "eval_long_seq_generation"),
             ("final_motion_completion", "completion_sw", "eval_completion_single_window"),
             ("try_interpolation_w_trajectory_single_window", "interpolation_sw",
              "eval_interpolation_w_trajectory_single_window"),
             ("test_model_rec", "reconstruction", "eval_reconstruction"))
    chosen = [(task, out) for flag, task, out in tasks if getattr(args, flag)]
    if not chosen:
        p.error("choose one of the task flags")
    task, out_name = chosen[0]
    output_dir = os.path.join(args.output_path, out_name, model_name)
    if mh.is_primary():  # under several ranks the primary writes every file
        os.makedirs(output_dir, exist_ok=True)

    trainer, _, _, _ = build_trainer(cfg, output_dir, device=device)
    if args.test_model:
        trainer.load_params(args.test_model)
    model = trainer.state.model

    traj_runner = traj = None
    if args.trajectory_config:
        from ..models.trajectory import TrajectoryRunner
        from ..train.trainer import Trainer

        t_trainer = Trainer(load_config(args.trajectory_config),
                            os.path.join(output_dir, "traj"), device=device,
                            mean_std=trainer.mean_std)
        if args.trajectory_test_model:
            t_trainer.load_params(args.trajectory_test_model)
        traj = (t_trainer.state.model, trainer.mean_std)
        traj_runner = TrajectoryRunner(*traj)
    if task == "interpolation_sw" and traj is None:
        # without a trajectory model the run would be plain interpolation
        # written into the *_w_trajectory directory
        p.error("--try_interpolation_w_trajectory_single_window requires "
                "--trajectory_config/--trajectory_test_model")

    mprob = args.missing_joint_prob
    if mprob is None:
        mprob = cfg.data.missing_joint_prob or 0.3
    eval_kwargs = {}
    if task == "completion_sw":
        eval_kwargs = (dict(mask_dir=args.mask_dir) if args.mask_dir else
                       dict(missing="random", missing_joint_prob=mprob, seed=cfg.run.seed))
    eval_ds = EvalMotionDataset(os.path.join(cfg.data.data_root, "seqs"),
                                resolve_split_json(cfg, "test"), **eval_kwargs)
    W = cfg.model.train_seq_len
    n_eval = len(eval_ds) if args.max_seqs < 0 else min(args.max_seqs, len(eval_ds))
    run = dict(args=args, eval_ds=eval_ds, n_eval=n_eval, W=W, output_dir=output_dir,
               traj_runner=traj_runner)

    if task == "reconstruction":
        from ..apps.inference import VAEInference

        _run_reconstruction(VAEInference(model, cfg, device=device), group=group, **run)
        return
    if task == "interpolation_sw":
        # the keyframe trajectory loss inside the solver
        lat = dataclasses.replace(cfg.latent_opt, optimize_trajectory=True,
                                  reg_w_trajectory=cfg.latent_opt.reg_w_trajectory or 1.0)
        apps = LatentOptApps(model, dataclasses.replace(cfg, latent_opt=lat), trajectory=traj,
                             group=group)
    else:
        apps = LatentOptApps(model, cfg, group=group)
    seed = cfg.run.seed
    if task in ("completion_sw", "interpolation_sw"):
        _run_single_window(apps, seed, task, **run)
    elif task == "completion":
        missing = "upper" if cfg.latent_opt.missing_upper_completion else "lower"
        _run_completion_batched(apps, seed, missing, **run)
    elif task == "generation":
        _run_generation_batched(apps, seed, **run)
    else:
        _run_interpolation(apps, seed, cfg, **run)


def eval_config(cfg):
    """``cfg`` without its training execution keys: the optimizer's
    parameter and moment storage, the data wire and the run's dispatch and
    checkpoint modes at their defaults (the solver's own dtypes are
    ``latent_opt``'s)."""
    from ..utils.config import DataConfig, OptimConfig, RunConfig

    def defaults(section, cls, names):
        return dataclasses.replace(section, **{n: getattr(cls, n) for n in names})

    return dataclasses.replace(
        cfg, optim=defaults(cfg.optim, OptimConfig, ("param_dtype", "moment_dtype")),
        data=defaults(cfg.data, DataConfig, ("compact_transfer", "wire_format")),
        run=defaults(cfg.run, RunConfig, ("steps_per_call", "async_checkpoint")))


def _gen(seed: int, offset: int) -> torch.Generator:
    """The z generator of one solve: (seed, offset) as the JAX package's
    ``fold_in(PRNGKey(seed), offset)``."""
    return torch.Generator().manual_seed((seed << 24) + offset)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _metrics(pose, gt_pose) -> dict:
    from ..apps.metrics import accel_error, mpjpe

    pose, gt = torch.as_tensor(_np(pose)), torch.as_tensor(_np(gt_pose))
    return {"mpjpe": float(mpjpe(pose, gt)), "accel_err": float(accel_error(pose, gt))}


def _iter_eligible(eval_ds, n_eval, W):
    """Test items with at least one window, loaded one at a time."""
    for i in range(n_eval):
        it = eval_ds[i]
        if it["rot_mat"].shape[0] >= W:
            yield it


def _chunked(iterable, size):
    it = iter(iterable)
    while True:
        chunk = list(itertools.islice(it, size))
        if not chunk:
            return
        yield chunk


def _pad_chunk(chunk, size, ci):
    """(chunk, n_real): after the first, a chunk is padded to ``size`` by
    repeating its last item, as the JAX package pads (padded rows discarded;
    with a shared decoder clone they weigh in, so the port keeps them)."""
    n_real = len(chunk)
    if ci == 0:
        return chunk, n_real
    return chunk + [chunk[-1]] * (size - n_real), n_real


def _save_seq_outputs(name, rotmat, output_dir, traj_runner=None, gen_vis=False):
    """The optimised rotations and, with a trajectory model, its world-space
    poses of them; with ``gen_vis`` an animation of those (or of the
    rotations' FK poses).  The primary rank's: every rank holds them."""
    from ..ops import fk as fk_mod
    from ..parallel.multihost import is_primary

    if not is_primary():
        return

    rotmat = _np(rotmat)
    np.save(os.path.join(output_dir, f"{name}_rot_opt_res.npy"), rotmat)
    pose = None
    if traj_runner is not None:
        from ..ops import rotations as rot

        world, _ = traj_runner(rot.rotmat_to_rot6d(torch.as_tensor(rotmat))[None])
        pose = _np(world[0])
        np.save(os.path.join(output_dir, f"{name}_root_trans_opt_res.npy"), pose)
    if gen_vis:
        from ..utils.viz import save_animation

        if pose is None:
            pose = fk_mod.fk_numpy(rotmat.astype(np.float32))
        save_animation(pose[None], os.path.join(output_dir, f"{name}.mp4"))


def _write_summary(results, output_dir):
    from ..parallel.multihost import is_primary

    if not is_primary():
        return
    if not results:
        print("no test sequences long enough for one window")
        return
    keys = sorted({k for _, m in results for k in m})
    summary = {k: float(np.mean([m[k] for _, m in results if k in m])) for k in keys}
    summary["num_seqs"] = len(results)
    print("summary:", summary, flush=True)
    with open(os.path.join(output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


def _run_interpolation(apps, seed, cfg, args, eval_ds, n_eval, W, output_dir, traj_runner):
    """Long-sequence interpolation: one batched solve per sequence (its
    windows), or per chunk of sequences with --batch_across_seqs; MPJPE and
    acceleration error against the ground truth's FK, and the SLERP
    baseline's MPJPE on one-window sequences."""
    from ..apps.baselines import slerp_rotations
    from ..apps.metrics import mpjpe
    from ..apps.tasks import interpolation_mask
    from ..ops import fk as fk_mod

    results = []
    for ci, chunk in enumerate(_chunked(_iter_eligible(eval_ds, n_eval, W), args.chunk)):
        if args.batch_across_seqs:
            outs = apps.interpolate_many([it["rot_mat"] for it in chunk], _gen(seed, 7000 + ci))
        else:
            outs = [apps.interpolate(it["rot_mat"], _gen(seed, 7000 + ci * args.chunk + j))
                    for j, it in enumerate(chunk)]
        for it, out in zip(chunk, outs):
            rotmat = it["rot_mat"]
            pose = _np(out["pose"])
            T_out = pose.shape[0]
            gt_pose = fk_mod.fk_numpy(rotmat[:T_out])
            m = _metrics(pose, gt_pose)
            if T_out == W:
                tmask = interpolation_mask(W, cfg.latent_opt.interpolation_window)
                slerp = slerp_rotations(rotmat[:W], tmask)
                m["slerp_mpjpe"] = float(mpjpe(torch.as_tensor(fk_mod.fk_numpy(slerp)),
                                               torch.as_tensor(gt_pose)))
            name = it["name"].replace(".npy", "")
            _save_seq_outputs(name, out["rot_mat"], output_dir, traj_runner, args.gen_vis)
            results.append((name, m))
            print(name, m, flush=True)
    _write_summary(results, output_dir)


def _rank_split(fn, x: torch.Tensor, group):
    """``fn`` (a batch -> a tuple of batches) over ``group``'s ranks: the
    batch padded to a multiple of the world size by cycling its rows, each
    rank's contiguous rows through ``fn``, every output gathered to every
    rank (zeroed buffers and an all-reduce: exact) and trimmed."""
    if group is None:
        return fn(x)
    from ..parallel.sharding import gather_rows, rank_rows, world_size

    B = x.shape[0]
    B_pad = -(-B // world_size(group)) * world_size(group)
    r0, r1 = rank_rows(B_pad, group)
    outs = fn(x[torch.arange(r0, r1) % B])
    return tuple(gather_rows(o, B_pad, r0, group)[:B] for o in outs)


def _run_reconstruction(infer, args, eval_ds, n_eval, W, output_dir, traj_runner, group=None):
    """Posterior-mean reconstruction over the test split: every sequence cut
    into non-overlapping windows, a chunk's windows reconstructed in batches
    of 128 (under ``--data_parallel``, each batch's rows split over the
    ranks); MPJPE, PA-MPJPE and acceleration error against the ground
    truth's FK."""
    from ..apps.metrics import pa_mpjpe
    from ..ops import fk as fk_mod
    from ..ops import rotations as rot

    results = []
    for chunk in _chunked(_iter_eligible(eval_ds, n_eval, W), args.chunk):
        counts = [it["rot_mat"].shape[0] // W for it in chunk]
        flat = np.concatenate([it["rot_mat"][:n * W].reshape(n, W, 24, 3, 3)
                               for it, n in zip(chunk, counts)])
        parts = [_rank_split(infer.mean_reconstruction,
                             rot.rotmat_to_rot6d(torch.as_tensor(flat[s:s + 128])), group)
                 for s in range(0, flat.shape[0], 128)]
        rec_rm = np.concatenate([_np(rm) for _, rm, _ in parts])
        rec_pose = np.concatenate([_np(rp) for _, _, rp in parts])
        o = 0
        for it, n in zip(chunk, counts):
            T_out = n * W
            seq_rm = rec_rm[o:o + n].reshape(T_out, 24, 3, 3)
            seq_pose = rec_pose[o:o + n].reshape(T_out, 24, 3)
            o += n
            gt_pose = fk_mod.fk_numpy(it["rot_mat"][:T_out])
            m = _metrics(seq_pose, gt_pose)
            m["pa_mpjpe"] = float(pa_mpjpe(torch.as_tensor(seq_pose), torch.as_tensor(gt_pose)))
            name = it["name"].replace(".npy", "")
            _save_seq_outputs(name, seq_rm, output_dir, traj_runner, args.gen_vis)
            results.append((name, m))
            print(name, m, flush=True)
    _write_summary(results, output_dir)


def _run_completion_batched(apps, seed, missing, args, eval_ds, n_eval, W, output_dir,
                            traj_runner):
    """Long-sequence completion, batched across a chunk's sequences per
    window index."""
    from ..ops import fk as fk_mod

    results = []
    for ci, chunk in enumerate(_chunked(_iter_eligible(eval_ds, n_eval, W), args.chunk)):
        chunk, n_real = _pad_chunk(chunk, args.chunk, ci)
        outs = apps.complete_many([it["rot_mat"] for it in chunk], _gen(seed, 5000 + ci),
                                  missing=missing)
        for it, out in zip(chunk[:n_real], outs[:n_real]):
            pose = _np(out["pose"])
            m = _metrics(pose, fk_mod.fk_numpy(it["rot_mat"][:pose.shape[0]]))
            name = it["name"].replace(".npy", "")
            _save_seq_outputs(name, out["rot_mat"], output_dir, traj_runner, args.gen_vis)
            results.append((name, m))
            print(name, m, flush=True)
    _write_summary(results, output_dir)


def _run_generation_batched(apps, seed, args, eval_ds, n_eval, W, output_dir, traj_runner):
    """Autoregressive generation, batched across a chunk's sequences per
    window round, from each sequence's first window."""
    results = []
    for ci, chunk in enumerate(_chunked(_iter_eligible(eval_ds, n_eval, W), args.chunk)):
        chunk, n_real = _pad_chunk(chunk, args.chunk, ci)
        outs = apps.generate_many([it["rot_mat"][:W] for it in chunk], _gen(seed, 3000 + ci),
                                  num_windows=5, overlap=10)
        for it, out in zip(chunk[:n_real], outs[:n_real]):
            m = {"length": out["pose"].shape[0]}
            name = it["name"].replace(".npy", "")
            _save_seq_outputs(name, out["rot_mat"], output_dir, traj_runner, args.gen_vis)
            results.append((name, m))
            print(name, m, flush=True)
    _write_summary(results, output_dir)


def _run_single_window(apps, seed, task, args, eval_ds, n_eval, W, output_dir, traj_runner):
    """One-window completion, or interpolation under the keyframe trajectory
    loss, a chunk of sequences per batched solve, with the MPJPE of the
    missing (unsupervised) joints."""
    from ..ops import fk as fk_mod

    results = []
    for ci, chunk in enumerate(_chunked(_iter_eligible(eval_ds, n_eval, W), args.chunk)):
        chunk, n_real = _pad_chunk(chunk, args.chunk, ci)
        wins = np.stack([it["rot_mat"][:W] for it in chunk])
        if task == "completion_sw":
            masks = np.stack([it["mask"][:W] for it in chunk])
            out = apps.complete_single_window(wins, masks, _gen(seed, 1000 + ci))
        else:
            # the ground truth's root translation: frame-0 velocity zeroed,
            # then accumulated
            rv = np.stack([it["root_v"][:W] for it in chunk]).astype(np.float32)
            rv[:, 0] = 0.0
            out = apps.interpolate_single_window(wins, _gen(seed, 1000 + ci),
                                                 root_trans=np.cumsum(rv, axis=1))
        pose, mask, rotm = _np(out["pose"]), _np(out["mask"]), _np(out["rot_mat"])
        for j, it in enumerate(chunk[:n_real]):
            gt_pose = fk_mod.fk_numpy(it["rot_mat"][:W])
            m = _metrics(pose[j], gt_pose)
            missing = 1.0 - mask[j]
            if missing.sum() > 0:
                err = np.linalg.norm(pose[j] - gt_pose, axis=-1)
                m["mpjpe_missing"] = float((err * missing).sum() / missing.sum())
            name = it["name"].replace(".npy", "")
            _save_seq_outputs(name, rotm[j], output_dir, traj_runner, args.gen_vis)
            results.append((name, m))
            print(name, m, flush=True)
    _write_summary(results, output_dir)


if __name__ == "__main__":
    main()
