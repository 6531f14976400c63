"""Trajectory-model evaluation CLI (port of ``hm_vae_tpu.cli.eval_trajectory``):

    python -m hm_vae_torch.cli.eval_trajectory --config configs/len64_no_aug_hm_vae.yaml \\
        --test_model gen_vae.pt --trajectory_config configs/trajectory_model.yaml \\
        --trajectory_test_model gen_traj.pt --pred_trajectory_for_single_window \\
        [--debug_trajectory] [--seq_generation_npy_path seq.npy] [--device cpu]

``--pred_trajectory_for_single_window`` decodes prior samples of the VAE and
runs the trajectory model on them; ``--seq_generation_npy_path`` /
``--seq_generation_npy_folder`` run it on saved (T, 24, 3, 3) rotation
sequences, each whole in one call; ``--debug_trajectory`` runs ground-truth
test windows through it.  Each sequence b of a run tagged ``tag`` is saved as
``{tag}_{b}.npy`` (T, 24, 9: the 6D rotations and the world-space positions)
and ``{tag}_{b}_trans.npy`` (the root's world positions, (T, 3)) under
``<output_path>/eval_trajectory/<config name>[_<out_tag>]/``.  ``--device``
defaults to ``cuda`` and raises without CUDA unless ``--device cpu`` is
given.  ``--gen_vis`` also renders each sequence's world-space poses
(``{tag}_{b}.mp4``, or a gif without ffmpeg; it needs matplotlib).

``--sequence_parallel N`` splits the trajectory model's time axis over N
ranks (torchrun with ``HMVAE_DIST=1``; halo exchange per level, any length
padded and trimmed unless ``--sequence_parallel_strict``); every rank loads
the same sequences, and the primary rank writes the files:

    HMVAE_DIST=1 python -m torch.distributed.run --nproc_per_node N \
        -m hm_vae_torch.cli.eval_trajectory --sequence_parallel N ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description="Trajectory prediction evaluation")
    p.add_argument("--config", type=str, required=True, help="VAE config (for sampling)")
    p.add_argument("--test_model", type=str, default="")
    p.add_argument("--trajectory_config", type=str, required=True)
    p.add_argument("--trajectory_test_model", type=str, default="")
    p.add_argument("--output_path", type=str, default="./")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--gen_vis", action="store_true")
    # the reference's literal flags: --vis_iters x --vis_bs bounds the
    # sampled sequences (--num_samples wins), --out_tag suffixes the
    # output directory
    p.add_argument("--vis_iters", type=int, default=None)
    p.add_argument("--vis_bs", type=int, default=None)
    p.add_argument("--out_tag", type=str, default="")
    p.add_argument("--pred_trajectory_for_single_window", action="store_true")
    p.add_argument("--seq_generation_npy_path", type=str, default="")
    p.add_argument("--seq_generation_npy_folder", type=str, default="")
    p.add_argument("--debug_trajectory", action="store_true")
    p.add_argument("--sequence_parallel", type=int, default=1,
                   help="split the trajectory model's time axis over N ranks (torchrun with "
                        "HMVAE_DIST=1)")
    p.add_argument("--sequence_parallel_strict", action="store_true",
                   help="with --sequence_parallel: demand T %% N == 0 instead of padding and "
                        "trimming (the padded tail's last velocities see repeated frames)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from ..apps.inference import VAEInference
    from ..models.trajectory import TrajectoryRunner
    from ..ops import rotations as rot
    from ..parallel import multihost as mh
    from ..train.trainer import Trainer, build_trainer
    from ..utils.config import load_config
    from . import start

    device = start(args.device)
    if mh.process_count() != args.sequence_parallel:
        raise ValueError(
            f"--sequence_parallel {args.sequence_parallel} needs as many ranks, this run has "
            f"{mh.process_count()}: start it as HMVAE_DIST=1 python -m torch.distributed.run "
            f"--nproc_per_node {args.sequence_parallel} -m hm_vae_torch.cli.eval_trajectory ...")
    cfg = load_config(args.config)
    if args.data_root:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                data_root=args.data_root))
    if args.num_samples is None:
        args.num_samples = (args.vis_iters * (args.vis_bs or 32)
                            if args.vis_iters is not None else 16)
    model_name = os.path.splitext(os.path.basename(args.config))[0]
    if args.out_tag:
        model_name = f"{model_name}_{args.out_tag}"
    output_dir = os.path.join(args.output_path, "eval_trajectory", model_name)
    if mh.is_primary():  # under several ranks the primary writes every file
        os.makedirs(output_dir, exist_ok=True)

    trainer, _, _, test_ds = build_trainer(cfg, output_dir, device=device)
    if args.test_model:
        trainer.load_params(args.test_model)
    t_trainer = Trainer(load_config(args.trajectory_config), os.path.join(output_dir, "traj"),
                        device=device, mean_std=trainer.mean_std)
    if args.trajectory_test_model:
        t_trainer.load_params(args.trajectory_test_model)
    runner = TrajectoryRunner(t_trainer.state.model, trainer.mean_std,
                              sp_group=mh.process_group(),
                              sp_pad_incomplete=not args.sequence_parallel_strict)

    def run_and_save(rot6d, tag):
        rot6d = torch.as_tensor(np.asarray(rot6d, np.float32)
                                if not torch.is_tensor(rot6d) else rot6d).to(device)
        world, _ = runner(rot6d)
        if not mh.is_primary():  # every rank holds the result; one writes it
            return world
        six, pos = rot6d.cpu().numpy(), world.cpu().numpy()
        for b in range(pos.shape[0]):
            # (T, 24, 9): the 6D rotations beside the world positions
            np.save(os.path.join(output_dir, f"{tag}_{b}.npy"),
                    np.concatenate([six[b], pos[b]], axis=-1))
            np.save(os.path.join(output_dir, f"{tag}_{b}_trans.npy"), pos[b][:, 0, :])
            if args.gen_vis:
                from ..utils.viz import save_animation

                save_animation(pos[b][None], os.path.join(output_dir, f"{tag}_{b}.mp4"))
        return world

    if args.pred_trajectory_for_single_window:
        infer = VAEInference(trainer.state.model, cfg, device=device)
        out6d, _, _ = infer.prior_samples(args.num_samples,
                                          torch.Generator().manual_seed(cfg.run.seed))
        run_and_save(infer.clean_6d(out6d), "sampled_single_window")

    npys = []
    if args.seq_generation_npy_path:
        npys = [args.seq_generation_npy_path]
    elif args.seq_generation_npy_folder:
        npys = [os.path.join(args.seq_generation_npy_folder, f)
                for f in sorted(os.listdir(args.seq_generation_npy_folder))
                if f.endswith(".npy")]
    for path in npys:
        mats = torch.as_tensor(np.load(path), dtype=torch.float32)  # (T, 24, 3, 3)
        run_and_save(rot.rotmat_to_rot6d(mats)[None],
                     os.path.splitext(os.path.basename(path))[0] + "_traj")

    if args.debug_trajectory:
        # ground-truth test windows through the trajectory model
        b = test_ds.sample_batch(min(4, cfg.optim.batch_size))
        world = run_and_save(b["rot_6d"], "debug_gt_window")
        print("debug trajectory shapes:", tuple(world.shape), flush=True)


if __name__ == "__main__":
    main()
