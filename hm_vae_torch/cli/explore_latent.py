"""Latent-space exploration CLI (port of ``hm_vae_tpu.cli.explore_latent``).

    python -m hm_vae_torch.cli.explore_latent --config <yaml> [--test_model gen_*.pt] \\
        --check_hier_latent_space | --vis_given_z_vec z.npz [--device cpu]

``--check_hier_latent_space`` runs three probes (``apps/latent_space.py``):
per-level prior sweeps, level swaps between two test motions and a
latent-space interpolation between them; ``--vis_given_z_vec`` decodes a
saved ``np.savez`` z list (its arrays in the order of their sorted keys).
Each probe writes ``<name>_pose.npy`` and ``<name>_rot.npy`` under
``<output_path>/latent_space/<config name>/``, and ``index.json`` maps the
names to the poses' shapes, as the JAX package's CLI writes them.  Runs on
``--device cuda`` unless told otherwise.  ``--gen_vis`` also renders each
probe's first sequence (``<name>.mp4``, or a gif without ffmpeg; it needs
matplotlib).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Hierarchical latent exploration")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--output_path", type=str, default="./")
    p.add_argument("--test_model", type=str, default="", help="gen_*.pt checkpoint")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--num_samples", type=int, default=4,
                   help="prior samples per level in the sweep")
    p.add_argument("--num_lerp", type=int, default=5,
                   help="interpolation points between the two motions")
    p.add_argument("--gen_vis", action="store_true")
    p.add_argument("--check_hier_latent_space", action="store_true")
    p.add_argument("--vis_given_z_vec", type=str, default="",
                   help="path to an .npz of z arrays to decode")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if not (args.check_hier_latent_space or args.vis_given_z_vec):
        p.error("choose --check_hier_latent_space and/or --vis_given_z_vec")
    import torch

    from ..apps import latent_space as ls
    from ..apps.inference import VAEInference
    from ..data.dataset import EvalMotionDataset, resolve_split_json
    from ..ops import rotations as rot
    from ..train.trainer import build_trainer
    from ..utils.config import load_config
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.data_root:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                data_root=args.data_root))
    model_name = os.path.splitext(os.path.basename(args.config))[0]
    output_dir = os.path.join(args.output_path, "latent_space", model_name)
    os.makedirs(output_dir, exist_ok=True)

    trainer, _, _, _ = build_trainer(cfg, output_dir, device=device)
    if args.test_model:
        trainer.load_params(args.test_model)
    infer = VAEInference(trainer.state.model, cfg, device=device)
    index = {}

    def emit(name, out):
        _, rm, pose = (t.float().cpu().numpy() for t in out)
        np.save(os.path.join(output_dir, f"{name}_pose.npy"), pose)
        np.save(os.path.join(output_dir, f"{name}_rot.npy"), rm)
        index[name] = list(pose.shape)
        if args.gen_vis:
            from ..utils.viz import save_animation

            save_animation(pose[:1], os.path.join(output_dir, f"{name}.mp4"))

    if args.vis_given_z_vec:
        with np.load(args.vis_given_z_vec) as zf:
            zs = [zf[k] for k in sorted(zf.files)]
        emit("given_z", ls.decode_given_z(infer, zs))

    if args.check_hier_latent_space:
        sweep = ls.level_sweep(infer, torch.Generator().manual_seed(cfg.run.seed),
                               batch=args.num_samples)
        for name, out in sweep.items():
            emit(f"sweep_{name}", out)

        # two test motions for the swap and lerp probes: windows of two
        # sequences, or two non-overlapping windows of one long enough
        W = cfg.model.train_seq_len
        ds = EvalMotionDataset(os.path.join(cfg.data.data_root, "seqs"),
                               resolve_split_json(cfg, "test"))
        picks, fallback = [], None
        for i in range(len(ds)):
            mats = ds[i]["rot_mat"]
            if mats.shape[0] >= W:
                picks.append(mats[:W])
                if len(picks) == 1 and mats.shape[0] >= 2 * W:
                    fallback = mats[W:2 * W]
            if len(picks) == 2:
                break
        if len(picks) == 1 and fallback is not None:
            picks.append(fallback)
        if len(picks) == 2:
            a6, b6 = (rot.rotmat_to_rot6d(torch.as_tensor(m)[None]) for m in picks)
            nl = cfg.model.num_layers
            emit("swap_shallow_from_b", ls.level_swap(infer, a6, b6, 0))
            emit("swap_deep_from_b", ls.level_swap(infer, a6, b6, nl - 1))
            for i, out in enumerate(ls.latent_lerp(infer, a6, b6, num=args.num_lerp)):
                emit(f"lerp_{i}", out)
        else:
            print("fewer than two window-length test sequences; skipped swap/lerp probes")

    with open(os.path.join(output_dir, "index.json"), "w") as f:
        json.dump(index, f, indent=2)
    print("wrote", len(index), "probes to", output_dir)


if __name__ == "__main__":
    main()
