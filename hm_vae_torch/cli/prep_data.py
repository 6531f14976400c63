"""Data preparation CLI (port of ``hm_vae_tpu.cli.prep_data``).

    python -m hm_vae_torch.cli.prep_data --amass_dir <raw AMASS root> --dest <dir> [--fps 30]

converts ``<amass_dir>/<subset>/<subject>/*.npz`` (SMPL-H ``poses``,
``trans``, ``mocap_framerate``) into ``<dest>/seqs/*.npy`` (579-dim frames),
``<dest>/{train,val,test}.json`` (split by AMASS subset) and
``<dest>/mean_std.npy`` (over the train split), as the reference's
``utils/process_all_data_motion.py`` + ``divide_train_val_json.py`` do;
``--fps 0`` keeps each sequence's frame rate.  ``--synthetic N`` writes N
synthetic sequences in the same layout instead.

``--gen_masks P [P2 ...]`` writes the per-frame random joint masks of the
``missing_joint_prob`` completion evaluation, which ``eval_recovery
--mask_dir`` loads: one (T, 24) 0/1 npy (1 = visible) per sequence of
``--mask_split`` (default test) under ``<dest>/eval_masks/missing_prob_<P>/``,
seeded by crc32 of (seed, P, name): the JAX package's masks, bit for bit.

Runs on the host (numpy and scipy); no device is used.
"""

from __future__ import annotations

import argparse
import json
import os
import zlib

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Prepare motion data")
    p.add_argument("--amass_dir", type=str, default="")
    p.add_argument("--dest", type=str, required=True)
    p.add_argument("--fps", type=int, default=30,
                   help="target fps (0 keeps original framerate)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic sequences instead of AMASS")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gen_masks", type=float, nargs="+", default=None, metavar="PROB",
                   help="generate per-frame random joint-visibility masks for these "
                        "missing_joint_prob values over --mask_split")
    p.add_argument("--mask_split", type=str, default="test",
                   choices=("train", "val", "test"))
    args = p.parse_args(argv)

    if args.gen_masks:
        written = generate_masks(args.dest, args.gen_masks, split=args.mask_split,
                                 seed=args.seed)
        for prob, (d, n) in written.items():
            print(f"missing_prob_{prob}: {n} masks -> {d}")
        return

    if args.synthetic:
        from ..data.synthetic import generate_dataset

        generate_dataset(args.dest, num_seqs=args.synthetic, seed=args.seed)
        print(f"wrote {args.synthetic} synthetic sequences to {args.dest}")
        return

    if not args.amass_dir:
        p.error("provide --amass_dir or --synthetic N")
    from ..data.amass_prep import process_amass_root

    splits = process_amass_root(args.amass_dir, args.dest,
                                target_fps=args.fps if args.fps > 0 else None)
    print({k: len(v) for k, v in splits.items()})


def generate_masks(data_root: str, probs, split: str = "test", seed: int = 0):
    """Write (T, 24) 0/1 visibility masks (1 = visible) per sequence of
    ``split``, one folder per missing probability; deterministic per
    (seed, prob, name).  Returns {prob: (folder, count)}."""
    with open(os.path.join(data_root, f"{split}.json")) as f:
        ids = json.load(f)
    names = [ids[k] for k in sorted(ids, key=int)]
    out = {}
    for prob in probs:
        dest = os.path.join(data_root, "eval_masks", f"missing_prob_{prob}")
        os.makedirs(dest, exist_ok=True)
        for name in names:
            T = np.load(os.path.join(data_root, "seqs", name), mmap_mode="r").shape[0]
            # stable across processes (Python's str hash is salted)
            rng = np.random.default_rng(zlib.crc32(f"{seed}/{prob}/{name}".encode()))
            np.save(os.path.join(dest, name), (rng.random((T, 24)) >= prob).astype(np.float32))
        out[prob] = (dest, len(names))
    return out


if __name__ == "__main__":
    main()
