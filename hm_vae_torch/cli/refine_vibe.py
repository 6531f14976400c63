"""VIBE-output refinement CLI (port of ``hm_vae_tpu.cli.refine_vibe``).

Takes a ``vibe_output.pkl`` (dict of person -> {'pose': (T, 72)}) or a raw
``(T, 72)`` axis-angle ``.npy``, refines each sequence by sliding
center-frame mean reconstruction (all windows in one batched call), and saves
our and VIBE's rotation matrices.

    python -m hm_vae_torch.cli.refine_vibe --config configs/len64_no_aug_hm_vae.yaml \
        --vibe_output poses.npy --output_path out/ [--test_model gen_00250000.pt]

``--test_model`` takes a reference-format ``gen_*.pt``; without it the model
is a seeded random init (``--seed``).  ``--gen_vis`` also renders VIBE's
and the refined poses side by side (``<name>_cmp.mp4``, or a gif without
ffmpeg; it needs matplotlib).  Runs on ``--device cuda`` unless told
otherwise.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_pose_sequences(path: str):
    """Yield (name, (T, 72) axis-angle) from a VIBE pkl or a npy file."""
    if path.endswith(".pkl"):
        import joblib

        data = joblib.load(path)
        for pid, entry in data.items():
            yield str(pid), np.asarray(entry["pose"], np.float32)
    else:
        arr = np.load(path)
        if arr.ndim == 2 and arr.shape[1] == 72:
            yield os.path.splitext(os.path.basename(path))[0], arr.astype(np.float32)
        else:
            raise ValueError(f"expected (T, 72) axis-angle npy, got {arr.shape}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Refine VIBE pose estimates")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--test_model", type=str, default="",
                   help="reference-format gen_*.pt checkpoint")
    p.add_argument("--vibe_output", type=str, required=True,
                   help="vibe_output.pkl or (T,72) axis-angle .npy")
    p.add_argument("--output_path", type=str, default="./")
    p.add_argument("--gen_vis", action="store_true")
    p.add_argument("--vibe_order_6d", action="store_true",
                   help="also save refined 6D in VIBE layout for re-injection")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init when no --test_model is given")
    args = p.parse_args(argv)

    import torch

    from ..apps.inference import VAEInference, aa_to_all_reps
    from ..models.hm_vae import HMVAE
    from ..ops import fk as fk_mod
    from ..ops import rotations as rot
    from ..utils.config import load_config
    from ..utils.device import resolve_device
    from ..utils.weights import load_reference_checkpoint, state_dict_from_reference

    def to_numpy(t):
        return t.float().cpu().numpy()

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    output_dir = os.path.join(args.output_path, "refine_vibe")
    os.makedirs(output_dir, exist_ok=True)

    model = HMVAE(cfg.model, cfg.optim.init,
                  generator=torch.Generator().manual_seed(args.seed))
    if args.test_model:
        model.load_state_dict(state_dict_from_reference(
            load_reference_checkpoint(args.test_model), cfg.model))
    infer = VAEInference(model, cfg, device=device)

    with torch.inference_mode():
        for name, aa in load_pose_sequences(args.vibe_output):
            six, mats, pose = aa_to_all_reps(torch.as_tensor(aa[None], device=device))
            refined_rot = rot.rot6d_to_rotmat(infer.refine_sliding_window(six[0]))
            np.save(os.path.join(output_dir, f"{name}_our_rot_mat.npy"),
                    to_numpy(refined_rot))
            np.save(os.path.join(output_dir, f"{name}_vibe_rot_mat.npy"),
                    to_numpy(mats[0]))
            if args.vibe_order_6d:
                vibe6d = rot.rot6d_ours_to_vibe(rot.rotmat_to_rot6d(refined_rot))
                np.save(os.path.join(output_dir, f"{name}_our_6d_vibe_order.npy"),
                        to_numpy(vibe6d))
            if args.gen_vis:
                from ..utils.viz import save_animation

                ours = to_numpy(fk_mod.fk_from_rotmat(refined_rot, fk_mod.default_offsets()))
                ours[:, :, 0] += 1.0  # offset for side-by-side (reference :904)
                save_animation(np.stack([to_numpy(pose[0]), ours]),
                               os.path.join(output_dir, f"{name}_cmp.mp4"))
            print(f"refined {name}: {aa.shape[0]} frames")


if __name__ == "__main__":
    main()
