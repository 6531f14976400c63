"""Export trained models as ``torch.export`` serving bundles (port of
``hm_vae_tpu.cli.export_model``).

Turns a reference-format ``gen_*.pt`` (the port's training checkpoints, or a
JAX checkpoint converted by ``scripts/jax_checkpoint_to_pt.py``) into a
directory of ``torch.export`` programs: posterior-mean reconstruction,
encoder, decoder and, optionally, the root-trajectory predictor, loadable
with ``hm_vae_torch.apps.export.load_exported`` in a process that has
``torch`` and the port's operator registration only (see
``hm_vae_torch/apps/export.py``).

    python -m hm_vae_torch.cli.export_model --config configs/len64_no_aug_hm_vae.yaml \\
        --test_model gen_00250000.pt --trajectory_config configs/trajectory_model.yaml \\
        --trajectory_test_model gen_traj.pt --out exported/ [--serve_dtype bfloat16]

Without ``--test_model`` the weights are a random init from the config's
``run.seed`` (pipeline smoke tests).  The bundle is exported on ``--device``
(``cuda`` unless told; it serves on any device, see ``load_exported``).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="Export a serving bundle (torch.export)")
    p.add_argument("--config", type=str, required=True, help="VAE config yaml")
    p.add_argument("--test_model", type=str, default="",
                   help="gen_*.pt to export (a seeded random init if empty, for pipeline "
                        "smoke tests)")
    p.add_argument("--out", type=str, required=True, help="output bundle directory")
    p.add_argument("--trajectory_config", type=str, default="",
                   help="optionally add the trajectory predictor")
    p.add_argument("--trajectory_test_model", type=str, default="")
    p.add_argument("--mean_std", type=str, default="",
                   help="dataset stats npy for the trajectory export (default: the vendored "
                        "AMASS stats)")
    p.add_argument("--serve_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16: bf16 weight constants and bf16 conv compute (a quarter of "
                        "the f32 packed tiles); ~1e-2 output deviation")
    p.add_argument("--device", type=str, default="cuda", help="the device to export on")
    args = p.parse_args(argv)

    import torch

    from ..apps.export import export_bundle
    from ..data import layout
    from ..models.hm_vae import HMVAE
    from ..models.trajectory import TrajectoryModel
    from ..utils.config import load_config
    from ..utils.device import resolve_device
    from ..utils.weights import load_reference_checkpoint, state_dict_from_reference

    device = resolve_device(args.device)

    def model(cls, cfg, path):
        m = cls(cfg.model, cfg.optim.init,
                generator=torch.Generator().manual_seed(cfg.run.seed))
        if path:
            m.load_state_dict(state_dict_from_reference(load_reference_checkpoint(path),
                                                        cfg.model))
        return m.to(device).eval()

    cfg = load_config(args.config)
    trajectory = None
    if args.trajectory_config:
        tcfg = load_config(args.trajectory_config)
        trajectory = (model(TrajectoryModel, tcfg, args.trajectory_test_model),
                      layout.load_mean_std(args.mean_std))
    manifest = export_bundle(args.out, model(HMVAE, cfg, args.test_model), cfg,
                             trajectory=trajectory, serve_dtype=args.serve_dtype)
    print(json.dumps({
        "out": args.out,
        "functions": {k: v["bytes"] for k, v in manifest["functions"].items()},
        "device": manifest["device"],
        "serve_dtype": manifest["serve_dtype"],
    }))


if __name__ == "__main__":
    main()
