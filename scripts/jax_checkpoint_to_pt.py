"""Convert a JAX Trainer checkpoint into a ``gen_*.pt`` for the PyTorch port.

The JAX package's Trainer writes orbax checkpoints (``<run>/checkpoints/
gen_*`` directories); the port's CLIs read reference-format ``gen_*.pt``
files (``{"state_dict": ...}`` in the reference implementation's names,
``hm_vae_torch/utils/weights.py``).  This script reads the parameters of a
checkpoint for a config, the HM-VAE or the root-trajectory model, and writes
that file:

    python scripts/jax_checkpoint_to_pt.py --config configs/len64_no_aug_hm_vae.yaml \\
        --checkpoint outputs/len64/checkpoints/gen_000250000 --out gen_00250000.pt

- the HM-VAE through the JAX package's ``export_hmvae_params`` (the conv
  masks and pool/unpool matrices included; a compact-layout tree is
  densified);
- the trajectory model through the port's ``trajectory_params_from_flax``
  and ``trajectory_reference_state_dict``.

It needs the JAX package (jax, flax, orbax) and the port, so it lives
outside ``hm_vae_torch/``, which never imports JAX.  The parameters are read
on JAX's default platform; set ``JAX_PLATFORMS=cpu`` on a machine whose
accelerator is busy.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def convert(config: str, checkpoint: str, out: str) -> str:
    """Write the parameters of the JAX checkpoint ``checkpoint`` (a model of
    the config file ``config``) to ``out`` as a reference-format
    ``gen_*.pt``; returns ``out``."""
    import jax
    import torch

    from hm_vae_tpu.data import layout
    from hm_vae_tpu.train.trainer import Trainer
    from hm_vae_tpu.utils.config import load_config
    from hm_vae_tpu.utils.torch_import import export_hmvae_params
    from hm_vae_torch.utils import config as port_config
    from hm_vae_torch.utils.weights import (trajectory_params_from_flax,
                                            trajectory_reference_state_dict)

    cfg = load_config(config)
    trajectory = cfg.model.model_name == "TrajectoryModel"
    with tempfile.TemporaryDirectory(prefix="jax_checkpoint_to_pt_") as scratch:
        trainer = Trainer(cfg, scratch, mean_std=layout.load_mean_std() if trajectory else None)
        trainer.load_params(os.path.abspath(checkpoint))
        params = jax.tree.map(np.asarray, jax.device_get(trainer.state.params))
    if trajectory:
        mcfg = port_config.load_config(config).model
        sd = trajectory_reference_state_dict(trajectory_params_from_flax(params, mcfg), mcfg)
    else:
        sd = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in export_hmvae_params(params, cfg.model).items()}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({"state_dict": sd}, out)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True, help="the model's config yaml")
    p.add_argument("--checkpoint", required=True, help="a JAX Trainer gen_* checkpoint")
    p.add_argument("--out", required=True, help="the gen_*.pt to write")
    args = p.parse_args(argv)
    print(convert(args.config, args.checkpoint, args.out))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)  # run as a script: the packages sit at the repo root
    main()
