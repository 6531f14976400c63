"""Whether training at bf16 conv compute diverges because of the bf16
backward kernels or because of the learning rate (run from the repo root on
a GPU):

    python3 scripts/torch_bf16_lr_divergence.py [--lr 1e-3] [--steps 40]

Runs the JAX package's convergence criterion's setting (chip_smoke.py phase
35 (d): one fixed batch of the native sampler's f16 aa wire, fresh noise
each step, eager steps from one init) on ``configs/len64_production.yaml``
at batch 8 and ``--lr``: at bf16 compute through the bf16 dgrad and wgrad
kernels, at bf16 compute with the backward kernels replaced by their plain
PyTorch versions on the card, at bf16 compute on the batch scaled by
1 + 2^-7 (a perturbation that survives the cast to bf16), and at f32
compute.  Prints one JSON line a run: its losses and the kernels' launches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_lr_divergence.py needs a GPU")
    import chip_smoke
    from hm_vae_torch.data.dataset import make_loaders
    from hm_vae_torch.ops import fused_conv_pool as fcp

    kernels = fcp.fused_conv_pool_dgrad, fcp.fused_conv_pool_wgrad

    def plain_dgrad(gy, y, weight, s, T_in):
        return fcp.fused_conv_pool_dgrad_reference(
            gy, y, weight, T_in, s.stride, s.padding, "reflect" if s.reflect else "constant",
            s.negative_slope)

    def plain_wgrad(gy, y, x, s):
        return fcp.fused_conv_pool_wgrad_reference(
            gy, y, x, s.kernel_size, s.stride, s.padding,
            "reflect" if s.reflect else "constant", s.negative_slope,
            s.live_elements().to(gy.device))

    root = os.path.join(chip_smoke.OUT_DIR, "train_data")
    for run, compute, plain, scale in (("kernels", "bfloat16", False, 1.0),
                                       ("plain_backward", "bfloat16", True, 1.0),
                                       ("kernels_perturbed", "bfloat16", False, 1.0 + 2 ** -7),
                                       ("f32_compute", "float32", False, 1.0)):
        cfg = chip_smoke.production_config(root, optim={"batch_size": chip_smoke.BATCH,
                                                        "lr": args.lr},
                                           model={"compute_dtype": compute})
        stream = make_loaders(cfg)[0].iter_compact_superbatches(
            1, chip_smoke.BATCH, False, cfg.data.native_threads, "aa", dtype=np.float16)
        batch = {"aa": torch.from_numpy(next(stream)["aa"][0]).to("cuda").float() * scale}
        stream.close()
        fcp.fused_conv_pool_dgrad, fcp.fused_conv_pool_wgrad = (
            (plain_dgrad, plain_wgrad) if plain else kernels)
        try:
            losses, entries, runs = chip_smoke._criterion_run(cfg, batch, args.steps)
        finally:
            fcp.fused_conv_pool_dgrad, fcp.fused_conv_pool_wgrad = kernels
        print(json.dumps({"run": run, "lr": args.lr, "losses": losses.tolist(),
                          "entry_launches": entries, "device_runs": runs}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
