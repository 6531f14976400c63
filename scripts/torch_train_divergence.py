"""How far apart training trajectories of the port drift, and from what
(run from the repo root on a GPU):

    python3 scripts/torch_train_divergence.py [--steps 20]

Runs ``Trainer.fit`` on the full-width len-64 config with chip_smoke.py's
synthetic data and seed, from the same init, batches and noise: on the CPU
(the reference), on the CPU with one thread (another summation order), on
the CPU and the GPU from the init scaled by 1 + 1e-7, on the GPU, and on the
GPU with the backward kernels replaced by their plain PyTorch versions
(exact f32 on the card).  Prints each run's losses and, per step, each
run's relative difference from the CPU run and from the GPU run: what
chip_smoke.py's training band is calibrated against.
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
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_divergence.py needs a GPU")
    import chip_smoke
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.trainer import build_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = fcp.fused_conv_pool_dgrad, fcp.fused_conv_pool_wgrad

    def plain_dgrad(gy, y, weight, s, T_in):
        return fcp.fused_conv_pool_dgrad_reference(
            gy, y, weight, T_in, s.stride, s.padding, "reflect" if s.reflect else "constant",
            s.negative_slope)

    def plain_wgrad(gy, y, x, s):
        return fcp.fused_conv_pool_wgrad_reference(
            gy, y, x, s.kernel_size, s.stride, s.padding,
            "reflect" if s.reflect else "constant", s.negative_slope, s.live_elements())

    cfg = chip_smoke.train_config(os.path.join(chip_smoke.OUT_DIR, "train_data"))
    runs = (("cpu", "cpu", 1.0, None), ("cpu_1_thread", "cpu", 1.0, 1),
            ("cpu_perturbed", "cpu", 1.0 + 1e-7, None), ("gpu", "cuda", 1.0, None),
            ("gpu_perturbed", "cuda", 1.0 + 1e-7, None),
            ("gpu_plain_backward", "cuda", 1.0, None))
    losses = {}
    threads = torch.get_num_threads()
    for name, dev, scale, n_threads in runs:
        plain = name == "gpu_plain_backward"
        fcp.fused_conv_pool_dgrad, fcp.fused_conv_pool_wgrad = (
            (plain_dgrad, plain_wgrad) if plain else kernels)
        torch.set_num_threads(n_threads or threads)
        trainer, ds, _, _ = build_trainer(cfg, os.path.join(chip_smoke.OUT_DIR, f"div_{name}"),
                                          device=dev)
        with torch.no_grad():
            for p in trainer.state.model.parameters():
                p.mul_(scale)
        out = []
        trainer.fit(ds, None, max_iter=args.steps,
                    log_cb=lambda step, m: out.append(float(m["loss_total"])))
        losses[name] = np.array(out)
    fcp.fused_conv_pool_dgrad, fcp.fused_conv_pool_wgrad = kernels
    torch.set_num_threads(threads)
    for name, v in losses.items():
        row = {"run": name, "threads": 1 if name == "cpu_1_thread" else threads,
               "loss": v.tolist()}
        for ref in ("cpu", "gpu"):
            if name != ref:
                row[f"rel_vs_{ref}"] = np.abs(v / losses[ref] - 1).tolist()
        print(json.dumps(row), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
