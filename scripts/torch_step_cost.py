"""The port's eager training step on the card, for two trees in one run.

For the len-64 VAE (``configs/len64_no_aug_hm_vae.yaml``) and the
trajectory model (``configs/trajectory_model.yaml``), each at its config's
batch on synthetic data made from the seed, one ``train_step`` a call:
ms a step by CUDA events (median of 5 samples of 10 steps), and device
time and device operations (kernels, copies, sets) a step by
torch.profiler (device activity only, 5 steps).  ``--root`` names the tree
whose ``hm_vae_torch`` is measured (default: the one holding this script),
so that a parent commit unpacked beside the repo is measured by the same
code:

    python scripts/torch_step_cost.py --root build/parent --tag parent
    python scripts/torch_step_cost.py --tag change

Prints the card's name and power limit, then one JSON line per config.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("len64_no_aug_hm_vae.yaml", "trajectory_model.yaml")


def time_ms(torch, fn, reps=10, samples=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def profile(torch, fn, calls=5):
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, count = 0.0, 0
    for ev in prof.events():
        if ev.device_type.name == "CUDA" and not getattr(ev, "is_user_annotation", False):
            busy += ev.time_range.elapsed_us()
            count += 1
    return {"device_ms_per_step": busy / calls / 1e3, "device_ops_per_step": count / calls,
            "idle_share": 1.0 - busy / wall_us}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="the tree whose hm_vae_torch is measured")
    ap.add_argument("--tag", default="", help="a label printed with every line")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from hm_vae_torch.train.train_step import loss_fields, to_device, train_step
    from hm_vae_torch.train.trainer import build_trainer
    from hm_vae_torch.utils.config import load_config

    import hm_vae_torch
    if not os.path.abspath(hm_vae_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"hm_vae_torch came from {hm_vae_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    out_dir = os.path.join(root, "build", "torch_step_cost")
    big = 10 ** 9
    for name in CONFIGS:
        cfg = load_config(os.path.join(root, "configs", name))
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, synthetic=True,
                                          data_root=os.path.join(out_dir, "data")),
            run=dataclasses.replace(cfg.run, log_iter=big, validation_iter=big,
                                    snapshot_save_iter=big, image_save_iter=big))
        trainer, train_ds = build_trainer(cfg, os.path.join(out_dir, name), device="cuda")[:2]
        state = trainer.state
        batch = to_device(train_ds.sample_batch(cfg.optim.batch_size), "cuda",
                          loss_fields(state.model))
        noise = torch.Generator()

        def step():
            return train_step(state, batch, cfg, generator=noise.manual_seed(0),
                              mean_std=trainer.mean_std)

        row = {"tag": args.tag, "config": f"configs/{name}", "batch": cfg.optim.batch_size,
               "ms_per_step": time_ms(torch, step), **profile(torch, step)}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
