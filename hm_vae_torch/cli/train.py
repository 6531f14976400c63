"""Training CLI (port of ``hm_vae_tpu.cli.train``):

    python -m hm_vae_torch.cli.train --config configs/len8_smoke.yaml \
        --output_path out/ [--resume] [--max_iter N] [--device cpu]

Flag-compatible with the reference's training script (``--config --output_path --resume
--test_model``; ``--multigpus`` is accepted and ignored: several cards are
several ranks, below), plus ``--max_iter``, ``--data_root`` and ``--device``
(default ``cuda``; it raises without CUDA unless ``--device cpu`` is given).
Checkpoints go to ``<output_path>/outputs/<config name>/checkpoints/``.

Data parallel over N ranks, one process each (``optim.batch_size`` stays
the global batch; the primary rank writes the files):

    HMVAE_DIST=1 python -m torch.distributed.run --nproc_per_node N \
        -m hm_vae_torch.cli.train --config ... --output_path out/

With ``model_parallel: M`` in the config (M dividing N) the ranks form N // M
data rows of M model ranks, the latent heads sharded over each row.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil


def main(argv=None):
    p = argparse.ArgumentParser(description="Train the hm-vae model")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--output_path", type=str, default="./")
    p.add_argument("--test_batch_size", type=int, default=10)
    p.add_argument("--multigpus", action="store_true",
                   help="ignored: start one rank a card with torchrun (HMVAE_DIST=1)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--test_model", type=str, default="",
                   help="reference-format gen_*.pt: load its weights only")
    p.add_argument("--max_iter", type=int, default=None, help="override config max_iter")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from ..parallel.multihost import is_primary
    from ..train.trainer import build_trainer
    from ..utils.config import load_config
    from . import start

    device = start(args.device)
    cfg = load_config(args.config)
    if args.data_root:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                data_root=args.data_root))
    model_name = os.path.splitext(os.path.basename(args.config))[0]
    output_dir = os.path.join(args.output_path, "outputs", model_name)
    if is_primary():  # under several ranks the primary writes every file
        os.makedirs(output_dir, exist_ok=True)
        shutil.copyfile(args.config, os.path.join(output_dir, "config.yaml"))

    trainer, train_ds, val_ds, test_ds = build_trainer(cfg, output_dir, device=device)
    if args.resume:
        step = trainer.resume()
        print(f"Resume from iteration {step}", flush=True)
    if args.test_model:
        trainer.load_params(args.test_model)

    def log_cb(step, metrics):
        msg = ", ".join(f"{k.removeprefix('loss_')}: {v:.4f}"
                        for k, v in sorted(metrics.items()))
        print(f"[{step:08d}] {msg}", flush=True)

    metrics = trainer.fit(train_ds, val_ds, max_iter=args.max_iter, log_cb=log_cb,
                          test_ds=test_ds)
    trainer.save()
    trainer.wait_for_saves()  # an asynchronous write lands before the run ends
    print("Finish Training", metrics, flush=True)


if __name__ == "__main__":
    main()
