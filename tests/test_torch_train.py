"""The port's training path on the CPU at len-8 size: ``Trainer.fit`` writes
``gen_*.pt`` checkpoints that resume to an identical state and that the JAX
package's ``import_hmvae_params`` reads; a 20-step loss trajectory tracks the
JAX ``Trainer`` from the same init on the same batches; the KL curriculum's
heads keep their optimizer counts at 0 until ``iteration_interval``; the NaN
guard restores; the training CLI trains and resumes; unported options raise.
(The trajectory model's training: ``test_torch_trajectory.py``; the
production path's options: ``test_torch_production.py``.)
"""

import dataclasses
import itertools
import os

import jax
import numpy as np
import pytest
import torch

from hm_vae_tpu.train.trainer import Trainer as JTrainer
from hm_vae_tpu.utils import config as jcfg
from hm_vae_tpu.utils.torch_import import import_hmvae_params, load_reference_checkpoint
from hm_vae_torch.cli import train as train_cli
from hm_vae_torch.data.dataset import make_loaders
from hm_vae_torch.train.trainer import Trainer, build_trainer
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, tmp, loss=None, run=None, data=None, optim=None):
    return mod.Config(
        model=mod.ModelConfig(**LEN8),
        loss=mod.LossConfig(**{"iteration_interval": 4, **(loss or {})}),
        optim=mod.OptimConfig(**{"lr": 1e-3, "batch_size": 4, "max_iter": 6, **(optim or {})}),
        data=mod.DataConfig(**{"data_root": os.path.join(tmp, "data"), "synthetic": True,
                               "synthetic_num_seqs": 6, **(data or {})}),
        run=mod.RunConfig(**{"log_iter": 2, "validation_iter": 4, "snapshot_save_iter": 5,
                             **(run or {})}))


def _opt_state(trainer):
    opt = trainer.state.optimizer
    return {name: {k: (v.clone() if torch.is_tensor(v) else v)
                   for k, v in opt.state[p].items()}
            for name, p in trainer.state.model.named_parameters() if p in opt.state}


def test_fit_checkpoint_resume_identical(tmp_path):
    tmp = str(tmp_path)
    cfg = _cfg(tcfg, tmp)
    trainer, train_ds, val_ds, _ = build_trainer(cfg, os.path.join(tmp, "run"), device="cpu")
    logged = []
    metrics = trainer.fit(train_ds, val_ds, log_cb=lambda s, m: logged.append(s))
    assert np.isfinite(metrics["loss_total"]) and trainer.state.step == 6
    assert logged == [2, 4, 6]
    ck = trainer.latest_checkpoint()
    assert ck.endswith("gen_00000005.pt")
    with open(os.path.join(tmp, "run", "logs", "metrics.jsonl")) as f:
        assert any("val_loss_total" in line for line in f)

    path = trainer.save()  # step 6
    again, _, _, _ = build_trainer(cfg, os.path.join(tmp, "run"), device="cpu")
    assert again.resume() == 6 and again.latest_checkpoint() == path
    for (n, a), (_, b) in zip(trainer.state.model.state_dict().items(),
                              again.state.model.state_dict().items()):
        assert torch.equal(a, b), n
    want, got = _opt_state(trainer), _opt_state(again)
    assert want.keys() == got.keys()
    for n in want:
        for k in want[n]:
            assert (want[n][k] == got[n][k]) if k == "step" else torch.equal(want[n][k],
                                                                             got[n][k]), (n, k)
    assert again.state.optimizer.param_groups[0]["step"] == 6
    again.fit(train_ds, None, max_iter=8)
    assert again.state.step == 8


def test_checkpoint_loads_into_jax(tmp_path):
    """The port's gen_*.pt is the reference's layout: the JAX package's
    importer reads it to the same parameters."""
    tmp = str(tmp_path)
    trainer = Trainer(_cfg(tcfg, tmp), os.path.join(tmp, "run"), device="cpu")
    path = trainer.save(3)
    flax = import_hmvae_params(load_reference_checkpoint(path), jcfg.ModelConfig(**LEN8))
    back = params_from_flax(jax.tree.map(np.asarray, flax), trainer.cfg.model)
    sd = trainer.state.model.state_dict()
    assert back.keys() == {k for k in sd if not k.endswith(("mask", "pool", "unpool"))}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    other = Trainer(_cfg(tcfg, tmp, run={"seed": 5}), os.path.join(tmp, "run2"), device="cpu")
    other.load_params(path)  # weights only
    assert other.state.step == 0 and not other.state.optimizer.state
    for k, v in other.state.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


class _Fixed:
    """A dataset yielding the same batches to both trainers."""

    def __init__(self, batches):
        self.batches = batches

    def iter_batches(self, batch_size):
        return itertools.cycle(self.batches)


def test_trajectory_tracks_jax_trainer(tmp_path):
    """20 steps from the same init on the same batches, kl_w 0 (no noise),
    across the curriculum boundary (step 10), at the len-64 config's lr.

    Adam amplifies last-place differences (a near-zero gradient's update is
    +-lr whatever its size), so the band is calibrated on the port itself:
    a second port run from the init scaled by 1 + 1e-7.  The JAX run must
    stay within 10x that run's spread (so far) + 1e-5, and within 1e-5 over
    the first 5 steps, before the amplification starts."""
    tmp = str(tmp_path)
    kw = dict(loss={"kl_w": 0.0, "iteration_interval": 10}, optim={"lr": 1e-4},
              run={"log_iter": 1, "validation_iter": 10 ** 6, "snapshot_save_iter": 10 ** 6})
    tc = _cfg(tcfg, tmp, **kw)
    train_ds, _, _ = make_loaders(tc)
    batches = [{k: v for k, v in train_ds.sample_batch(4).items() if k in ("rot_6d", "rot_mat")}
               for _ in range(20)]
    jt = JTrainer(_cfg(jcfg, tmp, **kw), os.path.join(tmp, "jrun"))
    init = params_from_flax(jax.tree.map(np.asarray, jt.state.params), tc.model)
    ref = []
    jt.fit(_Fixed(batches), None, max_iter=20, log_cb=lambda s, m: ref.append(m["loss_total"]))

    def port(scale):
        tt = Trainer(tc, os.path.join(tmp, f"trun{scale}"), device="cpu")
        tt.state.model.load_state_dict({k: v * scale for k, v in init.items()})
        out = []
        tt.fit(_Fixed(batches), None, max_iter=20, log_cb=lambda s, m: out.append(m["loss_total"]))
        return np.array(out)

    ref, ours, perturbed = np.array(ref), port(1.0), port(1.0 + 1e-7)
    assert len(ref) == len(ours) == len(perturbed) == 20
    err = np.abs(ours / ref - 1)
    band = 10 * np.maximum.accumulate(np.abs(perturbed / ours - 1)) + 1e-5
    assert (err[:5] <= 1e-5).all(), err
    assert (err <= band).all(), (err, band)


def test_curriculum_heads_count_from_the_boundary(tmp_path):
    """Below iteration_interval the shallow head is detached and the middle
    heads are never read: no gradient, no optimizer step; the shallow head
    starts its own count at the boundary, the middle ones never do."""
    tmp = str(tmp_path)
    cfg = _cfg(tcfg, tmp, run={"validation_iter": 10 ** 6, "snapshot_save_iter": 10 ** 6})
    trainer, train_ds, _, _ = build_trainer(cfg, os.path.join(tmp, "run"), device="cpu")

    def counts():
        opt = trainer.state.optimizer
        return {n: opt.state[p]["step"] if p in opt.state else 0
                for n, p in trainer.state.model.named_parameters()}

    trainer.fit(train_ds, max_iter=4)
    c = counts()
    frozen = ("encoder.latent_head_0", "encoder.latent_head_1", "encoder.latent_head_2",
              "decoder.latent_dec_1", "decoder.latent_dec_2")
    for n, v in c.items():
        assert v == (0 if n.startswith(frozen) else 4), n
    trainer.fit(train_ds, max_iter=6)
    c = counts()
    for n, v in c.items():
        want = 2 if n.startswith("encoder.latent_head_0") else 0 if n.startswith(frozen) else 6
        assert v == want, n


def test_nan_guard_restores_and_fails_on_a_corrupt_checkpoint(tmp_path):
    tmp = str(tmp_path)
    cfg = _cfg(tcfg, tmp, run={"snapshot_save_iter": 2, "log_iter": 1})
    trainer, train_ds, _, _ = build_trainer(cfg, os.path.join(tmp, "run"), device="cpu")
    trainer.fit(train_ds, None, max_iter=3)
    assert trainer.latest_checkpoint().endswith("gen_00000002.pt")
    with torch.no_grad():
        for p in trainer.state.model.parameters():
            p.mul_(float("nan"))
    trainer.fit(train_ds, None, max_iter=4)
    assert trainer.state.step == 4
    assert all(torch.isfinite(p).all() for p in trainer.state.model.parameters())
    with torch.no_grad():
        for p in trainer.state.model.parameters():
            p.mul_(float("nan"))
    trainer.save(5)
    with pytest.raises(FloatingPointError, match="recurred"):
        trainer.fit(train_ds, None, max_iter=8)


def test_cli_trains_and_resumes(tmp_path, capsys):
    out = str(tmp_path)
    args = ["--config", os.path.join(ROOT, "configs", "len8_smoke.yaml"), "--output_path", out,
            "--device", "cpu", "--data_root", os.path.join(out, "data"), "--max_iter", "6"]
    train_cli.main(args)
    ck = os.path.join(out, "outputs", "len8_smoke", "checkpoints")
    assert sorted(os.listdir(ck)) == ["gen_00000006.pt"]
    train_cli.main(args[:-1] + ["8", "--resume"])
    text = capsys.readouterr().out
    assert "Resume from iteration 6" in text and "Finish Training" in text
    assert "[00000005]" in text and sorted(os.listdir(ck))[-1] == "gen_00000008.pt"


@pytest.mark.parametrize("change", [
    {"model": {"lora_rank": 2}},
    {"run": {"model_parallel": 2}},
])
def test_unported_options_raise(tmp_path, change):
    cfg = _cfg(tcfg, str(tmp_path))
    cfg = dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), **v)
                                      for k, v in change.items()})
    with pytest.raises(NotImplementedError):
        Trainer(cfg, str(tmp_path / "run"), device="cpu")


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_cfg(tcfg, str(tmp_path)), str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--config", os.path.join(ROOT, "configs", "len8_smoke.yaml"),
                        "--output_path", str(tmp_path)])
