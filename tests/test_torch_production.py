"""The production training path on the CPU at len-8 size
(``configs/len64_production.yaml``'s execution keys): several steps a call
(``steps_per_call``) through the native sampler's compact superbatches on
the f16 axis-angle wire, bf16 parameters (stochastically rounded write-back)
and bf16 moments, a KL curriculum boundary inside a call, the tail of single
rows, asynchronous checkpoints and their pruning, and the device root
rotation in the Trainer.

The port's Trainer is held against the JAX Trainer on the same windows (the
two native samplers give the same arrays) from the same init, in the band of
``test_torch_train.py::test_trajectory_tracks_jax_trainer``: 10x the spread
of perturbed runs, + 1e-5, and within 1e-5 at the first logged step.  The
perturbation scales by 1 + 1e-7 the one f32 operand of the step (the
parameters are bf16, so a scaled init rounds back to itself): the batch
after its device upcast, on both sides (the spreads of the two packages
differ by up to 10x at some steps, as the GPU's and the CPU's do in
``chip_smoke.py``)."""

import itertools
import os

import jax
import numpy as np
import pytest
import torch

from hm_vae_tpu.data.dataset import make_loaders as jmake_loaders
from hm_vae_tpu.train.trainer import Trainer as JTrainer
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.data.native_loader import NativeMotionLoader
from hm_vae_torch.train import trainer as ttrainer
from hm_vae_torch.train.losses import draw_noise, eps_shapes
from hm_vae_torch.train.train_step import MultiStep, create_state, train_step
from hm_vae_torch.train.trainer import Trainer, build_trainer, step_generator
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
PRODUCTION = dict(data={"compact_transfer": True, "wire_format": "aa",
                        "transfer_dtype": "float16", "use_native_loader": True},
                  optim={"param_dtype": "bfloat16", "moment_dtype": "bfloat16"},
                  run={"steps_per_call": 4, "async_checkpoint": True})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, tmp, **parts):
    merged = {k: dict(PRODUCTION.get(k, {}), **parts.get(k, {}))
              for k in ("loss", "optim", "data", "run")}
    return mod.Config(
        model=mod.ModelConfig(**LEN8),
        loss=mod.LossConfig(**{"iteration_interval": 6, **merged["loss"]}),
        optim=mod.OptimConfig(**{"lr": 1e-3, "batch_size": 4, "max_iter": 22,
                                 **merged["optim"]}),
        data=mod.DataConfig(**{"data_root": os.path.join(tmp, "data"), "synthetic": True,
                               "synthetic_num_seqs": 6, **merged["data"]}),
        run=mod.RunConfig(**{"log_iter": 1, "validation_iter": 10 ** 6,
                             "snapshot_save_iter": 10 ** 6, **merged["run"]}))


def _port_init(jt, tc):
    """The JAX Trainer's init (bf16 values) as the port's state dict."""
    return params_from_flax(jax.tree.map(lambda a: np.asarray(a, np.float32), jt.state.params),
                            tc.model)


def _fit(trainer, train_ds, max_iter):
    steps, losses = [], []
    trainer.fit(train_ds, None, max_iter=max_iter,
                log_cb=lambda s, m: (steps.append(s), losses.append(m["loss_total"])))
    return steps, np.array(losses)


def test_production_path_tracks_jax_trainer(tmp_path, monkeypatch):
    """22 steps at 4 a call (calls at 0-20, then the last 2 steps as single
    rows of a superbatch), the curriculum boundary at step 6 inside the
    second call, kl_w 0 (no noise), lr 1e-4: the port's loss after every
    call and the tail stays in the band of the JAX Trainer's."""
    tmp = str(tmp_path)
    kw = dict(loss={"kl_w": 0.0}, optim={"lr": 1e-4})
    tc = _cfg(tcfg, tmp, **kw)

    def jax_run(scale):
        jc = _cfg(jcfg, tmp, **kw)
        jtrain, _, _ = jmake_loaders(jc)
        assert type(jtrain).__name__ == "NativeMotionLoader"
        jt = JTrainer(jc, os.path.join(tmp, f"jrun{scale}"))
        init = _port_init(jt, tc)
        jt._build_steps()
        if scale != 1.0:  # the batches after the device upcast
            multi, single = jt._ingest_m, jt._ingest_s
            jt._ingest_m = lambda t, step: jax.tree.map(lambda x: x * scale, multi(t, step))
            jt._ingest_s = lambda t, step: jax.tree.map(lambda x: x * scale, single(t, step))
        out = []
        jt.fit(jtrain, None, log_cb=lambda s, m: out.append(m["loss_total"]))
        return init, np.array(out)

    def port(init, scale):
        tt, train_ds, _, _ = build_trainer(tc, os.path.join(tmp, f"trun{scale}"), device="cpu")
        assert isinstance(train_ds, NativeMotionLoader)
        if scale != 1.0:
            consume = ttrainer.Trainer._consume
            monkeypatch.setattr(tt, "_consume", lambda staged: {
                k: v * scale for k, v in consume(tt, staged).items()})
        tt.state.model.load_state_dict(init)
        assert all(p.dtype == torch.bfloat16 for p in tt.state.model.parameters())
        steps, out = _fit(tt, train_ds, 22)
        assert steps == [4, 8, 12, 16, 20, 22]  # the tail runs in one turn
        opt = tt.state.optimizer
        head = tt.state.model.encoder.latent_head_0.weight
        # the shallow head stepped from the boundary (step 6) only
        assert int(opt.state[head]["step"]) == 22 - 6
        assert all(int(opt.state[p]["step"]) == 22 for p in
                   tt.state.model.decoder.conv_0.parameters())
        return out

    init, ref = jax_run(1.0)
    _, ref_perturbed = jax_run(1.0 + 1e-7)
    ours, perturbed = port(init, 1.0), port(init, 1.0 + 1e-7)
    assert len(ref) == len(ours) == len(perturbed) == len(ref_perturbed) == 6
    err = np.abs(ours / ref - 1)
    spread = np.maximum(np.abs(perturbed / ours - 1), np.abs(ref_perturbed / ref - 1))
    band = 10 * np.maximum.accumulate(spread) + 1e-5
    assert err[0] <= 1e-5, err
    assert (err <= band).all(), (err, band)


def _fixed_batches(n, B=4, seed=0):
    rng = np.random.default_rng(seed)
    aa = (rng.normal(size=(n, B, 8, 24, 3)) * 0.5).astype(np.float32)
    return {"aa": torch.from_numpy(aa)}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_k_eager_steps_are_k_single_steps(tmp_path, param_dtype):
    """MultiStep's K steps a call (the CPU runs them eagerly) give the bits
    of K single steps on the same batches and noise, across the curriculum
    boundary (step 6, inside the second call)."""
    tc = _cfg(tcfg, str(tmp_path), optim={"param_dtype": param_dtype,
                                           "moment_dtype": param_dtype})
    batches = _fixed_batches(8)
    eps_of = lambda s: draw_noise(eps_shapes(tc, 4), step_generator(tc.run.seed, s))  # noqa
    a = create_state(tc, "cpu")
    for s in range(8):
        train_step(a, {"aa": batches["aa"][s]}, tc, eps=eps_of(s))
    b = create_state(tc, "cpu")
    multi = MultiStep(b, tc)
    for c in range(2):
        sl = slice(4 * c, 4 * c + 4)
        eps = [torch.stack(x) for x in zip(*[eps_of(s) for s in range(sl.start, sl.stop)])]
        multi({"aa": batches["aa"][sl]}, eps)
    assert a.step == b.step == 8 and int(b.step_t) == 8
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sa.keys() == sb.keys(), n
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (n, k)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_trainer_k_steps_a_call_are_single_steps(tmp_path, param_dtype):
    """Through Trainer.fit on the same batches (a dataset without a native
    stream, so both consume it in order): 4 steps a call, their noise drawn
    for the call (kl_w on), and the remaining 2 as single steps, give the
    bits of 10 single steps."""
    class Fixed:
        def __init__(self, batches):
            self.batches = batches

        def iter_batches(self, batch_size):
            return iter(self.batches)

    b = _fixed_batches(10, seed=3)
    states = {}
    for K in (1, 4):
        tc = _cfg(tcfg, str(tmp_path), run={"steps_per_call": K},
                  optim={"param_dtype": param_dtype, "moment_dtype": param_dtype},
                  data={"use_native_loader": False, "transfer_dtype": "float32"})
        assert tc.loss.kl_w != 0
        tr = Trainer(tc, str(tmp_path / f"run{K}"), device="cpu")
        tr.fit(Fixed([{"aa": b["aa"][i].numpy()} for i in range(10)]), None, max_iter=10)
        assert tr.state.step == 10
        states[K] = tr.state
    for (n, p), q in zip(states[1].model.named_parameters(), states[4].model.parameters()):
        assert torch.equal(p, q), n
        for k, v in states[1].optimizer.state[p].items():
            assert torch.equal(v, states[4].optimizer.state[q][k]), (n, k)


def _state_tensors(trainer):
    out = {f"model.{k}": v for k, v in trainer.state.model.state_dict().items()}
    opt = trainer.state.optimizer
    for name, p in trainer.state.model.named_parameters():
        for k, v in opt.state.get(p, {}).items():
            out[f"opt.{name}.{k}"] = v
    out["opt.count"] = opt.param_groups[0]["step"]
    return out


def test_async_checkpoint_is_the_sync_one_and_resumes(tmp_path):
    tmp = str(tmp_path)
    runs = {}
    for mode in (False, True):
        cfg = _cfg(tcfg, tmp, run={"async_checkpoint": mode, "snapshot_save_iter": 8})
        tr, train_ds, _, _ = build_trainer(cfg, os.path.join(tmp, f"run_{mode}"), device="cpu")
        tr.fit(train_ds, None, max_iter=12)
        tr.wait_for_saves()
        runs[mode] = tr
        assert [os.path.basename(tr.latest_checkpoint())] == ["gen_00000008.pt"]
    blobs = [torch.load(r.latest_checkpoint(), weights_only=True) for r in runs.values()]
    assert blobs[0]["step"] == blobs[1]["step"] == 8
    for k, v in blobs[0]["state_dict"].items():
        assert torch.equal(v, blobs[1]["state_dict"][k]), k
    so, ao = blobs[0]["optimizer"], blobs[1]["optimizer"]
    assert so["state"].keys() == ao["state"].keys()
    for i in so["state"]:
        for k in so["state"][i]:
            assert torch.equal(torch.as_tensor(so["state"][i][k]),
                               torch.as_tensor(ao["state"][i][k])), (i, k)
    # resume from each: the same state, and on to the same step 12
    again = {}
    for mode, tr in runs.items():
        cfg = _cfg(tcfg, tmp, run={"async_checkpoint": mode})
        t2, train_ds, _, _ = build_trainer(cfg, os.path.join(tmp, f"run_{mode}"), device="cpu")
        assert t2.resume() == 8
        again[mode] = _state_tensors(t2)
        t2.fit(train_ds, None, max_iter=12)
        assert t2.state.step == 12
    for k, v in again[False].items():
        assert torch.equal(v, again[True][k]), k


def test_keep_checkpoints_prunes_and_a_writer_error_is_raised(tmp_path, monkeypatch):
    tmp = str(tmp_path)
    cfg = _cfg(tcfg, tmp, run={"snapshot_save_iter": 4, "keep_checkpoints": 2})
    tr, train_ds, _, _ = build_trainer(cfg, os.path.join(tmp, "run"), device="cpu")
    tr.fit(train_ds, None, max_iter=16)
    names = sorted(os.listdir(tr.ckpt_dir))
    assert names == ["gen_00000012.pt", "gen_00000016.pt"], names

    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ttrainer.torch, "save", broken)
    tr.save(17)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint") as e:
        tr.wait_for_saves()
    assert isinstance(e.value.__cause__, OSError)
    tr.wait_for_saves()  # the error is reported once
    # fit's teardown re-raises a failed save of the run
    tr.save(18)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        tr.fit(train_ds, None, max_iter=16)


@pytest.mark.parametrize("max_iter, step_fails", [(4, False), (8, False), (4, True)])
def test_fit_raises_a_failed_background_fill(tmp_path, monkeypatch, caplog, max_iter,
                                             step_fails):
    """A superbatch fill that fails in the background is raised by fit: at
    the next superbatch (8 steps), or by the teardown when none is taken
    (4 steps); an error of the step already propagating is raised instead,
    and the fill's is logged."""
    tmp = str(tmp_path)
    tr, train_ds, _, _ = build_trainer(_cfg(tcfg, tmp), os.path.join(tmp, "run"), device="cpu")
    stream = train_ds.iter_compact_superbatches

    def failing(*a, **kw):
        s = stream(*a, **kw)
        fill = s._fill

        def flaky(slot):
            if slot == 1:
                raise OSError("sequence read failed")
            fill(slot)

        s._fill = flaky
        return s

    monkeypatch.setattr(train_ds, "iter_compact_superbatches", failing)
    if step_fails:
        def broken(staged):
            raise ValueError("step failed")

        monkeypatch.setattr(tr, "_consume", broken)
    with pytest.raises(ValueError if step_fails else OSError,
                       match="step failed" if step_fails else "sequence read failed"):
        tr.fit(train_ds, None, max_iter=max_iter)
    assert ("background batch fill failed during teardown" in caplog.text) == step_fails


def test_device_root_rotation_trains(tmp_path):
    """random_root_rot with device_augment: the native sampler serves the
    train split, the Trainer rotates on the device (CPU here) and trains; the
    rotations are keyed by the step, so two runs agree bit for bit."""
    tmp = str(tmp_path)
    cfg = _cfg(tcfg, tmp, data={"random_root_rot_flag": True, "device_augment": True,
                                "fps_aug_flag": True})
    finals = []
    for run in range(2):
        tr, train_ds, _, _ = build_trainer(cfg, os.path.join(tmp, f"run{run}"), device="cpu")
        assert isinstance(train_ds, NativeMotionLoader) and tr._augment is not None
        m = tr.fit(train_ds, None, max_iter=10)
        assert np.isfinite(m["loss_total"])
        finals.append(tr.state.model.state_dict())
    for k, v in finals[0].items():
        assert torch.equal(v, finals[1][k]), k


def test_step_noise_depends_on_the_seed():
    """The noise generator mixes the seed into the 32 bits torch's CPU
    generator reads (``(seed << 32) + step`` drew the same noise for every
    seed)."""
    draw = lambda seed, step: torch.randn(4, generator=step_generator(seed, step))  # noqa: E731
    assert not torch.equal(draw(0, 3), draw(1, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert torch.equal(draw(2, 5), draw(2, 5))


@pytest.mark.parametrize("wire", ["rot6d", "rotmat"])
def test_other_wires_and_superbatch_streams_train(tmp_path, wire):
    """The other compact wires, and the full-field superbatch stream
    (compact_transfer off), train a few calls."""
    tmp = str(tmp_path)
    for compact in (True, False):
        cfg = _cfg(tcfg, tmp, data={"wire_format": wire, "compact_transfer": compact,
                                    "transfer_dtype": "float32"})
        tr, train_ds, _, _ = build_trainer(cfg, os.path.join(tmp, f"run{compact}"),
                                           device="cpu")
        m = tr.fit(train_ds, None, max_iter=9)
        assert tr.state.step == 9 and np.isfinite(m["loss_total"])


def test_production_config_reads_its_execution_keys():
    path = os.path.join(os.path.dirname(__file__), "..", "configs", "len64_production.yaml")
    c = tcfg.load_config(path)
    assert (c.run.steps_per_call, c.run.async_checkpoint, c.run.keep_checkpoints) == (32, True, 5)
    assert (c.data.wire_format, c.data.transfer_dtype, c.data.compact_transfer) == \
        ("aa", "float16", True)
    assert (c.optim.param_dtype, c.optim.moment_dtype, c.optim.batch_size) == \
        ("bfloat16", "bfloat16", 64)


def test_trainer_on_fixed_batches_without_a_native_stream(tmp_path):
    """A dataset with only iter_batches: K batches stacked per call (the
    prefetch iterator), as the JAX Trainer stacks them."""
    class Fixed:
        def __init__(self, batches):
            self.batches = batches

        def iter_batches(self, batch_size):
            return itertools.cycle(self.batches)

    tc = _cfg(tcfg, str(tmp_path), data={"use_native_loader": False})
    b = _fixed_batches(3)
    batches = [{"aa": b["aa"][i].numpy()} for i in range(3)]
    tr = Trainer(tc, str(tmp_path / "run"), device="cpu")
    m = tr.fit(Fixed(batches), None, max_iter=10)
    assert tr.state.step == 10 and np.isfinite(m["loss_total"])


def test_batch64_backward_plans_fit_shared_memory():
    """At the production batch of 64 every len-64 level's dgrad and wgrad
    plan fits a block's shared memory (a wgrad block holds x's rows of its
    batches: dec3 splits its batches over 3 blocks, not 2; dgrad's whole-row
    plan, and the spans of several batches' whole rows it is routed to);
    the batch-8 plans are those chosen before."""
    from hm_vae_torch.models.hm_vae import HMVAE, SkeletonConv
    from hm_vae_torch.ops import fused_conv_pool as fcp

    cfg = tcfg.load_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                        "len64_production.yaml"))
    model = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(0))
    convs = [m for m in model.modules() if isinstance(m, SkeletonConv)]
    T_in = {"encoder": [64, 32, 16, 8], "decoder": [8, 16, 32, 64]}
    for part in ("encoder", "decoder"):
        for i in range(4):
            s = getattr(getattr(model, part), f"conv_{i}").structure()
            T, K, stride, pad = T_in[part][i], s.kernel_size, s.stride, s.padding
            T_out = fcp._t_out(T, K, stride, pad, s.reflect)
            t_ld = T_out + -T_out % 4
            for B in (8, 64):
                nbb, _, _, span = fcp.dgrad_whole_plan(B, T, K, stride, pad, t_ld,
                                                       s.dgrad_start.numel() - 1,
                                                       s.dgrad_max_live, 132)
                assert span == 0 and fcp._dgrad_smem(T, K, t_ld, stride, pad, nbb) <= fcp.MAX_SMEM
                # routed, batch 64's dgrad takes spans of several batches' whole rows
                d = fcp.dgrad_plan(B, T, K, stride, pad, t_ld, s.dgrad_start.numel() - 1,
                                   s.dgrad_max_live, 132, 1,
                                   (s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live))
                assert (d.span > 0) == (B == 64)
                if d.span:
                    assert d.nbb > 1 and fcp._dgrad_span_layout(K, stride, d.span)[0] <= \
                        fcp.MAX_SMEM
                smem = lambda sb, split: fcp._wgrad_smem(B, T, K, T_out, t_ld, stride,  # noqa
                                                         sb, split)
                plan = fcp.wgrad_plan(B, T_out, s.wgrad_row.numel(), 132, smem=smem)
                assert plan.span == 0 and smem(plan.sb, plan.split) <= fcp.MAX_SMEM, (
                    part, i, B, plan)
                if B == 8:
                    assert plan == fcp.wgrad_plan(B, T_out, s.wgrad_row.numel(), 132)
    assert len(convs) == 8
