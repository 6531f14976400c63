"""The port's compact parameter layout (``hm_vae_torch.models.param_layout``)
against ``hm_vae_tpu.models.param_layout`` on the CPU, mirroring
``tests/test_param_layout.py``:

- an unknown layout raises ``ValueError``;
- the index maps of every conv (len-8, len-64, extra convs, the trajectory
  model): live counts, gather index, live positions and row bounds equal to
  JAX's; the conversions and the expander (forward and its gather
  backward) bit for bit against JAX's ``compact_from_dense``,
  ``dense_from_compact`` and ``expander``;
- a compact model: its forward and its gradients at the live entries within
  the port's parity tolerance of JAX's compact model (1e-5 * max(1,
  max|ref|), as tests/test_torch_losses.py), and bit-equal to the port's
  dense model on the same live weights; with extra convs and for the
  trajectory model too;
- flax compact trees through ``params_from_flax`` (into either layout), and
  a compact model's checkpoint read by JAX's ``import_hmvae_params``;
- five training steps under ``compact`` bit-equal to ``dense`` at the live
  entries (weights, Adam moments and losses, f32);
- the solver on a compact model against JAX's compact solver (the tolerances
  of tests/test_torch_latent_opt.py) and against the port's dense solve
  (those of JAX's ``test_latent_opt_solver_equal_across_layouts``);
- ``load_params`` and a full-state ``resume`` across layouts, the resumed
  run bit-equal to the one that stayed dense at the live entries.
"""

import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from hm_vae_tpu.apps import latent_opt as jlo
from hm_vae_tpu.models import param_layout as jpl
from hm_vae_tpu.models import trajectory as jtr
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.models.structure import get_structure as jget_structure
from hm_vae_tpu.models.structure import get_trajectory_structure as jget_trajectory_structure
from hm_vae_tpu.utils import config as jcfg
from hm_vae_tpu.utils.torch_import import import_hmvae_params, load_reference_checkpoint
from hm_vae_torch.apps import latent_opt as tlo
from hm_vae_torch.models import param_layout as pl
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure, get_trajectory_structure
from hm_vae_torch.models.trajectory import TrajectoryModel
from hm_vae_torch.train.train_step import create_state, train_step
from hm_vae_torch.train.trainer import Trainer
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax, trajectory_params_from_flax

from test_torch_latent_opt import LAT, _setup

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
TRAJ = dict(LEN8, model_name="TrajectoryModel", train_seq_len=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(ref, scale=1e-5):
    return scale * max(1.0, float(np.abs(ref).max()))


def _compact(mod, **kw):
    return mod.ModelConfig(**{**kw, "param_layout": "compact"})


def _x6d(B=2, T=8, seed=1):
    rm = R.from_rotvec(np.random.default_rng(seed).normal(scale=0.4, size=(B * T * 24, 3)))
    m = rm.as_matrix().astype(np.float32).reshape(B, T, 24, 3, 3)
    return np.concatenate((m[..., :, 0], m[..., :, 1]), axis=-1), m


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="param_layout"):
        pl.validate_layout("sparse")
    for model in (HMVAE, TrajectoryModel):
        with pytest.raises(ValueError, match="param_layout"):
            model(tcfg.ModelConfig(**{**(TRAJ if model is TrajectoryModel else LEN8),
                                      "param_layout": "bogus"}))


def _spec_pairs(kw):
    """(name, port spec, JAX spec) of every conv of a configuration."""
    if kw.get("model_name") == "TrajectoryModel":
        ours = get_trajectory_structure(tcfg.ModelConfig(**kw)).levels
        theirs = jget_trajectory_structure(jcfg.ModelConfig(**kw)).levels
        return [(f"traj{i}", a.conv, b.conv) for i, (a, b) in enumerate(zip(ours, theirs))]
    st, jst = get_structure(tcfg.ModelConfig(**kw)), jget_structure(jcfg.ModelConfig(**kw))
    out = []
    for part in ("encoder_levels", "decoder_levels"):
        for i, (a, b) in enumerate(zip(getattr(st, part), getattr(jst, part))):
            out.append((f"{part[:3]}{i}", a.conv, b.conv))
            out += [(f"{part[:3]}{i}_extra{e}", x, y)
                    for e, (x, y) in enumerate(zip(a.extra_convs, b.extra_convs))]
    return out


@pytest.mark.parametrize("kw", [LEN8, {}, dict(LEN8, extra_conv=1), TRAJ],
                         ids=["len8", "len64", "extra_conv", "trajectory"])
def test_meta_and_round_trip_bit_for_bit_against_jax(kw):
    rng = np.random.default_rng(0)
    n_compact = 0
    for name, spec, jspec in _spec_pairs(kw):
        np.testing.assert_array_equal(spec.mask, jspec.mask, err_msg=name)
        assert pl.is_compact_spec(spec, "compact") == jpl.is_compact_spec(jspec, "compact")
        assert not pl.is_compact_spec(spec, "dense")
        meta, jmeta = pl.compact_meta(spec), jpl.compact_meta(jspec)
        assert meta.n_live == jmeta.n_live == int(spec.mask.sum()), name
        for f in ("gather_idx", "live_flat", "row_bounds"):
            np.testing.assert_array_equal(getattr(meta, f), getattr(jmeta, f), err_msg=name)
        if spec.mask.all():
            continue
        n_compact += 1
        w = rng.normal(size=(spec.out_channels, spec.in_channels, spec.kernel_size)
                       ).astype(np.float32)
        wc = pl.compact_from_dense(w, spec)
        np.testing.assert_array_equal(wc, jpl.compact_from_dense(w, jspec), err_msg=name)
        dense = pl.dense_from_compact(wc, spec)
        np.testing.assert_array_equal(dense, jpl.dense_from_compact(wc, jspec), err_msg=name)
        # the expander and its gather backward, against JAX's custom_vjp
        wt = torch.from_numpy(wc).requires_grad_()
        out = pl.expand(wt, spec)
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(jpl.expander(jspec)(jnp.asarray(wc))))
        g = rng.normal(size=dense.shape).astype(np.float32)
        out.backward(torch.from_numpy(g))
        (jg,) = jax.vjp(jpl.expander(jspec), jnp.asarray(wc))[1](jnp.asarray(g))
        np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jg), err_msg=name)
        # windows: (G, L, K) expands window by window
        wg = torch.from_numpy(np.stack([wc, 2 * wc]))
        np.testing.assert_array_equal(pl.expand(wg, spec)[1].numpy(), 2 * dense)
    assert n_compact > 0


def _jax_pair(kw, seed=0):
    """A JAX compact model, its variables (numpy) and the port's compact
    model on them."""
    jc, tc = _compact(jcfg, **kw), _compact(tcfg, **kw)
    if kw.get("model_name") == "TrajectoryModel":
        jm = jtr.TrajectoryModel(jc)
        v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, kw["train_seq_len"], 24, 3)))
        tm = TrajectoryModel(tc)
        tm.load_state_dict(trajectory_params_from_flax(jax.tree.map(np.asarray, v), tc))
    else:
        jm = JHMVAE(jc)
        v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 24, 6)))
        tm = HMVAE(tc)
        tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, v), tc))
    assert jpl.params_layout(v) == "compact"
    return jm, jax.tree.map(np.asarray, v), tm


def _dense_twin(tm, kw):
    """The port's dense model on the compact model's live weights."""
    cls = TrajectoryModel if kw.get("model_name") == "TrajectoryModel" else HMVAE
    cfg = tcfg.ModelConfig(**kw)
    dm = cls(cfg)
    dm.load_state_dict(pl.convert_state_dict(tm.state_dict(), cfg, "dense"))
    return dm


@pytest.mark.parametrize("kw", [LEN8, dict(LEN8, extra_conv=1)], ids=["len8", "extra_conv"])
def test_compact_forward_and_live_grads_match_jax_and_dense(kw):
    jm, v, tm = _jax_pair(kw)
    six, _ = _x6d()
    jstats, jout = jm.apply(v, jnp.asarray(six))
    x = torch.from_numpy(six)
    stats, out = tm(x)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=_tol(np.asarray(jout)), rtol=0)
    dm = _dense_twin(tm, kw)
    dstats, dout = dm(x)
    assert torch.equal(out, dout)
    for a, b, j in zip(stats, dstats, jstats):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(j), atol=_tol(np.asarray(j)))
    # gradients of a scalar of the output, at the compact leaves
    w = np.random.default_rng(3).normal(size=jout.shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(six))[1] * w))(v)
    jg = params_from_flax(jax.tree.map(np.asarray, jg), _compact(tcfg, **kw))
    (tm(x)[1] * torch.from_numpy(w)).sum().backward()
    (dm(x)[1] * torch.from_numpy(w)).sum().backward()
    dense_grads = pl.convert_state_dict({n: p.grad for n, p in dm.named_parameters()
                                         if p.grad is not None}, tm.cfg, "compact")
    checked = 0
    for n, p in tm.named_parameters():
        if p.grad is None:
            continue
        ref = jg[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=_tol(ref), rtol=0, err_msg=n)
        assert torch.equal(p.grad, dense_grads[n]), n
        checked += n.endswith("weight_c")
    assert checked >= 6


def test_trajectory_model_compact_matches_jax_and_dense():
    jm, v, tm = _jax_pair(TRAJ)
    x = np.random.default_rng(4).normal(size=(2, 16, 24, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=_tol(ref), rtol=0)
    assert torch.equal(out, _dense_twin(tm, TRAJ)(torch.from_numpy(x)))
    assert any(n.endswith("weight_c") for n, _ in tm.named_parameters())


def test_flax_compact_trees_and_jax_import(tmp_path):
    """A flax compact tree gives the compact state dict, or the dense one
    (dead entries 0) for a dense config; a compact model's checkpoint (dense
    reference names) reads back through JAX's importer in either layout."""
    jm, v, tm = _jax_pair(LEN8)
    dense_cfg = tcfg.ModelConfig(**LEN8)
    dense = params_from_flax(v, dense_cfg)
    jdense = jpl.convert_conv_params(v, jcfg.ModelConfig(**LEN8), "dense")
    want = params_from_flax(jdense, dense_cfg)
    assert dense.keys() == want.keys() and not any(k.endswith("weight_c") for k in dense)
    for k in dense:
        assert torch.equal(dense[k], want[k]), k
    cfg = tcfg.Config(model=_compact(tcfg, **LEN8), optim=tcfg.OptimConfig(batch_size=2),
                      data=tcfg.DataConfig(data_root=str(tmp_path / "data"), synthetic=True,
                                           synthetic_num_seqs=4))
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    trainer.state.model.load_state_dict(params_from_flax(v, cfg.model))
    sd = load_reference_checkpoint(trainer.save(3))
    back = import_hmvae_params(sd, _compact(jcfg, **LEN8))
    for (pa, la), (pb, lb) in zip(jax.tree_util.tree_leaves_with_path(v),
                                  jax.tree_util.tree_leaves_with_path(back)):
        assert str(pa) == str(pb)
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb), err_msg=str(pa))


def _batch(seed=2):
    six, rm = _x6d(2, 8, seed)
    return {"rot_6d": torch.from_numpy(six), "rot_mat": torch.from_numpy(rm)}


def test_compact_training_is_bit_equal_to_dense_at_live_entries():
    cfg_d = tcfg.Config(model=tcfg.ModelConfig(**LEN8), loss=tcfg.LossConfig(iteration_interval=3),
                        optim=tcfg.OptimConfig(lr=1e-3, batch_size=2))
    cfg_c = dataclasses.replace(cfg_d, model=_compact(tcfg, **LEN8))
    sd = create_state(cfg_d, "cpu")
    sc = create_state(cfg_c, "cpu")
    sc.model.load_state_dict(pl.convert_state_dict(sd.model.state_dict(), cfg_d.model,
                                                   "compact"))
    eps = [torch.from_numpy(np.random.default_rng(5 + k).normal(size=(2, e, d)).astype(
        np.float32)) for k, (_, e, d) in enumerate(
        [(2, z, w) for z, w in zip(get_structure(cfg_d.model).z_edges,
                                   get_structure(cfg_d.model).z_dims)])]
    for i in range(5):
        b = _batch(10 + i)
        md = train_step(sd, b, cfg_d, eps)
        mc = train_step(sc, b, cfg_c, eps)
        assert {k: float(v) for k, v in md.items()} == {k: float(v) for k, v in mc.items()}, i
    live = pl.convert_state_dict(sd.model.state_dict(), cfg_d.model, "compact")
    for n, p in sc.model.state_dict().items():
        assert torch.equal(p, live[n]), n
    names = [n for n, _ in sd.model.named_parameters()]
    dense_opt = pl.convert_optimizer_state(sd.optimizer.state_dict(), names, cfg_d.model,
                                           "compact")
    comp_opt = sc.optimizer.state_dict()
    for i, st in comp_opt["state"].items():
        for k, t in st.items():
            assert torch.equal(t, dense_opt["state"][i][k]), (names[i], k)


def test_solver_on_a_compact_model_matches_jax_and_the_dense_solve():
    s = _setup()
    kw = {**LAT, "per_window_decoder": True}
    jc = jcfg.Config(model=_compact(jcfg, **LEN8), latent_opt=jcfg.LatentOptConfig(**kw))
    tc = tcfg.Config(model=_compact(tcfg, **LEN8), latent_opt=tcfg.LatentOptConfig(**kw))
    td = dataclasses.replace(tc, model=tcfg.ModelConfig(**LEN8))
    jv = jpl.convert_conv_params(jax.tree.map(np.asarray, s["params"]),
                                 jcfg.ModelConfig(**LEN8), "compact")
    ref = jax.tree.map(np.asarray, jlo.make_latent_optimizer(JHMVAE(jc.model), jc)(
        jv, {k: jnp.asarray(v) for k, v in s["targets"].items()}, jnp.asarray(s["mask"]),
        [jnp.asarray(a) for a in s["z"]], [jnp.asarray(a) for a in s["zr"]]))
    tm = HMVAE(tc.model)
    tm.load_state_dict(pl.convert_state_dict(s["tm"].state_dict(), td.model, "compact"))
    args = (s["targets"], s["mask"], s["z"], s["zr"])
    ours = tlo.make_latent_optimizer(tm, tc)(*args)
    dense = tlo.make_latent_optimizer(s["tm"], td)(*args)
    np.testing.assert_allclose(ours.loss_history.numpy(), ref.loss_history, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ours.last_6d.numpy(), ref.last_6d, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.final_loss.numpy(), ref.final_loss, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ours.final_loss.numpy(), dense.final_loss.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ours.last_6d.numpy(), dense.last_6d.numpy(), rtol=1e-4,
                               atol=1e-5)


def _trainer_cfg(tmp, layout, **run):
    return tcfg.Config(
        model=tcfg.ModelConfig(**{**LEN8, "param_layout": layout}),
        loss=tcfg.LossConfig(iteration_interval=4),
        optim=tcfg.OptimConfig(lr=1e-3, batch_size=2),
        data=tcfg.DataConfig(data_root=os.path.join(tmp, "data"), synthetic=True,
                             synthetic_num_seqs=4, use_native_loader=False),
        run=tcfg.RunConfig(**{"log_iter": 100, "validation_iter": 10 ** 9,
                              "snapshot_save_iter": 10 ** 9, "image_save_iter": 10 ** 9,
                              "seed": 3, **run}))


def _live(trainer):
    """A trainer's parameters in the compact layout (numpy)."""
    cfg = trainer.cfg.model
    return {k: v.numpy() for k, v in pl.convert_state_dict(
        trainer.state.model.state_dict(), dataclasses.replace(cfg, param_layout="dense"),
        "compact").items()}


def test_load_params_across_layouts(tmp_path):
    tmp = str(tmp_path)
    dense = Trainer(_trainer_cfg(tmp, "dense"), os.path.join(tmp, "d"), device="cpu")
    compact = Trainer(_trainer_cfg(tmp, "compact", seed=5), os.path.join(tmp, "c"), device="cpu")
    compact.load_params(dense.save(7))
    want = _live(dense)
    for k, v in _live(compact).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    back = Trainer(_trainer_cfg(tmp, "dense", seed=9), os.path.join(tmp, "d2"), device="cpu")
    back.load_params(compact.save(9))
    for k, v in _live(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # the dead entries come back as zeros
    w = back.state.model.encoder.conv_0.weight.detach().numpy()
    assert (w[~back.state.model.encoder.conv_0.spec.mask.astype(bool)] == 0).all()


class _Fixed:
    """The same batches, from the first, at every ``fit`` call."""

    def __init__(self, n=6):
        self.batches = []
        for k in range(n):
            six, rm = _x6d(2, 8, 20 + k)
            self.batches.append({"rot_6d": six, "rot_mat": rm})

    def iter_batches(self, batch_size):
        return itertools.cycle(self.batches)


@pytest.mark.parametrize("first,then", [("dense", "compact"), ("compact", "dense")])
def test_full_state_resume_across_layouts(tmp_path, first, then):
    """6 steps in one layout and a checkpoint, then 6 more in the same
    process and, resumed from the checkpoint, in the other layout, on the
    same batches and noise: the two runs' live entries the same bits."""
    tmp = str(tmp_path)
    data = _Fixed()
    a = Trainer(_trainer_cfg(tmp, first), os.path.join(tmp, "a"), device="cpu")
    a.fit(data, max_iter=6)
    ck = a.save()
    a.fit(data, max_iter=12)
    b = Trainer(_trainer_cfg(tmp, then), os.path.join(tmp, "b"), device="cpu")
    assert b.resume(ck) == 6
    b.fit(data, max_iter=12)
    assert b.state.step == 12
    want = _live(a)
    for k, v in _live(b).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
