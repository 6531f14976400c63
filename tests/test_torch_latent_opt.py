"""The port's test-time solver (``hm_vae_torch.apps.latent_opt``) against the
JAX package's ``make_latent_optimizer`` on the CPU, at len-8 size, from the
same weights, targets, mask and numpy z, with ``opt_it`` crossing
``prev_epochs`` (a z phase, then a decoder phase):

- per-window clones and the shared clone; the ``full``, ``last_conv`` and
  ``heads`` scopes; ``optimize_decoder: false``; bf16 Adam moments; a final
  iteration that is the first decoder step: at a small lr every iteration's
  loss within 1e-5 relative, ``last_6d`` within 1e-5, ``final_loss`` within
  1e-5 relative (f32 sums in another order), rotations and positions within
  1e-4 (random weights decode short 6D vectors, and Gram-Schmidt amplifies
  a 6D difference by the inverse of their length);
- the production lr (0.1): Adam amplifies last-place differences (a
  near-zero gradient's update is +-lr), so the loss history must stay within
  10x the spread of a JAX run from the weights scaled by 1 + 1e-7, + 1e-5
  (the self-perturb band of tests/test_app_parity.py), and within 1e-5 over
  the first 3 iterations;
- the bf16 clone (``opt_param_dtype: bfloat16``): two decoder-chain steps
  bit-equal to the JAX chain's, per scope, per window and shared; a solve in
  the self-perturb band above, and within 1e-5 over its first 3 iterations;
- ``track_best``: the same best iterations as JAX's, per window and shared,
  the outputs in the self-perturb band;
- the unported options raise.  (The keyframe trajectory loss:
  ``test_torch_trajectory.py``; the lora scope: ``test_torch_lora.py``.)
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from hm_vae_tpu.apps import latent_opt as jlo
from hm_vae_tpu.apps.tasks import _targets_from_rotmat_np as jtargets
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.apps import latent_opt as tlo
from hm_vae_torch.apps.tasks import LatentOptApps
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
LAT = dict(opt_it=8, opt_lr=1e-3, opt_step_size=3, prev_epochs=3, reg_w=0.5,
           reg_w_decoder=1000.0, interpolation_window=3)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUP = {}


def _setup():
    """The JAX model and params, the port model on the same weights, and a
    batch of B windows: targets, a keyframe mask with one hidden joint, z."""
    if not _SETUP:
        jm = JHMVAE(jcfg.ModelConfig(**LEN8))
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24, 6)))
        mc = tcfg.ModelConfig(**LEN8)
        tm = HMVAE(mc)
        tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), mc), strict=False)
        rng = np.random.default_rng(0)
        rotm = R.from_rotvec(rng.normal(scale=0.4, size=(B * 8 * 24, 3))).as_matrix()
        targets = jtargets(rotm.astype(np.float32).reshape(B, 8, 24, 3, 3))
        mask = np.tile(np.array([1, 0, 0, 1, 0, 0, 1, 1], np.float32)[None, :, None], (B, 1, 24))
        mask[:, :, 23] = 0.0
        st = get_structure(mc)
        z = [rng.normal(size=(B, st.z_edges[i], st.z_dims[i])).astype(np.float32)
             if i in (0, mc.num_layers - 1) else
             np.zeros((B, st.z_edges[i], st.z_dims[i]), np.float32)
             for i in range(mc.num_layers)]
        zr = [0.1 * a for a in z]
        _SETUP.update(jm=jm, params=params, tm=tm, targets=targets, mask=mask, z=z, zr=zr)
    return _SETUP


def _cfgs(**lat):
    kw = {**LAT, **lat}
    return (jcfg.Config(model=jcfg.ModelConfig(**LEN8), latent_opt=jcfg.LatentOptConfig(**kw)),
            tcfg.Config(model=tcfg.ModelConfig(**LEN8), latent_opt=tcfg.LatentOptConfig(**kw)))


def _jax_solve(jc, params):
    s = _setup()
    res = jlo.make_latent_optimizer(s["jm"], jc)(
        params, {k: jnp.asarray(v) for k, v in s["targets"].items()}, jnp.asarray(s["mask"]),
        [jnp.asarray(a) for a in s["z"]], [jnp.asarray(a) for a in s["zr"]])
    return jax.tree.map(np.asarray, res)


def _port_solve(tc):
    s = _setup()
    return tlo.make_latent_optimizer(s["tm"], tc)(s["targets"], s["mask"], s["z"], s["zr"])


@pytest.mark.parametrize("lat", [
    dict(per_window_decoder=True),
    dict(per_window_decoder=False),
    dict(per_window_decoder=True, finetune_scope="last_conv"),
    dict(per_window_decoder=True, finetune_scope="heads"),
    dict(per_window_decoder=False, finetune_scope="last_conv"),
    dict(optimize_decoder=False),
    dict(per_window_decoder=True, opt_moment_dtype="bfloat16"),
    dict(per_window_decoder=True, opt_it=5, prev_epochs=4),  # the last step is the first
], ids=["per_window", "shared", "last_conv", "heads", "shared_last_conv", "no_decoder",
        "bf16_moments", "switch_at_last"])
def test_solve_matches_jax_per_iteration(lat):
    jc, tc = _cfgs(**lat)
    ref = _jax_solve(jc, _setup()["params"])
    ours = _port_solve(tc)
    hist = ours.loss_history.numpy()
    assert hist.shape == (tc.latent_opt.opt_it,)
    np.testing.assert_allclose(hist, ref.loss_history, rtol=1e-5, atol=0)
    for f, tol in (("last_6d", 1e-5), ("last_rotmat", 1e-4), ("last_pose", 1e-4)):
        got = getattr(ours, f).numpy()
        np.testing.assert_allclose(got, getattr(ref, f), atol=tol, rtol=0, err_msg=f)
        assert getattr(ours, f.replace("last", "best")) is getattr(ours, f)
    np.testing.assert_allclose(ours.final_loss.numpy(), ref.final_loss, rtol=1e-5, atol=0)


def test_production_lr_within_the_jax_self_perturb_band():
    """At opt_lr 0.1 both solvers move fast: the port's loss history stays in
    the band of a JAX run from weights scaled by 1 + 1e-7."""
    jc, tc = _cfgs(opt_lr=0.1, opt_it=10, prev_epochs=5, opt_step_size=5)
    params = _setup()["params"]
    ref = _jax_solve(jc, params).loss_history
    perturbed = _jax_solve(jc, jax.tree.map(lambda a: a * (1 + 1e-7), params)).loss_history
    ours = _port_solve(tc).loss_history.numpy()
    err = np.abs(ours / ref - 1)
    band = 10 * np.maximum.accumulate(np.abs(perturbed / ref - 1)) + 1e-5
    assert (err[:3] <= 1e-5).all(), err
    assert (err <= band).all(), (err, band)


def test_no_kernel_launches_on_the_cpu():
    counters = (fcp.fused_conv_pool, fcp.fused_conv_pool_dgrad, fcp.fused_conv_pool_wgrad,
                fcp.fused_conv_pool_windowed, fcp.fused_conv_pool_dgrad_windowed,
                fcp.fused_conv_pool_wgrad_windowed)
    for c in counters:
        c.launches = 0
    _port_solve(_cfgs(opt_it=3, prev_epochs=0)[1])
    assert all(c.launches == 0 for c in counters)


def _flax_to_port(tree, name):
    """The port's layout of a decoder leaf from a flax (sub)tree of numpy
    arrays: a latent head's ``weight`` is its ``kernel`` transposed."""
    mod, leaf = name.split(".")
    if leaf == "weight" and mod.startswith("latent_"):
        return np.ascontiguousarray(np.swapaxes(tree[mod]["kernel"], -1, -2))
    return np.asarray(tree[mod][leaf])


@pytest.mark.parametrize("per_window", [True, False], ids=["per_window", "shared"])
@pytest.mark.parametrize("scope", ["full", "last_conv", "heads"])
def test_sr_chain_steps_are_the_jax_bits(scope, per_window):
    """Two steps of the decoder chain on a bf16 clone, from given f32 values
    cast to bf16 and bf16 gradients (as both solvers' gradients of bf16
    leaves are), bit-equal to the JAX solver's chain (add_decayed_weights
    -> scale_by_adam_stored(bf16) -> scale_by_learning_rate ->
    stochastic_round_updates), under jax.vmap over 3 windows (every window
    the same hash bits) or on one shared clone: the trainable leaves, their
    order (the salts) and the transposed heads."""
    import optax

    from hm_vae_tpu.train.optim import scale_by_adam_stored, stochastic_round_updates
    from hm_vae_torch.train.optim import chain_init

    wd = 1e-4
    jc, tc = _cfgs(finetune_scope=scope, opt_param_dtype="bfloat16", opt_lr=0.1,
                   opt_moment_dtype="bfloat16", per_window_decoder=per_window)
    lat = jc.latent_opt
    dec_all = jax.tree.map(np.asarray, _setup()["params"]["params"]["decoder"])
    keys = jlo._scope_keys(dec_all, scope)
    rng = np.random.default_rng(4)
    lead = (3,) if per_window else ()

    def draw(scale):
        return {k: jax.tree.map(lambda a: (scale(a) * rng.normal(size=lead + a.shape)
                                           ).astype(np.float32), dec_all[k]) for k in keys}

    tree = draw(lambda a: np.abs(a).max())
    grads = [draw(lambda a: 1e-2), draw(lambda a: 1e-2)]
    bf16 = jnp.bfloat16
    tx = optax.chain(optax.add_decayed_weights(wd), scale_by_adam_stored(moment_dtype="bfloat16"),
                     optax.scale_by_learning_rate(jlo._steplr(lat.opt_lr * 1e-3, lat)),
                     stochastic_round_updates("bfloat16"))
    init, update = (jax.vmap(tx.init), jax.vmap(tx.update)) if per_window else (tx.init,
                                                                               tx.update)
    p = jax.tree.map(lambda a: jnp.asarray(a).astype(bf16), tree)
    state = init(p)
    for g in grads:
        u, state = update(jax.tree.map(lambda a: jnp.asarray(a).astype(bf16), g), state, p)
        p = optax.apply_updates(p, u)
    want = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), p)

    names = tlo.trainable_names([n for n, _ in _setup()["tm"].decoder.named_parameters()],
                                tc.latent_opt)
    assert {n.split(".")[0] for n in names} == set(keys)

    def port(t):
        return [torch.from_numpy(_flax_to_port(t, n)).to(torch.bfloat16) for n in names]

    leaves = port(tree)
    d_state = chain_init(leaves, "bfloat16")
    step = tlo.decoder_chain(names, tc.latent_opt, wd, per_window)
    for g in grads:
        leaves = step(leaves, port(g), d_state)
    for n, v in zip(names, leaves):
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.float().numpy(), _flax_to_port(want, n), err_msg=n)


@pytest.mark.parametrize("per_window", [True, False], ids=["per_window", "shared"])
def test_bf16_clone_solve_within_the_jax_self_perturb_band(per_window):
    """opt_param_dtype bfloat16 (with bf16 moments, as the production
    config): the clone stored in bf16, written back by stochastic rounding.
    At opt_lr 0.1 the port's loss history stays in the band of a JAX run from
    weights scaled by 1 + 1e-7, and within 1e-5 over the first 3 iterations
    (the f32 clone's history is 1e-4 away from the first iteration on)."""
    jc, tc = _cfgs(opt_lr=0.1, opt_it=10, prev_epochs=5, opt_step_size=5,
                   opt_param_dtype="bfloat16", opt_moment_dtype="bfloat16",
                   per_window_decoder=per_window)
    params = _setup()["params"]
    ref = _jax_solve(jc, params).loss_history
    perturbed = _jax_solve(jc, jax.tree.map(lambda a: a * (1 + 1e-7), params)).loss_history
    ours = _port_solve(tc).loss_history.numpy()
    err = np.abs(ours / ref - 1)
    band = 10 * np.maximum.accumulate(np.abs(perturbed / ref - 1)) + 1e-5
    assert (err[:3] <= 1e-5).all(), err
    assert (err <= band).all(), (err, band)


@pytest.mark.parametrize("per_window,opt_it", [(True, 6), (False, 5)],
                         ids=["per_window", "shared"])
def test_track_best_matches_jax(per_window, opt_it):
    """track_best at opt_lr 1.0, where the loss rises after the second
    iteration: ``best_*`` are the outputs of the least total per window (or
    of the batch), the last iteration compared too.  The port picks the
    iterations JAX picks (best equal to last in the same windows), and its
    best outputs agree with JAX's within 10x the spread of a JAX run from
    weights scaled by 1 + 1e-7, + 1e-5 (6D; rotations and positions 10x
    that, as Gram-Schmidt and FK amplify a 6D difference)."""
    jc, tc = _cfgs(opt_lr=1.0, opt_it=opt_it, prev_epochs=3, opt_step_size=50,
                   track_best=True, per_window_decoder=per_window)
    params = _setup()["params"]
    ref = _jax_solve(jc, params)
    perturbed = _jax_solve(jc, jax.tree.map(lambda a: a * (1 + 1e-7), params))
    ours = _port_solve(tc)
    same_j = (ref.best_6d == ref.last_6d).reshape(B, -1).all(1)
    same_t = (ours.best_6d == ours.last_6d).reshape(B, -1).all(1).numpy()
    np.testing.assert_array_equal(same_t, same_j)
    assert not same_j.all()
    for f, amp in (("best_6d", 1), ("best_rotmat", 10), ("best_pose", 10)):
        spread = float(np.abs(getattr(perturbed, f) - getattr(ref, f)).max())
        np.testing.assert_allclose(getattr(ours, f).numpy(), getattr(ref, f),
                                   atol=amp * (10 * spread + 1e-5), rtol=0, err_msg=f)


def test_production_config_solves_with_the_bf16_clone():
    """configs/len64_production.yaml's solver keys: the bf16 clone and bf16
    moments, in the port's config as in the JAX package's."""
    path = os.path.join(os.path.dirname(__file__), "..", "configs", "len64_production.yaml")
    for lat in (tcfg.load_config(path).latent_opt, jcfg.load_config(path).latent_opt):
        assert (lat.opt_param_dtype, lat.opt_moment_dtype) == ("bfloat16", "bfloat16")
        assert lat.finetune_scope == "full" and lat.per_window_decoder


def test_unported_arguments_raise():
    tc = _cfgs()[1]
    tm = _setup()["tm"]
    with pytest.raises(NotImplementedError, match="item 11"):
        LatentOptApps(tm, tc, mesh=object())
    # a trajectory without optimize_trajectory is not used, as in the JAX package
    assert LatentOptApps(tm, tc, trajectory=(None, None))._traj_solve is None
    with pytest.raises(ValueError, match="opt_param_dtype"):
        tlo.make_latent_optimizer(tm, dataclasses.replace(
            tc, latent_opt=dataclasses.replace(tc.latent_opt, opt_param_dtype="float16")))


def test_init_z_draws_deep_and_shallow_from_the_generator():
    tc = _cfgs()[1]
    z1 = tlo.init_z(torch.Generator().manual_seed(3), tc, 4)
    z2 = tlo.init_z(torch.Generator().manual_seed(3), tc, 4)
    st = get_structure(tc.model)
    assert [tuple(z.shape) for z in z1] == [(4, st.z_edges[i], st.z_dims[i]) for i in range(4)]
    assert all(torch.equal(a, b) for a, b in zip(z1, z2))
    assert not z1[1].any() and not z1[2].any() and z1[0].std() > 0.5 and z1[3].std() > 0.5
