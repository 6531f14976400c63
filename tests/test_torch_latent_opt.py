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
- the unported options raise.  (The keyframe trajectory loss:
  ``test_torch_trajectory.py``.)
"""

import dataclasses

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


@pytest.mark.parametrize("change,match", [
    (dict(finetune_scope="lora"), "item 6"),
    (dict(opt_param_dtype="bfloat16"), "later slice"),
    (dict(track_best=True), "track_best"),
])
def test_unported_options_raise(change, match):
    with pytest.raises(NotImplementedError, match=match):
        tlo.make_latent_optimizer(_setup()["tm"], _cfgs(**change)[1])


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
