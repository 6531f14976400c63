"""The port's optimizer against the JAX package's on the same gradients
(CPU): ``TorchAdamL2`` (``make_optimizer``) over several steps against
``torch_adam_l2`` and the plain optax chain, with parameters missing a
gradient (None here, an all-zero leaf there), a StepLR boundary, bf16
moments, and bf16 parameters with the counter-hash stochastic rounding,
whose bits must agree exactly.

Tolerances: f32 parameters 1e-6 * max(1, |p|) (the same expression,
``pow`` and ``sqrt`` may round differently in the last place); bf16
parameters within one bf16 ulp (a last-place f32 difference can move a
stochastic rounding across its threshold)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hm_vae_tpu.train import optim as joptim
from hm_vae_tpu.train.train_step import cast_params as jcast
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.train import optim as toptim
from hm_vae_torch.train.train_step import cast_params
from hm_vae_torch.utils import config as tcfg

# a parameter tree shaped like the model's: conv weights and biases, latent
# Dense kernels (transposed in the port), one decoder conv without a bias
SHAPES = {
    "decoder": {"conv_0": {"weight": (4, 6, 3)},
                "latent_dec_0": {"bias": (7,), "kernel": (3, 7)}},
    "encoder": {"conv_0": {"bias": (6,), "weight": (6, 4, 3)},
                "conv_0_extra_0": {"bias": (4,), "weight": (4, 4, 3)},
                "latent_head_0": {"bias": (3,), "kernel": (5, 3)},
                "latent_head_1": {"bias": (2,), "kernel": (4, 2)}},
}
# parameter -> the steps at which it has no gradient
NO_GRAD = {"encoder.latent_head_1.kernel": range(0, 4), "encoder.latent_head_1.bias": range(0, 4),
           "decoder.latent_dec_0.kernel": [2], "decoder.latent_dec_0.bias": [2]}
STEPS = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves():
    for part, mods in SHAPES.items():
        for mod, leaves in mods.items():
            for leaf, shape in leaves.items():
                yield f"{part}.{mod}.{leaf}", (part, mod, leaf), shape


def _port_name(name):
    return name.replace(".kernel", ".weight")


def _tree(fn):
    out = {}
    for name, (part, mod, leaf), shape in _leaves():
        out.setdefault(part, {}).setdefault(mod, {})[leaf] = fn(name, shape)
    return {"params": out}


def _run(cfg_kw, param_dtype=None, grad_dtype=np.float32):
    rng = np.random.default_rng(0)
    init = _tree(lambda n, s: rng.normal(size=s).astype(np.float32))
    grads = [_tree(lambda n, s, i=i: (np.zeros(s, np.float32) if i in NO_GRAD.get(n, ())
                                      else rng.normal(size=s).astype(np.float32) * 0.1))
             for i in range(STEPS)]
    # JAX: the optax transformation on the tree
    jc = jcfg.OptimConfig(**cfg_kw)
    tx = joptim.make_optimizer(jc)
    params = jax.tree.map(jnp.asarray, init)
    if param_dtype:
        params = jcast(params, param_dtype)
    state = tx.init(params)
    for g in grads:
        g = jax.tree.map(lambda a: jnp.asarray(a).astype(grad_dtype), g)
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    # the port: named parameters (kernels transposed), None where JAX has 0
    module = torch.nn.Module()
    named = []
    for name, (part, mod, leaf), _ in _leaves():
        a = init["params"][part][mod][leaf]
        p = torch.nn.Parameter(torch.from_numpy(a.T.copy() if leaf == "kernel" else a.copy()))
        module.register_parameter(_port_name(name).replace(".", "__"), p)
        named.append((_port_name(name), p))
    if param_dtype:
        cast_params(module, param_dtype)
    opt = toptim.make_optimizer(named, tcfg.OptimConfig(**cfg_kw))
    for i, g in enumerate(grads):
        opt.zero_grad(set_to_none=True)
        for name, (part, mod, leaf), _ in _leaves():
            if i in NO_GRAD.get(name, ()):
                continue
            a = g["params"][part][mod][leaf]
            p = dict(named)[_port_name(name)]
            p.grad = torch.from_numpy(a.T.copy() if leaf == "kernel" else a.copy()).to(p.dtype)
        opt.step()
    return params, state, named, opt


def _leaf(tree, name):
    part, mod, leaf = name.split(".")
    return tree["params"][part][mod][leaf]


def _as_port(a, name):
    a = np.asarray(a, np.float32)
    return a.T if name.endswith("kernel") else a


BASE = dict(lr=0.01, weight_decay=0.1, lr_policy="step", step_size=3, gamma=0.5)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_torch_adam_l2_matches_jax(moment_dtype):
    """Grad-None skip counts, the StepLR boundary at step 3 and 6, f32 or
    bf16 moments."""
    params, state, named, opt = _run(dict(BASE, moment_dtype=moment_dtype))
    ours = dict(named)
    for name, _, _ in _leaves():
        p = ours[_port_name(name)]
        ref = _as_port(_leaf(params, name), name)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(ref).max())), err_msg=name)
        st = opt.state[p]
        assert st.get("step", 0) == int(_leaf(state.counts, name)), name
        for key, mom in (("exp_avg", state.mu), ("exp_avg_sq", state.nu)):
            m = _as_port(_leaf(mom, name), name)
            assert st[key].dtype == getattr(torch, moment_dtype)
            tol = 1e-6 if moment_dtype == "float32" else 2 ** -7
            np.testing.assert_allclose(st[key].float().numpy(), m, rtol=tol,
                                       atol=1e-12, err_msg=f"{name} {key}")
    assert opt.param_groups[0]["step"] == int(state.count) == STEPS
    # no gradient at steps 0-3: its count starts fresh at step 4
    assert opt.state[ours["encoder.latent_head_1.weight"]]["step"] == STEPS - 4


def test_plain_chain_matches_jax():
    """none_grad_skip off: one global count, a missing gradient counts as
    zeros (decay and moments still step)."""
    params, state, named, opt = _run(dict(BASE, none_grad_skip=False))
    for name, _, _ in _leaves():
        p = dict(named)[_port_name(name)]
        ref = _as_port(_leaf(params, name), name)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(ref).max())), err_msg=name)
        assert opt.state[p]["step"] == STEPS


def test_bf16_params_stochastic_rounding_matches_jax():
    params, _, named, opt = _run(dict(BASE, param_dtype="bfloat16"), param_dtype="bfloat16",
                                 grad_dtype=jnp.bfloat16)
    for name, _, _ in _leaves():
        p = dict(named)[_port_name(name)]
        assert p.dtype == torch.bfloat16
        ref = _as_port(_leaf(params, name), name)
        got = p.detach().float().numpy()
        # within one bf16 ulp (8 significant bits), and equal almost everywhere
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(got - ref) <= ulp).all(), name
        assert (got == ref).mean() > 0.9, name


@pytest.mark.parametrize("shape,salt,count", [((6, 4, 3), 1, 1), ((5, 3), 7, 12),
                                              ((1000,), 33, 250000)])
def test_hash_bits_are_jax_bits(shape, salt, count):
    ref = np.asarray(joptim._hash_bits16(shape, salt, jnp.asarray(count, jnp.int32)))
    ours = toptim._hash_bits16(shape, salt, count).numpy()
    assert (ours == ref.astype(np.int64)).all()
    x = np.random.default_rng(salt).normal(size=shape).astype(np.float32)
    sr_ref = np.asarray(joptim.stochastic_round_bf16_hash(jnp.asarray(x), salt,
                                                          jnp.asarray(count, jnp.int32)))
    sr = toptim.stochastic_round_bf16_hash(torch.from_numpy(x), salt, count).numpy()
    assert (sr.view(np.uint32) == sr_ref.view(np.uint32)).all()
    assert (sr.view(np.uint32) & 0xFFFF == 0).all()


def test_flax_salt_order():
    """Salts follow the flax tree's sorted-key flatten order."""
    names = [_port_name(n) for n, _, _ in _leaves()]
    salts = toptim.flax_salts(names)
    order = [_port_name(".".join(k.key for k in path[1:]))
             for path, _ in jax.tree_util.tree_flatten_with_path(_tree(lambda n, s: 0))[0]]
    assert [salts[n][0] for n in order] == list(range(1, len(order) + 1))
    assert salts["encoder.latent_head_0.weight"][1] and not salts["encoder.conv_0.weight"][1]


@pytest.mark.parametrize("policy,step_size", [("constant", 1), ("step", 4), ("mstep", (3, 5))])
def test_schedules_match_jax(policy, step_size):
    ref = joptim.make_schedule_raw(1e-3, policy, step_size, 0.3)
    ours = toptim.make_schedule_raw(1e-3, policy, step_size, 0.3)
    for c in range(9):
        assert float(ours(c)) == pytest.approx(float(ref(jnp.asarray(c))), rel=1e-6), c


def test_bf16_params_need_none_grad_skip():
    with pytest.raises(ValueError, match="none_grad_skip"):
        toptim.make_optimizer([], dataclasses.replace(
            tcfg.OptimConfig(), param_dtype="bfloat16", none_grad_skip=False))
