"""The port's ``fused_conv_pool`` on CPU tensors (its plain version) against
the JAX package: the Pallas kernel in interpret mode, the XLA level
(skeleton_conv -> pool -> LeakyReLU) and the bare conv.  The CUDA kernel
itself is held against the same plain version on the GPU by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.ops import pallas_kernels as pk
from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_torch.ops import fused_conv_pool as fcp

B, C_IN, T, C_OUT, K, P = 2, 12, 16, 24, 3, 14


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(B, C_IN, T)).astype(np.float32),
        w=(rng.normal(size=(C_OUT, C_IN, K)) * 0.1).astype(np.float32),
        b=(rng.normal(size=(C_OUT,)) * 0.1).astype(np.float32),
        mask=(rng.random((C_OUT, C_IN)) > 0.5).astype(np.float32),
        pool=(rng.normal(size=(P, C_OUT)) * 0.2).astype(np.float32),
    )


def _port(d, stride, pad, mode, **kw):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return fcp.fused_conv_pool(t["x"], t["w"], t["b"], t["mask"], t["pool"], stride,
                               pad, mode, **kw).numpy()


@pytest.fixture
def interpret(monkeypatch):
    """Run pallas_call in interpret mode, as tests/test_pallas.py does."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    monkeypatch.setattr(pk.pl, "pallas_call", interp)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_plain_matches_pallas_interpret(interpret, stride, mode):
    d = _inputs()
    pad = (K - 1) // 2
    ref = np.asarray(pk.fused_conv_pool(
        *(jnp.asarray(d[k]) for k in ("x", "w", "b", "mask", "pool")), stride, pad,
        {"zeros": "constant"}.get(mode, mode)))
    ours = _port(d, stride, pad, mode)
    assert ours.shape == ref.shape
    # the Pallas kernel multiplies bf16 operands (tests/test_pallas.py:43-45)
    np.testing.assert_allclose(ours, ref, atol=0.02 * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_plain_matches_xla_level(stride, mode):
    d = _inputs(1)
    pad = 4
    ref = np.asarray(jsnn.leaky_relu(jsnn.apply_channel_matrix(jsnn.skeleton_conv(
        jnp.asarray(d["x"]), jnp.asarray(d["w"]), jnp.asarray(d["b"]),
        jnp.asarray(d["mask"]), stride, pad, mode), jnp.asarray(d["pool"])), 0.2))
    ours = _port(d, stride, pad, mode)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())),
                               rtol=0)


@pytest.mark.parametrize("stride", [1, 2])
def test_no_pool_no_bias_no_activation_is_the_conv(stride):
    d = _inputs(2)
    wm = d["w"] * d["mask"][:, :, None]
    ref = np.asarray(jsnn.skeleton_conv_w(jnp.asarray(d["x"]), jnp.asarray(wm), None,
                                          stride, 1, "reflect"))
    x, w = torch.from_numpy(d["x"]), torch.from_numpy(wm)
    ours = fcp.fused_conv_pool(x, w, None, None, None, stride, 1, "reflect",
                               negative_slope=1.0).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    masked = fcp.fused_conv_pool(x, torch.from_numpy(d["w"]), None,
                                 torch.from_numpy(d["mask"]), None, stride, 1, "reflect",
                                 negative_slope=1.0).numpy()
    np.testing.assert_allclose(masked, ref, atol=1e-5, rtol=0)


def test_cpu_tensors_never_launch():
    fcp.fused_conv_pool.launches = 0
    d = _inputs()
    _port(d, 2, 1, "reflect")
    fcp.fused_conv_pool_reference(*(torch.from_numpy(d[k]) for k in
                                    ("x", "w", "b", "mask", "pool")), 2, 1)
    assert fcp.fused_conv_pool.launches == 0


def test_other_devices_raise():
    x = torch.empty((B, C_IN, T), device="meta")
    w = torch.empty((C_OUT, C_IN, K), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fcp.fused_conv_pool(x, w, None, None, None, 1, 1)
    assert fcp.fused_conv_pool.launches == 0
