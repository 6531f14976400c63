"""The packed operands of the port's ``fused_conv_pool`` kernel on the CPU:
packing round-trips to the folded weight, the live-tile lists at the
full-width len-64 structure, and the packed level's plain version against the
JAX package (the XLA level and the Pallas kernel in interpret mode).  The
CUDA kernel itself reads these packed operands on the GPU, where
chip_smoke.py holds it against the same plain version."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.ops import pallas_kernels as pk
from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_torch.models.hm_vae import HMVAE, SkeletonConv
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "len64_no_aug_hm_vae.yaml")
DTYPES = [torch.float32, torch.bfloat16]
B, C_IN, T, C_OUT, K, P = 2, 12, 16, 24, 3, 14


def _inputs(seed=0, c_in=C_IN):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(B, c_in, T)).astype(np.float32),
        w=(rng.normal(size=(C_OUT, c_in, K)) * 0.1).astype(np.float32),
        b=(rng.normal(size=(C_OUT,)) * 0.1).astype(np.float32),
        mask=(rng.random((C_OUT, c_in)) > 0.5).astype(np.float32),
        pool=(rng.normal(size=(P, C_OUT)) * 0.2).astype(np.float32),
        unpool=(rng.random((c_in, 5)) > 0.6).astype(np.float32),
    )


def _packed(d, stride, pad, mode, pool=True, slope=0.2):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    wf, bf = fcp.fold_operands(t["w"], t["b"], t["mask"], t["pool"] if pool else None)
    return fcp.pack_level(wf, bf, stride, pad, mode, slope), wf, bf


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(24, 12, 3), (168, 144, 15), (70, 20, 5), (64, 16, 1)])
def test_pack_round_trips_exactly(dtype, shape):
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    w[:, : shape[1] // 3] = 0  # whole zero tiles on wide levels
    b = torch.from_numpy(rng.normal(size=shape[:1]).astype(np.float32)).to(dtype)
    packed = fcp.pack_level(w, b, 2, shape[2] // 2)
    w2, b2 = fcp.unpack_level(packed)
    assert w2.dtype == dtype and torch.equal(w2, w) and torch.equal(b2, b)
    rows = -(-shape[0] // fcp.ROWS)
    assert packed.tile_start.shape == (rows + 1,) and packed.bias.dtype == torch.float32
    assert packed.tiles.shape[0] == packed.tile_chunk.numel() == int(packed.tile_start[-1])
    if dtype == torch.float32:  # TF32 rounding + remainder, the rounding exact in TF32
        big = packed.tiles.reshape(packed.tiles.shape[0], 2, -1)[:, 0]
        assert (big.view(torch.int32) & 0x1FFF == 0).all()
    none = fcp.unpack_level(fcp.pack_level(w, None, 1, 0))[1]
    assert none is None


def test_pack_layout_is_wgmma_core_matrices():
    """Value (row r, reduction j = k*16 + c) of a bf16 tile sits at byte
    (j//16)*2048 + (j//8 % 2)*128 + (r//8)*256 + (r%8)*16 + (j%8)*2."""
    w = torch.arange(64 * 16 * 15, dtype=torch.float32).reshape(64, 16, 15) + 1
    tile = fcp.pack_level(w.to(torch.bfloat16), None, 1, 7).tiles[0].float()
    for r in (0, 5, 9, 63):
        for c, k in ((0, 0), (3, 0), (7, 4), (8, 4), (15, 14)):
            j = k * 16 + c
            byte = (j // 16) * 2048 + (j // 8 % 2) * 128 + (r // 8) * 256 + (r % 8) * 16 \
                + (j % 8) * 2
            assert tile[byte // 2] == w[r, c, k].to(torch.bfloat16).float()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_packing_round_trips_to_folded_weight(dtype):
    cfg = tcfg.ModelConfig(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8,
                           compute_dtype=dtype)
    m = HMVAE(cfg, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for conv in (c for c in m.modules() if isinstance(c, SkeletonConv)):
            fw, fb = conv.folded_weight()
            w2, b2 = fcp.unpack_level(conv.packed_operands())
            assert torch.equal(w2, fw)
            assert (b2 is None and fb is None) or torch.equal(b2, fb)


def _structural(conv):
    """The folded weight's live (row, channel) pattern from the structure:
    the mask, through the pool after it or the unpool before it."""
    live = conv.spec.mask != 0
    if conv.unpool is not None:
        live = (live.astype(np.float32) @ (conv.unpool.numpy() != 0)) > 0
    if conv.pool is not None:
        live = ((conv.pool.numpy() != 0).astype(np.float32) @ live) > 0
    return live


@pytest.fixture(scope="module")
def full_width():
    cfg = tcfg.load_config(CONFIG)
    return HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dtype", DTYPES)
def test_live_tiles_cover_every_nonzero_and_no_zero_tile(full_width, dtype):
    """At every level of the full-width len-64 model the live-tile lists
    name exactly the (64-row, chunk) tiles where the structure is nonzero."""
    counts = []
    with torch.no_grad():
        for name in ([f"encoder.conv_{i}" for i in range(4)]
                     + [f"decoder.conv_{i}" for i in range(4)]):
            conv = full_width.get_submodule(name)
            conv.dtype = dtype
            packed = conv.packed_operands()
            live = torch.from_numpy(_structural(conv))
            rows, cin = live.shape
            cc = fcp.CHUNK_CHANNELS[dtype]
            rt, nc = -(-rows // fcp.ROWS), -(-cin // cc)
            pad = torch.zeros(rt * fcp.ROWS, nc * cc, dtype=torch.bool)
            pad[:rows, :cin] = live
            want = pad.reshape(rt, fcp.ROWS, nc, cc).any(3).any(1)  # (rt, nc)
            got = torch.zeros(rt, nc, dtype=torch.bool)
            for r in range(rt):
                s, e = int(packed.tile_start[r]), int(packed.tile_start[r + 1])
                chunks = packed.tile_chunk[s:e].long()
                assert (chunks[1:] > chunks[:-1]).all()
                got[r, chunks] = True
            assert torch.equal(got, want), name
            fw, _ = conv.folded_weight()
            assert torch.equal(fw.abs().sum(2) != 0, live), name  # values follow structure
            assert packed.max_live == int(want.sum(1).max())
            counts.append((int(want.sum()), rt * nc))
    if dtype == torch.bfloat16:  # 64-row x 16-channel tiles live / all, per level
        assert counts == [(21, 27), (30, 44), (78, 84), (231, 231), (252, 252), (75, 84),
                          (35, 42), (45, 63)]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_plain_matches_xla_level_with_pool(stride, mode, dtype):
    d = _inputs(3)
    pad = 4
    ref = np.asarray(jsnn.leaky_relu(jsnn.apply_channel_matrix(jsnn.skeleton_conv(
        jnp.asarray(d["x"]), jnp.asarray(d["w"]), jnp.asarray(d["b"]),
        jnp.asarray(d["mask"]), stride, pad, mode), jnp.asarray(d["pool"])), 0.2))
    t = {k: torch.from_numpy(v).to(dtype) for k, v in d.items()}
    wf, bf = fcp.fold_operands(t["w"], t["b"], t["mask"], t["pool"])
    ours = fcp.fused_conv_pool_packed(t["x"], fcp.pack_level(wf, bf, stride, pad, mode))
    assert ours.dtype == dtype and ours.shape == ref.shape
    # f32: sums in another order; bf16: operands and output rounded to bf16
    tol = (1e-4 * max(1.0, float(np.abs(ref).max())) if dtype == torch.float32
           else 0.02 * float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_packed_plain_matches_xla_level_with_unpool(stride, mode):
    """A decoder level: the unpool folded into the weight, no pool, and no
    activation, against unpool -> skeleton_conv in JAX."""
    d = _inputs(4)
    U = d["unpool"]  # (C_IN, 5): 5 pre-unpool channels
    x = np.random.default_rng(5).normal(size=(B, 5, T)).astype(np.float32)
    ref = np.asarray(jsnn.skeleton_conv(
        jsnn.apply_channel_matrix(jnp.asarray(x), jnp.asarray(U)), jnp.asarray(d["w"]),
        jnp.asarray(d["b"]), jnp.asarray(d["mask"]), stride, 1, mode))
    w = torch.from_numpy(d["w"] * d["mask"][:, :, None])
    wf = torch.einsum("ock,cp->opk", w, torch.from_numpy(U)).contiguous()
    packed = fcp.pack_level(wf, torch.from_numpy(d["b"]), stride, 1, mode, 1.0)
    ours = fcp.fused_conv_pool_packed(torch.from_numpy(x), packed).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())),
                               rtol=0)


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
def test_packed_plain_matches_pallas_interpret(interpret, stride, mode):
    d = _inputs(6, c_in=20)  # a ragged last chunk in both dtypes
    pad = (K - 1) // 2
    ref = np.asarray(pk.fused_conv_pool(
        *(jnp.asarray(d[k]) for k in ("x", "w", "b", "mask", "pool")), stride, pad,
        {"zeros": "constant"}.get(mode, mode)))
    packed, _, _ = _packed(d, stride, pad, mode)
    ours = fcp.fused_conv_pool_packed(torch.from_numpy(d["x"]), packed).numpy()
    assert ours.shape == ref.shape
    # the Pallas kernel multiplies bf16 operands (tests/test_pallas.py:43-45)
    np.testing.assert_allclose(ours, ref, atol=0.02 * float(np.abs(ref).max()), rtol=0)


def test_packed_entry_on_cpu_never_launches_and_meta_raises():
    d = _inputs(7)
    packed, wf, bf = _packed(d, 2, 1, "reflect")
    fcp.fused_conv_pool.launches = 0
    x = torch.from_numpy(d["x"])
    ours = fcp.fused_conv_pool_packed(x, packed)
    ref = fcp.fused_conv_pool_reference(x, wf, bf, None, None, 2, 1, "reflect", 0.2)
    torch.testing.assert_close(ours, ref, atol=0, rtol=0)
    assert fcp.fused_conv_pool.launches == 0
    with pytest.raises(ValueError, match="cpu or cuda"):
        fcp.fused_conv_pool_packed(torch.empty(x.shape, device="meta"), packed)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fcp.pack_level(wf.double(), None, 1, 1)
    with pytest.raises(ValueError, match="padding_mode"):
        fcp.pack_level(wf, None, 1, 1, "circular")


@pytest.mark.parametrize("kernel,variant", [("fwd", "base"), ("fwd", "nobuild"),
                                            ("fwd", "nomma"), ("dgrad", "base"),
                                            ("wgrad", "base")])
def test_kernel_trace_still_patches_the_kernel(kernel, variant):
    """kernel_trace.py stamps the kernel sources at fixed anchors; each must
    still be found exactly once."""
    import kernel_trace

    src = kernel_trace.patched_source(variant, kernel)
    assert src.count("gtime()") == (11 if kernel == "fwd" else 9)
    assert ("k < 0" in src) == (variant != "base")
