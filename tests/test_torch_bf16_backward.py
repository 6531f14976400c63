"""Training at ``compute_dtype: bfloat16`` (the JAX package's bf16 params +
moments + compute mode) on the CPU, where the port's backward wrappers run
their plain versions (the bf16 dgrad and wgrad kernels run only on the GPU,
where chip_smoke.py phase 35 holds them against these plain versions):

- the plain bf16 dgrad, wgrad and bias grad through ``FusedConvPoolFn``
  against ``jax.vjp`` of the JAX package's level in bf16, at the eight
  levels of the full-width len-64 model (batch 2) and a K-31 level of the
  trajectory model, both paddings;
- the planner in bf16: whole-row plans that fit shared memory at the
  len-64 levels (batch 8 and 64) and the trajectory's (8, 128); the
  Python layouts against a transcription of the kernels' (``dgrad_layout``
  and ``wgrad_layout`` in ``csrc/fused_conv_pool_bwd.cu``) in both element
  sizes, and the item kernel's (``wgrad_span_layout``) over one batch's
  columns and several batches' rows; long rows planning dgrad's spans and
  wgrad's items in bf16, and a bf16 structure's backward lists at the
  kernels' 8-channel chunks.  (The windowed bf16 backward, its plans and
  the solve at bf16 compute: ``tests/test_torch_bf16_solve.py``.)

Training at bf16 compute is held against JAX in
``tests/test_torch_bf16_training.py``.

Tolerance: a level's gradients within 0.02 * max|ref|, the bf16 rule the
kernels are held to on the card (both sides round g and each output to
bf16 after f32 sums taken in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.models.trajectory import TrajectoryModel
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "configs", "len64_no_aug_hm_vae.yaml")
TRAJ_CONFIG = os.path.join(ROOT, "configs", "trajectory_model.yaml")
BF16 = torch.bfloat16
SMS = 132  # an H100's SMs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CASES = {}


def _cases(name):
    """(name, conv, input T) of the full-width len-64 model's eight convs,
    or of the trajectory model's four (at T 64), each at bf16 compute."""
    if name not in _CASES:
        gen = torch.Generator().manual_seed(0)
        if name == "len64":
            cfg = tcfg.load_config(CONFIG).model
            m = HMVAE(cfg, generator=gen)
            st = get_structure(cfg)
            cases = [(f"enc{i}", getattr(m.encoder, f"conv_{i}"), st.enc_timesteps[i])
                     for i in range(len(st.encoder_levels))]
            cases += [(f"dec{i}", getattr(m.decoder, f"conv_{i}"),
                       st.dec_timesteps[i] * (2 if lvl.upsample else 1))
                      for i, lvl in enumerate(st.decoder_levels)]
        else:
            m = TrajectoryModel(tcfg.load_config(TRAJ_CONFIG).model, generator=gen)
            cases = [(f"traj{i}", getattr(m.encoder, f"conv_{i}"), 64)
                     for i in range(len(m.encoder.structure.levels))]
        for _, conv, _ in cases:
            conv.dtype = BF16
        _CASES[name] = cases
    return _CASES[name]


def _bf16(a):
    """f32 numpy -> (the same values rounded to bf16 in torch, and in JAX)."""
    t = torch.from_numpy(a).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    tol = 0.02 * float(np.abs(ref).max())
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= tol, f"{what}: max |port - jax| {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("mode", ["reflect", "constant"])
@pytest.mark.parametrize("model,level", [("len64", i) for i in range(8)] + [("traj", 1)])
def test_bf16_level_grads_match_jax(model, level, mode):
    """The level in bf16 as JAX's SkeletonConv computes it at compute_dtype
    bfloat16 (x, the folded weight and the bias cast to bf16, the conv,
    LeakyReLU), its vjp against the port's plain bf16 backward."""
    name, conv, T = _cases(model)[level]
    with torch.no_grad():
        wf, bf = conv.folded_weight()
    assert wf.dtype == BF16
    sp, slope = conv.spec, conv.negative_slope
    s = fcp.pack_structure(conv.structure().live_elements(), sp.kernel_size, BF16, sp.stride,
                           sp.padding, mode, slope)
    rng = np.random.default_rng(level)
    xt, xj = _bf16(rng.normal(size=(2, wf.shape[1], T)).astype(np.float32))
    wj = jnp.asarray(wf.float().numpy(), jnp.bfloat16)
    b = np.zeros(wf.shape[0], np.float32) if bf is None else bf.float().numpy()
    bj = jnp.asarray(b, jnp.bfloat16)

    def f(x, w, b):
        return jsnn.leaky_relu(jsnn.skeleton_conv_w(x, w, b, sp.stride, sp.padding, mode),
                               slope)

    y_ref, vjp = jax.vjp(f, xj, wj, bj)
    assert y_ref.dtype == jnp.bfloat16
    gyt, gyj = _bf16(rng.normal(size=y_ref.shape).astype(np.float32))
    gx_ref, gw_ref, gb_ref = (np.asarray(g.astype(jnp.float32)) for g in vjp(gyj))

    xt.requires_grad_()
    wt = wf.detach().clone().requires_grad_()
    bt = None if bf is None else bf.detach().clone().requires_grad_()
    y = fcp.FusedConvPoolFn.apply(xt, wt, bt, s)
    y.backward(gyt)
    assert y.dtype == xt.grad.dtype == wt.grad.dtype == BF16
    live = s.live_elements().numpy()[:, :, None]
    what = f"{name} {mode}"
    _close(y.detach(), y_ref.astype(jnp.float32), f"{what} forward")
    _close(xt.grad, gx_ref, f"{what} dgrad")
    _close(wt.grad, gw_ref * live, f"{what} wgrad")
    if bt is not None:
        assert bt.grad.dtype == BF16
        _close(bt.grad, gb_ref, f"{what} bias grad")


# The kernels' shared-memory layouts (csrc/fused_conv_pool_bwd.cu), written
# out from the C++ here so that the planner's copies are held to them.
def _a16(n):
    return (n + 15) & ~15


def _c_dgrad_layout(T_in, K, T_out, t_ld, stride, padding, nbb, esz):
    off = (K + stride - 1) // stride - 1
    Tp = T_in + 2 * padding
    V0 = (Tp + stride - 1) // stride
    ln = off + max(V0, T_out)
    rs = (ln + 11) // 16 * 16 + 4 if esz == 4 else (ln + 23) // 32 * 32 + 8
    wr = 16 * K + 8
    w = 64
    g = w + _a16(2 * 32 * wr * esz)
    g2 = g + _a16(2 * nbb * 32 * t_ld * esz)
    out_bytes = 16 * nbb * Tp * 4
    g2_end = g2 + nbb * 32 * rs * (8 if esz == 4 else 2)
    out = w if out_bytes <= g - w else _a16(g2_end)
    return g2_end if out == w else out + out_bytes


def _c_wgrad_layout(B, T_in, K, T_out, t_ld, stride, sb, split, esz):
    nb_max = (B + split - 1) // split
    n_st = (nb_max + sb - 1) // sb
    Lx = (T_out - 1) * stride + K
    Lh = (Lx + stride - 1) // stride
    rsx = ((stride * Lh + 11) // 16 * 16 + 4 if esz == 4
           else (stride * Lh + 55) // 64 * 64 + 8)
    kw = 8 if esz == 4 else 16
    ks = (sb * T_out + kw - 1) // kw
    rj = 8 * K + 4
    g = 64 + _a16(nb_max * 8 * rsx * (8 if esz == 4 else 2))
    stage = _a16(2 * sb * 64 * t_ld * esz)
    gf = ks * 4 * 32 * (32 if esz == 4 else 16)
    x_raw = nb_max * 8 * T_in * esz
    red = 64 * rj * 4
    slots = min(n_st, 2)
    while True:
        total = max(g + slots * stage + max(gf, x_raw), g + red)
        if slots == 1 or total <= 233472 // 2 - 1024:
            return total
        slots -= 1


def _c_wgrad_span_layout(K, stride, span, esz, nbb, T_in, T_out, t_ld):
    gran, chunk, planes = 16 // esz, 128 // esz, 2 if esz == 4 else 1
    if nbb > 1:
        R = T_out + (K + stride - 1) // stride - 1
        Lh = nbb * R
        xr = 8 * T_in
        gbytes = nbb * 64 * t_ld * esz
        raw = 2 * gbytes + nbb * xr * esz
    else:
        Lx = (span - 1) * stride + K
        R, Lh = 0, (Lx + stride - 1) // stride
        xr = (Lx + 3 * gran - 3) // gran * gran
        gbytes = span // chunk * 64 * 128
        raw = 2 * gbytes + 8 * xr * esz
    ln = stride * Lh
    rsx = (ln + 11) // 16 * 16 + 4 if esz == 4 else (ln + 1 + 55) // 64 * 64 + 8
    stage = (raw + 1023) & ~1023
    xs = 64 + 1024 + 2 * stage
    bt = xs + _a16(2 * 8 * rsx * (8 if esz == 4 else 2))
    tab = bt + 2 * planes * 4 * 2048
    tab_end = tab + (stride * R * 8 if nbb > 1 else 0)
    return max(tab_end, 64 + 64 * (8 * K + 4) * 4)


def _shapes():
    """(structure, batch, T) of the whole-row shapes training reaches: the
    len-64 levels at batch 8 and 64, the trajectory's at (8, 128)."""
    for _, conv, T in _cases("len64"):
        for B in (8, 64):
            yield conv.structure(), B, T
    for _, conv, _ in _cases("traj"):
        yield conv.structure(), 8, 128


def test_bf16_whole_row_plans_fit_shared_memory():
    n = 0
    for s, B, T in _shapes():
        assert s.dtype == BF16
        K, stride, pad = s.kernel_size, s.stride, s.padding
        T_out = (T + 2 * pad - K) // stride + 1
        t_ld = -(-T_out // 8) * 8  # rows of gy and y in 16-byte granules of 8 bf16
        assert fcp.dgrad_whole_rows(T, K, stride, pad, t_ld, 2)
        d = fcp.dgrad_whole_plan(B, T, K, stride, pad, t_ld, s.dgrad_start.numel() - 1,
                                 s.dgrad_max_live, SMS, esz=2)
        assert d.span == 0 and fcp._dgrad_smem(T, K, t_ld, stride, pad, d.nbb, 2) <= fcp.MAX_SMEM
        # routed: at the production batch, and at the trajectory's (8, 128),
        # dgrad takes spans of whole rows
        routed = fcp.dgrad_plan(B, T, K, stride, pad, t_ld, s.dgrad_start.numel() - 1,
                                s.dgrad_max_live, SMS, esz=2)
        assert (routed.span > 0) == (B == 64 or K == 31)
        assert not routed.span or routed.nbb * (T + 2 * pad) <= routed.span
        # a group never holds more columns than its warps' tiles
        assert d.nbb == 1 or fcp._dgrad_tiles(T + 2 * pad, stride, d.nbb) <= fcp.BWD_WARPS
        assert fcp.wgrad_whole_rows(B, T, K, T_out, t_ld, stride, 2)
        smem = lambda sb, split: fcp._wgrad_smem(B, T, K, T_out, t_ld, stride, sb,  # noqa
                                                 split, 2)
        w = fcp.wgrad_plan(B, T_out, s.wgrad_row.numel(), SMS, smem=smem)
        assert w.span == 0 and smem(w.sb, w.split) <= fcp.MAX_SMEM
        # bf16 stages are half as large: never a smaller group than f32's
        d32 = fcp.dgrad_whole_plan(B, T, K, stride, pad, -(-T_out // 4) * 4,
                                   s.dgrad_start.numel() - 1, s.dgrad_max_live, SMS)
        assert d.nbb >= d32.nbb
        n += 1
    assert n == 8 * 2 + 4


@pytest.mark.parametrize("esz", [4, 2])
def test_planner_layouts_mirror_the_kernels(esz):
    n = 0
    for K in (3, 15, 31):
        for stride in (1, 2):
            for T in (8, 16, 33, 64, 128, 150):
                pad = (K - 1) // 2
                if T + 2 * pad < K:
                    continue
                T_out = (T + 2 * pad - K) // stride + 1
                gran = 16 // esz
                t_ld = -(-T_out // gran) * gran
                for nbb in (1, 2, 5):
                    assert fcp._dgrad_smem(T, K, t_ld, stride, pad, nbb, esz) == \
                        _c_dgrad_layout(T, K, T_out, t_ld, stride, pad, nbb, esz)
                for B, split in ((8, 1), (8, 8), (64, 3)):
                    sb = max(1, min(-(-B // split), 32 // T_out))
                    assert fcp._wgrad_smem(B, T, K, T_out, t_ld, stride, sb, split, esz) == \
                        _c_wgrad_layout(B, T, K, T_out, t_ld, stride, sb, split, esz)
                # the item kernel's: one batch's columns, and several batches'
                # rows at every count an item can take
                span = fcp.wgrad_span_cols(K, stride, esz)
                for nbb in (1, 2, 5, max(1, span // T_out)):
                    if nbb > 1 and nbb * T_out > span:
                        continue
                    assert fcp._wgrad_span_smem(K, stride, span, esz, nbb, T, T_out, t_ld) == \
                        _c_wgrad_span_layout(K, stride, span, esz, nbb, T, T_out, t_ld)
                n += 1
    assert n > 30


@pytest.mark.parametrize("model,level,T,wgrad_spans", [
    ("traj", 0, 1024, True), ("traj", 3, 7200, True), ("len64", 1, 1024, True)])
def test_bf16_long_rows_plan_kernels_that_fit(model, level, T, wgrad_spans):
    """Rows past a whole-row block (the trajectory at T 1,024 and 7,200, a
    stride-2 len-64 level at T 1,024) run in bf16 too: dgrad its span
    kernel (spans of one batch's row, two or more stages of its bf16
    planes in a block), wgrad its item kernel (items of one batch's 128
    columns, two stages of bf16 boxes in a block, two blocks an SM).  At
    the len-64 level
    wgrad's bf16 stages, half as large, would still fit whole rows (batch
    2), but the plan takes items there as f32 does (``wgrad_items_routed``:
    the card timed them faster)."""
    _, conv, _ = _cases(model)[level]
    sp = conv.spec
    s = fcp.pack_structure(conv.structure().live_elements(), sp.kernel_size, BF16, sp.stride,
                           sp.padding, sp.padding_mode, conv.negative_slope, device="meta")
    K, stride, pad = sp.kernel_size, sp.stride, sp.padding
    T_out = (T + 2 * pad - K) // stride + 1
    t_ld = -(-T_out // 8) * 8
    d = fcp.dgrad_plan(2, T, K, stride, pad, t_ld, s.dgrad_start.numel() - 1, s.dgrad_max_live,
                       SMS, 1, (s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live), esz=2)
    assert d.nbb == 1 and d.groups == 2 and d.span == fcp.dgrad_span_cols(K, stride, 2) == 256
    assert fcp.dgrad_span_rows(T, K, stride, pad, d.span) == 0
    smem, stages = fcp._dgrad_span_layout(K, stride, d.span, 2)
    assert smem <= fcp.MAX_SMEM and stages >= 3
    # bf16's whole rows fit at the len-64 level only
    assert fcp.wgrad_whole_rows(2, T, K, T_out, t_ld, stride, 2) == (model == "len64")
    assert not fcp.wgrad_whole_rows(2, T, K, T_out, -(-T_out // 4) * 4, stride,
                                    4)  # f32 takes items at every one
    cols = fcp.wgrad_span_cols(K, stride, 2)
    assert not fcp.wgrad_rows_routed(2, T, K, stride, pad, 2)
    assert fcp.wgrad_items_routed(2, T, K, stride, pad, 2)  # as f32's
    rows = fcp.wgrad_routed_rows(2, T, K, stride, pad, 2, cols)
    w = fcp.wgrad_plan(2, T_out, s.wgrad_row.numel(), SMS, 1,
                       lambda sb, split: fcp._wgrad_smem(2, T, K, T_out, t_ld, stride, sb,
                                                         split, 2), cols, rows)
    assert (rows == 1 and w.span > 0) == wgrad_spans
    # items of one batch's columns, two chunks of 64 bf16 columns each
    assert w.sb == 1 and w.span == cols == 128 and 1 <= w.split <= fcp.MAX_SPLIT
    assert fcp._wgrad_span_smem(K, stride, w.span, 2) <= fcp.MAX_SMEM
    # bf16: one or two m64 tiles a warpgroup, two blocks an SM
    assert fcp.wgrad_items_per_sm(K, stride, w.span, 2) == 2


def test_bf16_structure_lists_are_the_backward_chunks():
    """A bf16 structure's forward tiles are 16 channels wide, its backward
    lists 8 (the kernels' chunk in either dtype): the same lists as the f32
    structure of the same live entries."""
    for _, conv, _ in _cases("len64") + _cases("traj"):
        s16 = conv.structure()
        sp = conv.spec
        s32 = fcp.pack_structure(s16.live_elements(), sp.kernel_size, torch.float32, sp.stride,
                                 sp.padding, sp.padding_mode, conv.negative_slope)
        assert s16.live.shape[1] == -(-s16.in_channels // 16)
        for f in ("bwd_live", "wgrad_row", "wgrad_chunk", "dgrad_start", "dgrad_row",
                  "dgrad_span_start", "dgrad_span_row", "dgrad_span_group"):
            assert torch.equal(getattr(s16, f), getattr(s32, f)), f
        assert (s16.dgrad_max_live, s16.dgrad_span_max_live) == (
            s32.dgrad_max_live, s32.dgrad_span_max_live)
        assert torch.equal(s16.live_elements(), s32.live_elements())
