"""The test-time solve at ``compute_dtype: bfloat16`` on the CPU, where the
port's windowed wrappers run their plain versions (the windowed bf16
forward, dgrad and wgrad kernels run only on the GPU, where chip_smoke.py
phase 36 holds them against these plain versions):

- the plain windowed bf16 level (forward, dgrad, wgrad and the bias
  gradient, through ``WindowedFusedConvPoolFn``) against ``jax.vjp`` of
  ``jax.vmap`` of the JAX package's level at compute_dtype bfloat16 (x, the
  folded weight and the bias cast to bf16), at the four decoder levels of
  the full-width len-64 model, 3 windows of one batch, both paddings:
  within 0.02 * max|ref|, the bf16 rule the kernels are held to on the card;
- the solve at bf16 compute against ``make_latent_optimizer`` at bf16
  compute, at len-8 size as ``test_torch_latent_opt.py`` sets it up, from
  the same weights (``params_from_flax``), targets, mask and numpy z,
  per-window and shared clones, the ``full``, ``last_conv`` and ``lora``
  scopes, the clone in f32 and in bf16.  Both sides round to bf16 at every
  conv, after sums in another order, so no bitwise bound holds; the
  yardstick is what bf16 compute does to JAX's own solve.  Tolerance:
  iteration i's loss within twice the distance between JAX's bf16- and
  f32-compute histories so far (the largest |bf16 - f32| over iterations
  0..i), + 1e-4 * max(1, |ref|); the first iteration within 1e-2 relative;
- at the production lr (0.1) with the bf16 clone, that band is narrower
  than JAX's own bf16 solve keeps: from weights scaled by 1 + 2^-8 (one
  bf16 rounding) JAX's bf16 history leaves it.  There the band also
  takes that distance: twice the larger of |bf16 - f32| and |bf16 -
  perturbed bf16| so far, + 1e-4 * max(1, |ref|);
- a negative case: a bf16 windowed plain dgrad with the reflect padding's
  adjoint left out falls outside the first tolerance, over 25 clone steps
  (at the len-8 setup's 3 the fault does not show);
- the plans: bf16 windowed plans at the solve's shapes (10 windows of one
  batch, the len-64 decoder levels) are dgrad's whole rows and wgrad's
  tile kernel, whose blocks fit shared memory by the Python layouts, as
  f32's; at long windows (512 and 1,024 frames) dgrad takes spans and
  wgrad items wherever f32 does (dec0 at 512 frames, 64-frame rows, takes
  the tile kernel in both).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.apps import latent_opt as jlo
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.apps import latent_opt as tlo
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

from test_torch_latent_opt import LAT, LEN8, _setup
from test_torch_lora import RANK, _jax_lora_b

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "configs", "len64_no_aug_hm_vae.yaml")
BF16 = torch.bfloat16
G, SMS = 3, 132  # windows of the level test; an H100's SMs
SOLVE_WINDOWS = 10  # the solve's windows (chip_smoke.py's)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DEC = []


def _decoder_levels():
    """(name, conv, input T) of the four decoder convs of the full-width
    len-64 model."""
    if not _DEC:
        cfg = tcfg.load_config(CONFIG)
        m = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(0))
        st = get_structure(cfg.model)
        _DEC.extend((f"dec{i}", getattr(m.decoder, f"conv_{i}"),
                     st.dec_timesteps[i] * (2 if lvl.upsample else 1))
                    for i, lvl in enumerate(st.decoder_levels))
    return _DEC


def _structure(conv, dtype, mode="reflect", device=None):
    sp = conv.spec
    return fcp.pack_structure(conv.structure().live_elements(), sp.kernel_size, dtype,
                              sp.stride, sp.padding, mode, conv.negative_slope,
                              **({"device": device} if device else {}))


def _bf16(a):
    """f32 numpy -> (the same values rounded to bf16 in torch, and in JAX)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("mode", ["reflect", "constant"])
@pytest.mark.parametrize("level", range(4))
def test_windowed_bf16_level_matches_jax_vmap(level, mode):
    name, conv, T = _decoder_levels()[level]
    sp, slope = conv.spec, conv.negative_slope
    s = _structure(conv, BF16, mode)
    rng = np.random.default_rng(level)
    live = s.live_elements().numpy()
    P, C = live.shape
    K = sp.kernel_size
    bound = 1.0 / np.sqrt(C * K)
    wt, wj = _bf16(rng.uniform(-bound, bound, (G, P, C, K)).astype(np.float32)
                   * live[None, :, :, None])
    bt, bj = _bf16(rng.uniform(-bound, bound, (G, P)).astype(np.float32))
    xt, xj = _bf16(rng.normal(size=(G, C, T)).astype(np.float32))

    def f(x, w, b):  # JAX's SkeletonConv at compute_dtype bfloat16, one window
        return jsnn.leaky_relu(jsnn.skeleton_conv_w(x, w, b, sp.stride, sp.padding, mode),
                               slope)

    y_ref, vjp = jax.vjp(jax.vmap(f), xj[:, None], wj, bj)
    assert y_ref.dtype == jnp.bfloat16
    gyt, gyj = _bf16(rng.normal(size=y_ref.shape).astype(np.float32))
    gx_ref, gw_ref, gb_ref = (np.asarray(g.astype(jnp.float32)) for g in vjp(gyj))

    leaves = [t.clone().requires_grad_() for t in (xt, wt, bt)]
    y = fcp.WindowedFusedConvPoolFn.apply(*leaves, s)
    assert y.dtype == BF16
    y.backward(gyt.reshape(y.shape))
    for what, got, ref in (("y", y.detach(), np.asarray(y_ref.astype(jnp.float32))),
                           ("dgrad", leaves[0].grad, gx_ref),
                           ("wgrad", leaves[1].grad, gw_ref * live[None, :, :, None]),
                           ("bias grad", leaves[2].grad, gb_ref)):
        assert got.dtype == BF16, what
        ref = ref.reshape(got.shape)
        err = float(np.abs(got.float().numpy() - ref).max())
        tol = 0.02 * float(np.abs(ref).max())
        assert err <= tol, f"{name} {mode} {what}: max |port - jax| {err:.3e} > {tol:.3e}"


def test_windowed_bf16_plain_versions_round_once():
    """In bf16 the windowed plain versions compute as the kernels do: f32
    sums of the bf16 operands, g rounded to bf16 once, each output rounded
    once; in f32 they are the one-window plain versions window by window."""
    _, conv, T = _decoder_levels()[2]
    s16 = _structure(conv, BF16)
    rng = np.random.default_rng(7)
    live = s16.live_elements().numpy()
    P, C = live.shape
    K, stride, pad, slope = conv.spec.kernel_size, conv.spec.stride, conv.spec.padding, 0.2
    w = torch.from_numpy((0.1 * rng.normal(size=(G, P, C, K)) * live[None, :, :, None])
                         .astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.normal(size=(G, P)).astype(np.float32)).to(BF16)
    x = torch.from_numpy(rng.normal(size=(G, C, T)).astype(np.float32)).to(BF16)
    y = fcp.fused_conv_pool_windowed_reference(x, w, b, stride, pad, "reflect", slope)
    gy = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32)).to(BF16)
    g = torch.where(y >= 0, gy, gy * slope)  # rounded to bf16 once
    for i in range(G):
        sl = slice(i, i + 1)
        ref = fcp.fused_conv_pool_reference(x[sl].float(), w[i].float(), b[i].float(), None,
                                            None, stride, pad, "reflect", slope).to(BF16)
        assert torch.equal(y[sl], ref)
        gx = fcp.fused_conv_pool_dgrad_reference(g[sl].float(), torch.ones_like(g[sl].float()),
                                                 w[i].float(), T, stride, pad).to(BF16)
        gw, gb = fcp.fused_conv_pool_wgrad_reference(g[sl].float(),
                                                     torch.ones_like(g[sl].float()),
                                                     x[sl].float(), K, stride, pad)
        assert torch.equal(fcp.fused_conv_pool_dgrad_windowed_reference(
            gy, y, w, T, stride, pad, "reflect", slope)[sl], gx)
        wgw, wgb = fcp.fused_conv_pool_wgrad_windowed_reference(gy, y, x, K, stride, pad, G,
                                                                "reflect", slope)
        assert torch.equal(wgw[i], gw.to(BF16)) and torch.equal(wgb[i], gb.to(BF16))
    # f32: window by window, the one-window plain versions' bits
    x32, w32, b32 = x.float(), w.float(), b.float()
    y32 = fcp.fused_conv_pool_windowed_reference(x32, w32, b32, stride, pad, "reflect", slope)
    gy32 = gy.float()
    d32 = fcp.fused_conv_pool_dgrad_windowed_reference(gy32, y32, w32, T, stride, pad,
                                                       "reflect", slope)
    for i in range(G):
        sl = slice(i, i + 1)
        assert torch.equal(d32[sl], fcp.fused_conv_pool_dgrad_reference(
            gy32[sl], y32[sl], w32[i], T, stride, pad, "reflect", slope))


# ---------------------------------------------------------------------------
# the solve at bf16 compute against JAX's

def _configs(compute, **lat):
    kw = {**LAT, **lat}
    return (jcfg.Config(model=jcfg.ModelConfig(**LEN8, compute_dtype=compute),
                        latent_opt=jcfg.LatentOptConfig(**kw)),
            tcfg.Config(model=tcfg.ModelConfig(**LEN8, compute_dtype=compute),
                        latent_opt=tcfg.LatentOptConfig(**kw)))


_HISTORIES = {}


def _cached(fn):
    """``fn(compute, **kw)`` once per arguments in this module (the
    negative case and the witness reuse other cases' histories); the
    function itself is ``__wrapped__``."""
    @functools.wraps(fn)
    def run(compute, **kw):
        key = (fn.__name__, compute, tuple(sorted(kw.items())))
        if key not in _HISTORIES:
            _HISTORIES[key] = fn(compute, **kw)
        return _HISTORIES[key]
    return run


@_cached
def _jax_history(compute, scale=1.0, **lat):
    """JAX's loss history, from the weights scaled by `scale`."""
    s = _setup()
    jc, _ = _configs(compute, **lat)
    params = jax.tree.map(lambda a: a * scale, s["params"])
    res = jlo.make_latent_optimizer(JHMVAE(jc.model), jc)(
        params, {k: jnp.asarray(v) for k, v in s["targets"].items()},
        jnp.asarray(s["mask"]), [jnp.asarray(a) for a in s["z"]],
        [jnp.asarray(a) for a in s["zr"]])
    return np.asarray(res.loss_history, np.float64)


@_cached
def _port_history(compute, **lat):
    s = _setup()
    _, tc = _configs(compute, **lat)
    model = HMVAE(tc.model)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, s["params"]), tc.model),
                          strict=False)
    lora = _jax_lora_b(s["jm"], RANK, s["z"]) if lat.get("finetune_scope") == "lora" else None
    res = tlo.make_latent_optimizer(model, tc, lora_init=lora)(
        s["targets"], s["mask"], s["z"], s["zr"])
    return res.loss_history.numpy().astype(np.float64)


def _band(ref16, *others):
    """Iteration i's tolerance: twice the largest distance of JAX's bf16
    history from `others` (its f32 history; at the production lr also its
    perturbed bf16 one) over iterations 0..i, + 1e-4 * max(1, |ref|)."""
    d = np.max([np.abs(ref16 - o) for o in others], axis=0)
    return 2 * np.maximum.accumulate(d) + 1e-4 * np.maximum(1.0, np.abs(ref16))


def _within(ours, ref16, *others):
    return bool(abs(ours[0] / ref16[0] - 1) <= 1e-2
                and (np.abs(ours - ref16) <= _band(ref16, *others)).all())


BF16_CLONE = dict(opt_param_dtype="bfloat16", opt_moment_dtype="bfloat16")
LORA = dict(finetune_scope="lora", lora_rank=RANK)
# the production solver's lr (configs/len_64_test_interpolation.yaml), and
# a scale of the weights by one bf16 rounding
PRODUCTION_LR = dict(opt_lr=0.1)
BF16_ROUNDING = 1.0 + 2.0 ** -8
# the negative case: 5 z iterations, then 25 on the clone at the decoder's
# lr (opt_lr * 1e-3), no step decay, enough decoder steps for a fault in
# its gradient to show
LONG = dict(opt_lr=0.01, opt_it=30, prev_epochs=4, opt_step_size=30)


@pytest.mark.parametrize("lat", [
    dict(per_window_decoder=True),
    dict(per_window_decoder=True, **BF16_CLONE),
    dict(per_window_decoder=True, finetune_scope="last_conv"),
    dict(per_window_decoder=True, **LORA),
    dict(per_window_decoder=False),
    dict(per_window_decoder=False, **BF16_CLONE),
    dict(per_window_decoder=False, **LORA),
], ids=["per_window", "per_window_bf16_clone", "last_conv", "lora", "shared",
        "shared_bf16_clone", "shared_lora"])
def test_bf16_solve_within_jax_bf16_band(lat):
    ref16, ref32 = _jax_history("bfloat16", **lat), _jax_history("float32", **lat)
    ours = _port_history("bfloat16", **lat)
    assert ours.shape == ref16.shape and np.isfinite(ours).all()
    assert _within(ours, ref16, ref32), (
        f"port {ours.tolist()}\njax bf16 {ref16.tolist()}\njax f32 {ref32.tolist()}\n"
        f"|diff| {np.abs(ours - ref16).tolist()}\nband {_band(ref16, ref32).tolist()}")


def test_jax_bf16_solve_at_the_production_lr_leaves_its_f32_band():
    """The witness for the production-lr band: with the bf16 clone at lr
    0.1, JAX's own bf16 solve from weights scaled by one bf16 rounding
    leaves twice its bf16-f32 distance, so that band bounds no rounding
    noise there."""
    lat = {**PRODUCTION_LR, "per_window_decoder": True, **BF16_CLONE}
    ref16, ref32 = _jax_history("bfloat16", **lat), _jax_history("float32", **lat)
    perturbed = _jax_history("bfloat16", scale=BF16_ROUNDING, **lat)
    assert np.isfinite(perturbed).all()
    assert not _within(perturbed, ref16, ref32), (
        f"perturbed {perturbed.tolist()}\njax bf16 {ref16.tolist()}\n"
        f"band {_band(ref16, ref32).tolist()}")


@pytest.mark.parametrize("windows", [True, False], ids=["per_window", "shared"])
def test_bf16_solve_at_the_production_lr_within_jax_bf16_spread(windows):
    """At lr 0.1 with the bf16 clone: within twice the larger of JAX's
    bf16-f32 distance and its distance from its bf16 solve from weights
    scaled by 1 + 2^-8, + 1e-4 * max(1, |ref|); the first iteration within
    1e-2 relative."""
    lat = {**PRODUCTION_LR, "per_window_decoder": windows, **BF16_CLONE}
    ref16, ref32 = _jax_history("bfloat16", **lat), _jax_history("float32", **lat)
    perturbed = _jax_history("bfloat16", scale=BF16_ROUNDING, **lat)
    ours = _port_history("bfloat16", **lat)
    assert ours.shape == ref16.shape and np.isfinite(ours).all()
    assert _within(ours, ref16, ref32, perturbed), (
        f"port {ours.tolist()}\njax bf16 {ref16.tolist()}\n"
        f"band {_band(ref16, ref32, perturbed).tolist()}")


def test_a_broken_bf16_windowed_dgrad_falls_outside_the_band(monkeypatch):
    """The windowed bf16 dgrad's plain version with the reflect padding's
    adjoint left out (the reflected columns' gradient dropped): over 25
    clone steps (LONG) the per-window solve leaves the band that the sound
    one keeps."""
    lat = {**LONG, "per_window_decoder": True}
    ref16, ref32 = _jax_history("bfloat16", **lat), _jax_history("float32", **lat)
    sound = _port_history("bfloat16", **lat)
    assert _within(sound, ref16, ref32)
    called = []

    def broken(gy, y, weight, T_in, stride, padding, padding_mode="reflect",
               negative_slope=0.2):
        called.append(gy.dtype)
        G = weight.shape[0]
        g = fcp._act_grad(gy, y, negative_slope)
        return torch.cat([fcp._dgrad_of_g(gg.float(), weight[i].float(), T_in, stride,
                                          padding, "constant")
                          for i, gg in enumerate(g.chunk(G))]).to(gy.dtype)

    monkeypatch.setattr(fcp, "fused_conv_pool_dgrad_windowed_reference", broken)
    ours = _port_history.__wrapped__("bfloat16", **lat)
    assert called and set(called) == {BF16}
    assert not _within(ours, ref16, ref32), (
        f"broken {ours.tolist()}\njax bf16 {ref16.tolist()}\nband {_band(ref16, ref32).tolist()}")


# ---------------------------------------------------------------------------
# the plans

def _plans(conv, T, windows, dtype, batch=1):
    """dgrad's and wgrad's plans for ``windows`` windows of ``batch``
    batches at input T, as the wrappers make them (``_dgrad``, ``_wgrad``:
    wgrad's tile kernel where ``wgrad_tiles_routed``), and the blocks'
    shared memory."""
    s = _structure(conv, dtype, conv.spec.padding_mode, device="meta")
    esz = 4 if dtype == torch.float32 else 2
    K, stride, pad = s.kernel_size, s.stride, s.padding
    T_out = (T + 2 * pad - K) // stride + 1
    t_ld = -(-T_out // (16 // esz)) * (16 // esz)
    d = fcp.dgrad_plan(batch, T, K, stride, pad, t_ld, s.dgrad_start.numel() - 1,
                       s.dgrad_max_live, SMS, windows,
                       (s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live), esz)
    dsmem = (fcp._dgrad_smem(T, K, t_ld, stride, pad, d.nbb, esz) if not d.span
             else fcp._dgrad_span_layout(K, stride, d.span, esz)[0])
    entries = s.wgrad_row.numel()
    if fcp.wgrad_tiles_routed(batch, T, K, stride, pad, entries, esz, windows):
        wsmem = fcp._wgrad_tiles_layout(K, stride, batch, T, T_out, t_ld, entries, esz)["total"]
        w = fcp.wgrad_tiles_plan(s.wgrad_row.numel(), windows, SMS,
                                 fcp.wgrad_tiles_per_sm(wsmem))
        return d, w, {"dgrad": dsmem, "wgrad": wsmem}
    cols = fcp.wgrad_span_cols(K, stride, esz)
    rows = int(fcp.wgrad_bf16_items(batch, T, K, stride, pad, esz))
    w = fcp.wgrad_plan(batch, T_out, s.wgrad_row.numel(), SMS, windows,
                       lambda sb, split: fcp._wgrad_smem(batch, T, K, T_out, t_ld, stride, sb,
                                                         split, esz),
                       cols, rows, fcp.wgrad_items_per_sm(K, stride, cols, esz, 1, T, T_out,
                                                          t_ld))
    smem = {"dgrad": dsmem,
            "wgrad": (fcp._wgrad_smem(batch, T, K, T_out, t_ld, stride, w.sb, w.split, esz)
                      if not w.span else fcp._wgrad_span_smem(K, stride, w.span, esz))}
    return d, w, smem


@pytest.mark.parametrize("level", range(4))
def test_bf16_windowed_plans_at_the_solve_fit_shared_memory(level):
    """10 windows of one batch at the decoder level's own length: dgrad's
    whole rows and wgrad's tile kernel in both dtypes, within MAX_SMEM by
    the Python layouts (which test_torch_bf16_backward.py and
    test_torch_wgrad_tiles.py hold against the kernels'), bf16 never a
    smaller batch group than f32's, every window's blocks its own (the tile
    kernel's units a window's entries)."""
    _, conv, T = _decoder_levels()[level]
    d16, w16, smem16 = _plans(conv, T, SOLVE_WINDOWS, BF16)
    d32, w32, smem32 = _plans(conv, T, SOLVE_WINDOWS, torch.float32)
    assert d16.span == 0 and d32.span == 0
    assert isinstance(w16, fcp.WgradTilesPlan) and isinstance(w32, fcp.WgradTilesPlan)
    assert w16.units == w32.units == conv.structure().wgrad_row.numel() * SOLVE_WINDOWS
    assert max(smem16.values()) <= fcp.MAX_SMEM and max(smem32.values()) <= fcp.MAX_SMEM
    assert d16.nbb == d32.nbb == 1


@pytest.mark.parametrize("frames", [512, 1024])
@pytest.mark.parametrize("level", range(4))
def test_bf16_windowed_plans_at_long_windows_take_spans_and_items(level, frames):
    """4 windows of one batch at window lengths past whole-row staging: a
    padded row past 256 columns takes dgrad's spans in both dtypes, and
    wgrad takes items wherever f32's whole rows do not fit, in both dtypes
    (``wgrad_bf16_items``), and the tile kernel in both at dec0 at 512
    frames (64-frame rows, the solve's dec3 shape); the span, item and tile
    blocks fit shared memory."""
    _, conv, T = _decoder_levels()[level]
    T = T * frames // 64
    sp = conv.spec
    d16, w16, smem16 = _plans(conv, T, 4, BF16)
    d32, w32, smem32 = _plans(conv, T, 4, torch.float32)
    long_row = T + 2 * sp.padding > 256
    assert (d16.span > 0) == (d32.span > 0) == long_row
    if isinstance(w16, fcp.WgradTilesPlan) or isinstance(w32, fcp.WgradTilesPlan):
        # dec0 at 512 frames: 64-frame rows, the solve's dec3 shape
        assert isinstance(w16, fcp.WgradTilesPlan) and isinstance(w32, fcp.WgradTilesPlan)
        assert level == 0 and frames == 512 and not long_row
        assert max(smem16.values()) <= fcp.MAX_SMEM and max(smem32.values()) <= fcp.MAX_SMEM
        return
    assert (w16.span > 0) == (w32.span > 0)
    assert w32.span > 0 or not long_row
    assert max(smem16.values()) <= fcp.MAX_SMEM and max(smem32.values()) <= fcp.MAX_SMEM
    if w16.span:
        assert w16.sb == 1 and w16.span == fcp.wgrad_span_cols(sp.kernel_size, sp.stride, 2)
    if d16.span:
        assert d16.nbb == 1 and fcp.dgrad_span_rows(T, sp.kernel_size, sp.stride, sp.padding,
                                                    d16.span) == 0


# ---------------------------------------------------------------------------
# the model's windowed bf16 path

@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_windowed_bf16_fold_and_leaf_dtypes(layout):
    """``SkeletonConv.forward_with`` on G windows' weights at bf16 compute
    (dense ``weight`` and compact ``weight_c``): the fold of the stacked
    weights is each window's fold, in bf16; the leaves' gradients come back
    in the leaves' dtypes, an f32 clone's the bf16 clone's values exactly
    (the fold casts both to the same bf16 values)."""
    cfg = tcfg.ModelConfig(**LEN8, compute_dtype="bfloat16", param_layout=layout)
    model = HMVAE(cfg, generator=torch.Generator().manual_seed(0))
    st = get_structure(cfg)
    conv = model.decoder.conv_3  # unpool folded in, a bias; compact under compact
    assert conv.compact == (layout == "compact")
    rng = np.random.default_rng(5)
    raw = conv.raw_weight.detach()
    scale = 1 + 0.2 * rng.normal(size=(G,) + (1,) * raw.dim())
    w = torch.from_numpy((raw.numpy()[None] * scale).astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.normal(size=(G, conv.bias.shape[0])).astype(np.float32)).to(BF16)
    wf, bf = conv.fold(w, b)
    assert wf.dtype == bf.dtype == BF16 and wf.shape[0] == G
    for g in range(G):
        w1, b1 = conv.fold(w[g], b[g])
        torch.testing.assert_close(wf[g].float(), w1.float(), atol=0, rtol=2 ** -7)
        torch.testing.assert_close(bf[g].float(), b1.float(), atol=0, rtol=2 ** -7)
    T = st.dec_timesteps[3] * (2 if st.decoder_levels[3].upsample else 1)
    x = torch.from_numpy(rng.normal(size=(G, conv.folded_shape()[1], T)).astype(np.float32))
    grads = {}
    for dt in (torch.float32, BF16):
        leaves = [w.to(dt).requires_grad_(), b.to(dt).requires_grad_()]
        y = conv.forward_with(x, *leaves)
        assert y.dtype == BF16
        y.float().square().sum().backward()
        assert all(t.grad.dtype == dt for t in leaves)
        grads[dt] = [t.grad for t in leaves]
    for g32, g16 in zip(grads[torch.float32], grads[BF16]):
        assert torch.equal(g32, g16.float())
