"""Test-time latent optimization: one engine for interpolation, completion and
generation.

Port of ``hm_vae_tpu.apps.latent_opt``.  A solve optimizes the latents z of a
batch of windows against masked targets for ``opt_it`` iterations of one
forward and backward each: ``n_z = min(prev_epochs + 1, opt_it - 1)``
iterations on z with the decoder frozen, then, with ``optimize_decoder``,
iterations on a clone of the decoder (or of its ``finetune_scope`` part) with
z frozen, pulled back toward the trained weights.  The last iteration's
forward, before its update, is the result (the reference returns the last
iteration, not the best one).  With ``track_best`` the ``best_*`` fields
hold the outputs of the least total loss seen, per window under per-window
clones (the starting point's forward first, the last iteration compared
too); without it they alias ``last_*``.

With ``per_window_decoder`` (the default) every window of the batch
optimizes against its own loss mean and fine-tunes its own decoder clone and
Adam state: the JAX package's ``jax.vmap`` over windows.  Here the clones are
stacked (B, ...) tensors and the decoder convs run the windowed forms of the
``fused_conv_pool`` kernels (:class:`~hm_vae_torch.ops.fused_conv_pool.
WindowedFusedConvPoolFn`).  The objective whose gradient matches the vmapped
one is the SUM of the windows' means.  ``False`` shares one clone and one
batch-mean loss.

On a CUDA device each iteration launches the forward kernel at the four
decoder convs and, through autograd, dgrad where a conv's input needs a
gradient and wgrad where its weight does: z phase 4 / 4 / 0, decoder phase
(full scope) 4 / 4 / 4, windowed under per-window clones.

With ``trajectory=(traj_model, mean_std)``, ``latent_opt.optimize_trajectory``
and keyframe indices, the keyframe trajectory loss is added: the trajectory
model runs on the decoded pose inside the loop (the stats read as given),
and the root displacements between consecutive keyframes are pulled toward
the ground truth's (``targets['root_trans']``, (B, T, 3)).  Under per-window
clones the term is each window's own mean, added into that window's total,
as the vmapped JAX loss computes it on a batch of one.  The trajectory
model's weights are frozen (a copy taken when the solver is made, as the JAX
solver closes over them) and shared by every window: each iteration adds 4
non-windowed forward and 4 dgrad launches (level 0's input is the decoded
pose), no wgrad.

The ``lora`` scope (``lora_rank`` r > 0) fine-tunes rank-r adapters on
every decoder conv (:func:`draw_adapters`: ``lora_a`` zero, so the first
iteration decodes as the base model), the conv biases and the latent heads;
the conv weights stay frozen and shared by every window, so each conv runs
the non-windowed forward kernel at slope 1.0 and, through autograd, dgrad,
and no wgrad: 4 / 4 / 0 launches an iteration in both phases (the
adapters' rank-r convs are plain PyTorch im2col products, batched over
windows).  Its pull-back is in weight space (:func:`_lora_reg`) and
``lora_lr_mult`` scales the adapters' steps.  Its state is small: it stays
f32 whatever ``opt_param_dtype`` says, as in JAX.

``opt_param_dtype: bfloat16`` stores the clone (and its per-window stack)
in bf16: the pull-back target is the cast clone, the convs fold it in the
model's compute dtype, its gradients are bf16 as JAX's, and each step
writes the new value back by stochastic rounding, hashed per leaf of the
trainable subtree with one draw for every window.

At ``compute_dtype: bfloat16`` the convs fold the clone (f32 or bf16) in
bf16 and run the kernels' bf16 forms, the windowed ones under per-window
clones, as the JAX solver vmaps its bf16 level over the windows; each
clone leaf gets its gradient in its own dtype.

The optimizer is the JAX package's optax chain, ``add_decayed_weights ->
scale_by_adam_stored -> scale_by_learning_rate(StepLR)`` (the decoder
chain then ``optax.masked(optax.scale(lora_lr_mult))`` and the SR
write-back where they apply), as a functional update
(:func:`~hm_vae_torch.train.optim.chain_update`): the z chain counts z
steps only; the decoder chain counts from 0 at the switch, at lr * 1e-3.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data import layout
from ..models.hm_vae import HMVAE, SkeletonConv, lora_b_init
from ..models.structure import get_structure
from ..models.trajectory import accumulate_root_trajectory
from ..ops import fk as fk_mod
from ..ops import rotations as rot
from ..parallel.sharding import world_size
from ..train.optim import chain_init, chain_update, flax_salts, make_schedule_raw
from ..utils.config import Config, LatentOptConfig


def _scope_keys(names: Sequence[str], scope: str) -> List[str]:
    """The top-level decoder modules the fine-tune phase optimizes (the
    rest stay frozen at the trained weights and shared by every window)."""
    if scope == "full":
        return list(names)
    if scope == "heads":
        return [k for k in names if k.startswith("latent_dec")]
    if scope == "last_conv":
        convs = sorted((k for k in names if k.startswith("conv_")),
                       key=lambda k: int(k.split("_")[-1]))
        return convs[-1:]
    raise ValueError(f"unknown latent_opt.finetune_scope: {scope!r} "
                     "(expected full|lora|last_conv|heads)")


@dataclasses.dataclass
class LatentOptResult:
    """All (B, T, 24, ...) tensors on the solve's device; ``best_*`` alias
    ``last_*`` unless ``track_best`` is on."""

    last_6d: torch.Tensor
    last_rotmat: torch.Tensor
    last_pose: torch.Tensor
    best_6d: torch.Tensor
    best_rotmat: torch.Tensor
    best_pose: torch.Tensor
    final_loss: torch.Tensor    # (B,) per-sample final masked loss
    loss_history: torch.Tensor  # (opt_it,) total loss (per-window: the windows' mean)


def init_z(generator: Optional[torch.Generator], cfg: Config, batch: int) -> List[torch.Tensor]:
    """Random deep and shallow z, zero middles, drawn on the CPU from
    ``generator`` (shallow first): the apps' starting point."""
    st = get_structure(cfg.model)
    nl = cfg.model.num_layers
    zs = []
    for i in range(nl):
        shape = (batch, st.z_edges[i], st.z_dims[i])
        zs.append(torch.randn(shape, generator=generator) if i in (0, nl - 1)
                  else torch.zeros(shape))
    return zs


def replace_with_target(result_field, target_field, mask):
    """Overwrite supervised entries with targets (``replace_*_with_gt``)."""
    m = mask
    while m.dim() < result_field.dim():
        m = m[..., None]
    return m * target_field + (1.0 - m) * result_field


def _steplr(lr: float, lat: LatentOptConfig):
    policy = "constant" if lat.opt_lr_policy == "constant" else "step"
    return make_schedule_raw(lr, policy, lat.opt_step_size, lat.opt_gamma)


def _per_sample(x, t, m):
    return ((x - t) ** 2 * m).mean(dim=tuple(range(1, x.dim())))


def _lora_reg(params, orig, per_window: bool):
    """The pull-back term under the lora scope (the JAX package's
    ``_lora_reg``): for each adapter the weight-space ``mean((A @ B)^2)``
    by the Gram identity ``sum((A^T A) * (B B^T)) / (out_f * in_f * K)``
    (the delta is never formed), then ``mean((w - w0)^2)`` of each direct
    leaf.  Per window ((G, ...) leaves): a (G,) vector."""
    total = 0.0
    for n, a in params.items():
        if n.endswith(".lora_a"):
            a = a.float()
            b = params[n[:-1] + "b"].float()
            b2 = b.reshape(b.shape[:-2] + (-1,))
            gram = (a.transpose(-1, -2) @ a) * (b2 @ b2.transpose(-1, -2))
            total = total + gram.sum((-1, -2)) / (a.shape[-2] * b2.shape[-1])
    for n, v in params.items():
        if not n.split(".")[-1].startswith("lora_"):
            total = total + _mean_sq(v.float() - orig[n].float(), per_window)
    return total


def _mean_sq(d: torch.Tensor, per_window: bool) -> torch.Tensor:
    d = d * d
    return d.reshape(d.shape[0], -1).mean(1) if per_window else d.mean()


def _clone_bf16(lat: LatentOptConfig) -> bool:
    """Whether the clone is stored in bf16: the lora scope's per-window
    state is small and stays f32, as in JAX."""
    return lat.opt_param_dtype == "bfloat16" and lat.finetune_scope != "lora"


def trainable_names(names: Sequence[str], lat: LatentOptConfig) -> List[str]:
    """The decoder parameters (by name, adapters included under the lora
    scope) that the decoder phase steps, in the flax leaf order of the JAX
    solver's trainable subtree: the scope's modules, or under the lora
    scope the adapters, the conv biases and the latent heads."""
    if lat.finetune_scope == "lora":
        chosen = [n for n in names if n.startswith("latent_dec")
                  or n.split(".")[-1] in ("bias", "lora_a", "lora_b")]
    else:
        keys = _scope_keys(list(dict.fromkeys(n.split(".")[0] for n in names)),
                           lat.finetune_scope)
        chosen = [n for n in names if n.split(".")[0] in keys]
    return sorted(chosen, key=lambda n: tuple(n.split(".")))


def decoder_chain(names: Sequence[str], lat: LatentOptConfig, weight_decay: float,
                  per_window: bool):
    """The decoder phase's update over the leaves ``names`` (flax order):
    ``step(params, grads, state) -> new params`` with the chain's state from
    :func:`~hm_vae_torch.train.optim.chain_init`.  The lora scope scales
    the adapters' steps by ``lora_lr_mult``; a bf16 clone is written back by
    stochastic rounding, salted by each leaf's index + 1 in ``names`` and
    hashed over the flax layout (a latent head's weight transposed), one
    draw for every window."""
    lr = _steplr(lat.opt_lr * 1e-3, lat)
    scales = sr_salts = None
    if lat.finetune_scope == "lora" and lat.lora_lr_mult != 1.0:
        scales = [lat.lora_lr_mult if n.split(".")[-1].startswith("lora_") else None
                  for n in names]
    if _clone_bf16(lat):
        salts = flax_salts(names)
        sr_salts = [salts[n] for n in names]

    def step(params, grads, state):
        return chain_update(params, grads, state, lr, weight_decay, scales=scales,
                            sr_salts=sr_salts, lead=int(per_window))

    return step


def draw_adapters(model: HMVAE, rank: int, lora_init=None) -> Dict[str, torch.Tensor]:
    """Fresh rank-``rank`` adapters for every decoder conv, on the CPU, by
    the port's decoder names (``conv_0.lora_a``, ...): ``lora_a`` zero,
    ``lora_b`` drawn in the flax leaf order from a generator seeded 0 (the
    JAX solver draws them from ``PRNGKey(0)``).  ``lora_init`` (numpy or
    tensors by the same names) replaces the draws it names."""
    gen = torch.Generator().manual_seed(0)
    convs = sorted(((n, m) for n, m in model.decoder.named_children()
                    if isinstance(m, SkeletonConv)), key=lambda t: t[0])
    out = {}
    for name, conv in convs:
        out_f, in_f = conv.folded_shape()
        out[f"{name}.lora_a"] = torch.zeros(out_f, rank)
        out[f"{name}.lora_b"] = lora_b_init(rank, in_f, conv.spec.kernel_size, gen)
    for n, v in (lora_init or {}).items():
        if n not in out:
            raise KeyError(f"lora_init names {n!r}, which is no adapter leaf of the decoder")
        v = v.detach().float().cpu() if torch.is_tensor(v) else torch.tensor(np.asarray(v),
                                                                              dtype=torch.float32)
        if v.shape != out[n].shape:
            raise ValueError(f"lora_init {n!r} has shape {tuple(v.shape)}, expected "
                             f"{tuple(out[n].shape)}")
        out[n] = v
    return out


def make_latent_optimizer(model: HMVAE, cfg: Config, lat: Optional[LatentOptConfig] = None,
                          trajectory=None, key_frames=None, lora_init=None, group=None):
    """The solver over ``model``'s decoder (its parameters at each call).

    Returns ``solve(targets, mask, z_init, z_reg_target) -> LatentOptResult``
    with targets ``{rot_6d (B,T,24,6), rot_mat (B,T,24,3,3), pose
    (B,T,24,3)}`` (and ``root_trans`` (B,T,3) under the trajectory loss),
    mask (B, T, 24) (1 = supervised) and z lists (shallow -> deep, batched),
    as tensors or arrays; they are moved to the model's device as f32.
    ``trajectory=(traj_model, mean_std)`` with ``lat.optimize_trajectory``
    and ``key_frames`` (frame indices) adds the keyframe trajectory loss.
    Under the lora scope ``lora_init`` replaces adapter draws
    (:func:`draw_adapters`).

    ``group``: the batch is this rank's equal share of a global (padded)
    batch split over the group's ranks (``LatentOptApps._dispatch``).  The
    per-window clones are independent: no collective.  The shared clone
    (``per_window_decoder: false``) is not: each rank's batch terms are its
    share of the global batch mean (divided by the world size, as is the
    pull-back, which every rank adds), the clone's gradients are summed
    over the ranks every iteration, and the total (the history's value,
    ``track_best``'s scalar) is the all-reduced global one, so that the
    solve equals the one of the whole batch.
    """
    lat = lat or cfg.latent_opt
    lcfg = cfg.loss
    use_traj = trajectory is not None and lat.optimize_trajectory
    if use_traj:
        if key_frames is None:
            raise ValueError("the keyframe trajectory loss needs key_frames")
        traj_model = copy.deepcopy(trajectory[0]).requires_grad_(False)
        traj_ms = np.asarray(trajectory[1], np.float32)
        key = torch.as_tensor(np.asarray(key_frames, np.int64))
    lora = lat.finetune_scope == "lora"
    if lora and lat.lora_rank <= 0:
        raise ValueError(f"latent_opt.finetune_scope='lora' needs lora_rank > 0, got "
                         f"{lat.lora_rank}")
    if lat.opt_param_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported latent_opt.opt_param_dtype: {lat.opt_param_dtype!r}")
    clone_bf16 = _clone_bf16(lat)
    adapters = draw_adapters(model, lat.lora_rank, lora_init) if lora else {}
    wd = float(cfg.optim.weight_decay)
    lr_z = _steplr(lat.opt_lr, lat)
    per_win = lat.per_window_decoder
    shared_ranks = None if per_win or group is None else world_size(group)
    n_scan = lat.opt_it - 1
    n_z = min(lat.prev_epochs + 1, n_scan) if lat.optimize_decoder else n_scan
    dec_step_last = lat.optimize_decoder and lat.opt_it - 1 > lat.prev_epochs

    def solve(targets, mask, z_init, z_reg_target) -> LatentOptResult:
        dev = next(model.parameters()).device

        def put(a):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                   dtype=torch.float32).to(dev)

        tgt = {k: put(targets[k]) for k in ("rot_6d", "rot_mat", "pose")}
        traj_term = None
        if use_traj:
            traj = traj_model.to(dev)
            pos_mean = put(traj_ms[0][layout.COORD].reshape(24, 3))
            pos_std = put(traj_ms[1][layout.COORD].reshape(24, 3))
            rv_mean, rv_std = put(traj_ms[0][layout.ROOT_V]), put(traj_ms[1][layout.ROOT_V])
            kf = key.to(dev)
            rel_gt = torch.diff(put(targets["root_trans"])[:, kf], dim=1)

            def traj_term(pose):
                """Per window: the mean squared error of the predicted root
                displacements between consecutive keyframes."""
                root_v = rv_mean + rv_std * traj((pose - pos_mean) / pos_std)
                rel = torch.diff(accumulate_root_trajectory(root_v)[:, kf], dim=1)
                return ((rel - rel_gt) ** 2).mean(dim=(1, 2))
        mask_t = put(mask)
        z = [put(t) for t in z_init]
        zr = [put(t) for t in z_reg_target]
        B = mask_t.shape[0]
        offsets = torch.as_tensor(fk_mod.default_offsets(), device=dev)
        m6, mm = mask_t[..., None], mask_t[..., None, None]

        # only the decoder is cloned, and within it the scope's leaves; the
        # rest stays the trained decoder, shared by every window
        dec = {n: p.detach() for n, p in model.decoder.named_parameters()}
        dec.update({n: v.to(dev) for n, v in adapters.items()})
        names = trainable_names(list(dec), lat)
        # the bf16 clone: its pull-back target is the cast clone itself
        train0 = {n: dec[n].to(torch.bfloat16 if clone_bf16 else torch.float32)
                  for n in names}
        dec_step = decoder_chain(names, lat, wd, per_win)

        def forward(zs, params):
            out6d = model.decode(zs, params={**dec, **params})
            out_rotmat = rot.rot6d_to_rotmat(out6d)
            return out6d, out_rotmat, fk_mod.fk_from_rotmat(out_rotmat, offsets)

        def pull_back(dec_p):
            if lora:
                return _lora_reg(dec_p, train0, per_win)
            return sum(_mean_sq(dec_p[n].float() - train0[n].float(), per_win) for n in names)

        def total_loss(out, zs, dec_p):
            """The total per window (B,), or of the batch (shared clone)."""
            o6, orm, op = out
            if per_win:
                total = (lcfg.rec_6d_w * _per_sample(o6, tgt["rot_6d"], m6)
                         + lcfg.rec_rot_w * _per_sample(orm, tgt["rot_mat"], mm)
                         + lcfg.rec_pose_w * _per_sample(op, tgt["pose"], m6))
                reg = _per_sample(zs[0], zr[0], 1.0) + _per_sample(zs[-1], zr[-1], 1.0)
            else:
                total = (lcfg.rec_6d_w * torch.mean((o6 - tgt["rot_6d"]) ** 2 * m6)
                         + lcfg.rec_rot_w * torch.mean((orm - tgt["rot_mat"]) ** 2 * mm)
                         + lcfg.rec_pose_w * torch.mean((op - tgt["pose"]) ** 2 * m6))
                reg = torch.mean((zs[0] - zr[0]) ** 2) + torch.mean((zs[-1] - zr[-1]) ** 2)
            total = total + lat.reg_w * reg
            if dec_p is not None:
                total = total + lat.reg_w_decoder * pull_back(dec_p)
            if traj_term is not None:
                t = traj_term(op)
                total = total + lat.reg_w_trajectory * (t if per_win else t.mean())
            if shared_ranks is not None:  # this rank's share of the global total
                total = total / shared_ranks
            return total

        def objective(total):
            """Per window: the sum of the windows' totals (the vmapped
            gradient) and, for the history, their mean; the shared clone
            under ranks: the rank's share and the global total."""
            if per_win:
                return total.sum(), total.mean()
            if shared_ranks is not None:
                value = total.detach().clone()
                dist.all_reduce(value, group=group)
                return total, value
            return total, total

        # track_best: per window (or of the batch: the global total under
        # ranks, the same decision on every rank) the least total so far and
        # the outputs of its forward, from the starting point's
        best = None
        if lat.track_best:
            with torch.no_grad():
                best = [torch.full((B,) if per_win else (), float("inf"), device=dev),
                        forward(z, train0)]

        def track(total, out):
            if best is None:
                return
            total = total.detach()
            better = total < best[0]
            best[0] = torch.where(better, total, best[0])
            best[1] = tuple(torch.where(better.reshape(better.shape + (1,) * (o.dim() - 1))
                                        if per_win else better, o.detach(), b)
                            for o, b in zip(out, best[1]))

        history = []
        # z phase: the decoder frozen (no weight gradient, no wgrad); the
        # frozen clone's pull-back term is exactly 0 and is left out
        z_state = chain_init(z, lat.opt_moment_dtype)
        for _ in range(n_z):
            zs = [t.detach().requires_grad_() for t in z]
            out = forward(zs, train0)
            total = total_loss(out, zs, None)
            obj, value = objective(total)
            grads = torch.autograd.grad(obj, zs, allow_unused=True)
            z = chain_update(zs, grads, z_state, lr_z, wd)
            history.append(value.detach())
            track(total if per_win else value, out)
        z = [t.detach() for t in z]

        # decoder phase: z frozen, the clones (one per window) step
        dec_p = None
        if lat.optimize_decoder and n_scan > n_z:
            dec_p = ({n: v.expand((B,) + v.shape).clone() for n, v in train0.items()}
                     if per_win else dict(train0))
            d_state = chain_init(list(dec_p.values()), lat.opt_moment_dtype)
            for _ in range(n_scan - n_z):
                leaves = {n: v.detach().requires_grad_() for n, v in dec_p.items()}
                out = forward(z, leaves)
                total = total_loss(out, z, leaves)
                obj, value = objective(total)
                grads = torch.autograd.grad(obj, list(leaves.values()), allow_unused=True)
                if shared_ranks is not None:  # the shared clone's gradient: every rank's share
                    for g in grads:
                        if g is not None:
                            dist.all_reduce(g, group=group)
                dec_p = dict(zip(names, dec_step(list(leaves.values()), grads, d_state)))
                history.append(value.detach())
                track(total if per_win else value, out)

        # the last iteration: its forward, before its update, is the result
        # (its update is never read, so it is not computed)
        with torch.no_grad():
            if dec_step_last:
                if dec_p is None:
                    dec_p = ({n: v.expand((B,) + v.shape) for n, v in train0.items()}
                             if per_win else dict(train0))
                last = forward(z, dec_p)
                total = total_loss(last, z, dec_p)
            else:
                last = forward(z, train0)
                total = total_loss(last, z, None)
            value = objective(total)[1]
            history.append(value)
            track(total if per_win else value, last)
            final = (lcfg.rec_6d_w * _per_sample(last[0], tgt["rot_6d"], m6)
                     + lcfg.rec_rot_w * _per_sample(last[1], tgt["rot_mat"], mm)
                     + lcfg.rec_pose_w * _per_sample(last[2], tgt["pose"], m6))
        best_out = last if best is None else best[1]
        return LatentOptResult(
            last_6d=last[0], last_rotmat=last[1], last_pose=last[2], best_6d=best_out[0],
            best_rotmat=best_out[1], best_pose=best_out[2], final_loss=final,
            loss_history=torch.stack(history))

    return solve
