"""Test-time latent optimization: one engine for interpolation, completion and
generation.

Port of ``hm_vae_tpu.apps.latent_opt``.  A solve optimizes the latents z of a
batch of windows against masked targets for ``opt_it`` iterations of one
forward and backward each: ``n_z = min(prev_epochs + 1, opt_it - 1)``
iterations on z with the decoder frozen, then, with ``optimize_decoder``,
iterations on a clone of the decoder (or of its ``finetune_scope`` part) with
z frozen, pulled back toward the trained weights.  The last iteration's
forward, before its update, is the result (the reference returns the last
iteration, not the best one; ``track_best`` is not ported).

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

The optimizer is the JAX package's optax chain, ``add_decayed_weights ->
scale_by_adam_stored -> scale_by_learning_rate(StepLR)``, as a functional
update (:func:`~hm_vae_torch.train.optim.chain_update`): the z chain counts
z steps only; the decoder chain counts from 0 at the switch, at lr * 1e-3.

Not ported, each raising ``NotImplementedError``: the ``lora`` scope
(ROADMAP Queue 1 item 6), the bf16 clone (``opt_param_dtype: bfloat16``,
item 5b) and ``track_best``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data import layout
from ..models.hm_vae import HMVAE
from ..models.structure import get_structure
from ..models.trajectory import accumulate_root_trajectory
from ..ops import fk as fk_mod
from ..ops import rotations as rot
from ..train.optim import chain_init, chain_update, make_schedule_raw
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
    ``last_*``."""

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


def make_latent_optimizer(model: HMVAE, cfg: Config, lat: Optional[LatentOptConfig] = None,
                          trajectory=None, key_frames=None):
    """The solver over ``model``'s decoder (its parameters at each call).

    Returns ``solve(targets, mask, z_init, z_reg_target) -> LatentOptResult``
    with targets ``{rot_6d (B,T,24,6), rot_mat (B,T,24,3,3), pose
    (B,T,24,3)}`` (and ``root_trans`` (B,T,3) under the trajectory loss),
    mask (B, T, 24) (1 = supervised) and z lists (shallow -> deep, batched),
    as tensors or arrays; they are moved to the model's device as f32.
    ``trajectory=(traj_model, mean_std)`` with ``lat.optimize_trajectory``
    and ``key_frames`` (frame indices) adds the keyframe trajectory loss.
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
    if lat.finetune_scope == "lora":
        raise NotImplementedError("finetune_scope 'lora' needs the lora_rank adapters, not "
                                  "ported yet (ROADMAP Queue 1 item 6)")
    if lat.opt_param_dtype == "bfloat16":
        raise NotImplementedError("opt_param_dtype bfloat16 (the stochastically rounded "
                                  "decoder clone) is left for a later slice")
    if lat.opt_param_dtype != "float32":
        raise ValueError(f"unsupported latent_opt.opt_param_dtype: {lat.opt_param_dtype!r}")
    if lat.track_best:
        raise NotImplementedError("track_best is not ported: the apps return the last "
                                  "iteration, as the reference does")
    wd = float(cfg.optim.weight_decay)
    lr_z = _steplr(lat.opt_lr, lat)
    lr_d = _steplr(lat.opt_lr * 1e-3, lat)
    per_win = lat.per_window_decoder
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

        # only the decoder is cloned, and within it the scope's modules; the
        # rest stays the trained decoder, shared by every window
        dec = {n: p.detach() for n, p in model.decoder.named_parameters()}
        keys = _scope_keys(list(dict(model.decoder.named_children())), lat.finetune_scope)
        names = sorted((n for n in dec if n.split(".")[0] in keys),
                       key=lambda n: tuple(n.split(".")))  # the flax leaf order
        train0 = {n: dec[n].float() for n in names}

        def forward(zs, params):
            out6d = model.decode(zs, params={**dec, **params})
            out_rotmat = rot.rot6d_to_rotmat(out6d)
            return out6d, out_rotmat, fk_mod.fk_from_rotmat(out_rotmat, offsets)

        def total_loss(out, zs, dec_p):
            """The objective (per-window: the sum of the windows' totals)
            and the loss history's value (their mean)."""
            o6, orm, op = out
            if per_win:
                total = (lcfg.rec_6d_w * _per_sample(o6, tgt["rot_6d"], m6)
                         + lcfg.rec_rot_w * _per_sample(orm, tgt["rot_mat"], mm)
                         + lcfg.rec_pose_w * _per_sample(op, tgt["pose"], m6))
                reg = _per_sample(zs[0], zr[0], 1.0) + _per_sample(zs[-1], zr[-1], 1.0)
                total = total + lat.reg_w * reg
                if dec_p is not None:
                    total = total + lat.reg_w_decoder * sum(
                        ((dec_p[n] - train0[n]) ** 2).reshape(B, -1).mean(1) for n in names)
                if traj_term is not None:
                    total = total + lat.reg_w_trajectory * traj_term(op)
                return total.sum(), total.mean()
            total = (lcfg.rec_6d_w * torch.mean((o6 - tgt["rot_6d"]) ** 2 * m6)
                     + lcfg.rec_rot_w * torch.mean((orm - tgt["rot_mat"]) ** 2 * mm)
                     + lcfg.rec_pose_w * torch.mean((op - tgt["pose"]) ** 2 * m6))
            reg = torch.mean((zs[0] - zr[0]) ** 2) + torch.mean((zs[-1] - zr[-1]) ** 2)
            total = total + lat.reg_w * reg
            if dec_p is not None:
                total = total + lat.reg_w_decoder * sum(
                    torch.mean((dec_p[n] - train0[n]) ** 2) for n in names)
            if traj_term is not None:
                total = total + lat.reg_w_trajectory * traj_term(op).mean()
            return total, total

        history = []
        # z phase: the decoder frozen (no weight gradient, no wgrad); the
        # frozen clone's pull-back term is exactly 0 and is left out
        z_state = chain_init(z, lat.opt_moment_dtype)
        for _ in range(n_z):
            zs = [t.detach().requires_grad_() for t in z]
            objective, value = total_loss(forward(zs, train0), zs, None)
            grads = torch.autograd.grad(objective, zs, allow_unused=True)
            z = chain_update(zs, grads, z_state, lr_z, wd)
            history.append(value.detach())
        z = [t.detach() for t in z]

        # decoder phase: z frozen, the clones (one per window) step
        dec_p = None
        if lat.optimize_decoder and n_scan > n_z:
            dec_p = ({n: v.expand((B,) + v.shape).clone() for n, v in train0.items()}
                     if per_win else dict(train0))
            d_state = chain_init(list(dec_p.values()), lat.opt_moment_dtype)
            for _ in range(n_scan - n_z):
                leaves = {n: v.detach().requires_grad_() for n, v in dec_p.items()}
                objective, value = total_loss(forward(z, leaves), z, leaves)
                grads = torch.autograd.grad(objective, list(leaves.values()),
                                            allow_unused=True)
                dec_p = dict(zip(names, chain_update(list(leaves.values()), grads, d_state,
                                                     lr_d, wd)))
                history.append(value.detach())

        # the last iteration: its forward, before its update, is the result
        # (its update is never read, so it is not computed)
        with torch.no_grad():
            if dec_step_last:
                if dec_p is None:
                    dec_p = ({n: v.expand((B,) + v.shape) for n, v in train0.items()}
                             if per_win else dict(train0))
                last = forward(z, dec_p)
                _, value = total_loss(last, z, dec_p)
            else:
                last = forward(z, train0)
                _, value = total_loss(last, z, None)
            history.append(value)
            final = (lcfg.rec_6d_w * _per_sample(last[0], tgt["rot_6d"], m6)
                     + lcfg.rec_rot_w * _per_sample(last[1], tgt["rot_mat"], mm)
                     + lcfg.rec_pose_w * _per_sample(last[2], tgt["pose"], m6))
        return LatentOptResult(
            last_6d=last[0], last_rotmat=last[1], last_pose=last[2], best_6d=last[0],
            best_rotmat=last[1], best_pose=last[2], final_loss=final,
            loss_history=torch.stack(history))

    return solve
