"""Loss functions of the VAE.

Port of ``hm_vae_tpu.train.losses`` (``kl_normal``, ``l2``,
``hmvae_forward``, ``decode_full``).  The KL curriculum gates the shallow
latent's gradient below ``iteration_interval`` as the JAX package's
``_grad_gate`` does: the value always, the gradient through a ``where``
only when ``step >= iteration_interval``, with the step a tensor (the
training step's, on the model's device), so that the gate is decided on the
device and one CUDA graph serves both sides of the boundary.  The shallow
head's gradient is exact zeros before it, which the optimizer reads as
untouched (as torch's ``grad is None`` skip in the reference).  The two
middle latents are never read by the decoder: their heads get no gradient.

Noise is explicit: ``eps`` (one tensor per level, as the JAX side would
draw them) or a ``torch.Generator`` that draws them on the CPU, so that the
same seed gives the same noise on every device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models.hm_vae import HMVAE, reparametrize, split_stats
from ..models.structure import get_structure
from ..ops import fk as fk_mod
from ..ops import rotations as rot
from ..utils.config import Config


def kl_normal(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, I)) summed over the latent dim, mean over the
    rest."""
    return torch.mean(-0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))


def l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def _offsets(device) -> torch.Tensor:
    return fk_mod.offsets_on(torch.device(device))


def _grad_gate(x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The value of x always; its gradient only where ``active`` (a bool
    tensor, decided on the device)."""
    return torch.where(active, x, x.detach())


def ground_truth(batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rot6d, rotmat) targets from whichever wire form the batch carries:
    ``rot_mat`` and/or ``rot_6d`` (each derives the other: 6D is the first
    two columns, the matrix Gram-Schmidt of 6D), or ``aa`` (Rodrigues)."""
    rotmat = batch.get("rot_mat")
    rot6d = batch.get("rot_6d")
    if rotmat is None and rot6d is None:
        rotmat = rot.aa_to_rotmat(batch["aa"].float())
    if rot6d is None:
        rot6d = rot.rotmat_to_rot6d(rotmat)
    if rotmat is None:
        rotmat = rot.rot6d_to_rotmat(rot6d)
    return rot6d, rotmat


def eps_shapes(cfg: Config, batch: int) -> List[Tuple[int, int, int]]:
    """Each level's mu shape (B, edges, latent dim), shallow -> deep."""
    st = get_structure(cfg.model)
    return [(batch, st.z_edges[i], st.z_dims[i]) for i in range(cfg.model.num_layers)]


def draw_noise(shapes: Sequence[Tuple[int, ...]], generator: Optional[torch.Generator]
               ) -> List[torch.Tensor]:
    """Standard normal noise of each shape, drawn on the CPU from
    ``generator`` in level order."""
    return [torch.randn(s, generator=generator) for s in shapes]


def draw_eps(z_stats: Sequence[torch.Tensor], cfg: Config,
             generator: Optional[torch.Generator]) -> List[torch.Tensor]:
    """Standard normal noise of each level's mu shape, drawn on the CPU
    from ``generator`` and moved to the stats' device."""
    shapes = [split_stats(s, cfg.model, i)[0].shape for i, s in enumerate(z_stats)]
    return [e.to(s.device) for e, s in zip(draw_noise(shapes, generator), z_stats)]


def hmvae_forward(model: HMVAE, batch: Dict[str, torch.Tensor],
                  step: torch.Tensor, cfg: Config,
                  sample: bool = True, eps: Optional[Sequence[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One VAE forward and its losses: ground-truth FK (detached targets),
    encoder, reparametrization with the KL curriculum, decoder, 6D ->
    rotmat -> FK, L2 + KL.

    ``batch`` holds unnormalised ``rot_6d`` (B,T,24,6) and/or ``rot_mat``
    (B,T,24,3,3), or ``aa`` (B,T,24,3).  ``step`` is the iteration of the KL
    curriculum, a 0-dim integer tensor (see the module docstring).  With
    ``kl_w != 0`` and ``sample`` the latents are sampled with ``eps`` if
    given, else with noise from ``generator``.

    Returns (total loss, metrics) with every logged scalar as a tensor.
    """
    mcfg, lcfg = cfg.model, cfg.loss
    rot6d_gt, rotmat_gt = ground_truth(batch)
    offsets = _offsets(rot6d_gt.device)
    with torch.no_grad():
        pose_gt = fk_mod.fk_from_rotmat(rotmat_gt, offsets)

    _, z_stats = model.encode(rot6d_gt)
    nl = mcfg.num_layers
    active_shallow = step >= lcfg.iteration_interval
    sampling = lcfg.kl_w != 0 and sample
    if sampling and eps is None:
        eps = draw_eps(z_stats, cfg, generator)

    z_list: List[torch.Tensor] = []
    kl_list: List[torch.Tensor] = []
    for i, stats in enumerate(z_stats):
        mu, logvar = split_stats(stats, mcfg, i)
        if i == 0:
            # curriculum: the value always, the gradient from the boundary on
            mu, logvar = _grad_gate(mu, active_shallow), _grad_gate(logvar, active_shallow)
        z = reparametrize(mu, logvar, eps[i]) if sampling else mu
        if i == nl - 1 or i == 0:
            kl_list.append(kl_normal(mu, logvar))
        else:
            kl_list.append(torch.zeros((), device=mu.device))
        z_list.append(z)

    out6d = model.decode(z_list)
    out_rotmat = rot.rot6d_to_rotmat(out6d)
    out_pose = fk_mod.fk_from_rotmat(out_rotmat, offsets)

    l_rec_6d = l2(out6d, rot6d_gt)
    l_rec_rot = l2(out_rotmat, rotmat_gt)
    l_rec_pose = l2(out_pose, pose_gt)
    l_kl = lcfg.kl_w * kl_list[nl - 1] + lcfg.shallow_kl_w * kl_list[0]
    total = (lcfg.rec_6d_w * l_rec_6d + lcfg.rec_rot_w * l_rec_rot
             + lcfg.rec_pose_w * l_rec_pose + l_kl)
    metrics = {"loss_total": total, "loss_kl": l_kl, "loss_rec_6d": l_rec_6d,
               "loss_rec_rot": l_rec_rot, "loss_rec_pose": l_rec_pose}
    for i in range(nl):
        metrics[f"loss_hier_kl_{i + 1}"] = kl_list[i]
    return total, metrics


def decode_full(model: HMVAE, z_list: Sequence[torch.Tensor]):
    """z list -> (6d, rotmat, positions)."""
    out6d = model.decode(z_list)
    out_rotmat = rot.rot6d_to_rotmat(out6d)
    return out6d, out_rotmat, fk_mod.fk_from_rotmat(out_rotmat, _offsets(out6d.device))
