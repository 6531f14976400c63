"""Root-trajectory prediction model (PyTorch).

Port of ``hm_vae_tpu.models.trajectory``: a stride-1 skeleton conv/pool
encoder over joint positions (channel base 3) gives a per-frame latent
(B, 7*d_model, T); ``fc_mapping``, a per-frame Linear(7*d_model -> 3),
regresses the normalised root velocity; the trajectory is the velocity
accumulated from frame 1 on.  Fully convolutional: any T in one call.

Module and parameter names follow the flax tree (``encoder.conv_{i}.weight``,
``fc_mapping.weight``), the Linear weight stored (out, in); under
``param_layout: compact`` a masked level stores ``encoder.conv_{i}.weight_c``
(:mod:`.param_layout`), as the JAX module's levels do.  On a CUDA
device every level is one launch of the ``fused_conv_pool`` kernel on the
level's folded weight ``P @ (W*mask)`` and bias ``P @ b``, then
LeakyReLU(0.2): the JAX module runs the conv and applies the pool after it
(``apply_channel_matrix``), the same function.  Training runs the levels
through :class:`~hm_vae_torch.ops.fused_conv_pool.FusedConvPoolFn`, so a step
launches the forward kernel 4 times, dgrad 3 (level 0's input is data) and
wgrad 4.

:class:`TrajectoryRunner` with ``sp_group`` splits the time axis over a
group's ranks (:mod:`hm_vae_torch.parallel.sequence_parallel`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data import layout
from ..ops import fk as fk_mod
from ..ops import rotations as rot
from ..utils.config import Config, ModelConfig
from .hm_vae import OperandMap, SkeletonConv, _linear, _run
from .param_layout import validate_layout
from .structure import get_trajectory_structure


class TrajectoryEncoder(nn.Module):
    """Stride-1 cascade: (B, C0, T) -> (B, out_edges*d_model, T), f32."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.structure = st = get_trajectory_structure(cfg)
        for i, lvl in enumerate(st.levels):
            self.add_module(f"conv_{i}", SkeletonConv(
                lvl.conv, cfg.compute_dtype, pool_matrix=lvl.pool_matrix,
                negative_slope=0.2, generator=generator, param_layout=cfg.param_layout))

    def forward(self, x: torch.Tensor, ops: Optional[OperandMap] = None) -> torch.Tensor:
        for i in range(len(self.structure.levels)):
            x = _run(getattr(self, f"conv_{i}"), x, ops)
        return x.float()


class TrajectoryModel(nn.Module):
    """Per-frame root velocity regression from pose sequences."""

    def __init__(self, cfg: ModelConfig, init_type: str = "kaiming",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # lora_rank is ignored, as in the JAX model: the adapters are the
        # VAE decoder's, the trajectory model declares none
        validate_layout(cfg.param_layout)
        self.cfg = cfg
        st = get_trajectory_structure(cfg)
        self.encoder = TrajectoryEncoder(cfg, generator)
        # the reference trainer's weights_init rebinds this plain Linear
        self.fc_mapping = _linear(st.out_edges * st.d_model, 3, init_type, generator)

    def conv_operands(self) -> OperandMap:
        """Every conv's packed operands, computed once (serving)."""
        return {m: m.packed_operands() for m in self.modules() if isinstance(m, SkeletonConv)}

    def forward(self, inputs: torch.Tensor, ops: Optional[OperandMap] = None) -> torch.Tensor:
        """inputs (B, T, 24, C0) -> root_v (B, T, 3), normalised units."""
        B, T, J, C0 = inputs.shape
        x = inputs.reshape(B, T, J * C0).transpose(1, 2).contiguous()
        # (B, k*d, T) -> (B, T, k*d): the reference's (edge, channel) order
        feat = self.encoder(x, ops).transpose(1, 2)
        return self.fc_mapping(feat)


def accumulate_root_trajectory(root_v: torch.Tensor) -> torch.Tensor:
    """(B, T, 3) per-step root velocity -> (B, T, 3) root translation; step 0
    contributes nothing (a cumsum with the first velocity zeroed)."""
    v = torch.cat((torch.zeros_like(root_v[:, :1]), root_v[:, 1:]), dim=1)
    return torch.cumsum(v, dim=1)


def add_trajectory(pose: torch.Tensor, root_v: torch.Tensor) -> torch.Tensor:
    """Poses (B, T, 24, 3) in world space: + the accumulated root_v."""
    return pose + accumulate_root_trajectory(root_v)[:, :, None, :]


def _stat(mean_std, row: int, sl, device, zero_to_one: bool = False):
    """A slice of one row of the (2, 579) stats on ``device``: from a numpy
    array, or from a tensor (already on the device: no host copy)."""
    if torch.is_tensor(mean_std):
        v = mean_std[row, sl].to(device)
        return torch.where(v == 0, torch.ones_like(v), v) if zero_to_one else v
    v = np.asarray(mean_std[row], np.float32)[sl]
    if zero_to_one:
        v = np.where(v == 0, 1, v).astype(np.float32)
    return torch.as_tensor(v, device=device)


def make_root_v_fn(model: TrajectoryModel, mean_std: np.ndarray,
                   ops: Optional[OperandMap] = None):
    """The root-velocity predictor on ``model``'s current weights (or its
    packed ``ops``): pose (B, T, 24, 3) unnormalised FK positions -> root_v
    (B, T, 3) in unnormalised units.  Normalises with the stats' joint-pos
    slice as given (no zero-std guard, as the JAX function), runs the model,
    de-standardises."""
    dev = next(model.parameters()).device
    c_mean = _stat(mean_std, 0, layout.COORD, dev).reshape(24, 3)
    c_std = _stat(mean_std, 1, layout.COORD, dev).reshape(24, 3)
    rv_mean = _stat(mean_std, 0, layout.ROOT_V, dev)
    rv_std = _stat(mean_std, 1, layout.ROOT_V, dev)

    def predict_root_v(pose: torch.Tensor) -> torch.Tensor:
        root_v_n = model((pose - c_mean) / c_std, ops)
        return rv_mean + rv_std * root_v_n

    return predict_root_v


class TrajectoryRunner:
    """Inference: 6D rotations or positions in -> world-space poses out.

    FK -> normalise with the stats' joint-pos slice -> model ->
    de-standardise root_v -> integrate, on the model's device, with the
    convs' operands packed once.

    ``sp_group``: a ``torch.distributed`` group over whose ranks the time
    axis is split (every rank calls with the same data and gets the whole
    result): each level exchanges halos with its neighbours and runs VALID
    (:func:`~hm_vae_torch.parallel.sequence_parallel.make_sp_trajectory_fn`).
    Any length is padded and trimmed, unless ``sp_pad_incomplete`` is false,
    which demands ``T % ranks == 0`` (the padded tail's last velocities see
    repeated frames).
    """

    def __init__(self, model: TrajectoryModel, mean_std: np.ndarray, sp_group=None,
                 sp_pad_incomplete: bool = True):
        self.model = model
        self.device = next(model.parameters()).device
        self._predict = make_root_v_fn(model, mean_std, model.conv_operands())
        self._offsets = torch.as_tensor(fk_mod.default_offsets(), device=self.device)
        self._sp = None
        if sp_group is not None:
            from ..parallel.sequence_parallel import make_sp_trajectory_fn

            self._sp = make_sp_trajectory_fn(model, mean_std, sp_group, sp_pad_incomplete)

    @torch.no_grad()
    def __call__(self, data) -> Tuple[torch.Tensor, torch.Tensor]:
        """data: (B, T, 24, 6) rot6d or (B, T, 24, 3) positions.  Returns
        (world_pose (B, T, 24, 3), root_v (B, T, 3) unnormalised)."""
        data = torch.as_tensor(np.asarray(data) if not torch.is_tensor(data) else data,
                               dtype=torch.float32).to(self.device)
        if data.shape[-1] == 6:
            pose = fk_mod.fk_from_rotmat(rot.rot6d_to_rotmat(data), self._offsets)
        else:
            pose = data
        if self._sp is not None:
            return self._sp(pose)
        root_v = self._predict(pose)
        return add_trajectory(pose, root_v), root_v


def trajectory_losses(model: TrajectoryModel, batch: Dict[str, torch.Tensor], cfg: Config,
                      mean_std: np.ndarray) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss: L2 on the normalised root_v + L2 on the world
    trajectories accumulated from de-standardised velocities
    (``use_accumulation_root_v``).  A batch without ``joint_pos`` derives
    the positions from its rotations by FK, normalised with a zero std read
    as 1."""
    dev = batch["root_v"].device
    if "joint_pos" not in batch:
        rot_mat = batch.get("rot_mat")
        if rot_mat is None:
            rot_mat = (rot.rot6d_to_rotmat(batch["rot_6d"]) if "rot_6d" in batch
                       else rot.aa_to_rotmat(batch["aa"].float()))
        pose = fk_mod.fk_from_rotmat(rot_mat, fk_mod.offsets_on(dev))
        mean_c = _stat(mean_std, 0, layout.COORD, dev).reshape(24, 3)
        std_c = _stat(mean_std, 1, layout.COORD, dev, zero_to_one=True).reshape(24, 3)
        batch = dict(batch, rot_mat=rot_mat, rot_pos=pose, joint_pos=(pose - mean_c) / std_c)
        if "rot_6d" not in batch:
            batch["rot_6d"] = rot.rotmat_to_rot6d(rot_mat)
    inputs = batch["joint_pos"] if cfg.model.trajectory_input_joint_pos else batch["rot_6d"]
    root_v_gt = batch["root_v"]
    pred = model(inputs)
    l_root_v = torch.mean((pred - root_v_gt) ** 2)
    if cfg.model.use_accumulation_root_v:
        mean_rv = _stat(mean_std, 0, layout.ROOT_V, dev)
        std_rv = _stat(mean_std, 1, layout.ROOT_V, dev)
        pose = batch["rot_pos"]
        pred_w = add_trajectory(pose, mean_rv + std_rv * pred)
        gt_w = add_trajectory(pose, mean_rv + std_rv * root_v_gt)
        l_trans = torch.mean((pred_w - gt_w) ** 2)
    else:
        l_trans = torch.zeros((), device=dev)
    total = cfg.loss.rec_root_v_w * l_root_v + cfg.loss.rec_root_trans_w * l_trans
    return total, {"loss_total": total, "loss_rec_root_v": l_root_v,
                   "loss_rec_root_trans": l_trans}
