"""Inference: posterior-mean reconstruction, prior samples, VIBE refinement.

Port of ``hm_vae_tpu.apps.inference``.  The serving path is

    encode -> mean z -> decode -> 6D -> rotmat -> FK

defined once in :func:`make_inference_fns` and bound by
:class:`VAEInference`.  Its eight skeleton convs (four encoder, four decoder
levels) are eight launches of the ``fused_conv_pool`` kernel on a CUDA device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.hm_vae import HMVAE, prior_z_list, split_stats
from ..ops import fk as fk_mod
from ..ops import rotations as rot
from ..utils.config import Config
from ..utils.device import resolve_device


def make_inference_fns(model: HMVAE, cfg: Config):
    """The inference functions over ``model``'s parameters:
    ``{"encode_mean", "decode_full", "reconstruct"}``.  z lists are tuples.

    Like the JAX version, which closes over its parameters as constants, it
    prepares the kernel operands of every conv once, here (the folded weight
    in the compute dtype, packed into block-sparse tiles): later changes to
    the parameters are not seen.
    """
    with torch.no_grad():
        ops = model.conv_operands()
    offsets = torch.as_tensor(fk_mod.default_offsets(),
                              device=next(model.parameters()).device)

    def encode_mean(x6d):
        _, stats = model.encode(x6d, ops)
        return tuple(split_stats(s, cfg.model, i)[0] for i, s in enumerate(stats))

    def decode_full(z_tuple):
        out6d = model.decode(list(z_tuple), ops)
        out_rotmat = rot.rot6d_to_rotmat(out6d)
        out_pose = fk_mod.fk_from_rotmat(out_rotmat, offsets)
        return out6d, out_rotmat, out_pose

    def reconstruct(x6d):
        return decode_full(encode_mean(x6d))

    return {"encode_mean": encode_mean, "decode_full": decode_full,
            "reconstruct": reconstruct}


class VAEInference:
    """A model bound for inference on one device (``cuda`` unless told).

    The model is moved to ``device``; its conv operands are packed once,
    when this is built (:func:`make_inference_fns`).
    """

    def __init__(self, model: HMVAE, cfg: Config, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        fns = make_inference_fns(self.model, cfg)
        self._encode_mean = fns["encode_mean"]
        self._decode_full = fns["decode_full"]
        self._reconstruct = fns["reconstruct"]

    def _in(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def mean_z(self, rot6d):
        """(B, T, 24, 6) -> posterior-mean z list."""
        return list(self._encode_mean(self._in(rot6d)))

    @torch.inference_mode()
    def mean_reconstruction(self, rot6d):
        """Posterior-mean reconstruction: 6D in -> (6d, rotmat, pose)."""
        return self._reconstruct(self._in(rot6d))

    @torch.inference_mode()
    def decode_full(self, z_list):
        return self._decode_full(tuple(self._in(z) for z in z_list))

    def prior_samples(self, batch: int, generator: Optional[torch.Generator] = None):
        """Decode z ~ N(0, I) (deep and shallow levels; zero middles)."""
        return self.decode_full(prior_z_list(self.cfg.model, batch, generator))

    @torch.inference_mode()
    def clean_6d(self, out6d):
        """Re-orthonormalise a decoded 6D rep through its rotation matrix."""
        return rot.rotmat_to_rot6d(rot.rot6d_to_rotmat(self._in(out6d)))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def refine_sliding_window(self, rot6d_seq) -> torch.Tensor:
        """Center-frame sliding-window mean reconstruction of (T, 24, 6).

        Windows of ``train_seq_len`` slide with stride 1; each contributes
        its center frame, head and tail come from the first and last window.
        All windows are reconstructed in one batched call.
        """
        seq = self._in(rot6d_seq)
        W = self.cfg.model.train_seq_len
        T = seq.shape[0]
        if T < W:
            raise ValueError(f"sequence shorter than window: {T} < {W}")
        c0 = W // 2 - 1
        windows = seq.unfold(0, W, 1).permute(0, 3, 1, 2)  # (n_win, W, 24, 6)
        rec6d, _, _ = self._reconstruct(windows)
        out = torch.cat((rec6d[0, : c0 + 1], rec6d[1:-1, c0], rec6d[-1, c0:]), dim=0)
        if out.shape[0] != T:
            raise RuntimeError(f"refined length {out.shape[0]} != {T}")
        return out


# ----------------------------------------------------------------------
def adjust_root_rot(seq_rotmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate each sequence so its first frame's root rotation is identity.

    seq_rotmat (B, T, 24, 3, 3) -> (adjusted, relative rotation (B, T, 3, 3)).
    """
    rel = seq_rotmat[:, 0, 0].transpose(-1, -2)
    T = seq_rotmat.shape[1]
    rel_t = rel[:, None].expand(rel.shape[0], T, 3, 3)
    out = seq_rotmat.clone()
    out[:, :, 0] = rel_t @ seq_rotmat[:, :, 0]
    return out, rel_t


def apply_root_rot_to_translation(rel_rot: torch.Tensor, root_v: torch.Tensor) -> torch.Tensor:
    """(B, T, 3, 3) x (B, T, 3) -> the root velocities rotated by
    :func:`adjust_root_rot`'s relative rotation."""
    return (rel_rot @ root_v[..., None])[..., 0]


def aa_to_all_reps(aa_seq: torch.Tensor):
    """Axis-angle (B, T, 24*3) -> (rot6d, rotmat, FK positions)."""
    B, T = aa_seq.shape[:2]
    mats = rot.aa_to_rotmat(aa_seq.reshape(B, T, 24, 3))
    pose = fk_mod.fk_from_rotmat(mats, fk_mod.default_offsets())
    return rot.rotmat_to_rot6d(mats), mats, pose

