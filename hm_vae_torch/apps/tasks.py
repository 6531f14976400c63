"""Motion completion, interpolation and generation on long sequences.

Port of ``hm_vae_tpu.apps.tasks``.  The three applications differ only in
their masks and in how they stitch windows; each runs the one solver of
:mod:`hm_vae_torch.apps.latent_opt`:

- interpolation: non-overlapping windows and a temporal keyframe mask; the
  windows are independent, so all of them solve in one batched call;
- completion: a per-joint visibility mask, windows at stride W - 1, each
  window's first frame pinned to the previous window's output (a sequential
  outer loop; across sequences the same window index batches);
- generation: autoregressive windows overlapping ``overlap`` frames, z
  regularised toward its random start.

Random starting points come from a ``torch.Generator``: where the JAX package
folds a window's index into its key, the port draws the windows' z one after
the other from the one generator.  Outputs are tensors on the model's device
where the JAX package returns device arrays, numpy where it returns numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.hm_vae import HMVAE
from ..ops import fk as fk_mod
from ..ops import rotations as rot
from ..parallel.sharding import gather_rows, rank_rows, world_size
from ..utils.config import Config
from .latent_opt import LatentOptResult, init_z, make_latent_optimizer, replace_with_target

UPPER_JOINTS = (12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23)
LOWER_JOINTS = (0, 3, 6, 9, 1, 2, 4, 5, 7, 8, 10, 11)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _targets_from_rotmat(rotmat, device=None) -> Dict[str, torch.Tensor]:
    """(..., T, 24, 3, 3) -> target dict with 6D and FK positions, on
    ``device`` (default: the input's)."""
    rotmat = torch.as_tensor(_np(rotmat) if not torch.is_tensor(rotmat) else rotmat,
                             dtype=torch.float32, device=device)
    six = rot.rotmat_to_rot6d(rotmat)
    pose = fk_mod.fk_from_rotmat(rotmat, fk_mod.default_offsets())
    return {"rot_6d": six, "rot_mat": rotmat, "pose": pose}


def _targets_from_rotmat_np(rotmat) -> Dict[str, np.ndarray]:
    """Host numpy targets, for variable-length full sequences."""
    rotmat = np.asarray(_np(rotmat), np.float32)
    six = np.concatenate((rotmat[..., :, 0], rotmat[..., :, 1]), axis=-1)
    pose = np.asarray(fk_mod.fk_numpy(rotmat), np.float32)
    return {"rot_6d": six, "rot_mat": rotmat, "pose": pose}


def interpolation_mask(T: int, keyframe_every: int) -> np.ndarray:
    """Temporal keyframe mask (T,): 1 at keyframes, the final frame included."""
    m = np.zeros(T, dtype=np.float32)
    m[::keyframe_every] = 1.0
    m[-1] = 1.0
    return m


def completion_joint_mask(missing: str) -> np.ndarray:
    """(24,) 1 = visible; missing='upper'|'lower' hides that body part."""
    m = np.ones(24, dtype=np.float32)
    joints = UPPER_JOINTS if missing == "upper" else LOWER_JOINTS
    m[list(joints)] = 0.0
    return m


class LatentOptApps:
    """The applications over one model (its weights at each call), on the
    model's device.  ``trajectory=(traj_model, mean_std)`` with
    ``cfg.latent_opt.optimize_trajectory`` set adds the keyframe trajectory
    loss to interpolation given a ``root_trans``.

    ``group`` (a ``torch.distributed`` group): every batched solve's window
    batch is split over its ranks (:meth:`_dispatch`), each rank holding the
    same model and drawing the same starting points."""

    def __init__(self, model: HMVAE, cfg: Config, trajectory=None, group=None):
        self.model = model
        self.cfg = cfg
        self.group = group
        self.W = cfg.model.train_seq_len
        self.solve = make_latent_optimizer(model, cfg, group=group)
        # completion switches phase later than the other tasks
        lat = cfg.latent_opt
        if lat.prev_epochs_completion != lat.prev_epochs:
            self.solve_completion = make_latent_optimizer(
                model, cfg, lat=dataclasses.replace(lat, prev_epochs=lat.prev_epochs_completion),
                group=group)
        else:
            self.solve_completion = self.solve
        self._traj_solve = None
        if trajectory is not None and lat.optimize_trajectory:
            key = tuple(np.nonzero(interpolation_mask(self.W, lat.interpolation_window))[0])
            self._traj_solve = make_latent_optimizer(model, cfg, trajectory=trajectory,
                                                     key_frames=key, group=group)

    def _dispatch(self, solve, targets, mask, z_init, z_reg) -> LatentOptResult:
        """One batched solve; under a group, split over its ranks, as the
        JAX package shards the window batch over its mesh's data axis.

        The batch is padded to a multiple of the world size by cycling real
        windows (the JAX package's policy), each rank solves its contiguous
        rows, the per-window results are gathered to every rank (zeroed
        buffers and one all-reduce each: exact) and the padding is trimmed.
        ``loss_history`` is the padded batch's mean, as in JAX (per-window
        clones: the ranks' means averaged; the shared clone's total is
        global already)."""
        if self.group is None:
            return solve(targets, mask, z_init, z_reg)
        n = world_size(self.group)
        B = int(mask.shape[0])
        B_pad = -(-B // n) * n
        r0, r1 = rank_rows(B_pad, self.group)
        rows = np.arange(r0, r1) % B  # the rank's rows of the cyclically padded batch

        def take(x):
            if torch.is_tensor(x):
                return x[torch.as_tensor(rows, device=x.device)]
            return np.asarray(x)[rows]

        res = solve({k: take(v) for k, v in targets.items()}, take(mask),
                    [take(z) for z in z_init], [take(z) for z in z_reg])
        fields = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}
        out = {k: gather_rows(v, B_pad, r0, self.group)[:B]
               for k, v in fields.items() if k != "loss_history"}
        history = res.loss_history
        if self.cfg.latent_opt.per_window_decoder:
            history = history.clone()
            dist.all_reduce(history, group=self.group)
            history /= n
        return LatentOptResult(loss_history=history, **out)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def interpolate(self, rotmat_seq, generator: Optional[torch.Generator],
                    replace_with_gt: Optional[bool] = None, root_trans=None,
                    restarts: int = 1) -> Dict:
        """Temporal interpolation of one long sequence (T, 24, 3, 3): the
        stitched (n_win * W, ...) outputs.  ``restarts > 1`` solves that many
        random starts per window in the same batch and keeps each window's
        best by final loss.  With ``root_trans`` (T, 3) and a trajectory
        solve, the keyframe trajectory loss is on."""
        lat = self.cfg.latent_opt
        W = self.W
        seq = _np(rotmat_seq)
        n_win = seq.shape[0] // W
        if n_win == 0:
            raise ValueError(f"sequence shorter than window: {seq.shape[0]} < {W}")
        wins = seq[: n_win * W].reshape(n_win, W, 24, 3, 3)
        R = max(1, restarts)
        wins_b = np.repeat(wins, R, axis=0) if R > 1 else wins
        targets = _targets_from_rotmat_np(wins_b)
        tmask = interpolation_mask(W, lat.interpolation_window)
        mask = self._put(np.tile(tmask[None, :, None], (n_win * R, 1, 24)))
        z_init = init_z(generator, self.cfg, n_win * R)
        z_reg = [torch.zeros_like(z) for z in z_init]
        if self._traj_solve is not None and root_trans is not None:
            rt = _np(root_trans)[: n_win * W].reshape(n_win, W, 3)
            res = self._dispatch(self._traj_solve,
                                 dict(targets, root_trans=np.repeat(rt, R, axis=0)), mask,
                                 z_init, z_reg)
        else:
            res = self._dispatch(self.solve, targets, mask, z_init, z_reg)

        if R > 1:
            per = res.final_loss.reshape(n_win, R)
            sel = torch.arange(n_win, device=per.device) * R + per.argmin(dim=1)
            res = LatentOptResult(
                last_6d=res.last_6d[sel], last_rotmat=res.last_rotmat[sel],
                last_pose=res.last_pose[sel], best_6d=res.best_6d[sel],
                best_rotmat=res.best_rotmat[sel], best_pose=res.best_pose[sel],
                final_loss=per.min(dim=1).values, loss_history=res.loss_history)
            targets = _targets_from_rotmat_np(wins)
            mask = self._put(np.tile(tmask[None, :, None], (n_win, 1, 24)))

        out6d, outrot, outpose = res.last_6d, res.last_rotmat, res.last_pose
        if replace_with_gt if replace_with_gt is not None else lat.replace_frame_with_gt:
            tg = {k: self._put(v) for k, v in targets.items()}
            out6d = replace_with_target(out6d, tg["rot_6d"], mask)
            outrot = replace_with_target(outrot, tg["rot_mat"], mask)
            outpose = replace_with_target(outpose, tg["pose"], mask)

        def stitch(x):
            return x.reshape((n_win * W,) + tuple(x.shape[2:]))

        return {"rot_6d": stitch(out6d), "rot_mat": stitch(outrot), "pose": stitch(outpose),
                "mask": stitch(mask), "loss_history": res.loss_history}

    # ------------------------------------------------------------------
    def interpolate_many(self, rotmat_seqs, generator: Optional[torch.Generator],
                         pad_to_multiple: int = 1) -> List[Dict[str, np.ndarray]]:
        """Temporal interpolation of many long sequences in one batched
        solve: every sequence's windows flatten into one batch, padded to a
        multiple of ``pad_to_multiple`` by cycling the real windows (the JAX
        package pads to 32 for one compile; eager PyTorch compiles nothing,
        so the port pads nothing by default), padded rows discarded.
        Returns one numpy dict per sequence, as :meth:`interpolate`'s."""
        lat = self.cfg.latent_opt
        W = self.W
        seqs = [np.asarray(_np(s), np.float32) for s in rotmat_seqs]
        n_wins = [s.shape[0] // W for s in seqs]
        short = [i for i, n in enumerate(n_wins) if n == 0]
        if short:
            raise ValueError(f"sequences {short} are shorter than one window (< {W})")
        wins = np.concatenate([s[: n * W].reshape(n, W, 24, 3, 3)
                               for s, n in zip(seqs, n_wins)])
        B = wins.shape[0]
        B_pad = -(-B // pad_to_multiple) * pad_to_multiple
        if B_pad > B:
            wins = np.concatenate([wins, wins[np.arange(B_pad - B) % B]])
        targets = _targets_from_rotmat_np(wins)
        tmask = interpolation_mask(W, lat.interpolation_window)
        mask = self._put(np.tile(tmask[None, :, None], (B_pad, 1, 24)))
        z_init = init_z(generator, self.cfg, B_pad)
        z_reg = [torch.zeros_like(z) for z in z_init]
        res = self._dispatch(self.solve, targets, mask, z_init, z_reg)

        out6d, outrot, outpose = res.last_6d, res.last_rotmat, res.last_pose
        if lat.replace_frame_with_gt:
            tg = {k: self._put(v) for k, v in targets.items()}
            out6d = replace_with_target(out6d, tg["rot_6d"], mask)
            outrot = replace_with_target(outrot, tg["rot_mat"], mask)
            outpose = replace_with_target(outpose, tg["pose"], mask)
        o6, orm, op, msk = (_np(t) for t in (out6d, outrot, outpose, mask))
        outs, off = [], 0
        for n in n_wins:
            def stitch(x):
                return x[off:off + n].reshape((n * W,) + x.shape[2:])

            outs.append({"rot_6d": stitch(o6), "rot_mat": stitch(orm), "pose": stitch(op),
                         "mask": stitch(msk)})
            off += n
        return outs

    # ------------------------------------------------------------------
    def interpolate_single_window(self, rotmat_wins, generator: Optional[torch.Generator],
                                  root_trans=None) -> Dict:
        """One-window temporal interpolation of (B, W, 24, 3, 3), one window
        per sequence, in one batched solve; ``root_trans`` (B, W, 3) turns
        the keyframe trajectory loss on, as in :meth:`interpolate`."""
        lat = self.cfg.latent_opt
        B, W = rotmat_wins.shape[:2]
        if W != self.W:
            raise ValueError(f"window length {W} != train_seq_len {self.W}")
        targets = _targets_from_rotmat(rotmat_wins, self.device)
        tmask = interpolation_mask(W, lat.interpolation_window)
        mask = self._put(np.tile(tmask[None, :, None], (B, 1, 24)))
        z_init = init_z(generator, self.cfg, B)
        z_reg = [torch.zeros_like(z) for z in z_init]
        if self._traj_solve is not None and root_trans is not None:
            res = self._dispatch(self._traj_solve, dict(targets, root_trans=root_trans), mask,
                                 z_init, z_reg)
        else:
            res = self._dispatch(self.solve, targets, mask, z_init, z_reg)
        out6d, outrot, outpose = res.last_6d, res.last_rotmat, res.last_pose
        if lat.replace_frame_with_gt:
            out6d = replace_with_target(out6d, targets["rot_6d"], mask)
            outrot = replace_with_target(outrot, targets["rot_mat"], mask)
            outpose = replace_with_target(outpose, targets["pose"], mask)
        return {"rot_6d": out6d, "rot_mat": outrot, "pose": outpose, "mask": mask,
                "loss_history": res.loss_history}

    # ------------------------------------------------------------------
    def complete_single_window(self, rotmat_wins, masks,
                               generator: Optional[torch.Generator]) -> Dict:
        """One-window motion completion of (B, W, 24, 3, 3) under (B, W, 24)
        visibility masks (1 = visible), in one batched solve."""
        lat = self.cfg.latent_opt
        B, W = rotmat_wins.shape[:2]
        if W != self.W:
            raise ValueError(f"window length {W} != train_seq_len {self.W}")
        targets = _targets_from_rotmat(rotmat_wins, self.device)
        mask = self._put(_np(masks))
        z_init = init_z(generator, self.cfg, B)
        z_reg = [torch.zeros_like(z) for z in z_init]
        res = self._dispatch(self.solve_completion, targets, mask, z_init, z_reg)
        out6d, outrot, outpose = res.last_6d, res.last_rotmat, res.last_pose
        if lat.replace_part_with_gt:
            out6d = replace_with_target(out6d, targets["rot_6d"], mask)
            outrot = replace_with_target(outrot, targets["rot_mat"], mask)
            outpose = replace_with_target(outpose, targets["pose"], mask)
        return {"rot_6d": out6d, "rot_mat": outrot, "pose": outpose, "mask": mask,
                "loss_history": res.loss_history}

    # ------------------------------------------------------------------
    def complete(self, rotmat_seq, generator: Optional[torch.Generator],
                 missing: str = "lower") -> Dict[str, torch.Tensor]:
        """Body-part completion over a long sequence with 1-frame stitching."""
        lat = self.cfg.latent_opt
        W = self.W
        overlap = 1
        stride = W - overlap
        seq = _np(rotmat_seq)
        T = seq.shape[0]
        joint_mask = completion_joint_mask(missing)
        full = _targets_from_rotmat_np(seq)
        acc = None
        for t0 in range(0, T, stride):
            if t0 + W > T:
                break  # the final partial window is dropped
            tgt = {k: np.array(v[None, t0:t0 + W]) for k, v in full.items()}
            mask = np.tile(joint_mask[None, :], (W, 1))
            if acc is not None:
                # pin frame 0 to the previous window's full output
                mask[:overlap] = 1.0
                for k in ("rot_6d", "rot_mat", "pose"):
                    tgt[k][0, :overlap] = _np(acc[k][-overlap:])
            mask = self._put(mask)[None]
            z_init = init_z(generator, self.cfg, 1)
            z_reg = [torch.zeros_like(z) for z in z_init]
            res = self._dispatch(self.solve_completion, tgt, mask, z_init, z_reg)
            out = {"rot_6d": res.last_6d, "rot_mat": res.last_rotmat, "pose": res.last_pose}
            if lat.replace_part_with_gt:
                out = {k: replace_with_target(v, self._put(tgt[k]), mask)
                       for k, v in out.items()}
            out = {k: v[0] for k, v in out.items()}
            acc = out if acc is None else {k: torch.cat((acc[k], out[k][overlap:]), 0)
                                           for k in acc}
        if acc is None:
            raise ValueError(f"sequence shorter than window: {T} < {W}")
        return acc

    # ------------------------------------------------------------------
    def complete_many(self, rotmat_seqs, generator: Optional[torch.Generator],
                      missing: str = "lower") -> List[Dict[str, torch.Tensor]]:
        """Body-part completion of many long sequences, batched per window
        index: window w of every sequence solves in one call (windows within
        a sequence stay sequential).  A sequence with fewer windows than the
        longest rides along on its last window, its extra outputs dropped."""
        lat = self.cfg.latent_opt
        W = self.W
        overlap = 1
        stride = W - overlap
        seqs = [_np(s) for s in rotmat_seqs]
        counts = [max(0, (s.shape[0] - W) // stride + 1) for s in seqs]
        short = [i for i, c in enumerate(counts) if c == 0]
        if short:
            raise ValueError(
                f"sequences {short} are shorter than one window "
                f"({[seqs[i].shape[0] for i in short]} < {W} frames); filter them out "
                "before calling complete_many")
        B = len(seqs)
        joint_mask = completion_joint_mask(missing)
        fulls = [_targets_from_rotmat_np(s) for s in seqs]
        accs: List[Optional[Dict[str, torch.Tensor]]] = [None] * B
        for w in range(max(counts)):
            tgt = {k: np.zeros((B, W) + fulls[0][k].shape[1:], np.float32)
                   for k in ("rot_6d", "rot_mat", "pose")}
            mask = np.tile(joint_mask[None, None, :], (B, W, 1))
            for b, (full, cnt) in enumerate(zip(fulls, counts)):
                t0 = min(w, max(cnt - 1, 0)) * stride  # clamp = repeat the last
                for k in tgt:
                    tgt[k][b] = full[k][t0:t0 + W]
                if accs[b] is not None and w < cnt:
                    mask[b, :overlap] = 1.0
                    for k in tgt:
                        tgt[k][b, :overlap] = _np(accs[b][k][-overlap:])
            tgt_t = {k: self._put(v) for k, v in tgt.items()}
            mask_t = self._put(mask)
            z_init = init_z(generator, self.cfg, B)
            z_reg = [torch.zeros_like(z) for z in z_init]
            res = self._dispatch(self.solve_completion, tgt_t, mask_t, z_init, z_reg)
            out = {"rot_6d": res.last_6d, "rot_mat": res.last_rotmat, "pose": res.last_pose}
            if lat.replace_part_with_gt:
                out = {k: replace_with_target(out[k], tgt_t[k], mask_t) for k in out}
            for b, cnt in enumerate(counts):
                if w >= cnt:
                    continue
                ob = {k: out[k][b] for k in out}
                accs[b] = ob if accs[b] is None else {
                    k: torch.cat((accs[b][k], ob[k][overlap:]), 0) for k in ob}
        return accs

    # ------------------------------------------------------------------
    def generate(self, seed_rotmat, generator: Optional[torch.Generator],
                 num_windows: int = 5, overlap: int = 10) -> Dict[str, torch.Tensor]:
        """Autoregressive generation from a seed window (W, 24, 3, 3): the
        sequence grows by W - overlap frames per window."""
        W = self.W
        whole = _targets_from_rotmat(seed_rotmat, self.device)
        tmask = np.zeros(W, dtype=np.float32)
        tmask[:overlap] = 1.0
        mask = self._put(np.tile(tmask[:, None], (1, 24)))[None]
        pad = W - overlap
        for _ in range(num_windows):
            tgt = {k: torch.cat((v[-overlap:], v.new_zeros((pad,) + tuple(v.shape[1:]))),
                                0)[None] for k, v in whole.items()}
            z_init = init_z(generator, self.cfg, 1)
            # generation regularises z toward its random start
            res = self._dispatch(self.solve, tgt, mask, z_init, z_init)
            whole = {"rot_6d": torch.cat((whole["rot_6d"], res.last_6d[0, overlap:]), 0),
                     "rot_mat": torch.cat((whole["rot_mat"], res.last_rotmat[0, overlap:]), 0),
                     "pose": torch.cat((whole["pose"], res.last_pose[0, overlap:]), 0)}
        return whole

    # ------------------------------------------------------------------
    def generate_many(self, seed_rotmats, generator: Optional[torch.Generator],
                      num_windows: int = 5, overlap: int = 10) -> List[Dict[str, np.ndarray]]:
        """Autoregressive generation from many seed windows, batched per
        round: each round solves every sequence's next window in one call.
        Returns one numpy dict per sequence, as :meth:`generate`'s."""
        W = self.W
        seeds = np.stack([np.asarray(_np(s), np.float32) for s in seed_rotmats])
        B = seeds.shape[0]
        whole = _targets_from_rotmat_np(seeds)
        tmask = np.zeros(W, dtype=np.float32)
        tmask[:overlap] = 1.0
        mask = self._put(np.tile(tmask[None, :, None], (B, 1, 24)))
        pad = W - overlap
        for _ in range(num_windows):
            tgt = {k: np.concatenate((whole[k][:, -overlap:],
                                      np.zeros((B, pad) + whole[k].shape[2:], np.float32)),
                                     axis=1)
                   for k in ("rot_6d", "rot_mat", "pose")}
            z_init = init_z(generator, self.cfg, B)
            res = self._dispatch(self.solve, tgt, mask, z_init, z_init)
            out = {"rot_6d": res.last_6d, "rot_mat": res.last_rotmat, "pose": res.last_pose}
            whole = {k: np.concatenate((whole[k], _np(out[k])[:, overlap:]), axis=1)
                     for k in whole}
        return [{k: v[b] for k, v in whole.items()} for b in range(B)]
