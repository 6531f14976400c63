"""Hierarchical latent-space exploration (port of
``hm_vae_tpu.apps.latent_space``).

The reference's intended latent-inspection surface (its Trainer delegates
``check_hier_latent_space`` and ``vis_given_z_vec`` to methods the released
model does not define).  Three probes over a trained VAE:

- :func:`level_sweep`: decode z ~ N(0, I) injected at one hierarchy level,
  every other level zero.  A middle level decodes as the all-zero baseline:
  the decoder reads the deepest and the shallowest z only.
- :func:`level_swap`: encode two motions, decode A's posterior means with
  one level's taken from B.
- :func:`latent_lerp`: decodes along the line between two motions'
  posterior means, at a chosen subset of levels (all by default).

Every probe returns ``(rot_6d, rot_mat, pose)`` from
:meth:`~hm_vae_torch.apps.inference.VAEInference.decode_full`.  The noise
comes from an explicit ``torch.Generator`` (the JAX package folds a key per
level).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..apps.inference import VAEInference
from ..models.structure import get_structure


def _zero_z_list(cfg_model, batch: int) -> List[torch.Tensor]:
    st = get_structure(cfg_model)
    return [torch.zeros((batch, st.z_edges[i], st.z_dims[i]))
            for i in range(cfg_model.num_layers)]


def level_sweep(infer: VAEInference, generator: Optional[torch.Generator] = None,
                batch: int = 1, scale: float = 1.0) -> Dict[str, Tuple]:
    """Per-level prior sweep: ``{"baseline", "level_0", ...} -> decode_full``.

    ``baseline`` decodes the all-zero z list; ``level_i`` adds
    ``scale * N(0, I)`` at level i only, drawn on the CPU from ``generator``
    level by level (0 first).  Levels 1..n-2 decode as the baseline.
    """
    zeros = _zero_z_list(infer.cfg.model, batch)
    out: Dict[str, Tuple] = {"baseline": infer.decode_full(zeros)}
    for lvl in range(infer.cfg.model.num_layers):
        zs = list(zeros)
        zs[lvl] = scale * torch.randn(zeros[lvl].shape, generator=generator)
        out[f"level_{lvl}"] = infer.decode_full(zs)
    return out


def level_swap(infer: VAEInference, rot6d_a, rot6d_b, level: int) -> Tuple:
    """Decode A's posterior means with ``level`` replaced by B's.

    rot6d_a/b: (B, T, 24, 6).  ``level`` indexes the hierarchy (0 =
    shallow, num_layers-1 = deep; the middles do not reach the decoder).
    """
    zs = infer.mean_z(rot6d_a)
    zs[level] = infer.mean_z(rot6d_b)[level]
    return infer.decode_full(zs)


def latent_lerp(infer: VAEInference, rot6d_a, rot6d_b, num: int = 5,
                levels: Optional[Sequence[int]] = None) -> List[Tuple]:
    """``num`` decodes along the line between A's and B's posterior means.

    ``levels`` restricts the interpolation to those hierarchy levels
    (default: all); the others keep A's means.  The endpoints are the two
    motions' mean reconstructions.
    """
    za = infer.mean_z(rot6d_a)
    zb = infer.mean_z(rot6d_b)
    levels = tuple(range(infer.cfg.model.num_layers)) if levels is None else tuple(levels)
    outs = []
    for i in range(num):
        t = i / max(num - 1, 1)
        zs = [(1.0 - t) * a + t * b if lvl in levels else a
              for lvl, (a, b) in enumerate(zip(za, zb))]
        outs.append(infer.decode_full(zs))
    return outs


def decode_given_z(infer: VAEInference, z_arrays: Sequence) -> Tuple:
    """``vis_given_z_vec``: decode a saved z list (such as an ``np.savez`` of
    a previous run or a latent-opt solve) through 6D -> rotmat -> FK."""
    zs = [torch.as_tensor(z, dtype=torch.float32) for z in z_arrays]
    exp = _zero_z_list(infer.cfg.model, zs[0].shape[0])
    if len(zs) != len(exp) or any(z.shape != e.shape for z, e in zip(zs, exp)):
        raise ValueError(
            f"z list shapes {[tuple(z.shape) for z in zs]} do not match the "
            f"model's {[tuple(e.shape) for e in exp]}")
    return infer.decode_full(zs)

