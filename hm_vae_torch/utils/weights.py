"""Weight bridges into the port's :class:`~hm_vae_torch.models.hm_vae.HMVAE`
and :class:`~hm_vae_torch.models.trajectory.TrajectoryModel`.

- :func:`params_from_flax`: a flax parameter tree of the JAX package (nested
  dicts of numpy arrays) -> the port's ``state_dict``
  (:func:`trajectory_params_from_flax` for the trajectory model).
- :func:`state_dict_from_reference` / :func:`load_reference_checkpoint`: the
  reference implementation's ``gen_*.pt`` checkpoints -> the port's
  ``state_dict``; :func:`reference_state_dict` is the inverse, with the
  constant buffers, which the port's training checkpoints store (so that
  ``hm_vae_tpu.utils.torch_import.import_hmvae_params`` reads them).  The
  key mapping and the checks of the constant buffers
  (conv masks, pool/unpool matrices) are the port's own copy of
  ``hm_vae_tpu.utils.torch_import``; a constant that does not match this
  configuration fails loudly instead of mis-loading.  The trajectory
  model's reference names (``enc.layers.{i}.0.*`` the conv,
  ``enc.layers.{i}.1.weight`` the pool, ``fc_mapping.*``) are those of
  ``import_trajectory_params`` (:func:`trajectory_state_dict_from_reference`,
  :func:`trajectory_reference_state_dict`); the generic functions dispatch
  on ``cfg.model_name``.

The port's names follow the flax tree; Linear weights are (out, in), the
transpose of a flax Dense kernel.  A decoder conv's adapters
(``decoder/conv_*/lora_a``, ``lora_b``, of a model with ``lora_rank`` > 0)
keep their names and layout (``decoder.conv_*.lora_a``, ...), and so they
stand in a reference state dict too, beside the reference names (the
reference has no adapters).

Both parameter layouts (:mod:`~hm_vae_torch.models.param_layout`): a flax
tree of either (``weight`` or ``weight_c`` leaves) gives the state dict of
``cfg.param_layout``; the reference names speak dense, as the reference and
the JAX package's ``torch_import`` do, so a compact model's conv weights are
written dense (dead entries 0) and read back by ``compact_from_dense``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..models.param_layout import convert_state_dict, params_layout
from ..models.structure import get_structure, get_trajectory_structure
from .config import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def params_from_flax(params_np: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Flax ``{'encoder': {...}, 'decoder': {...}}`` (optionally under
    ``'params'``), of either layout -> port state_dict in
    ``cfg.param_layout``."""
    if cfg.model_name == "TrajectoryModel":
        return trajectory_params_from_flax(params_np, cfg)
    tree = params_np.get("params", params_np)
    sd: Dict[str, torch.Tensor] = {}
    for part in ("encoder", "decoder"):
        for name, leaf in tree[part].items():
            if "kernel" in leaf:  # Dense: (in, out) -> Linear (out, in)
                sd[f"{part}.{name}.weight"] = _t(np.asarray(leaf["kernel"]).T)
                sd[f"{part}.{name}.bias"] = _t(leaf["bias"])
            else:
                for k, v in leaf.items():
                    sd[f"{part}.{name}.{k}"] = _t(v)
    return _in_layout(sd, cfg)


def _in_layout(sd: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A state dict of either layout in ``cfg.param_layout``."""
    if params_layout(sd) == cfg.param_layout:
        return sd
    return convert_state_dict(sd, cfg, cfg.param_layout)


def _dense(sd: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Mapping[str, torch.Tensor]:
    return sd if params_layout(sd) == "dense" else convert_state_dict(sd, cfg, "dense")


def trajectory_params_from_flax(params_np: Mapping, cfg: ModelConfig
                                ) -> Dict[str, torch.Tensor]:
    """Flax trajectory tree ``{'encoder': {conv_i: {weight, bias}},
    'fc_mapping': {kernel, bias}}`` (optionally under ``'params'``; a level
    ``weight_c`` in the compact layout) -> port state_dict in
    ``cfg.param_layout``."""
    tree = params_np.get("params", params_np)
    sd = {f"encoder.{name}.{k}": _t(v)
          for name, leaf in tree["encoder"].items() for k, v in leaf.items()}
    sd["fc_mapping.weight"] = _t(np.asarray(tree["fc_mapping"]["kernel"]).T)
    sd["fc_mapping.bias"] = _t(tree["fc_mapping"]["bias"])
    return _in_layout(sd, cfg)


def load_reference_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a reference ``gen_*.pt`` into a flat name -> numpy dict."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def reference_state_dict(sd: Mapping[str, torch.Tensor],
                         cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Port state_dict (either layout) -> the reference ``TwoHierSAVAEModel``
    state dict (f32, on the CPU, dense), with the conv masks and the
    pool/unpool matrices, and a decoder conv's adapters under the port's
    names (the trajectory model's: :func:`trajectory_reference_state_dict`)."""
    sd = _dense(sd, cfg)
    if cfg.model_name == "TrajectoryModel":
        return trajectory_reference_state_dict(sd, cfg)
    st = get_structure(cfg)
    E = cfg.extra_conv
    out: Dict[str, torch.Tensor] = {}

    def put(name, v):
        out[name] = v.detach().float().cpu() if torch.is_tensor(v) else _t(v)

    def conv(dst, src, spec):
        put(f"{dst}.weight", sd[f"{src}.weight"])
        if f"{src}.bias" in sd:
            put(f"{dst}.bias", sd[f"{src}.bias"])
        put(f"{dst}.mask", np.broadcast_to(spec.mask[:, :, None], tuple(sd[f"{src}.weight"].shape)))

    for i, lvl in enumerate(st.encoder_levels):
        for e, espec in enumerate(lvl.extra_convs):
            conv(f"enc.layers.{i}.{e}", f"encoder.conv_{i}_extra_{e}", espec)
        conv(f"enc.layers.{i}.{E}", f"encoder.conv_{i}", lvl.conv)
        put(f"enc.layers.{i}.{E + 1}.weight", lvl.pool_matrix)
        put(f"enc.latent_enc_layers.{i}.weight", sd[f"encoder.latent_head_{i}.weight"])
        put(f"enc.latent_enc_layers.{i}.bias", sd[f"encoder.latent_head_{i}.bias"])
    for i, lvl in enumerate(st.decoder_levels):
        unpool_idx = 1 if lvl.upsample else 0
        for e, espec in enumerate(lvl.extra_convs):
            conv(f"dec.layers.{i}.{unpool_idx + 1 + e}", f"decoder.conv_{i}_extra_{e}", espec)
        conv(f"dec.layers.{i}.{unpool_idx + 1 + E}", f"decoder.conv_{i}", lvl.conv)
        put(f"dec.unpools.{i}.weight", lvl.unpool_matrix)
        put(f"dec.layers.{i}.{unpool_idx}.weight", lvl.unpool_matrix)
        put(f"dec.latent_dec_layers.{i}.weight", sd[f"decoder.latent_dec_{i}.weight"])
        put(f"dec.latent_dec_layers.{i}.bias", sd[f"decoder.latent_dec_{i}.bias"])
    for name in sd:
        if name.startswith("decoder.") and name.endswith((".lora_a", ".lora_b")):
            put(name, sd[name])
    return out


def _check_constant(sd: Mapping[str, np.ndarray], name: str, ours: np.ndarray):
    if name in sd:
        theirs = np.asarray(sd[name])
        if theirs.shape != ours.shape or not np.allclose(theirs, ours, atol=1e-5):
            raise ValueError(
                f"checkpoint constant {name} does not match this config "
                f"(shape {theirs.shape} vs {ours.shape}) — wrong architecture?")


def state_dict_from_reference(sd: Mapping[str, np.ndarray],
                              cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Reference ``TwoHierSAVAEModel`` state dict -> port state_dict in
    ``cfg.param_layout``, with the adapters it holds under the port's names.

    Encoder Sequential: ``[extra_conv x E, conv, pool, leaky]``; decoder
    Sequential: ``[upsample?, unpool, extra_conv x E, conv, leaky?]``.  (The
    trajectory model's: :func:`trajectory_state_dict_from_reference`.)
    """
    if cfg.model_name == "TrajectoryModel":
        return trajectory_state_dict_from_reference(sd, cfg)
    st = get_structure(cfg)
    E = cfg.extra_conv
    out: Dict[str, torch.Tensor] = {}
    for i, lvl in enumerate(st.encoder_levels):
        for e in range(E):
            out[f"encoder.conv_{i}_extra_{e}.weight"] = _t(sd[f"enc.layers.{i}.{e}.weight"])
            out[f"encoder.conv_{i}_extra_{e}.bias"] = _t(sd[f"enc.layers.{i}.{e}.bias"])
        w = _t(sd[f"enc.layers.{i}.{E}.weight"])
        out[f"encoder.conv_{i}.weight"] = w
        if lvl.conv.bias:
            out[f"encoder.conv_{i}.bias"] = _t(sd[f"enc.layers.{i}.{E}.bias"])
        _check_constant(sd, f"enc.layers.{i}.{E}.mask",
                        np.broadcast_to(lvl.conv.mask[:, :, None], tuple(w.shape)))
        _check_constant(sd, f"enc.layers.{i}.{E + 1}.weight", lvl.pool_matrix)
        out[f"encoder.latent_head_{i}.weight"] = _t(sd[f"enc.latent_enc_layers.{i}.weight"])
        out[f"encoder.latent_head_{i}.bias"] = _t(sd[f"enc.latent_enc_layers.{i}.bias"])

    for i, lvl in enumerate(st.decoder_levels):
        unpool_idx = 1 if lvl.upsample else 0
        conv_idx = unpool_idx + 1 + E
        for e in range(E):
            key = f"dec.layers.{i}.{unpool_idx + 1 + e}"
            out[f"decoder.conv_{i}_extra_{e}.weight"] = _t(sd[f"{key}.weight"])
            if lvl.conv.bias:
                out[f"decoder.conv_{i}_extra_{e}.bias"] = _t(sd[f"{key}.bias"])
        out[f"decoder.conv_{i}.weight"] = _t(sd[f"dec.layers.{i}.{conv_idx}.weight"])
        if lvl.conv.bias:
            out[f"decoder.conv_{i}.bias"] = _t(sd[f"dec.layers.{i}.{conv_idx}.bias"])
        _check_constant(sd, f"dec.unpools.{i}.weight", lvl.unpool_matrix)
        out[f"decoder.latent_dec_{i}.weight"] = _t(sd[f"dec.latent_dec_layers.{i}.weight"])
        out[f"decoder.latent_dec_{i}.bias"] = _t(sd[f"dec.latent_dec_layers.{i}.bias"])
    for name in sd:
        if name.startswith("decoder.") and name.endswith((".lora_a", ".lora_b")):
            out[name] = _t(sd[name])
    return _in_layout(out, cfg)


def trajectory_reference_state_dict(sd: Mapping[str, torch.Tensor],
                                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Port trajectory state_dict -> the reference ``TrajectoryModel`` state
    dict (f32, on the CPU): each level's Sequential ``[conv, pool, leaky]``
    with the conv mask and the pool matrix, and ``fc_mapping``; a compact
    level's weight written dense."""
    sd = _dense(sd, cfg)
    st = get_trajectory_structure(cfg)
    out: Dict[str, torch.Tensor] = {}
    for i, lvl in enumerate(st.levels):
        w = sd[f"encoder.conv_{i}.weight"]
        out[f"enc.layers.{i}.0.weight"] = w.detach().float().cpu()
        out[f"enc.layers.{i}.0.bias"] = sd[f"encoder.conv_{i}.bias"].detach().float().cpu()
        out[f"enc.layers.{i}.0.mask"] = _t(np.broadcast_to(lvl.conv.mask[:, :, None],
                                                           tuple(w.shape)))
        out[f"enc.layers.{i}.1.weight"] = _t(lvl.pool_matrix)
    for k in ("weight", "bias"):
        out[f"fc_mapping.{k}"] = sd[f"fc_mapping.{k}"].detach().float().cpu()
    return out


def trajectory_state_dict_from_reference(sd: Mapping[str, np.ndarray],
                                         cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Reference ``TrajectoryModel`` state dict -> port state_dict, the
    conv masks and pool matrices checked against this configuration's."""
    st = get_trajectory_structure(cfg)
    out: Dict[str, torch.Tensor] = {}
    for i, lvl in enumerate(st.levels):
        w = _t(sd[f"enc.layers.{i}.0.weight"])
        out[f"encoder.conv_{i}.weight"] = w
        out[f"encoder.conv_{i}.bias"] = _t(sd[f"enc.layers.{i}.0.bias"])
        _check_constant(sd, f"enc.layers.{i}.0.mask",
                        np.broadcast_to(lvl.conv.mask[:, :, None], tuple(w.shape)))
        _check_constant(sd, f"enc.layers.{i}.1.weight", lvl.pool_matrix)
    out["fc_mapping.weight"] = _t(sd["fc_mapping.weight"])
    out["fc_mapping.bias"] = _t(sd["fc_mapping.bias"])
    return _in_layout(out, cfg)
