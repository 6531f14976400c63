"""Model export for serving: ``torch.export`` bundles.

Port of ``hm_vae_tpu.apps.export``.  The serving functions are exported once
with ``torch.export`` into self-contained programs, the trained parameters
baked in as constants, one ``<name>.pt2`` file each:

- ``reconstruct``: rot6d (b, T, 24, 6) -> (rot6d, rotmat, fk positions), the
  posterior-mean reconstruction (encode -> mean z -> decode -> 6D -> rotmat
  -> FK);
- ``encode_mean``: rot6d -> the tuple of per-level posterior means;
- ``decode``: the tuple of per-level z -> (rot6d, rotmat, fk positions)
  (prior samples are client-side N(0, I) z at the deep and shallow levels,
  zeros at the middles);
- ``trajectory``: FK positions (b, t, 24, 3) -> unnormalised root velocity
  (b, t, 3), the dataset mean/std baked in.

Each is the closure that in-process serving runs
(:func:`~hm_vae_torch.apps.inference.make_inference_fns`,
:func:`~hm_vae_torch.models.trajectory.make_root_v_fn`), so an artifact
cannot drift from it.  Every skeleton conv is one node of the registered
operator ``hm_vae_torch::fused_conv_pool`` (the hand-written CUDA kernel on a
CUDA device, its plain version on the CPU), its packed operands lifted
constants of the program: 8 nodes in ``reconstruct``, 4 in ``encode_mean``,
``decode`` and ``trajectory``.  The batch dimension is dynamic (from 1), and
so is the trajectory's time dimension (from ``min_time``).

The serving process needs ``torch`` and the operator's registration, no model
code, config or asset file::

    import hm_vae_torch.ops.fused_conv_pool  # registers the operator
    from hm_vae_torch.apps.export import load_exported  # imports no model code
    fns = load_exported("exported/", device="cuda")
    out6d, rotmat, pose = fns["reconstruct"](batch_rot6d)

A bundle is one ``<name>.pt2`` per function and a ``manifest.json``
recording each function's input and output shapes and dtypes, its dynamic
dimensions and their ranges, its bytes and the seconds its export took, the
operators it needs, the device it was exported on, the serving dtype and the
model config.  A bundle exported
on one device serves on another: :func:`load_exported` moves its constants.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.export import Dim

from ..ops.fused_conv_pool import OP_NAME

MANIFEST_NAME = "manifest.json"
_EXT = ".pt2"


class _Closure(torch.nn.Module):
    """A serving closure as the module ``torch.export`` traces.  The closure
    is a plain attribute, not a submodule: the tensors it reads (packed
    operands, latent heads, FK offsets, stats) become the program's lifted
    constants, and a raw conv weight it never reads is not stored."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, inputs):
        return self.fn(inputs)


def hmvae_export_functions(model, cfg) -> Dict[str, tuple]:
    """``{name: (fn, example args, dynamic shapes)}`` of the HM-VAE's
    serving functions, on ``model``'s device and current weights: the
    closures of :func:`~hm_vae_torch.apps.inference.make_inference_fns`,
    the batch dimension ``b`` dynamic from 1."""
    from ..models.structure import get_structure
    from .inference import make_inference_fns

    dev = next(model.parameters()).device
    T, J = cfg.model.train_seq_len, cfg.model.n_joints
    st = get_structure(cfg.model)
    fns = make_inference_fns(model, cfg)
    b = Dim("b", min=1)
    x = torch.zeros((2, T, J, 6), device=dev)
    zs = tuple(torch.zeros((2, st.z_edges[i], st.z_dims[i]), device=dev)
               for i in range(cfg.model.num_layers))
    return {
        "reconstruct": (fns["reconstruct"], (x,), ({0: b},)),
        "encode_mean": (fns["encode_mean"], (x,), ({0: b},)),
        "decode": (fns["decode_full"], (zs,), (tuple({0: b} for _ in zs),)),
    }


def trajectory_export_function(model, mean_std: np.ndarray, min_time: int = 16) -> tuple:
    """(fn, example args, dynamic shapes) of the trajectory model: the
    closure of :func:`~hm_vae_torch.models.trajectory.make_root_v_fn` on its
    packed operands, batch ``b`` dynamic from 1 and time ``t`` from
    ``min_time`` (the model is fully convolutional; the floor keeps the K-31
    convs' reflect padding valid)."""
    from ..models.trajectory import make_root_v_fn

    dev = next(model.parameters()).device
    fn = make_root_v_fn(model, mean_std, model.conv_operands())
    pose = torch.zeros((2, 2 * min_time, 24, 3), device=dev)
    return fn, (pose,), ({0: Dim("b", min=1), 1: Dim("t", min=min_time)},)


def _bf16_copy(model):
    """A copy of ``model`` computing in bf16 (``compute_dtype``), its
    floating parameters stored in bf16, as the JAX package's
    ``_cast_floating`` casts the parameter tree."""
    cfg = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
    out = type(model)(cfg, generator=torch.Generator().manual_seed(0))
    out.load_state_dict(model.state_dict())
    out.to(next(model.parameters()).device)
    for p in out.parameters():
        p.data = p.data.to(torch.bfloat16)
    return out.eval()


def _export_one(fn, args, dynamic_shapes) -> torch.export.ExportedProgram:
    """``fn`` traced on ``args``.  It runs once on them first: the constant
    tensors that the ops cache on first use (the upsample matrix, the FK
    level indices) must be made as real tensors, not as the tracer's fake
    ones, which the cache would keep."""
    with torch.no_grad():
        fn(*args)
        return torch.export.export(_Closure(fn), args, dynamic_shapes=dynamic_shapes,
                                   strict=False)


def _describe(ep: torch.export.ExportedProgram, args, dynamic_shapes) -> Dict:
    """Shapes and dtypes of the inputs and outputs (a dynamic dimension by
    its name), and each dynamic dimension's range (``null``: unbounded)."""
    names = {}  # symbol -> Dim name, read from the inputs' placeholders
    leaves = torch.utils._pytree.tree_leaves(args)
    dims = torch.utils._pytree.tree_leaves(
        dynamic_shapes, is_leaf=lambda d: isinstance(d, dict))
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"][-len(leaves):]
    for node, spec in zip(placeholders, dims):
        for axis, dim in spec.items():
            names[str(node.meta["val"].shape[axis])] = dim.__name__

    def shape(t):
        return [int(d) if str(d).isdigit() else
                re.sub(r"\b(s\d+)\b", lambda m: names.get(m.group(1), m.group(1)), str(d))
                for d in t.shape]

    def tensors(vals):
        return [{"shape": shape(v), "dtype": str(v.dtype).replace("torch.", "")} for v in vals]

    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in torch.utils._pytree.tree_leaves(out_node.args[0])]
    ranges = {}
    for sym, vr in ep.range_constraints.items():
        if str(sym) in names:
            hi = vr.upper  # int_oo where unbounded
            ranges[names[str(sym)]] = [int(vr.lower), None if hi > sys.maxsize else int(hi)]
    return {"inputs": tensors(p.meta["val"] for p in placeholders), "outputs": tensors(outs),
            "dynamic_dims": ranges}


def export_bundle(out_dir: str, model, cfg, trajectory: Optional[tuple] = None,
                  serve_dtype: str = "float32") -> Dict:
    """Export the serving functions of ``model`` (an ``HMVAE``, on the device
    to export on) to ``out_dir``; returns the manifest.

    ``trajectory``: optional ``(trajectory model, mean_std)`` adds the
    root-trajectory predictor.  ``serve_dtype="bfloat16"``: every floating
    parameter stored in bf16 and the convs computing in bf16 (the packed
    tiles are a quarter of f32's two TF32 planes); inputs, outputs, the
    latent heads and the rotation and FK chain stay f32.
    """
    if serve_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported serve_dtype: {serve_dtype}")
    os.makedirs(out_dir, exist_ok=True)
    if serve_dtype == "bfloat16":
        model = _bf16_copy(model)
        cfg = dataclasses.replace(cfg, model=model.cfg)
    table = hmvae_export_functions(model, cfg)
    if trajectory is not None:
        t_model, mean_std = trajectory
        if serve_dtype == "bfloat16":
            t_model = _bf16_copy(t_model)
        table["trajectory"] = trajectory_export_function(t_model, mean_std)

    manifest: Dict = {
        "format": "torch.export",
        "torch_version": torch.__version__,
        "device": str(next(model.parameters()).device),
        "serve_dtype": serve_dtype,
        "ops": [OP_NAME],
        "functions": {},
        "config": dataclasses.asdict(cfg.model),
        "train_seq_len": cfg.model.train_seq_len,
    }
    for name, (fn, args, dyn) in table.items():
        t0 = time.perf_counter()
        ep = _export_one(fn, args, dyn)
        path = os.path.join(out_dir, name + _EXT)
        torch.export.save(ep, path)
        manifest["functions"][name] = dict(_describe(ep, args, dyn),
                                           bytes=os.path.getsize(path),
                                           seconds=time.perf_counter() - t0)
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def load_exported(out_dir: str, device=None) -> Dict[str, torch.nn.Module]:
    """Every function of a bundle as a callable module, keyed as in the
    manifest; with ``device``, its constants moved there first
    (``move_to_device_pass``), so that a bundle exported on the CPU serves
    on a GPU and back."""
    from torch.export.passes import move_to_device_pass

    with open(os.path.join(out_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    fns = {}
    for name in manifest["functions"]:
        ep = torch.export.load(os.path.join(out_dir, name + _EXT))
        if device is not None:
            ep = move_to_device_pass(ep, torch.device(device))
        fns[name] = ep.module()
    return fns
