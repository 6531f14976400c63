"""The port's serving export (``hm_vae_torch/apps/export.py``) against the JAX
package's (``hm_vae_tpu/apps/export.py``), on the CPU at the small widths of
``tests/test_export.py``, from the same weights: the registered operator
``hm_vae_torch::fused_conv_pool`` (``torch.library.opcheck``), the f32 and
bf16 bundles against the JAX bundles, the graphs' operator nodes and lifted
constants, the manifest, loading without the port's model code, the export
CLI, and ``apply_root_rot_to_translation``."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hm_vae_tpu.apps import export as jexport
from hm_vae_tpu.apps import inference as jinference
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.models.trajectory import TrajectoryModel as JTrajectoryModel
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.apps import export as texport
from hm_vae_torch.apps import inference as tinference
from hm_vae_torch.apps.inference import VAEInference
from hm_vae_torch.data import layout
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.models.trajectory import TrajectoryModel, TrajectoryRunner
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.ops import rotations as rot
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax, reference_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
TRAJ = dict(model_name="TrajectoryModel", latent_d=12, kernel_size=7, train_seq_len=32,
            trajectory_input_joint_pos=True)
OP = torch.ops.hm_vae_torch.fused_conv_pool.default


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mean_std():
    rng = np.random.default_rng(3)
    ms = np.zeros((2, layout.FRAME_DIM), np.float32)
    ms[0] = rng.normal(size=layout.FRAME_DIM) * 0.1
    ms[1] = 1.0 + 0.2 * rng.random(layout.FRAME_DIM)
    return ms


def _rand6d(seed, B, T=8):
    aa = torch.from_numpy(np.random.default_rng(seed).normal(size=(B, T, 24, 3)) * 0.3)
    return rot.rotmat_to_rot6d(rot.aa_to_rotmat(aa.float())).numpy()


def _close(got, want, tol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def models():
    """The JAX models and parameters, and the port's on the same weights."""
    jc = jcfg.Config(model=jcfg.ModelConfig(**VAE))
    jtc = jcfg.ModelConfig(**TRAJ)
    jm, jtm = JHMVAE(jc.model), JTrajectoryModel(jtc)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24, 6)))
    jtp = jtm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 24, 3)))
    tc = tcfg.Config(model=tcfg.ModelConfig(**VAE))
    ttc = tcfg.ModelConfig(**TRAJ)
    tm, ttm = HMVAE(tc.model), TrajectoryModel(ttc)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jp), tc.model))
    ttm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtp), ttc))
    return {"jax": (jm, jp, jc, jtm, jtp), "port": (tm.eval(), tc, ttm.eval())}


def _write_yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def bundles(models, tmp_path_factory):
    """{(side, dtype): (functions, manifest[, directory])}: each side's
    bundle, exported on the CPU, in f32 with the trajectory and in bf16.
    The port's f32 bundle is the export CLI's, on gen_*.pt files of the
    weights (its printed summary under "cli")."""
    from hm_vae_torch.cli.export_model import main

    jm, jp, jc, jtm, jtp = models["jax"]
    tm, tc, ttm = models["port"]
    ms, out = _mean_std(), {}
    tmp = tmp_path_factory.mktemp("inputs")
    ck, tck, ms_path = (str(tmp / n) for n in ("gen_1.pt", "gen_traj_1.pt", "ms.npy"))
    torch.save({"state_dict": reference_state_dict(tm.state_dict(), tc.model)}, ck)
    torch.save({"state_dict": reference_state_dict(ttm.state_dict(), ttm.cfg)}, tck)
    np.save(ms_path, ms)
    cli = ["--config", _write_yaml(str(tmp / "vae.yaml"), {"model_name": "TwoHierSAVAEModel",
                                                              **VAE}),
           "--test_model", ck, "--trajectory_test_model", tck, "--mean_std", ms_path,
           "--trajectory_config", _write_yaml(str(tmp / "traj.yaml"), TRAJ), "--device", "cpu"]
    for dtype in ("float32", "bfloat16"):
        f32 = dtype == "float32"
        d = str(tmp_path_factory.mktemp(f"jax_{dtype}"))
        man = jexport.export_bundle(d, jm, jp, jc, trajectory=(jtm, jtp, ms) if f32 else None,
                                    platforms=("cpu",), serve_dtype=dtype)
        fns = jexport.load_exported(d)
        out[("jax", dtype)] = ({k: f.call for k, f in fns.items()}, man)
        d = str(tmp_path_factory.mktemp(f"port_{dtype}"))
        if f32:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                main(cli + ["--out", d])
            out["cli"] = (printed.getvalue(), cli)
            with open(os.path.join(d, texport.MANIFEST_NAME)) as f:
                man = json.load(f)
        else:
            man = texport.export_bundle(d, tm, tc, serve_dtype=dtype)
        out[("port", dtype)] = (texport.load_exported(d), man, d)
    return out


def _packed_level(dtype, where):
    """One level's packed operands of the port model: encoder conv_0 (the
    skeleton pool folded in) or decoder conv_3 (no pool)."""
    cfg = tcfg.ModelConfig(**VAE, compute_dtype=dtype)
    model = HMVAE(cfg, generator=torch.Generator().manual_seed(0))
    conv = model.encoder.conv_0 if where == "pooled" else model.decoder.conv_3
    return conv, conv.packed_operands()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["pooled", "unpooled"])
def test_operator_passes_opcheck(where, dtype):
    conv, p = _packed_level(dtype, where)
    assert (conv.pool is not None) == (where == "pooled")
    x = torch.randn((3, p.in_channels, 8), generator=torch.Generator().manual_seed(1))
    args = (x.to(p.dtype), p.tiles, p.bias, p.tile_start, p.tile_chunk, p.live_index,
            p.in_channels, p.kernel_size, p.rows, p.stride, p.padding, p.reflect,
            p.negative_slope, p.max_live)
    torch.library.opcheck(OP, args)
    # the operator is the packed entry, and its CPU form the plain version
    fcp.fused_conv_pool.launches = 0
    w, b = fcp.unpack_level(p)
    want = fcp.fused_conv_pool_reference(args[0], w, b, None, None, p.stride, p.padding,
                                         "reflect" if p.reflect else "constant",
                                         p.negative_slope)
    assert torch.equal(OP(*args), want)
    assert torch.equal(fcp.fused_conv_pool_packed(args[0], p), want)
    assert fcp.fused_conv_pool.launches == 0


def test_operator_checks_the_operands_before_a_launch():
    """The CUDA implementation's checks (they run before the kernel is built):
    a windowed packing takes one bias per window, and the tiles must be the
    packing's."""
    conv, p = _packed_level("float32", "unpooled")
    G = 3
    s = conv.structure()
    w, b = conv.folded_weight()
    win = fcp.repack(s, w.detach().expand(G, *w.shape).contiguous(), None)
    x = torch.zeros((G, p.in_channels, 8))
    args = (win.tile_start, win.tile_chunk, win.live_index, p.in_channels, p.kernel_size,
            p.rows, p.stride, p.padding, p.reflect, p.negative_slope, p.max_live)
    with pytest.raises(ValueError, match="bias must be .* of 3 x"):
        fcp._op_cuda(x, win.tiles, p.bias, *args)  # one window's bias
    with pytest.raises(ValueError, match="contiguous tiles"):
        fcp._op_cuda(x, win.tiles[:, :-1], win.bias, *args)
    with pytest.raises(RuntimeError, match="nvcc|CUDA"):  # no bias: a zero one a window
        fcp._op_cuda(x, win.tiles, None, *args)  # passes the checks, then needs the card
    assert fcp.fused_conv_pool_windowed.launches == 0


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name", ["reconstruct", "encode_mean", "decode"])
def test_f32_bundle_matches_jax_bundle(bundles, name, batch):
    jfns, ours = bundles[("jax", "float32")][0], bundles[("port", "float32")][0]
    if name == "decode":
        st = get_structure(tcfg.ModelConfig(**VAE))
        rng = np.random.default_rng(batch)
        zs = tuple(rng.normal(size=(batch, st.z_edges[i], st.z_dims[i])).astype(np.float32)
                   for i in range(len(st.z_edges)))
        want = jfns[name](tuple(jnp.asarray(z) for z in zs))
        got = ours[name](tuple(torch.from_numpy(z) for z in zs))
    else:
        x = _rand6d(batch, batch)
        want, got = jfns[name](jnp.asarray(x)), ours[name](torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    _close([g.numpy() for g in got], want, 1e-4)


@pytest.mark.parametrize("batch,T", [(1, 32), (2, 100)])
def test_trajectory_bundle_matches_jax_bundle(bundles, batch, T):
    pose = np.random.default_rng(T).normal(size=(batch, T, 24, 3)).astype(np.float32)
    want = bundles[("jax", "float32")][0]["trajectory"](jnp.asarray(pose))
    got = bundles[("port", "float32")][0]["trajectory"](torch.from_numpy(pose))
    assert got.shape == (batch, T, 3)
    _close(got.numpy(), want, 1e-4)


def test_bf16_bundle_matches_jax_bf16_bundle_and_is_smaller(bundles):
    jfns = bundles[("jax", "bfloat16")][0]
    ours, man = bundles[("port", "bfloat16")][:2]
    f32 = bundles[("port", "float32")][1]
    assert man["serve_dtype"] == "bfloat16" and man["config"]["compute_dtype"] == "bfloat16"
    for name, info in man["functions"].items():
        assert info["bytes"] < 0.8 * f32["functions"][name]["bytes"], name
    x = _rand6d(11, 2)
    got = ours["reconstruct"](torch.from_numpy(x))
    assert all(g.dtype == torch.float32 for g in got)  # outputs stay f32
    _close([g.numpy() for g in got], jfns["reconstruct"](jnp.asarray(x)), 0.05)


def test_graphs_hold_one_operator_node_per_level_on_lifted_constants(bundles, models):
    fns, man, d = bundles[("port", "float32")]
    assert {k: sum(n.target is OP for n in f.graph.nodes) for k, f in fns.items()} == {
        "reconstruct": 8, "encode_mean": 4, "decode": 4, "trajectory": 4}
    ep = torch.export.load(os.path.join(d, "reconstruct.pt2"))
    consts = [ep.constants[s.target] for s in ep.graph_signature.input_specs
              if s.kind == torch.export.graph_signature.InputKind.CONSTANT_TENSOR]
    tm = models["port"][0]
    for packed in tm.conv_operands().values():  # every level's tiles, as values
        assert any(c.shape == packed.tiles.shape and torch.equal(c, packed.tiles)
                   for c in consts)
    assert not ep.state_dict  # no parameter: the raw conv weights are not stored
    assert man["format"] == "torch.export" and man["ops"] == [fcp.OP_NAME]
    assert man["device"] == "cpu" and man["train_seq_len"] == 8
    rec = man["functions"]["reconstruct"]
    assert rec["inputs"] == [{"shape": ["b", 8, 24, 6], "dtype": "float32"}]
    assert rec["outputs"][1] == {"shape": ["b", 8, 24, 3, 3], "dtype": "float32"}
    assert rec["dynamic_dims"] == {"b": [1, None]} and rec["bytes"] > 0
    traj = man["functions"]["trajectory"]
    assert traj["inputs"][0]["shape"] == ["b", "t", 24, 3]
    assert traj["outputs"] == [{"shape": ["b", "t", 3], "dtype": "float32"}]
    assert traj["dynamic_dims"] == {"b": [1, None], "t": [16, None]}
    with open(os.path.join(d, texport.MANIFEST_NAME)) as f:
        assert json.load(f) == json.loads(json.dumps(man))


def test_bundle_moves_to_another_device(bundles):
    """``load_exported(device=...)`` moves the constants (here to ``meta``,
    which runs the operator's shape function: no card on this machine)."""
    fns = texport.load_exported(bundles[("port", "float32")][2], device="meta")
    out = fns["reconstruct"](torch.zeros((5, 8, 24, 6), device="meta"))
    assert [o.device.type for o in out] == ["meta"] * 3
    assert tuple(out[2].shape) == (5, 8, 24, 3)
    assert tuple(fns["trajectory"](torch.zeros((1, 300, 24, 3), device="meta")).shape) == (
        1, 300, 3)


BLOCKED_LOAD = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "hm_vae_tpu") or name.startswith(
                ("hm_vae_torch.models", "hm_vae_torch.train", "hm_vae_torch.utils.config")):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import numpy as np, torch
import hm_vae_torch.ops.fused_conv_pool
from hm_vae_torch.apps.export import load_exported
fns = load_exported(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2]))
np.save(sys.argv[3], fns["reconstruct"](x)[2].numpy())
np.save(sys.argv[4], fns["trajectory"](torch.zeros((1, 20, 24, 3))).numpy())
"""


def test_bundle_loads_without_the_model_code(bundles, models, tmp_path):
    x = _rand6d(4, 1)
    paths = [str(tmp_path / n) for n in ("x.npy", "pose.npy", "traj.npy")]
    np.save(paths[0], x)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", BLOCKED_LOAD, bundles[("port", "float32")][2],
                          *paths], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    tm, tc, _ = models["port"]
    want = VAEInference(tm, tc, device="cpu").mean_reconstruction(x)[2]
    np.testing.assert_array_equal(np.load(paths[1]), want.numpy())
    assert np.load(paths[2]).shape == (1, 20, 3)


def test_export_cli_end_to_end(bundles, models, tmp_path):
    """``cli/export_model.py`` (it made the f32 bundle from gen_*.pt files
    of the weights): its one-line summary, and the bundle serves those
    weights; without --device it runs on CUDA, and raises here."""
    from hm_vae_torch.cli.export_model import main

    printed, cli = bundles["cli"]
    fns, man, d = bundles[("port", "float32")]
    summary = json.loads(printed.strip().splitlines()[-1])
    assert summary == {"out": d, "functions": {k: v["bytes"] for k, v in man["functions"].items()},
                       "device": "cpu", "serve_dtype": "float32"}
    assert set(fns) == {"reconstruct", "encode_mean", "decode", "trajectory"}
    tm, tc, ttm = models["port"]
    x = _rand6d(9, 2)
    want = VAEInference(tm, tc, device="cpu").mean_reconstruction(x)
    for g, w in zip(fns["reconstruct"](torch.from_numpy(x)), want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    pose = torch.randn((1, 16, 24, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(fns["trajectory"](pose),
                                   TrajectoryRunner(ttm, _mean_std())._predict(pose))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(cli[:2] + ["--out", str(tmp_path / "none")])


def test_apply_root_rot_to_translation_matches_jax():
    rng = np.random.default_rng(0)
    aa = torch.from_numpy(rng.normal(size=(2, 5, 24, 3)).astype(np.float32))
    mats = rot.aa_to_rotmat(aa)
    _, rel = tinference.adjust_root_rot(mats)
    v = rng.normal(size=(2, 5, 3)).astype(np.float32)
    got = tinference.apply_root_rot_to_translation(rel, torch.from_numpy(v))
    want = jinference.apply_root_rot_to_translation(jnp.asarray(rel.numpy()), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
