"""The port's serving entry points against the JAX package on shared weights:
sliding-window refinement, full decode, the refine_vibe CLI, and the device
rule (CUDA unless the CPU is asked for; never a silent CPU fallback)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hm_vae_tpu.apps import inference as jinf
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.apps import inference as tinf
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

MODEL = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
ATOL = 5e-4


@pytest.fixture(scope="module")
def pair():
    jc, tc = jcfg.Config(model=jcfg.ModelConfig(**MODEL)), tcfg.Config(
        model=tcfg.ModelConfig(**MODEL))
    jm = JHMVAE(jc.model)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24, 6)))
    tm = HMVAE(tc.model)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables["params"]),
                                        tc.model))
    return (jinf.VAEInference(jm, variables, jc),
            tinf.VAEInference(tm, tc, device="cpu"))


def _rand6d(B, T, seed):
    aa = np.random.default_rng(seed).normal(size=(B, T, 72)).astype(np.float32) * 0.3
    six, _, _ = jinf.aa_to_all_reps(jnp.asarray(aa))
    return np.array(six)


def test_refine_sliding_window_matches_jax(pair):
    j, t = pair
    seq = _rand6d(1, 20, 3)[0]
    ref = np.asarray(j.refine_sliding_window(jnp.asarray(seq)))
    ours = t.refine_sliding_window(seq)
    assert ours.shape == (20, 24, 6)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="shorter than window"):
        t.refine_sliding_window(seq[:5])


def test_decode_full_and_mean_z_match_jax(pair):
    j, t = pair
    st = get_structure(t.cfg.model)
    rng = np.random.default_rng(4)
    zs = [rng.normal(size=(3, e, d)).astype(np.float32) for e, d in zip(st.z_edges, st.z_dims)]
    for a, b in zip(j.decode_full([jnp.asarray(z) for z in zs]), t.decode_full(zs)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)
    x = _rand6d(2, 8, 5)
    for a, b in zip(j.mean_z(jnp.asarray(x)), t.mean_z(x)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


def test_prior_samples_clean6d_and_root_helpers(pair):
    _, t = pair
    out6d, outrot, pose = t.prior_samples(3, torch.Generator().manual_seed(2))
    assert out6d.shape == (3, 8, 24, 6) and pose.shape == (3, 8, 24, 3)
    clean = t.clean_6d(out6d)
    np.testing.assert_allclose(np.linalg.norm(clean.numpy().reshape(-1, 2, 3), axis=-1),
                               1.0, atol=1e-5)
    aa = np.random.default_rng(6).normal(size=(2, 5, 72)).astype(np.float32) * 0.4
    jsix, jmats, jpose = jinf.aa_to_all_reps(jnp.asarray(aa))
    six, mats, pose = tinf.aa_to_all_reps(torch.from_numpy(aa))
    for a, b in ((jsix, six), (jmats, mats), (jpose, pose)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)
    adj, rel = tinf.adjust_root_rot(mats)
    jadj, jrel = jinf.adjust_root_rot(jmats)
    np.testing.assert_allclose(adj.numpy(), np.asarray(jadj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(rel.numpy(), np.asarray(jrel), atol=1e-6, rtol=0)


def _cli_setup(tmp_path):
    cfg = dict(MODEL, model_name="TwoHierSAVAEModel", batch_size=4, synthetic=True,
               synthetic_num_seqs=6, data_root=str(tmp_path / "data"))
    cfg_path = tmp_path / "refine.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    npy = tmp_path / "vibe_seq.npy"
    np.save(npy, np.random.default_rng(8).normal(size=(40, 72)).astype(np.float32) * 0.3)
    return str(cfg_path), str(npy)


def test_refine_vibe_cli_writes_the_jax_files(tmp_path):
    from hm_vae_tpu.cli import refine_vibe as jcli
    from hm_vae_torch.cli import refine_vibe as tcli

    cfg_path, npy = _cli_setup(tmp_path)
    common = ["--config", cfg_path, "--vibe_output", npy, "--vibe_order_6d"]
    jcli.main(common + ["--output_path", str(tmp_path / "jax")])
    tcli.main(common + ["--output_path", str(tmp_path / "torch"), "--device", "cpu",
                        "--seed", "3"])
    jdir, tdir = tmp_path / "jax" / "refine_vibe", tmp_path / "torch" / "refine_vibe"
    jfiles = sorted(f for f in os.listdir(jdir) if f.endswith(".npy"))
    assert jfiles == sorted(os.listdir(tdir)) and len(jfiles) == 3
    for f in jfiles:
        a, b = np.load(jdir / f), np.load(tdir / f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.isfinite(b).all(), f
    # the input's own rotations are written unchanged by both
    np.testing.assert_allclose(np.load(tdir / "vibe_seq_vibe_rot_mat.npy"),
                               np.load(jdir / "vibe_seq_vibe_rot_mat.npy"), atol=1e-5)


def test_cuda_is_the_default_and_never_falls_back(tmp_path, monkeypatch):
    from hm_vae_torch.cli import refine_vibe as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path, npy = _cli_setup(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--config", cfg_path, "--vibe_output", npy,
                   "--output_path", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    model = HMVAE(tcfg.ModelConfig(**MODEL))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.VAEInference(model, tcfg.Config(model=model.cfg))
