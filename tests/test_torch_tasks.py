"""The port's latent-optimization applications (``hm_vae_torch.apps.tasks``),
metrics, baselines, evaluation dataset and ``eval_recovery`` CLI on the CPU,
against the JAX package's.

Every ``LatentOptApps`` method runs on both packages from the same weights
and sequences, with both packages' ``init_z`` replaced (here, in the test) by
the same numpy draws, at a small lr and an ``opt_it`` that crosses both
phase switches.  Outputs agree within 1e-4 (f32 sums in another order over a
few Adam steps; rotations of random-weight outputs amplify 6D differences),
masks exactly.  Metrics and baselines: 1e-5 relative.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import hm_vae_tpu.apps.tasks as jtasks
import hm_vae_torch.apps.tasks as ttasks
from hm_vae_tpu.apps import baselines as jbase
from hm_vae_tpu.apps import metrics as jmet
from hm_vae_tpu.data.dataset import EvalMotionDataset as JEval
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.apps import baselines as tbase
from hm_vae_torch.apps import metrics as tmet
from hm_vae_torch.cli import eval_recovery
from hm_vae_torch.cli import train as train_cli
from hm_vae_torch.data import synthetic
from hm_vae_torch.data.dataset import EvalMotionDataset
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
LAT = dict(opt_it=4, opt_lr=1e-3, opt_step_size=2, prev_epochs=1, prev_epochs_completion=2,
           reg_w=0.0, reg_w_decoder=1000.0, interpolation_window=3)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_APPS = {}


def _apps():
    """The JAX and the port's LatentOptApps on the same len-8 weights."""
    if not _APPS:
        jc = jcfg.Config(model=jcfg.ModelConfig(**LEN8), latent_opt=jcfg.LatentOptConfig(**LAT))
        tc = tcfg.Config(model=tcfg.ModelConfig(**LEN8), latent_opt=tcfg.LatentOptConfig(**LAT))
        jm = JHMVAE(jc.model)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24, 6)))
        tm = HMVAE(tc.model)
        tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tc.model),
                           strict=False)
        _APPS.update(jax=jtasks.LatentOptApps(jm, params, jc), port=ttasks.LatentOptApps(tm, tc),
                     st=get_structure(tc.model))
    return _APPS


@pytest.fixture
def same_z(monkeypatch):
    """Both packages' init_z draw the same numpy z, call by call."""
    st = _apps()["st"]

    def draws(wrap):
        rng = np.random.default_rng(11)

        def init_z(_key, cfg, batch):
            return [wrap(rng.normal(size=(batch, st.z_edges[i], st.z_dims[i])).astype(np.float32)
                         if i in (0, 3) else np.zeros((batch, st.z_edges[i], st.z_dims[i]),
                                                      np.float32)) for i in range(4)]
        return init_z

    monkeypatch.setattr(jtasks, "init_z", draws(jnp.asarray))
    monkeypatch.setattr(ttasks, "init_z", draws(torch.from_numpy))


def _seq(T, seed):
    rng = np.random.default_rng(seed)
    aa = np.cumsum(rng.normal(scale=0.05, size=(T, 24, 3)), axis=0) + rng.normal(
        scale=0.3, size=(1, 24, 3))
    return R.from_rotvec(aa.reshape(-1, 3)).as_matrix().astype(np.float32).reshape(T, 24, 3, 3)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _same(ours, ref, what=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), what
        for k in ref:
            _same(ours[k], ref[k], f"{what}.{k}")
        return
    if isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), what
        for i, (o, r) in enumerate(zip(ours, ref)):
            _same(o, r, f"{what}[{i}]")
        return
    o, r = _np(ours), np.asarray(ref)
    assert o.shape == r.shape, (what, o.shape, r.shape)
    np.testing.assert_allclose(o, r, atol=TOL, rtol=0, err_msg=what)


def test_masks_are_exact():
    for T, k in ((8, 3), (64, 5), (10, 4)):
        assert np.array_equal(ttasks.interpolation_mask(T, k), jtasks.interpolation_mask(T, k))
    for part in ("upper", "lower"):
        assert np.array_equal(ttasks.completion_joint_mask(part),
                              jtasks.completion_joint_mask(part))


def test_targets_from_rotmat():
    m = _seq(8, 1)[None]
    _same(ttasks._targets_from_rotmat(torch.from_numpy(m)), jtasks._targets_from_rotmat(m))
    _same(ttasks._targets_from_rotmat_np(m), jtasks._targets_from_rotmat_np(m))


@pytest.mark.parametrize("restarts", [1, 2])
def test_interpolate(same_z, restarts):
    a, seq = _apps(), _seq(19, 2)  # two windows and a dropped tail
    ref = a["jax"].interpolate(seq, jax.random.PRNGKey(0), restarts=restarts)
    ours = a["port"].interpolate(seq, torch.Generator(), restarts=restarts)
    _same(ours, ref, "interpolate")


def test_interpolate_many(same_z):
    a = _apps()
    seqs = [_seq(8, 3), _seq(17, 4)]
    ref = a["jax"].interpolate_many(seqs, jax.random.PRNGKey(0), pad_to_multiple=4)
    ours = a["port"].interpolate_many(seqs, torch.Generator(), pad_to_multiple=4)
    _same(ours, ref, "interpolate_many")


def test_single_window_tasks(same_z):
    a = _apps()
    wins = np.stack([_seq(8, 5), _seq(8, 6)])
    masks = (np.random.default_rng(0).random((2, 8, 24)) > 0.3).astype(np.float32)
    _same(a["port"].interpolate_single_window(wins, torch.Generator()),
          a["jax"].interpolate_single_window(wins, jax.random.PRNGKey(0)), "interp_sw")
    _same(a["port"].complete_single_window(wins, masks, torch.Generator()),
          a["jax"].complete_single_window(wins, masks, jax.random.PRNGKey(0)), "complete_sw")


def test_complete_and_complete_many(same_z):
    a = _apps()
    seq, seq2 = _seq(16, 7), _seq(9, 8)  # windows at 0, 7 (and 14 dropped); one window
    _same(a["port"].complete(seq, torch.Generator(), missing="lower"),
          a["jax"].complete(seq, jax.random.PRNGKey(0), missing="lower"), "complete")
    _same(a["port"].complete_many([seq, seq2], torch.Generator(), missing="upper"),
          a["jax"].complete_many([seq, seq2], jax.random.PRNGKey(0), missing="upper"),
          "complete_many")


def test_generate_and_generate_many(same_z):
    a = _apps()
    seed, seed2 = _seq(8, 9), _seq(8, 10)
    _same(a["port"].generate(seed, torch.Generator(), num_windows=2, overlap=3),
          a["jax"].generate(jnp.asarray(seed), jax.random.PRNGKey(0), num_windows=2, overlap=3),
          "generate")
    _same(a["port"].generate_many([seed, seed2], torch.Generator(), num_windows=2, overlap=3),
          a["jax"].generate_many([seed, seed2], jax.random.PRNGKey(0), num_windows=2,
                                 overlap=3), "generate_many")


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    p, g = (rng.normal(size=(4, 24, 3)).astype(np.float32) for _ in range(2))
    tr, tg = (rng.normal(size=(2, 10, 3)).astype(np.float32) for _ in range(2))
    for name, args in (("mpjpe", (p, g)), ("pa_mpjpe", (p, g)), ("accel", (p,)),
                       ("accel_error", (p, g)), ("trajectory_ade", (tr, tg)),
                       ("trajectory_fde", (tr, tg))):
        ours = float(getattr(tmet, name)(*(torch.from_numpy(x) for x in args)))
        ref = float(getattr(jmet, name)(*(jnp.asarray(x) for x in args)))
        np.testing.assert_allclose(ours, ref, rtol=1e-5, err_msg=name)
    # a similarity transform of gt is aligned away
    rot = R.random(random_state=1).as_matrix().astype(np.float32)
    assert float(tmet.pa_mpjpe(torch.from_numpy(2.0 * g @ rot.T + 0.5), torch.from_numpy(g))) \
        < 1e-5


def test_baselines_match_jax():
    rot = _seq(12, 3)
    mask = ttasks.interpolation_mask(12, 5)
    np.testing.assert_allclose(tbase.slerp_rotations(rot, mask),
                               jbase.slerp_rotations(rot, mask), atol=1e-6)
    trans = np.random.default_rng(0).normal(size=(12, 3)).astype(np.float32)
    assert np.array_equal(tbase.lerp_root_trajectory(trans, mask),
                          jbase.lerp_root_trajectory(trans, mask))


def test_eval_dataset_matches_jax(tmp_path):
    d = str(tmp_path)
    synthetic.generate_dataset(d, num_seqs=4, min_len=20, max_len=30, seed=0)
    mask_dir = os.path.join(d, "masks")
    os.makedirs(mask_dir)
    idx = os.path.join(d, "test.json")
    with open(idx) as f:
        names = list(json.load(f).values())
    for n in names:
        np.save(os.path.join(mask_dir, n), np.ones((40, 24), np.float32) * 0.5)
    seq_dir = os.path.join(d, "seqs")
    for kw in (dict(), dict(missing="random", missing_joint_prob=0.3, seed=5),
               dict(missing="upper"), dict(missing="lower"), dict(mask_dir=mask_dir)):
        ours, ref = EvalMotionDataset(seq_dir, idx, **kw), JEval(seq_dir, idx, **kw)
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert a.keys() == b.keys() and a["name"] == b["name"]
            for k in a:
                if k != "name":
                    assert np.array_equal(a[k], b[k]), (kw, k)


def _cli_config(tmp):
    """The len-8 smoke config at len 16 (so that generation's 10-frame
    overlap fits a window), with a short solve."""
    text = open(os.path.join(ROOT, "configs", "len8_smoke.yaml")).read()
    text = text.replace("train_seq_len: 8", "train_seq_len: 16")
    path = os.path.join(tmp, "len16_eval.yaml")
    with open(path, "w") as f:
        f.write(text + "opt_it: 3\nprev_epochs: 1\nprev_epochs_completion: 1\n"
                       "synthetic_num_seqs: 10\n")
    return path


def test_eval_recovery_cli_runs_every_task(tmp_path, capsys):
    """A checkpoint written by the port's training CLI, then each task of
    eval_recovery on the synthetic test split: per-sequence outputs and a
    summary."""
    tmp = str(tmp_path)
    cfg = _cli_config(tmp)
    data = os.path.join(tmp, "data")
    train_cli.main(["--config", cfg, "--output_path", tmp, "--data_root", data,
                    "--device", "cpu", "--max_iter", "2"])
    ck = os.path.join(tmp, "outputs", "len16_eval", "checkpoints", "gen_00000002.pt")
    base = ["--config", cfg, "--output_path", tmp, "--data_root", data, "--device", "cpu",
            "--test_model", ck, "--max_seqs", "1"]
    for flag, out, extra in (
            ("--final_try_long_seq_interpolation", "eval_long_seq_interpolation", []),
            ("--final_try_long_seq_interpolation", "eval_long_seq_interpolation",
             ["--batch_across_seqs", "--shared_decoder_clone", "--finetune_scope", "heads"]),
            ("--final_motion_completion_long_seq", "eval_long_seq_completion", []),
            ("--try_final_long_seq_generation", "eval_long_seq_generation", []),
            ("--final_motion_completion", "eval_completion_single_window", []),
            ("--test_model_rec", "eval_reconstruction", [])):
        d = os.path.join(tmp, out, "len16_eval")
        shutil.rmtree(d, ignore_errors=True)
        eval_recovery.main(base + [flag] + extra)
        files = sorted(os.listdir(d))
        assert "summary.json" in files, (flag, files)
        res = [f for f in files if f.endswith("_rot_opt_res.npy")]
        assert len(res) == 1, (flag, files)
        rot = np.load(os.path.join(d, res[0]))
        assert rot.ndim == 4 and rot.shape[1:] == (24, 3, 3) and np.isfinite(rot).all()
        with open(os.path.join(d, "summary.json")) as f:
            summary = json.load(f)
        assert summary["num_seqs"] == 1
    assert "summary:" in capsys.readouterr().out


_PRODUCTION_KEYS = ("compact_transfer: true\nwire_format: aa\ntransfer_dtype: float16\n"
                    "moment_dtype: bfloat16\nparam_dtype: bfloat16\nsteps_per_call: 32\n"
                    "async_checkpoint: true\nopt_param_dtype: bfloat16\n"
                    "opt_moment_dtype: bfloat16\n")


@pytest.mark.parametrize("extra,config_tail,want", [
    (["--finetune_scope", "lora", "--lora_rank", "2", "--lora_lr_mult", "5"], "",
     dict(finetune_scope="lora", lora_rank=2, lora_lr_mult=5.0)),
    (["--opt_param_dtype", "bfloat16", "--opt_moment_dtype", "bfloat16",
      "--shared_decoder_clone"], "",
     dict(opt_param_dtype="bfloat16", opt_moment_dtype="bfloat16", per_window_decoder=False)),
    ([], _PRODUCTION_KEYS,
     dict(opt_param_dtype="bfloat16", opt_moment_dtype="bfloat16", finetune_scope="full")),
], ids=["lora", "bf16_clone", "production_keys"])
def test_eval_recovery_cli_solver_modes(tmp_path, monkeypatch, extra, config_tail, want):
    """The solver-mode flags reach the solver (and LatentOptApps passes them
    on untouched), and a config with the production config's training
    execution keys evaluates: an f32 model, its solver's bf16 clone and
    moments, per-sequence outputs and a summary."""
    tmp = str(tmp_path)
    cfg = _cli_config(tmp)
    data = os.path.join(tmp, "data")
    train_cli.main(["--config", cfg, "--output_path", tmp, "--data_root", data,
                    "--device", "cpu", "--max_iter", "2"])
    ck = os.path.join(tmp, "outputs", "len16_eval", "checkpoints", "gen_00000002.pt")
    with open(cfg, "a") as f:
        f.write(config_tail)
    seen = []
    real = ttasks.make_latent_optimizer

    def spy(model, cfg, lat=None, **kw):
        seen.append((lat or cfg.latent_opt, next(model.parameters()).dtype))
        return real(model, cfg, lat=lat, **kw)

    monkeypatch.setattr(ttasks, "make_latent_optimizer", spy)
    eval_recovery.main(["--config", cfg, "--output_path", tmp, "--data_root", data,
                        "--device", "cpu", "--test_model", ck, "--max_seqs", "1",
                        "--final_try_long_seq_interpolation"] + extra)
    assert seen and all(dt == torch.float32 for _, dt in seen)
    for lat, _ in seen:
        assert {k: getattr(lat, k) for k in want} == want
    d = os.path.join(tmp, "eval_long_seq_interpolation", "len16_eval")
    files = sorted(os.listdir(d))
    res = [f for f in files if f.endswith("_rot_opt_res.npy")]
    assert "summary.json" in files and len(res) == 1, files
    assert np.isfinite(np.load(os.path.join(d, res[0]))).all()


@pytest.mark.parametrize("extra,match", [
    (["--final_try_long_seq_interpolation", "--data_parallel", "2"], "item 11"),
])
def test_eval_recovery_unported_flags_raise(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        eval_recovery.main(["--config", os.path.join(ROOT, "configs", "len8_smoke.yaml"),
                            "--output_path", str(tmp_path), "--device", "cpu"] + extra)


def test_eval_recovery_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_recovery.main(["--config", os.path.join(ROOT, "configs", "len8_smoke.yaml"),
                            "--output_path", str(tmp_path), "--final_try_long_seq_interpolation"])
