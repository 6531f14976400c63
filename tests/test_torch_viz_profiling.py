"""The port's visualization (``hm_vae_torch.utils.viz``) and profiling
(``hm_vae_torch.utils.profiling``) helpers, on the CPU:

- ``save_frame``, ``save_skeleton_obj`` and ``save_animation`` write the JAX
  package's files, byte for byte (the same drawing code and matplotlib);
  ``save_mesh_obj`` through ``HM_VAE_SMPL_MODEL`` the JAX package's meshes
  (vertices within 1e-5 + the 6 printed digits, faces equal);
- ``--gen_vis`` through ``refine_vibe``, ``eval_recovery`` (with and without
  a trajectory model), ``eval_trajectory`` and ``explore_latent`` writes an
  animation beside each saved result;
- the Trainer saves its two animations every ``image_save_iter`` steps of a
  VAE run, and none for the trajectory model, and keeps training mode;
- ``Timer``, ``time_fn`` and ``trace`` behave as ``tests/test_profiling.py``
  checks the JAX ones (``trace`` writes a Chrome trace here).

This machine has no ffmpeg, so the animations are gifs (pillow).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation as R

from hm_vae_tpu.utils import smpl as jsmpl
from hm_vae_tpu.utils import viz as jviz
from hm_vae_torch.cli import eval_recovery, eval_trajectory, explore_latent, refine_vibe
from hm_vae_torch.cli import train as train_cli
from hm_vae_torch.utils import profiling, viz

J = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose(seed, shape=(J, 3)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("what", ["frame", "frame_mask", "skeleton_obj", "animation"])
def test_drawing_writes_the_jax_files(tmp_path, what):
    outs = []
    for side, mod in (("jax", jviz), ("port", viz)):
        d = str(tmp_path / side)
        if what.startswith("frame"):
            mask = (np.arange(J) % 3 > 0).astype(np.float32) if what == "frame_mask" else None
            p = mod.save_frame(_pose(0), os.path.join(d, "f.png"), mask=mask)
        elif what == "skeleton_obj":
            p = mod.save_skeleton_obj(_pose(1), os.path.join(d, "s.obj"))
        else:
            p = mod.save_animation(_pose(2, (2, 3, J, 3)), os.path.join(d, "a.mp4"), fps=3,
                                   mask=np.ones((3, J)))
        outs.append(p)
    assert os.path.basename(outs[0]) == os.path.basename(outs[1])
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        data = b.read()
        assert len(data) > 0 and data == a.read()


def _smpl_npz(path, V=30, F=20):
    rng = np.random.default_rng(0)
    W = rng.random((V, J)) + np.eye(J)[rng.integers(0, J, V)]
    Jreg = rng.random((J, V))
    np.savez(path, v_template=rng.standard_normal((V, 3)) * 0.1,
             shapedirs=rng.standard_normal((V, 3, 10)) * 0.01,
             posedirs=rng.standard_normal((V, 3, 9 * (J - 1))) * 0.01,
             J_regressor=Jreg / Jreg.sum(1, keepdims=True), weights=W / W.sum(1, keepdims=True),
             parents=np.asarray([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
                                 17, 18, 19, 20, 21]), f=rng.integers(0, V, (F, 3)))
    return path, V


def test_save_mesh_obj_writes_the_jax_meshes(tmp_path, monkeypatch):
    monkeypatch.delenv("HM_VAE_SMPL_MODEL", raising=False)
    rot = R.from_rotvec(np.random.default_rng(3).normal(scale=0.4, size=(3 * J, 3))).as_matrix()
    rot, trans = rot.reshape(3, J, 3, 3), np.random.default_rng(4).normal(size=(3, 3))
    with pytest.raises(ValueError, match="HM_VAE_SMPL_MODEL"):
        viz.save_mesh_obj(str(tmp_path / "none"), rot, trans, device="cpu")
    path, V = _smpl_npz(str(tmp_path / "smpl.npz"))
    monkeypatch.setenv("HM_VAE_SMPL_MODEL", path)
    mask = np.asarray([0, 1, 0])
    want = jviz.save_mesh_obj(str(tmp_path / "jax"), rot, trans, temporal_mask=mask)
    got = viz.save_mesh_obj(str(tmp_path / "port"), rot, trans, temporal_mask=mask, device="cpu")
    assert sorted(os.listdir(got)) == sorted(os.listdir(want)) == ["00000.obj", "00001.obj",
                                                                   "00002.obj"]
    assert os.listdir(tmp_path / "port" / "k_objs") == ["00001_k.obj"]
    for f in os.listdir(want):
        a, b = (open(os.path.join(d, f)).read().splitlines() for d in (want, got))
        assert b[V:] == a[V:]
        va, vb = (np.array([[float(x) for x in ln.split()[1:]] for ln in t[:V]]) for t in (a, b))
        np.testing.assert_allclose(vb, va, atol=1e-5 + 1e-6, rtol=0)
    # the same model as jsmpl would pose it
    np.testing.assert_allclose(
        jsmpl.SMPLBodyModel(path).forward(rot, transl=trans)[0, :3],
        np.array([[float(x) for x in ln.split()[1:]] for ln in
                  open(os.path.join(got, "00000.obj")).read().splitlines()[:3]]), atol=2e-5)


# ---------------------------------------------------------------------------
# --gen_vis through the CLIs, the Trainer's images


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A small VAE (len 16, K 3) with a short solve and a small trajectory
    model on one synthetic dataset, each trained 2 steps by the CLI."""
    tmp = str(tmp_path_factory.mktemp("vis"))
    data = os.path.join(tmp, "data")
    cfgs = {"vae": dict(model_name="TwoHierSAVAEModel", latent_d=6, shallow_latent_d=6,
                        kernel_size=3, train_seq_len=16, batch_size=4, synthetic=True,
                        synthetic_num_seqs=10, data_root=data, opt_it=3, prev_epochs=1,
                        interpolation_window=3, replace_frame_with_gt=True),
            "traj": dict(model_name="TrajectoryModel", latent_d=12, kernel_size=3,
                         train_seq_len=16, trajectory_input_joint_pos=True, batch_size=4,
                         synthetic=True, synthetic_num_seqs=10, data_root=data,
                         rec_root_v_w=1, rec_root_trans_w=1)}
    paths, cks = {}, {}
    for name, c in cfgs.items():
        paths[name] = os.path.join(tmp, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(c, f)
        train_cli.main(["--config", paths[name], "--output_path", tmp, "--device", "cpu",
                        "--max_iter", "2"])
        cks[name] = os.path.join(tmp, "outputs", name, "checkpoints", "gen_00000002.pt")
    seq = R.from_rotvec(np.random.default_rng(5).normal(scale=0.3, size=(20 * J, 3)))
    np.save(os.path.join(tmp, "rot.npy"), seq.as_matrix().reshape(20, J, 3, 3).astype(np.float32))
    np.save(os.path.join(tmp, "aa.npy"), seq.as_rotvec().reshape(20, 72).astype(np.float32))
    return dict(tmp=tmp, data=data, paths=paths, cks=cks)


def _gifs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".gif"))


@pytest.mark.parametrize("cli", ["refine_vibe", "eval_recovery", "eval_recovery_trajectory",
                                 "eval_trajectory", "explore_latent"])
def test_gen_vis_through_the_clis(run, cli):
    tmp, vae, ck = run["tmp"], run["paths"]["vae"], run["cks"]["vae"]
    out = os.path.join(tmp, cli)
    common = ["--config", vae, "--test_model", ck, "--output_path", out, "--device", "cpu",
              "--gen_vis"]
    traj = ["--trajectory_config", run["paths"]["traj"], "--trajectory_test_model",
            run["cks"]["traj"]]
    if cli == "refine_vibe":
        refine_vibe.main(common + ["--vibe_output", os.path.join(tmp, "aa.npy")])
        assert _gifs(os.path.join(out, "refine_vibe")) == ["aa_cmp.gif"]
    elif cli.startswith("eval_recovery"):
        eval_recovery.main(common + ["--final_try_long_seq_interpolation", "--max_seqs", "2",
                                     "--data_root", run["data"]]
                           + (traj if cli.endswith("trajectory") else []))
        d = os.path.join(out, "eval_long_seq_interpolation", "vae")
        res = sorted(f[:-len("_rot_opt_res.npy")] for f in os.listdir(d)
                     if f.endswith("_rot_opt_res.npy"))
        assert res and _gifs(d) == [r + ".gif" for r in res]
        assert any(f.endswith("_root_trans_opt_res.npy") for f in os.listdir(d)) == (
            cli.endswith("trajectory"))
    elif cli == "eval_trajectory":
        eval_trajectory.main(common + traj + ["--seq_generation_npy_path",
                                              os.path.join(tmp, "rot.npy"),
                                              "--data_root", run["data"]])
        assert _gifs(os.path.join(out, "eval_trajectory", "vae")) == ["rot_traj_0.gif"]
    else:
        explore_latent.main(common + ["--check_hier_latent_space", "--num_samples", "2",
                                      "--num_lerp", "2", "--data_root", run["data"]])
        d = os.path.join(out, "latent_space", "vae")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        assert index and _gifs(d) == sorted(n + ".gif" for n in index)


def test_trainer_saves_images_every_image_save_iter(run, tmp_path):
    from hm_vae_torch.train.trainer import build_trainer
    from hm_vae_torch.utils.config import load_config

    for name in ("vae", "traj"):
        cfg = load_config(run["paths"][name])
        cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, image_save_iter=2))
        trainer, train_ds, val_ds, test_ds = build_trainer(cfg, str(tmp_path / name),
                                                           device="cpu")
        trainer.fit(train_ds, None, max_iter=5, test_ds=test_ds)
        images = trainer.image_dir
        if name == "vae":
            assert sorted(os.listdir(images)) == ["2", "4"]
            for step in ("2", "4"):
                assert _gifs(os.path.join(images, step)) == ["mean_seq_rot_6d.gif",
                                                              "sampled_seq_rot_6d.gif"]
            assert trainer.state.model.training
        else:  # the trajectory model saves none, as in the JAX package
            assert os.listdir(images) == []


# ---------------------------------------------------------------------------
# profiling


def test_timer_measures_elapsed(capsys):
    with profiling.Timer("unit", verbose=True) as t:
        sum(range(1000))
    assert t.elapsed > 0
    assert "[timer] unit:" in capsys.readouterr().out
    with profiling.Timer(verbose=False) as t2:
        pass
    assert capsys.readouterr().out == ""
    assert t2.elapsed >= 0


def test_time_fn_median_positive():
    calls = []

    def f(x):
        calls.append(1)
        return (x * 2).sum()

    sec = profiling.time_fn(f, torch.arange(128.0), iters=3, warmup=1)
    assert sec > 0 and len(calls) == 4


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d) as prof:
        torch.arange(16.0).sum()
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
    assert any(e.key == "aten::sum" for e in prof.key_averages())
