"""The port's data preparation (``hm_vae_torch.data.amass_prep``,
``hm_vae_torch.cli.prep_data``) and the vendored split manifests, against the
JAX package's, on raw AMASS-layout trees made from a seed:

- ``convert_sequence``: the (T, 579) frames bit for bit (integer-stride
  resampling to the target fps, no resampling, the < 30-frame drop);
- ``process_amass_root`` and ``prep_data --amass_dir``: every sequence file,
  ``mean_std.npy`` and the split jsons bit for bit;
- ``prep_data --gen_masks`` and ``--synthetic``: the same files bit for bit;
- ``data.*_json: reference``: the vendored manifests, the JAX package's
  entries (10818 / 363 / 140).

Everything here is numpy and scipy on the host in both packages, so the
tolerance is none: equal arrays of equal dtype, equal bytes of json.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from hm_vae_tpu.cli import prep_data as jprep_cli
from hm_vae_tpu.data import amass_prep as jprep
from hm_vae_tpu.data import dataset as jdataset
from hm_vae_tpu.data import layout as jlayout
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.cli import prep_data as tprep_cli
from hm_vae_torch.data import amass_prep as tprep
from hm_vae_torch.data import dataset as tdataset
from hm_vae_torch.data import layout as tlayout
from hm_vae_torch.utils import config as tcfg

# (subset, subject, action, raw frames, mocap framerate): train (CMU, KIT),
# val (HumanEva), test (Transitions_mocap); one too short after the stride
RAW = (("CMU", "01", "walk_poses", 240, 120.0), ("CMU", "01", "run_poses", 100, 60.0),
       ("KIT", "3", "jump_poses", 95, 30.0), ("CMU", "02", "short_poses", 100, 120.0),
       ("HumanEva", "S1", "box_poses", 180, 60.0),
       ("Transitions_mocap", "mazen", "turn_poses", 150, 50.0))


def _raw_tree(root, seed=0):
    """A raw AMASS-layout tree: SMPL-H poses (N, 156), trans, mocap_framerate,
    betas, plus a subject's shape.npz that the walk skips."""
    rng = np.random.default_rng(seed)
    for subset, subject, action, n, fps in RAW:
        d = os.path.join(root, subset, subject)
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, action + ".npz"), poses=rng.normal(size=(n, 156)) * 0.4,
                 trans=np.cumsum(rng.normal(size=(n, 3)) * 0.01, axis=0),
                 mocap_framerate=np.float64(fps), betas=rng.normal(size=16))
        np.savez(os.path.join(d, "shape.npz"), betas=rng.normal(size=16))
    return root


def _same_tree(a, b):
    """Every file under a and b: the same names, npys equal in dtype and
    values, other files equal bytes."""
    names = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)  # noqa: E731
                             for d, _, fs in os.walk(r) for f in fs)
    assert names(a) == names(b)
    for rel in names(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and np.array_equal(x, y), rel
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("n,fps,target", [(240, 120.0, 30), (121, 60.0, 30), (75, 30.0, 30),
                                          (90, None, 30), (64, 120.0, None), (116, 120.0, 30)],
                         ids=["stride4", "stride2", "stride1", "no_framerate", "no_target",
                              "dropped"])
def test_convert_sequence_matches_jax_bit_for_bit(n, fps, target):
    rng = np.random.default_rng(n)
    poses = rng.normal(size=(n, 156)) * 0.4
    trans = np.cumsum(rng.normal(size=(n, 3)) * 0.01, axis=0)
    want = jprep.convert_sequence(poses, trans, fps, target)
    got = tprep.convert_sequence(poses, trans, fps, target)
    if want is None:  # 116 raw frames at stride 4: 29 frames, under the minimum of 30
        assert got is None
        return
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    stride = max(int(fps) // target, 1) if fps and target else 1
    assert got.shape == (-(-n // stride), tlayout.FRAME_DIM)


def test_convert_sequence_keeps_thirty_frames():
    rng = np.random.default_rng(5)
    poses, trans = rng.normal(size=(120, 156)), rng.normal(size=(120, 3))
    assert tprep.convert_sequence(poses, trans, 120.0, 30).shape == (30, 579)
    assert tprep.convert_sequence(poses[:116], trans[:116], 120.0, 30) is None


@pytest.mark.parametrize("target", [30, None], ids=["fps30", "native_fps"])
def test_process_amass_root_matches_jax_bit_for_bit(tmp_path, target):
    raw = _raw_tree(str(tmp_path / "amass"))
    want = jprep.process_amass_root(raw, str(tmp_path / "jax"), target_fps=target, verbose=False)
    got = tprep.process_amass_root(raw, str(tmp_path / "port"), target_fps=target, verbose=False)
    assert got == want
    assert {k: len(v) for k, v in got.items()} == (
        {"train": 3, "val": 1, "test": 1} if target else {"train": 4, "val": 1, "test": 1})
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_prep_data_cli_matches_jax(tmp_path, capsys):
    raw = _raw_tree(str(tmp_path / "amass"), seed=3)
    jprep.process_amass_root(raw, str(tmp_path / "jax"), verbose=False)
    tprep_cli.main(["--amass_dir", raw, "--dest", str(tmp_path / "port")])
    assert "'train': 3" in capsys.readouterr().out
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    with pytest.raises(SystemExit):  # neither --amass_dir nor --synthetic
        tprep_cli.main(["--dest", str(tmp_path / "none")])


@pytest.mark.parametrize("split", ["test", "train"])
def test_gen_masks_matches_jax_bit_for_bit(tmp_path, split):
    raw = _raw_tree(str(tmp_path / "amass"), seed=4)
    for side in ("jax", "port"):
        jprep.process_amass_root(raw, str(tmp_path / side), verbose=False)
    jprep_cli.generate_masks(str(tmp_path / "jax"), [0.1, 0.5], split=split, seed=7)
    tprep_cli.main(["--dest", str(tmp_path / "port"), "--gen_masks", "0.1", "0.5",
                    "--mask_split", split, "--seed", "7"])
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    d = tmp_path / "port" / "eval_masks" / "missing_prob_0.5"
    masks = [np.load(d / f) for f in sorted(os.listdir(d))]
    assert masks and all(m.shape[1] == 24 and set(np.unique(m)) <= {0.0, 1.0} for m in masks)


def test_synthetic_cli_matches_jax(tmp_path):
    jprep_cli.main(["--dest", str(tmp_path / "jax"), "--synthetic", "5", "--seed", "2"])
    tprep_cli.main(["--dest", str(tmp_path / "port"), "--synthetic", "5", "--seed", "2"])
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("split,count", [("train", 10818), ("val", 363), ("test", 140)])
def test_reference_manifests_resolve_as_in_jax(split, count):
    tc, jc = (dataclasses.replace(c, data=dataclasses.replace(c.data, **{f"{split}_json":
                                                                     "reference"}))
              for c in (tcfg.Config(), jcfg.Config()))
    path = tdataset.resolve_split_json(tc, split)
    assert path == tlayout.reference_split_path(split)
    with open(path) as f, open(jdataset.resolve_split_json(jc, split)) as g:
        got, want = json.load(f), json.load(g)
    assert got == want and len(got) == count
    with open(path, "rb") as f, open(jlayout.reference_split_path(split), "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(ValueError, match="unknown split"):
        tlayout.reference_split_path("dev")
