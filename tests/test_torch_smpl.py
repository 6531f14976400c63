"""The port's SMPL body model (``hm_vae_torch.utils.smpl``) and mesh metrics
(``hm_vae_torch.apps.metrics.vertex_error[_from_rotmats]``) against the JAX
package's, on the CPU, with a small body model made from a seed (the licensed
SMPL files are not in the repository; the layout is the official one, as
``tests/test_smpl.py`` builds it).

Both compute in float64 and return float32, so the vertices agree within
1e-5 (the sums run in another order, then one float32 rounding each);
``write_obj`` writes the same text, so the exported files are equal bytes.
"""

import os

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from hm_vae_tpu.apps import metrics as jmetrics
from hm_vae_tpu.utils import smpl as jsmpl
from hm_vae_torch.apps import metrics as tmetrics
from hm_vae_torch.utils import smpl as tsmpl

J, V, NB, F = 24, 40, 10, 30
PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_model(tmp_path, posedirs=True, parents_key=False, seed=0):
    """A body model npz in the official layout: kintree_table (root parent
    stored as uint32 -1) or parents, posedirs random, zero or absent."""
    rng = np.random.default_rng(seed)
    W = rng.random((V, J)) * 0.05
    W[np.arange(V), rng.integers(0, J, V)] += 1.0
    W /= W.sum(axis=1, keepdims=True)
    Jreg = rng.random((J, V))
    Jreg /= Jreg.sum(axis=1, keepdims=True)
    arrays = dict(v_template=rng.standard_normal((V, 3)) * 0.1,
                  shapedirs=rng.standard_normal((V, 3, NB)) * 0.01,
                  J_regressor=Jreg, weights=W, f=rng.integers(0, V, (F, 3)))
    if posedirs is not None:
        arrays["posedirs"] = (rng.standard_normal((V, 3, 9 * (J - 1))) * 0.01 if posedirs
                              else np.zeros((V, 3, 9 * (J - 1))))
    if parents_key:
        arrays["parents"] = np.asarray(PARENTS)
    else:
        kintree = np.stack([np.asarray(PARENTS), np.arange(J)])
        kintree[0, 0] = 2**32 - 1
        arrays["kintree_table"] = kintree.astype(np.uint32)
    path = os.path.join(tmp_path, f"smpl_{posedirs}_{parents_key}_{seed}.npz")
    np.savez(path, **arrays)
    return path


def _rotmats(T, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return R.from_rotvec(rng.normal(scale=scale, size=(T * J, 3))).as_matrix().reshape(T, J, 3, 3)


@pytest.mark.parametrize("posedirs", [True, False, None], ids=["posedirs", "zero", "absent"])
@pytest.mark.parametrize("betas", [False, True], ids=["mean_shape", "betas"])
@pytest.mark.parametrize("transl", [False, True], ids=["no_transl", "transl"])
def test_lbs_matches_jax(tmp_path, posedirs, betas, transl):
    path = _tiny_model(tmp_path, posedirs=posedirs)
    jm, tm = jsmpl.SMPLBodyModel(path), tsmpl.SMPLBodyModel(path, device="cpu")
    rng = np.random.default_rng(1)
    rot = _rotmats(6, 2).astype(np.float32)
    kw = {}
    if betas:
        kw["betas"] = rng.normal(size=NB)
    if transl:
        kw["transl"] = rng.normal(size=(6, 3))
    want = jm.forward(rot, **kw)
    got = tm(torch.as_tensor(rot), **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (6, V, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(tm.joints_of(kw.get("betas")).numpy(), jm.joints_of(kw.get("betas")),
                               atol=TOL, rtol=0)
    assert tm.parents == tuple(int(p) for p in jm.parents)
    assert np.array_equal(tm.faces, jm.faces)


def test_identity_pose_is_the_template_and_parents_key_loads(tmp_path):
    tm = tsmpl.SMPLBodyModel(_tiny_model(tmp_path, parents_key=True), device="cpu")
    assert tm.parents[0] == -1 and tm.parents[1:] == tuple(PARENTS[1:])
    eye = np.broadcast_to(np.eye(3), (2, J, 3, 3))
    np.testing.assert_allclose(tm(eye).numpy(), np.broadcast_to(
        tm.v_template.numpy(), (2, V, 3)), atol=TOL, rtol=0)
    assert all(b.dtype == torch.float64 for b in tm.buffers())


def test_missing_arrays_and_default_device(tmp_path):
    path = os.path.join(tmp_path, "bad.npz")
    np.savez(path, v_template=np.zeros((V, 3)))
    with pytest.raises(ValueError, match="missing required SMPL arrays"):
        tsmpl.SMPLBodyModel(path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsmpl.SMPLBodyModel(_tiny_model(tmp_path))


def test_export_mesh_sequence_matches_jax_files(tmp_path):
    """The reference exporter's folder layout (our_wo_root_objs/%05d.obj,
    k_objs/%05d_k.obj, mask/temporal_mask.npy), and the JAX package's files,
    byte for byte."""
    path = _tiny_model(tmp_path)
    rot, trans = _rotmats(4, 3), np.random.default_rng(4).normal(size=(4, 3))
    mask = np.asarray([1, 0, 0, 1])
    jsmpl.export_mesh_sequence(str(tmp_path / "jax"), rot, trans, jsmpl.SMPLBodyModel(path),
                               temporal_mask=mask)
    out = tsmpl.export_mesh_sequence(str(tmp_path / "port"), rot, trans,
                                     tsmpl.SMPLBodyModel(path, device="cpu"), temporal_mask=mask)
    assert out == str(tmp_path / "port" / "our_wo_root_objs")
    assert sorted(os.listdir(out)) == [f"{t:05d}.obj" for t in range(4)]
    assert sorted(os.listdir(tmp_path / "port" / "k_objs")) == ["00000_k.obj", "00003_k.obj"]
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "mask" / "temporal_mask.npy"), mask)
    for sub in ("our_wo_root_objs", "k_objs"):
        for f in os.listdir(tmp_path / "jax" / sub):
            a = (tmp_path / "jax" / sub / f).read_text().splitlines()
            b = (tmp_path / "port" / sub / f).read_text().splitlines()
            assert len(a) == len(b) == V + F
            assert b[V:] == a[V:]  # faces
            va = np.array([[float(x) for x in ln.split()[1:]] for ln in a[:V]])
            vb = np.array([[float(x) for x in ln.split()[1:]] for ln in b[:V]])
            np.testing.assert_allclose(vb, va, atol=TOL + 1e-6, rtol=0)  # + the 6 printed digits


def test_write_obj_writes_the_jax_text(tmp_path):
    rng = np.random.default_rng(5)
    v, f = rng.normal(size=(V, 3)).astype(np.float32), rng.integers(0, V, (F, 3))
    jsmpl.write_obj(v, f, str(tmp_path / "a.obj"))
    tsmpl.write_obj(v, f, str(tmp_path / "b.obj"))
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()


@pytest.mark.parametrize("case", ["same", "translated", "posed"])
def test_vertex_error_from_rotmats_matches_jax(tmp_path, case):
    path = _tiny_model(tmp_path)
    jm, tm = jsmpl.SMPLBodyModel(path), tsmpl.SMPLBodyModel(path, device="cpu")
    gt = _rotmats(5, 6)
    pred, kw = gt.copy(), {}
    if case == "translated":
        kw["pred_transl"] = np.tile([[0.3, 0.0, 0.4]], (5, 1))
    if case == "posed":
        pred = _rotmats(5, 7)
        kw = dict(pred_transl=np.zeros((5, 3)), gt_transl=np.full((5, 3), 0.1))
    want = jmetrics.vertex_error_from_rotmats(jm, pred, gt, **kw)
    got = tmetrics.vertex_error_from_rotmats(tm, pred, gt, **kw)
    assert isinstance(got, float)
    assert got == pytest.approx(want, abs=TOL)
    if case == "translated":
        assert got == pytest.approx(0.5, abs=TOL)
    v1, v2 = (np.random.default_rng(s).normal(size=(3, V, 3)).astype(np.float32) for s in (8, 9))
    assert float(tmetrics.vertex_error(v1, v2)) == pytest.approx(
        float(jmetrics.vertex_error(v1, v2)), rel=1e-6)
