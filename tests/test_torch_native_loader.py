"""The port's native C++ sampler against the JAX package's on the same
synthetic processed data and seed (CPU): the same source and seed give the
same arrays, bit for bit, for whole batches, every compact wire, the
superbatch streams and the prefetch pool, on 1 and 4 threads.  A failed
build raises with the compiler's error (no numpy fallback), and
``make_loaders`` returns the native train split."""

import dataclasses
import os
import subprocess

import numpy as np
import pytest

from hm_vae_tpu.data import synthetic
from hm_vae_tpu.data.native_loader import NativeMotionLoader as JLoader
from hm_vae_torch.data import dataset as tdataset
from hm_vae_torch.data import native_loader as tnative
from hm_vae_torch.data.native_loader import NativeMotionLoader as TLoader
from hm_vae_torch.utils import config as tcfg

L = 12


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("native_ds"))
    synthetic.generate_dataset(d, num_seqs=6, min_len=40, max_len=100, seed=3)
    return d


def _pair(data_dir, seed=5, fps_aug=False):
    ms = np.load(os.path.join(data_dir, "mean_std.npy"))
    args = (os.path.join(data_dir, "seqs"), os.path.join(data_dir, "train.json"), ms, L)
    return JLoader(*args, fps_aug=fps_aug, seed=seed), TLoader(*args, fps_aug=fps_aug, seed=seed)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_source_is_the_jax_packages():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "hm_vae_tpu", "native", "loader.cpp"), "rb") as f:
        assert tnative.SOURCE.read_bytes() == f.read()


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("fps_aug", [False, True])
def test_sample_batch_matches_jax(data_dir, threads, fps_aug):
    j, t = _pair(data_dir, fps_aug=fps_aug)
    for _ in range(3):  # the counter advances the same way
        _same(j.sample_batch(16, threads=threads), t.sample_batch(16, threads=threads))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("wire", ["rotmat", "rot6d", "aa"])
@pytest.mark.parametrize("need_root_v", [False, True])
def test_sample_compact_matches_jax(data_dir, threads, wire, need_root_v):
    j, t = _pair(data_dir, seed=7)
    for _ in range(2):
        _same(j.sample_compact(16, need_root_v, threads, wire=wire),
              t.sample_compact(16, need_root_v, threads, wire=wire))


@pytest.mark.parametrize("threads", [1, 4])
def test_superbatch_matches_jax(data_dir, threads):
    j, t = _pair(data_dir)
    _same(j.sample_superbatch(3, 4, threads), t.sample_superbatch(3, 4, threads))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("wire", ["rotmat", "rot6d", "aa"])
def test_compact_superbatch_stream_matches_jax(data_dir, threads, wire):
    j, t = _pair(data_dir, seed=2)
    js = j.iter_compact_superbatches(3, 4, True, threads, wire=wire)
    ts = t.iter_compact_superbatches(3, 4, True, threads, wire=wire)
    for _ in range(4):
        _same({k: v.copy() for k, v in next(js).items()}, next(ts))
    ts.close()


def test_f16_wire_is_the_host_cast(data_dir):
    """The f16 stream holds the f32 stream's values cast on the host, as the
    JAX Trainer's wire cast makes them."""
    j, t = _pair(data_dir, seed=4)
    js = j.iter_compact_superbatches(2, 4, True, 2, wire="aa")
    ts = t.iter_compact_superbatches(2, 4, True, 2, wire="aa", dtype=np.float16)
    for _ in range(3):
        _same({k: v.astype(np.float16) for k, v in next(js).items()}, next(ts))
    ts.close()


@pytest.mark.parametrize("threads", [1, 4])
def test_superbatch_stream_matches_jax(data_dir, threads):
    j, t = _pair(data_dir, seed=3)
    js, ts = j.iter_superbatches(2, 4, threads), t.iter_superbatches(2, 4, threads)
    for _ in range(4):
        _same({k: v.copy() for k, v in next(js).items()}, next(ts))
    ts.close()


def test_prefetch_pool_matches_jax(data_dir):
    """One pool thread: the same queue of batches."""
    j, t = _pair(data_dir, seed=9)
    j.start_prefetch(4, depth=2, threads=1)
    t.start_prefetch(4, depth=2, threads=1)
    for _ in range(3):
        _same(j.next_batch(), t.next_batch())
    j.close()
    t.close()


def test_stream_waits_for_the_copy_event(data_dir):
    """A slot handed out is refilled only after its copy's event."""
    _, t = _pair(data_dir)
    s = t.iter_compact_superbatches(2, 4, False, 1, wire="aa")
    first = next(s)
    waited = []

    class Event:
        def synchronize(self):
            waited.append(True)

    s.copy_done(Event())
    keep = first["aa"].copy()
    next(s)  # starts refilling the first slot after its event
    s.close()
    assert waited == [True]
    assert not np.array_equal(keep, s.slots[0][-1]["aa"].reshape(keep.shape))


def test_stream_close_raises_a_failed_fill():
    """A background fill's error is raised by close(), once."""
    slots = [{"x": np.zeros(2, np.float32)} for _ in range(2)]

    def fill(slot):
        if slot == 1:
            raise OSError("sequence read failed")
        slots[slot]["x"][:] = 1

    s = tnative.BufferStream(slots, fill, lambda v: v)
    assert next(s)["x"].tolist() == [1, 1]  # slot 1 fills in the background
    with pytest.raises(OSError, match="sequence read failed"):
        s.close()
    s.close()


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    real = subprocess.run

    def broken(cmd, **kw):
        return real(["sh", "-c", "echo 'loader.cpp:1: error: boom' >&2; exit 1"], **kw)

    monkeypatch.setattr(tnative.subprocess, "run", broken)
    with pytest.raises(RuntimeError, match="(?s)boom.*use_native_loader: false"):
        tnative.get_library()


def test_make_loaders_returns_the_native_train_split(tmp_path, monkeypatch):
    cfg = tcfg.Config(data=tcfg.DataConfig(data_root=str(tmp_path / "data"), synthetic=True,
                                           synthetic_num_seqs=6),
                      model=tcfg.ModelConfig(train_seq_len=8))
    read = []
    numpy_split = tdataset.MotionDataset

    def recorded(seq_dir, index_json, *a, **kw):
        read.append(os.path.basename(index_json))
        return numpy_split(seq_dir, index_json, *a, **kw)

    monkeypatch.setattr(tdataset, "MotionDataset", recorded)
    train, val, test = tdataset.make_loaders(cfg)
    monkeypatch.undo()
    assert read == ["val.json", "test.json"]  # no numpy copy of the train split
    assert isinstance(train, TLoader)
    assert isinstance(val, tdataset.MotionDataset) and isinstance(test, tdataset.MotionDataset)
    np.testing.assert_array_equal(train.mean, val.mean)
    np.testing.assert_array_equal(train.std, val.std)
    off = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, use_native_loader=False))
    assert isinstance(tdataset.make_loaders(off)[0], tdataset.MotionDataset)
    host_aug = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, random_root_rot_flag=True, device_augment=False))
    assert isinstance(tdataset.make_loaders(host_aug)[0], tdataset.MotionDataset)
