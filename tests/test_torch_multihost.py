"""The port's multi-process plumbing (``hm_vae_torch.parallel.multihost``)
against the JAX package's ``hm_vae_tpu.parallel.multihost``:

- ``process_shard``, ``process_seed`` and ``local_batch_size``: the same
  numbers and the same errors for counts 1, 2, 3, 5 and 8 and item counts
  up to 10,818 (the AMASS train split's sequences), every index;
- the ``HMVAE_DIST`` gate: off without the variable (no group, one
  process), on with it: ``maybe_initialize_distributed`` joins torchrun's
  group from its environment (a one-rank group on the CPU, in a child
  process, on localhost) and returns the backend;
- the backend rule (NCCL where each rank of a node has its own card, gloo
  where they share one or run on the CPU) and the rank's device;
- the zero-slot gather and the mean of :mod:`~hm_vae_torch.parallel.sharding`
  under two gloo ranks: exact, the same on both.
"""

import multiprocessing as mp
import socket

import numpy as np
import pytest
import torch

from hm_vae_tpu.parallel import multihost as jmh
from hm_vae_torch.parallel import multihost as tmh

import torch_ranks

COUNTS = (1, 2, 3, 5, 8)
ITEMS = (0, 1, 7, 8, 64, 237, 1000, 10818)


@pytest.mark.parametrize("count", COUNTS)
def test_shards_seeds_and_batches_are_jaxs(count):
    for n in ITEMS:
        shards = [tmh.process_shard(n, i, count) for i in range(count)]
        assert shards == [jmh.process_shard(n, i, count) for i in range(count)]
        assert shards[0][0] == 0 and shards[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(shards, shards[1:]))
    for i in range(count):
        assert tmh.process_seed(123, i, count) == jmh.process_seed(123, i, count)
    for bs in (8, 64, 10818, 9):
        if bs % count:
            for mod in (tmh, jmh):
                with pytest.raises(ValueError, match="must divide"):
                    mod.local_batch_size(bs, count=count)
        else:
            assert tmh.local_batch_size(bs, count=count) == jmh.local_batch_size(
                bs, count=count) == bs // count
    for bad in (-1, count):
        for fn in (tmh.process_shard, jmh.process_shard):
            with pytest.raises(ValueError, match="outside"):
                fn(10, bad, count)
        for fn in (tmh.process_seed, jmh.process_seed):
            with pytest.raises(ValueError, match="outside"):
                fn(0, bad, count)


def test_one_process_without_the_gate(monkeypatch):
    monkeypatch.delenv("HMVAE_DIST", raising=False)
    assert tmh.maybe_initialize_distributed("cpu") is None
    assert tmh.process_group() is None
    assert (tmh.process_index(), tmh.process_count(), tmh.is_primary()) == (0, 1, True)
    assert tmh.process_seed(5) == 5 and tmh.process_shard(9) == (0, 9)
    assert tmh.local_batch_size(8) == 8
    monkeypatch.setenv("HMVAE_DIST", "0")
    assert not tmh.dist_requested()


def test_backend_rule_and_rank_device(monkeypatch):
    assert tmh.choose_backend("cuda", 2, 2) == "nccl"
    assert tmh.choose_backend("cuda", 1, 8) == "nccl"
    assert tmh.choose_backend("cuda", 2, 1) == "gloo"  # two ranks on one card
    assert tmh.choose_backend("cpu", 4, 0) == "gloo"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tmh.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmh.rank_device("cuda")


def test_gate_joins_torchruns_group_from_its_environment():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    p = ctx.Process(target=torch_ranks.env_child, args=(port, results))
    p.start()
    try:
        got = results.get(timeout=120)
    finally:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()
    assert not p.is_alive()
    assert got == ("gloo", "gloo", 1, True, True), got


def test_zero_slot_gather_and_mean_under_two_ranks(tmp_path):
    out = torch_ranks.run_ranks(torch_ranks.gather_and_mean, 2, tmp_path)
    want = np.arange(7, dtype=np.float32)[:, None] * np.array([1.0, -0.5], np.float32)
    for full, cols, mean, _ in out:
        np.testing.assert_array_equal(full, want)
        np.testing.assert_array_equal(cols, want.T)
        assert mean == {"a": 0.5, "b": 2.0}
    assert [o[3] for o in out] == [(0, 4), (4, 7)]
