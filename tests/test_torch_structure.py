"""Port's config reader and static structure against the JAX package.

Every ConvSpec field, mask, pool/unpool matrix, timestep schedule and latent
edge count of ``hm_vae_torch.models.structure`` must equal
``hm_vae_tpu.models.structure`` exactly, and the port's own YAML reader must
read every shipped config as ``yaml.safe_load`` does.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import yaml

from hm_vae_tpu.models import structure as jst
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.models import structure as tst
from hm_vae_torch.utils import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
HMVAE_CONFIGS = ["len8_data_aug_hm_vae.yaml", "len8_smoke.yaml",
                 "len64_no_aug_hm_vae.yaml", "len64_production.yaml"]


def _model_cfgs(name, extra_conv=None):
    path = os.path.join(ROOT, "configs", name)
    j, t = jcfg.load_config(path).model, tcfg.load_config(path).model
    if extra_conv is not None:
        j = dataclasses.replace(j, extra_conv=extra_conv)
        t = dataclasses.replace(t, extra_conv=extra_conv)
    return j, t


def _same_spec(a, b, where):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f"{where}.{f.name}")
            assert va.dtype == vb.dtype, (where, f.name)
        else:
            assert va == vb, (where, f.name, va, vb)


@pytest.mark.parametrize("name,extra_conv", [(n, None) for n in HMVAE_CONFIGS]
                         + [("len8_data_aug_hm_vae.yaml", 1)])
def test_structure_matches_jax(name, extra_conv):
    jm, tm = _model_cfgs(name, extra_conv)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    js, ts = jst.get_structure(jm), tst.get_structure(tm)
    for attr in ("channel_base", "channel_list", "enc_timesteps", "enc_strides",
                 "dec_timesteps", "z_edges", "z_dims"):
        assert getattr(js, attr) == getattr(ts, attr), attr
    jc, tc = js.cascade, ts.cascade
    for attr in ("edge_num", "pooled_edge_num", "pooling_lists", "topologies"):
        assert getattr(jc, attr) == getattr(tc, attr), attr
    assert [[list(map(int, n)) for n in lvl] for lvl in jc.neighbours] == \
        [[list(map(int, n)) for n in lvl] for lvl in tc.neighbours]
    for kind in ("encoder_levels", "decoder_levels"):
        for i, (a, b) in enumerate(zip(getattr(js, kind), getattr(ts, kind))):
            where = f"{kind}[{i}]"
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                if f.name == "conv":
                    _same_spec(va, vb, f"{where}.conv")
                elif f.name == "extra_convs":
                    assert len(va) == len(vb) == (extra_conv or 0)
                    for e, (x, y) in enumerate(zip(va, vb)):
                        _same_spec(x, y, f"{where}.extra_convs[{e}]")
                elif isinstance(va, np.ndarray):
                    np.testing.assert_array_equal(va, vb, err_msg=f"{where}.{f.name}")
                else:
                    assert va == vb, (where, f.name, va, vb)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_matches_safe_load(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert tcfg.read_yaml(path) == ref
    j, t = jcfg.load_config(path), tcfg.load_config(path)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


YAML_CASES = """\
# header comment
a: 1
b: -0.5   # trailing comment
c: 1e-4
d: 0.0001
e: true
f: Off
g: ~
h:
i: 'quoted # not a comment'
j: "double"
k: [100, 200, 3.5]
l: []
m: 0x1F
n: 017
o: 1_000
p: .inf
q: some/path-with.dots
r: 2.
model:
  latent_d: 12
  padding_mode: zeros
optim:
  step_size: [10, 20]
"""


def test_yaml_reader_scalars_and_sections():
    assert tcfg.parse_yaml(YAML_CASES) == yaml.safe_load(YAML_CASES)


@pytest.mark.parametrize("text", ["a:\n  - 1\n  - 2\n", "a: {b: 1}\n", "a: &x 1\n",
                                  "a:\n  b:\n    c: 1\n", "just text\n"])
def test_yaml_reader_rejects_unsupported(text):
    with pytest.raises(ValueError):
        tcfg.parse_yaml(text)


def test_vendored_assets_match():
    import json

    from hm_vae_torch.ops import topology as ttp

    with open(os.path.join(ttp.ASSETS_DIR, "joint24_parents.json")) as f:
        assert tuple(json.load(f)) == ttp.SMPL24_PARENTS
    for name in ("joint24_parents.json", "skeleton_offsets.npy"):
        with open(os.path.join(ROOT, "hm_vae_tpu", "assets", name), "rb") as a, \
                open(os.path.join(ttp.ASSETS_DIR, name), "rb") as b:
            assert a.read() == b.read(), name


def test_nested_config_matches_jax(tmp_path):
    text = ("latent_d: 6\nlora_rank: 4\nmodel:\n  kernel_size: 3\n  train_seq_len: 8\n"
            "latent_opt:\n  moment_dtype: bfloat16\n")
    p = tmp_path / "nested.yaml"
    p.write_text(text)
    j, t = jcfg.load_config(str(p)), tcfg.load_config(str(p))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.model.lora_rank == 0 and t.latent_opt.lora_rank == 4
    assert t.latent_opt.opt_moment_dtype == "bfloat16"
    flat = {"latent_d": 6, "lora_rank": 4, "step_size": [1, 2], "unknown_key": 1}
    assert dataclasses.asdict(jcfg.from_flat_dict(flat)) == \
        dataclasses.asdict(tcfg.from_flat_dict(flat))
