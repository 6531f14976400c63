"""The port stands alone: importing all of ``hm_vae_torch`` (and
chip_smoke.py, kernel_trace.py), the training and latent-optimization paths
included, loads neither JAX nor the JAX package, and no source of the port
imports them (its C++ sampler, ``native/loader.cpp``, includes nothing of
them either)."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "hm_vae_tpu")
# the training path's modules, which must be among those imported
TRAINING = tuple(f"hm_vae_torch.{m}" for m in (
    "train.losses", "train.optim", "train.train_step", "train.trainer", "data.synthetic",
    "data.layout", "data.dataset", "utils.logging", "cli.train",
    # the production training path
    "data.native_loader", "data.device_aug",
    # the latent-optimization path
    "apps.latent_opt", "apps.tasks", "apps.metrics", "apps.baselines", "cli.eval_recovery",
    # the trajectory model
    "models.trajectory", "cli.eval_trajectory",
    # the serving export and the latent-space probes
    "apps.export", "cli.export_model", "apps.latent_space", "cli.explore_latent",
    # data preparation, the SMPL body model, visualization and profiling
    "data.amass_prep", "cli.prep_data", "utils.smpl", "utils.viz", "utils.profiling"))


def _port_sources():
    for d, _, files in os.walk(os.path.join(ROOT, "hm_vae_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "kernel_trace.py")


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hm_vae_torch\n"
        "for m in pkgutil.walk_packages(hm_vae_torch.__path__, 'hm_vae_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, kernel_trace\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len([n for n in sys.modules if n.startswith('hm_vae_torch.')]))\n"
        "assert not bad, bad\n"
        f"missing = [n for n in {TRAINING!r} if n not in sys.modules]\n"
        "assert not missing, missing\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30  # every submodule was imported


def test_sources_import_no_jax():
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__")):
                names = [str(node.args[0].value)]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, node.lineno, n)


def test_native_source_includes_only_the_standard_library():
    with open(os.path.join(ROOT, "hm_vae_torch", "native", "loader.cpp")) as f:
        includes = [line.split()[1] for line in f if line.startswith("#include")]
    assert includes and all(i.startswith("<") for i in includes), includes
