"""Typed configuration schema and a YAML reader of the port's own.

The dataclasses and the flat/nested loading rules are those of
``hm_vae_tpu.utils.config``: every key the code consumes is a typed field with
a default, unknown keys are ignored with a log line, and the reference's flat
``key: value`` files load unchanged.

PyYAML is not a dependency of the port.  :func:`read_yaml` reads the subset of
YAML the repository's configs use — ``key: value`` scalars with YAML 1.1
resolution (as ``yaml.safe_load`` resolves them), flow lists ``[a, b]``,
comments, and one level of indented sections — and raises on anything else.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any, Dict, List, Tuple

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (consumed by models/structure.py)."""

    model_name: str = "TwoHierSAVAEModel"
    n_joints: int = 24
    input_dim: int = 6
    output_dim: int = 6
    latent_d: int = 24
    shallow_latent_d: int = 12
    num_layers: int = 4
    skeleton_dist: int = 2
    skeleton_pool: str = "mean"
    extra_conv: int = 0
    padding_mode: str = "reflection"
    kernel_size: int = 15
    upsampling: str = "linear"
    train_seq_len: int = 64
    max_input_timesteps: int = 300
    # "dense" (reference layout) or "compact"; the port runs dense only
    param_layout: str = "dense"
    # rank of the test-time decoder adapters; 0 = none (the port runs 0 only)
    lora_rank: int = 0
    # "float32" | "bfloat16" conv compute (f32 parameters either way)
    compute_dtype: str = "float32"
    # trajectory model only
    trajectory_input_joint_pos: bool = True
    use_accumulation_root_v: bool = True


@dataclasses.dataclass(frozen=True)
class LossConfig:
    rec_6d_w: float = 1.0
    rec_rot_w: float = 1.0
    rec_pose_w: float = 10.0
    rec_joint_pos_w: float = 0.0
    rec_root_v_w: float = 0.0
    rec_root_trans_w: float = 0.0
    rec_linear_v_w: float = 0.0
    rec_angular_v_w: float = 0.0
    kl_w: float = 0.003
    shallow_kl_w: float = 0.003
    iteration_interval: int = 50000


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-4
    # weights_init scheme of the latent Linear heads:
    # gaussian | xavier | kaiming | orthogonal | default
    init: str = "kaiming"
    lr_policy: str = "step"
    step_size: Any = 100000
    gamma: float = 0.3
    max_iter: int = 250000
    batch_size: int = 8
    moment_dtype: str = "float32"
    param_dtype: str = "float32"
    none_grad_skip: bool = True


@dataclasses.dataclass(frozen=True)
class LatentOptConfig:
    opt_lr: float = 0.1
    opt_it: int = 150
    reg_w: float = 0.0
    reg_w_decoder: float = 1000.0
    reg_w_trajectory: float = 0.0
    opt_lr_policy: str = "step"
    opt_step_size: int = 50
    opt_gamma: float = 0.1
    interpolation_window: int = 5
    optimize_decoder: bool = True
    per_window_decoder: bool = True
    optimize_trajectory: bool = False
    opt_moment_dtype: str = "float32"
    opt_param_dtype: str = "float32"
    finetune_scope: str = "full"
    lora_rank: int = 16
    lora_lr_mult: float = 10.0
    replace_frame_with_gt: bool = True
    replace_part_with_gt: bool = True
    missing_upper_completion: bool = False
    missing_lower_completion: bool = True
    prev_epochs: int = 50
    prev_epochs_completion: int = 100
    track_best: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_root: str = "data/processed"
    train_json: str = "train_all_amass_motion_data.json"
    val_json: str = "val_all_amass_motion_data.json"
    test_json: str = "test_all_amass_motion_data.json"
    mean_std_path: str = ""
    fps_aug_flag: bool = False
    random_root_rot_flag: bool = False
    device_augment: bool = True
    use_30fps_data: bool = True
    num_prefetch: int = 2
    synthetic: bool = False
    synthetic_num_seqs: int = 64
    use_native_loader: bool = True
    native_threads: int = 8
    compact_transfer: bool = True
    transfer_dtype: str = "float32"
    wire_format: str = "rot6d"
    missing_joint_prob: float = 0.0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    log_iter: int = 20
    validation_iter: int = 500
    image_save_iter: int = 20000
    snapshot_save_iter: int = 20000
    seed: int = 0
    steps_per_call: int = 1
    model_parallel: int = 1
    keep_checkpoints: int = 0
    nan_guard: bool = True
    matmul_precision: str = "default"
    async_checkpoint: bool = False
    preemption_checkpoint: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    optim: OptimConfig = OptimConfig()
    latent_opt: LatentOptConfig = LatentOptConfig()
    data: DataConfig = DataConfig()
    run: RunConfig = RunConfig()


_SECTIONS = (
    ("model", ModelConfig), ("loss", LossConfig), ("optim", OptimConfig),
    ("latent_opt", LatentOptConfig), ("data", DataConfig), ("run", RunConfig),
)
# renamed keys accepted (with a log line) from older nested configs
_SECTION_ALIASES = {"latent_opt": {"moment_dtype": "opt_moment_dtype"}}
# a flat `lora_rank:` is a solver knob (latent_opt): it must not add adapter
# parameters to the model (nested yaml can still set model.lora_rank)
_FLAT_EXCLUDES = {"model": ("lora_rank",)}


def _fill(cls, flat: Dict[str, Any], exclude=()):
    names = {f.name for f in dataclasses.fields(cls)} - set(exclude)
    kwargs = {}
    for k, v in flat.items():
        if k in names:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def from_flat_dict(flat: Dict[str, Any]) -> Config:
    """Build a :class:`Config` from a flat reference-style dict."""
    known = set()
    sections = {}
    for name, cls in _SECTIONS:
        sections[name] = _fill(cls, flat, _FLAT_EXCLUDES.get(name, ()))
        known |= {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(flat) - known)
    if unknown:
        log.info("ignoring unused config keys: %s", unknown)
    return Config(**sections)


def load_config(path: str) -> Config:
    """Load a flat (reference) or nested ``{model: {...}, ...}`` config."""
    raw = read_yaml(path)
    section_names = {name for name, _ in _SECTIONS}
    if not section_names & set(raw):
        return from_flat_dict(raw)
    nested = {}
    flat_extra = {k: v for k, v in raw.items() if k not in section_names}
    for name, cls in _SECTIONS:
        sect = dict(raw.get(name) or {})
        for old, new in _SECTION_ALIASES.get(name, {}).items():
            if old in sect:
                log.info("config: %s.%s is now %s.%s", name, old, name, new)
                sect[new] = sect.pop(old)
        unknown = sorted(set(sect) - {f.name for f in dataclasses.fields(cls)})
        if unknown:
            log.info("ignoring unknown %s config keys: %s", name, unknown)
        merged = dict(flat_extra)
        merged.update(sect)
        excl = tuple(k for k in _FLAT_EXCLUDES.get(name, ()) if k not in sect)
        nested[name] = _fill(cls, merged, excl)
    return Config(**nested)


# --------------------------------------------------------------------------
# YAML subset reader
# --------------------------------------------------------------------------

# YAML 1.1 scalar resolution, as PyYAML's SafeLoader applies it
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OCT = re.compile(r"^[-+]?0[0-7_]+$")
_INT_HEX = re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")


def _scalar(text: str) -> Any:
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1].replace("''", "'") if s[0] == "'" else s[1:-1]
    if _NULL.match(s):
        return None
    if s in _BOOL:
        return _BOOL[s]
    sign = -1 if s.startswith("-") else 1
    digits = s.lstrip("+-").replace("_", "")
    if _INT.match(s):
        return sign * int(digits)
    if _INT_HEX.match(s):
        return sign * int(digits, 16)
    if _INT_OCT.match(s):
        return sign * int(digits, 8)
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return sign * float("inf")
    if _NAN.match(s):
        return float("nan")
    if s[:1] in "[{&*!|>%@`-" or s.startswith("? "):
        raise ValueError(f"unsupported YAML value: {text!r}")
    return s


def _value(text: str) -> Any:
    s = text.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"unsupported YAML list: {text!r}")
        inner = s[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    return _scalar(s)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse ``key: value`` lines with at most one level of indented sections."""
    lines: List[Tuple[int, str, str]] = []
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"line {n}: tabs in indentation")
        key, sep, rest = line.strip().partition(":")
        if not sep or (rest and not rest[0].isspace()):
            raise ValueError(f"line {n}: expected 'key: value', got {raw!r}")
        lines.append((len(line) - len(line.lstrip()), _scalar(key), rest))
    out: Dict[str, Any] = {}
    section = None
    for i, (indent, key, rest) in enumerate(lines):
        if indent == 0:
            opens = not rest.strip() and i + 1 < len(lines) and lines[i + 1][0] > 0
            section = {} if opens else None
            out[key] = section if opens else _value(rest)
        elif section is None:
            raise ValueError(f"unexpected indentation at key {key!r}")
        elif not rest.strip() and i + 1 < len(lines) and lines[i + 1][0] > indent:
            raise ValueError(f"nesting deeper than one level at key {key!r}")
        else:
            section[key] = _value(rest)
    return out


def read_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return parse_yaml(f.read())
