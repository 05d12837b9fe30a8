"""Config system: typed dataclasses + a YAML subset + ``key=value`` overrides.

A copy of ``ivosw_tpu/core/config.py`` (same fields, defaults and override
rules) whose loader reads ``configs/config.yaml`` without the ``yaml``
package: the file is flat ``key: value`` lines plus one level of nested
groups, and :func:`parse_simple_yaml` reads exactly that form.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class DataConfig:
    # reference: configs/config.yaml:11-16
    # num_workers: surface-parity only, INERT — host DataLoader prefetch in
    # the reference (train_agent.py:181); this framework has no DataLoader
    num_workers: int = 2
    root_dir_davis: str = "data/DAVIS"
    root_dir_scribble_youtube_vos: str = "data/Scribble_Youtube_VOS"
    subset: str = "train"
    len_subseq: int = 25


@dataclass
class DavisInteractiveConfig:
    # reference: configs/config.yaml:17-22
    metric: str = "J_AND_F"  # J | F | J_AND_F
    allow_repeat: int = 1
    max_nb_interactions: int = 5
    # per-object wall-clock budget in seconds for one sample; 0 = unlimited.
    # The reference declares this knob but never reads it (its drivers pass
    # max_time=None, eval_agent_atnet.py:62); here it IS wired to the
    # session's per-sample budget (max_time_per_interaction * n_objects)
    max_time_per_interaction: int = 0
    # combine_th: surface-parity only, INERT — present in the reference YAML
    # (configs/config.yaml:22) but never read by any reference code path
    combine_th: float = 0.4
    # scribble-robot tuning; the reference sets min_nb_nodes on the
    # davisinteractive robot from backbone config (eval_agent_atnet.py:193)
    robot_min_nb_nodes: int = 4
    robot_nb_points: int = 25


@dataclass
class AssessNetConfig:
    # reference: configs/config.yaml:23-30
    num_epochs: int = 50
    lr: float = 5e-6
    gamma: float = 0.95
    momentum: float = 0.9
    weight_decay: float = 5e-4
    train_batch_size: int = 32
    # num_workers: surface-parity only, INERT (see DataConfig.num_workers)
    num_workers: int = 12
    # optional path to a torchvision-format resnet50 state_dict; when set,
    # train_assess starts from the ImageNet trunk like the reference's
    # resnet50(pretrained=True) encoder (models/assessment.py:28-39)
    imagenet_ckpt: str = ""
    # odd moving-average window over the predicted per-frame quality in the
    # wild setting; 1 (default) = reference behaviour (raw per-frame
    # predictions). Denoises the recommendation state: quality structure is
    # contiguous (bands/segments) while QA prediction error is per-frame
    smooth_quality: int = 1
    # fold BatchNorm + stem normalisation into conv weights for the wild
    # scoring path (inference-only graph; bf16-tolerance parity with the
    # live-BN forward — models/fold.py). Pure perf knob.
    fold_inference: bool = True
    # frames per compiled block in the fused wild scoring pass; 0 = module
    # default (interact/recommend.py::FRAME_CHUNK). Pure perf knob: larger
    # chunks amortise dispatch, smaller ones waste less tail padding
    score_chunk: int = 0
    # bf16 storage of the QA pass's frames and prob maps. The port's crop
    # kernel reads float32 frames and prob planes, so the port refuses
    # True (eval/eval_agent.py) until a later slice adds a bf16 reader.
    bf16_inputs: bool = False


@dataclass
class AgentConfig:
    # reference: configs/config.yaml:31-48
    save_result_dir: str = "train"
    reward_csv: str = "reward.csv"
    pretrain_csv: str = "pretrain.csv"
    sample_th: float = 0.05
    optimizer: str = "adam"
    lr: float = 5e-6
    # lr_pow: surface-parity only, INERT — in the reference YAML
    # (configs/config.yaml:38) but never read by any reference code path
    lr_pow: float = 0.9
    momentum: float = 0.9
    weight_decay: float = 5e-4
    memory_size: int = 100000
    gamma: float = 0.95
    eps_start: float = 0.7
    eps_end: float = 0.25
    # eps_k: surface-parity only, INERT — in the reference YAML
    # (configs/config.yaml:45) but never read by any reference code path
    eps_k: int = 5
    eps_decay: int = 500
    update_rate: float = 0.05
    train_batch_size: int = 32


@dataclass
class Config:
    # reference: configs/config.yaml:1-9
    seed: int = 0
    gpu_id: int = 0  # kept for config-surface parity; unused by the port
    phase: str = "eval"  # baseline | pretrain | train | eval
    setting: str = "wild"  # oracle | wild
    method: str = "ours"  # ours | worst | random | linspace
    num_epochs: int = 1
    dataset: str = "davis"  # davis | ytbvos
    ckpt_dir: str = "weights"
    vos: str = "tapnet"  # tapnet | matchnet | ipnet | fake (JAX-native backbones)
    # evaluation round count; the reference hardcodes 8 in its eval drivers
    # (eval_agent_atnet.py:61) while davis_interactive.max_nb_interactions
    # governs training — kept separate here for the same reason
    eval_rounds: int = 8
    # eval_dp_shards / eval_sp_shards: >1 is refused by the port until the
    # parallelism slice lands (eval/eval_agent.py).
    # >1: data-parallel eval sweep — sequences shard round-robin over this
    # many devices (evaluate_dp); the merged curve equals the single-device
    # one (no reference equivalent: it is strictly single-GPU)
    eval_dp_shards: int = 1
    # >1: sequence-parallel wild scoring — every AssessNet scoring chunk has
    # its FRAME axis sharded over this many devices
    # (parallel/mesh.py::frame_sharded_score_clip); scores equal the
    # single-device pass. Exclusive with eval_dp_shards>1 (DP already owns
    # the devices, one sequence per shard). No reference equivalent: its
    # only answer to long clips is subsampling (SURVEY §5)
    eval_sp_shards: int = 1

    data: DataConfig = field(default_factory=DataConfig)
    davis_interactive: DavisInteractiveConfig = field(
        default_factory=DavisInteractiveConfig
    )
    assess_net: AssessNetConfig = field(default_factory=AssessNetConfig)
    agent: AgentConfig = field(default_factory=AgentConfig)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def default_config() -> Config:
    return Config()


def _coerce(value: str, target_type: type) -> Any:
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    return value


def apply_override(cfg: Config, dotted_key: str, value: Any) -> None:
    """Set ``cfg.a.b.c = value`` with type coercion from the field type."""
    parts = dotted_key.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key: {dotted_key}")
    current = getattr(obj, leaf)
    if isinstance(value, str) and current is not None:
        value = _coerce(value, type(current))
    setattr(obj, leaf, value)


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``key=value`` CLI overrides (sacred ``with`` equivalent)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got: {item!r}")
        key, value = item.split("=", 1)
        apply_override(cfg, key.strip(), value.strip())
    return cfg


def _update_dataclass(obj: Any, data: Dict[str, Any]) -> None:
    for key, value in data.items():
        if not hasattr(obj, key):
            raise KeyError(f"unknown config key: {key}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _update_dataclass(current, value)
        else:
            setattr(obj, key, value)


def _scalar(text: str) -> Any:
    """YAML 1.1 scalar typing for the forms the config file uses."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_simple_yaml(text: str) -> Dict[str, Any]:
    """Parse flat ``key: value`` lines with one level of indented groups.

    Comments (``#`` at line start or after whitespace) and blank lines are
    skipped. Anything deeper than one nesting level raises ValueError."""
    out: Dict[str, Any] = {}
    group: Optional[Dict[str, Any]] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw
        for i, ch in enumerate(raw):
            if ch == "#" and (i == 0 or raw[i - 1] in " \t"):
                line = raw[:i]
                break
        if not line.strip():
            continue
        indented = line[0] in " \t"
        key, sep, value = line.strip().partition(":")
        if not sep:
            raise ValueError(f"line {lineno}: expected 'key: value', got {raw!r}")
        key, value = key.strip(), value.strip()
        if not indented:
            if value:
                out[key] = _scalar(value)
                group = None
            else:
                group = out.setdefault(key, {})
        elif group is not None and value:
            group[key] = _scalar(value)
        else:
            raise ValueError(f"line {lineno}: unsupported nesting in {raw!r}")
    return out


def load_config(
    yaml_path: Optional[str] = None, overrides: Optional[List[str]] = None
) -> Config:
    """Build a Config from an optional YAML file plus CLI overrides."""
    cfg = Config()
    if yaml_path is not None and os.path.exists(yaml_path):
        with open(yaml_path) as fp:
            _update_dataclass(cfg, parse_simple_yaml(fp.read()))
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg
