"""Configuration of the port: the `ModelConfig`, `LossConfig`,
`TrainConfig` and `DataConfig` fields the DecNet forward and its
training read (a copy of the schema in decnet_tpu/config.py, which the port
does not import), a loader for a checkpoint's `config.json` sidecar, and
`section.key=value` overrides.

Values the port does not implement are refused with NotImplementedError
rather than ignored."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, Optional, Tuple

import torch

# Keys of a sidecar's "model" section that only the JAX package reads: its
# kernel dispatch and execution modes, and the adaptive-sampling knobs no
# forward reaches.
_IGNORED_KEYS = frozenset((
    "arch", "matching_impl", "step", "samp_num",
    "sample_spa_size_list", "conv3d_impl", "split_concat"))

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
COST_FUNCS = ("cor", "cat", "ssd")
NORMS = ("bn", "gn")
GRAD_METHODS = ("detach", "undetach")
THOLD_MODES = ("fixed", "quantile")
VARIANTS = ("default", "stressor", "legacy")


def _refuse(section: str, obj, unsupported: dict, where: str = ""):
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{section} values not ported yet: "
            f"{ {k: getattr(obj, k) for k in bad} }" + where)


@dataclasses.dataclass
class ModelConfig:
    """Architecture of DecNet: the faithful (reference-form) model with 1
    to 4 stages (`num_stage`), the `cor`, `cat` or `ssd` cost, batch or
    group norm (`norm`), the bicubic skip of the fine stages from
    `skip_stage_id` on, learned detail heads (`use_detail`), the
    space-to-depth twins of the full-resolution stage (`s2d_fine`,
    `s2d_stages` 1) and of the 1/3-res stage too (`s2d_stages` 2), and the
    prior-windowed matching (`match_window`).

    Values are validated as the JAX package's asserts do
    (decnet_tpu/config.py:105-109), and a dtype the port has no torch type
    for is refused."""
    max_disp: int = 216
    base_channels: int = 8
    num_stage: int = 4
    down_scale: int = 3
    cost_func: str = "cor"
    # "detach": the coarser stage's prediction enters DynamicUpsampling
    # without gradient (the reference detaches cross-stage predictions)
    grad_method: str = "detach"
    skip_stage_id: int = 4          # stages >= this upsample bicubically
    use_detail: bool = False        # False: masks come from the caller
    thold: float = 0.9              # detail > thold (fixed mode)
    thold_mode: str = "fixed"       # fixed | quantile (shared by the pair)
    detail_density: float = 0.25    # the kept fraction in quantile mode
    dtype: str = "bfloat16"         # compute dtype; BN and softmax stay f32
    norm: str = "bn"
    s2d_fine: bool = False
    s2d_stages: int = 1             # fine stages in s2d form when s2d_fine
    match_temp: float = 1.0
    match_temp_learned: bool = False
    match_window: int = 0
    cand_fallback: bool = False

    def __post_init__(self):
        if self.max_disp % (self.down_scale ** (self.num_stage - 1)):
            raise ValueError(
                f"max_disp ({self.max_disp}) must be divisible by "
                f"down_scale^{self.num_stage - 1}")
        if self.grad_method not in GRAD_METHODS:
            raise ValueError(f"grad_method must be one of {GRAD_METHODS}, "
                             f"got {self.grad_method!r}")
        if self.thold_mode not in THOLD_MODES:
            raise ValueError(f"thold_mode must be one of {THOLD_MODES}, "
                             f"got {self.thold_mode!r}")
        if self.cost_func not in COST_FUNCS:
            raise ValueError(f"cost_func must be one of {COST_FUNCS}, got "
                             f"{self.cost_func!r}")
        if self.norm not in NORMS:
            raise ValueError(f"norm must be one of {NORMS}, got "
                             f"{self.norm!r}")
        if not 1 <= self.num_stage <= 4:
            raise ValueError(f"num_stage must be 1 to 4, got "
                             f"{self.num_stage}")
        if self.s2d_fine and self.s2d_stages not in (1, 2):
            # the extractor packs only its full-res and 1/3-res levels
            raise ValueError(f"s2d_stages must be 1 or 2 with s2d_fine, "
                             f"got {self.s2d_stages}")
        if self.s2d_fine and 1 < self.num_stage <= self.s2d_stages:
            # stage 0 would get packed features (JAX feeds them to its cost
            # volume as they are)
            raise ValueError(f"s2d_stages ({self.s2d_stages}) must be below "
                             f"num_stage ({self.num_stage}) with s2d_fine")
        _refuse("ModelConfig", self, {"dtype": self.dtype not in DTYPES})

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


@dataclasses.dataclass
class LossConfig:
    loss_type: str = "multi_stage_regression_uploss"
    weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    down_func_name: str = "bicubic"     # GT pyramid: bilinear|bicubic|max|min
    if_overmask: bool = False           # zero the sky rows (<108/down)
    alpha: float = 0.1                  # detail-mask loss weight
    sparse_term_scale: float = 1.0      # multiplies 0.2/(10+3.75*stage)
    binary_thold: Optional[float] = None
    sparse_cand_mask: bool = True       # sparse term only where cand > 0

    def __post_init__(self):
        _refuse("LossConfig", self, {
            "down_func_name": self.down_func_name not in (
                "bilinear", "bicubic", "max", "min")})


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-3
    lr_schedule: str = "cosine"         # cosine | constant | piecewise
    warmup_steps: int = 500
    total_steps: int = 300_000
    weight_decay: float = 0.0
    batch_size: int = 8
    crop_h: int = 270
    crop_w: int = 513
    seed: int = 37
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 2000
    log_every: int = 50
    keep_ckpts: int = 5                 # resumable checkpoints kept, newest
    freeze_bn: bool = False             # every step normalises with running stats
    freeze_bn_after: int = 0            # from this step on, as freeze_bn; 0: never
    # the frozen-BN steps of a faithful model run its packed s2d twin
    # (models/repack.py::repack_linear); needs freeze_bn or freeze_bn_after
    packed_exec: bool = False
    max_rss_gb: float = 80.0            # a TPU-host guard; not read here

    def __post_init__(self):
        if self.lr_schedule not in ("cosine", "constant", "piecewise"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")


@dataclasses.dataclass
class MeshConfig:
    """The (data, tile, disp) mesh: images, image rows and stage-0
    hypotheses split over processes (`parallel/mesh.py`); data -1 takes
    every process left."""
    data: int = -1
    tile: int = 1
    disp: int = 1


@dataclasses.dataclass
class DataConfig:
    dataset: str = "sceneflow"
    root: str = ""
    split: str = "train"
    img_rows: int = 540
    img_cols: int = 960
    num_workers: int = 4
    mask_thold: float = 0.3
    mask_source: str = "compute"
    on_device: bool = False
    variant: str = "default"

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{self.variant!r}")


_SECTIONS = {"model": ModelConfig, "loss": LossConfig, "train": TrainConfig,
             "mesh": MeshConfig, "data": DataConfig}


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Strict: unknown keys raise (model keys only the JAX package reads
        are skipped, see `_IGNORED_KEYS`)."""
        unknown = set(d) - set(_SECTIONS)
        if unknown:
            raise KeyError(f"unknown config sections {sorted(unknown)}")
        built = {}
        for name, tp in _SECTIONS.items():
            fields = {f.name for f in dataclasses.fields(tp)}
            sub = dict(d.get(name, {}))
            if name == "model":
                sub = {k: v for k, v in sub.items() if k not in _IGNORED_KEYS}
            bad = set(sub) - fields
            if bad:
                raise KeyError(f"unknown config keys {name}.{sorted(bad)}")
            built[name] = tp(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in sub.items()})
        return cls(**built)

    def apply_overrides(self, overrides: Iterable[str]) -> "Config":
        """A new Config with 'section.key=value' overrides applied, e.g.
        model.max_disp=54 (values parsed by the type of the current one)."""
        d = self.to_dict()
        for ov in overrides:
            key, sep, val = ov.partition("=")
            section, _, name = key.partition(".")
            if not sep or section not in d or name not in d[section]:
                raise KeyError(f"bad override {ov!r}: want section.key=value "
                               f"with a known key")
            d[section][name] = _parse_value(val, d[section][name])
        return Config.from_dict(d)


def _parse_value(val: str, old):
    """`val` parsed like the JAX package's overrides: by the old value's
    type; 'none'/'null' clears an optional field."""
    if val.lower() in ("none", "null") and not isinstance(old, str):
        return None
    if old is None:
        try:
            return _int_or_float(val)
        except ValueError:
            return val
    if isinstance(old, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(val)
    if isinstance(old, float):
        return float(val)
    if isinstance(old, (tuple, list)):
        if val.startswith("["):
            return tuple(json.loads(val))
        return tuple(_int_or_float(x) for x in val.split(","))
    return val


def _int_or_float(x: str):
    try:
        return int(x)
    except ValueError:
        return float(x)


def _read_config(path: str) -> dict:
    """A config file as a dict: JSON, or YAML (`.yaml`/`.yml`) through
    PyYAML as the JAX package reads it; a directory means its
    `config.json`."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            try:
                import yaml
            except ImportError:
                raise ImportError(f"{path}: a YAML config needs PyYAML, "
                                  f"which does not import here; pass a "
                                  f"JSON config") from None
            return yaml.safe_load(f) or {}
        return json.load(f)


def load_full_config(path: str, overrides: Iterable[str] = ()) -> Config:
    """The whole Config from a `config.json` or YAML file (or the
    directory holding a `config.json`), with 'section.key=value' overrides applied."""
    return Config.from_dict(_read_config(path)).apply_overrides(overrides)


def load_config(path: str, **overrides) -> ModelConfig:
    """ModelConfig from a checkpoint's `config.json` sidecar (or the
    directory holding it).  Unknown model keys raise; `overrides` win."""
    raw = _read_config(path)
    model = dict(raw.get("model", raw))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(model) - fields - _IGNORED_KEYS
    if unknown:
        raise KeyError(f"{path}: unknown model keys {sorted(unknown)}")
    kw = {k: v for k, v in model.items() if k in fields}
    kw.update(overrides)
    return ModelConfig(**kw)
