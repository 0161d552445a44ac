"""Model configuration of the port: the `ModelConfig` fields the faithful
DecNet forward reads (a copy of the schema in decnet_tpu/config.py, which
the port does not import), plus a loader for a checkpoint's `config.json`
sidecar."""
from __future__ import annotations

import dataclasses
import json
import os

import torch

# Keys of a sidecar's "model" section that only the JAX package reads: its
# kernel dispatch, its training-only gradient switch, the adaptive-sampling
# knobs no forward reaches, and the learned-detail binarisation (the port
# takes precomputed masks; see `use_detail`).
_IGNORED_KEYS = frozenset((
    "arch", "matching_impl", "grad_method", "step", "samp_num",
    "sample_spa_size_list", "thold", "thold_mode", "detail_density",
    "s2d_stages", "conv3d_impl", "split_concat"))

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class ModelConfig:
    """Architecture of the faithful (reference-form) DecNet.

    Values the port does not implement yet (learned detail heads, the
    space-to-depth twins, windowed matching, the bicubic skip of fine
    stages, other costs or norms) are refused at construction rather than
    ignored."""
    max_disp: int = 216
    base_channels: int = 8
    num_stage: int = 4
    down_scale: int = 3
    cost_func: str = "cor"
    skip_stage_id: int = 4          # stages >= this would upsample bicubically
    use_detail: bool = False        # masks come from the Gaussian pyramid
    dtype: str = "bfloat16"         # compute dtype; BN and softmax stay f32
    norm: str = "bn"
    s2d_fine: bool = False
    match_temp: float = 1.0
    match_temp_learned: bool = False
    match_window: int = 0
    cand_fallback: bool = False

    def __post_init__(self):
        if self.max_disp % (self.down_scale ** (self.num_stage - 1)):
            raise ValueError(
                f"max_disp ({self.max_disp}) must be divisible by "
                f"down_scale^{self.num_stage - 1}")
        unsupported = {
            "num_stage": self.num_stage != 4,
            "skip_stage_id": self.skip_stage_id < self.num_stage,
            "cost_func": self.cost_func != "cor",
            "use_detail": self.use_detail,
            "norm": self.norm != "bn",
            "s2d_fine": self.s2d_fine,
            "match_window": self.match_window != 0,
            "dtype": self.dtype not in DTYPES,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"ModelConfig values not ported yet: "
                f"{ {k: getattr(self, k) for k in bad} }")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def load_config(path: str, **overrides) -> ModelConfig:
    """ModelConfig from a checkpoint's `config.json` sidecar (or the
    directory holding it).  Unknown model keys raise; `overrides` win."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        raw = json.load(f)
    model = dict(raw.get("model", raw))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(model) - fields - _IGNORED_KEYS
    if unknown:
        raise KeyError(f"{path}: unknown model keys {sorted(unknown)}")
    kw = {k: v for k, v in model.items() if k in fields}
    kw.update(overrides)
    return ModelConfig(**kw)
