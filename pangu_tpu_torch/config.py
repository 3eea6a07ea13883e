"""Model geometry of the port: the counterpart of ``pangu_tpu/config.py``.

Kept: ``ModelConfig`` with its derived token geometry and its
stochastic-depth schedule (``drop_path_max``, ``drop_path_rates``),
``StageGeometry``, ``TrainConfig`` (its LoRA fields included), ``DataConfig``,
``MeshConfig``, ``Config`` (``PANGU_DATA`` / ``PANGU_OUT`` give the data and
output roots), the presets ``PANGU_24``, ``TINY`` and ``MID``, and
``load_config`` (a JSON file plus ``a.b.c=value`` overrides).  The JAX
package's TPU tuning fields of XLA's attention (:data:`TPU_TUNING_FIELDS`:
``lon_chunk``, ``attn_unroll``) have no counterpart here: ``load_config``
accepts them from a JAX config file and drops them with one logged warning.
``fast_math`` (bf16 LayerNorm statistics, CPU/interpret only in the JAX
package) exists so such a file loads; the port has no bf16-statistics
LayerNorm, so ``True`` raises ``ValueError``.

Training and LoRA, as in the JAX package: ``remat`` recomputes each block of
the per-block path in the backward (``torch.utils.checkpoint``); ``train_fused``
trains through the whole-block kernels (False: the per-block path,
``models/pangu.py::run_stage_blocks``); ``grid_bwd`` is the grid attention's
backward, ``"pallas"`` (one kernel, ``grid_attention_bwd``) or ``"xla"``
(autograd of the reference composition through the ``sdpa`` kernels), on the
per-block path and in the v2 training stage; ``lora_fused`` merges LoRA
factors into the dense kernels inside ``forward`` where that is exact (served,
or trained without element-mode LoRA dropout) so the fused trunks run.

``attn_impl`` switches the whole dispatch, as in the JAX package:
``"pallas"`` runs the port's kernels wherever the JAX package runs its
Pallas kernels; ``"xla"`` runs the model as the JAX package's XLA layers,
block by block (``models/layers.py::earth_block``, ``down_sample``,
``up_sample``), with no kernel at all.  The port's default is ``"pallas"``
(every preset means the kernel path); the JAX package's is ``"xla"``, which
its command lines turn to ``"pallas"`` with ``--pallas``.

``block_layout`` selects the trunk's inter-block storage, served and
trained: ``"wm"`` (default) the window-major trunk (``ops/earth_block_wm``,
``ops/earth_block_bwd``); ``"v2"`` the rolled-coordinate grid trunk
(``ops/earth_block_fused``), whose stages roll back at their end.  Both take
any depth: under ``"wm"`` an odd stage depth leaves the all-window-major
trunk (``models/pangu.py::wm_core_supported``) for the canonical stage
chain, as in the JAX package.  ``lat_group`` has no effect under ``"v2"``,
as in the JAX package.

``edge_kernels=True`` selects the edge kernels (``ops/embed_wm``,
``ops/recovery_wm``) on geometries that pass :func:`embed_supported` and
:func:`recovery_supported`, and raises ``ValueError`` on any other and under
``block_layout="v2"`` (they read and write window-major storage, which the
v2 trunk never holds; the JAX package silently skips them there).  They run
only where the all-window-major trunk runs: odd depths, ``attn_impl="xla"``
or unmerged LoRA leaves skip them, as in the JAX package.
``lat_group`` (default 2, as in the JAX package) is the number of latitude
windows the grouped block kernel takes together (:func:`_pick_gh`); it must
be at least 1.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Mapping, Optional, Sequence, Tuple

# ModelConfig fields of the JAX package that tune XLA's attention on a TPU;
# load_config drops them (the port's kernels have no such knob)
TPU_TUNING_FIELDS = ("lon_chunk", "attn_unroll")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@dataclasses.dataclass(frozen=True)
class StageGeometry:
    """Static token-grid geometry of one encoder/decoder stage."""

    z: int            # token planes (surface plane + upper planes)
    h: int            # latitude tokens
    w: int            # longitude tokens
    h_padded: int     # latitude tokens padded to a window multiple
    dim: int
    heads: int
    depth: int
    window: Tuple[int, int, int]

    @property
    def num_window_types(self) -> int:
        # one earth-specific bias slice per (Z, lat) window position,
        # shared across longitude
        return (self.z // self.window[0]) * (self.h_padded // self.window[1])

    @property
    def window_tokens(self) -> int:
        wz, wh, ww = self.window
        return wz * wh * ww


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Geometry + architecture of the Earth-specific 3D Swin transformer."""

    upper_vars: int = 5
    surface_vars: int = 4
    const_masks: int = 3        # land/soil/topography planes appended to surface
    levels: int = 13
    lat: int = 721
    lon: int = 1440
    patch: Tuple[int, int, int] = (2, 4, 4)     # (Z, H, W)
    window: Tuple[int, int, int] = (2, 6, 12)   # (Z, H, W)
    depths: Tuple[int, ...] = (2, 6, 6, 2)
    heads: Tuple[int, ...] = (6, 12, 12, 6)
    dims: Tuple[int, ...] = (192, 384, 384, 192)
    drop_path_max: float = 0.2
    mlp_ratio: int = 4
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    gelu: str = "erf"           # "erf" (exact, parity) | "tanh" (perf config)
    edge_kernels: bool = False  # True: embed_wm / recovery_wm kernels
    lat_group: int = 2          # lat windows per grouped block (_pick_gh)
    block_layout: str = "wm"    # "wm" window-major | "v2" rolled grid trunk
    remat: bool = True          # recompute per-block training blocks
    train_fused: bool = True    # train through the whole-block kernels
    grid_bwd: str = "pallas"    # grid attention backward: "pallas" | "xla"
    lora_fused: bool = True     # merge LoRA into the kernels where exact
    # "pallas": the kernels; "xla": the plain layers.  The JAX default is
    # "xla" (its CLIs map --pallas to "pallas"); the port's is "pallas"
    attn_impl: str = "pallas"
    fast_math: bool = False     # bf16 LayerNorm statistics: not in the port

    def __post_init__(self):
        pz, ph, pw = self.patch
        if self.lon % pw != 0:
            raise ValueError("lon must be a multiple of the W patch size")
        if (self.lon // pw) % self.window[2] != 0:
            raise ValueError("lon tokens must be a multiple of the W window")
        if len(self.depths) != 4:
            raise ValueError("expect 4 stages (enc, enc, dec, dec)")
        if self.block_layout not in ("wm", "v2"):
            raise ValueError(f"block_layout must be 'wm' or 'v2', not "
                             f"{self.block_layout!r}")
        if self.attn_impl not in ("xla", "pallas"):
            raise ValueError(f"attn_impl must be 'xla' or 'pallas', not "
                             f"{self.attn_impl!r}")
        if self.edge_kernels and self.block_layout == "v2":
            raise ValueError("edge_kernels=True needs block_layout='wm': the "
                             "edge kernels read and write window-major storage")
        if self.gelu not in ("erf", "tanh"):
            raise ValueError(f"gelu must be 'erf' or 'tanh', not {self.gelu!r}")
        if self.edge_kernels and not (embed_supported(self)
                                      and recovery_supported(self)):
            raise ValueError(
                "edge_kernels=True: the geometry fails embed_supported / "
                f"recovery_supported (patch {self.patch}, window "
                f"{self.window}, {self.w_tokens} longitude tokens, "
                f"{self.upper_vars} upper variables)")
        if self.grid_bwd not in ("pallas", "xla"):
            raise ValueError(f"grid_bwd must be 'pallas' or 'xla', not "
                             f"{self.grid_bwd!r}")
        if self.lat_group < 1:
            raise ValueError(f"lat_group must be at least 1, not "
                             f"{self.lat_group}")
        if self.fast_math:
            raise ValueError("fast_math=True (bf16 LayerNorm statistics) is "
                             "the JAX package's CPU/interpret-only mode; the "
                             "port's LayerNorms keep float32 statistics (the "
                             "perf config is gelu='tanh')")

    @property
    def gelu_tanh(self) -> bool:
        return self.gelu == "tanh"

    # ---- derived embedding geometry -------------------------------------
    @property
    def lat_padded(self) -> int:
        return _round_up(self.lat, self.patch[1])

    @property
    def levels_padded(self) -> int:
        return _round_up(self.levels, self.patch[0])

    @property
    def upper_planes(self) -> int:
        return self.levels_padded // self.patch[0]

    @property
    def z_tokens(self) -> int:
        # +1: the surface plane is stacked under the upper planes
        return self.upper_planes + 1

    @property
    def h_tokens(self) -> int:
        return self.lat_padded // self.patch[1]

    @property
    def w_tokens(self) -> int:
        return self.lon // self.patch[2]

    @property
    def upper_patch_features(self) -> int:
        pz, ph, pw = self.patch
        return (self.upper_vars + 1) * pz * ph * pw  # +1: const_h plane

    @property
    def surface_patch_features(self) -> int:
        _, ph, pw = self.patch
        return (self.surface_vars + self.const_masks) * ph * pw

    # ---- stage geometry --------------------------------------------------
    def stage(self, i: int) -> StageGeometry:
        """Token geometry of stage i (0/3 full res, 1/2 half res)."""
        if i in (0, 3):
            z, h, w = self.z_tokens, self.h_tokens, self.w_tokens
        else:
            z = self.z_tokens
            h = _cdiv(self.h_tokens, 2)
            w = self.w_tokens // 2
        return StageGeometry(
            z=z, h=h, w=w,
            h_padded=_round_up(h, self.window[1]),
            dim=self.dims[i], heads=self.heads[i], depth=self.depths[i],
            window=self.window,
        )

    @property
    def total_blocks(self) -> int:
        return sum(self.depths)

    def drop_path_rates(self) -> Tuple[float, ...]:
        """Linearly scheduled stochastic-depth rates over all blocks."""
        n = self.total_blocks
        if n == 1:
            return (0.0,)
        return tuple(self.drop_path_max * i / (n - 1) for i in range(n))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters, the JAX package's defaults: Adam with L2
    folded into the gradient, a MultiStep schedule over epochs, the weighted
    L1 loss, early stopping and the LoRA fine-tuning set-up."""

    epochs: int = 100
    lr: float = 5e-6
    weight_decay: float = 3e-6   # L2 into the gradient (torch Adam's meaning)
    batch_size: int = 2
    eval_batch_size: int = 1
    lr_milestones: Tuple[int, ...] = (25, 50)   # epochs
    lr_gamma: float = 0.5
    upper_weights: Tuple[float, ...] = (3.00, 0.60, 1.50, 0.77, 0.54)
    surface_weights: Tuple[float, ...] = (1.50, 0.77, 0.66, 3.00)
    surface_loss_weight: float = 0.25
    save_interval: int = 1       # epochs between checkpoints
    save_steps: int = 0          # >0: also checkpoint every N optimizer steps
    val_interval: int = 1
    early_stop_patience: int = 5
    seed: int = 99
    # LoRA (``models/lora.py::init_lora``): rank, alpha, dropout rate of the
    # branch input and its mode ("element": per-token masks, unmerged;
    # "feature": one token-constant mask per step, merged exactly)
    lora_rank: int = 16
    lora_alpha: float = 16.0
    lora_dropout: float = 0.1
    lora_dropout_mode: str = "element"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Host-side ERA5 pipeline configuration, the JAX package's fields and
    defaults."""

    nc_path: str = os.environ.get("PANGU_DATA", "/data/pangu")
    aux_path: str = ""           # defaults to <nc_path>/aux_data
    horizon: int = 24            # forecast horizon in hours
    train_start: str = "20150101"
    train_end: str = "20171231"
    train_freq: str = "12h"
    val_start: str = "20190101"
    val_end: str = "20191231"
    val_freq: str = "12h"
    test_start: str = "20180103"
    test_end: str = "20180117"
    test_freq: str = "12h"
    prefetch: int = 2            # batches the loader holds ready
    num_workers: int = 4         # loader threads

    upper_variables: Tuple[str, ...] = ("z", "q", "t", "u", "v")
    surface_variables: Tuple[str, ...] = ("msl", "u10", "v10", "t2m")
    # pressure levels, canonical order: index 0 is 1000 hPa
    levels_hpa: Tuple[str, ...] = (
        "1000", "925", "850", "700", "600", "500", "400",
        "300", "250", "200", "150", "100", "50",
    )

    def resolved_aux_path(self) -> str:
        return self.aux_path or os.path.join(self.nc_path, "aux_data")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: dp the batch, sp the longitude windows, tp the z
    windows of the window-major trunk (and with them the bias tables).  The
    port serves and trains under a mesh of ``torch.distributed`` ranks
    (``parallel/``); what has no sharded path yet raises there."""

    dp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.sp * self.tp


def _pick_gh(nlat: int, target: int) -> int:
    """Largest divisor of nlat <= target: the latitude windows one grouped
    block takes together (``pangu_tpu/ops/earth_block_wm.py::_pick_gh``)."""
    for g in range(min(nlat, max(1, target)), 0, -1):
        if nlat % g == 0:
            return g
    return 1


def embed_supported(cfg: ModelConfig) -> bool:
    """The geometry ``ops/embed_wm`` takes (the gate of the JAX package's
    ``ops/embed_wm.py::embed_supported``)."""
    pz, ph, pw = cfg.patch
    wz, wh, ww = cfg.window
    return (pw == 4 and ph == 4 and pz == 2 and wz == 2
            and cfg.w_tokens % ww == 0 and wh % 2 == 0
            and (cfg.upper_vars + 1) * pz * ph % 8 == 0)


def recovery_supported(cfg: ModelConfig) -> bool:
    """The geometry ``ops/recovery_wm`` takes (the gate of the JAX package's
    ``ops/recovery_wm.py::recovery_supported``)."""
    pz, ph, pw = cfg.patch
    wz, wh, ww = cfg.window
    return (pw == 4 and ph == 4 and pz == 2 and wz == 2
            and cfg.upper_vars * pz * ph * pw <= 256
            and cfg.w_tokens % ww == 0)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    output_path: str = os.environ.get("PANGU_OUT", "result")


# ---------------------------------------------------------------------------
# Presets: the geometry of pangu_tpu.config's; edge_kernels (False here,
# True there) and attn_impl ("pallas" here, "xla" there) differ
# ---------------------------------------------------------------------------

PANGU_24 = ModelConfig()

# Miniature geometry with the same structural quirks as the real grid (odd
# latitude -> nonzero lat padding, odd half-res latitude, Z padding).
TINY = ModelConfig(
    levels=5,
    lat=49,
    lon=192,
    depths=(2, 2, 2, 2),
    heads=(2, 4, 4, 2),
    dims=(16, 32, 32, 16),
    remat=False,
)

# Mid-size geometry (~1/3 linear of the full grid, full level count).
MID = ModelConfig(
    levels=13,
    lat=241,
    lon=480,
    depths=(2, 2, 2, 2),
    heads=(4, 8, 8, 4),
    dims=(48, 96, 96, 48),
    remat=False,
)


# ---------------------------------------------------------------------------
# Overrides: nested-dict merge from a JSON file / CLI ("a.b.c=v")
# ---------------------------------------------------------------------------

def _replace_nested(obj, updates: Mapping[str, Any], dropped: list):
    own = {}
    for k, v in updates.items():
        field = next((f for f in dataclasses.fields(obj) if f.name == k), None)
        if field is None:
            if isinstance(obj, ModelConfig) and k in TPU_TUNING_FIELDS:
                dropped.append(k)
                continue
            raise KeyError(f"unknown config field {k!r} on {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, Mapping):
            own[k] = _replace_nested(cur, v, dropped)
        elif isinstance(cur, tuple) and isinstance(v, Sequence) and not isinstance(v, str):
            own[k] = tuple(v)
        elif isinstance(cur, str):
            # string fields stay strings (a date window "20180103" would
            # otherwise JSON-parse to an int)
            own[k] = str(v)
        else:
            own[k] = v
    return dataclasses.replace(obj, **own)


def load_config(path: Optional[str] = None, overrides: Sequence[str] = (),
                base: Optional[Config] = None) -> Config:
    """A Config from ``base`` (default ``Config()``), an optional JSON file and
    ``a.b.c=value`` overrides, in that order.  The JAX package's
    :data:`TPU_TUNING_FIELDS` are dropped with one warning."""
    cfg = Config() if base is None else base
    dropped: list = []
    if path:
        with open(path) as f:
            cfg = _replace_nested(cfg, json.load(f), dropped)
    nested: dict = {}
    for item in overrides:
        key, _, raw = item.partition("=")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        node = nested
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    if nested:
        cfg = _replace_nested(cfg, nested, dropped)
    if dropped:
        logging.getLogger(__name__).warning(
            "config: dropped %s (TPU tuning of XLA's attention; the port's "
            "kernels have no such setting)", ", ".join(sorted(set(dropped))))
    return cfg
