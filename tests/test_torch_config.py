"""The port's model geometry equals the JAX package's on every preset, and
values the port does not take raise instead of being ignored: an unknown
``block_layout``, ``grid_bwd`` or ``attn_impl``, and the edge kernels under
``block_layout="v2"`` (the JAX package silently skips them there).  Odd
stage depths are accepted under both layouts, as by the JAX package.  The
training and LoRA fields (``remat``, ``train_fused``, ``grid_bwd``,
``lora_fused``; ``TrainConfig``'s ``lora_*``) equal the JAX package's on
every preset."""

import dataclasses

import pytest

import pangu_tpu.config as JC
import pangu_tpu_torch.config as PC

PRESETS = ["PANGU_24", "TINY", "MID"]
DERIVED = ["lat_padded", "levels_padded", "upper_planes", "z_tokens",
           "h_tokens", "w_tokens", "upper_patch_features",
           "surface_patch_features", "total_blocks"]
SHARED_FIELDS = ["upper_vars", "surface_vars", "const_masks", "levels", "lat",
                 "lon", "patch", "window", "depths", "heads", "dims",
                 "mlp_ratio", "param_dtype", "compute_dtype",
                 "gelu", "lat_group", "drop_path_max", "block_layout",
                 "remat", "train_fused", "grid_bwd", "lora_fused"]


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("preset", PRESETS)
def test_stage_geometry_matches_jax(preset, stage):
    want = getattr(JC, preset).stage(stage)
    got = getattr(PC, preset).stage(stage)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("num_window_types", "window_tokens"):
        assert getattr(got, prop) == getattr(want, prop)


@pytest.mark.parametrize("preset", PRESETS)
def test_model_config_matches_jax(preset):
    want, got = getattr(JC, preset), getattr(PC, preset)
    for name in SHARED_FIELDS + DERIVED:
        assert getattr(got, name) == getattr(want, name), name


def test_pangu_24_full_width_geometry():
    g0, g1 = PC.PANGU_24.stage(0), PC.PANGU_24.stage(1)
    assert (g0.z, g0.h_padded, g0.w, g0.dim) == (8, 186, 1440 // 4, 192)
    assert (g1.z, g1.h_padded, g1.w, g1.dim) == (8, 96, 180, 384)
    assert g0.num_window_types == 124 and g1.num_window_types == 64
    assert g0.window_tokens == 144


@pytest.mark.parametrize("lat_group", [1, 2, 3, 16])
def test_lat_group_at_least_one_is_accepted(lat_group):
    assert dataclasses.replace(PC.PANGU_24,
                               lat_group=lat_group).lat_group == lat_group


def test_lat_group_defaults_to_jax_default():
    assert PC.ModelConfig().lat_group == JC.ModelConfig().lat_group == 2


@pytest.mark.parametrize("lat_group", [0, -1])
def test_lat_group_below_one_raises(lat_group):
    with pytest.raises(ValueError, match="lat_group"):
        dataclasses.replace(PC.PANGU_24, lat_group=lat_group)


@pytest.mark.parametrize("nlat,target,want", [
    (31, 2, 1), (16, 2, 2), (3, 2, 1), (6, 2, 2), (6, 4, 3), (2, 2, 2),
    (16, 0, 1)])
def test_pick_gh_matches_jax(nlat, target, want):
    from pangu_tpu.ops.earth_block_wm import _pick_gh
    assert PC._pick_gh(nlat, target) == _pick_gh(nlat, target) == want


GATE_VARIANTS = [{}, {"patch": (1, 4, 4)}, {"window": (2, 5, 12)},
                 {"window": (1, 6, 12)}, {"upper_vars": 9}]


@pytest.mark.parametrize("change", GATE_VARIANTS)
@pytest.mark.parametrize("preset", PRESETS)
def test_edge_gates_match_jax(preset, change):
    want = dataclasses.replace(getattr(JC, preset), **change)
    got = dataclasses.replace(getattr(PC, preset), **change)
    from pangu_tpu.ops.embed_wm import embed_supported
    from pangu_tpu.ops.recovery_wm import recovery_supported
    assert PC.embed_supported(got) == embed_supported(want)
    assert PC.recovery_supported(got) == recovery_supported(want)


@pytest.mark.parametrize("preset", PRESETS)
def test_edge_kernels_accepted_on_presets(preset):
    cfg = dataclasses.replace(getattr(PC, preset), edge_kernels=True)
    assert cfg.edge_kernels


@pytest.mark.parametrize("change", GATE_VARIANTS[1:])
def test_edge_kernels_on_unsupported_geometry_raise(change):
    dataclasses.replace(PC.TINY, **change)          # fine without the kernels
    with pytest.raises(ValueError, match="embed_supported"):
        dataclasses.replace(PC.TINY, edge_kernels=True, **change)


@pytest.mark.parametrize("change", [{"gelu": "relu"},
                                    {"attn_impl": "cuda"}])
def test_invalid_values_raise(change):
    with pytest.raises(ValueError):
        dataclasses.replace(PC.TINY, **change)


@pytest.mark.parametrize("layout", ["wm", "v2"])
def test_block_layout_values_of_jax_are_accepted(layout):
    want = dataclasses.replace(JC.TINY, block_layout=layout)
    assert dataclasses.replace(PC.TINY, block_layout=layout).block_layout \
        == want.block_layout == layout


@pytest.mark.parametrize("grid_bwd", ["pallas", "xla"])
def test_grid_bwd_values_of_jax_are_accepted(grid_bwd):
    want = dataclasses.replace(JC.TINY, grid_bwd=grid_bwd)
    assert dataclasses.replace(PC.TINY, grid_bwd=grid_bwd).grid_bwd \
        == want.grid_bwd == grid_bwd


@pytest.mark.parametrize("grid_bwd", ["cuda", "XLA", ""])
def test_unknown_grid_bwd_raises(grid_bwd):
    with pytest.raises(ValueError, match="grid_bwd"):
        dataclasses.replace(PC.TINY, grid_bwd=grid_bwd)


@pytest.mark.parametrize("layout", ["canon", "V2", ""])
def test_unknown_block_layout_raises(layout):
    with pytest.raises(ValueError, match="block_layout"):
        dataclasses.replace(PC.TINY, block_layout=layout)


@pytest.mark.parametrize("depths", [(2, 3, 3, 2), (1, 1, 1, 1), (3, 6, 5, 2)])
def test_odd_depths_only_under_v2(depths):
    """Named for the refusal it once pinned; odd depths are accepted under
    both layouts, as by the JAX package, and under ``"wm"`` they leave the
    all-window-major trunk for the canonical stage chain."""
    from pangu_tpu_torch.models import pangu
    import torch
    for layout in ("wm", "v2"):
        cfg = dataclasses.replace(PC.TINY, depths=depths, block_layout=layout)
        want = dataclasses.replace(JC.TINY, depths=depths,
                                   block_layout=layout)
        assert cfg.depths == want.depths == depths
        assert cfg.total_blocks == sum(depths)
    params = pangu.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    wm = dataclasses.replace(cfg, block_layout="wm")
    assert not pangu.wm_core_supported(params, wm)
    even = pangu.init_params(torch.Generator().manual_seed(0), PC.TINY,
                             device="cpu")
    assert pangu.wm_core_supported(even, PC.TINY)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_attn_impl_values_of_jax_are_accepted(attn_impl):
    want = dataclasses.replace(JC.TINY, attn_impl=attn_impl)
    assert dataclasses.replace(PC.TINY, attn_impl=attn_impl).attn_impl \
        == want.attn_impl == attn_impl


@pytest.mark.parametrize("attn_impl", ["cuda", "Pallas", ""])
def test_unknown_attn_impl_raises(attn_impl):
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(PC.TINY, attn_impl=attn_impl)


def test_attn_impl_defaults():
    """The port's presets mean the kernel path ("pallas"); the JAX
    package's default is "xla" (its command lines map --pallas)."""
    assert all(getattr(PC, p).attn_impl == "pallas" for p in PRESETS)
    assert JC.ModelConfig().attn_impl == "xla"


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_wm_core_needs_pallas(attn_impl):
    from pangu_tpu_torch.models import pangu
    import torch
    params = pangu.init_params(torch.Generator().manual_seed(0), PC.TINY,
                               device="cpu")
    cfg = dataclasses.replace(PC.TINY, attn_impl=attn_impl)
    assert pangu.wm_core_supported(params, cfg) == (attn_impl == "pallas")


@pytest.mark.parametrize("preset", PRESETS)
def test_v2_refuses_edge_kernels(preset):
    v2 = dataclasses.replace(getattr(PC, preset), block_layout="v2")
    assert not v2.edge_kernels
    with pytest.raises(ValueError, match="block_layout"):
        dataclasses.replace(v2, edge_kernels=True)


TRAIN_FIELDS = ["epochs", "lr", "weight_decay", "batch_size",
                "eval_batch_size", "lr_milestones", "lr_gamma",
                "upper_weights", "surface_weights", "surface_loss_weight",
                "save_interval", "save_steps", "val_interval",
                "early_stop_patience", "seed", "lora_rank", "lora_alpha",
                "lora_dropout", "lora_dropout_mode"]


@pytest.mark.parametrize("field", TRAIN_FIELDS)
def test_train_config_defaults_match_jax(field):
    assert getattr(PC.TrainConfig(), field) == getattr(JC.TrainConfig(), field)


def test_train_config_has_no_lora_fields():
    """Named for the slices before LoRA; the fields are now exactly the
    compared ones, the JAX package's LoRA fields among them."""
    names = {f.name for f in dataclasses.fields(PC.TrainConfig)}
    assert names == set(TRAIN_FIELDS)
    assert {"lora_rank", "lora_alpha", "lora_dropout",
            "lora_dropout_mode"} <= names
