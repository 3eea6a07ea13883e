"""The port's mesh, sharding rules and halos against the JAX package, at TINY,
float32, on the CPU:

* ``_lon_shift_wm`` / ``_z_shift_wm`` on sp = 2 and tp = 2 shards of a
  2-rank gloo world (``parallel/launch.py``), gathered, against the JAX
  functions' single-device branch on the whole storage (exact: both only
  move values); ``Mesh.ppermute`` rotates by +1 and -1; a rank past the
  mesh is idle;
* row 5z's plain version (``apply_transition_wm`` on a z shard, ``z_base``,
  ``nz_global``) against the JAX Pallas kernel in interpret mode with a
  concrete ``z_base``, called outside any ``shard_map``, each z0 of tp = 2
  (valid rows, 2e-4 as ``tests/test_torch_transition.py``);
* ``wm_core_mesh``, ``auto_mesh_config`` and ``param_spec`` against the JAX
  functions (pure Python);
* a read across shards (a lon shift on a lon shard, a z shift on a z
  shard, a z offset under ``z_base``) raises ``ValueError`` in every
  wrapper (the paths a mesh used to refuse serve through the canonical
  route: ``tests/test_torch_parallel_canon.py``);
* the backend rule and the launch detection of ``parallel/mesh.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import AbstractMesh

import torch_parity as TP
import torch_world
from pangu_tpu.config import PANGU_24 as JAX_PANGU_24
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.engine import transition_wm as JTW
from pangu_tpu.models import pangu as jax_pangu
from pangu_tpu.ops import earth_block_wm as JW
from pangu_tpu.parallel import mesh as jax_mesh
from pangu_tpu.parallel import sharding as jax_sharding
from pangu_tpu_torch.config import PANGU_24, TINY, MeshConfig
from pangu_tpu_torch.data.constants import synthetic_constants, to_device
from pangu_tpu_torch.engine import transition_wm as TW
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.ops.earth_block_wm import (block_wm, from_window_major,
                                                to_window_major)
from pangu_tpu_torch.ops.updown_wm import down_sample_wm
from pangu_tpu_torch.parallel import launch
from pangu_tpu_torch.parallel import mesh as M
from pangu_tpu_torch.parallel import sharding

TOL = 2e-4
G0 = TINY.stage(0)
NZ = G0.z // G0.window[0]
LON_SHIFTS, Z_SHIFTS = (6, -6), (1, -1)


def _storage(seed, b=1):
    wz, wh, ww = G0.window
    shape = (b, NZ, G0.h_padded // wh, G0.w // ww, wz * wh * ww, G0.dim)
    return TP.normal(shape, seed)


@pytest.fixture(scope="module")
def halo_world():
    xs = _storage(5)
    got = launch.run(torch_world.halos, 2, torch.as_tensor(xs), G0.window,
                     LON_SHIFTS, Z_SHIFTS, device="cpu", timeout_s=60)
    return xs, got


@pytest.mark.parametrize("dw", LON_SHIFTS)
def test_lon_shift_on_sp_shards_matches_jax(halo_world, dw):
    xs, got = halo_world
    want = np.asarray(JW._lon_shift_wm(jnp.asarray(xs), dw, G0.window[2],
                                       None, 1))
    for rank in got:
        np.testing.assert_array_equal(rank[(2, 1, dw)].numpy(), want)


@pytest.mark.parametrize("dz", Z_SHIFTS)
def test_z_shift_on_tp_shards_matches_jax(halo_world, dz):
    xs, got = halo_world
    want = np.asarray(JW._z_shift_wm(jnp.asarray(xs), dz, G0.window[0],
                                     None, 1))
    for rank in got:
        np.testing.assert_array_equal(rank[(1, 2, dz)].numpy(), want)


def test_ppermute_rotates_and_a_rank_past_the_mesh_is_idle(halo_world):
    _, got = halo_world
    assert [[float(t) for t in r["ppermute"]] for r in got] == [[1, 1], [0, 0]]
    # a shift: one halo and one gather; then the two rotates
    assert [r["exchanges"] for r in got] == [2 * len(LON_SHIFTS) + 2] * 2
    assert [r["idle"] for r in got] == [False, True]


@pytest.fixture(scope="module")
def transition():
    jparams, params = TP.port_and_jax_params(TINY, seed=41)
    consts = synthetic_constants(TINY)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    return (JTW.build_transition_wm(jparams, jc, JAX_TINY),
            TW.build_transition_wm(params, to_device(consts, "cpu"), TINY))


@pytest.mark.parametrize("off", [(0, 3, 6), (0, 0, 0)])
@pytest.mark.parametrize("z0", [0, 1])
def test_transition_z_shard_matches_jax_pallas(transition, z0, off):
    """Row 5z: the shard of tp = 2 holding z window z0 (the surface plane
    at z0 0, the top plane at z0 1), its plain version against the JAX
    kernel with ``z_scalar=True``; and equal to that shard of the whole
    pair's transition."""
    jtp, tp = transition
    skip, dec = _storage(42, 2), _storage(43, 2)
    cut = slice(z0, z0 + 1)
    jloc = {**jtp, "bias_field_wm": jtp["bias_field_wm"][:, cut]}
    with pltpu.force_tpu_interpret_mode():
        want = JTW.apply_transition_wm(
            jloc, jnp.asarray(skip[:, cut]), jnp.asarray(dec[:, cut]),
            JAX_TINY.stage(0), off, z_base=jnp.int32(z0), nz_global=NZ)
    loc = {**tp, "bias_field_wm": tp["bias_field_wm"][:, cut]}
    got = TW.apply_transition_wm(loc, torch.as_tensor(skip[:, cut]),
                                 torch.as_tensor(dec[:, cut]), G0, off,
                                 z_base=z0, nz_global=NZ)
    whole = TW.apply_transition_wm(tp, torch.as_tensor(skip),
                                   torch.as_tensor(dec), G0, off)
    assert got.shape == want.shape
    got_grid = from_window_major(got, G0.window)[:, :, :G0.h]
    want_grid = from_window_major(torch.as_tensor(np.array(want)),
                                  G0.window)[:, :, :G0.h]
    assert TP.max_abs_err(got_grid, want_grid) <= TOL
    assert torch.equal(got, whole[:, cut])
    assert TW.apply_transition_wm.launches == 0


@pytest.mark.parametrize("cfg,jcfg", [(TINY, JAX_TINY),
                                      (PANGU_24, JAX_PANGU_24)])
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 1), (1, 1, 2),
                                   (2, 2, 2), (1, 3, 1), (1, 3, 2),
                                   (1, 1, 4), (1, 5, 1), (1, 1, 3),
                                   (1, 15, 1)])
def test_wm_core_mesh_matches_jax(cfg, jcfg, shape):
    mesh = M.Mesh(cfg=MeshConfig(*shape), coords={"dp": 0, "sp": 0, "tp": 0},
                  lines={}, groups={}, device=torch.device("cpu"),
                  host_staged=False)
    with jax.sharding.use_abstract_mesh(AbstractMesh(shape,
                                                     ("dp", "sp", "tp"))):
        want = jax_pangu.wm_core_mesh(jcfg) is not None
    assert (pangu.wm_core_mesh(cfg, mesh) is not None) == want


@pytest.mark.parametrize("n,lon,heads,batch", [
    (6, 15, 6, 1), (4, 2, 2, 1), (8, 15, 6, 1), (4, 15, 6, 2), (3, 2, 2, 1),
    (8, 30, 6, 4), (1, 15, 6, 1)])
def test_auto_mesh_config_matches_jax(n, lon, heads, batch):
    want = jax_mesh.auto_mesh_config(n, lon_windows=lon, max_heads=heads,
                                     batch=batch)
    got = M.auto_mesh_config(n, lon_windows=lon, max_heads=heads, batch=batch)
    assert (got.dp, got.sp, got.tp) == (want.dp, want.sp, want.tp)


def test_param_spec_matches_jax():
    jparams, params = TP.port_and_jax_params(TINY, seed=1)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    port = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat) == len(port)
    for path, leaf in flat:
        names = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        assert sharding.param_spec(names, port[path]) == tuple(
            jax_sharding.param_spec(path, leaf)), names


def _cpu_mesh(dp=1, sp=1, tp=1):
    """A mesh object of this process alone: enough for what raises before
    the first exchange."""
    return M.Mesh(cfg=MeshConfig(dp, sp, tp),
                  coords={"dp": 0, "sp": 0, "tp": 0}, lines={}, groups={},
                  device=torch.device("cpu"), host_staged=False)


@pytest.fixture(scope="module")
def served():
    params = pangu.init_params(torch.Generator().manual_seed(2), TINY,
                               device="cpu")
    consts = synthetic_constants(TINY)
    upper = torch.as_tensor(TP.normal((1, 5, TINY.levels, TINY.lat, TINY.lon),
                                      6))
    surface = torch.as_tensor(TP.normal((1, 4, TINY.lat, TINY.lon), 7))
    return params, consts, upper, surface


def test_reads_across_shards_raise(served, transition):
    params, _, _, _ = served
    _, tp = transition
    bp = params["stages"][0]["blocks"][1]
    xs = torch.as_tensor(_storage(44))
    lon_shard = xs[:, :, :, :2].contiguous()
    z_shard = xs[:, :1].contiguous()
    with pytest.raises(ValueError, match="reads across shards"):
        block_wm(bp, lon_shard, G0, (1, 3, 6), 3, None, False)
    with pytest.raises(ValueError, match="reads across shards"):
        block_wm(bp, z_shard, G0, (1, 3, 0), 3, None, False)
    with pytest.raises(ValueError, match="reads across shards"):
        down_sample_wm(params["downsample"], lon_shard, G0, TINY.stage(1),
                       (0, 3, 6))
    loc = {**tp, "bias_field_wm": tp["bias_field_wm"][:, :1]}
    with pytest.raises(ValueError, match="reads across shards"):
        TW.apply_transition_wm(loc, z_shard, z_shard, G0, (1, 3, 6),
                               z_base=0, nz_global=NZ)
    with pytest.raises(ValueError, match="needs z_base"):
        TW.apply_transition_wm(loc, z_shard, z_shard, G0, (0, 3, 6))
    # the same reads are shard-local where the shift has no such component
    assert block_wm(bp, lon_shard, G0, (1, 3, 0), 3, None, False).shape == (
        lon_shard.shape)
    table = bp["attn"]["bias_table"]
    bp_z = {**bp, "attn": {**bp["attn"],
                           "bias_table": table[:table.shape[0] // NZ]}}
    assert block_wm(bp_z, z_shard, G0, (0, 3, 6), 3, None, False).shape == (
        z_shard.shape)


def test_shard_params_slices_only_the_bias_tables(served):
    params = served[0]
    got = sharding.shard_params(params, _cpu_mesh(1, 1, 2))
    for i in range(4):
        t = params["stages"][i]["blocks"][0]["attn"]["bias_table"]
        g = got["stages"][i]["blocks"][0]["attn"]["bias_table"]
        assert torch.equal(g, t[:t.shape[0] // 2])
        assert g.untyped_storage().nbytes() == t.nbytes // 2   # a copy
        assert (got["stages"][i]["blocks"][0]["mlp"]["fc1"]["kernel"]
                is params["stages"][i]["blocks"][0]["mlp"]["fc1"]["kernel"])
    assert sharding.shard_params(params, _cpu_mesh(1, 2, 1)) is params


def test_launch_detection_and_backend_rule(monkeypatch):
    assert M._should_initialize({"WORLD_SIZE": "4", "MASTER_ADDR": "h"})
    assert not M._should_initialize({"WORLD_SIZE": "4"})
    assert not M._should_initialize({"WORLD_SIZE": "1", "MASTER_ADDR": "h"})
    assert M._should_initialize({"SLURM_NTASKS": "2"})
    assert not M._should_initialize({})
    for k in ("WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    assert not M.initialize_distributed(device="cpu")
    assert M.backend_for("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert M.backend_for("cuda", 6) == "gloo"      # ranks share the card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert M.backend_for("cuda", 4) == "nccl"


def test_window_major_shard_is_the_slice_of_the_canonical_grid():
    """z and longitude windows are contiguous blocks of the canonical grid,
    so slicing the grid and relayouting equals relayouting and slicing."""
    x = torch.as_tensor(TP.normal((1, G0.z, G0.h_padded, G0.w, 4), 8))
    mesh = _cpu_mesh(1, 2, 2)
    mesh.coords = {"dp": 0, "sp": 1, "tp": 1}
    a = to_window_major(sharding.shard(x, sharding.TOKEN_SPEC, mesh),
                        G0.window)
    b = sharding.shard(to_window_major(x, G0.window), torch_world.WM_SPEC,
                       mesh)
    assert torch.equal(a, b)
