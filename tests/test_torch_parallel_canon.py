"""The canonical-layout route of the port under a (dp, sp, tp) mesh, served,
in one 4-rank gloo world on the CPU (``parallel/launch.py``), at TINY,
float32, every case against one device's port on the same params and
fields, within 1e-5 of the largest |value|:

* ``block_layout="v2"`` forward at (1, 2, 2) (tp replicated, sp 2) and at
  (2, 2, 1) with batch 2 (the batch over dp);
* taps at (1, 2, 1), gathered whole;
* a 2-step token-space trajectory at (1, 2, 2) (the canonical chain);
* the 24 + 6 h token-space hierarchy at (1, 2, 2);
* the meshes the window-major gate refuses: (1, 3, 1) (sp 3 divides no
  stage's longitude windows), (1, 1, 4) (tp 4, and the canonical route
  collapses tp) and (2, 1, 1) with batch 1, forward and rollout: their
  view collapses to one rank, so every rank serves the whole call with no
  exchange;
* the trajectory, taps and v2 at (1, 2, 1), which raised before;
* every case, on every rank, against the JAX package's one-device call
  from the same params (``attn_impl="xla"``: ``forward`` with taps,
  ``make_rollout(token_space=True, return_trajectory=True)``,
  ``make_hierarchical_rollout(token_space=True)``), max abs error 5e-4 on
  normalised outputs and on the taps, the tolerance of
  ``tests/test_torch_parallel_rollout.py``;
* ``models/pangu.py::serving_mesh``'s route and view for each such call,
  and the one log line of each axis ``canon_view`` collapses (pure Python,
  fake meshes).

The world runs in a thread while the one-device and JAX references are
computed.  The JAX package's own sharded paths hang in Pallas interpret
mode here and are not run."""

import dataclasses
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
import torch_world
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.engine.rollout import make_hierarchical_rollout as \
    jax_make_hierarchical_rollout
from pangu_tpu.engine.rollout import make_rollout as jax_make_rollout
from pangu_tpu.models import pangu as jax_pangu
from pangu_tpu_torch.config import TINY, MeshConfig
from pangu_tpu_torch.data.constants import norm_data, synthetic_constants
from pangu_tpu_torch.models import lora, pangu
from pangu_tpu_torch.parallel import launch
from pangu_tpu_torch.parallel import mesh as M
from pangu_tpu_torch.parallel import sharding

TOL = 1e-5
TOL_JAX = 5e-4
JAX_CFG = dataclasses.replace(JAX_TINY, attn_impl="xla")
V2 = dataclasses.replace(TINY, block_layout="v2")
# key -> (mesh, cfg, kind, batch)
SHARDED = {"v2 forward": ((1, 2, 2), V2, "forward", 1),
           "v2 forward dp": ((2, 2, 1), V2, "forward", 2),
           "taps": ((1, 2, 1), TINY, "taps", 1),
           "trajectory": ((1, 2, 2), TINY, "trajectory", 1),
           "hierarchy": ((1, 2, 2), TINY, "hierarchy", 1)}
WERE_REFUSED = {f"{entry} {shape}": (shape, TINY, entry, 1)
                for entry in ("forward", "rollout")
                for shape in ((1, 3, 1), (1, 1, 4), (2, 1, 1))}
WERE_UNSHARDED = {"trajectory (1, 2, 1)": ((1, 2, 1), TINY, "trajectory", 1),
                  "taps (1, 2, 1)": ((1, 2, 1), TINY, "taps", 1),
                  "v2 (1, 2, 1)": ((1, 2, 1), V2, "forward", 1)}
CASES = {**SHARDED, **WERE_REFUSED, **WERE_UNSHARDED}


@pytest.fixture(scope="module")
def results():
    (jbase, base), (jh6, h6) = (TP.port_and_jax_params(TINY, seed=s)
                                for s in (61, 62))
    trees = {"base": base, "h6": h6}
    consts = {k: torch.as_tensor(v) for k, v in
              synthetic_constants(TINY).items()}
    upper = (consts["upper_mean"][None] + consts["upper_std"][None]
             * torch.as_tensor(TP.normal((2, 5, TINY.levels, TINY.lat,
                                          TINY.lon), 63)))
    surface = (consts["surface_mean"][None] + consts["surface_std"][None]
               * torch.as_tensor(TP.normal((2, 4, TINY.lat, TINY.lon), 64)))
    cases = [(key, shape, cfg, kind, b)
             for key, (shape, cfg, kind, b) in CASES.items()]
    box = {}

    def world():
        try:
            box["world"] = launch.run(torch_world.canon_serve, 4, cases,
                                      trees, consts, upper, surface,
                                      device="cpu", timeout_s=120)
        except Exception as e:           # re-raised in the test's thread
            box["error"] = e

    thread = threading.Thread(target=world)
    thread.start()
    jax_refs = _jax_results(jbase, jh6, consts, upper, surface)
    single, refs = {}, {}
    for key, shape, cfg, kind, b in cases:
        ref = (id(cfg), kind, b)
        if ref not in refs:
            refs[ref] = torch_world.serve_case(kind, cfg, trees, consts,
                                               upper[:b], surface[:b])
        single[key] = refs[ref]
    thread.join(timeout=300)
    assert not thread.is_alive()
    if "error" in box:
        raise box["error"]
    return {"world": box["world"], "single": single, "jax": jax_refs,
            "consts": consts}


def _jax_results(jbase, jh6, consts, upper, surface):
    """The JAX package's one-device results, by kind: the forward with taps
    at batch 2, the 2-step token-space trajectory and the 24 + 6 h
    token-space hierarchy at batch 1 (torch tensors)."""
    jc = {k: jnp.asarray(v.numpy()) for k, v in consts.items()}

    def fields(b):      # fresh arrays: the rollouts donate their state
        return jnp.asarray(upper[:b].numpy()), jnp.asarray(surface[:b].numpy())

    def fwd(p, u, s):
        taps = {}
        out = jax_pangu.forward(p, u, s, jc, JAX_CFG, taps=taps)
        return out, taps

    traj = jax_make_rollout(JAX_CFG, jc, 2, return_trajectory=True,
                            token_space=True)(jbase, *fields(1))
    roll, _ = jax_make_hierarchical_rollout(JAX_CFG, jc, 30, (24, 6),
                                            token_space=True)
    out = {"taps": jax.jit(fwd)(jbase, *fields(2)), "trajectory": traj,
           "hierarchy": roll({24: jbase, 6: jh6}, *fields(1))}
    out["forward"], out["rollout"] = out["taps"][0], traj[0]
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), out)


def _flat(x):
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _check(results, key, sharded):
    want = results["single"][key]
    n_ranks = int(np.prod(CASES[key][0]))
    ranks = [r[key] for r in results["world"][:n_ranks]]
    assert len(ranks) == n_ranks
    if isinstance(want, tuple) and isinstance(want[-1], dict):
        assert all(sorted(r["result"][-1]) == sorted(want[-1]) for r in ranks)
    for r in ranks:
        got = _flat(r["result"])
        assert len(got) == len(_flat(want))
        for g, w in zip(got, _flat(want)):
            assert g.shape == w.shape
            scale = float(w.abs().max())
            assert TP.max_abs_err(g, w) <= TOL * scale, key
        assert (r["exchanges"] > 0) == sharded, key


def _normalised(kind, res, consts):
    """The tensors of one served result to hold against the JAX package's:
    outputs normalised, taps as they are."""
    flat = _flat(res)
    if kind in ("forward", "taps"):
        return flat
    return [t for i in range(0, len(flat), 2)
            for t in norm_data(flat[i], flat[i + 1], consts)]


@pytest.mark.parametrize("key", sorted(CASES))
def test_served_case_matches_jax(results, key):
    shape, _, kind, b = CASES[key]
    want_res = results["jax"][kind]
    if kind == "taps":
        assert sorted(want_res[1]) == sorted(results["single"][key][1])
    if kind in ("forward", "taps"):     # the JAX forward ran at batch 2
        want_res = jax.tree.map(lambda t: t[:b], want_res)
    else:                               # the JAX rollouts at batch 1
        assert b == 1
    want = _normalised(kind, want_res, results["consts"])
    for r in results["world"][:int(np.prod(shape))]:
        got = _normalised(kind, r[key]["result"], results["consts"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape, key
            assert TP.max_abs_err(g, w) <= TOL_JAX, key


@pytest.mark.parametrize("key", sorted(SHARDED))
def test_canonical_route_matches_one_device(results, key):
    _check(results, key, sharded=True)


@pytest.mark.parametrize("key", sorted(WERE_REFUSED))
def test_refused_mesh_serves_one_device(results, key):
    """A mesh the window-major gate refuses: the canonical route's view
    collapses it to one rank (no exchange)."""
    _check(results, key, sharded=False)


@pytest.mark.parametrize("key", sorted(WERE_UNSHARDED))
def test_canonical_paths_serve_under_a_mesh(results, key):
    _check(results, key, sharded=True)


def _fake_mesh(dp=1, sp=1, tp=1):
    """A mesh of this process alone, its lines filled in: enough for the
    routing, which exchanges nothing."""
    shape = {"dp": dp, "sp": sp, "tp": tp}
    return M.Mesh(cfg=MeshConfig(dp, sp, tp),
                  coords={a: 0 for a in shape},
                  lines={a: list(range(n)) for a, n in shape.items()},
                  groups={a: None for a in shape}, device=torch.device("cpu"),
                  host_staged=False)


_PARAMS = pangu.init_params(torch.Generator().manual_seed(65), TINY,
                            device="cpu")
_ELEMENT = lora.init_lora(torch.Generator().manual_seed(66), _PARAMS, rank=2,
                          dropout=0.1, dropout_mode="element")
_FEATURE = lora.init_lora(torch.Generator().manual_seed(66), _PARAMS, rank=2,
                          dropout=0.1, dropout_mode="feature")


@pytest.mark.parametrize("tree,cfg,shape,batch,train,canonical,want", [
    (_PARAMS, TINY, (1, 2, 2), 1, False, False, ("wm", (1, 2, 2))),
    (_PARAMS, TINY, (2, 2, 1), 1, False, False, ("wm", (1, 2, 1))),
    (_PARAMS, TINY, (1, 2, 2), 1, False, True, ("canon", (1, 2, 1))),
    (_PARAMS, V2, (2, 2, 2), 2, True, False, ("canon", (2, 2, 1))),
    (_PARAMS, TINY, (1, 4, 1), 1, False, False, None),
    (_PARAMS, TINY, (1, 1, 4), 1, False, False, None),
    (_PARAMS, dataclasses.replace(TINY, train_fused=False), (1, 2, 2), 1,
     True, False, ("canon", (1, 2, 1))),
    (_PARAMS, dataclasses.replace(TINY, train_fused=False), (1, 2, 2), 1,
     False, False, ("wm", (1, 2, 2))),
    (_ELEMENT, TINY, (1, 2, 2), 1, True, False, ("canon", (1, 2, 1))),
    (_ELEMENT, TINY, (1, 2, 2), 1, False, False, ("wm", (1, 2, 2))),
    (_FEATURE, TINY, (1, 2, 2), 1, True, False, ("wm", (1, 2, 2))),
    (_PARAMS, dataclasses.replace(TINY, attn_impl="xla"), (4, 1, 1), 2,
     True, False, None),
])
def test_serving_mesh_routes(tree, cfg, shape, batch, train, canonical,
                             want):
    with sharding.use_mesh(_fake_mesh(*shape)):
        got = pangu.serving_mesh(tree, cfg, batch, train=train,
                                 canonical=canonical)
    if want is None:
        assert got is None
    else:
        assert (got[0], tuple(got[1].shape.values())) == want


@pytest.mark.parametrize("shape,batch,axis", [((1, 1, 4), 1, "tp"),
                                              ((1, 3, 1), 1, "sp"),
                                              ((2, 1, 1), 1, "dp")])
def test_canon_view_logs_each_collapse_once(monkeypatch, caplog, shape,
                                            batch, axis):
    """A mesh the canonical route collapses to one rank says so, once per
    process, naming the axis: its ranks do the same work."""
    monkeypatch.setattr(sharding, "_LOGGED", set())
    with caplog.at_level(logging.WARNING, logger="pangu_tpu"):
        for _ in range(2):
            with sharding.use_mesh(_fake_mesh(*shape)):
                assert pangu.serving_mesh(_PARAMS, TINY, batch,
                                          canonical=True) is None
    lines = [r.getMessage() for r in caplog.records
             if "canonical-layout route" in r.getMessage()]
    assert len(lines) == 1 and f" {axis} {max(shape)} collapsed" in lines[0]
