"""Training engine of the port: the counterpart of
``pangu_tpu/engine/train.py`` (loss, optimizer, train and eval steps, the
epoch loop), on one device or under a (dp, sp, tp) mesh.

* ``weighted_l1_loss``: mean(|err_upper| * w_var) + 0.25 * mean(|err_surface|
  * w_var) on normalised fields, the reference's formula;
* ``make_optimizer``: Adam(0.9, 0.999, 1e-8) with L2 folded into the gradient
  before the moments -- ``torch.optim.Adam``'s ``weight_decay`` -- under a
  MultiStep schedule (x ``lr_gamma`` at each milestone epoch), stepped per
  optimizer step; with a ``trainable_mask`` the frozen leaves get no update
  and no decay (``optax.multi_transform`` with ``set_to_zero`` in the JAX
  package);
* ``attach_lora``: the LoRA fine-tuning set-up of ``cli/lora_tune.py``,
  adapters by the ``TrainConfig``'s LoRA fields and the optimizer that
  trains only them and ``patch_recovery``;
* ``make_train_step``: raw-unit batch in, targets normalised on the device,
  the training forward (``pangu.forward(..., deterministic=False)``), the
  loss, its gradient (the block backward kernels run inside it), one Adam
  step;
* ``make_eval_step``: the served forward and the same loss;
* ``train_loop``: epochs with validation, early stopping and best-params
  tracking, and a duck-typed ``checkpointer`` (``save(state, epoch=, step=,
  batch=)``, ``save_best(state)``).

A step's stochastic-depth scales come from a ``torch.Generator`` seeded by
the step's seed, so a run repeats itself; the JAX package's ``jax.random``
streams are not reproduced.

Under an active mesh of more than one rank (``parallel.sharding.use_mesh``)
every rank passes the whole batch and holds the whole parameter tree and
its own optimizer: the training forward runs the rank's shard, and
``parallel.sharding.reduce_grads`` sums the gradient after
``loss.backward()`` over the view of the mesh the forward ran under
(``models/pangu.py::serving_mesh``; a collapsed axis replicated the
work): the sum the JAX package's ``jit`` over the mesh holds, which the
reference's DDP set-up forgot.  Every rank then holds the same
gradient bits, takes the same Adam update and reports the same metrics, so
early stopping decides alike everywhere; the command lines save
checkpoints on rank 0 alone.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import ModelConfig, TrainConfig
from pangu_tpu_torch.data.constants import norm_data, to_device
from pangu_tpu_torch.models import lora, pangu
from pangu_tpu_torch.parallel import sharding


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def weighted_l1_loss(out_upper, out_surface, tgt_upper, tgt_surface,
                     tcfg: TrainConfig):
    """The weights multiply elementwise and the mean runs over all elements
    (not a weighted average), as in the reference; float32.  Returns
    ``(loss, {"loss_upper", "loss_surface"})``."""
    dev = out_upper.device
    wu = torch.tensor(tcfg.upper_weights, dtype=torch.float32,
                      device=dev).reshape(1, -1, 1, 1, 1)
    ws = torch.tensor(tcfg.surface_weights, dtype=torch.float32,
                      device=dev).reshape(1, -1, 1, 1)
    lu = ((out_upper.float() - tgt_upper.float()).abs() * wu).mean()
    ls = ((out_surface.float() - tgt_surface.float()).abs() * ws).mean()
    return lu + tcfg.surface_loss_weight * ls, {"loss_upper": lu,
                                                "loss_surface": ls}


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def lr_schedule(tcfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """The MultiStep schedule per optimizer step: lr x gamma^(milestones
    passed), a milestone m passed from step m * steps_per_epoch on."""
    def lr(step: int) -> float:
        passed = sum(step >= m * steps_per_epoch for m in tcfg.lr_milestones)
        return tcfg.lr * tcfg.lr_gamma ** passed
    return lr


@dataclasses.dataclass
class Optimizer:
    """Adam with L2 into the gradient under the MultiStep schedule:
    ``init(params)`` builds its state (a ``torch.optim.Adam`` over the
    param leaves, or over those the ``trainable_mask`` tree marks True, and
    the step count), ``apply(state)`` takes one step with the gradients the
    leaves hold; a frozen leaf is left as it is, bit for bit."""

    tcfg: TrainConfig
    steps_per_epoch: int = 1
    trainable_mask: Any = None

    def init(self, params) -> Dict[str, Any]:
        leaves = list(_leaves(params))
        if self.trainable_mask is not None:
            mask = list(_leaves(self.trainable_mask))
            if len(mask) != len(leaves):
                raise ValueError(f"trainable_mask has {len(mask)} leaves, "
                                 f"the params {len(leaves)}")
            leaves = [t for t, m in zip(leaves, mask) if m]
        adam = torch.optim.Adam(leaves, lr=self.tcfg.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.tcfg.weight_decay)
        return {"adam": adam, "count": 0}

    def apply(self, opt_state) -> None:
        lr = lr_schedule(self.tcfg, self.steps_per_epoch)(opt_state["count"])
        for group in opt_state["adam"].param_groups:
            group["lr"] = lr
        opt_state["adam"].step()
        opt_state["count"] += 1


def make_optimizer(tcfg: TrainConfig, steps_per_epoch: int = 1,
                   trainable_mask: Any = None) -> Optimizer:
    """The optimizer; ``trainable_mask``: a tree of bools like the params
    (``models/lora.py::trainable_mask``), True for the leaves it trains."""
    return Optimizer(tcfg, steps_per_epoch, trainable_mask)


def attach_lora(gen: torch.Generator, params, tcfg: TrainConfig,
                steps_per_epoch: int = 1):
    """LoRA fine-tuning as ``cli/lora_tune.py`` sets it up: adapters on
    every Linear site (``lora.init_lora`` with ``tcfg.lora_rank``,
    ``lora_alpha``, ``lora_dropout`` and ``lora_dropout_mode``, A drawn from
    ``gen``) and the optimizer that trains only the factors and
    ``patch_recovery``.  Returns ``(params, optimizer)``."""
    params = lora.init_lora(gen, params, rank=tcfg.lora_rank,
                            alpha=tcfg.lora_alpha, dropout=tcfg.lora_dropout,
                            dropout_mode=tcfg.lora_dropout_mode)
    return params, make_optimizer(tcfg, steps_per_epoch,
                                  lora.trainable_mask(params))


# ---------------------------------------------------------------------------
# Train state and steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


def create_train_state(params, opt: Optimizer) -> TrainState:
    """The params' leaves become trainable (``requires_grad``) in place."""
    for t in _leaves(params):
        t.requires_grad_(True)
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def loss_and_grads(params, batch, constants, cfg: ModelConfig,
                   tcfg: TrainConfig, *, device: _device.DeviceLike = "cuda",
                   kernels: bool = True, seed: Optional[int] = None,
                   drops=None):
    """Forward (training mode), loss and its gradient: ``(loss, aux,
    grads)``, grads a tree like ``params`` (float32 loss, gradients in each
    param's dtype).  ``batch``: upper / surface / target_upper /
    target_surface in raw units; the targets are normalised on the device.
    Stochastic depth: ``drops`` if given, else drawn from a generator on the
    device seeded with ``seed`` (no seed: scales of 1).  Under an active
    mesh the batch is the whole batch on every rank, and the gradient is
    summed over the view the forward ran under
    (``parallel.sharding.reduce_grads``) before it is returned."""
    dev = _device.resolve(device)
    for t in _leaves(params):
        t.grad = None
    gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
    routed = pangu.serving_mesh(params, cfg, batch["upper"].shape[0],
                                train=True)
    out_u, out_s = pangu.forward(params, batch["upper"], batch["surface"],
                                 constants, cfg, device=dev, kernels=kernels,
                                 deterministic=False, gen=gen, drops=drops,
                                 routed=routed)
    consts = to_device(constants, dev)
    tgt_u, tgt_s = norm_data(batch["target_upper"].to(dev, torch.float32),
                             batch["target_surface"].to(dev, torch.float32),
                             consts)
    loss, aux = weighted_l1_loss(out_u, out_s, tgt_u, tgt_s, tcfg)
    loss.backward()
    grads = _map(params, lambda t: t.grad)
    if routed is not None:
        grads = sharding.reduce_grads(params, grads, routed[1])
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in _leaves(grads)))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, constants,
                    opt: Optimizer, *, device: _device.DeviceLike = "cuda",
                    kernels: bool = True) -> Callable:
    """The train step ``(state, batch, seed) -> (state, metrics)``: the loss
    and its gradient (:func:`loss_and_grads`, stochastic-depth scales drawn
    from a generator seeded with ``seed``, as the JAX step draws them from
    its ``rng``), then one optimizer step in place on the params.  Metrics:
    loss, loss_upper,
    loss_surface, grad_norm (tensors on the device).  On the card the
    training trunk runs the block, block backward, DownSample, UpSample and
    (``cfg.edge_kernels``) embed, embed dW, recovery and recovery backward
    kernels; ``device="cpu"`` runs every plain version.  Under an active
    mesh each rank trains its shard, the gradient is summed over the mesh,
    and every rank takes the same update on its copy of the params."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)

    def train_step(state: TrainState, batch, seed: int):
        loss, aux, grads = loss_and_grads(state.params, batch, consts, cfg,
                                          tcfg, device=dev, kernels=kernels,
                                          seed=seed)
        metrics = {"loss": loss, **aux, "grad_norm": global_norm(grads)}
        opt.apply(state.opt_state)
        return (TrainState(params=state.params, opt_state=state.opt_state,
                           step=state.step + 1), metrics)

    return train_step


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig, constants, *,
                   device: _device.DeviceLike = "cuda",
                   kernels: bool = True) -> Callable:
    """The validation step ``(params, batch) -> metrics``: the served
    forward (under an active mesh the sharded one, the whole prediction on
    every rank; a batch that dp does not divide, such as a validation
    batch of 1 under a training mesh, with dp collapsed) and the same
    weighted L1 against normalised targets."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)

    @torch.no_grad()
    def eval_step(params, batch):
        out_u, out_s = pangu.forward(params, batch["upper"], batch["surface"],
                                     consts, cfg, device=dev, kernels=kernels)
        tgt_u, tgt_s = norm_data(batch["target_upper"].to(dev, torch.float32),
                                 batch["target_surface"].to(dev, torch.float32),
                                 consts)
        loss, aux = weighted_l1_loss(out_u, out_s, tgt_u, tgt_s, tcfg)
        return {"loss": loss, **aux}

    return eval_step


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------

def train_loop(tcfg: TrainConfig, state: TrainState, train_step, eval_step,
               train_batches: Callable[[int], Iterable],
               val_batches: Callable[[], Iterable], *, seed: int = 0,
               start_epoch: int = 1, start_batch: int = 0, checkpointer=None,
               logger=None, writer=None) -> Tuple[TrainState, Dict]:
    """Epoch loop with validation, early stopping after
    ``tcfg.early_stop_patience`` validations without improvement, and
    best-params tracking (the best params are returned in the state).
    ``train_batches(epoch)`` / ``val_batches()`` yield batch dicts.  Step
    ``n`` (counted over the whole run) gets the seed ``seed + n``, so a run
    resumed at (``start_epoch``, ``start_batch``) repeats the uninterrupted
    one.  With ``tcfg.save_steps > 0`` the checkpointer also saves every
    that many steps.  In a world of several ranks every rank runs the same
    steps and validations; the caller passes a checkpointer on the rank
    that writes alone (``cli/common.py::writes``)."""
    best_loss = float("inf")
    best_params = None
    stale = 0
    history = {"train_loss": [], "val_loss": []}
    gstep = int(state.step)

    def log(msg):
        if logger is not None:
            logger.info(msg)

    for epoch in range(start_epoch, tcfg.epochs + 1):
        t0 = time.time()
        epoch_loss, nb = 0.0, 0
        batches = iter(train_batches(epoch))
        if epoch == start_epoch and start_batch:
            log(f"resuming epoch {epoch} at batch {start_batch}")
            for _ in range(start_batch):
                next(batches, None)
            nb = start_batch
        for batch in batches:
            state, metrics = train_step(state, batch, seed + gstep)
            epoch_loss += float(metrics["loss"])
            nb += 1
            gstep += 1
            if (checkpointer is not None and tcfg.save_steps
                    and gstep % tcfg.save_steps == 0):
                checkpointer.save(state, epoch=epoch, step=gstep, batch=nb)
        epoch_loss /= max(nb - (start_batch if epoch == start_epoch else 0), 1)
        history["train_loss"].append(epoch_loss)
        log(f"Epoch {epoch} : {epoch_loss:.6f} "
            f"({nb} steps, {time.time() - t0:.1f}s)")

        if checkpointer is not None and epoch % tcfg.save_interval == 0:
            checkpointer.save(state, epoch=epoch + 1, step=gstep, batch=0)

        if epoch % tcfg.val_interval == 0:
            val_loss, nv = 0.0, 0
            for batch in val_batches():
                val_loss += float(eval_step(state.params, batch)["loss"])
                nv += 1
            val_loss /= max(nv, 1)
            history["val_loss"].append(val_loss)
            log(f"Validate at Epoch {epoch} : {val_loss:.6f}")
            if writer is not None:
                writer.add_scalars("Loss", {"train": epoch_loss,
                                            "val": val_loss}, epoch)
            if val_loss < best_loss:
                best_loss = val_loss
                # a copy: the optimizer updates the live params in place
                best_params = _map(state.params,
                                   lambda t: t.detach().clone()
                                   if isinstance(t, torch.Tensor)
                                   else copy.deepcopy(t))
                stale = 0
                if checkpointer is not None:
                    checkpointer.save_best(state)
                log(f"current best model is saved at {epoch} epoch.")
            else:
                stale += 1
                if stale >= tcfg.early_stop_patience:
                    log(f"No improvement in validation loss for {stale} "
                        "epochs, terminating training.")
                    break

    history["best_val_loss"] = best_loss
    if best_params is not None:
        # into the live leaves, which the optimizer holds: the returned
        # state trains on, as the JAX loop's best params with its opt_state
        with torch.no_grad():
            for live, best in zip(_leaves(state.params), _leaves(best_params)):
                if isinstance(live, torch.Tensor):
                    live.copy_(best)
    return state, history

