"""Jitted train/eval steps shared by the whole zoo.

The reference's hot loop is eager per-op Python dispatch
[R: train.py :: train()]. Here one XLA program does
forward + backward + optimizer + BN-stat update + metrics; the TrainState is
donated so parameters update in place in HBM. Under a mesh, the batch arrives
sharded on the 'data' axis and XLA's global-view autodiff inserts the psum
for gradients — data parallelism with zero framework code in the step.

Mixed precision: compute in ``compute_dtype`` (bf16 on the GPU, see
utils/runtime.py), params and optimizer state in fp32, loss/grad reduction
in fp32 (SURVEY.md §2.6 AMP row: bf16 compute / fp32 accum).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import optax

from .. import nn
from ..ops import argmax_lastdim
from .metrics import confusion_matrix
from .state import TrainState


def make_train_step(model: nn.Module, loss_fn: Callable,
                    tx: optax.GradientTransformation, *,
                    schedule: Optional[Callable] = None,
                    compute_dtype=jnp.float32,
                    grad_accum: int = 1,
                    donate: bool = True,
                    remat: bool = False,
                    fwd_method: Optional[str] = None):
    """Build ``step(state, batch, rng) -> (state, metrics)``, jitted.

    batch: {"image": NHWC float, "label": NHW int}. ``loss_fn(logits, labels)``
    must reduce to a scalar. ``schedule`` is only used for LR reporting.
    ``remat=True`` rematerializes the forward during backward
    (``jax.checkpoint``) — trades ~1 extra forward of FLOPs for dropping
    activation storage; this is what makes full-resolution 2048x1024 batches
    fit HBM (BASELINE config 5 / SURVEY §7 hard-part 6).
    ``fwd_method`` runs a non-default forward (e.g. ``"logits_lowres"``
    paired with ``losses.resize_cross_entropy`` so the full-res logits
    tensor never materializes — the loss owns the upsample).
    """

    def fwd(params, stats, images, labels, step_rng):
        logits, new_vars = nn.apply(
            model, {"params": params, "stats": stats}, images,
            train=True, mutable=True, rngs={"dropout": step_rng},
            method=fwd_method)
        loss = loss_fn(logits.astype(jnp.float32), labels)
        return loss, new_vars["stats"]

    if remat:
        fwd = jax.checkpoint(fwd)

    def one_step(state: TrainState, batch, rng):
        images = batch["image"].astype(compute_dtype)
        labels = batch["label"]
        step_rng = jax.random.fold_in(rng, state.step)

        def loss_wrapped(params):
            return fwd(params, state.stats, images, labels, step_rng)

        (loss, new_stats), grads = jax.value_and_grad(
            loss_wrapped, has_aux=True)(state.params)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_state = TrainState(params=new_params, stats=new_stats,
                               opt_state=new_opt, step=state.step + 1)
        metrics = {"loss": loss}
        if schedule is not None:
            metrics["lr"] = schedule(state.step)
        return new_state, metrics

    if grad_accum > 1:
        def accum_step(state: TrainState, batch, rng):
            """Microbatch accumulation via lax.scan over a reshaped batch."""
            images = batch["image"]
            labels = batch["label"]
            b = images.shape[0]
            assert b % grad_accum == 0
            mb = b // grad_accum
            images = images.reshape((grad_accum, mb) + images.shape[1:])
            labels = labels.reshape((grad_accum, mb) + labels.shape[1:])
            step_rng = jax.random.fold_in(rng, state.step)

            def loss_one(params, stats, im, lb, r):
                logits, new_vars = nn.apply(
                    model, {"params": params, "stats": stats},
                    im.astype(compute_dtype), train=True, mutable=True,
                    rngs={"dropout": r}, method=fwd_method)
                return loss_fn(logits.astype(jnp.float32), lb), \
                    new_vars["stats"]

            def body(carry, xs):
                g_acc, loss_acc, stats = carry
                im, lb, i = xs
                (loss, stats), grads = jax.value_and_grad(
                    loss_one, has_aux=True)(state.params, stats, im, lb,
                                            jax.random.fold_in(step_rng, i))
                g_acc = jax.tree_util.tree_map(jnp.add, g_acc, grads)
                return (g_acc, loss_acc + loss, stats), None

            zeros = jax.tree_util.tree_map(
                lambda p: jnp.zeros_like(p), state.params)
            (g_sum, loss_sum, new_stats), _ = jax.lax.scan(
                body, (zeros, 0.0, state.stats),
                (images, labels, jnp.arange(grad_accum)))
            grads = jax.tree_util.tree_map(lambda g: g / grad_accum, g_sum)
            updates, new_opt = tx.update(grads, state.opt_state, state.params)
            new_params = optax.apply_updates(state.params, updates)
            new_state = TrainState(new_params, new_stats, new_opt,
                                   state.step + 1)
            metrics = {"loss": loss_sum / grad_accum}
            if schedule is not None:
                metrics["lr"] = schedule(state.step)
            return new_state, metrics
        fn = accum_step
    else:
        fn = one_step

    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_eval_step(model: nn.Module, num_classes: int, *,
                   ignore_index: int = 255, compute_dtype=jnp.float32):
    """Build ``eval_step(variables, batch) -> (pred NHW int32, cm KxK)``.

    Confusion matrix accumulates on device; under a mesh the bincount is a
    global reduction (the psum the reference did on a multiprocessing.Pool
    [R: utils/metric/metric.py :: get_iou]).

    If batch carries ``"valid"`` (int scalar), only the first ``valid`` rows
    count toward the confusion matrix — the padded tail rows of a
    fixed-shape eval batch (parallel/mesh.py::pad_batch_to) are masked to
    ``ignore_index``. The count is traced, so one compile serves every tail
    size. ``eval_step.trace_count()`` reports how many times the step has
    been traced (== compiled); tests pin it to 1 per resolution.
    """
    traces = {"n": 0}

    def _eval_step(variables, batch):
        traces["n"] += 1  # runs at trace time only: counts compilations
        # model.predict fuses the prediction head where possible (subpixel
        # argmax before depth-to-space for convT tails); default is
        # argmax(logits) with the tail-appropriate lowering. Exact either
        # way — no f32 upcast needed, bf16->f32 is monotone.
        pred = nn.apply(model, variables,
                        batch["image"].astype(compute_dtype), train=False,
                        method="predict")
        labels = batch["label"]
        if pred.shape != labels.shape:  # trace-time check, zero runtime cost
            raise ValueError(
                f"model output {pred.shape[1:]} != label {labels.shape[1:]}"
                f" - the eval resolution must be divisible by the model's"
                f" output stride (the reference assumes this implicitly:"
                f" CamVid 360x480, Cityscapes 1024x2048 are both divisible"
                f" by 8). Fix: --val_size H,W with compatible H,W.")
        if "valid" in batch:
            row = jax.lax.broadcasted_iota(jnp.int32, labels.shape, 0)
            labels = jnp.where(row < batch["valid"], labels, ignore_index)
        cm = confusion_matrix(pred, labels, num_classes, ignore_index)
        return pred, cm

    jitted = jax.jit(_eval_step)

    def eval_step(variables, batch):
        return jitted(variables, batch)

    eval_step.trace_count = lambda: traces["n"]
    return eval_step


def make_predict_step(model: nn.Module, *, compute_dtype=jnp.float32,
                      output_size=None):
    """Build ``predict(variables, images) -> pred NHW int32`` (predict.py)."""
    from ..ops import resize_bilinear

    @jax.jit
    def predict(variables, images):
        if output_size is not None:
            logits = nn.apply(model, variables, images.astype(compute_dtype),
                              train=False)
            logits = resize_bilinear(logits.astype(jnp.float32), output_size)
            return argmax_lastdim(logits, tail="resize")
        return nn.apply(model, variables, images.astype(compute_dtype),
                        train=False, method="predict")

    return predict
