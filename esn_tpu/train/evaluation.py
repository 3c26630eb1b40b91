"""Mesh-sharded, single-compile evaluation driver.

Reference: ``test.py :: test`` / ``train.py :: val`` [R] iterate the val
loader one image at a time on one GPU and fan the confusion-matrix work out
to a multiprocessing.Pool. Here every eval batch is padded host-side to ONE
fixed shape (so XLA compiles the eval step exactly once per resolution)
and device_put sharded over the mesh's ``data`` axis, so validation uses
every device; padded tail rows are masked out of the
confusion matrix via the batch's ``valid`` count (train/step.py).
"""
from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..parallel import mesh as meshlib


def eval_batch_size(loader_batch: int, mesh=None) -> int:
    """Fixed eval batch: loader batch rounded up to the data-axis size."""
    n_shard = 1
    if mesh is not None:
        n_shard = int(mesh.shape.get(meshlib.DATA_AXIS, 1))
    return -(-loader_batch // n_shard) * n_shard


def run_eval(eval_step, variables, loader, eval_transform, num_classes: int,
             *, mesh=None,
             per_image: Optional[Callable] = None) -> np.ndarray:
    """Accumulate the (K, K) confusion matrix over ``loader``.

    - ``eval_step`` from train.step.make_eval_step (handles "valid" masking).
    - ``mesh``: shard each padded batch's leading dim on the ``data`` axis
      (replicated over any other axes); None = single-device.
    - ``per_image(i, pred_hw, batch)``: optional callback on each REAL row
      (prediction saving in test.py); padded rows are never surfaced.
    """
    target_b = eval_batch_size(getattr(loader, "batch_size", 1) or 1, mesh)
    cm = np.zeros((num_classes, num_classes), np.int64)
    for batch in loader:
        if "label" not in batch:
            # unlabeled split: nothing to score (predict.py drives its own
            # loop); skip before any transform/device work
            continue
        arrays = {"image": np.asarray(batch["image"]),
                  "label": np.asarray(batch["label"])}
        padded, real = meshlib.pad_batch_to(arrays, target_b)
        if mesh is not None:
            padded = meshlib.shard_batch(padded, mesh)
        images = eval_transform(jnp.asarray(padded["image"]))
        pred, cm_b = eval_step(variables, {
            "image": images,
            "label": jnp.asarray(padded["label"]),
            "valid": np.int32(real)})
        cm += np.asarray(cm_b, np.int64)
        if per_image is not None:
            pred_np = np.asarray(pred)[:real]
            for i in range(real):
                per_image(i, pred_np[i], batch)
    return cm
