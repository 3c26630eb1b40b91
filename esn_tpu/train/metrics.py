"""mIoU evaluation via an on-device confusion matrix.

Reference: ``utils/metric/metric.py`` [R] — a numpy ``ConfusionMatrix`` fed
per-image ``[gt.flatten(), pred.flatten()]`` pairs, fanned out over a
``multiprocessing.Pool``. Replacement: one fused
``bincount``-style scatter-add per batch *on device* (the histogram is a
single XLA reduce over ``gt*K + pred``), accumulated into a (K, K) fp64-free
int32 matrix; cross-device reduction is a ``psum`` when evaluation runs under
pjit. The host only ever sees the final K×K matrix.

A drop-in ``get_iou(data_list, class_num)`` host API is kept for CLI parity.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def confusion_matrix(pred: jnp.ndarray, gt: jnp.ndarray, num_classes: int,
                     ignore_index: int = 255) -> jnp.ndarray:
    """(K, K) confusion matrix, rows = ground truth, cols = prediction.

    Ignored pixels contribute nothing. jit-safe, any leading shape.
    """
    pred = pred.reshape(-1).astype(jnp.int32)
    gt = gt.reshape(-1).astype(jnp.int32)
    valid = (gt != ignore_index) & (gt >= 0) & (gt < num_classes)
    idx = jnp.where(valid, gt * num_classes + jnp.clip(pred, 0, num_classes - 1),
                    num_classes * num_classes)
    counts = jnp.bincount(idx, length=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def iou_from_confusion(cm: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-class IoU and mean IoU over classes with nonzero union
    (matches reference ConfusionMatrix.jaccard semantics [R])."""
    cm = cm.astype(jnp.float64) if cm.dtype == jnp.int64 else cm.astype(jnp.float32)
    tp = jnp.diagonal(cm)
    union = jnp.sum(cm, axis=0) + jnp.sum(cm, axis=1) - tp
    iou = tp / jnp.maximum(union, 1e-9)
    present = union > 0
    miou = jnp.sum(jnp.where(present, iou, 0.0)) / jnp.maximum(
        jnp.sum(present.astype(cm.dtype)), 1.0)
    return iou, miou


def pixel_accuracy(cm: jnp.ndarray) -> jnp.ndarray:
    cm = cm.astype(jnp.float32)
    return jnp.trace(cm) / jnp.maximum(jnp.sum(cm), 1.0)


class MeanIoU:
    """Streaming evaluator: accumulate batches on device, finalize on host."""

    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self._cm = jnp.zeros((num_classes, num_classes), jnp.int32)
        self._update = jax.jit(
            lambda cm, pred, gt: cm + confusion_matrix(
                pred, gt, num_classes, ignore_index))

    def update(self, pred, gt):
        self._cm = self._update(self._cm, pred, gt)

    def reset(self):
        self._cm = jnp.zeros((self.num_classes, self.num_classes), jnp.int32)

    @property
    def matrix(self) -> np.ndarray:
        return np.asarray(self._cm)

    def result(self) -> Tuple[np.ndarray, float]:
        iou, miou = iou_from_confusion(self._cm)
        return np.asarray(iou), float(miou)


def get_iou(data_list: Sequence[Tuple[np.ndarray, np.ndarray]],
            class_num: int, save_path: Optional[str] = None,
            ignore_index: int = 255) -> Tuple[float, np.ndarray]:
    """CLI-parity API (reference get_iou [R]): list of (gt, pred) pairs
    -> (mean IoU, per-class IoU); optionally writes the per-class report."""
    evaluator = MeanIoU(class_num, ignore_index)
    for gt, pred in data_list:
        evaluator.update(jnp.asarray(pred), jnp.asarray(gt))
    iou, miou = evaluator.result()
    lines = [f"class {i:2d}: IoU {v:.4f}" for i, v in enumerate(iou)]
    lines.append(f"meanIoU: {miou:.4f}")
    report = "\n".join(lines)
    print(report)
    if save_path:
        with open(save_path, "w") as f:
            f.write(report + "\n")
    return miou, iou
