"""Device mesh + sharding helpers — the framework's distributed backbone.

Reference counterpart: ``nn.DataParallel`` single-process scatter/gather [R:
train.py :: train_model] — replaced by a named ``jax.sharding.Mesh`` whose
collectives XLA inserts (NCCL on GPUs). The zoo's models are 0.3–30M params, so
the production layout is pure data parallelism (batch sharded on the ``data``
axis, params replicated, gradients psum'd by XLA's global-view autodiff); a
``model`` axis is reserved in the mesh-naming contract for spatial sharding of
full-res activations (SURVEY.md §5 — vision analogue of sequence parallelism),
wired in esn_tpu/parallel/spatial.py.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(devices: Optional[Sequence] = None,
              axes: Tuple[str, ...] = (DATA_AXIS,),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Build a mesh. Default: all devices on one 'data' axis.

    ``shape`` reshapes devices for multi-axis meshes, e.g. (2, 2) with
    axes ('data', 'model'). The cards of one host reach each other all to
    all over NVLink, so the axis order follows the algorithm alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axes) - 1)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axes)


def batch_sharding(mesh: Mesh, ndim: int = 4,
                   axis: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) dim; replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """device_put every array in the batch with its batch dim sharded."""
    def put(x):
        return jax.device_put(x, NamedSharding(
            mesh, P(axis, *([None] * (x.ndim - 1)))))
    return jax.tree_util.tree_map(put, batch)


def replicate(tree, mesh: Mesh):
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def pad_batch_to(batch, target_b: int):
    """Pad every array's leading dim up to exactly ``target_b`` (host-side
    numpy, edge mode). Non-array values pass through untouched.

    Returns (padded_batch, real_count). Used for the tail batch of an epoch
    when drop_last=False — padding to one FIXED batch shape means eval
    compiles once per resolution, and padded rows are masked out of the
    confusion matrix via the batch's "valid" count (train/step.py).
    """
    def pad(x):
        if not isinstance(x, np.ndarray):
            return x
        b = x.shape[0]
        assert b <= target_b, f"batch {b} exceeds pad target {target_b}"
        if b == target_b:
            return x
        pad_width = [(0, target_b - b)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad_width, mode="edge")
    first = next(v for v in jax.tree_util.tree_leaves(batch)
                 if isinstance(v, np.ndarray))
    return {k: pad(v) for k, v in batch.items()}, first.shape[0]


def pad_batch_to_devices(batch, n_devices: int):
    """Pad the leading dim up to a multiple of n_devices. See pad_batch_to."""
    first = next(v for v in jax.tree_util.tree_leaves(batch)
                 if isinstance(v, np.ndarray))
    b = first.shape[0]
    return pad_batch_to(batch, b + ((-b) % n_devices))
