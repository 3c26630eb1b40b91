"""Spatial sharding — the vision analogue of sequence/context parallelism
(SURVEY.md §5). Full-res 2048x1024 activations dominate HBM when training
Fast-SCNN/ContextNet (BASELINE config 5); sharding image *height* across a
``model`` mesh axis splits every activation H-wise across devices.

Mechanism: we only annotate shardings — XLA's SPMD partitioner inserts
the halo exchanges (collective-permutes between devices) that stencil ops
(convs, pools) need at shard boundaries. This is the scaling-book recipe
("pick a mesh, annotate, let XLA insert collectives") applied to images; no
hand-written ring code, and it composes with data parallelism on the other
mesh axis and with cross-replica BatchNorm for free.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, MODEL_AXIS


def check_spatial_config(input_hw: Tuple[int, int], n_spatial: int,
                         max_stride: int = 32) -> None:
    """Validate that spatial sharding is inside the supported envelope.

    Deep feature maps shrink to H/max_stride rows; when that drops to ~1-2
    rows per shard XLA's SPMD partitioner hits a grouped-conv/BN backward
    edge case (verified empirically: 512px+ inputs — the config this feature
    exists for — are exact to fp noise; 64px toys are not). Require at least
    max_stride*4 rows and divisibility so every shard keeps whole rows at
    the deepest stage.
    """
    h = input_hw[0]
    deep_h = h // max_stride
    if deep_h < 4 or deep_h % n_spatial != 0:
        raise ValueError(
            f"spatial sharding of H={h} over {n_spatial} shards leaves "
            f"{deep_h} rows at stride {max_stride}; need >=4 rows divisible "
            f"by {n_spatial} (use >= {max_stride * 4}px inputs)")


def make_spatial_mesh(n_data: int, n_spatial: int,
                      devices=None) -> Mesh:
    """(data, model) mesh: batch sharded on 'data', height on 'model'."""
    devices = list(devices if devices is not None else jax.devices())
    need = n_data * n_spatial
    assert len(devices) >= need, f"need {need} devices, have {len(devices)}"
    arr = np.asarray(devices[:need]).reshape(n_data, n_spatial)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def spatial_batch_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    """NHWC: batch on 'data', H on 'model'. For labels use ndim=3."""
    spec = [DATA_AXIS, MODEL_AXIS] + [None] * (ndim - 2)
    return NamedSharding(mesh, P(*spec))


def shard_batch_spatial(batch, mesh: Mesh):
    def put(x):
        return jax.device_put(x, spatial_batch_sharding(mesh, x.ndim))
    return jax.tree_util.tree_map(put, batch)


def replicate(tree, mesh: Mesh):
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
