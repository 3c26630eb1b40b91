"""Spatial resize ops (NHWC, static shapes only — XLA-friendly).

The reference upsamples logits with ``F.interpolate(..., mode='bilinear')``
or transposed convs [R: most model/*.py forward tails]. We standardize on
half-pixel-center bilinear (torch ``align_corners=False``), which is what
``jax.image.resize`` implements.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def resize_bilinear(x: jnp.ndarray, size: Tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize to (H, W); matches torch align_corners=False.

    ``antialias=False`` is required for reference parity on DOWNSCALE:
    torch ``F.interpolate`` and cv2 ``INTER_LINEAR`` sample a plain
    2-tap bilinear kernel at every scale, while jax.image.resize
    defaults to widening the kernel when minifying (maxabs diff 1.28 on
    unit-normal data at 4x — caught via the ContextNet deep-branch
    input). For upsampling antialias is a no-op, so every fused predict
    tail keeps its semantics.
    """
    n, h, w, c = x.shape
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    out = jax.image.resize(x, (n, oh, ow, c), method="bilinear",
                           antialias=False)
    return out.astype(x.dtype)


def resize_nearest(x: jnp.ndarray, size: Tuple[int, int]) -> jnp.ndarray:
    n, h, w, c = x.shape
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    return jax.image.resize(x, (n, oh, ow, c), method="nearest")


def resize_nearest_cv2(x: jnp.ndarray, size: Tuple[int, int]) -> jnp.ndarray:
    """Nearest resize with cv2.INTER_NEAREST index semantics: destination
    pixel j reads source ``min(floor(j * src/dst), src-1)`` — verified
    pixel-exact against cv2 at up- and down-scales (jax.image's
    'nearest' uses a different rounding and DISAGREES with cv2 at most
    scale ratios). The reference resizes LABELS with INTER_NEAREST
    [R: dataset/*.py __getitem__], so label parity requires this exact
    convention. x: (..., H, W) — spatial last two dims; any dtype
    (pure gather, ints stay ints).
    """
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    iy = jnp.minimum((jnp.arange(oh) * (h / oh)).astype(jnp.int32), h - 1)
    ix = jnp.minimum((jnp.arange(ow) * (w / ow)).astype(jnp.int32), w - 1)
    return x[..., iy, :][..., ix]


def upsample2x_bilinear(x: jnp.ndarray) -> jnp.ndarray:
    return resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2))

