"""Pooling ops, including the index-preserving max-pool/max-unpool pair.

The reference relies on cuDNN ``MaxPool2d(return_indices=True)`` +
``MaxUnpool2d`` for the ENet/SegNet decoders [R: model/ENet.py,
model/SegNet.py]. JAX has no stock unpool; the classic route is a scatter,
which serialises on colliding writes. We exploit that every use in the
zoo is a 2x2/stride-2 window, so the pool is a reshape+max over a static
4-lane axis and the unpool is a **one-hot multiply + reshape** — pure
elementwise work, no scatter, trivially differentiable, and it
fuses with the surrounding convs under XLA.

Indices are local window positions in [0, 4): ``idx = di*2 + dj`` (int32,
same NHWC layout as the pooled output) — not torch's flat global indices.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import jax.numpy as jnp
from jax import lax

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v):
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def max_pool2d(x: jnp.ndarray, window: IntOr2, stride: Optional[IntOr2] = None,
               padding: IntOr2 = 0) -> jnp.ndarray:
    """Standard max pool, NHWC, torch floor semantics."""
    kh, kw = _pair(window)
    sh, sw = _pair(stride if stride is not None else window)
    ph, pw = _pair(padding)
    neg_inf = -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(x.dtype).min
    return lax.reduce_window(
        x, neg_inf, lax.max,
        window_dimensions=(1, kh, kw, 1),
        window_strides=(1, sh, sw, 1),
        padding=((0, 0), (ph, ph), (pw, pw), (0, 0)),
    )


def avg_pool2d(x: jnp.ndarray, window: IntOr2, stride: Optional[IntOr2] = None,
               padding: IntOr2 = 0, count_include_pad: bool = True) -> jnp.ndarray:
    """Average pool, NHWC (torch default count_include_pad=True)."""
    kh, kw = _pair(window)
    sh, sw = _pair(stride if stride is not None else window)
    ph, pw = _pair(padding)
    summed = lax.reduce_window(
        x.astype(jnp.float32), 0.0, lax.add,
        window_dimensions=(1, kh, kw, 1),
        window_strides=(1, sh, sw, 1),
        padding=((0, 0), (ph, ph), (pw, pw), (0, 0)),
    )
    if count_include_pad or (ph == 0 and pw == 0):
        y = summed / float(kh * kw)
    else:
        ones = jnp.ones(x.shape[:3] + (1,), jnp.float32)
        counts = lax.reduce_window(
            ones, 0.0, lax.add,
            window_dimensions=(1, kh, kw, 1),
            window_strides=(1, sh, sw, 1),
            padding=((0, 0), (ph, ph), (pw, pw), (0, 0)),
        )
        y = summed / counts
    return y.astype(x.dtype)


def max_pool2d_with_indices_2x2(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """2x2 stride-2 max pool returning (values, local argmax indices).

    Odd trailing rows/cols are dropped (torch floor semantics). Ties resolve
    to the first (lowest) window position, matching ``jnp.argmax``.

    (A strided-view + fused-compare variant was slower on ENet before the
    GPU port — four stride-2 middle-dim reads beat one transpose only on
    paper; not measured on the H100.)
    """
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    xr = x[:, : 2 * h2, : 2 * w2, :]
    xr = xr.reshape(n, h2, 2, w2, 2, c)
    # (n, h2, w2, c, di, dj) -> flatten window to last axis
    xr = xr.transpose(0, 1, 3, 5, 2, 4).reshape(n, h2, w2, c, 4)
    vals = jnp.max(xr, axis=-1)
    idx = jnp.argmax(xr, axis=-1).astype(jnp.int32)
    return vals, idx


def max_unpool2d_2x2(y: jnp.ndarray, idx: jnp.ndarray,
                     output_size: Optional[Tuple[int, int]] = None) -> jnp.ndarray:
    """Inverse of :func:`max_pool2d_with_indices_2x2`, scatter-free.

    Places each value at its remembered window position, zeros elsewhere.
    Formulated as four masked planes stacked in (row, col) window order so
    the final reshape to (2H, 2W) is a pure view — the earlier
    one-hot-expand + 6-axis transpose version materialized a 4x-size
    transpose copy (profiled at ~1/3 of a SegNet inference step).
    ``output_size`` (H, W) pads/crops to handle odd originals.
    """
    n, h, w, c = y.shape
    planes = [y * (idx == k).astype(y.dtype) for k in range(4)]
    top = jnp.stack(planes[0:2], axis=3)              # (n, h, w, dj, c)
    bot = jnp.stack(planes[2:4], axis=3)
    rows = jnp.stack([top, bot], axis=2)              # (n, h, di, w, dj, c)
    out = rows.reshape(n, 2 * h, 2 * w, c)
    if output_size is not None:
        oh, ow = output_size
        if oh > 2 * h or ow > 2 * w:
            out = jnp.pad(out, ((0, 0), (0, max(0, oh - 2 * h)),
                                (0, max(0, ow - 2 * w)), (0, 0)))
        out = out[:, :oh, :ow, :]
    return out


def global_avg_pool(x: jnp.ndarray, keepdims: bool = True) -> jnp.ndarray:
    y = jnp.mean(x.astype(jnp.float32), axis=(1, 2), keepdims=keepdims)
    return y.astype(x.dtype)


def adaptive_avg_pool2d(x: jnp.ndarray, output_size: IntOr2) -> jnp.ndarray:
    """torch-style adaptive average pool (bin edges floor/ceil), NHWC.

    Output sizes in the zoo are tiny (PPM: 1,2,3,6 [R: model/FastSCNN.py];
    APN GAP branch), so we emit one static-slice mean per bin — XLA folds
    these into a handful of fused reductions.
    """
    oh, ow = _pair(output_size)
    n, h, w, c = x.shape
    if (h % oh == 0) and (w % ow == 0):
        # fast path: plain average pool
        return avg_pool2d(x, (h // oh, w // ow), (h // oh, w // ow))
    rows = []
    for i in range(oh):
        h0, h1 = (i * h) // oh, -(-((i + 1) * h) // oh)
        h1 = max(h1, h0 + 1) if h0 < h else h1  # guard h < oh (tiny inputs)
        cols = []
        for j in range(ow):
            w0, w1 = (j * w) // ow, -(-((j + 1) * w) // ow)
            w1 = max(w1, w0 + 1) if w0 < w else w1
            cols.append(jnp.mean(x[:, h0:h1, w0:w1, :].astype(jnp.float32),
                                 axis=(1, 2)))
        rows.append(jnp.stack(cols, axis=1))
    out = jnp.stack(rows, axis=1)  # (n, oh, ow, c)
    return out.astype(x.dtype)
