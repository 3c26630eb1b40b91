"""Fused bilinear-upsample + class-argmax prediction tail (Pallas, Triton).

Eight zoo models end ``__call__`` with the same tail (reference: every
model/*.py whose forward finishes in ``F.interpolate(mode='bilinear')``
[R]): logits at 1/r resolution -> f32 bilinear x r -> cast back -> argmax.
Unfused, the upsample materialises full-resolution class logits (for
Fast-SCNN at 2048x1024: 2048*1024*19*4 B ~ 159 MB per image) only to
reduce them to one int32 per pixel.

This kernel reads the low-res logits and writes only the int32 map. One
program owns one image, one low-res row ``i`` and ``BLOCK_OUT`` adjacent
full-res columns, one lane per column. Each lane works out its own
horizontal tap pair and weight, then loops over the classes: it reads the
two taps of the <= 3 contributing rows (i-1, i, i+1, clamped), forms the
column interpolation once per row, and from it the r output rows
r*i .. r*i+r-1. Each output row keeps a running (max, index) pair per lane
— a strict ``>`` keeps the first class attaining the max, which is
jnp.argmax's tie rule — so no class padding and no cross-lane reduction
exist. The r index rows are stored straight to their interleaved
full-res positions, each as one contiguous masked store: no phase-major
intermediate and no depth-to-space transpose.

Semantics: ``argmax(resize_bilinear(y.astype(f32), (r*h, r*w)), axis=-1)``.
Half-pixel centres (torch align_corners=False): output pixel r*i+p reads
source coordinate i + (p+0.5)/r - 0.5, a 2-tap convex combination; at the
image border the out-of-range tap clamps (identical to jax.image.resize's
kernel renormalisation in the 2-tap case). The plain tail
(:func:`resize_argmax_ref`) rounds the interpolation to the model dtype
before its argmax, so in bf16 the two can differ at pixels where that
rounding creates a tie; in f32 they differ only by the association of the
separable interpolation (rate-tested in tests/test_pallas_resize_argmax.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# full-res columns per program and its warps: the fastest of (256, 4),
# (512, 4), (512, 8), (1024, 8) for fastscnn's tail on an H100 (PERF.md)
BLOCK_OUT = 512
NUM_WARPS = 8


def resize_argmax_ref(y: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Plain reference: the exact tail the models' ``__call__`` ships."""
    n, h, w, c = y.shape
    out = jax.image.resize(y.astype(jnp.float32),
                           (n, h * factor, w * factor, c), method="bilinear")
    return jnp.argmax(out.astype(y.dtype), axis=-1).astype(jnp.int32)


def _fracs(r: int):
    """Per output phase: (which tap pair, weight on the pair's second tap).
    Pair 0 is (k-1, k), pair 1 is (k, k+1) around source index k."""
    out = []
    for p in range(r):
        d = (p + 0.5) / r - 0.5
        out.append((0, 1.0 + d) if d < 0 else (1, d))
    return out


def _kernel(y_ref, o_ref, *, r: int, bo: int):
    """y_ref: (N, h, w, C) logits; o_ref: (N, r*h, r*w) int32."""
    _, h, w, c = y_ref.shape
    b = pl.program_id(0)
    i = pl.program_id(1)
    ox = pl.program_id(2) * bo + jnp.arange(bo, dtype=jnp.int32)
    j = jnp.minimum(ox // r, w - 1)
    # this lane's horizontal phase as a tap pair and a weight (_fracs)
    d = ((ox % r).astype(jnp.float32) + 0.5) / r - 0.5
    first = d < 0
    g = jnp.where(first, 1.0 + d, d)
    j0 = jnp.clip(jnp.where(first, j - 1, j), 0, w - 1)
    j1 = jnp.clip(jnp.where(first, j, j + 1), 0, w - 1)
    rows = [jnp.clip(i + s, 0, h - 1) for s in (-1, 0, 1)]
    fr = _fracs(r)
    best, idx = [None] * r, [None] * r
    for cc in range(c):
        cols = []
        for rr in rows:
            a = plt.load(y_ref.at[b, rr, j0, cc]).astype(jnp.float32)
            a1 = plt.load(y_ref.at[b, rr, j1, cc]).astype(jnp.float32)
            cols.append(a + g * (a1 - a))
        for p, (pair, f) in enumerate(fr):
            lo, hi = cols[pair], cols[pair + 1]
            x = lo + f * (hi - lo)
            if cc == 0:
                best[p], idx[p] = x, jnp.zeros((bo,), jnp.int32)
            else:
                m = x > best[p]
                best[p] = jnp.where(m, x, best[p])
                idx[p] = jnp.where(m, cc, idx[p])
    for p in range(r):
        plt.store(o_ref.at[b, r * i + p, ox], idx[p], mask=ox < r * w)


@partial(jax.jit, static_argnames=("factor", "interpret"))
def resize_argmax(y: jnp.ndarray, factor: int,
                  interpret: bool = False) -> jnp.ndarray:
    """Fused ``argmax(upsample_bilinear_rx(y))`` -> (B, r*h, r*w) int32.

    y: (B, h, w, C) float logits at low resolution. Prediction only (no
    gradient). ``ops.classify.fused_resize_argmax`` decides eligibility.
    """
    n, h, w, c = y.shape
    r = int(factor)
    bo = min(BLOCK_OUT, pl.next_power_of_2(r * w))
    return pl.pallas_call(
        partial(_kernel, r=r, bo=bo),
        grid=(n, h, pl.cdiv(r * w, bo)),
        out_shape=jax.ShapeDtypeStruct((n, r * h, r * w), jnp.int32),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="resize_argmax",
    )(y)
