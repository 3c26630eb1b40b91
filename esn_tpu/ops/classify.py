"""Prediction-head ops (class-axis argmax).

Separated from the spatial ops because the lowering is perf-critical and
centralized (every eval/predict/bench path routes through here).
"""
from __future__ import annotations

import os

import jax.numpy as jnp
from jax import lax


def _argmax_packed_bf16(x: jnp.ndarray) -> jnp.ndarray:
    """Exact bf16 argmax as ONE plain max-reduce via a packed integer key.

    Key = monotone(value bits) << 8 | (255 - class index): ordering by key
    is ordering by (value, -index), so the max key decodes to the FIRST
    maximal class — jnp.argmax's tie rule. ``x + 0`` first canonicalizes
    -0.0 to +0.0 so both zeros compare equal, as in float compare.
    """
    b = lax.bitcast_convert_type(x + jnp.asarray(0, x.dtype),
                                 jnp.uint16).astype(jnp.int32)
    key = jnp.where(b >= 0x8000, b ^ 0xFFFF, b | 0x8000)
    idx = lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    m = jnp.max((key << 8) | (255 - idx), axis=-1)
    return (255 - (m & 255)).astype(jnp.int32)


def _argmax_two_pass(x: jnp.ndarray) -> jnp.ndarray:
    """Exact argmax for any float dtype as two plain reduces:
    max, then min class index attaining it."""
    c = x.shape[-1]
    m = jnp.max(x, axis=-1, keepdims=True)
    idx = lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    # min() clamped to c-1: an all-NaN row never matches x == m, and the
    # sentinel c would be an out-of-range label for downstream scatters
    # (confusion_matrix). jnp.argmax returns 0 there; any in-range index
    # is an acceptable answer for undefined input.
    return jnp.minimum(jnp.min(jnp.where(x == m, idx, c), axis=-1),
                       c - 1).astype(jnp.int32)


def argmax_lastdim(x, tail: str = "conv"):
    """Class-axis argmax — the zoo's single prediction hook.

    Centralized because the lowering is perf-sensitive and depends on what
    PRODUCED the logits (``tail``, from the model's ``LOGITS_TAIL``):

    - ``jnp.argmax`` is a VARIADIC reduce; XLA refuses its producer into the
      reduction and recomputes it per class. After an expensive producer
      (ESPNet's transposed-conv decoder) that is catastrophic: the
      producer's full cost is paid once per class.
    - But when the producer is a cheap low-res bilinear upsample
      (Fast-SCNN & friends), that same refusion is OPTIMAL: full-res logits
      never touch device memory, and recomputing an upsample per class is
      nearly free; single-pass reformulations lost end to end before the
      GPU port (not measured on the H100).

    So: ``tail="resize"`` (model ends in ``ops.resize``) keeps
    ``jnp.argmax``; ``tail="conv"`` (default — conv/deconv/unpool tails)
    avoids the variadic form with plain max-reduces:

    - bf16: one max over a packed (value bits, reversed index) integer key —
      single pass, bit-exact incl. first-max tie rule (NaN keys sort above
      +inf, roughly matching argmax-on-NaN behavior).
    - other floats: max + masked min-index — two passes, exact for all
      dtypes.

    ``ESN_TPU_ARGMAX=naive`` forces ``jnp.argmax`` everywhere.
    """
    if os.environ.get("ESN_TPU_ARGMAX", "auto") == "naive" \
            or tail == "resize" or x.shape[-1] > 256:
        return jnp.argmax(x, axis=-1).astype(jnp.int32)
    if x.dtype == jnp.bfloat16:
        return _argmax_packed_bf16(x)
    return _argmax_two_pass(x)


def fused_resize_argmax(y, out_hw, *, backend=None, interpret=False):
    """Fused ``argmax(resize_bilinear(y.astype(f32), out_hw))`` through the
    Pallas-Triton kernel (ops.pallas.resize_argmax) — the tail shared by
    eight zoo models [R: every model/*.py forward ending in
    F.interpolate(mode='bilinear')]. Returns ``None`` when the plain tail
    should run instead: on any backend but ``gpu``, for a non-integer or
    anisotropic scale, a scale outside 2..8, or more than 64 classes.

    ``backend`` defaults to ``jax.default_backend()``; ``interpret=True``
    runs the kernel in the Pallas interpreter (tests on the CPU).
    Near-tie caveat: the kernel argmaxes the f32 interpolation (as the
    torch reference does); the plain tail rounds to the model dtype first,
    so argmax can differ where rounding creates ties — both are valid
    answers at those pixels.
    """
    import jax
    if (backend or jax.default_backend()) != "gpu":
        return None
    r = resize_argmax_factor(y.shape, out_hw)
    if r is None:
        return None
    from .pallas.resize_argmax import resize_argmax
    return resize_argmax(y, r, interpret=interpret)


def resize_argmax_factor(shape, out_hw):
    """Upsampling factor r when the fused kernel takes logits of ``shape``
    (B, h, w, C) to ``out_hw``: an integer isotropic r in 2..8 and
    2 <= C <= 64. None otherwise."""
    _, h, w, c = shape
    oh, ow = out_hw
    if oh % h or ow % w or oh // h != ow // w:
        return None
    r = oh // h
    if not 2 <= r <= 8 or not 2 <= c <= 64:
        return None
    return r


def resize_tail_argmax(y, out_hw, *, tail: str = "resize"):
    """The standard resize-tail prediction: the fused kernel where
    :func:`fused_resize_argmax` selects it, else exactly the unfused tail
    the model's __call__ ships (f32 bilinear -> model dtype -> argmax)."""
    out = fused_resize_argmax(y, out_hw)
    if out is not None:
        return out
    from .resize import resize_bilinear
    logits = resize_bilinear(y.astype(jnp.float32), out_hw).astype(y.dtype)
    return argmax_lastdim(logits, tail=tail)


def subpixel_argmax(x, kernel, bias, *, stride, padding,
                    argmax_tail: str = "conv"):
    """Fused prediction head for a final ConvTranspose: class-argmax per
    subpixel phase at LOW res, then depth-to-space the int32 indices.

    ``argmax(depth_to_space(z)) == depth_to_space(argmax per phase)`` —
    depth-to-space only permutes pixels — so this is exact, but the
    full-resolution class-channel logits never exist: the only full-res
    tensor is the int32 prediction map.

    x: (N,H,W,I) features; kernel/bias: the ConvTranspose's parameters.
    """
    from .convolution import subpixel_phase_conv
    sh, sw = stride
    z = subpixel_phase_conv(x, kernel, stride=stride, padding=padding)
    n, h, w, c = z.shape
    o = c // (sh * sw)
    z = z.reshape(n, h, w, sh * sw, o)
    if bias is not None:
        z = z + bias.astype(z.dtype)
    idx = argmax_lastdim(z, tail=argmax_tail)     # (n,h,w,sh*sw)
    idx = idx.reshape(n, h, w, sh, sw).transpose(0, 1, 3, 2, 4)
    return idx.reshape(n, h * sh, w * sw)


def resize2x_head_argmax(y, w, b, *, argmax_tail: str = "conv"):
    """Fused ``argmax(resize_bilinear_2x(conv1x1(y)))`` prediction tail.

    For a model whose head sits at 1/2 res (FPENet's MEU decoder
    [R: model/FPENet.py]), the default tail materializes full-res class
    logits — the f32 bilinear intermediate plus its writes at full
    resolution. Both ops are linear, so
    resize∘head is ONE conv: each of the 4 subpixel phases of the 2x
    half-pixel-centre bilinear (torch align_corners=False, as
    ops.resize.resize_bilinear) is a fixed 2x2-tap convex combination,
    so (bilinear ⊗ head) is a single conv producing all phases' logits
    at HALF res; argmax runs per phase and the int32 index maps
    interleave (argmax commutes with the pixel permutation, cf.
    subpixel_argmax). Runs W-folded (f = 128/C_in) so the narrow head
    input is read lane-dense; jax.image.resize's edge clamping is
    reproduced by edge-padding the folded input (slot-0 / slot-(f-1)
    blocks tiled across slots). Full-res logits never exist. Same math
    as the unfused tail up to f32 re-association of the premultiplied
    (bilinear x head) weights — argmax can differ at near-tie pixels.

    y: (B,H,W,C) features; w: (1,1,C,nc) head kernel; b: (nc,) or None.
    Returns (B,2H,2W) int32, or None if the geometry is ineligible
    (caller falls back to the unfused tail).
    """
    bsz, h, ww, c = y.shape
    nc = w.shape[-1]
    if 128 % c or not 2 <= 128 // c <= 8:
        return None
    f = 128 // c
    if ww % f:
        return None
    yf = y.reshape(bsz, h, ww // f, f * c)
    q = ww // f
    # edge padding: H rows clamp directly; the W taps one full-res pixel
    # outside clamp to column 0 / W-1, i.e. a folded column whose every
    # slot holds the slot-0 (slot f-1) block of the edge column
    left = jnp.tile(yf[:, :, :1, :c], (1, 1, 1, f))
    right = jnp.tile(yf[:, :, -1:, (f - 1) * c:], (1, 1, 1, f))
    yp = jnp.concatenate([left, yf, right], axis=2)
    yp = jnp.concatenate([yp[:, :1], yp, yp[:, -1:]], axis=1)
    # fused kernel: out channel = slot*4*nc + (p*2+q)*nc + cls
    taps = {0: ((-1, 0.25), (0, 0.75)), 1: ((0, 0.75), (1, 0.25))}
    kf = jnp.zeros((3, 3, f * c, f * 4 * nc), w.dtype)
    w00 = w[0, 0]                                   # (C, nc)
    for p in (0, 1):
        for qq in (0, 1):
            for oh, ah in taps[p]:
                for ow, aw in taps[qq]:
                    for s in range(f):
                        t = s + ow
                        tq, ts = divmod(t, f)
                        col = s * 4 * nc + (p * 2 + qq) * nc
                        kf = kf.at[1 + oh, 1 + tq, ts * c:(ts + 1) * c,
                                   col:col + nc].add(ah * aw * w00)
    from .convolution import _conv_core
    z = _conv_core(yp, kf, (1, 1), ((0, 0), (0, 0)), (1, 1), 1)
    z = z.reshape(bsz, h, q, f * 4, nc)
    if b is not None:
        z = z + b.astype(z.dtype)
    idx = argmax_lastdim(z, tail=argmax_tail)        # (B,H,Q,f*4)
    idx = idx.reshape(bsz, h, q, f, 2, 2).transpose(0, 1, 4, 2, 3, 5)
    return idx.reshape(bsz, 2 * h, 2 * ww)
