"""Convolution primitives, NHWC / HWIO.

The reference gets all conv FLOPs from cuDNN via ``torch.nn.Conv2d`` (NCHW)
[R: every model/*.py]. Here everything is ``lax.conv_general_dilated`` in
NHWC, which XLA hands to cuDNN on the GPU; bf16 inputs accumulate in
fp32.

Shape semantics mirror torch's integer-padding convention exactly (the model
zoo's geometry depends on it): ``out = floor((H + 2p - d*(k-1) - 1)/s) + 1``.

Weight-porting note: torch Conv2d weights are OIHW; ours are HWIO
(``w_jax = w_torch.transpose(2, 3, 1, 0)``). torch ConvTranspose2d weights
are IOHW and must additionally be spatially flipped
(``w_jax = w_torch.flip(2, 3).transpose(2, 3, 0, 1)``) because we express
transposed conv as an lhs-dilated regular conv.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 2
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


import functools


def _conv_raw(x, kernel, stride, padding, dilation, groups):
    return lax.conv_general_dilated(
        x, kernel.astype(x.dtype),
        window_strides=stride,
        padding=padding,
        rhs_dilation=dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5))
def _conv_core(x, kernel, stride, padding, dilation, groups):
    """conv with a hand-written weight gradient.

    XLA's native conv weight-grad lowered poorly for dense kernels on the
    machine this was tuned on before the GPU port (not measured on the
    H100); dW is mathematically K*K strided-slice contractions, so emit
    exactly that: one ``(Ci, N*Ho*Wo) @ (N*Ho*Wo, Co)`` matmul per tap. dx
    keeps XLA's native transposed-conv grad.
    """
    return _conv_raw(x, kernel, stride, padding, dilation, groups)


def _conv_fwd(x, kernel, stride, padding, dilation, groups):
    return _conv_core(x, kernel, stride, padding, dilation, groups), (x, kernel)


def _conv_bwd(stride, padding, dilation, groups, res, gy):
    x, kernel = res
    _, vjp_x = jax.vjp(
        lambda x_: _conv_raw(x_, kernel, stride, padding, dilation, groups), x)
    (dx,) = vjp_x(gy)

    kh, kw = kernel.shape[:2]
    if groups != 1 or kh * kw > 25 or x.shape[-1] < 8:
        # depthwise/grouped: XLA's native dW is fine; huge kernels:
        # tap-loop trace cost outweighs the win; tiny c_in (the RGB stem):
        # the taps' pad+reshape costs more than native
        _, vjp_w = jax.vjp(
            lambda w_: _conv_raw(x, w_, stride, padding, dilation, groups),
            kernel)
        (dw,) = vjp_w(gy)
        return dx, dw

    (ph0, ph1), (pw0, pw1) = padding
    sh, sw = stride
    dh, dw_ = dilation
    n, ho, wo = gy.shape[:3]
    c_in = x.shape[-1]

    if sh <= 2 and sw <= 2:
        # Strided slices materialize; decompose each axis by stride parity
        # with a free reshape so every tap is a unit-stride, fusable slice.
        # rows/cols the taps touch, rounded up to a stride multiple
        hp = -(-((kh - 1) * dh + ho * sh) // sh) * sh
        wp = -(-((kw - 1) * dw_ + wo * sw) // sw) * sw
        eh = max(hp - (x.shape[1] + ph0 + ph1), 0)
        ew = max(wp - (x.shape[2] + pw0 + pw1), 0)
        xp = jnp.pad(x, ((0, 0), (ph0, ph1 + eh), (pw0, pw1 + ew), (0, 0)))
        xp = xp[:, :hp, :wp, :]
        xr = xp.reshape(n, hp // sh, sh, wp // sw, sw, c_in)

        def tap(ki, kj):
            r0, c0 = ki * dh, kj * dw_
            return xr[:, r0 // sh:r0 // sh + ho, r0 % sh,
                      c0 // sw:c0 // sw + wo, c0 % sw, :]
    else:
        xp = jnp.pad(x, ((0, 0), (ph0, ph1), (pw0, pw1), (0, 0)))

        def tap(ki, kj):
            r0, c0 = ki * dh, kj * dw_
            rows = lax.slice_in_dim(xp, r0, r0 + (ho - 1) * sh + 1, sh,
                                    axis=1)
            return lax.slice_in_dim(rows, c0, c0 + (wo - 1) * sw + 1, sw,
                                    axis=2)

    taps = []
    for ki in range(kh):
        for kj in range(kw):
            taps.append(jnp.einsum(
                "nhwc,nhwd->cd", tap(ki, kj), gy,
                preferred_element_type=jnp.float32))
    dw = jnp.stack(taps).reshape(kh, kw, *taps[0].shape)
    return dx, dw.astype(kernel.dtype)


_conv_core.defvjp(_conv_fwd, _conv_bwd)


def conv2d(x: jnp.ndarray, kernel: jnp.ndarray, *,
           stride: IntOr2 = 1, padding: IntOr2 = 0, dilation: IntOr2 = 1,
           groups: int = 1, bias: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """2D convolution. x: NHWC, kernel: HWIO (I = in_channels // groups).

    Reverse-mode grads use the custom weight-gradient VJP above. custom_vjp
    functions reject forward-mode autodiff (jvp/jacfwd); set
    ``ESN_TPU_CUSTOM_CONV_GRAD=0`` to fall back to XLA's native conv autodiff
    when forward mode is needed (slower weight grads, full transform support).
    """
    import os
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    core = _conv_core if os.environ.get(
        "ESN_TPU_CUSTOM_CONV_GRAD", "1") != "0" else _conv_raw
    y = core(x, kernel, (sh, sw), ((ph, ph), (pw, pw)), (dh, dw), groups)
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y


def _zero_insert(x: jnp.ndarray, sh: int, sw: int) -> jnp.ndarray:
    """(N,H,W,C) -> (N,H*sh,W*sw,C): each pixel followed by s-1 zero rows/cols."""
    if sh == 1 and sw == 1:
        return x
    n, h, w, c = x.shape
    y = jnp.zeros((n, h, sh, w, sw, c), x.dtype)
    y = y.at[:, :, 0, :, 0, :].set(x)
    return y.reshape(n, h * sh, w * sw, c)


def _subpixel_axis(K: int, s: int, p: int):
    """Per-axis tap geometry for the subpixel convT decomposition.

    In this module's convT convention (zero-insert + UNFLIPPED stride-1
    correlation with pad K-1-p), phase r of the output satisfies
    ``out[s*q + r] = sum_u x[q + (u + r + p - K + 1)//s] * w[u]`` over taps
    ``u`` with ``(u + r + p - K + 1) % s == 0``.

    Returns (first-tap-per-phase, input-offset-per-phase, dmin, dmax).
    """
    k0, d0 = [], []
    dmin, dmax = 10 ** 9, -10 ** 9
    for r in range(s):
        u0 = (K - 1 - p - r) % s
        assert u0 < K, "phase with zero taps (k < s geometry)"
        n_taps = len(range(u0, K, s))
        base = (u0 + r + p - K + 1) // s
        k0.append(u0)
        d0.append(base)
        dmin = min(dmin, base)
        dmax = max(dmax, base + n_taps - 1)
    return k0, d0, dmin, dmax


def subpixel_phase_conv(x: jnp.ndarray, kernel: jnp.ndarray, *,
                        stride: Tuple[int, int],
                        padding: Tuple[int, int]) -> jnp.ndarray:
    """The stride-1 phase conv of the subpixel convT decomposition:
    returns (N, H, W, sh*sw*O) phase-major — depth-to-space of this equals
    the transposed conv. Exposed separately so prediction heads can reduce
    over classes BEFORE depth-to-space (ops.classify.subpixel_argmax)."""
    sh, sw = stride
    ph, pw = padding
    K_h, K_w, I, O = kernel.shape
    k0h, d0h, dminh, dmaxh = _subpixel_axis(K_h, sh, ph)
    k0w, d0w, dminw, dmaxw = _subpixel_axis(K_w, sw, pw)
    Uh = dmaxh - dminh + 1
    Uw = dmaxw - dminw + 1
    assert dminh <= 0 and dminw <= 0, "unsupported convT geometry"
    parts = []
    for rh in range(sh):
        for rw in range(sw):
            sub = kernel[k0h[rh]::sh, k0w[rw]::sw]
            oh = d0h[rh] - dminh
            ow = d0w[rw] - dminw
            sub = jnp.pad(sub, ((oh, Uh - oh - sub.shape[0]),
                                (ow, Uw - ow - sub.shape[1]),
                                (0, 0), (0, 0)))
            parts.append(sub)
    merged = jnp.concatenate(parts, axis=-1)  # (Uh, Uw, I, sh*sw*O)
    pad = ((-dminh, dmaxh), (-dminw, dmaxw))
    import os
    core = _conv_core if os.environ.get(
        "ESN_TPU_CUSTOM_CONV_GRAD", "1") != "0" else _conv_raw
    return core(x, merged, (1, 1), pad, (1, 1), 1)


def depth_to_space(y: jnp.ndarray, sh: int, sw: int) -> jnp.ndarray:
    """(N, H, W, sh*sw*O) phase-major -> (N, sh*H, sw*W, O)."""
    n, h, w, c = y.shape
    o = c // (sh * sw)
    y = y.reshape(n, h, w, sh, sw, o).transpose(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h * sh, w * sw, o)


def conv2d_transpose_subpixel(x: jnp.ndarray, kernel: jnp.ndarray, *,
                              stride: Tuple[int, int],
                              padding: Tuple[int, int],
                              bias: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """ConvT(k, s) as ONE stride-1 conv to ``s*s*O`` channels at input
    resolution + depth-to-space — the subpixel/pixel-shuffle decomposition.

    Requires ``k + output_padding - 2p == s`` per axis (out == s*H), which
    covers the zoo's two decoder geometries (k2s2p0 and k3s2p1op1). Wins
    twice over zero-insertion: the matmul runs at LOW res with s^2-fat output
    channels (dense matrix work instead of 3/4-zero taps), and a class-axis
    argmax downstream no longer refuses a full-res conv as its producer.
    """
    y = subpixel_phase_conv(x, kernel, stride=stride, padding=padding)
    y = depth_to_space(y, stride[0], stride[1])
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y


def conv2d_transpose(x: jnp.ndarray, kernel: jnp.ndarray, *,
                     stride: IntOr2 = 1, padding: IntOr2 = 0,
                     output_padding: IntOr2 = 0,
                     bias: Optional[jnp.ndarray] = None,
                     lowering: str = "auto") -> jnp.ndarray:
    """Transposed conv with torch shape semantics:
    ``out = (H - 1)*s - 2p + k + output_padding``. x: NHWC, kernel: HWIO
    (I = in_channels, O = out_channels).

    Default lowering is the subpixel decomposition (see
    ``conv2d_transpose_subpixel``) whenever the geometry allows; otherwise
    explicit zero-insertion (reshape interleave) + a stride-1 conv. Neither
    uses lax lhs_dilation: lhs-dilated convs with asymmetric padding
    miscompile under the SPMD spatial partitioner (halo logic).
    Set ``ESN_TPU_SUBPIXEL_CONVT=0`` to force zero-insertion everywhere.
    """
    import os
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    oph, opw = _pair(output_padding)
    kh, kw = kernel.shape[0], kernel.shape[1]
    assert oph < sh and opw < sw, "output_padding must be < stride"
    if (lowering != "zero_insert"
            and os.environ.get("ESN_TPU_SUBPIXEL_CONVT", "1") != "0"
            and (sh > 1 or sw > 1)
            and kh + oph - 2 * ph == sh and kw + opw - 2 * pw == sw
            and kh >= sh and kw >= sw):
        return conv2d_transpose_subpixel(x, kernel, stride=(sh, sw),
                                         padding=(ph, pw), bias=bias)
    y = _zero_insert(x, sh, sw)
    # zero-insertion appends (s-1) trailing zero rows/cols beyond the last
    # sample vs. pure lhs-dilation; fold them into the high-side padding
    pad_h = (kh - 1 - ph, kh - 1 - ph + oph - (sh - 1))
    pad_w = (kw - 1 - pw, kw - 1 - pw + opw - (sw - 1))

    def clamp(yy, axis, lo, hi):
        # negative padding = crop (rare: p > k-1 or large stride)
        if lo < 0:
            yy = lax.slice_in_dim(yy, -lo, yy.shape[axis], axis=axis)
            lo = 0
        if hi < 0:
            yy = lax.slice_in_dim(yy, 0, yy.shape[axis] + hi, axis=axis)
            hi = 0
        return yy, lo, hi

    y, lo_h, hi_h = clamp(y, 1, *pad_h)
    y, lo_w, hi_w = clamp(y, 2, *pad_w)
    y = lax.conv_general_dilated(
        y, kernel.astype(x.dtype),
        window_strides=(1, 1),
        padding=((lo_h, hi_h), (lo_w, hi_w)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y


def depthwise_conv2d(x: jnp.ndarray, kernel: jnp.ndarray, *,
                     stride: IntOr2 = 1, padding: IntOr2 = 0,
                     dilation: IntOr2 = 1,
                     bias: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Depthwise conv: kernel HW1C (HWIO with I=1, O=C*multiplier)."""
    channels = x.shape[-1]
    return conv2d(x, kernel, stride=stride, padding=padding,
                  dilation=dilation, groups=channels, bias=bias)


def conv_output_size(size: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1
