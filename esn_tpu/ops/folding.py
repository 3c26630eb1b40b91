"""Lane folding: pack W-adjacent pixels into channels for narrow-C stages.

Where vector registers and memory tiles are 128 lanes wide on the channel
(minor) axis, as on the accelerator this was designed for before the GPU
port, a 16-channel activation wastes 7/8 of every vector op and memory
tile (not measured on the H100). The
zoo's factorized decoders (ERFNet/ESNet nb1d(16/64) at 1/2 and 1/4 res,
reference model/ERFNet.py :: non_bottleneck_1d [R]) spend most of their
time exactly there.

The fix: reshape ``(B,H,W,C) -> (B,H,W/F,F*C)`` (W-major fold — contiguous
in NHWC row-major, so XLA lowers it to a relayout, paid once per folded
region) and rewrite each stride-1 conv as an equivalent conv on the folded
tensor with a block-structured kernel:

- H-direction taps keep their geometry; each fold slot g uses the same
  weights — a block-diagonal ``(F*C_in, F*C_out)`` kernel.
- W-direction taps move across fold slots: tap offset ``o`` sends input
  slot ``g+o`` (possibly in a neighboring folded pixel) to output slot
  ``g`` — a block-banded kernel over ``U = Tmax-Tmin+1`` folded taps.

The folded kernel is dense with structural zeros: F x more FLOPs for the
W-taps, but every matmul is now 128-lane dense, and memory traffic drops
by F. Exactness is testable: same math, different association.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from .convolution import _conv_core, _conv_raw


def fold_w(x: jnp.ndarray, f: int) -> jnp.ndarray:
    """(B,H,W,C) -> (B,H,W/f,f*C); W must divide by f."""
    b, h, w, c = x.shape
    assert w % f == 0, (w, f)
    return x.reshape(b, h, w // f, f * c)


def unfold_w(x: jnp.ndarray, f: int) -> jnp.ndarray:
    """Inverse of fold_w."""
    b, h, wf, fc = x.shape
    assert fc % f == 0
    return x.reshape(b, h, wf * f, fc // f)


def fold_factor(c: int, w: int, *, max_f: int = 8,
                lanes: int = 128) -> int:
    """Largest F <= max_f with F*C <= lanes and F | W (1 = don't fold)."""
    f = min(max_f, max(1, lanes // c))
    while f > 1 and w % f != 0:
        f -= 1
    return f


def fold_worthwhile(kw: int, dw: int, f: int) -> bool:
    """Is folding a (.,kw) conv with W-dilation dw at fold f a net win?

    The banded folded kernel spans ``U`` folded taps; FLOPs grow U/kw while
    lane density grows ~f. Require U/kw <= f/2 so at least half the density
    gain survives. (f=2,d=5: U=7 -> no; f=8,d=16: U=5 -> yes.)
    """
    pw = dw * (kw - 1) // 2
    pos = [(g + dw * tw - pw) // f for g in range(f) for tw in range(kw)]
    u = max(pos) - min(pos) + 1
    return 2 * u <= kw * f


def folded_kernel(kernel: jnp.ndarray, f: int, *,
                  dilation: Tuple[int, int] = (1, 1),
                  padding: Tuple[int, int] = (0, 0)):
    """Build the folded-conv kernel for a stride-1 conv.

    kernel: (kh, kw, I, O) HWIO. Returns (kf, (wlo, whi)) where
    kf: (kh, U, f*I, f*O) and (wlo, whi) is the folded W-axis padding.
    The H axis keeps the caller's dilation/padding unchanged.

    Derivation: with SAME-style explicit padding pw, the original conv reads
    input index ``w + dw*tw - pw``. Writing output w = f*q + g, that index
    is ``f*(q+T) + g'`` with ``T = (g + dw*tw - pw) // f`` and g' the
    remainder — so original tap (tw, ci -> co) lands in folded tap T at
    block (g'*I, g*O).
    """
    kh, kw, i, o = kernel.shape
    dw = dilation[1]
    pw = padding[1]
    pos = [(g, tw, (g + dw * tw - pw) // f, (g + dw * tw - pw) % f)
           for g in range(f) for tw in range(kw)]
    tmin = min(t for _, _, t, _ in pos)
    tmax = max(t for _, _, t, _ in pos)
    u = tmax - tmin + 1
    kf = jnp.zeros((kh, u, f * i, f * o), kernel.dtype)
    for g, tw, t, gp in pos:
        kf = kf.at[:, t - tmin, gp * i:(gp + 1) * i,
                   g * o:(g + 1) * o].set(kernel[:, tw])
    return kf, (-tmin, tmax)


def folded_depthwise_conv(x: jnp.ndarray, w: jnp.ndarray, f: int, *,
                          dilation: Tuple[int, int] = (1, 1),
                          padding: Tuple[int, int] = (0, 0),
                          bias: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Depthwise conv on a W-folded tensor — full-lane vector execution.

    ``x``: (B, H, W/f, f*C) slot-major (``fold_w`` layout); ``w``:
    (kh, kw, C) per-channel taps. Computes exactly
    ``fold_w(depthwise_conv(unfold_w(x)), f)`` for a stride-1 SAME conv.

    Depthwise convs never touch the matrix unit — they are vector shift-FMA
    loops, so
    at C=32/64 (CGNet/DABNet/FPENet context branches, reference
    ChannelWiseDilatedConv [R: model/CGNet.py]) half to 3/4 of every
    128-wide vector op is padding. Here the conv is written as kh*kw
    shifted multiply-adds on the folded tensor (f*C lanes, dense); a
    W-tap whose offset is not a multiple of f reads its neighbors from a
    rolled slot — a static channel-block slice, fused by XLA into the
    same loop. FLOPs are unchanged; lane density and memory tiles improve
    f x.

    Requires SAME geometry in both axes (every zoo depthwise conv is SAME):
    ``2*p == d*(k-1)`` per axis.
    """
    b, h, q, fc = x.shape
    kh, kw, c = w.shape
    assert fc == f * c, (x.shape, w.shape, f)
    dh, dw = dilation
    ph, pw = padding
    assert 2 * ph == dh * (kh - 1) and 2 * pw == dw * (kw - 1), \
        "folded_depthwise_conv requires SAME geometry"
    offs = [dw * tw - pw for tw in range(kw)]
    qlo = max(0, -min((g + o) // f for o in offs for g in range(f)))
    qhi = max(0, max((g + o) // f for o in offs for g in range(f)))
    xp = jnp.pad(x, ((0, 0), (ph, ph), (qlo, qhi), (0, 0)))
    acc = None
    for th in range(kh):
        hs = slice(th * dh, th * dh + h)
        for tw in range(kw):
            o = dw * tw - pw
            if o % f == 0:
                t = o // f
                term = xp[:, hs, qlo + t: qlo + t + q, :]
            else:
                pieces = []
                for g in range(f):
                    s, t = (g + o) % f, (g + o) // f
                    pieces.append(
                        xp[:, hs, qlo + t: qlo + t + q, s * c:(s + 1) * c])
                term = jnp.concatenate(pieces, -1)
            contrib = term * jnp.tile(w[th, tw], f).astype(x.dtype)
            acc = contrib if acc is None else acc + contrib
    if bias is not None:
        acc = acc + jnp.tile(bias, f).astype(acc.dtype)
    return acc


def folded_conv2d(x: jnp.ndarray, kernel: jnp.ndarray, f: int, *,
                  dilation: Tuple[int, int] = (1, 1),
                  padding: Tuple[int, int] = (0, 0),
                  bias: Optional[jnp.ndarray] = None,
                  custom_grad: bool = True) -> jnp.ndarray:
    """Stride-1 conv on a W-folded tensor, equivalent to conv2d on the
    unfolded one. x: (B,H,W/f,f*I); kernel: the ORIGINAL (kh,kw,I,O)."""
    kf, (wlo, whi) = folded_kernel(kernel, f, dilation=dilation,
                                   padding=padding)
    ph = padding[0]
    core = _conv_core if custom_grad else _conv_raw
    y = core(x, kf, (1, 1), ((ph, ph), (wlo, whi)), (dilation[0], 1), 1)
    if bias is not None:
        y = y + jnp.tile(bias, f).astype(y.dtype)
    return y


def depthwise_dense_kernel(w: jnp.ndarray) -> jnp.ndarray:
    """(kh,kw,1,C) HWIO depthwise kernel -> (kh,kw,C,C) dense, with the
    per-channel taps on the I==O diagonal — same math, the off-diagonal
    zeros are exact in the f32 accumulator.

    Why: a depthwise conv never touches the matrix unit, and in fold layout its
    mixed-slot W-taps need per-slot channel-block concats (lane shuffles).
    Densifying and folding (``folded_kernel`` of this) turns it into ONE
    block-banded 128-lane matrix conv, which beat both the mixed-slot shift-FMA
    and the unfolded path for every FPE dilation before the GPU port (not
    measured on the H100). Reference depthwise dilated convs: FPEBlock / CGNet
    ChannelWise(Dilated)Conv / DABNet [R: model/FPENet.py, model/CGNet.py].
    """
    kh, kw, one, c = w.shape
    assert one == 1, w.shape
    return w[:, :, 0, None, :] * jnp.eye(c, dtype=w.dtype)[None, None]
