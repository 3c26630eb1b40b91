"""Space-to-depth stem lowering: stride-s RGB convs as dense stride-1 convs.

The zoo's stems convolve a full-res 3-channel input with stride 2
(reference: ENet InitialBlock, ERFNet DownsamplerBlock, FastSCNN/CGNet/
DABNet/ESPNet first conv [R: model/*.py]). Where the channel axis is tiled
128 lanes wide, as on the accelerator this was designed for before the GPU
port, a 3-channel NHWC tensor is padded to 128 lanes in every vector
register and memory tile, and the stem's weight-grad materialising that
padded full-res input was the single largest training allocation (not
measured on the H100).

The fix: a stride-s conv consumes disjoint s x s input blocks up to its
halo, so reshaping the input space-to-depth ``(B,H,W,C) -> (B,H/s,W/s,
s*s*C)`` (phase-major) turns it into a stride-1 conv with a rearranged
kernel: tap (dh, dw) of the original kernel lands at folded tap
``T = floor((d-p)/s)`` per axis, phase ``g = (d-p) mod s``. Every original
weight appears exactly once; the folded kernel is (Uh, Uw, s*s*C, O) with
structural zeros. Same math, 4x fewer spatial positions, s*s*C lanes
instead of C — and the weight-grad input materialization shrinks by s*s.

This is the 2D, strided generalization of ops/folding.py's W-axis lane
folding (see its derivation); both are exact rewrites tested against the
plain lowering.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from .convolution import _conv_core, _conv_raw


def space_to_depth(x: jnp.ndarray, fh: int, fw: int) -> jnp.ndarray:
    """(B,H,W,C) -> (B,H/fh,W/fw,fh*fw*C), phase-major (gh, gw, c).

    Shuffle-free formulation: because W and C are adjacent in NHWC and the
    phase layout is (gh, gw, c)-major, the W-phase interleave is a PURE
    RESHAPE of the (W*C)-flattened rows; only the H-phase split moves data
    (an H-strided slice + channel concat, both layout-friendly). The naive
    6-D transpose lowering is a cross-lane byte shuffle; here XLA can fuse
    the slices into the consumer conv.
    """
    b, h, w, c = x.shape
    assert h % fh == 0 and w % fw == 0, (h, w, fh, fw)
    xf = x.reshape(b, h, w // fw, fw * c)
    if fh == 1:
        return xf
    pieces = [xf[:, gh::fh] for gh in range(fh)]
    return jnp.concatenate(pieces, axis=-1)


def _axis_taps(k: int, s: int, p: int):
    """Original tap d -> (folded tap T, phase g) for one axis."""
    taps = [((d - p) // s, (d - p) % s) for d in range(k)]
    tmin = min(t for t, _ in taps)
    tmax = max(t for t, _ in taps)
    return taps, tmin, tmax


def s2d_kernel(kernel: jnp.ndarray, stride: Tuple[int, int],
               padding: Tuple[int, int]):
    """Rearranged kernel for the space-to-depth lowering.

    kernel: (kh, kw, I, O) HWIO of the ORIGINAL stride-s conv.
    Returns (kf, pads) with kf: (Uh, Uw, sh*sw*I, O) and pads the folded
    explicit padding ((lo_h, hi_h), (lo_w, hi_w)).
    """
    kh, kw, i, o = kernel.shape
    sh, sw = stride
    ph, pw = padding
    taps_h, tmin_h, tmax_h = _axis_taps(kh, sh, ph)
    taps_w, tmin_w, tmax_w = _axis_taps(kw, sw, pw)
    uh = tmax_h - tmin_h + 1
    uw = tmax_w - tmin_w + 1
    kf = jnp.zeros((uh, uw, sh * sw * i, o), kernel.dtype)
    for dh, (th, gh) in enumerate(taps_h):
        for dw, (tw, gw) in enumerate(taps_w):
            blk = (gh * sw + gw) * i
            kf = kf.at[th - tmin_h, tw - tmin_w,
                       blk:blk + i, :].set(kernel[dh, dw])
    return kf, ((-tmin_h, tmax_h), (-tmin_w, tmax_w))


def general_folded_kernel(kernel: jnp.ndarray, *,
                          stride: Tuple[int, int],
                          padding: Tuple[int, int],
                          in_fold: Tuple[int, int],
                          out_fold_w: int):
    """Kernel for a conv that CONSUMES an s2d-folded input and PRODUCES a
    W-lane-folded output — both sides at full lane density.

    Original conv: K (kh,kw,ci,co), stride (sh,sw), SAME-ish pad (ph,pw).
    Input arrives as ``space_to_depth(x, fh, fwi)`` (phase-major); output
    is ``fold_w(conv(x), fo)`` (slot-major g*co+c). Requirements for the
    rewrite to BE a convolution on the folded tensors (tap offsets must
    not depend on position): ``sh % fh == 0`` and ``(sw*fo) % fwi == 0``.
    The folded conv then has stride ``(sh//fh, sw*fo//fwi)``.

    Derivation: output element (h', q, g*co+c) is original output
    (h', fo*q+g); its tap (th,tw) reads original input row
    ``sh*h' - ph + th`` -> folded row ``(sh//fh)*h' + (th-ph)//fh``, phase
    ``(th-ph) % fh``; and col ``sw*(fo*q+g) - pw + tw`` -> folded col
    ``SW*q + (sw*g - pw + tw)//fwi``, phase ``(sw*g - pw + tw) % fwi``.
    Every original weight lands once per output slot g; zeros elsewhere.

    Returns (folded_kernel (Uh,Uw, fh*fwi*ci, fo*co), folded stride,
    folded pads ((lo_h, hi_h), (lo_w, hi_w)) as asymmetric padding).
    """
    kh, kw, ci, co = kernel.shape
    sh, sw = stride
    ph, pw = padding
    fh, fwi = in_fold
    fo = out_fold_w
    assert sh % fh == 0 and (sw * fo) % fwi == 0, (stride, in_fold, fo)
    hts = sorted({(th - ph) // fh for th in range(kh)})
    wts = sorted({(sw * g - pw + tw) // fwi
                  for g in range(fo) for tw in range(kw)})
    uh, uw = hts[-1] - hts[0] + 1, wts[-1] - wts[0] + 1
    # traceable scatter (static indices): the kernel is usually a traced
    # model parameter, so the folded kernel must be built with jnp ops —
    # the grad then flows back through the placement automatically
    kf = jnp.zeros((uh, uw, fh * fwi * ci, fo * co), kernel.dtype)
    for th in range(kh):
        ht, gh = divmod(th - ph, fh)
        for g in range(fo):
            for tw in range(kw):
                wt, gw = divmod(sw * g - pw + tw, fwi)
                s = (gh * fwi + gw) * ci
                kf = kf.at[ht - hts[0], wt - wts[0], s:s + ci,
                           g * co:(g + 1) * co].add(kernel[th, tw])
    return (kf, (sh // fh, sw * fo // fwi), (hts[0], wts[0]), (uh, uw))


def general_folded_conv(xs: jnp.ndarray, kernel: jnp.ndarray, *,
                        stride: Tuple[int, int], padding: Tuple[int, int],
                        in_fold: Tuple[int, int], out_fold_w: int,
                        bias: Optional[jnp.ndarray] = None,
                        custom_grad: bool = True) -> jnp.ndarray:
    """Run a conv on an s2d-folded input, emitting a W-folded output.
    ``xs = space_to_depth(x, *in_fold)``; result equals
    ``fold_w(conv2d(x, kernel, stride, padding), out_fold_w)``."""
    kh, kw = kernel.shape[:2]
    sh, sw = stride
    ph, pw = padding
    fh, fwi = in_fold
    fo = out_fold_w
    kf, fstride, (ht0, wt0), (uh, uw) = general_folded_kernel(
        kernel, stride=stride, padding=padding, in_fold=in_fold,
        out_fold_w=out_fold_w)
    hf, wf = xs.shape[1], xs.shape[2]
    ho = (hf * fh + 2 * ph - kh) // sh + 1
    wo = (wf * fwi + 2 * pw - kw) // sw + 1
    assert wo % fo == 0, (wo, fo)
    q = wo // fo
    lo_h, lo_w = -ht0, -wt0
    hi_h = (ho - 1) * fstride[0] + uh - lo_h - hf
    hi_w = (q - 1) * fstride[1] + uw - lo_w - wf
    core = _conv_core if custom_grad else _conv_raw
    y = core(xs, kf, fstride, ((lo_h, hi_h), (lo_w, hi_w)), (1, 1), 1)
    if bias is not None:
        y = y + jnp.tile(bias, out_fold_w).astype(y.dtype)
    return y


def s2d_conv_on_folded(xs: jnp.ndarray, kernel: jnp.ndarray, *,
                       stride: Tuple[int, int], padding: Tuple[int, int],
                       bias: Optional[jnp.ndarray] = None,
                       custom_grad: bool = True) -> jnp.ndarray:
    """Like :func:`s2d_conv2d` but takes the ALREADY-folded input
    (``space_to_depth(x, sh, sw)``) so a conv||pool concat stem can share
    one relayout between the conv and the phase-max pool."""
    kf, pads = s2d_kernel(kernel, stride, padding)
    core = _conv_core if custom_grad else _conv_raw
    y = core(xs, kf, (1, 1), pads, (1, 1), 1)
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y


def s2d_conv2d(x: jnp.ndarray, kernel: jnp.ndarray, *,
               stride: Tuple[int, int], padding: Tuple[int, int],
               bias: Optional[jnp.ndarray] = None,
               custom_grad: bool = True) -> jnp.ndarray:
    """conv2d(x, kernel, stride=s, padding=p) via space-to-depth + stride-1.

    Exact rewrite (every original tap appears once). Requires H % sh == 0,
    W % sw == 0, groups == 1, dilation == 1, and the standard torch output
    size to equal H/sh x W/sw (true for every zoo stem geometry: k3s2p1,
    k7s2p3, k2s2p0...). x is the ORIGINAL (B,H,W,C) input.
    """
    sh, sw = stride
    return s2d_conv_on_folded(space_to_depth(x, sh, sw), kernel,
                              stride=stride, padding=padding, bias=bias,
                              custom_grad=custom_grad)


import functools

import jax
from jax import lax


def w_fold_stem_conv(x, kernel, *, stride, padding, bias=None,
                     lanes: int = 128, custom_grad: bool = True,
                     unfold: bool = True):
    """Stride-s RGB-stem conv as a LANE-FULL W-folded conv.

    The 3-channel stem was a large share of the fastscnn train step before
    the GPU port (not measured on the H100), and the s2d(2,2) rewrite
    REGRESSED: its 12-channel folded input takes a c-minor layout padded
    12->128 lanes (10.7x physical traffic, read from the compiled HLO).
    The fix that feeds
    full lanes with ZERO shuffle cost is W-axis folding: ``fold_w`` is a
    pure reshape (W and C are adjacent in NHWC), so
      x (B,H,W,3) --reshape--> (B,H,W/64,192)   [192 >= 128 lanes]
      conv via general_folded_kernel (stride (2,1), Uh x 2 taps,
           out (B,H/2,W/64, 32*Co) — 1024 output channels, pad-free)
      --reshape--> (B,H/2,W/2,Co).
    Exact rewrite (general_folded_kernel derivation); both reshapes are
    layout-free. fwi is the largest power-of-2 multiple of s_w dividing W
    with fwi*C >= lanes.
    """
    from .folding import unfold_w
    sh, sw = stride
    b, h, w, c = x.shape
    fwi = sw
    while fwi * c < lanes and w % (fwi * 2) == 0:
        fwi *= 2
    fo = fwi // sw
    xs = space_to_depth(x, 1, fwi)
    y = general_folded_conv(xs, kernel, stride=stride, padding=padding,
                            in_fold=(1, fwi), out_fold_w=fo, bias=bias,
                            custom_grad=custom_grad)
    if not unfold:
        return y, fo  # caller runs BN/act folded and unfolds once
    return unfold_w(y, fo)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def s2d_stem_conv(x, kernel, stride, padding):
    """Stride-s RGB-STEM conv via space-to-depth, with a stem-specific VJP.

    Forward: ``conv2d(x, kernel, stride, padding)`` computed as a stride-1
    conv over the s2d-folded input (exact rewrite; see s2d_kernel).

    Backward: the naive composition (s2d + folded conv under the generic
    custom conv VJP) REGRESSED the fastscnn full-res train step before the
    GPU port even though the convs themselves got faster — the backward
    spent its time in the relayout's transpose chain and in materializing
    an input cotangent nobody consumes. This VJP:

      - returns a ZERO input cotangent (the stem input is the image;
        training differentiates wrt params only). ONLY valid at the true
        network input — the Conv hook gates on in_ch <= 4.
      - computes dW as stride-1 taps einsums over the folded input
        (12-channel lanes, the same formulation the custom conv VJP uses
        for dense kernels) and GATHERS the folded-kernel gradient back to
        the original (kh, kw, I, O) taps — each original weight appears
        exactly once in the folded kernel, so the inverse is a static
        slice, not a scatter chain.
    """
    xs = space_to_depth(x, *stride)
    kf, pads = s2d_kernel(kernel, stride, padding)
    return _conv_raw(xs, kf, (1, 1), pads, (1, 1), 1)


def _s2d_stem_fwd(x, kernel, stride, padding):
    xs = space_to_depth(x, *stride)
    kf, pads = s2d_kernel(kernel, stride, padding)
    y = _conv_raw(xs, kf, (1, 1), pads, (1, 1), 1)
    # x and kernel ride the residuals for their STATIC metadata only
    # (shape/dtype for the zero cotangent and the dW cast) — zeros_like/
    # astype read no data, so XLA DCEs the actual dependency
    return y, (xs, x, kernel)


def _s2d_stem_bwd(stride, padding, res, gy):
    import jax.numpy as jnp
    xs, x, kernel = res
    kh, kw, ci, co = kernel.shape
    sh, sw = stride
    ph, pw = padding
    taps_h, tmin_h, _ = _axis_taps(kh, sh, ph)
    taps_w, tmin_w, _ = _axis_taps(kw, sw, pw)
    (lo_h, hi_h), (lo_w, hi_w) = ((-tmin_h, max(t for t, _ in taps_h)),
                                  (-tmin_w, max(t for t, _ in taps_w)))
    n, ho, wo = gy.shape[:3]
    cf = xs.shape[-1]
    xp = jnp.pad(xs, ((0, 0), (lo_h, hi_h + max(ho - xs.shape[1] - hi_h, 0)),
                      (lo_w, hi_w + max(wo - xs.shape[2] - hi_w, 0)),
                      (0, 0)))
    # dkf[u, v] = sum_nhw xp[n, h+u, w+v, :] gy[n, h, w, :]
    uh = lo_h + hi_h + 1
    uw = lo_w + hi_w + 1
    taps = {}
    for u in range(uh):
        for v in range(uw):
            taps[(u, v)] = jnp.einsum(
                "nhwc,nhwd->cd",
                lax.slice(xp, (0, u, v, 0), (n, u + ho, v + wo, cf)), gy,
                preferred_element_type=jnp.float32)
    # gather folded grads back to original tap positions (exact inverse
    # of s2d_kernel's placement)
    rows = []
    for dh, (th, gh) in enumerate(taps_h):
        cols = []
        for dw_, (tw, gw) in enumerate(taps_w):
            blk = (gh * sw + gw) * ci
            cols.append(taps[(th - tmin_h, tw - tmin_w)][blk:blk + ci, :])
        rows.append(jnp.stack(cols))
    dw = jnp.stack(rows).astype(kernel.dtype)
    dx = jnp.zeros_like(x)  # stem contract: image grad unused
    return dx, dw


s2d_stem_conv.defvjp(_s2d_stem_fwd, _s2d_stem_bwd)


def s2d_eligible(x_shape, kernel_shape, stride, padding, dilation,
                 groups: int, *, max_in_ch: int = 8) -> bool:
    """Engage the lowering only where it wins: tiny-channel (stem) inputs,
    stride == 2, SAME-family geometry whose output is exactly H/2 x W/2."""
    if groups != 1 or tuple(dilation) != (1, 1):
        return False
    sh, sw = stride
    if (sh, sw) != (2, 2):
        return False
    b, h, w, c = x_shape
    if c > max_in_ch or h % sh or w % sw:
        return False
    kh, kw, _, _ = kernel_shape
    ph, pw = padding
    from .convolution import conv_output_size
    return (conv_output_size(h, kh, sh, ph) == h // sh
            and conv_output_size(w, kw, sw, pw) == w // sw)


def s2d_max_pool_2x2(xs: jnp.ndarray, channels: int) -> jnp.ndarray:
    """MaxPool2d(2, stride 2) of the ORIGINAL tensor, computed from its
    space-to-depth form (B,H/2,W/2,4*C): max over the 4 phases. Lets the
    conv||pool concat stems share one s2d relayout (XLA CSEs it)."""
    b, h2, w2, c4 = xs.shape
    assert c4 == 4 * channels
    return jnp.max(xs.reshape(b, h2, w2, 4, channels), axis=3)
