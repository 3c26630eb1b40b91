"""Core layer modules (the torch.nn surface the reference zoo builds on).

Reference counterparts: ``nn.Conv2d / ConvTranspose2d / BatchNorm2d / PReLU /
Dropout2d / Linear`` used throughout ``model/*.py`` [R]. All NHWC.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp

from . import initializers as init
from .core import Module, Scope
from ..ops import convolution as C

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v):
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _s2d_stem_enabled(scope) -> bool:
    """ESN_TPU_S2D_STEM: 'train' (default) = s2d stem lowering in training
    only; '1' = always; '0' = never. Never during init (shapes only).

    Consulted by the conv||pool concat stem blocks (models/blocks.py
    DownsamplerConcat, models/enet.py InitialBlock), where the pool shares
    the conv's relayout and the lowering won for ERFNet training. Plain
    single-conv stems do NOT engage: generic per-conv engagement slowed
    Fast-SCNN training (both tuned before the GPU port; not measured on
    the H100)."""
    if scope.is_init:
        return False
    mode = os.environ.get("ESN_TPU_S2D_STEM", "train")
    return mode == "1" or (mode == "train" and scope.train)


def _block_diag_kernel(w: jnp.ndarray, groups: int) -> jnp.ndarray:
    """(kh,kw,C/g,O) grouped kernel -> (kh,kw,C,O) dense block-diagonal:
    input block g feeds only output columns [g*O/g, (g+1)*O/g)."""
    kh, kw, cg, o = w.shape
    og = o // groups
    blocks = jnp.split(w, groups, axis=3)
    full = jnp.zeros((kh, kw, cg * groups, o), w.dtype)
    for g, blk in enumerate(blocks):
        full = full.at[:, :, g * cg:(g + 1) * cg,
                       g * og:(g + 1) * og].set(blk)
    return full


class Conv(Module):
    """2D convolution, NHWC/HWIO. Kaiming fan-out init (reference init_weight)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: IntOr2, *,
                 stride: IntOr2 = 1, padding: IntOr2 = 0, dilation: IntOr2 = 1,
                 groups: int = 1, bias: bool = True,
                 kernel_init=None):
        assert in_ch % groups == 0 and out_ch % groups == 0
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel = _pair(kernel)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.use_bias = bias
        self.kernel_init = kernel_init or init.kaiming_normal("fan_out")

    def params(self, scope: Scope):
        """Create/fetch (kernel, bias) without running — lets composite
        fast paths (e.g. lane folding) reuse the same parameter tree."""
        kh, kw = self.kernel
        w = scope.param("kernel", self.kernel_init,
                        (kh, kw, self.in_ch // self.groups, self.out_ch))
        b = None
        if self.use_bias:
            fan_in = kh * kw * self.in_ch // self.groups
            b = scope.param("bias", init.bias_for_fan_in(fan_in), (self.out_ch,))
        return w, b

    def __call__(self, scope: Scope, x):
        w, b = self.params(scope)
        kw = self.kernel[1]
        pw = _pair(self.padding)[1]
        dw = _pair(self.dilation)[1]
        if (os.environ.get("ESN_TPU_AUTOFOLD", "0") == "1"
                and not scope.is_init and self.groups == 1
                and _pair(self.stride) == (1, 1) and self.in_ch <= 64
                and 2 * pw == dw * (kw - 1)):
            # SAME-W geometry required: folded_conv2d derives fold padding
            # from tap positions assuming output width == input width.
            # EXPERIMENTAL, default off: per-conv lane folding pays a
            # fold/unfold relayout around every conv while the elementwise
            # ops between stay lane-padded — a net loss on ENet before
            # the GPU port. Folding wins at BLOCK granularity (one fold,
            # whole block folded, one unfold): see NonBottleneck1d._folded.
            from ..ops import folding
            f = folding.fold_factor(self.in_ch, x.shape[2])
            if f > 1:
                y = folding.folded_conv2d(
                    folding.fold_w(x, f), w, f,
                    dilation=_pair(self.dilation),
                    padding=_pair(self.padding), bias=b)
                return folding.unfold_w(y, f)
        if (os.environ.get("ESN_TPU_S2D_CONV", "0") == "1"
                and not scope.is_init and self.groups == 1):
            # EXPERIMENTAL generic s2d engagement on any eligible
            # tiny-channel stride-2 conv (the RGB stem), whose 3 channels
            # leave the channel axis mostly padding.
            from ..ops import s2d as S
            if S.s2d_eligible(x.shape, w.shape, _pair(self.stride),
                              _pair(self.padding), _pair(self.dilation),
                              self.groups):
                if self.in_ch <= 4:
                    # true RGB stem: lane-full W-folded lowering (pure
                    # reshapes, no shuffle). The s2d(2,2) alternative
                    # pads its 12-ch folded input 10.7x
                    return S.w_fold_stem_conv(
                        x, w, stride=_pair(self.stride),
                        padding=_pair(self.padding), bias=b)
                return S.s2d_conv2d(x, w, stride=_pair(self.stride),
                                    padding=_pair(self.padding), bias=b)
        if (1 < self.groups < self.in_ch
                and os.environ.get("ESN_TPU_DENSE_GROUPED", "1") != "0"):
            # Grouped (non-depthwise) convs lower to per-group matmuls whose
            # contraction dim (in_ch/groups = 32-128 here) under-fills a
            # matrix unit; embedding the groups as a block-diagonal DENSE
            # kernel is exactly the same math (off-diagonal zeros are exact
            # in the f32 accumulator) and was ~2x faster at every EESP
            # geometry before the GPU port (not measured on the H100).
            # Reference grouped convs: ESPNetv2 reduce/expand, groups=4
            # [R: model/ESPNet_v2/Model.py]. Depthwise (groups==in_ch)
            # keeps the native path.
            return C.conv2d(x, _block_diag_kernel(w, self.groups),
                            stride=self.stride, padding=self.padding,
                            dilation=self.dilation, bias=b)
        return C.conv2d(x, w, stride=self.stride, padding=self.padding,
                        dilation=self.dilation, groups=self.groups, bias=b)

    def pieces_apply(self, scope: Scope, pieces):
        """Conv over a VIRTUAL channel concat: ``conv(concat(pieces)) ==
        sum_i conv(piece_i, W[:, :, lo_i:hi_i, :])`` — the input-channel
        split of the kernel. Each piece keeps its own lane-friendly layout
        and the misaligned concat never exists (see BatchNorm.pieces_apply).
        Piece partial sums accumulate in f32 and round once, like the fused
        conv's accumulator. groups=1 only."""
        assert self.groups == 1
        w, b = self.params(scope)
        acc, lo = None, 0
        for p in pieces:
            hi = lo + p.shape[-1]
            term = C.conv2d(p, w[:, :, lo:hi, :], stride=self.stride,
                            padding=self.padding,
                            dilation=self.dilation).astype(jnp.float32)
            acc = term if acc is None else acc + term
            lo = hi
        assert lo == self.in_ch, (lo, self.in_ch)
        y = acc.astype(pieces[0].dtype)
        if b is not None:
            y = y + b.astype(y.dtype)
        return y


class ConvTranspose(Module):
    """Transposed 2D convolution with torch shape semantics."""

    def __init__(self, in_ch: int, out_ch: int, kernel: IntOr2, *,
                 stride: IntOr2 = 1, padding: IntOr2 = 0,
                 output_padding: IntOr2 = 0, bias: bool = True,
                 kernel_init=None, lowering: str = "auto"):
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel = _pair(kernel)
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.use_bias = bias
        self.kernel_init = kernel_init or init.kaiming_normal("fan_out")
        self.lowering = lowering

    def params(self, scope: Scope):
        """Create/fetch (kernel, bias) without running — for fused
        prediction heads (ops.classify.subpixel_argmax)."""
        kh, kw = self.kernel
        w = scope.param("kernel", self.kernel_init,
                        (kh, kw, self.in_ch, self.out_ch))
        b = None
        if self.use_bias:
            fan_in = kh * kw * self.in_ch
            b = scope.param("bias", init.bias_for_fan_in(fan_in), (self.out_ch,))
        return w, b

    def subpixel_eligible(self) -> bool:
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        oph, opw = _pair(self.output_padding)
        kh, kw = self.kernel
        return (sh > 1 or sw > 1) and kh >= sh and kw >= sw \
            and kh + oph - 2 * ph == sh and kw + opw - 2 * pw == sw

    def __call__(self, scope: Scope, x):
        w, b = self.params(scope)
        return C.conv2d_transpose(x, w, stride=self.stride, padding=self.padding,
                                  output_padding=self.output_padding, bias=b,
                                  lowering=self.lowering)


class BatchNorm(Module):
    """BatchNorm2d over NHWC with functional running stats.

    Batch statistics are taken over the *global* batch: under pjit with the
    batch sharded on the mesh's data axis, the ``jnp.mean`` below compiles to
    a cross-replica reduction — sync-BN for free (the reference's
    DataParallel BN is per-GPU, strictly weaker).

    Stats always accumulate in fp32 regardless of compute dtype.
    """

    def __init__(self, num_features: int, *, momentum: float = 0.1,
                 eps: float = 1e-5, affine: bool = True):
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.affine = affine

    def __call__(self, scope: Scope, x):
        return self.folded_apply(scope, x, 1)

    def folded_apply(self, scope: Scope, x, fold: int):
        """Apply BN to a W-lane-folded tensor (``ops.folding``): channel
        slot ``f*C + c`` is original channel c, so statistics reduce over
        the fold axis too and affine params tile ``fold`` times. ``fold=1``
        is plain BatchNorm."""
        c = self.num_features
        assert x.shape[-1] == fold * c, \
            f"BatchNorm expected {fold}x{c} channels, got {x.shape}"
        run_mean = scope.stat("mean", init.zeros, (c,))
        run_var = scope.stat("var", init.ones, (c,))
        if scope.train and not scope.is_init:
            # one-pass moments: E[x-c] and E[(x-c)^2] are two reductions over
            # the SAME input, which XLA computes in a single fused sweep; the
            # textbook E[(x-mean)^2] forces a second full pass (mean is an
            # input to it). Centering on c = running mean (a constant wrt the
            # sweep) keeps the shifted-moment subtraction cancellation-free:
            # once rm tracks the batch mean, E[(x-c)^2] ~ var >> E[x-c]^2.
            xf = x.astype(jnp.float32).reshape(*x.shape[:3], fold, c) \
                - run_mean
            d = jnp.mean(xf, axis=(0, 1, 2, 3))
            m2 = jnp.mean(jnp.square(xf), axis=(0, 1, 2, 3))
            mean = run_mean + d
            var = jnp.maximum(m2 - jnp.square(d), 0.0)
            n = x.shape[0] * x.shape[1] * x.shape[2] * fold
            unbiased = var * (n / max(n - 1, 1))
            m = self.momentum
            scope.put_stat("mean", (1 - m) * run_mean + m * mean)
            scope.put_stat("var", (1 - m) * run_var + m * unbiased)
        else:
            mean, var = run_mean, run_var
        scale = jax.lax.rsqrt(var + self.eps)
        if self.affine:
            gamma = scope.param("scale", init.ones, (c,))
            beta = scope.param("bias", init.zeros, (c,))
            scale = scale * gamma
            offset = beta - mean * scale
        else:
            offset = -mean * scale
        if fold > 1:
            scale = jnp.tile(scale, fold)
            offset = jnp.tile(offset, fold)
        return (x * scale.astype(x.dtype) + offset.astype(x.dtype))

    def folded_slice_apply(self, scope: Scope, x, fold: int,
                           lo: int, hi: int):
        """``folded_apply`` restricted to original channels ``[lo, hi)`` —
        for blocks that process one channel-group of a wider BN's features
        as its own W-folded tensor (FPEBlock group-major layout: the
        expand's mid channels never exist as one tensor). Exact: BN stats
        are per-channel, so slicing commutes with the moment computation;
        train mode updates only the slice of the running stats (pending
        updates from earlier groups in the same traversal are respected —
        ``Scope.stat`` returns them)."""
        c = hi - lo
        assert x.shape[-1] == fold * c, (x.shape, fold, lo, hi)
        nf = self.num_features
        run_mean = scope.stat("mean", init.zeros, (nf,))
        run_var = scope.stat("var", init.ones, (nf,))
        rm, rv = run_mean[lo:hi], run_var[lo:hi]
        if scope.train and not scope.is_init:
            xf = x.astype(jnp.float32).reshape(*x.shape[:3], fold, c) - rm
            d = jnp.mean(xf, axis=(0, 1, 2, 3))
            m2 = jnp.mean(jnp.square(xf), axis=(0, 1, 2, 3))
            mean = rm + d
            var = jnp.maximum(m2 - jnp.square(d), 0.0)
            n = x.shape[0] * x.shape[1] * x.shape[2] * fold
            unbiased = var * (n / max(n - 1, 1))
            m = self.momentum
            scope.put_stat("mean", run_mean.at[lo:hi].set(
                (1 - m) * rm + m * mean))
            scope.put_stat("var", run_var.at[lo:hi].set(
                (1 - m) * rv + m * unbiased))
        else:
            mean, var = rm, rv
        scale = jax.lax.rsqrt(var + self.eps)
        if self.affine:
            gamma = scope.param("scale", init.ones, (nf,))[lo:hi]
            beta = scope.param("bias", init.zeros, (nf,))[lo:hi]
            scale = scale * gamma
            offset = beta - mean * scale
        else:
            offset = -mean * scale
        if fold > 1:
            scale = jnp.tile(scale, fold)
            offset = jnp.tile(offset, fold)
        return (x * scale.astype(x.dtype) + offset.astype(x.dtype))

    def pieces_apply(self, scope: Scope, pieces):
        """BN over a VIRTUAL channel concat given as a list of tensors.

        Odd-width concats (e.g. CGNet's 32+3 / 64+64+3 raw-input injections,
        reference InputInjection concat [R: model/CGNet.py]) give every
        consumer a misaligned channel layout; keeping the pieces separate and
        slicing the per-channel parameters is exact (BN is independent per
        channel) and lets each piece stay in its natural layout.
        Parameters/stats remain full-length — checkpoint-identical to the
        concat path.
        """
        c = self.num_features
        offs = [0]
        for p in pieces:
            offs.append(offs[-1] + p.shape[-1])
        assert offs[-1] == c, (offs, c)
        run_mean = scope.stat("mean", init.zeros, (c,))
        run_var = scope.stat("var", init.ones, (c,))
        if scope.train and not scope.is_init:
            ds, m2s = [], []
            for p, lo in zip(pieces, offs):
                xf = p.astype(jnp.float32) - run_mean[lo:lo + p.shape[-1]]
                ds.append(jnp.mean(xf, axis=(0, 1, 2)))
                m2s.append(jnp.mean(jnp.square(xf), axis=(0, 1, 2)))
            d = jnp.concatenate(ds)
            m2 = jnp.concatenate(m2s)
            mean = run_mean + d
            var = jnp.maximum(m2 - jnp.square(d), 0.0)
            n = pieces[0].shape[0] * pieces[0].shape[1] * pieces[0].shape[2]
            unbiased = var * (n / max(n - 1, 1))
            m = self.momentum
            scope.put_stat("mean", (1 - m) * run_mean + m * mean)
            scope.put_stat("var", (1 - m) * run_var + m * unbiased)
        else:
            mean, var = run_mean, run_var
        scale = jax.lax.rsqrt(var + self.eps)
        if self.affine:
            gamma = scope.param("scale", init.ones, (c,))
            beta = scope.param("bias", init.zeros, (c,))
            scale = scale * gamma
            offset = beta - mean * scale
        else:
            offset = -mean * scale
        return [p * scale[lo:lo + p.shape[-1]].astype(p.dtype)
                + offset[lo:lo + p.shape[-1]].astype(p.dtype)
                for p, lo in zip(pieces, offs)]


class PReLU(Module):
    """PReLU with 1 (torch default) or per-channel slopes, init 0.25."""

    def __init__(self, num_parameters: int = 1, init_value: float = 0.25):
        self.num_parameters = num_parameters
        self.init_value = init_value

    def __call__(self, scope: Scope, x):
        return self.folded_apply(scope, x, 1)

    def folded_apply(self, scope: Scope, x, fold: int):
        """PReLU on a W-lane-folded tensor (slot-major layout: channel
        g*C + c is original channel c), so per-channel slopes tile."""
        a = scope.param("alpha", init.constant(self.init_value),
                        (self.num_parameters,))
        if fold > 1 and self.num_parameters > 1:
            a = jnp.tile(a, fold)
        a = a.astype(x.dtype)
        return jnp.where(x >= 0, x, a * x)

    def pieces_apply(self, scope: Scope, pieces):
        """PReLU over a virtual channel concat (see BatchNorm.pieces_apply);
        per-channel slopes slice exactly, a scalar slope broadcasts."""
        a = scope.param("alpha", init.constant(self.init_value),
                        (self.num_parameters,))
        out, lo = [], 0
        for p in pieces:
            ap = a if self.num_parameters == 1 else a[lo:lo + p.shape[-1]]
            out.append(jnp.where(p >= 0, p, ap.astype(p.dtype) * p))
            lo += p.shape[-1]
        return out


class Dropout(Module):
    def __init__(self, rate: float):
        self.rate = float(rate)

    def __call__(self, scope: Scope, x):
        if not scope.train or self.rate <= 0.0 or scope.is_init:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(scope.make_rng("dropout"), keep, x.shape)
        return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


class SpatialDropout(Module):
    """Dropout2d: drops whole channel feature maps (reference: ENet)."""

    def __init__(self, rate: float):
        self.rate = float(rate)

    def __call__(self, scope: Scope, x):
        return self.folded_apply(scope, x, 1)

    def folded_apply(self, scope: Scope, x, fold: int):
        """Channel-dropout on a W-lane-folded tensor: the mask is drawn per
        ORIGINAL channel and tiled, so all fold slots of a channel drop
        together (anything else would not be channel dropout)."""
        if not scope.train or self.rate <= 0.0 or scope.is_init:
            return x
        keep = 1.0 - self.rate
        n, _, _, fc = x.shape
        mask = jax.random.bernoulli(scope.make_rng("dropout"), keep,
                                    (n, 1, 1, fc // fold))
        if fold > 1:
            mask = jnp.tile(mask, (1, 1, 1, fold))
        return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


class Dense(Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        self.in_features, self.out_features = in_features, out_features
        self.use_bias = bias

    def __call__(self, scope: Scope, x):
        w = scope.param("kernel", init.torch_conv_default,
                        (self.in_features, self.out_features))
        w2 = w.astype(x.dtype)
        y = jnp.dot(x, w2, preferred_element_type=jnp.float32).astype(x.dtype)
        if self.use_bias:
            b = scope.param("bias", init.bias_for_fan_in(self.in_features),
                            (self.out_features,))
            y = y + b.astype(y.dtype)
        return y


def relu(x):
    return jnp.maximum(x, 0)


def relu6(x):
    return jnp.clip(x, 0, 6)


def sigmoid(x):
    return jax.nn.sigmoid(x)
