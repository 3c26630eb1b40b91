"""Shared block library — the ~12 families the 17-model zoo decomposes into
(SURVEY.md §7 design stance). The reference repeats these per file
[R: model/*.py]; here models are thin compositions over this module, which
is also where a per-family lowering change lands without touching any model
code.

All blocks are NHWC; convs feeding BN carry no bias.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from .. import nn
from ..ops import folding
from ..ops import pooling as P
from ..ops import resize as R

IntOr2 = Union[int, Tuple[int, int]]


def _act_module(act: Optional[str], ch: int) -> Optional[nn.Module]:
    if act is None or act == "none":
        return None
    if act == "relu":
        return nn.Fn(nn.relu)
    if act == "relu6":
        return nn.Fn(nn.relu6)
    if act == "prelu":
        return nn.PReLU(ch)
    if act == "prelu1":
        return nn.PReLU(1)
    raise KeyError(act)


class ConvBNAct(nn.Module):
    """conv -> BN -> activation; the universal fused unit (XLA folds the BN
    affine into the conv epilogue). Reference: CBR/ConvBNPReLU/_ConvBNReLU
    variants in nearly every model file [R]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: IntOr2 = 3, *,
                 stride: IntOr2 = 1, padding: Optional[IntOr2] = None,
                 dilation: IntOr2 = 1, groups: int = 1, act: str = "prelu",
                 bn: bool = True, bias: Optional[bool] = None,
                 bn_eps: float = 1e-5):
        if padding is None:
            k = kernel if isinstance(kernel, tuple) else (kernel, kernel)
            d = dilation if isinstance(dilation, tuple) else (dilation,) * 2
            padding = (d[0] * (k[0] - 1) // 2, d[1] * (k[1] - 1) // 2)
        self.conv = nn.Conv(in_ch, out_ch, kernel, stride=stride,
                            padding=padding, dilation=dilation, groups=groups,
                            bias=(not bn) if bias is None else bias)
        self.bn = nn.BatchNorm(out_ch, eps=bn_eps) if bn else None
        self.act = _act_module(act, out_ch)

    def __call__(self, scope, x):
        import os
        conv = self.conv
        mode = os.environ.get("ESN_TPU_S2D_CONV", "auto")
        # TRAIN-only by default: before the GPU port the folded stem sped up
        # the contextnet train step but slowed b128 inference — the unfold
        # boundary prices differently under the inference-mode fusions (not
        # measured on the H100). "1" forces both modes.
        engage = (mode == "1"
                  or (mode not in ("0", "1") and scope.train
                      and getattr(self, "fold_stem", False)))
        if (engage and not scope.is_init and conv.groups == 1
                and conv.in_ch <= 4 and self.bn is not None):
            # stem fast path: the RGB stem conv runs W-folded
            # (ops/s2d.w_fold_stem_conv: 3 input channels would leave
            # the channel axis mostly padding) and BN + activation stay
            # IN folded space (folded_apply), so the one unfold happens
            # after the whole stem unit — a fold boundary in the middle
            # adds backward relayouts (tuned before the GPU port; not
            # measured on the H100).
            from ..ops import s2d as S
            from ..ops.folding import unfold_w
            p2 = lambda v: (v, v) if isinstance(v, int) else tuple(v)
            kh, kw = conv.kernel
            if S.s2d_eligible(x.shape, (kh, kw, conv.in_ch, conv.out_ch),
                              p2(conv.stride), p2(conv.padding),
                              p2(conv.dilation), conv.groups):
                w, b = conv.params(scope.child("conv"))
                y, fo = S.w_fold_stem_conv(
                    x, w, stride=p2(conv.stride), padding=p2(conv.padding),
                    bias=b, unfold=False)
                y = self.bn.folded_apply(scope.child("bn"), y, fo)
                if self.act is not None:
                    y = (self.act.folded_apply(scope.child("act"), y, fo)
                         if hasattr(self.act, "folded_apply")
                         else scope("act", self.act, y))
                return unfold_w(y, fo)
        x = scope("conv", self.conv, x)
        if self.bn is not None:
            x = scope("bn", self.bn, x)
        if self.act is not None:
            x = scope("act", self.act, x)
        return x

    def pieces_apply(self, scope, pieces):
        """Conv over a virtual channel concat: ``conv(concat(pieces)) ==
        sum_i conv(piece_i, W[:, :, lo_i:hi_i, :])`` — the input-channel
        split of the kernel. Each piece keeps its own (lane-friendly)
        layout and the misaligned concat never exists. The piece partial
        sums accumulate in f32 and round once, like the fused conv's
        accumulator. groups=1 only."""
        from ..ops.convolution import conv2d
        assert self.conv.groups == 1
        w, b = self.conv.params(scope.child("conv"))
        acc, lo = None, 0
        for p in pieces:
            hi = lo + p.shape[-1]
            # each piece conv runs in the compute dtype (bf16 in, f32
            # accumulate); partial sums add in f32 and round once, so the
            # only drift vs the fused conv is one bf16 round per piece
            term = conv2d(p, w[:, :, lo:hi, :],
                          stride=self.conv.stride,
                          padding=self.conv.padding,
                          dilation=self.conv.dilation).astype(jnp.float32)
            acc = term if acc is None else acc + term
            lo = hi
        x = acc.astype(pieces[0].dtype)
        if b is not None:
            x = x + b.astype(x.dtype)
        if self.bn is not None:
            x = scope("bn", self.bn, x)
        if self.act is not None:
            x = scope("act", self.act, x)
        return x


class BNAct(nn.Module):
    """BN -> PReLU/ReLU (reference BR/BNPReLU [R])."""

    def __init__(self, ch: int, act: str = "prelu", bn_eps: float = 1e-5):
        self.bn = nn.BatchNorm(ch, eps=bn_eps)
        self.act = _act_module(act, ch)

    def __call__(self, scope, x):
        x = scope("bn", self.bn, x)
        if self.act is not None:
            x = scope("act", self.act, x)
        return x

    def pieces_apply(self, scope, pieces):
        """BN+act over a virtual channel concat — a list of tensors treated
        as one concatenated tensor without materializing it (exact: both ops
        are per-channel; see nn.BatchNorm.pieces_apply for why)."""
        pieces = self.bn.pieces_apply(scope.child("bn"), pieces)
        if isinstance(self.act, nn.PReLU):
            pieces = self.act.pieces_apply(scope.child("act"), pieces)
        elif self.act is not None:   # ReLU-family: channel-independent
            pieces = [self.act(scope.child("act"), p) for p in pieces]
        return pieces


class DWConvBNAct(nn.Module):
    """Depthwise conv -> BN -> act (channel multiplier 1)."""

    def __init__(self, ch: int, kernel: IntOr2 = 3, *, stride: IntOr2 = 1,
                 dilation: IntOr2 = 1, act: str = "relu",
                 padding: Optional[IntOr2] = None):
        self.inner = ConvBNAct(ch, ch, kernel, stride=stride,
                               dilation=dilation, groups=ch, act=act,
                               padding=padding)

    def __call__(self, scope, x):
        return scope("dw", self.inner, x)


class DSConv(nn.Module):
    """Depthwise-separable conv: dw 3x3 + pw 1x1, each BN+ReLU
    (reference _DSConv in FastSCNN/ContextNet [R]). XLA fuses each BN and
    activation into its conv's epilogue."""

    def __init__(self, in_ch: int, out_ch: int, *, stride: IntOr2 = 1,
                 kernel: IntOr2 = 3, dilation: IntOr2 = 1, act: str = "relu"):
        self.dw = ConvBNAct(in_ch, in_ch, kernel, stride=stride,
                            dilation=dilation, groups=in_ch, act=act)
        self.pw = ConvBNAct(in_ch, out_ch, 1, act=act)

    def __call__(self, scope, x):
        return scope("pw", self.pw, scope("dw", self.dw, x))


class InvertedResidual(nn.Module):
    """MobileNetV2 linear bottleneck (reference LinearBottleneck in
    FastSCNN/ContextNet [R]): 1x1 expand -> dw 3x3 -> 1x1 project (linear),
    residual when stride 1 and shapes match."""

    def __init__(self, in_ch: int, out_ch: int, *, expansion: int = 6,
                 stride: int = 1, dilation: int = 1, act: str = "relu6"):
        mid = in_ch * expansion
        self.use_res = (stride == 1 and in_ch == out_ch)
        self.expand = ConvBNAct(in_ch, mid, 1, act=act) if expansion != 1 \
            else None
        self.dw = ConvBNAct(mid, mid, 3, stride=stride, dilation=dilation,
                            groups=mid, act=act)
        self.project = ConvBNAct(mid, out_ch, 1, act="none")

    def __call__(self, scope, x):
        y = x
        if self.expand is not None:
            y = scope("expand", self.expand, y)
        y = scope("dw", self.dw, y)
        y = scope("project", self.project, y)
        return x + y if self.use_res else y


class PyramidPooling(nn.Module):
    """PPM (reference PyramidPooling in FastSCNN [R]): adaptive-avg-pool to
    ``bins``, 1x1 reduce, bilinear upsample, concat, 1x1 fuse."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 bins: Sequence[int] = (1, 2, 3, 6), act: str = "relu"):
        out_ch = out_ch or in_ch
        self.bins = tuple(bins)
        red = in_ch // len(bins)
        self.reducers = [ConvBNAct(in_ch, red, 1, act=act) for _ in bins]
        self.fuse = ConvBNAct(in_ch + red * len(bins), out_ch, 1, act=act)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        feats = [x]
        for i, b in enumerate(self.bins):
            y = P.adaptive_avg_pool2d(x, b)
            y = scope(f"reduce{i}", self.reducers[i], y)
            feats.append(R.resize_bilinear(y, (h, w)))
        return scope("fuse", self.fuse, jnp.concatenate(feats, axis=-1))


class SEGate(nn.Module):
    """Squeeze-excite channel gate: GAP -> FC -> ReLU -> FC -> sigmoid -> scale
    (reference FGlo in CGNet, SEModule in FPENet [R])."""

    def __init__(self, ch: int, reduction: int = 16):
        mid = max(ch // reduction, 1)
        self.fc1 = nn.Dense(ch, mid)
        self.fc2 = nn.Dense(mid, ch)

    def __call__(self, scope, x):
        s = P.global_avg_pool(x, keepdims=False)        # (N, C)
        return x * self.gate(scope, s)[:, None, None, :]

    def gate(self, scope, s):
        """Gate vector (N, C) from an externally pooled mean (N, C) — for
        fused paths that already hold the spatial sum."""
        s = nn.relu(scope("fc1", self.fc1, s))
        return nn.sigmoid(scope("fc2", self.fc2, s))

    def folded_apply(self, scope, x, fold: int):
        """SE gate on a W-lane-folded tensor (``ops.folding`` slot-major
        layout): the squeeze averages fold slots into their channel (GAP is
        position-invariant, so this is the same mean over a different
        summation order) and the gate vector tiles ``fold`` times."""
        if fold == 1:
            return self(scope, x)
        c = x.shape[-1] // fold
        s = jnp.mean(x.astype(jnp.float32).reshape(*x.shape[:3], fold, c),
                     axis=(1, 2, 3)).astype(x.dtype)
        s = nn.relu(scope("fc1", self.fc1, s))
        s = nn.sigmoid(scope("fc2", self.fc2, s))
        return x * jnp.tile(s, fold)[:, None, None, :]


class DownsamplerConcat(nn.Module):
    """conv s2 || maxpool s2 -> concat (-> BN+act). Reference
    DownsamplerBlock in ERFNet/LEDNet/ESNet, ENet InitialBlock [R].
    When out_ch <= in_ch the conv produces out_ch and no pool concat happens
    (ERFNet semantics for deep downsamplers)."""

    def __init__(self, in_ch: int, out_ch: int, act: str = "relu",
                 bn_eps: float = 1e-3):
        self.concat_pool = out_ch > in_ch
        conv_out = out_ch - in_ch if self.concat_pool else out_ch
        self.conv = nn.Conv(in_ch, conv_out, 3, stride=2, padding=1,
                            bias=True)
        self.post = BNAct(out_ch, act=act, bn_eps=bn_eps)

    def __call__(self, scope, x):
        from ..nn.layers import _s2d_stem_enabled
        from ..ops import s2d as S
        w, b = self.conv.params(scope.child("conv"))
        if (self.concat_pool and _s2d_stem_enabled(scope)
                and S.s2d_eligible(x.shape, w.shape, (2, 2), (1, 1),
                                   (1, 1), 1)):
            # space-to-depth stem lowering (ops/s2d.py): one relayout
            # shared by the dense stride-1 conv AND the phase-max pool —
            # kills the 3-channel full-res padding in the weight-grad
            # (tuned before the GPU port; not measured on the H100)
            xs = S.space_to_depth(x, 2, 2)
            y = S.s2d_conv_on_folded(xs, w, stride=(2, 2), padding=(1, 1),
                                     bias=b)
            pool = S.s2d_max_pool_2x2(xs, x.shape[-1])
            y = jnp.concatenate([y, pool], axis=-1)
        else:
            y = scope("conv", self.conv, x)
            if self.concat_pool:
                y = jnp.concatenate([y, P.max_pool2d(x, 2, 2)], axis=-1)
        return scope("post", self.post, y)


class InputInjection(nn.Module):
    """k cascaded stride-2 avg-pools of the raw input (reference
    InputInjection / InputProjectionA in CGNet/ESPNet/DABNet [R])."""

    def __init__(self, times: int):
        self.times = times

    def __call__(self, scope, x):
        for _ in range(self.times):
            x = P.avg_pool2d(x, 3, 2, 1)
        return x


def channel_shuffle(x: jnp.ndarray, groups: int) -> jnp.ndarray:
    """(reference LEDNet channel_shuffle [R])"""
    n, h, w, c = x.shape
    assert c % groups == 0
    return x.reshape(n, h, w, groups, c // groups) \
            .transpose(0, 1, 2, 4, 3).reshape(n, h, w, c)


def channel_split(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    c = x.shape[-1] // 2
    return x[..., :c], x[..., c:]


class FactorizedConv(nn.Module):
    """(k,1)+(1,k) factorized pair with optional dilation, BN+act after the
    pair (reference non_bottleneck_1d halves, FCU, SS-nbt branches [R])."""

    def __init__(self, ch: int, k: int = 3, *, dilation: int = 1,
                 act: str = "relu", act_between: bool = True,
                 bn: bool = True, bn_eps: float = 1e-3):
        pad = (k - 1) // 2
        d = dilation
        self.c1 = nn.Conv(ch, ch, (k, 1), padding=(pad * d, 0),
                          dilation=(d, 1), bias=True)
        self.c2 = nn.Conv(ch, ch, (1, k), padding=(0, pad * d),
                          dilation=(1, d), bias=True)
        self.between = _act_module(act if act_between else None, ch)
        self.post = BNAct(ch, act=act, bn_eps=bn_eps) if bn else \
            _act_module(act, ch)

    def __call__(self, scope, x):
        x = scope("c1", self.c1, x)
        if self.between is not None:
            x = scope("between", self.between, x)
        x = scope("c2", self.c2, x)
        if self.post is not None:
            x = scope("post", self.post, x)
        return x


class NonBottleneck1d(nn.Module):
    """Factorized residual unit (reference non_bottleneck_1d in ERFNet, FCU
    in ESNet [R]): (kx1 -> relu -> 1xk -> BN+relu) then the dilated pair
    (kx1 -> relu -> 1xk -> BN), dropout, residual add, relu."""

    def __init__(self, ch: int, k: int = 3, *, dilation: int = 1,
                 dropout: float = 0.0, bn_eps: float = 1e-3):
        pad = (k - 1) // 2
        self.ch = ch
        self.k = k
        self.dilation = dilation
        self.p1a = nn.Conv(ch, ch, (k, 1), padding=(pad, 0), bias=True)
        self.p1b = nn.Conv(ch, ch, (1, k), padding=(0, pad), bias=True)
        self.bn1 = nn.BatchNorm(ch, eps=bn_eps)
        d = dilation
        self.p2a = nn.Conv(ch, ch, (k, 1), padding=(pad * d, 0),
                           dilation=(d, 1), bias=True)
        self.p2b = nn.Conv(ch, ch, (1, k), padding=(0, pad * d),
                           dilation=(1, d), bias=True)
        self.bn2 = nn.BatchNorm(ch, eps=bn_eps)
        self.drop = nn.SpatialDropout(dropout)

    def __call__(self, scope, x):
        f = 1
        if os.environ.get("ESN_TPU_FOLD", "1") != "0" and not scope.is_init:
            f = folding.fold_factor(self.ch, x.shape[2])
        if f > 1:
            return self._folded(scope, x, f)
        y = nn.relu(scope("p1a", self.p1a, x))
        y = scope("p1b", self.p1b, y)
        y = nn.relu(scope("bn1", self.bn1, y))
        y = nn.relu(scope("p2a", self.p2a, y))
        y = scope("p2b", self.p2b, y)
        y = scope("bn2", self.bn2, y)
        y = scope("drop", self.drop, y)
        return nn.relu(x + y)

    def _folded(self, scope, x, f):
        """Lane-folded execution (ops.folding): same parameters, same math,
        W packed into channels so the 16/32-channel factorized convs run
        on a dense channel axis (a layout tuned before the GPU port; not
        measured on the H100). Engaged for ch <= 64
        outside init; exact vs the plain path (tested)."""
        pad = (self.k - 1) // 2
        d = self.dilation
        w1a, b1a = self.p1a.params(scope.child("p1a"))
        w1b, b1b = self.p1b.params(scope.child("p1b"))
        w2a, b2a = self.p2a.params(scope.child("p2a"))
        w2b, b2b = self.p2b.params(scope.child("p2b"))
        y = folding.fold_w(x, f)
        y = nn.relu(folding.folded_conv2d(y, w1a, f, padding=(pad, 0),
                                          bias=b1a))
        y = folding.folded_conv2d(y, w1b, f, padding=(0, pad), bias=b1b)
        y = nn.relu(self.bn1.folded_apply(scope.child("bn1"), y, f))
        y = nn.relu(folding.folded_conv2d(y, w2a, f, padding=(pad * d, 0),
                                          dilation=(d, 1), bias=b2a))
        y = folding.folded_conv2d(y, w2b, f, padding=(0, pad * d),
                                  dilation=(1, d), bias=b2b)
        y = self.bn2.folded_apply(scope.child("bn2"), y, f)
        y = self.drop.folded_apply(scope.child("drop"), y, f)
        return folding.unfold_w(nn.relu(folding.fold_w(x, f) + y), f)


class UpsamplerBlock(nn.Module):
    """3x3 s2 transposed conv + BN + act (reference ERFNet/ESNet decoder
    UpsamplerBlock [R])."""

    def __init__(self, in_ch: int, out_ch: int, act: str = "relu",
                 bn_eps: float = 1e-3):
        self.deconv = nn.ConvTranspose(in_ch, out_ch, 3, stride=2, padding=1,
                                       output_padding=1, bias=True)
        self.post = BNAct(out_ch, act=act, bn_eps=bn_eps)

    def __call__(self, scope, x):
        return scope("post", self.post, scope("deconv", self.deconv, x))


def subpixel_predict_tail(layer, scope, y, *, argmax_tail="resize"):
    """Finish a model whose LAST layer is a ConvTranspose with the fused
    prediction head: class-argmax per subpixel phase, depth-to-space on the
    int32 indices (ops.classify.subpixel_argmax — exact, and the full-res
    class-channel logits never exist). Falls back to logits + argmax when
    the geometry is ineligible or ESN_TPU_FUSED_PREDICT=0.

    argmax_tail defaults to "resize" (= plain jnp.argmax): the phase conv
    is a CHEAP producer, so the variadic-reduce refusion costs nothing,
    and the packed-key form only makes the graph larger."""
    from ..nn.layers import _pair
    from ..ops import classify as CL
    from ..ops import convolution as C

    w, b = layer.params(scope)
    if (os.environ.get("ESN_TPU_FUSED_PREDICT", "1") != "0"
            and layer.subpixel_eligible()):
        return CL.subpixel_argmax(y, w, b, stride=_pair(layer.stride),
                                  padding=_pair(layer.padding),
                                  argmax_tail=argmax_tail)
    logits = C.conv2d_transpose(y, w, stride=layer.stride,
                                padding=layer.padding,
                                output_padding=layer.output_padding, bias=b,
                                lowering=layer.lowering)
    return CL.argmax_lastdim(logits, tail="conv")
