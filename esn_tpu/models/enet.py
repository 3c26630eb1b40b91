"""ENet (Paszke et al., arXiv 1606.02147) — NHWC implementation.

Reference counterpart: ``model/ENet.py`` [R] (InitialBlock, RegularBottleneck,
DownsamplingBottleneck, UpsamplingBottleneck). Re-designed here around the
framework's scatter-free index pool/unpool pair (esn_tpu/ops/pooling.py): the
encoder's max-pool positions flow to the decoder as explicit values — a
side-channel the functional form makes first-class instead of hidden module
state.

Architecture (paper Table 1):
- initial: 3x3/s2 conv (13ch) || 2x2 maxpool (3ch) -> concat 16ch
- stage1: downsample 16->64 + 4 regular bottlenecks (dropout 0.01)
- stage2: downsample 64->128 + [x, dil2, asym5, dil4, x, dil8, asym5, dil16]
- stage3: the stage2 mix again, no downsample (dropout 0.1)
- stage4: upsample 128->64 (max-unpool skip) + 2 regular, ReLU decoder
- stage5: upsample 64->16 + 1 regular
- fullconv: 3x3/s2 transposed conv -> classes, output at input resolution
"""
from __future__ import annotations

import jax.numpy as jnp

import os

from .. import nn
from ..nn.layers import _pair
from ..ops import folding
from ..ops import pooling as P
from .blocks import subpixel_predict_tail


def _act(relu: bool, ch: int) -> nn.Module:
    return nn.Fn(nn.relu) if relu else nn.PReLU(ch)


class InitialBlock(nn.Module):
    def __init__(self, in_ch: int = 3, out_ch: int = 16):
        self.conv = nn.Conv(in_ch, out_ch - in_ch, 3, stride=2, padding=1,
                            bias=False)
        self.bn = nn.BatchNorm(out_ch)
        self.act = nn.PReLU(out_ch)

    def __call__(self, scope, x):
        from ..nn.layers import _s2d_stem_enabled
        from ..ops import s2d as S
        w, b = self.conv.params(scope.child("conv"))
        if (_s2d_stem_enabled(scope)
                and S.s2d_eligible(x.shape, w.shape, (2, 2), (1, 1),
                                   (1, 1), 1)):
            # space-to-depth stem: one relayout shared by the dense
            # stride-1 conv and the phase-max pool (blocks.py
            # DownsamplerConcat has the rationale + measurements)
            xs = S.space_to_depth(x, 2, 2)
            main = S.s2d_conv_on_folded(xs, w, stride=(2, 2),
                                        padding=(1, 1), bias=b)
            pooled = S.s2d_max_pool_2x2(xs, x.shape[-1])
        else:
            main = scope("conv", self.conv, x)
            pooled = P.max_pool2d(x, 2, 2)
        y = jnp.concatenate([main, pooled], axis=-1)
        y = scope("bn", self.bn, y)
        return scope("act", self.act, y)


class RegularBottleneck(nn.Module):
    """Residual bottleneck: 1x1 reduce -> core conv -> 1x1 expand.

    ``dilation`` > 1 selects the dilated variant; ``asymmetric`` selects the
    5x1 + 1x5 factorized core [R: RegularBottleneck with kernel_size=5].
    """

    def __init__(self, ch: int, *, internal_ratio: int = 4, dilation: int = 1,
                 asymmetric: bool = False, dropout: float = 0.1,
                 relu: bool = False):
        self.ch = ch
        mid = ch // internal_ratio
        self.reduce = nn.Sequential(nn.Conv(ch, mid, 1, bias=False),
                                    nn.BatchNorm(mid), _act(relu, mid))
        if asymmetric:
            self.core = nn.Sequential(
                nn.Conv(mid, mid, (5, 1), padding=(2, 0), bias=False),
                nn.Conv(mid, mid, (1, 5), padding=(0, 2), bias=False),
                nn.BatchNorm(mid), _act(relu, mid))
        else:
            self.core = nn.Sequential(
                nn.Conv(mid, mid, 3, padding=dilation, dilation=dilation,
                        bias=False),
                nn.BatchNorm(mid), _act(relu, mid))
        self.expand = nn.Sequential(nn.Conv(mid, ch, 1, bias=False),
                                    nn.BatchNorm(ch))
        self.drop = nn.SpatialDropout(dropout)
        self.out_act = _act(relu, ch)

    def __call__(self, scope, x):
        f = 1
        if os.environ.get("ESN_TPU_FOLD_ENET", "0") == "1" \
                and not scope.is_init:
            f = folding.fold_factor(self.ch, x.shape[2])
        if f > 1:
            return self._folded(scope, x, f)
        y = scope("reduce", self.reduce, x)
        y = scope("core", self.core, y)
        y = scope("expand", self.expand, y)
        y = scope("drop", self.drop, y)
        return scope("out_act", self.out_act, x + y)

    def _folded(self, scope, x, f):
        """Lane-folded execution (ops.folding, slot-major): one fold, the whole
        reduce/core/expand/residual chain dense, one unfold. Exact vs the plain
        path (tested) but OFF by default: it lost before the GPU port (not
        measured on the H100) — the bottleneck's mid width is ch/4, so even
        folded the core runs at 32/128 lanes, the 1x1 reduce/expand (the FLOPs)
        were already half-dense unfolded, and each block pays fold/unfold
        relayouts. Folding pays off when a block is narrow END-TO-END
        (NonBottleneck1d), not when only its waist is narrow. Kept behind
        ESN_TPU_FOLD_ENET=1."""
        def act(m, s, y):
            if isinstance(m, nn.PReLU):
                return m.folded_apply(s, y, f)
            return m(s, y)

        def conv_bn(seq, s, y):
            for i, layer in enumerate(seq.layers):
                si = s.child(str(i))
                if isinstance(layer, nn.Conv):
                    w, b = layer.params(si)
                    y = folding.folded_conv2d(
                        y, w, f, dilation=_pair(layer.dilation),
                        padding=_pair(layer.padding), bias=b)
                elif isinstance(layer, nn.BatchNorm):
                    y = layer.folded_apply(si, y, f)
                else:
                    y = act(layer, si, y)
            return y

        y = folding.fold_w(x, f)
        r = y
        y = conv_bn(self.reduce, scope.child("reduce"), y)
        y = conv_bn(self.core, scope.child("core"), y)
        y = conv_bn(self.expand, scope.child("expand"), y)
        y = self.drop.folded_apply(scope.child("drop"), y, f)
        y = act(self.out_act, scope.child("out_act"), r + y)
        return folding.unfold_w(y, f)


class DownsamplingBottleneck(nn.Module):
    """Strided bottleneck; skip = indexed 2x2 maxpool + channel zero-pad."""

    def __init__(self, in_ch: int, out_ch: int, *, internal_ratio: int = 4,
                 dropout: float = 0.1, relu: bool = False):
        mid = in_ch // internal_ratio
        self.in_ch, self.out_ch = in_ch, out_ch
        self.reduce = nn.Sequential(
            nn.Conv(in_ch, mid, 2, stride=2, bias=False),
            nn.BatchNorm(mid), _act(relu, mid))
        self.core = nn.Sequential(
            nn.Conv(mid, mid, 3, padding=1, bias=False),
            nn.BatchNorm(mid), _act(relu, mid))
        self.expand = nn.Sequential(nn.Conv(mid, out_ch, 1, bias=False),
                                    nn.BatchNorm(out_ch))
        self.drop = nn.SpatialDropout(dropout)
        self.out_act = _act(relu, out_ch)

    def __call__(self, scope, x):
        main = scope("reduce", self.reduce, x)
        main = scope("core", self.core, main)
        main = scope("expand", self.expand, main)
        main = scope("drop", self.drop, main)
        skip, indices = P.max_pool2d_with_indices_2x2(x)
        pad = self.out_ch - self.in_ch
        if pad > 0:
            skip = jnp.pad(skip, ((0, 0), (0, 0), (0, 0), (0, pad)))
        out = scope("out_act", self.out_act, main + skip)
        return out, indices


class UpsamplingBottleneck(nn.Module):
    """Transposed-conv bottleneck; skip = 1x1 conv + max-unpool(indices)."""

    def __init__(self, in_ch: int, out_ch: int, *, internal_ratio: int = 4,
                 dropout: float = 0.1, relu: bool = True):
        mid = in_ch // internal_ratio
        self.skip_conv = nn.Sequential(nn.Conv(in_ch, out_ch, 1, bias=False),
                                       nn.BatchNorm(out_ch))
        self.reduce = nn.Sequential(nn.Conv(in_ch, mid, 1, bias=False),
                                    nn.BatchNorm(mid), _act(relu, mid))
        self.up = nn.Sequential(
            # zero_insert, not subpixel: subpixel internal ups make ENet's
            # large-batch graph much bigger (tuned before the GPU port; not
            # measured on the H100), and gain nothing here anyway: mid is
            # 16-32ch, the same narrow-waist regime where folding lost (see
            # _folded).
            nn.ConvTranspose(mid, mid, 3, stride=2, padding=1,
                             output_padding=1, bias=False,
                             lowering="zero_insert"),
            nn.BatchNorm(mid), _act(relu, mid))
        self.expand = nn.Sequential(nn.Conv(mid, out_ch, 1, bias=False),
                                    nn.BatchNorm(out_ch))
        self.drop = nn.SpatialDropout(dropout)
        self.out_act = _act(relu, out_ch)

    def __call__(self, scope, x, indices):
        skip = scope("skip_conv", self.skip_conv, x)
        skip = P.max_unpool2d_2x2(skip, indices)
        main = scope("reduce", self.reduce, x)
        main = scope("up", self.up, main)
        main = scope("expand", self.expand, main)
        main = scope("drop", self.drop, main)
        return scope("out_act", self.out_act, main + skip)


class ENet(nn.Module):
    """Input NHWC float (H, W multiples of 8); output NHWC logits."""

    def __init__(self, classes: int = 19, in_ch: int = 3,
                 encoder_relu: bool = False, decoder_relu: bool = True):
        self.classes = classes
        self.initial = InitialBlock(in_ch, 16)

        self.down1 = DownsamplingBottleneck(16, 64, dropout=0.01,
                                            relu=encoder_relu)
        self.stage1 = nn.Sequential(*[
            RegularBottleneck(64, dropout=0.01, relu=encoder_relu)
            for _ in range(4)])

        self.down2 = DownsamplingBottleneck(64, 128, dropout=0.1,
                                            relu=encoder_relu)

        def _mix(relu):
            return nn.Sequential(
                RegularBottleneck(128, relu=relu),
                RegularBottleneck(128, dilation=2, relu=relu),
                RegularBottleneck(128, asymmetric=True, relu=relu),
                RegularBottleneck(128, dilation=4, relu=relu),
                RegularBottleneck(128, relu=relu),
                RegularBottleneck(128, dilation=8, relu=relu),
                RegularBottleneck(128, asymmetric=True, relu=relu),
                RegularBottleneck(128, dilation=16, relu=relu),
            )

        self.stage2 = _mix(encoder_relu)
        self.stage3 = _mix(encoder_relu)

        self.up4 = UpsamplingBottleneck(128, 64, relu=decoder_relu)
        self.stage4 = nn.Sequential(
            RegularBottleneck(64, relu=decoder_relu),
            RegularBottleneck(64, relu=decoder_relu))
        self.up5 = UpsamplingBottleneck(64, 16, relu=decoder_relu)
        self.stage5 = RegularBottleneck(16, relu=decoder_relu)
        self.fullconv = nn.ConvTranspose(16, classes, 3, stride=2, padding=1,
                                         output_padding=1, bias=False,
                                         lowering="zero_insert")

    def features(self, scope, x):
        y = scope("initial", self.initial, x)
        y, idx1 = scope("down1", self.down1, y)
        y = scope("stage1", self.stage1, y)
        y, idx2 = scope("down2", self.down2, y)
        y = scope("stage2", self.stage2, y)
        y = scope("stage3", self.stage3, y)
        y = scope("up4", self.up4, y, idx2)
        y = scope("stage4", self.stage4, y)
        y = scope("up5", self.up5, y, idx1)
        y = scope("stage5", self.stage5, y)
        return y

    def __call__(self, scope, x):
        return scope("fullconv", self.fullconv,
                     self.features(scope, x))

    def predict(self, scope, x):
        """Fused prediction head — see blocks.subpixel_predict_tail.
        argmax_tail="resize" (= plain jnp.argmax) on the phase logits: the
        packed-key argmax only makes ENet's graph larger, and the phase
        conv is a cheap producer here, so naive costs nothing.

        ENet caveat: __call__ pins the head to the zero_insert lowering
        while this path evaluates the same math via the subpixel phase
        conv — different floating-point association, so in bf16 argmax may
        differ at near-tie pixels (both are valid roundings; f32 parity is
        exact and tested)."""
        return subpixel_predict_tail(self.fullconv,
                                     scope.child("fullconv"),
                                     self.features(scope, x),
                                     argmax_tail="resize")
