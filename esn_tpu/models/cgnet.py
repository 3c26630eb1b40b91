"""CGNet M3N21 (Wu et al. 2018, arXiv 1811.08201) — NHWC.

Reference counterpart: ``model/CGNet.py`` [R] (ConvBNPReLU, ChannelWiseConv,
ChannelWiseDilatedConv, FGlo, ContextGuidedBlock, ContextGuidedBlock_Down,
InputInjection). ~0.50M params, paper 64.8 mIoU.

The CG block computes joint local (depthwise 3x3) + surrounding (depthwise
dilated 3x3) context, fuses, then gates channels with a GAP->FC->sigmoid
global-context unit (FGlo). Stages: M=3 blocks at 1/4 (d=2), N=21 at 1/8
(d=4), with raw-input injections at each downsampling.
"""
from __future__ import annotations

import os

import jax.numpy as jnp

from .. import nn
from ..ops import folding
from ..ops import pooling as P
from ..ops import resize as R
from ..ops import s2d as S
from .blocks import BNAct, ConvBNAct, InputInjection, SEGate
from .registry import register

BN_EPS = 1e-3


class FGlo(SEGate):
    """Global context channel gate (GAP -> FC/r -> ReLU -> FC -> sigmoid)."""


class CGBlock(nn.Module):
    """Residual context-guided block at constant resolution."""

    def __init__(self, ch: int, dilation: int = 2, reduction: int = 16):
        half = ch // 2
        self.ch = ch
        self.dilation_ = dilation
        self.reduce = ConvBNAct(ch, half, 1, act="prelu", bn_eps=BN_EPS)
        self.loc = nn.Conv(half, half, 3, padding=1, groups=half, bias=False)
        self.sur = nn.Conv(half, half, 3, padding=dilation,
                           dilation=dilation, groups=half, bias=False)
        self.join = BNAct(ch, act="prelu", bn_eps=BN_EPS)
        self.glo = FGlo(ch, reduction)

    def __call__(self, scope, x):
        f = 1
        # ESN_TPU_FOLD_DW default OFF: before the GPU port the shift-FMA
        # folded depthwise path was slower at inference than XLA's native
        # depthwise lowering — the 9-tap re-read pattern costs more
        # memory traffic than the padding it removes (not measured on the
        # H100). Kept as an exact, tested, opt-in alternative.
        if os.environ.get("ESN_TPU_FOLD_DW", "0") == "1" and not scope.is_init:
            f = folding.fold_factor(self.ch // 2, x.shape[2])
        if f > 1:
            return self._folded(scope, x, f)
        y = scope("reduce", self.reduce, x)
        loc = scope("loc", self.loc, y)
        sur = scope("sur", self.sur, y)
        y = scope("join", self.join, jnp.concatenate([loc, sur], axis=-1))
        y = scope("glo", self.glo, y)
        return x + y

    def _folded(self, scope, x, f):
        """Lane-folded execution (ops.folding): same parameters, same math.
        The block's bottleneck is its dual depthwise 3x3 at ch/2 = 32-64
        channels (reference ChannelWiseConv / ChannelWiseDilatedConv [R:
        model/CGNet.py]) — 50-75% channel padding. W folds
        into channels once per block (a free NHWC reshape), the depthwise
        pair runs at full density (folded_depthwise_conv), and BN / PReLU /
        FGlo apply fold-aware. Exact vs the plain path (tested)."""
        half = self.ch // 2
        d = self.dilation_
        xf = folding.fold_w(x, f)
        rs = scope.child("reduce")
        w, b = self.reduce.conv.params(rs.child("conv"))
        y = folding.folded_conv2d(xf, w, f, bias=b)
        y = self.reduce.bn.folded_apply(rs.child("bn"), y, f)
        y = self.reduce.act.folded_apply(rs.child("act"), y, f)
        wl, _ = self.loc.params(scope.child("loc"))
        ws, _ = self.sur.params(scope.child("sur"))
        loc = folding.folded_depthwise_conv(y, wl[:, :, 0], f,
                                            padding=(1, 1))
        sur = folding.folded_depthwise_conv(y, ws[:, :, 0], f,
                                            dilation=(d, d), padding=(d, d))
        # interleaved concat == fold_w(concat([loc, sur])): slot-major over
        # the joined 2*half channels
        bsz, h, q = loc.shape[:3]
        j = jnp.concatenate([loc.reshape(bsz, h, q, f, half),
                             sur.reshape(bsz, h, q, f, half)], axis=-1) \
            .reshape(bsz, h, q, f * self.ch)
        js = scope.child("join")
        j = self.join.bn.folded_apply(js.child("bn"), j, f)
        j = self.join.act.folded_apply(js.child("act"), j, f)
        j = self.glo.folded_apply(scope.child("glo"), j, f)
        return folding.unfold_w(xf + j, f)


class CGBlockDown(nn.Module):
    """Strided context-guided block (no residual): full 3x3/s2, dual
    depthwise context, 1x1 re-fuse, FGlo."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 2,
                 reduction: int = 16):
        self.conv = ConvBNAct(in_ch, out_ch, 3, stride=2, act="prelu",
                              bn_eps=BN_EPS)
        self.loc = nn.Conv(out_ch, out_ch, 3, padding=1, groups=out_ch,
                           bias=False)
        self.sur = nn.Conv(out_ch, out_ch, 3, padding=dilation,
                           dilation=dilation, groups=out_ch, bias=False)
        self.join_bn = BNAct(2 * out_ch, act="prelu", bn_eps=BN_EPS)
        self.refuse = nn.Conv(2 * out_ch, out_ch, 1, bias=False)
        self.glo = FGlo(out_ch, reduction)

    def __call__(self, scope, x):
        if isinstance(x, (list, tuple)):
            # virtual-concat input (CGNet's raw-input injections): the
            # stride-2 conv splits its kernel over the pieces instead of
            # materializing a misaligned 35/131-ch concat (tuned before the GPU
            # port; not measured on the H100)
            y = self.conv.pieces_apply(scope.child("conv"), x)
        else:
            y = scope("conv", self.conv, x)
        loc = scope("loc", self.loc, y)
        sur = scope("sur", self.sur, y)
        y = scope("join_bn", self.join_bn,
                  jnp.concatenate([loc, sur], axis=-1))
        y = scope("refuse", self.refuse, y)
        return scope("glo", self.glo, y)


@register("cgnet", "context_guided_network")
class CGNet(nn.Module):
    LOGITS_TAIL = "resize"
    def __init__(self, classes: int = 19, in_ch: int = 3, m: int = 3,
                 n: int = 21, dropout: float = 0.0):
        self.stem = nn.Sequential(
            ConvBNAct(in_ch, 32, 3, stride=2, act="prelu", bn_eps=BN_EPS),
            ConvBNAct(32, 32, 3, act="prelu", bn_eps=BN_EPS),
            ConvBNAct(32, 32, 3, act="prelu", bn_eps=BN_EPS))
        self.inj1 = InputInjection(1)
        self.inj2 = InputInjection(2)
        self.b1 = BNAct(32 + in_ch, act="prelu", bn_eps=BN_EPS)

        # identical repeated blocks run as ONE lax.scan body (nn.ScanChain):
        # graph size becomes depth-independent, which is what got CGNet's
        # large-batch full-res TRAINING graphs small. Inference unrolls
        # (eval_unroll): XLA's cross-block fusion beat the scan carry before
        # the GPU port (not measured on the H100).
        self.down2 = CGBlockDown(32 + in_ch, 64, dilation=2, reduction=8)
        self.stage2 = nn.ScanChain(CGBlock(64, 2, 8), m - 1, eval_unroll=True)
        self.b2 = BNAct(128 + in_ch, act="prelu", bn_eps=BN_EPS)

        self.down3 = CGBlockDown(128 + in_ch, 128, dilation=4, reduction=16)
        self.stage3 = nn.ScanChain(CGBlock(128, 4, 16), n - 1,
                                   eval_unroll=True)
        self.b3 = BNAct(256, act="prelu", bn_eps=BN_EPS)
        self.drop = nn.SpatialDropout(dropout)
        self.head = nn.Conv(256, classes, 1, bias=False)

    def _stem(self, scope, x):
        """Lane-folded stem: conv1 consumes the s2d(2,8)-relayout of the
        full-res RGB input (a shuffle-free reshape — ops/s2d.py space_to_depth)
        and emits its 1/2-res 32-ch output W-folded f=4 (128 dense lanes);
        c2/c3 + BN/PReLU run entirely folded; one unfold (free reshape) at the
        end. Exact (general_folded_conv parity-tested); tuned before the GPU
        port, not measured on the H100. Falls back to the unrolled Sequential
        when shapes don't divide or during init."""
        c1, c2, c3 = self.stem.layers
        hw_ok = x.shape[1] % 2 == 0 and x.shape[2] % 16 == 0
        if scope.is_init or not hw_ok \
                or os.environ.get("ESN_TPU_FOLDED_STEM", "1") == "0":
            return scope("stem", self.stem, x)
        st = scope.child("stem")
        f = 4
        xs = S.space_to_depth(x, 2, 8)
        y = None
        for i, m in enumerate((c1, c2, c3)):
            s = st.child(str(i))
            w_, b_ = m.conv.params(s.child("conv"))
            if i == 0:
                y = S.general_folded_conv(xs, w_, stride=(2, 2),
                                          padding=(1, 1), in_fold=(2, 8),
                                          out_fold_w=f, bias=b_)
            else:
                y = S.general_folded_conv(y, w_, stride=(1, 1),
                                          padding=(1, 1), in_fold=(1, f),
                                          out_fold_w=f, bias=b_)
            y = m.bn.folded_apply(s.child("bn"), y, f)
            y = m.act.folded_apply(s.child("act"), y, f)
        return folding.unfold_w(y, f)

    def logits_lowres(self, scope, x):
        """1/8-res logits (nn.Module.predict fuses the 8x upsample+argmax
        tail through ops.classify.resize_tail_argmax)."""
        s1 = self._stem(scope, x)                              # 1/2, 32
        i1 = scope("inj1", self.inj1, x)
        i2 = scope("inj2", self.inj2, x)
        # raw-input injections ride as VIRTUAL concats (lists of pieces):
        # BN/PReLU slice their per-channel params, the downsampler conv
        # splits its kernel — exact, and the 35/131-ch lane-misaligned
        # tensors never exist
        p1 = self.b1.pieces_apply(scope.child("b1"), [s1, i1])
        d2 = scope("down2", self.down2, p1)                    # 1/4, 64
        s2 = scope("stage2", self.stage2, d2)
        p2 = self.b2.pieces_apply(scope.child("b2"), [s2, d2, i2])
        d3 = scope("down3", self.down3, p2)                    # 1/8, 128
        s3 = scope("stage3", self.stage3, d3)
        y = scope("b3", self.b3, jnp.concatenate([s3, d3], -1))
        y = scope("drop", self.drop, y)
        return scope("head", self.head, y)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        y = self.logits_lowres(scope, x)
        return R.resize_bilinear(y.astype(jnp.float32), (h, w)) \
            .astype(y.dtype)
