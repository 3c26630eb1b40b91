"""DABNet (Li & Kim 2019, arXiv 1907.11357) — NHWC.

Reference counterpart: ``model/DABNet.py`` [R] (Conv, BNPReLU, DABModule,
DownSamplingBlock, InputInjection). ~0.76M params, paper 70.1 mIoU.

DAB module: BN+PReLU -> 3x3 reduce to ch/2 -> dual depth-wise asymmetric
branches (3x1+1x3, plain || dilated) -> sum -> 1x1 expand -> residual.
Stages: 3 modules d=2 at 1/4; 6 modules d=4,4,8,8,16,16 at 1/8; raw-input
injections at 1/2, 1/4, 1/8.
"""
from __future__ import annotations

import os

import jax.numpy as jnp

from .. import nn
from ..ops import folding
from ..ops import pooling as P
from ..ops import resize as R
from .blocks import BNAct, ConvBNAct, InputInjection
from .registry import register

BN_EPS = 1e-3


class DABModule(nn.Module):
    def __init__(self, ch: int, dilation: int = 2):
        half = ch // 2
        d = dilation
        self.ch = ch
        self.dilation_ = d
        self.pre = BNAct(ch, act="prelu", bn_eps=BN_EPS)
        self.reduce = ConvBNAct(ch, half, 3, act="prelu", bn_eps=BN_EPS)
        # plain depthwise asymmetric pair
        self.a1 = nn.Conv(half, half, (3, 1), padding=(1, 0), groups=half,
                          bias=False)
        self.a2 = nn.Conv(half, half, (1, 3), padding=(0, 1), groups=half,
                          bias=False)
        self.a_post = BNAct(half, act="prelu", bn_eps=BN_EPS)
        # dilated depthwise asymmetric pair
        self.b1 = nn.Conv(half, half, (3, 1), padding=(d, 0),
                          dilation=(d, 1), groups=half, bias=False)
        self.b2 = nn.Conv(half, half, (1, 3), padding=(0, d),
                          dilation=(1, d), groups=half, bias=False)
        self.b_post = BNAct(half, act="prelu", bn_eps=BN_EPS)
        self.expand = nn.Conv(half, ch, 1, bias=False)

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
        y = scope("pre", self.pre, x)
        y = scope("reduce", self.reduce, y)
        a = scope("a2", self.a2, scope("a1", self.a1, y))
        a = scope("a_post", self.a_post, a)
        b = scope("b2", self.b2, scope("b1", self.b1, y))
        b = scope("b_post", self.b_post, b)
        y = scope("expand", self.expand, a + b)
        return x + y

    def _folded(self, scope, x, f):
        """Lane-folded execution (ops.folding; CGBlock._folded rationale).
        The asymmetric depthwise pairs at ch/2 = 32-64 channels (reference
        model/DABNet.py depth_wise convs [R]) run at full 128-lane density:
        (3,1) taps are slot-uniform by construction, (1,3) dilated taps are
        slot-uniform whenever f | d (d = 4/8/16 at stage2), and the d=1/
        d=2 pairs take the mixed-slot slice path. Exact (tested)."""
        half = self.ch // 2
        d = self.dilation_

        def bnact(mod, s, y):
            y = mod.bn.folded_apply(s.child("bn"), y, f)
            return mod.act.folded_apply(s.child("act"), y, f)

        xf = folding.fold_w(x, f)
        y = bnact(self.pre, scope.child("pre"), xf)
        rs = scope.child("reduce")
        w, b = self.reduce.conv.params(rs.child("conv"))
        y = folding.folded_conv2d(y, w, f, padding=(1, 1), bias=b)
        y = self.reduce.bn.folded_apply(rs.child("bn"), y, f)
        y = self.reduce.act.folded_apply(rs.child("act"), y, f)

        wa1, _ = self.a1.params(scope.child("a1"))
        wa2, _ = self.a2.params(scope.child("a2"))
        a = folding.folded_depthwise_conv(y, wa1[:, :, 0], f,
                                          padding=(1, 0))
        a = folding.folded_depthwise_conv(a, wa2[:, :, 0], f,
                                          padding=(0, 1))
        a = bnact(self.a_post, scope.child("a_post"), a)

        wb1, _ = self.b1.params(scope.child("b1"))
        wb2, _ = self.b2.params(scope.child("b2"))
        bb = folding.folded_depthwise_conv(y, wb1[:, :, 0], f,
                                           dilation=(d, 1), padding=(d, 0))
        bb = folding.folded_depthwise_conv(bb, wb2[:, :, 0], f,
                                           dilation=(1, d), padding=(0, d))
        bb = bnact(self.b_post, scope.child("b_post"), bb)

        we, _ = self.expand.params(scope.child("expand"))
        y = folding.folded_conv2d(a + bb, we, f)
        return folding.unfold_w(xf + y, f)


class DownSamplingBlock(nn.Module):
    """conv s2 (out-in) || maxpool concat (ENet style) [R]."""

    def __init__(self, in_ch: int, out_ch: int):
        self.concat_pool = out_ch > in_ch
        conv_out = out_ch - in_ch if self.concat_pool else out_ch
        self.conv = nn.Conv(in_ch, conv_out, 3, stride=2, padding=1,
                            bias=True)
        self.post = BNAct(out_ch, act="prelu", bn_eps=BN_EPS)

    def __call__(self, scope, x):
        if isinstance(x, (list, tuple)):
            # virtual-concat input (DABNet's raw-input injections): the
            # stride-2 conv splits its kernel over the pieces and the pool
            # path pools each piece (both per-channel exact); BN/PReLU
            # slice their params. The lane-hostile 35/131/259-ch concats
            # never exist — one aligned concat materializes the output.
            y = self.conv.pieces_apply(scope.child("conv"), x)
            pieces = [y] + ([P.max_pool2d(p, 2, 2) for p in x]
                            if self.concat_pool else [])
            pieces = self.post.pieces_apply(scope.child("post"), pieces)
            return jnp.concatenate(pieces, axis=-1)
        y = scope("conv", self.conv, x)
        if self.concat_pool:
            y = jnp.concatenate([y, P.max_pool2d(x, 2, 2)], axis=-1)
        return scope("post", self.post, y)


@register("dabnet")
class DABNet(nn.Module):
    LOGITS_TAIL = "resize"
    def __init__(self, classes: int = 19, in_ch: int = 3):
        self.stem = nn.Sequential(
            ConvBNAct(in_ch, 32, 3, stride=2, act="prelu", bn_eps=BN_EPS),
            ConvBNAct(32, 32, 3, act="prelu", bn_eps=BN_EPS),
            ConvBNAct(32, 32, 3, act="prelu", bn_eps=BN_EPS))
        self.inj1 = InputInjection(1)
        self.inj2 = InputInjection(2)
        self.inj3 = InputInjection(3)
        self.b1 = BNAct(32 + in_ch, act="prelu", bn_eps=BN_EPS)

        self.down1 = DownSamplingBlock(32 + in_ch, 64)
        # repeated DAB stacks run as lax.scan bodies (nn.ScanChain): graph
        # size becomes repeat-independent (shorter compiles). The
        # (4,4,8,8,16,16) stage is three scanned pairs — dilation is static
        # inside each body.
        self.block1 = nn.ScanChain(DABModule(64, 2), 3, eval_unroll=True)
        self.b2 = BNAct(128 + in_ch, act="prelu", bn_eps=BN_EPS)

        self.down2 = DownSamplingBlock(128 + in_ch, 128)
        self.block2 = nn.Sequential(*[nn.ScanChain(DABModule(128, d), 2,
                                                   eval_unroll=True)
                                      for d in (4, 8, 16)])
        self.b3 = BNAct(256 + in_ch, act="prelu", bn_eps=BN_EPS)
        self.head = nn.Conv(256 + in_ch, classes, 1, bias=False)

    def logits_lowres(self, scope, x):
        """1/8-res logits (nn.Module.predict fuses the 8x upsample+argmax
        tail through ops.classify.resize_tail_argmax)."""
        y = scope("stem", self.stem, x)                       # 1/2, 32
        i1 = scope("inj1", self.inj1, x)
        i2 = scope("inj2", self.inj2, x)
        i3 = scope("inj3", self.inj3, x)
        # raw-input injections ride as VIRTUAL concats (lists of pieces,
        # same rewrite as CGNet): BN/PReLU slice per-channel params, the
        # downsampler/head convs split their kernels — exact, and the
        # 35/131/259-ch lane-misaligned tensors never exist
        p1 = self.b1.pieces_apply(scope.child("b1"), [y, i1])

        d1 = scope("down1", self.down1, p1)                   # 1/4, 64
        y = scope("block1", self.block1, d1)
        p2 = self.b2.pieces_apply(scope.child("b2"), [y, d1, i2])

        d2 = scope("down2", self.down2, p2)                   # 1/8, 128
        y = scope("block2", self.block2, d2)
        p3 = self.b3.pieces_apply(scope.child("b3"), [y, d2, i3])
        return self.head.pieces_apply(scope.child("head"), p3)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        y = self.logits_lowres(scope, x)
        return R.resize_bilinear(y.astype(jnp.float32), (h, w)) \
            .astype(y.dtype)
