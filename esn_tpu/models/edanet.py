"""EDANet (Lo et al. 2018, arXiv 1809.06323) — NHWC.

Reference counterpart: ``model/EDANet.py`` [R] (DownsamplingBlock, EDAModule,
EDABlock). ~0.68M params, paper 67.3 mIoU.

Dense asymmetric-dilated modules with growth rate 40:
down(3->15), down(15->60), 5 EDA modules d=(1,1,1,2,2) -> 260,
down(260->130), 8 EDA modules d=(2,2,4,4,8,8,16,16) -> 450,
1x1 -> classes, x8 bilinear.
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import nn
from ..ops import pooling as P
from ..ops import resize as R
from .registry import register


class DownsamplingBlock(nn.Module):
    """conv s2 (out-in) || maxpool2 concat, BN+ReLU (ENet-style stem).
    When out_ch <= in_ch (deep downsamplers) it is a plain strided conv."""

    def __init__(self, in_ch: int, out_ch: int):
        self.concat_pool = out_ch > in_ch
        conv_out = out_ch - in_ch if self.concat_pool else out_ch
        self.conv = nn.Conv(in_ch, conv_out, 3, stride=2, padding=1,
                            bias=True)
        self.bn = nn.BatchNorm(out_ch, eps=1e-3)

    def __call__(self, scope, x):
        y = scope("conv", self.conv, x)
        if self.concat_pool:
            y = jnp.concatenate([y, P.max_pool2d(x, 2, 2)], axis=-1)
        return nn.relu(scope("bn", self.bn, y))


class EDAModule(nn.Module):
    """1x1 reduce -> (3x1,1x3) -> BN relu -> dilated (3x1,1x3) -> BN relu ->
    dropout -> dense concat with the input (growth k)."""

    def __init__(self, in_ch: int, growth: int = 40, dilation: int = 1,
                 dropout: float = 0.02):
        k = growth
        d = dilation
        self.reduce = nn.Conv(in_ch, k, 1, bias=True)
        self.a1 = nn.Conv(k, k, (3, 1), padding=(1, 0), bias=True)
        self.a2 = nn.Conv(k, k, (1, 3), padding=(0, 1), bias=True)
        self.bn1 = nn.BatchNorm(k, eps=1e-3)
        self.b1 = nn.Conv(k, k, (3, 1), padding=(d, 0), dilation=(d, 1),
                          bias=True)
        self.b2 = nn.Conv(k, k, (1, 3), padding=(0, d), dilation=(1, d),
                          bias=True)
        self.bn2 = nn.BatchNorm(k, eps=1e-3)
        self.drop = nn.SpatialDropout(dropout)

    def __call__(self, scope, x):
        y = scope("reduce", self.reduce, x)
        y = scope("a1", self.a1, y)
        y = scope("a2", self.a2, y)
        y = nn.relu(scope("bn1", self.bn1, y))
        y = scope("b1", self.b1, y)
        y = scope("b2", self.b2, y)
        y = nn.relu(scope("bn2", self.bn2, y))
        y = scope("drop", self.drop, y)
        return jnp.concatenate([x, y], axis=-1)


@register("edanet")
class EDANet(nn.Module):
    LOGITS_TAIL = "resize"
    def __init__(self, classes: int = 19, in_ch: int = 3, growth: int = 40):
        self.down1 = DownsamplingBlock(in_ch, 15)
        self.down2 = DownsamplingBlock(15, 60)
        ch = 60
        block1 = []
        for d in (1, 1, 1, 2, 2):
            block1.append(EDAModule(ch, growth, d))
            ch += growth
        self.block1 = nn.Sequential(*block1)      # 260
        self.down3 = DownsamplingBlock(ch, 130)
        ch = 130
        block2 = []
        for d in (2, 2, 4, 4, 8, 8, 16, 16):
            block2.append(EDAModule(ch, growth, d))
            ch += growth
        self.block2 = nn.Sequential(*block2)      # 450
        self.head = nn.Conv(ch, classes, 1, bias=True)

    def logits_lowres(self, scope, x):
        """1/8-res logits (nn.Module.predict fuses the 8x upsample+argmax
        tail through ops.classify.resize_tail_argmax)."""
        y = scope("down1", self.down1, x)
        y = scope("down2", self.down2, y)
        y = scope("block1", self.block1, y)
        y = scope("down3", self.down3, y)
        y = scope("block2", self.block2, y)
        return scope("head", self.head, y)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        y = self.logits_lowres(scope, x)
        return R.resize_bilinear(y.astype(jnp.float32), (h, w)).astype(y.dtype)
