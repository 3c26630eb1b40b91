"""ESNet (Wang et al. 2019, arXiv 1906.09826) — NHWC.

Reference counterpart: ``model/ESNet.py`` [R] (DownsamplerBlock, FCU, PFCU,
UpsamplerBlock). ~1.66M params, paper 70.7 mIoU.

Symmetric encoder-decoder:
enc: down(3->16), 3x FCU(16,k3); down(16->64), 2x FCU(64,k5);
     down(64->128), 3x PFCU(128, d=2,5,9)
dec: up(128->64), 2x FCU(64,k5); up(64->16), 2x FCU(16,k3);
     2x2/s2 deconv -> classes.
"""
from __future__ import annotations

from .. import nn
from .blocks import (DownsamplerConcat, NonBottleneck1d, UpsamplerBlock, subpixel_predict_tail)
from .registry import register


class PFCU(nn.Module):
    """Parallel factorized unit: shared (3x1,1x3) head, then three dilated
    (3x1,1x3) branches (d=2,5,9) summed, BN, dropout, residual, relu."""

    def __init__(self, ch: int, dilations=(2, 5, 9), dropout: float = 0.3):
        self.h1 = nn.Conv(ch, ch, (3, 1), padding=(1, 0), bias=True)
        self.h2 = nn.Conv(ch, ch, (1, 3), padding=(0, 1), bias=True)
        self.bn_head = nn.BatchNorm(ch, eps=1e-3)
        self.branches = []
        for d in dilations:
            self.branches.append((
                nn.Conv(ch, ch, (3, 1), padding=(d, 0), dilation=(d, 1),
                        bias=True),
                nn.Conv(ch, ch, (1, 3), padding=(0, d), dilation=(1, d),
                        bias=True),
                nn.BatchNorm(ch, eps=1e-3)))
        self.drop = nn.SpatialDropout(dropout)

    def __call__(self, scope, x):
        y = nn.relu(scope("h1", self.h1, x))
        y = scope("h2", self.h2, y)
        y = nn.relu(scope("bn_head", self.bn_head, y))
        total = None
        for i, (c1, c2, bn) in enumerate(self.branches):
            b = nn.relu(scope(f"b{i}_1", c1, y))
            b = scope(f"b{i}_2", c2, b)
            b = scope(f"b{i}_bn", bn, b)
            total = b if total is None else total + b
        total = scope("drop", self.drop, total)
        return nn.relu(x + total)


@register("esnet")
class ESNet(nn.Module):
    def __init__(self, classes: int = 19, in_ch: int = 3):
        # repeated FCU/PFCU stacks run as lax.scan bodies (nn.ScanChain):
        # graph size becomes repeat-independent (shorter compiles)
        self.encoder = nn.Sequential(
            DownsamplerConcat(in_ch, 16, act="relu"),
            nn.ScanChain(NonBottleneck1d(16, k=3, dropout=0.03), 3,
                         eval_unroll=True),
            DownsamplerConcat(16, 64, act="relu"),
            nn.ScanChain(NonBottleneck1d(64, k=5, dropout=0.03), 2,
                         eval_unroll=True),
            DownsamplerConcat(64, 128, act="relu"),
            nn.ScanChain(PFCU(128), 3, eval_unroll=True))
        self.decoder = nn.Sequential(
            UpsamplerBlock(128, 64),
            nn.ScanChain(NonBottleneck1d(64, k=5), 2, eval_unroll=True),
            UpsamplerBlock(64, 16),
            nn.ScanChain(NonBottleneck1d(16, k=3), 2, eval_unroll=True))
        self.head = nn.ConvTranspose(16, classes, 2, stride=2, bias=True)

    def features(self, scope, x):
        y = scope("encoder", self.encoder, x)
        y = scope("decoder", self.decoder, y)
        return y

    def __call__(self, scope, x):
        return scope("head", self.head,
                     self.features(scope, x))

    def predict(self, scope, x):
        """Fused prediction head — see blocks.subpixel_predict_tail."""
        return subpixel_predict_tail(self.head,
                                     scope.child("head"),
                                     self.features(scope, x))
