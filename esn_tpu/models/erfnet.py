"""ERFNet (Romera et al. 2017) — NHWC.

Reference counterpart: ``model/ERFNet.py`` [R] (DownsamplerBlock,
non_bottleneck_1d, Encoder/Decoder). ~2.06M params, paper 68.0 mIoU.

Encoder: down(3->16), down(16->64), 5x nb1d(64, drop .03);
down(64->128), 2x [nb1d d=2, d=4, d=8, d=16] (drop .3).
Decoder: up(128->64), 2x nb1d; up(64->16), 2x nb1d; 2x2/s2 deconv -> classes.
"""
from __future__ import annotations

from .. import nn
from .blocks import DownsamplerConcat, NonBottleneck1d, UpsamplerBlock, subpixel_predict_tail
from .registry import register


@register("erfnet")
class ERFNet(nn.Module):
    def __init__(self, classes: int = 19, in_ch: int = 3,
                 dropout_1: float = 0.03, dropout_2: float = 0.3):
        # repeated blocks run as lax.scan bodies (nn.ScanChain): the 5x
        # nb1d(64) stack scans directly; the 2x [d=2,4,8,16] stage scans a
        # 4-block Sequential pattern (structurally identical across the two
        # repeats — dilation is static inside the body). Graph size becomes
        # repeat-independent, which keeps ERFNet's full-res training graph
        # and its compile time small.
        self.encoder = nn.Sequential(
            DownsamplerConcat(in_ch, 16, act="relu"),
            DownsamplerConcat(16, 64, act="relu"),
            nn.ScanChain(NonBottleneck1d(64, dropout=dropout_1), 5,
                         eval_unroll=True),
            DownsamplerConcat(64, 128, act="relu"),
            nn.ScanChain(
                nn.Sequential(*[NonBottleneck1d(128, dilation=d,
                                                dropout=dropout_2)
                                for d in (2, 4, 8, 16)]), 2,
                eval_unroll=True))
        self.decoder = nn.Sequential(
            UpsamplerBlock(128, 64),
            NonBottleneck1d(64), NonBottleneck1d(64),
            UpsamplerBlock(64, 16),
            NonBottleneck1d(16), NonBottleneck1d(16))
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
