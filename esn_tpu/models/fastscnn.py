"""Fast-SCNN (Poudel et al. 2019, arXiv 1902.04502) — NHWC.

Reference counterpart: ``model/FastSCNN.py`` [R] (LearningToDownsample,
GlobalFeatureExtractor, FeatureFusionModule, Classifer). Flagship of the
full-res 2048x1024 benchmark config (BASELINE config 5; paper: 123.5 fps,
1.11M params).

Structure:
- learning-to-downsample: conv 3->32 s2, dsconv 32->48 s2, dsconv 48->64 s2
- global feature extractor (on 1/8): inverted residuals t=6
  [64x3 s2, 96x3 s2, 128x3 s1] + PPM(128, bins 1,2,3,6)
- feature fusion: 1/32 path x4 upsample -> dwconv -> 1x1 (linear);
  1/8 path 1x1 (linear); add -> ReLU
- classifier: 2x dsconv 128 + dropout + 1x1 -> classes; x8 bilinear
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import nn
from ..ops import resize as R
from .blocks import ConvBNAct, DSConv, InvertedResidual, PyramidPooling
from .registry import register


class LearningToDownsample(nn.Module):
    def __init__(self, in_ch=3, chs=(32, 48, 64)):
        c1, c2, c3 = chs
        self.conv = ConvBNAct(in_ch, c1, 3, stride=2, act="relu")
        self.ds1 = DSConv(c1, c2, stride=2)
        self.ds2 = DSConv(c2, c3, stride=2)

    def __call__(self, scope, x):
        x = scope("conv", self.conv, x)
        x = scope("ds1", self.ds1, x)
        return scope("ds2", self.ds2, x)


class GlobalFeatureExtractor(nn.Module):
    def __init__(self, in_ch=64, chs=(64, 96, 128), expansion=6,
                 repeats=(3, 3, 3), out_ch=128):
        def stage(cin, cout, n, stride):
            mods = [InvertedResidual(cin, cout, expansion=expansion,
                                     stride=stride)]
            mods += [InvertedResidual(cout, cout, expansion=expansion)
                     for _ in range(n - 1)]
            return nn.Sequential(*mods)
        self.s1 = stage(in_ch, chs[0], repeats[0], 2)
        self.s2 = stage(chs[0], chs[1], repeats[1], 2)
        self.s3 = stage(chs[1], chs[2], repeats[2], 1)
        self.ppm = PyramidPooling(chs[2], out_ch)

    def __call__(self, scope, x):
        x = scope("s1", self.s1, x)
        x = scope("s2", self.s2, x)
        x = scope("s3", self.s3, x)
        return scope("ppm", self.ppm, x)


class FeatureFusion(nn.Module):
    """Add-fusion of the 1/8 spatial path and upsampled 1/32 context path."""

    def __init__(self, high_ch=64, low_ch=128, out_ch=128):
        self.low_dw = ConvBNAct(low_ch, low_ch, 3, groups=low_ch, act="none")
        self.low_pw = ConvBNAct(low_ch, out_ch, 1, act="none")
        self.high_pw = ConvBNAct(high_ch, out_ch, 1, act="none")

    def __call__(self, scope, high, low):
        h, w = high.shape[1:3]
        low = R.resize_bilinear(low, (h, w))
        low = scope("low_dw", self.low_dw, low)
        low = scope("low_pw", self.low_pw, low)
        high = scope("high_pw", self.high_pw, high)
        return nn.relu(high + low)


class Classifier(nn.Module):
    def __init__(self, ch, classes, dropout=0.1):
        self.ds1 = DSConv(ch, ch)
        self.ds2 = DSConv(ch, ch)
        self.drop = nn.Dropout(dropout)
        self.conv = nn.Conv(ch, classes, 1, bias=True)

    def __call__(self, scope, x):
        x = scope("ds1", self.ds1, x)
        x = scope("ds2", self.ds2, x)
        x = scope("drop", self.drop, x)
        return scope("conv", self.conv, x)


@register("fastscnn", "fast_scnn", "fast-scnn")
class FastSCNN(nn.Module):
    LOGITS_TAIL = "resize"
    def __init__(self, classes: int = 19, in_ch: int = 3):
        self.classes = classes
        self.ltd = LearningToDownsample(in_ch)
        self.gfe = GlobalFeatureExtractor()
        self.ffm = FeatureFusion()
        self.head = Classifier(128, classes)

    def logits_lowres(self, scope, x):
        """1/8-res logits (nn.Module.predict fuses the 8x upsample+argmax
        tail through ops.classify.resize_tail_argmax)."""
        high = scope("ltd", self.ltd, x)           # 1/8
        low = scope("gfe", self.gfe, high)         # 1/32
        y = scope("ffm", self.ffm, high, low)      # 1/8
        return scope("head", self.head, y)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        y = self.logits_lowres(scope, x)
        return R.resize_bilinear(y.astype(jnp.float32), (h, w)) \
            .astype(y.dtype)
