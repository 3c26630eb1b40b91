"""ContextNet (Poudel et al. 2018, arXiv 1805.04554) — NHWC.

Reference counterpart: ``model/ContextNet.py`` [R] (Shallow_net, DeepNet,
FeatureFusionModule). Two-branch design for 2048x1024: a full-res shallow
spatial branch (3 dsconvs to 1/8) + a deep context branch run on a 4x
downsampled input (inverted residual stack to 1/4 of that = 1/32 overall),
fused additively at 1/8. ~0.85M params, paper 66.1 mIoU.
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import nn
from ..ops import resize as R
from .blocks import ConvBNAct, DSConv, InvertedResidual
from .registry import register


class ShallowNet(nn.Module):
    """Full-res spatial branch -> 1/8, 64ch."""

    def __init__(self, in_ch=3):
        self.conv = ConvBNAct(in_ch, 32, 3, stride=2, act="relu")
        # W-folded stem (ops/s2d.w_fold_stem_conv): before the GPU port it sped
        # up this model's full-res train step and slowed fastscnn/dabnet/
        # espnet_c, so it is a per-model opt-in (not measured on the H100)
        self.conv.fold_stem = True
        self.ds1 = DSConv(32, 64, stride=2)
        self.ds2 = DSConv(64, 128, stride=2)
        self.ds3 = DSConv(128, 128, stride=1)

    def __call__(self, scope, x):
        x = scope("conv", self.conv, x)
        x = scope("ds1", self.ds1, x)
        x = scope("ds2", self.ds2, x)
        return scope("ds3", self.ds3, x)


class DeepNet(nn.Module):
    """Context branch on the 1/4-res input: MobileNetV2-style stack."""

    def __init__(self, in_ch=3):
        self.conv = ConvBNAct(in_ch, 32, 3, stride=2, act="relu")
        self.conv.fold_stem = True  # see ShallowNet
        cfg = [  # (expansion, out_ch, repeats, stride)
            (1, 32, 1, 1),
            (6, 32, 1, 1),
            (6, 48, 3, 2),
            (6, 64, 3, 2),
            (6, 96, 2, 1),
            (6, 128, 2, 1),
        ]
        stages = []
        cin = 32
        for t, c, n, s in cfg:
            mods = [InvertedResidual(cin, c, expansion=t, stride=s)]
            mods += [InvertedResidual(c, c, expansion=t) for _ in range(n - 1)]
            stages.append(nn.Sequential(*mods))
            cin = c
        self.stages = nn.Sequential(*stages)
        self.tail = ConvBNAct(128, 128, 1, act="relu")

    def __call__(self, scope, x):
        x = scope("conv", self.conv, x)
        x = scope("stages", self.stages, x)
        return scope("tail", self.tail, x)


class FusionModule(nn.Module):
    def __init__(self, high_ch=128, low_ch=128, out_ch=128):
        self.low_dw = ConvBNAct(low_ch, low_ch, 3, groups=low_ch,
                                dilation=4, act="none")
        self.low_pw = ConvBNAct(low_ch, out_ch, 1, act="none")
        self.high_pw = ConvBNAct(high_ch, out_ch, 1, act="none")

    def __call__(self, scope, high, low):
        h, w = high.shape[1:3]
        low = R.resize_bilinear(low, (h, w))
        low = scope("low_dw", self.low_dw, low)
        low = scope("low_pw", self.low_pw, low)
        high = scope("high_pw", self.high_pw, high)
        return nn.relu(high + low)


@register("contextnet", "context_net")
class ContextNet(nn.Module):
    LOGITS_TAIL = "resize"
    def __init__(self, classes: int = 19, in_ch: int = 3):
        self.classes = classes
        self.shallow = ShallowNet(in_ch)
        self.deep = DeepNet(in_ch)
        self.fusion = FusionModule()
        self.ds1 = DSConv(128, 128)
        self.ds2 = DSConv(128, 128)
        self.drop = nn.Dropout(0.1)
        self.head = nn.Conv(128, classes, 1, bias=True)

    def logits_lowres(self, scope, x):
        """1/8-res logits (nn.Module.predict fuses the 8x upsample+argmax
        tail through ops.classify.resize_tail_argmax)."""
        h, w = x.shape[1:3]
        x_small = R.resize_bilinear(x, (h // 4, w // 4))
        high = scope("shallow", self.shallow, x)      # 1/8
        low = scope("deep", self.deep, x_small)       # 1/32 overall
        y = scope("fusion", self.fusion, high, low)
        y = scope("ds1", self.ds1, y)
        y = scope("ds2", self.ds2, y)
        y = scope("drop", self.drop, y)
        return scope("head", self.head, y)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        y = self.logits_lowres(scope, x)
        return R.resize_bilinear(y.astype(jnp.float32), (h, w)) \
            .astype(y.dtype)
