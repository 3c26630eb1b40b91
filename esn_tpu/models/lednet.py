"""LEDNet (Wang et al. 2019, arXiv 1905.02423) — NHWC.

Reference counterpart: ``model/LEDNet.py`` [R] (SS_nbt_module,
DownsamplerBlock, channel_shuffle, APN_Module). ~0.94M params, paper 70.6.

Encoder: split-shuffle non-bottleneck units (channel split, dual factorized
branches with dilation, concat, residual, channel shuffle); decoder: APN
attention pyramid (3/5/7 kernel cascade + GAP branch) at 1/8 emitting class
scores, x8 bilinear.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .. import nn
from ..nn.layers import _pair
from ..ops import folding
from ..ops import pooling as P
from ..ops import resize as R
from .blocks import (BNAct, ConvBNAct, DownsamplerConcat, channel_shuffle,
                     channel_split)
from .registry import register

BN_EPS = 1e-3


class SSnbt(nn.Module):
    """Split-shuffle non-bottleneck: each half gets factorized convs (one
    half (3x1)(1x3), the other (1x3)(3x1)) + a dilated factorized pair."""

    def __init__(self, ch: int, dilation: int = 1, dropout: float = 0.0):
        half = ch // 2
        self.half = half
        d = dilation
        self.d = d
        self.l1 = nn.Conv(half, half, (3, 1), padding=(1, 0), bias=True)
        self.l2 = nn.Conv(half, half, (1, 3), padding=(0, 1), bias=True)
        self.l_bn1 = BNAct(half, act="relu", bn_eps=BN_EPS)
        self.l3 = nn.Conv(half, half, (3, 1), padding=(d, 0),
                          dilation=(d, 1), bias=True)
        self.l4 = nn.Conv(half, half, (1, 3), padding=(0, d),
                          dilation=(1, d), bias=True)
        self.l_bn2 = nn.BatchNorm(half, eps=BN_EPS)

        self.r1 = nn.Conv(half, half, (1, 3), padding=(0, 1), bias=True)
        self.r2 = nn.Conv(half, half, (3, 1), padding=(1, 0), bias=True)
        self.r_bn1 = BNAct(half, act="relu", bn_eps=BN_EPS)
        self.r3 = nn.Conv(half, half, (1, 3), padding=(0, d),
                          dilation=(1, d), bias=True)
        self.r4 = nn.Conv(half, half, (3, 1), padding=(d, 0),
                          dilation=(d, 1), bias=True)
        self.r_bn2 = nn.BatchNorm(half, eps=BN_EPS)
        self.drop = nn.SpatialDropout(dropout)

    def __call__(self, scope, x):
        f = 1
        if os.environ.get("ESN_TPU_FOLD", "1") != "0" and not scope.is_init:
            f = folding.fold_factor(self.half, x.shape[2])
            if not folding.fold_worthwhile(3, self.d, f):
                f = 1
        if f > 1:
            return self._folded(scope, x, f)
        left, right = channel_split(x)
        l = nn.relu(scope("l1", self.l1, left))
        l = scope("l_bn1", self.l_bn1, scope("l2", self.l2, l))
        l = nn.relu(scope("l3", self.l3, l))
        l = scope("l_bn2", self.l_bn2, scope("l4", self.l4, l))

        r = nn.relu(scope("r1", self.r1, right))
        r = scope("r_bn1", self.r_bn1, scope("r2", self.r2, r))
        r = nn.relu(scope("r3", self.r3, r))
        r = scope("r_bn2", self.r_bn2, scope("r4", self.r4, r))

        y = jnp.concatenate([l, r], axis=-1)
        y = scope("drop", self.drop, y)
        y = nn.relu(x + y)
        return channel_shuffle(y, 2)

    def _folded(self, scope, x, f):
        """Lane-folded halves (ops.folding): each 16-64ch factorized branch
        runs 128-lane dense. Exact vs the plain path incl. the dropout mask
        (drawn once at full width and split, as the plain path does)."""
        def conv(m, name, y, relu_after=False):
            w, b = m.params(scope.child(name))
            y = folding.folded_conv2d(y, w, f, dilation=_pair(m.dilation),
                                      padding=_pair(m.padding), bias=b)
            return nn.relu(y) if relu_after else y

        def bnact(m, name, y):
            s = scope.child(name)
            y = m.bn.folded_apply(s.child("bn"), y, f)
            if m.act is not None:
                y = m.act.folded_apply(s.child("act"), y, f) \
                    if isinstance(m.act, nn.PReLU) else m.act(s.child("act"), y)
            return y

        left, right = channel_split(x)
        lf, rf = folding.fold_w(left, f), folding.fold_w(right, f)

        l = conv(self.l1, "l1", lf, relu_after=True)
        l = bnact(self.l_bn1, "l_bn1", conv(self.l2, "l2", l))
        l = conv(self.l3, "l3", l, relu_after=True)
        l = self.l_bn2.folded_apply(scope.child("l_bn2"),
                                    conv(self.l4, "l4", l), f)

        r = conv(self.r1, "r1", rf, relu_after=True)
        r = bnact(self.r_bn1, "r_bn1", conv(self.r2, "r2", r))
        r = conv(self.r3, "r3", r, relu_after=True)
        r = self.r_bn2.folded_apply(scope.child("r_bn2"),
                                    conv(self.r4, "r4", r), f)

        if scope.train and self.drop.rate > 0.0 and not scope.is_init:
            # one full-width mask split in half — bit-identical to the plain
            # path's single draw on the concatenated tensor
            keep = 1.0 - self.drop.rate
            n = x.shape[0]
            mask = jax.random.bernoulli(
                scope.child("drop").make_rng("dropout"), keep,
                (n, 1, 1, 2 * self.half))
            ml = jnp.tile(mask[..., :self.half], (1, 1, 1, f))
            mr = jnp.tile(mask[..., self.half:], (1, 1, 1, f))
            l = jnp.where(ml, l / keep, 0.0).astype(l.dtype)
            r = jnp.where(mr, r / keep, 0.0).astype(r.dtype)

        l = folding.unfold_w(nn.relu(lf + l), f)
        r = folding.unfold_w(nn.relu(rf + r), f)
        return channel_shuffle(jnp.concatenate([l, r], axis=-1), 2)


class APN(nn.Module):
    """Attention pyramid network head at 1/8 resolution -> classes ch."""

    def __init__(self, in_ch: int, classes: int):
        # the pyramid collapses to class channels immediately — that is what
        # keeps LEDNet at ~1M params despite 7x7/5x5 kernels
        c = classes
        self.down1 = ConvBNAct(in_ch, c, 7, stride=2, act="relu",
                               bn_eps=BN_EPS)   # 1/16
        self.down2 = ConvBNAct(c, c, 5, stride=2, act="relu",
                               bn_eps=BN_EPS)   # 1/32
        self.down3 = ConvBNAct(c, c, 3, stride=2, act="relu",
                               bn_eps=BN_EPS)   # 1/64
        self.lvl2 = ConvBNAct(c, c, 5, act="relu", bn_eps=BN_EPS)
        self.lvl1 = ConvBNAct(c, c, 7, act="relu", bn_eps=BN_EPS)
        self.main = ConvBNAct(in_ch, c, 1, act="relu", bn_eps=BN_EPS)
        self.glob = ConvBNAct(in_ch, c, 1, act="none", bn=False, bias=True)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        d1 = scope("down1", self.down1, x)            # 1/16
        d2 = scope("down2", self.down2, d1)           # 1/32
        d3 = scope("down3", self.down3, d2)           # 1/64, classes
        p = R.resize_bilinear(d3, d2.shape[1:3]) + scope("lvl2", self.lvl2, d2)
        p = R.resize_bilinear(p, d1.shape[1:3]) + scope("lvl1", self.lvl1, d1)
        p = R.resize_bilinear(p, (h, w))
        main = scope("main", self.main, x) * p        # attention-weighted
        g = P.global_avg_pool(x)                      # (N,1,1,C)
        g = scope("glob", self.glob, g)
        return main + g


@register("lednet")
class LEDNet(nn.Module):
    LOGITS_TAIL = "resize"
    def __init__(self, classes: int = 19, in_ch: int = 3):
        # repeated SS-nbt stacks run as lax.scan bodies (nn.ScanChain);
        # the (2,5,9) dilation pattern repeats twice, so it scans a
        # 3-block Sequential pattern (dilations static inside the body)
        self.encoder = nn.Sequential(
            DownsamplerConcat(in_ch, 32, act="relu", bn_eps=BN_EPS),
            nn.ScanChain(SSnbt(32, 1, 0.03), 3, eval_unroll=True),
            DownsamplerConcat(32, 64, act="relu", bn_eps=BN_EPS),
            nn.ScanChain(SSnbt(64, 1, 0.03), 2, eval_unroll=True),
            DownsamplerConcat(64, 128, act="relu", bn_eps=BN_EPS),
            SSnbt(128, 1, 0.3),
            nn.ScanChain(nn.Sequential(SSnbt(128, 2, 0.3),
                                       SSnbt(128, 5, 0.3),
                                       SSnbt(128, 9, 0.3)), 2,
                         eval_unroll=True),
            SSnbt(128, 17, 0.3))
        self.apn = APN(128, classes)

    def logits_lowres(self, scope, x):
        """1/8-res logits (nn.Module.predict fuses the 8x upsample+argmax
        tail through ops.classify.resize_tail_argmax)."""
        y = scope("encoder", self.encoder, x)     # 1/8
        return scope("apn", self.apn, y)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        y = self.logits_lowres(scope, x)
        return R.resize_bilinear(y.astype(jnp.float32), (h, w)) \
            .astype(y.dtype)
