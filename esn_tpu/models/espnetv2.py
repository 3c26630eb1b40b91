"""ESPNetv2 segmentation (Mehta et al. 2019, arXiv 1811.11431 — PAPERS.md).

Reference counterpart: ``model/ESPNet_v2/`` [R] (EESP, DownSampler, EESPNet,
EESPNet_Seg; ~700 LoC dir). ~0.8M params (seg), paper 66.2 mIoU.

EESP unit: grouped 1x1 reduce -> K depthwise **dilated** 3x3 (d=1,2,4,8) ->
HFF prefix-sum de-gridding -> concat -> grouped 1x1 expand -> residual.
Strided EESP concatenates an avg-pooled copy of the unit input and adds a
reinjection of the avg-pooled *raw image* (the v2 signature move).
Seg head: PSP-style pooling on the deepest level + EESP fusion with the
1/8 skip, classes at 1/8, x8 bilinear.
"""
from __future__ import annotations

import os

import jax.numpy as jnp

from .. import nn
from ..ops import folding
from ..ops import pooling as P
from ..ops import resize as R
from .blocks import BNAct, ConvBNAct, PyramidPooling
from .registry import register

BN_EPS = 1e-3


class EESP(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1,
                 k: int = 4, groups: int = 4, residual: bool = True):
        d = max(out_ch // k, 1)
        rem = out_ch - d * (k - 1)
        self.k = k
        g = groups if (in_ch % groups == 0 and d % groups == 0) else 1
        self.reduce = ConvBNAct(in_ch, d, 1, groups=g, act="prelu",
                                bn_eps=BN_EPS)
        self.branches = []
        for i in range(k):
            dil = 2 ** i
            out = rem if i == k - 1 else d
            self.branches.append(nn.Conv(d, out, 3, padding=dil,
                                         dilation=dil, groups=d if out % d == 0
                                         else 1, bias=False))
        self.concat_bn = BNAct(out_ch, act="prelu", bn_eps=BN_EPS)
        ge = groups if out_ch % groups == 0 else 1
        self.expand = ConvBNAct(out_ch, out_ch, 1, groups=ge, act="none",
                                bn_eps=BN_EPS)
        self.stride = stride
        self.residual = residual and stride == 1 and in_ch == out_ch
        self.act = nn.PReLU(out_ch)

    def __call__(self, scope, x):
        y = scope("reduce", self.reduce, x)
        if self.stride == 2:
            y = P.avg_pool2d(y, 3, 2, 1)
        f = 1
        # ESN_TPU_FOLD_DW default OFF: before the GPU port the shift-FMA
        # folded depthwise path was slower at inference than XLA's native
        # depthwise lowering — the 9-tap re-read pattern costs more
        # memory traffic than the padding it removes (not measured on the
        # H100). Kept as an exact, tested, opt-in alternative.
        if (os.environ.get("ESN_TPU_FOLD_DW", "0") == "1" and not scope.is_init
                and all(b.groups == b.in_ch == b.out_ch
                        for b in self.branches)):
            f = folding.fold_factor(self.branches[0].in_ch, y.shape[2])
        if f > 1:
            y = self._folded_branches(scope, y, f)
        else:
            outs = [scope(f"d{i}", b, y) for i, b in enumerate(self.branches)]
            fused, acc = [outs[0]], None
            for i in range(1, self.k):
                acc = outs[i] if i == 1 else acc + outs[i]
                fused.append(acc)
            y = jnp.concatenate(fused, axis=-1)
            y = scope("concat_bn", self.concat_bn, y)
        y = scope("expand", self.expand, y)
        if self.residual:
            y = y + x
        return scope("act", self.act, y)

    def _folded_branches(self, scope, y, f):
        """Lane-folded branch sector (ops.folding; CGBlock._folded
        rationale): the k depthwise dilated 3x3 branches run on d =
        out_ch/k = 8-64 channels (reference EESP in
        model/ESPNet_v2/Model.py [R]) — up to 94% channel padding. W
        folds once; branches, HFF additive fusion and concat-BN run at
        full density; the grouped 1x1s stay unfolded. Exact (tested)."""
        d = self.branches[0].in_ch
        yf = folding.fold_w(y, f)
        outs = []
        for i, br in enumerate(self.branches):
            wb, _ = br.params(scope.child(f"d{i}"))
            dil = br.dilation if isinstance(br.dilation, tuple) \
                else (br.dilation,) * 2
            outs.append(folding.folded_depthwise_conv(
                yf, wb[:, :, 0], f, dilation=dil,
                padding=(dil[0], dil[1])))
        fused, acc = [outs[0]], None
        for i in range(1, self.k):
            acc = outs[i] if i == 1 else acc + outs[i]
            fused.append(acc)
        bsz, h, q = yf.shape[:3]
        z = jnp.concatenate([o.reshape(bsz, h, q, f, d) for o in fused],
                            axis=-1).reshape(bsz, h, q, f * self.k * d)
        cs = scope.child("concat_bn")
        z = self.concat_bn.bn.folded_apply(cs.child("bn"), z, f)
        z = self.concat_bn.act.folded_apply(cs.child("act"), z, f)
        return folding.unfold_w(z, f)


class StridedEESP(nn.Module):
    """stride-2 EESP || avg-pool(input) concat, + raw-image reinjection."""

    def __init__(self, in_ch: int, out_ch: int, *, k: int = 4,
                 groups: int = 4, in_image_ch: int = 3):
        eesp_out = out_ch - in_ch
        assert eesp_out > 0
        self.eesp = EESP(in_ch, eesp_out, stride=2, k=k, groups=groups,
                         residual=False)
        self.img_conv = nn.Sequential(
            ConvBNAct(in_image_ch, in_image_ch, 3, act="prelu",
                      bn_eps=BN_EPS),
            ConvBNAct(in_image_ch, out_ch, 1, act="none", bn_eps=BN_EPS))
        self.act = nn.PReLU(out_ch)

    def __call__(self, scope, x, image):
        main = scope("eesp", self.eesp, x)
        pooled = P.avg_pool2d(x, 3, 2, 1)
        y = jnp.concatenate([main, pooled], axis=-1)
        img = R.resize_bilinear(image, y.shape[1:3])
        y = y + scope("img_conv", self.img_conv, img)
        return scope("act", self.act, y)


@register("espnetv2", "espnet_v2", "eespnet_seg")
class ESPNetV2Seg(nn.Module):
    LOGITS_TAIL = "resize"
    def __init__(self, classes: int = 19, in_ch: int = 3,
                 chs=(32, 128, 256, 512), repeats=(3, 7, 3)):
        # default channel stack matches the reference's s=2.0 EESPNet [R]
        c0, c1, c2, c3 = chs
        self.stem = ConvBNAct(in_ch, c0, 3, stride=2, act="prelu",
                              bn_eps=BN_EPS)                    # 1/2
        # identical repeated EESP units run as lax.scan bodies
        # (nn.ScanChain): graph size becomes repeat-independent
        self.down1 = StridedEESP(c0, c1)                        # 1/4
        self.level1 = nn.ScanChain(EESP(c1, c1), repeats[0])
        self.down2 = StridedEESP(c1, c2)                        # 1/8
        self.level2 = nn.ScanChain(EESP(c2, c2), repeats[1])
        self.down3 = StridedEESP(c2, c3)                        # 1/16
        self.level3 = nn.ScanChain(EESP(c3, c3), repeats[2])

        self.psp = PyramidPooling(c3, c2 // 2, act="relu")
        self.proj_l2 = ConvBNAct(c2, c2 // 2, 1, act="prelu", bn_eps=BN_EPS)
        self.fuse = EESP(c2, c2 // 2, residual=False)
        self.head = nn.Conv(c2 // 2, classes, 1, bias=False)

    def logits_lowres(self, scope, x):
        """1/8-res logits (nn.Module.predict fuses the 8x upsample+argmax
        tail through ops.classify.resize_tail_argmax)."""
        y = scope("stem", self.stem, x)
        y = scope("down1", self.down1, y, x)
        y = scope("level1", self.level1, y)
        y = scope("down2", self.down2, y, x)
        l2 = scope("level2", self.level2, y)                   # 1/8, 128
        y = scope("down3", self.down3, l2, x)
        y = scope("level3", self.level3, y)                    # 1/16, 256
        y = scope("psp", self.psp, y)                          # 1/16, 128
        y = R.resize_bilinear(y, l2.shape[1:3])                # 1/8
        s = scope("proj_l2", self.proj_l2, l2)
        y = scope("fuse", self.fuse, jnp.concatenate([y, s], -1))
        return scope("head", self.head, y)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        y = self.logits_lowres(scope, x)
        return R.resize_bilinear(y.astype(jnp.float32), (h, w)) \
            .astype(y.dtype)
