"""FPENet (Liu & Yin 2019, arXiv 1909.08599) — NHWC.

Reference counterpart: ``model/FPENet.py`` [R] (FPEBlock, MEUModule,
SEModule). ~0.38M params, paper 70.1 mIoU.

FPE block: 1x1 expand (t=4) -> split into 4 groups -> depthwise 3x3 with
dilations 1,2,4,8, each group's output added into the next (an in-block
feature pyramid / HFF) -> concat -> 1x1 project -> SE gate -> residual.
Decoder: MEU mutual-embedding upsample (channel attention from deep x
spatial attention from shallow).
"""
from __future__ import annotations

import os

import jax.numpy as jnp

from .. import nn
from ..ops import folding
from ..ops import pooling as P
from ..ops import resize as R
from .blocks import ConvBNAct, SEGate
from .registry import register


class FPEBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1,
                 t: int = 4, scales: int = 4, dilations=(1, 2, 4, 8),
                 reduction: int = 16):
        mid = out_ch * t
        assert mid % scales == 0
        self.scales = scales
        self.stride_ = stride
        self.in_ch = in_ch
        self.g = mid // scales
        self.expand = ConvBNAct(in_ch, mid, 1, stride=stride, act="relu")
        self.dws = [ConvBNAct(self.g, self.g, 3, dilation=d, groups=self.g,
                              act="relu") for d in dilations[:scales]]
        self.project = ConvBNAct(mid, out_ch, 1, act="none")
        self.se = SEGate(out_ch, reduction)
        self.use_res = (stride == 1 and in_ch == out_ch)
        self.act = nn.Fn(nn.relu)
        # Group-major folded execution (v2, default on): fold factors such
        # that each depthwise GROUP is one dense 128-lane tile (f*g = 128)
        # and the incoming tensor is fully folded (fin*in_ch = 128). The
        # strided blocks change fold factor across the conv, which is a
        # convolution on the folded tensors iff (stride*f) % fin == 0
        # (ops/s2d.general_folded_kernel). Decided at construction; the
        # call dispatches on the input's channel count, so the same block
        # still runs unfolded inputs through the plain path.
        f = 128 // self.g if self.g in (16, 32, 64) else 1
        fin = 128 // in_ch if in_ch in (16, 32, 64) else 1
        ok = (f > 1 and fin > 1
              and ((stride == 1 and fin == f)
                   or (stride == 2 and (2 * f) % fin == 0)))
        self.fold = f if ok else 1  # geometric eligibility only
        self.fold_in = fin

    def fold_now(self) -> int:
        """Effective fold factor: geometric eligibility (construction) x
        the ESN_TPU_FPE_FOLDED toggle, read at dispatch time like every
        other ESN_TPU_* flag (ADVICE r2)."""
        if os.environ.get("ESN_TPU_FPE_FOLDED", "1") == "0":
            return 1
        return self.fold

    def __call__(self, scope, x):
        fold = self.fold_now()
        if fold > 1 and x.shape[-1] == self.fold_in * self.in_ch:
            return self._folded2(scope, x, fold)
        f = 1
        # ESN_TPU_FOLD_DW default OFF: before the GPU port the shift-FMA
        # folded depthwise path was slower at inference than XLA's native
        # depthwise lowering — the 9-tap re-read pattern costs more
        # memory traffic than the padding it removes (not measured on the
        # H100). Kept as an exact, tested, opt-in alternative.
        if (os.environ.get("ESN_TPU_FOLD_DW", "0") == "1" and not scope.is_init
                and self.stride_ == 1):
            f = folding.fold_factor(self.g, x.shape[2])
        if f > 1:
            return self._folded(scope, x, f)
        y = scope("expand", self.expand, x)
        groups = [y[..., i * self.g:(i + 1) * self.g]
                  for i in range(self.scales)]
        outs = []
        prev = None
        for i, dw in enumerate(self.dws):
            inp = groups[i] if prev is None else groups[i] + prev
            prev = dw(scope.child(f"dw{i}"), inp)
            outs.append(prev)
        y = jnp.concatenate(outs, axis=-1)
        y = scope("project", self.project, y)
        y = scope("se", self.se, y)
        if self.use_res:
            y = x + y
        return nn.relu(y)

    def _folded(self, scope, x, f):
        """Lane-folded execution (ops.folding; CGBlock._folded rationale).
        The in-block feature pyramid runs depthwise 3x3 convs on g =
        mid/scales = 4-64 channel groups (reference model/FPENet.py
        FPEBlock [R]) — at g=4 that is 3% channel density. W folds
        into
        channels once; group slices come from the fold-layout reshape;
        dilations with f | d are slot-uniform, the rest take the
        mixed-slot slice path. Exact (tested)."""
        g, mid = self.g, self.g * self.scales

        def bnrelu(s, mod, y):
            y = mod.bn.folded_apply(s.child("bn"), y, f)
            return nn.relu(y)

        xf = folding.fold_w(x, f)
        es = scope.child("expand")
        w, b = self.expand.conv.params(es.child("conv"))
        y = folding.folded_conv2d(xf, w, f, bias=b)
        y = bnrelu(es, self.expand, y)

        bsz, h, q = y.shape[:3]
        y5 = y.reshape(bsz, h, q, f, mid)
        outs = []
        prev = None
        for i, dw in enumerate(self.dws):
            grp = y5[..., i * g:(i + 1) * g].reshape(bsz, h, q, f * g)
            inp = grp if prev is None else grp + prev
            ds = scope.child(f"dw{i}")
            wd, _ = dw.conv.params(ds.child("conv"))
            d = dw.conv.dilation if isinstance(dw.conv.dilation, tuple) \
                else (dw.conv.dilation,) * 2
            prev = folding.folded_depthwise_conv(
                inp, wd[:, :, 0], f, dilation=d,
                padding=(d[0], d[1]))
            prev = bnrelu(ds, dw, prev)
            outs.append(prev)
        # fold-layout concat: slot-major over the mid channels
        y = jnp.concatenate([o.reshape(bsz, h, q, f, g) for o in outs],
                            axis=-1).reshape(bsz, h, q, f * mid)
        ps = scope.child("project")
        wp, bp = self.project.conv.params(ps.child("conv"))
        y = folding.folded_conv2d(y, wp, f, bias=bp)
        y = self.project.bn.folded_apply(ps.child("bn"), y, f)
        y = self.se.folded_apply(scope.child("se"), y, f)
        if self.use_res:
            y = xf + y
        return folding.unfold_w(nn.relu(y), f)

    def _folded2(self, scope, x, f):
        """Group-major folded execution (v2, ESN_TPU_FPE_FOLDED, default).

        Input and output are W-folded (``ops.folding`` slot-major layout);
        the caller folds once per stage. Inside the block every tensor is a
        dense 128-lane tile:

        - the expand 1x1 splits by OUTPUT-channel group into ``scales``
          folded convs, each emitting one group directly — the mid-channel
          concat and its 4x-padded 32-ch slices (most of the HFF chain's
          time before the GPU port) never exist; BN runs per group via
          ``folded_slice_apply`` (exact);
        - each depthwise dilated 3x3 runs as ONE dense block-banded folded
          conv on the matrix unit (``depthwise_dense_kernel`` +
          ``folded_kernel``), which beat the mixed-slot shift-FMA before the
          GPU port;
        - the project 1x1 splits by INPUT-channel group (sum of per-group
          convs, f32 accumulation) so the concat stays virtual.

        Strided blocks consume a fold_in-folded input and emit an f-folded
        output via ``general_folded_conv``. Exact vs the plain path
        (tested); reference semantics: FPEBlock [R: model/FPENet.py].
        """
        from ..ops import s2d
        g, ns, s = self.g, self.scales, self.stride_
        fin = self.fold_in
        es = scope.child("expand")
        we, be = self.expand.conv.params(es.child("conv"))
        groups = []
        for i in range(ns):
            wi = we[:, :, :, i * g:(i + 1) * g]
            bi = None if be is None else be[i * g:(i + 1) * g]
            if s == 1:
                yi = folding.folded_conv2d(x, wi, f, bias=bi)
            else:
                yi = s2d.general_folded_conv(
                    x, wi, stride=(s, s), padding=(0, 0),
                    in_fold=(1, fin), out_fold_w=f, bias=bi)
            yi = self.expand.bn.folded_slice_apply(
                es.child("bn"), yi, f, i * g, (i + 1) * g)
            groups.append(nn.relu(yi))
        outs = []
        prev = None
        for i, dw in enumerate(self.dws):
            inp = groups[i] if prev is None else groups[i] + prev
            ds = scope.child(f"dw{i}")
            wd, _ = dw.conv.params(ds.child("conv"))
            d = dw.conv.dilation if isinstance(dw.conv.dilation, tuple) \
                else (dw.conv.dilation,) * 2
            # per-(f, d) lowering, tuned at both stage geometries before the
            # GPU port (not measured on the H100): banded wins everywhere but
            # at a wide span (U=9 at d=8, f=2), where the slot-uniform
            # shift-FMA path wins.
            u = d[1] * 2 // f + 1
            if d[1] % f == 0 and u >= 7:
                prev = folding.folded_depthwise_conv(
                    inp, wd[:, :, 0], f, dilation=d, padding=(d[0], d[1]))
            else:
                prev = folding.folded_conv2d(
                    inp, folding.depthwise_dense_kernel(wd), f,
                    dilation=d, padding=(d[0], d[1]))
            prev = nn.relu(dw.bn.folded_apply(ds.child("bn"), prev, f))
            outs.append(prev)
        ps = scope.child("project")
        wp, _ = self.project.conv.params(ps.child("conv"))
        acc = None
        for i, o in enumerate(outs):
            yi = folding.folded_conv2d(
                o, wp[:, :, i * g:(i + 1) * g, :], f).astype(jnp.float32)
            acc = yi if acc is None else acc + yi
        y = acc.astype(x.dtype)
        y = self.project.bn.folded_apply(ps.child("bn"), y, f)
        y = self.se.folded_apply(scope.child("se"), y, f)
        if self.use_res:
            y = x + y
        return nn.relu(y)


class MEU(nn.Module):
    """Mutual embedding upsample: deep features gated by shallow spatial
    attention; shallow features gated by deep channel attention; sum."""

    def __init__(self, deep_ch: int, shallow_ch: int, out_ch: int):
        self.deep_conv = ConvBNAct(deep_ch, out_ch, 1, act="none")
        self.shallow_conv = ConvBNAct(shallow_ch, out_ch, 1, act="none")
        self.chan_fc = nn.Conv(out_ch, out_ch, 1, bias=True)
        self.spat_conv = nn.Conv(1, 1, 1, bias=True)

    def __call__(self, scope, deep, shallow):
        d = scope("deep_conv", self.deep_conv, deep)
        s = scope("shallow_conv", self.shallow_conv, shallow)
        # channel attention from deep (GAP -> 1x1 -> sigmoid)
        ca = P.global_avg_pool(d)
        ca = nn.sigmoid(scope("chan_fc", self.chan_fc, ca))
        # spatial attention from shallow (channel-mean -> 1x1 -> sigmoid)
        sa = jnp.mean(s.astype(jnp.float32), axis=-1, keepdims=True)
        sa = nn.sigmoid(scope("spat_conv", self.spat_conv,
                              sa.astype(s.dtype)))
        d_up = R.resize_bilinear(d, s.shape[1:3])
        sa_d = d_up * sa          # deep modulated by shallow spatial attn
        ca_s = s * ca             # shallow modulated by deep channel attn
        return nn.relu(sa_d + ca_s)


@register("fpenet")
class FPENet(nn.Module):
    LOGITS_TAIL = "resize"
    def __init__(self, classes: int = 19, in_ch: int = 3, width: int = 16):
        w = width
        self.stem = ConvBNAct(in_ch, w, 3, stride=2, act="relu")     # 1/2
        self.stage1 = FPEBlock(w, w, t=1)
        self.down2 = FPEBlock(w, 2 * w, stride=2, t=4)               # 1/4
        # repeated FPE blocks run as lax.scan bodies (nn.ScanChain):
        # graph size becomes repeat-independent (shorter compiles)
        self.stage2 = nn.ScanChain(FPEBlock(2 * w, 2 * w, t=4), 2)
        self.down3 = FPEBlock(2 * w, 4 * w, stride=2, t=4)           # 1/8
        self.stage3 = nn.ScanChain(FPEBlock(4 * w, 4 * w, t=4), 8)
        self.meu2 = MEU(4 * w, 2 * w, 2 * w)
        self.meu1 = MEU(2 * w, w, w)
        self.head = nn.Conv(w, classes, 1, bias=True)

    def __call__(self, scope, x):
        h, w_ = x.shape[1:3]
        y = scope("head", self.head, self.features(scope, x))
        return R.resize_bilinear(y.astype(jnp.float32), (h, w_)) \
            .astype(y.dtype)

    def features(self, scope, x):
        """Decoder output at 1/2 res (the head conv's input).

        Group-major folded encoder (FPEBlock._folded2): fold once after
        stage1, stay folded through down2/stage2/down3/stage3, unfold at
        the decoder boundary (reshape-only). Engaged when every block
        opted in at construction and W folds evenly (s1 is at 1/2 res;
        s1.W % 8 covers the /4-res f=4 and /8-res f=2 folds too)."""
        s1 = scope("stage1", self.stage1, scope("stem", self.stem, x))
        # fold factors derived from the blocks (not hardcoded for width=16):
        # stage1's output folds by down2's expected input fold; each stage
        # output unfolds by that stage's own fold factor
        fin = self.down2.fold_in
        if (self.down2.fold_now() > 1 and self.stage2.block.fold_now() > 1
                and self.stage3.block.fold_now() > 1
                and s1.shape[2] % fin == 0):
            t = scope("down2", self.down2, folding.fold_w(s1, fin))
            s2f = scope("stage2", self.stage2, t)
            t = scope("down3", self.down3, s2f)
            s3f = scope("stage3", self.stage3, t)
            s2 = folding.unfold_w(s2f, self.stage2.block.fold)
            s3 = folding.unfold_w(s3f, self.stage3.block.fold)
        else:
            s2 = scope("stage2", self.stage2, scope("down2", self.down2, s1))
            s3 = scope("stage3", self.stage3, scope("down3", self.down3, s2))
        y = scope("meu2", self.meu2, s3, s2)       # 1/4
        return scope("meu1", self.meu1, y, s1)     # 1/2

    def predict(self, scope, x):
        """Fused prediction tail (ops.classify.resize2x_head_argmax): the head
        sits at 1/2 res, so the default argmax(resize(logits)) tail
        materializes full-res class logits. The fused (bilinear x head) phase
        conv computes argmax at half res and interleaves indices; full-res
        logits never exist. bf16 caveat: same math, different f32 association —
        argmax can differ at near-tie pixels (both are valid roundings)."""
        from ..ops import classify as CL
        if (x.shape[1] % 2 or x.shape[2] % 2
                or os.environ.get("ESN_TPU_FUSED_PREDICT", "1") == "0"):
            return super().predict(scope, x)
        y = self.features(scope, x)
        hs = scope.child("head")
        wh, bh = self.head.params(hs)
        out = CL.resize2x_head_argmax(y, wh, bh, argmax_tail="resize")
        if out is None:
            logits = self.head(hs, y)
            logits = R.resize_bilinear(
                logits.astype(jnp.float32), x.shape[1:3]).astype(y.dtype)
            return CL.argmax_lastdim(logits, tail="resize")
        return out
