"""ESPNet (Mehta et al. 2018, arXiv 1803.06815 — PAPERS.md) — NHWC.

Reference counterpart: ``model/ESPNet.py`` [R] (CBR/BR/C/CDilated,
DownSamplerB, DilatedParllelResidualBlockB, InputProjectionA,
ESPNet_Encoder, ESPNet). ~0.36M params, paper 60.3 mIoU.

ESP module: 1x1 reduce to n/K -> K parallel dilated 3x3 (d=1,2,4,8,16) ->
**hierarchical feature fusion** (cumulative sums de-grid the dilated
outputs) -> concat (+ residual). Encoder = ESPNet-C with input reinjections;
the full ESPNet adds a light transposed-conv decoder with level-wise skips.
"""
from __future__ import annotations

import os

import jax.numpy as jnp

from .. import nn
from ..ops import resize as R
from ..ops.convolution import conv2d
from .blocks import BNAct, ConvBNAct, InputInjection, subpixel_predict_tail
from .registry import register

BN_EPS = 1e-3


class ESPModule(nn.Module):
    """K-way dilated spatial pyramid with HFF; residual when shapes allow."""

    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1, k: int = 5,
                 residual: bool = True, fused_hff: bool = False):
        d = out_ch // k
        d1 = out_ch - d * (k - 1)  # first branch absorbs the remainder
        self.k = k
        self.fused_hff = fused_hff
        self.reduce = nn.Conv(in_ch, d, 3 if stride == 2 else 1,
                              stride=stride,
                              padding=1 if stride == 2 else 0, bias=False)
        self.branches = []
        for i in range(k):
            dil = 2 ** i
            out = d1 if i == 0 else d
            self.branches.append(nn.Conv(d, out, 3, padding=dil,
                                         dilation=dil, bias=False))
        self.post = BNAct(out_ch, act="prelu", bn_eps=BN_EPS)
        self.residual = residual and stride == 1 and in_ch == out_ch

    def __call__(self, scope, x):
        # per-model default (ctor): ON everywhere since the ScanChain rewrite
        # keeps the tiled-kernel graph small (tuned before the GPU port; not
        # measured on the H100).
        # Env forces: 1 = on, 0 = off.
        mode = os.environ.get("ESN_TPU_ESP_FUSED_HFF", "")
        on = self.fused_hff if mode == "" else mode == "1"
        # reduce-fold experiment: when the reduce is 1x1/s1 and the input is a
        # plain tensor, compose reduce INTO the branch kernels (reduce has no
        # BN/act before the branches — purely linear, exact; f64 parity test).
        # Hypothesis was that killing the lane-padded d~25-ch reduced tensor
        # beats the 5x dense-K flops. It was wrong before the GPU port, where
        # espnet_c slowed down (not measured on the H100) — default OFF, kept
        # as an env-gated experiment (ESN_TPU_ESP_FOLD_REDUCE=1).
        fold = (on and not scope.is_init
                and not isinstance(x, (list, tuple))
                and tuple(self.reduce.kernel) == (1, 1)
                and os.environ.get("ESN_TPU_ESP_FOLD_REDUCE", "0") == "1")
        if fold:
            # params still created by the unfused path at init time
            return self._finish(scope, x, self._fused_hff(
                scope, x, fold_reduce=True))
        if isinstance(x, (list, tuple)):
            # virtual-concat input (raw-input injection / skip concats):
            # the reduce conv splits its kernel over the pieces instead of
            # materializing a lane-hostile 19/131-ch concat — same exact
            # rewrite as CGNet's injections (nn.Conv.pieces_apply)
            assert not self.residual
            y = self.reduce.pieces_apply(scope.child("reduce"), x)
        else:
            y = scope("reduce", self.reduce, x)
        if on and not scope.is_init:
            y = self._fused_hff(scope, y)
        else:
            outs = [scope(f"d{i}", b, y)
                    for i, b in enumerate(self.branches)]
            # hierarchical feature fusion: prefix-sum the dilated outputs
            fused = [outs[0]]
            acc = outs[1] if self.k > 1 else None
            for i in range(1, self.k):
                acc = outs[i] if i == 1 else acc + outs[i]
                fused.append(acc)
            y = jnp.concatenate(fused, axis=-1)
        return self._finish(scope, x, y)

    def _finish(self, scope, x, y):
        if self.residual:
            y = y + x
        return scope("post", self.post, y)

    def _fused_hff(self, scope, y, fold_reduce=False):
        """HFF + concat folded into the branch kernels.

        The reference computes K narrow dilated convs (d_out = 12-28 ch),
        prefix-sums them (HFF de-gridding [R: model/ESPNet.py
        DilatedParllelResidualBlockB]) and concatenates. On a 128-wide
        matrix unit a 25-channel conv output wastes 4/5 of the result
        tile, and the prefix chain + concat are extra memory round
        trips. Because everything
        between the branch convs and the BN is linear, the concat of
        prefix sums IS a sum of K full-width convs whose kernels place the
        branch kernel in every concat block it reaches (branch 0 -> block
        0; branch j>=1 -> blocks j..K-1). Same math, re-associated: each
        conv runs with a dense 128-lane N dimension and the HFF/concat
        vanish into the adds. Exact (tested, fp32); ~(K+1)/2 x nominal
        FLOPs on ops that were N-padding-bound anyway.
        """
        blocks = []        # per-branch output channel ranges in the concat
        off = 0
        for b in self.branches:
            blocks.append((off, off + b.out_ch))
            off += b.out_ch
        out_ch = off
        wr2 = None
        if fold_reduce:
            # ``y`` here is the MODULE input; compose the 1x1 reduce into
            # each branch kernel (linear ∘ linear — exact):
            # K_eff[k,l,a,o] = Σ_m Wr[a,m] · Wbr[k,l,m,o]
            wr, _ = self.reduce.params(scope.child("reduce"))
            wr2 = wr[0, 0]                        # (in_ch, d)
        acc = None
        for j, br in enumerate(self.branches):
            w, _ = br.params(scope.child(f"d{j}"))
            if wr2 is not None:
                w = jnp.einsum("am,klmo->klao", wr2, w)
            lo = blocks[j][0]
            hi = out_ch if j >= 1 else blocks[0][1]
            # place the branch kernel into concat blocks [lo, hi) — for
            # j >= 1 the kernel repeats in every downstream block (the
            # prefix sums), realized by tiling along O
            reps = (hi - lo) // br.out_ch
            wj = jnp.concatenate(
                [jnp.zeros(w.shape[:3] + (lo,), w.dtype),
                 jnp.tile(w, (1, 1, 1, reps)),
                 jnp.zeros(w.shape[:3] + (out_ch - hi,), w.dtype)], axis=-1)
            d = br.dilation if isinstance(br.dilation, tuple) \
                else (br.dilation,) * 2
            p = br.padding if isinstance(br.padding, tuple) \
                else (br.padding,) * 2
            term = conv2d(y, wj, stride=(1, 1), padding=p, dilation=d,
                          groups=1)
            acc = term if acc is None else acc + term
        return acc


@register("espnet_c", "espnetc")
class ESPNetC(nn.Module):
    """Encoder-only variant with a 1x1 classifier (ESPNet-C [R])."""

    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3, alpha2: int = 2,
                 alpha3: int = 8, fused_hff: bool = True):
        fh = fused_hff
        self.stem = ConvBNAct(in_ch, 16, 3, stride=2, act="prelu",
                              bn_eps=BN_EPS)
        self.inj1 = InputInjection(1)
        self.inj2 = InputInjection(2)
        self.b1 = BNAct(16 + in_ch, act="prelu", bn_eps=BN_EPS)
        self.down1 = ESPModule(16 + in_ch, 64, stride=2, residual=False,
                               fused_hff=fh)
        # identical repeated ESP modules run as ONE lax.scan body
        # (nn.ScanChain, same treatment as CGNet's stages): graph size
        # becomes depth-independent, which keeps the full-res eval graph
        # and its compile time small
        self.level2 = nn.ScanChain(ESPModule(64, 64, fused_hff=fh), alpha2)
        self.b2 = BNAct(128 + in_ch, act="prelu", bn_eps=BN_EPS)
        self.down2 = ESPModule(128 + in_ch, 128, stride=2, residual=False,
                               fused_hff=fh)
        self.level3 = nn.ScanChain(ESPModule(128, 128, fused_hff=fh),
                                   alpha3)
        self.b3 = BNAct(256, act="prelu", bn_eps=BN_EPS)
        self.head = nn.Conv(256, classes, 1, bias=False)

    def encode(self, scope, x):
        """Returns (l1, l2, l3) feature pyramid. l1/l2 ride as VIRTUAL
        concats (lists of pieces): BN/PReLU slice their per-channel params
        and every consumer (the down ESP reduce convs here, the decoder
        proj convs in ESPNet) splits its kernel over the pieces — exact,
        and the misaligned 19/131-ch tensors never exist (the same
        rewrite as CGNet's)."""
        i1 = scope("inj1", self.inj1, x)
        i2 = scope("inj2", self.inj2, x)
        s = scope("stem", self.stem, x)                       # 1/2
        f1 = self.b1.pieces_apply(scope.child("b1"), [s, i1])     # 19
        d1 = scope("down1", self.down1, f1)                   # 1/4, 64
        l2 = scope("level2", self.level2, d1)
        f2 = self.b2.pieces_apply(scope.child("b2"),
                                  [l2, d1, i2])                # 131
        d2 = scope("down2", self.down2, f2)                   # 1/8, 128
        l3 = scope("level3", self.level3, d2)
        f3 = scope("b3", self.b3, jnp.concatenate([l3, d2], -1))  # 256
        return f1, f2, f3

    def logits_lowres(self, scope, x):
        """1/8-res logits (nn.Module.predict fuses the 8x upsample+argmax
        tail through ops.classify.resize_tail_argmax)."""
        _, _, f3 = self.encode(scope, x)
        return scope("head", self.head, f3)

    def __call__(self, scope, x):
        h, w = x.shape[1:3]
        y = self.logits_lowres(scope, x)
        return R.resize_bilinear(y.astype(jnp.float32), (h, w)) \
            .astype(y.dtype)


@register("espnet")
class ESPNet(nn.Module):
    """ESPNet-C + light decoder with level-wise skips [R: ESPNet]."""

    def __init__(self, classes: int = 19, in_ch: int = 3, alpha2: int = 2,
                 alpha3: int = 8):
        self.enc = ESPNetC(classes, in_ch, alpha2, alpha3, fused_hff=True)
        c = classes
        self.proj3 = ConvBNAct(256, c, 1, act="prelu", bn_eps=BN_EPS)
        self.up3 = nn.ConvTranspose(c, c, 2, stride=2, bias=False)
        self.proj2 = ConvBNAct(128 + in_ch, c, 1, act="prelu", bn_eps=BN_EPS)
        self.mix2 = ESPModule(2 * c, 2 * c, residual=False, k=4,
                              fused_hff=True)
        self.up2 = nn.ConvTranspose(2 * c, c, 2, stride=2, bias=False)
        self.proj1 = ConvBNAct(16 + in_ch, c, 1, act="prelu", bn_eps=BN_EPS)
        self.mix1 = ConvBNAct(2 * c, c, 3, act="prelu", bn_eps=BN_EPS)
        self.up1 = nn.ConvTranspose(c, c, 2, stride=2, bias=False)

    def features(self, scope, x):
        # f1/f2 arrive as virtual concats (see ESPNetC.encode); with
        # ESN_TPU_ESPNET_PIECES=1 the proj convs split their kernels over
        # the pieces and the decoder skip concats ride as pieces into
        # mix2's reduce / mix1's conv. Default OFF for the decoder: the
        # piece convs add graph nodes, and materializing the decoder
        # concats was faster before the GPU port (not measured on the H100; the
        # encoder's own injections stay virtual inside ESPNetC).
        f1, f2, f3 = self.enc.encode(scope.child("enc"), x)
        pieces = os.environ.get("ESN_TPU_ESPNET_PIECES", "0") == "1"
        if not pieces:
            f1 = jnp.concatenate(f1, -1)
            f2 = jnp.concatenate(f2, -1)
        y = scope("proj3", self.proj3, f3)                # 1/8, C
        y = scope("up3", self.up3, y)                     # 1/4
        s2 = (self.proj2.pieces_apply(scope.child("proj2"), f2) if pieces
              else scope("proj2", self.proj2, f2))
        y = scope("mix2", self.mix2,
                  [y, s2] if pieces else jnp.concatenate([y, s2], -1))
        y = scope("up2", self.up2, y)                     # 1/2
        s1 = (self.proj1.pieces_apply(scope.child("proj1"), f1) if pieces
              else scope("proj1", self.proj1, f1))
        y = (self.mix1.pieces_apply(scope.child("mix1"), [y, s1]) if pieces
             else scope("mix1", self.mix1, jnp.concatenate([y, s1], -1)))
        return y                  # 1/1, C

    def __call__(self, scope, x):
        return scope("up1", self.up1,
                     self.features(scope, x))

    def predict(self, scope, x):
        """Fused prediction head — see blocks.subpixel_predict_tail."""
        return subpixel_predict_tail(self.up1,
                                     scope.child("up1"),
                                     self.features(scope, x))
