"""``losses.resize_cross_entropy`` — the scanned upsample+CE loss tail —
against cross-entropy over materialised bilinear logits (value and
gradient), a float64 numpy oracle, and the all-ignored edge case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esn_tpu.ops.resize import resize_bilinear
from esn_tpu.train.losses import cross_entropy, resize_cross_entropy

CASES = [
    # (B, h, w, C, r, eps, weighted)
    (2, 8, 16, 19, 8, 0.0, True),    # production-like incl. class weights
    (1, 4, 8, 5, 8, 0.1, False),     # label smoothing
    (1, 8, 8, 11, 4, 0.0, True),     # r=4
    (2, 16, 32, 19, 2, 0.1, True),   # many rows at a small factor
    (1, 24, 16, 19, 8, 0.0, True),   # tall
]


@pytest.mark.parametrize("B,h,w,C,r,eps,weighted", CASES)
def test_resize_ce_value_and_grad_match_materialized(B, h, w, C, r, eps,
                                                     weighted):
    rng = np.random.RandomState(B * h + C)
    z = jnp.asarray(rng.randn(B, h, w, C), jnp.float32)
    lab = rng.randint(0, C + 1, (B, h * r, w * r)).astype(np.int32)
    lab[lab == C] = 255                      # sprinkle ignore pixels
    lab = jnp.asarray(lab)
    cw = jnp.asarray(rng.rand(C) + 0.5, jnp.float32) if weighted else None

    def ref_loss(zz):
        full = resize_bilinear(zz.astype(jnp.float32), (h * r, w * r))
        return cross_entropy(full, lab, num_classes=C, class_weights=cw,
                             ignore_index=255, label_smoothing=eps)

    def new_loss(zz):
        return resize_cross_entropy(zz, lab, num_classes=C, class_weights=cw,
                                    ignore_index=255, label_smoothing=eps)

    l0, g0 = jax.value_and_grad(ref_loss)(z)
    l1, g1 = jax.value_and_grad(new_loss)(z)
    assert abs(float(l0 - l1)) < 1e-4, (float(l0), float(l1))
    rel = float(jnp.linalg.norm(g0 - g1) / jnp.linalg.norm(g0))
    assert rel < 1e-4, rel


def _expand(n, r):
    """(n, r*n) half-pixel bilinear upsampling matrix, edge taps clamped."""
    m = np.zeros((n, r * n))
    for o in range(r * n):
        src = (o + 0.5) / r - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        m[min(max(i0, 0), n - 1), o] += 1 - t
        m[min(max(i0 + 1, 0), n - 1), o] += t
    return m


def test_resize_ce_matches_f64_oracle():
    """Absolute ground truth at a tiny size: float64 numpy upsample + CE,
    gradient by central differences."""
    r, B, h, w, C = 2, 1, 2, 4, 3
    rng = np.random.RandomState(1)
    z = rng.randn(B, h, w, C).astype(np.float32)
    lab = rng.randint(0, C, (B, h * r, w * r)).astype(np.int32)

    def f64_loss(zz):
        up = np.einsum("hH,bhwc->bHwc", _expand(h, r), zz.astype(np.float64))
        up = np.einsum("wW,bHwc->bHWc", _expand(w, r), up)
        m = up.max(-1, keepdims=True)
        lse = m[..., 0] + np.log(np.exp(up - m).sum(-1))
        true = np.take_along_axis(up, lab[..., None].astype(np.int64),
                                  -1)[..., 0]
        return (lse - true).mean()

    g64 = np.zeros(z.shape, np.float64)
    for i in np.ndindex(*z.shape):
        zp = z.astype(np.float64)
        zm = zp.copy()
        zp[i] += 1e-6
        zm[i] -= 1e-6
        g64[i] = (f64_loss(zp) - f64_loss(zm)) / 2e-6

    l1, g1 = jax.value_and_grad(lambda zz: resize_cross_entropy(
        zz, jnp.asarray(lab), num_classes=C, ignore_index=255))(
            jnp.asarray(z))
    assert abs(float(l1) - f64_loss(z)) < 1e-5
    rel = np.linalg.norm(np.asarray(g1) - g64) / np.linalg.norm(g64)
    assert rel < 1e-5, rel


def test_resize_ce_all_ignored_is_finite():
    """All-ignored labels: the weight sum is 0, the loss stays finite (0)
    and the gradient is exactly zero."""
    r, B, h, w, C = 8, 1, 8, 8, 19
    z = jnp.asarray(np.random.RandomState(0).randn(B, h, w, C), jnp.float32)
    lab = jnp.full((B, h * r, w * r), 255, jnp.int32)
    l, g = jax.value_and_grad(lambda zz: resize_cross_entropy(
        zz, lab, num_classes=C, ignore_index=255))(z)
    assert np.isfinite(float(l)) and float(l) == 0.0
    assert float(jnp.abs(g).max()) == 0.0
