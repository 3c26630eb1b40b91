"""Lane-folding (ops.folding) exactness: folded conv == plain conv, and the
NonBottleneck1d folded fast path == its plain path (eval AND train, incl.
BN batch stats and the channel-dropout mask)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esn_tpu import nn
from esn_tpu.ops import convolution as C
from esn_tpu.ops import folding


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def test_folded_conv_matches_plain(rng):
    for (kh, kw, d, c, f) in [(3, 1, 1, 16, 8), (1, 3, 1, 16, 8),
                              (3, 1, 2, 16, 4), (1, 3, 2, 32, 4),
                              (1, 3, 16, 16, 8), (3, 3, 1, 16, 8),
                              (1, 5, 1, 8, 8)]:
        x = jnp.asarray(rng.randn(2, 8, 24, c), jnp.float32)
        w = jnp.asarray(rng.randn(kh, kw, c, c), jnp.float32)
        b = jnp.asarray(rng.randn(c), jnp.float32)
        ph = d * (kh - 1) // 2
        pw = d * (kw - 1) // 2
        ref = C.conv2d(x, w, padding=(ph, pw), dilation=d, bias=b)
        got = folding.unfold_w(
            folding.folded_conv2d(folding.fold_w(x, f), w, f,
                                  dilation=(d, d), padding=(ph, pw), bias=b),
            f)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=str((kh, kw, d, c, f)))


def test_folded_conv_grads_match(rng):
    x = jnp.asarray(rng.randn(2, 6, 16, 16), jnp.float32)
    w = jnp.asarray(rng.randn(1, 3, 16, 16), jnp.float32)

    def plain(args):
        return jnp.sum(C.conv2d(args[0], args[1], padding=(0, 1)) ** 2)

    def folded(args):
        y = folding.folded_conv2d(folding.fold_w(args[0], 8), args[1], 8,
                                  padding=(0, 1))
        return jnp.sum(y ** 2)

    gp = jax.grad(plain)((x, w))
    gf = jax.grad(folded)((x, w))
    for a, b in zip(gp, gf):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-4)


def _run_nb1d(x, train, monkeypatch, fold_on):
    from esn_tpu.models.blocks import NonBottleneck1d
    monkeypatch.setenv("ESN_TPU_FOLD", "1" if fold_on else "0")
    m = NonBottleneck1d(16, dilation=2, dropout=0.5 if train else 0.0)
    v = m.init(jax.random.PRNGKey(0), x)
    # perturb params so the test isn't at init symmetry
    v = jax.tree_util.tree_map(
        lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype)
        .reshape(a.shape), v)
    if train:
        y, nv = nn.apply(m, v, x, train=True, mutable=True,
                         rngs={"dropout": jax.random.PRNGKey(7)})
        return y, nv["stats"]
    return nn.apply(m, v, x), None


def test_nb1d_folded_matches_plain_eval(rng, monkeypatch):
    x = jnp.asarray(rng.randn(2, 8, 32, 16), jnp.float32)
    ref, _ = _run_nb1d(x, False, monkeypatch, False)
    got, _ = _run_nb1d(x, False, monkeypatch, True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_nb1d_folded_matches_plain_train(rng, monkeypatch):
    x = jnp.asarray(rng.randn(2, 8, 32, 16), jnp.float32)
    ref, stats_ref = _run_nb1d(x, True, monkeypatch, False)
    got, stats_got = _run_nb1d(x, True, monkeypatch, True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(stats_ref),
                    jax.tree_util.tree_leaves(stats_got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-4)


def test_fold_factor():
    assert folding.fold_factor(16, 256) == 8
    assert folding.fold_factor(64, 256) == 2
    assert folding.fold_factor(128, 256) == 1
    assert folding.fold_factor(16, 100) == 5   # W divisibility fallback
    assert folding.fold_factor(25, 256) == 4   # non-pow2 channel counts
    assert folding.fold_factor(16, 31) == 1


def test_enet_regular_bottleneck_folded_matches_plain(rng, monkeypatch):
    from esn_tpu.models.enet import RegularBottleneck
    for asym, prelu in [(False, True), (True, False)]:
        x = jnp.asarray(rng.randn(2, 8, 32, 16), jnp.float32)
        outs = []
        for fold_on in (False, True):
            monkeypatch.setenv("ESN_TPU_FOLD_ENET", "1" if fold_on else "0")
            m = RegularBottleneck(16, dropout=0.0, asymmetric=asym,
                                  relu=not prelu)
            v = m.init(jax.random.PRNGKey(0), x)
            v = jax.tree_util.tree_map(
                lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype)
                .reshape(a.shape), v)
            outs.append(nn.apply(m, v, x))
        np.testing.assert_allclose(np.asarray(outs[1]), np.asarray(outs[0]),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"asym={asym}")


def test_lednet_ssnbt_folded_matches_plain(rng, monkeypatch):
    from esn_tpu.models.lednet import SSnbt
    x = jnp.asarray(rng.randn(2, 8, 32, 32), jnp.float32)
    for train in (False, True):
        outs = []
        for fold_on in (False, True):
            monkeypatch.setenv("ESN_TPU_FOLD", "1" if fold_on else "0")
            m = SSnbt(32, dilation=2, dropout=0.5 if train else 0.0)
            v = m.init(jax.random.PRNGKey(0), x)
            v = jax.tree_util.tree_map(
                lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype)
                .reshape(a.shape), v)
            if train:
                y, _ = nn.apply(m, v, x, train=True, mutable=True,
                                rngs={"dropout": jax.random.PRNGKey(3)})
            else:
                y = nn.apply(m, v, x)
            outs.append(y)
        np.testing.assert_allclose(np.asarray(outs[1]), np.asarray(outs[0]),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"train={train}")


def _run_fpenet(x, train, monkeypatch, fold_on, model_cls=None):
    from esn_tpu.models.fpenet import FPENet
    monkeypatch.setenv("ESN_TPU_FPE_FOLDED", "1" if fold_on else "0")
    monkeypatch.setenv("ESN_TPU_FOLD_DW", "0")
    m = FPENet(classes=7)
    v = m.init(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(
        lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype)
        .reshape(a.shape) / max(a.size, 1), v)
    if train:
        y, nv = nn.apply(m, v, x, train=True, mutable=True)
        return y, nv["stats"]
    return nn.apply(m, v, x), None


def test_fpenet_groupmajor_folded_matches_plain_eval(rng, monkeypatch):
    """FPEBlock._folded2 (group-major folded encoder: split expand,
    dense-banded depthwise, virtual-concat project) == plain path.
    W=48 -> s1.W=24 is NOT divisible by 8, exercising the fallback too."""
    x = jnp.asarray(rng.randn(2, 32, 64, 3), jnp.float32)
    ref, _ = _run_fpenet(x, False, monkeypatch, False)
    got, _ = _run_fpenet(x, False, monkeypatch, True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    # indivisible width falls back to the plain path, same result
    x2 = jnp.asarray(rng.randn(1, 32, 40, 3), jnp.float32)
    ref2, _ = _run_fpenet(x2, False, monkeypatch, False)
    got2, _ = _run_fpenet(x2, False, monkeypatch, True)
    np.testing.assert_allclose(np.asarray(got2), np.asarray(ref2),
                               rtol=2e-4, atol=2e-4)


def test_fpenet_groupmajor_folded_matches_plain_train(rng, monkeypatch):
    """Train mode: outputs AND the BN running stats must match — incl. the
    per-group sliced stat updates of folded_slice_apply (expand BN)."""
    x = jnp.asarray(rng.randn(2, 32, 64, 3), jnp.float32)
    ref, stats_ref = _run_fpenet(x, True, monkeypatch, False)
    got, stats_got = _run_fpenet(x, True, monkeypatch, True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    ra, _ = jax.tree_util.tree_flatten_with_path(stats_ref)
    ga, _ = jax.tree_util.tree_flatten_with_path(stats_got)
    for (pa, a), (pb, b) in zip(ra, ga):
        assert pa == pb
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=2e-4, atol=2e-4, err_msg=str(pa))


def test_fpenet_groupmajor_folded_grads_match(rng, monkeypatch):
    from esn_tpu.models.fpenet import FPENet
    x = jnp.asarray(rng.randn(1, 32, 64, 3), jnp.float32)
    grads = []
    for fold_on in (False, True):
        monkeypatch.setenv("ESN_TPU_FPE_FOLDED", "1" if fold_on else "0")
        m = FPENet(classes=7)
        v = m.init(jax.random.PRNGKey(0), x)
        v = jax.tree_util.tree_map(
            lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype)
            .reshape(a.shape) / max(a.size, 1), v)

        def loss(vv):
            y, _ = nn.apply(m, vv, x, train=True, mutable=True)
            return jnp.mean(y ** 2)

        grads.append(jax.grad(loss)(v))
    for a, b in zip(jax.tree_util.tree_leaves(grads[0]),
                    jax.tree_util.tree_leaves(grads[1])):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=5e-3, atol=5e-5)
