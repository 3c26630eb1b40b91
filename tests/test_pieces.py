"""Virtual-concat (pieces) execution vs materialized concat.

CGNet's raw-input injections create misaligned 35/131-channel concats; the pieces path applies BN/PReLU with sliced per-channel
params and splits conv kernels over the pieces. Both must match the
materialized-concat reference math to float-epsilon, with identical
variables layout (checkpoint compatibility)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esn_tpu import nn
from esn_tpu.models.blocks import BNAct, ConvBNAct



def _pieces(key, shapes, dtype=jnp.float32):
    ks = jax.random.split(key, len(shapes))
    return [jax.random.normal(k, s, dtype) for k, s in zip(ks, shapes)]


def test_bnact_pieces_eval_matches_concat():
    ps = _pieces(jax.random.PRNGKey(0),
                 [(2, 8, 12, 32), (2, 8, 12, 3)])
    cat = jnp.concatenate(ps, -1)
    m = BNAct(35, act="prelu", bn_eps=1e-3)
    v = m.init(jax.random.PRNGKey(1), cat)
    # perturb stats/params so slicing bugs can't hide behind identity BN
    v = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape)
        if a.ndim == 1 else a, v)
    want = nn.apply(m, v, cat)

    def run_pieces(scope, pieces):
        return m.pieces_apply(scope, pieces)

    class Wrap(nn.Module):
        def __call__(self, scope, pieces):
            return m.pieces_apply(scope, pieces)

    got = jnp.concatenate(nn.apply(Wrap(), v, ps), -1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_bnact_pieces_train_stats_match():
    ps = _pieces(jax.random.PRNGKey(0), [(2, 8, 12, 32), (2, 8, 12, 3)])
    cat = jnp.concatenate(ps, -1)
    m = BNAct(35, act="prelu", bn_eps=1e-3)
    v = m.init(jax.random.PRNGKey(1), cat)

    class Wrap(nn.Module):
        def __call__(self, scope, pieces):
            return m.pieces_apply(scope, pieces)

    want, vars_cat = nn.apply(m, v, cat, train=True, mutable=True)
    got_ps, vars_pcs = nn.apply(Wrap(), v, ps, train=True, mutable=True)
    got = jnp.concatenate(got_ps, -1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    lc = jax.tree_util.tree_leaves_with_path(vars_cat["stats"])
    lp = dict(jax.tree_util.tree_leaves_with_path(vars_pcs["stats"]))
    assert lc and len(lc) == len(lp)
    for path, leaf in lc:
        np.testing.assert_allclose(np.asarray(lp[path]), np.asarray(leaf),
                                   rtol=1e-5, atol=1e-7)


def test_convbnact_pieces_matches_concat():
    ps = _pieces(jax.random.PRNGKey(0),
                 [(2, 16, 24, 64), (2, 16, 24, 64), (2, 16, 24, 3)])
    cat = jnp.concatenate(ps, -1)
    m = ConvBNAct(131, 128, 3, stride=2, act="prelu", bn_eps=1e-3)
    v = m.init(jax.random.PRNGKey(1), cat)
    want = nn.apply(m, v, cat)

    class Wrap(nn.Module):
        def __call__(self, scope, pieces):
            return m.pieces_apply(scope, pieces)

    got = nn.apply(Wrap(), v, ps)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_conv_pieces_matches_concat():
    ps = _pieces(jax.random.PRNGKey(0),
                 [(2, 16, 24, 32), (2, 16, 24, 3)])
    cat = jnp.concatenate(ps, -1)
    m = nn.Conv(35, 29, 3, stride=2, padding=1, bias=True)
    v = m.init(jax.random.PRNGKey(1), cat)
    want = nn.apply(m, v, cat)

    class Wrap(nn.Module):
        def __call__(self, scope, pieces):
            return m.pieces_apply(scope, pieces)

    got = nn.apply(Wrap(), v, ps)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_dabnet_downsampling_pieces_matches_concat():
    from esn_tpu.models.dabnet import DownSamplingBlock
    ps = _pieces(jax.random.PRNGKey(0),
                 [(2, 16, 24, 32), (2, 16, 24, 3)])
    cat = jnp.concatenate(ps, -1)
    m = DownSamplingBlock(35, 64)          # conv(29) || maxpool(35) concat
    v = m.init(jax.random.PRNGKey(1), cat)
    want = nn.apply(m, v, cat)
    got = nn.apply(m, v, ps)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _grad_flows(model, x, rngs):
    v = model.init(jax.random.PRNGKey(1), x)

    def loss(params):
        y = nn.apply(model, {**v, "params": params}, x, train=True,
                     mutable=True, rngs=rngs)[0]
        return jnp.sum(y ** 2)

    g = jax.grad(loss)(v["params"])
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
    nonzero = sum(float(jnp.sum(jnp.abs(l))) > 0 for l in leaves)
    assert nonzero / len(leaves) > 0.9, f"{nonzero}/{len(leaves)}"


def test_espnet_grad_flows_through_pieces():
    from esn_tpu.models.espnet import ESPNet
    _grad_flows(ESPNet(5, alpha2=2, alpha3=2),
                jax.random.normal(jax.random.PRNGKey(0), (1, 64, 64, 3),
                                  jnp.float32),
                {"dropout": jax.random.PRNGKey(2)})


def test_dabnet_grad_flows_through_pieces():
    from esn_tpu.models.dabnet import DABNet
    _grad_flows(DABNet(5),
                jax.random.normal(jax.random.PRNGKey(0), (1, 64, 64, 3),
                                  jnp.float32),
                {"dropout": jax.random.PRNGKey(2)})


def test_cgnet_grad_flows_through_pieces():
    from esn_tpu.models.cgnet import CGNet
    model = CGNet(5, m=2, n=2)
    x = jax.random.normal(jax.random.PRNGKey(0), (1, 64, 64, 3), jnp.float32)
    v = model.init(jax.random.PRNGKey(1), x)

    def loss(params):
        y = nn.apply(model, {**v, "params": params}, x, train=True,
                     mutable=True, rngs={"dropout": jax.random.PRNGKey(2)})[0]
        return jnp.sum(y ** 2)

    g = jax.grad(loss)(v["params"])
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
    # every parameter must receive gradient somewhere (stem, injected
    # pieces, downsampler split-kernels, scanned stages)
    nonzero = sum(float(jnp.sum(jnp.abs(l))) > 0 for l in leaves)
    assert nonzero / len(leaves) > 0.9, f"{nonzero}/{len(leaves)}"
