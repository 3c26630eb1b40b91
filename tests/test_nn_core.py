"""Module calculus + layer tests. torch (CPU) is used as an independent
numerical oracle for conv/BN semantics — no reference code involved."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esn_tpu import nn
from esn_tpu.ops import convolution as C


def test_init_apply_roundtrip_deterministic():
    mod = nn.Sequential(
        nn.Conv(3, 8, 3, padding=1),
        nn.BatchNorm(8),
        nn.PReLU(8),
        nn.Conv(8, 4, 1),
    )
    x = jnp.ones((2, 16, 16, 3))
    v1 = nn.init(mod, jax.random.PRNGKey(0), x)
    v2 = nn.init(mod, jax.random.PRNGKey(0), x)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, b), v1, v2)
    y = nn.apply(mod, v1, x)
    assert y.shape == (2, 16, 16, 4)
    # different seed -> different params
    v3 = nn.init(mod, jax.random.PRNGKey(1), x)
    assert not np.allclose(v1["params"]["0"]["kernel"], v3["params"]["0"]["kernel"])


def test_missing_param_raises():
    mod = nn.Conv(3, 8, 3, padding=1)
    x = jnp.ones((1, 8, 8, 3))
    variables = nn.init(mod, jax.random.PRNGKey(0), x)
    bigger = nn.Sequential(nn.Conv(3, 8, 3, padding=1), nn.Conv(8, 4, 1))
    with pytest.raises(KeyError):
        nn.apply(bigger, {"params": {"0": variables["params"]}, "stats": {}}, x)


def test_conv_matches_torch(rng):
    torch = pytest.importorskip("torch")
    x = rng.randn(2, 3, 17, 23).astype(np.float32)
    for (k, s, p, d, g, cin, cout) in [
        (3, 1, 1, 1, 1, 3, 8),
        (3, 2, 1, 1, 1, 3, 8),
        ((5, 1), 1, (2, 0), 1, 1, 3, 6),
        (3, 1, 2, 2, 1, 3, 8),
        (3, 1, 1, 1, 3, 3, 9),   # grouped
    ]:
        kt = (k, k) if isinstance(k, int) else k
        tconv = torch.nn.Conv2d(cin, cout, kt, stride=s, padding=p,
                                dilation=d, groups=g, bias=True)
        with torch.no_grad():
            ref = tconv(torch.from_numpy(x)).numpy()
        w = tconv.weight.detach().numpy().transpose(2, 3, 1, 0)  # OIHW->HWIO
        b = tconv.bias.detach().numpy()
        y = C.conv2d(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w),
                     stride=s, padding=p, dilation=d, groups=g,
                     bias=jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(y).transpose(0, 3, 1, 2), ref,
                                   rtol=1e-4, atol=1e-4)


def test_conv_transpose_matches_torch(rng):
    torch = pytest.importorskip("torch")
    x = rng.randn(2, 4, 9, 11).astype(np.float32)
    for (k, s, p, op) in [(3, 2, 1, 1), (2, 2, 0, 0), (4, 2, 1, 0), (3, 1, 1, 0)]:
        tconv = torch.nn.ConvTranspose2d(4, 6, k, stride=s, padding=p,
                                         output_padding=op, bias=True)
        with torch.no_grad():
            ref = tconv(torch.from_numpy(x)).numpy()
        # torch IOHW -> flip spatial -> HWIO
        w = tconv.weight.detach().numpy()        # (in, out, kh, kw)
        w = w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy()
        b = tconv.bias.detach().numpy()
        y = C.conv2d_transpose(jnp.asarray(x.transpose(0, 2, 3, 1)),
                               jnp.asarray(w), stride=s, padding=p,
                               output_padding=op, bias=jnp.asarray(b))
        assert y.shape[1:3] == ref.shape[2:], (k, s, p, op)
        np.testing.assert_allclose(np.asarray(y).transpose(0, 3, 1, 2), ref,
                                   rtol=1e-4, atol=1e-4)


def test_batchnorm_train_matches_torch(rng):
    torch = pytest.importorskip("torch")
    x = rng.randn(4, 5, 6, 7).astype(np.float32) * 3 + 1
    tbn = torch.nn.BatchNorm2d(7, momentum=0.1, eps=1e-5)
    tbn.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        ref = tbn(xt).numpy().transpose(0, 2, 3, 1)

    bn = nn.BatchNorm(7)
    variables = nn.init(bn, jax.random.PRNGKey(0), jnp.asarray(x))
    y, new_vars = nn.apply(bn, variables, jnp.asarray(x), train=True,
                           mutable=True)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(new_vars["stats"]["mean"]),
                               tbn.running_mean.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(new_vars["stats"]["var"]),
                               tbn.running_var.numpy(), rtol=1e-4, atol=1e-5)
    # eval mode uses running stats
    tbn.eval()
    with torch.no_grad():
        ref_eval = tbn(xt).numpy().transpose(0, 2, 3, 1)
    y_eval = nn.apply(bn, new_vars, jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(y_eval), ref_eval, rtol=1e-4, atol=1e-4)


def test_prelu_and_dropout():
    x = jnp.array([[-2.0, 3.0]])
    pr = nn.PReLU(1)
    v = nn.init(pr, jax.random.PRNGKey(0), x)
    y = nn.apply(pr, v, x)
    np.testing.assert_allclose(np.asarray(y), [[-0.5, 3.0]])

    drop = nn.SpatialDropout(0.5)
    x = jnp.ones((8, 4, 4, 16))
    v = nn.init(drop, jax.random.PRNGKey(0), x)
    y = nn.apply(drop, v, x, train=True, rngs={"dropout": jax.random.PRNGKey(1)})
    y = np.asarray(y)
    # whole channels dropped or kept (scaled by 2)
    per_channel = y.reshape(8, -1, 16)
    for b in range(8):
        for c in range(16):
            vals = np.unique(per_channel[b, :, c])
            assert len(vals) == 1 and vals[0] in (0.0, 2.0)
    # eval = identity
    y2 = nn.apply(drop, v, x, train=False)
    np.testing.assert_array_equal(np.asarray(y2), np.asarray(x))


def test_jit_and_grad_compose():
    mod = nn.Sequential(nn.Conv(3, 8, 3, padding=1), nn.BatchNorm(8),
                        nn.PReLU(8))
    x = jnp.ones((2, 8, 8, 3))
    variables = nn.init(mod, jax.random.PRNGKey(0), x)

    @jax.jit
    def loss_fn(params, stats, x):
        y, new_vars = nn.apply(mod, {"params": params, "stats": stats}, x,
                               train=True, mutable=True)
        return jnp.mean(y ** 2), new_vars["stats"]

    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], variables["stats"], x)
    assert np.isfinite(float(loss))
    flat = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(g))) for g in flat)
    assert any(np.any(np.asarray(g) != 0) for g in flat)


def test_grouped_conv_dense_blockdiag_parity(rng, monkeypatch):
    """The block-diag dense lowering for non-depthwise grouped convs
    (nn.layers._block_diag_kernel) is exactly the grouped
    conv: off-diagonal zeros are exact in the f32 accumulator. Both conv
    and grad parity, plus a 3x3 grouped case."""
    for k, g, cin, cout in [(1, 4, 16, 24), (3, 2, 8, 8)]:
        conv = nn.Conv(cin, cout, k, padding=k // 2, groups=g, bias=True)
        x = jnp.asarray(rng.randn(2, 9, 11, cin).astype(np.float32))
        v = conv.init(jax.random.PRNGKey(0), x)

        def run(on):
            monkeypatch.setenv("ESN_TPU_DENSE_GROUPED", "1" if on else "0")
            loss = lambda vv: jnp.sum(nn.apply(conv, vv, x) ** 2)
            return nn.apply(conv, v, x), jax.grad(loss)(v)

        y_ref, g_ref = run(False)
        y_new, g_new = run(True)
        np.testing.assert_allclose(np.asarray(y_new), np.asarray(y_ref),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_new)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=1e-4, atol=1e-4)
