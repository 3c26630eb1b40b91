"""The composed DSConv and CG blocks against float64 numpy oracles.

Both blocks run as plain XLA compositions (conv -> BN -> activation); the
oracles below recompute them from the same variable trees in float64, so
a change of lowering anywhere under them shows here first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esn_tpu import nn
from esn_tpu.models.blocks import DSConv
from esn_tpu.models.cgnet import BN_EPS, CGBlock


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _dwconv(x, k, stride=1, dil=1):
    """Depthwise 3x3, padding ``dil``: x (N,H,W,C), k (3,3,C)."""
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (dil, dil), (dil, dil), (0, 0)))
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = np.zeros((n, oh, ow, c))
    for a in range(3):
        for b in range(3):
            out += k[a, b] * xp[:, a * dil:a * dil + (oh - 1) * stride + 1:stride,
                                b * dil:b * dil + (ow - 1) * stride + 1:stride]
    return out


def _bn(x, p, s, eps, train):
    """Returns (y, new running mean) with the block's momentum 0.1."""
    if train:
        mean, var = x.mean((0, 1, 2)), x.var((0, 1, 2))
    else:
        mean, var = s["mean"], s["var"]
    y = (x - mean) / np.sqrt(var + eps) * p["scale"] + p["bias"]
    return y, 0.9 * s["mean"] + 0.1 * mean


_ACTS = {"relu": lambda v: np.maximum(v, 0),
         "relu6": lambda v: np.clip(v, 0, 6),
         "none": lambda v: v}


def _prelu(x, a):
    return np.where(x >= 0, x, a * x)


def _perturb_stats(v, rng):
    """Non-trivial running statistics, so eval BN is really exercised."""
    v["stats"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.rand(*a.shape) + 0.5, a.dtype)
        if a.ndim else a, v["stats"])
    return v


# (hw, stride, act, dtype): the geometries the zoo's DSConvs see, odd sizes
# for the stride-2 edge, every activation, and the bf16 compute dtype
DSCONV_CASES = [
    ((16, 16), 1, "relu", "float32"),
    ((10, 14), 1, "relu", "float32"),
    ((9, 15), 1, "relu", "float32"),
    ((16, 16), 2, "relu", "float32"),
    ((10, 14), 2, "relu", "float32"),
    ((9, 15), 2, "relu", "float32"),
    ((8, 8), 1, "relu6", "float32"),
    ((8, 8), 1, "none", "float32"),
    ((16, 16), 1, "relu", "bfloat16"),
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("hw,stride,act,dtype", DSCONV_CASES)
def test_dsconv_matches_f64_oracle(rng, hw, stride, act, dtype, train):
    ci, co = 8, 16
    block = DSConv(ci, co, stride=stride, act=act)
    x = jnp.asarray(rng.randn(2, *hw, ci), jnp.float32)
    v = _perturb_stats(block.init(jax.random.PRNGKey(0), x), rng)
    xd = x.astype(dtype)
    y, new = nn.apply(block, v, xd, train=train, mutable=True)
    assert y.dtype == jnp.dtype(dtype)

    p, s = _f64(v["params"]), _f64(v["stats"])
    f = _ACTS[act]
    h1, _ = _bn(_dwconv(np.asarray(xd, np.float64),
                        p["dw"]["conv"]["kernel"][:, :, 0], stride),
                p["dw"]["bn"], s["dw"]["bn"], block.dw.bn.eps, train)
    h1 = f(h1)
    h2, mean2 = _bn(np.einsum("nhwc,cd->nhwd", h1,
                              p["pw"]["conv"]["kernel"][0, 0]),
                    p["pw"]["bn"], s["pw"]["bn"], block.pw.bn.eps, train)
    want = f(h2)
    # f32: summation order only; bf16: activations round to 8 mantissa bits
    # at every layer boundary
    tol = 1e-4 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(np.asarray(y, np.float64), want,
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(new["stats"]["pw"]["bn"]["mean"]),
                               mean2, rtol=tol, atol=tol)


@pytest.mark.parametrize("c,d,h,w", [(64, 2, 32, 48), (128, 4, 40, 64),
                                     (64, 2, 30, 48)])
def test_cgblock_eval_matches_f64_oracle(rng, c, d, h, w):
    block = CGBlock(c, d, 8 if c == 64 else 16)
    x = jnp.asarray(rng.randn(2, h, w, c), jnp.float32)
    v = _perturb_stats(block.init(jax.random.PRNGKey(1), x), rng)
    v["params"] = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.05 * rng.randn(*a.shape), a.dtype),
        v["params"])                      # slopes off their 0.25 init
    got = nn.apply(block, v, x)

    p, s = _f64(v["params"]), _f64(v["stats"])
    xn = np.asarray(x, np.float64)
    r = p["reduce"]
    y = np.einsum("nhwc,cd->nhwd", xn, r["conv"]["kernel"][0, 0])
    y = _prelu(_bn(y, r["bn"], s["reduce"]["bn"], BN_EPS, False)[0],
               r["act"]["alpha"])
    j = np.concatenate([_dwconv(y, p["loc"]["kernel"][:, :, 0]),
                        _dwconv(y, p["sur"]["kernel"][:, :, 0], dil=d)], -1)
    j = _prelu(_bn(j, p["join"]["bn"], s["join"]["bn"], BN_EPS, False)[0],
               p["join"]["act"]["alpha"])
    g = p["glo"]
    z = np.maximum(j.mean((1, 2)) @ g["fc1"]["kernel"] + g["fc1"]["bias"], 0)
    z = 1 / (1 + np.exp(-(z @ g["fc2"]["kernel"] + g["fc2"]["bias"])))
    want = xn + j * z[:, None, None, :]
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=1e-4, atol=1e-4)
