"""Parity tests for the fused bilinear-upsample+argmax prediction tail
(ops/pallas/resize_argmax.py, Pallas through Triton) — the Pallas
interpreter on the CPU, vs the plain tail the models ship — and the
wrapper's choice between the kernel and the plain tail.

The kernel argmaxes the f32 interpolation (torch-reference semantics);
the unfused tail rounds to the model dtype first, so bf16 near-tie pixels
can legitimately differ — tests bound the mismatch RATE for bf16 and
require exactness for f32 (where both paths compare the same values, up
to the f32 association of the separable interpolation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esn_tpu.ops.pallas.resize_argmax import resize_argmax, resize_argmax_ref


def _f32_ref(y, r):
    """f32-exact oracle: argmax of the f32 interpolation (no rounding)."""
    n, h, w, c = y.shape
    out = jax.image.resize(y.astype(jnp.float32), (n, h * r, w * r, c),
                           method="bilinear")
    return jnp.argmax(out, axis=-1).astype(jnp.int32)


@pytest.mark.parametrize("factor", [2, 3, 4, 8])
def test_resize_argmax_matches_f32_oracle(rng, factor):
    """Against the f32 oracle the kernel must agree everywhere except
    genuine association-level ties (rate ~0 on random inputs)."""
    y = jnp.asarray(rng.randn(2, 8, 24, 7).astype(np.float32))
    got = resize_argmax(y, factor, interpret=True)
    ref = _f32_ref(y, factor)
    assert got.shape == ref.shape
    match = float(jnp.mean((got == ref).astype(jnp.float32)))
    assert match >= 0.999, match


def test_resize_argmax_bf16_near_tie_rate(rng):
    """vs the shipped unfused tail (bf16 round before argmax): mismatches
    only at rounding-created ties, bounded rate."""
    y = jnp.asarray(rng.randn(2, 16, 16, 19).astype(np.float32)) \
        .astype(jnp.bfloat16)
    got = resize_argmax(y, 8, interpret=True)
    ref = resize_argmax_ref(y, 8)
    match = float(jnp.mean((got == ref).astype(jnp.float32)))
    assert match >= 0.99, match


def test_resize_argmax_edge_clamp_constant_rows(rng):
    """A constant-per-class field upsamples to itself: every output pixel
    must pick the globally max class (edge clamping exact)."""
    vals = rng.randn(5).astype(np.float32)
    y = jnp.asarray(np.tile(vals, (1, 4, 6, 1)))
    got = resize_argmax(y, 4, interpret=True)
    assert np.all(np.asarray(got) == int(np.argmax(vals)))


def test_resize_argmax_first_max_tie_rule():
    """Exact ties resolve to the FIRST maximal class (jnp.argmax rule)."""
    y = jnp.zeros((1, 4, 8, 6), jnp.float32)  # all classes tie at 0
    got = resize_argmax(y, 2, interpret=True)
    assert np.all(np.asarray(got) == 0)


def test_resize_argmax_odd_sizes(rng):
    """Widths that are no multiple of the column tile and a class count
    that is no power of two (exercises the clamped edge columns and the
    masked class padding)."""
    y = jnp.asarray(rng.randn(3, 5, 13, 11).astype(np.float32))
    got = resize_argmax(y, 3, interpret=True)
    ref = _f32_ref(y, 3)
    assert float(jnp.mean((got == ref).astype(jnp.float32))) >= 0.999


def test_model_predict_falls_back_unfused_on_cpu(rng):
    """On CPU the dispatcher returns None and predict must equal the
    plain argmax-of-logits tail exactly (covers the logits_lowres
    refactor of the eight resize-tail models)."""
    from esn_tpu import nn
    from esn_tpu.models import build_model
    for name in ("fastscnn", "contextnet", "edanet"):
        model = build_model(name, 11)
        x = jnp.asarray(rng.randn(1, 64, 96, 3).astype(np.float32))
        v = model.init(jax.random.PRNGKey(0), x)
        pred = nn.apply(model, v, x, train=False, method="predict")
        logits = nn.apply(model, v, x, train=False)
        ref = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(pred), np.asarray(ref)), name


@pytest.mark.parametrize("backend,shape,out_hw,fused", [
    ("gpu", (2, 8, 16, 19), (64, 128), True),     # r=8, the zoo's shape
    ("gpu", (1, 4, 6, 64), (8, 12), True),        # r=2, C at its limit
    ("gpu", (1, 4, 6, 5), (12, 18), True),        # r=3
    ("gpu", (1, 4, 6, 5), (10, 15), False),       # non-integer scale
    ("gpu", (1, 4, 6, 5), (8, 18), False),        # anisotropic
    ("gpu", (1, 4, 6, 5), (40, 60), False),       # r=10 > 8
    ("gpu", (1, 4, 6, 65), (8, 12), False),       # C > 64
    ("cpu", (2, 8, 16, 19), (64, 128), False),    # the CPU runs plain
])
def test_fused_resize_argmax_selection(rng, backend, shape, out_hw, fused):
    """The wrapper picks the kernel by backend and shape alone; where it
    picks it, the result is the kernel's."""
    from esn_tpu.ops.classify import fused_resize_argmax
    y = jnp.asarray(rng.randn(*shape).astype(np.float32))
    got = fused_resize_argmax(y, out_hw, backend=backend, interpret=True)
    assert (got is not None) == fused
    if fused:
        want = resize_argmax(y, out_hw[0] // shape[1], interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
