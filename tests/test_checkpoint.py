"""Checkpoint format (train/checkpoint.py): keyed ``.npz`` plus a JSON
header. Round trips must be bit-exact for every leaf dtype the trainer
holds (bf16 and f32 params, int32 step and optimizer counts), and every
loader must refuse a tree that does not fit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esn_tpu.train import checkpoint as ckpt
from esn_tpu.train.optimizers import build_optimizer
from esn_tpu.train.state import TrainState


def _variables(rng, dtype=jnp.float32):
    return {
        "params": {"enc": {"conv": {"kernel": jnp.asarray(
                       rng.randn(3, 3, 2, 4), dtype)},
                           "bn": {"scale": jnp.asarray(rng.rand(4), dtype)}},
                   "head": {"kernel": jnp.asarray(rng.randn(4, 5), dtype)}},
        "stats": {"enc": {"bn": {"mean": jnp.asarray(rng.randn(4),
                                                     jnp.float32)}},
                  "count": jnp.asarray(7, jnp.int32)},
    }


def _assert_bit_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_checkpoint_round_trip_is_bit_exact(rng, tmp_path, dtype):
    tx = build_optimizer("adam", 1e-3)
    state = TrainState.create(_variables(rng, jnp.dtype(dtype)), tx)
    # a non-trivial optimizer state: one update with random gradients
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape), p.dtype), state.params)
    _, opt_state = tx.update(grads, state.opt_state, state.params)
    state = state._replace(opt_state=opt_state,
                           step=jnp.asarray(5, jnp.int32))

    path = ckpt.save_checkpoint(str(tmp_path), 2, state, {"mIoU": 0.25})
    assert path.endswith("model_2.ckpt")
    target = TrainState.create(_variables(np.random.RandomState(9),
                                          jnp.dtype(dtype)), tx)
    restored, meta = ckpt.load_checkpoint(path, target)
    assert meta == {"epoch": 2, "mIoU": 0.25}
    _assert_bit_equal(restored, state)


def test_load_variables_ignores_optimizer_state(rng, tmp_path):
    """Inference CLIs restore params + stats whatever optimizer trained."""
    v = _variables(rng)
    path = ckpt.save_checkpoint(str(tmp_path), 1, TrainState.create(
        v, build_optimizer("adam", 1e-3)))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, v)
    restored, meta = ckpt.load_variables(path, zeros)
    assert meta["epoch"] == 1
    _assert_bit_equal(restored, v)


def test_load_encoder_grafts_subtree_and_casts(rng, tmp_path):
    """A sub-model checkpoint (its root is the target's ``enc`` subtree,
    plus a classifier the target lacks) grafts in, cast to the target's
    dtypes."""
    full = _variables(rng)
    donor = {"params": {**full["params"]["enc"],
                        "cls": {"kernel": jnp.ones((4, 3))}},
             "stats": full["stats"]["enc"]}
    path = ckpt.save_checkpoint(str(tmp_path), 1, TrainState.create(
        donor, build_optimizer("sgd", 0.1)))
    target = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, jnp.bfloat16 if a.dtype == jnp.float32
                            else a.dtype), full)
    got, _ = ckpt.load_encoder(path, target, subtree="enc")
    k = got["params"]["enc"]["conv"]["kernel"]
    assert k.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(k), np.asarray(full["params"]["enc"]["conv"]["kernel"]
                                  .astype(jnp.bfloat16)))
    np.testing.assert_array_equal(
        np.asarray(got["stats"]["enc"]["bn"]["mean"]),
        np.asarray(full["stats"]["enc"]["bn"]["mean"].astype(jnp.bfloat16)))
    # outside the subtree nothing moves
    assert not np.asarray(got["params"]["head"]["kernel"]).any()


def test_params_only_round_trip(rng, tmp_path):
    v = _variables(rng, jnp.bfloat16)
    path = str(tmp_path / "export.ckpt")
    ckpt.save_params_only(path, v)
    _assert_bit_equal(ckpt.load_params_only(
        path, jax.tree_util.tree_map(jnp.zeros_like, v)), v)


def test_load_refuses_shape_mismatch_and_missing_leaf(rng, tmp_path):
    v = _variables(rng)
    path = ckpt.save_checkpoint(str(tmp_path), 1, TrainState.create(
        v, build_optimizer("sgd", 0.1)))
    wrong = jax.tree_util.tree_map(lambda a: a, v)
    wrong["params"]["head"]["kernel"] = jnp.zeros((4, 6))
    with pytest.raises(ValueError, match="head/kernel"):
        ckpt.load_variables(path, wrong)
    extra = jax.tree_util.tree_map(lambda a: a, v)
    extra["params"]["aux"] = {"kernel": jnp.zeros(3)}
    with pytest.raises(KeyError, match="aux"):
        ckpt.load_variables(path, extra)


def test_list_and_latest_checkpoints(rng, tmp_path):
    state = TrainState.create(_variables(rng), build_optimizer("sgd", 0.1))
    for epoch in (3, 10, 1):
        ckpt.save_checkpoint(str(tmp_path), epoch, state)
    assert [e for e, _ in ckpt.list_checkpoints(str(tmp_path))] == [1, 3, 10]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("model_10.ckpt")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
