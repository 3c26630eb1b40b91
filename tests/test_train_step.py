"""Train/eval step tests: loss descends, DP sharding is value-equivalent to
single-device, checkpoints resume exactly."""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esn_tpu import nn
from esn_tpu.parallel import mesh as meshlib
from esn_tpu.train import checkpoint as ckpt
from esn_tpu.train.losses import cross_entropy
from esn_tpu.train.optimizers import build_optimizer
from esn_tpu.train.schedules import poly_schedule
from esn_tpu.train.state import TrainState
from esn_tpu.train.step import make_eval_step, make_train_step

NUM_CLASSES = 4


def tiny_model(with_bn=True):
    if with_bn:
        # conv bias=False before BN: a biased conv pre-BN has a loss-invariant
        # direction whose noise-gradient Adam amplifies arbitrarily
        return nn.Sequential(
            nn.Conv(3, 16, 3, padding=1, bias=False), nn.BatchNorm(16),
            nn.PReLU(16), nn.Conv(16, NUM_CLASSES, 1))
    return nn.Sequential(
        nn.Conv(3, 16, 3, padding=1), nn.PReLU(16),
        nn.Conv(16, NUM_CLASSES, 1))


def make_batch(rng, b=8, h=16, w=16):
    images = rng.rand(b, h, w, 3).astype(np.float32)
    # learnable labeling: quadrant index
    yy, xx = np.mgrid[0:h, 0:w]
    labels = (2 * (yy >= h // 2) + (xx >= w // 2)).astype(np.int32)
    labels = np.broadcast_to(labels, (b, h, w)).copy()
    return {"image": images, "label": labels}


def build_everything(grad_accum=1, with_bn=True):
    model = tiny_model(with_bn)
    sched = poly_schedule(0.05, 200)
    tx = build_optimizer("adam", sched, weight_decay=0.0)
    loss_fn = lambda lg, lb: cross_entropy(lg, lb, num_classes=NUM_CLASSES)
    step = make_train_step(model, loss_fn, tx, schedule=sched,
                           grad_accum=grad_accum, donate=False)
    return model, tx, step


def test_loss_decreases(rng):
    model, tx, step = build_everything()
    batch = make_batch(rng)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.asarray(batch["image"]))
    state = TrainState.create(variables, tx)
    key = jax.random.PRNGKey(42)
    batch = jax.tree_util.tree_map(jnp.asarray, batch)
    first = None
    for i in range(40):
        state, metrics = step(state, batch, key)
        if first is None:
            first = float(metrics["loss"])
    last = float(metrics["loss"])
    assert last < first * 0.5, (first, last)
    assert int(state.step) == 40
    assert "lr" in metrics


def test_grad_accum_matches_full_batch(rng):
    # BN-free model: with BN, microbatch statistics legitimately differ
    model, tx, step1 = build_everything(grad_accum=1, with_bn=False)
    _, _, step4 = build_everything(grad_accum=4, with_bn=False)
    batch = make_batch(rng, b=8)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(batch["image"]))
    state1 = TrainState.create(variables, tx)
    state4 = TrainState.create(variables, tx)
    key = jax.random.PRNGKey(7)
    batch = jax.tree_util.tree_map(jnp.asarray, batch)
    s1, m1 = step1(state1, batch, key)
    s4, m4 = step4(state4, batch, key)
    # same total batch -> same gradient direction; losses comparable
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-4)
    p1 = jax.tree_util.tree_leaves(s1.params)
    p4 = jax.tree_util.tree_leaves(s4.params)
    for a, b in zip(p1, p4):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-5)


def test_data_parallel_equivalence(rng):
    """8-device data-parallel step == single-device step on the same batch."""
    assert len(jax.devices()) == 8
    model, tx, step = build_everything()
    batch = make_batch(rng, b=16)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(batch["image"]))
    key = jax.random.PRNGKey(3)

    # single device
    state_a = TrainState.create(variables, tx)
    batch_a = jax.tree_util.tree_map(jnp.asarray, batch)
    for _ in range(3):
        state_a, m_a = step(state_a, batch_a, key)

    # 8-device mesh: batch sharded, state replicated
    m = meshlib.make_mesh()
    state_b = meshlib.replicate(TrainState.create(variables, tx), m)
    batch_b = meshlib.shard_batch(
        jax.tree_util.tree_map(np.asarray, batch), m)
    for _ in range(3):
        state_b, m_b = step(state_b, batch_b, key)

    assert float(m_a["loss"]) == pytest.approx(float(m_b["loss"]), rel=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(state_a.params),
                    jax.tree_util.tree_leaves(state_b.params)):
        # atol 5e-6: BN batch moments reduce in different orders across the
        # mesh (E[x^2]-E[x]^2, psum of partials) — float noise, not drift
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=5e-6)


def test_eval_step_confusion(rng):
    model, tx, _ = build_everything()
    batch = make_batch(rng, b=4)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(batch["image"]))
    eval_step = make_eval_step(model, NUM_CLASSES)
    pred, cm = eval_step(variables, jax.tree_util.tree_map(jnp.asarray, batch))
    assert pred.shape == batch["label"].shape
    assert int(jnp.sum(cm)) == batch["label"].size


def test_checkpoint_exact_resume(rng):
    model, tx, step = build_everything()
    batch = jax.tree_util.tree_map(jnp.asarray, make_batch(rng))
    variables = model.init(jax.random.PRNGKey(0), batch["image"])
    state = TrainState.create(variables, tx)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        state, _ = step(state, batch, key)

    with tempfile.TemporaryDirectory() as d:
        path = ckpt.save_checkpoint(d, 3, state, {"mIoU": 0.5})
        assert ckpt.latest_checkpoint(d) == path
        target = TrainState.create(
            model.init(jax.random.PRNGKey(1), batch["image"]), tx)
        restored, meta = ckpt.load_checkpoint(path, target)
        assert meta["epoch"] == 3 and meta["mIoU"] == 0.5
        assert int(restored.step) == 3

        # continue both; trajectories must match exactly
        s1, m1 = step(state, batch, key)
        s2, m2 = step(restored, batch, key)
        assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=0)
        for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                        jax.tree_util.tree_leaves(s2.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_remat_matches_plain(rng):
    """jax.checkpoint must not change numerics, only memory."""
    model, tx, step_plain = build_everything(with_bn=True)
    from esn_tpu.train.losses import cross_entropy
    from esn_tpu.train.state import TrainState
    from esn_tpu.train.step import make_train_step
    import jax
    import jax.numpy as jnp
    import numpy as np

    loss_fn = lambda lg, lb: cross_entropy(lg, lb, num_classes=NUM_CLASSES)
    step_remat = make_train_step(model, loss_fn, tx, donate=False, remat=True)

    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 16, 16, 3), jnp.float32))
    batch = {"image": jnp.asarray(rng.rand(2, 16, 16, 3), jnp.float32),
             "label": jnp.asarray(rng.randint(0, NUM_CLASSES, (2, 16, 16)))}
    key = jax.random.PRNGKey(1)

    s1, m1 = step_plain(TrainState.create(variables, tx), batch, key)
    s2, m2 = step_remat(TrainState.create(variables, tx), batch, key)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-6)
    l1 = jax.tree_util.tree_leaves(s1.params)
    l2 = jax.tree_util.tree_leaves(s2.params)
    for a, b in zip(l1, l2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
