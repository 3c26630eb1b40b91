#!/usr/bin/env python
"""On-card smoke test: the main path once, end to end, on NVIDIA GPUs.

    python chip_smoke.py            # one card: device, train, evaluate +
                                    # predict and kernel phases
    python chip_smoke.py --cards 4  # only the multi-device phase

Everything runs in this one process: a second JAX process could not
reserve the card's memory. The CLIs are driven through their
``main(argv)``. Data are synthetic at Cityscapes' full widths (19 classes,
1024x2048 source); the model is Fast-SCNN with random weights from a seed.
A failed check raises and the process exits non-zero. Without a GPU, or
outside a checkout of the repository, it exits non-zero and prints no
result.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
Every number printed before it carries the card's name and power limit.
"""
import argparse
import contextlib
import io
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke")
SEED = 1
SRC_HW = (1024, 2048)           # Cityscapes source resolution
CROP_HW = None                  # None: the dataset's default train crop
TRAIN_STEPS = 3
BATCH = 8
# bf16 vs f32-"highest" first-step loss: bf16 keeps 8 mantissa bits, and
# through Fast-SCNN's ~20 conv+BN layers at random init the class-weighted
# CE moves by well under this
FIRST_LOSS_RTOL = 2e-2
# resize+argmax kernel vs the plain f32 reference: in f32 only ties at
# the association level of the separable interpolation may differ; in bf16
# the plain tail rounds to bf16 before its argmax and creates ties
AGREE_F32 = 0.9999
AGREE_BF16 = 0.99
PREDICT_BATCH = 128
TIMED_STEPS = 10
# the multi-device phase: f32 under "highest", one SGD step; the layouts
# differ only in reduction order. The loss and the BN statistics are well
# conditioned. The first step's gradient is not: in float32 it already sits
# 1.5e-2 (rel L2) from a float64 run of the same step on one device, while
# float64 on four devices matches float64 on one to 1e-7 (CPU, 128x256), so
# the update is held to a bound that only a wrong reduction can break (a
# missing psum or a per-shard BN is off by O(1))
MULTI_LOSS_RTOL = 1e-4
MULTI_UPDATE_RTOL = 5e-2
MULTI_STATS_RTOL = 1e-4

CARD = "?"


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def measured(msg: str) -> None:
    say(f"{msg} ({CARD})")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------------ device
def device_phase(devices) -> str:
    import jax
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    cards = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    check(bool(cards), "nvidia-smi listed no card")
    for ln in cards:
        print(ln, flush=True)
    say(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind} "
        f"({devices[0].platform})")
    return cards[0]


# ------------------------------------------------------------------- train
def _data_argv(work):
    return ["--model", "fastscnn", "--dataset", "cityscapes",
            "--data_root", os.path.join(work, "nodata"),
            "--synthetic_hw", "%d,%d" % SRC_HW]


def _train_argv(work):
    crop = ["--input_size", "%d,%d" % CROP_HW] if CROP_HW else []
    return _data_argv(work) + crop + [
        "--batch_size", str(BATCH), "--max_epochs", "1",
        "--synthetic_len", str(BATCH * TRAIN_STEPS),
        "--val_epochs", "1", "--seed", str(SEED),
        "--savedir", os.path.join(work, "ckpt")]


def train_phase(work):
    """train.main at the default crop, validation at source resolution;
    returns (checkpoint path, epoch event)."""
    import jax
    import numpy as np
    import train as train_cli
    from esn_tpu.train import checkpoint as ckpt
    from esn_tpu.train.trainer import Trainer

    argv = _train_argv(work)
    t0 = time.perf_counter()
    check(train_cli.main(argv) == 0, "train.main failed")
    say(f"train.main: {time.perf_counter() - t0:.1f} s incl. compilation")
    run_dir = train_cli.config_from_args(train_cli.parse_args(argv)).run_dir
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        event = [json.loads(ln) for ln in f][-1]
    losses = event["step_losses"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train losses {losses}")
    check(event["miou"] is not None and len(event["per_class_iou"]) == 19,
          "no validation at the end of training")
    measured(f"train: step losses {losses}, val mIoU {event['miou']}")

    # reference: the same first step in float32 under "highest" precision
    ref_argv = argv + ["--compute_dtype", "float32",
                       "--savedir", os.path.join(work, "ref")]
    ref = Trainer(train_cli.config_from_args(train_cli.parse_args(ref_argv)))
    init = jax.device_get(ref.state)
    with jax.default_matmul_precision("highest"):
        ref.train_epoch(0)
    want = ref.step_losses[0]
    rel = abs(losses[0] - want) / abs(want)
    measured(f"first-step loss: default dtype {losses[0]:.6f}, float32 "
             f"'highest' {want:.6f}, rel diff {rel:.2e} "
             f"(bound {FIRST_LOSS_RTOL})")
    check(rel <= FIRST_LOSS_RTOL, "first-step loss off its f32 reference")

    path = os.path.join(run_dir, "model_1.ckpt")
    state, meta = ckpt.load_checkpoint(path, init)
    check(meta["epoch"] == 1 and int(state.step) == TRAIN_STEPS,
          f"checkpoint meta {meta}, step {state.step}")
    changed = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(state.params),
        jax.tree_util.tree_leaves(init.params))]
    check(sum(changed) > len(changed) // 2,
          f"only {sum(changed)}/{len(changed)} param tensors changed")
    again = ckpt.save_checkpoint(os.path.join(work, "resave"), 1, state,
                                 {k: v for k, v in meta.items()
                                  if k != "epoch"})
    with np.load(path) as za, np.load(again) as zb:
        check(sorted(za.files) == sorted(zb.files), "checkpoint keys differ")
        for k in za.files:
            check(za[k].dtype == zb[k].dtype
                  and za[k].tobytes() == zb[k].tobytes(),
                  f"checkpoint leaf {k} not restored bit-exactly")
    say(f"checkpoint: {sum(changed)}/{len(changed)} param tensors changed, "
        f"restored bit-exactly")
    return path, event


# ------------------------------------------------------- evaluate, predict
def _iou_table(text):
    """{class name: printed value} from test.py's report."""
    out = {}
    for ln in text.splitlines():
        name, sep, val = ln.rpartition(":")
        if sep and ln.startswith("  "):
            try:
                out[name.strip()] = float(val)
            except ValueError:
                pass
    return out


def _read_png(path):
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = head[:4]
    ch = {0: 1, 2: 3}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = rows.reshape(h, 1 + w * ch)
    check(depth == 8 and not rows[:, 0].any(), f"{path}: unexpected encoding")
    img = rows[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def eval_predict_phase(work, ckpt_path, event):
    import numpy as np
    import predict as predict_cli
    import test as test_cli
    from esn_tpu.data import palettes

    val_len = max(BATCH * TRAIN_STEPS // 4, 8)   # the train-time val split
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = test_cli.main(_data_argv(work) + [
            "--checkpoint", ckpt_path, "--batch_size", str(BATCH),
            "--synthetic_len", str(val_len)])
    print(buf.getvalue(), end="")
    check(rc == 0, "test.main failed")
    say(f"test.main: {time.perf_counter() - t0:.1f} s")
    got = _iou_table(buf.getvalue())
    miou = got.pop("meanIoU", None)
    check(f"{miou:.4f}" == f"{event['miou']:.4f}",
          f"test.py mIoU {miou} != train-time val mIoU {event['miou']}")
    # events.jsonl keeps class IoUs at 6 decimals, test.py prints 4
    want = dict(zip(palettes.CITYSCAPES_CLASSES, event["per_class_iou"]))
    check(got.keys() == want.keys() and all(
        abs(got[n] - want[n]) <= 5e-5 + 1e-6 for n in want),
        f"test.py class IoUs {got} != train-time val {want}")
    measured(f"evaluate: mIoU {miou:.4f} equals the train-time val mIoU; "
             f"all 19 class IoUs agree to the printed digit")

    pred_dir = os.path.join(work, "pred")
    t0 = time.perf_counter()
    check(predict_cli.main(_data_argv(work) + [
        "--checkpoint", ckpt_path, "--batch_size", "2",
        "--synthetic_len", "2", "--save_seg_dir", pred_dir]) == 0,
        "predict.main failed")
    say(f"predict.main: {time.perf_counter() - t0:.1f} s")
    ids = set(palettes.CITYSCAPES_TRAINID_TO_LABELID.tolist())
    colors = {tuple(c) for c in palettes.CITYSCAPES_PALETTE.tolist()}
    for i in range(2):
        base = os.path.join(pred_dir, f"synthetic_{i:05d}")
        grey = _read_png(base + ".png")
        rgb = _read_png(base + "_color.png")
        check(grey.shape == SRC_HW and set(np.unique(grey).tolist()) <= ids,
              f"{base}.png: shape {grey.shape}")
        check(rgb.shape == SRC_HW + (3,) and {tuple(c) for c in np.unique(
            rgb.reshape(-1, 3), axis=0).tolist()} <= colors,
            f"{base}_color.png: shape {rgb.shape}")
    say(f"predict: 2 grey label-ID and 2 colour PNGs at "
        f"{SRC_HW[0]}x{SRC_HW[1]}")


# ------------------------------------------------------------------ kernel
def _lowres_shapes():
    """(h, w, C, r) -> models, for every logits_lowres model whose
    resize+argmax tail the fused kernel takes at the source resolution."""
    import jax
    import jax.numpy as jnp
    from esn_tpu import nn
    from esn_tpu.models import available_models, build_model
    from esn_tpu.ops.classify import resize_argmax_factor

    shapes = {}
    x = jax.ShapeDtypeStruct((1,) + SRC_HW + (3,), jnp.float32)
    for name in available_models():
        model = build_model(name, 19)
        if not hasattr(model, "logits_lowres"):
            continue
        v = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 64, 64, 3))))
        y = jax.eval_shape(lambda v, x: nn.apply(
            model, v, x, method="logits_lowres"), v, x)
        r = resize_argmax_factor(y.shape, SRC_HW)
        if r is not None:
            shapes.setdefault(tuple(y.shape[1:]) + (r,), []).append(name)
    return shapes


def _time(fn, *args):
    import jax
    ts = []
    for _ in range(TIMED_STEPS // 2):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return ts


def kernel_phase():
    import jax
    import jax.numpy as jnp
    from esn_tpu import nn
    from esn_tpu.models import build_model
    from esn_tpu.ops.classify import fused_resize_argmax
    from esn_tpu.ops.pallas.resize_argmax import resize_argmax_ref

    shapes = _lowres_shapes()
    check(bool(shapes), "no model takes the fused resize+argmax tail")
    ref_fn = jax.jit(resize_argmax_ref, static_argnums=1)
    for (h, w, c, r), names in sorted(shapes.items()):
        y32 = jax.random.normal(jax.random.PRNGKey(SEED), (2, h, w, c))
        for dtype, bound in ((jnp.float32, AGREE_F32),
                             (jnp.bfloat16, AGREE_BF16)):
            y = y32.astype(dtype)
            got = fused_resize_argmax(y, (r * h, r * w))
            check(got is not None, "the GPU did not select the kernel")
            with jax.default_matmul_precision("highest"):
                want = ref_fn(y, r)
            agree = float(jnp.mean((got == want).astype(jnp.float32)))
            measured(f"resize+argmax kernel vs plain f32 'highest' "
                     f"reference, (2,{h},{w},{c}) x{r} "
                     f"{jnp.dtype(dtype).name} [{','.join(names)}]: "
                     f"agreement {agree:.6f} (bound {bound})")
            check(agree >= bound, "kernel disagrees with its reference")

    # end to end: fastscnn predict at the source resolution, bf16, b128
    model = build_model("fastscnn", 19)
    v = model.init(jax.random.PRNGKey(SEED), jnp.zeros((1, 64, 64, 3)))
    x = jax.random.normal(jax.random.PRNGKey(SEED + 1),
                          (PREDICT_BATCH,) + SRC_HW + (3,), jnp.bfloat16)
    fused = jax.jit(lambda v, x: nn.apply(model, v, x, method="predict"))
    plain = jax.jit(lambda v, x: jnp.argmax(
        nn.apply(model, v, x), axis=-1).astype(jnp.int32))
    agree = float(jnp.mean((fused(v, x) == plain(v, x)).astype(jnp.float32)))
    measured(f"fastscnn b{PREDICT_BATCH} predict: fused vs plain tail "
             f"agreement {agree:.6f} (bound {AGREE_BF16})")
    check(agree >= AGREE_BF16, "fused and plain predict disagree")
    times = {"plain": [], "fused": []}
    for which in ("plain", "fused", "fused", "plain"):
        times[which] += _time(fused if which == "fused" else plain, v, x)
    for which, ts in times.items():
        med = statistics.median(ts)
        measured(f"fastscnn predict {SRC_HW[0]}x{SRC_HW[1]} bf16 "
                 f"b{PREDICT_BATCH}, {which} tail: median of {len(ts)} "
                 f"steps {med * 1e3:.2f} ms = {PREDICT_BATCH / med:.2f} "
                 f"img/s")


# ------------------------------------------------------------ multi-device
def _rel(a, b):
    import jax
    import numpy as np
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    num = sum(float(np.sum((np.asarray(x, np.float64) - y) ** 2))
              for x, y in zip(la, lb))
    den = sum(float(np.sum(np.asarray(x, np.float64) ** 2)) for x in la)
    return (num / max(den, 1e-30)) ** 0.5


def multicard_phase(devices, hw=SRC_HW):
    """One fastscnn train step with the same weights and batch, data-
    parallel over all ``devices`` (global batch 8) and data-parallel x
    height-sharded 2x2 (global batch 2), each against one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from esn_tpu.models import build_model
    from esn_tpu.parallel import mesh as meshlib
    from esn_tpu.parallel import spatial as splib
    from esn_tpu.train.losses import cross_entropy
    from esn_tpu.train.optimizers import build_optimizer
    from esn_tpu.train.state import TrainState
    from esn_tpu.train.step import make_train_step

    model = build_model("fastscnn", 19)
    variables = model.init(jax.random.PRNGKey(SEED),
                           jnp.zeros((1, 64, 64, 3)))
    tx = build_optimizer("sgd", 0.1, weight_decay=0.0)
    step = make_train_step(
        model, lambda lg, lb: cross_entropy(lg, lb, num_classes=19), tx,
        compute_dtype=jnp.float32, donate=False)
    rng = np.random.RandomState(SEED)
    data = {"image": rng.rand(8, *hw, 3).astype(np.float32),
            "label": rng.randint(0, 19, (8, *hw)).astype(np.int32)}
    p0 = variables["params"]

    def run(state, batch):
        with jax.default_matmul_precision("highest"):
            s, m = step(state, batch, jax.random.PRNGKey(0))
        s = jax.device_get(s)
        upd = jax.tree_util.tree_map(lambda n, o: np.asarray(n) - o,
                                     s.params, p0)
        return float(m["loss"]), upd, s.stats

    def one(batch):
        put = lambda t: jax.device_put(t, devices[0])
        return run(put(TrainState.create(variables, tx)), put(batch))

    mesh = meshlib.make_mesh(devices)
    dp = run(meshlib.replicate(TrainState.create(variables, tx), mesh),
             meshlib.shard_batch(data, mesh))
    small = {k: v[:2] for k, v in data.items()}
    splib.check_spatial_config(hw, 2)
    smesh = splib.make_spatial_mesh(2, 2, devices)
    sp = run(splib.replicate(TrainState.create(variables, tx), smesh),
             splib.shard_batch_spatial(small, smesh))
    for tag, got, want in ((f"data-parallel {len(devices)}, b8", dp,
                            one(data)),
                           ("data-parallel 2 x spatial 2, b2", sp,
                            one(small))):
        dl = abs(got[0] - want[0]) / abs(want[0])
        du, ds = _rel(want[1], got[1]), _rel(want[2], got[2])
        measured(f"{tag} at {hw[0]}x{hw[1]} vs one device, f32 'highest': "
                 f"loss {got[0]:.6f} vs {want[0]:.6f} (rel {dl:.2e}, "
                 f"bound {MULTI_LOSS_RTOL}); param update rel L2 {du:.2e} "
                 f"(bound {MULTI_UPDATE_RTOL}); BN stats rel L2 {ds:.2e} "
                 f"(bound {MULTI_STATS_RTOL})")
        check(dl <= MULTI_LOSS_RTOL and du <= MULTI_UPDATE_RTOL
              and ds <= MULTI_STATS_RTOL, f"{tag} disagrees with one device")


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=[1, 4],
                   help="4: run only the multi-device phase on 4 cards")
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "esn_tpu")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < args.cards:
        print(f"chip_smoke: needs {args.cards} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 1
    from esn_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    CARD = device_phase(devices)
    t0 = time.perf_counter()
    if args.cards > 1:
        multicard_phase(devices[:args.cards])
    else:
        shutil.rmtree(WORK, ignore_errors=True)
        ckpt_path, event = train_phase(WORK)
        eval_predict_phase(WORK, ckpt_path, event)
        kernel_phase()
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
