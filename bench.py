#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line.

Headline metric (BASELINE.json): Cityscapes 2048x1024 images/sec on the
flagship Fast-SCNN, inference on one GPU in the default compute dtype.
vs_baseline is the ratio to the reference's paper-reported 123.5 fps @
2048x1024 (TitanXp, the PyTorch zoo's headline number — BASELINE.md).

Each step is one jitted call closed by ``block_until_ready``; the value is
the median over ``--steps`` warm steps. It refuses to time the CPU.

Usage: python bench.py [--model fastscnn] [--batch 128] [--mode infer|train]
"""
import argparse
import json
import statistics
import sys
import time

BASELINES_FPS = {  # reference fps @ 2048x1024 (BASELINE.md; paper-reported)
    "fastscnn": 123.5,
    "contextnet": 65.0,
    # ENet paper reports 1280x720 @ 19fps (TitanX); 2048x1024 is 2.28x the
    # pixels -> ~8.3 fps extrapolated
    "enet": 8.3,
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="fastscnn")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--mode", default="infer", choices=["infer", "train"])
    p.add_argument("--size", default="1024,2048")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--dtype", default=None,
                   help="float32|bfloat16 (default: as the CLIs choose)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from esn_tpu.models import build_model
    from esn_tpu.train.losses import cross_entropy
    from esn_tpu.train.optimizers import build_optimizer
    from esn_tpu.train.state import TrainState
    from esn_tpu.train.step import make_train_step
    from esn_tpu.utils.runtime import (default_compute_dtype,
                                       setup_compile_cache)

    dev = jax.devices()
    if dev[0].platform == "cpu":
        print("bench.py: no accelerator found; refusing to time the CPU",
              file=sys.stderr)
        return 1
    setup_compile_cache()
    h, w = (int(v) for v in args.size.split(","))
    classes = 19
    dtype = jnp.dtype(args.dtype or default_compute_dtype())

    model = build_model(args.model, classes)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 128, 128, 3), jnp.float32))
    key = jax.random.PRNGKey(1)
    images = jax.random.normal(key, (args.batch, h, w, 3), dtype)

    if args.mode == "infer":
        from esn_tpu import nn
        run = jax.jit(lambda v, x: nn.apply(model, v, x, method="predict"))
        fixed_args = (variables, images)
    else:
        labels = jax.random.randint(jax.random.PRNGKey(2),
                                    (args.batch, h, w), 0, classes)
        loss_fn = lambda lg, lb: cross_entropy(lg, lb, num_classes=classes)
        tx = build_optimizer("adam", 1e-3)
        step = make_train_step(model, loss_fn, tx, compute_dtype=dtype,
                               donate=False)
        state0 = TrainState.create(variables, tx)
        run = lambda s, b: step(s, b, key)
        fixed_args = (state0, {"image": images, "label": labels})

    for _ in range(args.warmup):
        jax.block_until_ready(run(*fixed_args))
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*fixed_args))
        times.append(time.perf_counter() - t0)
    ips = args.batch / statistics.median(times)

    # the reference publishes inference fps only; train mode has no baseline
    base = BASELINES_FPS.get(args.model.lower()) \
        if args.mode == "infer" else None
    print(json.dumps({
        "metric": f"{args.model}_{h}x{w}_{args.mode}_images_per_sec",
        "value": ips,
        "unit": "images/sec",
        "vs_baseline": ips / base if base else None,
        "dtype": dtype.name,
        "device": {"platform": dev[0].platform, "kind": dev[0].device_kind,
                   "count": len(dev)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
