#!/usr/bin/env python
"""Prediction CLI — reference ``predict.py`` surface [R].

Runs the unlabeled test split, writes grey trainID PNGs (Cityscapes: converted
to labelIDs for server submission) and/or colorized PNGs.
"""
import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="esn_tpu prediction")
    p.add_argument("--model", default="ENet")
    p.add_argument("--dataset", default="camvid",
                   choices=["cityscapes", "camvid"])
    p.add_argument("--checkpoint", default="")
    p.add_argument("--save_seg_dir", default="./result/predict")
    p.add_argument("--output_grey", action="store_true", default=True)
    p.add_argument("--output_color", action="store_true", default=True)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--data_root", default=None)
    p.add_argument("--synthetic_len", type=int, default=8)
    p.add_argument("--synthetic_hw", default=None, help="H,W synthetic source")
    p.add_argument("--compute_dtype", default=None)
    p.add_argument("--cuda", type=bool, default=True, help="[compat] ignored")
    p.add_argument("--gpus", default="0", help="[compat] ignored")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from esn_tpu.utils.runtime import (default_compute_dtype,
                                       setup_compile_cache)
    setup_compile_cache()
    from esn_tpu.data import build_dataset_test, palettes
    from esn_tpu.data.datasets import get_spec
    from esn_tpu.models import build_model
    from esn_tpu.train import checkpoint as ckpt
    from esn_tpu.train.step import make_predict_step

    kw = {"root": args.data_root} if args.data_root else {}
    if args.synthetic_hw:
        kw["synthetic_hw"] = tuple(
            int(v) for v in str(args.synthetic_hw).replace("x", ",").split(","))
    spec = get_spec(args.dataset)
    datas, loader, eval_transform = build_dataset_test(
        args.dataset, num_workers=args.num_workers, none_gt=True,
        batch_size=args.batch_size, synthetic_len=args.synthetic_len, **kw)

    model = build_model(args.model, spec.num_classes)
    # param shapes are spatial-size independent; init on a tiny sample
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), sample)
    if args.checkpoint:
        variables, _ = ckpt.load_variables(args.checkpoint, variables)

    dtype = jnp.dtype(args.compute_dtype or default_compute_dtype())
    predict = make_predict_step(model, compute_dtype=dtype)

    count = 0
    for batch in loader:
        images = eval_transform(jnp.asarray(batch["image"]))
        pred = predict(variables, images)
        for i, name in enumerate(batch["name"]):
            palettes.save_predict(
                np.asarray(pred[i]), None, name, args.dataset,
                args.save_seg_dir, output_grey=args.output_grey,
                output_color=args.output_color)
            count += 1
    print(f"=> wrote {count} predictions to {args.save_seg_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
