#!/usr/bin/env python
"""Evaluation CLI — reference ``test.py`` surface [R].

Loads a checkpoint, runs the val split, prints per-class IoU + mIoU.
``--best`` sweeps every checkpoint in the run dir for the best epoch;
``--save`` writes colorized predictions.
"""
import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="esn_tpu evaluation")
    p.add_argument("--model", default="ENet")
    p.add_argument("--dataset", default="camvid",
                   choices=["cityscapes", "camvid"])
    p.add_argument("--checkpoint", default="")
    p.add_argument("--best", action="store_true",
                   help="sweep all checkpoints in the run dir (from "
                        "--checkpoint's directory, or derived from "
                        "--savedir/--batch_size/--train_type like train.py)")
    p.add_argument("--savedir", default="./checkpoint",
                   help="train.py savedir, for --best without --checkpoint")
    p.add_argument("--train_type", default="train",
                   choices=["train", "trainval"])
    p.add_argument("--train_batch_size", type=int, default=8,
                   help="batch size of the training run being swept "
                        "(names the run dir), for --best without --checkpoint")
    p.add_argument("--save", action="store_true",
                   help="save colorized predictions")
    p.add_argument("--save_seg_dir", default="./result")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--data_root", default=None)
    p.add_argument("--synthetic_len", type=int, default=16)
    p.add_argument("--synthetic_hw", default=None, help="H,W synthetic source")
    p.add_argument("--compute_dtype", default=None)
    p.add_argument("--cuda", type=bool, default=True, help="[compat] ignored")
    p.add_argument("--gpus", default="0", help="[compat] ignored")
    return p.parse_args(argv)


def evaluate(model, variables, loader, eval_transform, spec, *,
             save_dir=None, dataset="camvid", compute_dtype=None, mesh=None,
             eval_step=None):
    import jax.numpy as jnp
    import numpy as np
    from esn_tpu.data import palettes
    from esn_tpu.parallel import mesh as meshlib
    from esn_tpu.train.evaluation import run_eval
    from esn_tpu.train.metrics import iou_from_confusion
    from esn_tpu.train.step import make_eval_step

    if mesh is None:
        mesh = meshlib.make_mesh()  # all devices on the data axis
    if eval_step is None:
        eval_step = make_eval_step(
            model, spec.num_classes, ignore_index=spec.ignore_label,
            compute_dtype=compute_dtype or jnp.float32)

    per_image = None
    if save_dir:
        def per_image(i, pred_hw, batch):
            palettes.save_predict(
                pred_hw, np.asarray(batch["label"][i]),
                batch["name"][i], dataset, save_dir, output_grey=False,
                output_color=True)

    cm = run_eval(eval_step, variables, loader, eval_transform,
                  spec.num_classes, mesh=mesh, per_image=per_image)
    iou, miou = iou_from_confusion(jnp.asarray(cm))
    return np.asarray(iou), float(miou)


def main(argv=None):
    args = parse_args(argv)
    import jax
    import jax.numpy as jnp
    from esn_tpu.utils.runtime import (default_compute_dtype,
                                       setup_compile_cache)
    setup_compile_cache()
    from esn_tpu.data import build_dataset_test
    from esn_tpu.data.datasets import get_spec
    from esn_tpu.models import build_model
    from esn_tpu.train import checkpoint as ckpt

    kw = {"root": args.data_root} if args.data_root else {}
    if args.synthetic_hw:
        kw["synthetic_hw"] = tuple(
            int(v) for v in str(args.synthetic_hw).replace("x", ",").split(","))
    spec = get_spec(args.dataset)
    datas, loader, eval_transform = build_dataset_test(
        args.dataset, num_workers=args.num_workers, none_gt=False,
        batch_size=args.batch_size, synthetic_len=args.synthetic_len, **kw)

    model = build_model(args.model, spec.num_classes)
    # param shapes are spatial-size independent; init on a tiny sample
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), sample)

    candidates = []
    if args.best:
        if args.checkpoint:
            run_dir = os.path.dirname(args.checkpoint)
        else:
            # reference --best sweeps from the run config alone [R: test.py]:
            # reconstruct train.py's savedir layout {ds}/{model}bs{B}gpu{N}_{t}
            run_dir = os.path.join(
                args.savedir, args.dataset,
                f"{args.model}bs{args.train_batch_size}"
                f"gpu{jax.device_count()}_{args.train_type}")
        candidates = [p for _, p in ckpt.list_checkpoints(run_dir)]
        if not candidates:
            print(f"=> --best: no checkpoints found in {run_dir}")
    elif args.checkpoint:
        candidates = [args.checkpoint]

    dtype = jnp.dtype(args.compute_dtype or default_compute_dtype())

    # one mesh + one jitted eval step shared across the whole sweep — a
    # --best sweep over N checkpoints compiles once, not N times
    from esn_tpu.parallel import mesh as meshlib
    from esn_tpu.train.step import make_eval_step
    mesh = meshlib.make_mesh()
    eval_step = make_eval_step(model, spec.num_classes,
                               ignore_index=spec.ignore_label,
                               compute_dtype=dtype)

    if not candidates:
        print("=> no checkpoint given; evaluating random init")
        iou, miou = evaluate(model, variables, loader, eval_transform, spec,
                             save_dir=args.save_seg_dir if args.save else None,
                             dataset=args.dataset, compute_dtype=dtype,
                             mesh=mesh, eval_step=eval_step)
        _report(iou, miou, args.dataset)
        return 0

    best = (None, -1.0)
    for path in candidates:
        vars_i, meta = ckpt.load_variables(path, variables)
        iou, miou = evaluate(model, vars_i, loader, eval_transform, spec,
                             save_dir=args.save_seg_dir if args.save else None,
                             dataset=args.dataset, compute_dtype=dtype,
                             mesh=mesh, eval_step=eval_step)
        print(f"=> {os.path.basename(path)} (epoch {meta.get('epoch')}): "
              f"mIoU {miou:.4f}")
        if miou > best[1]:
            best = (path, miou)
            best_iou = iou
    print(f"=> best: {os.path.basename(best[0])} mIoU {best[1]:.4f}")
    _report(best_iou, best[1], args.dataset)
    return 0


def _report(iou, miou, dataset):
    from esn_tpu.data.palettes import CAMVID_CLASSES, CITYSCAPES_CLASSES
    names = CITYSCAPES_CLASSES if dataset == "cityscapes" else CAMVID_CLASSES
    for i, v in enumerate(iou):
        name = names[i] if i < len(names) else f"class{i}"
        print(f"  {name:>15s}: {v:.4f}")
    print(f"  {'meanIoU':>15s}: {miou:.4f}")


if __name__ == "__main__":
    sys.exit(main())
