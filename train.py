#!/usr/bin/env python
"""Training CLI — reference ``train.py`` surface [R] on the JAX core.

Example:
    python train.py --model ENet --dataset camvid --max_epochs 300 \
        --batch_size 8 --lr 4.5e-4 --lr_schedule poly

Flags kept for compatibility even where JAX makes them moot (--cuda/--gpus
select devices in the reference; here the device mesh is discovered
automatically and reported).
"""
import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="esn_tpu training")
    p.add_argument("--model", default="ENet")
    p.add_argument("--dataset", default="camvid",
                   choices=["cityscapes", "camvid"])
    p.add_argument("--input_size", default=None,
                   help="H,W crop size (default: dataset-native)")
    p.add_argument("--max_epochs", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=4.5e-4)
    p.add_argument("--optim", default="adam",
                   choices=["sgd", "adam", "adamw", "radam", "ranger"])
    p.add_argument("--lr_schedule", default="poly",
                   choices=["poly", "warmpoly", "constant"])
    p.add_argument("--poly_exp", type=float, default=0.9)
    p.add_argument("--warmup_iters", type=int, default=500)
    p.add_argument("--warmup_factor", type=float, default=1.0 / 3.0)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--use_ohem", action="store_true")
    p.add_argument("--use_label_smoothing", action="store_true")
    p.add_argument("--use_lovaszsoftmax", action="store_true")
    p.add_argument("--use_focal", action="store_true")
    p.add_argument("--random_mirror", type=bool, default=True)
    p.add_argument("--random_scale", type=bool, default=True)
    p.add_argument("--aug_mode", default="batch",
                   choices=["batch", "reference"],
                   help="'reference' = per-image scale draw with the 0.5-2.0"
                        " scale set (mIoU-parity mode, see PARITY.md);"
                        " 'batch' = per-batch scale (default, faster)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--train_type", default="train",
                   choices=["train", "trainval"])
    p.add_argument("--resume", default="")
    p.add_argument("--savedir", default="./checkpoint")
    p.add_argument("--logFile", default="log.txt")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--val_epochs", type=int, default=50)
    p.add_argument("--compute_dtype", default=None,
                   help="float32|bfloat16 (default: bf16 on GPU, else f32)")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--data_root", default=None)
    p.add_argument("--synthetic_len", type=int, default=64)
    p.add_argument("--synthetic_hw", default=None, help="H,W synthetic source")
    # compat no-ops (reference GPU flags)
    p.add_argument("--profile_dir", default="",
                   help="capture a jax.profiler trace of the first epoch")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize forward in backward (full-res memory)")
    p.add_argument("--spatial", type=int, default=1,
                   help="shard image height over N devices (full-res training)")
    p.add_argument("--encoder_checkpoint", default="",
                   help="pretrained encoder ckpt (ESPNet two-stage training)")
    p.add_argument("--cuda", type=bool, default=True,
                   help="[compat] ignored; devices come from the JAX mesh")
    p.add_argument("--gpus", default="0",
                   help="[compat] ignored; devices come from the JAX mesh")
    return p.parse_args(argv)


def config_from_args(args):
    from esn_tpu.data.datasets import get_spec
    from esn_tpu.train.trainer import TrainConfig
    from esn_tpu.utils.runtime import default_compute_dtype

    spec = get_spec(args.dataset)
    if args.input_size:
        h, w = (int(v) for v in str(args.input_size).replace("x", ",").split(","))
    else:
        h, w = spec.default_crop_hw
    loss = "ce"
    if args.use_ohem:
        loss = "ohem"
    elif args.use_label_smoothing:
        loss = "label_smoothing"
    elif args.use_lovaszsoftmax:
        loss = "lovasz"
    elif args.use_focal:
        loss = "focal"
    dtype = args.compute_dtype or default_compute_dtype()
    kw = dict(
        model=args.model, dataset=args.dataset, input_size=(h, w),
        max_epochs=args.max_epochs, batch_size=args.batch_size, lr=args.lr,
        optim=args.optim, lr_schedule=args.lr_schedule,
        poly_exp=args.poly_exp, warmup_iters=args.warmup_iters,
        warmup_factor=args.warmup_factor, weight_decay=args.weight_decay,
        loss=loss, random_scale=args.random_scale,
        random_mirror=args.random_mirror, aug_mode=args.aug_mode,
        num_workers=args.num_workers,
        train_type=args.train_type, resume=args.resume,
        savedir=args.savedir, log_file=args.logFile, seed=args.seed,
        val_epochs=args.val_epochs, compute_dtype=dtype,
        grad_accum=args.grad_accum, synthetic_len=args.synthetic_len,
        profile_dir=args.profile_dir, remat=args.remat, spatial=args.spatial,
        encoder_checkpoint=args.encoder_checkpoint)
    if args.synthetic_hw:
        kw["synthetic_hw"] = tuple(
            int(v) for v in str(args.synthetic_hw).replace("x", ",").split(","))
    if args.data_root:
        kw["data_root"] = args.data_root
    return TrainConfig(**kw)


def main(argv=None):
    args = parse_args(argv)
    from esn_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    cfg = config_from_args(args)
    from esn_tpu.train.trainer import Trainer
    trainer = Trainer(cfg)
    print(f"=> model {cfg.model} ({trainer.n_params} params), "
          f"dataset {cfg.dataset}, crop {cfg.input_size}, "
          f"loss {cfg.loss}, optim {cfg.optim}/{cfg.lr_schedule}")
    miou = trainer.fit()
    print(f"=> final mIoU: {miou:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
