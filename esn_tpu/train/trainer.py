"""Trainer — the framework core the reference never had.

Reference: ``train.py :: train_model/train/val`` [R] is a hand-rolled eager
epoch loop. Here it is a library class: config -> (data, model, mesh, jitted
steps) -> epoch loop with on-device augmentation, periodic validation,
per-epoch checkpoints, log.txt + curve PNGs (same observable surface as the
reference) plus structured JSONL.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn
from ..data import builders as data_builders
from ..data.datasets import get_spec
from ..models import build_model
from ..parallel import mesh as meshlib
from ..utils import profiling
from ..utils.params import count_params
from . import checkpoint as ckpt
from .losses import build_loss
from .metrics import iou_from_confusion
from .optimizers import build_optimizer
from .schedules import build_schedule
from .state import TrainState
from .step import make_eval_step, make_train_step


@dataclasses.dataclass
class TrainConfig:
    model: str = "ENet"
    dataset: str = "camvid"
    input_size: Tuple[int, int] = (360, 480)
    max_epochs: int = 300
    batch_size: int = 8
    lr: float = 4.5e-4
    optim: str = "adam"
    lr_schedule: str = "poly"
    poly_exp: float = 0.9
    warmup_iters: int = 500
    warmup_factor: float = 1.0 / 3.0
    weight_decay: float = 1e-4
    loss: str = "ce"            # ce | label_smoothing | ohem | focal | lovasz
    random_scale: bool = True
    random_mirror: bool = True
    aug_mode: str = "batch"     # batch | reference (per-image scale, PARITY.md)
    num_workers: int = 4
    train_type: str = "train"   # train | trainval
    resume: str = ""
    savedir: str = "./checkpoint"
    log_file: str = "log.txt"
    seed: int = 1
    val_epochs: int = 50        # validate every N epochs (reference ~50) [R]
    compute_dtype: Optional[str] = None  # None: runtime.default_compute_dtype
    grad_accum: int = 1
    data_root: str = data_builders.DEFAULT_ROOT
    synthetic_len: int = 64     # only used when real data is absent
    use_class_weights: bool = True
    val_size: Optional[Tuple[int, int]] = None  # None = source resolution
    synthetic_hw: Optional[Tuple[int, int]] = None  # shrink synthetic source
    profile_dir: str = ""       # capture a profiler trace of epoch 1 steps
    remat: bool = False         # rematerialize fwd in bwd (full-res memory)
    spatial: int = 1            # shard image H over a 'model' mesh axis
    encoder_checkpoint: str = ""  # graft a pretrained encoder (ESPNet stage 2)

    @property
    def run_dir(self) -> str:
        # mirrors reference savedir layout: {ds}/{model}bs{B}gpu{N}_{type}
        n_dev = jax.device_count()
        return os.path.join(self.savedir, self.dataset,
                            f"{self.model}bs{self.batch_size}"
                            f"gpu{n_dev}_{self.train_type}")


class Trainer:
    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.spec = get_spec(cfg.dataset)
        from ..utils.seed import setup_seed
        setup_seed(cfg.seed)

        # data
        (self.datas, self.train_loader, self.val_loader, self.augment,
         self.eval_transform) = data_builders.build_dataset_train(
            cfg.dataset, cfg.input_size, cfg.batch_size,
            train_type=cfg.train_type, random_scale=cfg.random_scale,
            random_mirror=cfg.random_mirror, aug_mode=cfg.aug_mode,
            num_workers=cfg.num_workers,
            root=cfg.data_root, synthetic_len=cfg.synthetic_len,
            val_size=cfg.val_size, synthetic_hw=cfg.synthetic_hw)

        # model
        self.model = build_model(cfg.model, self.spec.num_classes)
        h, w = cfg.input_size
        sample = jnp.zeros((1, h, w, 3), jnp.float32)
        variables = self.model.init(jax.random.PRNGKey(cfg.seed), sample)
        if cfg.encoder_checkpoint:
            # two-stage recipe (reference ESPNet encoderFile [R]): pretrain
            # the encoder model, then train the full net on top of it
            variables, _ = ckpt.load_encoder(cfg.encoder_checkpoint,
                                             variables)
        self.n_params = count_params(variables)

        # loss / schedule / optimizer
        weights = jnp.asarray(self.datas["classWeights"]) \
            if cfg.use_class_weights else None
        loss_kwargs = dict(num_classes=self.spec.num_classes,
                           ignore_index=self.spec.ignore_label)
        base_loss = build_loss(cfg.loss, **loss_kwargs)
        self.loss_fn = (lambda lg, lb: base_loss(lg, lb, class_weights=weights))
        iters_per_epoch = max(len(self.train_loader), 1)
        total_steps = cfg.max_epochs * iters_per_epoch
        self.schedule = build_schedule(
            cfg.lr_schedule, cfg.lr, total_steps, power=cfg.poly_exp,
            warmup_steps=cfg.warmup_iters, warmup_factor=cfg.warmup_factor)
        self.tx = build_optimizer(cfg.optim, self.schedule,
                                  weight_decay=cfg.weight_decay)

        # mesh + steps: use the most devices that divide the global batch;
        # with spatial>1, devices split into (data, model) and image height
        # is sharded over 'model' (SURVEY §5 — the vision analogue of
        # sequence parallelism; XLA SPMD inserts the conv halo exchanges)
        n_dev = jax.device_count()
        if cfg.spatial > 1:
            from ..parallel import spatial as splib
            splib.check_spatial_config(cfg.input_size, cfg.spatial)
            assert n_dev % cfg.spatial == 0, \
                f"{n_dev} devices not divisible by spatial={cfg.spatial}"
            avail = n_dev // cfg.spatial
            n_data = max(k for k in range(1, avail + 1)
                         if cfg.batch_size % k == 0)
            self.mesh = splib.make_spatial_mesh(n_data, cfg.spatial)
            self._shard_train_batch = lambda b: splib.shard_batch_spatial(
                b, self.mesh)
        else:
            usable = max(k for k in range(1, n_dev + 1)
                         if cfg.batch_size % k == 0)
            if usable != n_dev:
                print(f"[esn_tpu.train] batch_size {cfg.batch_size} not "
                      f"divisible by {n_dev} devices; data-parallel over "
                      f"{usable}")
            self.mesh = meshlib.make_mesh(jax.devices()[:usable])
            self._shard_train_batch = lambda b: meshlib.shard_batch(
                b, self.mesh)
        from ..utils.runtime import default_compute_dtype
        compute_dtype = jnp.dtype(cfg.compute_dtype
                                  or default_compute_dtype())
        # scanned resize-CE (ESN_TPU_FUSED_CE=1, default off): the loss
        # owns the upsample (losses.resize_cross_entropy) and the full-res
        # logits never materialize — see fused_resize_ce_spec's docstring.
        from .losses import fused_resize_ce_spec
        fused_loss, fwd_method = (None, None) if cfg.spatial > 1 \
            else fused_resize_ce_spec(self.model, cfg.loss)
        if fused_loss is not None:
            self.loss_fn = (lambda lg, lb: fused_loss(
                lg, lb, class_weights=weights, **loss_kwargs))
        self.train_step = make_train_step(
            self.model, self.loss_fn, self.tx,
            grad_accum=max(1, cfg.grad_accum), schedule=self.schedule,
            compute_dtype=compute_dtype, remat=cfg.remat,
            fwd_method=fwd_method)
        self.eval_step = make_eval_step(
            self.model, self.spec.num_classes,
            ignore_index=self.spec.ignore_label,
            compute_dtype=compute_dtype)

        # state (replicated over the mesh)
        self.state = meshlib.replicate(TrainState.create(variables, self.tx),
                                       self.mesh)
        self.start_epoch = 0
        if cfg.resume:
            self.state, meta = ckpt.load_checkpoint(cfg.resume, self.state)
            self.start_epoch = int(meta.get("epoch", 0))
            self.state = meshlib.replicate(self.state, self.mesh)

        os.makedirs(self.cfg.run_dir, exist_ok=True)
        self._log_path = os.path.join(self.cfg.run_dir, cfg.log_file)
        self._jsonl_path = os.path.join(self.cfg.run_dir, "events.jsonl")
        self._history = []  # (epoch, loss, lr, miou or None)
        self.step_losses = []  # per-step train losses of the last epoch
        self._step_timer = profiling.StepTimer()
        self._log_header()

    # ------------------------------------------------------------------ log
    def _log_header(self):
        mode = "a" if self.start_epoch else "w"
        with open(self._log_path, mode) as f:
            f.write(f"Model: {self.cfg.model}  dataset: {self.cfg.dataset}  "
                    f"params: {self.n_params}\n")
            f.write(f"devices: {jax.device_count()}  "
                    f"mesh: {tuple(self.mesh.shape.items())}\n")
            f.write("epoch\tlr\tloss_train\tmIoU_val\ttime_s\n")

    def _class_names(self):
        from ..data.palettes import CAMVID_CLASSES, CITYSCAPES_CLASSES
        names = CITYSCAPES_CLASSES if self.cfg.dataset == "cityscapes" \
            else CAMVID_CLASSES
        return [names[i] if i < len(names) else f"class{i}"
                for i in range(self.spec.num_classes)]

    def _log_epoch(self, epoch, loss, lr, miou, seconds, iou=None):
        miou_s = f"{miou:.4f}" if miou is not None else "-"
        with open(self._log_path, "a") as f:
            f.write(f"{epoch}\t{lr:.6f}\t{loss:.4f}\t{miou_s}\t"
                    f"{seconds:.1f}\n")
            if iou is not None:
                # per-class IoU lines at val epochs — same log.txt surface
                # as the reference [R: train.py val logging]
                for name, v in zip(self._class_names(), iou):
                    f.write(f"  {name:>15s} IoU: {float(v):.4f}\n")
        event = {"epoch": epoch, "loss": loss, "lr": lr,
                 "miou": miou, "time_s": seconds,
                 "step_losses": self.step_losses}
        if iou is not None:
            event["per_class_iou"] = [round(float(v), 6) for v in iou]
        steps = self._step_timer.summary()
        if steps:
            event["host_step"] = steps  # dispatch+input time, not device time
            self._step_timer.reset()
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(event) + "\n")

    # ---------------------------------------------------------------- train
    def train_epoch(self, epoch: int) -> Tuple[float, float]:
        cfg = self.cfg
        self.train_loader.set_epoch(epoch)
        rng = jax.random.PRNGKey(cfg.seed * 1000003 + epoch)
        losses, lr = [], 0.0
        do_trace = bool(cfg.profile_dir) and epoch == self.start_epoch
        # host decode + device transfer run one batch ahead of compute
        from ..data.loader import device_prefetch
        batches = device_prefetch(
            iter(self.train_loader), size=2,
            put_fn=lambda b: self._shard_train_batch(
                {"image": b["image"], "label": b["label"]}))
        with profiling.trace(cfg.profile_dir if do_trace else None):
            for i, batch in enumerate(batches):
                with self._step_timer.step():
                    aug_rng = jax.random.fold_in(rng, i)
                    images, labels = batch["image"], batch["label"]
                    with profiling.annotate("augment"):
                        x, y = self.augment(aug_rng, images, labels)
                    with profiling.annotate("train_step"):
                        self.state, metrics = self.train_step(
                            self.state, {"image": x, "label": y}, rng)
                    losses.append(metrics["loss"])
                    lr = metrics.get("lr", cfg.lr)
        self.step_losses = [float(v) for v in jax.device_get(losses)]
        mean_loss = float(jnp.mean(jnp.stack(losses))) if losses else 0.0
        return mean_loss, float(lr)

    def validate(self) -> Tuple[np.ndarray, float]:
        """Mesh-sharded validation: every batch padded to one fixed shape
        (single eval compile per resolution) and sharded over the mesh's
        data axis, so validation uses every device of the mesh."""
        from .evaluation import run_eval
        variables = {"params": self.state.params, "stats": self.state.stats}
        cm = run_eval(self.eval_step, variables, self.val_loader,
                      self.eval_transform, self.spec.num_classes,
                      mesh=self.mesh)
        iou, miou = iou_from_confusion(jnp.asarray(cm))
        return np.asarray(iou), float(miou)

    def fit(self, epochs: Optional[int] = None) -> float:
        cfg = self.cfg
        end_epoch = min(self.start_epoch + epochs, cfg.max_epochs) \
            if epochs is not None else cfg.max_epochs
        last_miou = None
        for epoch in range(self.start_epoch, end_epoch):
            t0 = time.time()
            loss, lr = self.train_epoch(epoch)
            miou = iou_vec = None
            if ((epoch + 1) % cfg.val_epochs == 0
                    or epoch + 1 == cfg.max_epochs):
                iou_vec, miou = self.validate()
                last_miou = miou
            dt = time.time() - t0
            self._log_epoch(epoch + 1, loss, lr, miou, dt, iou=iou_vec)
            ckpt.save_checkpoint(cfg.run_dir, epoch + 1, self.state,
                                 {"mIoU": miou if miou is not None else -1.0,
                                  "loss": loss})
            self._history.append((epoch + 1, loss, lr, miou))
            print(f"epoch {epoch + 1}/{cfg.max_epochs} loss {loss:.4f} "
                  f"lr {lr:.6f}"
                  + (f" mIoU {miou:.4f}" if miou is not None else "")
                  + f" ({dt:.1f}s)")
        self._plot_curves()
        if last_miou is None:
            _, last_miou = self.validate()
        return last_miou

    def _plot_curves(self):
        """loss/IoU PNGs, same artifacts as the reference [R: train.py]."""
        if not self._history:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        epochs = [h[0] for h in self._history]
        losses = [h[1] for h in self._history]
        fig, ax = plt.subplots()
        ax.plot(epochs, losses)
        ax.set_xlabel("epoch"), ax.set_ylabel("train loss")
        fig.savefig(os.path.join(self.cfg.run_dir, "loss_vs_epochs.png"))
        plt.close(fig)
        pts = [(e, m) for (e, _, _, m) in self._history if m is not None]
        if pts:
            fig, ax = plt.subplots()
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o")
            ax.set_xlabel("epoch"), ax.set_ylabel("val mIoU")
            fig.savefig(os.path.join(self.cfg.run_dir, "iou_vs_epochs.png"))
            plt.close(fig)
