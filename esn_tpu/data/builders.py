"""Dataset builders — reference ``builders/dataset_builder.py`` parity [R].

``build_dataset_train`` / ``build_dataset_test`` reproduce the reference
surface: pick the list file by train_type, load-or-compute the inform stats
pickle, return loaders. Departure: the returned train "loader" yields raw
uint8 batches; augmentation happens on device via the ``augment`` fn also
returned (wired into the trainer's step pipeline).

When the dataset root has no list files (this build environment ships no
Cityscapes/CamVid), builders fall back to the synthetic dataset so every CLI
path stays executable end-to-end; the fallback is reported loudly.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .augment import make_augment_fn, make_eval_transform
from .datasets import (ManifestDataset, SyntheticDataset, get_spec)
from .inform import load_or_compute_inform
from .loader import BatchLoader

DEFAULT_ROOT = os.environ.get("ESN_DATA_ROOT", "dataset")


def _list_path(root: str, dataset: str, split: str) -> str:
    return os.path.join(root, dataset, f"{dataset}_{split}_list.txt")


def _have_real_data(root: str, dataset: str, split: str) -> bool:
    return os.path.exists(_list_path(root, dataset, split))


def _make_dataset(root, dataset, split, spec, synthetic_len, resize_hw=None,
                  seed=0, synthetic_hw=None):
    if _have_real_data(root, dataset, split):
        return ManifestDataset.from_list_file(
            _list_path(root, dataset, split), spec,
            root=os.path.join(root, dataset), resize_hw=resize_hw), True
    print(f"[esn_tpu.data] WARNING: no list file for "
          f"{dataset}/{split} under {root!r} — using synthetic data")
    return SyntheticDataset(spec, length=synthetic_len, seed=seed,
                            hw=resize_hw or synthetic_hw or spec.source_hw
                            ), False


def build_dataset_train(dataset: str, input_size: Tuple[int, int],
                        batch_size: int, train_type: str = "train",
                        random_scale: bool = True, random_mirror: bool = True,
                        aug_mode: str = "batch",
                        num_workers: int = 4, root: str = DEFAULT_ROOT,
                        synthetic_len: int = 64,
                        val_size: Optional[Tuple[int, int]] = None,
                        synthetic_hw: Optional[Tuple[int, int]] = None):
    """Returns (datas, train_loader, val_loader, augment_fn, eval_transform).

    datas = {'classWeights','mean','std'} — the inform dict [R].
    ``val_size`` optionally fixes the val resolution (reference
    CityscapesValDataSet resize mode [R]); default keeps source resolution.
    """
    spec = get_spec(dataset)
    split = "trainval" if train_type == "trainval" else "train"
    train_ds, real = _make_dataset(root, dataset, split, spec, synthetic_len,
                                   synthetic_hw=synthetic_hw)
    val_ds, _ = _make_dataset(root, dataset, "val", spec,
                              max(synthetic_len // 4, 8), seed=1,
                              resize_hw=val_size, synthetic_hw=synthetic_hw)

    inform_path = os.path.join(root, "inform", f"{dataset}_inform.pkl") \
        if real else None
    datas = load_or_compute_inform(
        inform_path, train_ds.stats_samples, spec.num_classes,
        spec.ignore_label)

    train_loader = BatchLoader(train_ds, batch_size, shuffle=True,
                               drop_last=True, num_workers=num_workers)
    val_loader = BatchLoader(val_ds, batch_size, shuffle=False,
                             drop_last=False, num_workers=num_workers)

    if hasattr(train_ds, "hw"):          # synthetic: fixed size by build
        source_hw = train_ds.hw
    else:
        # real data: trust the files, not the spec — probe the first record
        # and normalize any odd-sized stragglers to it (XLA needs one static
        # source shape; the reference assumes it implicitly [R: dataset/*.py])
        source_hw = tuple(train_ds[0]["image"].shape[:2])
        train_ds.resize_hw = source_hw

    augment_fn = make_augment_fn(
        crop_hw=tuple(input_size), source_hw=source_hw,
        mean=datas["mean"], ignore_label=spec.ignore_label,
        random_scale=random_scale, random_mirror=random_mirror,
        per_image_scale=(aug_mode == "reference"))
    eval_transform = make_eval_transform(mean=datas["mean"])
    return datas, train_loader, val_loader, augment_fn, eval_transform


def build_dataset_test(dataset: str, num_workers: int = 4,
                       none_gt: bool = False, root: str = DEFAULT_ROOT,
                       batch_size: int = 1, synthetic_len: int = 16,
                       synthetic_hw: Optional[Tuple[int, int]] = None):
    """Returns (datas, test_loader, eval_transform).

    none_gt=True selects the unlabeled test split (predict.py) [R].
    """
    spec = get_spec(dataset)
    split = "test" if none_gt else "val"
    # synthetic val data uses the seed build_dataset_train gives it, so a
    # checkpoint evaluated here scores on the images training validated on
    ds, real = _make_dataset(root, dataset, split, spec, synthetic_len,
                             seed=2 if none_gt else 1,
                             synthetic_hw=synthetic_hw)
    if isinstance(ds, SyntheticDataset) and none_gt:
        ds.with_labels = False

    train_ds, train_real = _make_dataset(root, dataset, "train", spec,
                                         synthetic_len,
                                         synthetic_hw=synthetic_hw)
    inform_path = os.path.join(root, "inform", f"{dataset}_inform.pkl") \
        if train_real else None
    datas = load_or_compute_inform(
        inform_path, train_ds.stats_samples, spec.num_classes,
        spec.ignore_label)

    loader = BatchLoader(ds, batch_size, shuffle=False, drop_last=False,
                         num_workers=num_workers)
    eval_transform = make_eval_transform(mean=datas["mean"])
    return datas, loader, eval_transform
