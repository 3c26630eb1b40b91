"""Dataset definitions: manifest-driven Cityscapes / CamVid + synthetic.

Reference: ``dataset/cityscapes.py`` / ``dataset/camvid.py`` [R] — torch
Datasets doing cv2 decode + full CPU-side augmentation in forked DataLoader
workers. Split of responsibilities:

- host (this file): manifest parsing, image decode (cv2 BGR to match the
  reference's mean/std conventions), static resize for val — cheap, IO-bound;
- device (augment.py): scale-jitter/crop/mirror/normalize as part of the
  jitted input program, feeding device-resident batches.

Dataset contracts (match the reference):
- Cityscapes: 19 classes, ignore_label 255, source 1024x2048, BGR uint8,
  labels are trainID uint8 PNGs.
- CamVid: 11 classes, ignore_label 11, source 720x960.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_classes: int
    ignore_label: int
    source_hw: Tuple[int, int]
    default_crop_hw: Tuple[int, int]


CITYSCAPES = DatasetSpec("cityscapes", 19, 255, (1024, 2048), (512, 1024))
CAMVID = DatasetSpec("camvid", 11, 11, (720, 960), (360, 480))

SPECS = {"cityscapes": CITYSCAPES, "camvid": CAMVID}


def get_spec(name: str) -> DatasetSpec:
    key = name.lower()
    if key not in SPECS:
        raise KeyError(f"unknown dataset {name!r}; options {sorted(SPECS)}")
    return SPECS[key]


def read_manifest(list_path: str, root: Optional[str] = None
                  ) -> List[Tuple[str, Optional[str]]]:
    """Parse a split list file: ``image_path[<sep>label_path]`` per line
    (reference *_list.txt format [R])."""
    root = root or os.path.dirname(os.path.abspath(list_path))
    out = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            img = os.path.join(root, parts[0]) if not os.path.isabs(parts[0]) \
                else parts[0]
            lab = None
            if len(parts) > 1:
                lab = os.path.join(root, parts[1]) \
                    if not os.path.isabs(parts[1]) else parts[1]
            out.append((img, lab))
    return out


class ManifestDataset:
    """Decoded (image BGR uint8 HWC, label int32 HW or None, name) records."""

    def __init__(self, records: Sequence[Tuple[str, Optional[str]]],
                 spec: DatasetSpec, resize_hw: Optional[Tuple[int, int]] = None):
        self.records = list(records)
        self.spec = spec
        self.resize_hw = resize_hw

    @classmethod
    def from_list_file(cls, list_path: str, spec: DatasetSpec,
                       root: Optional[str] = None, **kw):
        return cls(read_manifest(list_path, root), spec, **kw)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img_path, lab_path = self.records[i]
        image = label = None
        if img_path.endswith(".npy"):
            return self._get_packed(i)
        from . import native
        if native.available():  # C++ decode+resize (native/esn_native.cc)
            image = native.decode_bgr(img_path, self.resize_hw)
            if lab_path is not None and image is not None:
                label = native.decode_grey(lab_path, self.resize_hw)
                if label is None:
                    image = None  # fall through to cv2 for both
        if image is None:
            import cv2
            image = cv2.imread(img_path, cv2.IMREAD_COLOR)  # BGR, like ref
            if image is None:
                raise FileNotFoundError(img_path)
            if lab_path is not None:
                label = cv2.imread(lab_path, cv2.IMREAD_GRAYSCALE)
                if label is None:
                    raise FileNotFoundError(lab_path)
            if self.resize_hw is not None:
                h, w = self.resize_hw
                image = cv2.resize(image, (w, h),
                                   interpolation=cv2.INTER_LINEAR)
                if label is not None:
                    label = cv2.resize(label, (w, h),
                                       interpolation=cv2.INTER_NEAREST)
        item = {"image": image.astype(np.uint8),
                "name": os.path.basename(img_path),
                "size": np.array(image.shape[:2], np.int32)}
        if label is not None:
            item["label"] = label.astype(np.int32)
        return item

    def _get_packed(self, i: int) -> Dict[str, np.ndarray]:
        """Pre-packed record: one ``.npy`` holding (H, W, 4) uint8 —
        BGR image in channels 0..2, label in channel 3 — or (H, W, 3)
        for unlabeled test records (tools/pack_dataset.py). No codec in
        the hot path: ~58x the PNG decode rate per host core
        (benchmarks/host_loader.json), which is what feeds full-res
        inference serving where PNG decode would bind the host."""
        img_path, lab_path = self.records[i]
        arr = np.load(img_path)
        if arr.ndim != 3 or arr.shape[-1] not in (3, 4):
            raise ValueError(
                f"packed record {img_path} has shape {arr.shape}; expected "
                "(H, W, 3|4) uint8 from tools/pack_dataset.py")
        image = arr[..., :3]
        label = arr[..., 3] if arr.shape[-1] == 4 else None
        if lab_path is not None:  # separately-packed label column
            label = np.load(lab_path)
            if label.ndim != 2:
                raise ValueError(
                    f"packed label {lab_path} has shape {label.shape}; "
                    "expected (H, W) from tools/pack_dataset.py")
            # pack_dataset guarantees uint8; cast defensively — cv2.resize
            # rejects int32/int64 input
            label = label.astype(np.uint8, copy=False)
        if self.resize_hw is not None:
            import cv2
            h, w = self.resize_hw
            if tuple(image.shape[:2]) != (h, w):
                image = cv2.resize(image, (w, h),
                                   interpolation=cv2.INTER_LINEAR)
            # key the label resize on the label's own shape — a label
            # packed at a different resolution than its image must still
            # land on resize_hw
            if label is not None and tuple(label.shape[:2]) != (h, w):
                label = cv2.resize(label, (w, h),
                                   interpolation=cv2.INTER_NEAREST)
        item = {"image": np.ascontiguousarray(image, dtype=np.uint8),
                "name": os.path.basename(img_path),
                "size": np.array(image.shape[:2], np.int32)}
        if label is not None:
            item["label"] = label.astype(np.int32)
        return item

    def stats_samples(self):
        """Generator for the inform pass (train split only)."""
        for i in range(len(self)):
            item = self[i]
            yield item["image"], item["label"]


class SyntheticDataset:
    """Deterministic synthetic segmentation data for tests and benches.

    Images are smoothed random fields; labels are the argmax over
    ``num_classes`` random low-frequency score maps — spatially coherent,
    learnable structure with no files on disk (this environment has no
    Cityscapes/CamVid download).
    """

    def __init__(self, spec: DatasetSpec, length: int = 32,
                 hw: Optional[Tuple[int, int]] = None, seed: int = 0,
                 with_labels: bool = True, ignore_frac: float = 0.02):
        self.spec = spec
        self.length = length
        self.hw = hw or spec.source_hw
        self.seed = seed
        self.with_labels = with_labels
        self.ignore_frac = ignore_frac

    def __len__(self):
        return self.length

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if not (0 <= i < self.length):
            raise IndexError(i)
        h, w = self.hw
        rng = np.random.RandomState(self.seed * 100003 + i)
        base = rng.rand(h // 8 + 1, w // 8 + 1, 3)
        image = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
        image = (image * 255).astype(np.uint8)
        item = {"image": image, "name": f"synthetic_{i:05d}.png",
                "size": np.array([h, w], np.int32)}
        if self.with_labels:
            k = self.spec.num_classes
            scores = rng.rand(h // 32 + 1, w // 32 + 1, k)
            scores = np.kron(scores, np.ones((32, 32, 1)))[:h, :w]
            label = np.argmax(scores, -1).astype(np.int32)
            mask = rng.rand(h, w) < self.ignore_frac
            label[mask] = self.spec.ignore_label
            item["label"] = label
        return item

    def stats_samples(self):
        for i in range(len(self)):
            item = self[i]
            yield item["image"], item["label"]
