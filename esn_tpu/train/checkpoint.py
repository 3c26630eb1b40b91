"""Checkpoint / resume.

Reference: ``torch.save({'epoch','model'})`` per epoch + ``--resume``; the
optimizer state is NOT saved, so reference resumes are inexact
[R: train.py; SURVEY.md §5]. Here a checkpoint is the full TrainState
(params + BN stats + optimizer state + step) plus metadata, so resume is
bit-exact. ``convert_state.py``'s job (strip DataParallel prefixes) has no
analogue: there is nothing to strip.

Format: one uncompressed ``.npz`` holding every pytree leaf under its path
("params/enc/conv/kernel", "opt_state/0/mu/...") and a JSON header with
each leaf's dtype and the metadata. Dtypes numpy cannot store (bf16) are
kept as same-width unsigned-integer views and restored bit for bit.

Layout: ``{savedir}/model_{epoch}.ckpt``, mirroring the reference's
``model_{epoch}.pth`` naming so sweep tooling (--best) ports over.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .state import TrainState

_CKPT_RE = re.compile(r"model_(\d+)\.ckpt$")
_HEADER = "__header__"
_NATIVE = {"bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
           "uint32", "uint64", "float16", "float32", "float64"}


def _key(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            raise TypeError(f"unsupported pytree path entry {k!r}")
    return "/".join(parts)


def _write(path: str, tree, meta: Dict[str, Any]) -> None:
    arrays, dtypes = {}, {}
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(jax.device_get(leaf))
        key = _key(p)
        dtypes[key] = a.dtype.name
        if a.dtype.name not in _NATIVE:     # bf16 & co: raw bits
            a = a.view(np.dtype(f"uint{8 * a.dtype.itemsize}"))
        arrays[key] = a
    header = json.dumps({"dtypes": dtypes, "meta": meta})
    arrays[_HEADER] = np.frombuffer(header.encode(), np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def _read(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(leaves by path, metadata) of a checkpoint file."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z[_HEADER]).decode())
        leaves = {}
        for key, dtype in header["dtypes"].items():
            a = z[key]
            if dtype not in _NATIVE:
                a = a.view(jnp.dtype(dtype))
            leaves[key] = a
    return leaves, header["meta"]


def _restore(target, leaves: Dict[str, np.ndarray], prefix: str = ""):
    """Rebuild ``target``'s structure from ``leaves`` (shape-checked)."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(target)
    out = []
    for p, ref in paths:
        key = prefix + _key(p)
        if key not in leaves:
            raise KeyError(f"checkpoint has no leaf {key!r}")
        a = leaves[key]
        if a.shape != np.shape(ref):
            raise ValueError(
                f"{key}: checkpoint {a.shape} != target {np.shape(ref)}")
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def save_checkpoint(savedir: str, epoch: int, state: TrainState,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(savedir, exist_ok=True)
    path = os.path.join(savedir, f"model_{epoch}.ckpt")
    _write(path, state, {"epoch": int(epoch), **(extra or {})})
    return path


def load_checkpoint(path: str, target_state: TrainState
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore into the structure of ``target_state`` (shape-checked)."""
    leaves, meta = _read(path)
    return _restore(target_state, leaves), meta


def load_variables(path: str, target_variables):
    """Restore only {params, stats} from a full checkpoint — for inference
    CLIs, which must load checkpoints regardless of how the optimizer chain
    was configured at train time."""
    leaves, meta = _read(path)
    restored = {k: _restore(target_variables[k], leaves, k + "/")
                for k in ("params", "stats")}
    return restored, meta


def latest_checkpoint(savedir: str) -> Optional[str]:
    ckpts = list_checkpoints(savedir)
    return ckpts[-1][1] if ckpts else None


def list_checkpoints(savedir: str):
    """All (epoch, path) pairs, sorted — powers test.py --best sweeps [R]."""
    out = []
    if os.path.isdir(savedir):
        for name in os.listdir(savedir):
            m = _CKPT_RE.search(name)
            if m:
                out.append((int(m.group(1)), os.path.join(savedir, name)))
    return sorted(out)


def save_params_only(path: str, variables) -> None:
    """Inference-only export (params + stats)."""
    _write(path, variables, {})


def load_params_only(path: str, target_variables):
    return _restore(target_variables, _read(path)[0])


def load_encoder(path: str, variables, subtree: str = "enc"):
    """Graft a pretrained sub-model checkpoint into ``variables[*][subtree]``.

    Reference counterpart: ESPNet's two-stage recipe — train ESPNet-C, then
    construct ESPNet with ``encoderFile=...`` so the decoder trains on top of
    the frozen-format encoder weights [R: model/ESPNet.py ESPNet.__init__].
    The donor checkpoint's param/stat tree must be a superset of the
    ``subtree`` slice (extra donor leaves — e.g. the C-classifier head — are
    ignored).
    """
    leaves, meta = _read(path)
    new = {"params": dict(variables["params"]),
           "stats": dict(variables["stats"])}
    for k in ("params", "stats"):
        grafted = _restore(variables[k][subtree], leaves, k + "/")
        new[k][subtree] = jax.tree_util.tree_map(
            lambda a, ref: a.astype(ref.dtype), grafted,
            variables[k][subtree])
    return new, meta
