"""Functional module calculus — the framework core.

A from-scratch, functional replacement for the reference's ``torch.nn.Module``
layer (reference: every ``model/*.py`` builds on torch modules [R]). Design:

- **Pure functions**: ``init(module, rng, *args)`` builds a variables pytree,
  ``apply(module, variables, *args)`` runs the forward pass. No hidden state,
  no tracing magic — everything is explicit pytrees, so ``jax.jit`` /
  ``pjit`` / ``grad`` compose trivially.
- **Scopes**: a module receives a :class:`Scope` that addresses its slice of
  the variables tree by path. Parameters are created on the init pass and
  read on apply. Mutable collections (BatchNorm running stats) are threaded
  out functionally via ``mutable=True``.
- **Deterministic RNG**: per-parameter keys are derived by folding a stable
  CRC32 hash of the scope path into the root key, so init is reproducible
  across processes (Python's ``hash`` is salted and never used).

Variables layout (nested dicts mirroring the module tree)::

    {"params": {...}, "stats": {...}}
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

PyTree = Any


def _path_hash(path: Tuple[str, ...]) -> int:
    return zlib.crc32("/".join(path).encode("utf-8")) & 0x7FFFFFFF


class _Root:
    """Shared per-call state for one init/apply traversal."""

    __slots__ = ("params", "stats", "is_init", "rngs", "train", "mutable",
                 "stat_updates", "_rng_counts")

    def __init__(self, *, params, stats, is_init, rngs, train, mutable):
        self.params = params
        self.stats = stats
        self.is_init = is_init
        self.rngs = rngs or {}
        self.train = train
        self.mutable = mutable
        self.stat_updates: Dict[Tuple[str, ...], Dict[str, jnp.ndarray]] = {}
        self._rng_counts: Dict[Tuple[str, ...], int] = {}


def _get_nested(tree: Dict, path: Tuple[str, ...], create: bool) -> Dict:
    node = tree
    for name in path:
        if name not in node:
            if not create:
                raise KeyError(
                    f"missing collection entry {'/'.join(path)!r}; "
                    "was apply() called with variables from a different model?")
            node[name] = {}
        node = node[name]
    return node


class Scope:
    """Addresses one module's slice of the variables tree."""

    __slots__ = ("root", "path")

    def __init__(self, root: _Root, path: Tuple[str, ...] = ()):
        self.root = root
        self.path = path

    # -- tree navigation ----------------------------------------------------
    def child(self, name: str) -> "Scope":
        return Scope(self.root, self.path + (str(name),))

    def __call__(self, name: str, module: "Module", *args, **kwargs):
        """Run ``module`` in a child scope — the submodule-call idiom."""
        return module(self.child(name), *args, **kwargs)

    # -- properties ---------------------------------------------------------
    @property
    def train(self) -> bool:
        return self.root.train

    @property
    def is_init(self) -> bool:
        return self.root.is_init

    # -- rng ----------------------------------------------------------------
    def make_rng(self, kind: str = "params") -> jax.Array:
        if kind not in self.root.rngs:
            raise ValueError(
                f"rng stream {kind!r} was not provided "
                f"(module path {'/'.join(self.path)!r}). Pass rngs={{'{kind}': key}}.")
        count = self.root._rng_counts.get(self.path + (kind,), 0)
        self.root._rng_counts[self.path + (kind,)] = count + 1
        key = jax.random.fold_in(self.root.rngs[kind], _path_hash(self.path))
        return jax.random.fold_in(key, count)

    # -- parameters ---------------------------------------------------------
    def param(self, name: str, init_fn: Callable[..., jnp.ndarray],
              shape: Sequence[int], dtype=jnp.float32) -> jnp.ndarray:
        d = _get_nested(self.root.params, self.path, create=self.root.is_init)
        if self.root.is_init and name not in d:
            d[name] = init_fn(self.make_rng("params"), shape, dtype)
        if name not in d:
            raise KeyError(f"missing param {'/'.join(self.path)}/{name}")
        return d[name]

    # -- mutable state (running stats) --------------------------------------
    def stat(self, name: str, init_fn: Callable[..., jnp.ndarray],
             shape: Sequence[int], dtype=jnp.float32) -> jnp.ndarray:
        d = _get_nested(self.root.stats, self.path, create=self.root.is_init)
        if self.root.is_init and name not in d:
            d[name] = init_fn(None, shape, dtype)
        if name not in d:
            raise KeyError(f"missing stat {'/'.join(self.path)}/{name}")
        # a pending update from this very traversal wins (rare, but coherent)
        upd = self.root.stat_updates.get(self.path)
        if upd and name in upd:
            return upd[name]
        return d[name]

    def put_stat(self, name: str, value: jnp.ndarray) -> None:
        if not (self.root.mutable or self.root.is_init):
            return  # silently drop updates on immutable apply (eval mode)
        if self.root.is_init:
            d = _get_nested(self.root.stats, self.path, create=True)
            d[name] = value
            return
        self.root.stat_updates.setdefault(self.path, {})[name] = value


class Module:
    """Base class: subclasses implement ``__call__(self, scope, *args)``.

    Modules are plain hyperparameter containers — all array state lives in
    the variables pytree, never on the module object.

    ``LOGITS_TAIL`` tells prediction paths what produces a model's logits —
    ``"resize"`` (bilinear-upsample tail) or ``"conv"`` — so
    ``ops.argmax_lastdim`` can pick the faster lowering (see its docstring).
    """

    LOGITS_TAIL = "conv"

    def __call__(self, scope: Scope, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError

    def predict(self, scope: Scope, x):
        """Class-map prediction: ``argmax(logits)`` by default. ConvT-tail
        models override this with the fused subpixel head (argmax before
        depth-to-space — ops.classify.subpixel_argmax), which is exact but
        never materializes full-res class-channel logits. Models whose
        __call__ ends in the standard bilinear-resize tail expose the
        pre-resize logits as ``logits_lowres``; predict then routes
        through the fused Pallas upsample+argmax
        (ops.classify.resize_tail_argmax) so full-res class logits never
        exist. Run it with ``nn.apply(model, variables, x,
        method="predict")``."""
        if hasattr(self, "logits_lowres"):
            from ..ops.classify import resize_tail_argmax
            y = self.logits_lowres(scope, x)
            return resize_tail_argmax(y, x.shape[1:3], tail=self.LOGITS_TAIL)
        from ..ops.classify import argmax_lastdim
        return argmax_lastdim(self(scope, x), tail=self.LOGITS_TAIL)

    # Convenience wrappers ---------------------------------------------------
    def init(self, rng, *args, train: bool = False, rngs: Optional[Dict] = None,
             **kwargs) -> Dict[str, PyTree]:
        return init(self, rng, *args, train=train, rngs=rngs, **kwargs)

    def apply(self, variables, *args, **kwargs):
        return apply(self, variables, *args, **kwargs)


def init(module: Module, rng: jax.Array, *args, train: bool = False,
         rngs: Optional[Dict[str, jax.Array]] = None, **kwargs) -> Dict[str, PyTree]:
    """Build the variables pytree by running the module on example inputs."""
    streams = {"params": rng, "dropout": rng}
    if rngs:
        streams.update(rngs)
    root = _Root(params={}, stats={}, is_init=True, rngs=streams,
                 train=train, mutable=True)
    module(Scope(root), *args, **kwargs)
    return {"params": root.params, "stats": root.stats}


def _merge_updates(stats: PyTree, updates: Dict[Tuple[str, ...], Dict[str, jnp.ndarray]]):
    if not updates:
        return stats
    new_stats = jax.tree_util.tree_map(lambda x: x, stats)  # shallow-ish copy

    def copy_path(tree, path):
        node = tree
        for name in path:
            node[name] = dict(node[name])
            node = node[name]
        return node

    new_stats = dict(new_stats)
    for path, upd in updates.items():
        node = new_stats
        for name in path:
            node[name] = dict(node.get(name, {}))
            node = node[name]
        node.update(upd)
    return new_stats


def apply(module: Module, variables: Dict[str, PyTree], *args,
          train: bool = False, mutable: bool = False,
          rngs: Optional[Dict[str, jax.Array]] = None,
          method: Optional[str] = None, **kwargs):
    """Run the forward pass (or another scope-taking method via ``method``,
    e.g. ``method="predict"`` for the fused prediction head).

    Returns ``y`` or, when ``mutable=True``, ``(y, new_variables)`` where
    ``new_variables["stats"]`` carries updated running statistics.
    """
    root = _Root(params=variables.get("params", {}),
                 stats=variables.get("stats", {}),
                 is_init=False, rngs=rngs, train=train, mutable=mutable)
    fn = getattr(module, method) if method else module
    y = fn(Scope(root), *args, **kwargs)
    if mutable:
        new_vars = {"params": variables.get("params", {}),
                    "stats": _merge_updates(variables.get("stats", {}),
                                            root.stat_updates)}
        return y, new_vars
    return y


class Sequential(Module):
    """Run child modules in order; children are named "0", "1", ..."""

    def __init__(self, *layers: Module):
        self.layers = [l for l in layers if l is not None]

    def __call__(self, scope: Scope, x, **kwargs):
        for i, layer in enumerate(self.layers):
            x = layer(scope.child(str(i)), x, **kwargs)
        return x


class Fn(Module):
    """Wrap a stateless function as a module."""

    def __init__(self, fn: Callable, **fixed_kwargs):
        self.fn = fn
        self.fixed_kwargs = fixed_kwargs

    def __call__(self, scope: Scope, *args, **kwargs):
        return self.fn(*args, **{**self.fixed_kwargs, **kwargs})


class ScanChain(Module):
    """N structurally identical blocks run as ONE ``lax.scan`` over stacked
    per-block parameters.

    Deep repeated-block models (CGNet's 20-block stage3, reference
    ``model/CGNet.py`` ContextGuidedBlock stack [R]) unroll into huge HLO
    under ``jit``: every block is re-lowered, compile time scales with depth,
    and big-batch graphs take minutes to compile.
    Under ``lax.scan`` the block body is compiled ONCE and iterated, so graph
    size is depth-independent — the canonical XLA treatment of repeated
    structure (same trick as scanned transformer layers).

    Variables layout is IDENTICAL to ``Sequential`` (children "0".."n-1"):
    the init pass runs the block per child scope, so checkpoints are
    interchangeable with the unrolled module and per-block params stay
    individually addressable. At apply time the per-block subtrees are
    stacked leaf-wise (a cheap device-side pack of small weight tensors) and
    scanned. Per-step math is identical (parity with Sequential up to
    XLA re-fusion rounding; tested at float-epsilon on CPU).

    Running-stat updates (train-mode BN) come back stacked and are
    scattered to their per-block paths. Each rng stream has the step index
    folded in so dropout masks differ per block.

    Scan is a graph-size/throughput trade: the scanned body blocks XLA's
    cross-block fusion and forces the carry through device memory each
    step, which was slower at big-batch INFERENCE before the GPU port (not
    measured on the H100) — while keeping CGNet/ESPNet-C big-batch eval and
    deep training graphs small. ``eval_unroll=True`` (per-model) unrolls
    eval/inference and keeps training scanned.

    ``ESN_TPU_SCAN_CHAIN=0`` forces the unrolled path everywhere;
    ``ESN_TPU_SCAN_CHAIN=1`` forces scan everywhere (overrides
    ``eval_unroll``).
    """

    def __init__(self, block: Module, n: int, eval_unroll: bool = False):
        self.block = block
        self.n = n
        self.eval_unroll = eval_unroll

    def _unrolled(self, scope: Scope, x, **kwargs):
        for i in range(self.n):
            x = self.block(scope.child(str(i)), x, **kwargs)
        return x

    def __call__(self, scope: Scope, x, **kwargs):
        import os
        env = os.environ.get("ESN_TPU_SCAN_CHAIN", "")
        unroll = self.eval_unroll and not scope.train if env == "" \
            else env == "0"
        if scope.is_init or self.n <= 1 or unroll:
            return self._unrolled(scope, x, **kwargs)
        root = scope.root
        subtrees = [_get_nested(root.params, scope.path + (str(i),), False)
                    for i in range(self.n)]
        stacked_p = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *subtrees)
        try:
            stat_subtrees = [
                _get_nested(root.stats, scope.path + (str(i),), False)
                for i in range(self.n)]
            stacked_s = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *stat_subtrees)
        except KeyError:
            stacked_s = {}
        block, train, mutable, rngs = (self.block, root.train, root.mutable,
                                       root.rngs)
        idx = jnp.arange(self.n)

        def body(carry, step):
            i, p, s = step
            step_rngs = {k: jax.random.fold_in(v, i)
                         for k, v in rngs.items()}
            r = _Root(params=p, stats=s, is_init=False, rngs=step_rngs,
                      train=train, mutable=mutable)
            y = block(Scope(r), carry, **kwargs)
            return y, r.stat_updates

        y, updates = jax.lax.scan(body, x, (idx, stacked_p, stacked_s))
        if mutable and updates:
            for rel_path, upd in updates.items():
                for i in range(self.n):
                    dst = root.stat_updates.setdefault(
                        scope.path + (str(i),) + rel_path, {})
                    for k, v in upd.items():
                        dst[k] = v[i]
        return y
