"""Batched FEL engine — every client of every cluster in one SGD step.

Port of ``repro.fl.batched_fel``. The reference loop
(``BHFLRuntime._run_fel``) runs clusters × clients × fel_iterations ×
batches eager SGD steps one at a time, with FedAvg between iterations.
This engine runs the FEL phase of a round as ``fel_iterations`` × T
steps, each of them one ``torch.func.vmap(vmap(grad(loss)))`` over the
(N clusters, C clients) stacked parameter dicts:

* every cluster's client shards are stacked into padded ``(N, C, n_max,
  ...)`` tensors on the device (per-client sizes masked),
* one step gathers every client's batch, takes every client's gradient
  and applies every client's SGD update at once (padding steps masked
  out with ``torch.where``),
* FedAvg (Eq. 1 at the edge) is a masked weighted sum over the clients,
  after each iteration,

so a round produces the stacked flat ``(N, D)`` model matrix W(k), in
``core.serialization``'s canonical order, that Model Evaluation takes
directly. The LM families' kernels (wkv6, flash attention) have vmap
rules that fold the clients into one launch per layer and step
(``kernels.wkv6``, ``kernels.flash_attention``).

Numerical contract: with the same seeds the engine follows the reference
loop step for step — the same batch permutations (the same numpy
streams, precomputed into an index tensor), the same dropout masks (the
loop's own generator, ``models.mlp.step_generator``, drawn outside
``vmap`` for each real step at the client's batch width and padded), the
same lr decay (a real step t has lr / (1 + decay·t), padding steps come
after a client's real ones and change nothing), and FedAvg weights that
are exactly zero for padded and empty clients. The round trains in
float32, as the reference's does. ``tests/test_torch_batched_fel.py``
pins the engine against the port's loop and against the reference's
engine.

Shape bucketing (``bucket=True`` / ``BHFLConfig(shape_bucketing=True)``)
pads the client, sample, step and batch axes to the next power of two.
The padding is masked, so it is bit-exact: a zero FedAvg weight, an
inactive step or a zero-masked batch row adds exact zeros. The reference
buckets so that runtimes rebuilt at nearby scales reuse one compiled XLA
program (its ``compile_count`` and module-level jit cache); eager torch
compiles nothing, so the port has neither, and bucketing here only pads.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core.serialization import flatten_pytree, unflatten_pytree
from repro_torch.fl.hierarchy import FELCluster
from repro_torch.obs import get_recorder


def _next_pow2(x: int) -> int:
    """The bucket boundary: smallest power of two ≥ x (min 1)."""
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of dicts (nested allowed) of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclass(frozen=True)
class BatchedTrainSpec:
    """What the engine needs from a ``ModelAdapter`` to train batched.

    ``stack`` turns one client dataset into a sample-major dict of numpy
    arrays (leading axis = samples; empty shards yield 0-row arrays of the
    same structure). ``draw(seed, step, bs, device)`` is a real SGD
    step's random input, drawn outside ``vmap`` (the MLP's dropout mask
    at the client's batch width ``bs``, as the loop draws it; None when
    the step needs none), and ``per_example_loss(params, batch, rand) ->
    (B,)`` the per-sample losses of a gathered batch, ``rand`` that draw
    padded to the engine's batch width (or None). The engine reduces the
    losses with the padding mask, so padded rows must simply be finite.
    """

    stack: Callable[[Any], Any]
    draw: Callable[[int, int, int, torch.device], Optional[torch.Tensor]]
    per_example_loss: Callable[[Any, Any, Optional[torch.Tensor]],
                               torch.Tensor]
    local_epochs: int
    batch_size: int
    lr: float
    momentum: float
    decay: float


class BatchedFELEngine:
    """Runs the FEL phase of a BCFL round batched over every client.

    Built once per runtime (shapes are fixed by the hierarchy) on the
    device of ``template_params``; per round only the batch-permutation
    index tensor and the random draws change.
    """

    def __init__(self, clusters: List[FELCluster], spec: BatchedTrainSpec,
                 fel_iterations: int, template_params: Any,
                 bucket: bool = False):
        if fel_iterations < 1:
            raise ValueError(f"fel_iterations must be >= 1, got {fel_iterations}")
        self.spec = spec
        self.fel_iterations = int(fel_iterations)
        self.bucket = bool(bucket)
        self.n_clusters = len(clusters)
        self.n_clients = max((len(c.clients) for c in clusters), default=0)
        if self.n_clusters == 0 or self.n_clients == 0:
            raise ValueError("batched engine needs at least one cluster "
                             "with at least one client")
        self._template = template_params
        self.device = flatten_pytree(template_params).device

        def _dim(x: int) -> int:
            """Bucketed axis extent: next pow2 under bucketing, exact else."""
            return _next_pow2(x) if self.bucket else max(1, int(x))

        # bucket the client axis: padded clients carry zero data, zero
        # FedAvg weight, and an all-False step mask (bit-exact — see
        # module doc)
        N, E = self.n_clusters, spec.local_epochs
        C = _dim(self.n_clients)
        self.n_clients_padded = C
        sizes = np.zeros((N, C), np.int64)
        client_ids = np.zeros((N, C), np.int64)
        for n, cluster in enumerate(clusters):
            for c, client in enumerate(cluster.clients):
                sizes[n, c] = client.data_size
                client_ids[n, c] = client.client_id
        self._sizes = sizes
        self._client_ids = client_ids

        # per-client batch size / step count (reference semantics:
        # bs = min(batch_size, size), drop-remainder batching, E epochs)
        bs = np.where(sizes > 0, np.minimum(spec.batch_size, sizes), 1)
        nb = np.where(sizes > 0, sizes // bs, 0)
        steps = E * nb
        self._bs = bs.astype(np.int32)
        self._steps = steps
        # bucket the step and batch axes too: masked steps advance nothing
        # and zero-masked batch rows reduce to exact zeros
        self.steps_per_iteration = _dim(int(steps.max()))
        self.batch_pad = _dim(int(bs.max()))

        T, B = self.steps_per_iteration, self.batch_pad
        stepmask = np.zeros((N, C, T), bool)
        for n in range(N):
            for c in range(C):
                stepmask[n, c, : steps[n, c]] = True
        self._stepmask = torch.as_tensor(stepmask, device=self.device)
        # fast path: uniform shards (every client runs every step at full
        # batch width) need none of the per-step masking. Under bucketing
        # the masked path is kept even for an aligned hierarchy, as in
        # the reference (the masked reduction is the same when the mask
        # is full).
        self._uniform = (not self.bucket and bool(stepmask.all())
                         and bool((bs == B).all()))

        # stack client shards into padded (N, C, n_max, ...) device leaves
        proto = None
        for cluster in clusters:
            for client in cluster.clients:
                if client.data_size > 0:
                    proto = spec.stack(client.data)
                    break
            if proto is not None:
                break
        if proto is None:
            raise ValueError("batched engine needs at least one non-empty "
                             "client shard")
        self.n_max = _dim(int(sizes.max()))

        def padded(client) -> Any:
            stacked = (spec.stack(client.data) if client is not None
                       else _tree_map(lambda a: a[:0], proto))

            def pad(leaf):
                leaf = np.asarray(leaf)
                out = np.zeros((self.n_max,) + leaf.shape[1:], leaf.dtype)
                out[: leaf.shape[0]] = leaf
                return out
            return _tree_map(pad, stacked)

        rows = []
        for cluster in clusters:
            cl = list(cluster.clients) + [None] * (C - len(cluster.clients))
            rows.append(_tree_map(lambda *ls: np.stack(ls),
                                  *[padded(cli) for cli in cl]))
        self._data = _tree_map(
            lambda *ls: torch.as_tensor(np.stack(ls), device=self.device),
            *rows)
        self._sizes_f = torch.as_tensor(sizes, dtype=torch.float32,
                                        device=self.device)
        self._bs_dev = torch.as_tensor(self._bs, device=self.device)
        self._rows = torch.arange(self.batch_pad, device=self.device)

    # -- host-side per-round prep (cheap: numpy permutations only) -----------
    def _batch_plan(self, round_seed: int) -> tuple[np.ndarray, np.ndarray]:
        """Replicates the reference batch stream: per (iteration, client,
        epoch) the same ``np.random.default_rng(seed + ep).permutation``
        and the same drop-remainder windows, flattened into an index
        tensor (I, N, C, T, B) plus per-client seeds (I, N, C)."""
        I, N, C = self.fel_iterations, self.n_clusters, self.n_clients_padded
        T, B, E = self.steps_per_iteration, self.batch_pad, self.spec.local_epochs
        idx = np.zeros((I, N, C, T, B), np.int32)
        seeds = np.zeros((I, N, C), np.int64)
        for it in range(I):
            for n in range(N):
                for c in range(C):
                    seed = round_seed * 1000 + int(self._client_ids[n, c]) * 10 + it
                    seeds[it, n, c] = seed
                    size = int(self._sizes[n, c])
                    if size == 0:
                        continue
                    bs = int(self._bs[n, c])
                    t = 0
                    for ep in range(E):
                        order = np.random.default_rng(seed + ep).permutation(size)
                        for s in range(0, size - bs + 1, bs):
                            idx[it, n, c, t, :bs] = order[s:s + bs]
                            t += 1
        return idx, seeds

    def _draws(self, seeds: np.ndarray) -> Optional[torch.Tensor]:
        """The spec's draw for every real (iteration, cluster, client,
        step), each at the client's batch width, padded with zeros to
        ``batch_pad`` rows: (I, N, C, T, B, ...), or None when the spec
        draws nothing."""
        I, N, C = seeds.shape
        out = None
        for it in range(I):
            for n in range(N):
                for c in range(C):
                    bs = int(self._bs[n, c])
                    for t in range(int(self._steps[n, c])):
                        rand = self.spec.draw(int(seeds[it, n, c]), t, bs,
                                              self.device)
                        if rand is None:
                            return None
                        if out is None:
                            out = torch.zeros(
                                (I, N, C, self.steps_per_iteration,
                                 self.batch_pad) + tuple(rand.shape[1:]),
                                dtype=rand.dtype, device=self.device)
                        out[it, n, c, t, :bs] = rand
        return out

    def run_round(self, global_flat: torch.Tensor,
                  round_seed: int) -> torch.Tensor:
        """One FEL phase: (D,) global model → stacked (N, D) W(k), all on
        the device."""
        idx, seeds = self._batch_plan(round_seed)
        i32 = np.iinfo(np.int32)
        if np.any(seeds > i32.max) or np.any(seeds < i32.min):
            raise ValueError(
                f"per-client seed overflows int32 (round_seed={round_seed}); "
                "keep cfg.seed * 1000 + rounds within int32 range")
        rec = get_recorder()
        if not rec.enabled:
            return self._round(global_flat, idx, seeds)
        # dispatch only: the host's issue of the round's launches; the
        # card may still be running them when the span closes
        t0 = time.perf_counter()
        rec.open_span("fel.dispatch", cat="fel")
        W = self._round(global_flat, idx, seeds)
        rec.close_span()
        rec.counter("fel.dispatches")
        rec.observe("fel.dispatch_ms", (time.perf_counter() - t0) * 1e3)
        return W

    # -- the round -------------------------------------------------------------
    def _loss(self, p, data_c, sel, bs_c, real, rand):
        """One client's masked mean loss of one step, for ``grad``."""
        batch = _tree_map(lambda a: a[sel], data_c)
        pe = self.spec.per_example_loss(p, batch, rand)
        if self._uniform:
            return torch.mean(pe)
        m = ((self._rows < bs_c) & real).to(torch.float32)
        return torch.sum(pe * m) / torch.clamp(torch.sum(m), min=1.0)

    def _round(self, global_flat: torch.Tensor, idx: np.ndarray,
               seeds: np.ndarray) -> torch.Tensor:
        spec = self.spec
        N, C = self.n_clusters, self.n_clients_padded
        T, I = self.steps_per_iteration, self.fel_iterations
        dev = self.device
        rand_all = self._draws(seeds)
        # vmap over clusters of vmap over clients of one client's gradient;
        # every argument stacked (N, C, ...), ``rand`` None when not drawn
        dims = (0, 0, 0, 0, 0, None if rand_all is None else 0)
        grad_fn = vmap(vmap(grad(self._loss), in_dims=dims), in_dims=dims)
        idx_dev = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        # train in float32: the reference loop's SGD update promotes
        # low-precision (bf16) params to f32 after the first step anyway
        params0 = _tree_map(lambda l: l.to(torch.float32),
                            unflatten_pytree(global_flat.to(dev),
                                             self._template))
        cluster = _tree_map(lambda l: l.expand(N, *l.shape), params0)
        tot = torch.sum(self._sizes_f, dim=1)                      # (N,)
        lam = self._sizes_f / torch.clamp(tot, min=1.0)[:, None]   # (N, C)

        def per_client(mask, leaf):
            """(N, C) ``mask`` broadcast against a (N, C, ...) leaf."""
            return mask.reshape(mask.shape + (1,) * (leaf.ndim - 2))

        for it in range(I):
            p = _tree_map(lambda l: l[:, None].expand(N, C, *l.shape[1:]),
                          cluster)
            mom = _tree_map(lambda l: torch.zeros(l.shape, dtype=l.dtype,
                                                  device=dev), p)
            for t in range(T):
                real = self._stepmask[:, :, t]
                rand = None if rand_all is None else rand_all[it, :, :, t]
                g = grad_fn(p, self._data, idx_dev[it, :, :, t],
                            self._bs_dev, real, rand)
                # optim.sgd.sgd_update's arithmetic: lr_t in float32 for
                # the step count t (a real step t is the client's t-th;
                # padding steps come after its real ones and are masked)
                lr_t = float(np.float32(spec.lr) / (
                    np.float32(1.0) + np.float32(spec.decay) * np.float32(t)))
                nmom = _tree_map(lambda m_, g_: m_ * spec.momentum + g_,
                                 mom, g)
                newp = _tree_map(lambda a, m_: a - lr_t * m_, p, nmom)
                if self._uniform:
                    p, mom = newp, nmom
                else:
                    p = _tree_map(lambda new, old: torch.where(
                        per_client(real, new), new, old), newp, p)
                    mom = _tree_map(lambda new, old: torch.where(
                        per_client(real, new), new, old), nmom, mom)
            # Eq. 1 at the edge: data-size weights; empty/padded clients
            # carry exact zero weight. A dataless cluster keeps the
            # incoming global model (its consensus weight is zero too).
            avg = _tree_map(lambda l: torch.einsum("nc,nc...->n...", lam, l),
                            p)
            cluster = _tree_map(
                lambda a, old: torch.where(
                    (tot > 0).reshape((N,) + (1,) * (a.ndim - 1)), a, old),
                avg, cluster)
        return vmap(flatten_pytree)(cluster)


def engine_for(adapter: Any, clusters: List[FELCluster], fel_iterations: int,
               template_params: Any,
               bucket: bool = False) -> Optional[BatchedFELEngine]:
    """Build a :class:`BatchedFELEngine` if ``adapter`` exposes a
    ``batched_train_spec()``; None when the adapter has no batched path."""
    spec_fn = getattr(adapter, "batched_train_spec", None)
    if spec_fn is None:
        return None
    spec = spec_fn()
    if spec is None:
        return None
    return BatchedFELEngine(clusters, spec, fel_iterations, template_params,
                            bucket=bucket)
