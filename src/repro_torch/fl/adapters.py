"""Model adapters — the pluggable-workload boundary of the BHFL runtime.

Port of ``repro.fl.adapters``: the paper's MNIST MLP
(:class:`MLPAdapter`) and the LM families (:class:`LMAdapter` over any
ported ``ArchConfig``: RWKV-6, dense, MoE, the Zamba2 hybrid; with the
CPU-scale :func:`transformer_adapter` and :func:`rwkv6_adapter` that
``run_bhfl(model="transformer" | "rwkv6")`` trains). ``BHFLRuntime``
needs init / local-train / eval / flatten / unflatten from an adapter,
and flatten/unflatten must use the canonical sorted-keypath layout of
``core.serialization``, the order HCDS commits to and ME aggregates in.
Both adapters also give the batched FEL engine (``fl.batched_fel``) its
train spec (``batched_train_spec``).

:func:`params_from_jax` loads the reference's MLP parameters into the
port, so both packages can start from one init (``jax.random`` draws
cannot be reproduced in torch); ``models.ssm_models.rwkv_params_from_jax``
``models.ssm_models.hybrid_params_from_jax`` and
``models.transformer.transformer_params_from_jax`` do the same for the
LM families.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple, Optional, Protocol, \
    runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.serialization import flatten_pytree, unflatten_pytree
from repro_torch.fl.client import Client, local_train
from repro_torch.models.config import ArchConfig
from repro_torch.models.mlp import (MLPConfig, dropout_mask, mlp_accuracy,
                                    mlp_init, mlp_loss, mlp_per_example_loss,
                                    step_generator)
from repro_torch.models.model_api import (DEFAULT_AUX_WEIGHT, Model,
                                          _token_ce_loss)
from repro_torch.optim.sgd import sgd_init, sgd_update


class EvalResult(NamedTuple):
    accuracy: float
    loss: float


@runtime_checkable
class ModelAdapter(Protocol):
    """What ``BHFLRuntime`` needs from a workload: a name, the device it
    runs on, and init / local train / evaluate / flatten / unflatten.
    ``init`` draws from a generator on ``init_device``."""

    name: str
    device: torch.device

    def init(self, generator: torch.Generator) -> dict: ...

    def local_train(self, params: dict, client: Client, *,
                    seed: int = 0) -> tuple[dict, float]: ...

    def evaluate(self, params: dict, dataset: Any) -> "EvalResult": ...

    def flatten(self, params: dict) -> torch.Tensor: ...

    def unflatten(self, flat: Any, template: dict) -> dict: ...


class _SerializationFlatten:
    """Shared flatten/unflatten via the canonical serialization roundtrip."""

    def flatten(self, params: dict) -> torch.Tensor:
        return flatten_pytree(params)

    def unflatten(self, flat: Any, template: dict) -> dict:
        return unflatten_pytree(flat, template)


@dataclass
class MLPAdapter(_SerializationFlatten):
    """The paper's 784-hidden-10 MLP over ``SyntheticImageDataset`` shards,
    trained with SGD+momentum+decay exactly as §7.1 specifies, on
    ``device`` (the CUDA card unless the caller asks for the CPU). Its
    init is drawn on the CPU, so every device starts from the same
    weights."""

    cfg: MLPConfig = MLPConfig()
    local_epochs: int = 1
    batch_size: int = 32
    lr: float = 1e-3
    momentum: float = 0.9
    decay: float = 5e-4
    device: Optional[torch.device | str] = None   # None: the CUDA card

    name: str = "mlp"
    init_device = "cpu"     # where the init generator lives

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init(self, generator: torch.Generator) -> dict:
        return mlp_init(self.cfg, generator, device=self.device)

    def local_train(self, params: dict, client: Client, *,
                    seed: int = 0) -> tuple[dict, float]:
        return local_train(params, client, self.cfg,
                           epochs=self.local_epochs,
                           batch_size=self.batch_size, lr=self.lr,
                           momentum=self.momentum, decay=self.decay,
                           seed=seed)

    @torch.no_grad()
    def evaluate(self, params: dict, dataset: Any) -> EvalResult:
        x = torch.as_tensor(dataset.x, device=self.device)
        y = torch.as_tensor(dataset.y, device=self.device)
        return EvalResult(
            float(mlp_accuracy(params, x, y, cfg=self.cfg)),
            float(mlp_loss(params, x, y, cfg=self.cfg)))

    def batched_train_spec(self):
        """The batched FEL engine's spec (``fl.batched_fel``): the shard
        as (x, y) arrays, the loop's dropout mask of each step
        (``step_generator(seed, step)`` at the client's batch width)
        drawn beforehand, and the per-sample CE. Memoized per adapter,
        as in the reference."""
        if getattr(self, "_batched_spec", None) is not None:
            return self._batched_spec
        from repro_torch.fl.batched_fel import BatchedTrainSpec
        cfg = self.cfg

        def stack(dataset):
            return {"x": np.asarray(dataset.x, np.float32),
                    "y": np.asarray(dataset.y, np.int32)}

        def draw(seed, step, bs, device):
            if cfg.dropout <= 0.0:
                return None
            return dropout_mask(step_generator(seed, step, device),
                                1.0 - cfg.dropout, (bs, cfg.hidden), device)

        def per_example(params, batch, rand):
            return mlp_per_example_loss(params, batch["x"], batch["y"],
                                        cfg=cfg, train=True, mask=rand)

        self._batched_spec = BatchedTrainSpec(
            stack, draw, per_example, self.local_epochs, self.batch_size,
            self.lr, self.momentum, self.decay)
        return self._batched_spec


def _flat(tree: dict, prefix: str = "") -> dict:
    """{"a/b": leaf} of a nested parameter dict."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *head, last = key.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@dataclass
class LMAdapter(_SerializationFlatten):
    """Any ported ``model_api.Model`` family as a BHFL workload: FedSGD on
    next-token cross entropy over ``TokenDataset`` client shards, through
    the port's ``optim.sgd`` (lr 1e-2, momentum 0.9, decay 5e-4, batch
    8); eval is next-token top-1 accuracy and CE from one forward. Runs
    on ``device`` (the CUDA card unless the caller asks for the CPU),
    where its init is drawn too.

    As in the reference (``jax.value_and_grad`` then ``sgd_update``), a
    bfloat16 parameter comes out of its first SGD step in float32 (the
    step's lr is a float32 array there), and its momentum from the second.
    """

    arch: ArchConfig
    local_epochs: int = 1
    batch_size: int = 8
    lr: float = 1e-2
    momentum: float = 0.9
    decay: float = 5e-4
    device: Optional[torch.device | str] = None   # None: the CUDA card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = Model(self.arch, device=self.device)
        self.name = self.arch.name

    @property
    def init_device(self) -> torch.device:
        return self.device

    def init(self, generator: torch.Generator) -> dict:
        return self.model.init(generator)

    def local_train(self, params: dict, client: Client, *,
                    seed: int = 0) -> tuple[dict, float]:
        """``local_epochs`` of SGD over the client's rows, batches in the
        reference's order (``TokenDataset.batches(seed=seed + ep)``);
        returns (new params, last loss) and leaves ``params`` untouched.
        An empty shard raises: callers skip empty clients."""
        # float32 leaves are updated in place, so they are copied; a
        # bfloat16 leaf is replaced by its float32 update, never written
        flat = {k: (v.detach().clone() if v.dtype == torch.float32
                    else v.detach()).requires_grad_(True)
                for k, v in _flat(params).items()}
        opt_state = sgd_init(flat)
        bs = min(self.batch_size, client.data_size)
        loss = torch.zeros(())
        for ep in range(self.local_epochs):
            for batch in client.data.batches(bs, seed=seed + ep):
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in batch.items()}
                loss = self.model.loss(_nested(flat), batch)
                # a leaf the loss does not reach (an audio model's
                # cross-attention, run without a context) gets a zero
                # gradient, as jax.grad gives it
                grads = torch.autograd.grad(loss, list(flat.values()),
                                            materialize_grads=True)
                sgd_update(dict(zip(flat, grads)), opt_state, flat,
                           lr=self.lr, momentum=self.momentum,
                           decay=self.decay)
                del grads       # not alive through the next step
                for v in flat.values():
                    v.requires_grad_(True)
        return (_nested({k: v.detach() for k, v in flat.items()}),
                float(loss.detach()))

    def batched_train_spec(self):
        """The batched FEL engine's spec (``fl.batched_fel``): token rows
        stack densely; the per-example loss is the per-row mean token CE
        plus ``DEFAULT_AUX_WEIGHT`` times the (batch-global) aux term, so
        for the dense, RWKV-6 and hybrid families (aux ≡ 0) the masked
        mean is ``Model.loss``. A MoE family's aux term sees the padded
        rows, as in the reference: route those through the reference
        loop. Nothing is drawn. Memoized per adapter."""
        if getattr(self, "_batched_spec", None) is not None:
            return self._batched_spec
        from repro_torch.fl.batched_fel import BatchedTrainSpec
        model = self.model

        def stack(dataset):
            return {"rows": np.asarray(dataset.tokens, np.int32)}

        def per_example(params, batch, rand):
            rows = batch["rows"]
            b = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
            logits, aux = model.forward(params, b)
            logits = logits.to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                b["labels"].long()[..., None])[..., 0]
            return torch.mean(lse - gold, dim=-1) + DEFAULT_AUX_WEIGHT * aux

        self._batched_spec = BatchedTrainSpec(
            stack, lambda seed, step, bs, device: None, per_example,
            self.local_epochs, self.batch_size, self.lr, self.momentum,
            self.decay)
        return self._batched_spec


    @torch.no_grad()
    def evaluate(self, params: dict, dataset: Any) -> EvalResult:
        rows = torch.as_tensor(dataset.tokens, device=self.device)
        batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
        # one forward pass serves both metrics (Model.loss would rerun it)
        logits, aux = self.model.forward(params, batch)
        acc = torch.mean((torch.argmax(logits, dim=-1)
                          == batch["labels"].long()).to(torch.float32))
        loss = (_token_ce_loss(logits, batch["labels"])
                + DEFAULT_AUX_WEIGHT * aux)
        return EvalResult(float(acc), float(loss))


def tiny_transformer_config(vocab_size: int = 256, d_model: int = 64,
                            n_layers: int = 2) -> ArchConfig:
    """CPU-scale dense transformer for BHFL rounds and tests."""
    return ArchConfig(
        name="bhfl-transformer-tiny", family="dense",
        n_layers=n_layers, d_model=d_model, n_heads=2, n_kv_heads=2,
        head_dim=d_model // 2, d_ff=2 * d_model, vocab_size=vocab_size,
        source="repro.fl.adapters")


def tiny_rwkv6_config(vocab_size: int = 256, d_model: int = 64,
                      n_layers: int = 2) -> ArchConfig:
    """CPU-scale RWKV-6 (attention-free) for BHFL rounds and tests."""
    return ArchConfig(
        name="bhfl-rwkv6-tiny", family="ssm",
        n_layers=n_layers, d_model=d_model, n_heads=d_model // 32,
        n_kv_heads=d_model // 32, d_ff=2 * d_model, vocab_size=vocab_size,
        rwkv=True, rwkv_head_size=32, source="repro.fl.adapters")


def transformer_adapter(vocab_size: int = 256, d_model: int = 64,
                        n_layers: int = 2, **hp) -> LMAdapter:
    return LMAdapter(tiny_transformer_config(vocab_size, d_model, n_layers),
                     **hp)


def rwkv6_adapter(vocab_size: int = 256, d_model: int = 64,
                  n_layers: int = 2, **hp) -> LMAdapter:
    return LMAdapter(tiny_rwkv6_config(vocab_size, d_model, n_layers), **hp)


_NAMED = {"mlp": MLPAdapter, "transformer": transformer_adapter,
          "rwkv6": rwkv6_adapter}


def make_adapter(model: "str | ModelAdapter", **kwargs) -> ModelAdapter:
    """Resolve ``model`` to an adapter: pass through an adapter instance,
    or build one by name ('mlp' | 'transformer' | 'rwkv6') from
    ``kwargs`` (``device`` among them)."""
    if isinstance(model, str):
        try:
            return _NAMED[model](**kwargs)
        except KeyError:
            raise ValueError(
                f"unknown model {model!r}; choose from {sorted(_NAMED)} "
                f"or pass a ModelAdapter instance") from None
    if isinstance(model, ModelAdapter):
        return model
    raise TypeError(f"model must be a name or ModelAdapter, got "
                    f"{type(model).__name__}")


def params_from_jax(params: Mapping[str, Any], cfg: MLPConfig = MLPConfig(),
                    device: torch.device | str | None = None) -> dict:
    """The reference's MLP parameters (a dict of numpy arrays, e.g.
    ``{k: np.asarray(v) for k, v in repro_params.items()}``) as the port's
    float32 tensors on ``device`` (the card unless the caller asks for
    the CPU). Names, shapes and dtypes are checked against ``cfg``; values
    are copied bit for bit."""
    dev = resolve_device(device)
    want = {"w1": (cfg.in_dim, cfg.hidden), "b1": (cfg.hidden,),
            "w2": (cfg.hidden, cfg.n_classes), "b2": (cfg.n_classes,)}
    if set(params) != set(want):
        raise ValueError(f"MLP parameters must be named {sorted(want)}; "
                         f"got {sorted(params)}")
    out = {}
    for k, shape in want.items():
        arr = np.asarray(params[k])
        if arr.shape != shape:
            raise ValueError(f"{k} has shape {arr.shape}; {cfg} needs "
                             f"{shape}")
        if arr.dtype != np.float32:
            raise TypeError(f"{k} has dtype {arr.dtype}; the MLP is float32")
        out[k] = torch.from_numpy(arr.copy()).to(dev)
    return out

