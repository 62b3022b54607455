"""Family-dispatched model API: init / forward / loss / prefill / decode.

Port of ``repro.models.model_api``: RWKV-6, the Zamba2 hybrid and the
attention families (dense, MoE, and the cross-attention families vlm and
audio, whose batch carries a ``context`` of frontend embeddings, cast to
bfloat16 here as in the reference). The paper's MLP family is not run
through ``Model`` (``repro_torch.configs.NOT_PORTED``).

    from repro_torch.models.model_api import Model
    model = Model(cfg)                      # on the card; device="cpu" asks
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    logits, aux = model.forward(params, {"tokens": tokens})
    batch = {"tokens": tokens}              # vlm, audio: and "context"
    loss = model.loss(params, {**batch, "labels": labels},
                      FwdOptions(remat=False))   # or no options
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode_step(params, cache, tokens, pos)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import NOT_PORTED
from repro_torch.core.serialization import map_tree
from repro_torch.models import ssm_models, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.models.mesh_ops import is_dtensor, on_mesh
from repro_torch.models.transformer import FwdOptions, check_options

# default weight of the auxiliary (load-balancing) loss term; eval paths
# that recombine (logits, aux) outside Model.loss must use the same value
DEFAULT_AUX_WEIGHT = 0.01
# the families Model runs besides RWKV-6 (config.rwkv)
PORTED_FAMILIES = ("hybrid",) + transformer.FAMILIES


def _token_ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over (B, S, V) logits, in float32:
    logsumexp minus the gold logit."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # the reference's masked-iota sum, which a vocab-sharded V
        # reduces as a partial sum (a gather along it does not)
        vidx = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(vidx == labels.long()[..., None],
                                     logits, 0.0), dim=-1)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


@dataclass(frozen=True)
class Model:
    """``device=None`` is the CUDA card (and raises without one); pass
    ``device="cpu"`` to run on the CPU."""

    cfg: ArchConfig
    device: Optional[torch.device | str] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if not (self.cfg.rwkv or self.cfg.family in PORTED_FAMILIES):
            why = NOT_PORTED.get(self.cfg.family,
                                 "the reference has no such family")
            raise NotImplementedError(f"{self.cfg.name} ({self.cfg.family}) "
                                      f"does not run through Model: {why}")

    # -- params -------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random weights drawn from ``generator``, which must live on
        ``self.device``."""
        if generator.device.type != self.device.type:
            raise ValueError(f"the generator is on {generator.device}; the "
                             f"model runs on {self.device}")
        if self.cfg.rwkv:
            return ssm_models.rwkv_init_params(self.cfg, generator)
        if self.cfg.family == "hybrid":
            return ssm_models.hybrid_init_params(self.cfg, generator)
        return transformer.init_params(self.cfg, generator)

    def param_shapes(self) -> dict:
        """{name: (shape, dtype)} of the parameter tree, nested as it is
        (the reference's ``abstract_params``)."""
        if self.cfg.rwkv:
            return ssm_models.rwkv_param_shapes(self.cfg)
        if self.cfg.family == "hybrid":
            return ssm_models.hybrid_param_shapes(self.cfg)
        return transformer.param_shapes(self.cfg)

    def abstract_params(self) -> dict:
        """The parameter tree as tensors on the meta device: the
        reference's shapes and dtypes, nothing allocated."""
        return map_tree(lambda sd: torch.empty(sd[0], dtype=sd[1],
                                               device="meta"),
                        self.param_shapes())

    def param_pspecs(self, tp: int, fsdp: int) -> dict:
        """The baseline :class:`~repro_torch.models.sharding.PSpec` tree
        of the parameters on a (fsdp × tp) mesh."""
        from repro_torch.models.sharding import param_pspecs
        return param_pspecs(self.abstract_params(), tp, fsdp,
                            self.cfg.family)

    def n_params(self) -> int:
        return sum(math.prod(shape) for _, shape in
                   _shape_leaves(self.param_shapes()))

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: routed experts count k of E)."""
        cfg = self.cfg
        if not cfg.n_experts:
            return self.n_params()
        total = 0
        for path, shape in _shape_leaves(self.param_shapes()):
            size = math.prod(shape)
            if ("moe" in path and "shared" not in path
                    and "router" not in path):
                size = size * cfg.experts_per_token // cfg.n_experts
            total += size
        return total

    # -- context stub (vlm/audio frontend carve-out) -------------------------
    def needs_context(self) -> bool:
        return self.cfg.family in transformer.CONTEXT_FAMILIES

    def context_shape(self, batch: int) -> tuple:
        return (batch, self.cfg.n_context_tokens, self.cfg.d_model)

    def stub_context(self, batch: int) -> torch.Tensor:
        """The serving engine's stand-in for the frontend's embeddings:
        the reference's ``0.1 * ones``, float32, of :meth:`context_shape`."""
        return 0.1 * torch.ones(self.context_shape(batch),
                                dtype=torch.float32, device=self.device)

    # -- forward / loss -------------------------------------------------------
    def forward(self, params: dict, batch: dict,
                opts: Optional[FwdOptions] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, S, V), aux loss ()). ``opts`` as the reference's,
        within what :func:`transformer.check_options` takes."""
        check_options(opts)
        with on_mesh(params.get("embed")):
            return self._forward(params, batch, opts)

    def _forward(self, params: dict, batch: dict,
                 opts: Optional[FwdOptions]) -> tuple:
        remat = opts is not None and opts.remat
        if self.cfg.rwkv:
            logits = ssm_models.rwkv_forward(params, batch["tokens"],
                                             self.cfg, remat=remat)
            return logits, torch.zeros((), device=logits.device)
        if self.cfg.family == "hybrid":
            logits = ssm_models.hybrid_forward(
                params, batch["tokens"], self.cfg, remat=remat,
                sharded=opts is not None and opts.seq_shard_axis is not None)
            return logits, torch.zeros((), device=logits.device)
        return transformer.forward(params, batch["tokens"], self.cfg,
                                   context=_context(batch), remat=remat,
                                   opts=opts)

    def loss(self, params: dict, batch: dict,
             opts: Optional[FwdOptions] = None,
             aux_weight: float = DEFAULT_AUX_WEIGHT) -> torch.Tensor:
        logits, aux = self.forward(params, batch, opts)
        with on_mesh(logits):
            return _token_ce_loss(logits, batch["labels"]) + aux_weight * aux

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int) -> Any:
        if self.cfg.rwkv:    # the recurrent state does not grow
            return ssm_models.rwkv_init_caches(self.cfg, batch, self.device)
        if self.cfg.family == "hybrid":
            return ssm_models.hybrid_init_cache(self.cfg, batch, seq_len,
                                                self.device)
        return transformer.init_cache(self.cfg, batch, seq_len, self.device)

    def abstract_cache(self, batch: int, seq_len: int) -> Any:
        """:meth:`init_cache` on the meta device: its shapes and dtypes,
        nothing allocated."""
        return Model(self.cfg, device="meta").init_cache(batch, seq_len)

    def prefill(self, params: dict, batch: dict,
                opts: Optional[FwdOptions] = None):
        """The last position's logits (B, 1, V) and a cache. A transformer
        fills a prompt-sized KV cache in one forward. The recurrent and
        hybrid prefill runs forward for the logits and returns a fresh
        cache, as the reference has it: the serving engine builds the
        state by replaying the prompt through :meth:`decode_step`.
        ``opts``: the mesh levers; remat is never on here."""
        tokens = batch["tokens"]
        check_options(opts)
        if opts is not None:
            opts = opts._replace(remat=False)
        if not (self.cfg.rwkv or self.cfg.family == "hybrid"):
            with on_mesh(params.get("embed")):
                return transformer.prefill(params, tokens, self.cfg,
                                           context=_context(batch),
                                           opts=opts)
        logits, _ = self.forward(params, batch, opts)
        cache = self.init_cache(tokens.shape[0], tokens.shape[1])
        return logits[:, -1:], cache

    def decode_step(self, params: dict, cache: Any, tokens: torch.Tensor,
                    pos: Any):
        with on_mesh(params.get("embed")):
            return self._decode_step(params, cache, tokens, pos)

    def _decode_step(self, params: dict, cache: Any, tokens: torch.Tensor,
                     pos: Any):
        if self.cfg.rwkv:
            return ssm_models.rwkv_decode_step(params, cache, tokens, pos,
                                               self.cfg)
        if self.cfg.family == "hybrid":
            return ssm_models.hybrid_decode_step(params, cache, tokens, pos,
                                                 self.cfg)
        return transformer.decode_step(params, cache, tokens, pos, self.cfg)


def _context(batch: dict) -> Optional[torch.Tensor]:
    """The batch's ``context`` in the compute dtype, or None."""
    ctx = batch.get("context")
    return None if ctx is None else ctx.to(COMPUTE_DTYPE)


def _shape_leaves(spec: dict, path: str = ""):
    """(path "a/b", shape) of each leaf of a ``param_shapes`` spec."""
    for k, v in spec.items():
        key = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            yield from _shape_leaves(v, key)
        else:
            yield key, v[0]
