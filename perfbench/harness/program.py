"""The system under test: ``repro_torch``'s PoFEL trainer, one round as
``repro_torch.launch.train.train_reduced`` runs it, at full width.

A round is ``launch.train.round_batch`` (a pool batch as (C, B/C, S)
leaves; the pool's own context takes the place of the launcher's
constant stand-in), ``fl.pofel_trainer.pofel_round`` (sgd1,
λ all ones), the consensus metrics brought to the host, and
``launch.train.append_round_block`` onto a ``blockchain.ledger.Ledger``.
The benchmark makes the weights and the batches; the program gets them
and nothing else. This is the only module of the benchmark that imports
the program, and it imports it from the checkout's ``src/``.
"""

from __future__ import annotations

import contextlib
import sys
from dataclasses import fields
from typing import Any, Callable, List, Optional

import torch

from perfbench.harness import weights as W
from perfbench.harness.spec import ROOT


def import_program():
    """The program's modules, from ``src/`` of the checkout."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.blockchain.ledger import Ledger
    from repro_torch.core import crypto
    from repro_torch.core.btsv import BTSVConfig, init_history
    from repro_torch.fl import pofel_trainer as pt
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model_api import Model
    from repro_torch.models.transformer import FwdOptions
    return dict(Ledger=Ledger, crypto=crypto, BTSVConfig=BTSVConfig,
                init_history=init_history, pt=pt, ops=ops,
                launch_train=launch_train, ArchConfig=ArchConfig,
                Model=Model, FwdOptions=FwdOptions)


def keypair_seed(seed: int) -> bytes:
    """The bytes the chain's signing key is derived from."""
    return b"perfbench-%d" % seed


class Program:
    """One trainer: the model, its PoFEL state and the chain. Built once
    in set-up and handed to the window."""

    def __init__(self, arch: dict, traffic: dict, weights: dict, seed: int,
                 device, replicas: Optional[dict] = None):
        m = self.m = import_program()
        self.device = torch.device(device)
        known = {f.name for f in fields(m["ArchConfig"])}
        self.cfg = m["ArchConfig"](**{k: v for k, v in arch.items()
                                      if k in known})
        self.model = m["Model"](self.cfg, device=self.device)
        W.check_layout(arch, self.model.param_shapes())
        pf = traffic["pofel"]
        self.C = traffic["clusters"]
        self.tcfg = m["pt"].PoFELTrainConfig(
            n_clusters=self.C, inner_lr=traffic["inner_lr"],
            outer=traffic["outer"], g_max=pf["g_max"],
            btsv=m["BTSVConfig"](**pf["btsv"]))
        self.opts = m["FwdOptions"](remat=traffic["remat"])
        self.lam = torch.ones((self.C,), dtype=torch.float32,
                              device=self.device)
        self.state = self._state(weights, replicas)
        self.ledger = m["Ledger"](0)
        self.keypair = m["crypto"].ECDSAKeyPair.generate(keypair_seed(seed))
        self.rounds = 0

    def _state(self, params: dict, replicas: Optional[dict]):
        """The trainer's state as ``pofel_trainer.init_train_state``
        builds it, around the benchmark's weights: the replicas as
        ``expand`` views of the global model (or, where given, the
        benchmark's (C, ...) ``replicas``, a flat tree), float32 outer
        momenta, the BTSV history and the round."""
        pt, C = self.m["pt"], self.C

        def tree(fn, t):
            return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                    for k, v in t.items()}

        return pt.PoFELTrainState(
            cluster_params=W.nest(replicas) if replicas is not None else
            tree(lambda t: t[None].expand(C, *t.shape), params),
            global_params=params,
            outer_momentum=tree(lambda t: torch.zeros(
                t.shape, dtype=torch.float32, device=self.device), params),
            btsv_history=self.m["init_history"](
                C, self.tcfg.btsv).to(self.device),
            round=torch.zeros((), dtype=torch.int32, device=self.device))

    def round(self, raw: dict, spans: Optional[Callable] = None):
        """One round on a pool batch; the consensus metrics on the host.
        ``spans(name)`` (a context manager) brackets each call."""
        span = spans or (lambda name: contextlib.nullcontext())
        lt, pt = self.m["launch_train"], self.m["pt"]
        with span("batch"):
            b = lt.round_batch(raw, self.model, self.C, self.device)
            if "context" in raw:
                b["context"] = raw["context"].reshape(b["context"].shape)
        with span("pofel_round"):
            self.state, metrics = pt.pofel_round(
                self.model, self.state, b, self.lam, self.tcfg, self.opts)
        with span("to_host"):
            metrics = pt.ConsensusMetrics(*(t.detach().cpu()
                                            for t in metrics))
        with span("chain"):
            lt.append_round_block(self.ledger, self.keypair, self.rounds,
                                  metrics)
        self.rounds += 1
        return metrics

    def global_params(self) -> dict:
        return self.state.global_params

    def history(self) -> torch.Tensor:
        return self.state.btsv_history.detach().cpu()

    def blocks(self) -> List[Any]:
        return list(self.ledger.blocks)

    def chain_verifies(self) -> bool:
        """The ledger's own check: links, and every leader's signature
        under the launcher's key."""
        return bool(self.ledger.verify_chain(
            {i: self.keypair.public_key for i in range(self.C)}))


@contextlib.contextmanager
def wrapped(program: Program, spans: Callable):
    """``fl.pofel_trainer.local_step`` and ``consensus`` wrapped in
    ``spans`` for the duration (``pofel_round`` looks both up in the
    module at each call)."""
    pt = program.m["pt"]
    inner = pt.local_step, pt.consensus

    def wrap(fn, name):
        def run(*a, **kw):
            with spans(name):
                return fn(*a, **kw)
        return run

    pt.local_step = wrap(inner[0], "local_step")
    pt.consensus = wrap(inner[1], "consensus")
    try:
        yield
    finally:
        pt.local_step, pt.consensus = inner


class ForwardMemory:
    """The card's allocated bytes when ``Model.loss`` returns, the most
    over the calls made while it is on: what the forward leaves for the
    backward (a copy of ``chip_smoke.ForwardMemory``'s reading). Wraps the
    model's class, whose ``loss`` ``local_step`` looks up at each call."""

    def __init__(self, program: Program):
        self.cls, self.dev = type(program.model), program.device
        self.end = 0

    def __enter__(self):
        inner = self.inner = self.cls.__dict__["loss"]

        def loss(model, *a, **kw):
            value = inner(model, *a, **kw)
            if self.dev.type == "cuda":
                self.end = max(self.end,
                               torch.cuda.memory_allocated(self.dev))
            return value

        self.cls.loss = loss
        return self

    def __exit__(self, *exc):
        self.cls.loss = self.inner
