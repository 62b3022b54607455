"""PoFEL-governed training launcher (port of ``repro.launch.train``).

Trains a reduced variant of the selected architecture for real rounds:
local FedSGD per cluster, the consensus on the device (Eq. 1 and Eq. 2
through the ME kernels, the BTSV leader), the outer update, then the
host-side chain: the consensus statistics are digested, signed into a
block and appended every round, and the chain is verified at the end.
vlm and audio models train with the reference's stand-in context
(``0.1 * ones`` bfloat16 of (C, B/C, n_context_tokens, d_model)), so
their cross-attention is differentiated with keys of their own length.

Runs on the card unless ``--device cpu`` asks for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --steps 3 \\
      --device cpu

``--trace PATH`` writes the run's spans (``repro_torch.obs``: each
round's ``pofel_round`` tree, each block's ``chain``, the garbage
collector's passes; on the card with the device's readings) as a Chrome
trace (``repro_torch.obs.load_trace``, or https://ui.perfetto.dev).
"""

from __future__ import annotations

import argparse
import time
from contextlib import contextmanager
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.blockchain.block import Block
from repro_torch.blockchain.ledger import Ledger
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import crypto
from repro_torch.data.tokens import TokenBatchSpec, synthetic_token_batches
from repro_torch.fl import pofel_trainer as pt
from repro_torch.models.model_api import Model
from repro_torch.models.transformer import FwdOptions


def append_round_block(ledger: Ledger, keypair: crypto.ECDSAKeyPair,
                       round_: int, metrics: pt.ConsensusMetrics) -> Block:
    """Host-side chain append: the device produced the consensus stats;
    the control plane signs and records them. Traced as a ``chain``
    span."""
    with obs.get_recorder().span("chain", cat="chain"):
        sims = metrics.similarities.detach().cpu().numpy()
        wv = metrics.vote_weights.detach().cpu().numpy()
        adv = {int(np.argmax(sims)): float(wv.sum())}
        block = Block(
            index=ledger.height, round=round_,
            leader_id=int(metrics.leader), prev_hash=ledger.head_hash,
            model_digests={i: crypto.sha256_digest(sims[i].tobytes()).hex()
                           for i in range(len(sims))},
            global_model_digest=crypto.sha256_digest(sims.tobytes()).hex(),
            votes={i: int(np.argmax(sims)) for i in range(len(sims))},
            vote_weights={i: float(wv[i]) for i in range(len(wv))},
            advotes=adv,
        ).signed(keypair)
        ledger.append(block, leader_pk=keypair.public_key)
        return block


class TrainRun(NamedTuple):
    """What :func:`train_reduced` leaves: the last state, the chain and
    each round's metrics (on the host)."""
    state: pt.PoFELTrainState
    ledger: Ledger
    metrics: List[pt.ConsensusMetrics]


def round_batch(raw: dict, model: Model, n_clusters: int,
                device: torch.device) -> dict:
    """A stream batch as the trainer's: every leaf (C, B/C, ...), and the
    stand-in context for a model that needs one."""
    cfg = model.cfg
    C = n_clusters
    B, S = raw["tokens"].shape
    b = {k: torch.as_tensor(raw[k]).reshape(C, B // C, S).to(device)
         for k in ("tokens", "labels")}
    if model.needs_context():
        b["context"] = 0.1 * torch.ones(
            (C, B // C, cfg.n_context_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    return b


def train_reduced(arch: str, steps: int, n_clusters: int, batch: int,
                  seq: int, seed: int, outer: str,
                  device: torch.device | str | None = None) -> TrainRun:
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = Model(cfg, device=dev)
    tcfg = pt.PoFELTrainConfig(n_clusters=n_clusters, inner_lr=1e-2,
                               outer=outer)
    state = pt.init_train_state(
        model, tcfg, torch.Generator(device=dev).manual_seed(seed))
    lambdas = torch.ones((n_clusters,), dtype=torch.float32, device=dev)
    opts = FwdOptions(remat=False)

    spec = TokenBatchSpec(batch, seq, cfg.vocab_size)
    stream = synthetic_token_batches(spec, seed=seed)
    ledger = Ledger(0)
    keypair = crypto.ECDSAKeyPair.generate(b"launcher")

    print(f"arch={arch} reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"V={cfg.vocab_size} params={model.n_params():,} device={dev}")
    history = []
    for k in range(steps):
        b = round_batch(next(stream), model, n_clusters, dev)
        t0 = time.perf_counter()
        state, metrics = pt.pofel_round(model, state, b, lambdas, tcfg, opts)
        metrics = pt.ConsensusMetrics(*(t.detach().cpu() for t in metrics))
        dt = time.perf_counter() - t0
        history.append(metrics)
        append_round_block(ledger, keypair, k, metrics)
        print(f"round {k:3d}  loss={float(torch.mean(metrics.loss)):.4f}  "
              f"leader={int(metrics.leader)}  "
              f"sims=[{float(metrics.similarities.min()):.4f},"
              f"{float(metrics.similarities.max()):.4f}]  "
              f"chain_height={ledger.height}  {dt*1e3:.0f}ms")
    if not ledger.verify_chain():
        raise RuntimeError(f"the chain of {ledger.height} blocks does not "
                           f"verify")
    print(f"done: {steps} PoFEL rounds, chain verified at height "
          f"{ledger.height}")
    return TrainRun(state, ledger, history)


@contextmanager
def trace_to(path: Optional[str], label: str, device) -> Iterator[None]:
    """Where a path is given, the block's spans and the collector's passes
    written there as a Chrome trace when it ends (the device's readings
    resolved first)."""
    if path is None:
        yield
        return
    rec = obs.TraceRecorder(label, device=resolve_device(device))
    with obs.use_recorder(rec), obs.record_collector(rec):
        yield
    rec.resolve()
    obs.write_chrome_trace(path, [(label, rec)])
    print(f"trace: {len(rec.spans)} spans written to {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b",
                    choices=[a for a in ARCH_IDS if a != "mnist-mlp"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outer", default="sgd1", choices=["sgd1", "nesterov"])
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the run's spans as a Chrome trace")
    args = ap.parse_args(argv)
    with trace_to(args.trace, args.arch, args.device):
        train_reduced(args.arch, args.steps, args.clusters, args.batch,
                      args.seq, args.seed, args.outer, device=args.device)


if __name__ == "__main__":
    main()
