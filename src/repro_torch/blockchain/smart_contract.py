"""The vote-tally smart contract (paper §4.3): BTSV wrapped in contract
semantics — nodes submit (vote, prediction) transactions for a round, and
once all expected submissions arrive the tally executes deterministically.

Every BCFL node runs an identical copy; determinism of the tally makes
the contract's output consensus-safe. The tally is N×N host contract code:
it runs in float32 torch on the CPU, whatever device the models live on,
and yields a float32 BTSV result with the ``present`` mask applied.

Votes travel as signed envelopes (``repro_torch.core.envelope``): a submission
may carry a ``SignedEnvelope(kind="vote")`` whose payload digest binds the
(voter, round, vote, predictions) tuple. When the contract is constructed
with the nodes' ``public_keys``, the tally batch-verifies the round's vote
envelopes in one ``verify_batch`` call and drops forged ones — recording
the attributed voter in :attr:`VoteTallyContract.rejected_votes`, so a
bribed or spoofed vote is *provably* someone's, instead of resting on
trust (previously votes were unsigned). Unsigned submissions remain
accepted for back-compat unless ``require_signatures=True``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import crypto
from repro_torch.core.btsv import (BTSVConfig, BTSVResult, btsv_round,
                                   init_history)
from repro_torch.core.envelope import SignedEnvelope, verify_envelopes


def vote_payload_digest(node_id: int, round: int, vote: int,
                        predictions: np.ndarray) -> bytes:
    """The digest a vote envelope commits to: voter ‖ round ‖ vote ‖ P^i(k)."""
    return crypto.sha256_digest(
        node_id.to_bytes(8, "big", signed=True),
        round.to_bytes(8, "big", signed=True),
        vote.to_bytes(8, "big", signed=True),
        np.asarray(predictions, np.float32).tobytes())


@dataclass(frozen=True)
class VoteSubmission:
    node_id: int
    round: int
    vote: int                 # e_best^i(k)
    predictions: np.ndarray   # P^i(k), shape (N,), sums to 1
    envelope: Optional[SignedEnvelope] = None   # signed wire form

    @classmethod
    def signed(cls, node_id: int, round: int, vote: int,
               predictions: np.ndarray,
               private_key: int) -> "VoteSubmission":
        env = SignedEnvelope.seal(
            "vote", round, node_id,
            vote_payload_digest(node_id, round, vote, predictions),
            private_key)
        return cls(node_id, round, vote, predictions, env)


class ContractError(ValueError):
    pass


class VoteTallyContract:
    """State machine: collect N submissions per round, then tally.

    ``public_keys`` arms signature enforcement: envelope-carrying
    submissions are batch-verified at tally time and forged ones dropped
    (and attributed in :attr:`rejected_votes`). ``require_signatures``
    additionally drops unsigned submissions.
    """

    def __init__(self, n_nodes: int, cfg: BTSVConfig = BTSVConfig(),
                 public_keys: Optional[Dict[int, crypto.Point]] = None,
                 require_signatures: bool = False):
        self.n_nodes = n_nodes
        self.cfg = cfg
        self.public_keys = public_keys
        self.require_signatures = require_signatures
        self._pending: Dict[int, Dict[int, VoteSubmission]] = {}
        self._history = init_history(n_nodes, cfg)
        self._results: Dict[int, BTSVResult] = {}
        # round -> {voter -> reason}: votes dropped at tally time with
        # attribution (forged envelope / missing signature)
        self.rejected_votes: Dict[int, Dict[int, str]] = {}

    def submit(self, s: VoteSubmission) -> None:
        if not (0 <= s.node_id < self.n_nodes):
            raise ContractError(f"unknown node {s.node_id}")
        if not (0 <= s.vote < self.n_nodes):
            raise ContractError(f"vote out of range: {s.vote}")
        preds = np.asarray(s.predictions, np.float32)
        if preds.shape != (self.n_nodes,):
            raise ContractError(f"prediction shape {preds.shape} != ({self.n_nodes},)")
        if not np.isclose(preds.sum(), 1.0, atol=1e-3):
            raise ContractError("predictions must sum to 1")
        if np.any(preds < 0):
            raise ContractError("negative prediction probability")
        if s.envelope is not None:
            # structural binding is cheap (one hash) — check at submit so a
            # mismatched envelope is rejected before it occupies the slot
            e = s.envelope
            if (e.kind != "vote" or e.sender != s.node_id
                    or e.round != s.round
                    or e.payload_digest != vote_payload_digest(
                        s.node_id, s.round, s.vote, preds)):
                raise ContractError(
                    f"vote envelope does not bind the submission "
                    f"(node {s.node_id}, round {s.round})")
        per_round = self._pending.setdefault(s.round, {})
        if s.node_id in per_round:
            raise ContractError(f"duplicate submission from node {s.node_id}")
        per_round[s.node_id] = s

    def ready(self, round: int) -> bool:
        return len(self._pending.get(round, {})) == self.n_nodes

    def _drop_forged(self, round: int,
                     subs: Dict[int, VoteSubmission]) -> Dict[int, VoteSubmission]:
        """Batch-verify the round's vote envelopes; return the surviving
        submissions, attributing the dropped ones in ``rejected_votes``."""
        if self.public_keys is None:
            return subs
        signed = [s for s in subs.values() if s.envelope is not None]
        rejected: Dict[int, str] = {}
        if signed:
            batch = verify_envelopes([s.envelope for s in signed],
                                     self.public_keys)
            for i in batch.bad:
                rejected[signed[i].node_id] = "forged-envelope"
        if self.require_signatures:
            for s in subs.values():
                if s.envelope is None:
                    rejected[s.node_id] = "unsigned-vote"
        if rejected:
            self.rejected_votes.setdefault(round, {}).update(rejected)
        return {i: s for i, s in subs.items() if i not in rejected}

    def tally(self, round: int,
              min_submissions: Optional[int] = None) -> BTSVResult:
        """Execute Alg. 4 once enough submissions for ``round`` are in.

        ``min_submissions`` makes the tally quorum-aware (the fault-injected
        network of ``repro_torch.sim`` loses votes to drops/partitions/churn):
        with at least that many submissions the tally proceeds, treating
        absent voters as *neutral* abstentions — a zero one-hot vote row,
        exclusion from the BTS population means, and a zero BTS score, so
        a dropped packet never erodes an honest node's cumulative history
        the way a bad vote would. The default (``None``) keeps the strict
        all-N contract semantics.

        A submission whose vote envelope fails the batch signature check is
        dropped *before* the quorum count — a forged vote can neither steer
        the tally nor prop up its quorum.
        """
        if round in self._results:
            return self._results[round]
        subs = self._drop_forged(round, self._pending.get(round, {}))
        expected = self.n_nodes if min_submissions is None else min_submissions
        if len(subs) < expected:
            raise ContractError(
                f"round {round}: {len(subs)}/{expected} submissions "
                f"(of {self.n_nodes} nodes)")
        uniform = np.full((self.n_nodes,), 1.0 / self.n_nodes, np.float32)
        votes = torch.tensor([subs[i].vote if i in subs else -1
                              for i in range(self.n_nodes)],
                             dtype=torch.int64)
        P = torch.from_numpy(np.stack(
            [np.asarray(subs[i].predictions, np.float32)
             if i in subs else uniform       # masked placeholder
             for i in range(self.n_nodes)]))
        present = None
        if len(subs) < self.n_nodes:
            present = torch.tensor([1.0 if i in subs else 0.0
                                    for i in range(self.n_nodes)],
                                   dtype=torch.float32)
        result, self._history = btsv_round(votes, P, self._history, self.cfg,
                                           present=present)
        self._results[round] = result
        self._pending.pop(round, None)
        return result

    def drop_round(self, round: int) -> None:
        """Discard a round's partial submissions (an aborted round — quorum
        never formed before the timeout — must not poison a retry)."""
        self._pending.pop(round, None)

    def result(self, round: int) -> Optional[BTSVResult]:
        return self._results.get(round)
