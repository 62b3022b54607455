"""Phase-based PoFEL protocol API (paper §4, Alg. 1).

Alg. 1 is an explicit five-phase protocol; each phase is a composable
object operating on a shared :class:`RoundContext`:

  1. :class:`CommitReveal`     — HCDS commit/reveal model exchange (§4.1)
  2. :class:`ModelEvaluation`  — Eq. 1 aggregation + Eq. 2 similarity (§4.2)
  3. :class:`VoteCollection`   — per-node vote submission to the contract
  4. :class:`Tally`            — BTSV weighted tally, leader election (§4.3)
  5. :class:`BlockMint`        — leader mints + signs; all ledgers append

``PoFELConsensus`` (``repro_torch.core.consensus``) composes the default
pipeline; experiments, attacks, and benchmarks hook individual phases —
either by replacing a phase object in ``consensus.phases`` (e.g. the
sharded in-graph ME from ``repro_torch.fl.sharded_consensus``) or by
registering before/after callbacks with ``consensus.add_phase_hook`` —
instead of monkey-patching a monolithic ``run_round``.

Two execution modes per phase:

* **ideal** (``ctx.env is None``) — every node present, synchronous,
  lossless: the paper's §7 setting, byte-identical to the pre-sim code;
* **networked** (``ctx.env`` set) — messages travel a fault-injected
  discrete-event bus (``repro_torch.sim.network.SimEnv``): commits/reveals can
  be lost or withheld, a model participates in ME only if a quorum of
  nodes holds its reveal, the tally proceeds on ≥ quorum votes
  (abstainers neutral), and BlockMint re-elects down the advote ranking
  when the elected leader times out. A phase that cannot reach its
  quorum before the timeout raises :class:`QuorumNotReached` — the
  driver records a liveness gap and moves to the next round.

This is the PyTorch port's copy of ``repro.core.phases``. ME leaves
(gw, sims) on the models' device; the host protocol reads them back
through :func:`_host` — sims once for the votes, gw once for the block's
``global_model_digest``, which hashes its float32 bytes (never a tensor's
storage).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.blockchain.block import Block, block_hash
from repro_torch.blockchain.ledger import InvalidBlock, Ledger
from repro_torch.blockchain.smart_contract import (ContractError,
                                                   VoteSubmission,
                                                   VoteTallyContract)
from repro_torch.core import crypto
from repro_torch.core.btsv import BTSVResult
from repro_torch.core.envelope import (commit_signing_digest, tags_equal,
                                       verify_envelopes)
from repro_torch.core.hcds import HCDSNode, run_hcds_round
from repro_torch.core.model_eval import (MEResult, make_predictions,
                                         model_evaluation_pytrees)
from repro_torch.core.serialization import serialize_pytree
from repro_torch.obs import get_recorder

# (node_id, honest_vote, honest_predictions) -> (vote, predictions)
VoteHook = Callable[[int, int, np.ndarray], tuple[int, np.ndarray]]
# callback fired around a phase: fn(phase_name, ctx)
PhaseHook = Callable[[str, "RoundContext"], None]


def _host(x: Any) -> np.ndarray:
    """A device tensor (or array-like) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class QuorumNotReached(RuntimeError):
    """A networked phase timed out below its quorum — the round cannot
    complete (liveness gap). The driver should skip to the next round."""


def honest_predictions(n: int, vote: int, g_max: float) -> np.ndarray:
    """An honest voter's prediction row, as a writable numpy array for the
    host-side vote path. Delegates to :func:`model_eval.make_predictions`
    so the G_max/G_min rule — including its n == 1 one-hot degenerate
    case — has exactly one implementation."""
    return _host(make_predictions(vote, n, g_max=g_max)).astype(np.float32)


@dataclass
class RoundContext:
    """Typed state flowing through one consensus round's phases.

    Inputs (set by the driver) come first; each later field is written by
    the phase named in its comment and read by the phases after it.
    """

    round: int
    models: List[Any]                    # W(k) — one parameter pytree per node
    data_sizes: List[float]              # |DS_m| per cluster
    n_nodes: int
    g_max: float = 0.99
    vote_hook: Optional[VoteHook] = None
    # networked mode: the fault-injected message bus + adversaries
    # (duck-typed ``repro_torch.sim.network.SimEnv``); None = ideal synchronous
    env: Optional[Any] = None
    # committee scope (``repro_torch.core.committee.Committee``): set when this
    # round runs over an explicit node subset inside a sharded consortium
    # — node ids in this context are committee-local, and observability
    # tags spans/events with the committee id. None = the classic single
    # global committee (byte-identical to the pre-shard pipeline).
    committee: Optional[Any] = None

    # CommitReveal
    rejected: Dict[int, str] = field(default_factory=dict)
    # networked CommitReveal: ids whose model reached a quorum of nodes
    # (None in the ideal world — every model is available by construction)
    available: Optional[List[int]] = None
    # ModelEvaluation (or a drop-in replacement like the sharded ME)
    evaluation: Optional[MEResult] = None
    # VoteCollection
    votes: Optional[np.ndarray] = None         # (N,) int64
    predictions: Optional[np.ndarray] = None   # (N, N) float32, rows sum to 1
    # Tally
    btsv: Optional[BTSVResult] = None
    leader: Optional[int] = None
    # BlockMint
    block: Optional[Block] = None
    # free-form scratch space for experiment hooks
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def similarities(self) -> np.ndarray:
        if self.evaluation is None:
            raise RuntimeError("similarities requested before ModelEvaluation ran")
        return _host(self.evaluation.similarities)

    @property
    def global_model(self) -> np.ndarray:
        if self.evaluation is None:
            raise RuntimeError("global model requested before ModelEvaluation ran")
        return _host(self.evaluation.global_model)


class ConsensusPhase:
    """One stage of Alg. 1. Subclasses read/write ``RoundContext`` fields;
    ``name`` keys phase hooks and pipeline surgery (``replace_phase``)."""

    name: str = "phase"

    def run(self, ctx: RoundContext) -> None:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} name={self.name!r}>"


class CommitReveal(ConsensusPhase):
    """Alg. 1 line 2 — HCDS at every node (commit, verify, reveal, verify).

    Networked mode: commits and reveals travel the bus (latency, drops,
    partitions), adversaries may withhold commits or equivocate reveals,
    and a model only participates in the rest of the round if its reveal
    was accepted by ≥ quorum nodes (``ctx.available``). Fewer than quorum
    available models aborts the round (:class:`QuorumNotReached`).
    """

    name = "commit_reveal"

    def __init__(self, nodes: Sequence[HCDSNode],
                 public_keys: Dict[int, crypto.Point]):
        self.nodes = list(nodes)
        self.public_keys = public_keys

    def run(self, ctx: RoundContext) -> None:
        # serialize each model once; HCDS commits and the block's model
        # digests (BlockMint) both reuse these bytes
        model_bytes = [serialize_pytree(m) for m in ctx.models]
        ctx.extra["model_bytes"] = model_bytes
        if ctx.env is not None:
            self._run_networked(ctx, model_bytes)
            return
        reveal_results = run_hcds_round(self.nodes, ctx.models, ctx.round,
                                        self.public_keys,
                                        model_bytes=model_bytes)
        for recv, senders in reveal_results.items():
            for sender, res in senders.items():
                if not res.accepted and sender not in ctx.rejected:
                    ctx.rejected[sender] = res.reason
                if res.evicted is not None:
                    # the plagiarism tie-break retroactively rejected an
                    # earlier-arrived copy from a later committer
                    if res.evicted not in ctx.rejected:
                        ctx.rejected[res.evicted] = "plagiarized-model"
                        # ideal mode has no env to note() through — emit
                        # the attributed audit event on the recorder
                        get_recorder().event("plagiarism_evicted",
                                             round=ctx.round,
                                             node=res.evicted)

    def _run_networked(self, ctx: RoundContext,
                       model_bytes: List[bytes]) -> None:
        env = ctx.env
        alive = env.alive()
        commits = {}
        for i in sorted(alive):
            if env.withholds_commit(i):
                ctx.rejected.setdefault(i, "commit-withheld")
                env.note("commit_withheld", round=ctx.round, node=i)
                continue
            c = self.nodes[i].commit(ctx.models[i], ctx.round,
                                     model_bytes=model_bytes[i])
            commits[i] = env.mutate_commit(i, c)
        # one batch verification of the phase's commit envelopes — the
        # sender set is shared by every receiver, so N×(N−1) per-message
        # checks collapse into one verify_batch; a failing batch bisects
        # down to the forged senders (attribution, not just rejection)
        senders = sorted(commits)
        batch = verify_envelopes([commits[i].envelope for i in senders],
                                 self.public_keys)
        forged_commits = {senders[j] for j in batch.bad}
        for i in sorted(forged_commits):
            ctx.rejected[i] = "forged-envelope"
            env.note("envelope_rejected", kind="commit", round=ctx.round,
                     node=i)
        deliveries = env.exchange("commit", ctx.round, commits)
        for recv, msgs in deliveries.items():
            # record in ascending sender id: the commit phase is a barrier
            # (all of a receiver's commits are in hand at the deadline), so
            # processing order is canonical, not arrival-jittered
            for sender in sorted(msgs):
                if sender in forged_commits:
                    continue        # every receiver rejects the forged tag
                self.nodes[recv].receive_commit(msgs[sender],
                                                self.public_keys[sender],
                                                verified=True)
        # the commit/reveal barrier: commitment precedence is the commit
        # transactions' chain-inclusion order (network-wide first delivery
        # on the bus), shared by every node — so plagiarism ties resolve
        # identically everywhere, and a copier that had to *observe* the
        # bytes before committing to them ranks behind the owner
        order_fn = getattr(env, "last_exchange_order", None)
        precedence = order_fn() if order_fn is not None else None
        # mid-phase crash faults at the commit→reveal boundary: the node's
        # volatile state dies with it. A fast reboot re-broadcasts its
        # commit — byte-identical after a WAL replay (receivers treat the
        # duplicate as idempotent), a FRESH statement under amnesia, which
        # every honest receiver detects and attributes as equivocation
        equivocators: set = set()
        crash_at = getattr(env, "crash_at", None)
        if crash_at is not None:
            late: Dict[int, Any] = {}
            for i in sorted(commits):
                spec = crash_at(i, "after_commit", ctx.round)
                if spec is None:
                    continue
                if not env.execute_crash(spec, i):
                    continue        # still down: nothing to re-broadcast
                late[i] = self.nodes[i].commit(ctx.models[i], ctx.round,
                                               model_bytes=model_bytes[i])
            if late:
                late_senders = sorted(late)
                late_batch = verify_envelopes(
                    [late[i].envelope for i in late_senders],
                    self.public_keys)
                late_forged = {late_senders[j] for j in late_batch.bad}
                for recv, msgs in env.exchange("commit", ctx.round,
                                               late).items():
                    for sender in sorted(msgs):
                        if sender in late_forged or recv == sender:
                            continue
                        res = self.nodes[recv].receive_commit(
                            msgs[sender], self.public_keys[sender],
                            verified=True)
                        if (not res.accepted
                                and res.reason == "commit-equivocation"):
                            equivocators.add(sender)
                for i in sorted(equivocators):
                    ctx.rejected[i] = "commit-equivocation"
                    env.note("equivocation_detected", kind="commit",
                             round=ctx.round, node=i)
                # precedence came from the FIRST commit exchange (the one
                # the reveals bind to); rank re-broadcasts that never made
                # that exchange behind everything that did
                if precedence is not None:
                    precedence += [i for i in late_senders
                                   if i not in precedence]
        for i in sorted(alive):
            self.nodes[i].finalize_commit_stage(ctx.round, precedence)
        # a node that never committed — or that crashed and is still down —
        # has nothing to reveal
        reveals = {i: env.mutate_reveal(i, self.nodes[i].reveal(ctx.round))
                   for i in sorted(commits) if i in env.alive()}
        # hash each reveal once (shared across receivers) and batch the
        # Alg. 2 line-15 re-verification for tags that differ from the
        # sender's commit tag (tag-equal reveals were proven by the commit
        # batch — same signature over the same envelope statement)
        digests = {i: crypto.sha256_digest(r.nonce, r.model_bytes)
                   for i, r in reveals.items()}
        retagged = [i for i, r in reveals.items()
                    if not tags_equal(r.tag, commits[i].tag)]
        reveal_bad = crypto.verify_batch(
            [(reveals[i].tag, self.public_keys[i],
              commit_signing_digest(ctx.round, i, digests[i]))
             for i in retagged]).bad
        forged_reveals = {retagged[j] for j in reveal_bad}
        for i in sorted(forged_reveals):
            ctx.rejected.setdefault(i, "forged-envelope")
            env.note("envelope_rejected", kind="reveal", round=ctx.round,
                     node=i)
        # who holds whose reveal, as receiver SETS (each revealer holds its
        # own): set semantics make the plagiarism-eviction bookkeeping
        # idempotent per receiver — several receivers evicting the same
        # copier discard their own ids once each, so the count can never
        # go negative and skew the quorum comparison
        holders: Dict[int, set] = {i: {i} for i in reveals}
        for recv, msgs in env.exchange("reveal", ctx.round, reveals).items():
            for sender, r in msgs.items():
                if sender in forged_reveals:
                    continue
                res = self.nodes[recv].receive_reveal(
                    r, self.public_keys[sender], digest=digests[sender])
                if res.accepted:
                    holders.setdefault(sender, set()).add(recv)
                    if res.evicted is not None:
                        # tie-break eviction: this receiver no longer holds
                        # the later committer's identical reveal
                        holders.get(res.evicted, set()).discard(recv)
                        if res.evicted not in ctx.rejected:
                            ctx.rejected[res.evicted] = "plagiarized-model"
                            env.note("plagiarism_evicted", round=ctx.round,
                                     node=res.evicted)
                elif (res.reason != "no-commitment"
                      and sender not in ctx.rejected):
                    # 'no-commitment' only means this receiver missed the
                    # sender's commit (a transport gap, not a protocol
                    # violation) — it must not brand an honest node
                    ctx.rejected[sender] = res.reason
        available = [i for i in range(ctx.n_nodes)
                     if len(holders.get(i, ())) >= env.quorum
                     and i not in equivocators]
        ctx.available = available
        for i in range(ctx.n_nodes):
            if i not in available:
                ctx.rejected.setdefault(
                    i, "unavailable" if i in alive else "offline")
            else:
                # a model a quorum accepted is in the round, full stop —
                # scattered per-receiver rejections were delivery noise
                ctx.rejected.pop(i, None)
        if len(available) < env.quorum:
            raise QuorumNotReached(
                f"round {ctx.round}: only {len(available)} models reached "
                f"a reveal quorum (need {env.quorum})")


class ModelEvaluation(ConsensusPhase):
    """Alg. 1 line 3 — ME at every node. All honest nodes compute identical
    (gw, sims); computed once here, per-node votes derived in the next phase.

    Networked mode: a model whose reveal never reached quorum gets zero
    weight in Eq. 1 — exactly what Eq. 1 already does for a dataless
    cluster — so gw(k) is computed over the available set only.
    """

    name = "model_evaluation"

    def run(self, ctx: RoundContext) -> None:
        sizes = list(ctx.data_sizes)
        if ctx.available is not None:
            avail = set(ctx.available)
            sizes = [s if i in avail else 0.0 for i, s in enumerate(sizes)]
            if sum(sizes) <= 0.0:
                raise QuorumNotReached(
                    f"round {ctx.round}: available models carry zero "
                    f"aggregate data weight")
        ctx.evaluation = model_evaluation_pytrees(
            list(ctx.models), sizes, g_max=ctx.g_max)


class VoteCollection(ConsensusPhase):
    """Alg. 1 line 4 — every node submits (vote, predictions) to the
    vote-tally contract. ``ctx.vote_hook`` lets experiments model malicious
    voters (bribery / random attacks, §7.4).

    With ``signers`` (node keypairs), every submission travels as a signed
    vote envelope — the contract batch-verifies them at tally time, so a
    bribed vote is attributable to its signer instead of resting on trust.
    """

    name = "vote_collection"

    def __init__(self, contract: VoteTallyContract,
                 signers: Optional[Dict[int, crypto.ECDSAKeyPair]] = None,
                 wals: Optional[Dict[int, Any]] = None):
        self.contract = contract
        self.signers = signers or {}
        # per-node protocol WALs (repro_torch.core.recovery): a vote is logged
        # before it is signed, so re-signing a conflicting vote for an
        # already-voted round raises WALConflict instead of equivocating
        self.wals = wals or {}

    def _submission(self, node_id: int, round: int, vote: int,
                    preds: np.ndarray) -> VoteSubmission:
        wal = self.wals.get(node_id)
        if wal is not None:
            wal.log_vote(round, vote)
        kp = self.signers.get(node_id)
        if kp is None:
            return VoteSubmission(node_id, round, vote, preds)
        return VoteSubmission.signed(node_id, round, vote, preds,
                                     kp.private_key)

    def run(self, ctx: RoundContext) -> None:
        if ctx.evaluation is None:
            raise RuntimeError("VoteCollection requires a prior ModelEvaluation")
        n = ctx.n_nodes
        sims = ctx.similarities
        if ctx.env is not None:
            self._run_networked(ctx, sims)
            return
        honest_vote = int(np.argmax(sims))
        honest_row = honest_predictions(n, honest_vote, ctx.g_max)
        votes = np.empty(n, np.int64)
        preds = np.empty((n, n), np.float32)
        for i in range(n):
            vote_i = honest_vote
            preds_i = honest_row.copy()
            if ctx.vote_hook is not None:
                vote_i, preds_i = ctx.vote_hook(i, vote_i, preds_i)
            votes[i] = vote_i
            preds[i] = preds_i
            self.contract.submit(
                self._submission(i, ctx.round, int(vote_i), preds_i))
        ctx.votes = votes
        ctx.predictions = preds

    def _run_networked(self, ctx: RoundContext, sims: np.ndarray) -> None:
        """Only live, non-withholding nodes vote; honest nodes restrict the
        argmax to available models; a vote lands on-chain only if its
        transaction reaches the chain quorum before the tally deadline.
        ``ctx.votes[i] == -1`` marks an abstention/lost vote."""
        env = ctx.env
        n = ctx.n_nodes
        avail = ctx.available if ctx.available is not None else list(range(n))
        masked = np.full(n, -np.inf, np.float64)
        masked[avail] = sims[avail]
        honest_vote = int(np.argmax(masked))
        honest_row = honest_predictions(n, honest_vote, ctx.g_max)
        votes = np.full(n, -1, np.int64)
        preds = np.zeros((n, n), np.float32)
        voters = [i for i in sorted(env.alive()) if not env.withholds_vote(i)]
        landed = env.tx_landed("vote", ctx.round, voters)
        for i in voters:
            vote_i = honest_vote
            preds_i = honest_row.copy()
            adversarial = env.adversary_vote(i, ctx.round, vote_i, preds_i)
            if adversarial is not None:
                vote_i, preds_i = adversarial
            elif ctx.vote_hook is not None:
                vote_i, preds_i = ctx.vote_hook(i, vote_i, preds_i)
            if i not in landed:
                env.note("vote_lost", round=ctx.round, node=i)
                continue
            sub = env.mutate_vote_submission(
                i, self._submission(i, ctx.round, int(vote_i), preds_i))
            try:
                self.contract.submit(sub)
            except ContractError as e:
                # a malformed/unbound adversarial envelope is rejected at
                # the contract door — an attributed protocol violation,
                # not a crash
                env.note("envelope_rejected", kind="vote", round=ctx.round,
                         node=i, reason=str(e))
                continue
            votes[i] = vote_i
            preds[i] = preds_i
        # mid-phase crash faults at the vote→tally boundary: the vote is
        # already on-chain (or lost in transit) — the crash only costs the
        # node the rest of the round; it rejoins via the recovery path
        crash_at = getattr(env, "crash_at", None)
        if crash_at is not None:
            for i in voters:
                spec = crash_at(i, "after_vote", ctx.round)
                if spec is not None:
                    env.execute_crash(spec, i)
        ctx.votes = votes
        ctx.predictions = preds


class Tally(ConsensusPhase):
    """Alg. 1 line 5 — BTSV tally inside the smart contract; elects e*(k)."""

    name = "tally"

    def __init__(self, contract: VoteTallyContract):
        self.contract = contract

    def run(self, ctx: RoundContext) -> None:
        if ctx.env is None:
            ctx.btsv = self.contract.tally(ctx.round)
        else:
            try:
                ctx.btsv = self.contract.tally(
                    ctx.round, min_submissions=ctx.env.quorum)
            except ContractError as e:
                # below quorum: drop the partial submissions so a later
                # retry of this round number starts clean
                self.contract.drop_round(ctx.round)
                raise QuorumNotReached(
                    f"round {ctx.round}: vote quorum not reached "
                    f"({e})") from e
            # forged vote envelopes the batch verification dropped, with
            # the attributed signer — surfaced in the scenario report
            for node, reason in sorted(
                    self.contract.rejected_votes.get(ctx.round, {}).items()):
                ctx.env.note("envelope_rejected", kind="vote",
                             round=ctx.round, node=node, reason=reason)
                ctx.rejected.setdefault(node, reason)
        ctx.leader = int(ctx.btsv.leader)


class BlockMint(ConsensusPhase):
    """Alg. 1 lines 6-7 — the leader mints and signs the block; every node
    verifies (signature + local BTSV re-tally) and appends to its ledger.

    Networked mode: if the elected leader times out (crashed/lazy), the
    next candidate down the advote ranking takes over (deterministic
    re-election, recorded in ``ctx.extra["reelections"]`` and the block's
    ``extra``); the block travels the bus, so nodes it never reaches fall
    behind and converge later via the ledger's catch-up sync.
    """

    name = "block_mint"

    def __init__(self, ledgers: Sequence[Ledger], nodes: Sequence[HCDSNode],
                 public_keys: Dict[int, crypto.Point],
                 contract: VoteTallyContract,
                 wals: Optional[Dict[int, Any]] = None):
        self.ledgers = list(ledgers)
        self.nodes = list(nodes)
        self.public_keys = public_keys
        self.contract = contract
        self.wals = wals or {}

    def run(self, ctx: RoundContext) -> None:
        if ctx.leader is None or ctx.btsv is None or ctx.votes is None:
            raise RuntimeError("BlockMint requires a prior Tally")
        if ctx.env is not None:
            self._run_networked(ctx)
            return
        n = ctx.n_nodes
        leader = ctx.leader
        block = self._mint(ctx, leader, votes={i: int(ctx.votes[i])
                                               for i in range(n)})

        def retally(b: Block) -> int:
            res = self.contract.result(b.round)
            return int(res.leader) if res is not None else -1

        # the identical block envelope reaches every node — verify it as
        # one batch call up front instead of once per ledger append
        if not verify_envelopes([block.envelope()], self.public_keys).ok:
            raise InvalidBlock(
                f"round {ctx.round}: minted block's leader signature "
                f"failed envelope verification")
        for ledger in self.ledgers:
            ledger.append(block, leader_pk=None, retally=retally)
        ctx.block = block

    def _mint(self, ctx: RoundContext, leader: int,
              votes: Dict[int, int]) -> Block:
        n = ctx.n_nodes
        # reuse the bytes CommitReveal already serialized (one
        # serialization per model per round); fall back if the pipeline
        # was rearranged without a CommitReveal stage
        model_bytes = ctx.extra.get("model_bytes")
        if model_bytes is None or len(model_bytes) != len(ctx.models):
            model_bytes = [serialize_pytree(m) for m in ctx.models]
        avail = ctx.available if ctx.available is not None else list(range(n))
        model_digests = {i: crypto.sha256_digest(model_bytes[i]).hex()
                         for i in avail}
        gw_digest = crypto.sha256_digest(
            np.asarray(ctx.global_model, np.float32).tobytes()).hex()
        extra: Dict[str, Any] = {
            "rejected": {str(i): r for i, r in ctx.rejected.items()}}
        if ctx.available is not None:
            extra["available"] = list(avail)
        if ctx.extra.get("reelections"):
            extra["reelections"] = int(ctx.extra["reelections"])
        block = Block(
            index=self.ledgers[leader].height,
            round=ctx.round,
            leader_id=leader,
            prev_hash=self.ledgers[leader].head_hash,
            model_digests=model_digests,
            global_model_digest=gw_digest,
            votes=votes,
            vote_weights={i: float(ctx.btsv.weights[i]) for i in range(n)},
            advotes={j: float(ctx.btsv.advotes[j]) for j in range(n)},
            extra=extra,
        ).signed(self.nodes[leader].keypair)
        wal = self.wals.get(leader)
        if wal is not None:
            # block-signed record: a restarted leader cannot sign a second,
            # conflicting block for a round it already minted
            wal.log_block(ctx.round, block_hash(block))
        return block

    def _run_networked(self, ctx: RoundContext) -> None:
        env = ctx.env
        advotes = _host(ctx.btsv.advotes).astype(np.float64)
        # stable argsort on the negated tallies: ties break to lower id, so
        # every node derives the same re-election order from the contract
        ranking = [int(i) for i in np.argsort(-advotes, kind="stable")]
        crash_at = getattr(env, "crash_at", None)
        reelections = 0
        leader = None
        block = None
        votes = {i: int(v) for i, v in enumerate(ctx.votes) if v >= 0}
        for cand in ranking:
            if env.leader_fails(cand, ctx.round, reelections):
                env.note("leader_timeout", round=ctx.round, candidate=cand,
                         attempt=reelections)
                reelections += 1
                continue
            led = self.ledgers[cand]
            # a leader that itself missed rounds first catches up with the
            # best chain it can reach, so it never mints on a stale head
            for peer in env.reachable_peers(cand):
                if self.ledgers[peer].height > led.height:
                    led.fork_choice(self.ledgers[peer].blocks,
                                    self.public_keys)
            ctx.extra["reelections"] = reelections
            cand_block = self._mint(ctx, cand, votes=votes)
            spec = (crash_at(cand, "after_mint", ctx.round)
                    if crash_at is not None else None)
            if spec is not None:
                # the elected leader minted and signed (the statement is in
                # its WAL) but died before appending or broadcasting: to
                # every peer this is an ordinary leader timeout, so the
                # signed-but-unseen block vanishes and the next candidate
                # takes over — no conflicting block ever reaches a ledger
                env.note("leader_timeout", round=ctx.round, candidate=cand,
                         attempt=reelections)
                env.execute_crash(spec, cand)
                reelections += 1
                continue
            leader, block = cand, cand_block
            break
        if leader is None or block is None:
            raise QuorumNotReached(
                f"round {ctx.round}: every leader candidate timed out")
        ctx.leader = leader
        ctx.extra["reelections"] = reelections
        led = self.ledgers[leader]

        def plausible(b: Block) -> int:
            """Env-mode analogue of the BTSV re-tally check: the block's
            leader must sit within the first ``reelections + 1`` entries of
            the advote ranking every node derives from the shared contract
            result (candidates before it are the ones that timed out)."""
            attempts = int(b.extra.get("reelections", 0))
            allowed = ranking[:attempts + 1]
            return b.leader_id if b.leader_id in allowed else -1

        # one envelope batch check covers the block for every receiver it
        # reaches this round (the bus delivers the identical object)
        if not verify_envelopes([block.envelope()], self.public_keys).ok:
            raise InvalidBlock(
                f"round {ctx.round}: minted block's leader signature "
                f"failed envelope verification")
        led.append(block, leader_pk=None, retally=plausible)
        deliveries = env.exchange("block", ctx.round, {leader: block})
        behind: List[int] = []
        for recv in sorted(env.alive()):
            if recv == leader:
                continue
            got = deliveries.get(recv, {}).get(leader)
            if got is None:
                env.note("missed_block", round=ctx.round, node=recv)
                behind.append(recv)
                continue
            rled = self.ledgers[recv]
            if rled.head_hash != block.prev_hash:
                # the receiver missed earlier blocks: catch-up sync from
                # the leader's chain (reachable — its block just arrived),
                # falling back to fork choice on diverged history
                try:
                    rled.sync_from(led.blocks[:-1], self.public_keys)
                except InvalidBlock:
                    rled.fork_choice(led.blocks, self.public_keys)
            if rled.head_hash == block.prev_hash:
                # signature already checked by the phase-level batch above
                rled.append(block, leader_pk=None, retally=plausible)
            elif rled.head_hash != led.head_hash:
                env.note("append_failed", round=ctx.round, node=recv)
                behind.append(recv)
        ctx.extra["behind"] = behind
        ctx.block = block


def run_phases(phases: Sequence[ConsensusPhase], ctx: RoundContext,
               before: Optional[Dict[str, List[PhaseHook]]] = None,
               after: Optional[Dict[str, List[PhaseHook]]] = None,
               ) -> RoundContext:
    """Drive ``ctx`` through ``phases``, firing registered hooks around
    each phase (keyed by phase name; ``"*"`` matches every phase)."""
    before = before or {}
    after = after or {}
    for phase in phases:
        for fn in before.get(phase.name, []) + before.get("*", []):
            fn(phase.name, ctx)
        phase.run(ctx)
        for fn in after.get(phase.name, []) + after.get("*", []):
            fn(phase.name, ctx)
    return ctx
