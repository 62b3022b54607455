"""HCDS — Hash-based Commitment and Digital Signature (paper §4.1, Alg. 2).

Two-phase protocol run by every BCFL node e_i at round k:

Commit stage
    1. draw fixed-length nonce r^i(k)
    2. d^i(k)   = H(r^i(k) || w^i(k))
    3. tag^i(k) = DSign over the commit *envelope* of d^i(k)
       (``repro_torch.core.envelope`` — the kind/round/sender header is bound
       into the signature, so commit tags cannot be replayed cross-phase)
    4. broadcast the commit; verify every received commit's envelope

Reveal stage
    5. broadcast (r^i(k), w^i(k), tag^i(k)) — the same tag, per the paper
    6. for every received reveal: recompute H(r^l || w^l), compare to the
       committed d^l, then re-verify the tag against the commit envelope
       rebuilt from the recomputed hash

A model revealed without a matching prior commitment — or whose commitment
digest matches another node's (byte-identical plagiarism) — is rejected.

Verification is *batched per phase*: :func:`run_hcds_round` (and the
networked ``CommitReveal`` phase in ``repro_torch.core.phases``) collects every
commit envelope of the round and calls
:func:`repro_torch.core.envelope.verify_envelopes` once — under the ``batch``
crypto backend that is one randomized-linear-combination equation instead
of N×(N−1) double-scalar multiplications. Receivers then record
already-verified messages through the bookkeeping-only paths
(``receive_commit(..., verified=True)``); a reveal whose tag and digest
both match its verified commitment needs no further crypto at all (the
signature over the identical statement was already checked), so the reveal
stage degenerates to pure hashing for honest traffic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.core import crypto
from repro_torch.core.envelope import (SignedEnvelope, commit_signing_digest,
                                       digests_equal, tags_equal,
                                       verify_envelopes)
from repro_torch.core.serialization import serialize_pytree
from repro_torch.obs import get_recorder


@dataclass(frozen=True)
class Commitment:
    """The commit-stage broadcast of node ``node_id``: (d^i(k), tag^i(k))."""

    node_id: int
    round: int
    digest: bytes
    tag: crypto.Signature

    @property
    def envelope(self) -> SignedEnvelope:
        """The commit as a signed envelope (what the tag actually signs)."""
        return SignedEnvelope("commit", self.round, self.node_id,
                              self.digest, self.tag)


@dataclass(frozen=True)
class Reveal:
    """The reveal-stage broadcast: (r^i(k), w^i(k) serialized, tag^i(k))."""

    node_id: int
    round: int
    nonce: bytes
    model_bytes: bytes
    tag: crypto.Signature


@dataclass
class HCDSResult:
    accepted: bool
    reason: str = "ok"
    # set when accepting this reveal retroactively rejected another node's
    # already-recorded reveal (plagiarism tie-break: the commitment stage
    # fixes precedence, so a copy that merely *arrived* first is evicted
    # once the earlier committer's reveal shows up)
    evicted: Optional[int] = None


class HCDSNode:
    """Per-node HCDS state machine.

    The surrounding runtime (``fl.hfl_runtime`` or a benchmark) moves
    messages between nodes; this class only implements the cryptographic
    checks of Alg. 2, so adversarial delivery orders can be simulated by
    the caller.
    """

    def __init__(self, node_id: int, keypair: Optional[crypto.ECDSAKeyPair] = None,
                 nonce_len: int = 32, wal: Optional[Any] = None):
        self.node_id = node_id
        self.keypair = keypair or crypto.ECDSAKeyPair.generate(
            seed=node_id.to_bytes(8, "big"))
        self.nonce_len = nonce_len
        # optional durable protocol WAL (repro_torch.core.recovery.NodeWAL).
        # With one attached, commit()/reveal() write through before
        # signing: a restart replays the log instead of re-drawing a
        # nonce, and a *conflicting* re-commit for an already-logged
        # round raises WALConflict instead of equivocating.
        self.wal = wal
        # received commitments / accepted reveals per round
        self._commits: Dict[int, Dict[int, Commitment]] = {}
        self._reveals: Dict[int, Dict[int, Reveal]] = {}
        self._own: Dict[int, tuple[bytes, bytes]] = {}  # round -> (nonce, model_bytes)
        # round -> node_id -> commitment record index. Precedence between
        # identical reveals is decided by this order (§4.1: the commitment
        # stage, not reveal arrival, fixes who owns a model). Drivers call
        # :meth:`finalize_commit_stage` at the commit/reveal barrier to
        # canonicalize it, so every receiver holds the same order.
        self._commit_order: Dict[int, Dict[int, int]] = {}

    # -- commit stage -----------------------------------------------------
    def commit(self, model: Any, round: int,
               model_bytes: Optional[bytes] = None) -> Commitment:
        """Alg. 2 lines 1-4: build this node's commitment for ``round``.

        ``model_bytes`` lets the caller hand in the already-serialized
        model so one round serializes each model exactly once (the driver
        reuses the same bytes for the block's model digests).
        """
        if model_bytes is None:
            model_bytes = serialize_pytree(model)
        if self.wal is not None:
            # already committed for this round (pre-crash)? Re-issue the
            # logged statement byte-for-byte instead of double-signing; a
            # *different* model for the same round raises WALConflict
            rec = self.wal.commit_record(round, model_bytes)
            if rec is not None:
                return self.restore_own_commit(
                    round, nonce=bytes.fromhex(rec.data["nonce"]),
                    model_bytes=model_bytes,
                    digest=bytes.fromhex(rec.data["commitment"]),
                    tag=crypto.Signature.coerce(rec.data["tag"]))
        nonce = crypto.random_nonce(self.nonce_len)
        digest = crypto.sha256_digest(nonce, model_bytes)
        env = SignedEnvelope.seal("commit", round, self.node_id, digest,
                                  self.keypair.private_key)
        if self.wal is not None:
            self.wal.log_commit(round, model_bytes, nonce, digest,
                                env.signature)
        self._own[round] = (nonce, model_bytes)
        c = Commitment(self.node_id, round, digest, env.signature)
        # record own commit (self-signed just now — no re-verification)
        self.receive_commit(c, self.keypair.public_key, verified=True)
        return c

    def restore_own_commit(self, round: int, nonce: bytes,
                           model_bytes: bytes, digest: bytes,
                           tag: crypto.Signature) -> Commitment:
        """Recovery path (``repro_torch.core.recovery.replay_wal``): reinstate
        this node's own already-signed commitment after a restart, without
        fresh signing. Idempotent."""
        self._own[round] = (nonce, model_bytes)
        c = Commitment(self.node_id, round, digest, tag)
        self.receive_commit(c, self.keypair.public_key, verified=True)
        return c

    def receive_commit(self, c: Commitment, sender_pk: crypto.Point,
                       verified: bool = False) -> HCDSResult:
        """Alg. 2 lines 5-10: verify the commit envelope with the sender's
        PK. ``verified=True`` skips the signature check (the caller already
        batch-verified this envelope) but keeps the replay bookkeeping."""
        if not verified and not c.envelope.verify(sender_pk):
            return HCDSResult(False, "bad-signature")
        per_round = self._commits.setdefault(c.round, {})
        prior = per_round.get(c.node_id)
        if prior is not None and not digests_equal(prior.digest, c.digest):
            # the same sender already committed a DIFFERENT digest this
            # round: equivocation (e.g. an amnesiac restart re-drawing its
            # nonce). Keep the first statement — precedence and any reveal
            # checks were built on it — and attribute the violation.
            return HCDSResult(False, "commit-equivocation")
        # byte-identical digest from a different node ⇒ replayed commitment
        # (constant-time compare: a timing probe must not learn how much
        # of a guessed commitment digest matched — RA201)
        for other_id, other in per_round.items():
            if other_id != c.node_id and digests_equal(other.digest,
                                                       c.digest):
                return HCDSResult(False, "duplicate-digest")
        order = self._commit_order.setdefault(c.round, {})
        if c.node_id not in order:
            order[c.node_id] = len(order)
        per_round[c.node_id] = c
        return HCDSResult(True)

    def finalize_commit_stage(self, round: int,
                              precedence: Optional[List[int]] = None) -> None:
        """Fix commitment precedence at the commit/reveal barrier.

        Alg. 2 makes the commit stage a barrier: reveals are only
        processed once the phase's commits are all in hand, so the record
        order can be canonicalized — every receiver (including each node
        looking at its *own* early self-recorded commit) must resolve
        identical-reveal ties identically.

        ``precedence`` is the commit transactions' chain-inclusion order
        when the driver has one (networked mode: the bus's network-wide
        first-delivery order — a copier that could only construct its
        commitment after observing the victim's bytes broadcasts late and
        lands behind the owner). Without one (the ideal synchronous
        world, where every commit is simultaneous) ascending committer id
        is the convention. Committers absent from ``precedence`` rank
        last, in id order.
        """
        held = self._commits.get(round, {})
        ranked = [nid for nid in (precedence or []) if nid in held]
        ranked += [nid for nid in sorted(held) if nid not in ranked]
        self._commit_order[round] = {nid: i for i, nid in enumerate(ranked)}

    # -- reveal stage ------------------------------------------------------
    def reveal(self, round: int) -> Reveal:
        """Alg. 2 line 11: broadcast (r, w, tag)."""
        nonce, model_bytes = self._own[round]
        c = self._commits[round][self.node_id]
        if self.wal is not None:
            # reveal-sent record: conflicts are impossible while commits
            # are WAL-guarded, but the record marks the round's reveal as
            # issued so a restarted node re-broadcasts, never re-derives
            self.wal.log_reveal(round, c.digest)
        r = Reveal(self.node_id, round, nonce, model_bytes, c.tag)
        self.receive_reveal(r, self.keypair.public_key)
        return r

    def receive_reveal(self, r: Reveal, sender_pk: crypto.Point,
                       digest: Optional[bytes] = None) -> HCDSResult:
        """Alg. 2 lines 12-19: binding + signature check of a reveal.

        ``digest`` lets a batch driver hand in the precomputed H(r‖w) so
        one round hashes each reveal once instead of once per receiver.
        A reveal whose tag equals its (already verified) commitment's tag
        and whose digest binds needs no fresh crypto — the commit envelope
        signature covered the identical statement.
        """
        per_round = self._commits.get(r.round, {})
        c = per_round.get(r.node_id)
        if c is None:
            return HCDSResult(False, "no-commitment")
        if digest is None:
            digest = crypto.sha256_digest(r.nonce, r.model_bytes)
        if not digests_equal(digest, c.digest):
            return HCDSResult(False, "digest-mismatch")
        if not tags_equal(r.tag, c.tag) and not crypto.dverify(
                r.tag, sender_pk,
                commit_signing_digest(r.round, r.node_id, digest)):
            return HCDSResult(False, "bad-signature")
        # plagiarism check: identical model bytes revealed by another node.
        # Precedence belongs to the commitment stage (§4.1): the earlier
        # *committer* of the pair owns the bytes, no matter whose reveal
        # happened to arrive first — jittered delivery must not make
        # receivers disagree about who the plagiarist is, or brand the
        # honest victim.
        order = self._commit_order.get(r.round, {})
        reveals = self._reveals.setdefault(r.round, {})
        evicted: Optional[int] = None
        for other_id, other in list(reveals.items()):
            if other_id == r.node_id or other.model_bytes != r.model_bytes:
                continue
            if order.get(other_id, -1) <= order.get(r.node_id, 1 << 30):
                # the other node committed first: the incoming reveal is
                # the copy
                return HCDSResult(False, "plagiarized-model")
            # the incoming reveal belongs to the earlier committer — the
            # already-recorded copy is retroactively the plagiarized one
            del reveals[other_id]
            evicted = other_id
        reveals[r.node_id] = r
        return HCDSResult(True, evicted=evicted)

    def accepted_models(self, round: int) -> Dict[int, bytes]:
        """Model bytes of every node whose reveal passed all checks."""
        return {nid: rv.model_bytes for nid, rv in self._reveals.get(round, {}).items()}


def run_hcds_round(nodes: list[HCDSNode], models: list[Any], round: int,
                   public_keys: Optional[dict[int, crypto.Point]] = None,
                   model_bytes: Optional[list[bytes]] = None,
                   ) -> dict[int, dict[int, HCDSResult]]:
    """Drive one full commit+reveal exchange among honest ``nodes``.

    Returns {receiver_id: {sender_id: result}} for the reveal stage.

    Each model is serialized exactly once per round (the per-sender bytes
    are computed up front, or taken from ``model_bytes``), and signature
    verification happens once per phase: all commit envelopes go through a
    single ``verify_envelopes`` batch instead of a dverify per
    (sender, receiver) pair, and each reveal is hashed once with the digest
    shared across receivers.
    """
    pks = public_keys or {n.node_id: n.keypair.public_key for n in nodes}
    if model_bytes is None:
        model_bytes = [serialize_pytree(m) for m in models]
    rec = get_recorder()
    with rec.span("hcds:commit_stage", cat="hcds", round=round,
                  n_nodes=len(nodes)):
        commits = [n.commit(m, round, model_bytes=b)
                   for n, m, b in zip(nodes, models, model_bytes)]
        batch = verify_envelopes([c.envelope for c in commits], pks)
        if not batch.ok:
            forged = batch.bad_senders([c.envelope for c in commits])
            raise RuntimeError(f"honest commit rejected: forged envelope from "
                               f"node(s) {forged}")
        for c in commits:
            for n in nodes:
                if n.node_id != c.node_id:
                    res = n.receive_commit(c, pks[c.node_id], verified=True)
                    if not res.accepted:
                        raise RuntimeError(
                            f"honest commit rejected: {c.node_id}->{n.node_id}: {res.reason}")
        for n in nodes:                 # the commit/reveal barrier (Alg. 2)
            n.finalize_commit_stage(round)
    with rec.span("hcds:reveal_stage", cat="hcds", round=round,
                  n_nodes=len(nodes)):
        reveals = [n.reveal(round) for n in nodes]
        digests = {r.node_id: crypto.sha256_digest(r.nonce, r.model_bytes)
                   for r in reveals}
        out: dict[int, dict[int, HCDSResult]] = {n.node_id: {} for n in nodes}
        for r in reveals:
            for n in nodes:
                if n.node_id != r.node_id:
                    out[n.node_id][r.node_id] = n.receive_reveal(
                        r, pks[r.node_id], digest=digests[r.node_id])
    return out
