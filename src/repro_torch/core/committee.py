"""Committee-scoped consensus: node subsets + cross-shard checkpoints.

The seed reproduction ran ONE permissioned chain: every edge server
broadcast to every other, so envelope fan-out grew N×(N−1) and realistic
scale capped near N≈32. Kang et al.'s multi-blockchain consortium
(PAPERS.md, arxiv 2008.04743) partitions the edge servers into
*committees*, each running an independent consensus instance over its own
subchain, stitched together by periodic cross-shard checkpoints. This
module supplies the committee-side primitives of that refactor:

* :class:`Committee` — an explicit node subset with its own quorum math
  (⌈2m/3⌉ over the *member* count) and the local↔global id mapping every
  shard-scoped structure (ledgers, WALs, vote contracts) is keyed by;
* :func:`make_committees` — balanced contiguous partition of N nodes into
  K committees (or explicit per-committee sizes);
* :func:`committee_seed` — per-committee RNG substream derived from the
  scenario seed by hashing ``(seed, committee_id)``, so resizing one
  committee never perturbs another committee's traffic;
* :func:`committee_keypair` — per-committee node keys derived from the
  *global* node id, so two committees never share a signing key and the
  consortium key directory is keyed by global id;
* :class:`CheckpointStatement` + :func:`sign_checkpoint` /
  :func:`verify_checkpoint_certificate` — the cross-shard hand-off: a
  committee summarizes its epoch (subchain head/height + minted global
  model digest) and ≥2/3 of its members countersign the statement as
  ``"checkpoint"`` envelopes, batch-verified via the existing
  ``verify_batch``/msm path. Members WAL-log the statement before signing
  (``NodeWAL.log_checkpoint``), so a crashed member that rejoins
  mid-epoch can never countersign a conflicting checkpoint;
* :func:`checkpoint_block` / :func:`make_checkpoint_validator` — package
  a certified statement as an ordinary :class:`~repro_torch.blockchain.block.
  Block` on the consortium *top-chain*, validated through the ledger's
  existing ``retally`` seam: ``Ledger.append`` / ``sync_from`` reject a
  checkpoint block whose certificate is invalid or sub-quorum exactly
  the way they reject a block whose leader fails the BTSV re-tally.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.blockchain.block import Block
from repro_torch.blockchain.ledger import Ledger
from repro_torch.core import crypto
from repro_torch.core.envelope import SignedEnvelope, verify_envelopes

_SEED_DOMAIN = b"pofel-committee-substream-v1"
_KEY_DOMAIN = b"pofel-committee-key-v1"
_STMT_DOMAIN = b"pofel-checkpoint-v1"


@dataclass(frozen=True)
class Committee:
    """An explicit, ordered subset of consortium nodes.

    ``members`` holds *global* node ids; the consensus instance scoped to
    this committee addresses its nodes by *local* index 0..size-1 (so the
    existing ledgers/WALs/contract keyed 0..n-1 work unchanged), and
    :meth:`global_id` / :meth:`local_index` translate at the boundary.
    """

    committee_id: int
    members: Tuple[int, ...]

    def __post_init__(self):
        if self.committee_id < 0:
            raise ValueError(f"committee_id must be >= 0, got "
                             f"{self.committee_id}")
        if not self.members:
            raise ValueError(f"committee {self.committee_id} has no members")
        if list(self.members) != sorted(set(self.members)):
            raise ValueError(
                f"committee {self.committee_id} members must be strictly "
                f"increasing global ids, got {self.members}")

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def quorum(self) -> int:
        """BFT quorum over the committee's own member count: ⌈2m/3⌉."""
        return math.ceil(2 * self.size / 3)

    def __contains__(self, global_id: int) -> bool:
        return global_id in self.members

    def global_id(self, local_index: int) -> int:
        return self.members[local_index]

    def local_index(self, global_id: int) -> int:
        try:
            return self.members.index(global_id)
        except ValueError:
            raise KeyError(f"node {global_id} is not a member of committee "
                           f"{self.committee_id}") from None


def make_committees(n_nodes: int, committees: int,
                    sizes: Optional[Sequence[int]] = None,
                    ) -> Tuple[Committee, ...]:
    """Partition global ids 0..n_nodes-1 into committees.

    Default: ``committees`` contiguous balanced groups (sizes differ by at
    most one, earlier committees take the remainder). Explicit ``sizes``
    override the balance — they must sum to ``n_nodes`` — which is how the
    substream-isolation test resizes one committee while keeping another
    byte-identical.
    """
    if n_nodes <= 0:
        raise ValueError(f"n_nodes must be positive, got {n_nodes}")
    if sizes is not None:
        sizes = [int(s) for s in sizes]
        if any(s <= 0 for s in sizes):
            raise ValueError(f"committee sizes must be positive, got {sizes}")
        if sum(sizes) != n_nodes:
            raise ValueError(f"committee sizes {sizes} sum to {sum(sizes)}, "
                             f"expected n_nodes={n_nodes}")
    else:
        k = int(committees)
        if not 1 <= k <= n_nodes:
            raise ValueError(f"committees must be in [1, {n_nodes}], got {k}")
        base, rem = divmod(n_nodes, k)
        sizes = [base + (1 if c < rem else 0) for c in range(k)]
    out, start = [], 0
    for cid, m in enumerate(sizes):
        out.append(Committee(cid, tuple(range(start, start + m))))
        start += m
    return tuple(out)


def committee_seed(seed: int, committee_id: int) -> int:
    """Per-committee RNG substream: hash(seed, committee_id), truncated to
    63 bits. Independent committees draw from independent streams, so
    adding or resizing committee B never shifts committee A's draws —
    pinned by the substream-isolation determinism test."""
    digest = crypto.sha256_digest(
        _SEED_DOMAIN, int(seed).to_bytes(16, "big", signed=True),
        int(committee_id).to_bytes(8, "big", signed=True))
    return int.from_bytes(digest[:8], "big") >> 1


def committee_keypair(committee_id: int, global_id: int,
                      ) -> crypto.ECDSAKeyPair:
    """Deterministic signing key for a committee member, derived from the
    *global* node id (plus a committee tag and domain), so keys are unique
    consortium-wide and the cross-shard key directory is global-id-keyed."""
    return crypto.ECDSAKeyPair.generate(
        seed=_KEY_DOMAIN + int(committee_id).to_bytes(8, "big", signed=True)
        + int(global_id).to_bytes(8, "big", signed=True))


# ---------------------------------------------------------------------------
# Checkpoint statements + quorum certificates
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CheckpointStatement:
    """What a committee asserts at an epoch boundary: "our subchain stands
    at (height, head) and our minted global model digests to D". Members
    countersign the canonical digest of this statement."""

    committee_id: int
    epoch: int
    sub_height: int
    sub_head: str                 # subchain head hash (hex)
    global_model_digest: str      # hex digest of the committee's gw

    def payload_digest(self) -> bytes:
        body = json.dumps(
            {"committee": self.committee_id, "epoch": self.epoch,
             "sub_height": self.sub_height, "sub_head": self.sub_head,
             "model": self.global_model_digest}, sort_keys=True).encode()
        return crypto.sha256_digest(_STMT_DOMAIN, body)

    def to_dict(self) -> Dict[str, Any]:
        return {"committee_id": self.committee_id, "epoch": self.epoch,
                "sub_height": self.sub_height, "sub_head": self.sub_head,
                "global_model_digest": self.global_model_digest}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CheckpointStatement":
        return cls(int(d["committee_id"]), int(d["epoch"]),
                   int(d["sub_height"]), str(d["sub_head"]),
                   str(d["global_model_digest"]))


def sign_checkpoint(stmt: CheckpointStatement, global_id: int,
                    keypair: crypto.ECDSAKeyPair,
                    wal: Optional[Any] = None) -> SignedEnvelope:
    """One member's countersignature over ``stmt`` as a ``"checkpoint"``
    envelope (sender = the member's *global* id, round = the epoch).

    With a ``wal`` (the member's :class:`~repro_torch.core.recovery.NodeWAL`),
    the statement is logged *before* signing — a member that crashed and
    rejoined mid-epoch replays the log and a conflicting statement for the
    same epoch raises ``WALConflict`` instead of double-signing."""
    if wal is not None:
        wal.log_checkpoint(stmt.epoch, stmt.payload_digest().hex())
    return SignedEnvelope.seal("checkpoint", stmt.epoch, global_id,
                               stmt.payload_digest(), keypair.private_key)


def certificate_to_wire(cert: Mapping[int, crypto.Signature],
                        ) -> Dict[str, str]:
    """JSON-safe form of a certificate: global id -> canonical tag hex."""
    return {str(gid): crypto.Signature.coerce(sig).to_bytes().hex()
            for gid, sig in sorted(cert.items())}


def verify_checkpoint_certificate(
        stmt: CheckpointStatement, cert: Mapping[Any, Any],
        committee: Committee,
        public_keys: Mapping[int, crypto.Point]) -> bool:
    """≥2/3 quorum certificate check: the number of *distinct committee
    members* whose checkpoint envelope over ``stmt`` verifies must reach
    the committee's quorum. Signatures are checked as one
    ``verify_envelopes`` batch (the verify_batch/msm path). Non-member or
    malformed entries are simply not counted — they can only dilute, never
    forge, a certificate."""
    envelopes, signers = [], []
    for raw_gid in sorted(cert, key=str):
        try:
            gid = int(raw_gid)
            sig = crypto.Signature.coerce(cert[raw_gid])
        except (TypeError, ValueError, OverflowError):
            continue
        if gid not in committee or gid in signers:
            continue
        if gid not in public_keys:
            continue
        envelopes.append(SignedEnvelope("checkpoint", stmt.epoch, gid,
                                        stmt.payload_digest(), sig))
        signers.append(gid)
    if not envelopes:
        return False
    res = verify_envelopes(envelopes, dict(public_keys))
    good = len(envelopes) - len(res.bad)
    return good >= committee.quorum


def checkpoint_block(stmt: CheckpointStatement,
                     cert: Mapping[int, crypto.Signature],
                     top_ledger: Ledger, leader_global_id: int,
                     leader_keypair: crypto.ECDSAKeyPair) -> Block:
    """Package a certified checkpoint statement as an ordinary top-chain
    block: the statement + wire certificate ride ``extra["checkpoint"]``,
    the emitting committee's leader signs the block envelope, and the
    consensus artifacts (votes/weights/advotes) are empty — the quorum
    certificate is this block's proof, checked by the validator from
    :func:`make_checkpoint_validator` through the ledger's retally seam."""
    return Block(
        index=top_ledger.height,
        round=stmt.epoch,
        leader_id=leader_global_id,
        prev_hash=top_ledger.head_hash,
        model_digests={},
        global_model_digest=stmt.global_model_digest,
        votes={},
        vote_weights={},
        advotes={},
        extra={"checkpoint": {"statement": stmt.to_dict(),
                              "cert": certificate_to_wire(cert)}},
    ).signed(leader_keypair)


def checkpoint_statement_of(block: Block) -> Optional[CheckpointStatement]:
    """The statement a checkpoint block carries, or None for a block
    without (or with a malformed) ``extra["checkpoint"]``."""
    cp = block.extra.get("checkpoint") if isinstance(block.extra, dict) \
        else None
    if not isinstance(cp, dict):
        return None
    try:
        return CheckpointStatement.from_dict(cp["statement"])
    except (KeyError, TypeError, ValueError):
        return None


def make_checkpoint_validator(
        committees: Mapping[int, Committee],
        public_keys: Mapping[int, crypto.Point],
        ) -> Callable[[Block], int]:
    """A ``retally``-style validator for top-chain appends: returns
    ``block.leader_id`` iff the block carries a well-formed checkpoint
    whose emitter is a member of the claimed committee and whose
    certificate reaches that committee's ≥2/3 quorum — anything else
    returns -1, so ``Ledger.append``/``sync_from`` raise ``InvalidBlock``
    exactly as they do for a leader that fails the BTSV re-tally."""
    def validate(block: Block) -> int:
        stmt = checkpoint_statement_of(block)
        if stmt is None or stmt.epoch != block.round:
            return -1
        if stmt.global_model_digest != block.global_model_digest:
            return -1
        com = committees.get(stmt.committee_id)
        if com is None or block.leader_id not in com:
            return -1
        cert = block.extra["checkpoint"].get("cert")
        if not isinstance(cert, Mapping):
            return -1
        if not verify_checkpoint_certificate(stmt, cert, com, public_keys):
            return -1
        return block.leader_id
    return validate
