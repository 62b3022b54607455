"""Crash recovery: durable per-node protocol state + rejoin primitives.

The HCDS scheme (§4.1) implicitly assumes a node never signs two
*conflicting* statements for the same round — a different commitment, a
different vote, a different block. Nothing volatile can guarantee that
across a crash: a node that reboots mid-round with empty memory will
happily draw a fresh nonce and re-commit, which to every peer is
indistinguishable from deliberate equivocation. This module supplies the
durable layer the assumption needs:

* :class:`NodeWAL` — an append-only write-ahead log of the protocol
  statements a node has signed (``commit`` / ``reveal`` / ``vote`` /
  ``block`` records keyed by round). Appending a record that conflicts
  with an already-logged one for the same (kind, round) raises
  :class:`WALConflict` — re-signing a conflicting statement is
  structurally impossible, not merely discouraged. Logs can be
  memory-only (the simulator default) or backed by a JSONL file that
  survives process restarts.
* :func:`wipe_volatile` / :func:`replay_wal` — the crash and the
  restart: clear an ``HCDSNode``'s in-memory round state, then rebuild
  this node's *own* commitments from its WAL so its re-broadcasts are
  byte-identical to what it signed before the crash (idempotent:
  replaying twice equals replaying once).
* :func:`snapshot_ledger` / :func:`restore_ledger` (+ the directory
  forms :func:`save_snapshot` / :func:`load_snapshot`) — integrity-
  digested chain snapshots in the style of ``repro.checkpoint``: the
  manifest carries ``sha256(serialized payload)`` and restore refuses a
  tampered file. With a model tree the node's last global model goes
  beside it as a ``repro_torch.checkpoint`` checkpoint at step = chain
  height, as the reference co-locates it.
* :func:`rejoin_ledger` — the catch-up half of a rejoin: adopt the best
  reachable peer chain via ``Ledger.sync_from`` (fork-choice fallback on
  diverged history).

``repro_torch.sim.network.SimEnv`` drives these from its ``CrashRestart``
handling; ``PoFELConsensus`` attaches one WAL per node so the enforcement
is on by default in every networked run.
"""

from __future__ import annotations

import hmac
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.blockchain.ledger import (InvalidBlock, Ledger,
                                           _block_from_dict, _block_to_dict)
from repro_torch.core import crypto
from repro_torch.obs import get_recorder


class WALConflict(RuntimeError):
    """An append would contradict an already-logged record for the same
    (kind, round) — signing it would be equivocation, so the WAL refuses."""


def _texts_equal(a: str, b: str) -> bool:
    # constant-time compare, same discipline as envelope.digests_equal
    return hmac.compare_digest(a.encode(), b.encode())


@dataclass(frozen=True)
class WALRecord:
    """One durable protocol statement: ``digest`` is the conflict key for
    (kind, round); ``data`` carries whatever replay needs (hex-encoded)."""

    kind: str
    round: int
    digest: str
    data: Mapping[str, str] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"kind": self.kind, "round": self.round,
                           "digest": self.digest, "data": dict(self.data)},
                          sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "WALRecord":
        d = json.loads(line)
        return cls(d["kind"], int(d["round"]), d["digest"],
                   dict(d.get("data", {})))


class NodeWAL:
    """Append-only per-node protocol WAL.

    ``path=None`` keeps the log in memory (one simulated process = one
    Python object, so a simulated crash that keeps the object models a
    machine whose disk survived). With a ``path``, every append is also
    written through to a JSONL file and an existing file is loaded at
    construction — a genuinely durable log for restart-across-process
    tests and tooling.
    """

    def __init__(self, node_id: int, path: Optional[str | Path] = None):
        self.node_id = node_id
        self.path = Path(path) if path is not None else None
        self._records: List[WALRecord] = []
        self._index: Dict[Tuple[str, int], WALRecord] = {}
        if self.path is not None and self.path.exists():
            for line in self.path.read_text().splitlines():
                if line.strip():
                    self._admit(WALRecord.from_json(line), write=False)

    def __len__(self) -> int:
        return len(self._records)

    def records(self) -> List[WALRecord]:
        return list(self._records)

    def lookup(self, kind: str, round: int) -> Optional[WALRecord]:
        return self._index.get((kind, round))

    def _admit(self, rec: WALRecord, write: bool) -> WALRecord:
        existing = self._index.get((rec.kind, rec.round))
        if existing is not None:
            if not _texts_equal(existing.digest, rec.digest):
                raise WALConflict(
                    f"node {self.node_id}: {rec.kind} for round {rec.round} "
                    f"already logged with a different digest — refusing to "
                    f"sign a conflicting statement")
            return existing          # identical re-append: idempotent
        self._records.append(rec)
        self._index[(rec.kind, rec.round)] = rec
        if write:
            # only live appends are observable — re-loading an existing
            # JSONL file at construction is not new protocol activity
            obs = get_recorder()
            if obs.enabled:
                obs.counter("recovery.wal_appends")
                obs.event("wal_append", round=rec.round, node=self.node_id,
                          kind=rec.kind, durable=self.path is not None)
        if write and self.path is not None:
            with self.path.open("a") as f:
                f.write(rec.to_json() + "\n")
        return rec

    def append(self, kind: str, round: int, digest: str,
               **data: str) -> WALRecord:
        return self._admit(WALRecord(kind, int(round), str(digest),
                                     dict(data)), write=True)

    # -- typed helpers for the four protocol statements ----------------------
    def log_commit(self, round: int, model_bytes: bytes, nonce: bytes,
                   digest: bytes, tag: crypto.Signature) -> WALRecord:
        """Record a commit-sent: keyed by the *model* digest (two commits
        to the same model differ only in nonce and are not equivocation —
        two commits to different models are)."""
        return self.append(
            "commit", round, crypto.sha256_digest(model_bytes).hex(),
            nonce=nonce.hex(), commitment=digest.hex(),
            model=model_bytes.hex(),
            tag=crypto.Signature.coerce(tag).to_bytes().hex())

    def commit_record(self, round: int,
                      model_bytes: bytes) -> Optional[WALRecord]:
        """The logged commit for ``round``, or None. Raises
        :class:`WALConflict` if one exists for *different* model bytes —
        the double-sign the WAL exists to prevent."""
        rec = self.lookup("commit", round)
        if rec is None:
            return None
        if not _texts_equal(rec.digest,
                            crypto.sha256_digest(model_bytes).hex()):
            raise WALConflict(
                f"node {self.node_id}: commit for round {round} already "
                f"logged over different model bytes — refusing the "
                f"conflicting re-commit")
        return rec

    def log_reveal(self, round: int, digest: bytes) -> WALRecord:
        return self.append("reveal", round, digest.hex())

    def log_vote(self, round: int, vote: int) -> WALRecord:
        return self.append("vote", round, str(int(vote)))

    def log_block(self, round: int, block_hash_hex: str) -> WALRecord:
        return self.append("block", round, block_hash_hex)

    def log_checkpoint(self, epoch: int, statement_digest_hex: str,
                       ) -> WALRecord:
        """Record a checkpoint countersignature (keyed by epoch): a member
        that crashed and rejoined mid-epoch replays its WAL, and signing a
        *conflicting* checkpoint statement for the same epoch raises
        :class:`WALConflict` instead of equivocating across shards."""
        return self.append("checkpoint", epoch, statement_digest_hex)


# ---------------------------------------------------------------------------
# Crash + restart of HCDS state
# ---------------------------------------------------------------------------

def wipe_volatile(node: Any) -> None:
    """The crash: clear every in-memory HCDS structure of ``node`` (its
    keypair and WAL survive — they model durable key storage and the log)."""
    node._commits.clear()
    node._reveals.clear()
    node._own.clear()
    node._commit_order.clear()


def replay_wal(node: Any, wal: NodeWAL) -> int:
    """The restart: rebuild ``node``'s own commitments from its WAL so a
    re-broadcast is byte-identical to the pre-crash statement. Idempotent —
    replaying an already-replayed log changes nothing. Returns the number
    of records applied."""
    applied = 0
    for rec in wal.records():
        if rec.kind != "commit":
            # reveal/vote/block records exist to refuse conflicting
            # re-signing (checked at signing time); they carry no volatile
            # state to rebuild
            continue
        node.restore_own_commit(
            rec.round,
            nonce=bytes.fromhex(rec.data["nonce"]),
            model_bytes=bytes.fromhex(rec.data["model"]),
            digest=bytes.fromhex(rec.data["commitment"]),
            tag=crypto.Signature.coerce(rec.data["tag"]))
        applied += 1
    obs = get_recorder()
    if obs.enabled:
        obs.counter("recovery.wal_replays")
        obs.counter("recovery.wal_records_replayed", applied)
        obs.event("wal_replay", node=wal.node_id, applied=applied,
                  records=len(wal))
    return applied


# ---------------------------------------------------------------------------
# Ledger snapshot / restore (repro.checkpoint-style integrity digests)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LedgerSnapshot:
    """A ledger frozen to JSON with a ``repro.checkpoint``-style integrity
    digest (sha256 over the canonical serialized payload)."""

    node_id: int
    height: int
    head: str
    digest: str
    payload: str          # canonical JSON list of block dicts

    @staticmethod
    def payload_digest(payload: str) -> str:
        return crypto.sha256_digest(payload.encode()).hex()


def snapshot_ledger(ledger: Ledger) -> LedgerSnapshot:
    payload = json.dumps([_block_to_dict(b) for b in ledger.blocks],
                         sort_keys=True)
    obs = get_recorder()
    if obs.enabled:
        obs.counter("recovery.ledger_snapshots")
        obs.event("ledger_snapshot", node=ledger.node_id,
                  height=ledger.height)
    return LedgerSnapshot(
        node_id=ledger.node_id, height=ledger.height, head=ledger.head_hash,
        digest=LedgerSnapshot.payload_digest(payload), payload=payload)


def restore_ledger(snap: LedgerSnapshot,
                   public_keys: Optional[Dict[int, crypto.Point]] = None,
                   ) -> Ledger:
    """Rebuild a ledger from a snapshot, refusing a tampered payload (the
    manifest digest must match) and, with ``public_keys``, a chain whose
    block signatures no longer verify."""
    if not _texts_equal(snap.digest,
                        LedgerSnapshot.payload_digest(snap.payload)):
        raise InvalidBlock(
            f"ledger snapshot for node {snap.node_id} fails its integrity "
            f"digest — refusing to restore tampered state")
    led = Ledger(snap.node_id)
    led.blocks = [_block_from_dict(d) for d in json.loads(snap.payload)]
    if led.height != snap.height or led.head_hash != snap.head:
        raise InvalidBlock(
            f"ledger snapshot for node {snap.node_id} does not match its "
            f"manifest (height/head mismatch)")
    if public_keys is not None and not led.verify_chain(public_keys):
        raise InvalidBlock(
            f"restored chain for node {snap.node_id} fails verification")
    obs = get_recorder()
    if obs.enabled:
        obs.counter("recovery.ledger_restores")
        obs.event("ledger_restore", node=snap.node_id, height=snap.height)
    return led


def save_snapshot(directory: str | Path, ledger: Ledger,
                  model_tree: Any = None) -> Path:
    """Persist ``ledger`` (and, optionally, ``model_tree`` as a
    ``repro_torch.checkpoint`` checkpoint at step = chain height) under
    ``directory``. Returns the manifest path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    snap = snapshot_ledger(ledger)
    manifest = directory / f"ledger_{ledger.node_id}.json"
    manifest.write_text(json.dumps({
        "node_id": snap.node_id, "height": snap.height, "head": snap.head,
        "digest": snap.digest, "payload": snap.payload}, indent=2))
    if model_tree is not None:
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(directory, step=ledger.height, tree=model_tree)
    return manifest


def load_snapshot(directory: str | Path, node_id: int,
                  public_keys: Optional[Dict[int, crypto.Point]] = None,
                  model_template: Any = None) -> Tuple[Ledger, Any]:
    """Restore a node's ledger (and, with ``model_template``, its last
    checkpointed global model) from :func:`save_snapshot` output."""
    directory = Path(directory)
    d = json.loads((directory / f"ledger_{node_id}.json").read_text())
    snap = LedgerSnapshot(node_id=int(d["node_id"]), height=int(d["height"]),
                          head=d["head"], digest=d["digest"],
                          payload=d["payload"])
    ledger = restore_ledger(snap, public_keys)
    model = None
    if model_template is not None:
        from repro_torch.checkpoint import load_checkpoint
        model = load_checkpoint(directory, step=ledger.height,
                                template=model_template)
    return ledger, model


# ---------------------------------------------------------------------------
# Rejoin: catch up from reachable peers
# ---------------------------------------------------------------------------

def rejoin_ledger(ledger: Ledger, peer_ledgers: Sequence[Ledger],
                  public_keys: Optional[Dict[int, crypto.Point]] = None,
                  ) -> int:
    """Catch ``ledger`` up from the best reachable peer chain (longest,
    head-hash tie-break — the same rule as ``Ledger.fork_choice``).
    Returns how many blocks the rejoining node adopted."""
    candidates = sorted(peer_ledgers,
                        key=lambda led: (-led.height, led.head_hash))
    if not candidates:
        return 0
    best = candidates[0]
    if best.height <= ledger.height:
        return 0
    before = ledger.height
    try:
        ledger.sync_from(best.blocks, public_keys)
    except InvalidBlock:
        ledger.fork_choice(best.blocks, public_keys)
    adopted = ledger.height - before
    obs = get_recorder()
    if obs.enabled:
        obs.counter("recovery.ledger_rejoins")
        obs.counter("recovery.blocks_adopted", adopted)
        obs.event("ledger_rejoin", node=ledger.node_id, adopted=adopted,
                  height=ledger.height)
    return adopted
