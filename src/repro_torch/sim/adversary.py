"""Adversary library for the BHFL network simulator (paper §3.2, §7.4).

Each adversary attaches Byzantine behaviour to one node (``node_id``) or
to a protocol role (``node_id=None`` — e.g. :class:`LeaderCrash` crashes
*whoever* wins the election). ``SimEnv`` consults them at the protocol
step they subvert:

=====================  ====================================================
:class:`Plagiarist`     copies a peer's FEL model; HCDS rejects the
                        duplicate reveal (§3.2 — the HCDS claim)
:class:`BriberyVoter`   votes a fixed target (TA) or uniformly at random
                        (RA); BTSV down-weights it (§7.4 — the BTSV claim)
:class:`CommitWithholder`  never broadcasts its commitment, so its model
                        misses the reveal quorum and drops out of ME
:class:`RevealEquivocator` commits to one model, reveals another; every
                        honest receiver sees the digest mismatch
:class:`LazyLeader`     participates normally but never mints when
                        elected, forcing a re-election
:class:`LeaderCrash`    role adversary: the elected leader times out in
                        the configured rounds, whoever it is
:class:`CrashRestart`   benign (non-Byzantine) mid-phase crash fault: the
                        node dies at a named phase boundary and restarts
                        through the recovery path (WAL replay + ledger
                        re-sync); ``amnesia=True`` drops the WAL, turning
                        the restart into attributable equivocation
=====================  ====================================================

Adversaries are stateless across runs — any randomness flows through the
seeded generator the environment passes in, keeping scenarios replayable.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Optional, Tuple

import numpy as np


class Adversary:
    """Base: honest behaviour at every step. Subclasses override the step
    they attack; everything else stays protocol-compliant so the attack is
    isolated (one deviation per adversary class)."""

    plagiarizes: bool = False
    # Byzantine adversaries deviate from the protocol; benign faults
    # (crash/restart) set this False so SimEnv keeps their nodes in the
    # honest safety/leadership accounting
    byzantine: bool = True

    def __init__(self, node_id: Optional[int] = None):
        self.node_id = node_id

    def withholds_commit(self, round: int) -> bool:
        return False

    def withholds_vote(self, round: int) -> bool:
        return False

    def mutate_commit(self, round: int, commit: Any) -> Any:
        return commit

    def mutate_reveal(self, round: int, reveal: Any) -> Any:
        return reveal

    def mutate_vote_submission(self, round: int, submission: Any) -> Any:
        return submission

    def vote(self, round: int, n: int, honest_vote: int, preds: np.ndarray,
             rng: np.random.Generator
             ) -> Optional[Tuple[int, np.ndarray]]:
        """Return (vote, predictions) to deviate, or None to vote honestly."""
        return None

    def extra_delay(self, kind: str, round: int) -> float:
        """Additional bus delay for this node's ``kind`` broadcasts (ms)."""
        return 0.0

    def fails_as_leader(self, round: int, node: int, attempt: int) -> bool:
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} node={self.node_id}>"


class Plagiarist(Adversary):
    """Copies the first honest node's FEL model instead of training
    (wired by the runtime's ``plagiarists`` set). It can only bind bytes
    it has *observed*, so its commitment broadcast necessarily trails the
    owner's by ``observe_lag`` — which is what convicts it: commitment
    precedence (the commit transactions' chain-inclusion order) ranks the
    copy behind the owner at every honest receiver, regardless of node
    ids or of which *reveal* happened to arrive first (``reveal_lag`` can
    be 0 — raced reveals are retroactively evicted by the tie-break in
    ``HCDSNode.receive_reveal``). Every receiver rejects the copy as
    ``plagiarized-model``."""

    plagiarizes = True

    def __init__(self, node_id: int, reveal_lag: float = 30.0,
                 observe_lag: float = 30.0):
        super().__init__(node_id)
        self.reveal_lag = reveal_lag
        self.observe_lag = observe_lag

    def extra_delay(self, kind: str, round: int) -> float:
        if kind == "commit":
            return self.observe_lag
        return self.reveal_lag if kind == "reveal" else 0.0


class BriberyVoter(Adversary):
    """§7.4 bribery attacks: ``mode='targeted'`` always votes ``target``
    (TA); ``mode='random'`` votes uniformly at random (RA). Predictions
    claim g_max certainty for the bribed vote, like an honest voter would."""

    def __init__(self, node_id: int, mode: str = "targeted", target: int = 0,
                 g_max: float = 0.99):
        if mode not in ("targeted", "random"):
            raise ValueError(f"mode must be 'targeted' or 'random', "
                             f"got {mode!r}")
        super().__init__(node_id)
        self.mode = mode
        self.target = target
        self.g_max = g_max

    def vote(self, round: int, n: int, honest_vote: int, preds: np.ndarray,
             rng: np.random.Generator) -> Tuple[int, np.ndarray]:
        vote = self.target if self.mode == "targeted" \
            else int(rng.integers(0, n))
        p = np.full(n, (1.0 - self.g_max) / (n - 1), np.float32)
        p[vote] = self.g_max
        return vote, p


class CommitWithholder(Adversary):
    """Silent in the commit stage: no commitment, hence nothing to reveal,
    hence its model never reaches the availability quorum."""

    def withholds_commit(self, round: int) -> bool:
        return True


class RevealEquivocator(Adversary):
    """Commits to its trained model, then reveals different bytes. Every
    honest receiver recomputes H(r‖w), sees the mismatch with the
    committed digest, and rejects (``digest-mismatch``)."""

    def mutate_reveal(self, round: int, reveal: Any) -> Any:
        forged = bytes(reveal.model_bytes[:-1]) + bytes(
            [reveal.model_bytes[-1] ^ 0x01])
        return replace(reveal, model_bytes=forged)


class EnvelopeForger(Adversary):
    """Forges at the *message layer*: its broadcasts carry envelopes signed
    with a key it does not own (a stolen-identity / spoofing attack below
    the protocol semantics). The phase-level batch verification must fail,
    bisect, and attribute exactly this node's envelopes
    (``forged-envelope`` in the round's rejections, counted by
    ``ScenarioReport.rejected_envelopes``) — without collateral damage to
    honest traffic verified in the same batch.

    ``kinds`` selects which envelope kinds are forged (default: commits
    and votes — the two batch-verified broadcast paths with per-sender
    attribution)."""

    def __init__(self, node_id: int, kinds: Tuple[str, ...] = ("commit",
                                                               "vote")):
        super().__init__(node_id)
        self.kinds = tuple(kinds)
        # a key this node does NOT own — lazily derived, never registered
        self._forged_key = None

    def _forged_private_key(self) -> int:
        if self._forged_key is None:
            from repro_torch.core.crypto import ECDSAKeyPair
            self._forged_key = ECDSAKeyPair.generate(
                b"envelope-forger-" + str(self.node_id).encode())
        return self._forged_key.private_key

    def mutate_commit(self, round: int, commit: Any) -> Any:
        if "commit" not in self.kinds:
            return commit
        from repro_torch.core.envelope import SignedEnvelope
        env = SignedEnvelope.seal("commit", round, commit.node_id,
                                  commit.digest, self._forged_private_key())
        return replace(commit, tag=env.signature)

    def mutate_vote_submission(self, round: int, submission: Any) -> Any:
        if "vote" not in self.kinds or submission.envelope is None:
            return submission
        from repro_torch.core.envelope import SignedEnvelope
        env = SignedEnvelope.seal(
            "vote", round, submission.node_id,
            submission.envelope.payload_digest, self._forged_private_key())
        return replace(submission, envelope=env)


class LazyLeader(Adversary):
    """Fully protocol-compliant until elected — then it never broadcasts
    the block, and the network re-elects the next candidate."""

    def fails_as_leader(self, round: int, node: int, attempt: int) -> bool:
        return node == self.node_id


class CrashRestart(Adversary):
    """Benign mid-phase crash/restart fault (not Byzantine): the node dies
    at a named phase boundary of round ``round`` and comes back through
    the recovery path (``repro_torch.core.recovery``).

    ``at`` names the boundary:

    * ``"after_commit"`` — after its commit broadcast, before its reveal.
      With ``down_rounds=0`` the node fast-reboots inside the phase and
      re-broadcasts its commit: byte-identical after the WAL replay
      (receivers treat the duplicate as idempotent and its reveal still
      binds), or a FRESH statement under ``amnesia=True`` — which honest
      receivers must detect and attribute as ``commit-equivocation``
      rather than crash the round.
    * ``"after_vote"`` — after its vote transaction; the vote stands, the
      node misses the rest of the round and rejoins later.
    * ``"after_mint"`` — as the elected leader, after minting and signing
      the block but before appending/broadcasting it: peers observe an
      ordinary leader timeout and re-elect; the signed block exists only
      in the crashed leader's WAL. Usually used as a ROLE fault
      (``node_id=None``) — it fires for whichever node wins the election.

    ``down_rounds > 0`` keeps the node dark until the start of round
    ``round + down_rounds``, where ``SimEnv.begin_round`` drives the
    rejoin: volatile state wiped, WAL replayed, ledger re-synced from the
    best reachable peer chain. ``amnesia=True`` detaches the node's WAL
    at bind time — the restart replays nothing."""

    byzantine = False
    crash_fault = True
    POINTS = ("after_commit", "after_vote", "after_mint")

    def __init__(self, node_id: Optional[int], at: str, round: int,
                 down_rounds: int = 0, amnesia: bool = False):
        if at not in self.POINTS:
            raise ValueError(f"at must be one of {self.POINTS}, got {at!r}")
        if round < 0:
            raise ValueError(f"round must be >= 0, got {round}")
        if down_rounds < 0:
            raise ValueError(f"down_rounds must be >= 0, got {down_rounds}")
        if node_id is None and at != "after_mint":
            raise ValueError(
                "a role CrashRestart (node_id=None) only makes sense at "
                "'after_mint' — the elected leader is the only node a "
                "role can identify")
        super().__init__(node_id)
        self.at = at
        self.in_round = round
        self.down_rounds = down_rounds
        self.amnesia = amnesia

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"<CrashRestart node={self.node_id} at={self.at} "
                f"round={self.in_round} down={self.down_rounds} "
                f"amnesia={self.amnesia}>")


class LeaderCrash(Adversary):
    """Role adversary (``node_id=None``): in each round of ``rounds``, the
    first ``times`` elected candidates crash at mint time — deterministic
    exercise of BlockMint's re-election path regardless of which node the
    tally actually elects."""

    def __init__(self, rounds: Tuple[int, ...], times: int = 1):
        super().__init__(None)
        self.rounds = tuple(rounds)
        self.times = times

    def fails_as_leader(self, round: int, node: int, attempt: int) -> bool:
        return round in self.rounds and attempt < self.times
