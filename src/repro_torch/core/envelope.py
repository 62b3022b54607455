"""Signed-envelope message layer — the one wire format consensus traffic
travels in.

Every PoFEL broadcast — HCDS commits and reveals (§4.1), vote-tally
contract submissions (§4.3), and minted blocks — is a
:class:`SignedEnvelope`: a typed header ``(kind, round, sender)`` over a
payload digest, signed by the sender. Centralizing the format buys three
things the scattered per-message tuples could not:

* **domain separation** — the signing digest binds the kind/round/sender
  header, so a commit tag can never be replayed as a vote or a block
  signature (cross-phase replay was previously only prevented by
  convention);
* **batch verification** — a phase collects its envelopes and calls
  :func:`verify_envelopes` once; under the ``batch`` crypto backend the
  round's N×(N−1) signature checks collapse into one
  randomized-linear-combination equation (``repro_torch.core.crypto``);
* **attribution** — a failing batch bisects to the exact forged envelopes,
  so the simulator's adversary scenarios can count and blame them
  (``ScenarioReport.rejected_envelopes``).

HCDS keeps its paper semantics: the reveal stage re-broadcasts the commit
tag, so a reveal is *re-verified against the rebuilt commit envelope* of
the recomputed digest (:func:`commit_signing_digest`) rather than carrying
a second signature.
"""

from __future__ import annotations

import hmac
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core import crypto

KINDS = ("commit", "reveal", "vote", "block", "checkpoint")
# the reference protocol's own domain tag, not a second namespace: the
# port speaks the same wire format, so its envelopes verify across both
_DOMAIN = b"pofel-envelope-v1"  # noqa: RA404


def digests_equal(a: bytes, b: bytes) -> bool:
    """Constant-time equality for commitment digests / payload digests.

    A short-circuiting ``==`` leaks the length of the matching prefix
    through timing (the RA2xx rule class ``repro_torch.analysis`` enforces);
    ``hmac.compare_digest`` examines every byte regardless."""
    return hmac.compare_digest(a, b)


def tags_equal(a, b) -> bool:
    """Constant-time equality for signature tags, accepting any
    representation :meth:`crypto.Signature.coerce` does (Signature, bare
    ``(r, s)``, hex). Compares the canonical 65-byte wire forms; a bare
    ``(r, s)`` pair equals a Signature with the same (r, s) and v == 0.
    A tag that cannot be canonicalized (adversarial out-of-range values)
    is simply unequal — the caller's dverify fallback rejects it."""
    try:
        return hmac.compare_digest(crypto.Signature.coerce(a).to_bytes(),
                                   crypto.Signature.coerce(b).to_bytes())
    except (TypeError, ValueError, OverflowError):
        return False


def signing_digest(kind: str, round: int, sender: int,
                   payload_digest: bytes) -> bytes:
    """The digest an envelope's signature covers: a domain-separated hash
    of the typed header plus the payload digest."""
    return crypto.sha256_digest(
        _DOMAIN, kind.encode(), round.to_bytes(8, "big", signed=True),
        sender.to_bytes(8, "big", signed=True), payload_digest)


def commit_signing_digest(round: int, sender: int,
                          payload_digest: bytes) -> bytes:
    """The commit-envelope digest for a recomputed H(r‖w) — what a reveal's
    re-broadcast tag must verify against (Alg. 2 line 15)."""
    return signing_digest("commit", round, sender, payload_digest)


@dataclass(frozen=True)
class SignedEnvelope:
    """One consensus message on the wire: who sent what, in which phase of
    which round, under which signature."""

    kind: str                       # one of KINDS
    round: int
    sender: int
    payload_digest: bytes           # H(payload) — payloads travel off-wire
    signature: crypto.Signature

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown envelope kind {self.kind!r}; "
                             f"choose from {KINDS}")

    def signing_digest(self) -> bytes:
        # the envelope implementation itself: __post_init__ checked the
        # kind against KINDS (the analyzer reads the reference's registry)
        return signing_digest(self.kind, self.round,  # noqa: RA402
                              self.sender, self.payload_digest)

    @classmethod
    def seal(cls, kind: str, round: int, sender: int, payload_digest: bytes,
             private_key: int) -> "SignedEnvelope":
        # cls(...) checks the kind against KINDS
        digest = signing_digest(kind, round, sender,  # noqa: RA402
                                payload_digest)
        return cls(kind, round, sender, payload_digest,
                   crypto.dsign(digest, private_key))

    def verify(self, public_key: crypto.Point) -> bool:
        """Per-message verification (the non-batched path)."""
        return crypto.dverify(self.signature, public_key,
                              self.signing_digest())

    # -- wire dict I/O -------------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        return {"kind": self.kind, "round": self.round, "sender": self.sender,
                "payload_digest": self.payload_digest.hex(),
                "signature": crypto.Signature.coerce(self.signature)
                                             .to_bytes().hex()}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "SignedEnvelope":
        return cls(str(d["kind"]), int(d["round"]), int(d["sender"]),
                   bytes.fromhex(str(d["payload_digest"])),
                   crypto.Signature.coerce(d["signature"]))


class EnvelopeBatchResult(NamedTuple):
    """Outcome of :func:`verify_envelopes` over one phase's envelopes."""

    ok: bool
    bad: Tuple[int, ...]            # indices of forged/unverifiable envelopes

    def bad_senders(self, envelopes: Sequence[SignedEnvelope]) -> List[int]:
        """The attributed senders, in input order without duplicates."""
        seen, out = set(), []
        for i in self.bad:
            s = envelopes[i].sender
            if s not in seen:
                seen.add(s)
                out.append(s)
        return out


def verify_envelopes(envelopes: Sequence[SignedEnvelope],
                     public_keys: Dict[int, crypto.Point],
                     backend: Optional[str] = None) -> EnvelopeBatchResult:
    """Verify one phase's envelopes in a single batch.

    An envelope whose sender has no registered public key is unverifiable
    and counted bad. Everything else goes through
    :func:`repro_torch.core.crypto.verify_batch` — one RLC equation under the
    ``batch`` backend, a dverify loop under the others — so the accept set
    is always exactly the individually-valid envelopes.
    """
    missing = tuple(i for i, e in enumerate(envelopes)
                    if e.sender not in public_keys)
    known = [(i, e) for i, e in enumerate(envelopes)
             if e.sender in public_keys]
    res = crypto.verify_batch(
        [(e.signature, public_keys[e.sender], e.signing_digest())
         for _, e in known], backend=backend)
    bad = tuple(sorted(missing + tuple(known[j][0] for j in res.bad)))
    return EnvelopeBatchResult(not bad, bad)
