"""Block structure for the consortium BCFL chain (paper §3.1 step 4).

A block at BCFL round k stores: the leader identity e*(k), the digests of
all submitted FEL models W(k) (full weights live in the off-chain model
store, as any realistic chain would do — the chain stores commitments),
the updated global model digest, the consensus artifacts (votes, BTS
scores, vote weights), and the previous block hash.

The leader's signature travels in the same signed-envelope format as every
other consensus message (``repro_torch.core.envelope``): the tag covers the
``("block", round, leader)`` header plus the body digest, serialized
canonically via :meth:`repro_torch.core.crypto.Signature.to_bytes`. Chain-level
verification (``ledger.verify_chain`` / ``fork_choice``) batches all block
envelopes into one ``verify_batch`` call instead of verifying per block.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, Optional

from repro_torch.core import crypto
from repro_torch.core.envelope import SignedEnvelope


@dataclass(frozen=True)
class Block:
    index: int
    round: int
    leader_id: int
    prev_hash: str
    model_digests: Dict[int, str]        # node_id -> hex digest of w^i(k)
    global_model_digest: str             # hex digest of gw(k)
    votes: Dict[int, int]                # voter -> votee
    vote_weights: Dict[int, float]       # voter -> WV^i(k)
    advotes: Dict[int, float]            # votee -> adjusted tally
    task_id: str = "task-0"
    extra: Dict[str, Any] = field(default_factory=dict)
    leader_signature: Optional[crypto.Signature] = None

    def body_bytes(self) -> bytes:
        d = asdict(self)
        d.pop("leader_signature")
        return json.dumps(d, sort_keys=True, default=str).encode()

    def envelope(self) -> SignedEnvelope:
        """The block's signed envelope: what the leader signature covers
        (requires ``leader_signature``; for an unsigned block it carries a
        null tag that can never verify)."""
        sig = (crypto.Signature.coerce(self.leader_signature)
               if self.leader_signature is not None
               else crypto.Signature(0, 0, 0))
        return SignedEnvelope("block", self.round, self.leader_id,
                              crypto.sha256_digest(self.body_bytes()), sig)

    def signed(self, keypair: crypto.ECDSAKeyPair) -> "Block":
        env = SignedEnvelope.seal(
            "block", self.round, self.leader_id,
            crypto.sha256_digest(self.body_bytes()), keypair.private_key)
        return Block(**{**asdict(self), "leader_signature": env.signature})

    def verify_signature(self, leader_pk: crypto.Point) -> bool:
        if self.leader_signature is None:
            return False
        return self.envelope().verify(leader_pk)


def block_hash(block: Block) -> str:
    sig_hex = (crypto.Signature.coerce(block.leader_signature)
               .to_bytes().hex()
               if block.leader_signature is not None else "")
    return crypto.sha256_digest(block.body_bytes(), sig_hex.encode()).hex()


GENESIS_HASH = "0" * 64
