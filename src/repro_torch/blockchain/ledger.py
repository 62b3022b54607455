"""Append-only ledger each BCFL node maintains (paper §3.1 step 4).

Verification on append: chain linkage, leader signature, and that the
claimed leader matches an independent BTSV re-tally (nodes re-run the
smart contract locally — the consortium-chain analogue of validating a
block's proof).

Whole-chain checks (:meth:`Ledger.sync_from`, :meth:`Ledger.fork_choice`,
:func:`_chain_valid`) verify leader signatures as ONE batch over the
chain's block envelopes (``repro_torch.core.crypto.verify_batch``) instead of a
double-scalar multiplication per block — catch-up sync after a partition
validates a whole suffix for roughly the cost of one verification.

Nodes that miss a round (network partition, crash — the fault scenarios
of ``repro_torch.sim``) converge through two primitives:

* :meth:`Ledger.sync_from` — catch-up sync: validate and append the
  suffix of a peer's chain beyond our height (a stale-``prev_hash``
  block, i.e. a peer whose history diverges from ours, is rejected);
* :meth:`Ledger.fork_choice` — longest-valid-chain rule with a
  deterministic head-hash tie-break, for adopting a competing chain
  after rejoining.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.blockchain.block import GENESIS_HASH, Block, block_hash
from repro_torch.core import crypto
from repro_torch.core.envelope import verify_envelopes


class InvalidBlock(ValueError):
    pass


def _verify_block_signatures(blocks: Sequence[Block],
                             public_keys: Dict[int, crypto.Point]) -> bool:
    """Batch-verify the leader signatures of ``blocks``: every leader must
    have a registered key and every block envelope must verify. One
    ``verify_batch`` call covers the whole sequence."""
    if any(b.leader_signature is None or b.leader_id not in public_keys
           for b in blocks):
        return False
    return verify_envelopes([b.envelope() for b in blocks], public_keys).ok


class Ledger:
    def __init__(self, node_id: int = -1):
        self.node_id = node_id
        self.blocks: List[Block] = []

    @property
    def head_hash(self) -> str:
        return block_hash(self.blocks[-1]) if self.blocks else GENESIS_HASH

    @property
    def height(self) -> int:
        return len(self.blocks)

    def append(self, block: Block, leader_pk: Optional[crypto.Point] = None,
               retally: Optional[Callable[[Block], int]] = None) -> None:
        if block.prev_hash != self.head_hash:
            raise InvalidBlock(
                f"chain break at height {self.height}: prev_hash mismatch")
        if block.index != self.height:
            raise InvalidBlock(f"bad index {block.index} at height {self.height}")
        if leader_pk is not None and not block.verify_signature(leader_pk):
            raise InvalidBlock("leader signature invalid")
        if retally is not None and retally(block) != block.leader_id:
            raise InvalidBlock("leader does not match local BTSV re-tally")
        self.blocks.append(block)

    # -- catch-up sync / fork choice ----------------------------------------
    def sync_from(self, blocks: Sequence[Block],
                  public_keys: Optional[Dict[int, crypto.Point]] = None,
                  retally: Optional[Callable[[Block], int]] = None) -> int:
        """Catch-up sync: append the suffix of ``blocks`` (a peer's chain)
        beyond our height, fully validated. Returns how many blocks were
        adopted. Raises :class:`InvalidBlock` if the peer's block at our
        height does not extend our head (diverged history — resolve with
        :meth:`fork_choice` instead of blind adoption).
        """
        # hash chains: one comparison at the last shared index proves the
        # whole overlap matches (or exposes a diverged history, even when
        # the peer's chain is not longer than ours)
        overlap = min(self.height, len(blocks))
        if overlap and (block_hash(blocks[overlap - 1])
                        != block_hash(self.blocks[overlap - 1])):
            raise InvalidBlock(
                f"peer history diverges from local chain at height "
                f"{overlap - 1}")
        suffix = list(blocks[self.height:])
        if public_keys is not None:
            for block in suffix:
                if block.leader_id not in public_keys:
                    raise InvalidBlock(
                        f"no public key for leader {block.leader_id} at "
                        f"height {block.index} — refusing unverified sync")
            # one batch verification for the whole adopted suffix; the
            # per-block append below then only checks linkage/retally
            if not _verify_block_signatures(suffix, public_keys):
                raise InvalidBlock("leader signature invalid in sync suffix")
        adopted = 0
        for block in suffix:
            self.append(block, leader_pk=None, retally=retally)
            adopted += 1
        return adopted

    def fork_choice(self, blocks: Sequence[Block],
                    public_keys: Optional[Dict[int, crypto.Point]] = None,
                    ) -> bool:
        """Longest-valid-chain rule: adopt ``blocks`` wholesale if it is a
        valid chain and strictly longer than ours — equal-length ties break
        toward the lexicographically smaller head hash, so every honest
        node facing the same candidates picks the same chain. Returns True
        if the local chain was replaced."""
        candidate = list(blocks)
        if not _chain_valid(candidate, public_keys):
            return False
        if len(candidate) < len(self.blocks):
            return False
        if len(candidate) == len(self.blocks):
            if not candidate or not self.blocks:
                return False
            if block_hash(candidate[-1]) >= self.head_hash:
                return False
        self.blocks = candidate
        return True

    def verify_chain(self,
                     public_keys: Optional[Dict[int, crypto.Point]] = None,
                     ) -> bool:
        """Linkage of the whole chain; with ``public_keys`` additionally
        batch-verifies every block's leader signature."""
        return _chain_valid(self.blocks, public_keys)

    # -- persistence --------------------------------------------------------
    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps([_block_to_dict(b)
                                          for b in self.blocks]))

    @classmethod
    def load(cls, path: str | Path, node_id: int = -1) -> "Ledger":
        led = cls(node_id)
        for d in json.loads(Path(path).read_text()):
            led.blocks.append(_block_from_dict(d))
        if not led.verify_chain():
            raise InvalidBlock(f"loaded chain from {path} fails verification")
        return led


def _block_to_dict(b: Block) -> dict:
    """JSON-safe dict form of a block; the signature travels as the
    canonical ``Signature.to_bytes`` hex."""
    from dataclasses import asdict
    d = asdict(b)
    if d.get("leader_signature") is not None:
        d["leader_signature"] = (crypto.Signature
                                 .coerce(b.leader_signature).to_bytes().hex())
    return d


def _block_from_dict(d: dict) -> Block:
    d = dict(d)
    d["model_digests"] = {int(k): v for k, v in d["model_digests"].items()}
    d["votes"] = {int(k): int(v) for k, v in d["votes"].items()}
    d["vote_weights"] = {int(k): float(v) for k, v in d["vote_weights"].items()}
    d["advotes"] = {int(k): float(v) for k, v in d["advotes"].items()}
    if d.get("leader_signature") is not None:
        # canonical hex; a pre-envelope [r, s] list still coerces, but the
        # envelope refactor changed block_hash, so a multi-block chain
        # persisted before it fails the prev_hash linkage on load and must
        # be re-minted (no deployed chains predate this format)
        d["leader_signature"] = crypto.Signature.coerce(d["leader_signature"])
    return Block(**d)


def _chain_valid(blocks: Sequence[Block],
                 public_keys: Optional[Dict[int, crypto.Point]] = None) -> bool:
    """Linkage (+ leader signatures, when keys are supplied) of a candidate
    chain, without mutating any ledger. Signatures are verified as one
    batch over the chain's block envelopes."""
    prev = GENESIS_HASH
    for i, b in enumerate(blocks):
        if b.prev_hash != prev or b.index != i:
            return False
        prev = block_hash(b)
    if public_keys is not None and not _verify_block_signatures(blocks,
                                                                public_keys):
        return False
    return True
