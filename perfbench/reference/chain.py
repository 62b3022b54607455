"""The chain's checks in plain Python: block bodies, hash links and the
leader's ECDSA signature over secp256k1 (the paper's DSign/DVerify), from
the formats the repository's blockchain defines: a block's body is its
fields but the signature as sorted-key JSON; its hash is SHA-256 of the
body and the signature's hex (r ‖ s ‖ v, 65 bytes); the signature covers
SHA-256 of the envelope domain "pofel-envelope-v1", the kind "block",
the round and the leader (8 bytes each, big-endian, signed) and the
body's SHA-256."""

from __future__ import annotations

import hashlib
import json
from typing import Optional, Tuple

P = 2 ** 256 - 2 ** 32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
GENESIS = "0" * 64
DOMAIN = b"pofel-envelope-v1"

Point = Optional[Tuple[int, int]]


def _add(a: Point, b: Point) -> Point:
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0] and (a[1] + b[1]) % P == 0:
        return None
    if a == b:
        lam = 3 * a[0] * a[0] * pow(2 * a[1], -1, P) % P
    else:
        lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, P) % P
    x = (lam * lam - a[0] - b[0]) % P
    return x, (lam * (a[0] - x) - a[1]) % P


def _mul(k: int, pt: Point) -> Point:
    out = None
    while k:
        if k & 1:
            out = _add(out, pt)
        pt = _add(pt, pt)
        k >>= 1
    return out


def public_key(seed: bytes) -> Point:
    """The key pair's public point for a key derived from ``seed``:
    SK = SHA-256(seed) mod (N − 1) + 1."""
    sk = int.from_bytes(hashlib.sha256(seed).digest(), "big") % (N - 1) + 1
    return _mul(sk, G)


def verify(r: int, s: int, pk: Point, digest: bytes) -> bool:
    if not (1 <= r < N and 1 <= s < N) or pk is None:
        return False
    z = int.from_bytes(digest, "big")
    w = pow(s, -1, N)
    pt = _add(_mul(z * w % N, G), _mul(r * w % N, pk))
    return pt is not None and pt[0] % N == r


def body_bytes(block: dict) -> bytes:
    body = {k: v for k, v in block.items() if k != "leader_signature"}
    return json.dumps(body, sort_keys=True, default=str).encode()


def sig_bytes(sig) -> bytes:
    r, s, v = sig
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v & 0xFF])


def block_hash(block: dict) -> str:
    return hashlib.sha256(body_bytes(block) + sig_bytes(
        block["leader_signature"]).hex().encode()).hexdigest()


def signing_digest(block: dict) -> bytes:
    return hashlib.sha256(
        DOMAIN + b"block" + block["round"].to_bytes(8, "big", signed=True)
        + block["leader_id"].to_bytes(8, "big", signed=True)
        + hashlib.sha256(body_bytes(block)).digest()).digest()


def check_block(block: dict, height: int, prev_hash: str, pk: Point,
                expect: dict) -> list:
    """The faults of one block, as strings: its place in the chain, its
    signature, and the fields ``expect`` gives (round, leader, the
    digests of the round's similarities, the votes and their weights)."""
    faults = []
    if block["index"] != height:
        faults.append(f"index {block['index']} at height {height}")
    if block["prev_hash"] != prev_hash:
        faults.append(f"block {height}: prev_hash does not link")
    sig = block.get("leader_signature")
    if sig is None or not verify(sig[0], sig[1], pk, signing_digest(block)):
        faults.append(f"block {height}: the leader's signature fails")
    for key, want in expect.items():
        if block[key] != want:
            faults.append(f"block {height}: {key} {block[key]!r} != "
                          f"{want!r}")
    return faults


def expected_fields(round_: int, sims, leader: int, weights) -> dict:
    """What the trainer's block of a round holds, from the round's
    float32 similarities and vote weights: SHA-256 digests of each
    similarity's bytes and of all of them, every vote for the largest
    similarity, the weights, and the leader's tally."""
    C = len(sims)
    best = int(max(range(C), key=lambda i: (sims[i], -i)))
    return {
        "round": round_, "leader_id": leader,
        "model_digests": {i: hashlib.sha256(sims[i].tobytes()).hexdigest()
                          for i in range(C)},
        "global_model_digest": hashlib.sha256(sims.tobytes()).hexdigest(),
        "votes": {i: best for i in range(C)},
        "vote_weights": {i: float(weights[i]) for i in range(C)},
        "advotes": {best: float(weights.sum())},
    }
