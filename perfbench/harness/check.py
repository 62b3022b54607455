"""The comparison that decides ``correct``.

Set-up drives the program through its first rounds with the window's own
call, on pool batches that all differ, and keeps what they produced: the
losses, the consensus metrics, the BTSV history, and per leaf the norms
‖a0 − w1‖ (the first gradient as the optimizer applied it, times the
step) and ‖a0 − w_R‖ (the change after R rounds), a0 the mean of the
replicas the clusters start from. Once the window has closed and the
program's state is freed, the plain reference follows the same R rounds
from the same replicas and batches, and these numbers are held to the
cell's limits:

* ``loss_gap``: the largest |loss_p − loss_r| / loss_r over the rounds
  and clusters; ``first_loss_gap`` the same over the first round, whose
  losses both sides compute from the same weights;
* ``grad_gap``, ``delta_gap``: over the leaves, the largest gap between
  the program's norm and the reference's, over the reference's norm of
  that leaf or of the median leaf, whichever is larger; leaves whose
  reference gradient is under a thousandth of the median leaf's are left
  out (a gradient that is nought to rounding moves by round-off alone);
* ``stalled_leaves``: the leaves the reference moves over the R rounds
  that the program moves by under a tenth of that, or by over ten
  times;
* ``sims_gap``: Eq. 2, the largest |s_p − s_r|, and how far below the
  reference's best the program's voted model lies (the first round's
  replicas start apart, so the similarities differ there by far more
  than rounding, and the vote has a clear winner);
* ``tally_gap``: BTSV (Alg. 4) from the program's votes and history: the
  largest gap in scores, vote weights and the new history;
* ``chain_faults``: blocks that do not link, whose signature fails, or
  whose fields are not the round's (every round of the run), and a chain
  the program itself does not verify.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from perfbench.reference import chain as ref_chain
from perfbench.reference import pofel as ref_pofel

NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "delta_gap",
           "stalled_leaves", "sims_gap", "tally_gap", "chain_faults")


@dataclass
class RoundRecord:
    """What a round of the program produced, on the host."""
    losses: np.ndarray
    sims: np.ndarray           # float32, as the program computed them
    leader: int
    weights: np.ndarray        # float32 vote weights
    scores: np.ndarray
    history_before: Optional[np.ndarray] = None
    history_after: Optional[np.ndarray] = None


@dataclass
class ProgramReadings:
    rounds: List[RoundRecord] = field(default_factory=list)
    first_step: Dict[str, float] = field(default_factory=dict)  # ‖a0 − w1‖
    change: Dict[str, float] = field(default_factory=dict)      # ‖a0 − w_R‖
    blocks: List[dict] = field(default_factory=list)
    chain_verifies: bool = True


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: List[str]) -> tuple:
    """(the worst leaf's gap, its path)."""
    med = float(np.median([ref[p] for p in keep])) if keep else 0.0
    worst, where = 0.0, ""
    for p in keep:
        denom = max(ref[p], med)
        gap = abs(prog[p] - ref[p]) / denom if denom > 0 else \
            abs(prog[p] - ref[p])
        if not gap <= worst:          # NaN wins
            worst, where = gap, p
    return worst, where


def kept_leaves(grad_norms: Dict[str, float]) -> List[str]:
    med = float(np.median(list(grad_norms.values())))
    return sorted(p for p, g in grad_norms.items() if g >= 1e-3 * med)


def compare(readings: ProgramReadings, ref_rounds: list,
            ref_first: Dict[str, float], ref_change: Dict[str, float],
            pofel: dict, public_key, chain: bool = True
            ) -> Dict[str, dict]:
    """The numbers compared, each {"value": ..., and "where" for a leaf
    gap}. ``ref_rounds`` are the reference's ``RoundOut``s of the
    compared rounds; ``chain`` False leaves out the tally and the
    chain."""
    out: Dict[str, dict] = {}
    loss = 0.0
    sims = 0.0
    for k, (rec, ref) in enumerate(zip(readings.rounds, ref_rounds)):
        gap = np.abs(rec.losses.astype(np.float64) - ref.losses) / \
            np.abs(ref.losses)
        loss = max(loss, float(np.max(gap)) if np.all(np.isfinite(gap))
                   else math.inf)
        if k == 0:
            out["first_loss_gap"] = {"value": loss}
        s = rec.sims.astype(np.float64)
        vote = int(np.argmax(rec.sims))
        sims = max(sims, float(np.max(np.abs(s - ref.sims))),
                   float(np.max(ref.sims) - ref.sims[vote]))
    out["loss_gap"] = {"value": loss}
    keep = kept_leaves(ref_rounds[0].grad_norms)
    g, where = leaf_gap(readings.first_step, ref_first, keep)
    out["grad_gap"] = {"value": g, "where": where, "left_out": sorted(
        set(ref_rounds[0].grad_norms) - set(keep))}
    d, where = leaf_gap(readings.change, ref_change, keep)
    out["delta_gap"] = {"value": d, "where": where}
    stalled = [p for p in keep if not (0.1 * ref_change[p] <=
                                       readings.change[p] <=
                                       10.0 * ref_change[p])]
    out["stalled_leaves"] = {"value": len(stalled), "leaves": stalled[:5]}
    out["sims_gap"] = {"value": sims if math.isfinite(sims) else math.inf}
    if not chain:
        return out
    tally, faults = 0.0, []
    for k, rec in enumerate(readings.rounds):
        if rec.history_before is None:
            continue
        C = len(rec.sims)
        votes = np.full(C, int(np.argmax(rec.sims)))
        t = ref_pofel.btsv_tally(votes, rec.history_before.astype(
            np.float64), pofel)
        for key, got in (("scores", rec.scores), ("weights", rec.weights),
                         ("history", rec.history_after)):
            tally = max(tally, float(np.max(np.abs(
                got.astype(np.float64) - t[key]))))
        if rec.leader != t["leader"]:
            faults.append(f"round {k}: leader {rec.leader}, the tally's "
                          f"{t['leader']}")
    out["tally_gap"] = {"value": tally}
    faults += chain_faults(readings, public_key)
    out["chain_faults"] = {"value": len(faults), "faults": faults[:5]}
    return out


def chain_faults(readings: ProgramReadings, public_key) -> List[str]:
    """Every block against the round the program ran: linked, signed by
    the launcher's key, its fields the round's."""
    faults = [] if readings.chain_verifies else \
        ["the program's own chain verification fails"]
    if len(readings.blocks) != len(readings.rounds):
        faults.append(f"{len(readings.blocks)} blocks for "
                      f"{len(readings.rounds)} rounds")
    prev = ref_chain.GENESIS
    for k, (block, rec) in enumerate(zip(readings.blocks, readings.rounds)):
        faults += ref_chain.check_block(
            block, k, prev, public_key, ref_chain.expected_fields(
                k, rec.sims, rec.leader, rec.weights))
        prev = ref_chain.block_hash(block)
    return faults


def judge(numbers: Dict[str, dict], limits: Dict[str, float]) -> bool:
    """Every number the limits name within its limit (a number must be
    finite); a number they do not name is reported and not compared."""
    ok = True
    for name, limit in limits.items():
        value = numbers[name]["value"]
        numbers[name]["limit"] = limit
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok
