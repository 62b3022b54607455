"""Comparing a ``ScenarioReport`` of the port with the reference's.

Shared by ``test_torch_sim.py`` and ``test_torch_consortium.py``. The
reports must agree in every field but the head hashes (HCDS nonces are
``os.urandom``), accuracy and loss (allclose at ``test_torch_e2e.py``'s
tolerances) and the obs metrics. The leader is compared exactly only
where the reference's top-2 similarity margin over the available models
is at least ten times the similarity tolerance. A round below that ties
in float32: the port's argmax must then lie within the tolerance of the
reference's best model, the port must elect its own argmax wherever the
reference elected its argmax (or, if it re-elected, have seen its argmax
time out), and the other fields that follow from the
election are left out (``LEADER_ROUND``, ``LEADER_RUN``, ``LEADER_EVENTS``; the
honest nodes' heights compare as a multiset, since a leader that crashes
after minting is the node that falls behind).
"""

import numpy as np

SIM_ATOL = 1e-5

# fields of a round that follow from who was elected
LEADER_ROUND = ("leader", "honest_leader", "leader_is_argmax",
                "reelections")
# the run's roll-ups of those
LEADER_RUN = ("honest_leader_rate", "argmax_leader_rate", "reelections")
# events whose node is the elected leader (a timeout re-elects; a role
# crash kills whoever won)
LEADER_EVENTS = ("leader_timeout", "node_crashed", "node_restarted",
                 "node_rejoined")


def _available(report_round, n, committees=None):
    """The round's available models, as indices into its similarities."""
    if report_round["available"] is None:
        return list(range(n))
    if committees is None:
        return list(report_round["available"])
    com = committees[report_round["committee"]]
    return [com.local_index(g) for g in report_round["available"]]


def drop_keys(d, keys):
    return {k: v for k, v in d.items() if k not in keys}


def _events_without_leader(events):
    """The events with the leader's part taken out: no timeouts (their
    count is the re-elections'), no node on the crash events."""
    return [drop_keys(e, ("node",)) if e["event"] in LEADER_EVENTS else e
            for e in events if e["event"] != "leader_timeout"]


def _timed_out(events, report_round):
    """The candidates that timed out in a round (committee-local ids in a
    consortium, as the similarities are indexed)."""
    return {e["candidate"] for e in events
            if e["event"] == "leader_timeout"
            and e["round"] == report_round["round"]
            and e.get("committee", report_round["committee"])
            == report_round["committee"]}


def compare_reports(jd, td, j_hist, t_hist, committees=None):
    """Assert that two ``ScenarioReport.to_dict()``s agree as the module
    doc says; returns the number of rounds whose vote tied. ``j_hist`` /
    ``t_hist`` are the runs' ``RoundMetrics`` in the report's round order;
    ``committees`` (a consortium's) maps the rounds' global ids back to
    the committee-local ones the similarities are indexed by."""
    assert len(td["rounds"]) == len(jd["rounds"])
    tied = 0
    for jr, tr, mj, mt in zip(jd["rounds"], td["rounds"], j_hist, t_hist):
        assert (mj.consensus is None) == (mt.consensus is None)
        skip = ("heads", "test_accuracy", "test_loss")
        if mj.consensus is not None:
            sj = np.asarray(mj.consensus.similarities, np.float64)
            st = np.asarray(mt.consensus.similarities, np.float64)
            np.testing.assert_allclose(st, sj, rtol=0, atol=SIM_ATOL)
            np.testing.assert_allclose(tr["test_accuracy"],
                                       jr["test_accuracy"], atol=1e-6)
            np.testing.assert_allclose(tr["test_loss"], jr["test_loss"],
                                       rtol=1e-4)
            avail = _available(jr, len(sj), committees)
            top = np.sort(sj[avail])[-2:]
            if len(top) < 2 or top[1] - top[0] >= 10 * SIM_ATOL:
                np.testing.assert_array_equal(
                    mt.consensus.votes, np.asarray(mj.consensus.votes))
            else:
                tied += 1
                skip += LEADER_ROUND
                # the port's vote goes to a model the reference scores
                # within the tolerance of its best
                pick = avail[int(np.argmax(st[avail]))]
                assert sj[pick] >= top[1] - 10 * SIM_ATOL
                # BTSV's criterion (tests/test_attacks.py): where the
                # reference elected its argmax, the port elects its own,
                # or re-elects because its own timed out
                if jr["leader_is_argmax"]:
                    if tr["reelections"] == 0:
                        assert tr["leader_is_argmax"]
                    else:
                        assert pick in _timed_out(td["events"], tr)
        if tied:
            # a leader that crashes after minting falls behind: which node
            # lags follows the election, how many blocks each holds not
            skip += ("heights",)
            assert set(tr["heights"]) == set(jr["heights"])
            assert sorted(tr["heights"].values()) == \
                sorted(jr["heights"].values())
        assert drop_keys(tr, skip) == drop_keys(jr, skip)
    skip = ("final_heads", "obs_metrics", "rounds", "events",
            "committee_reports")
    row_skip = ("final_head",)
    if tied:
        skip += LEADER_RUN
        row_skip += ("reelections",)
        assert _events_without_leader(td["events"]) == \
            _events_without_leader(jd["events"])
    else:
        assert td["events"] == jd["events"]
    assert drop_keys(td, skip) == drop_keys(jd, skip)
    assert set(td["final_heads"]) == set(jd["final_heads"])
    assert [drop_keys(c, row_skip) for c in td["committee_reports"]] == \
        [drop_keys(c, row_skip) for c in jd["committee_reports"]]
    return tied
