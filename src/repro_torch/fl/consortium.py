"""Sharded consortium: K committee-scoped PoFEL instances + checkpoint sync.

The seed reproduction ran one global committee — every edge server talked
to every other, envelope fan-out grew N×(N−1), and round wall-time scaled
~N². :class:`ConsortiumRuntime` partitions the N BCFL nodes into K
committees (``repro_torch.core.committee``), each driving its *own* full
:class:`~repro_torch.fl.hfl_runtime.BHFLRuntime` — five-phase PoFEL pipeline,
subchain, WALs, committee-scoped quorum ⌈2m/3⌉ — over a committee-scoped
:class:`~repro_torch.sim.network.SimEnv` seeded from an independent RNG
substream (``committee_seed``), so per-round work scales with the
committee size (~N/K), not the consortium.

The shards are stitched together by **cross-shard checkpoint sync**:
every ``checkpoint_interval`` rounds each committee

1. summarizes its epoch as a :class:`~repro_torch.core.committee.
   CheckpointStatement` (subchain height/head + global model digest),
2. collects ≥2/3 member countersignatures (WAL-logged before signing, so
   a member that crashed and rejoined mid-epoch can never countersign a
   conflicting statement), batch-verified via ``verify_envelopes``,
3. packages the certified statement as an ordinary block on its
   *top-chain* ledger and broadcasts the chain (plus its model and data
   size) over a K-endpoint cross-shard bus, and
4. merges peers' checkpoints — ``Ledger.sync_from`` with a certificate
   validator on the retally seam, falling back to ``fork_choice`` (with
   every certificate pre-validated) when histories diverged under a
   cross-shard partition — then aggregates the peer models it adopted
   into its next global model, weighted by data size (Eq. 1 across
   committees).

Committees emit sequentially in committee-id order with merge-on-delivery,
so in a healthy epoch the top-chain serializes K checkpoints; under a
cross-bus partition each side keeps certifying on its own fork and the
final sync reconverges them through fork choice — concurrent checkpoints
are fork-choice fodder, not safety violations.

``finalize`` folds the K per-shard :class:`~repro_torch.sim.report.
ScenarioReport` objects plus the checkpoint layer into one consortium
verdict via :func:`~repro_torch.sim.report.merge_consortium_report`.

In the port each shard is a ``BHFLRuntime`` on ``device`` (the CUDA card
unless the caller asks for the CPU): its FEL and ME run there. The
checkpoint layer is host protocol: a model crosses committees as the
float32 host copy of its canonical flattening, and the cross-committee
Eq. 1 is float64 numpy, as in the reference, its result put back on the
shard's device through ``adapter.unflatten``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.blockchain.block import block_hash
from repro_torch.blockchain.ledger import InvalidBlock, Ledger
from repro_torch.core import crypto
from repro_torch.core.committee import (CheckpointStatement, Committee,
                                        checkpoint_block,
                                        checkpoint_statement_of,
                                        committee_seed,
                                        make_checkpoint_validator,
                                        make_committees, sign_checkpoint)
from repro_torch.core.recovery import WALConflict
from repro_torch.core.serialization import flatten_pytree
from repro_torch.fl.hfl_runtime import BHFLConfig, BHFLRuntime, RoundMetrics
from repro_torch.fl.hierarchy import FELCluster
from repro_torch.obs import get_recorder
from repro_torch.sim.network import NetworkConfig, SimEnv, SimNetwork
from repro_torch.sim.report import merge_consortium_report
from repro_torch.sim.scenarios import Scenario

# the cross-shard bus draws its substream under this pseudo-committee id,
# disjoint from every real committee's stream
_CROSS_BUS_ID = -1


def _host_flat(params: Any) -> np.ndarray:
    """The float32 host copy of a model's sorted-keypath flattening."""
    return flatten_pytree(params).detach().cpu().numpy().astype(np.float32)


def model_digest(params: Any) -> str:
    """Canonical hex digest of a model: sha256 over the float32 bytes of
    its sorted-keypath flattening — committees that adopted the same
    aggregate produce the same digest, which is what a checkpoint
    certificate attests cross-shard."""
    return crypto.sha256_digest(_host_flat(params).tobytes()).hex()


class ConsortiumRuntime:
    """K committee-scoped BHFL runtimes + the cross-shard checkpoint layer.

    Drop-in peer of :class:`~repro_torch.fl.hfl_runtime.BHFLRuntime` for the
    ``api.run_bhfl`` facade: ``run_round`` drives every shard's round (and
    the checkpoint epoch when the interval elapses), ``history`` collects
    per-shard :class:`RoundMetrics`, and ``finalize`` builds the merged
    :class:`~repro_torch.sim.report.ScenarioReport`. ``device`` is where
    every shard trains and runs ME (``None``: the CUDA card).
    """

    def __init__(self, clusters: Sequence[FELCluster], cfg: BHFLConfig,
                 test_set: Optional[Any] = None,
                 adapter: Optional[Any] = None, *,
                 scenario: Scenario, seed: int, device: Any = None):
        if scenario.committees <= 1 and not scenario.committee_sizes:
            raise ValueError(
                "ConsortiumRuntime needs committees > 1 — a single "
                "committee is the plain BHFLRuntime path")
        if scenario.net.partitions:
            raise ValueError(
                "scenario.net.partitions is unsupported with committees > 1 "
                "— committees are already disjoint buses; partition the "
                "consortium via scenario.cross_net instead")
        self.scenario = scenario
        self.seed = seed
        self.cfg = cfg
        self.device = resolve_device(device)
        self.committees: Tuple[Committee, ...] = make_committees(
            cfg.n_nodes, scenario.committees, scenario.committee_sizes)
        self.checkpoint_interval = max(1, int(scenario.checkpoint_interval))

        # -- K shard runtimes, each over its committee's clusters ------------
        # local cluster ids 0..m-1 so every shard-internal structure
        # (ledgers, WALs, contract) keeps its 0..n-1 keying; cfg.seed is
        # shared, so every shard initializes the identical global model
        # (their pre-training digests agree by construction)
        self.shards: List[BHFLRuntime] = []
        for com in self.committees:
            sub_clusters = [FELCluster(local, clusters[gid].clients)
                            for local, gid in enumerate(com.members)]
            sub_cfg = dataclasses.replace(cfg, n_nodes=com.size)
            self.shards.append(BHFLRuntime(sub_clusters, sub_cfg, test_set,
                                           adapter=adapter,
                                           device=self.device,
                                           committee=com))
        self._attach_envs()

        # -- the cross-shard bus (K endpoints, one per committee) ------------
        cross_cfg = scenario.cross_net if scenario.cross_net is not None \
            else NetworkConfig(link=scenario.net.link,
                               retry=scenario.net.retry)
        self.cross = SimNetwork(len(self.committees), cross_cfg,
                                seed=committee_seed(seed, _CROSS_BUS_ID))

        # -- consortium key directory + top-chains ---------------------------
        # global-id-keyed public keys (committee_keypair guarantees no two
        # committees share a key), the certificate validator every
        # top-chain append/sync runs through, and one top ledger per
        # committee (its view of the consortium checkpoint chain)
        self.public_keys: Dict[int, Any] = {}
        for com, shard in zip(self.committees, self.shards):
            for local in range(com.size):
                self.public_keys[com.global_id(local)] = \
                    shard.consensus.public_keys[local]
        self.validator = make_checkpoint_validator(
            {c.committee_id: c for c in self.committees}, self.public_keys)
        self.top_ledgers: Dict[int, Ledger] = {
            c.committee_id: Ledger(c.committee_id) for c in self.committees}
        # cross-shard blocks already counted into ``merged`` per receiver
        # (counted once even if fork choice later rewrites the chain)
        self._counted: Dict[int, set] = {c.committee_id: set()
                                         for c in self.committees}

        self.rounds_run = 0
        self.epochs = 0
        self.emitted: List[int] = [0] * len(self.committees)
        self.merged: List[int] = [0] * len(self.committees)
        self.history: List[RoundMetrics] = []
        # global ids of the leaders elected in the most recent round
        # (one per committee that completed) — the facade settles rewards
        # from this after each run_round
        self.last_leaders: List[int] = []

    # -- wiring ---------------------------------------------------------------
    def _attach_envs(self) -> None:
        """One committee-scoped SimEnv per shard: an independent bus seeded
        from the committee's RNG substream, with the scenario's global
        churn/adversary node ids remapped into committee-local ids. Role
        adversaries (``node_id=None``) apply in every committee — each
        shard elects its own leader for them to target."""
        sc = self.scenario
        for com, shard in zip(self.committees, self.shards):
            churn = tuple(dataclasses.replace(c, node=com.local_index(c.node))
                          for c in sc.net.churn if c.node in com)
            sub_net = dataclasses.replace(sc.net, churn=churn, partitions=())
            network = SimNetwork(com.size, sub_net,
                                 seed=committee_seed(self.seed,
                                                     com.committee_id),
                                 committee=com.committee_id)
            advs: List[Any] = []
            for adv in sc.adversaries:
                gid = getattr(adv, "node_id", None)
                if gid is None:
                    advs.append(adv)
                elif gid in com:
                    local_adv = copy.copy(adv)
                    local_adv.node_id = com.local_index(gid)
                    advs.append(local_adv)
            env = SimEnv(network, advs, quorum=sc.quorum or None,
                         seed=committee_seed(self.seed, com.committee_id),
                         committee=com)
            shard.env = env
            env.bind(shard.consensus)
            shard.plagiarists |= env.plagiarist_ids()

    def set_vote_hook(self, hook: Any) -> None:
        """Install a vote hook on every shard (it sees committee-local ids)."""
        for shard in self.shards:
            shard.vote_hook = hook

    def set_plagiarists(self, global_ids: Sequence[int]) -> None:
        """Mark plagiarist nodes by *global* id, remapped into their shard."""
        for com, shard in zip(self.committees, self.shards):
            shard.plagiarists |= {com.local_index(g) for g in global_ids
                                  if g in com}

    # -- facade compatibility -------------------------------------------------
    @property
    def consensus(self):
        """Committee 0's consensus instance (``BHFLRun.chain_height`` & co.
        read the first shard's subchain in consortium runs)."""
        return self.shards[0].consensus

    @property
    def adapter(self):
        return self.shards[0].adapter

    @property
    def global_params(self) -> Any:
        return self.shards[0].global_params

    def leader_counts(self) -> Dict[int, int]:
        """Per-node leadership totals in *global* ids, all committees."""
        counts: Dict[int, int] = {i: 0 for i in range(self.cfg.n_nodes)}
        for com, shard in zip(self.committees, self.shards):
            for local, c in sorted(shard.leader_counts().items()):
                counts[com.global_id(local)] += c
        return counts

    def verify_chains(self) -> bool:
        """Every subchain and every top-chain verifies end to end."""
        return (all(led.verify_chain()
                    for shard in self.shards
                    for led in shard.consensus.ledgers)
                and all(self.top_ledgers[c.committee_id].verify_chain()
                        for c in self.committees))

    # -- one consortium round -------------------------------------------------
    def run_round(self) -> List[RoundMetrics]:
        """One BCFL round in every committee (sequential over shards —
        their buses are independent, so ordering is presentation, not
        protocol), then a checkpoint epoch when the interval elapses."""
        out: List[RoundMetrics] = []
        self.last_leaders = []
        for com, shard in zip(self.committees, self.shards):
            m = shard.run_round()
            out.append(m)
            if m.leader_id >= 0:
                self.last_leaders.append(com.global_id(m.leader_id))
        self.history.extend(out)
        self.rounds_run += 1
        if self.rounds_run % self.checkpoint_interval == 0:
            self.checkpoint_epoch()
        return out

    def run(self, n_rounds: int) -> List[List[RoundMetrics]]:
        return [self.run_round() for _ in range(n_rounds)]

    # -- the checkpoint epoch -------------------------------------------------
    def checkpoint_epoch(self) -> None:
        """One cross-shard sync epoch: sequential emission in committee-id
        order with merge-on-delivery, then per-committee model aggregation
        over the peers whose checkpoints were adopted."""
        epoch = self.epochs
        # align the cross bus round with the just-finished BCFL round
        # index, so cross_net PartitionSpec windows are expressed in the
        # same 0-based round coordinates as everything else
        self.cross.set_round(self.rounds_run - 1)
        rec = get_recorder()
        rec.open_span("phase:checkpoint_sync", cat="consensus",
                      round=self.rounds_run - 1, sim_now=self.cross.now,
                      epoch=epoch)
        # receiver cid -> sender cid -> (flat model, data size)
        peer_models: Dict[int, Dict[int, Tuple[np.ndarray, float]]] = {
            c.committee_id: {} for c in self.committees}
        for com, shard in zip(self.committees, self.shards):
            cid = com.committee_id
            payload = self._emit_checkpoint(com, shard, epoch)
            if payload is None:
                continue
            deliveries = self.cross.exchange("checkpoint", {cid: payload})
            for recv in sorted(deliveries):
                if cid in deliveries[recv]:
                    self._merge_checkpoint(recv, cid, deliveries[recv][cid],
                                           peer_models)
        self._aggregate_models(peer_models)
        self.epochs += 1
        rec.close_span(sim_now=self.cross.now)

    def _emit_checkpoint(self, com: Committee, shard: BHFLRuntime,
                         epoch: int) -> Optional[Dict[str, Any]]:
        """Build, certify, and self-append one committee's checkpoint.
        Returns the cross-shard payload, or None when the live members
        cannot reach the committee quorum (no emission this epoch)."""
        cid = com.committee_id
        env = shard.env
        cons = shard.consensus
        alive_local = sorted(env.alive())
        # the committee asserts the tallest live member subchain (the same
        # deterministic best-chain rule as the final catch-up sync)
        digest = model_digest(shard.global_params)
        if alive_local:
            best = sorted((cons.ledgers[i] for i in alive_local),
                          key=lambda l: (-l.height, l.head_hash))[0]
            stmt = CheckpointStatement(cid, epoch, best.height,
                                       best.head_hash, digest)
        else:
            stmt = None
        cert: Dict[int, Any] = {}
        if stmt is not None:
            for local in alive_local:
                gid = com.global_id(local)
                try:
                    envelope = sign_checkpoint(
                        stmt, gid, cons.hcds_nodes[local].keypair,
                        wal=cons.wals.get(local))
                except WALConflict:
                    # a rejoined member whose WAL pins a different
                    # statement for this epoch refuses to double-sign
                    env.note("checkpoint_sign_refused", node=local,
                             epoch=epoch)
                    continue
                cert[gid] = envelope.signature
        if stmt is None or len(cert) < com.quorum:
            env.note("checkpoint_skipped", epoch=epoch,
                     signers=len(cert), quorum=com.quorum)
            return None
        # the emitting leader: the last completed round's leader if still
        # live, else the lowest live member
        leader_local = next((m.leader_id for m in reversed(shard.history)
                             if m.leader_id >= 0), None)
        if leader_local is None or leader_local not in set(alive_local):
            leader_local = alive_local[0]
        leader_gid = com.global_id(leader_local)
        top = self.top_ledgers[cid]
        blk = checkpoint_block(stmt, cert, top, leader_gid,
                               cons.hcds_nodes[leader_local].keypair)
        top.append(blk, leader_pk=self.public_keys[leader_gid],
                   retally=self.validator)
        self.emitted[cid] += 1
        env.note("checkpoint_emitted", epoch=epoch, signers=len(cert),
                 sub_height=stmt.sub_height, top_height=top.height)
        return {
            "blocks": list(top.blocks),
            "model": _host_flat(shard.global_params),
            "data_size": float(sum(c.data_size for c in shard.clusters)),
            "digest": digest,
        }

    def _merge_checkpoint(self, recv_cid: int, sender_cid: int,
                          payload: Dict[str, Any],
                          peer_models: Dict[int, Dict[int, Tuple[np.ndarray,
                                                                 float]]],
                          ) -> None:
        """One receiver merges one sender's top-chain: catch-up sync with
        the certificate validator on the retally seam; diverged histories
        (concurrent checkpoints under a cross-shard partition) fall back
        to fork choice after every candidate certificate is pre-validated
        — an invalid or sub-quorum cert can never ride in on a fork."""
        blocks = payload["blocks"]
        top = self.top_ledgers[recv_cid]
        env = self.shards[recv_cid].env
        try:
            top.sync_from(blocks, self.public_keys, retally=self.validator)
        except InvalidBlock:
            if all(self.validator(b) == b.leader_id for b in blocks):
                top.fork_choice(blocks, self.public_keys)
        # count every cross-shard block newly present on this receiver's
        # chain, exactly once per block hash (survives later fork rewrites)
        counted = self._counted[recv_cid]
        for b in top.blocks:
            h = block_hash(b)
            if h in counted:
                continue
            counted.add(h)
            stmt = checkpoint_statement_of(b)
            if stmt is not None and stmt.committee_id != recv_cid:
                self.merged[recv_cid] += 1
                env.note("checkpoint_merged", epoch=stmt.epoch,
                         src=stmt.committee_id)
        # adopt the sender's model for aggregation iff the statement that
        # vouches for exactly these bytes made it onto our chain
        for b in top.blocks:
            stmt = checkpoint_statement_of(b)
            if (stmt is not None and stmt.committee_id == sender_cid
                    and stmt.global_model_digest == payload["digest"]):
                peer_models[recv_cid][sender_cid] = (payload["model"],
                                                     payload["data_size"])
                break

    def _aggregate_models(self, peer_models: Dict[int, Dict[int, Tuple[
            np.ndarray, float]]]) -> None:
        """Cross-committee Eq. 1: each committee folds the peer models it
        adopted into its own, weighted by data size. A committee that
        adopted nothing (isolated side of a partition) keeps its model
        bit-identical — no gratuitous float churn."""
        for com, shard in zip(self.committees, self.shards):
            peers = peer_models[com.committee_id]
            if not peers:
                continue
            own_flat = _host_flat(shard.global_params)
            own_w = float(sum(c.data_size for c in shard.clusters))
            total = np.zeros_like(own_flat, dtype=np.float64)
            weight = 0.0
            for sender in sorted(peers):
                flat, w = peers[sender]
                total += np.asarray(flat, np.float64) * w
                weight += w
            total += own_flat.astype(np.float64) * own_w
            weight += own_w
            agg = (total / weight).astype(np.float32)
            shard.global_params = shard.adapter.unflatten(
                agg, shard.global_params)
            shard.env.note("model_aggregated", epoch=self.epochs,
                           peers=sorted(peers))

    # -- the consortium verdict ----------------------------------------------
    def finalize(self, scenario_name: str, seed: int,
                 rounds_requested: int) -> Any:
        """Heal every fault, final-sync the subchains (each shard env) and
        the top-chains, and merge the per-committee reports into one
        :class:`~repro_torch.sim.report.ScenarioReport`."""
        # heal the cross bus past every partition window, then reconverge
        # the top-chains on the deterministic best (tallest, then smallest
        # head hash) — the same rule as the subchain final sync
        last_cut = max([p.end_round for p in self.cross.config.partitions]
                       + [0])
        self.cross.set_round(max(self.cross.round + 1, last_cut))
        tops = [self.top_ledgers[c.committee_id] for c in self.committees]
        best = sorted(tops, key=lambda l: (-l.height, l.head_hash))[0]
        for led in tops:
            if led is best or led.head_hash == best.head_hash:
                continue
            try:
                led.sync_from(best.blocks, self.public_keys,
                              retally=self.validator)
            except InvalidBlock:
                if all(self.validator(b) == b.leader_id
                       for b in best.blocks):
                    led.fork_choice(best.blocks, self.public_keys)
        # cross-shard safety: a height where the FINAL top-chains still
        # disagree is a violation; forks that reconverged are not
        by_height: Dict[int, set] = {}
        for led in tops:
            for h, b in enumerate(led.blocks):
                by_height.setdefault(h, set()).add(block_hash(b))
        top_violations = sum(1 for s in by_height.values() if len(s) > 1)
        sub_reports = [
            shard.env.finalize(scenario=scenario_name, seed=seed,
                               rounds_requested=rounds_requested)
            for shard in self.shards]
        return merge_consortium_report(
            scenario_name, seed, list(self.committees), sub_reports,
            rounds_requested=rounds_requested,
            checkpoints_emitted=list(self.emitted),
            checkpoints_merged=list(self.merged),
            top_heights={c.committee_id:
                         self.top_ledgers[c.committee_id].height
                         for c in self.committees},
            top_heads={c.committee_id:
                       self.top_ledgers[c.committee_id].head_hash
                       for c in self.committees},
            top_safety_violations=top_violations,
            cross_stats={k: dict(v)
                         for k, v in sorted(self.cross.stats.items())},
        )
