"""Task publication + incentive workflow (paper §3.1 steps 1-2, §5).

1. Task Publication — a model owner publishes a ``LearningTask`` (identity,
   task description, budget, termination criteria) to the BCFL network;
   every node evaluates whether to accept (utility at the Stackelberg
   equilibrium must be positive — the participation constraint).
2. Incentive Mechanism — the two-stage Stackelberg game between publisher
   and participating nodes fixes the total FEL reward δ* and each node's
   CPU-frequency investment f_i* before training starts.
3. During training, each block's leader earns the fixed block reward, and
   the FEL reward is split across clusters ∝ f_i* (edge servers then
   redistribute to clients by CPU cycles — the paper's example rule).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import crypto
from repro_torch.core.incentive import (NodeParams, PublisherParams,
                                        StackelbergSolution,
                                        stackelberg_equilibrium)


@dataclass(frozen=True)
class LearningTask:
    """The on-chain task announcement (paper: 'user identity and learning
    task description ... recorded on the blockchain')."""

    task_id: str
    publisher_id: str
    description: str
    target_loss: float = 0.0          # terminate when global loss ≤ target
    max_rounds: int = 100             # or when the time budget expires
    block_reward: float = 10.0        # fixed reward to each round's leader
    publisher: PublisherParams = field(default_factory=PublisherParams)

    def digest(self) -> str:
        body = json.dumps({
            "task_id": self.task_id, "publisher": self.publisher_id,
            "description": self.description, "target_loss": self.target_loss,
            "max_rounds": self.max_rounds, "block_reward": self.block_reward,
        }, sort_keys=True).encode()
        return crypto.sha256_digest(body).hex()


@dataclass
class TaskAgreement:
    """Result of publication + the Stackelberg stage: who participates and
    at what price."""

    task: LearningTask
    participants: List[int]
    delta_star: float                 # total FEL reward per round (Stage 1)
    f_star: Dict[int, float]          # per-node CPU investment (Stage 2)
    node_utilities: Dict[int, float]


def negotiate_task(task: LearningTask, node_ids: List[int],
                   gamma: Dict[int, float], mu: Dict[int, float],
                   ) -> TaskAgreement:
    """Run publication + the two-stage game.

    Nodes whose equilibrium utility is negative decline (participation
    constraint); the game is re-solved among the remainder until stable.
    """
    active = list(node_ids)
    while active:
        nodes = NodeParams(
            torch.tensor([gamma[i] for i in active], dtype=torch.float32),
            torch.tensor([mu[i] for i in active], dtype=torch.float32))
        sol: StackelbergSolution = stackelberg_equilibrium(
            nodes, task.publisher)
        utils = sol.node_utilities.numpy()
        if np.all(utils >= -1e-6) or len(active) == 1:
            return TaskAgreement(
                task=task,
                participants=active,
                delta_star=float(sol.delta_star),
                f_star={i: float(f)
                        for i, f in zip(active, sol.f_star.numpy())},
                node_utilities={i: float(u) for i, u in zip(active, utils)},
            )
        # drop the worst-off node and re-negotiate
        active = [i for i, u in zip(active, utils) if u > utils.min()]
    raise ValueError("no participants accepted the task")


@dataclass
class RewardLedger:
    """Accumulated payouts (block rewards to leaders + FEL rewards split
    ∝ f_i*) — the fairness bookkeeping of §7.3/§7.5."""

    agreement: TaskAgreement
    block_rewards: Dict[int, float] = field(default_factory=dict)
    fel_rewards: Dict[int, float] = field(default_factory=dict)

    def settle_round(self, leader_id: int) -> None:
        t = self.agreement
        self.block_rewards[leader_id] = (
            self.block_rewards.get(leader_id, 0.0) + t.task.block_reward)
        F = sum(t.f_star.values())
        for i, f in t.f_star.items():
            self.fel_rewards[i] = (self.fel_rewards.get(i, 0.0)
                                   + t.delta_star * f / F)

    def totals(self) -> Dict[int, float]:
        ids = set(self.block_rewards) | set(self.fel_rewards)
        return {i: self.block_rewards.get(i, 0.0) + self.fel_rewards.get(i, 0.0)
                for i in sorted(ids)}

    def client_split(self, node_id: int, client_cycles: Dict[int, float],
                     ) -> Dict[int, float]:
        """Edge server → clients redistribution ∝ CPU cycles (paper §5:
        'an example distribution rule could be based on the CPU cycle
        frequency spent by each end device')."""
        total = sum(client_cycles.values())
        pot = self.fel_rewards.get(node_id, 0.0)
        return {c: pot * cyc / total for c, cyc in client_cycles.items()}
