"""BTSV — Bayesian Truth Serum-based Voting (paper §4.3, Alg. 4), in PyTorch.

Port of ``repro.core.btsv``. Inputs per round k: the vote matrix A
(A[i, j] = 1 iff e_i voted for e_j) and the prediction matrix P
(P[i, j] = p_j^i, each row sums to 1).

  x̄_j   = mean_i A[i, j]                                     (Eq. 3)
  ȳ_j   = exp(mean_i log P[i, j])  (geometric mean)          (Eq. 4)
  info_i = Σ_j A[i, j] log(x̄_j / ȳ_j)                        (Eq. 5)
  pred_i = α Σ_j x̄_j log(P[i, j] / x̄_j)                      (Eq. 6)
  score_i = info_i + pred_i, α = 1 (zero-sum)                 (Eq. 7)
  CHS_i(k) = Σ_{max(0,k-c)}^{k} score_i                       (Eq. 8)
  WV_i = β / (1 + exp(−θ·CHS_i − ε))                          (Eq. 9)
  advotes_j = Σ_i WV_i A[i, j]                                (Eq. 10)
  leader = argmax_j advotes_j

This is N×N host math for the vote-tally contract: it runs in float32 on
whatever device its inputs are on, and the contract keeps it on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BTSVConfig(NamedTuple):
    alpha: float = 1.0    # prediction-score weight (zero-sum at 1.0)
    beta: float = 1.3     # WV upper limit
    theta: float = 0.4    # WV gradient vs CHS
    epsilon: float = 1.2  # WV(CHS=0) ≈ 1
    history: int = 20     # c — CHS window length
    eps: float = 1e-12    # numerical floor inside logs


class BTSVResult(NamedTuple):
    leader: torch.Tensor     # () int64 — e*(k)
    scores: torch.Tensor     # (N,) — score^i(k)
    weights: torch.Tensor    # (N,) — WV^i(k)
    advotes: torch.Tensor    # (N,) — adjusted tallied votes
    chs: torch.Tensor        # (N,) — cumulative historical score used


def votes_to_matrix(votes: torch.Tensor, n: int) -> torch.Tensor:
    """E_best(k) (N,) int votes → (N, N) one-hot matrix A (Alg. 4 lines
    1-8). A vote of -1 (abstention) one-hots to a zero row."""
    cols = torch.arange(n, device=votes.device)
    return (votes[:, None] == cols[None, :]).to(torch.float32)


def bts_scores(A: torch.Tensor, P: torch.Tensor,
               cfg: BTSVConfig = BTSVConfig(),
               present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 3-7 — per-node BTS score for one round.

    ``present`` (an (N,) 0/1 mask, default all-present) restricts the
    population means to the voters whose submissions actually arrived —
    a fault-dropped vote is neutral: excluded from x̄/ȳ and scored 0.
    """
    if present is None:
        present = torch.ones(A.shape[0], dtype=torch.float32,
                             device=A.device)
    m = torch.clamp(torch.sum(present), min=1.0)
    x_bar = torch.sum(A * present[:, None], dim=0) / m             # (N,)
    log_p = torch.log(torch.clamp(P, min=cfg.eps))
    y_bar = torch.exp(torch.sum(present[:, None] * log_p, dim=0) / m)
    log_x = torch.log(torch.clamp(x_bar, min=cfg.eps))
    log_ratio = log_x - torch.log(torch.clamp(y_bar, min=cfg.eps))
    info = A @ log_ratio                                           # (N,)
    # prediction score: α Σ_j x̄_j log(p_j^i / x̄_j); terms with x̄_j = 0 vanish
    terms = torch.where(x_bar > 0, x_bar * (log_p - log_x),
                        torch.zeros((), dtype=log_p.dtype,
                                    device=log_p.device))
    pred = cfg.alpha * torch.sum(terms, dim=1)
    return (info + pred) * present


def vote_weights(chs: torch.Tensor,
                 cfg: BTSVConfig = BTSVConfig()) -> torch.Tensor:
    """Eq. 9 — sigmoid mapping of cumulative score to vote weight."""
    return cfg.beta / (1.0 + torch.exp(-cfg.theta * chs - cfg.epsilon))


def btsv_round(votes: torch.Tensor, P: torch.Tensor,
               score_history: torch.Tensor,
               cfg: BTSVConfig = BTSVConfig(),
               present: Optional[torch.Tensor] = None,
               ) -> tuple[BTSVResult, torch.Tensor]:
    """One smart-contract tally (Alg. 4).

    ``score_history`` is a (c, N) rolling buffer of past scores (zeros
    when unused); it is shifted and returned updated, and the input is
    left untouched. ``present`` masks out voters whose submissions never
    landed (see :func:`bts_scores`).
    """
    n = P.shape[0]
    A = votes_to_matrix(votes, n)
    scores = bts_scores(A, P, cfg, present=present)
    chs = torch.sum(score_history, dim=0) + scores                # Eq. 8
    wv = vote_weights(chs, cfg)
    advotes = wv @ A                                               # Eq. 10
    leader = torch.argmax(advotes)
    new_history = torch.cat([score_history[1:], scores[None]], dim=0)
    return BTSVResult(leader, scores, wv, advotes, chs), new_history


def init_history(n_nodes: int, cfg: BTSVConfig = BTSVConfig()) -> torch.Tensor:
    return torch.zeros((cfg.history, n_nodes), dtype=torch.float32)
