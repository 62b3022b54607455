"""Two-stage Stackelberg incentive mechanism (paper §5), in PyTorch.

Port of ``repro.core.incentive``. Stage 1 (leader = task publisher):
choose total reward δ maximizing

    U_tp(δ) = B − (λ δ / F − φ)²                         (Eq. 11)

Stage 2 (followers = BCFL nodes): node e_i chooses CPU frequency f_i
maximizing

    U_i(f_i) = δ f_i / (f_i + Σf_{−i}) − γ_i μ_i f_i²    (Eq. 12)

Closed forms (Thm 5.1 / 5.2): U_i is strictly concave, the Nash
equilibrium solves ∂U_i/∂f_i = 0; the publisher's optimum is δ* = F* φ / λ.

The reference's ``lax.fori_loop`` loops become Python loops and its
``vmap`` over nodes a batch dimension, all in float32 on the CPU (the
negotiation is host-side, once per task). Every loop body is a
deterministic function of its carried state, so a loop stops as soon as
an iteration leaves that state unchanged: every later iteration would
leave it unchanged too, and the result is the reference's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PublisherParams(NamedTuple):
    B: float = 500.0
    lam: float = 1.0
    phi: float = 5.0


class NodeParams(NamedTuple):
    gamma: torch.Tensor  # (N,) CPU architecture coefficients γ_i
    mu: torch.Tensor     # (N,) total CPU cycles for the task μ_i


def publisher_utility(delta: torch.Tensor, F: torch.Tensor,
                      p: PublisherParams) -> torch.Tensor:
    """Eq. 11."""
    return p.B - (p.lam * delta / F - p.phi) ** 2


def node_utility(f_i: torch.Tensor, f_rest: torch.Tensor,
                 delta: torch.Tensor, gamma_i: torch.Tensor,
                 mu_i: torch.Tensor) -> torch.Tensor:
    """Eq. 12 — f_rest is Σ f_{−i}."""
    return delta * f_i / (f_i + f_rest) - gamma_i * mu_i * f_i ** 2


def optimal_delta(F_star: torch.Tensor, p: PublisherParams) -> torch.Tensor:
    """Thm 5.2: δ* = F* φ / λ."""
    return F_star * p.phi / p.lam


def best_response(f_rest: torch.Tensor, delta: torch.Tensor,
                  gamma: torch.Tensor, mu: torch.Tensor,
                  iters: int = 60) -> torch.Tensor:
    """Solve ∂U_i/∂f_i = 0 for f_i ≥ 0 by bisection (Thm 5.1), for every
    node at once (all arguments broadcast over the node axis).

    ∂U_i/∂f_i = δ·f_rest/(f_rest+f_i)² − 2 γ_i μ_i f_i is strictly
    decreasing in f_i (U_i concave), so a sign-change bracket + bisection
    is exact.
    """
    c = 2.0 * gamma * mu

    def grad(f):
        return delta * f_rest / (f_rest + f) ** 2 - c * f

    # bracket: grad(0) = δ/f_rest > 0; find hi with grad(hi) < 0
    hi = torch.clamp(torch.sqrt(delta / torch.clamp(c, min=1e-12)), min=1.0)
    for _ in range(40):
        widened = torch.where(grad(hi) > 0, hi * 2.0, hi)
        if torch.equal(widened, hi):
            break
        hi = widened
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = grad(mid) > 0
        lo_next, hi_next = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
        if torch.equal(lo_next, lo) and torch.equal(hi_next, hi):
            break
        lo, hi = lo_next, hi_next
    return 0.5 * (lo + hi)


def best_response_iteration(delta: torch.Tensor, nodes: NodeParams,
                            f_init: torch.Tensor, iters: int = 100,
                            damping: float = 0.5) -> torch.Tensor:
    """Stage-2 Nash equilibrium f* = (f_1*, ..., f_N*) for a fixed δ."""
    f = f_init
    for _ in range(iters):
        F = torch.sum(f)
        br = best_response(F - f, delta, nodes.gamma, nodes.mu)
        f_next = damping * br + (1.0 - damping) * f
        if torch.equal(f_next, f):
            break
        f = f_next
    return f


class StackelbergSolution(NamedTuple):
    delta_star: torch.Tensor
    f_star: torch.Tensor
    F_star: torch.Tensor
    publisher_utility: torch.Tensor
    node_utilities: torch.Tensor


def stackelberg_equilibrium(nodes: NodeParams,
                            publisher: PublisherParams = PublisherParams(),
                            outer_iters: int = 20, inner_iters: int = 60,
                            ) -> StackelbergSolution:
    """Backward-induction equilibrium: alternate δ ← δ*(F), f ← Nash(δ)."""
    nodes = NodeParams(torch.as_tensor(nodes.gamma, dtype=torch.float32),
                       torch.as_tensor(nodes.mu, dtype=torch.float32))
    n = nodes.gamma.shape[0]
    f = torch.full((n,), 10.0, dtype=torch.float32)
    delta = torch.tensor(100.0, dtype=torch.float32)
    for _ in range(outer_iters):
        f_next = best_response_iteration(delta, nodes, f, iters=inner_iters)
        delta_next = optimal_delta(torch.sum(f_next), publisher)
        if torch.equal(f_next, f) and torch.equal(delta_next, delta):
            break
        f, delta = f_next, delta_next
    F = torch.sum(f)
    u_nodes = node_utility(f, F - f, delta, nodes.gamma, nodes.mu)
    return StackelbergSolution(delta, f, F,
                               publisher_utility(delta, F, publisher),
                               u_nodes)
