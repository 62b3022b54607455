"""Grouped expert products of the dropless MoE layer (``models.moe``).

No kernel of the JAX package corresponds: its expert layer is the
capacity dispatch, whose (E, C, D) buffer goes through batched matrix
products over all E experts, padding and dropped tokens included. The
dropless layer of an expert-parallel chip instead computes every
assignment to the experts it holds, and only those: a data-dependent
number of rows for each expert, which static shapes can only bound.

:func:`grouped_mm` is one grouped product. The rows of ``a`` lie in
contiguous groups that end at the device offsets ``offs`` (G,) int32,
and each group is multiplied by its own matrix:

* ``a`` (M, K) × ``b`` (G, K, N) → (M, N): the forward products
  X·W_gate[e], X·W_up[e], H·W_down[e], and the backward's dX-type
  products with ``b`` a transposed view;
* ``a`` (K, M) × ``b`` (M, N) → (G, K, N): the backward's dW-type
  products, each group's rows summed over (an empty group gives zeros).

Rows past the last offset are not computed; their output is undefined
(the plain version fills them with NaN, so that a caller who reads one
fails its tests). On the card the body is ``torch._grouped_mm`` (a
grouped GEMM on the tensor cores, bfloat16 with float32 accumulation,
the group sizes read on the device: no synchronize); on the CPU the
plain per-group loop. Each card launch is counted in ``launches``, and
its rows (a view of ``offs[-1]``, no kernel) are kept on the device,
summed every 1,024 launches and when :func:`routed_rows` reads them.

:func:`expert_rows` is the expert FFN of every (token, choice)
assignment of a chip that holds experts [0, E): y[t, j] =
(silu(x_t·W_gate[e]) ⊙ x_t·W_up[e])·W_down[e] for e = idx[t, j] < E,
and zeros where the choice is an expert held elsewhere. A stable sort of
the choices puts the held ones first, grouped by expert, into a buffer
of T·min(k, E) rows (static: the most a chip can be sent); three
grouped products follow. Its backward recomputes the two input products
(cheaper than keeping them) and makes eight: dH, dX of the gate and up
products, their three dW, and the forward pair again. Under
``torch.func.vmap`` (the PoFEL trainer's clusters) both ops fold the
clusters into the groups, so each product is one launch for all of
them: C clusters × E experts make C·E groups, expert-major, and the
clusters' (E, C) matrices are gathered into one stack of C·E.

The fold records each call's held and absent assignments and its tokens
in the active recorder (``repro_torch.obs``): ``moe_rows_held``,
``moe_rows_absent`` (device tensors, added at the recorder's
``resolve``) and ``moe_tokens``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._dtensor import refuse_device
from repro_torch.kernels._fold import front, is_wrapped
from repro_torch.obs import get_recorder

DTYPES = (torch.bfloat16, torch.float32)

launches = 0          # grouped products launched on the card
_rows: dict = {}      # device → its launches' rows, (1,) tensors
_FOLD = 1024          # pending rows summed into one tensor at this many


def _sum(rows: list) -> torch.Tensor:
    return torch.cat(rows).sum(0, keepdim=True, dtype=torch.int64)


def routed_rows() -> int:
    """Rows the card's grouped products computed since the last reset
    (each launch's ``offs[-1]``). Reading them waits for the device;
    with no launch there is nothing to read and no wait."""
    return sum(int(_sum(rows)) for rows in _rows.values())


def reset_counts() -> None:
    global launches
    launches = 0
    _rows.clear()


def _count(offs: torch.Tensor) -> None:
    global launches
    launches += 1
    rows = _rows.setdefault(offs.device, [])
    rows.append(offs[-1:])
    if len(rows) >= _FOLD:
        rows[:] = [_sum(rows)]


def grouped_mm_ref(a: torch.Tensor, b: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`grouped_mm`: a loop over the groups,
    each product summed in float32 and rounded to a's dtype once; rows
    past the last offset NaN."""
    ends = [int(e) for e in offs.tolist()]
    starts = [0] + ends[:-1]
    f32 = torch.float32
    if b.dim() == 3:
        out = torch.full((a.shape[0], b.shape[-1]), float("nan"),
                         dtype=a.dtype, device=a.device)
        for g, (s, e) in enumerate(zip(starts, ends)):
            out[s:e] = (a[s:e].to(f32) @ b[g].to(f32)).to(a.dtype)
        return out
    out = torch.zeros((len(ends), a.shape[0], b.shape[1]), dtype=a.dtype,
                      device=a.device)
    for g, (s, e) in enumerate(zip(starts, ends)):
        out[g] = (a[:, s:e].to(f32) @ b[s:e].to(f32)).to(a.dtype)
    return out


def grouped_mm(a: torch.Tensor, b: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """(M, K) × (G, K, N) → (M, N), or (K, M) × (M, N) → (G, K, N), the
    groups of rows ending at ``offs`` (G,) int32 on a's device."""
    if b.dim() not in (2, 3) or a.dim() != 2 or offs.dim() != 1:
        raise ValueError(f"grouped_mm takes (M, K) x (G, K, N) or (K, M) x "
                         f"(M, N); got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"grouped_mm takes a and b of one dtype in {DTYPES}; "
                        f"got {a.dtype}, {b.dtype}")
    if a.device.type == "cpu":
        return grouped_mm_ref(a, b, offs)
    if a.device.type != "cuda":
        raise ValueError(f"no grouped product for {a.device}")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"the card's grouped product takes bfloat16; got "
                        f"{a.dtype}")
    offs = offs.to(torch.int32).contiguous()
    out = torch._grouped_mm(a, b, offs)
    _count(offs)
    return out


# ---------------------------------------------------------------------------
# The expert FFN of every assignment, as ops whose vmap rules fold clusters
# ---------------------------------------------------------------------------

class _Plan(NamedTuple):
    """Where each assignment of a folded call goes. ``rows`` (M,): the
    assignment (flat (c, t, j)) in each buffer row, the held ones first
    and grouped; ``tok`` (M,): its token in the (C·T, D) rows; ``pos``
    (N,): each assignment's buffer row (``held`` says which are real);
    ``ends`` (E·C,) int32: the ends of the (expert, cluster) groups."""
    rows: torch.Tensor
    tok: torch.Tensor
    pos: torch.Tensor
    held: torch.Tensor
    ends: torch.Tensor


def _plan(idx: torch.Tensor, E: int) -> _Plan:
    C, T, k = idx.shape
    N, dev = C * T * k, idx.device
    e = idx.reshape(C, T * k).to(torch.int64)
    held = e < E
    c = torch.arange(C, device=dev)[:, None]
    key = torch.where(held, e * C + c, E * C).reshape(-1)
    order = torch.argsort(key, stable=True)
    M = C * T * min(k, E)
    rows = order[:M]
    counts = torch.zeros(E * C + 1, dtype=torch.int64, device=dev
                         ).scatter_add_(0, key, torch.ones_like(key))
    ends = torch.cumsum(counts[:E * C], 0).to(torch.int32)
    slot = torch.arange(M, device=dev)
    pos = torch.zeros(N, dtype=torch.int64, device=dev).scatter(0, rows, slot)
    return _Plan(rows, rows // k, pos, held.reshape(-1), ends)


def _stack(ws: tuple, C: int) -> tuple:
    """Each (C or 1, E, ·, ·) weight as the (E·C, ·, ·) stack of the
    (expert, cluster) groups."""
    return tuple(w.expand(C, *w.shape[1:]).transpose(0, 1).reshape(
        C * w.shape[1], *w.shape[2:]) for w in ws)


def _per_cluster(dw: torch.Tensor, C: int, E: int) -> torch.Tensor:
    """A dW-type product's (E·C, ·, ·) groups as (C, E, ·, ·)."""
    return dw.view(E, C, *dw.shape[1:]).transpose(0, 1)


def _gate_up(xp, plan: _Plan, wg, wu):
    return grouped_mm(xp, wg, plan.ends), grouped_mm(xp, wu, plan.ends)


def _to_assignments(rows_out: torch.Tensor, plan: _Plan) -> torch.Tensor:
    """Buffer rows (M, D) → each assignment's row (N, D), zero where its
    expert is held elsewhere (no row past the groups is read out)."""
    out = rows_out.index_select(0, plan.pos)
    return out.masked_fill_(~plan.held[:, None], 0)


def _record(plan: _Plan, C: int, T: int, k: int) -> None:
    rec = get_recorder()
    if not rec.enabled:
        return
    n = plan.ends[-1].to(torch.int64)
    rec.device_counter("moe_rows_held", n)
    rec.device_counter("moe_rows_absent", C * T * k - n)
    rec.counter("moe_tokens", C * T)


def expert_rows_core(x, idx, wg, wu, wd) -> torch.Tensor:
    """x (C, T, D), idx (C, T, k), weights (C or 1, E, ·, ·) → y (C, T,
    k, D)."""
    C, T, D = x.shape
    k, E = idx.shape[-1], wg.shape[1]
    wg, wu, wd = _stack((wg, wu, wd), C)
    plan = _plan(idx, E)
    _record(plan, C, T, k)
    xp = x.reshape(C * T, D).index_select(0, plan.tok)
    g, u = _gate_up(xp, plan, wg, wu)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    y = grouped_mm(h, wd, plan.ends)
    return _to_assignments(y, plan).view(C, T, k, D)


def expert_rows_backward_core(dy, x, idx, wg, wu, wd) -> tuple:
    """(dx (C, T, D), dW_gate, dW_up, dW_down each (C, E, ·, ·)) of
    :func:`expert_rows_core` for the output gradient ``dy`` (C, T, k,
    D)."""
    C, T, D = x.shape
    k, E = idx.shape[-1], wg.shape[1]
    wg, wu, wd = _stack((wg, wu, wd), C)
    plan = _plan(idx, E)
    f32 = torch.float32
    xp = x.reshape(C * T, D).index_select(0, plan.tok)
    g, u = _gate_up(xp, plan, wg, wu)
    dyp = dy.reshape(C * T * k, D).index_select(0, plan.rows)
    dh = grouped_mm(dyp, wd.transpose(-2, -1), plan.ends)
    g32 = g.to(f32)
    sig = torch.sigmoid(g32)
    act = (g32 * sig).to(x.dtype)
    dwd = grouped_mm((act * u).t(), dyp, plan.ends)
    du = dh * act
    dg = ((dh * u).to(f32) * sig * (1.0 + g32 * (1.0 - sig))).to(x.dtype)
    del g, g32, sig, act, dh, u
    dxp = grouped_mm(dg, wg.transpose(-2, -1), plan.ends)
    dxp += grouped_mm(du, wu.transpose(-2, -1), plan.ends)
    dwg = grouped_mm(xp.t(), dg, plan.ends)
    dwu = grouped_mm(xp.t(), du, plan.ends)
    dx = _to_assignments(dxp, plan).view(C * T, k, D).sum(
        1, dtype=f32).to(x.dtype).view(C, T, D)
    return (dx,) + tuple(_per_cluster(w, C, E) for w in (dwg, dwu, dwd))


@torch.library.custom_op("repro_torch::moe_expert_rows", mutates_args=(),
                         device_types=("cpu", "cuda"))
def expert_rows_op(x: torch.Tensor, idx: torch.Tensor, wg: torch.Tensor,
                   wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """:func:`expert_rows_core` (grouped products on the card, the plain
    loop on the CPU)."""
    return expert_rows_core(x, idx, wg, wu, wd)


@expert_rows_op.register_fake
def _(x, idx, wg, wu, wd):
    return x.new_empty((*idx.shape, x.shape[-1]))


@torch.library.custom_op("repro_torch::moe_expert_rows_backward",
                         mutates_args=(), device_types=("cpu", "cuda"))
def expert_rows_backward_op(dy: torch.Tensor, x: torch.Tensor,
                            idx: torch.Tensor, wg: torch.Tensor,
                            wu: torch.Tensor, wd: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """:func:`expert_rows_backward_core`."""
    return expert_rows_backward_core(dy, x, idx, wg, wu, wd)


@expert_rows_backward_op.register_fake
def _(dy, x, idx, wg, wu, wd):
    C = x.shape[0]
    return (x.new_empty(x.shape),) + tuple(
        w.new_empty((C,) + tuple(w.shape[1:])) for w in (wg, wu, wd))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy):
    x, idx, wg, wu, wd = ctx.saved_tensors
    dx, dwg, dwu, dwd = expert_rows_backward_op(dy, x, idx, wg, wu, wd)
    return dx, None, dwg, dwu, dwd


expert_rows_op.register_autograd(_backward, setup_context=_setup_context)


def _fold(t, dim, V):
    """The vmapped axis folded into the op's leading cluster axis."""
    t = front(t, dim, V)
    return t.reshape(V * t.shape[1], *t.shape[2:])


def _fold_all(args, in_dims, V):
    return tuple(_fold(t, d, V) for t, d in zip(args, in_dims))


def _unfold(t, V):
    return t.view(V, t.shape[0] // V, *t.shape[1:])


def _fwd_vmap(info, in_dims, x, idx, wg, wu, wd):
    V = info.batch_size
    y = expert_rows_core(*_fold_all((x, idx, wg, wu, wd), in_dims, V))
    return _unfold(y, V), 0


def _bwd_vmap(info, in_dims, dy, x, idx, wg, wu, wd):
    V = info.batch_size
    grads = expert_rows_backward_core(*_fold_all((dy, x, idx, wg, wu, wd),
                                                 in_dims, V))
    return tuple(_unfold(g, V) for g in grads), (0, 0, 0, 0)


expert_rows_op.register_vmap(_fwd_vmap)
expert_rows_backward_op.register_vmap(_bwd_vmap)


class _ExpertRows(torch.autograd.Function):
    """The op under ``torch.func`` (whose transforms do not take a custom
    op's autograd): the forward and backward ops, whose vmap rules fold
    the clusters into the groups."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, idx, wg, wu, wd):
        return expert_rows_op(x, idx, wg, wu, wd)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, idx, wg, wu, wd = ctx.saved_tensors
        dx, dwg, dwu, dwd = _ExpertRowsBackward.apply(dy, x, idx, wg, wu,
                                                      wd)
        return dx, None, dwg, dwu, dwd


class _ExpertRowsBackward(torch.autograd.Function):
    """The backward op under ``torch.func``; it has no gradient of its
    own."""

    generate_vmap_rule = True

    @staticmethod
    def forward(dy, x, idx, wg, wu, wd):
        return expert_rows_backward_op(dy, x, idx, wg, wu, wd)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the expert rows' backward has no "
                                  "gradient")


def _check(x, idx, wg, wu, wd) -> None:
    if x.dim() != 2 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"expert_rows needs x (T, D) and idx (T, k); got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}")
    E, D, Fe = wg.shape
    if tuple(wu.shape) != (E, D, Fe) or tuple(wd.shape) != (E, Fe, D) \
            or x.shape[1] != D:
        raise ValueError(f"expert_rows needs w_gate, w_up (E, D, F) and "
                         f"w_down (E, F, D) with D = {x.shape[1]}; got "
                         f"{tuple(wg.shape)}, {tuple(wu.shape)}, "
                         f"{tuple(wd.shape)}")
    if idx.dtype.is_floating_point:
        raise TypeError(f"idx must be integer; got {idx.dtype}")
    if any(w.dtype != x.dtype for w in (wg, wu, wd)):
        raise TypeError(f"expert_rows takes weights in x's dtype {x.dtype}")


def expert_rows(x: torch.Tensor, idx: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """x (T, D), the routed experts ``idx`` (T, k) of a router over any
    number of experts, the held experts' ``w_gate``, ``w_up`` (E, D, F)
    and ``w_down`` (E, F, D) → (T, k, D): each choice's expert FFN of
    its token, zero for a choice ≥ E. Differentiable in x and the
    weights."""
    _check(x, idx, w_gate, w_up, w_down)
    refuse_device(x, "grouped expert product")
    args = tuple(t[None] for t in (x, idx, w_gate, w_up, w_down))
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w_gate, w_up, w_down))
    if grad and is_wrapped(x, w_gate, w_up, w_down):
        return _ExpertRows.apply(*args)[0]
    return expert_rows_op(*args)[0]
