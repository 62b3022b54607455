"""WKV6 recurrence — the RWKV-6 time-mixing hot spot, forward and backward.

Port of ``repro.kernels.ops.wkv6_recurrence`` (the Pallas ``wkv6``
kernel). Per batch b and head h, with a K × K float32 state S:

    o_t = r_t · (S + diag(u) · k_tᵀ v_t)
    S  ← diag(w_t) · S + k_tᵀ v_t

For a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/wkv6.cu`` (each block one group of Jc state columns of one
(b, h), each lane a tile of K/G rows by C columns of the state, T time
steps staged in shared memory a chunk, r/k/v/w read in place through
their strides; one step (S = 1) in a kernel of its own with the same
order of sums — the design note is in the source) and counts one launch.
:func:`launch_shape` is the kernels' geometry, a function of K alone; the
kernel refuses another. For a CPU tensor it runs
:func:`repro_torch.kernels.ref.wkv6_recurrence_ref`. Inputs are float32
only (the model casts to float32 first) and K is 8, 16, 32 or 64.

When a gradient is wanted (grad mode on and an input that requires it)
the op is a ``torch.autograd.Function``: on the card the forward kernel
also writes the state before every 16-step chunk, and the backward is a
kernel of its own (:func:`wkv6_backward`: a thread-block cluster per
(b, h), one block per group of state columns, recomputes each chunk's
states from there and walks t downward, the blocks adding their row sums
through distributed shared memory in rank order; then du's ordered fold
over b; :func:`backward_shape` is its geometry), counted in
``backward_launches``; on the CPU the forward and backward are the
plain versions (``ref.wkv6_backward_ref``). Serving never takes that
route, so its launches and kernels are unchanged. Under
``torch.func.vmap`` (the batched FEL engine) both Functions fold the
vmapped axis into the heads and launch once for the whole batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dtensor import ensure_rules, refuse_device
from repro_torch.kernels._fold import front, is_wrapped
from repro_torch.kernels.ref import wkv6_backward_ref, wkv6_recurrence_ref

HEAD_SIZES = (8, 16, 32, 64)
CHUNK = 16       # steps between the states the training forward saves

launches = 0            # forward kernel launches
backward_launches = 0   # backward calls (each the walk and du's fold)

# K -> state columns a block of the backward (csrc/wkv6.cu: Bwd<K>::JB)
BACKWARD_COLUMNS = {64: 16, 32: 16, 16: 16, 8: 8}
# K -> columns a lane of the backward (csrc/wkv6.cu: Bwd<K>::CT)
BACKWARD_LANE_COLUMNS = {64: 4, 32: 4, 16: 4, 8: 2}

# K -> (Jc state columns a block, G lanes a column group, C columns a
# lane, T steps a chunk, ring stages): csrc/wkv6.cu's Geo<K>, which
# refuses any other
_GEOMETRY = {64: (64, 8, 8, 16, 3), 32: (32, 4, 4, 16, 2),
             16: (16, 4, 2, 16, 2), 8: (8, 4, 1, 16, 2)}


class LaunchShape(NamedTuple):
    blocks: int         # B·H·(K / jc)
    threads: int        # (jc / c)·g
    jc: int             # state columns a block
    g: int              # lanes a column group; each holds K / g rows
    c: int              # columns a lane
    t: int              # time steps a staged chunk
    stages: int         # chunks in the copy ring
    smem_bytes: int     # dynamic shared memory a block
    step_blocks: int    # S = 1 (decode) kernel: B·H blocks
    step_threads: int   # of K·G threads, no staging


def launch_shape(B: int, H: int, K: int) -> LaunchShape:
    """The kernels' grids, blocks and shared memory for (B, H, K): the
    chunked kernel's for S > 1, the one-step kernel's for S = 1. Jc, G, C,
    T and the stages depend on K alone, and with them the order of every
    sum (the same in both kernels), so B, H and S change the grid and never
    the bits of a (b, h)."""
    if K not in _GEOMETRY:
        raise ValueError(f"wkv6_recurrence takes K in {HEAD_SIZES}; got {K}")
    jc, g, c, t, stages = _GEOMETRY[K]
    row = K + ((K - 1) >> 5) * 4          # r/k/w row, 4 floats pad per 32
    floats = stages * t * (3 * row + jc) + t * jc + t + K
    return LaunchShape(B * H * (K // jc), (jc // c) * g, jc, g, c, t, stages,
                       4 * floats, B * H, K * g)


class BackwardShape(NamedTuple):
    blocks: int         # B·H·(K / jb)
    cluster: int        # blocks of a cluster: the K / jb column groups
    threads: int        # K·(jb / ct): a row's jb / ct lanes
    jb: int             # state columns a block
    ct: int             # columns a lane
    fold_rows: int      # rows whose sums each cluster rank adds up
    smem_bytes: int     # dynamic shared memory a block


def backward_shape(B: int, H: int, K: int) -> BackwardShape:
    """The backward walk's grid, clusters and shared memory for (B, H, K)
    (csrc/wkv6.cu: BwdLayout<K>). Its order of sums is a function of K
    alone; B and H only scale the grid."""
    if K not in BACKWARD_COLUMNS:
        raise ValueError(f"wkv6_backward takes K in {HEAD_SIZES}; got {K}")
    jb, ct = BACKWARD_COLUMNS[K], BACKWARD_LANE_COLUMNS[K]
    ncb, threads, t = K // jb, K * (jb // ct), CHUNK
    floats = (2 * (3 * t * K + 2 * t * jb) + (t // 2) * K * jb
              + 2 * (3 * t * K + t) + t * (threads // 32) * jb
              + t * (K // ncb) + K)
    return BackwardShape(B * H * ncb, ncb, threads, jb, ct, K // ncb,
                         4 * floats)


def copy_width(ptrs, strides, shape) -> int:
    """Floats per cp.async copy of r/k/v/w: 4 (16 bytes) where every base
    address and every used (b, s, h) stride is a multiple of 16 bytes, else
    1. The stride of a dim of extent 1 is never used."""
    used = [st for st, n in zip(strides[:3], shape[:3]) if n > 1]
    if all(p % 16 == 0 for p in ptrs) and all(st % 4 == 0 for st in used):
        return 4
    return 1


def _check(r, k, v, w, u, s0) -> None:
    if r.ndim != 4:
        raise ValueError(f"wkv6_recurrence needs r, k, v, w of shape "
                         f"(B, S, H, K); got r {tuple(r.shape)}")
    B, S, H, K = r.shape
    want = {"k": (k, r.shape), "v": (v, r.shape), "w": (w, r.shape),
            "u": (u, (H, K)), "s0": (s0, (B, H, K, K))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6_recurrence: {name} has shape "
                             f"{tuple(t.shape)}; r {tuple(r.shape)} needs "
                             f"{tuple(shape)}")
    if min(B, S, H) < 1:
        raise ValueError(f"wkv6_recurrence needs B, S, H >= 1; got "
                         f"{tuple(r.shape)}")
    if K not in HEAD_SIZES:
        raise ValueError(f"wkv6_recurrence takes K in {HEAD_SIZES}; got {K}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6_recurrence takes float32 only; {name} is "
                            f"{t.dtype}")
        if t.device != r.device:
            raise ValueError(f"r is on {r.device} but {name} is on "
                             f"{t.device}")


def _launch_checks(r, k, v, w, u, s0) -> tuple:
    """The kernels' layout requirements; returns r's strides."""
    strides = r.stride()
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.stride() != strides:
            raise ValueError(f"wkv6 kernel needs r, k, v, w with one set of "
                             f"strides; r has {strides}, {name} "
                             f"{t.stride()}")
    if strides[3] != 1:
        raise ValueError(f"wkv6 kernel needs a unit stride over K; got "
                         f"strides {strides}")
    if not (u.is_contiguous() and s0.is_contiguous()):
        raise ValueError("wkv6 kernel needs contiguous u and s0")
    if s0.data_ptr() % 16:
        raise ValueError("wkv6 kernel needs s0 aligned to 16 bytes")
    return strides


def _forward(r, k, v, w, u, s0, save: bool):
    """(o, final state, the saved chunk states or None)."""
    B, S, H, K = r.shape
    if r.device.type == "cpu":
        return (*wkv6_recurrence_ref(r, k, v, w, u, s0), None)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for {r.device}")
    strides = _launch_checks(r, k, v, w, u, s0)
    global launches
    fn = _build.entry_point("wkv6")
    geo = launch_shape(B, H, K)
    vec = copy_width([t.data_ptr() for t in (r, k, v, w)], strides, r.shape)
    o = torch.empty((B, S, H, K), device=r.device, dtype=torch.float32)
    s_fin = torch.empty((B, H, K, K), device=r.device, dtype=torch.float32)
    ckpt = (torch.empty((B, H, -(-S // CHUNK), K, K), device=r.device,
                        dtype=torch.float32) if save else None)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 strides[0], strides[1], strides[2], u.data_ptr(),
                 s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(),
                 0 if ckpt is None else ckpt.data_ptr(), B, S, H, K,
                 vec, geo.jc, geo.g, geo.c, geo.t, geo.stages, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    return o, s_fin, ckpt


def wkv6_backward(r, k, v, w, u, s0, d_o, d_state, ckpt=None):
    """The gradient of :func:`wkv6_recurrence`: (dr, dk, dv, dw, du, ds0)
    in float32 for d_o (B, S, H, K) and d_state (B, H, K, K; None is
    zeros). On the card ``ckpt`` is what the training forward saved; on
    the CPU it is not used and the plain version runs."""
    B, S, H, K = r.shape
    if r.device.type == "cpu":
        return wkv6_backward_ref(r, k, v, w, u, s0, d_o, d_state)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for {r.device}")
    strides = _launch_checks(r, k, v, w, u, s0)
    if ckpt is None or tuple(ckpt.shape) != (B, H, -(-S // CHUNK), K, K):
        raise ValueError("wkv6 backward kernel needs the chunk states of "
                         "the training forward")
    if d_o.shape != r.shape or d_o.dtype != torch.float32 \
            or d_o.stride(3) != 1:
        raise ValueError(f"wkv6 backward kernel needs a float32 d_o of "
                         f"shape {tuple(r.shape)} with a unit stride over "
                         f"K; got {tuple(d_o.shape)} {d_o.dtype} strides "
                         f"{d_o.stride()}")
    dev = r.device
    d_state = (torch.zeros((B, H, K, K), device=dev, dtype=torch.float32)
               if d_state is None else
               d_state.to(torch.float32).contiguous())
    if d_state.data_ptr() % 16:
        d_state = d_state.clone()
    global backward_launches
    fn = _build.entry_point("wkv6_backward")
    geo = backward_shape(B, H, K)
    vec = min(copy_width([t.data_ptr() for t in (r, k, v, w)], strides,
                         r.shape),
              copy_width([d_o.data_ptr()], d_o.stride(), d_o.shape))

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    dr, dk, dv, dw = (empty(B, S, H, K) for _ in range(4))
    du, ds0, du_part = empty(H, K), empty(B, H, K, K), empty(B, H, K)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 *strides[:3], u.data_ptr(), ckpt.data_ptr(),
                 d_o.data_ptr(), *d_o.stride()[:3], d_state.data_ptr(),
                 du_part.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ds0.data_ptr(),
                 B, S, H, K, vec, geo.jb, geo.ct, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 backward kernel launch failed: CUDA "
                           f"error {err}")
    backward_launches += 1
    return dr, dk, dv, dw, du, ds0


def _fold(t, dim, V):
    """(V, B, S, H, K) → (B, S, V·H, K), contiguous: the vmapped axis
    becomes part of the heads (each batch member's u is its own)."""
    t = front(t, dim, V)
    V, B, S, H, K = t.shape
    return t.permute(1, 2, 0, 3, 4).reshape(B, S, V * H, K).contiguous()


def _fold_state(t, dim, V):
    """(V, B, H, ...) → (B, V·H, ...), contiguous."""
    t = front(t, dim, V)
    return t.transpose(0, 1).reshape(t.shape[1], V * t.shape[2],
                                     *t.shape[3:]).contiguous()


def _fold_u(u, dim, V):
    """(V, H, K) → (V·H, K), contiguous."""
    return front(u, dim, V).reshape(-1, u.shape[-1]).contiguous()


def _unfold(t, V):
    """(B, S, V·H, K) → (V, B, S, H, K)."""
    B, S, VH, K = t.shape
    return t.reshape(B, S, V, VH // V, K).permute(2, 0, 1, 3, 4)


def _unfold_state(t, V):
    """(B, V·H, ...) → (V, B, H, ...)."""
    return t.reshape(t.shape[0], V, t.shape[1] // V,
                     *t.shape[2:]).transpose(0, 1)


# -- the kernels as torch.library custom ops ---------------------------------

@torch.library.custom_op("repro_torch::wkv6", mutates_args=(),
                         device_types=("cpu", "cuda"))
def wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
            save: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel (the plain version on the CPU): (o, final
    state, the chunk states the backward kernel reads; empty (B, H, 0,
    K, K) on the CPU or when ``save`` is 0). ``save`` is an int (0 or 1),
    so that DTensor's sharding cache tells the two apart."""
    o, s_fin, ckpt = _forward(r, k, v, w, u, s0, save=bool(save))
    if ckpt is None:
        B, S, H, K = r.shape
        ckpt = r.new_empty((B, H, 0, K, K))
    # the layouts the fake implementation gives
    return o.contiguous(), s_fin.contiguous(), ckpt


@wkv6_op.register_fake
def _(r, k, v, w, u, s0, save):
    B, S, H, K = r.shape
    chunks = -(-S // CHUNK) if save and r.device.type == "cuda" else 0
    return (r.new_empty(r.shape), r.new_empty((B, H, K, K)),
            r.new_empty((B, H, chunks, K, K)))


@torch.library.custom_op("repro_torch::wkv6_backward", mutates_args=(),
                         device_types=("cpu", "cuda"))
def wkv6_backward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                     d_o: torch.Tensor, d_state: Optional[torch.Tensor],
                     ckpt: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`wkv6_backward` (the walk, then du's fold; the plain version
    on the CPU): (dr, dk, dv, dw, du, ds0)."""
    if d_o.stride(3) != 1:      # e.g. the expanded grad of a sum
        d_o = d_o.contiguous()
    return tuple(g.contiguous() for g in wkv6_backward(
        r, k, v, w, u, s0, d_o, d_state, ckpt))


@wkv6_backward_op.register_fake
def _(r, k, v, w, u, s0, d_o, d_state, ckpt):
    return (*(r.new_empty(r.shape) for _ in range(4)), u.new_empty(u.shape),
            s0.new_empty(s0.shape))


def _setup_context(ctx, inputs, output):
    r, k, v, w, u, s0, _ = inputs      # the last: save
    ctx.mark_non_differentiable(output[2])
    ctx.save_for_backward(r, k, v, w, u, s0, output[2])


def _backward(ctx, d_o, d_state, _):
    r, k, v, w, u, s0, ckpt = ctx.saved_tensors
    if d_o is None:
        d_o = torch.zeros_like(r)
    return (*wkv6_backward_op(r, k, v, w, u, s0, d_o, d_state, ckpt), None)


wkv6_op.register_autograd(_backward, setup_context=_setup_context)


def _fwd_vmap(info, in_dims, r, k, v, w, u, s0, save):
    """The vmapped axis folded into the heads: one launch for all of it;
    vmap over vmap folds twice, still one launch."""
    V = info.batch_size
    o, s_fin, ckpt = wkv6_op(
        *(_fold(t, d, V) for t, d in zip((r, k, v, w), in_dims)),
        _fold_u(u, in_dims[4], V), _fold_state(s0, in_dims[5], V), save)
    return ((_unfold(o, V), _unfold_state(s_fin, V),
             _unfold_state(ckpt, V)), (0, 0, 0))


def _bwd_vmap(info, in_dims, r, k, v, w, u, s0, d_o, d_state, ckpt):
    V = info.batch_size
    dr, dk, dv, dw, du, ds0 = wkv6_backward_op(
        *(_fold(t, d, V) for t, d in zip((r, k, v, w), in_dims)),
        _fold_u(u, in_dims[4], V), _fold_state(s0, in_dims[5], V),
        _fold(d_o, in_dims[6], V),
        None if d_state is None else _fold_state(d_state, in_dims[7], V),
        _fold_state(ckpt, in_dims[8], V))
    return ((*(_unfold(t, V) for t in (dr, dk, dv, dw)),
             du.reshape(V, -1, du.shape[-1]), _unfold_state(ds0, V)),
            (0,) * 6)


wkv6_op.register_vmap(_fwd_vmap)
wkv6_backward_op.register_vmap(_bwd_vmap)


def sharding_rules(r, k, v, w, u, s0, save):
    """The placements the kernel computes right on a shard: the batch
    (u whole), the heads (u on its H dim) or none. Never the time axis:
    the state carries over it."""
    from torch.distributed.tensor import Replicate, Shard
    return [([Shard(0)] * 3, [Shard(0)] * 4 + [Replicate(), Shard(0), None]),
            ([Shard(2), Shard(1), Shard(1)],
             [Shard(2)] * 4 + [Shard(0), Shard(1), None]),
            ([Replicate()] * 3, [Replicate()] * 6 + [None])]


def backward_sharding_rules(r, k, v, w, u, s0, d_o, d_state, ckpt):
    """As the forward's; on the batch, du (a sum over b) is partial."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    ds = None if d_state is None else Shard(0)
    dh = None if d_state is None else Shard(1)
    dr = None if d_state is None else Replicate()
    return [([Shard(0)] * 4 + [Partial(), Shard(0)],
             [Shard(0)] * 4 + [Replicate(), Shard(0), Shard(0), ds,
                               Shard(0)]),
            ([Shard(2)] * 4 + [Shard(0), Shard(1)],
             [Shard(2)] * 4 + [Shard(0), Shard(1), Shard(2), dh, Shard(1)]),
            ([Replicate()] * 6, [Replicate()] * 7 + [dr, Replicate()])]


class _Recurrence(torch.autograd.Function):
    """The op under ``torch.func`` (whose transforms do not take a custom
    op's autograd): the forward and backward ops, whose vmap rules fold
    the vmapped axis into the heads."""

    generate_vmap_rule = True

    @staticmethod
    def forward(r, k, v, w, u, s0, save):
        return wkv6_op(r, k, v, w, u, s0, int(save))

    setup_context = staticmethod(_setup_context)

    @staticmethod
    def backward(ctx, d_o, d_state, _):
        r, k, v, w, u, s0, ckpt = ctx.saved_tensors
        if d_o is None:
            d_o = torch.zeros_like(r)
        return (*_RecurrenceBackward.apply(r, k, v, w, u, s0, d_o, d_state,
                                           ckpt), None)


class _RecurrenceBackward(torch.autograd.Function):
    """The backward op under ``torch.func``, which differentiates the
    backward graph it builds; it has no gradient of its own."""

    generate_vmap_rule = True

    @staticmethod
    def forward(r, k, v, w, u, s0, d_o, d_state, ckpt):
        return wkv6_backward_op(r, k, v, w, u, s0, d_o, d_state, ckpt)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the wkv6 backward has no gradient")


def wkv6_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r, k, v, w (B, S, H, K), u (H, K), s0 (B, H, K, K), all float32 →
    (o (B, S, H, K), final state (B, H, K, K)) in float32,
    differentiable when an input requires grad. Inputs wrapped by
    ``torch.func`` (vmap, grad) go through the Function, whose vmap rule
    folds the vmapped axis into the heads: one launch for the batch."""
    _check(r, k, v, w, u, s0)
    ts = (r, k, v, w, u, s0)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ts)
    if grad and is_wrapped(*ts):
        return _Recurrence.apply(r, k, v, w, u, s0, int(grad))[:2]
    refuse_device(r, "wkv6")
    ensure_rules(r)
    return wkv6_op(r, k, v, w, u, s0, int(grad))[:2]
