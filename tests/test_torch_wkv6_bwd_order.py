"""The order of sums of the port's wkv6 backward kernel (csrc/wkv6.cu:
wkv6_bwd), emulated in torch on the CPU, against the port's plain
backward ``repro_torch.kernels.ref.wkv6_backward_ref`` and a float64 loop.

The kernel cuts a (b, h)'s K state columns into column groups of JB, one
block of a thread-block cluster each (``wkv6.backward_shape``, a function
of K). A lane holds one row i and CT columns of its block's; at every
step it sums its CT terms of dr, dk and dw in order, the L = JB / CT
lanes of a row fold with an xor tree, and at the end of every 16-step
chunk the cluster's ranks add their blocks' partials in rank order; dr
then gets u·k·(dO·v), with dO·v summed in order over each group's columns
and the groups in rank order. dv sums k·e over the rows of a warp with an
xor tree and over the warps in order. du sums r·k·(dO·v) over t, walking
down, then over b in order. That reassociates the plain version's sums
(and takes dr as Σ_j dO·S + u·k·(dO·v) where the plain version takes
Σ_j dO·(S + u·k·v)). This test shows on the CPU that the reassociation
fits the tolerance the card is held to: rtol 1e-4 / atol 1e-3
(``chip_smoke.py`` WKV6_GRAD_TOL), float32 over up to 100 steps, with
decays near 1, in the middle and near 0 (down to 1e-30). Both the
emulation and the plain version are held to a float64 loop at that
tolerance as well.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import wkv6 as kw
from repro_torch.kernels.ref import wkv6_backward_ref

WKV6_GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
CHUNK = kw.CHUNK
DECAYS = {"near 1": (0.99, 0.999), "mid": (0.2, 0.99),
          "near 0": (1e-30, 1e-2)}


def xor_fold(x: torch.Tensor) -> torch.Tensor:
    """(..., n) → (...): the kernel's __shfl_xor tree over n lanes (each
    level adds lane g and lane g ^ off)."""
    n = x.shape[-1]
    lanes = torch.arange(n)
    off = 1
    while off < n:
        x = x + x[..., lanes ^ off]
        off *= 2
    return x[..., 0]


def ordered(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ over ``dim`` one term after another, in index order."""
    x = x.movedim(dim, 0)
    acc = x[0].clone()
    for t in x[1:]:
        acc = acc + t
    return acc


def wkv6_backward_kernel_order(r, k, v, w, u, s0, d_o, d_state):
    """(B, S, H, K) float32 inputs → (dr, dk, dv, dw, du, ds0) with the
    kernel's order of sums."""
    B, S, H, K = r.shape
    geo = kw.backward_shape(1, 1, K)
    jb, ct, ncb = geo.jb, geo.ct, geo.cluster
    lanes = jb // ct
    rows_a_warp = 32 // lanes

    def flat(t):
        return t.transpose(1, 2).reshape(B * H, S, K)

    rf, kf, vf, wf, dof = (flat(t) for t in (r, k, v, w, d_o))
    uf = u[None].expand(B, H, K).reshape(B * H, K)
    # the training forward's chunk states, then the states before each
    # step inside a chunk, recomputed from them with the same update
    state = s0.reshape(B * H, K, K).clone()
    before = []
    for t in range(S):
        before.append(state)
        state = wf[:, t, :, None] * state + kf[:, t, :, None] * vf[:, t, None, :]
    ds = d_state.reshape(B * H, K, K).clone()
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros(B * H, K)

    def groups(x):                  # (BH, K, K) → (BH, K, ncb, L, ct)
        return x.reshape(B * H, K, ncb, lanes, ct)

    def row_sum(x):                 # in-lane order, lane tree, rank order
        acc = groups(x)[..., 0]
        for q in range(1, ct):
            acc = acc + groups(x)[..., q]
        return ordered(xor_fold(acc), 2)

    for t in reversed(range(S)):
        r_t, k_t, w_t, v_t, do_t = (x[:, t] for x in (rf, kf, wf, vf, dof))
        prev = before[t]
        rd = r_t[:, :, None] * do_t[:, None, :]
        e = uf[:, :, None] * rd + ds
        dot_g = do_t.reshape(B * H, ncb, jb)[..., 0] \
            * v_t.reshape(B * H, ncb, jb)[..., 0]
        for x in range(1, jb):
            dot_g = dot_g + do_t.reshape(B * H, ncb, jb)[..., x] \
                * v_t.reshape(B * H, ncb, jb)[..., x]
        dot = ordered(dot_g, 1)                                  # (BH,)
        dr[:, t] = row_sum(do_t[:, None, :] * prev) \
            + (uf * k_t) * dot[:, None]
        dk[:, t] = row_sum(e * v_t[:, None, :])
        dw[:, t] = row_sum(ds * prev)
        col = (k_t[:, :, None] * e).reshape(B * H, K // rows_a_warp,
                                            rows_a_warp, K)
        dv[:, t] = ordered(xor_fold(col.transpose(2, 3)), 1)
        du = du + (r_t * k_t) * dot[:, None]
        ds = w_t[:, :, None] * ds + rd

    def unflat(t):
        return t.reshape(B, H, S, K).transpose(1, 2).contiguous()

    return (unflat(dr), unflat(dk), unflat(dv), unflat(dw),
            ordered(du.reshape(B, H, K), 0), ds.reshape(B, H, K, K))


def wkv6_backward_float64(r, k, v, w, u, s0, d_o, d_state):
    """The plain version's equations in float64 numpy, as float32
    tensors."""
    args = [np.asarray(a, np.float64) for a in
            (r, k, v, w, u, s0, d_o, d_state)]
    r, k, v, w, u, s0, d_o, d_state = args
    B, S, H, K = r.shape
    st = s0.copy()
    before = []
    for t in range(S):
        before.append(st)
        st = w[:, t, :, :, None] * st + k[:, t, :, :, None] * v[:, t, :, None, :]
    ds = d_state.copy()
    out = [np.empty_like(r) for _ in range(4)]
    du = np.zeros((B, H, K))
    for t in reversed(range(S)):
        r_t, k_t, v_t, w_t, do_t = (x[:, t] for x in (r, k, v, w, d_o))
        prev = before[t]
        dot = np.sum(do_t * v_t, -1, keepdims=True)
        e = ds + (u * r_t)[..., None] * do_t[..., None, :]
        out[0][:, t] = np.einsum("bhij,bhj->bhi", prev, do_t) + u * k_t * dot
        out[1][:, t] = np.einsum("bhij,bhj->bhi", e, v_t)
        out[2][:, t] = np.einsum("bhi,bhij->bhj", k_t, e)
        out[3][:, t] = np.sum(ds * prev, -1)
        du = du + r_t * k_t * dot
        ds = w_t[..., None] * ds + r_t[..., None] * do_t[..., None, :]
    return tuple(torch.from_numpy(np.asarray(x, np.float32))
                 for x in (*out, du.sum(0), ds))


def _inputs(seed, B, S, H, K, decay):
    rng = np.random.default_rng(seed)
    lo, hi = DECAYS[decay]
    x = rng.random((B, S, H, K))
    w = np.exp(np.log(lo) + (np.log(hi) - np.log(lo)) * x)
    arrs = (rng.standard_normal((B, S, H, K)),
            rng.standard_normal((B, S, H, K)),
            rng.standard_normal((B, S, H, K)), w,
            rng.standard_normal((H, K)),
            0.1 * rng.standard_normal((B, H, K, K)),
            rng.standard_normal((B, S, H, K)),
            0.1 * rng.standard_normal((B, H, K, K)))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
# (B, S, H, K): RWKV-6's head size over several chunks and a ragged one,
# the tiny LM's, and the other sizes
SHAPES = [(2, 100, 1, 64), (2, 33, 2, 32), (2, 17, 2, 16), (3, 40, 2, 8)]


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("B,S,H,K", SHAPES)
def test_backward_kernel_order_matches_plain(B, S, H, K, decay):
    args = _inputs(B * S + K, B, S, H, K, decay)
    got = wkv6_backward_kernel_order(*args)
    want = wkv6_backward_ref(*args)
    for name, a, b in zip(NAMES, got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, **WKV6_GRAD_TOL, msg=name)


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("B,S,H,K", SHAPES)
def test_backward_kernel_order_and_plain_match_float64(B, S, H, K, decay):
    args = _inputs(B * S + K, B, S, H, K, decay)
    f64 = wkv6_backward_float64(*args)
    for which in (wkv6_backward_kernel_order(*args),
                  wkv6_backward_ref(*args)):
        for name, a, b in zip(NAMES, which, f64):
            torch.testing.assert_close(a, b, **WKV6_GRAD_TOL, msg=name)


@pytest.mark.parametrize("K", [8, 16, 32, 64])
def test_backward_cluster_covers_every_row_and_column_once(K):
    """The ranks' column groups tile the K columns, their fold shares tile
    the K rows, and the lanes of a block hold each (row, column) once."""
    geo = kw.backward_shape(1, 1, K)
    cols = [j for q in range(geo.cluster)
            for j in range(q * geo.jb, (q + 1) * geo.jb)]
    rows = [i for q in range(geo.cluster)
            for i in range(q * geo.fold_rows, (q + 1) * geo.fold_rows)]
    assert cols == list(range(K)) and rows == list(range(K))
    lanes = geo.jb // geo.ct
    held = [(tid // lanes, (tid % lanes) * geo.ct + c)
            for tid in range(geo.threads) for c in range(geo.ct)]
    assert sorted(held) == [(i, j) for i in range(K) for j in range(geo.jb)]
