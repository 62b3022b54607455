"""The bfloat16 flash backward kernels (csrc/flash_attention.cu:
flash_bwd_dq_wg, flash_bwd_dkdv_wg) emulated in torch on the CPU: their
rounding of P and dS and their order of sums over the G query heads,
against the port's plain backward ``flash_attention_backward_ref``.

The kernels take P and dS into their products as two bfloat16 parts, hi
= bf16(x) and lo = bf16(x - hi), products of bfloat16 operands summed
in float32. dQ sums the key tiles of its query tile in
order. dK and dV of a key tile: the (head, query tile) pairs that see it
— the G heads of the kv group in order, each its query tiles in order —
are cut into ``dkdv_cluster`` contiguous runs, one for each block of a
cluster; each block sums its run in order, and the blocks' sums are
added in rank order. The plain version computes in float32 and sums
dK and dV over the heads one after another. This test shows on the CPU
that the kernels' rounding and order fit the tolerance the card is held
to (``chip_smoke.py`` FLASH_GRAD_TOL["bfloat16"], rtol/atol 2e-2: one
rounding of a float32 result to bfloat16 and the products' bfloat16
operands), at G = 1, 4 and 8, causal, windows shorter and longer than a
tile, non-causal, and S that is not a multiple of the 64-row tile; and
with keys of their own length (Skv != Sq: key tiles of Skv, query tiles
of Sq) and at hd 112 (the hd-128 tile with columns 112-127 zero, D over
the 112 columns that exist).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels.ref import (flash_attention_backward_ref,
                                     flash_attention_gqa_ref,
                                     flash_attention_lse_ref)

BF16_GRAD_TOL = dict(rtol=2e-2, atol=2e-2)
T = kf.TILE
LOG2E = 1.4426950408889634


def _parts(x: torch.Tensor):
    """x (float32) as the bfloat16 parts the kernel multiplies with."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mask(qpos, kpos, S, Skv, causal, window):
    ok = (qpos[:, None] < S) & (kpos[None, :] < Skv)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        ok &= qpos[:, None] - kpos[None, :] < window
    return ok


def _tile(x, t0, S, width):
    """Rows [t0, t0 + 64) of (B, S, H, hd) as (B, H, 64, width) float32,
    zeros past S and past hd (TMA's fill)."""
    out = torch.zeros(x.shape[0], x.shape[2], T, width)
    n = min(T, S - t0)
    out[:, :, :n, :x.shape[3]] = x[:, t0:t0 + n].transpose(1, 2).float()
    return out


def flash_backward_kernel_order(q, k, v, o, lse, d_o, causal, window):
    B, S, Hq, hd = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    W = 128 if hd == 112 else hd      # the tile's width
    scale2 = LOG2E / math.sqrt(hd)
    n_t, n_kt = -(-S // T), -(-Skv // T)
    # D = Σ dO·O of every row: two halves of hd in order, then added
    prod = d_o.float() * o.float()
    halves = []
    for h0 in (0, hd // 2):
        acc = prod[..., h0]
        for d in range(h0 + 1, h0 + hd // 2):
            acc = acc + prod[..., d]
        halves.append(acc)
    D = (halves[0] + halves[1]).transpose(1, 2)          # (B, Hq, S)
    L2 = lse.float() * LOG2E
    pad = n_t * T - S
    Dp = torch.nn.functional.pad(D, (0, pad))
    L2p = torch.nn.functional.pad(L2, (0, pad))

    def p_ds(sc, dp, qpos, kpos, Lq, Dq, keys_are_rows):
        """P and dS of a tile; rows keys (dK/dV) or queries (dQ)."""
        if keys_are_rows:
            ok = _mask(qpos, kpos, S, Skv, causal, window).T
            p = torch.exp2(sc * scale2 - Lq[..., None, :])
            ds = p * (dp - Dq[..., None, :])
        else:
            ok = _mask(qpos, kpos, S, Skv, causal, window)
            p = torch.exp2(sc * scale2 - Lq[..., :, None])
            ds = p * (dp - Dq[..., :, None])
        p = torch.where(ok, p, torch.zeros(()))
        return p, torch.where(ok, ds, torch.zeros(()))

    dq = torch.zeros(B, S, Hq, hd)
    kvh = torch.arange(Hq) // G
    for qt in range(n_t):
        q0 = qt * T
        qpos = torch.arange(q0, q0 + T)
        Qt, dOt = _tile(q, q0, S, W), _tile(d_o, q0, S, W)
        Lq, Dq = L2p[..., q0:q0 + T], Dp[..., q0:q0 + T]
        q_last = min(q0 + T, S) - 1
        kt_begin = max(0, q0 - window + 1) // T if window > 0 else 0
        kt_end = -(-((q_last + 1) if causal else Skv) // T)
        acc = torch.zeros(B, Hq, T, W)
        for kt in range(kt_begin, kt_end):
            k0 = kt * T
            Kt, Vt = (_tile(k, k0, Skv, W)[:, kvh],
                      _tile(v, k0, Skv, W)[:, kvh])
            _, ds = p_ds(Qt @ Kt.transpose(2, 3), dOt @ Vt.transpose(2, 3),
                         qpos, torch.arange(k0, k0 + T), Lq, Dq, False)
            for part in _parts(ds):
                acc = acc + part @ Kt
        n = min(T, S - q0)
        dq[:, q0:q0 + n] = (acc * (scale2 / LOG2E)).transpose(
            1, 2)[:, :n, :, :hd]

    dk, dv = torch.zeros(B, Skv, Hk, hd), torch.zeros(B, Skv, Hk, hd)
    cl = kf.dkdv_cluster(S, G, causal, window, Skv)
    for kt in range(n_kt):
        k0 = kt * T
        kpos = torch.arange(k0, k0 + T)
        Kt, Vt = _tile(k, k0, Skv, W), _tile(v, k0, Skv, W)
        k_last = min(k0 + T, Skv) - 1
        qt_begin = k0 // T if causal else 0
        q_end = min(S, k_last + window) if window > 0 else S
        nq = -(-q_end // T) - qt_begin
        pairs = [(g, qt_begin + j) for g in range(G) for j in range(nq)]
        fk, fv = [], []
        for rank in range(cl):
            run = pairs[len(pairs) * rank // cl:len(pairs) * (rank + 1) // cl]
            assert len(pairs) < 2 or len(run) < len(pairs)
            ak, av = torch.zeros(B, Hk, T, W), torch.zeros(B, Hk, T, W)
            for g, qt in run:
                q0 = qt * T
                heads = torch.arange(Hk) * G + g
                Qt, dOt = (_tile(q, q0, S, W)[:, heads],
                           _tile(d_o, q0, S, W)[:, heads])
                p, ds = p_ds(Kt @ Qt.transpose(2, 3), Vt @ dOt.transpose(2, 3),
                             torch.arange(q0, q0 + T), kpos,
                             L2p[:, heads, q0:q0 + T],
                             Dp[:, heads, q0:q0 + T], True)
                for part in _parts(p):
                    av = av + part @ dOt
                for part in _parts(ds):
                    ak = ak + part @ Qt
            fk.append(ak)
            fv.append(av)
        sk, sv = fk[0], fv[0]
        for rank in range(1, cl):
            sk, sv = sk + fk[rank], sv + fv[rank]
        n = min(T, Skv - k0)
        dk[:, k0:k0 + n] = (sk * (scale2 / LOG2E)).transpose(
            1, 2)[:, :n, :, :hd]
        dv[:, k0:k0 + n] = sv.transpose(1, 2)[:, :n, :, :hd]
    return (dq.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


# (B, S, Hq, Hk, hd, causal, window): G = 4, 8 and 1; S around a tile and
# 513; a window shorter than a tile, one longer; non-causal
# (B, S, Hq, Hk, hd, causal, window): G = 4, 8 and 1; S around a tile and
# 513; a window shorter than a tile, one longer; non-causal
CASES = [(2, 130, 8, 2, 64, True, 0), (1, 65, 8, 1, 32, True, 0),
         (2, 63, 2, 2, 16, True, 0), (1, 1, 4, 4, 32, True, 0),
         (1, 513, 8, 1, 16, True, 0), (1, 200, 4, 1, 64, True, 40),
         (1, 130, 4, 1, 64, True, 7), (2, 100, 4, 2, 32, False, 0),
         (1, 70, 2, 1, 128, True, 0)]
# (B, S, Hq, Hk, hd, causal, window, Skv): keys of their own length,
# non-causal (more keys, fewer, ragged, one short tile), and hd 112
OWN_KEYS_AND_HD112 = [
    (1, 64, 4, 4, 64, False, 0, 256), (2, 57, 8, 2, 64, False, 0, 100),
    (1, 200, 4, 4, 32, False, 0, 16), (1, 33, 2, 1, 128, False, 0, 80),
    (1, 130, 4, 4, 112, True, 0, 130), (2, 64, 2, 2, 112, True, 0, 64),
    (1, 70, 2, 1, 112, True, 9, 70), (1, 40, 2, 2, 112, False, 0, 90)]


def _check_order(B, S, Skv, Hq, Hk, hd, causal, window):
    rng = np.random.default_rng(S * 10 + Hq + hd)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, k, v = bf(B, S, Hq, hd), bf(B, Skv, Hk, hd), bf(B, Skv, Hk, hd)
    d_o = bf(B, S, Hq, hd)
    o = flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
    lse = flash_attention_lse_ref(q, k, causal=causal, window=window)
    got = flash_backward_kernel_order(q, k, v, o, lse, d_o, causal, window)
    want = flash_attention_backward_ref(q, k, v, o, lse, d_o, causal=causal,
                                        window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), b.float(), **BF16_GRAD_TOL,
                                   msg=name)


@pytest.mark.parametrize("B,S,Hq,Hk,hd,causal,window", CASES)
def test_bf16_backward_kernel_order_matches_plain(B, S, Hq, Hk, hd, causal,
                                                  window):
    _check_order(B, S, S, Hq, Hk, hd, causal, window)


@pytest.mark.parametrize("B,S,Hq,Hk,hd,causal,window,Skv",
                         OWN_KEYS_AND_HD112)
def test_bf16_backward_kernel_order_own_keys_and_hd112(B, S, Hq, Hk, hd,
                                                       causal, window, Skv):
    _check_order(B, S, Skv, Hq, Hk, hd, causal, window)
