"""What the port's kernel wrappers decide before any launch, on the CPU:
the weighted aggregate's load width, the bfloat16 flash kernel's TMA
layout rules, the wkv6 kernel's geometry and copy width, the two backward
kernels' launch geometry (the wkv6 walk's clusters and blocks, the
bfloat16 flash dK/dV clusters and the scratch), the cosine partials'
chunking, and the refusal of devices that have no kernel. The
kernels themselves run in ``tests/test_torch_kernels_cuda.py`` (card
only)."""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wkv
from repro_torch.kernels.cosine_sim import chunk_for, splits_for
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels.flash_attention import tma_refusal
from repro_torch.kernels.weighted_agg import vector_width


# (D, base address mod 16, element size, columns a thread loads at once)
@pytest.mark.parametrize("D,addr,size,want", [
    (1001, 0, 4, 1), (1001, 0, 2, 1),          # D odd
    (1002, 0, 4, 2), (1002, 0, 2, 2),          # D = 2 mod 4
    (1028, 0, 4, 4), (1028, 0, 2, 4),          # D = 4 mod 8
    (1024, 0, 4, 4), (1024, 0, 2, 8),          # D = 0 mod 8
    (101_770, 0, 4, 2), (101_770, 0, 2, 2),    # the MLP's D
    (1024, 8, 4, 2), (1024, 4, 4, 1),          # the base sets the width
    (1024, 8, 2, 4), (1024, 4, 2, 2), (1024, 2, 2, 1),
])
def test_vector_width_choice(D, addr, size, want):
    assert vector_width(D, 4096 + addr, size) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1001, 1002, 1024, 101_770])
def test_vector_width_keeps_every_row_aligned(D, dtype):
    """On real views (the whole tensor, big[1:], one element in) every row
    start is aligned to the chosen load, and twice the width would not
    be."""
    big = torch.zeros(4 * D + 1, dtype=dtype)
    size = big.element_size()
    for W in (big[:3 * D].view(3, D), big[:4 * D].view(4, D)[1:],
              big[1:1 + 3 * D].view(3, D)):
        v = vector_width(D, W.data_ptr(), size)
        assert v * size <= 16 and D % v == 0
        assert all((W[n].data_ptr() % (v * size)) == 0 for n in range(3))
        if v * size < 16:
            assert D % (2 * v) or W.data_ptr() % (2 * v * size)


def test_tma_refusal_reads_base_and_strides():
    B, S, H, hd = 2, 40, 4, 32
    ok = torch.zeros(B, S, H, hd, dtype=torch.bfloat16)
    assert tma_refusal("q", ok) is None
    # (B, H, S, hd) storage seen through a transpose, and q, k, v slices of
    # one fused projection: strides in any order, all 16-byte multiples
    assert tma_refusal("q", ok.transpose(1, 2).contiguous()
                       .transpose(1, 2)) is None
    qkv = torch.zeros(B, S, H + 4, hd, dtype=torch.bfloat16)
    assert all(tma_refusal(n, t) is None
               for n, t in zip("qkv", qkv.split([H, 2, 2], dim=2)))
    flat = torch.zeros(B * S * H * hd + 8, dtype=torch.bfloat16)
    base = flat.data_ptr() % 16 // 2          # elements to a 16-byte base
    shifted = flat[base + 1:base + 1 + B * S * H * hd].view(B, S, H, hd)
    assert "address" in tma_refusal("q", shifted)
    padded = torch.zeros(B, S, H, hd + 4, dtype=torch.bfloat16)[..., :hd]
    assert "stride 2" in tma_refusal("k", padded)
    # the stride of a dim of extent 1 is never used
    single = torch.as_strided(ok, (1, S, H, hd), (3, H * hd, hd, 1))
    assert tma_refusal("v", single) is None


def test_wrappers_refuse_a_device_without_kernels():
    before = ops.launch_counts()
    W = torch.ones(4, 8, device="meta")
    with pytest.raises(ValueError, match="no weighted_aggregate kernel"):
        ops.weighted_aggregate(W, torch.ones(4, device="meta"))
    q = torch.ones(1, 8, 2, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no flash attention kernel"):
        ops.flash_attention(q, q, q)
    assert ops.launch_counts() == before


def test_cpu_aggregate_takes_any_float_weights():
    """The wrapper casts non-fp32 weights itself; on the CPU the result is
    the plain version's."""
    from repro_torch.kernels.ref import weighted_aggregate_ref
    gen = torch.Generator().manual_seed(0)
    W = torch.randn(5, 33, generator=gen)
    w = torch.rand(5, generator=gen, dtype=torch.float64) + 0.5
    out = ops.weighted_aggregate(W, w)
    assert out.dtype == torch.float32
    assert torch.equal(out, weighted_aggregate_ref(W, w))


# csrc/wkv6.cu's budget: a lane's state tile in at most 64 registers, and
# two blocks' shared memory within an SM's 228 KB (the (8, 32) grid has
# two blocks an SM at K = 64)
SMEM_PER_SM = 233_472
BLOCKS_PER_SM = 2
MAX_STATE_REGISTERS = 64

# K -> (jc, g, c, t, stages, threads, shared bytes): csrc/wkv6.cu's Geo<K>
WKV6_GEOMETRY = {64: (64, 8, 8, 16, 3, 64, 55_872),
                 32: (32, 4, 4, 16, 2, 32, 18_624),
                 16: (16, 4, 2, 16, 2, 32, 9_344),
                 8: (8, 4, 1, 16, 2, 32, 4_704)}


@pytest.mark.parametrize("K", sorted(WKV6_GEOMETRY))
@pytest.mark.parametrize("B,H", [(8, 32), (1, 1), (3, 5), (64, 40)])
def test_wkv6_launch_shape_is_pinned(B, H, K):
    """Jc, G, C, T and the ring depend on K alone (so does the order of
    every sum); B and H only scale the grid."""
    shape = wkv.launch_shape(B, H, K)
    jc, g, c, t, stages, threads, smem = WKV6_GEOMETRY[K]
    assert (shape.jc, shape.g, shape.c, shape.t, shape.stages) == \
        (jc, g, c, t, stages)
    assert shape.threads == threads == (jc // c) * g
    assert shape.blocks == B * H * (K // jc)
    assert shape.smem_bytes == smem
    assert (shape.step_blocks, shape.step_threads) == (B * H, K * g)


@pytest.mark.parametrize("K", sorted(WKV6_GEOMETRY))
def test_wkv6_geometry_fits_the_source_budget(K):
    """The source's budget: whole warps, a column group's lanes inside one
    warp, a lane's state tile in at most 64 registers, rows a lane reads
    with 8- or 16-byte loads inside one 32-float run of the padded row,
    columns in 4-, 8- or 16-byte pieces, and two blocks' shared memory
    within an SM's."""
    s = wkv.launch_shape(8, 32, K)
    rows = K // s.g
    assert s.threads % 32 == 0 and 32 % s.g == 0
    assert K % s.jc == 0 and s.jc % s.c == 0 and s.jc % 4 == 0
    assert rows * s.c <= MAX_STATE_REGISTERS
    assert (rows % 4 == 0 or rows == 2) and 32 % rows == 0
    assert s.c in (1, 2) or s.c % 4 == 0
    assert BLOCKS_PER_SM * s.smem_bytes <= SMEM_PER_SM


def test_wkv6_launch_shape_refuses_other_heads():
    with pytest.raises(ValueError, match="K in"):
        wkv.launch_shape(1, 1, 12)


# K -> (jb columns a block, ct columns a lane, blocks a cluster, threads,
# rows a rank folds, shared bytes): csrc/wkv6.cu's Bwd<K> and BwdLayout<K>
WKV6_BACKWARD = {64: (16, 4, 4, 256, 16, 95_616),
                 32: (16, 4, 2, 128, 16, 50_432),
                 16: (16, 4, 1, 64, 16, 27_840),
                 8: (8, 2, 1, 32, 8, 11_424)}
MAX_PORTABLE_CLUSTER = 8
REGISTERS_PER_SM = 65_536
BACKWARD_REGISTERS = 128   # the walk at K = 64 (nvcc -Xptxas -v on sm_90a)


@pytest.mark.parametrize("K", sorted(WKV6_BACKWARD))
@pytest.mark.parametrize("B,H", [(8, 32), (1, 1), (3, 5), (4, 32)])
def test_wkv6_backward_shape_is_pinned(B, H, K):
    """The walk's geometry, and with it the order of every sum, depends on
    K alone; B and H only scale the grid of clusters."""
    g = wkv.backward_shape(B, H, K)
    jb, ct, cluster, threads, rows, smem = WKV6_BACKWARD[K]
    assert (g.jb, g.ct, g.cluster, g.threads, g.fold_rows, g.smem_bytes) \
        == (jb, ct, cluster, threads, rows, smem)
    assert g.blocks == B * H * cluster and cluster == K // jb
    assert (wkv.BACKWARD_COLUMNS[K], wkv.BACKWARD_LANE_COLUMNS[K]) == (jb, ct)


@pytest.mark.parametrize("K", sorted(WKV6_BACKWARD))
def test_wkv6_backward_fits_the_card(K):
    """Whole warps, a row's lanes inside one warp, a portable cluster
    whose ranks tile the K rows, and two blocks an SM by shared memory
    and, at K = 64, by registers."""
    g = wkv.backward_shape(8, 32, K)
    lanes = g.jb // g.ct
    assert g.threads % 32 == 0 and lanes == 4
    assert g.cluster <= MAX_PORTABLE_CLUSTER
    assert g.cluster * g.fold_rows == K and g.cluster * g.jb == K
    assert g.threads >= wkv.CHUNK
    assert BLOCKS_PER_SM * (g.smem_bytes + 1024) <= SMEM_PER_SM
    if K == 64:
        assert BLOCKS_PER_SM * g.threads * BACKWARD_REGISTERS \
            <= REGISTERS_PER_SM


def test_wkv6_backward_shape_refuses_other_heads():
    with pytest.raises(ValueError, match="K in"):
        wkv.backward_shape(1, 1, 12)


# (S, G, causal, window) -> blocks of a bfloat16 dK/dV cluster
@pytest.mark.parametrize("S,G,causal,window,want", [
    (512, 8, True, 0, 4), (16, 1, True, 0, 1), (1000, 4, True, 256, 4),
    (65, 1, True, 0, 2), (64, 2, True, 0, 2), (64, 3, True, 0, 2),
    (130, 1, False, 0, 2), (200, 1, True, 7, 2), (1, 8, True, 0, 4),
    (513, 1, True, 0, 4)])
def test_flash_dkdv_cluster_is_pinned(S, G, causal, window, want):
    """As many blocks as the longest key tile has (head, query tile)
    pairs, up to four: the pairs are cut into that many runs."""
    assert kf.dkdv_cluster(S, G, causal, window) == want <= kf.MAX_CLUSTER
    assert kf.dkdv_cluster(S, G, causal, window, S) == want


# (Sq, Skv, G) -> blocks of a cluster for non-causal keys of their own
# length: every key tile of Skv is seen by all of Sq's query tiles
@pytest.mark.parametrize("S,Skv,G,want", [
    (64, 16, 1, 1), (64, 16, 2, 2), (512, 1024, 1, 4), (57, 100, 1, 1),
    (57, 100, 4, 4), (100, 57, 1, 2), (512, 16, 8, 4), (64, 256, 3, 2),
    (512, 256, 24, 4)])
def test_flash_dkdv_cluster_counts_pairs_over_sq(S, Skv, G, want):
    assert kf.dkdv_cluster(S, G, False, 0, Skv) == want <= kf.MAX_CLUSTER
    assert want == min(4, 1 << (G * -(-S // kf.TILE)).bit_length() - 1)


@pytest.mark.parametrize("B,S,Hq", [(8, 512, 32), (1, 1000, 8), (8, 16, 2),
                                    (2, 1, 3), (1, 65, 4)])
def test_flash_backward_scratch_is_pinned(B, S, Hq):
    """(L log2 e, D) pairs of every row, S padded to whole 64-row tiles
    (each dK/dV tile's pairs are one aligned 512-byte copy)."""
    n = kf.backward_scratch_floats(B, S, Hq)
    assert n == 2 * B * Hq * (-(-S // 64) * 64)
    assert n >= B * Hq * S                 # float32 keeps D in its front
    assert (2 * 64 * 4) % 16 == 0


# (pointer residues mod 16, strides, shape, floats a copy)
@pytest.mark.parametrize("ptrs,strides,shape,want", [
    ((0, 0, 0, 0), (512 * 2048, 2048, 64, 1), (8, 512, 32, 64), 4),
    ((0, 0, 0, 0), (512 * 8192, 8192, 64, 1), (8, 512, 32, 64), 4),  # fused
    ((0, 4, 0, 0), (2048, 2048, 64, 1), (1, 4, 32, 64), 1),           # base
    ((0, 0, 0, 0), (33 * 80, 80, 20, 1), (2, 33, 4, 16), 4),
    ((0, 0, 0, 0), (33 * 66, 66, 16, 1), (2, 33, 4, 16), 1),          # stride
    ((0, 0, 0, 0), (3, 66 * 4, 66, 1), (1, 33, 4, 16), 1),            # h 66
    ((0, 0, 0, 0), (3, 64 * 4, 64, 1), (1, 33, 4, 16), 4),  # b unused
    ((0, 0, 0, 0), (3, 5, 64, 1), (1, 1, 4, 16), 4),        # s unused too
])
def test_wkv6_copy_width(ptrs, strides, shape, want):
    assert wkv.copy_width([4096 + p for p in ptrs], strides, shape) == want


@pytest.mark.parametrize("D", [1, 7, 2047, 2048, 2049, 101_770, 2 ** 21,
                               2 ** 21 + 1, 10 ** 9, 2 ** 31 - 1])
def test_cosine_chunking_depends_on_d_only(D):
    """Whole 2048-element tiles a block, at most 1024 blocks, every element
    in exactly one chunk; the order of every sum follows from these."""
    chunk, splits = chunk_for(D), splits_for(D)
    assert chunk % 2048 == 0 and 1 <= splits <= 1024
    assert (splits - 1) * chunk < D <= splits * chunk
    if D <= 2 ** 21:
        assert chunk == 2048      # one tile: gw read once into registers
    assert (chunk_for(D), splits_for(D)) == (chunk, splits)


@pytest.mark.parametrize("hd,ok", [(16, True), (32, True), (64, True),
                                   (112, True), (128, True), (100, False),
                                   (96, False), (8, False)])
def test_flash_head_dims(hd, ok):
    """hd 112 (Zamba2-7B's shared attention) is taken, as the reference's
    kernel takes any hd; a head dim the kernel has no case for is refused
    before any launch (on the CPU, before the plain version)."""
    q = torch.zeros(1, 5, 2, hd)
    if ok:
        assert ops.flash_attention(q, q, q).shape == (1, 5, 2, hd)
    else:
        with pytest.raises(ValueError, match="takes hd in"):
            ops.flash_attention(q, q, q)


def _cases(source: str, function: str) -> set:
    """The head dims of ``function``'s REPRO_HD case list in the source."""
    import re
    body = source.split(f" {function}(", 1)[1].split("default:", 1)[0]
    return {int(n) for n in re.findall(r"REPRO_HD\((\d+)\)", body)}


def test_flash_source_cases_match_the_wrapper():
    """The forward's case list and both backward case lists are the
    wrapper's HEAD_DIMS: every head dim the forward takes is
    differentiated on the card, hd 112 included."""
    from pathlib import Path
    src = (Path(kf.__file__).parent / "csrc" / "flash_attention.cu"
           ).read_text()
    assert _cases(src, "dispatch_hd") == set(kf.HEAD_DIMS)
    assert _cases(src, "dispatch_bwd_f32") == set(kf.HEAD_DIMS)
    assert _cases(src, "dispatch_bwd_tc") == set(kf.HEAD_DIMS)
    assert not hasattr(kf, "NO_BACKWARD_HEAD_DIMS")


def _c_params(source: str, symbol: str) -> list:
    """(type, name) of each parameter of the C entry ``symbol``."""
    body = source.split(f'extern "C" int {symbol}(', 1)[1].split(")", 1)[0]
    out = []
    for p in (p.strip() for p in body.split(",")):
        kind = ("pointer" if "*" in p else "long long"
                if p.startswith("long long") else p.split()[0])
        out.append((kind, p.split()[-1].lstrip("*")))
    return out


def test_flash_c_entries_match_their_ctypes_signatures():
    """The ctypes argument types of both flash entry points follow the C
    entries' parameter lists in csrc/flash_attention.cu; both take the
    keys' own length Skv after S."""
    import ctypes
    from pathlib import Path
    from repro_torch.kernels import _build
    src = (Path(kf.__file__).parent / "csrc" / "flash_attention.cu"
           ).read_text()
    ctype = {"pointer": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int}
    names = {}
    for entry in ("flash_attention", "flash_attention_backward"):
        _, symbol, argtypes = _build.SIGNATURES[entry]
        params = _c_params(src, symbol)
        assert [ctype[kind] for kind, _ in params] == argtypes
        names[entry] = [name for _, name in params]
    assert names["flash_attention"][-10:] == [
        "B", "S", "Skv", "Hq", "Hk", "hd", "causal", "window", "dtype",
        "stream"]
    assert names["flash_attention_backward"][-10:] == [
        "B", "S", "Skv", "Hq", "Hk", "hd", "causal", "window", "dtype",
        "stream"]


def test_flash_backward_with_keys_of_their_own_length_on_the_cpu():
    """The CPU runs the plain backward with Skv != Sq (dk, dv of the keys'
    length); nothing is refused any more: the card's kernels take Skv too
    (tests/test_torch_kernels_cuda.py), only a causal or windowed mask
    with Skv != Sq is refused, as the forward refuses it."""
    assert not hasattr(kf, "NO_BACKWARD_CROSS")
    with pytest.raises(ValueError, match="Skv 12 != Sq 8"):
        kf.flash_attention_backward(*(torch.zeros(1, n, 2, 16)
                                      for n in (8, 12, 12, 8)),
                                    torch.zeros(1, 2, 8),
                                    torch.zeros(1, 8, 2, 16))
    q, k = torch.randn(1, 8, 2, 16), torch.randn(1, 12, 2, 16)
    o = ops.flash_attention(q, k, k, causal=False)
    lse = kf.flash_attention_lse_ref(q, k, causal=False)
    dq, dk, dv = kf.flash_attention_backward(q, k, k, o, lse,
                                             torch.ones_like(o),
                                             causal=False)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
