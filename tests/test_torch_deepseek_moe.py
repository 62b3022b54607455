"""DeepSeek-MoE's dropless expert layer of one expert-parallel chip
(``models.moe`` with ``capacity_factor`` 0, ``router_experts``, a
leading dense layer, the published ungated top-k) against the plain
reference of the benchmark (``perfbench/reference/moe.py``), on the CPU
at a reduced size.

The program runs with its compute dtype set to float32 and its weights
in float32 (as ``perfbench/tests/test_perfbench_reference.py`` runs
it), so both sides compute in float32 and differ by the order of their
sums alone: losses within rtol 2e-6, each gradient within 1e-5 of its
own norm (sums over up to T·k rows in another order, through three
layers; both read ~1e-6 here). Both route on their own activations; the top-k choices agree
unless two router scores lie within float32 rounding, which the seeds
here do not meet.

The ``cuda`` tests run on a card (PYTHONPATH=src python3 -m pytest -q
tests/test_torch_deepseek_moe.py -m cuda): the grouped products and the
expert rows at the benchmark's widths against a per-expert loop, in
bfloat16 (products rounded once, sums in float32 on both sides: 2e-2 of
the largest element), and one MoE layer's forward and backward under
``torch.cuda.set_sync_debug_mode("error")``, which raises on any
synchronize with the host. This file imports no JAX.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness.weights import (check_layout, flatten,  # noqa: E402
                                       nest)
from perfbench.reference import moe as ref                   # noqa: E402
from repro_torch.kernels import moe_grouped, ops             # noqa: E402
from repro_torch.models.config import ArchConfig             # noqa: E402
from repro_torch.models.model_api import Model               # noqa: E402
from repro_torch.models.moe import MoEConfig, moe_ffn        # noqa: E402
from repro_torch.models.transformer import FwdOptions        # noqa: E402

# the benchmark's configuration's shape, cut to a CPU test: 16 routed
# experts, 4 held here, top-6, 2 shared, one dense layer of 3
ARCH = dict(name="tiny-deepseek-moe", reference="moe", family="moe",
            n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
            d_ff=96, vocab_size=97, n_experts=4, router_experts=16,
            experts_per_token=6, n_shared_experts=2, moe_d_ff=32,
            capacity_factor=0.0, first_dense_layers=1, norm_topk=False,
            norm_eps=1e-6, rope_theta=10000.0)
NOOPTS = FwdOptions(remat=False)
LOSS = dict(rtol=2e-6, atol=0.0)
GRAD = 1e-5


def _cfg(arch: dict) -> ArchConfig:
    fields = ArchConfig.__dataclass_fields__
    return ArchConfig(**{k: v for k, v in arch.items() if k in fields})


@pytest.fixture
def fp32(monkeypatch):
    """The program's models with float32 activations."""
    from repro_torch.models import model_api, transformer
    for mod in (model_api, transformer):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def _tree(fn, t):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in t.items()}


def _params(arch: dict, seed: int = 0, router_scale: float = 1.0) -> dict:
    """float32 weights off their init constants (the norms' ones), the
    router scaled by ``router_scale``."""
    model = Model(_cfg(arch), device="cpu")
    p = _tree(lambda t: t.to(torch.float32),
              model.init(torch.Generator().manual_seed(seed)))
    g = torch.Generator().manual_seed(seed + 1)
    p = _tree(lambda t: t + 0.05 * torch.randn(t.shape, generator=g), p)
    p["layers"]["moe"]["router"] = p["layers"]["moe"]["router"] \
        * router_scale
    return p


def _batch(arch: dict, B: int, S: int, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, arch["vocab_size"], (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


def test_layout_is_the_references():
    """The program declares the reference's layout: the dense first layer
    apart, the router over all 16 experts, the 4 held experts' stacks."""
    shapes = Model(_cfg(ARCH), device="cpu").param_shapes()
    check_layout(ARCH, shapes)
    assert shapes["dense_layers"]["mlp"]["w_up"][0] == (1, 64, 96)
    assert shapes["layers"]["moe"]["router"][0] == (2, 64, 16)
    assert shapes["layers"]["moe"]["w_gate"][0] == (2, 4, 64, 32)
    assert shapes["layers"]["moe"]["shared"]["w_gate"][0] == (2, 64, 64)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_every_gradient_under_the_trainers_vmap(fp32, seed):
    """Two replicas of their own through ``vmap(grad_and_value(
    Model.loss))``, as ``fl.pofel_trainer.local_step`` runs them, against
    the reference's loss and gradients of each."""
    model = Model(_cfg(ARCH), device="cpu")
    reps = [_params(ARCH, seed + 10 * c) for c in range(2)]
    stacked = nest({p: torch.stack([flatten(r)[p] for r in reps])
                    for p in flatten(reps[0])})
    batch = _batch(ARCH, 2, 24, seed)
    per = {k: v.reshape(2, 1, -1) for k, v in batch.items()}

    def one(params, b):
        return torch.func.grad_and_value(
            lambda p, bb: model.loss(p, bb, NOOPTS))(params, b)

    grads, losses = torch.func.vmap(one)(stacked, per)
    for c in range(2):
        loss, want = ref.loss_and_grads(
            reps[c], {k: v[c:c + 1] for k, v in batch.items()}, ARCH)
        torch.testing.assert_close(losses[c], loss, **LOSS)
        got = flatten(grads)
        for path, g in flatten(want).items():
            assert _rel(got[path][c], g) < GRAD, path


def test_a_layer_whose_held_expert_no_token_picks(fp32):
    """One held expert of 16 and top-1, expert 0's router column zero and
    the others' scores ten times larger: no token picks it (one would if
    all its 15 other scores were negative), its stacks take no part in
    the loss, and both sides give them a zero gradient."""
    arch = dict(ARCH, n_experts=1, experts_per_token=1)
    model = Model(_cfg(arch), device="cpu")
    p = _params(arch, 9, router_scale=10.0)
    p["layers"]["moe"]["router"][:, :, 0] = 0.0
    batch = _batch(arch, 1, 24, 9)
    grads, loss = torch.func.grad_and_value(
        lambda q: model.loss(q, batch, NOOPTS))(p)
    want_loss, want = ref.loss_and_grads(p, batch, arch)
    torch.testing.assert_close(loss, want_loss, **LOSS)
    for name in ("w_gate", "w_up", "w_down"):
        assert not grads["layers"]["moe"][name].any()
        assert not want["layers"]["moe"][name].any()


def _layer_args(arch: dict, T: int, seed: int, bias: float = 0.0):
    """One MoE layer's float32 weights (the model's first MoE layer) and
    (T, D) tokens; ``bias`` is added to the router's column of expert 0."""
    p = _params(arch, seed)
    layer = _tree(lambda t: t[0], p["layers"]["moe"])
    layer["router"] = layer["router"].clone()
    layer["router"][:, 0] += bias
    g = torch.Generator().manual_seed(seed + 7)
    return layer, torch.randn((T, arch["d_model"]), generator=g)


def _ref_layer(arch: dict, layer: dict, x: torch.Tensor) -> tuple:
    flat = {"moe/" + k: v for k, v in flatten(layer).items()}
    return ref._experts(arch, ref.Products(), flat, x)


def _moe_cfg(arch: dict) -> MoEConfig:
    return MoEConfig(arch["n_experts"], arch["experts_per_token"],
                     arch["capacity_factor"],
                     router_experts=arch["router_experts"],
                     norm_topk=arch["norm_topk"])


def test_a_skewed_router_drops_no_row():
    """A router biased to held expert 0, which every token then picks:
    far past the capacity dispatch's slots, every assignment is computed,
    as the reference computes it, and the recorder counts each held and
    absent assignment."""
    from repro_torch import obs
    arch = dict(ARCH, router_experts=8, n_experts=4)
    layer, x = _layer_args(arch, 40, 3, bias=0.5)
    x = x + 1.0             # expert 0's score up by about 0.5 · D
    rec = obs.TraceRecorder("moe")
    with obs.use_recorder(rec):
        out, aux = moe_ffn(x, layer, _moe_cfg(arch))
    rec.resolve()
    want, want_aux = _ref_layer(arch, layer, x)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=1e-6)
    probs = torch.softmax(x @ layer["router"], -1)
    idx = torch.topk(probs, 6, -1).indices
    assert bool((idx[:, 0] == 0).all())
    held = int((idx < 4).sum())
    counts = rec.metrics_snapshot()["counters"]
    assert counts == {"moe_rows_held": held, "moe_rows_absent": 240 - held,
                      "moe_tokens": 40}
    # with the router cut to the 4 held experts and top-2, the capacity
    # dispatch (20 slots an expert) drops half of expert 0's 40 rows;
    # the dropless layer computes them, as the reference does
    own = dict(layer, router=layer["router"][:, :4])
    two = dict(arch, router_experts=4, experts_per_token=2)
    capped, _ = moe_ffn(x, own, MoEConfig(4, 2, 1.0, norm_topk=False))
    kept, _ = moe_ffn(x, own, _moe_cfg(two))
    torch.testing.assert_close(kept, _ref_layer(two, own, x)[0],
                               rtol=1e-5, atol=1e-5)
    assert _rel(capped, kept) > 0.05


def test_eight_shares_add_up_to_the_uncut_layer():
    """A 64-expert layer cut into the eight chips' shares of 8 experts:
    each chip's output less the shared experts (which every chip
    computes alike) summed, plus the shared experts once, is the uncut
    layer; each share is the reference's share."""
    arch = dict(ARCH, router_experts=64, n_experts=64, d_model=32,
                moe_d_ff=16)
    layer, x = _layer_args(arch, 48, 5)
    whole, _ = moe_ffn(x, layer, _moe_cfg(arch))
    torch.testing.assert_close(whole, _ref_layer(arch, layer, x)[0],
                               rtol=1e-5, atol=1e-5)
    sh = layer["shared"]
    shared = (torch.nn.functional.silu(x @ sh["w_gate"])
              * (x @ sh["w_up"])) @ sh["w_down"]
    held = dict(arch, n_experts=8)
    total = shared.clone()
    for s in range(8):
        mine = list(range(8 * s, 8 * s + 8))
        order = mine + [e for e in range(64) if e not in mine]
        share = dict(layer, router=layer["router"][:, order],
                     **{k: layer[k][8 * s:8 * s + 8]
                        for k in ("w_gate", "w_up", "w_down")})
        out, _ = moe_ffn(x, share, _moe_cfg(held))
        torch.testing.assert_close(out, _ref_layer(held, share, x)[0],
                                   rtol=1e-5, atol=1e-5)
        total += out - shared
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm_topk", [False, True])
def test_norm_topk_both_ways(norm_topk):
    """The published gating (the softmax's own top-k scores) and the
    renormalized one, each as the reference computes it; they differ."""
    arch = dict(ARCH, norm_topk=norm_topk)
    layer, x = _layer_args(arch, 32, 2)
    out, _ = moe_ffn(x, layer, _moe_cfg(arch))
    torch.testing.assert_close(out, _ref_layer(arch, layer, x)[0],
                               rtol=1e-5, atol=1e-5)
    other, _ = moe_ffn(x, layer, _moe_cfg(dict(arch,
                                               norm_topk=not norm_topk)))
    assert _rel(other, out) > 1e-2


def test_leading_dense_layer(fp32):
    """The first layer is a dense SwiGLU of width d_ff apart from the MoE
    stack: the model's loss is the reference's, and it is not the loss
    the same weights give with the dense layer left out."""
    model = Model(_cfg(ARCH), device="cpu")
    p = _params(ARCH, 4)
    batch = _batch(ARCH, 1, 20, 4)
    loss = model.loss(p, batch, NOOPTS)
    torch.testing.assert_close(loss, ref.loss_and_grads(p, batch, ARCH)[0],
                               **LOSS)
    moe_only = dict(ARCH, n_layers=2, first_dense_layers=0)
    q = {k: v for k, v in p.items() if k != "dense_layers"}
    assert abs(float(Model(_cfg(moe_only), device="cpu").loss(
        q, batch, NOOPTS)) - float(loss)) > 1e-3


def test_prefill_and_decode_walk_the_dense_layer_first():
    """Serving: a prefill of S tokens and one decode step give the last
    logits a forward over S + 1 tokens gives (bfloat16, the rule of the
    other families' serving tests: within 0.125 and 0.02 on average)."""
    model = Model(_cfg(ARCH), device="cpu")
    p = model.init(torch.Generator().manual_seed(6))
    toks = _batch(ARCH, 2, 9, 6)["tokens"]
    full, _ = model.forward(p, {"tokens": toks})
    _, cache = model.prefill(p, {"tokens": toks[:, :-1]})
    big = model.init_cache(2, 9)
    big = type(big)(*(b if c is None else b.index_copy(
        2, torch.arange(8), c) for b, c in zip(big, cache)))
    step, _ = model.decode_step(p, big, toks[:, -1:], 8)
    diff = (step[:, 0].float() - full[:, -1].float()).abs()
    assert float(diff.max()) <= 0.125 and float(diff.mean()) <= 0.02


def test_the_plain_grouped_product_leaves_no_row_past_the_groups_read():
    """The plain version fills the rows past the last offset with NaN and
    gives an empty group's dW zeros; the expert rows read none of them
    (their output is finite)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(10, 4, generator=g)
    b = torch.randn(3, 4, 5, generator=g)
    offs = torch.tensor([2, 2, 7], dtype=torch.int32)
    out = moe_grouped.grouped_mm(a, b, offs)
    assert bool(out[7:].isnan().all())
    torch.testing.assert_close(out[2:7], a[2:7] @ b[2])
    dw = moe_grouped.grouped_mm(a.t(), torch.randn(10, 5, generator=g),
                                offs)
    assert bool((dw[1] == 0).all())
    x = torch.randn(6, 4, generator=g)
    idx = torch.tensor([[0, 5, 1], [7, 6, 5], [1, 0, 2]] * 2)
    y = ops.moe_expert_rows(x, idx, b, b.clone(), torch.randn(
        3, 5, 4, generator=g))
    assert bool(torch.isfinite(y).all())
    assert bool((y[idx >= 3] == 0).all())


def test_routed_rows_are_kept_on_the_device_and_summed_in_bulk(monkeypatch):
    """Each launch keeps a view of its last offset (no kernel); every
    ``_FOLD`` launches they are summed into one, and reading them sums
    what is left; with no launch there is nothing to read."""
    monkeypatch.setattr(moe_grouped, "_FOLD", 3)
    moe_grouped.reset_counts()
    assert moe_grouped.routed_rows() == 0
    ends = [torch.tensor([2, 5, n], dtype=torch.int32) for n in range(7, 14)]
    for e in ends:
        moe_grouped._count(e)
    assert len(moe_grouped._rows[ends[0].device]) == 1     # folded at 7
    assert moe_grouped.launches == 7
    assert moe_grouped.routed_rows() == sum(range(7, 14))
    moe_grouped.reset_counts()
    assert (moe_grouped.launches, moe_grouped.routed_rows()) == (0, 0)


def _grad_gap_tool():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "moe_grad_gap", ROOT / "tools" / "moe_grad_gap.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_the_gap_tools_reference_routing_is_the_references():
    """``tools/moe_grad_gap.py``'s copy of the reference's expert FFN,
    given the reference's own choices, gives its loss and gradients to
    the bit; the choices it keeps are one (T, k) a MoE layer."""
    tool = _grad_gap_tool()
    params, one = _params(ARCH, 3), _batch(ARCH, 2, 12, 3)
    loss, grads = ref.loss_and_grads(params, one, ARCH)
    seen = {}
    with tool.reference_routing(seen, None):
        loss_seen, _ = ref.loss_and_grads(params, one, ARCH)
    assert sorted(seen) == [0, 1]
    assert seen[0].shape == (one["tokens"].numel(), 6)
    with tool.reference_routing({}, [seen[0], seen[1]]):
        loss_forced, forced = ref.loss_and_grads(params, one, ARCH)
    assert float(loss_seen) == float(loss) == float(loss_forced)
    for p, g in flatten(grads).items():
        assert torch.equal(flatten(forced)[p], g), p


def test_the_gap_tool_reads_a_small_cell():
    """The tool's readings on the CPU at a small size (1,024 tokens a
    cluster over a vocabulary of 128): one routing a MoE layer; the
    program's choices forced on the reference bring the held experts'
    gradients within a few bfloat16 roundings of the program's; the
    embedding's gradient, its repeated tokens' rows summed in bfloat16,
    comes out low, and summed in float32 it comes out within 1 %."""
    tool = _grad_gap_tool()
    small = dict(n_layers=3, d_model=64, n_heads=2, n_kv_heads=2,
                 head_dim=32, d_ff=96, vocab_size=128, n_experts=4,
                 router_experts=16, moe_d_ff=32)
    r = tool.readings("deepseek-moe-16b.round-1x4096", 2 ** 31 + 11, "cpu",
                      small, dict(seq_len=1024, pool=2))
    e32 = r["embed_float32_sums"]
    assert r["own"]["embed_norm_ratio"] < 0.99
    assert e32["norm_gap"] < 0.01 < e32["norm_gap_before"]
    assert len(r["flips"]["layers"]) == 2
    assert 0.0 <= r["flips"]["mean"] <= 1.0
    for mode in ("own", "forced"):
        assert r[mode]["first_loss_gap"] < 1e-2
        assert set(r[mode]["diff"]) >= {"embed", "layers/moe/w_gate"}
    for leaf in ("layers/moe/w_gate", "layers/moe/w_up", "layers/moe/w_down"):
        assert r["forced"]["diff"][leaf] < 0.05, leaf


def test_the_trainers_forward_holds_a_moe_span_a_layer():
    """One FEL step of two clusters under a recorder: a ``moe`` span for
    each of the two MoE layers inside the ``forward`` span, and the
    counters, handed over on the device, added at ``resolve``: every
    assignment of the 2 · 16 tokens, held or absent, in each layer."""
    from repro_torch import obs
    from repro_torch.fl import pofel_trainer as pt
    model = Model(_cfg(ARCH), device="cpu")
    tcfg = pt.PoFELTrainConfig(n_clusters=2, inner_lr=0.01)
    state = pt.init_train_state(model, tcfg,
                                torch.Generator().manual_seed(8))
    batch = {k: v.reshape(2, 1, -1) for k, v in _batch(ARCH, 2, 16,
                                                       8).items()}
    rec = obs.TraceRecorder("step")
    with obs.use_recorder(rec):
        pt.local_step(model, state.cluster_params, batch, tcfg, NOOPTS)
    rec.resolve()
    fwd = [sp for sp in rec.spans if sp.name == "forward"]
    moe = [sp for sp in rec.spans if sp.name == "moe"]
    assert len(fwd) == 1 and len(moe) == 2
    assert {sp.parent for sp in moe} == {fwd[0].span_id}
    c = rec.metrics_snapshot()["counters"]
    assert c["moe_tokens"] == 2 * 2 * 16
    assert c["moe_rows_held"] + c["moe_rows_absent"] == 2 * 2 * 16 * 6
    assert 0 < c["moe_rows_held"] < 2 * 2 * 16 * 6


def test_trainer_spans_reads_the_moe_spans():
    """``tools/trainer_spans.py``'s ``per_round`` gives the ``moe`` spans'
    device time a round."""
    import importlib.util
    from repro_torch.obs import SpanRecord
    path = ROOT / "tools" / "trainer_spans.py"
    spec = importlib.util.spec_from_file_location("trainer_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def span(i, name, parent, ms):
        return SpanRecord(i, name, "trainer", None, None, parent, 0, 0.0,
                          1.0, device_ms=ms, alloc_bytes=0)

    spans = [span(0, "pofel_round", None, 10.0),
             span(1, "local_step", 0, 8.0), span(2, "forward", 1, 3.0),
             span(3, "moe", 2, 1.0), span(4, "moe", 2, 1.5),
             span(5, "update", 1, 1.0), span(6, "consensus", 0, 1.0)]
    got = tool.per_round(spans)
    assert got["moe_spans"] == 2 and got["moe_ms"] == pytest.approx(2.5)
    assert "moe_ms" not in tool.per_round([sp for sp in spans
                                           if sp.name != "moe"])


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


BF16 = 2e-2     # of the largest element: bfloat16 products rounded once


def _close(a, b, what):
    err = float((a.float() - b.float()).abs().max())
    assert err <= BF16 * float(b.float().abs().max()), (what, err)


@pytest.mark.cuda
def test_grouped_products_on_the_card(cuda_device):
    """The three forms at the benchmark's widths (d 2048, f 1408) over 16
    groups of ragged sizes, one empty: the forward and dX-type products
    (rows past the groups not compared), the dW-type (an empty group
    zero); one launch each, counted with its rows."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    sizes = [390] * 16
    sizes[1], sizes[2] = 0, 393
    ends = torch.tensor(sizes, device=dev).cumsum(0).to(torch.int32)
    n, M, D, Fe = int(sum(sizes)), 49152, 2048, 1408
    x = torch.randn(M, D, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(16, D, Fe, generator=g, device=dev) / 45).to(
        torch.bfloat16)
    dy = torch.randn(M, Fe, generator=g, device=dev).to(torch.bfloat16)
    starts = [0] + ends.tolist()[:-1]
    ops.reset_launch_counts()
    fwd = moe_grouped.grouped_mm(x, w, ends)
    dx = moe_grouped.grouped_mm(dy, w.transpose(-2, -1), ends)
    dw = moe_grouped.grouped_mm(x.t(), dy, ends)
    counts = ops.launch_counts()
    assert (counts["moe_grouped"], counts["moe_grouped_rows"]) == (3, 3 * n)
    for e, (s, t) in enumerate(zip(starts, ends.tolist())):
        if t > s:
            _close(fwd[s:t], x[s:t].float() @ w[e].float(), ("fwd", e))
            _close(dx[s:t], dy[s:t].float() @ w[e].float().t(), ("dx", e))
            _close(dw[e], x[s:t].float().t() @ dy[s:t].float(), ("dw", e))
    assert bool((dw[1] == 0).all())


def _loop(x, idx, ws, dy):
    """Per expert, in float32: y and the gradients of Σ y·dy."""
    xs = x.float().requires_grad_()
    wf = [w.float().requires_grad_() for w in ws]
    y = torch.zeros(*idx.shape, x.shape[-1], device=x.device)
    for e in range(ws[0].shape[0]):
        t, j = torch.nonzero(idx == e, as_tuple=True)
        h = torch.nn.functional.silu(xs[t] @ wf[0][e]) * (xs[t] @ wf[1][e])
        y = y.index_put((t, j), h @ wf[2][e])
    (y * dy.float()).sum().backward()
    return y.detach(), xs.grad, [w.grad for w in wf]


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True], ids=["own", "shared"])
def test_expert_rows_under_vmap_on_the_card(cuda_device, shared):
    """Two clusters of 4096 tokens, top-6 over 64 experts, 8 held: the
    vmapped expert rows and their gradients against a per-expert loop,
    each cluster's weights its own or one expanded set; one launch a
    product for both clusters (3 forward, 11 with the gradient)."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(1)
    C, T, k, E, D, Fe = 2, 4096, 6, 8, 2048, 1408
    x = torch.randn(C, T, D, generator=g, device=dev).to(torch.bfloat16)
    idx = torch.topk(torch.randn(C, T, 64, generator=g, device=dev), k,
                     dim=-1).indices.to(torch.int32)
    ws = [(torch.randn(1 if shared else C, E, *s, generator=g, device=dev)
           / 45).to(torch.bfloat16) for s in ((D, Fe), (D, Fe), (Fe, D))]
    ws = [w.expand(C, *w.shape[1:]) for w in ws]
    dy = torch.randn(C, T, k, D, generator=g, device=dev).to(torch.bfloat16)

    def loss(xx, ii, a, b, c, d):
        return (ops.moe_expert_rows(xx, ii, a, b, c).float()
                * d.float()).sum()

    ops.reset_launch_counts()
    y = torch.func.vmap(ops.moe_expert_rows)(x, idx, *ws)
    assert ops.launch_counts()["moe_grouped"] == 3
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 2, 3, 4)))(
        x, idx, *ws, dy)
    assert ops.launch_counts()["moe_grouped"] == 14
    for c in range(C):
        want_y, want_dx, want_dw = _loop(x[c], idx[c], [w[c] for w in ws],
                                         dy[c])
        _close(y[c], want_y, "y")
        assert bool((y[c][idx[c] >= E] == 0).all())
        _close(grads[0][c], want_dx, "dx")
        for got, want in zip(grads[1:], want_dw):
            _close(got[c], want, "dw")


@pytest.mark.cuda
def test_a_moe_layer_never_synchronizes(cuda_device):
    """One dropless MoE layer (router over 64, 8 held, top-6, shared
    experts) forward and backward under the trainer's vmap(grad) with
    the card's sync debug mode at "error": a synchronize raises."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(2)
    C, T, D, Fe = 2, 4096, 2048, 1408

    def w(*s):
        return (torch.randn(C, *s, generator=g, device=dev)
                / s[-2] ** 0.5).to(torch.bfloat16)

    params = {"router": torch.randn(C, D, 64, generator=g, device=dev)
              / D ** 0.5, "w_gate": w(8, D, Fe), "w_up": w(8, D, Fe),
              "w_down": w(8, Fe, D), "shared": {"w_gate": w(D, 2 * Fe),
                                                "w_up": w(D, 2 * Fe),
                                                "w_down": w(2 * Fe, D)}}
    x = torch.randn(C, T, D, generator=g, device=dev).to(torch.bfloat16)
    cfg = MoEConfig(8, 6, 0.0, router_experts=64, norm_topk=False)

    def loss(p, xx):
        out, aux = moe_ffn(xx, p, cfg)
        return out.float().square().mean() + 0.01 * aux

    step = torch.func.vmap(torch.func.grad_and_value(loss))
    step(params, x)                     # warm: allocator, kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads, losses = step(params, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(losses).all())
    assert all(bool(torch.isfinite(t).all()) for t in flatten(grads).values())


def test_arch_keys_reach_the_config():
    """The configuration's new keys are ArchConfig's, with defaults that
    leave every other configuration as it was."""
    cfg = _cfg(ARCH)
    assert (cfg.n_router, cfg.first_dense_layers, cfg.norm_topk,
            cfg.capacity_factor) == (16, 1, False, 0.0)
    plain = ArchConfig("x", "moe", 2, 8, 1, 1, 8, 8)
    assert (plain.router_experts, plain.first_dense_layers, plain.norm_topk,
            plain.capacity_factor) == (0, 0, True, 1.25)
    assert dataclasses.replace(plain, n_experts=4).n_router == 4
