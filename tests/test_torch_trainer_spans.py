"""Spans inside the port's PoFEL trainer (``repro_torch.obs`` in
``fl.pofel_trainer`` and ``launch.train``), on the CPU at the reduced
MusicGen-medium: each round one span tree, a traced round bit-identical
to an untraced one, no device readings off the card, the collector's
passes recorded without disturbing the span stack or the span ids, the
Chrome export and the launcher's ``--trace`` file. On the card (marked
``cuda``): the device's readings, children within their parents. No
JAX.
"""

import contextlib
import gc
import importlib.util
import threading
from pathlib import Path

import pytest
import torch

from repro_torch import obs
from repro_torch.blockchain.ledger import Ledger
from repro_torch.configs import get_config
from repro_torch.core import crypto
from repro_torch.core.serialization import leaves_with_paths
from repro_torch.data.tokens import TokenBatchSpec, synthetic_token_batches
from repro_torch.fl import pofel_trainer as pt
from repro_torch.launch import train
from repro_torch.models.model_api import Model
from repro_torch.models.transformer import FwdOptions
from repro_torch.obs import recorder as recorder_mod
from repro_torch.obs.spans import SpanRecord

C = 2
READINGS = ("device_ms", "alloc_bytes", "mem_start_bytes", "mem_bytes")


def _trainer(device):
    """(model, config, state, batch, λ): the reduced MusicGen-medium, C
    clusters of 2 sequences of 8 tokens, with the launcher's context."""
    cfg = get_config("musicgen-medium").reduced()
    model = Model(cfg, device=device)
    tcfg = pt.PoFELTrainConfig(n_clusters=C, inner_lr=1e-2)
    state = pt.init_train_state(
        model, tcfg, torch.Generator(device=device).manual_seed(0))
    raw = next(synthetic_token_batches(
        TokenBatchSpec(2 * C, 8, cfg.vocab_size), seed=0))
    batch = train.round_batch(raw, model, C, torch.device(device))
    lam = torch.ones((C,), dtype=torch.float32, device=device)
    return model, tcfg, state, batch, lam


@pytest.fixture(scope="module")
def trainer():
    return _trainer("cpu")


def _rounds(trainer, rec, rounds=1):
    """``rounds`` rounds from the trainer's state under ``rec``, each
    block appended; [(new state, metrics)]."""
    model, tcfg, state, batch, lam = trainer
    ledger, keypair = Ledger(0), crypto.ECDSAKeyPair.generate(b"spans")
    out = []
    with obs.use_recorder(rec):
        for k in range(rounds):
            state, m = pt.pofel_round(model, state, batch, lam, tcfg,
                                      FwdOptions(remat=False))
            train.append_round_block(ledger, keypair, k, m)
            out.append((state, m))
    return out


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def _children(rec, span):
    return sorted((s for s in rec.spans
                   if s.parent == span.span_id and s.name != "gc"),
                  key=lambda s: s.wall_start)


def _check_tree(rec, rounds):
    roots = _named(rec, "pofel_round")
    assert len(roots) == rounds
    for root in roots:
        assert root.parent is None and root.cat == "trainer"
        step, cons = _children(rec, root)
        assert (step.name, cons.name) == ("local_step", "consensus")
        assert [s.name for s in _children(rec, step)] == ["forward",
                                                          "update"]
        assert not _children(rec, cons)
        for s in (step, cons, *_children(rec, step)):
            assert s.cat == "trainer" and s.error is None
    chains = _named(rec, "chain")
    assert len(chains) == rounds
    assert all(s.parent is None and s.cat == "chain" for s in chains)
    assert rec.depth() == 0


@pytest.mark.parametrize("rounds", [1, 2])
def test_each_round_is_one_span_tree(trainer, rounds):
    rec = obs.TraceRecorder("spans")
    _rounds(trainer, rec, rounds)
    _check_tree(rec, rounds)


def test_a_traced_round_is_bit_identical_to_an_untraced_one(trainer):
    (plain, pm), = _rounds(trainer, obs.NullRecorder())
    rec = obs.TraceRecorder("spans", device="cpu")
    with obs.record_collector(rec):
        (traced, tm), = _rounds(trainer, rec)
    assert _named(rec, "pofel_round")
    for a, b in zip(plain, traced):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
            continue
        pa, pb = leaves_with_paths(a), leaves_with_paths(b)
        assert [p for p, _ in pa] == [p for p, _ in pb]
        for (path, x), (_, y) in zip(pa, pb):
            assert x.dtype == y.dtype and torch.equal(x, y), path
    for x, y in zip(pm, tm):
        assert torch.equal(x, y)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_no_device_readings_off_the_card(trainer, device):
    rec = obs.TraceRecorder("spans", device=device)
    _rounds(trainer, rec)
    rec.resolve()
    assert rec.spans
    for s in rec.spans:
        assert all(getattr(s, k) is None for k in READINGS), s


@pytest.mark.parametrize("where", ["open_span", "close_span",
                                   "threshold_1"])
def test_a_collection_inside_the_recorder_leaves_the_stack_intact(
        trainer, where, monkeypatch):
    """A full collection forced in the middle of ``open_span`` (between
    taking the span's id and pushing it) or of ``close_span`` (between
    popping the span and storing its record), or one after nearly every
    allocation: the span ids stay unique, the stack unwinds to empty, the
    trainer's tree is whole and each ``gc`` span carries its pass."""
    target = {"open_span": "_OpenSpan",
              "close_span": "SpanRecord"}.get(where)
    if target is not None:
        real = getattr(recorder_mod, target)

        def forcing(*a, **kw):
            if kw.get("name", a[1] if len(a) > 1 else None) != "gc":
                gc.collect()
            return real(*a, **kw)

        monkeypatch.setattr(recorder_mod, target, forcing)
    rec = obs.TraceRecorder("spans")
    threshold = gc.get_threshold()
    if where == "threshold_1":
        gc.set_threshold(1)
    try:
        with obs.record_collector(rec):
            _rounds(trainer, rec, 2)
    finally:
        gc.set_threshold(*threshold)
    ids = [s.span_id for s in rec.spans]
    assert len(ids) == len(set(ids))
    assert {s.parent for s in rec.spans} <= set(ids) | {None}
    _check_tree(rec, 2)
    passes = _named(rec, "gc")
    assert len(passes) >= (14 if target else 1)
    for s in passes:
        assert s.cat == "host" and s.attrs["generation"] in (0, 1, 2)
        assert s.attrs["collected"] >= 0 and s.wall_dur >= 0


@pytest.mark.parametrize("how", ["exit", "exception"])
def test_record_collector_removes_its_callback(how):
    rec = obs.TraceRecorder("spans")
    before = list(gc.callbacks)
    with pytest.raises(RuntimeError) if how == "exception" else \
            contextlib.nullcontext():
        with obs.record_collector(rec):
            assert len(gc.callbacks) == len(before) + 1
            gc.collect()
            if how == "exception":
                raise RuntimeError("inside the block")
    assert gc.callbacks == before
    assert 2 in [s.attrs["generation"] for s in rec.spans]
    n = len(rec.spans)
    gc.collect()
    assert len(rec.spans) == n


def test_the_null_recorder_stays_a_shared_no_op():
    null = obs.NullRecorder()
    assert obs.get_recorder().enabled is False
    assert null.span("pofel_round", cat="trainer") is recorder_mod._NOOP_SPAN
    before = list(gc.callbacks)
    with obs.record_collector(null):
        assert gc.callbacks == before


def test_the_chrome_export_carries_the_new_attributes(trainer, tmp_path):
    rec = obs.TraceRecorder("spans")
    with obs.record_collector(rec):
        _rounds(trainer, rec)
        with obs.use_recorder(rec), rec.span("outer"):
            gc.collect()
    step = _named(rec, "local_step")[0]
    # the card's readings, stood in by hand on the CPU
    step.device_ms, step.alloc_bytes = 1.5, 4096
    step.mem_start_bytes, step.mem_bytes = 1024, 2048
    path = tmp_path / "trace.json"
    obs.write_chrome_trace(str(path), [("spans", rec)])
    spans = [e for e in obs.load_trace(str(path))["traceEvents"]
             if e["ph"] == "X"]
    by_id = {e["args"]["span_id"]: e for e in spans}
    args = by_id[step.span_id]["args"]
    assert [args[k] for k in READINGS] == [1.5, 4096, 1024, 2048]
    forward = by_id[_named(rec, "forward")[0].span_id]["args"]
    assert not set(READINGS) & set(forward)
    outer = _named(rec, "outer")[0]
    inside = [e for e in spans if e["name"] == "gc"
              and e["args"]["parent"] == outer.span_id]
    assert inside and inside[-1]["cat"] == "host"
    assert inside[-1]["args"]["generation"] == 2
    assert "collected" in inside[-1]["args"]


def test_the_launcher_writes_its_trace(tmp_path, capsys):
    path = tmp_path / "train.json"
    threshold = gc.get_threshold()
    gc.set_threshold(10)       # passes in a run this short, surely
    try:
        train.main(["--arch", "musicgen-medium", "--steps", "2",
                    "--clusters", "2", "--batch", "4", "--seq", "8",
                    "--device", "cpu", "--trace", str(path)])
    finally:
        gc.set_threshold(*threshold)
    out = capsys.readouterr().out
    assert "chain verified at height 2" in out and "trace:" in out
    names = [e["name"] for e in obs.load_trace(str(path))["traceEvents"]
             if e["ph"] == "X"]
    for name in ("pofel_round", "local_step", "forward", "update",
                 "consensus", "chain"):
        assert names.count(name) == 2, name
    assert "gc" in names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_readings_on_the_card(card):
    """Each span's events nest on the one stream, so a child's
    ``device_ms`` is at most its parent's; the allocator's readings are
    there, and ``local_step`` hands out at least its children's bytes."""
    trainer = _trainer(card)
    _rounds(trainer, obs.NullRecorder())     # warm every shape
    rec = obs.TraceRecorder("spans", device=card)
    _rounds(trainer, rec, 2)
    torch.cuda.synchronize(card)
    rec.resolve()
    _check_tree(rec, 2)
    by_id = {s.span_id: s for s in rec.spans}
    for s in rec.spans:
        assert s.device_ms is not None and s.device_ms >= 0
        assert s.alloc_bytes >= 0 and s.mem_bytes > 0, s
        if s.parent is not None:
            assert s.device_ms <= by_id[s.parent].device_ms + 1e-3, s
    for step in _named(rec, "local_step"):
        kids = _children(rec, step)
        assert step.alloc_bytes >= sum(k.alloc_bytes for k in kids)


class _BackwardThread(torch.autograd.Function):
    """The identity, noting in ``threads`` the thread its backward runs
    on."""

    generate_vmap_rule = True
    threads: list = []

    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        _BackwardThread.threads.append(threading.get_ident())
        return g


@pytest.mark.cuda
def test_local_step_backward_runs_on_the_calling_thread(card, monkeypatch):
    """On the card autograd would run the backward on its device thread,
    whose graph task holds the gradients until that thread next runs;
    ``local_step`` keeps the backward on the caller's thread, so the
    update frees each gradient as it applies it."""
    model, tcfg, state, batch, _ = _trainer(card)
    loss = type(model).loss
    monkeypatch.setattr(type(model), "loss", lambda self, *a, **kw:
                        _BackwardThread.apply(loss(self, *a, **kw)))
    monkeypatch.setattr(_BackwardThread, "threads", [])
    pt.local_step(model, state.cluster_params, batch, tcfg,
                  FwdOptions(remat=False))
    assert _BackwardThread.threads
    assert set(_BackwardThread.threads) == {threading.get_ident()}


def _tool():
    """``tools/trainer_spans.py``, loaded by its path."""
    path = Path(__file__).resolve().parents[1] / "tools" / "trainer_spans.py"
    spec = importlib.util.spec_from_file_location("trainer_spans", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(span_id, name, parent, start, dur, device_ms=None,
          alloc_bytes=None, depth=0, **attrs):
    return SpanRecord(span_id, name, "trainer", None, None, parent, depth,
                      start, dur, attrs=attrs, device_ms=device_ms,
                      alloc_bytes=alloc_bytes)


def _made_rounds(card: bool):
    """Two rounds of hand-made spans, with the card's readings or
    without, and a collector pass in each round and one outside."""
    spans = []
    for r in range(2):
        b, t = 10 * r, 10.0 * r

        def dev(ms):
            return ms if card else None

        spans += [
            _span(b, "pofel_round", None, t, 2.0, dev(1900.0), None),
            _span(b + 1, "local_step", b, t, 1.8, dev(1800.0 + r),
                  dev(5 * 2 ** 30), 1),
            _span(b + 2, "forward", b + 1, t, 0.2, dev(200.0), dev(2 ** 30),
                  2),
            _span(b + 3, "gc", b + 1, t + 0.5, 0.03, depth=2,
                  generation=r, collected=7),
            _span(b + 4, "update", b + 1, t + 1.6, 0.1, dev(90.0),
                  dev(2 ** 29), 2),
            _span(b + 5, "consensus", b, t + 1.8, 0.02, dev(20.0),
                  dev(0), 1)]
    return spans + [_span(99, "gc", None, 30.0, 0.04, generation=2,
                          collected=0)]


@pytest.mark.parametrize("card", [True, False], ids=["card", "cpu"])
def test_per_round_reads_the_trainer_layers(card):
    got = _tool().per_round(_made_rounds(card))
    assert got["rounds"] == 2
    assert got["gc_ms"] == pytest.approx((0.03 + 0.03 + 0.04) * 1e3 / 2)
    assert got["local_step_host_ms"] == pytest.approx(1800.0)
    if not card:
        for key in ("forward_ms", "update_ms", "backward_ms",
                    "backward_churn_gib", "local_step_device_ms"):
            assert got[key] is None, key
        return
    assert got["forward_ms"] == pytest.approx(200.0)
    assert got["update_ms"] == pytest.approx(90.0)
    assert got["backward_ms"] == pytest.approx(1800.5 - 290.0)
    assert got["backward_churn_gib"] == pytest.approx(5 - 1 - 0.5)
    assert got["consensus_device_ms"] == pytest.approx(20.0)


def test_per_round_reads_nothing_without_a_round():
    tool = _tool()
    assert tool.per_round([]) is None
    assert tool.per_round([s for s in _made_rounds(True)
                           if s.name != "pofel_round"]) is None


class _Harness:
    """A stand-in for the benchmark's host spans: ``local_step`` over
    [0, 2) s, else the harness."""

    def innermost(self, t):
        return "local_step" if 0.0 <= t < 2.0 else "harness"


def test_idle_gaps_go_to_the_innermost_program_span():
    """Gaps on the host clock: one in the forward, one in a collector
    pass inside local_step, one in local_step's own time, one in
    consensus; one where no program span is open (the harness's span),
    one after everything. Each gap is charged once: the sum stays."""
    spans = _made_rounds(True)[:6]
    gaps = [(0.05, 0.15), (0.51, 0.52), (1.0, 1.3), (1.805, 1.81),
            (2.5, 2.6), (5.0, 5.5)]
    got = dict(_tool().idle_by_program_span(gaps, spans, _Harness()))
    assert got == pytest.approx({
        "forward": 0.1, "gc": 0.01, "local_step": 0.3, "consensus": 0.005,
        "harness": 0.6})
    assert sum(got.values()) == pytest.approx(sum(b - a for a, b in gaps))
    fallback = dict(_tool().idle_by_program_span(gaps, [], _Harness()))
    assert fallback == pytest.approx({"local_step": 0.415, "harness": 0.6})
