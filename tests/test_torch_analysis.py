"""The port's consensus-safety analyzer (``repro_torch.analysis``) against
the reference's (``repro.analysis``), on the CPU.

* Parity: over ``src tests benchmarks examples`` with the repo baseline,
  the port gives exactly the reference's findings, noqa-suppressed,
  baselined and stale entries for every file outside ``src/repro_torch``.
* Scopes: a path of the port gets the scopes of its twin in ``repro``.
* Fixtures at port paths: each rule family fires on a bad snippet and
  stays silent on its good twin, as the reference's does at the twin
  path; RA101 also catches torch's global generator.
* Registries: a port file is held to the port's ``KINDS``; the port's
  envelope raises no RA402/RA404 under the port's analyzer.
* The CLI's exit codes, the self-run, the port's own gate, and no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro import analysis as ref
from repro.analysis import core as ref_core
from repro_torch import analysis as port
from repro_torch.analysis import core as port_core
from repro_torch.analysis.__main__ import main as port_main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO_ROOT, "analysis-baseline.json")
PORT_PREFIX = "src/repro_torch/"

CONSENSUS = "src/repro_torch/core/tally_helper.py"
CRYPTO = "src/repro_torch/core/crypto/helper.py"
NEUTRAL = "src/repro_torch/launch/helper.py"
OBS = "src/repro_torch/obs/helper.py"
BENCH = "benchmarks/bench_helper.py"


def codes(report):
    return [f.rule for f in report.findings]


def twin(path: str) -> str:
    """The JAX package's path of a port path."""
    return path.replace("src/repro_torch/", "src/repro/")


def keyed(findings):
    return sorted((f.rule, f.path, f.line, f.col, f.message)
                  for f in findings if not f.path.startswith(PORT_PREFIX))


# ---------------------------------------------------------------------------
# parity with the reference outside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_reports():
    paths = ["src", "tests", "benchmarks", "examples"]
    return (ref.analyze_paths(paths, root=REPO_ROOT,
                              baseline=ref.load_baseline(BASELINE)),
            port.analyze_paths(paths, root=REPO_ROOT,
                               baseline=port.load_baseline(BASELINE)))


@pytest.mark.parametrize("field", ["findings", "suppressed", "grandfathered"])
def test_parity_with_reference_outside_the_port(both_reports, field):
    theirs, ours = both_reports
    assert keyed(getattr(ours, field)) == keyed(getattr(theirs, field))


def test_parity_stale_errors_and_file_count(both_reports):
    theirs, ours = both_reports
    assert ([e.key() for e in ours.stale_baseline]
            == [e.key() for e in theirs.stale_baseline])
    assert ours.errors == theirs.errors == []
    assert ours.files_analyzed == theirs.files_analyzed
    assert ours.ok and theirs.ok
    # the reference still reads the port's three envelope noqa lines; the
    # port's own analyzer has nothing to suppress there
    env = "src/repro_torch/core/envelope.py"
    assert sorted(f.rule for f in theirs.suppressed if f.path == env) == [
        "RA402", "RA402", "RA404"]
    assert [f for f in ours.suppressed + ours.findings if f.path == env] == []


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [
    "src/repro/core/hcds.py", "src/repro/blockchain/ledger.py",
    "src/repro/sim/network.py", "src/repro/fl/client.py",
    "benchmarks/bench_hcds.py", "src/repro/core/crypto/field.py",
    "src/repro/core/envelope.py", "src/repro/core/phases.py",
    "src/repro/core/btsv.py", "tests/test_hcds.py",
    "src/repro/obs/recorder.py", "src/repro/launch/serve.py",
    "examples/quickstart.py", "tests/test_torch_analysis.py",
])
def test_file_scopes_match_reference_and_twin(path):
    want = ref_core.file_scopes(path)
    assert port_core.file_scopes(path) == want
    if path.startswith("src/repro/"):
        port_path = path.replace("src/repro/", "src/repro_torch/")
        assert port_core.file_scopes(port_path) == want


def test_port_consensus_crypto_obs_scopes():
    fs = port_core.file_scopes
    for p in ("core/hcds.py", "blockchain/ledger.py", "sim/network.py"):
        assert {"consensus", "rng", "repro"} <= fs(f"src/repro_torch/{p}")
    for p in ("core/crypto/__init__.py", "core/hcds.py", "core/envelope.py",
              "core/phases.py"):
        assert "crypto" in fs(f"src/repro_torch/{p}")
    assert "obs" in fs("src/repro_torch/obs/export.py")
    # a part that merely starts with the name is not the package
    assert "repro" not in fs("build/repro_torch_kernels/core/x.py")


# ---------------------------------------------------------------------------
# fixtures at port paths: (rule, bad, good, path); the reference's analyzer
# gives the same codes at the twin path
# ---------------------------------------------------------------------------

FIXTURES = {
    "RA101-numpy": ("RA101", """
        import numpy as np
        def pick_round():
            return np.random.randint(1 << 30)
    """, """
        import numpy as np
        def pick_round(seed):
            return int(np.random.default_rng(seed).integers(1 << 30))
    """, CONSENSUS),
    "RA101-stdlib": ("RA101", """
        import random
        def jitter():
            return random.random()
    """, """
        import random
        def jitter(rng: random.Random):
            return rng.random()
    """, CONSENSUS),
    "RA101-bench": ("RA101", """
        import numpy as np
        W = np.random.normal(size=8)
    """, """
        import numpy as np
        W = np.random.default_rng(0).normal(size=8)
    """, BENCH),
    "RA102": ("RA102", """
        import time
        def deadline():
            return time.time() + 60.0
    """, """
        import time
        def stopwatch():
            return time.perf_counter()
    """, CONSENSUS),
    "RA103": ("RA103", """
        def finalize_commit_order(commits):
            order = {}
            for nid in {c.node_id for c in commits}:
                order[nid] = len(order)
            return order
    """, """
        def finalize_commit_order(commits):
            order = {}
            for nid in sorted({c.node_id for c in commits}):
                order[nid] = len(order)
            return order
    """, CONSENSUS),
    "RA151-hook": ("RA151", """
        def evict_on_phase(phase, ctx):
            ctx.rejected[0] = "nope"

        def install(consensus):
            consensus.add_phase_hook("*", evict_on_phase, when="after")
    """, """
        def watch(phase, ctx):
            print(phase, ctx.round, len(ctx.commitments))

        def install(consensus):
            consensus.add_phase_hook("*", watch, when="after")
    """, NEUTRAL),
    "RA151-obs": ("RA151", """
        def snapshot(rec, ctx):
            ctx.votes.clear()
            return dict(ctx.commitments)
    """, """
        def snapshot(rec, ctx, env):
            rec.observe("votes", len(ctx.votes))
            return env.network.now
    """, OBS),
    "RA201": ("RA201", """
        def check(reveal_digest, commitment):
            return reveal_digest != commitment.digest
    """, """
        import hmac
        def check(reveal_digest, commitment):
            return hmac.compare_digest(reveal_digest, commitment.digest)
    """, CRYPTO),
    "RA202": ("RA202", """
        def sign(digest, private_key):
            if private_key > 100:
                return fast_path(digest)
            return slow_path(digest)
    """, """
        def sign(digest, private_key):
            return point_mul_base_ct(private_key)
    """, CRYPTO),
    "RA203": ("RA203", """
        def sign_s(z, r, k_inv, private_key, N):
            return k_inv * (z + r * private_key) % N
    """, """
        def verify_u(z, r, w, N):
            return (z * w % N, r * w % N)
    """, CRYPTO),
    "RA401": ("RA401", """
        from repro_torch.core.envelope import SignedEnvelope
        def announce(round, sender, digest, sk):
            return SignedEnvelope.seal("gossip", round, sender, digest, sk)
    """, """
        from repro_torch.core.envelope import SignedEnvelope
        def announce(round, sender, digest, sk):
            return SignedEnvelope.seal("vote", round, sender, digest, sk)
    """, CONSENSUS),
    "RA402": ("RA402", """
        from repro_torch.core.envelope import SignedEnvelope
        def announce(kind, round, sender, digest, sk):
            return SignedEnvelope.seal(kind, round, sender, digest, sk)
    """, """
        from repro_torch.core.envelope import SignedEnvelope
        def announce(round, sender, digest, sk):
            return SignedEnvelope.seal("commit", round, sender, digest, sk)
    """, CONSENSUS),
    "RA403": ("RA403", """
        from repro_torch.core import crypto
        def sign_gossip(payload, sk):
            return crypto.dsign(crypto.sha256_digest(payload), sk)
    """, """
        from repro_torch.core import crypto
        from repro_torch.core.envelope import signing_digest
        def sign_vote(round, sender, payload_digest, sk):
            return crypto.dsign(
                signing_digest("vote", round, sender, payload_digest), sk)
    """, CONSENSUS),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rule_fires_on_bad_and_not_on_good_at_port_path(name):
    rule, bad, good, path = FIXTURES[name]
    bad, good = textwrap.dedent(bad), textwrap.dedent(good)
    assert codes(port.analyze_source(bad, path)) == [rule]
    assert codes(port.analyze_source(good, path)) == []
    # the reference holds the twin path to the same rule
    assert codes(ref.analyze_source(bad, twin(path))) == [rule]
    assert codes(ref.analyze_source(good, twin(path))) == []


def test_rules_out_of_scope_at_port_paths_silent():
    _, bad, _, _ = FIXTURES["RA101-numpy"]
    assert codes(port.analyze_source(textwrap.dedent(bad), NEUTRAL)) == []
    _, bad, _, _ = FIXTURES["RA201"]
    assert codes(port.analyze_source(textwrap.dedent(bad), NEUTRAL)) == []


def test_noqa_suppresses_at_port_path():
    report = port.analyze_source(textwrap.dedent("""
        import torch
        def pick():
            return torch.randint(0, 10, (1,))  # noqa: RA101
    """), CONSENSUS)
    assert codes(report) == []
    assert [f.rule for f in report.suppressed] == ["RA101"]


TORCH_BAD = [
    "torch.rand(3)", "torch.randn(2, 2)", "torch.randint(0, 5, (3,))",
    "torch.randperm(4)", "torch.bernoulli(p)", "torch.multinomial(p, 1)",
    "torch.normal(0.0, 1.0, (3,))", "x.uniform_()", "x.normal_(0.0, 1.0)",
    "x.bernoulli_(0.5)", "x.random_(0, 9)", "torch.empty(3).normal_()",
    "torch.manual_seed(0)", "torch.seed()",
]
TORCH_GOOD = [
    "torch.rand(3, generator=g)", "torch.randn(2, 2, generator=g)",
    "torch.randint(0, 5, (3,), generator=g)", "torch.randperm(4, generator=g)",
    "torch.multinomial(p, 1, generator=g)", "x.normal_(generator=g)",
    "x.uniform_(generator=g)", "torch.Generator().manual_seed(0)",
    "g.manual_seed(0)", "torch.zeros(3)", "x.add_(1)",
]


@pytest.mark.parametrize("expr", TORCH_BAD)
def test_ra101_torch_global_generator_fires(expr):
    src = f"import torch\ndef draw(x, p):\n    return {expr}\n"
    for path in (CONSENSUS, "src/repro_torch/sim/adversary.py", BENCH):
        assert codes(port.analyze_source(src, path)) == ["RA101"], path
    assert codes(port.analyze_source(src, NEUTRAL)) == []


@pytest.mark.parametrize("expr", TORCH_GOOD)
def test_ra101_torch_explicit_generator_silent(expr):
    src = f"import torch\ndef draw(x, p, g):\n    return {expr}\n"
    assert codes(port.analyze_source(src, CONSENSUS)) == []


# ---------------------------------------------------------------------------
# one envelope registry a package
# ---------------------------------------------------------------------------

REF_REGISTRY = """
KINDS = ("commit", "reveal", "vote", "block", "checkpoint")
_DOMAIN = b"pofel-envelope-v1"
"""
PORT_REGISTRY = """
KINDS = ("commit", "gossip")
_DOMAIN = b"pofel-envelope-v1"
"""
SEAL = """
from envelope import SignedEnvelope
def announce(round, sender, digest, sk):
    return SignedEnvelope.seal({kind!r}, round, sender, digest, sk)
"""


def _registry_report(kind: str, path: str):
    ctxs = [port.FileContext.parse(REF_REGISTRY, "src/repro/core/envelope.py"),
            port.FileContext.parse(PORT_REGISTRY,
                                   "src/repro_torch/core/envelope.py"),
            port.FileContext.parse(SEAL.format(kind=kind), path)]
    return port.analyze_contexts(ctxs)


@pytest.mark.parametrize("kind,path,want", [
    ("gossip", "src/repro_torch/core/gossip.py", []),
    ("vote", "src/repro_torch/core/gossip.py", ["RA401"]),
    ("vote", "src/repro/core/gossip.py", []),
    ("gossip", "src/repro/core/gossip.py", ["RA401"]),
    ("gossip", "tests/test_gossip.py", ["RA401"]),
])
def test_each_file_is_held_to_its_own_package_registry(kind, path, want):
    report = _registry_report(kind, path)
    assert codes(report) == want
    for f in report.findings:
        assert f.path == path


def test_domain_tag_compared_within_one_package():
    # both registries carry the same tag: no RA404 across packages
    assert codes(_registry_report("commit", "src/repro_torch/core/x.py")) == []
    offender = 'GOSSIP_DOMAIN = b"pofel-envelope-v1"\n'
    for path in ("src/repro_torch/core/gossip.py", "src/repro/core/gossip.py"):
        ctxs = [port.FileContext.parse(REF_REGISTRY,
                                       "src/repro/core/envelope.py"),
                port.FileContext.parse(PORT_REGISTRY,
                                       "src/repro_torch/core/envelope.py"),
                port.FileContext.parse(offender, path)]
        report = port.analyze_contexts(ctxs)
        assert [(f.rule, f.path) for f in report.findings] == [
            ("RA404", path)]


def test_port_registry_duplicate_kind_fires():
    dup = 'KINDS = ("commit", "vote", "vote")\n_DOMAIN = b"x"\n'
    ctx = port.FileContext.parse(dup, "src/repro_torch/core/envelope.py")
    assert codes(port.analyze_contexts([ctx])) == ["RA404"]


def test_port_envelope_clean_under_port_analyzer():
    report = port.analyze_paths(
        ["src/repro_torch/core/envelope.py", "src/repro/core/envelope.py",
         "src/repro_torch/core/phases.py", "src/repro_torch/core/hcds.py"],
        root=REPO_ROOT)
    assert report.findings == [] and report.errors == []
    assert [f for f in report.suppressed
            if f.rule in ("RA402", "RA404")] == []


# ---------------------------------------------------------------------------
# the CLI, the self-run, the port's gate, no JAX
# ---------------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "src" / "repro_torch" / "core" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\nNOISE = torch.randn(9)\n")
    monkeypatch.chdir(tmp_path)
    assert port_main(["src", "--format", "text"]) == 1
    assert port_main(["src", "--format", "github"]) == 1
    out = capsys.readouterr().out
    assert "::error file=src/repro_torch/core/bad.py" in out
    assert port_main(["src", "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in doc["findings"]] == ["RA101"]
    bad.write_text("import torch\n"
                   "NOISE = torch.randn(9, generator=torch.Generator()"
                   ".manual_seed(0))\n")
    assert port_main(["src"]) == 0
    assert port_main(["nonexistent-dir"]) == 2
    (tmp_path / "broken.json").write_text('{"entries": [{"rule": "RA101"}]}')
    assert port_main(["src", "--baseline", "broken.json"]) == 2
    assert port_main(["--list-rules"]) == 0


def test_analyzer_is_clean_on_itself():
    report = port.analyze_paths(["src/repro_torch/analysis"], root=REPO_ROOT)
    assert report.files_analyzed >= 10
    assert report.findings == [] and report.errors == []


def test_port_gate_is_clean():
    """``python -m repro_torch.analysis src/repro_torch`` exits 0: zero
    findings with the repo baseline; the signer's deliberate RA203 is the
    one noqa-suppressed finding."""
    report = port.analyze_paths(["src/repro_torch"], root=REPO_ROOT,
                                baseline=port.load_baseline(BASELINE))
    assert report.findings == [] and report.errors == []
    assert [(f.rule, f.path) for f in report.suppressed] == [
        ("RA203", "src/repro_torch/core/crypto/__init__.py")]


def test_analysis_imports_neither_jax_nor_reference():
    code = ("import sys; from repro_torch.analysis.__main__ import main; "
            "rc = main(['src/repro_torch/analysis']); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad or rc else 0)")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO_ROOT, "src")}
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "0 finding(s)" in done.stdout
