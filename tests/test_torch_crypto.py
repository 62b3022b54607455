"""The port's crypto (``repro_torch.core.crypto``) against the reference's
(``repro.core.crypto``), on the CPU.

Signatures are bytes, so they are compared exactly; so are ``dverify``'s
and ``verify_batch``'s decisions, for every backend of the port (the
``torch`` limb backend with ``device="cpu"``, its plain ladder) against
the reference's ``batch`` backend, on seeded sets with and without
forgeries and with one adversarial item whose nonce point R is its
public key. The limb field ops are held to Python big integers mod p,
and the plain ladder to the reference's ``_rlc_kernel`` limb for limb
(under ``jax.enable_x64``, at 8 steps and 4 lanes). The reference's
ladder runs under ``jax.disable_jit``: its ``fori_loop`` then runs as a
Python loop, op by op (~13 s), where XLA's compile of the loop body takes
many minutes on a CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import crypto as jcrypto
from repro.core.crypto.backends import jax as jlimb
from repro_torch.core import crypto
from repro_torch.core.crypto import curve
from repro_torch.core.crypto.backends import limb
from repro_torch.core.crypto.backends.limb import LimbOps
from repro_torch.kernels import rlc_ladder as rl

P = limb._P
PORT_BACKENDS = ("naive", "windowed", "batch", "glv", "torch")


def _signed(pkg, n: int, forged=(), seed: int = 0) -> list:
    """``n`` (tag, PK, digest) triples of ``pkg`` (either crypto package)
    from seeded keys; the items in ``forged`` carry another digest; one
    more item at the end has R = PK (r = PK.x, v = PK.y's parity)."""
    out = []
    for i in range(n):
        kp = pkg.ECDSAKeyPair.generate(b"crypto-test-%d-%d" % (seed, i))
        d = pkg.sha256_digest(b"msg", bytes([seed, i]))
        tag = pkg.dsign(d, kp.private_key)
        if i in forged:
            d = pkg.sha256_digest(b"forged", bytes([seed, i]))
        out.append((tag, kp.public_key, d))
    kp = pkg.ECDSAKeyPair.generate(b"crypto-test-pk-is-r-%d" % seed)
    pk = kp.public_key
    out.append((pkg.Signature(pk[0] % curve.N, 12345, pk[1] & 1), pk,
                pkg.sha256_digest(b"pk-is-r", bytes([seed]))))
    return out


@pytest.fixture
def torch_on_cpu(monkeypatch):
    """The ``torch`` backend on its plain ladder (the CPU)."""
    monkeypatch.setitem(crypto._OPS, "torch", LimbOps(device="cpu"))


@pytest.mark.parametrize("seed", range(3))
def test_dsign_gives_the_reference_bytes(seed):
    for i in range(4):
        kp = crypto.ECDSAKeyPair.generate(b"k%d-%d" % (seed, i))
        jkp = jcrypto.ECDSAKeyPair.generate(b"k%d-%d" % (seed, i))
        assert kp.public_key == jkp.public_key
        d = crypto.sha256_digest(b"d", bytes([seed, i]))
        assert d == jcrypto.sha256_digest(b"d", bytes([seed, i]))
        assert crypto.dsign(d, kp.private_key).to_bytes() == \
            jcrypto.dsign(d, jkp.private_key).to_bytes()


@pytest.mark.parametrize("forged", [(), (1,)], ids=["valid", "forged"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_verify_batch_and_dverify_decide_as_the_reference(
        torch_on_cpu, backend, forged):
    n = 3
    port, ref = _signed(crypto, n, forged), _signed(jcrypto, n, forged)
    assert [t.to_bytes() for t, _, _ in port] == \
        [t.to_bytes() for t, _, _ in ref]
    want = jcrypto.verify_batch(ref, backend="batch")
    before = rl.launches
    got = crypto.verify_batch(port, backend=backend)
    assert got == (want.ok, want.bad)
    assert want.bad == tuple(sorted(set(forged) | {n}))   # R = PK forged
    assert rl.launches == before                 # the CPU: no kernel
    with crypto.use_backend("batch" if backend == "torch" else backend):
        assert [crypto.dverify(*it) for it in port] == \
            [jcrypto.dverify(*it) for it in ref]


def _edge_and_random(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, P - 1, P - 2, P - 977, (1 << 255), (1 << 224) - 1,
            (1 << 256) - (1 << 32) - 978]
    rand = [int.from_bytes(rng.bytes(32), "big") % P for _ in range(n)]
    return [v % P for v in edge] + rand


def _limbs(vals) -> torch.Tensor:
    return torch.from_numpy(np.stack([limb.to_limbs(v) for v in vals])
                            .astype(np.int64))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr", "small"])
def test_field_ops_agree_with_big_integers(op):
    a_vals = _edge_and_random(40, 0)
    b_vals = a_vals[::-1]                    # every edge meets every other
    a, b = _limbs(a_vals), _limbs(b_vals)
    if op == "small":
        outs = {m: limb.ff_small(a, m) for m in (2, 3, 4, 8)}
        for m, out in outs.items():
            assert [limb.from_limbs(r) for r in out.numpy()] == \
                [v * m % P for v in a_vals]
        return
    fn, want = {"add": (limb.ff_add, lambda x, y: (x + y) % P),
                "sub": (limb.ff_sub, lambda x, y: (x - y) % P),
                "mul": (limb.ff_mul, lambda x, y: x * y % P),
                "sqr": (lambda x, _y: limb.ff_sqr(x),
                        lambda x, _y: x * x % P)}[op]
    out = fn(a, b).numpy()
    assert ((out >= 0) & (out < 1 << 32)).all()
    assert [limb.from_limbs(r) for r in out] == \
        [want(x, y) for x, y in zip(a_vals, b_vals)]
    zeros = limb.ff_is_zero(_limbs([0, 1, P - 1]))
    assert zeros.tolist() == [True, False, False]


def test_plain_ladder_matches_the_reference_kernel_limb_for_limb():
    rng = np.random.default_rng(7)
    S, L = 8, 4
    vals = [int.from_bytes(rng.bytes(32), "big") % P
            for _ in range(2 * S * L)]
    sx = np.stack([limb.to_limbs(v) for v in vals[:S * L]]).reshape(S, L, 8)
    sy = np.stack([limb.to_limbs(v) for v in vals[S * L:]]).reshape(S, L, 8)
    use = rng.random((S, L)) < 0.75
    use[0, 0] = False                       # a lane that starts late
    with jax.enable_x64(), jax.disable_jit():
        want = [np.asarray(x) for x in jlimb._rlc_kernel(
            jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(use))]
    got = limb.rlc_ladder_ref(torch.from_numpy(sx.astype(np.int64)),
                              torch.from_numpy(sy.astype(np.int64)),
                              torch.from_numpy(use))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint64), w)


def test_prepared_addends_of_a_pk_is_r_lane_mask_its_infinite_slot():
    """PK = R makes the combination slot P1 + P3 (or P2 + P3) the point at
    infinity; ``prepare`` masks it off, and the digits that pick it add
    nothing."""
    kp = crypto.ECDSAKeyPair.generate(b"pk-is-r")
    pk = kp.public_key
    group = [(5, 7, pk, pk), (11, 13, pk, pk)]
    sg, sx, sy, use = limb.prepare(group)
    assert sx.shape == (130, 2, 8) and use.shape == (130, 2)
    assert sx.dtype == np.int64 and ((sx >= 0) & (sx < 1 << 32)).all()
    assert (sx[use] != 0).any(-1).all()       # no used slot is infinity
    assert not use.all()
    assert not limb.fold(sg, *[x.numpy() for x in limb.rlc_ladder_ref(
        torch.from_numpy(sx), torch.from_numpy(sy), torch.from_numpy(use))],
        n=2)


def test_calibrate_without_a_card_keeps_batch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(crypto, "_CALIBRATION", None)
    assert crypto._calibrate() == "batch"
    info = crypto.calibration_info()
    assert info["chosen"] == "batch" and "no CUDA device" in info["reason"]


def _failing_ladder(*args):
    raise RuntimeError("rlc_ladder: launch failed")


def _wrong_ladder(step_x, step_y, step_use, _right=rl.rlc_ladder):
    X, Y, Z = _right(step_x, step_y, step_use)
    return X, Y, torch.zeros_like(Z)


@pytest.mark.parametrize("ladder,match", [(_failing_ladder, "launch failed"),
                                          (_wrong_ladder, "equation")],
                         ids=["fails", "wrong"])
def test_calibrate_with_a_broken_ladder_raises(monkeypatch, ladder, match):
    """With a card and a built library (both faked here) ``auto`` probes
    the torch ladder, and a ladder that fails or gives a wrong point
    raises: verification does not settle on the host in silence."""
    from repro_torch.core.crypto import aotcache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(aotcache, "has_cached_kernels", lambda: True)
    monkeypatch.setitem(crypto._OPS, "torch", LimbOps(device="cpu"))
    monkeypatch.setattr(crypto, "_CALIBRATION", None)
    monkeypatch.setattr(rl, "rlc_ladder", ladder)
    with pytest.raises(RuntimeError, match=match):
        crypto._calibrate(probe_n=4)
    assert crypto.calibration_info() is None


def test_limb_ops_without_a_card_or_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        LimbOps()
    monkeypatch.delitem(crypto._OPS, "torch", raising=False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        crypto.set_backend("torch")
    assert crypto.get_backend() == "batch"
    assert LimbOps(device="cpu").device.type == "cpu"
