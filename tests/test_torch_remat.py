"""Rematerialization in the port (``repro_torch.models.remat``, reached
through ``FwdOptions(remat=True)``) on the CPU, at the reduced configs
of the six families: rwkv6-1.6b, yi-6b, zamba2-7b, deepseek-moe-16b,
musicgen-medium and llama-3.2-vision-90b (its cross-attention gates set
nonzero, so the cross blocks take part).

* Against the port without remat: the loss is bit-identical, and so are
  the gradients, under ``torch.func.grad_and_value`` and under
  ``torch.func.vmap`` of it over C = 2 replicas (the PoFEL trainer's
  form). The re-run block's vjp could add a weight's uses in another
  order than autograd does and differ in the last float32 bit; on these
  configs it does not, so the comparison is bitwise.
* Against the reference's ``jax.grad`` with ``FwdOptions(remat=True)``
  (``jax.checkpoint`` on the same blocks), from the reference's weights,
  with both packages computing in float32 (``COMPUTE_DTYPE`` patched,
  every leaf float32): ``tests/test_torch_lm_round.py``'s float32
  tolerance, rtol 1e-4 / atol 1e-5, and the loss within 1e-4. RWKV-6
  is the exception: its two backends' float32 gradients lie up to 7e-4
  of a leaf's largest entry apart (the embedding's, 3.2e-3 of 5.3) with
  remat and without alike, the ill-conditioning
  ``tests/test_torch_lm_round.py`` describes (a CPU measurement), so it
  is held at atol 1e-3 of each leaf's largest entry, and the reference's
  remat gradients are checked bit-identical to its own without remat: on
  both sides remat adds nothing.
* The forward keeps only the blocks' inputs for the backward; a block
  that fails when it runs again raises instead of falling back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model_api as j_api
import repro.models.ssm_models as j_ssm
import repro.models.transformer as j_tf
import repro_torch.models.model_api as t_api
import repro_torch.models.ssm_models as t_ssm
import repro_torch.models.transformer as t_tf
from repro.configs import get_config as j_get_config
from repro.models.model_api import Model as JModel
from repro.models.transformer import FwdOptions as JFwdOptions
from repro_torch.configs import get_config
from repro_torch.core.serialization import leaves_with_paths
from repro_torch.models.model_api import Model
from repro_torch.models.params_io import tree_from_numpy
from repro_torch.models.remat import checkpoint
from repro_torch.models.transformer import FwdOptions

ARCHS = ["rwkv6-1.6b", "yi-6b", "zamba2-7b", "deepseek-moe-16b",
         "musicgen-medium", "llama-3.2-vision-90b"]
C, B, S = 2, 2, 16
F32_TOL = dict(rtol=1e-4, atol=1e-5)
RWKV_ATOL_OF_SCALE = 1e-3
LOSS_TOL = 1e-4


def _batch(model, lead=()):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 500, lead + (B, S)).astype(np.int32)
    lab = rng.integers(0, 500, lead + (B, S)).astype(np.int32)
    out = {"tokens": tok, "labels": lab}
    if model.needs_context():
        out["context"] = np.full(
            lead + (B, model.cfg.n_context_tokens, model.cfg.d_model), 0.1,
            np.float32)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _gates(params, gen):
    for g in ("gate_attn", "gate_mlp"):
        if g in params.get("cross_layers", {}):
            params["cross_layers"][g] = torch.randn(
                params["cross_layers"][g].shape, generator=gen)
    return params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(model, params, batch, remat):
    opts = FwdOptions(remat=remat)
    return torch.func.grad_and_value(model.loss)(params, batch, opts)


def _assert_trees_equal(a, b):
    for (p, x), (q, y) in zip(leaves_with_paths(a), leaves_with_paths(b)):
        assert p == q and torch.equal(x, y), p


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_identical_under_grad_and_vmap(arch):
    model = Model(get_config(arch).reduced(), device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = _gates(model.init(gen), gen)
    one = _torch_batch(_batch(model))
    g0, l0 = _grads(model, params, one, False)
    g1, l1 = _grads(model, params, one, True)
    assert torch.equal(l0, l1)
    _assert_trees_equal(g0, g1)
    reps = {k: v for k, v in params.items()}
    reps = torch.utils._pytree.tree_map(
        lambda t: t[None].expand(C, *t.shape), reps)
    many = _torch_batch(_batch(model, (C,)))
    got = {}
    for remat in (False, True):
        got[remat] = torch.func.vmap(
            lambda p, b, r=remat: _grads(model, p, b, r))(reps, many)
    assert torch.equal(got[False][1], got[True][1])
    _assert_trees_equal(got[False][0], got[True][0])


@pytest.fixture
def float32_compute(monkeypatch):
    for mod in (j_ssm, j_tf, j_api):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (t_ssm, t_tf, t_api):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_match_reference(arch, float32_compute):
    cfg = j_get_config(arch).reduced()
    jm = JModel(cfg)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    if "cross_layers" in jp:
        for i, g in enumerate(("gate_attn", "gate_mlp")):
            jp["cross_layers"][g] = 0.5 + 0.25 * i + jp["cross_layers"][g]
    b = _batch(jm)

    def reference(remat):
        return jax.jit(jax.value_and_grad(
            lambda p, bb: jm.loss(p, bb, JFwdOptions(remat=remat))))(
                jp, jax.tree.map(jnp.asarray, b))

    jloss, jgrads = reference(True)
    tm = Model(get_config(arch).reduced(), device="cpu")
    spec = torch.utils._pytree.tree_map(
        lambda sd: (sd[0], torch.float32), tm.param_shapes(),
        is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], tuple))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), spec, "cpu")
    tgrads, tloss = _grads(tm, tp, _torch_batch(b), True)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    if cfg.rwkv:
        plain = jax.tree.leaves(reference(False)[1])
        for a, b_ in zip(jax.tree.leaves(jgrads), plain):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
    for (path, g), want in zip(leaves_with_paths(tgrads),
                               jax.tree.leaves(jgrads)):
        want = np.asarray(want, np.float32)
        tol = F32_TOL if not cfg.rwkv else dict(
            rtol=F32_TOL["rtol"],
            atol=RWKV_ATOL_OF_SCALE * float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, err_msg=path, **tol)


def _saved_bytes(fn, params):
    """Bytes of the tensors autograd saves while ``fn`` runs, other than
    the parameters (and views of them)."""
    weights = {x.untyped_storage().data_ptr()
               for _, x in leaves_with_paths(params)}
    total = [0]

    def pack(t):
        if t.untyped_storage().data_ptr() not in weights:
            total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b"])
def test_remat_saves_only_the_blocks_inputs(arch):
    """Under plain autograd the forward with remat saves a fraction of
    the activations it saves without (measured: 0.22 for yi-6b, 0.05 for
    rwkv6-1.6b), and ``backward`` gives ``torch.func``'s gradients."""
    model = Model(get_config(arch).reduced(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(model))
    leaves = torch.utils._pytree.tree_map(
        lambda t: t.detach().requires_grad_(), params)
    saved = {r: _saved_bytes(lambda r=r: model.loss(
        leaves, batch, FwdOptions(remat=r)), leaves) for r in (False, True)}
    assert saved[True] < saved[False] / 4, saved
    loss = model.loss(leaves, batch, FwdOptions(remat=True))
    loss.backward()
    want, _ = _grads(model, params, batch, True)
    for (p, x), (_, g) in zip(leaves_with_paths(leaves),
                              leaves_with_paths(want)):
        assert torch.equal(x.grad, g), p


def test_a_block_that_fails_again_raises():
    second = iter((False, True))

    def block(w, x):
        if next(second):
            raise RuntimeError("the second run failed")
        return (w * x).sin()

    w = torch.ones(3, requires_grad=True)
    y = checkpoint(block, w, torch.arange(3.0))
    with pytest.raises(RuntimeError, match="second run"):
        y.sum().backward()


def test_checkpoint_passes_trees_and_values_through():
    """Dict and tuple arguments, non-tensor values, integer tensors (no
    gradient) and a tuple of outputs."""
    def block(p, x, idx, scale):
        return p["a"][idx] * x * scale, (p["b"] * x).sum()

    p = {"a": torch.randn(4, 3), "b": torch.randn(3)}
    x, idx = torch.randn(3), torch.tensor(2)
    want = torch.func.grad(lambda p, x: sum(
        o.sum() for o in block(p, x, idx, 0.5)), argnums=(0, 1))(p, x)
    got = torch.func.grad(lambda p, x: sum(
        o.sum() for o in checkpoint(block, p, x, idx, 0.5)),
        argnums=(0, 1))(p, x)
    _assert_trees_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_remat_keeps_no_cache_to_collect():
    cfg = get_config("yi-6b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat"):
        t_tf.forward(params, torch.zeros((1, 4), dtype=torch.int32), cfg,
                     collect_cache=True, remat=True)
