"""The port's AdamW and learning-rate schedules (``repro_torch.optim``)
against the reference's (``repro.optim``), on the CPU, and the input
shapes of ``repro_torch.configs`` against ``repro.configs``.

float32 params agree at rtol 2e-5 / atol 2e-6 over several steps (sums
in another order: the gradient norm). bfloat16 params keep the
reference's dtypes: float32 moments when the gradient is clipped (a
bfloat16 gradient times the float32 clip scale is float32 in jnp),
bfloat16 when it is not (and then bit for bit: the scalars are rounded
to bfloat16 as jnp rounds its weakly typed Python floats); the params
stay bfloat16 and agree within one bfloat16 rounding of the float32
update.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch import configs
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               constant_lr, cosine_decay_lr,
                               warmup_cosine_lr)

RTOL, ATOL = 2e-5, 2e-6

SHAPES = {"emb": (12, 8), "layers": {"w": (3, 8, 8), "b": (3, 8)},
          "norm": (8,)}


def _tree(rng, spec, scale=1.0):
    if isinstance(spec, dict):
        return {k: _tree(rng, v, scale) for k, v in spec.items()}
    return (scale * rng.standard_normal(spec)).astype(np.float32)


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dtype)


def _to_jax(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_jax(v, dtype) for k, v in tree.items()}
    return jnp.asarray(tree).astype(dtype)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _np(x):
    return (x.to(torch.float32).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _run(dtype, steps, grad_scale, lr, jlr, grad_clip, seed=0):
    """``steps`` AdamW updates on both sides from the same params and
    seeded gradients; yields (step, port (params, state), reference's)."""
    rng = np.random.default_rng(seed)
    p0 = _tree(rng, SHAPES)
    tp, jp = _to_torch(p0, dtype), _to_jax(p0, JDT[dtype])
    ts, js = adamw_init(tp), jadamw.adamw_init(jp)
    for k in range(steps):
        g = _tree(rng, SHAPES, grad_scale)
        tp, ts = adamw_update(_to_torch(g, dtype), ts, tp, lr=lr,
                              grad_clip=grad_clip)
        jp, js = jadamw.adamw_update(_to_jax(g, JDT[dtype]), js, jp, lr=jlr,
                                     grad_clip=grad_clip)
        yield k + 1, (tp, ts), (jp, js)


LRS = {
    "const": (1e-2, 1e-2),
    "callable": (warmup_cosine_lr(3e-2, 2, 6),
                 jsched.warmup_cosine_lr(3e-2, 2, 6)),
}


@pytest.mark.parametrize("lr", sorted(LRS))
@pytest.mark.parametrize("grad_clip,grad_scale", [
    (None, 1.0),        # no clipping
    (1.0, 1e-2),        # clipping on, the norm under the clip
    (1.0, 1.0),         # a clip that binds (the norm is ~18)
    (0.5, 3.0),
])
def test_adamw_float32_matches_reference(lr, grad_clip, grad_scale):
    tlr, jlr = LRS[lr]
    for step, (tp, ts), (jp, js) in _run(torch.float32, 5, grad_scale, tlr,
                                         jlr, grad_clip):
        assert int(ts.step) == int(js.step) == step
        assert ts.step.dtype == torch.int32
        for tree, jtree in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for path, a, b in _pairs(tree, jtree):
                assert a.dtype == torch.float32, path
                np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL,
                                           atol=ATOL, err_msg=path)


@pytest.mark.parametrize("grad_clip,moments", [(1.0, torch.float32),
                                               (None, torch.bfloat16)])
def test_adamw_bfloat16_dtypes_follow_reference(grad_clip, moments):
    for step, (tp, ts), (jp, js) in _run(torch.bfloat16, 2, 1.0, 1e-2, 1e-2,
                                         grad_clip):
        for path, a, b in _pairs(tp, jp):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            # one bfloat16 rounding of a float32 update computed alike
            np.testing.assert_allclose(_np(a), _np(b), rtol=2 ** -7,
                                       atol=1e-6, err_msg=f"{step} {path}")
        for tree, jtree in ((ts.mu, js.mu), (ts.nu, js.nu)):
            for path, a, b in _pairs(tree, jtree):
                assert a.dtype == moments, (step, path)
                assert str(b.dtype) == str(moments).split(".")[1]
                if moments == torch.bfloat16:
                    # the same bfloat16 operations, each rounded alike
                    np.testing.assert_array_equal(_np(a), _np(b),
                                                  err_msg=f"{step} {path}")
                else:
                    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL,
                                               atol=ATOL,
                                               err_msg=f"{step} {path}")


def test_adamw_leaves_its_inputs_and_types_the_state():
    rng = np.random.default_rng(3)
    params = _to_torch(_tree(rng, SHAPES), torch.float32)
    before = {k: v.clone() for k, v in params.items() if k != "layers"}
    state = adamw_init(params)
    assert isinstance(state, AdamWState) and state.step.shape == ()
    grads = _to_torch(_tree(rng, SHAPES), torch.float32)
    new, state2 = adamw_update(grads, state, params)
    for k, v in before.items():
        assert torch.equal(params[k], v)
    assert int(state.step) == 0 and int(state2.step) == 1
    assert new.keys() == params.keys()


STEPS = np.array([0, 1, 2, 3, 5, 7, 10, 13, 50], np.int32)


@pytest.mark.parametrize("name,ours,theirs", [
    ("constant", constant_lr(3e-4), jsched.constant_lr(3e-4)),
    ("cosine", cosine_decay_lr(1e-3, 10), jsched.cosine_decay_lr(1e-3, 10)),
    ("cosine-final", cosine_decay_lr(2e-2, 7, final_frac=0.3),
     jsched.cosine_decay_lr(2e-2, 7, final_frac=0.3)),
    ("warmup", warmup_cosine_lr(1e-3, 3, 13),
     jsched.warmup_cosine_lr(1e-3, 3, 13)),
    ("warmup-none", warmup_cosine_lr(5e-4, 0, 4),
     jsched.warmup_cosine_lr(5e-4, 0, 4)),
])
def test_schedules_match_reference(name, ours, theirs):
    for s in STEPS:
        a = ours(torch.tensor(s, dtype=torch.int32))
        b = theirs(jnp.asarray(s, jnp.int32))
        assert a.shape == () and a.dtype == torch.float32, name
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL, atol=1e-12,
                                   err_msg=f"{name} step {s}")


def test_input_shapes_equal_reference():
    from repro.configs.shapes import LONG_CONTEXT_WINDOW as J_WINDOW
    from repro_torch.configs.shapes import LONG_CONTEXT_WINDOW
    assert configs.INPUT_SHAPES.keys() == jconfigs.INPUT_SHAPES.keys()
    for k, shape in configs.INPUT_SHAPES.items():
        assert isinstance(shape, configs.InputShape)
        ref = jconfigs.INPUT_SHAPES[k]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind,
                shape.needs_subquadratic) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind,
            ref.needs_subquadratic)
    assert LONG_CONTEXT_WINDOW == J_WINDOW
    assert "INPUT_SHAPES" in configs.__all__ and "InputShape" in configs.__all__
