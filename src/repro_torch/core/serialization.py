"""Deterministic serialization of parameter trees for hashing/commitment.

The PyTorch port's counterpart of ``repro.core.serialization``. A model
is a tree of tensors: a dict (nested dicts allowed) whose leaves are
tensors, numpy arrays or scalars, or a bare tensor. A NamedTuple of such
trees is a tree too (the PoFEL trainer's state), as JAX flattens it:
fields in declaration order, spelled ``.name``.

HCDS commits to H(nonce || model) and every block carries the sha256 of
each model's bytes, so the encoding must match the reference's byte for
byte for identical weights: leaves in sorted key-path order, with
key-paths spelled the way ``jax.tree_util.keystr`` writes them
(``['w1']`` for a dict key, ``''`` for a bare leaf); numpy dtype
strings (``<f4``; ``<V2`` for bfloat16, as JAX's numpy arrays spell it); int64
shapes; raw little-endian bytes. The same order
defines the canonical flat float32 vector that ME and every adapter use.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

_MAGIC = b"RPR0"


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flatten order: dict keys sorted
    at each level, NamedTuple fields in declaration order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += leaves_with_paths(getattr(tree, name), f"{prefix}.{name}")
        return out
    return [(prefix, tree)]


def _sorted_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in canonical sorted-keypath order."""
    return sorted(leaves_with_paths(tree), key=lambda kv: kv[0])


def _is_bf16(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf's host array; a bfloat16 tensor comes out as its raw 2-byte
    values (int16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def flatten_pytree(tree: Any) -> torch.Tensor:
    """Canonical (sorted key-path) float32 flat vector of a parameter tree,
    on the device of its tensor leaves.

    The order matches :func:`serialize_pytree`, so the HCDS commitment and
    the ME similarity computation see the same vector.
    """
    return torch.cat([torch.as_tensor(leaf).reshape(-1).to(torch.float32)
                      for _, leaf in _sorted_leaves(tree)])


def rebuild(template: Any, leaves: dict, prefix: str = "") -> Any:
    """A tree shaped like ``template`` whose leaves are ``leaves[path]``
    (paths as :func:`leaves_with_paths` spells them)."""
    if isinstance(template, dict):
        return {k: rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(rebuild(getattr(template, n), leaves,
                                        f"{prefix}.{n}")
                                for n in template._fields))
    return leaves[prefix]



def unflatten_pytree(flat: Any, template: Any) -> Any:
    """Inverse of :func:`flatten_pytree`: a tree shaped like ``template``
    whose leaves take the template leaves' dtype and device. The slices
    of a tensor ``flat`` are views, so a flat vector already on the
    template's device and dtype is adopted without a copy."""
    if not isinstance(flat, torch.Tensor):
        flat = torch.from_numpy(np.array(flat))
    paths = _sorted_leaves(template)
    sizes = [int(np.prod(tuple(leaf.shape), dtype=np.int64))
             for _, leaf in paths]
    if sum(sizes) != flat.shape[0]:
        raise ValueError(f"flat vector has {flat.shape[0]} elements; "
                         f"template needs {sum(sizes)}")
    leaves, off = {}, 0
    for (path, leaf), n in zip(paths, sizes):
        chunk = flat[off:off + n].reshape(tuple(leaf.shape))
        leaves[path] = chunk.to(device=leaf.device, dtype=leaf.dtype)
        off += n
    return rebuild(template, leaves)


def serialize_pytree(tree: Any) -> bytes:
    """Canonical bytes of a tree of tensors/arrays/scalars.

    Layout: MAGIC | n_leaves | for each leaf (sorted by keypath):
    len(path) path | len(dtype) dtype | ndim shape... | nbytes raw-bytes.
    Tensor leaves are copied to the host first.
    """
    leaves = _sorted_leaves(tree)
    out = [_MAGIC, struct.pack("<I", len(leaves))]
    for path, leaf in leaves:
        arr = _to_numpy(leaf)
        path_b = path.encode()
        # numpy has no bfloat16: the reference's bfloat16 arrays spell it
        # '<V2', and a bfloat16 tensor reads out through an int16 view
        dtype_b = b"<V2" if _is_bf16(leaf) else arr.dtype.str.encode()
        out.append(struct.pack("<I", len(path_b)))
        out.append(path_b)
        out.append(struct.pack("<I", len(dtype_b)))
        out.append(dtype_b)
        out.append(struct.pack("<I", arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        raw = np.ascontiguousarray(arr).tobytes()
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    return b"".join(out)

