"""Tree checkpoints: an npz payload and a JSON manifest with key paths,
true dtypes and an integrity digest.

Port of ``repro.checkpoint``, in its format: a checkpoint either package
writes, the other reads. The leaves go in JAX's flatten order (dict keys
sorted at each level, NamedTuple fields in declaration order, as
``core.serialization.leaves_with_paths`` walks a tree) as ``leaf_<i>``,
each copied to the host; ``keypaths`` are spelled as
``jax.tree_util.keystr`` spells them. bfloat16, which ``np.savez``
cannot store, goes as its bit-equal ``uint16`` view with ``"bfloat16"``
in ``true_dtypes``. The digest is ``sha256(serialize_pytree(tree))``,
the bytes HCDS commits to.

A loaded tree takes its structure from ``template`` and puts each leaf on
the device of the template's leaf there (the CPU for a leaf that is not
a tensor), in the dtype the checkpoint recorded.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.crypto import sha256_digest
from repro_torch.core.serialization import (leaves_with_paths, rebuild,
                                            serialize_pytree)

_STEP_RE = re.compile(r"step_(\d+)\.npz$")
_NATIVE_KINDS = set("biufc")


def _to_savable(leaf: Any) -> tuple[np.ndarray, Optional[str]]:
    """A leaf as a host array np.savez takes, and its true dtype's name
    where the array is a bit-equal view of another."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind in _NATIVE_KINDS and arr.dtype.str != "<V2":
        return arr, None
    uint = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        arr.dtype.itemsize]
    return arr.view(uint), arr.dtype.name


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths = leaves_with_paths(tree)
    arrays, true_dtypes = {}, {}
    for i, (_, leaf) in enumerate(paths):
        arr, true_dtype = _to_savable(leaf)
        arrays[f"leaf_{i}"] = arr
        if true_dtype is not None:
            true_dtypes[str(i)] = true_dtype
    payload = directory / f"step_{step}.npz"
    np.savez(payload, **arrays)
    manifest = {
        "step": step,
        "keypaths": [p for p, _ in paths],
        "true_dtypes": true_dtypes,
        "digest": sha256_digest(serialize_pytree(tree)).hex(),
        "metadata": metadata or {},
    }
    (directory / f"step_{step}.json").write_text(json.dumps(manifest))
    return payload


def latest_step(directory: str | Path) -> Optional[int]:
    steps = [int(m.group(1)) for f in Path(directory).glob("step_*.npz")
             if (m := _STEP_RE.search(f.name))]
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, true_dtype: Optional[str],
               device: torch.device) -> torch.Tensor:
    if true_dtype is None:
        return torch.from_numpy(np.array(arr)).to(device)
    if true_dtype != "bfloat16":
        raise TypeError(f"a checkpoint leaf of dtype {true_dtype} has no "
                        f"torch counterpart here")
    return torch.from_numpy(arr.view(np.int16).copy()).view(
        torch.bfloat16).to(device)


def load_checkpoint(directory: str | Path, step: int, template: Any,
                    verify: bool = True) -> Any:
    directory = Path(directory)
    manifest = json.loads((directory / f"step_{step}.json").read_text())
    true_dtypes = manifest.get("true_dtypes", {})
    paths = leaves_with_paths(template)
    with np.load(directory / f"step_{step}.npz") as data:
        if len(data.files) != len(paths):
            raise ValueError(f"checkpoint step {step} holds "
                             f"{len(data.files)} leaves; the template has "
                             f"{len(paths)}")
        leaves = {}
        for i, (path, leaf) in enumerate(paths):
            dev = (leaf.device if isinstance(leaf, torch.Tensor)
                   else torch.device("cpu"))
            leaves[path] = _to_tensor(data[f"leaf_{i}"],
                                      true_dtypes.get(str(i)), dev)
    tree = rebuild(template, leaves)
    if verify:
        digest = sha256_digest(serialize_pytree(tree)).hex()
        if digest != manifest["digest"]:
            raise ValueError(f"checkpoint step {step} integrity check failed")
    return tree
