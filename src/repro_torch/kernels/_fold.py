"""Helpers of the kernels' ``torch.func.vmap`` rules.

A vmapped call of a kernel's ``torch.autograd.Function`` folds the
vmapped axis into one of the kernel's own axes and makes one launch for
the whole batch (wkv6 folds it into the heads, flash attention into the
batch); these put that axis first, and give an input the rule was not
vmapped over the batch's extent.
"""

from __future__ import annotations

from typing import Optional

import torch


def front(t: torch.Tensor, dim: Optional[int], size: int) -> torch.Tensor:
    """``t`` with its vmapped axis first; an unbatched ``t`` (``dim``
    None) expanded along a new first axis of ``size``."""
    if dim is None:
        return t.expand(size, *t.shape)
    return t.movedim(dim, 0)


def is_wrapped(*ts) -> bool:
    """Whether a tensor among ``ts`` is wrapped by ``torch.func`` (vmap
    or grad): its data cannot be read through a pointer, so a kernel
    call must go through the op's Function, whose rules unwrap it."""
    return any(isinstance(t, torch.Tensor)
               and torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in ts)
