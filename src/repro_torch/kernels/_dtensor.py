"""The kernels' custom ops on DTensors.

Each op has sharding rules (``register_sharding``): the placements its
kernel computes right on a shard, so that DTensor runs the kernel on each
rank's local tensors and redistributes any other input to one of them
first. They are registered at the first call that is given a DTensor,
so that importing the kernels does not import ``torch.distributed``.

A rule may leave an output partial over a mesh dim (the cosine partials
of a W sharded along its columns). :func:`ordered_sum` reduces such a
partial by an all-gather and a sum in rank order, never a float
all-reduce, so that the same inputs give the same bits on every run
(ROADMAP port rule 5).
"""

from __future__ import annotations

import torch

_registered = False


def is_dtensor(t) -> bool:
    if not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def refuse_device(t, kernel: str) -> None:
    """A plain tensor on a device with no kernel (neither the card nor the
    CPU's plain version) raises; the ops' fake implementations take meta
    tensors only inside a DTensor (its sharding propagation, the dry
    run's abstract arguments)."""
    if t.device.type not in ("cpu", "cuda") and not is_dtensor(t):
        raise ValueError(f"no {kernel} kernel for {t.device}")


def ensure_rules(t) -> None:
    """Register every op's sharding rules once, if ``t`` is a DTensor."""
    global _registered
    if _registered or not is_dtensor(t):
        return
    from torch.distributed.tensor.experimental import register_sharding

    from repro_torch.kernels import cosine_sim, flash_attention, \
        weighted_agg, wkv6
    for op, rules in (
            (flash_attention.flash_op, flash_attention.sharding_rules),
            (flash_attention.flash_backward_op,
             flash_attention.backward_sharding_rules),
            (wkv6.wkv6_op, wkv6.sharding_rules),
            (wkv6.wkv6_backward_op, wkv6.backward_sharding_rules),
            (cosine_sim.cosine_partials_op, cosine_sim.sharding_rules),
            (weighted_agg.weighted_aggregate_op,
             weighted_agg.sharding_rules)):
        register_sharding(op._opoverload)(rules)
    _registered = True


def ordered_sum(t):
    """A DTensor with its partial mesh dims reduced: each rank's local
    tensor all-gathered over the dim and summed in rank order (the same
    bits on every rank and every run); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate
    placements = list(t.placements)
    local = t.to_local()
    for dim, p in enumerate(placements):
        if not isinstance(p, Partial):
            continue
        if p.reduce_op != "sum":
            raise ValueError(f"ordered_sum reduces sums only; got {p}")
        placements[dim] = Replicate()
        if t.device_mesh.size(dim) == 1:
            continue            # one rank's part is the sum
        group = t.device_mesh.get_group(dim)
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local.contiguous(), group=group)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        local = total
    return DTensor.from_local(local, t.device_mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())
