#!/usr/bin/env python3
"""Where a dropless MoE cell's gradient gap comes from: the program's
first gradients against the plain reference's, with each side's own
routing and with the program's routing forced on the reference.

    python3 tools/moe_grad_gap.py --workload deepseek-moe-16b.round-1x4096 \\
        --seeds 2147483701,2147483702 [--json FILE]

For each seed, the first checked round as ``perfbench/run.py`` makes it
(the pool's first batch, the clusters' starting replicas apart):

1. the program's gradients as ``fl.pofel_trainer.local_step`` takes them
   (``vmap(grad_and_value(Model.loss))`` over the clusters), and each MoE
   layer's top-k choices (read through the transforms' wrappers);
2. the reference's (``perfbench/reference/moe.py``) for each cluster,
   once routing on its own float32 activations and once on the
   program's choices (the gates read from its own softmax there);
3. ``flips``: per MoE layer, the share of the (token, choice)
   assignments that the two sides route to different experts, over the
   whole router and over the held experts' assignments;
4. per leaf, with either routing: ``grad_gap`` as the benchmark reads it
   (‖a0 − w1‖ after the bfloat16 update, both sides' updates made by
   the reference's round), ``norm_gap`` (the same leaf gap read on the
   float32 gradients' norms, before any rounding to bfloat16) and
   ``diff`` (‖g_p − g_r‖ / ‖g_r‖, the largest over the clusters);
5. ``embed_float32_sums``: the embedding's gap again with the program's
   lookup made on a float32 copy of the table, so that its backward sums
   the rows of a repeated token in float32 (``index_put`` with
   ``accumulate`` sums them in the table's dtype, rounding after each
   row), against the reference's own routing.

Prints one JSON line a seed. Runs on the card at the cell's size;
:func:`readings` also runs on the CPU with keys that shrink the cell
(the tests' use). Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

F32 = torch.float32


def unwrapped(t: torch.Tensor) -> torch.Tensor:
    """A tensor inside ``torch.func`` transforms as a plain copy, its
    vmapped axes first."""
    fn = torch._C._functorch
    while fn.is_functorch_wrapped_tensor(t):
        if fn.is_batchedtensor(t):
            t = fn.get_unwrapped(t).movedim(fn.maybe_get_bdim(t), 0)
        else:
            t = fn.get_unwrapped(t)
    return t.detach().clone()


@contextlib.contextmanager
def program_routing(out: List[torch.Tensor]):
    """Each call of the program's router appends its choices (C, T, k)."""
    from repro_torch.models import moe
    inner = moe.router_topk

    def router_topk(x, w, cfg):
        gates, idx, probs = inner(x, w, cfg)
        out.append(unwrapped(idx).long())
        return gates, idx, probs

    moe.router_topk = router_topk
    try:
        yield
    finally:
        moe.router_topk = inner


@contextlib.contextmanager
def reference_routing(seen: Dict[int, torch.Tensor],
                      forced: Optional[List[torch.Tensor]]):
    """The reference's expert FFN with its choices kept in ``seen`` (by
    layer, in the order the forward meets them) or, where ``forced``
    gives them by layer, replaced; the rest as the reference computes
    it. A layer is known by its router's storage, which the backward's
    recomputation passes again."""
    from perfbench.reference import moe as ref
    inner = ref._experts
    layers: Dict[int, int] = {}

    def experts(arch, prod, p, h):
        layer = layers.setdefault(p["moe/router"].data_ptr(), len(layers))
        E, k = arch["n_experts"], arch["experts_per_token"]
        probs = torch.softmax(prod.mm(h, p["moe/router"]), dim=-1)
        R = probs.shape[-1]
        gates, idx = torch.topk(probs, k, dim=-1)
        seen.setdefault(layer, idx.detach().clone())
        if forced is not None:
            idx = forced[layer].to(idx.device)
            gates = probs.gather(-1, idx)
        if arch.get("norm_topk", True):
            gates = gates / gates.sum(dim=-1, keepdim=True)
        out = ref._swiglu(prod, h, p["moe/shared/w_gate"],
                          p["moe/shared/w_up"], p["moe/shared/w_down"]) \
            if "moe/shared/w_gate" in p else torch.zeros_like(h)
        for e in range(E):
            tok, j = torch.nonzero(idx == e, as_tuple=True)
            if not len(tok):
                continue
            y = ref._swiglu(prod, h[tok], p["moe/w_gate"][e],
                            p["moe/w_up"][e], p["moe/w_down"][e])
            out = out.index_add(0, tok, gates[tok, j][:, None] * y)
        first = torch.nn.functional.one_hot(idx[:, 0], R).to(F32).mean(0)
        return out, R * torch.sum(first * probs.mean(0))

    ref._experts = experts
    try:
        yield
    finally:
        ref._experts = inner


@contextlib.contextmanager
def embedding_sums_in_float32():
    """The program's embedding lookup made on a float32 copy of the
    table, so that its backward sums the rows of a repeated token in
    float32 and rounds the sum to the table's dtype once (the forward
    is unchanged to the bit)."""
    from repro_torch.models import transformer
    inner = transformer.embed

    def embed(table, tokens):
        return inner(table.to(F32), tokens).to(table.dtype)

    transformer.embed = embed
    try:
        yield
    finally:
        transformer.embed = inner


def flip_shares(prog: torch.Tensor, refc: torch.Tensor, R: int,
                E: int) -> tuple:
    """(the share of the (T, k) choices routed to different experts,
    the share of the held assignments of either side the other lacks)."""
    T, k = prog.shape
    mp = torch.zeros(T, R, dtype=torch.bool, device=prog.device)
    mr = torch.zeros_like(mp)
    mp.scatter_(1, prog, True)
    mr.scatter_(1, refc.to(prog.device), True)
    differ = int((mp & ~mr).sum())
    held_p, held_r = mp[:, :E], mr[:, :E]
    held = int((held_p ^ held_r).sum())
    both = int(held_p.sum()) + int(held_r.sum())
    return differ / (T * k), held / max(both, 1)


def gap_of(prog: Dict[str, float], ref: Dict[str, float], keep: List[str],
           leaf: str) -> float:
    """One leaf's gap as the benchmark's ``leaf_gap`` reads it: over the
    reference's norm or the kept leaves' median, whichever is larger."""
    med = statistics.median(ref[p] for p in keep) if keep else 0.0
    return abs(prog[leaf] - ref[leaf]) / max(ref[leaf], med, 1e-30)


def readings(workload: str, seed: int, device, arch_keys: dict = None,
             traffic_keys: dict = None) -> dict:
    """One seed's readings (see the module's docstring); ``arch_keys``
    and ``traffic_keys`` replace the cell's own."""
    from perfbench.harness import cell as cell_mod
    from perfbench.harness.check import kept_leaves, leaf_gap
    from perfbench.harness.program import Program
    from perfbench.harness.spec import load_cell
    from perfbench.harness.traffic import cluster_slices, token_pool
    from perfbench.harness.weights import flatten, nest
    from perfbench.reference import moe as ref
    from perfbench.reference import pofel as ref_pofel
    from perfbench.reference.precision import Products

    dev = torch.device(device)
    cell = load_cell(workload, ROOT)
    arch = dict(cell.config["arch"], **(arch_keys or {}))
    traffic = dict(cell.traffic, **(traffic_keys or {}))
    cell = dataclasses.replace(cell, traffic=traffic)
    C, lr = traffic["clusters"], traffic["inner_lr"]
    E = arch["n_experts"]
    R = arch.get("router_experts") or E
    pool = token_pool(seed, traffic, arch, dev)
    weights, start, a0 = cell_mod.starting_point(cell, seed, dev, arch)

    # the program: local_step's gradients and its routing
    prog = Program(arch, traffic, weights, seed, dev, start)
    del weights
    batch = prog.m["launch_train"].round_batch(pool[0], prog.model, C, dev)
    model, opts, aux = prog.model, prog.opts, prog.tcfg.aux_weight

    def loss(params, b):
        return model.loss(params, b, opts, aux)

    def step():
        with torch.autograd.set_multithreading_enabled(False):
            return torch.func.vmap(torch.func.grad_and_value(loss))(
                prog.state.cluster_params, batch)

    with embedding_sums_in_float32():
        embed32 = step()[0]["embed"]
    routes: List[torch.Tensor] = []
    with program_routing(routes):
        grads, losses = step()
    g_prog = flatten(grads)
    loss_prog = [float(v) for v in losses]
    del grads, prog, batch, model
    cell_mod.free(dev)

    batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
               for b in cluster_slices(pool[0], C)]
    own = iter(range(C))

    def program_grads(params, b, arch_, prod):
        c = next(own)
        return (torch.tensor(loss_prog[c]),
                nest({p: g[c] for p, g in g_prog.items()}))

    w1, _ = ref_pofel.fedsgd_round(None, batches, program_grads, arch, lr,
                                   Products(), start)
    first_prog = ref_pofel.leaf_change_norms(a0, flatten(w1))
    del w1
    def norm(g):
        return max(float(torch.linalg.vector_norm(g[c], dtype=torch.float64))
                   for c in range(C))

    norm_prog = {p: norm(g) for p, g in g_prog.items()}
    norm32 = dict(norm_prog, embed=norm(embed32))

    out = {"seed": seed, "loss_program": loss_prog}
    natural: List[Dict[int, torch.Tensor]] = []
    for mode in ("own", "forced"):
        clusters = iter(range(C))
        diff: Dict[str, float] = {}
        embed32_diff = [0.0]
        ref_loss: List[float] = []

        def reference_grads(params, b, arch_, prod):
            c = next(clusters)
            seen: Dict[int, torch.Tensor] = {}
            forced = None if mode == "own" else \
                [r[c] for r in routes]
            with reference_routing(seen, forced):
                lv, grads = ref.loss_and_grads(params, b, arch_, prod)
            if mode == "own":
                natural.append(seen)
                g = grads["embed"]
                embed32_diff[0] = max(embed32_diff[0], float(
                    torch.linalg.vector_norm(embed32[c].to(F32) - g)
                    / torch.linalg.vector_norm(g)))
            ref_loss.append(float(lv))
            for p, g in flatten(grads).items():
                d = torch.linalg.vector_norm(
                    g_prog[p][c].to(F32) - g, dtype=torch.float64)
                n = torch.linalg.vector_norm(g, dtype=torch.float64)
                diff[p] = max(diff.get(p, 0.0), float(d / n) if n > 0
                              else float(d))
            return lv, grads

        w1, rout = ref_pofel.fedsgd_round(None, batches, reference_grads,
                                          arch, lr, Products(), start)
        first_ref = ref_pofel.leaf_change_norms(a0, flatten(w1))
        del w1
        keep = kept_leaves(rout.grad_norms)
        moe_leaves = [p for p in keep if p.startswith("layers/moe/")]
        gap, where = leaf_gap(first_prog, first_ref, keep)
        ngap, nwhere = leaf_gap(norm_prog, rout.grad_norms, keep)
        mgap, mwhere = leaf_gap(norm_prog, rout.grad_norms, moe_leaves)
        worst = max(keep, key=lambda p: diff[p])
        out[mode] = {
            "loss_reference": ref_loss,
            "first_loss_gap": max(abs(a - b) / abs(b) for a, b in
                                  zip(loss_prog, ref_loss)),
            "grad_gap": [gap, where],
            "norm_gap": [ngap, nwhere],
            "norm_gap_moe": [mgap, mwhere],
            "diff_worst": [diff[worst], worst],
            "diff": {p: diff[p] for p in keep
                     if p == "embed" or p.startswith("layers/moe/")},
            "embed_norm_ratio": norm_prog["embed"] / rout.grad_norms["embed"]}
        if mode == "own":
            out["embed_float32_sums"] = {
                "norm_gap": gap_of(norm32, rout.grad_norms, keep, "embed"),
                "norm_gap_before": gap_of(norm_prog, rout.grad_norms, keep,
                                          "embed"),
                "diff": embed32_diff[0],
                "norm_ratio": norm32["embed"] / rout.grad_norms["embed"]}
        cell_mod.free(dev)

    per_layer = [[flip_shares(routes[l][c], natural[c][l], R, E)
                  for c in range(C)] for l in range(len(routes))]
    out["flips"] = {
        "layers": [[round(a, 6), round(b, 6)] for a, b in
                   (max(row) for row in per_layer)],
        "mean": sum(a for row in per_layer for a, _ in row)
        / max(1, sum(len(row) for row in per_layer)),
        "mean_held": sum(b for row in per_layer for _, b in row)
        / max(1, sum(len(row) for row in per_layer))}
    del start, a0, g_prog, routes, natural, embed32
    cell_mod.free(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = open(args.json, "a") if args.json else None
    try:
        for s in args.seeds.split(","):
            line = json.dumps(readings(args.workload, int(s),
                                       torch.device("cuda", 0)))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
