#!/usr/bin/env python3
"""Time the port's wkv6 and cosine-partials kernels, the two backward
kernels (wkv6, flash attention) and the bf16 flash forward at the hd 112
and MoE shapes of two checkouts on one card, in turns (A, B, B, A), so
two versions are compared inside one run.

    python3 tools/kernel_ab.py ROOT_A ROOT_B [--json FILE] [--only NAME ...]

Each ROOT is the root of a checkout of this repository (for instance the
parent commit unpacked with ``git archive`` into ``build/parent``). Every
turn is a fresh process that puts ROOT/src first on the path, builds that
checkout's kernels from its own sources, and times each kernel with
``chip_smoke.graph_time_us`` (CUDA events over CUDA-graph replays, median
of 50) at the shapes ``chip_smoke.py`` uses (``WKV6_SHAPES``,
``WKV6_BWD_SHAPES``, ``FLASH_BWD_CASES``, the bf16 cases of
``FLASH_112_CASES`` and ``FLASH_MOE_CASES``), beside its largest absolute
difference from the checkout's plain version; the backward kernels also
with ``chip_smoke.call_time_us`` (one eager call, CUDA events), the
footing of the library's time. ``--only`` keeps the kernels named
(``wkv6``, ``wkv6_backward``, ``flash_attention_backward``,
``flash_attention``, ``cosine_partials``). It prints one line per kernel
and shape with the four values, and the card's ``nvidia-smi`` line. Needs
one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
COSINE_SHAPES = ((8, 101_770), (50, 101_770))
KERNELS = ("wkv6", "wkv6_backward", "flash_attention_backward",
           "flash_attention", "cosine_partials")


def time_checkout(root: Path, only=KERNELS) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref
    assert Path(_build.__file__).resolve().is_relative_to(root.resolve())
    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for B, S, H, K in (cs.WKV6_SHAPES if "wkv6" in only else ()):
        args = cs.wkv6_inputs(gen, dev, B, S, H, K, "mid")
        got = ops.wkv6_recurrence(*args)
        want = ref.wkv6_recurrence_ref(*args)
        out[f"wkv6 {(B, S, H, K)} max_abs_err"] = max(
            float((a - b).abs().max()) for a, b in zip(got, want))
        out[f"wkv6 {(B, S, H, K)}"] = cs.graph_time_us(
            lambda: ops.wkv6_recurrence(*args))
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import wkv6 as kw
    for B, S, H, K in (cs.WKV6_BWD_SHAPES if "wkv6_backward" in only
                       else ()):
        args = cs.wkv6_inputs(gen, dev, B, S, H, K, "mid")
        d_o = torch.randn(B, S, H, K, generator=gen, device=dev)
        d_state = 0.1 * torch.randn(B, H, K, K, generator=gen, device=dev)
        _, _, ckpt = kw._forward(*args, save=True)

        def bwd():
            return kw.wkv6_backward(*args, d_o, d_state, ckpt)
        tag = f"wkv6_backward {(B, S, H, K)}"
        want = ref.wkv6_backward_ref(*args, d_o, d_state)
        out[f"{tag} max_abs_err"] = max(
            float((a - b).abs().max()) for a, b in zip(bwd(), want))
        out[tag] = cs.graph_time_us(bwd)
        out[f"{tag} eager"] = cs.call_time_us(bwd)
    for B, S, Hq, Hk, hd, dt, causal, window in (
            cs.FLASH_BWD_CASES if "flash_attention_backward" in only
            else ()):
        dtype = getattr(torch, dt)
        q = torch.randn(B, S, Hq, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, Hk, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, Hk, hd, generator=gen, device=dev).to(dtype)
        d_o = torch.randn(B, S, Hq, hd, generator=gen, device=dev).to(dtype)
        o, lse = kf._forward(q, k, v, causal, window, want_lse=True)
        kwa = dict(causal=causal, window=window)

        def fbwd():
            return kf.flash_attention_backward(q, k, v, o, lse, d_o, **kwa)
        tag = (f"flash_attention_backward {(B, S, Hq, Hk, hd)} {dt} causal "
               f"{causal} window {window}")
        want = ref.flash_attention_backward_ref(q, k, v, o, lse, d_o, **kwa)
        out[f"{tag} max_abs_err"] = max(
            float((a.float() - b.float()).abs().max())
            for a, b in zip(fbwd(), want))
        del want
        out[tag] = cs.graph_time_us(fbwd)
        out[f"{tag} eager"] = cs.call_time_us(fbwd)
    fwd = [c for c in cs.FLASH_112_CASES + cs.FLASH_MOE_CASES
           if c[5] == "bfloat16" and "flash_attention" in only]
    for B, S, Hq, Hk, hd, dt, causal, window in fwd:
        q = torch.randn(B, S, Hq, hd, generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn(B, S, Hk, hd, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        kwa = dict(causal=causal, window=window)
        tag = f"flash_attention {(B, S, Hq, Hk, hd)} {dt} causal {causal}"
        want = ref.flash_attention_gqa_ref(q, k, v, **kwa)
        out[f"{tag} max_abs_err"] = float(
            (ops.flash_attention(q, k, v, **kwa).float()
             - want.float()).abs().max())
        out[tag] = cs.graph_time_us(lambda: ops.flash_attention(q, k, v,
                                                                **kwa))
    for N, D in (COSINE_SHAPES if "cosine_partials" in only else ()):
        for dt in (torch.float32, torch.bfloat16):
            W = torch.randn(N, D, generator=gen, device=dev).to(dt)
            gw = torch.randn(D, generator=gen, device=dev).to(dt)
            tag = f"cosine_partials {(N, D)} {str(dt).split('.')[-1]}"
            got = ops.cosine_partials(W, gw)
            want = ref.cosine_partials_ref(W, gw)
            out[f"{tag} max_abs_err"] = max(
                float((a - b).abs().max()) for a, b in zip(got, want))
            out[tag] = cs.graph_time_us(lambda: ops.cosine_partials(W, gw))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--json", type=Path)
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one is not None:
        print(json.dumps(time_checkout(a.one, a.only)))
        return 0
    if len(a.roots) != 2:
        ap.error("give two checkout roots, A and B")
    turns = []
    for label, root in (("A", a.roots[0]), ("B", a.roots[1]),
                        ("B", a.roots[1]), ("A", a.roots[0])):
        res = subprocess.run([sys.executable, __file__, "--one", str(root),
                              "--only", *a.only],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        turns.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    table = {}
    for key in turns[0][1]:
        table[key] = {"A": [t[key] for lab, t in turns if lab == "A"],
                      "B": [t[key] for lab, t in turns if lab == "B"]}
        unit = "" if key.endswith("max_abs_err") else " us"
        print(f"{key}: A {table[key]['A']}{unit}, B {table[key]['B']}{unit}",
              flush=True)
    print(smi)
    if a.json:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(json.dumps({"card": smi, "A": str(a.roots[0]),
                                      "B": str(a.roots[1]),
                                      "times": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
