"""Serving launcher: batched prefill + decode from the PoFEL global model
(port of ``repro.launch.serve``).

Serves the REDUCED variant of the selected architecture for real tokens,
as the reference does: seeded random weights (or ``params`` given), a
batch of seeded prompts, one timed prefill, then ``gen - 1`` timed
decode steps. The rwkv and hybrid families discard the prefill's cache
and replay the prompt through decode steps, as the reference's launcher
does. A transformer's prompt-sized KV cache grows by ``gen`` slots along
its sequence axis (``serving.grow_cache``, the axis named; the
reference's ``grow`` pads the first axis whose extent equals the prompt
length, which at ``--prompt-len 2`` is the reduced models' layer axis).
Sampling at ``temperature > 0`` draws from a ``torch.Generator`` seeded
``seed + 1`` (the reference's ``jax.random.key(seed + 1)``; the draws
differ).

Runs on the card unless ``--device cpu`` asks for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
      --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.model_api import Model
from repro_torch.serving import SamplerConfig, grow_cache, sample_token


class ServeRun(NamedTuple):
    """What :func:`serve_reduced` served: the generated tokens (batch,
    gen) on the host, and the prefill's and the decode loop's wall times
    (each ending in a device synchronize)."""
    tokens: np.ndarray
    prefill_s: float
    decode_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def serve_reduced(arch: str, batch: int, prompt_len: int, gen: int,
                  seed: int, temperature: float,
                  device: torch.device | str | None = None,
                  params: Optional[Any] = None) -> ServeRun:
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = Model(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    total = prompt_len + gen

    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)).to(dev)
    b = {"tokens": prompts}
    if model.needs_context():
        b["context"] = model.stub_context(batch)

    # prefill
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, b)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    if not (cfg.rwkv or cfg.family == "hybrid"):
        cache = grow_cache(cache, gen)
    else:
        # recurrent caches are O(1); replay the prompt through decode steps
        cache = model.init_cache(batch, total)
        for i in range(prompt_len):
            logits, cache = model.decode_step(params, cache,
                                              prompts[:, i:i + 1], i)

    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    sampler = SamplerConfig(temperature=temperature)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(prompt_len, total - 1):
        logits, cache = model.decode_step(params, cache, tok, i)
        tok = sample_token(logits[:, -1].to(torch.float32), generator,
                           sampler)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_tokens = torch.cat(out, dim=1).cpu().numpy()
    print(f"arch={arch} reduced | prefill {prompt_len} toks × {batch} reqs: "
          f"{t_prefill*1e3:.0f}ms | decode {gen_tokens.shape[1]} steps: "
          f"{t_decode*1e3:.0f}ms "
          f"({t_decode/max(gen_tokens.shape[1],1)*1e3:.1f} ms/tok)")
    for r in range(min(batch, 2)):
        print(f"  req{r}: {gen_tokens[r].tolist()}")
    return ServeRun(gen_tokens, t_prefill, t_decode)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b",
                    choices=[a for a in ARCH_IDS if a != "mnist-mlp"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    serve_reduced(args.arch, args.batch, args.prompt_len, args.gen,
                  args.seed, args.temperature, device=args.device)


if __name__ == "__main__":
    main()
