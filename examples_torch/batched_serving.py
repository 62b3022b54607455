"""Batched serving through the ServingEngine on the PyTorch port, the
counterpart of ``examples/batched_serving.py``: mixed prompt lengths,
EOS, and nucleus sampling (reduced config). On the card the prefill runs
the flash-attention kernel.

Run:  PYTHONPATH=src python examples_torch/batched_serving.py [--arch yi-6b] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.model_api import Model
from repro_torch.serving import GenerationRequest, SamplerConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b",
                    choices=[a for a in ARCH_IDS if a != "mnist-mlp"])
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # raises without a card

    model = Model(get_config(args.arch).reduced(), device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServingEngine(
        model, params,
        SamplerConfig(temperature=args.temperature, top_p=args.top_p),
        device=device)

    rng = np.random.default_rng(0)
    requests = [
        GenerationRequest(0, rng.integers(0, 500, 5).astype(np.int32),
                          max_new_tokens=12),
        GenerationRequest(1, rng.integers(0, 500, 17).astype(np.int32),
                          max_new_tokens=8),
        GenerationRequest(2, rng.integers(0, 500, 9).astype(np.int32),
                          max_new_tokens=12, eos_token=7),
    ]
    t0 = time.perf_counter()
    completions = engine.generate(requests)
    dt = time.perf_counter() - t0

    total = sum(len(c.tokens) for c in completions)
    print(f"arch={args.arch} (reduced) — {len(requests)} requests, "
          f"{total} tokens in {dt*1e3:.0f} ms")
    for c in completions:
        print(f"  req{c.request_id} [{c.finished_by:6s}]: {c.tokens}")
    return completions


if __name__ == "__main__":
    main()
