"""Batched serving example on the PyTorch port, the counterpart of
``examples/serve_llm.py``: prefill + autoregressive decode with KV caches
(reduced config). On the card the prefill runs the flash-attention
kernel (the wkv6 kernel for RWKV-6).

Run:  PYTHONPATH=src python examples_torch/serve_llm.py [--arch zamba2-7b] [--device cpu]
"""

import argparse

from repro_torch import resolve_device
from repro_torch.launch.serve import serve_reduced


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # raises without a card
    return serve_reduced(args.arch, batch=args.batch, prompt_len=24, gen=12,
                         seed=0, temperature=0.0, device=device)


if __name__ == "__main__":
    main()
