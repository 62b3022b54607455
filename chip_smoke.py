#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

needs one NVIDIA Hopper card (H100), the CUDA toolkit (``nvcc``) and a
CUDA build of PyTorch. It never imports JAX or the reference package
``repro``. Phases, each of which fails the script:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a (one
   ``nvcc`` per source, in parallel) into ``build/repro_torch_kernels/``;
   where the toolkit has ``cuobjdump``, the flash library must hold
   ``HGMMA`` (wgmma) instructions: its bf16 path is on the tensor cores;
3. kernels: each ME kernel at (N, D) = (8, 101770) and (50, 101770), in
   float32 and bfloat16, and at the shapes phases 23-24 give it, (6,
   101770) (a scenario), (16, 101770) and (32, 101770) (a committee of
   consortium_64 and consortium_256), in float32, against its plain PyTorch version on the card,
   twice on the same input (the outputs must be bit-identical), one call
   of the partials putting exactly one kernel on the card, then
   timed with CUDA events over CUDA-graph replays (device time per call,
   median of 50) beside its plain version, a PyTorch library call and
   the card's byte bound;
4. main path: ``repro_torch.api.run_bhfl(model="mlp", n_nodes=8,
   clients_per_node=5, fel_iterations=3, rounds=3, seed=0,
   device="cuda")`` at the §7.1 width 784-128-10; the chain must verify
   at height 3, every loss be finite, and each kernel wrapper have
   launched exactly once per round;
5. profile: one more round of the main path's runtime under
   ``torch.profiler``: the device's busy time (the union of its kernel
   and copy intervals), set against the median wall time of the
   unprofiled rounds, and the kernels that took it;
6. agreement: with dropout off, a short run on the card must elect the
   same leaders as the same run on the CPU (plain versions), with
   similarities and accuracy within tolerance;
7. wkv6 kernel: the RWKV-6 recurrence at (B, S, H, K) = (8, 1, 32, 64)
   (decode) and (8, 512, 32, 64) (a forward) in float32, with its launch
   geometry, against its plain PyTorch version on the card with decays in
   (0.2, 0.99) and down to 1e-30, bit-identical on repeat, timed beside
   the plain version and the byte/operation bound;
8. serving: ``Model(get_config("rwkv6-1.6b"))`` at full width (24
   layers, d_model 2048, 32 heads of 64, vocab 65,536; seeded random
   weights on the card) behind ``ServingEngine.generate``: 8 greedy
   requests, prompts of 16-64 tokens, 32 new tokens each. Finite logits,
   one wkv6 launch per layer per decode step, the same tokens on a
   second run; then one ``Model.forward`` on (8, 512) tokens, and a
   profile of decode steps;
9. serving agreement: the reduced RWKV-6 config with the same weights on
   the card and on the CPU, teacher-forced along the CPU's greedy
   tokens: logits within the bfloat16 tolerance, the same argmax wherever
   the CPU's top-2 margin is clear of it;
10. flash kernel: flash attention at the Yi-6B serving prefill
    (8, 57, Hq 32, Hk 4, hd 128) and forward (8, 512, 32, 4, 128) shapes
    in bfloat16 (tensor cores) and float32 (CUDA cores), a 256-key window
    at hd 64 and a non-causal case at hd 32, against its plain PyTorch
    version on the card, bit-identical on repeat, timed beside the plain
    version, the byte/operation bound and
    ``scaled_dot_product_attention`` (the library yardstick, never called
    by the port);
11. dense serving: ``Model(get_config("yi-6b"))`` at full width (32
    layers, d_model 4096, 32 heads and 4 KV heads of 128, d_ff 11008,
    vocab 64,000; seeded random bfloat16 weights on the card) behind
    ``ServingEngine.generate``: the requests of phase 8, twice. Finite
    logits, one flash launch per layer, all in the one prefill, the same
    tokens on a second run; then one ``Model.forward`` on (8, 512) tokens
    (one flash launch per layer), and a profile of decode steps;
12. dense serving agreement: phase 9 for the reduced Yi-6B and the
    reduced StarCoder2-3B (GQA and random QKV biases), the prompt through
    ``prefill`` and the KV cache grown as the engine grows it;
13. wkv6 backward kernel: the training forward (it saves the state every
    16 steps) and the backward kernels at RWKV-6 1.6B's training shape
    (8, 512, 32, 64), the tiny LM's (8, 16, 2, 32) and across chunk
    edges, against the plain backward on the card, bit-identical on
    repeat, timed beside the plain version and the byte/operation bound;
14. flash backward kernels: at Yi-6B's (8, 512, 32, 4, 128) in bfloat16
    and float32, the tiny LM's (8, 16, 2, 2, 32) and a 256-key window,
    against the plain backward on the card, bit-identical on repeat,
    timed beside the plain version, the bound and the backward of
    ``scaled_dot_product_attention`` (the library yardstick, timed eagerly:
    the kernel's eager call is printed beside it, the pair that decides
    which is faster);
15. LM rounds: ``run_bhfl(model="rwkv6")`` and ``run_bhfl(model=
    "transformer")`` on the card at the defaults (6 nodes x 4 clients, 2
    FEL iterations, 256 x 16 tokens), 2 rounds each: valid chain of
    height 2, finite losses, and each model kernel launched once a layer
    per SGD step forward and backward (forward also once a layer per
    evaluation);
16. full-width FedSGD, right after phases 8 and 11 on their weights:
    ``LMAdapter.local_train`` on one client of 8 rows x 513 tokens,
    batch 4 (two SGD steps): RWKV-6 1.6B at full depth, Yi-6B at full width and 16 of
    its 32 layers (its bfloat16 weights come out of the first step in
    float32, as in the reference, so full depth needs more than the
    card's 80 GB); finite loss, one forward and one backward launch a
    layer per step, the peak memory; then one more step under
    ``torch.profiler``: device time by kernel name and the two backward
    kernels' share of it;
17. card against CPU gradients: ``Model.loss`` gradients of the tiny
    RWKV-6 (1 layer, d_model 64, 2 heads of 32) and the tiny dense
    transformer, the same weights on both, within the bfloat16 rule;
18. batched main path: phase 4's ``run_bhfl`` with ``engine="batched"``
    (every client of every cluster in one ``torch.func.vmap``-ed SGD
    step): the chain, finite losses, each ME kernel once a round, phase
    4's leaders and its final global model within BATCHED_W_TOL; the
    ``round`` and ``fel`` spans beside phase 4's;
19. batched profile: one more batched round under ``torch.profiler``
    (busy share), the device ops of one FEL phase, batched beside the
    reference loop's, and the batched phase's host time beside that of
    its batch plan and its dropout draws;
20. batched LM rounds: phase 15's runs with ``engine="batched"``: valid
    chain, finite losses, each model kernel launched forward and
    backward once a layer per vmapped SGD step (2 a round at the
    defaults, against phase 15's 48);
21. vmap rules: the wkv6 forward and backward at (V, B, S, H, K) =
    VMAP_WKV6 and bf16 flash forward and backward at VMAP_FLASH under
    ``torch.func.vmap``: one launch each, bit-identical to V separate
    launches and within the kernel's tolerance of the plain version at
    the folded shape, the folded call timed beside the V calls, the
    plain version, the bound and (flash) SDPA;
22. sharded ME: ``ShardedModelEvaluation(4)`` on a batched round's W
    against the dense ME phase: gw bit-identical, similarities within
    rtol 1e-5, the same vote, two kernel launches a shard;
23. scenarios: ``run_bhfl(scenario=...)`` of ``byzantine_third`` (the
    reference loop), ``edge_churn`` (the batched engine, node 5 down for
    two rounds) and ``crash_restart`` (WAL replay, ledger re-sync) on the
    card: live, no safety violation, each ME kernel once per completed
    round, byzantine_third's leaders honest or the honest argmax, the
    round wall times; one more byzantine_third round profiled (busy
    share); the chrome trace of one run written, read back with
    ``obs.load_trace`` and summarized (``obs.format_summary``);
24. consortium: ``run_bhfl(scenario="consortium_256")`` (N = 256 in 8
    committees of 32, a 1 % lossy WAN with retries, checkpoints every 2
    rounds) beside ``consortium_64``: every committee live, no safety
    violation, the top-chains converged at 8 x epochs, each ME kernel
    once per completed shard round, the committee round wall times, and
    one more consortium round of each profiled (busy share).

25. flash at hd 112 (Zamba2-7B's shared attention, 32 query and 32 kv
    heads): phase 10 at (8, 512) and (8, 64), bf16 and fp32, and phase
    14's backward checks at (8, 512) bf16 and fp32 and (8, 64) bf16 (the
    hd-128 tile on maps of hd extent 112, as the forward); then phase 10
    at the MoE models' bf16 shapes: DeepSeek-MoE-16B's
    prefill (8, 57) and forward (8, 512), 16 query and 16 kv heads of
    128, and Phi-3.5-MoE's forward (8, 512), 32 query and 8 kv heads;
26. hybrid serving: ``Model(get_config("zamba2-7b"))`` at full width and
    depth (81 layers: 13 groups of 5 Mamba2 blocks and the shared block,
    3 more Mamba2 blocks; d_model 3584, Mamba2 state 64, 32 x 112 shared
    heads; ~22.1 GB of seeded random weights, the Mamba2 blocks float32)
    through phase 8's checks: the prompt replays through decode steps (no
    flash launch in ``generate``), the same tokens twice; one (8, 512)
    forward with exactly 13 flash launches at hd 112; a decode profile;
27. MoE serving: ``Model(get_config("deepseek-moe-16b"))`` at full width
    and depth (28 layers, 64 routed experts top-6 and 2 shared; ~33.8 GB
    bfloat16) the same way: 28 flash launches in the prefill, the same
    tokens twice, a decode profile; then one (8, 512) forward with its
    routing counted (C = 480 slots an expert; the share of dropped
    assignments);
28. ``phi3.5-moe-42b-a6.6b`` at full width and 16 of its 32 layers (its
    83.7 GB of bfloat16 weights at 32 layers do not fit the card with
    activations): one (8, 512) forward, 16 flash launches at G = 4, its
    routing counted, then timed;
29. phase 9's agreement for the reduced Zamba2-7B and DeepSeek-MoE-16B;
30. LM rounds: ``run_bhfl(model=LMAdapter(get_config(arch).reduced()))``
    at the API's LM defaults, Zamba2-7B on both engines and
    DeepSeek-MoE-16B on the loop: valid chain, finite losses, flash
    forward and backward launches against the attention layers and the
    SGD steps, each ME kernel once a round (phase 3 holds both ME kernels
    at these rounds' (6, D)).

31. flash with keys of their own length (cross-attention, Skv != Sq,
    non-causal): Llama-3.2-Vision's prefill (8, 57) and forward (8, 512)
    queries to 1024 context keys (64 query over 8 kv heads of 128),
    MusicGen-medium's (8, 57) and (8, 512) to 256 keys (24 over 24 heads
    of 64) in bf16 and once in fp32, a ragged Skv of 100 and Sq > Skv
    (512 queries to 16 keys): phase 10's checks and times, SDPA with
    ``enable_gqa`` beside; phase 14's backward checks with keys of their
    own length: Llama-3.2-Vision's (8, 512) to 1024 keys, MusicGen's to
    256 in bf16 and fp32, the trainer's folded (8, 64) to 256, the ragged
    Skv and Sq > Skv (each backward row's launches are the calls of its
    shape in phase 38); then the same checks at the two
    models' causal self-attention, (8, 57) and (8, 512) at 64 over 8
    heads of 128 and 24 over 24 of 64. Each row's launches are its own
    call's in phases 32-33 (``ops.flash_launch_shapes``): the check-only
    rows (fp32, ragged, Sq > Skv) have none, and every call of those
    phases has its row;
32. audio serving: ``Model(get_config("musicgen-medium"))`` at full width
    and depth (48 layers, d_model 1536, 24 heads of 64, 256 context
    tokens; 2,271,438,336 parameters, ~4.5 GB bfloat16) through phase
    8's checks with the reference's ``0.1 * ones`` context: 96 flash
    launches in the prefill (48 self, 48 cross), the same tokens twice,
    a (8, 512) forward with its context (96), a decode profile;
33. vlm serving: ``llama-3.2-vision-90b`` at full width and VLM_LAYERS =
    30 of its 100 layers (6 groups of 4 self-attention layers and a
    gated cross-attention block; 27,770,986,508 parameters, ~55.5 GB
    bfloat16; 87.7 B and ~175 GB at 100 layers do not fit the card) the
    same way: 30 flash launches in the prefill and in the forward;
34. phase 9's agreement for the reduced Llama-3.2-Vision and MusicGen
    (the vlm gates set nonzero, so the cross blocks add something), with
    the engine's context;
35. an LM round of the reduced MusicGen on the loop engine, as phase 30:
    its rounds pass no context (the reference's ``LMAdapter``), so only
    the self-attention runs, one flash launch a layer.

36. the PoFEL trainer: ``launch.train.train_reduced`` for yi-6b,
    rwkv6-1.6b and llama-3.2-vision-90b at the reference launcher's
    defaults (4 clusters, batch 8, seq 64, 3 rounds, sgd1; the vlm with
    the ``0.1 * ones`` context): chains verified at height 3, finite
    losses, and a round's launches exactly one folded flash (or wkv6)
    forward and one backward call an attention layer (vlm: self and
    cross) and one launch of each ME kernel a leaf; then the launcher's
    CLI, ``python -m repro_torch.launch.train --arch musicgen-medium
    --steps 2``, on the card by default;
37. one reduced ``pofel_round`` of MusicGen-medium and Llama-3.2-Vision
    (gates nonzero) on the card and on the CPU from one state: losses
    within 5e-2, similarities within 1e-4, the same leader wherever the
    CPU's top-2 margin is clear;
38. full-width trainer rounds, batch 8, seq 64,
    sgd1, the context: MusicGen-medium at full depth (2.27 B parameters:
    96 flash forward launches and 96 backward calls a round, Skv 256 !=
    Sq 64 in the cross half) and Zamba2-7B at 12 of its 81 layers and
    C = 2 (two groups: 2 launches of each at hd 112; at C = 4 its
    backward ran out of the card's memory): three rounds each (the second
    with ``local_step`` and ``consensus`` timed apart, the third
    profiled for the busy share), finite losses, the launches, the peak
    memory;
39. checkpoints: ``save_checkpoint`` / ``load_checkpoint`` of a MusicGen
    trainer state (full width, 4 of its 48 layers) on the card; the next
    round from the restored state is bit-identical to the next round
    from the live one.

40. the analyzer: ``python -m repro_torch.analysis src/repro_torch`` on
    this machine (no JAX) exits 0; its files analyzed and suppressed;
41. the serving launcher: ``launch.serve.serve_reduced`` for starcoder2-3b,
    deepseek-moe-16b, rwkv6-1.6b, zamba2-7b, musicgen-medium and
    llama-3.2-vision-90b at the CLI's defaults (batch 4, prompts of 32,
    16 new tokens, greedy, seed 0), twice: exactly the path's launches
    (flash once an attention layer in a dense, MoE, vlm or audio prefill,
    and in the hybrid's prefill, a forward, once a group; wkv6 once a
    layer in the RWKV-6 prefill, each replayed prompt step and each
    decode step), the same tokens twice, the same call on the CPU with
    the card's weights held to phase 9's rule; then ``python -m
    repro_torch.launch.serve`` with its defaults on the card; the
    prefill and per-token times beside the card's name and power limit;
42. AdamW: the reduced MusicGen's params, native and float32, through 3
    ``adamw_update`` steps with ``warmup_cosine_lr`` on the card and the
    CPU, clipped and not: within the float32 tolerance (bfloat16 leaves
    within one rounding), the moments' dtypes by the reference's rule;
    then one clipped update over MusicGen-medium's full 2.27 B bfloat16
    parameters with seeded gradients: float32 moments, bfloat16 params,
    finite values, its time and peak memory.

It prints a JSON line of kernel results, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. It exits non-zero, before that
line, when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 bandwidth, fp32 (non-tensor-core) and dense
# bf16 tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
SHAPES = ((8, 101_770), (50, 101_770))
# ME in phases 23-24: 6 nodes a scenario, committees of 16 and 32; float32,
# the MLP's dtype
SIM_SHAPES = ((6, 101_770), (16, 101_770), (32, 101_770))
MAIN_ROUNDS = 3
ME_KERNELS = ("cosine_partials", "weighted_aggregate")
WKV6_SHAPES = ((8, 1, 32, 64), (8, 512, 32, 64))
# decays: the timed range, and down to 1e-30 (the model's exp(-exp(.)))
WKV6_DECAYS = {"mid": (0.2, 0.99), "low": (1e-30, 0.999)}
# float32, sums over K in another order carried through up to 512 steps
WKV6_TOL = dict(rtol=1e-5, atol=1e-4)
N_REQUESTS, NEW_TOKENS = 8, 32
# bfloat16 model, card against CPU (tests/test_torch_rwkv6.py): logits
# within LOGIT_ATOL (0.02 on average); the argmax must agree where the
# top-2 margin exceeds twice that
LOGIT_ATOL, LOGIT_MEAN = 0.125, 0.02
# (B, S, Hq, Hk, hd, dtype, causal, window): the Yi-6B serving prefill
# and forward, each in bf16 (tensor cores) and fp32 (CUDA cores), then a
# window, a non-causal case
FLASH_CASES = ((8, 57, 32, 4, 128, "bfloat16", True, 0),
               (8, 57, 32, 4, 128, "float32", True, 0),
               (8, 512, 32, 4, 128, "bfloat16", True, 0),
               (8, 512, 32, 4, 128, "float32", True, 0),
               (1, 1000, 8, 2, 64, "bfloat16", True, 256),
               (2, 130, 4, 4, 32, "bfloat16", False, 0))
# both versions compute in float32, sums in another order
# (tests/test_kernels.py:19-21, 141-179)
FLASH_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2),
             "float32": dict(rtol=2e-5, atol=2e-5)}
# the backward kernels against the plain backward versions
# (tests/test_torch_kernels_cuda.py): wkv6 float32 sums over K and the
# walk in another order; flash float32 the same, bfloat16 one rounding of
# a float32 result
WKV6_BWD_SHAPES = ((8, 512, 32, 64), (8, 16, 2, 32), (2, 17, 3, 64),
                   (2, 33, 3, 16))
WKV6_GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
FLASH_BWD_CASES = ((8, 512, 32, 4, 128, "bfloat16", True, 0),
                   (8, 512, 32, 4, 128, "float32", True, 0),
                   (8, 16, 2, 2, 32, "bfloat16", True, 0),
                   (1, 1000, 8, 2, 64, "bfloat16", True, 256))
FLASH_GRAD_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2),
                  "float32": dict(rtol=1e-4, atol=1e-4)}
LM_ROUNDS = 2
# full-width FedSGD: (arch, layers trained) on one client of 8 x 513
# tokens at batch 4
FEDSGD = {"rwkv6-1.6b": None, "yi-6b": 16}
FEDSGD_ROWS, FEDSGD_SEQ, FEDSGD_BATCH = 8, 512, 4
# the batched engine's final global model against phase 4's: float32,
# cuBLAS's batched and single products may round differently
# (tests/test_batched_fel.py's ragged-shard tolerance)
BATCHED_W_TOL = dict(rtol=1e-5, atol=1e-6)
# the vmap rules at the batched LM rounds' shapes: (V, B, S, H, K) with
# V = 6 x 4 clients; flash (V, B, S, Hq, Hk, hd) there and at Yi-6B's heads
VMAP_WKV6 = (24, 8, 16, 2, 32)
VMAP_FLASH = ((24, 8, 16, 2, 2, 32), (4, 2, 512, 32, 4, 128))
ME_SHARDS = 4
# flash at Zamba2-7B's shared attention (32 query and kv heads of 112):
# its (8, 512) forward and an (8, 64) prefill-size call
FLASH_112_CASES = ((8, 512, 32, 32, 112, "bfloat16", True, 0),
                   (8, 64, 32, 32, 112, "bfloat16", True, 0),
                   (8, 512, 32, 32, 112, "float32", True, 0),
                   (8, 64, 32, 32, 112, "float32", True, 0))
# flash at the MoE models' heads, in the order of their launch counts in
# main(): DeepSeek-MoE-16B's prefill and (8, 512) forward (16 query and 16
# kv heads of 128), Phi-3.5-MoE's (8, 512) forward (32 query, 8 kv)
FLASH_MOE_CASES = ((8, 57, 16, 16, 128, "bfloat16", True, 0),
                   (8, 512, 16, 16, 128, "bfloat16", True, 0),
                   (8, 512, 32, 8, 128, "bfloat16", True, 0))
# the backward pair at the same heads: the hybrid trainer's (8, 512) and
# (8, 64) in bf16, (8, 512) in fp32
FLASH_112_BWD_CASES = ((8, 512, 32, 32, 112, "bfloat16", True, 0),
                       (8, 512, 32, 32, 112, "float32", True, 0),
                       (8, 64, 32, 32, 112, "bfloat16", True, 0))
# Phi-3.5-MoE's forward at full width and 16 of its 32 layers
PHI_LAYERS = 16
# cross-attention, (B, Sq, Skv, Hq, Hk, hd, dtype), in the order of their
# launch counts in main(): Llama-3.2-Vision's prefill and (8, 512)
# forward to its 1024 image tokens, MusicGen's to its 256 conditioning
# frames in bf16 and fp32, then a ragged Skv and Sq > Skv
FLASH_CROSS_CASES = ((8, 57, 1024, 64, 8, 128, "bfloat16"),
                     (8, 512, 1024, 64, 8, 128, "bfloat16"),
                     (8, 57, 256, 24, 24, 64, "bfloat16"),
                     (8, 512, 256, 24, 24, 64, "bfloat16"),
                     (8, 512, 256, 24, 24, 64, "float32"),
                     (2, 57, 100, 8, 2, 64, "bfloat16"),
                     (2, 512, 16, 8, 8, 32, "bfloat16"))
# the first four are on the served models' path, the last three checks only
CROSS_ON_PATH = 4
# the backward pair with keys of their own length, (B, Sq, Skv, Hq, Hk,
# hd, dtype): Llama-3.2-Vision's (8, 512) to 1024 keys, MusicGen's to 256
# in bf16 and fp32, the PoFEL trainer's folded MusicGen call (four
# clusters of 2 x 64 queries to 256 context frames), a ragged Skv and Sq >
# Skv
FLASH_CROSS_BWD_CASES = ((8, 512, 1024, 64, 8, 128, "bfloat16"),
                         (8, 512, 256, 24, 24, 64, "bfloat16"),
                         (8, 512, 256, 24, 24, 64, "float32"),
                         (8, 64, 256, 24, 24, 64, "bfloat16"),
                         (2, 57, 100, 8, 2, 64, "bfloat16"),
                         (2, 512, 16, 8, 8, 32, "bfloat16"))
# the same two models' self-attention (causal): Llama-3.2-Vision's prefill
# and (8, 512) forward (64 query over 8 kv heads of 128), then MusicGen's
# (24 over 24 heads of 64)
FLASH_XSELF_CASES = ((8, 57, 64, 8, 128, "bfloat16", True, 0),
                     (8, 512, 64, 8, 128, "bfloat16", True, 0),
                     (8, 57, 24, 24, 64, "bfloat16", True, 0),
                     (8, 512, 24, 24, 64, "bfloat16", True, 0))
# Llama-3.2-Vision-90B served at full width and 30 of its 100 layers
VLM_LAYERS = 30
# the hybrid and MoE LM rounds: (arch, FEL engine), the reduced configs
FAMILY_ROUNDS = (("zamba2-7b", "reference"), ("zamba2-7b", "batched"),
                 ("deepseek-moe-16b", "reference"))
# the audio family's LM round (phase 35): its rounds pass no context
CROSS_ROUNDS = (("musicgen-medium", "reference"),)
# the PoFEL trainer (phases 36-39): the reference launcher's defaults
TRAIN_C, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 64, 3
TRAIN_REDUCED = ("yi-6b", "rwkv6-1.6b", "llama-3.2-vision-90b")
TRAIN_AGREE = ("musicgen-medium", "llama-3.2-vision-90b")
# bfloat16 models, card against CPU (tests/test_torch_pofel_trainer.py)
TRAIN_LOSS_TOL, TRAIN_SIM_ATOL = 5e-2, 1e-4
# the agreement round starts from replicas made to differ, as the CPU
# test does: seeded noise of relative size TRAIN_DIVERGE[c] on cluster c
TRAIN_DIVERGE = (0.15, 0.03, 0.09, 0.21)
# full width: (arch, layers, clusters) — MusicGen-medium at full depth,
# Zamba2-7B at 12 of its 81 layers (two groups: the shared block runs
# twice) and 2 clusters: at 4 its backward needed more than the card's
# 80 GB (the plain Mamba2 loop's saved states and the full-size gradient
# of each use of a stacked float32 leaf)
TRAIN_FULL = (("musicgen-medium", None, 4), ("zamba2-7b", 12, 2))
# the checkpointed MusicGen state: full width, 4 of its 48 layers
CKPT_LAYERS = 4
# the serving launcher (phase 41): one arch of each family its CLI offers,
# at the CLI's defaults (batch 4, prompts of 32, 16 new tokens, greedy)
SERVE_ARCHS = ("starcoder2-3b", "deepseek-moe-16b", "rwkv6-1.6b",
               "zamba2-7b", "musicgen-medium", "llama-3.2-vision-90b")
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 16
# AdamW card against CPU (phase 42): float32 within the tolerance of
# tests/test_torch_optim.py (the gradient norm sums in another order)
ADAMW_STEPS = 3
ADAMW_RTOL, ADAMW_ATOL = 2e-5, 2e-6


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_tensor_cores() -> str:
    """The built flash library must hold HGMMA instructions (``wgmma`` in
    its SASS); "not checked" only where the toolkit has no cuobjdump."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "not checked (no cuobjdump)"
    lib = _build.build_dir() / "libflash_attention.so"
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    check(n > 0, f"{lib.name}: no HGMMA instruction in its SASS; the bf16 "
                 f"flash kernel is not on the tensor cores")
    return f"{n} HGMMA instructions in {lib.name}"


def graph_time_us(fn, reps: int = 20, samples: int = 50) -> float:
    """Median device time of one ``fn()`` call: ``reps`` calls captured in
    a CUDA graph, each replay timed with CUDA events, so host-side
    dispatch is not in the figure."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    return statistics.median(times)


def call_time_us(fn, samples: int = 50) -> float:
    """Median time of one eager call as the device timeline sees it
    (includes any wait for the host to issue the launches)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def bound_us(n_bytes: float, flops: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    return (max(t_bytes, t_ops) * 1e6,
            "bytes" if t_bytes >= t_ops else "operations")


def entry(name, source, replaces, W, max_err, bit, k_us, p_us, b, lib_us,
          call_us, **extra):
    b_us, b_by = b
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "shape": list(W.shape), "dtype": str(W.dtype).split(".")[-1],
            "max_abs_err": max_err, "bit_identical": bit,
            "ms": k_us / 1e3, "plain_ms": p_us / 1e3,
            "bound_ms": b_us / 1e3, "bound_by": b_by,
            "library_ms": None if lib_us is None else lib_us / 1e3,
            "kernel_us": k_us, "plain_us": p_us, "bound_us": b_us,
            "library_us": lib_us, "call_us": call_us, **extra}


def device_kernels(fn) -> tuple[list, int]:
    """Names of the device kernels one ``fn()`` call launches
    (``torch.profiler``), and how many sessions were taken again. A
    session that records no device activity at all is taken again after
    a throwaway session (:func:`warm_profiler`), up to four sessions:
    the profiler, not ``fn``, came back empty (``fn`` is a kernel call
    whose outputs are checked apart; an H100 run saw two empty sessions
    in a row). The retries go into the kernels line, so a flaky profiler
    shows there."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(4):
        if attempt:
            print("device_kernels: the profiler recorded no device activity; "
                  "profiling the call again", flush=True)
            warm_profiler(torch.device("cuda", torch.cuda.current_device()))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names, attempt


def warm_profiler(dev) -> None:
    """One throwaway CUDA ``torch.profiler`` session, so that no measured
    session is a process's first (a first session can come back without
    device records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        (x + 1).sum()
        torch.cuda.synchronize()


def check_partials(W, gw) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import cosine_partials_ref
    out = ops.cosine_partials(W, gw)
    again = ops.cosine_partials(W, gw)
    torch.cuda.synchronize()
    on_card, retries = device_kernels(lambda: ops.cosine_partials(W, gw))
    check(len(on_card) == 1 and "cosine_partials" in on_card[0],
          f"cosine_partials {tuple(W.shape)}: one call put {on_card} on the "
          f"card, want one cosine_partials kernel")
    ref = cosine_partials_ref(W, gw)
    bit = all(torch.equal(a, b) for a, b in zip(out, again))
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    tag = f"cosine_partials {tuple(W.shape)} {W.dtype}"
    check(bit, f"{tag}: two launches on one input differ")
    # tests/test_kernels.py:36-39 (dot atol 1e-2; all rtol 1e-4)
    check(torch.allclose(out[0], ref[0], rtol=1e-4, atol=1e-2)
          and torch.allclose(out[1], ref[1], rtol=1e-4, atol=0)
          and torch.allclose(out[2], ref[2], rtol=1e-4, atol=0),
          f"{tag}: disagrees with cosine_partials_ref (max abs err {err})")
    N, D = W.shape
    n_bytes = N * D * W.element_size() + D * gw.element_size() \
        + (2 * N + 1) * 4
    return entry(
        "cosine_partials", "src/repro_torch/kernels/csrc/cosine_partials.cu",
        "src/repro/kernels/cosine_sim.py:27", W, err, bit,
        graph_time_us(lambda: ops.cosine_partials(W, gw)),
        graph_time_us(lambda: cosine_partials_ref(W, gw)),
        bound_us(n_bytes, 4.0 * N * D + 2.0 * D),
        graph_time_us(lambda: F.cosine_similarity(W, gw[None], dim=1)),
        call_time_us(lambda: ops.cosine_partials(W, gw)),
        kernel_combine_us=graph_time_us(
            lambda: ops.batched_cosine_similarity(W, gw)),
        profiler_retries=retries,
        library_call="torch.nn.functional.cosine_similarity, against "
                     "kernel_combine_us (kernel + combine)")


def check_aggregate(W, w) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weighted_aggregate_ref
    from repro_torch.kernels.weighted_agg import vector_width
    out = ops.weighted_aggregate(W, w)
    again = ops.weighted_aggregate(W, w)
    torch.cuda.synchronize()
    ref = weighted_aggregate_ref(W, w)
    bit = torch.equal(out, again)
    err = float((out - ref).abs().max())
    tag = f"weighted_aggregate {tuple(W.shape)} {W.dtype}"
    check(bit, f"{tag}: two launches on one input differ")
    # tests/test_kernels.py:19-21,86
    tol = (dict(rtol=2e-2, atol=2e-2) if W.dtype == torch.bfloat16
           else dict(rtol=2e-5, atol=2e-6))
    check(torch.allclose(out, ref, **tol),
          f"{tag}: disagrees with weighted_aggregate_ref (max abs err {err})")
    N, D = W.shape
    lam = (w / w.sum()).to(W.dtype)
    Wt = W.t()
    vec = vector_width(D, W.data_ptr(), W.element_size())
    return entry(
        "weighted_aggregate", "src/repro_torch/kernels/csrc/weighted_agg.cu",
        "src/repro/kernels/weighted_agg.py:21", W, err, bit,
        graph_time_us(lambda: ops.weighted_aggregate(W, w)),
        graph_time_us(lambda: weighted_aggregate_ref(W, w)),
        bound_us(N * D * W.element_size() + N * 4 + D * 4, 2.0 * N * D),
        graph_time_us(lambda: torch.mv(Wt, lam)),
        call_time_us(lambda: ops.weighted_aggregate(W, w)),
        vector_width=vec, library_call="torch.mv(W.t(), lam)")


def family_me_sizes() -> list:
    """D of the ME in phases 30 and 35's LM rounds: the reduced
    Zamba2-7B's, DeepSeek-MoE-16B's and MusicGen's parameter counts (6
    nodes at the API's LM defaults; the flattening is float32)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_api import Model
    return [Model(get_config(arch).reduced(), device="cpu").n_params()
            for arch in ("zamba2-7b", "deepseek-moe-16b",
                         "musicgen-medium")]


def phase_kernels(dev) -> list:
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    cases = [(N, D, dt) for N, D in SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(N, D, torch.float32) for N, D in SIM_SHAPES]
    cases += [(6, D, torch.float32) for D in family_me_sizes()]
    for N, D, dt in cases:
        W = torch.randn(N, D, generator=gen, device=dev).to(dt)
        gw = torch.randn(D, generator=gen, device=dev).to(dt)
        w = torch.rand(N, generator=gen, device=dev) * 99.0 + 1.0
        for row in (check_partials(W, gw), check_aggregate(W, w)):
            print(f"kernel {row['name']} {row['shape']} {row['dtype']}: "
                  f"max_abs_err {row['max_abs_err']:.3e} bit-identical "
                  f"{row['bit_identical']} | kernel {row['kernel_us']:.2f}"
                  f" us, plain {row['plain_us']:.2f} us, library "
                  f"{row['library_us']:.2f} us, bound "
                  f"{row['bound_us']:.2f} us, eager call "
                  f"{row['call_us']:.2f} us", flush=True)
            rows.append(row)
    return rows


def time_model_evaluation(dev, N: int = 8, D: int = 101_770) -> float:
    """Wall time of one synchronized ME call (flattened models already
    stacked) at the main path's shape, median of 20, in ms."""
    import torch
    from repro_torch.core.model_eval import model_evaluation
    gen = torch.Generator(device=dev).manual_seed(1)
    W = torch.randn(N, D, generator=gen, device=dev)
    sizes = torch.full((N,), 500.0, device=dev)
    times = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = model_evaluation(W, sizes)
        res.similarities.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[5:])


def phase_main_path(dev):
    import torch
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.obs import TraceRecorder, use_recorder
    rec = TraceRecorder("chip_smoke")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with use_recorder(rec):
        run = api.run_bhfl(model="mlp", n_nodes=8, clients_per_node=5,
                           fel_iterations=3, rounds=MAIN_ROUNDS, seed=0,
                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(run.chain_valid, "main path: chain does not verify")
    check(run.chain_height == MAIN_ROUNDS,
          f"main path: chain height {run.chain_height} != {MAIN_ROUNDS}")
    check(all(math.isfinite(m.test_loss) and math.isfinite(m.test_accuracy)
              for m in run.history), "main path: non-finite loss/accuracy")
    for name in ME_KERNELS:
        check(counts[name] == MAIN_ROUNDS,
              f"main path: {name} launched {counts[name]} times in "
              f"{MAIN_ROUNDS} rounds (want one per round)")
    w1 = run.runtime.global_params["w1"]
    check(w1.is_cuda and tuple(w1.shape) == (784, 128),
          f"main path: global model w1 is {tuple(w1.shape)} on {w1.device}")
    per_round = {}
    for s in rec.spans:
        if s.round is None:
            continue
        d = per_round.setdefault(s.round, {})
        d[s.name] = d.get(s.name, 0.0) + s.wall_dur * 1e3
    for k in sorted(per_round):
        m = run.history[k]
        print(f"round {k}: wall {per_round[k]['round']:.1f} ms, fel "
              f"{per_round[k]['fel']:.1f} ms, ME phase "
              f"{per_round[k]['phase:model_evaluation']:.2f} ms (host), "
              f"leader {m.leader_id}, acc {m.test_accuracy:.4f}, loss "
              f"{m.test_loss:.4f}", flush=True)
    me_ms = time_model_evaluation(dev)
    print(f"model_evaluation (8, 101770) synchronized: {me_ms:.3f} ms",
          flush=True)
    summary = {"wall_s": wall, "launches": counts,
               "chain_height": run.chain_height,
               "leaders": [m.leader_id for m in run.history],
               "test_accuracy": [m.test_accuracy for m in run.history],
               "test_loss": [m.test_loss for m in run.history],
               "me_sync_ms": me_ms,
               "round_ms": {str(k): v for k, v in per_round.items()}}
    print("main_path " + json.dumps(summary), flush=True)
    round_ms = statistics.median(per_round[k]["round"] for k in per_round)
    # what the batched phase is held to: phase 4's leaders, similarities
    # and final global model (taken before phase 5 runs a fourth round)
    import numpy as np
    from repro_torch.core.serialization import flatten_pytree
    ref = {"leaders": summary["leaders"], "per_round": per_round,
           "sims": [np.asarray(m.consensus.similarities, np.float64)
                    for m in run.history],
           "global": flatten_pytree(run.runtime.global_params).clone()}
    return counts, run.runtime, round_ms, ref


def device_time(fn, what: str, host: bool = True):
    """Run ``fn`` under ``torch.profiler``: (device ops, busy µs — the union
    of the device's kernel and copy intervals —, {name: µs}). ``host``
    False records the device alone (a run of many host ops, whose host
    tracing would slow it by an order of magnitude)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(len(spans) > 0, f"{what}: the profiler saw no device activity")
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for t0, t1, name in spans:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    return len(spans), busy_us, by_name


def device_busy(fn, what: str, host: bool = True):
    """:func:`device_time` with the top 8 [name, µs] in place of the
    dict."""
    n_ops, busy_us, by_name = device_time(fn, what, host)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return n_ops, busy_us, [[n[:80], round(t, 1)] for n, t in top]


# device kernels of the two backward kernels, by name (csrc/*.cu)
BACKWARD_KERNEL_NAMES = ("wkv6_bwd", "flash_bwd")


def step_breakdown(fn, what: str) -> dict:
    """Device time of one ``fn()`` (an SGD step) by kernel name under
    ``torch.profiler``: the busy µs, the top 10 [name, µs, share of busy]
    and the two backward kernels' µs and share."""
    n_ops, busy_us, by_name = device_time(fn, what)
    bwd = {k: sum(t for n, t in by_name.items() if k in n)
           for k in BACKWARD_KERNEL_NAMES}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": n_ops, "busy_us": busy_us,
            "top": [[n[:90], round(t, 1), round(t / busy_us, 4)]
                    for n, t in top],
            "backward_us": bwd,
            "backward_share": sum(bwd.values()) / busy_us}


def phase_profile(runtime, round_ms: float, tag: str = "profile") -> dict:
    """Device busy share of one round: the union of the device's kernel
    and copy intervals in a profiled round, over the median wall time of
    the unprofiled rounds (the profiler slows the host, not the device)."""
    n_ops, busy_us, top = device_busy(runtime.run_round, tag)
    share = busy_us / (round_ms * 1e3)
    print(f"{tag}: {n_ops} device ops, busy {busy_us:.0f} us in a "
          f"{round_ms:.1f} ms round: busy share {share:.4f}, idle share "
          f"{1 - share:.4f}", flush=True)
    out = {"device_ops": n_ops, "busy_us": busy_us, "round_ms": round_ms,
           "busy_share": share, "top_us": top}
    print(f"{tag} " + json.dumps(out), flush=True)
    return out


def phase_agreement(dev) -> None:
    """The card against the CPU on one short run with dropout off: the
    same leaders, similarities within 1e-4 and accuracy within 1e-3."""
    import numpy as np
    from repro_torch import api
    from repro_torch.models.mlp import MLPConfig
    kw = dict(model="mlp", n_nodes=4, clients_per_node=2, fel_iterations=1,
              rounds=2, seed=3, mlp=MLPConfig(dropout=0.0),
              data=api.make_mnist_like(400, 100, seed=3))
    gpu = api.run_bhfl(device=dev, **kw)
    cpu = api.run_bhfl(device="cpu", **kw)
    check(gpu.chain_valid and cpu.chain_valid, "agreement: invalid chain")
    for g, c in zip(gpu.history, cpu.history):
        sg = np.asarray(g.consensus.similarities, np.float64)
        sc = np.asarray(c.consensus.similarities, np.float64)
        check(np.allclose(sg, sc, rtol=0, atol=1e-4),
              f"agreement: round {g.round} similarities {sg} vs {sc}")
        top = np.sort(sc)[-2:]
        if top[1] - top[0] > 1e-3:   # leader decided by a clear margin
            check(g.leader_id == c.leader_id,
                  f"agreement: round {g.round} leader {g.leader_id} vs "
                  f"{c.leader_id}")
        check(abs(g.test_accuracy - c.test_accuracy) <= 1e-3,
              f"agreement: round {g.round} accuracy {g.test_accuracy} vs "
              f"{c.test_accuracy}")
    print("agreement: card and CPU agree on leaders "
          f"{[m.leader_id for m in gpu.history]}", flush=True)


def wkv6_bound_us(B: int, S: int, H: int, K: int) -> tuple[float, str]:
    """Read r, k, v, w, u and s0 once, write o and the final state once;
    5 float32 operations per state entry and step, the fewest the
    function needs: o_t[j] = Σ_i r_i·S_ij + v_j·(Σ_i r_i·u_i·k_i) is one
    multiply-add per entry (the bonus sum is O(K) a step), and
    S_ij ← w_i·S_ij + k_i·v_j is three."""
    n_bytes = 4 * (5 * B * S * H * K + H * K + 2 * B * H * K * K)
    return bound_us(n_bytes, 5.0 * B * H * S * K * K)


def wkv6_inputs(gen, dev, B: int, S: int, H: int, K: int, decay: str):
    """r, k, v, u ~ N(0, 1), s0 ~ 0.1 N(0, 1); w uniform over the "mid"
    range, or log-uniform over the "low" one."""
    import math
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    r, k, v = randn(B, S, H, K), randn(B, S, H, K), randn(B, S, H, K)
    lo, hi = WKV6_DECAYS[decay]
    x = torch.rand(B, S, H, K, generator=gen, device=dev)
    if decay == "mid":
        w = lo + (hi - lo) * x
    else:
        w = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * x)
    return r, k, v, w, randn(H, K), 0.1 * randn(B, H, K, K)


def wkv6_agrees(args, tag: str) -> tuple[float, bool]:
    """The kernel against its plain version at WKV6_TOL, twice on one
    input (bit-identical): (max abs err, bit-identical)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import wkv6_recurrence_ref
    out = ops.wkv6_recurrence(*args)
    again = ops.wkv6_recurrence(*args)
    torch.cuda.synchronize()
    ref = wkv6_recurrence_ref(*args)
    bit = all(torch.equal(a, b) for a, b in zip(out, again))
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    check(bit, f"{tag}: two launches on one input differ")
    check(all(torch.allclose(a, b, **WKV6_TOL) for a, b in zip(out, ref)),
          f"{tag}: disagrees with wkv6_recurrence_ref (max abs err {err})")
    return err, bit


def check_wkv6(gen, dev, B: int, S: int, H: int, K: int) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import wkv6_recurrence_ref
    from repro_torch.kernels.wkv6 import launch_shape
    tag = f"wkv6 {(B, S, H, K)}"
    low_err, _ = wkv6_agrees(wkv6_inputs(gen, dev, B, S, H, K, "low"),
                             f"{tag} decays {WKV6_DECAYS['low']}")
    args = wkv6_inputs(gen, dev, B, S, H, K, "mid")
    err, bit = wkv6_agrees(args, tag)
    r = args[0]
    # the plain loop is S steps of ~8 launches: fewer graph replays
    plain_reps = dict(reps=2, samples=5) if S > 64 else {}
    return entry(
        "wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
        "src/repro/kernels/wkv6.py:29", r, err, bit,
        graph_time_us(lambda: ops.wkv6_recurrence(*args)),
        graph_time_us(lambda: wkv6_recurrence_ref(*args), **plain_reps),
        wkv6_bound_us(B, S, H, K), None,
        call_time_us(lambda: ops.wkv6_recurrence(*args)),
        low_decay_max_abs_err=low_err,
        geometry=launch_shape(B, H, K)._asdict(),
        library_call="none: no single PyTorch call computes the WKV6 "
                     "recurrence")


def phase_wkv6(dev) -> list:
    import torch
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for shape in WKV6_SHAPES:
        row = check_wkv6(gen, dev, *shape)
        geo = row["geometry"]
        launch = (f"one-step kernel: {geo['step_blocks']} blocks of "
                  f"{geo['step_threads']} threads" if shape[1] == 1 else
                  f"{geo['blocks']} blocks of {geo['threads']} threads, "
                  f"{geo['smem_bytes']} B shared")
        print(f"wkv6 {shape} launch: {launch}; Jc {geo['jc']}, G {geo['g']}"
              f", C {geo['c']}, T {geo['t']}, {geo['stages']} stages",
              flush=True)
        print(f"kernel wkv6 {row['shape']} float32: max_abs_err "
              f"{row['max_abs_err']:.3e} (decays down to 1e-30: "
              f"{row['low_decay_max_abs_err']:.3e}) bit-identical "
              f"{row['bit_identical']}"
              f" | kernel {row['kernel_us']:.2f} us, plain "
              f"{row['plain_us']:.2f} us, bound {row['bound_us']:.2f} us "
              f"({row['bound_by']}), eager call {row['call_us']:.2f} us",
              flush=True)
        rows.append(row)
    return rows


class FiniteWatch:
    """A model seen through the engine's eyes (cfg, device, init_cache,
    prefill, decode_step) that notes on the device whether every logit it
    returned was finite, without a host sync per step."""

    def __init__(self, model):
        import torch
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.finite = torch.ones((), dtype=torch.bool, device=model.device)

    def _watch(self, logits):
        import torch
        self.finite &= torch.isfinite(logits).all()
        return logits

    def init_cache(self, batch: int, seq_len: int):
        return self.model.init_cache(batch, seq_len)

    def needs_context(self) -> bool:
        return self.model.needs_context()

    def stub_context(self, batch: int):
        return self.model.stub_context(batch)

    def prefill(self, params, batch):
        logits, cache = self.model.prefill(params, batch)
        return self._watch(logits), cache

    def decode_step(self, params, cache, tokens, pos):
        logits, cache = self.model.decode_step(params, cache, tokens, pos)
        return self._watch(logits), cache


def serving_requests(vocab: int):
    """The serving phases' requests: 8 prompts of 16-64 tokens (lengths
    from numpy seed 0: 57, 47, 41, 29, 31, 18, 19, 16; ids from seed 1),
    32 new tokens each, greedy."""
    import numpy as np
    from repro_torch.serving import GenerationRequest
    lens = np.random.default_rng(0).integers(16, 65, N_REQUESTS)
    ids = np.random.default_rng(1)
    return [GenerationRequest(i, ids.integers(0, vocab, n).astype(np.int32),
                              NEW_TOKENS) for i, n in enumerate(lens)]


def n_elements(tree) -> int:
    return sum(n_elements(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


def attention_layers(cfg, context: bool = True) -> int:
    """Flash launches of one forward: one a self-attention layer, one a
    group's shared block in the hybrid, and with a ``context`` one a
    cross-attention (vlm: a block a group; audio: one in every layer)."""
    if cfg.family == "hybrid":
        from repro_torch.models.ssm_models import hybrid_group_shape
        return hybrid_group_shape(cfg)[0]
    if cfg.family == "vlm":
        from repro_torch.models.transformer import vlm_group_shape
        n_groups, spg = vlm_group_shape(cfg)
        return n_groups * (spg + int(context))
    if cfg.family == "audio" and context:
        return 2 * cfg.n_layers
    return cfg.n_layers


def context_batch(model, tokens) -> dict:
    """{"tokens": tokens} and, for a model that needs one, the serving
    engine's stub context (the reference's ``0.1 * ones``, float32)."""
    batch = {"tokens": tokens}
    if model.needs_context():
        batch["context"] = model.stub_context(tokens.shape[0])
    return batch


def phase_serving(dev, arch: str, kernel: str, then=None,
                  cfg=None) -> dict:
    """``arch`` (or ``cfg``, a cut of it) at full width behind
    ``ServingEngine.generate``, twice, the launches of ``kernel`` counted
    in each run; then a forward over (8, 512) tokens and a profile of
    decode steps. A recurrent model launches its kernel once per layer in
    every prompt-replay and decode step; a transformer once per self- and
    cross-attention in its one prefill; the hybrid replays the prompt
    through decode steps (decode attention is plain) and launches flash
    only in a forward, once a group. A model that needs a context gets
    the engine's stub in its forward too. ``then(model, params)``, if
    given, runs last, on the served weights."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model_api import Model
    from repro_torch.obs import TraceRecorder, use_recorder
    from repro_torch.serving import ServingEngine
    cfg = cfg or get_config(arch)
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = n_elements(params)
    reqs = serving_requests(cfg.vocab_size)
    max_p = max(len(r.prompt) for r in reqs)
    if cfg.rwkv:
        want, how = ((max_p + NEW_TOKENS - 1) * cfg.n_layers,
                     f"({max_p} + {NEW_TOKENS - 1}) x {cfg.n_layers}")
    elif cfg.family == "hybrid":
        want, how = 0, "none: the prompt replays through decode steps"
    else:
        want, how = (attention_layers(cfg), "one a self- and cross-"
                     "attention in the prefill")
    fwd_want = cfg.n_layers if cfg.rwkv else attention_layers(cfg)
    runs, shapes = [], []
    for attempt in range(2):
        watch = FiniteWatch(model)
        rec = TraceRecorder("serving")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with use_recorder(rec):
            out = ServingEngine(watch, params, device=dev).generate(reqs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        shapes.append(ops.flash_launch_shapes())
        span = {sp.name: sp.wall_dur * 1e3 for sp in rec.spans}
        runs.append({"tokens": [c.tokens for c in out], "counts": counts,
                     "finite": bool(watch.finite),
                     "prompt_ms": span["serve_prompt"],
                     "decode_ms": span["serve_decode"],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        check(len(out) == N_REQUESTS and all(
            c.request_id == i and 0 < len(c.tokens) <= NEW_TOKENS
            and all(0 <= t < cfg.vocab_size for t in c.tokens)
            for i, c in enumerate(out)),
              f"serving {arch}: bad completions "
              f"{[len(c.tokens) for c in out]}")
        check(runs[-1]["finite"], f"serving {arch}: a non-finite logit")
        check(counts[kernel] == want,
              f"serving {arch}: {kernel} launched {counts[kernel]} times, "
              f"want {how} = {want}")
        check(all(n == 0 for k, n in counts.items() if k != kernel),
              f"serving {arch}: other kernels launched {counts}")
    check(runs[0]["tokens"] == runs[1]["tokens"],
          f"serving {arch}: a second identical run gave other tokens")
    for k, r in enumerate(runs):
        print(f"serving {arch} run {k}: time to first token "
              f"({max_p}-token prompts) {r['prompt_ms']:.1f} ms, decode "
              f"{r['decode_ms']:.1f} ms = "
              f"{r['decode_ms'] / (NEW_TOKENS - 1):.2f} ms per decoded token "
              f"(batch {N_REQUESTS}), peak {r['peak_gb']:.2f} GB, {kernel} "
              f"launches {r['counts'][kernel]}", flush=True)

    # one forward over (8, 512) tokens
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (N_REQUESTS, 512)).astype(np.int32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    batch = context_batch(model, toks)
    with torch.inference_mode():
        logits, _ = model.forward(params, batch)
        torch.cuda.synchronize()
        fwd_launches = ops.launch_counts()[kernel]
        fwd_shapes = ops.flash_launch_shapes()
        check(fwd_launches == fwd_want,
              f"forward {arch}: {kernel} launched {fwd_launches} times, want "
              f"{fwd_want}")
        check(tuple(logits.shape) == (N_REQUESTS, 512, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"forward {arch}: logits {tuple(logits.shape)} not all finite")
        del logits
        fwd_peak = torch.cuda.max_memory_allocated() / 1e9
        fwd_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.forward(params, batch)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)

        # where a decode step's time goes: the step after the longest
        # prompt, over a cache of the served length
        cache = model.init_cache(N_REQUESTS, max_p + NEW_TOKENS)
        tok = toks[:, :1]
        step_ms = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_step(params, cache, tok, max_p)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        step = statistics.median(step_ms[2:])
        n_ops, busy_us, top = device_busy(
            lambda: [model.decode_step(params, cache, tok, max_p)
                     for _ in range(4)], f"serving {arch} profile")
    share = busy_us / 4 / (step * 1e3)
    print(f"forward {arch} (8, 512): {statistics.median(fwd_ms):.1f} ms "
          f"(median of 3), {kernel} launches {fwd_launches}, peak "
          f"{fwd_peak:.2f} GB", flush=True)
    print(f"decode step {arch} (batch 8): {step:.2f} ms synchronized; "
          f"profile of 4 steps: {n_ops} device ops, busy {busy_us / 4:.0f} "
          f"us a step: busy share {share:.4f}, idle share {1 - share:.4f}",
          flush=True)
    summary = {"arch": arch, "layers": cfg.n_layers, "n_params": n_params,
               "init_s": init_s,
               "max_prompt": max_p,
               "prompt_lens": [len(r.prompt) for r in reqs],
               "runs": [{k: v for k, v in r.items() if k != "tokens"}
                        for r in runs],
               "ttft_ms": [r["prompt_ms"] for r in runs],
               "ms_per_token": [r["decode_ms"] / (NEW_TOKENS - 1)
                                for r in runs],
               "forward_ms": fwd_ms, "forward_launches": fwd_launches,
               "forward_peak_gb": fwd_peak, "decode_step_ms": step,
               "decode_device_ops": n_ops / 4, "decode_busy_us": busy_us / 4,
               "decode_busy_share": share, "decode_top_us": top,
               "first_tokens": runs[0]["tokens"][0][:8]}
    print("serving " + json.dumps(summary), flush=True)
    out = {"launches": runs[0]["counts"][kernel],
           "forward_launches": fwd_launches,
           # flash launches by call, the first prefill's and the forward's
           "shapes": [shapes[0], fwd_shapes]}
    if then is not None:
        out["then"] = then(model, params)
    return out


def teacher_forced(model, params, reqs, forced):
    """(B, n, V) float32 logits on the host: the left-padded prompts of
    ``reqs`` taken in as the engine takes them (a transformer's prefill,
    with the engine's context where the model needs one, and its cache
    grown by n slots; a recurrent model's replay through decode steps),
    then ``forced`` (B, n) fed one token a step, as the engine feeds its
    own tokens."""
    import numpy as np
    import torch
    from repro_torch.serving import grow_cache
    P = max(len(r.prompt) for r in reqs)
    n = forced.shape[1]
    padded = np.zeros((len(reqs), P), np.int32)
    for i, r in enumerate(reqs):
        padded[i, P - len(r.prompt):] = r.prompt
    feed = torch.from_numpy(np.concatenate([padded, forced], 1)).to(
        model.device)
    out = []
    with torch.inference_mode():
        if model.cfg.rwkv or model.cfg.family == "hybrid":
            cache = model.init_cache(len(reqs), P + n)
            for i in range(P - 1):
                _, cache = model.decode_step(params, cache,
                                             feed[:, i:i + 1], i)
            start = P - 1
        else:
            logits, cache = model.prefill(params,
                                          context_batch(model, feed[:, :P]))
            cache = grow_cache(cache, n)
            out.append(logits[:, -1].float().cpu())
            start = P
        for i in range(start, P + n - 1):
            logits, cache = model.decode_step(params, cache,
                                              feed[:, i:i + 1], i)
            out.append(logits[:, -1].float().cpu())
    return torch.stack(out, 1)


def tree_to(tree, dev):
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


class RoutingTape:
    """The MoE routing of one run, recorded (``record``) and then forced
    on another (``replay``): each ``moe.router_topk`` call of the replay
    keeps its own probabilities but takes the recorded expert choices, so
    the two runs dispatch alike and differ only by rounding. A choice
    that bfloat16 rounding can flip (the recorded router logits' gap
    between the k-th and the (k+1)-th expert within 2 * LOGIT_ATOL, the
    margin rule of the token argmax) may differ; ``mismatched`` counts
    the tokens whose own choice differs where the gap is clear, ``flipped``
    all those whose choice differs."""

    def __init__(self):
        self.tape, self.mode, self.at = [], "record", 0
        self.flipped = self.mismatched = self.tokens = 0

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.inner = moe, moe.router_topk
        moe.router_topk = self._route
        self.at = 0
        return self

    def __exit__(self, *exc):
        self.moe.router_topk = self.inner
        self.mode = "replay"

    def _route(self, x, w, cfg):
        import torch
        gates, idx, probs = self.inner(x, w, cfg)
        if self.mode == "record":
            self.tape.append((idx.cpu(), (x.float() @ w.float()).cpu()))
            return gates, idx, probs
        want, logits = self.tape[self.at]
        self.at += 1
        k = cfg.experts_per_token
        top = logits.sort(-1, descending=True).values
        clear = (top[:, k - 1] - top[:, k] > 2 * LOGIT_ATOL
                 if k < top.shape[1] else torch.ones(len(top), dtype=bool))
        same = (idx.cpu().sort(-1).values == want.sort(-1).values).all(-1)
        self.tokens += len(same)
        self.flipped += int((~same).sum())
        self.mismatched += int((clear & ~same).sum())
        forced = want.to(idx.device)
        g = probs.gather(-1, forced.long())
        return g / g.sum(-1, keepdim=True).clamp(min=1e-9), forced, probs


def phase_serving_agreement(dev, arch: str) -> None:
    """The reduced ``arch`` with one set of weights on the card and on the
    CPU (random QKV biases where the config has them, the vlm tanh gates
    at random nonzero values: at their init of 0 the cross blocks add
    nothing), fed the CPU's
    greedy tokens: logits within LOGIT_ATOL, and the same argmax wherever
    the CPU's top-2 margin exceeds 2 * LOGIT_ATOL. A MoE model's card run
    takes the CPU run's expert choices (``RoutingTape``), and its own
    choices must agree wherever the CPU's router margin is clear."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_api import Model
    from repro_torch.serving import ServingEngine
    cfg = get_config(arch).reduced()
    card, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = card.init(gen)
    attn = params.get("layers", {}).get("attn", {})
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = torch.randn(attn[b].shape, generator=gen, device=dev
                                  ).to(attn[b].dtype)
    cross = params.get("cross_layers", {})
    for g in ("gate_attn", "gate_mlp"):
        if g in cross:
            cross[g] = torch.randn(cross[g].shape, generator=gen, device=dev)
    cpu_params = tree_to(params, "cpu")
    reqs = serving_requests(cfg.vocab_size)
    done = ServingEngine(cpu, cpu_params, device="cpu").generate(reqs)
    forced = np.asarray([c.tokens for c in done], np.int32)
    hold_to_cpu(f"serving agreement {arch}", card, params, cpu, cpu_params,
                reqs, forced)


def hold_to_cpu(tag: str, card, params, cpu, cpu_params, reqs,
                forced) -> None:
    """Phase 9's rule: both models teacher-forced along ``forced``, the
    CPU's greedy tokens (B, n) for ``reqs``: logits within LOGIT_ATOL (mean
    LOGIT_MEAN), and the same argmax wherever the CPU's top-2 margin
    exceeds 2 * LOGIT_ATOL. A MoE model's card run takes the CPU run's
    expert choices (``RoutingTape``), and its own choices must agree
    wherever the CPU's router margin is clear."""
    import torch
    with RoutingTape() as tape:
        lh = teacher_forced(cpu, cpu_params, reqs, forced)
    if cpu.cfg.family == "moe":
        with tape:
            lc = teacher_forced(card, params, reqs, forced)
        check(tape.at == len(tape.tape) and tape.mismatched == 0,
              f"{tag}: {tape.mismatched} tokens route to "
              f"other experts on the card where the CPU's router margin is "
              f"clear")
        print(f"{tag}: routing of {tape.tokens} tokens "
              f"over {len(tape.tape)} router calls, {tape.flipped} chose "
              f"other experts on the card, none where the margin is clear",
              flush=True)
    else:
        lc = teacher_forced(card, params, reqs, forced)
    check(torch.equal(lh.argmax(-1), torch.from_numpy(forced).long()),
          f"{tag}: the CPU's greedy tokens are not its argmax")
    diff = (lc - lh).abs()
    check(float(diff.max()) <= LOGIT_ATOL
          and float(diff.mean()) <= LOGIT_MEAN,
          f"{tag}: logits differ by {float(diff.max())} "
          f"(mean {float(diff.mean())})")
    top2 = lh.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * LOGIT_ATOL
    same = lc.argmax(-1) == lh.argmax(-1)
    check(bool(same[clear].all()),
          f"{tag}: {int((~same & clear).sum())} "
          f"clear-margin steps pick another token on the card")
    print(f"{tag}: {forced.shape[0]} x {forced.shape[1]} steps, "
          f"logits max diff {float(diff.max()):.4f} (mean "
          f"{float(diff.mean()):.5f}); argmax equal at {int(same.sum())} of "
          f"{same.numel()} steps, {int(clear.sum())} with a clear margin",
          flush=True)


def flash_bound_us(B: int, S: int, Hq: int, Hk: int, hd: int, size: int,
                   causal: bool, window: int, flop_per_s: float,
                   Skv: int | None = None) -> tuple[float, str]:
    """Read q, k, v once and write o once, (q + o)·Sq + (k + v)·Skv; 4·hd
    operations (two multiply-adds a dim, q·k and p·v) for each unmasked
    (q, k) pair — S(S+1)/2 a head when causal, fewer with a window,
    Sq·Skv with keys of their own length (Skv)."""
    Skv = S if Skv is None else Skv
    n_bytes = (2 * B * S * Hq * hd + 2 * B * Skv * Hk * hd) * size
    return bound_us(n_bytes, 4.0 * hd * B * Hq *
                    unmasked_pairs(S, causal, window, Skv), flop_per_s)


def check_flash(gen, dev, B: int, S: int, Hq: int, Hk: int, hd: int,
                dtype_name: str, causal: bool, window: int,
                Skv: int | None = None) -> dict:
    """Flash attention from S queries to S keys, or to ``Skv`` keys of
    their own length (cross-attention), against its plain version, timed
    beside it, SDPA and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_gqa_ref
    dtype = getattr(torch, dtype_name)
    Skv = S if Skv is None else Skv
    q = torch.randn(B, S, Hq, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hk, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hk, hd, generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window)
    out = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_gqa_ref(q, k, v, **kw)
    bit = torch.equal(out, again)
    err = float((out.float() - ref.float()).abs().max())
    tag = f"flash {(B, S, Hq, Hk, hd)} Skv {Skv} {dtype_name} causal " \
          f"{causal} window {window}"
    check(bit, f"{tag}: two launches on one input differ")
    check(torch.allclose(out.float(), ref.float(), **FLASH_TOL[dtype_name]),
          f"{tag}: disagrees with flash_attention_gqa_ref (max abs err "
          f"{err})")
    # the library yardstick: one SDPA call in its (B, H, S, hd) layout
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window > 0:
        pos = torch.arange(S, device=dev)
        mask = pos[None, :] > pos[:, None] - window
        if causal:
            mask &= pos[None, :] <= pos[:, None]

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    check(torch.allclose(sdpa().transpose(1, 2).float(), ref.float(),
                         **FLASH_TOL["bfloat16"]),
          f"{tag}: the SDPA yardstick does not compute the same function")
    plain_reps = (dict(reps=2, samples=10) if S * Skv * B * Hq > 1 << 24
                  else {})
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return entry(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:22", q, err, bit,
        graph_time_us(lambda: ops.flash_attention(q, k, v, **kw)),
        graph_time_us(lambda: flash_attention_gqa_ref(q, k, v, **kw),
                      **plain_reps),
        flash_bound_us(B, S, Hq, Hk, hd, q.element_size(), causal, window,
                       peak, Skv),
        graph_time_us(sdpa),
        call_time_us(lambda: ops.flash_attention(q, k, v, **kw)),
        kv_heads=Hk, kv_len=Skv, causal=causal, window=window,
        library_call="torch.nn.functional.scaled_dot_product_attention("
                     "enable_gqa=True)")


def phase_flash(dev, cases=FLASH_CASES, seed: int = 3) -> list:
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for case in cases:
        row = check_flash(gen, dev, *case)
        print(f"kernel flash_attention {row['shape']} Hk {row['kv_heads']} "
              f"Skv {row['kv_len']} {row['dtype']} causal {row['causal']} "
              f"window {row['window']}"
              f": max_abs_err {row['max_abs_err']:.3e} bit-identical "
              f"{row['bit_identical']} | kernel {row['kernel_us']:.2f} us, "
              f"plain {row['plain_us']:.2f} us, library "
              f"{row['library_us']:.2f} us, bound {row['bound_us']:.2f} us "
              f"({row['bound_by']}), eager call {row['call_us']:.2f} us",
              flush=True)
        rows.append(row)
    return rows



def wkv6_bwd_bound_us(B: int, S: int, H: int, K: int) -> tuple[float, str]:
    """Read r, k, v, w, dO, u and dS_T once, write dr, dk, dv, dw, du and
    ds0 once; 11 float32 operations per state entry and step, the fewest
    the gradient needs: one multiply-add each for dr, dk, dv and dw, and a
    multiply and a multiply-add for dS <- w dS + r dO^T."""
    n_bytes = 4 * (9 * B * S * H * K + 2 * H * K + 2 * B * H * K * K)
    return bound_us(n_bytes, 11.0 * B * H * S * K * K)


def check_wkv6_backward(gen, dev, B: int, S: int, H: int, K: int) -> dict:
    import torch
    from repro_torch.kernels import wkv6 as kw
    from repro_torch.kernels.ref import wkv6_backward_ref
    tag = f"wkv6 backward {(B, S, H, K)}"
    args = wkv6_inputs(gen, dev, B, S, H, K, "mid")
    d_o = torch.randn(B, S, H, K, generator=gen, device=dev)
    d_state = 0.1 * torch.randn(B, H, K, K, generator=gen, device=dev)
    _, _, ckpt = kw._forward(*args, save=True)

    def kernel():
        return kw.wkv6_backward(*args, d_o, d_state, ckpt)

    out, again = kernel(), kernel()
    torch.cuda.synchronize()
    ref = wkv6_backward_ref(*args, d_o, d_state)
    bit = all(torch.equal(a, b) for a, b in zip(out, again))
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    check(bit, f"{tag}: two launches on one input differ")
    check(all(torch.allclose(a, b, **WKV6_GRAD_TOL) for a, b in zip(out, ref)),
          f"{tag}: disagrees with wkv6_backward_ref (max abs err {err})")
    plain_reps = dict(reps=1, samples=3) if S > 64 else {}
    return entry(
        "wkv6_backward", "src/repro_torch/kernels/csrc/wkv6.cu",
        "src/repro/models/rwkv6.py:141 (jax.grad of lax.scan; the "
        "reference has no Pallas backward; forward src/repro/kernels/"
        "wkv6.py:29)", args[0], err, bit,
        graph_time_us(kernel),
        graph_time_us(lambda: wkv6_backward_ref(*args, d_o, d_state),
                      **plain_reps),
        wkv6_bwd_bound_us(B, S, H, K), None,
        call_time_us(kernel),
        forward_save_us=graph_time_us(lambda: kw._forward(*args, save=True)),
        library_call="none: no single PyTorch call computes the WKV6 "
                     "gradient")


def phase_wkv6_backward(dev) -> list:
    import torch
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for shape in WKV6_BWD_SHAPES:
        row = check_wkv6_backward(gen, dev, *shape)
        print(f"kernel wkv6_backward {row['shape']} float32: max_abs_err "
              f"{row['max_abs_err']:.3e} bit-identical "
              f"{row['bit_identical']} | kernel {row['kernel_us']:.2f} us "
              f"(training forward {row['forward_save_us']:.2f} us), plain "
              f"{row['plain_us']:.2f} us, bound {row['bound_us']:.2f} us "
              f"({row['bound_by']}), eager call {row['call_us']:.2f} us",
              flush=True)
        rows.append(row)
    return rows


def unmasked_pairs(S: int, causal: bool, window: int,
                   Skv: int | None = None) -> int:
    """(query, key) pairs the masks keep, S queries to S keys or to
    ``Skv`` keys, positions of both from 0."""
    Skv = S if Skv is None else Skv
    pairs = 0
    for qpos in range(S):
        hi = qpos + 1 if causal else Skv      # causal: Skv == S
        lo = max(0, qpos - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo)
    return pairs


def flash_bwd_bound_us(B: int, S: int, Hq: int, Hk: int, hd: int,
                       size: int, causal: bool, window: int,
                       flop_per_s: float,
                       Skv: int | None = None) -> tuple[float, str]:
    """Read q, k, v, o, dO and L once, write dq, dk, dv once: (q, o, dO,
    dq)·Sq and (k, v, dk, dv)·Skv; 10·hd operations for each unmasked
    (q, k) pair: five products over hd (Q·Kᵀ again, dO·Vᵀ, dV, dQ, dK), a
    multiply-add a dim each; Sq·Skv pairs with keys of their own
    length."""
    Skv = S if Skv is None else Skv
    n_bytes = (4 * B * S * Hq * hd + 4 * B * Skv * Hk * hd) * size \
        + 4 * B * Hq * S
    return bound_us(n_bytes, 10.0 * hd * B * Hq *
                    unmasked_pairs(S, causal, window, Skv), flop_per_s)


def check_flash_backward(gen, dev, B: int, S: int, Hq: int, Hk: int,
                         hd: int, dtype_name: str, causal: bool,
                         window: int, Skv: int | None = None) -> dict:
    """The backward kernel pair from S queries to S keys, or to ``Skv``
    keys of their own length, against the plain backward, timed beside
    it, the bound and the backward of SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_backward_ref
    dtype = getattr(torch, dtype_name)
    Skv = S if Skv is None else Skv
    q = torch.randn(B, S, Hq, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hk, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hk, hd, generator=gen, device=dev).to(dtype)
    d_o = torch.randn(B, S, Hq, hd, generator=gen, device=dev).to(dtype)
    o, lse = kf._forward(q, k, v, causal, window, want_lse=True)
    kw = dict(causal=causal, window=window)

    def kernel():
        return kf.flash_attention_backward(q, k, v, o, lse, d_o, **kw)

    out, again = kernel(), kernel()
    torch.cuda.synchronize()
    ref = flash_attention_backward_ref(q, k, v, o, lse, d_o, **kw)
    bit = all(torch.equal(a, b) for a, b in zip(out, again))
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(out, ref))
    tag = f"flash backward {(B, S, Hq, Hk, hd)} Skv {Skv} {dtype_name} " \
          f"causal {causal} window {window}"
    check(bit, f"{tag}: two launches on one input differ")
    check(all(torch.allclose(a.float(), b.float(),
                             **FLASH_GRAD_TOL[dtype_name])
              for a, b in zip(out, ref)),
          f"{tag}: disagrees with flash_attention_backward_ref (max abs err "
          f"{err})")
    # the library yardstick: the backward of one SDPA call (its graph
    # kept), timed eagerly with CUDA events
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    mask = None
    if window > 0:
        pos = torch.arange(S, device=dev)
        mask = pos[None, :] > pos[:, None] - window
        if causal:
            mask &= pos[None, :] <= pos[:, None]
    sdpa_out = F.scaled_dot_product_attention(
        *leaves, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    d_ot = d_o.transpose(1, 2)

    def library():
        return torch.autograd.grad(sdpa_out, leaves, d_ot, retain_graph=True)

    # the library rounds P and dS to bfloat16 for its products: held to
    # the plain version by the relative norm of the difference
    lib_err = max(float(torch.linalg.vector_norm(
        a.transpose(1, 2).float() - b.float())
        / torch.linalg.vector_norm(b.float()))
        for a, b in zip(library(), ref))
    check(lib_err <= 2e-2,
          f"{tag}: the SDPA backward yardstick does not compute the same "
          f"function (relative error {lib_err})")
    plain_reps = (dict(reps=2, samples=5) if S * Skv * B * Hq > 1 << 24
                  else {})
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return entry(
        "flash_attention_backward",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/models/layers.py:79 (jax.grad of blockwise_attention; "
        "the reference has no Pallas backward; forward src/repro/kernels/"
        "flash_attention.py:22)", q, err, bit,
        graph_time_us(kernel),
        graph_time_us(lambda: flash_attention_backward_ref(
            q, k, v, o, lse, d_o, **kw), **plain_reps),
        flash_bwd_bound_us(B, S, Hq, Hk, hd, q.element_size(), causal,
                           window, peak, Skv),
        call_time_us(library), call_time_us(kernel),
        kv_heads=Hk, kv_len=Skv, causal=causal, window=window,
        library_relative_err=lib_err,
        library_footing="eager: one call of each, CUDA events around it; "
                        "call_us is the kernel's on that footing",
        forward_lse_us=graph_time_us(
            lambda: kf._forward(q, k, v, causal, window, want_lse=True)),
        library_call="the backward of torch.nn.functional."
                     "scaled_dot_product_attention(enable_gqa=True), eager "
                     "(CUDA events around one call)")


def phase_flash_backward(dev, cases=FLASH_BWD_CASES, seed: int = 5) -> list:
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for case in cases:
        row = check_flash_backward(gen, dev, *case)
        row["eager_vs_library"] = row["call_us"] / row["library_us"]
        print(f"kernel flash_attention_backward {row['shape']} Hk "
              f"{row['kv_heads']} Skv {row['kv_len']} {row['dtype']} causal "
              f"{row['causal']} "
              f"window {row['window']}: max_abs_err {row['max_abs_err']:.3e}"
              f" bit-identical {row['bit_identical']} | kernel "
              f"{row['kernel_us']:.2f} us (training forward "
              f"{row['forward_lse_us']:.2f} us), plain {row['plain_us']:.2f}"
              f" us, bound {row['bound_us']:.2f} us ({row['bound_by']}) | "
              f"eager, one call each: kernel {row['call_us']:.2f} us, SDPA "
              f"backward {row['library_us']:.2f} us "
              f"({row['eager_vs_library']:.2f}x)", flush=True)
        rows.append(row)
    return rows


def sgd_steps(runtime, batch: int) -> int:
    """SGD steps of one round: every non-empty client, every FEL
    iteration, floor(n / min(batch, n)) steps each."""
    per_iter = sum(c.data_size // min(batch, c.data_size)
                   for cl in runtime.clusters for c in cl.clients
                   if c.data_size)
    return per_iter * runtime.cfg.fel_iterations


def phase_lm_rounds(dev) -> dict:
    """``run_bhfl(model=...)`` for both LM families on the card at the
    defaults: launch counts, chain and the round's spans."""
    import torch
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.obs import TraceRecorder, use_recorder
    out = {}
    for model, kernel in (("rwkv6", "wkv6"), ("transformer",
                                              "flash_attention")):
        rec = TraceRecorder(f"lm_{model}")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with use_recorder(rec):
            run = api.run_bhfl(model=model, rounds=LM_ROUNDS, seed=0,
                               device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        adapter = run.runtime.adapter
        layers = adapter.arch.n_layers
        steps = LM_ROUNDS * sgd_steps(run.runtime, adapter.batch_size)
        tag = f"LM round {model}"
        check(run.chain_valid, f"{tag}: chain does not verify")
        check(run.chain_height == LM_ROUNDS,
              f"{tag}: chain height {run.chain_height} != {LM_ROUNDS}")
        check(all(math.isfinite(m.test_loss) for m in run.history),
              f"{tag}: non-finite test loss")
        check(counts[kernel + "_backward"] == layers * steps,
              f"{tag}: {kernel}_backward launched "
              f"{counts[kernel + '_backward']} times, want {layers} layers x "
              f"{steps} SGD steps")
        check(counts[kernel] == layers * (steps + LM_ROUNDS),
              f"{tag}: {kernel} launched {counts[kernel]} times, want "
              f"{layers} layers x ({steps} SGD steps + {LM_ROUNDS} "
              f"evaluations)")
        per_round = {}
        for sp in rec.spans:
            if sp.round is None:
                continue
            d = per_round.setdefault(sp.round, {})
            d[sp.name] = d.get(sp.name, 0.0) + sp.wall_dur * 1e3
        for k in sorted(per_round):
            m = run.history[k]
            print(f"{tag} {k}: wall {per_round[k]['round']:.1f} ms, fel "
                  f"{per_round[k]['fel']:.1f} ms, consensus "
                  f"{per_round[k].get('consensus', float('nan')):.1f} ms, "
                  f"leader {m.leader_id}, loss {m.test_loss:.4f}, acc "
                  f"{m.test_accuracy:.4f}", flush=True)
        out[model] = {"wall_s": wall, "launches": counts,
                      "sgd_steps": steps, "layers": layers,
                      "leaders": [m.leader_id for m in run.history],
                      "test_loss": [m.test_loss for m in run.history],
                      "round_ms": {str(k): v for k, v in per_round.items()}}
        print(f"{tag}: {LM_ROUNDS} rounds in {wall:.2f} s, {steps} SGD "
              f"steps, {kernel} {counts[kernel]} and {kernel}_backward "
              f"{counts[kernel + '_backward']} launches", flush=True)
    print("lm_rounds " + json.dumps(out), flush=True)
    return out


def fedsgd(arch: str, kernel: str, layers_cut):
    """The full-width FedSGD phase on the served weights (``phase_serving``
    hands them over): one client of 8 x 513 tokens, batch 4, two SGD
    steps; ``layers_cut`` trains the first that many layers only."""
    def run(model, params):
        import dataclasses
        import numpy as np
        import torch
        from repro_torch.data.tokens import TokenDataset
        from repro_torch.fl.adapters import LMAdapter
        from repro_torch.fl.client import Client
        from repro_torch.kernels import ops
        cfg = model.cfg
        if layers_cut is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers_cut)
            params = {**params, "layers": {
                k: ({n: t[:layers_cut] for n, t in v.items()}
                    if isinstance(v, dict) else v[:layers_cut])
                for k, v in params["layers"].items()}}
        adapter = LMAdapter(cfg, batch_size=FEDSGD_BATCH, device=model.device)
        rows = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (FEDSGD_ROWS, FEDSGD_SEQ + 1)).astype(np.int32)
        client = Client(0, TokenDataset(rows, cfg.vocab_size))
        steps = FEDSGD_ROWS // FEDSGD_BATCH
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        new, loss = adapter.local_train(params, client, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        tag = f"FedSGD {arch} ({cfg.n_layers} layers)"
        check(math.isfinite(loss), f"{tag}: loss {loss}")
        check(counts[kernel + "_backward"] == cfg.n_layers * steps,
              f"{tag}: {kernel}_backward launched "
              f"{counts[kernel + '_backward']} times, want {cfg.n_layers} x "
              f"{steps}")
        check(counts[kernel] == cfg.n_layers * steps,
              f"{tag}: {kernel} launched {counts[kernel]} times, want "
              f"{cfg.n_layers} x {steps}")
        emb = new["embed"]
        check(emb.dtype == torch.float32 and bool(torch.isfinite(emb).all()),
              f"{tag}: embed after training is {emb.dtype} or not finite")
        del new
        torch.cuda.empty_cache()
        # where the device time of a step goes: one more step (a client of
        # one batch), after the first has done the set-up
        one = Client(0, TokenDataset(rows[:FEDSGD_BATCH], cfg.vocab_size))
        prof = step_breakdown(lambda: adapter.local_train(params, one,
                                                          seed=0),
                              f"{tag} profile")
        torch.cuda.empty_cache()
        print(f"{tag} profiled step: {prof['device_ops']} device ops, busy "
              f"{prof['busy_us'] / 1e3:.2f} ms; backward kernels "
              f"{ {k: round(v, 1) for k, v in prof['backward_us'].items()} }"
              f" us = {prof['backward_share']:.4f} of it; top: "
              f"{prof['top'][:5]}", flush=True)
        res = {"arch": arch, "layers": cfg.n_layers, "batch": FEDSGD_BATCH,
               "seq": FEDSGD_SEQ, "steps": steps, "loss": loss,
               "wall_s": wall, "step_ms": wall / steps * 1e3,
               "peak_gb": peak, "launches": counts, "profile": prof}
        print(f"{tag}, batch {FEDSGD_BATCH} x {FEDSGD_SEQ}: {steps} SGD steps"
              f" in {wall * 1e3:.1f} ms ({wall / steps * 1e3:.1f} ms a step, "
              f"the first with its set-up), loss {loss:.4f}, peak "
              f"{peak:.2f} GB, {kernel} {counts[kernel]} and "
              f"{kernel}_backward {counts[kernel + '_backward']} launches",
              flush=True)
        print("fedsgd " + json.dumps(res), flush=True)
        return res
    return run


def phase_grad_agreement(dev) -> None:
    """``Model.loss`` gradients through the kernels on the card against
    the CPU's, the same weights: every parameter gets one, within the
    bfloat16 rule relative to its scale s = max |g_cpu| (max diff
    <= 0.125 s, mean <= 0.02 s)."""
    import numpy as np
    import torch
    from repro_torch.fl.adapters import (_flat, _nested, tiny_rwkv6_config,
                                         tiny_transformer_config)
    from repro_torch.models.model_api import Model
    rows = np.random.default_rng(4).integers(0, 256, (4, 17))
    batch = {"tokens": torch.from_numpy(rows[:, :-1]),
             "labels": torch.from_numpy(rows[:, 1:])}
    for cfg in (tiny_rwkv6_config(n_layers=1), tiny_transformer_config()):
        cpu = Model(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        grads = []
        for model, p, b in ((Model(cfg, device=dev), tree_to(params, dev),
                             tree_to(batch, dev)), (cpu, params, batch)):
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in _flat(p).items()}
            loss = model.loss(_nested(leaves), b)
            grads.append(dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values())))))
        worst = 0.0
        for name, gh in grads[1].items():
            gc = grads[0][name].float().cpu()
            scale = float(gh.float().abs().max())
            diff = (gc - gh.float()).abs()
            check(bool(torch.isfinite(gc).all())
                  and float(diff.max()) <= 0.125 * scale
                  and float(diff.mean()) <= 0.02 * scale,
                  f"gradient agreement {cfg.name}: {name} differs by "
                  f"{float(diff.max())} (mean {float(diff.mean())}, scale "
                  f"{scale})")
            worst = max(worst, float(diff.max()) / max(scale, 1e-30))
        print(f"gradient agreement {cfg.name}: {len(grads[1])} parameters, "
              f"worst max diff {worst:.4f} of the gradient's scale",
              flush=True)

# -- slice 8: the batched FEL engine, the vmap rules, sharded ME ------------

def spans_by_round(rec) -> dict:
    """{round: {span name: summed wall ms}} of a recorder's spans."""
    per_round: dict = {}
    for sp in rec.spans:
        if sp.round is None:
            continue
        d = per_round.setdefault(sp.round, {})
        d[sp.name] = d.get(sp.name, 0.0) + sp.wall_dur * 1e3
    return per_round


def top2_margin(sims) -> float:
    top = sorted(float(x) for x in sims)[-2:]
    return top[1] - top[0] if len(top) == 2 else float("inf")


def phase_batched_main(dev, ref) -> dict:
    """Phase 4's run with ``engine="batched"``: the same chain checks,
    each ME kernel once a round, phase 4's leaders and its final global
    model within BATCHED_W_TOL (dropout on: the engine draws the loop's
    masks; cuBLAS may round a batched product and a single one
    differently)."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.obs import TraceRecorder, use_recorder
    rec = TraceRecorder("batched")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with use_recorder(rec):
        run = api.run_bhfl(model="mlp", n_nodes=8, clients_per_node=5,
                           fel_iterations=3, rounds=MAIN_ROUNDS, seed=0,
                           engine="batched", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rt = run.runtime
    tag = "batched main path"
    check(rt.engine == "batched", f"{tag}: engine is {rt.engine}")
    check(run.chain_valid, f"{tag}: chain does not verify")
    check(run.chain_height == MAIN_ROUNDS,
          f"{tag}: chain height {run.chain_height} != {MAIN_ROUNDS}")
    check(all(math.isfinite(m.test_loss) and math.isfinite(m.test_accuracy)
              for m in run.history), f"{tag}: non-finite loss/accuracy")
    for name in ME_KERNELS:
        check(counts[name] == MAIN_ROUNDS,
              f"{tag}: {name} launched {counts[name]} times in "
              f"{MAIN_ROUNDS} rounds (want one per round)")
    leaders = [m.leader_id for m in run.history]
    check(leaders == ref["leaders"],
          f"{tag}: leaders {leaders}, the reference engine's "
          f"{ref['leaders']}")
    gw, gw_ref = rt._global_flat, ref["global"]
    gw_err = float((gw - gw_ref).abs().max())
    check(torch.allclose(gw, gw_ref, **BATCHED_W_TOL),
          f"{tag}: final global model differs from phase 4's by {gw_err}")
    per_round = spans_by_round(rec)
    # the engine's dispatch span, one a round (it carries no round tag)
    dispatch = [sp.wall_dur * 1e3 for sp in rec.spans
                if sp.name == "fel.dispatch"]
    check(len(dispatch) == MAIN_ROUNDS,
          f"{tag}: {len(dispatch)} fel.dispatch spans in {MAIN_ROUNDS} rounds")
    for k in sorted(per_round):
        m, r4 = run.history[k], ref["per_round"][k]
        sims = np.asarray(m.consensus.similarities, np.float64)
        print(f"batched round {k}: wall {per_round[k]['round']:.1f} ms "
              f"(reference engine {r4['round']:.1f}), fel "
              f"{per_round[k]['fel']:.1f} ms (reference {r4['fel']:.1f}; "
              f"fel.dispatch {dispatch[k]:.1f}), "
              f"leader {m.leader_id}, top-2 margin {top2_margin(sims):.3e}, "
              f"similarities max diff "
              f"{float(np.abs(sims - ref['sims'][k]).max()):.3e}, acc "
              f"{m.test_accuracy:.4f}, loss {m.test_loss:.4f}", flush=True)
    round_ms = statistics.median(per_round[k]["round"] for k in per_round)
    fel_ms = statistics.median(per_round[k]["fel"] for k in per_round)
    ref_round = statistics.median(v["round"] for v in ref["per_round"].values())
    ref_fel = statistics.median(v["fel"] for v in ref["per_round"].values())
    summary = {"wall_s": wall, "launches": counts, "leaders": leaders,
               "global_max_abs_diff": gw_err, "round_ms_median": round_ms,
               "fel_ms_median": fel_ms, "reference_round_ms_median": ref_round,
               "reference_fel_ms_median": ref_fel,
               "steps_per_round": rt._engine.fel_iterations
               * rt._engine.steps_per_iteration, "fel_dispatch_ms": dispatch,
               "round_ms": {str(k): v for k, v in per_round.items()}}
    print(f"{tag}: median round {round_ms:.1f} ms (reference engine "
          f"{ref_round:.1f}), fel {fel_ms:.1f} ms (reference {ref_fel:.1f}) "
          f"= {fel_ms / round_ms:.4f} of the round; "
          f"{summary['steps_per_round']} vmapped SGD steps a round; final "
          f"global model max abs diff {gw_err:.3e}", flush=True)
    print("batched_main " + json.dumps(summary), flush=True)
    return {"counts": counts, "runtime": rt, "round_ms": round_ms}


def phase_fel_kernels(batched_rt, ref_rt) -> dict:
    """The device ops one FEL phase puts on the card, batched against the
    reference loop, from one round's global model each; and the host
    clock of the batched phase's parts (median of 5, synchronized): the
    batch plan (numpy), the dropout draws, the whole phase."""
    import torch
    eng = batched_rt._engine
    seed = batched_rt.cfg.seed + batched_rt.consensus.round + 1
    n_bat, busy_bat, _ = device_time(
        lambda: eng.run_round(batched_rt._global_flat, seed),
        "batched FEL phase")
    n_ref, busy_ref, _ = device_time(
        lambda: ref_rt._fel_models_reference(seed), "reference FEL phase")
    seeds = eng._batch_plan(seed)[1]
    parts = {"plan": lambda: eng._batch_plan(seed),
             "draws": lambda: eng._draws(seeds),
             "phase": lambda: eng.run_round(batched_rt._global_flat, seed)}
    host_ms = {}
    for name, fn in parts.items():
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        host_ms[name] = statistics.median(ms)
    out = {"batched_device_ops": n_bat, "batched_busy_us": busy_bat,
           "reference_device_ops": n_ref, "reference_busy_us": busy_ref,
           "batched_host_ms": host_ms}
    print(f"FEL phase on the card: batched {n_bat} device ops, busy "
          f"{busy_bat:.0f} us; reference loop {n_ref} device ops, busy "
          f"{busy_ref:.0f} us; batched phase {host_ms['phase']:.1f} ms "
          f"synchronized, of it the batch plan {host_ms['plan']:.1f} ms and "
          f"the dropout draws {host_ms['draws']:.1f} ms", flush=True)
    print("fel_kernels " + json.dumps(out), flush=True)
    return out


def phase_batched_lm(dev, lm_ref) -> dict:
    """Phase 15's LM rounds with ``engine="batched"``: valid chain, finite
    losses, and each model kernel launched forward and backward once a
    layer per vmapped SGD step for all the round's clients (the forward
    also once a layer per evaluation)."""
    import torch
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.obs import TraceRecorder, use_recorder
    out = {}
    for model, kernel in (("rwkv6", "wkv6"),
                          ("transformer", "flash_attention")):
        rec = TraceRecorder(f"batched_{model}")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with use_recorder(rec):
            run = api.run_bhfl(model=model, rounds=LM_ROUNDS, seed=0,
                               device=dev, engine="batched")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        rt = run.runtime
        layers = rt.adapter.arch.n_layers
        steps = LM_ROUNDS * rt._engine.fel_iterations \
            * rt._engine.steps_per_iteration
        tag = f"batched LM round {model}"
        check(rt.engine == "batched", f"{tag}: engine is {rt.engine}")
        check(run.chain_valid, f"{tag}: chain does not verify")
        check(run.chain_height == LM_ROUNDS,
              f"{tag}: chain height {run.chain_height} != {LM_ROUNDS}")
        check(all(math.isfinite(m.test_loss) for m in run.history),
              f"{tag}: non-finite test loss")
        check(counts[kernel + "_backward"] == layers * steps,
              f"{tag}: {kernel}_backward launched "
              f"{counts[kernel + '_backward']} times, want {layers} layers x "
              f"{steps} vmapped SGD steps")
        check(counts[kernel] == layers * (steps + LM_ROUNDS),
              f"{tag}: {kernel} launched {counts[kernel]} times, want "
              f"{layers} layers x ({steps} vmapped SGD steps + {LM_ROUNDS} "
              f"evaluations)")
        per_round = spans_by_round(rec)
        for k in sorted(per_round):
            m = run.history[k]
            r15 = lm_ref[model]["round_ms"][str(k)]
            print(f"{tag} {k}: wall {per_round[k]['round']:.1f} ms "
                  f"(reference engine {r15['round']:.1f}), fel "
                  f"{per_round[k]['fel']:.1f} ms (reference "
                  f"{r15['fel']:.1f}), leader {m.leader_id}, loss "
                  f"{m.test_loss:.4f}", flush=True)
        out[model] = {"wall_s": wall, "launches": counts,
                      "vmapped_steps": steps, "layers": layers,
                      "reference_sgd_steps": lm_ref[model]["sgd_steps"],
                      "leaders": [m.leader_id for m in run.history],
                      "test_loss": [m.test_loss for m in run.history],
                      "round_ms": {str(k): v for k, v in per_round.items()}}
        print(f"{tag}: {LM_ROUNDS} rounds in {wall:.2f} s, {steps} vmapped "
              f"SGD steps (reference engine: {lm_ref[model]['sgd_steps']} "
              f"SGD steps), {kernel} {counts[kernel]} and "
              f"{kernel}_backward {counts[kernel + '_backward']} launches "
              f"(reference engine {lm_ref[model]['launches'][kernel]} and "
              f"{lm_ref[model]['launches'][kernel + '_backward']})",
              flush=True)
    print("batched_lm_rounds " + json.dumps(out), flush=True)
    return out


def fold_row(name, replaces, shape, dtype, call_fn, v_calls_fn, plain_fn,
             bound, library_us, launches_key, err, plain_err,
             **extra) -> dict:
    """A kernels-line row of one folded (vmapped) call: its device time,
    the same work as V separate calls, the plain version at the folded
    shape, the bound; ``plain_err`` its max abs error against the plain
    version, ``err`` against the V separate launches."""
    plain_reps = extra.pop("plain_reps", {})
    k_us = graph_time_us(call_fn)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{'wkv6' if 'wkv6' in name else 'flash_attention'}.cu",
            "replaces": replaces, "launches": None,
            "launches_key": launches_key, "shape": list(shape),
            "dtype": dtype, "max_abs_err": plain_err,
            "v_launches_max_abs_diff": err, "bit_identical": err == 0.0,
            "ms": k_us / 1e3, "plain_ms": graph_time_us(plain_fn,
                                                        **plain_reps) / 1e3,
            "bound_ms": bound[0] / 1e3, "bound_by": bound[1],
            "library_ms": None if library_us is None else library_us / 1e3,
            "v_calls_ms": graph_time_us(v_calls_fn) / 1e3,
            "call": "vmapped (folded) call, fold copies included", **extra}


def max_diff(a, b) -> float:
    if a.numel() == 0 and b.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max())


def phase_vmap_wkv6(dev) -> list:
    """wkv6 forward (training: it saves the chunk states) and backward
    under ``torch.func.vmap`` at (V, B, S, H, K) = VMAP_WKV6 with s0
    unbatched, as the batched RWKV-6 round calls them: one launch each,
    bit-identical to V separate launches, within WKV6_TOL and
    WKV6_GRAD_TOL of the plain versions, timed beside them."""
    import torch
    from torch.func import vmap
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6 as kw
    from repro_torch.kernels.ref import wkv6_backward_ref, wkv6_recurrence_ref
    V, B, S, H, K = VMAP_WKV6
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    r, k, v, d_o = (randn(V, B, S, H, K) for _ in range(4))
    w = 0.2 + 0.79 * torch.rand(V, B, S, H, K, generator=gen, device=dev)
    u, s0 = randn(V, H, K), torch.zeros(B, H, K, K, device=dev)
    fwd = vmap(kw._Recurrence.apply, in_dims=(0, 0, 0, 0, 0, None, None))
    bwd = vmap(kw._RecurrenceBackward.apply,
               in_dims=(0, 0, 0, 0, 0, None, 0, None, 0))
    ops.reset_launch_counts()
    o, s_fin, ckpt = fwd(r, k, v, w, u, s0, True)
    grads = bwd(r, k, v, w, u, s0, d_o, None, ckpt)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    tag = f"wkv6 vmap {VMAP_WKV6}"
    check(counts["wkv6"] == 1 and counts["wkv6_backward"] == 1,
          f"{tag}: the folded calls launched {counts}, want one forward "
          f"and one backward")
    f_err = b_err = 0.0
    for i in range(V):
        oi, si, ci = kw._forward(r[i], k[i], v[i], w[i], u[i], s0, save=True)
        f_err = max(f_err, max_diff(o[i], oi), max_diff(s_fin[i], si),
                    max_diff(ckpt[i], ci))
        gi = kw.wkv6_backward(r[i], k[i], v[i], w[i], u[i], s0, d_o[i],
                              None, ci)
        b_err = max([b_err] + [max_diff(a[i], b) for a, b in zip(grads, gi)])
    check(f_err == 0.0 and b_err == 0.0,
          f"{tag}: the folded launch differs from {V} separate launches "
          f"(forward {f_err}, backward {b_err})")
    # the plain versions at the folded shape (B, S, V·H, K), at the
    # kernels' tolerances
    folded = [kw._fold(t, 0, V) for t in (r, k, v, w)]
    uf, s0f = u.reshape(V * H, K), kw._fold_state(s0, None, V)
    dof = kw._fold(d_o, 0, V)
    ro, rs = wkv6_recurrence_ref(*folded, uf, s0f)
    ref_f = (kw._unfold(ro, V), kw._unfold_state(rs, V))
    rg = wkv6_backward_ref(*folded, uf, s0f, dof, None)
    ref_b = (*(kw._unfold(t, V) for t in rg[:4]),
             rg[4].reshape(V, H, K), kw._unfold_state(rg[5], V))
    pf_err = max(max_diff(a, b) for a, b in zip((o, s_fin), ref_f))
    pb_err = max(max_diff(a, b) for a, b in zip(grads, ref_b))
    check(all(torch.allclose(a, b, **WKV6_TOL)
              for a, b in zip((o, s_fin), ref_f)),
          f"{tag}: the folded forward disagrees with the plain version "
          f"(max abs err {pf_err})")
    check(all(torch.allclose(a, b, **WKV6_GRAD_TOL)
              for a, b in zip(grads, ref_b)),
          f"{tag}: the folded backward disagrees with the plain version "
          f"(max abs err {pb_err})")
    rows = [
        fold_row("wkv6", "src/repro/kernels/wkv6.py:29", (V, B, S, H, K),
                 "float32", lambda: fwd(r, k, v, w, u, s0, True),
                 lambda: [kw._forward(r[i], k[i], v[i], w[i], u[i], s0,
                                      save=True) for i in range(V)],
                 lambda: wkv6_recurrence_ref(*folded, uf, s0f),
                 wkv6_bound_us(B, S, V * H, K), None, "wkv6", f_err, pf_err,
                 folded_shape=[B, S, V * H, K]),
        fold_row("wkv6_backward",
                 "src/repro/models/rwkv6.py:141 (jax.grad of lax.scan; the "
                 "reference has no Pallas backward)", (V, B, S, H, K),
                 "float32", lambda: bwd(r, k, v, w, u, s0, d_o, None, ckpt),
                 lambda: [kw.wkv6_backward(r[i], k[i], v[i], w[i], u[i], s0,
                                           d_o[i], None, ckpt[i])
                          for i in range(V)],
                 lambda: wkv6_backward_ref(*folded, uf, s0f, dof, None),
                 wkv6_bwd_bound_us(B, S, V * H, K), None, "wkv6_backward",
                 b_err, pb_err, folded_shape=[B, S, V * H, K])]
    for row in rows:
        print(f"vmap {row['name']} V x (B, S, H, K) = {tuple(row['shape'])}"
              f" folded to {tuple(row['folded_shape'])}: one launch, "
              f"bit-identical to {V} launches {row['bit_identical']}, "
              f"max_abs_err {row['max_abs_err']:.3e} against the plain "
              f"version | folded call {row['ms'] * 1e3:.2f} us, {V} calls "
              f"{row['v_calls_ms'] * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})",
              flush=True)
    return rows


def phase_vmap_flash(dev) -> list:
    """bf16 flash forward (with L, as training calls it) and backward under
    ``torch.func.vmap`` at each of VMAP_FLASH, causal: one launch each,
    bit-identical to V separate launches, within the bfloat16 FLASH_TOL
    and FLASH_GRAD_TOL of the plain versions, timed beside them."""
    import torch
    import torch.nn.functional as F
    from torch.func import vmap
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (flash_attention_backward_ref,
                                         flash_attention_gqa_ref)
    gen = torch.Generator(device=dev).manual_seed(7)
    fwd = vmap(kf._Attention.apply, in_dims=(0, 0, 0, None, None, None))
    bwd = vmap(kf._AttentionBackward.apply,
               in_dims=(0, 0, 0, 0, 0, 0, None, None))
    rows = []
    for V, B, S, Hq, Hk, hd in VMAP_FLASH:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q, d_o = randn(V, B, S, Hq, hd), randn(V, B, S, Hq, hd)
        k, v = randn(V, B, S, Hk, hd), randn(V, B, S, Hk, hd)
        ops.reset_launch_counts()
        o, lse = fwd(q, k, v, True, 0, True)
        grads = bwd(q, k, v, o, lse, d_o, True, 0)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        tag = f"flash vmap {(V, B, S, Hq, Hk, hd)}"
        check(counts["flash_attention"] == 1
              and counts["flash_attention_backward"] == 1,
              f"{tag}: the folded calls launched {counts}, want one forward "
              f"and one backward")
        f_err = b_err = 0.0
        for i in range(V):
            oi, li = kf._forward(q[i], k[i], v[i], True, 0, want_lse=True)
            f_err = max(f_err, max_diff(o[i], oi), max_diff(lse[i], li))
            gi = kf.flash_attention_backward(q[i], k[i], v[i], oi, li,
                                             d_o[i])
            b_err = max([b_err] + [max_diff(a[i], b)
                                   for a, b in zip(grads, gi)])
        check(f_err == 0.0 and b_err == 0.0,
              f"{tag}: the folded launch differs from {V} separate launches "
              f"(forward {f_err}, backward {b_err})")
        qf, kf_, vf, of, dof = (t.reshape(V * B, *t.shape[2:])
                                for t in (q, k, v, o, d_o))
        lf = lse.reshape(V * B, Hq, S)
        # the plain versions at the folded shape, at the kernels' tolerances
        ref_o = flash_attention_gqa_ref(qf, kf_, vf).reshape(o.shape)
        ref_g = [g.reshape(t.shape) for g, t in zip(
            flash_attention_backward_ref(qf, kf_, vf, of, lf, dof), grads)]
        pf_err = max_diff(o, ref_o)
        pb_err = max(max_diff(a, b) for a, b in zip(grads, ref_g))
        check(torch.allclose(o.float(), ref_o.float(),
                             **FLASH_TOL["bfloat16"]),
              f"{tag}: the folded forward disagrees with the plain version "
              f"(max abs err {pf_err})")
        check(all(torch.allclose(a.float(), b.float(),
                                 **FLASH_GRAD_TOL["bfloat16"])
                  for a, b in zip(grads, ref_g)),
              f"{tag}: the folded backward disagrees with the plain version "
              f"(max abs err {pb_err})")
        leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (qf, kf_, vf)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                  enable_gqa=True)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                qf.transpose(1, 2), kf_.transpose(1, 2), vf.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_out, leaves, dof.transpose(1, 2),
                                       retain_graph=True)

        big = dict(plain_reps=dict(reps=2, samples=10)) if S > 64 else {}
        shape = (V, B, S, Hq, Hk, hd)
        pair = [
            fold_row("flash_attention", "src/repro/kernels/flash_attention.py"
                     ":22", shape, "bfloat16",
                     lambda: fwd(q, k, v, True, 0, True),
                     lambda: [kf._forward(q[i], k[i], v[i], True, 0,
                                          want_lse=True) for i in range(V)],
                     lambda: flash_attention_gqa_ref(qf, kf_, vf),
                     flash_bound_us(V * B, S, Hq, Hk, hd, 2, True, 0,
                                    BF16_FLOP_PER_S),
                     graph_time_us(sdpa_fwd), "flash_attention", f_err,
                     pf_err, folded_shape=[V * B, S, Hq, Hk, hd],
                     library_call="torch.nn.functional."
                                  "scaled_dot_product_attention(enable_gqa="
                                  "True) at the folded shape", **big),
            fold_row("flash_attention_backward",
                     "src/repro/models/layers.py:79 (jax.grad of "
                     "blockwise_attention; the reference has no Pallas "
                     "backward)", shape, "bfloat16",
                     lambda: bwd(q, k, v, o, lse, d_o, True, 0),
                     lambda: [kf.flash_attention_backward(
                         q[i], k[i], v[i], o[i], lse[i], d_o[i])
                         for i in range(V)],
                     lambda: flash_attention_backward_ref(qf, kf_, vf, of,
                                                          lf, dof),
                     flash_bwd_bound_us(V * B, S, Hq, Hk, hd, 2, True, 0,
                                        BF16_FLOP_PER_S),
                     call_time_us(sdpa_bwd), "flash_attention_backward",
                     b_err, pb_err, folded_shape=[V * B, S, Hq, Hk, hd],
                     library_call="the backward of torch.nn.functional."
                                  "scaled_dot_product_attention at the "
                                  "folded shape, eager (CUDA events around "
                                  "one call)", **big)]
        for row in pair:
            print(f"vmap {row['name']} V x (B, S, Hq, Hk, hd) = {shape} "
                  f"folded to {tuple(row['folded_shape'])}: one launch, "
                  f"bit-identical to {V} launches {row['bit_identical']}, "
                  f"max_abs_err {row['max_abs_err']:.3e} against the plain "
                  f"version | folded call {row['ms'] * 1e3:.2f} us, {V} calls "
                  f"{row['v_calls_ms'] * 1e3:.2f} us, plain "
                  f"{row['plain_ms'] * 1e3:.2f} us, library "
                  f"{row['library_ms'] * 1e3:.2f} us, bound "
                  f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})",
                  flush=True)
        rows += pair
    return rows


def phase_sharded_me(batched_rt) -> dict:
    """``ShardedModelEvaluation(ME_SHARDS)`` on a batched round's W
    against the dense ME phase: gw bit-identical, similarities within
    rtol 1e-5, the same vote, two kernel launches a shard."""
    import torch
    from repro_torch.core.phases import ModelEvaluation, RoundContext
    from repro_torch.fl.sharded_consensus import ShardedModelEvaluation
    from repro_torch.kernels import ops
    rt = batched_rt
    W = rt._engine.run_round(rt._global_flat,
                             rt.cfg.seed + rt.consensus.round + 1)
    sizes = [float(c.data_size) for c in rt.clusters]

    def context():
        return RoundContext(round=0, models=list(W), data_sizes=sizes,
                            n_nodes=W.shape[0])

    dense, sharded = context(), context()
    ModelEvaluation().run(dense)
    ops.reset_launch_counts()
    ShardedModelEvaluation(ME_SHARDS).run(sharded)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    d, s = dense.evaluation, sharded.evaluation
    tag = f"sharded ME ({ME_SHARDS} shards of {tuple(W.shape)})"
    check(counts["weighted_aggregate"] == ME_SHARDS
          and counts["cosine_partials"] == ME_SHARDS,
          f"{tag}: launches {counts}, want two a shard")
    check(torch.equal(s.global_model, d.global_model),
          f"{tag}: gw differs from the dense ME's by "
          f"{max_diff(s.global_model, d.global_model)}")
    sim_err = max_diff(s.similarities, d.similarities)
    check(torch.allclose(s.similarities, d.similarities, rtol=1e-5, atol=0),
          f"{tag}: similarities differ from the dense ME's by {sim_err}")
    check(int(s.vote) == int(d.vote),
          f"{tag}: vote {int(s.vote)}, the dense ME's {int(d.vote)}")
    times = {}
    for name, phase in (("dense", ModelEvaluation()),
                        ("sharded", ShardedModelEvaluation(ME_SHARDS))):
        ms = []
        for _ in range(25):
            ctx = context()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phase.run(ctx)
            ctx.evaluation.similarities.cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = statistics.median(ms[5:])
    out = {"n_shards": ME_SHARDS, "launches": counts,
           "similarities_max_abs_diff": sim_err, "vote": int(s.vote),
           "phase_ms": times}
    print(f"{tag}: gw bit-identical to dense ME, similarities within "
          f"{sim_err:.3e}, vote {int(s.vote)} in both, {counts['cosine_partials']}"
          f" + {counts['weighted_aggregate']} launches; phase synchronized "
          f"dense {times['dense']:.3f} ms, sharded {times['sharded']:.3f} ms",
          flush=True)
    print("sharded_me " + json.dumps(out), flush=True)
    return out


# -- slice 10: the Zamba2 hybrid and the MoE family ------------------------

def phase_flash_112(dev) -> tuple[list, list]:
    """Flash attention at Zamba2-7B's shared attention (32 query and 32 kv
    heads of 112): phase 10's checks and times at its (8, 512) forward
    and a (8, 64) prefill-size call, bf16 and fp32; then phase 14's
    checks and times of the backward pair at FLASH_112_BWD_CASES. Returns
    (forward rows, backward rows)."""
    import torch
    from repro_torch.kernels import ops
    rows = phase_flash(dev, FLASH_112_CASES, seed=112)
    # the same heads at hd 128: hd 112 runs on the hd-128 tile, so this is
    # what its narrower rows save in bytes
    gen = torch.Generator(device=dev).manual_seed(128)
    q, k, v = (torch.randn(8, 512, 32, 128, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    t128 = graph_time_us(lambda: ops.flash_attention(q, k, v))
    print(f"flash (8, 512, 32, 32, 128) bf16 causal, the hd 112 rows' heads "
          f"at hd 128: kernel {t128:.2f} us", flush=True)
    del q, k, v
    return rows, phase_flash_backward(dev, FLASH_112_BWD_CASES, seed=1120)


def moe_forward(model, params) -> dict:
    """One (8, 512) forward of a MoE model with every layer's routing
    counted: the (token, choice) assignments, those past their expert's
    capacity C (dropped), C itself; finite logits and one flash launch a
    layer."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    cfg = model.cfg
    stats = {"assignments": 0, "dropped": 0, "capacity": []}
    inner = transformer.moe_ffn

    def counted(x, p, mcfg):
        _, idx, _ = moe.router_topk(x, p["router"], mcfg)
        pos = moe.position_in_expert(idx, mcfg.n_experts)
        C = moe.capacity(x.shape[0], mcfg)
        stats["assignments"] += pos.numel()
        stats["dropped"] += int((pos >= C).sum())
        stats["capacity"].append(C)
        return inner(x, p, mcfg)

    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (N_REQUESTS, 512)).astype(np.int32)).to(
        model.device)
    ops.reset_launch_counts()
    transformer.moe_ffn = counted
    try:
        with torch.inference_mode():
            logits, aux = model.forward(params, {"tokens": toks})
            finite = bool(torch.isfinite(logits).all())
    finally:
        transformer.moe_ffn = inner
    launches = ops.launch_counts()["flash_attention"]
    tag = f"MoE forward {cfg.name} ({cfg.n_layers} layers)"
    check(finite, f"{tag}: non-finite logits")
    check(launches == cfg.n_layers,
          f"{tag}: flash launched {launches} times, want {cfg.n_layers}")
    caps = sorted(set(stats["capacity"]))
    share = stats["dropped"] / stats["assignments"]
    print(f"{tag} (8, 512): capacity {caps} slots an expert, "
          f"{stats['dropped']} of {stats['assignments']} assignments "
          f"dropped ({share:.4f}), aux {float(aux):.4f}, flash launches "
          f"{launches}", flush=True)
    return {"capacity": caps, "assignments": stats["assignments"],
            "dropped": stats["dropped"], "dropped_share": share,
            "aux": float(aux), "forward_launches": launches}


def phase_phi_forward(dev) -> dict:
    """Phi-3.5-MoE at full width and PHI_LAYERS of its 32 layers (the cut:
    ~83.7 GB of bfloat16 weights at 32 layers, ~42.1 GB at 16): one
    counted (8, 512) forward (16 flash launches at G = 4), then two timed
    ones; the weights freed after."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_api import Model
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                              n_layers=PHI_LAYERS)
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    out = moe_forward(model, params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (N_REQUESTS, 512)).astype(np.int32)).to(dev)
    fwd_ms = []
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
    out.update(arch=cfg.name, layers=cfg.n_layers,
               n_params=model.n_params(), init_s=init_s, forward_ms=fwd_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"forward {cfg.name} at {PHI_LAYERS} of 32 layers (8, 512): "
          f"{min(fwd_ms):.1f} ms, {out['n_params'] / 1e9:.2f} B parameters, "
          f"peak {out['peak_gb']:.2f} GB", flush=True)
    print("phi_forward " + json.dumps(out), flush=True)
    del params, model
    torch.cuda.empty_cache()
    return out


def phase_family_rounds(dev, runs=FAMILY_ROUNDS,
                        tag_line: str = "family_rounds") -> dict:
    """``run_bhfl(model=LMAdapter(get_config(arch).reduced()))`` at the
    API's LM defaults for each (arch, engine) of ``runs`` (phase 30: the
    hybrid on both engines and the MoE family on the loop; phase 35: the
    audio family on the loop): valid chain, finite losses, flash forward
    and backward launches against the attention layers and the SGD steps
    (vmapped steps on the batched engine), each ME kernel once a round.
    The rounds pass no context, as the reference's ``LMAdapter``: an
    audio model runs its self-attention only."""
    import torch
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.obs import TraceRecorder, use_recorder
    out = {}
    for arch, engine in runs:
        cfg = get_config(arch).reduced()
        rec = TraceRecorder(f"{arch}_{engine}")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with use_recorder(rec):
            run = api.run_bhfl(model=api.LMAdapter(cfg, device=dev),
                               rounds=LM_ROUNDS, seed=0, device=dev,
                               engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        rt = run.runtime
        layers = attention_layers(cfg, context=False)
        if engine == "batched":
            steps = LM_ROUNDS * rt._engine.fel_iterations \
                * rt._engine.steps_per_iteration
        else:
            steps = LM_ROUNDS * sgd_steps(rt, rt.adapter.batch_size)
        tag = f"LM round {arch} reduced ({engine})"
        check(rt.engine == engine, f"{tag}: engine is {rt.engine}")
        check(run.chain_valid and run.chain_height == LM_ROUNDS,
              f"{tag}: chain valid {run.chain_valid}, height "
              f"{run.chain_height}")
        check(all(math.isfinite(m.test_loss) for m in run.history),
              f"{tag}: non-finite test loss")
        check(counts["flash_attention_backward"] == layers * steps,
              f"{tag}: flash backward launched "
              f"{counts['flash_attention_backward']} times, want {layers} "
              f"attention layers x {steps} SGD steps")
        check(counts["flash_attention"] == layers * (steps + LM_ROUNDS),
              f"{tag}: flash launched {counts['flash_attention']} times, "
              f"want {layers} x ({steps} SGD steps + {LM_ROUNDS} "
              f"evaluations)")
        check(all(counts[k] == LM_ROUNDS for k in ME_KERNELS),
              f"{tag}: ME kernels launched {counts}, want once a round")
        per_round = spans_by_round(rec)
        for k in sorted(per_round):
            m = run.history[k]
            print(f"{tag} {k}: wall {per_round[k]['round']:.1f} ms, fel "
                  f"{per_round[k]['fel']:.1f} ms, leader {m.leader_id}, "
                  f"loss {m.test_loss:.4f}", flush=True)
        out[f"{arch}/{engine}"] = {
            "wall_s": wall, "launches": counts, "sgd_steps": steps,
            "attention_layers": layers,
            "n_params": rt.adapter.model.n_params(),
            "leaders": [m.leader_id for m in run.history],
            "test_loss": [m.test_loss for m in run.history],
            "round_ms": {str(k): v for k, v in per_round.items()}}
        print(f"{tag}: {LM_ROUNDS} rounds in {wall:.2f} s, {steps} SGD "
              f"steps, flash {counts['flash_attention']} and backward "
              f"{counts['flash_attention_backward']} launches", flush=True)
    print(f"{tag_line} " + json.dumps(out), flush=True)
    return out


# -- slice 11: the cross-attention families ------------------------------

def phase_flash_cross(dev) -> tuple[list, list]:
    """Flash attention with keys of their own length (FLASH_CROSS_CASES,
    non-causal, window 0): phase 10's checks and times; then phase 14's
    checks and times of the backward pair at FLASH_CROSS_BWD_CASES.
    Returns (forward rows, backward rows)."""
    rows = phase_flash(dev, [(B, Sq, Hq, Hk, hd, dt, False, 0, Skv)
                             for B, Sq, Skv, Hq, Hk, hd, dt
                             in FLASH_CROSS_CASES], seed=1024)
    return rows, phase_flash_backward(
        dev, [(B, Sq, Hq, Hk, hd, dt, False, 0, Skv)
              for B, Sq, Skv, Hq, Hk, hd, dt in FLASH_CROSS_BWD_CASES],
        seed=1025)


def flash_key(row) -> tuple:
    """A flash row's call as ``ops.flash_launch_shapes`` keys it."""
    B, S, Hq, hd = row["shape"]
    return (B, S, row["kv_len"], Hq, row["kv_heads"], hd, row["dtype"],
            row["causal"], row["window"])


def launches_by_call(on_path: list, off_path: list, served: list) -> None:
    """Give each flash row the launches of its own call in the ``served``
    runs (phase_serving's prefill and forward): each row of ``on_path``
    must have been launched there, and every call launched there must
    have its row; ``off_path`` rows (checks only) get 0."""
    left: dict = {}
    for out in served:
        for counts in out["shapes"]:
            for key, n in counts.items():
                left[key] = left.get(key, 0) + n
    for row in on_path:
        row["launches"] = left.pop(flash_key(row), 0)
        row["on_path"] = True
        check(row["launches"] > 0, f"flash {flash_key(row)} was not "
              f"launched on the served models' path")
    for row in off_path:
        row["launches"] = 0
        row["on_path"] = False
    check(not left, f"flash calls on the served models' path with no row: "
          f"{left}")


def vlm_cut():
    """Llama-3.2-Vision-90B at full width and VLM_LAYERS of its 100
    layers: 6 groups of 4 self-attention layers and a cross block."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama-3.2-vision-90b"),
                               n_layers=VLM_LAYERS)


# -- slice 9: the simulator's scenarios and the sharded consortium --------

def round_breakdowns(rec) -> list:
    """One dict per ``round`` span of a recorder, in order: its round,
    committee (None unsharded), wall ms, and the summed wall ms of its
    descendant spans by name (found through the spans' parent ids)."""
    by_id = {sp.span_id: sp for sp in rec.spans}
    totals: dict = {}
    for sp in rec.spans:
        anc = sp
        while anc.parent is not None and anc.name != "round":
            anc = by_id[anc.parent]
        if anc.name != "round" or anc is sp:
            continue
        d = totals.setdefault(anc.span_id, {})
        d[sp.name] = d.get(sp.name, 0.0) + sp.wall_dur * 1e3
    out = []
    for sp in sorted((s for s in rec.spans if s.name == "round"),
                     key=lambda s: s.span_id):
        out.append({"round": sp.round,
                    "committee": sp.attrs.get("committee"),
                    "ms": sp.wall_dur * 1e3,
                    "aborted": sp.error is not None,
                    "parts": totals.get(sp.span_id, {})})
    return out


# the parts of a round whose share of it phases 23-24 print: FEL, HCDS
# commit/reveal, ME, every envelope batch verification (inside the
# phases), the whole consensus
ROUND_PARTS = ("fel", "phase:commit_reveal", "phase:model_evaluation",
               "crypto.verify_batch", "consensus")


def shares(rows) -> dict:
    """Median share of a round taken by each of ROUND_PARTS."""
    return {part: statistics.median(r["parts"].get(part, 0.0) / r["ms"]
                                    for r in rows)
            for part in ROUND_PARTS}


def completed_rounds(history) -> int:
    return sum(1 for m in history if m.consensus is not None)


# (scenario, FEL engine): BTSV under bribery on the loop, the batched
# engine's down-node path, WAL replay and ledger re-sync
SCENARIO_RUNS = (("byzantine_third", "reference"),
                 ("edge_churn", "batched"),
                 ("crash_restart", "reference"))


def phase_scenarios(dev) -> dict:
    """Phase 23: ``run_bhfl(scenario=...)`` on the card at the §7.1 width:
    live, no safety violation, each ME kernel once per completed round;
    byzantine_third's leaders honest or the honest similarity argmax (a
    bribed vote never elects), edge_churn converged on the batched engine,
    crash_restart's restarts recovered; one run's chrome trace written,
    read back and summarized."""
    import tempfile
    import torch
    from repro_torch import api, obs
    from repro_torch.kernels import ops
    out = {}
    for name, engine in SCENARIO_RUNS:
        rec = obs.TraceRecorder(name)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with obs.use_recorder(rec):
            run = api.run_bhfl(scenario=name, seed=0, engine=engine,
                               device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        rep = run.scenario_report
        tag = f"scenario {name} ({engine})"
        check(run.runtime.engine == engine,
              f"{tag}: engine is {run.runtime.engine}")
        check(rep.liveness, f"{tag}: liveness violated: {rep.summary()}")
        check(rep.safety_violations == 0,
              f"{tag}: {rep.safety_violations} safety violations")
        done = completed_rounds(run.history)
        check(done == rep.completed_rounds,
              f"{tag}: {done} rounds ran ME, the report completed "
              f"{rep.completed_rounds}")
        for kernel in ME_KERNELS:
            check(counts[kernel] == done,
                  f"{tag}: {kernel} launched {counts[kernel]} times in "
                  f"{done} completed rounds")
        if name == "byzantine_third":
            bribed = [r.round for r in rep.rounds if not r.aborted
                      and not (r.honest_leader or r.leader_is_argmax)]
            check(not bribed, f"{tag}: rounds {bribed} elected a bribery "
                              f"voter that is not the honest argmax")
        if name == "edge_churn":
            check(rep.converged, f"{tag}: honest chains did not converge")
        if name == "crash_restart":
            check(rep.recoveries >= 3 and rep.converged,
                  f"{tag}: {rep.recoveries} recoveries, converged "
                  f"{rep.converged}")
        rows = round_breakdowns(rec)
        print(f"{tag}: {rep.summary()}", flush=True)
        for r, m in zip(rows, run.history):
            print(f"{tag} round {r['round']}: wall {r['ms']:.1f} ms, fel "
                  f"{r['parts'].get('fel', 0.0):.1f}, commit/reveal "
                  f"{r['parts'].get('phase:commit_reveal', 0.0):.1f}, "
                  f"verify_batch "
                  f"{r['parts'].get('crypto.verify_batch', 0.0):.1f}, ME "
                  f"{r['parts'].get('phase:model_evaluation', 0.0):.2f} ms;"
                  f" leader {m.leader_id}", flush=True)
        out[name] = {"engine": engine, "wall_s": wall, "launches": counts,
                     "completed_rounds": done,
                     "round_ms": [r["ms"] for r in rows],
                     "round_ms_median": statistics.median(r["ms"]
                                                          for r in rows),
                     "shares": shares(rows),
                     "leaders": [m.leader_id for m in run.history],
                     "honest_leader_rate": rep.honest_leader_rate,
                     "argmax_leader_rate": rep.argmax_leader_rate,
                     "recoveries": rep.recoveries,
                     "reelections": rep.reelections}
        if name == SCENARIO_RUNS[0][0]:
            # the device's busy share of one more round on the same bus
            out[name]["profile"] = phase_profile(
                run.runtime, out[name]["round_ms_median"],
                f"scenario profile {name}")
            # the exporter and the profiler on a trace taken on the card
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                obs.write_chrome_trace(path, [(name, rec)])
                trace = obs.load_trace(path)
            n_spans = sum(e["ph"] == "X" for e in trace["traceEvents"])
            check(n_spans == len(rec.spans),
                  f"{tag}: the trace holds {n_spans} spans, the recorder "
                  f"{len(rec.spans)}")
            print(f"{tag}: chrome trace of {n_spans} spans written and "
                  f"read back; its profile:\n"
                  f"{obs.format_summary(trace, 'wall', 4)}", flush=True)
    print("scenarios " + json.dumps(out), flush=True)
    return out


# the consortium runs of phase 24: the scale run and the 64-node one
CONSORTIUM_RUNS = ("consortium_64", "consortium_256")


def phase_consortium(dev) -> dict:
    """Phase 24: ``run_bhfl(scenario="consortium_256")`` (N = 256 in 8
    committees of 32) beside consortium_64 on the card: every committee
    live, no safety violation, the top-chains converged at 8 x epochs,
    each ME kernel once per completed shard round."""
    import torch
    from repro_torch import api, obs
    from repro_torch.kernels import ops
    from repro_torch.sim import get_scenario
    out = {}
    for name in CONSORTIUM_RUNS:
        sc = get_scenario(name)
        rec = obs.TraceRecorder(name)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with obs.use_recorder(rec):
            run = api.run_bhfl(scenario=name, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        rep = run.scenario_report
        cons = run.runtime
        tag = f"consortium {name}"
        check(rep.committees == sc.committees
              and all(c.liveness for c in rep.committee_reports),
              f"{tag}: a committee lost liveness: {rep.summary()}")
        check(rep.safety_violations == 0,
              f"{tag}: {rep.safety_violations} safety violations")
        check(rep.top_chain_converged, f"{tag}: top-chains did not converge")
        check(rep.top_chain_height == sc.committees * cons.epochs,
              f"{tag}: top-chain height {rep.top_chain_height}, want "
              f"{sc.committees} x {cons.epochs} epochs")
        check(cons.verify_chains(), f"{tag}: a chain does not verify")
        done = completed_rounds(cons.history)
        for kernel in ME_KERNELS:
            check(counts[kernel] == done,
                  f"{tag}: {kernel} launched {counts[kernel]} times in "
                  f"{done} completed shard rounds")
        rows = round_breakdowns(rec)
        sync = [sp.wall_dur * 1e3 for sp in rec.spans
                if sp.name == "phase:checkpoint_sync"]
        per_round = {}
        for r in rows:
            per_round[r["round"]] = per_round.get(r["round"], 0.0) + r["ms"]
        committee_ms = statistics.median(r["ms"] for r in rows)
        print(f"{tag}: {rep.summary()}", flush=True)
        print(f"{tag}: {sc.rounds} rounds of {sc.committees} "
              f"committees of {sc.n_nodes // sc.committees} in {wall:.1f} "
              f"s; committee round median {committee_ms:.1f} ms (min "
              f"{min(r['ms'] for r in rows):.1f}, max "
              f"{max(r['ms'] for r in rows):.1f}); all committees' rounds "
              f"{[round(v, 1) for v in per_round.values()]} ms; checkpoint "
              f"sync {[round(v, 1) for v in sync]} ms; ME launches "
              f"{counts['cosine_partials']} in {done} shard rounds",
              flush=True)
        out[name] = {"wall_s": wall, "launches": counts,
                     "completed_shard_rounds": done,
                     "profile": phase_profile(
                         cons, statistics.median(per_round.values()),
                         f"consortium profile {name}"),
                     "committee_round_ms_median": committee_ms,
                     "round_ms_all_committees": list(per_round.values()),
                     "checkpoint_sync_ms": sync, "shares": shares(rows),
                     "top_chain_height": rep.top_chain_height,
                     "retransmits": rep.retransmits}
    print("consortium " + json.dumps(out), flush=True)
    return out


# -- slice 12: the PoFEL trainer and checkpoints ----------------------------

def trainer_round_launches(model, n_leaves: int) -> dict:
    """Kernel launches of one PoFEL round: under ``torch.func.vmap`` the
    clusters fold into one forward launch and one backward call a layer
    of each model kernel; Eq. 1 and Eq. 2 one launch each a leaf."""
    cfg = model.cfg
    attn = 0 if cfg.rwkv else attention_layers(cfg, model.needs_context())
    wkv = cfg.n_layers if cfg.rwkv else 0
    return {"cosine_partials": n_leaves, "weighted_aggregate": n_leaves,
            "wkv6": wkv, "flash_attention": attn, "wkv6_backward": wkv,
            "flash_attention_backward": attn}


def trainer_leaves(tree) -> int:
    from repro_torch.core.serialization import leaves_with_paths
    return len(leaves_with_paths(tree))


def phase_train_reduced(dev) -> dict:
    """``launch.train.train_reduced`` on the card at the reference
    launcher's defaults (TRAIN_C clusters, batch TRAIN_BATCH, seq
    TRAIN_SEQ, TRAIN_STEPS rounds, sgd1) for TRAIN_REDUCED: a chain
    verified at the height of the rounds, finite losses, and exactly the
    launches of :func:`trainer_round_launches` a round; then the CLI,
    ``python -m repro_torch.launch.train --arch musicgen-medium --steps
    2``, on the card by default."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.model_api import Model
    out = {}
    for arch in TRAIN_REDUCED:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        run = train.train_reduced(arch, TRAIN_STEPS, TRAIN_C, TRAIN_BATCH,
                                  TRAIN_SEQ, 0, "sgd1", device=dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        model = Model(get_config(arch).reduced(), device="cpu")
        per_round = trainer_round_launches(
            model, trainer_leaves(run.state.global_params))
        check(run.ledger.height == TRAIN_STEPS and run.ledger.verify_chain(),
              f"trainer {arch}: the chain does not verify at height "
              f"{TRAIN_STEPS}")
        check(all(bool(torch.isfinite(m.loss).all()) for m in run.metrics),
              f"trainer {arch}: a loss is not finite")
        want = {k: v * TRAIN_STEPS for k, v in per_round.items()}
        check(counts == want, f"trainer {arch}: launches {counts}, want "
              f"{want}")
        out[arch] = {"launches": counts, "per_round": per_round,
                     "wall_s": wall,
                     "losses": [float(m.loss.mean()) for m in run.metrics],
                     "leaders": [int(m.leader) for m in run.metrics],
                     "backward_shapes": {str(k): v for k, v in
                                         ops.flash_backward_launch_shapes()
                                         .items()}}
        print(f"trainer {arch} reduced: {TRAIN_STEPS} rounds in {wall:.2f} "
              f"s, chain verified at height {run.ledger.height}, launches "
              f"a round {per_round}", flush=True)
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "musicgen-medium", "--steps", "2"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(done.returncode == 0
          and "chain verified at height 2" in done.stdout
          and "device=cuda" in done.stdout,
          f"the launcher CLI failed: {done.stdout[-2000:]}"
          f"{done.stderr[-2000:]}")
    print(f"launcher CLI on the card ({time.perf_counter() - t0:.1f} s):\n"
          f"{done.stdout.strip()}", flush=True)
    return out


def diverged(replicas, seed: int = 1):
    """The replicas with seeded noise on every leaf: relative size
    TRAIN_DIVERGE[c] of the leaf's rms (at least 1e-2) for cluster c,
    added in float32 and cast back to the leaf's dtype (the CPU test's
    ``_diverged``, on torch's generator)."""
    import torch
    from repro_torch.fl import pofel_trainer as pt
    gen = torch.Generator().manual_seed(seed)
    rel = torch.tensor(TRAIN_DIVERGE)

    def leaf(x):
        x32 = x.to(torch.float32)
        rms = max(float(x32[0].pow(2).mean().sqrt()), 1e-2)
        scale = (rel * rms).view(-1, *([1] * (x.dim() - 1)))
        noise = torch.randn(x32.shape, generator=gen)
        return (x32 + scale * noise).to(x.dtype)
    return pt._map(leaf, replicas)


def phase_train_agreement(dev) -> None:
    """One reduced PoFEL round on the card and on the CPU from the same
    state (the vlm gates set nonzero, so its cross blocks take part;
    the replicas made to differ by :func:`diverged`, so the similarities
    spread) and batch, with the launcher's context: losses within
    TRAIN_LOSS_TOL, similarities within TRAIN_SIM_ATOL and the same
    leader. Fails if the CPU's similarities spread over less than
    10 × TRAIN_SIM_ATOL or its top two are within 2 × TRAIN_SIM_ATOL: the
    comparison would not tell a right Eq. 2 or leader from a wrong one."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import (TokenBatchSpec,
                                         synthetic_token_batches)
    from repro_torch.fl import pofel_trainer as pt
    from repro_torch.launch.train import round_batch
    from repro_torch.models.model_api import Model
    for arch in TRAIN_AGREE:
        cfg = get_config(arch).reduced()
        cpu, card = Model(cfg, device="cpu"), Model(cfg, device=dev)
        tcfg = pt.PoFELTrainConfig(n_clusters=TRAIN_C, inner_lr=1e-2)
        state = pt.init_train_state(cpu, tcfg,
                                    torch.Generator().manual_seed(0))
        cross = state.global_params.get("cross_layers", {})
        gen = torch.Generator().manual_seed(1)
        for g in ("gate_attn", "gate_mlp"):
            if g in cross:
                cross[g].copy_(torch.randn(cross[g].shape, generator=gen))
        state = state._replace(cluster_params=diverged(state.cluster_params))
        on_card = pt.PoFELTrainState(
            tree_to(state.cluster_params, dev),
            tree_to(state.global_params, dev),
            tree_to(state.outer_momentum, dev), state.btsv_history.to(dev),
            state.round.to(dev))
        raw = next(synthetic_token_batches(
            TokenBatchSpec(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size), seed=0))
        lam = torch.ones((TRAIN_C,))
        got = pt.pofel_round(card, on_card,
                             round_batch(raw, card, TRAIN_C, dev),
                             lam.to(dev), tcfg)[1]
        want = pt.pofel_round(cpu, state, round_batch(raw, cpu, TRAIN_C,
                                                      "cpu"), lam, tcfg)[1]
        gl, wl = got.loss.cpu(), want.loss
        gs, ws = got.similarities.cpu(), want.similarities
        top = torch.sort(ws, descending=True).values
        spread, margin = float(top[0] - top[-1]), float(top[0] - top[1])
        check(spread > 10 * TRAIN_SIM_ATOL and margin > 2 * TRAIN_SIM_ATOL,
              f"trainer agreement {arch}: the CPU's similarities {ws} "
              f"spread {spread:.2e} (top two {margin:.2e}), too little to "
              f"hold the card's to {TRAIN_SIM_ATOL}")
        check(float((gl - wl).abs().max()) <= TRAIN_LOSS_TOL,
              f"trainer agreement {arch}: losses {gl} vs {wl}")
        check(float((gs - ws).abs().max()) <= TRAIN_SIM_ATOL,
              f"trainer agreement {arch}: similarities {gs} vs {ws}")
        check(int(got.leader) == int(want.leader),
              f"trainer agreement {arch}: leader {int(got.leader)} vs "
              f"{int(want.leader)}")
        print(f"trainer agreement {arch}: losses within "
              f"{float((gl - wl).abs().max()):.2e}, similarities "
              f"{[round(float(x), 6) for x in ws]} (spread {spread:.2e}, "
              f"top two {margin:.2e}) within "
              f"{float((gs - ws).abs().max()):.2e}, leader "
              f"{int(got.leader)} on both", flush=True)


def trainer_full_cfg(arch: str, layers):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                           n_layers=layers)


def phase_train_full(dev, arch: str, layers, clusters: int) -> dict:
    """Three sgd1 PoFEL rounds of ``arch`` at full width (``layers`` of its
    layers, or all), ``clusters`` clusters sharing a batch of TRAIN_BATCH
    sequences of TRAIN_SEQ tokens, with the launcher's context: the first
    plain, the second with
    ``local_step`` and ``consensus`` timed apart (a synchronize around
    each), the third under ``torch.profiler`` (busy share against the
    second's wall time). Finite losses and exactly the launches of
    :func:`trainer_round_launches` a round; the peak memory."""
    import torch
    from repro_torch.data.tokens import (TokenBatchSpec,
                                         synthetic_token_batches)
    from repro_torch.fl import pofel_trainer as pt
    from repro_torch.kernels import ops
    from repro_torch.launch.train import round_batch
    from repro_torch.models.model_api import Model
    cfg = trainer_full_cfg(arch, layers)
    model = Model(cfg, device=dev)
    tcfg = pt.PoFELTrainConfig(n_clusters=clusters, inner_lr=1e-2)
    torch.cuda.reset_peak_memory_stats(dev)
    state = pt.init_train_state(model, tcfg,
                                torch.Generator(device=dev).manual_seed(0))
    n_leaves = trainer_leaves(state.global_params)
    per_round = trainer_round_launches(model, n_leaves)
    stream = synthetic_token_batches(
        TokenBatchSpec(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size), seed=0)
    lam = torch.ones((clusters,), device=dev)
    parts = {"local_step": 0.0, "consensus": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t0
            return res
        return run

    walls, losses, shapes = [], [], {}
    box = {"state": state}
    del state

    def one_round():
        b = round_batch(next(stream), model, clusters, dev)
        box["state"], m = pt.pofel_round(model, box["state"], b, lam, tcfg)
        torch.cuda.synchronize()
        box["metrics"] = m

    for k in range(3):
        ops.reset_launch_counts()
        if k == 1:
            inner = (pt.local_step, pt.consensus)
            pt.local_step = timed(inner[0], "local_step")
            pt.consensus = timed(inner[1], "consensus")
        t0 = time.perf_counter()
        try:
            if k == 2:
                n_ops, busy_us, top = device_busy(
                    one_round, f"trainer {arch}", host=False)
            else:
                one_round()
        finally:
            if k == 1:
                pt.local_step, pt.consensus = inner
        walls.append(time.perf_counter() - t0)
        m = box["metrics"]
        losses.append([float(x) for x in m.loss.cpu()])
        counts = ops.launch_counts()
        check(counts == per_round, f"trainer {arch} round {k}: launches "
              f"{counts}, want {per_round}")
        check(bool(torch.isfinite(m.loss).all())
              and bool(torch.isfinite(m.similarities).all()),
              f"trainer {arch} round {k}: losses {m.loss} similarities "
              f"{m.similarities}")
        for key, n in ops.flash_backward_launch_shapes().items():
            shapes[key] = shapes.get(key, 0) + n
    check(parts["local_step"] > 0 and parts["consensus"] > 0,
          f"trainer {arch}: round 2 timed local_step {parts['local_step']} "
          f"s and consensus {parts['consensus']} s; pofel_round did not "
          f"call them through the module")
    round_ms = walls[1] * 1e3
    out = {"arch": arch, "layers": cfg.n_layers, "params": model.n_params(),
           "clusters": clusters, "leaves": n_leaves, "per_round": per_round,
           "round_ms": [w * 1e3 for w in walls],
           "local_step_share": parts["local_step"] / walls[1],
           "consensus_share": parts["consensus"] / walls[1],
           "local_step_ms": parts["local_step"] * 1e3,
           "consensus_ms": parts["consensus"] * 1e3,
           "busy_us": busy_us, "busy_share": busy_us / (round_ms * 1e3),
           "device_ops": n_ops, "top_us": top,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "losses": losses, "backward_shapes": shapes}
    print(f"trainer {arch} full width, {cfg.n_layers} layers, "
          f"{out['params']:,} parameters, C = {clusters}: rounds "
          f"{[round(w, 1) for w in out['round_ms']]} ms; local_step "
          f"{out['local_step_ms']:.1f} ms ({out['local_step_share']:.3f}), "
          f"consensus {out['consensus_ms']:.1f} ms "
          f"({out['consensus_share']:.3f}); busy share "
          f"{out['busy_share']:.4f}; peak {out['peak_gb']:.1f} GB; launches "
          f"a round {per_round}", flush=True)
    print(f"trainer {arch} " + json.dumps(
        {k: v for k, v in out.items() if k != "backward_shapes"}),
          flush=True)
    return out


def phase_checkpoint(dev) -> dict:
    """``checkpoint.save_checkpoint`` / ``load_checkpoint`` of a MusicGen
    trainer state on the card (full width, CKPT_LAYERS of its 48 layers,
    after one round): the restored state equals the live one leaf for
    leaf, and the next round from each is bit-identical (similarities,
    losses, every global leaf)."""
    import torch
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.serialization import leaves_with_paths
    from repro_torch.data.tokens import (TokenBatchSpec,
                                         synthetic_token_batches)
    from repro_torch.fl import pofel_trainer as pt
    from repro_torch.launch.train import round_batch
    from repro_torch.models.model_api import Model
    cfg = trainer_full_cfg("musicgen-medium", CKPT_LAYERS)
    model = Model(cfg, device=dev)
    tcfg = pt.PoFELTrainConfig(n_clusters=TRAIN_C, inner_lr=1e-2)
    state = pt.init_train_state(model, tcfg,
                                torch.Generator(device=dev).manual_seed(0))
    stream = synthetic_token_batches(
        TokenBatchSpec(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size), seed=0)
    lam = torch.ones((TRAIN_C,), device=dev)
    state, _ = pt.pofel_round(model, state,
                              round_batch(next(stream), model, TRAIN_C, dev),
                              lam, tcfg)
    where = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(where, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        payload = save_checkpoint(where, int(state.round), state)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = load_checkpoint(where, int(state.round), state)
        t_load = time.perf_counter() - t0
        size = payload.stat().st_size
    finally:
        shutil.rmtree(where, ignore_errors=True)
    for (path, a), (_, b) in zip(leaves_with_paths(state),
                                 leaves_with_paths(restored)):
        check(a.dtype == b.dtype and a.device == b.device
              and torch.equal(a, b),
              f"checkpoint: {path} does not come back as it was saved")
    b = round_batch(next(stream), model, TRAIN_C, dev)
    s1, m1 = pt.pofel_round(model, state, b, lam, tcfg)
    s2, m2 = pt.pofel_round(model, restored, b, lam, tcfg)
    check(torch.equal(m1.similarities, m2.similarities)
          and torch.equal(m1.loss, m2.loss)
          and int(m1.leader) == int(m2.leader),
          f"checkpoint: the round after a restore differs: similarities "
          f"{m1.similarities} vs {m2.similarities}")
    for (path, a), (_, b2) in zip(leaves_with_paths(s1.global_params),
                                  leaves_with_paths(s2.global_params)):
        check(torch.equal(a, b2),
              f"checkpoint: global {path} differs after the next round")
    out = {"layers": cfg.n_layers, "params": model.n_params(),
           "bytes": size, "save_s": t_save, "load_s": t_load}
    print(f"checkpoint MusicGen-medium {cfg.n_layers} layers, "
          f"{out['params']:,} parameters, C = {TRAIN_C}: {size / 1e9:.2f} GB"
          f" saved in {t_save:.2f} s, loaded and verified in {t_load:.2f} s;"
          f" the next round is bit-identical", flush=True)
    return out


def trainer_backward_launches(rows: list, runs: list) -> None:
    """Give each backward row the flash backward calls of its own shape
    in the trainer's rounds ``runs`` (0 for a row no trainer call has)."""
    for row in rows:
        row["launches"] = sum(r["backward_shapes"].get(flash_key(row), 0)
                              for r in runs)
        row["on_path"] = row["launches"] > 0


# -- slice 13: the analyzer, the serving launcher, AdamW --------------------

def phase_analysis() -> str:
    """``python -m repro_torch.analysis src/repro_torch`` on this machine,
    which has no JAX: exit 0 (no finding beyond the baseline); its summary
    line (files analyzed, noqa-suppressed, baselined)."""
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    lines = done.stdout.strip().splitlines()
    last = lines[-1] if lines else ""
    check(done.returncode == 0 and last.startswith("0 finding(s)"),
          f"the analyzer exited {done.returncode}: {done.stdout[-2000:]}"
          f"{done.stderr[-2000:]}")
    print(f"analyzer on src/repro_torch ({time.perf_counter() - t0:.1f} s, "
          f"exit 0): {last}", flush=True)
    return last


def launcher_launches(cfg) -> dict:
    """The kernel launches of one ``serve_reduced`` at SERVE_PROMPT and
    SERVE_GEN: RWKV-6 runs wkv6 once a layer in the prefill's forward,
    in each of the prompt's replayed steps and in each of the SERVE_GEN - 1
    decode steps; every other family launches flash only in its timed
    prefill, once an attention layer (the hybrid's prefill is a forward,
    once a group; its replay and decode attention are plain)."""
    if cfg.rwkv:
        return {"wkv6": cfg.n_layers * (1 + SERVE_PROMPT + SERVE_GEN - 1)}
    return {"flash_attention": attention_layers(cfg)}


def phase_launcher(dev) -> dict:
    """``launch.serve.serve_reduced`` on the card for one arch of each
    family the CLI offers, at its defaults (SERVE_BATCH requests of
    SERVE_PROMPT tokens, SERVE_GEN new ones, greedy, seed 0, the weights
    it makes at seed 0): exactly :func:`launcher_launches`, the same tokens
    on a second run; the same call on the CPU with the card's weights,
    held to phase 9's rule (:func:`hold_to_cpu`); then the CLI, ``python
    -m repro_torch.launch.serve`` with its defaults, on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model_api import Model
    from repro_torch.serving import GenerationRequest
    out = {}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch).reduced()
        card, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
        params = card.init(torch.Generator(device=dev).manual_seed(0))
        want = {k: 0 for k in ops.launch_counts()}
        want.update(launcher_launches(cfg))
        runs = []
        for attempt in range(2):
            ops.reset_launch_counts()
            runs.append(serve.serve_reduced(
                arch, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, 0, 0.0,
                device=dev, params=params))
            counts = ops.launch_counts()
            check(counts == want, f"launcher {arch}: launches {counts}, "
                  f"want {want}")
        tokens = runs[0].tokens
        check(tokens.shape == (SERVE_BATCH, SERVE_GEN)
              and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
              f"launcher {arch}: tokens {tokens.shape}")
        check(np.array_equal(tokens, runs[1].tokens),
              f"launcher {arch}: a second identical run gave other tokens")
        cpu_params = tree_to(params, "cpu")
        host = serve.serve_reduced(arch, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                                   0, 0.0, device="cpu", params=cpu_params)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
        reqs = [GenerationRequest(i, prompts[i], SERVE_GEN)
                for i in range(SERVE_BATCH)]
        hold_to_cpu(f"launcher {arch} card vs CPU", card, params, cpu,
                    cpu_params, reqs, host.tokens)
        out[arch] = {
            "launches": {k: v for k, v in want.items() if v},
            "prefill_ms": [r.prefill_s * 1e3 for r in runs],
            "ms_per_decoded_token": [r.decode_s * 1e3 / (SERVE_GEN - 1)
                                     for r in runs],
            "tokens_equal_cpu": int((tokens == host.tokens).sum())}
        print(f"launcher {arch}: prefill {SERVE_PROMPT} x {SERVE_BATCH} "
              f"{out[arch]['prefill_ms'][1]:.2f} ms, "
              f"{out[arch]['ms_per_decoded_token'][1]:.2f} ms per decoded "
              f"token (second run; first {out[arch]['prefill_ms'][0]:.2f} / "
              f"{out[arch]['ms_per_decoded_token'][0]:.2f}), launches "
              f"{out[arch]['launches']}, {out[arch]['tokens_equal_cpu']} of "
              f"{tokens.size} tokens as on the CPU", flush=True)
        del card, params
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(done.returncode == 0 and done.stdout.startswith(
        f"arch=starcoder2-3b reduced | prefill {SERVE_PROMPT} toks × "
        f"{SERVE_BATCH} reqs"),
          f"the serving CLI failed: {done.stdout[-2000:]}"
          f"{done.stderr[-2000:]}")
    print(f"serving CLI on the card ({time.perf_counter() - t0:.1f} s):\n"
          f"{done.stdout.strip()}", flush=True)
    print(f"launcher times on {nvidia_smi()}: " + json.dumps(out),
          flush=True)
    return out


def adamw_agrees(tag: str, card, host) -> None:
    """Card against CPU leaf by leaf: the same dtypes; float32 within
    ADAMW_RTOL / ADAMW_ATOL, bfloat16 within one bfloat16 rounding."""
    import torch
    from repro_torch.core.serialization import leaves_with_paths
    for (path, a), (_, b) in zip(leaves_with_paths(card),
                                 leaves_with_paths(host)):
        check(a.dtype == b.dtype, f"{tag} {path}: {a.dtype} on the card, "
              f"{b.dtype} on the CPU")
        rtol, atol = ((ADAMW_RTOL, ADAMW_ATOL) if a.dtype == torch.float32
                      else (2 ** -7, 1e-6))
        check(torch.allclose(a.cpu().float(), b.float(), rtol=rtol,
                             atol=atol),
              f"{tag} {path}: differs by "
              f"{float((a.cpu().float() - b.float()).abs().max())}")


def phase_adamw(dev) -> dict:
    """AdamW: the reduced MusicGen's params (native dtypes, and cast to
    float32) through ADAMW_STEPS updates with ``warmup_cosine_lr`` on the
    card and on the CPU from the same seeded gradients, clipped and not:
    leaf by leaf within :func:`adamw_agrees`, and the moments' dtypes by
    the reference's rule (a bfloat16 leaf's are float32 when clipped,
    bfloat16 when not). Then one clipped update over MusicGen-medium's
    full 2.27 B bfloat16 parameters from a fresh state with seeded
    gradients, twice (the first with the allocator cold): float32 moments,
    params in their dtypes, finite values; its time and peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fl import pofel_trainer as pt
    from repro_torch.models.model_api import Model
    from repro_torch.optim import adamw_init, adamw_update, warmup_cosine_lr
    lr = warmup_cosine_lr(1e-2, 1, ADAMW_STEPS)
    base = Model(get_config("musicgen-medium").reduced(),
                 device="cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    grads = [pt._map(lambda p: torch.randn(p.shape, generator=gen), base)
             for _ in range(ADAMW_STEPS)]
    for label, cast in (("native", None), ("float32", torch.float32)):
        for clip in (1.0, None):
            tag = f"adamw reduced {label} clip={clip}"
            sides = {}
            for where in ("cpu", dev):
                p = pt._map(lambda t: t.to(where, cast or t.dtype), base)
                st = adamw_init(p)
                for g in grads:
                    g = pt._map(lambda t, q: t.to(where, q.dtype), g, p)
                    p, st = adamw_update(g, st, p, lr=lr, grad_clip=clip)
                sides[str(where)] = (p, st)
            (hp, hs), (cp, cs) = sides["cpu"], sides[str(dev)]
            adamw_agrees(tag, {"params": cp, "mu": cs.mu, "nu": cs.nu},
                         {"params": hp, "mu": hs.mu, "nu": hs.nu})
            moment_dtypes = {str(t.dtype) for t in pt._leaves(cs.mu)}
            param_dtypes = {str(t.dtype) for t in pt._leaves(cp)}
            for t, b0 in zip(pt._leaves(cs.mu) + pt._leaves(cs.nu),
                             2 * pt._leaves(base)):
                b0 = b0.to(cast or b0.dtype)
                want = (torch.promote_types(b0.dtype, torch.float32)
                        if clip is not None else b0.dtype)
                check(t.dtype == want, f"{tag}: a moment is {t.dtype}, want "
                      f"{want} for a {b0.dtype} leaf")
            print(f"{tag}: {ADAMW_STEPS} steps card vs CPU agree; params "
                  f"{sorted(param_dtypes)}, moments {sorted(moment_dtypes)}",
                  flush=True)

    cfg = get_config("musicgen-medium")
    model = Model(cfg, device=dev)
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = pt._map(lambda p: torch.randn(p.shape, generator=gen, device=dev,
                                          dtype=p.dtype), params)
    n = sum(t.numel() for t in pt._leaves(params))
    lr = warmup_cosine_lr(3e-4, 100, 10_000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for attempt in range(2):
        state = adamw_init(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, state = adamw_update(grads, state, params, lr=lr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for t, p in zip(pt._leaves(new), pt._leaves(params)):
            check(t.dtype == p.dtype and bool(torch.isfinite(t).all()),
                  f"adamw full width: a param leaf is {t.dtype} or not "
                  f"finite")
        for t in pt._leaves(state.mu) + pt._leaves(state.nu):
            check(t.dtype == torch.float32 and bool(torch.isfinite(t).all()),
                  f"adamw full width: a moment is {t.dtype} or not finite")
        del new, state
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    dtypes = sorted({str(t.dtype) for t in pt._leaves(params)})
    out = {"params": n, "param_dtypes": dtypes, "ms": times, "peak_gb": peak}
    print(f"adamw full width MusicGen-medium, {n:,} parameters {dtypes}: "
          f"one clipped update {times[1]:.1f} ms (first {times[0]:.1f} ms), "
          f"moments float32, peak {peak:.1f} GB on {nvidia_smi()}",
          flush=True)
    del params, grads
    torch.cuda.empty_cache()
    return out


def stamp(t0: float, what: str) -> None:
    print(f"[{time.perf_counter() - t0:.1f} s] {what}", flush=True)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # 1. card
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{_build.build_dir()} ({built or 'cached'})", flush=True)
    for name in _build.SOURCES:
        print(f"--- nvcc {name}.cu ---\n{_build.build_log(name).strip()}",
              flush=True)
    print(f"tensor cores: {check_tensor_cores()}", flush=True)
    warm_profiler(dev)
    stamp(t_start, "phases 1-2")
    # 3. ME kernels
    rows = phase_kernels(dev)
    # 4. main path
    counts, runtime, round_ms, main_ref = phase_main_path(dev)
    # 5. where the device time goes
    phase_profile(runtime, round_ms)
    # 6. the card against the CPU
    phase_agreement(dev)
    for row in rows:
        row["launches"] = counts[row["name"]]
    # 7. wkv6 kernel
    wkv_rows = phase_wkv6(dev)
    # 8. RWKV-6 1.6B serving at full width, then (16) FedSGD on its weights
    served = phase_serving(dev, "rwkv6-1.6b", "wkv6",
                           then=fedsgd("rwkv6-1.6b", "wkv6",
                                       FEDSGD["rwkv6-1.6b"]))
    fed = {"wkv6": served.pop("then")}
    served.pop("shapes")
    for row in wkv_rows:
        row.update(served)
    # 9. the served model on the card against the CPU
    phase_serving_agreement(dev, "rwkv6-1.6b")
    # 10. flash kernel
    flash_rows = phase_flash(dev)
    # 11. Yi-6B serving at full width, then (16) FedSGD on its weights
    served = phase_serving(dev, "yi-6b", "flash_attention",
                           then=fedsgd("yi-6b", "flash_attention",
                                       FEDSGD["yi-6b"]))
    fed["flash_attention"] = served.pop("then")
    served.pop("shapes")
    for row in flash_rows:
        row.update(served)
    # 12. the dense models on the card against the CPU
    for arch in ("yi-6b", "starcoder2-3b"):
        phase_serving_agreement(dev, arch)
    # 13-14. the backward kernels
    wkv_bwd_rows = phase_wkv6_backward(dev)
    flash_bwd_rows = phase_flash_backward(dev)
    # 15. the LM rounds: the backward kernels' launches are this path's
    lm = phase_lm_rounds(dev)
    for bwd_rows, model, kernel in (
            (wkv_bwd_rows, "rwkv6", "wkv6_backward"),
            (flash_bwd_rows, "transformer", "flash_attention_backward")):
        for row in bwd_rows:
            row["launches"] = lm[model]["launches"][kernel]
    # 16 ran after 8 and 11: its launches beside the kernels' rows
    for kernel, bwd_rows in (("wkv6", wkv_bwd_rows),
                             ("flash_attention", flash_bwd_rows)):
        for row in bwd_rows:
            row["fedsgd_launches"] = \
                fed[kernel]["launches"][kernel + "_backward"]
    # 17. gradients on the card against the CPU
    phase_grad_agreement(dev)
    # 18. the batched FEL engine on phase 4's setting, then (19) one
    # profiled round and the device ops of one FEL phase beside the loop's
    batched = phase_batched_main(dev, main_ref)
    phase_profile(batched["runtime"], batched["round_ms"], "batched profile")
    phase_fel_kernels(batched["runtime"], runtime)
    # 20. the batched LM rounds: one launch a layer per vmapped step
    blm = phase_batched_lm(dev, lm)
    # 21. the vmap rules: folded launches against V separate ones
    fold_rows = phase_vmap_wkv6(dev) + phase_vmap_flash(dev)
    # 22. sharded ME on a batched round's W
    sharded = phase_sharded_me(batched["runtime"])
    # 23. scenarios on the card, then (24) the consortium at N = 256
    scen = phase_scenarios(dev)
    consortium = phase_consortium(dev)
    for row in rows:
        row["batched_launches"] = batched["counts"][row["name"]]
        row["sharded_me_launches"] = sharded["launches"][row["name"]]
        row["scenario_launches"] = sum(v["launches"][row["name"]]
                                       for v in scen.values())
        row["consortium_launches"] = consortium["consortium_256"][
            "launches"][row["name"]]
    lm_counts = {**blm["rwkv6"]["launches"],
                 **{k: v for k, v in blm["transformer"]["launches"].items()
                    if k.startswith("flash")}}
    for row in wkv_rows + flash_rows + wkv_bwd_rows + flash_bwd_rows:
        row["batched_lm_launches"] = lm_counts[row["name"]]
    for row in fold_rows:
        row["launches"] = lm_counts[row.pop("launches_key")]
    stamp(t_start, "phases 3-24")
    # 25. flash at hd 112; 26. Zamba2-7B serving; 27. DeepSeek-MoE-16B
    # serving and its routing; 28. Phi-3.5-MoE at 16 layers; each model
    # freed before the next is built
    torch.cuda.empty_cache()
    f112_rows, f112_bwd_rows = phase_flash_112(dev)
    moe_rows = phase_flash(dev, FLASH_MOE_CASES, seed=129)
    zamba = phase_serving(dev, "zamba2-7b", "flash_attention")
    torch.cuda.empty_cache()
    for row in f112_rows:      # the main path: the Zamba2-7B forward
        row["launches"] = zamba["forward_launches"]
        row["serving_launches"] = zamba["launches"]
    deepseek = phase_serving(dev, "deepseek-moe-16b", "flash_attention",
                             then=moe_forward)
    torch.cuda.empty_cache()
    phi = phase_phi_forward(dev)
    # 29. the reduced hybrid and MoE models on the card against the CPU
    for arch in ("zamba2-7b", "deepseek-moe-16b"):
        phase_serving_agreement(dev, arch)
    # 30. the hybrid and MoE LM rounds
    fam = phase_family_rounds(dev)
    for row, n in zip(moe_rows, (deepseek["launches"],
                                 deepseek["forward_launches"],
                                 phi["forward_launches"])):
        row["launches"] = n
    stamp(t_start, "phases 25-30")
    # 31. flash with keys of their own length; 32. MusicGen-medium
    # serving; 33. Llama-3.2-Vision-90B at 30 layers; each model freed
    # before the next is built
    torch.cuda.empty_cache()
    cross_rows, cross_bwd_rows = phase_flash_cross(dev)
    xself_rows = phase_flash(dev, FLASH_XSELF_CASES, seed=57)
    musicgen = phase_serving(dev, "musicgen-medium", "flash_attention")
    torch.cuda.empty_cache()
    vlm = phase_serving(dev, "llama-3.2-vision-90b", "flash_attention",
                        cfg=vlm_cut())
    torch.cuda.empty_cache()
    # 34. the reduced cross-attention models on the card against the CPU
    for arch in ("llama-3.2-vision-90b", "musicgen-medium"):
        phase_serving_agreement(dev, arch)
    # 35. the audio family's LM round: self-attention only, as the
    # reference's rounds pass no context
    fam.update(phase_family_rounds(dev, CROSS_ROUNDS, "cross_rounds"))
    launches_by_call(cross_rows[:CROSS_ON_PATH] + xself_rows,
                     cross_rows[CROSS_ON_PATH:], [musicgen, vlm])
    for row in cross_rows + xself_rows:
        print(f"flash {flash_key(row)}: {row['launches']} launches on the "
              f"served path", flush=True)
    for row in flash_bwd_rows:
        row["family_lm_launches"] = {
            k: v["launches"]["flash_attention_backward"]
            for k, v in fam.items()}
    for row in rows:
        row["family_lm_launches"] = {k: v["launches"][row["name"]]
                                     for k, v in fam.items()}
    # 36. the PoFEL trainer, reduced, and its launcher CLI; 37. one round
    # on the card against the CPU; 38. full width: MusicGen-medium and
    # Zamba2-7B at 12 layers, each freed before the next; 39. checkpoints
    stamp(t_start, "phases 31-35")
    torch.cuda.empty_cache()
    treduced = phase_train_reduced(dev)
    phase_train_agreement(dev)
    stamp(t_start, "phases 36-37")
    tfull = {}
    for arch, layers, clusters in TRAIN_FULL:
        tfull[arch] = phase_train_full(dev, arch, layers, clusters)
        torch.cuda.empty_cache()
        stamp(t_start, f"phase 38 {arch}")
    phase_checkpoint(dev)
    stamp(t_start, "phase 39")
    # 40. the analyzer; 41. the serving launcher, card against CPU, and its
    # CLI; 42. AdamW, reduced card against CPU, then at MusicGen's width
    torch.cuda.empty_cache()
    phase_analysis()
    launcher = phase_launcher(dev)
    phase_adamw(dev)
    stamp(t_start, "phases 40-42")
    for row in wkv_rows + flash_rows:
        row["launcher_launches"] = {a: v["launches"].get(row["name"], 0)
                                    for a, v in launcher.items()}
    # the new backward rows: the trainer rounds' calls of their shapes
    trainer_backward_launches(f112_bwd_rows + cross_bwd_rows,
                              list(tfull.values()))
    for row in f112_bwd_rows + cross_bwd_rows:
        print(f"flash backward {flash_key(row)}: {row['launches']} calls in "
              f"the full-width trainer rounds", flush=True)
    for row in rows + flash_bwd_rows + wkv_bwd_rows:
        row["trainer_launches_a_round"] = {
            a: v["per_round"][row["name"]]
            for a, v in {**treduced, **tfull}.items()}
    print(json.dumps({"kernels": rows + wkv_rows + flash_rows + wkv_bwd_rows
                      + flash_bwd_rows + fold_rows + f112_rows
                      + f112_bwd_rows + moe_rows + cross_rows + xself_rows
                      + cross_bwd_rows}),
          flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
