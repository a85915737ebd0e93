#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the kernels
from the checkout's sources itself.  Phases, each of which fails the run:

1. build   — compile ``src/repro_torch/kernels/csrc/{flash_attention,
             flash_attention_bwd,ssd,mlstm,ssd_bwd,mlstm_bwd}.cu`` for
             sm_90a, one ``nvcc`` per source, all six started together;
2. kernels — every kernel against its plain PyTorch version on the card
             (the cases of ``tests/test_kernels.py``, in fp32 (the scalar
             kernels) and bf16 (the tensor-core kernels), attention at
             gemma2's head dim 256 (softcap 50, window 4096, GQA 16/8, a
             ragged Sq, decode at Sk 4096 and 5184, each timed beside its
             bound; a bf16 decode call at D 256 the wrappers split runs
             the split decode and its merge; below D 256 every bf16 decode
             call runs one TMA kernel, held at its edges (``DECODE_EDGES``:
             Sq 1-15 at every head dim, causal Sq < Sk, window, softcap,
             Sk 0, below and not a multiple of a tile, a longer cache, rows
             with no key, 1-8 ranges a cluster; two calls bitwise equal);
             the bf16 prefill, the warpgroup kernel,
             at the edges of its tiles at every head dim through both
             entries (Sq 16 to 5183, causal Sq != Sk, Sk not a multiple of
             the tile, GQA 1 to 24, windows at tile edges and 4096, q and k
             scaled by 4 under the softcap, strided views, rows that admit
             no key), and two calls bitwise equal at gemma2's serve shape
             and at stablelm's and phi3.5's prefill shapes),
             and the serve paths' shapes), then
             timed at the serve paths' shapes beside
             the plain version, one library call where there is one, and
             the card's bound; attention decode is timed with a cold L2;
             the attention backward's dq, dk, dv against autograd of the
             plain attention in fp32 (every head dim, both dtypes, causal,
             window, softcap, GQA, ragged and Sq != Sk, gemma2's head dim
             256 too, two bf16 calls bitwise equal at every head dim; then,
             at D 80 and 128, the edges of its tiles and items, GQA 8 and
             q, k scaled by 4), then
             timed at stablelm_3b's train shape beside SDPA's backward, two
             bf16 calls there bitwise equal, and at gemma2_9b's (1,16,8192,
             256) KV 8 softcap 50, its global (causal) and local (window
             4096) layers (the wgmma kernels), each first held against
             autograd of the plain attention, beside SDPA's backward
             without softcap (not the same function) and the earlier
             design's time; the five families' head
             layouts (GQA 5, 7 and 12 at D 128, 24 / 24 at D 64: ragged Sq,
             Sq != Sk, decode with a group over two 16-row blocks and Sk
             not a multiple of 64) through the forward, its lse entry, the
             split decode and the backward; by torch.profiler, a gemma2 decode call and a
             half-cache lse call run the split decode then its merge, a
             D 128 GQA decode call (split), a D 80 MHA one and its lse
             entry one launch of the TMA decode kernel each, a
             D 256 prefill call through either entry the warpgroup prefill
             (so do D 64, 80 and 128 calls), and a D 256, a D 80 and a D
             128 backward call its two wgmma kernels; the SSD and mLSTM
             backwards'
             gradients against autograd of their plain versions in fp32
             (ragged S, S shorter than a chunk, strided model-layout
             inputs, the forward tests' widths, SSD with the final state's
             cotangent and at a log-decay span past fp32's exp range,
             mLSTM with gates of +-20 and with the e^{-m} floor winning),
             each fp32 kernel at three shapes (labels ending in "C2") also
             entry by entry against the fp64 gradient, then timed at
             zamba2_1p2b's and xlstm_125m's train shapes (each backward's
             bf16 path on the tensor cores, its fp32 path scalar; the
             mLSTM's split by kernel), two bf16 calls there bitwise equal;
             the attention forward's second entry, ``flash_attention_lse``,
             its output and fp32 log-sum-exp against ``attention_lse_ref``
             in both dtypes (rows with no key among them), the split
             decode's entry called directly against ``attention_split_ref``
             (more ranges than keys, rows with no key, causal ranges past
             the keys), timed at a rank's half of stablelm_3b's and
             gemma2_9b's decode caches (the latter split) beside
             efficient attention with its log-sum-exp;
3. serve stablelm_3b — at full size, seed-initialised on the card:
             batch 8, prompt 512, 64 greedy tokens in bf16 through
             ``repro_torch.launch.serve``; the attention kernel must have
             run on every layer of the prefill and of every decode step,
             every logit must be finite, and in fp32 the prefill's last
             logits must match the same prefill with the plain attention
             (the bf16 gap is printed beside it);
3b. serve elastic — the elastic serving plane (``repro_torch.serving``)
             through ``repro_torch.launch.serve.main(["--scenario", "all",
             "--executor", "both"])``, the live runtime's slots on the card:
             it must return 0 with sim == live on every serve scenario and
             launch no kernel (the service prices decode steps; it runs no
             model); per scenario the resizes, requests, KV bytes moved,
             modelled p50 / p99 and the host wall of each replay;
4. serve zamba2_1p2b — the hybrid Mamba2 model at full size, the same
             batch, prompt and tokens: the SSD kernel must have run once
             per Mamba2 layer (the prefill; decode steps are plain
             PyTorch) and the attention kernel once per shared-block
             application in the prefill and every decode step; in fp32
             the prefill's last logits, and 4 decode steps after it (which
             read the prefill's final SSM states), must match the same
             with both kernels swapped for their plain versions;
5. serve xlstm_125m — the xLSTM model (6 mLSTM + 6 sLSTM blocks) at full
             size, the same batch, prompt and tokens: the mLSTM kernel must
             have run once per mLSTM layer (the prefill; decode steps are
             plain PyTorch) and no other kernel at all; in fp32 the
             prefill's last logits and 4 decode steps after it (which read
             the prefill's final mLSTM and sLSTM states) must match the
             same with the kernels swapped for their plain versions; the
             bf16 gap to the plain versions is printed after the first
             mLSTM block and at the last logits;
6. train stablelm_3b — full size, seed-initialised on the card, through
             ``repro_torch.launch.train``: fp32 master params, bf16
             compute, remat, batch 8 x seq 512, 4 AdamW steps of
             ``SyntheticTokens``; every loss and grad finite, 64 forward
             and 32 backward attention calls a step, no SSD or mLSTM
             launch; a profiled step must run the bf16 backward kernels
             and no scalar one; then, at full width and 4 layers in fp32,
             one step through the kernels against the same step with the
             plain attention: the loss, every grad leaf and the updated
             params (the bf16 gap is printed);
7. elastic stablelm_3b — the live elastic loop
             (``repro_torch.elastic.ElasticTrainer``) at full size on the
             ``steady-cycle`` trace, 25 steps over a pool of 4 slots, the
             engine carrying a ``PytreeBytesModel`` of the full model:
             expand 1->4 (hypercube), TS-shrink 4->1, twice; node counts
             per step, finite losses, 4 records equal to the port's
             simulator with the same engine, each stage 3's logged bytes
             equal to the charged ones and its total to the pytree's, 64
             forward and 32 backward attention calls a step, and a peak
             memory no higher than the train phase's.  The slots are
             logical and all lie on this one card: stage 3 records the
             params' new placement and moves no byte, and each record's
             ``est``/``downtime`` is the cost model's modelled cluster
             time, not a card time.  Then ``restart-vs-shrink``'s first 6
             steps at full width and 4 layers with a checkpoint
             directory: right after the RESTART (step 5) the params equal
             the step-4 snapshot on disk and the params held when it was
             saved, bitwise;
8. train zamba2_1p2b and train xlstm_125m — each full model through
             ``repro_torch.launch.train`` as in 6 (fp32 masters, bf16, remat,
             8 x 512, seed 0; zamba2 4 steps, xlstm, whose sLSTM loop takes
             ~8-10 s a step, 2): finite losses and grad norms, the
             kernels' calls a step (zamba2: 76 SSD, 38 SSD backward, 12
             attention, 6 attention backward; xlstm: 12 mLSTM, 6 mLSTM
             backward, no attention), a profiled step (the SSD or mLSTM
             backward's share, its bf16 kernels by name, which must be
             ssd_bwd_wgmma and ssd_bwd_gsum, or the five
             mlstm_bwd_*_bf16), the same steps with
             the plain versions (printed), and one fp32 step at full width
             and 6 layers (zamba2: its shared block follows layer 5) or 2
             units (xlstm) against the plain twin: the loss, every grad leaf
             and the params after AdamW; zamba2 also prints the largest
             per-chunk log-decay span at init;
9. serve gemma2_9b — full size (42 layers, head dim 256, softcaps), bf16,
             batch 2, prompt 5120, past its window of 4096: its 21 local
             layers' ring caches wrap in the prefill and in decode; the
             attention kernel on every layer of the prefill and of every
             decode step (2,688 launches), finite logits; the decode step
             printed beside the unsplit kernel's; the kernel timed at its four shapes
             (global and local prefill, the warpgroup kernel, beside the
             earlier design's time; decode over a full ring and the
             global cache, both split) beside the plain version, SDPA
             without softcap (not the same function) and the bound; the
             bf16 gap to the plain attention printed; in fp32 at full
             width and 4 layers (2 rings) the prefill's last logits and 4
             decode steps after it against the plain attention;
9b. train gemma2_9b — full width, depth cut to 4 layers (2 local, 2
             global; 2.628 B params), batch 1 x 8192 (Gemma 2's training
             context, past its 4096 window), through
             ``repro_torch.launch.train`` (fp32 masters, bf16, remat, 4
             steps): finite losses and grad norms, 8 forward and 4
             backward attention calls a step, the step time beside the
             mma.sync backward's, a profiled step (the bf16 D 256 backward
             kernels by name, the wgmma ones), the attention backward's share,
             the forward kernel timed at (1,16,8192,256) global and local
             beside its bound, the plain version and SDPA, and its share;
             then one fp32 step at full width and 2 layers (one local, one
             global) on 1 x 4608 against the plain twin;
10. phi35_moe_42b — full width, depth cut: served at 8 layers (bf16,
             batch 8, prompt 512, 64 tokens; 512 attention launches, finite
             logits; the share of routed pairs dropped at prefill and at
             decode; the attention kernel timed at its D 128 GQA shapes;
             the fp32 prefill and 4 decode steps at 2 layers against the
             plain attention), then trained at 2 layers through
             ``repro_torch.launch.train`` (fp32 masters, bf16, remat, 8 x
             512, 4 steps: finite losses and grad norms, 4 forward and 2
             backward attention calls a step; the share of routed pairs
             dropped before and after) and one fp32 step at 1 layer
             against the plain twin;
10b. the five other families (``FAMILIES``), each at
             its published widths and heads: qwen2_vl_7b (28 layers, M-RoPE)
             and musicgen_medium (48) whole, yi_34b whole (60 layers,
             68.8 GB of bf16 params drawn and cast layer by layer),
             llama4_scout_17b and command_r_plus_104b at 8 layers, served
             through ``repro_torch.launch.serve`` as in 3 (one attention
             launch a layer in the prefill and each decode step, finite
             logits, the peak under 76 GiB, the kernel at the model's
             prefill and decode shapes timed, llama4's dropped pairs, the
             bf16 gap printed, an fp32 prefill and 4 decode steps at 2-4
             layers against the plain attention); qwen2_vl at 8 layers,
             musicgen whole and yi at 4 trained 3 steps through
             ``repro_torch.launch.train`` (qwen2_vl and musicgen on
             embeddings, qwen2_vl with (3, B, S) positions; the backward
             kernel at the train shape held against autograd and timed;
             the fp32 step gate at 1-2 layers); llama4 and command_r print
             why one card cannot train them;
11. serve parallel — the same four ranks and mesh serve through
             ``build_prefill_step`` (the prompt in train mode) and
             ``build_serve_step``: stablelm_3b at full width and depth in
             decode mode (8 x 512 + 4 tokens) and zamba2_1p2b in long mode
             (1 x 4096 + 4; its caches split four ways), bf16, fed one
             process's greedy ids, which the mesh's must equal wherever
             the runs' bf16 gap cannot flip them; fp32 gates at 4 / 6
             layers against one process's logits at every step; each
             rank's kernel launches (``flash_attention_lse`` on every
             decode step's attention) and a decode step's collective bytes
             equal to the dry run's twin;
12. train parallel — four ranks share the card (gloo), a (data 2,
             model 2) mesh through ``repro_torch.launch.mesh.spawn``:
             stablelm_3b at 8 layers and at 16, phi35_moe_42b
             at 2 (expert parallel), zamba2_1p2b at 6 and xlstm_125m at
             2 (their blocks tensor parallel over the rank's heads)
             trained at full width, each block's weights gathered in its
             remat unit: equal, finite losses on every rank, each
             kernel's launches a rank, each collective's bytes a step
             equal to ``predicted_comm_bytes``; each rank's storage
             shards and what it holds beyond them at its peak in the
             steps' forward and backward, which may grow by less than
             PAR_HELD_GROWTH from stablelm's 8 layers to 16 (and in the
             whole step, printed); fp32 steps against the
             single-process step (stablelm, zamba2, xlstm) or the same
             ranks on the CPU (phi3.5); stablelm's bf16 step's gap to the
             single-process step beside the single-process bf16-vs-fp32
             gap (printed);
13. dryrun — ``repro_torch.launch.dryrun`` on fake ranks and abstract
             tensors (no card): the twin of 12's stablelm_3b cell on every
             rank, its collective bytes by (operation, axis) and kernel
             launches equal to the measured, its peak within 15% of
             ``torch.cuda.max_memory_allocated`` over the steps; then three
             production cells' records printed;
14. flex_attention — compiled ``torch.nn.attention.flex_attention``
             computing the attention kernel's function at gemma2_9b's D 256
             shapes (its softcap as a score_mod, the causal and window masks
             as a block mask): the serve prefill and decodes, the train
             forward and backward, each timed beside the kernel's time and
             held against the plain version (printed; where it does not
             compile, the error's first line).  Last, so that no phase
             after it shares the process with torch.compile's state, and
             only while the run has used less than FLEX_BY_S.

Prints each phase's wall time (``[smoke] <phase>: N s``), the card's name
and power limit, one JSON line of kernel numbers, and last ``{"ok": true,
"device": {...}}``.  Exits non-zero, printing no
result, on any failure, without a card, or without the port's sources.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# NVIDIA H100 SXM data sheet, for the least time the card could take.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
MLSTM_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MLSTM_EXTREME_TOL = dict(rtol=5e-4, atol=5e-4)   # tests/test_kernels.py, gates of +-20
MODEL_TOL = dict(rtol=2e-3, atol=5e-4)   # tests/test_models.py, fp32
# A backward sums over S terms where the forward's 2e-5 sums over keys.
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_REL_RMS = 1e-4     # a gradient leaf of the fp32 train gate, against the plain twin
KERNELS = ("flash_attention", "flash_attention_bwd", "ssd", "mlstm", "ssd_bwd", "mlstm_bwd")
# The launch counters: one a kernel source, and the forward's second entry
# (its log-sum-exp written too), counted on its own.
COUNTERS = KERNELS + ("flash_attention_lse",)
# The attention backward's paths, chosen by dtype alone: bf16 runs the
# warpgroup kernels at every head dim.  Kernels in launch order.
BWD_PATHS = {
    "bfloat16": {"route": "tensor cores (wgmma bf16; TMA, warp-specialised)",
                 "kernels": ["attn_bwd_dq_wgmma", "attn_bwd_dkdv_wgmma"]},
    "float32": {"route": "scalar fp32 FMA",
                "kernels": ["attn_bwd_prep", "attn_bwd_dkdv", "attn_bwd_dq"]},
}
# A bf16 decode call at D 256 the wrappers split
# (flash_attention.d256_decode_split): the split kernel, then the merge.
SPLIT_DECODE_KERNELS = ["attn_decode_bf16", "attn_decode_merge"]
# Every bf16 decode call below D 256, split or not
# (flash_attention.decode_split): one launch of the TMA decode kernel,
# whose ranges of keys merge on chip in a cluster.
DECODE_KERNEL = "attn_decode_tma"
# gemma2's times with the earlier D 256 designs, the unsplit decode kernel
# and the three-launch mma.sync backward (chip_smoke.py on an H100 80GB
# HBM3 at 700 W; PERF.md holds their sources): the serve decode step, the
# 4-layer train step, the kernels at their shapes.
EARLIER_GEMMA2 = {"decode step": "50.08-73.41 ms", "train step": "659.0 ms",
                  "decode_ring": "0.1741 ms", "decode_global": "0.1894 ms", "lse": "0.0955 ms",
                  "global": "26.8730 ms", "local": "20.5695 ms",
                  "prefill_global": "2.3799 ms", "prefill_local": "2.3041 ms"}
# The bf16 prefill (Sq >= 16) runs the warpgroup kernel at every head dim
# through both forward entries.
PREFILL_KERNEL = "attn_prefill_wgmma"
# The bf16 prefill's times below D 256 with the earlier mma.sync plan
# (attn_prefill_bf16; chip_smoke.py on an H100 80GB HBM3 at 700.00 W, PR
# 27's and PR 31's calls, PERF.md row 1), by q's shape, printed beside
# today's.
EARLIER_PREFILL = {(8, 32, 512, 80): "0.0903 ms", (8, 32, 512, 64): "0.0798 ms",
                   (8, 32, 512, 128): "0.1475 ms", (8, 28, 512, 128): "0.1341 ms",
                   (8, 56, 512, 128): "0.2601 ms", (8, 96, 512, 128): "0.4286 ms",
                   (8, 40, 512, 128): "0.1821 ms", (8, 24, 512, 64): "0.0749 ms"}
L2_BYTES = 50 * 2**20   # H100 L2; decode timings rotate over more K/V than this
# The bf16 prefill gaps to the plain twins that the scalar kernels gave
# (chip_smoke.py on an H100 80GB HBM3 at 700 W), printed beside today's.
EARLIER_BF16_GAP = {"stablelm_3b": "3.906e-02", "zamba2_1p2b": "8.6e-02"}

ARCH, BATCH, PROMPT, GEN = "stablelm_3b", 8, 512, 64
TRAIN_STEPS, TRAIN_SEQ, GATE_LAYERS = 4, 512, 4
ELASTIC_SCENARIO, ELASTIC_STEPS = "steady-cycle", 25
RESTART_STEP = 5        # restart-vs-shrink's RESTART, read back from step 4's snapshot
HYBRID = "zamba2_1p2b"
XLSTM = "xlstm_125m"
# gemma2 serves 2 x 5120 tokens: past its window of 4096, so its rings wrap;
# its fp32 gate at 4 layers holds 2 local (ring) and 2 global layers.
GEMMA2, GEMMA2_BATCH, GEMMA2_PROMPT, GEMMA2_GATE_LAYERS = "gemma2_9b", 2, 5120, 4
# gemma2 trains at full width and 4 layers (2 local, 2 global: 2.628 B
# params, 42 GB of fp32 masters, grads and AdamW state) on batch 1 x 8192,
# Gemma 2's training context (arXiv:2408.00118), past its 4096 window; its
# fp32 step gate at 2 layers (one local, one global) on 1 x 4608, the
# window + 512, so the local layer's mask bites there too.
GEMMA2_TRAIN_LAYERS, GEMMA2_TRAIN_SEQ = 4, 8192
GEMMA2_STEP_GATE_LAYERS, GEMMA2_STEP_GATE_SEQ = 2, 4096 + 512
# phi3.5-MoE (41.9 B params) fits one card cut in depth: 8 layers served
# (42.6 GB fp32 at init, 21.3 GB bf16), 2 trained (~46 GB of fp32 masters
# and AdamW state); the serve gate at 2 layers in fp32.
MOE, MOE_SERVE_LAYERS, MOE_GATE_LAYERS, MOE_TRAIN_LAYERS = "phi35_moe_42b", 8, 2, 2
# Depth of the recurrent families' fp32 train gate: zamba2's shared block
# follows layer 5, so 6 layers reach it; xlstm's 4 layers are 2 units.
RECURRENT_GATE_LAYERS = {HYBRID: 6, XLSTM: 4}
# Their train runs' steps: xlstm's sLSTM loop makes a step ~8-10 s of host
# time, so it takes 2 steps (each run, and the plain one, 4 until the D 256
# prefill's timings needed the room).
RECURRENT_TRAIN_STEPS = {HYBRID: TRAIN_STEPS, XLSTM: 2}
# [train parallel]: four ranks on the one card (gloo), a (data 2, model 2)
# mesh.  stablelm_3b at full width and 8 layers trains 8 x 512 for 4
# steps; its fp32 gate, at 2 layers on 2 x 1024, holds the mesh's step
# against the single-process step.  phi35_moe_42b at full width and 2
# layers trains 2 steps through the expert-parallel path; its fp32 gate,
# at 1 layer on 2 x 128, holds the ranks on the card against the same
# ranks on the CPU.
PAR_MESH, PAR_LAYERS, PAR_STEPS = (2, 2), 8, 4
PAR_GATE_LAYERS, PAR_GATE_BATCH, PAR_GATE_SEQ = 2, 2, 1024
PAR_MOE_LAYERS, PAR_MOE_STEPS = 2, 2
PAR_MOE_GATE_LAYERS, PAR_MOE_GATE_BATCH, PAR_MOE_GATE_SEQ = 1, 2, 128
# stablelm_3b at full width and 16 layers (cut from its full 32 to make
# room for [serve parallel]) trains 8 x 512 for 2 steps on the same mesh.  Each
# block's weights are gathered inside its checkpointed unit, so what a
# rank holds beyond its storage shards (params, grads, AdamW mu and nu) in
# the forward and backward must not grow with depth by more than the remat
# carries (8 more layers: ~0.04 GiB) and the allocator's slack; gathering
# the whole model first would hold 8 x 79 MB = 0.62 GiB more at 16 layers
# than at 8 (measured ~1.9 GiB more at 32).
PAR_FULL_LAYERS, PAR_FULL_STEPS = 16, 2
PAR_HELD_GROWTH = 0.4 * 2**30
# zamba2_1p2b at full width and 6 layers (the shared block follows layer
# 5) and xlstm_125m at 2 (one unit: an mLSTM block and the sLSTM) train on
# the same mesh, each block on the rank's heads: zamba2 8 x 512, xlstm 8 x
# 256 (its sLSTM loop is host-bound), 3 steps each; their fp32 gates
# against the single-process step at 6 layers on 2 x 512 and 2 layers on
# 2 x 128.
PAR_RECURRENT = {HYBRID: dict(layers=6, batch=8, seq=512, steps=3,
                              gate_layers=6, gate_batch=2, gate_seq=512),
                 XLSTM: dict(layers=2, batch=8, seq=256, steps=3,
                             gate_layers=2, gate_batch=2, gate_seq=128)}
PAR_GATE_LOSS, PAR_GATE_REL_RMS = 1e-5, 1e-6   # fp32: the mesh's numbers are the step's
# fp32, the gradients: the grad norm's relative gap and AdamW mu's worst
# leaf (mu after one step is the clipped gradient; sums split over the
# ranks round apart, so a gradient is held looser than the sign-like step)
PAR_GATE_GRAD = 1e-5
# The recurrent families' fp32 step is ill-conditioned where the dense one
# is not: a Mamba2 chunk sums dt A to |479| at init (an fp32 rounding of
# 1e-7 in dt moves its exponentials by ~5e-5), and AdamW's first update of
# a leaf drawn at zero (conv_b, the sLSTM bias), lr g / (|g| + eps), turns
# with g where |g| is near eps.  The single-process kernels-vs-plain gate
# reads 2.7e-5 / 4.7e-5 on their grads for the same reason.  Their mesh
# gate holds the loss and the grad norm as the dense one does, AdamW mu's
# worst leaf within GRAD_REL_RMS and every param within MODEL_TOL, as that
# gate holds them.
# The twin runs on another device (MKL against cuBLAS, the plain attention
# against the kernel): it is held as the other fp32 step gates hold the
# kernels against their plain twins, the loss within MODEL_TOL, and the
# grad norm's relative gap, AdamW mu's worst leaf and each param leaf
# after AdamW within GRAD_REL_RMS.


@contextlib.contextmanager
def phase_wall(name: str):
    """Prints the wall time of the phase run inside, as ``[smoke] name: N s``."""
    t0 = time.perf_counter()
    yield
    print(f"[smoke] {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not (SRC / "repro_torch").is_dir():
        return fail(f"the port's sources are not at {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import card_label

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_label(dev)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t_start = time.perf_counter()
    failures: list[str] = []
    with phase_wall("build"):
        build_phase(torch)
    with phase_wall("kernels attention"):
        entry = kernel_phase(torch, dev, failures)
    with phase_wall("kernels ssd"):
        ssd_entry = ssd_kernel_phase(torch, dev, failures)
    with phase_wall("kernels mlstm"):
        mlstm_entry = mlstm_kernel_phase(torch, dev, failures)
    with phase_wall("kernels attention backward"):
        bwd_entry = attention_bwd_phase(torch, dev, failures)
    with phase_wall("kernels ssd backward"):
        ssd_bwd_entry = ssd_bwd_phase(torch, dev, failures)
    with phase_wall("kernels mlstm backward"):
        mlstm_bwd_entry = mlstm_bwd_phase(torch, dev, failures)
    with phase_wall("kernels attention lse"):
        lse_entry = lse_kernel_phase(torch, dev, failures)
    if failures:
        return fail("; ".join(failures))
    counts: dict[str, dict[str, int]] = {}   # serve path -> kernel -> launches
    with phase_wall("serve"):
        serve_phase(torch, dev, entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    with phase_wall("serve elastic"):
        serve_elastic_phase(torch, dev, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    with phase_wall("serve hybrid"):
        hybrid_phase(torch, dev, entry, ssd_entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    with phase_wall("serve xlstm"):
        xlstm_phase(torch, dev, mlstm_entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    with phase_wall("train"):
        train_peak = train_phase(torch, dev, entry, bwd_entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    with phase_wall("elastic"):
        elastic_phase(torch, dev, train_peak, failures, counts)
    if failures:
        return fail("; ".join(failures))
    for arch in (HYBRID, XLSTM):
        torch.cuda.empty_cache()
        with phase_wall(f"train {arch}"):
            recurrent_train_phase(torch, dev, arch, failures, counts)
        if failures:
            return fail("; ".join(failures))
    torch.cuda.empty_cache()
    with phase_wall(GEMMA2):
        gemma2_phase(torch, dev, entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    with phase_wall(f"train {GEMMA2}"):
        gemma2_train_phase(torch, dev, entry, bwd_entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    with phase_wall(MOE):
        moe_phase(torch, dev, entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    for arch in FAMILIES:
        torch.cuda.empty_cache()
        with phase_wall(arch):
            family_phase(torch, dev, arch, entry, bwd_entry, failures, counts)
        if failures:
            return fail("; ".join(failures))
    torch.cuda.empty_cache()
    with phase_wall("serve parallel"):
        serve_parallel_phase(torch, dev, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    with phase_wall("train parallel"):
        par_ranks = train_parallel_phase(torch, dev, failures, counts)
    if failures:
        return fail("; ".join(failures))
    with phase_wall("dryrun"):
        dryrun_phase(torch, failures, par_ranks)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t_start
    if elapsed < FLEX_BY_S:
        with phase_wall("flex_attention"):
            flex_phase(torch, dev, entry, bwd_entry)
    else:
        print(f"[time] flex_attention not timed: {elapsed:.0f} s had passed, past FLEX_BY_S "
              f"({FLEX_BY_S} s); its compiles (~90 s) would put the run near its 1,200 s limit")
    kernels = [entry, bwd_entry, ssd_entry, mlstm_entry, ssd_bwd_entry, mlstm_bwd_entry,
               lse_entry]
    for e in kernels:
        e["launches_by_path"] = {path: c[e["name"]] for path, c in counts.items()}
        e["launches"] = sum(e["launches_by_path"].values())

    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# ----------------------------------------------------------------- kernels --


def randn(torch, shape, dtype, seed, dev, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(getattr(torch, dtype))


def model_layout(torch, B, H, S, D, dtype, seed, dev, s_alloc=None):
    """(B,H,S,D) view of a (B,S_alloc,H,D) tensor, as the model passes its
    activations and cache slices to the kernel."""
    t = randn(torch, (B, s_alloc or S, H, D), dtype, seed, dev)
    return t[:, :S].transpose(1, 2)


def time_ms(torch, fn, iters=20, reps=5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def admitted_pairs(torch, Sq, Sk, *, causal, window, dev) -> int:
    """(query, key) pairs of one head that the causal / window masks admit."""
    qp = torch.arange(Sq, device=dev)[:, None]
    kp = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return int(mask.sum())


def bound_ms(torch, q, k, v, *, causal, window, dev) -> tuple[float, str]:
    """Larger of bytes / bandwidth (q, k, v read once, o written once) and
    operations / peak: 4 D flops per (query, key) pair the mask admits."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * D * B * H * admitted_pairs(torch, Sq, Sk, causal=causal, window=window, dev=dev)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(log: str) -> dict[tuple[str, tuple[int, ...]], str]:
    """Registers and spills of each kernel in an ``nvcc -Xptxas=-v`` log, by
    the kernel's own name (the mangled name's first component after its
    anonymous namespace) and its integer and bool template arguments, in
    the log's order."""
    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, args = m.group(1), ""
            ns = re.match(r"_ZN(\d+)", name)
            if ns:
                rest = name[ns.end() + int(ns.group(1)):]
                n = re.match(r"\d+", rest)
                if n:
                    name = rest[n.end():n.end() + int(n.group())]
                    args = rest[n.end() + int(n.group()):]
            kernel = (name, tuple(int(a) for a in re.findall(r"L[ib](\d+)E", args)))
            out[kernel] = ""
        elif kernel and ("spill" in line or "registers" in line):
            text = re.sub(r"^ptxas info\s*:\s*", "", line.strip())
            out[kernel] = f"{out[kernel]}{'; ' if out[kernel] else ''}{text}"
    return out


def fa_dims() -> tuple[int, ...]:
    """The attention kernels' head dims."""
    from repro_torch.kernels import flash_attention as fa

    return fa.SUPPORTED_D


def build_phase(torch):
    """One nvcc per kernel source, all started together; prints each
    kernel's registers, spills and shared memory as ptxas reports them."""
    from repro_torch.kernels import _build

    def timed(name):
        t0 = time.perf_counter()
        log = _build.build(name)
        return log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(timed, KERNELS)))
    print(f"[build] {', '.join(KERNELS)} in parallel: {time.perf_counter() - t0:.1f}s")
    for name, (log, secs) in logs.items():
        print(f"[build] {name}: {secs:.1f}s{'' if log else ' (library already built)'}")
        summary = ptxas_summary(log)
        last = {kernel: props for (kernel, _), props in summary.items()}
        for kernel, props in last.items():
            print(f"[build] {name}: {kernel}: {props}")
        if name == "flash_attention_bwd":   # every head dim of the wgmma kernels (384 threads)
            for (kernel, args), props in summary.items():
                if args and kernel.endswith("_wgmma"):
                    print(f"[build] {name}: {kernel} at D {args[0]}: {props}")
        if name == "flash_attention":       # gemma2's head dim; the decode split or not
            for (kernel, args), props in summary.items():
                if args[:1] == (256,) and kernel != PREFILL_KERNEL:
                    mode = {(0,): " (unsplit)", (1,): " (split)"}.get(args[1:], "")
                    print(f"[build] {name}: {kernel} at D 256{mode}: {props}")
            dec = {args[0]: props for (kernel, args), props in summary.items()
                   if kernel == DECODE_KERNEL and args}
            for D in (d for d in fa_dims() if d < 256):
                print(f"[build] {name}: {DECODE_KERNEL} at D {D} (the bf16 decode; 160 "
                      f"threads): {dec.get(D, 'not in the log')}")
            wg = {args[0]: props for (kernel, args), props in summary.items()
                  if kernel == PREFILL_KERNEL and args}
            for D in fa_dims():
                print(f"[build] {name}: {PREFILL_KERNEL} at D {D} (the bf16 prefill; 384 "
                      f"threads, one block an SM, before setmaxnreg): "
                      f"{wg.get(D, 'not in the log')}")
    from repro_torch.kernels import mlstm, ssd

    print(f"[build] ssd: dynamic shared memory a block at the serve shape (chunk 128, "
          f"N 64, P 64): {ssd.smem_bytes(128, 64, 64)} bytes (bf16, ssd_fwd_wgmma, 2 "
          f"warpgroups), {ssd.smem_bytes(128, 64, 64, torch.float32)} bytes (fp32, scalar); "
          f"bf16 plan (heads a block, chunks a block, blocks a cluster, blocks at once) at the "
          f"serve shape "
          f"{ssd.plan(BATCH, PROMPT, 64, 128)}, the backward's at the train shape "
          f"{ssd.plan(BATCH, TRAIN_SEQ, 64, 128, backward=True)}")
    print(f"[build] mlstm: dynamic shared memory a block at the serve shape (chunk 128, "
          f"D 384): bf16 {mlstm.w_smem_bytes(128, 384)} bytes (W, one block a (b, h, chunk)), "
          f"{mlstm.smem_bytes(128, 384)} bytes (the rest, {mlstm.value_cols(128, 384)} value "
          f"columns a block); fp32 {mlstm.smem_bytes(128, 384, torch.float32)} bytes (scalar, "
          f"{mlstm.value_cols(128, 384, torch.float32)} value columns a block)")
    print(f"[build] ssd_bwd: dynamic shared memory a block at the train shape (chunk 128, N 64, "
          f"P 64): {ssd.bwd_tc_smem_bytes(128, 64, 64)} bytes (bf16, ssd_bwd_wgmma, 2 "
          f"warpgroups), {ssd.bwd_smem_bytes(128, 64, 64)} bytes (fp32, ssd_bwd, scalar, 8 warps); "
          f"fp32 scratch a call at ({BATCH},{TRAIN_SEQ},64,64): bf16 "
          f"{ssd.bwd_scratch_bytes(BATCH, TRAIN_SEQ, 64, 64, 64, 128, torch.bfloat16)} bytes, "
          f"fp32 {ssd.bwd_scratch_bytes(BATCH, TRAIN_SEQ, 64, 64, 64, 128)} bytes")
    print(f"[build] mlstm_bwd: dynamic shared memory a block at the train shape (chunk 128, "
          f"D 384): bf16 (tensor cores; the two sweeps 8 warps, two blocks an SM; the rest 16 "
          f"warps) "
          + ", ".join(f"{k} {mlstm.bwd_tc_smem_bytes(128, 384, k)}" for k in mlstm.BWD_TC_KERNELS)
          + f" bytes (mlstm_bwd_dstates_bf16 as mlstm_bwd_states_bf16, mlstm_bwd_gates_bf16 "
          f"none); fp32 (scalar, 8 warps) mlstm_bwd_main {mlstm.bwd_smem_bytes(128, 384)} bytes; "
          f"fp32 scratch a call at ({BATCH},{TRAIN_SEQ},4,384): "
          f"{mlstm.bwd_scratch_bytes(BATCH, TRAIN_SEQ, 4, 384, 128)} bytes (the larger path's)")


# The five families' head layouts, forward and backward: GQA 5 (llama4's
# 40/8), 7 (qwen2_vl's 28/4, yi's 56/8) and 12 (command_r's 96/8) at D 128,
# musicgen's 24/24 at D 64; ragged Sq, Sq != Sk, and decode (Sq < 16, the
# bf16 ones split over the SMs) with a group spread over two 16-row blocks
# and Sk not a multiple of 64: label, B, H, KV, Sq, Sk, D, causal, window.
FAMILY_FWD_EDGES = [
    ("D 128 gqa 5 (40/8) ragged Sq 77", 1, 40, 8, 77, 77, 128, True, 0),
    ("D 128 gqa 7 (56/8) Sq 100 Sk 300", 1, 56, 8, 100, 300, 128, False, 0),
    ("D 128 gqa 7 (28/4) window 64 Sq 200", 1, 28, 4, 200, 200, 128, True, 64),
    ("D 128 gqa 12 (96/8) ragged Sq 130", 1, 96, 8, 130, 130, 128, True, 0),
    ("D 64 mha 24/24 ragged Sq 150", 1, 24, 24, 150, 150, 64, True, 0),
    ("D 128 gqa 5 decode Sk 575", 2, 40, 8, 1, 575, 128, False, 0),
    ("D 128 gqa 7 decode Sk 333", 2, 56, 8, 1, 333, 128, False, 0),
    ("D 128 gqa 12 decode Sk 1000", 2, 96, 8, 1, 1000, 128, False, 0),
    ("D 64 mha 24/24 decode Sk 575", 2, 24, 24, 1, 575, 64, False, 0),
    ("D 128 gqa 5 Sq 4 Sk 461 (a group over two blocks)", 1, 40, 8, 4, 461, 128, False, 0),
    ("D 128 gqa 7 Sq 3 Sk 200 causal", 2, 56, 8, 3, 200, 128, True, 0),
    ("D 128 gqa 12 Sq 2 Sk 1000", 1, 96, 8, 2, 1000, 128, False, 0),
]
# The backward at those layouts: label, B, H, KV, Sq, Sk, D, causal.
FAMILY_BWD_EDGES = [
    ("gqa 5 (40/8) ragged S 77", 1, 40, 8, 77, 77, 128, True),
    ("gqa 7 (56/8) Sq 100 Sk 300", 1, 56, 8, 100, 300, 128, False),
    ("gqa 7 (28/4) S 129", 2, 28, 4, 129, 129, 128, True),
    ("gqa 12 (96/8) ragged S 130", 1, 96, 8, 130, 130, 128, True),
    ("mha 24/24 ragged S 150", 1, 24, 24, 150, 150, 64, True),
    ("mha 24/24 Sq 17 Sk 300", 2, 24, 24, 17, 300, 64, False),
]


def attention_check(torch, tag, label, q, k, v, dtype, failures, tol=None, *, causal,
                    window=0, softcap=0.0, convex=False) -> float:
    """The forward kernel against its plain version on the card, on the
    same inputs, within ``tol`` (``TOL[dtype]`` by default); a miss is a
    failure.  Returns the max abs error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
    want = ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    tol = tol or TOL[dtype]
    ok = bool(torch.isfinite(out).all()) and torch.allclose(out.float(), want.float(), **tol)
    if convex:
        ok = ok and float(out.abs().max()) <= float(v.abs().max()) + 1e-4
    print(f"{tag} {label:<34} {dtype:<8} max_abs_err={err:.3e} "
          f"(rtol={tol['rtol']}, atol={tol['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"flash_attention {label} {dtype}: max_abs_err {err:.3e}")
    return err


def kernel_phase(torch, dev, failures) -> dict:
    from repro_torch.kernels import flash_attention as fa

    # kernel vs plain version on the card
    def compare(label, q, k, v, dtype, tol=None, **opts) -> float:
        return attention_check(torch, "[kernel]", label, q, k, v, dtype, failures, tol, **opts)

    cases = [  # label, B, H, KV, Sq, Sk, D, causal, window
        ("mha", 1, 2, 2, 128, 128, 64, True, 0),
        ("gqa group 4", 2, 8, 2, 128, 128, 64, True, 0),
        ("mqa Sq!=Sk", 1, 4, 1, 64, 256, 32, False, 0),
        ("D 16 odd tiles", 2, 3, 3, 96, 96, 16, True, 0),
        ("D 80 causal Sq<Sk ragged", 2, 4, 2, 5, 37, 80, True, 0),
        ("D 80 window 20 masked rows", 1, 4, 4, 100, 77, 80, False, 20),
        ("D 128 gqa ragged", 1, 8, 2, 70, 70, 128, True, 0),
    ] + FAMILY_FWD_EDGES
    for seed, (label, B, H, KV, Sq, Sk, D, causal, window) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            q = randn(torch, (B, H, Sq, D), dtype, 3 * seed, dev)
            k = randn(torch, (B, KV, Sk, D), dtype, 3 * seed + 1, dev)
            v = randn(torch, (B, KV, Sk, D), dtype, 3 * seed + 2, dev)
            compare(label, q, k, v, dtype, causal=causal, window=window)
    for dtype in ("float32", "bfloat16"):
        for window in (16, 64, 128):
            q, k, v = (randn(torch, (1, 2, 128, 32), dtype, 100 + i, dev) for i in range(3))
            compare(f"window {window}", q, k, v, dtype, causal=True, window=window)
        q, k, v = (randn(torch, (1, 2, 64, 32), dtype, 110 + i, dev, 4.0 if i < 2 else 1.0)
                   for i in range(3))
        compare("softcap 20", q, k, v, dtype, dict(rtol=3e-5, atol=3e-5) if dtype == "float32"
                else None, causal=True, softcap=20.0)
        for seed, (log2s, group) in enumerate([(5, 1), (6, 2), (7, 4), (8, 2)]):
            S = 2 ** log2s
            q = randn(torch, (1, 2 * group, S, 32), dtype, 120 + 3 * seed, dev)
            k = randn(torch, (1, 2, S, 32), dtype, 121 + 3 * seed, dev)
            v = randn(torch, (1, 2, S, 32), dtype, 122 + 3 * seed, dev)
            compare(f"convex S {S} group {group}", q, k, v, dtype, causal=True, convex=True)
    # bf16 only: the tensor-core kernels' decode mode (Sq < 16) with GQA
    # group 4, every Sq from 1 to 15; and every head dim with ragged Sq != Sk
    # in prefill mode.
    dims = (16, 32, 64, 80, 128)
    for Sq in range(1, 16):
        D, Sk, causal = dims[Sq % 5], 40 * Sq + 17, Sq % 2 == 0
        q, k, v = (randn(torch, shape, "bfloat16", 130 + 3 * Sq + i, dev) for i, shape in
                   enumerate([(2, 8, Sq, D), (2, 2, Sk, D), (2, 2, Sk, D)]))
        compare(f"decode gqa 4 Sq {Sq} Sk {Sk} D {D}{' causal' if causal else ''}", q, k, v,
                "bfloat16", causal=causal)
    for i, D in enumerate(dims):
        for Sq, Sk, causal in ((37 + 31 * i, 100 + 23 * i, True), (150 - 9 * i, 61 + 7 * i, False)):
            q, k, v = (randn(torch, shape, "bfloat16", 180 + 10 * i + j, dev) for j, shape in
                       enumerate([(2, 4, Sq, D), (2, 2, Sk, D), (2, 2, Sk, D)]))
            compare(f"D {D} ragged Sq {Sq} Sk {Sk}{' causal' if causal else ''}", q, k, v,
                    "bfloat16", causal=causal)

    # gemma2's head dim 256 in both dtypes (softcap 50, its window of 4096
    # past which a 5120-row sequence reaches, GQA 16/8, a ragged Sq, decode
    # over a full ring and a global cache), each case timed beside its bound.
    d256 = [  # label, B, H, KV, Sq, Sk, causal, window, softcap
        ("D 256 causal softcap 50 gqa 16/8", 1, 16, 8, 1100, 1100, True, 0, 50.0),
        ("D 256 window 4096 softcap 50", 1, 4, 2, 5120, 5120, True, 4096, 50.0),
        ("D 256 gqa 16/8 ragged Sq 77 Sk 300", 2, 16, 8, 77, 300, True, 0, 0.0),
        ("D 256 decode Sk 4096 (a full ring)", 2, 16, 8, 1, 4096, False, 0, 50.0),
        ("D 256 decode Sk 5184", 2, 16, 8, 1, 5184, False, 0, 50.0),
    ]
    for seed, (label, B, H, KV, Sq, Sk, causal, window, softcap) in enumerate(d256):
        for dtype in ("float32", "bfloat16"):
            q = randn(torch, (B, H, Sq, 256), dtype, 300 + 3 * seed, dev, 2.0)
            k = randn(torch, (B, KV, Sk, 256), dtype, 301 + 3 * seed, dev, 2.0)
            v = randn(torch, (B, KV, Sk, 256), dtype, 302 + 3 * seed, dev)
            opts = dict(causal=causal, window=window, softcap=softcap)
            compare(label, q, k, v, dtype, **opts)
            ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, **opts), iters=5, reps=3)
            bound, by = bound_ms(torch, q, k, v, causal=causal, window=window, dev=dev)
            print(f"[time] flash_attention {label} {dtype}: kernel {ms:.4f} ms, bound "
                  f"{bound * 1e3:.2f} us ({by}), {ms / bound:.1f}x")
            del q, k, v

    prefill_edges(torch, dev, failures)

    # The serve path's two shapes, in the model's strided layout.
    H, D, Sk_dec = 32, 80, PROMPT + GEN - 1
    pq = model_layout(torch, BATCH, H, PROMPT, D, "bfloat16", 200, dev)
    pk = model_layout(torch, BATCH, H, PROMPT, D, "bfloat16", 201, dev)
    pv = model_layout(torch, BATCH, H, PROMPT, D, "bfloat16", 202, dev)
    dq = model_layout(torch, BATCH, H, 1, D, "bfloat16", 203, dev)
    dkv = decode_sets(torch, BATCH, H, Sk_dec, D, 204, dev)
    err = max(compare("serve prefill (8,32,512,80) causal", pq, pk, pv, "bfloat16",
                      causal=True),
              compare(f"serve decode (8,32,1,80) Sk {Sk_dec}", dq, *dkv[0], "bfloat16",
                      causal=False))

    pre, dec = attention_timings(torch, pq, [(pk, pv)], True, dev), \
        attention_timings(torch, dq, dkv, False, dev)
    for label, t, q in (("prefill (8,32,512,80) causal bf16", pre, pq),
                        (f"decode (8,32,1,80) Sk {Sk_dec} bf16", dec, dq)):
        print_attention_time(label, t, q)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": None,
        "max_abs_err": err,
        "shape": "prefill (8,32,512,80) causal bf16",
        **pre,
        "decode": {"shape": f"decode (8,32,1,80) Sk {Sk_dec} bf16", **dec},
    }


# The D 256 bf16 prefill's edges (PREFILL_KERNEL: 128 query rows an
# item, 64 a consumer warpgroup, 64-key tiles at D 256): label, B, H, KV,
# Sq, Sk, causal, window, softcap, the scale of q and k, the model's
# strided (B,S,H,D) layout.  Sq 16, 63, 64, 65, 129 and 5183 leave one
# consumer's rows partly or wholly past Sq; windows of 64 and 4096 put
# whole tiles outside one consumer's keys but not the other's; q and k
# scaled by 4 saturate the softcap.
D256_PREFILL_EDGES = [
    ("Sq 16", 1, 4, 2, 16, 16, True, 0, 50.0, 2.0, False),
    ("Sq 63", 1, 4, 2, 63, 63, True, 0, 50.0, 2.0, False),
    ("Sq 64", 2, 4, 2, 64, 64, True, 0, 50.0, 2.0, False),
    ("Sq 65", 1, 4, 2, 65, 65, True, 0, 50.0, 2.0, False),
    ("Sq 129", 1, 4, 4, 129, 129, True, 0, 50.0, 2.0, False),
    ("Sq 5183", 1, 2, 1, 5183, 5183, True, 0, 50.0, 2.0, False),
    ("causal Sq 100 < Sk 300", 1, 4, 2, 100, 300, True, 0, 50.0, 2.0, False),
    ("causal Sq 300 > Sk 100", 1, 4, 2, 300, 100, True, 0, 0.0, 1.0, False),
    ("Sq 130 Sk 200", 2, 4, 2, 130, 200, False, 0, 50.0, 2.0, False),
    ("Sq 200 Sk 77 no softcap", 1, 4, 2, 200, 77, False, 0, 0.0, 1.0, False),
    ("window 64", 1, 4, 2, 320, 320, True, 64, 50.0, 2.0, False),
    ("window 4096 Sq 4500", 1, 2, 1, 4500, 4500, True, 4096, 50.0, 2.0, False),
    ("q, k x 4", 1, 4, 2, 256, 256, True, 0, 50.0, 4.0, False),
    ("q, k x 4 window 64", 1, 4, 2, 300, 300, True, 64, 50.0, 4.0, False),
    ("strided (B,S,H,D) gqa 16/8", 2, 16, 8, 600, 600, True, 0, 50.0, 1.0, True),
    ("strided window 4096 Sq 4200", 1, 16, 8, 4200, 4200, True, 4096, 50.0, 1.0, True),
]
# flash_attention_lse at D 256, Sq >= 16: label, B, H, KV, Sq, Sk, causal,
# window, softcap; the first has rows that admit no key (q >= 163).
D256_PREFILL_LSE = [
    ("lse D 256 Sq 300 Sk 100 window 64, rows with no key", 1, 4, 2, 300, 100, False, 64, 50.0),
    ("lse D 256 causal Sq 700 gqa 16/8", 1, 16, 8, 700, 700, True, 0, 50.0),
]
# The same kernel's edges below D 256 (128-key tiles, one block an SM
# walking the items), run at D 16, 32, 64, 80 and 128 (the tensor maps'
# zero-filled columns past D at 16, 32 and 80), through both entries:
# label, B, H, KV, Sq, Sk, causal, window, softcap, the scale of q and k,
# the model's strided layout.  Tile edges of Sq (16 to 300); Sk below and
# above Sq; GQA groups 1, 5, 7, 12 and 24 / 24; windows at a half, a whole
# and one past a 128-key tile; the softcap saturated; the model's layout;
# rows that admit no key (the last two; the second with more items than
# SMs, so that a block walks items with keys and then items without).
PREFILL_EDGES = [
    ("Sq 16", 1, 4, 2, 16, 16, True, 0, 0.0, 1.0, False),
    ("Sq 17", 1, 4, 2, 17, 17, True, 0, 0.0, 1.0, False),
    ("Sq 63", 1, 4, 2, 63, 63, True, 0, 0.0, 1.0, False),
    ("Sq 64", 2, 4, 2, 64, 64, True, 0, 0.0, 1.0, False),
    ("Sq 65", 1, 4, 2, 65, 65, True, 0, 0.0, 1.0, False),
    ("Sq 127", 1, 4, 2, 127, 127, True, 0, 0.0, 1.0, False),
    ("Sq 128", 1, 4, 2, 128, 128, True, 0, 0.0, 1.0, False),
    ("Sq 129 group 1", 1, 4, 4, 129, 129, True, 0, 0.0, 1.0, False),
    ("Sq 300", 2, 4, 2, 300, 300, True, 0, 0.0, 1.0, False),
    ("causal Sq 100 < Sk 300", 1, 4, 2, 100, 300, True, 0, 0.0, 1.0, False),
    ("causal Sq 300 > Sk 100", 1, 4, 2, 300, 100, True, 0, 0.0, 1.0, False),
    ("Sq 130 Sk 200", 2, 4, 2, 130, 200, False, 0, 0.0, 1.0, False),
    ("gqa 5 (10/2)", 1, 10, 2, 200, 200, True, 0, 0.0, 1.0, False),
    ("gqa 7 (14/2)", 1, 14, 2, 129, 129, True, 0, 0.0, 1.0, False),
    ("gqa 12 (24/2)", 1, 24, 2, 128, 128, True, 0, 0.0, 1.0, False),
    ("mha 24/24", 1, 24, 24, 150, 150, True, 0, 0.0, 1.0, False),
    ("window 64", 1, 4, 2, 320, 320, True, 64, 0.0, 1.0, False),
    ("window 128", 1, 4, 2, 400, 400, True, 128, 0.0, 1.0, False),
    ("window 129", 1, 4, 2, 300, 300, True, 129, 0.0, 1.0, False),
    ("softcap 50, q, k x 4", 1, 4, 2, 256, 256, True, 0, 50.0, 4.0, False),
    ("softcap 50, q, k x 4, window 64", 1, 4, 2, 300, 300, True, 64, 50.0, 4.0, False),
    ("strided (B,S,H,D) gqa 2 (8/4)", 2, 8, 4, 300, 300, True, 0, 0.0, 1.0, True),
    ("Sq 300 Sk 100 window 64, rows with no key", 1, 4, 2, 300, 100, False, 64, 0.0, 1.0,
     False),
    ("288 items, the blocks' later ones with no key", 2, 48, 8, 300, 100, False, 64, 0.0, 1.0,
     False),
]
# Two calls bitwise equal at these prefill shapes (B, H, KV, S, D) in the
# model's layout: stablelm's and phi3.5's.
PREFILL_REPEATS = [("stablelm", 8, 32, 32, 512, 80), ("phi3.5", 8, 32, 8, 512, 128)]


def prefill_check(torch, label, q, k, v, failures, **opts) -> float:
    """The bf16 prefill through both forward entries against
    ``attention_lse_ref`` within 2e-2: each output, and the lse where a row
    admits a key; a row that admits none gives 0 and an lse of -inf.
    Returns the largest max abs error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    out = fa.flash_attention_cuda(q, k, v, **opts)
    out2, lse = fa.flash_attention_lse_cuda(q, k, v, **opts)
    want, want_lse = ref.attention_lse_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    empty = torch.isneginf(want_lse)
    tol = TOL["bfloat16"]
    err = max(float((o.float() - want.float()).abs().max()) for o in (out, out2))
    lse_err = float((lse[~empty] - want_lse[~empty]).abs().max()) if bool((~empty).any()) else 0.0
    ok = (all(bool(torch.isfinite(o).all()) and torch.allclose(o.float(), want.float(), **tol)
              and not o[empty].any() for o in (out, out2))
          and torch.equal(torch.isneginf(lse), empty)
          and torch.allclose(lse[~empty], want_lse[~empty], **tol))
    print(f"[kernel] prefill {label} bfloat16: max_abs_err={err:.3e} (both entries), lse "
          f"{lse_err:.3e} ({int(empty.sum())} rows with no key; rtol={tol['rtol']}, "
          f"atol={tol['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"prefill {label}: max_abs_err {err:.3e}, lse {lse_err:.3e}")
    return max(err, lse_err)


def prefill_inputs(torch, B, H, KV, Sq, Sk, D, seed, dev, scale=1.0, strided=False):
    """q, k, v of a prefill case: randn (q and k times ``scale``), or (strided)
    views of (B,S,H,D) tensors, k and v slices of longer caches."""
    if strided:
        return tuple(model_layout(torch, B, n, S, D, "bfloat16", seed + i, dev, s_alloc=S + 64 * i)
                     for i, (n, S) in enumerate(((H, Sq), (KV, Sk), (KV, Sk))))
    return tuple(randn(torch, shape, "bfloat16", seed + i, dev, x)
                 for i, (shape, x) in enumerate((((B, H, Sq, D), scale), ((B, KV, Sk, D), scale),
                                                 ((B, KV, Sk, D), 1.0))))


def prefill_edges(torch, dev, failures) -> float:
    """The bf16 prefill at its edges through both forward entries
    (``prefill_check``): ``PREFILL_EDGES`` at every head dim below 256,
    ``D256_PREFILL_EDGES`` and ``D256_PREFILL_LSE`` at D 256; then two calls
    bitwise equal at gemma2's serve shape (2,16,5120,256) KV 8 softcap 50,
    global and local, and at ``PREFILL_REPEATS``.  Prints its wall time;
    returns the largest max abs error."""
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    worst, n = 0.0, 0
    for D in (d for d in fa_dims() if d < 256):
        for seed, (label, B, H, KV, Sq, Sk, causal, window, cap, scale, strided) in enumerate(
                PREFILL_EDGES):
            q, k, v = prefill_inputs(torch, B, H, KV, Sq, Sk, D, 1700 + 3 * seed + 100 * D, dev,
                                     scale, strided)
            worst = max(worst, prefill_check(torch, f"D {D} {label}", q, k, v, failures,
                                             causal=causal, window=window, softcap=cap))
            n += 1
    for seed, (label, B, H, KV, Sq, Sk, causal, window, cap, scale, strided) in enumerate(
            D256_PREFILL_EDGES):
        q, k, v = prefill_inputs(torch, B, H, KV, Sq, Sk, 256, 1500 + 3 * seed, dev, scale,
                                 strided)
        worst = max(worst, prefill_check(torch, f"D 256 {label}", q, k, v, failures,
                                         causal=causal, window=window, softcap=cap))
        n += 1
        del q, k, v
    for seed, (label, B, H, KV, Sq, Sk, causal, window, cap) in enumerate(D256_PREFILL_LSE):
        q, k, v = prefill_inputs(torch, B, H, KV, Sq, Sk, 256, 1600 + 3 * seed, dev, 2.0)
        worst = max(worst, prefill_check(torch, label, q, k, v, failures, causal=causal,
                                         window=window, softcap=cap))
        n += 1
    repeats = [(f"D 256 {label} ({GEMMA2_BATCH},16,{GEMMA2_PROMPT},256) kv 8 softcap 50",
                GEMMA2_BATCH, 16, 8, GEMMA2_PROMPT, 256, window, 50.0, seed)
               for label, window, seed in (("global", 0, 1620), ("local", 4096, 1630))]
    repeats += [(f"{name} ({B},{H},{S},{D}) kv {KV}", B, H, KV, S, D, 0, 0.0, 1640 + 10 * i)
                for i, (name, B, H, KV, S, D) in enumerate(PREFILL_REPEATS)]
    for label, B, H, KV, S, D, window, cap, seed in repeats:
        q = model_layout(torch, B, H, S, D, "bfloat16", seed, dev)
        k, v = (model_layout(torch, B, KV, S, D, "bfloat16", seed + i, dev) for i in (1, 2))
        opts = dict(causal=True, window=window, softcap=cap)
        first, second = (fa.flash_attention_cuda(q, k, v, **opts) for _ in range(2))
        same = torch.equal(first, second)
        print(f"[kernel] prefill {label} bf16: two calls bitwise equal {same} "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"prefill {label}: two calls differ")
        del q, k, v, first, second
    print(f"[kernel] prefill edges: {n} cases through both entries, {len(repeats)} repeats, "
          f"{time.perf_counter() - t0:.1f} s")
    return worst


def decode_sets(torch, B, H, Sk, D, seed, dev, s_alloc=PROMPT + GEN) -> list:
    """Distinct (k, v) caches in the model's layout (``s_alloc`` rows
    allocated), enough of them that together they exceed the L2: a decode
    step reads each layer's cache cold, and a timing on one set would read
    it from the L2."""
    one = 2 * B * H * Sk * D * 2
    n = L2_BYTES // one + 2
    return [(model_layout(torch, B, H, Sk, D, "bfloat16", seed + 2 * i, dev, s_alloc),
             model_layout(torch, B, H, Sk, D, "bfloat16", seed + 2 * i + 1, dev, s_alloc))
            for i in range(n)]


def graph_ms(torch, fns, reps=5) -> float:
    """Device time per call: ``fns`` captured in order in one CUDA graph and
    replayed, so no host time sits between the launches.  Median of
    ``reps`` replays, by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / len(fns))
    return statistics.median(samples)


def attention_timings(torch, q, kv_sets, causal, dev, *, window=0, softcap=0.0,
                      iters=None) -> dict:
    """Kernel, plain version and one library call at one shape, and the
    bound.  With more than one (k, v) set (decode), each timed call reads
    the next set, so every call finds its K/V outside the L2.  The kernel
    and SDPA are timed as a CUDA graph of calls (``ms``, ``library_ms``),
    which leaves out the host's launch time: at 30-100 us a call that is
    as long as a decode or a 512-token prefill.  The calls launched one by
    one are kept as ``eager_ms`` and ``library_eager_ms``.  SDPA has no window
    or softcap argument: with either, it is timed without them
    (``library_note`` says so), and is not the same function."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    n = len(kv_sets)
    opts = dict(causal=causal, window=window, softcap=softcap)
    gqa = q.shape[1] != kv_sets[0][0].shape[1]
    kern = lambda i: fa.flash_attention_cuda(q, *kv_sets[i % n], **opts)   # noqa: E731
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        q, *kv_sets[i % n], is_causal=causal, enable_gqa=gqa)

    def rotating(fn):
        it = iter(range(10**9))
        return lambda: fn(next(it))

    iters = iters or (20 if n == 1 else 8 * n)
    t = {
        "eager_ms": time_ms(torch, rotating(kern), iters=iters),
        "plain_ms": time_ms(torch, rotating(lambda i: ref.attention_ref(
            q, *kv_sets[i % n], **opts)), iters=iters),
        "library_eager_ms": time_ms(torch, rotating(sdpa), iters=iters),
        "ms": graph_ms(torch, [lambda i=i: kern(i) for i in range(iters)]),
        "library_ms": graph_ms(torch, [lambda i=i: sdpa(i) for i in range(iters)]),
    }
    if window or softcap:
        t["library_note"] = (f"SDPA {'causal ' if causal else ''}without the "
                             + " and ".join(w for w, on in (("window", window),
                                                            ("softcap", softcap)) if on)
                             + ": not the same function (no PyTorch call applies a tanh "
                               "softcap)")
    t["bound_ms"], t["bound_by"] = bound_ms(torch, q, *kv_sets[0], causal=causal,
                                            window=window, dev=dev)
    t["splits"], t["split_keys"] = fa._split_plan(q, kv_sets[0][0])
    t["head_dim"] = q.shape[-1]
    t["cold"] = n > 1
    return t


def print_attention_time(label, t, q=None):
    """One ``[time]`` row for ``attention_timings``' t; with q, a bf16
    prefill's earlier ``mma.sync`` time at q's shape (``EARLIER_PREFILL``)
    beside today's."""
    if "library_note" in t:
        label = f"{label} (sdpa: {t['library_note']})"
    if t.get("splits", 1) > 1:
        kernels = (" + ".join(SPLIT_DECODE_KERNELS) if t.get("head_dim") == 256
                   else f"{DECODE_KERNEL}, one launch, the ranges merged in a cluster")
        label = f"{label} (keys split {t['splits']} ways, {t['split_keys']} a split: {kernels})"
    cold = (", cold L2 (each call reads the next of several K/V sets that together exceed "
            "the 50 MB L2)") if t.get("cold") else ""
    earlier = EARLIER_PREFILL.get(tuple(q.shape)) if q is not None else None
    earlier = f" (the earlier mma.sync plan {earlier}, launched one by one)" if earlier else ""
    print(f"[time] flash_attention {label}{cold}: kernel {t['ms']:.4f} ms{earlier}, sdpa "
          f"{t['library_ms']:.4f} ms as a CUDA graph of calls (device time); launched one by "
          f"one kernel {t['eager_ms']:.4f} ms, sdpa {t['library_eager_ms']:.4f} ms; plain "
          f"{t['plain_ms']:.4f} ms; bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")


def attention_share(terms, total_ms, times=1) -> str:
    """``times`` x the calls that ``terms`` lists ((n, t): n calls of a
    shape ``attention_timings`` timed as t) as a share of ``total_ms``: by
    the device time of a CUDA graph of calls (``ms``), and by the calls
    launched one by one (``eager_ms``, the host's launch time included)."""
    parts = []
    for key in ("ms", "eager_ms"):
        calls = " + ".join(f"{n} x {t[key]:.4f}" for n, t in terms)
        ms = times * sum(n * t[key] for n, t in terms)
        parts.append(f"{f'{times} x ({calls})' if times > 1 else calls} ms = {ms:.2f} ms, "
                     f"{ms / total_ms:.1%}")
    return f"{parts[0]} (launched one by one {parts[1]})"


def flex_timing(torch, q, k, v, *, causal, window=0, softcap=0.0, dout=None) -> dict:
    """``torch.nn.attention.flex_attention``, compiled, computing the
    kernel's function on the same inputs: the tanh softcap as its
    ``score_mod``, the causal (top-left) and window masks as a block mask
    (none for a decode call), GQA by ``enable_gqa``.  Timed here only; the
    port never calls it.  ``flex_ms`` is the forward's time (no grad) or,
    with ``dout``, its backward's (autograd of one forward with grad), with
    the largest difference from the plain version's output
    (``flex_max_abs_err``); where it does not compile or run on the card,
    ``flex_ms`` is None and ``flex_error`` holds the error's first line."""
    from repro_torch.kernels import ref

    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        torch._dynamo.reset()
        Sq, Sk = q.shape[2], k.shape[2]

        def score_mod(score, b, h, q_idx, kv_idx):
            return softcap * torch.tanh(score / softcap)

        def mask_mod(b, h, q_idx, kv_idx):
            keep = kv_idx <= q_idx
            return keep & (kv_idx > q_idx - window) if window else keep

        mask = create_block_mask(mask_mod, None, None, Sq, Sk, device=q.device) if causal \
            else None
        fn = torch.compile(flex_attention, dynamic=False)
        opts = dict(score_mod=score_mod if softcap else None, block_mask=mask,
                    enable_gqa=q.shape[1] != k.shape[1])
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        t0 = time.perf_counter()
        if dout is None:
            with torch.no_grad():
                out = fn(qc, kc, vc, **opts)
                torch.cuda.synchronize()
                compile_s = time.perf_counter() - t0
                ms = time_ms(torch, lambda: fn(qc, kc, vc, **opts), iters=5, reps=3)
        else:
            inputs = [t.detach().requires_grad_() for t in (qc, kc, vc)]
            out = fn(*inputs, **opts)
            torch.autograd.grad(out, inputs, dout, retain_graph=True)
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
            ms = time_ms(torch, lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True),
                         iters=5, reps=3)
        want = ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
        err = float((out.detach().float() - want.float()).abs().max())
        return {"flex_ms": ms, "flex_compile_s": compile_s, "flex_max_abs_err": err}
    except Exception as e:   # the library's own failure to compile, reported in its column
        first = (str(e).strip().splitlines() or [""])[0][:240]
        return {"flex_ms": None, "flex_error": f"{type(e).__name__}: {first}"}


def flex_phase(torch, dev, fa_entry, bwd_entry):
    """``flex_timing`` at gemma2_9b's D 256 shapes, beside the kernel's
    times already in ``fa_entry`` / ``bwd_entry``: the serve prefill
    (2,16,5120,256) and decodes over a full ring and the global cache, the
    train forward and backward (1,16,8192,256), global and local layers,
    KV 8, softcap 50.  Last of the run: ``torch.compile`` and its worker
    processes touch nothing that a phase measures after them."""
    W, cap, KV, D = 4096, 50.0, 8, 256
    shapes = [  # entry, key, B, H, Sq, Sk, causal, window, backward
        (fa_entry[GEMMA2], "prefill_global", GEMMA2_BATCH, 16, GEMMA2_PROMPT, GEMMA2_PROMPT,
         True, 0, False),
        (fa_entry[GEMMA2], "prefill_local", GEMMA2_BATCH, 16, GEMMA2_PROMPT, GEMMA2_PROMPT,
         True, W, False),
        (fa_entry[GEMMA2], "decode_ring", GEMMA2_BATCH, 16, 1, W, False, 0, False),
        (fa_entry[GEMMA2], "decode_global", GEMMA2_BATCH, 16, 1, GEMMA2_PROMPT + GEN - 1, False,
         0, False),
        (fa_entry[f"{GEMMA2} train"], "global", 1, 16, GEMMA2_TRAIN_SEQ, GEMMA2_TRAIN_SEQ, True,
         0, False),
        (fa_entry[f"{GEMMA2} train"], "local", 1, 16, GEMMA2_TRAIN_SEQ, GEMMA2_TRAIN_SEQ, True,
         W, False),
        (bwd_entry[GEMMA2], "global", 1, 16, GEMMA2_TRAIN_SEQ, GEMMA2_TRAIN_SEQ, True, 0, True),
        (bwd_entry[GEMMA2], "local", 1, 16, GEMMA2_TRAIN_SEQ, GEMMA2_TRAIN_SEQ, True, W, True),
    ]
    for seed, (entry, key, B, H, Sq, Sk, causal, window, backward) in enumerate(shapes):
        q = model_layout(torch, B, H, Sq, D, "bfloat16", 1800 + 4 * seed, dev)
        k, v = (model_layout(torch, B, KV, Sk, D, "bfloat16", 1801 + 4 * seed + i, dev)
                for i in range(2))
        dout = model_layout(torch, B, H, Sq, D, "bfloat16", 1803 + 4 * seed, dev) \
            if backward else None
        t = flex_timing(torch, q, k, v, causal=causal, window=window, softcap=cap, dout=dout)
        entry[key].update(t)
        print_flex(f"{'backward ' if backward else ''}{entry[key]['shape']} (kernel "
                   f"{entry[key]['ms']:.4f} ms)", t)
        del q, k, v, dout
        torch.cuda.empty_cache()


def print_flex(label, t):
    if t.get("flex_ms") is None:
        print(f"[time] flex_attention {label}: did not compile or run: {t['flex_error']}")
        return
    print(f"[time] flex_attention {label} (compiled; softcap score_mod, causal / window block "
          f"mask: the kernel's function): {t['flex_ms']:.4f} ms, compiled in "
          f"{t['flex_compile_s']:.1f} s, output max_abs_err {t['flex_max_abs_err']:.3e} against "
          "attention_ref")


# ------------------------------------------------- attention with its lse --

# The log-sum-exp entry's timing shapes: a rank's half of each cache a
# decode step on the (2, 2) mesh of [serve parallel] reads, its sequence
# split over 'model' (decode mode): stablelm_3b's 575 rows, gemma2_9b's
# global 5184 (its serve phase's cache).
LSE_TIMED = [("stablelm decode (8,32,1,80), a rank's half of Sk 575", 8, 32, 32, 288, 80, 0.0),
             ("gemma2 global decode (2,16,1,256) KV 8 softcap 50, a rank's half of Sk 5184",
              2, 16, 8, 2592, 256, 50.0)]


# The TMA decode kernel's edges below D 256 (DECODE_KERNEL): label, B, H,
# KV, Sq, Sk, D, causal, window, softcap, rows allocated for the cache (0:
# Sk), (splits, keys a split) for the split entry (None: the wrappers'
# rule).  Sq 1-15 at every head dim (ragged Sk, causal every other one),
# top-left causal with Sq < Sk, a window and a softcap, Sk not a whole
# tile, below a tile and 0, a cache allocated longer than Sk, rows that
# admit no key, and clusters of 1-8 ranges.
DECODE_EDGES = (
    [(f"D {D} Sq {Sq}", 2, 8, 2, Sq, 40 * Sq + 17 + i, D, Sq % 2 == 0, 0, 0.0, 0, None)
     for i, D in enumerate((16, 32, 64, 80, 128)) for Sq in range(1, 16)]
    + [("causal Sq 5 < Sk 37", 2, 4, 2, 5, 37, 80, True, 0, 0.0, 0, None),
       ("window 20 Sq 4", 1, 8, 2, 4, 300, 64, False, 20, 0.0, 0, None),
       ("softcap 30", 2, 16, 4, 1, 500, 128, False, 0, 30.0, 0, None),
       ("window 40 softcap 20 Sq 3", 2, 12, 4, 3, 333, 32, True, 40, 20.0, 0, None),
       ("Sk 37, not a whole tile", 2, 8, 8, 1, 37, 64, False, 0, 0.0, 0, None),
       ("Sk 7, below a tile", 2, 8, 2, 1, 7, 16, False, 0, 0.0, 0, None),
       ("Sk 0", 2, 8, 2, 1, 0, 128, False, 0, 0.0, 0, None),
       ("cache of 600 rows, Sk 333", 2, 8, 2, 3, 333, 128, False, 0, 0.0, 600, None),
       ("cache of 576 rows, Sk 575 (stablelm)", 2, 32, 32, 1, 575, 80, False, 0, 0.0, 576, None),
       ("rows with no key (window 3)", 1, 4, 2, 12, 5, 64, False, 3, 0.0, 0, None),
       ("rows with no key, split 4 x 16", 1, 4, 2, 12, 5, 64, False, 3, 0.0, 0, (4, 16))]
    + [(f"gqa 7 split {n}", 2, 28, 4, 1, 575, 128, False, 0, 0.0, 0,
        (n, -(-575 // (16 * n)) * 16)) for n in range(1, 9)]
    + [("causal Sq 8 split 8 x 96", 2, 8, 2, 8, 700, 80, True, 0, 0.0, 0, (8, 96))])


def decode_edges(torch, dev, failures) -> float:
    """The bf16 decode below D 256 at ``DECODE_EDGES``: through both forward
    entries (or the split entry, called directly) against
    ``attention_lse_ref`` within 2e-2, the output and the lse (-inf and a
    zero output for a row that admits no key); two calls bitwise equal, and
    the lse entry's output bitwise the forward's.  Returns the largest max
    abs error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    t0 = time.perf_counter()
    tol, worst = TOL["bfloat16"], 0.0
    for seed, (label, B, H, KV, Sq, Sk, D, causal, window, cap, alloc, split) in enumerate(
            DECODE_EDGES):
        q = randn(torch, (B, H, Sq, D), "bfloat16", 2600 + 3 * seed, dev, 2.0)
        k, v = (model_layout(torch, B, KV, Sk, D, "bfloat16", 2601 + 3 * seed + i, dev,
                             max(alloc, Sk, 1)) for i in range(2))
        opts = dict(causal=causal, window=window, softcap=cap)
        if split:
            lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
            outs = [fa.run_split(q, k, v, *split, lse=lse, **opts),
                    fa.run_split(q, k, v, *split, **opts)]
        else:
            out, lse = fa.flash_attention_lse_cuda(q, k, v, **opts)
            outs = [out, fa.flash_attention_cuda(q, k, v, **opts),
                    fa.flash_attention_cuda(q, k, v, **opts)]
        want, want_lse = ref.attention_lse_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        empty = torch.isneginf(want_lse)
        err = float((outs[0].float() - want.float()).abs().max()) if want.numel() else 0.0
        lse_err = float((lse[~empty] - want_lse[~empty]).abs().max()) if bool((~empty).any()) \
            else 0.0
        repeat = all(torch.equal(outs[0], o) for o in outs[1:])
        ok = (repeat and bool(torch.isfinite(outs[0]).all())
              and torch.allclose(outs[0].float(), want.float(), **tol)
              and torch.equal(torch.isneginf(lse), empty) and not outs[0][empty].any()
              and torch.allclose(lse[~empty], want_lse[~empty], **tol))
        plan = split or fa._split_plan(q, k)
        print(f"[kernel] decode {label} ({B},{H},{Sq},{D}) kv {KV} Sk {Sk}, {plan[0]} range(s) "
              f"of {plan[1]} keys: max_abs_err={err:.3e}, lse {lse_err:.3e} ({int(empty.sum())} "
              f"rows with no key); calls bitwise equal {repeat} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"decode {label}: max_abs_err {err:.3e}, lse {lse_err:.3e}, "
                            f"repeat {repeat}")
        worst = max(worst, err, lse_err)
    print(f"[kernel] decode edges: {len(DECODE_EDGES)} cases, {time.perf_counter() - t0:.1f} s")
    return worst


def split_decode_edges(torch, dev, failures) -> float:
    """The split decode's entry called directly (``flash_attention.run_split``)
    where the rule would not cut the keys: more ranges than keys, rows that
    admit no key (a window: 0 and lse -inf), a causal decode whose later
    ranges admit none, each against ``attention_split_ref`` and
    ``attention_lse_ref`` in bf16.  Returns the largest max abs error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    cases = [  # label, B, H, KV, Sq, Sk, D, splits, chunk, causal, window, softcap
        ("more ranges than keys", 1, 16, 8, 1, 100, 256, 5, 64, False, 0, 50.0),
        ("rows with no key (window 3)", 1, 4, 2, 12, 5, 256, 4, 64, False, 3, 0.0),
        ("causal Sq 8, ranges past the rows' keys", 2, 8, 2, 8, 700, 80, 8, 96, True, 0, 0.0),
        # the five families' head layouts: a 16-row block holding part of
        # a group (GQA 5 at Sq 4, 7 at Sq 3, 12 at Sq 2), keys not a
        # multiple of 64
        ("gqa 5 (40/8) Sq 4, partial groups", 1, 40, 8, 4, 700, 128, 6, 128, False, 0, 0.0),
        ("gqa 7 (56/8) Sq 3, partial groups", 2, 56, 8, 3, 333, 128, 3, 128, False, 0, 0.0),
        ("gqa 7 (56/8) Sk 333", 2, 56, 8, 1, 333, 128, 6, 64, False, 0, 0.0),
        ("gqa 12 (96/8) Sq 2 Sk 1000", 1, 96, 8, 2, 1000, 128, 8, 128, False, 0, 0.0),
        ("mha 24/24 D 64 Sk 575", 2, 24, 24, 1, 575, 64, 5, 128, False, 0, 0.0),
    ]
    worst = 0.0
    for seed, (label, B, H, KV, Sq, Sk, D, splits, chunk, causal, window, cap) in enumerate(cases):
        q = randn(torch, (B, H, Sq, D), "bfloat16", 450 + 3 * seed, dev)
        k = randn(torch, (B, KV, Sk, D), "bfloat16", 451 + 3 * seed, dev)
        v = randn(torch, (B, KV, Sk, D), "bfloat16", 452 + 3 * seed, dev)
        opts = dict(causal=causal, window=window, softcap=cap)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        out = fa.run_split(q, k, v, splits, chunk, lse=lse, **opts)
        want, want_lse = ref.attention_split_ref(q, k, v, splits, chunk, **opts)
        whole, whole_lse = ref.attention_lse_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        empty = torch.isneginf(whole_lse)
        err = max(float((out.float() - want.float()).abs().max()),
                  float((lse[~empty] - want_lse[~empty]).abs().max()))
        ok = (torch.equal(torch.isneginf(lse), empty) and torch.equal(torch.isneginf(want_lse), empty)
              and not out[empty].any() and bool(torch.isfinite(out).all())
              and torch.allclose(out.float(), want.float(), **TOL["bfloat16"])
              and torch.allclose(out.float(), whole.float(), **TOL["bfloat16"])
              and torch.allclose(lse[~empty], whole_lse[~empty], **TOL["bfloat16"]))
        print(f"[kernel] flash_attention split decode {label} ({splits} ranges of {chunk} keys) "
              f"bfloat16 max_abs_err={err:.3e} against attention_split_ref (and attention_lse_ref "
              f"within {TOL['bfloat16']['atol']}); {int(empty.sum())} rows with no key "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"split decode {label}: max_abs_err {err:.3e}")
        worst = max(worst, err)
    return worst


def lse_bound_ms(q, k, v) -> tuple[float, str]:
    """Larger of bytes / bandwidth (q, k, v read once, o and the fp32 lse
    written once) and operations / peak (4 D flops a (query, key) pair;
    non-causal decode admits every pair)."""
    B, H, Sq, D = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + 4 * B * H * Sq
    flops = 4 * D * B * H * Sq * k.shape[2]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lse_kernel_phase(torch, dev, failures) -> dict:
    """``flash_attention_lse`` against ``attention_lse_ref`` (the output
    and the fp32 log-sum-exp, rows that admit no key among them) in both
    dtypes, then timed at ``LSE_TIMED`` with a cold L2 (a CUDA graph of
    calls over K/V sets larger than the L2) beside the plain version and
    ``aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True)``,
    which computes the same (o, lse) without softcap and GQA (its K/V are
    given repeated over the query heads)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    cases = [  # label, B, H, KV, Sq, Sk, D, causal, window, softcap
        ("decode gqa 4 D 80", 2, 8, 2, 1, 575, 80, False, 0, 0.0),
        ("decode D 256 softcap 50", 2, 16, 8, 1, 700, 256, False, 0, 50.0),
        ("decode D 64 one key", 2, 4, 2, 1, 1, 64, False, 0, 0.0),
        ("Sq 5 D 128 causal", 1, 8, 2, 5, 40, 128, True, 0, 0.0),
        ("prefill D 80 window 20", 1, 4, 4, 100, 77, 80, False, 20, 0.0),
        ("prefill D 64 rows with no key", 1, 2, 2, 40, 8, 64, True, 4, 0.0),
    ] + [(label, B, H, KV, Sq, Sk, D, causal, window, 0.0)
         for label, B, H, KV, Sq, Sk, D, causal, window in FAMILY_FWD_EDGES]
    worst = 0.0
    for seed, (label, B, H, KV, Sq, Sk, D, causal, window, softcap) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            q = randn(torch, (B, H, Sq, D), dtype, 400 + 3 * seed, dev)
            k = randn(torch, (B, KV, Sk, D), dtype, 401 + 3 * seed, dev)
            v = randn(torch, (B, KV, Sk, D), dtype, 402 + 3 * seed, dev)
            opts = dict(causal=causal, window=window, softcap=softcap)
            out, lse = fa.flash_attention_lse_cuda(q, k, v, **opts)
            want, want_lse = ref.attention_lse_ref(q, k, v, **opts)
            torch.cuda.synchronize()
            empty = torch.isneginf(want_lse)
            lse_err = (lse[~empty] - want_lse[~empty]).abs()
            err = max(float((out.float() - want.float()).abs().max()),
                      float(lse_err.max()) if lse_err.numel() else 0.0)
            ok = (torch.equal(torch.isneginf(lse), empty) and not out[empty].any()
                  and torch.allclose(out.float(), want.float(), **TOL[dtype])
                  and torch.allclose(lse[~empty], want_lse[~empty], **TOL[dtype]))
            print(f"[kernel] flash_attention_lse {label:<30} {dtype:<8} max_abs_err={err:.3e} "
                  f"(out and lse; rtol={TOL[dtype]['rtol']}, atol={TOL[dtype]['atol']}; "
                  f"{int(empty.sum())} rows with no key) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash_attention_lse {label} {dtype}: max_abs_err {err:.3e}")
            worst = max(worst, err) if dtype == "bfloat16" else worst
    worst = max(worst, split_decode_edges(torch, dev, failures))
    worst = max(worst, decode_edges(torch, dev, failures))

    timed = []
    for seed, (label, B, H, KV, Sk, D, softcap) in enumerate(LSE_TIMED):
        q = model_layout(torch, B, H, 1, D, "bfloat16", 500 + seed, dev)
        kv = decode_sets(torch, B, KV, Sk, D, 510 + 10 * seed, dev, s_alloc=Sk)
        n = len(kv)
        reps = H // KV
        # the library call takes K/V with every query head's copy
        lib_kv = [(k.repeat_interleave(reps, 1), v.repeat_interleave(reps, 1))
                  for k, v in kv] if reps > 1 else kv
        kern = lambda i: fa.flash_attention_lse_cuda(q, *kv[i % n], causal=False,  # noqa: E731
                                                     softcap=softcap)
        lib = lambda i: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731
            q, *lib_kv[i % n], None, True)
        iters = 8 * n
        t = {"ms": graph_ms(torch, [lambda i=i: kern(i) for i in range(iters)]),
             "plain_ms": time_ms(torch, lambda: ref.attention_lse_ref(
                 q, *kv[0], causal=False, softcap=softcap), iters=10),
             "library_ms": graph_ms(torch, [lambda i=i: lib(i) for i in range(iters)])}
        t["bound_ms"], t["bound_by"] = lse_bound_ms(q, *kv[0])
        t["splits"], t["split_keys"] = fa._split_plan(q, kv[0][0])
        note = "; library without the softcap: not the same function" if softcap else ""
        split = (f" (keys split {t['splits']} ways, {t['split_keys']} a split; earlier design "
                 f"{EARLIER_GEMMA2['lse']})" if t["splits"] > 1 else " (unsplit)")
        print(f"[time] flash_attention_lse {label} bf16, cold L2{split}: kernel {t['ms']:.4f} ms, "
              f"library (efficient attention, compute_log_sumexp, K/V repeated to the query "
              f"heads{note}) {t['library_ms']:.4f} ms, as CUDA graphs of calls; plain "
              f"{t['plain_ms']:.4f} ms (warm); bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']})")
        timed.append({"shape": f"{label} bf16", **t})
        del q, kv, lib_kv
    return {"name": "flash_attention_lse", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:28",
            "launches": None, "max_abs_err": worst, **timed[0], "gemma2": timed[1]}


# ------------------------------------------------------- attention backward --


def attention_bwd_bound_ms(torch, q, k, *, causal, window, dev) -> tuple[float, str]:
    """Larger of bytes / bandwidth (q, k, v, o, dO read once; dq, dk, dv
    written once) and operations / peak: five products of 2 D flops each
    (q k^T, dO v^T, P^T dO, dS^T q, dS k) per (query, key) pair the mask
    admits."""
    B, H, Sq, D = q.shape
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size()
    flops = 10 * D * B * H * admitted_pairs(torch, Sq, k.shape[2], causal=causal, window=window,
                                            dev=dev)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The backward's cases at every head dim, in attention_bwd_phase and
# scripts/attention_fwd_ab.py --bwd: label, B, H, KV, Sq, Sk, causal,
# window, softcap.
ATTN_BWD_CASES = [
    ("causal", 2, 4, 4, 64, 64, True, 0, 0.0),
    ("gqa 4 ragged S 100 window 16", 1, 8, 2, 100, 100, True, 16, 0.0),
    ("mqa Sq 37 != Sk 70 softcap 50", 1, 4, 1, 37, 70, False, 0, 50.0),
    ("non-causal gqa 2 S 100 window 32", 1, 4, 2, 100, 100, False, 32, 0.0),
    ("causal window 32 softcap 50", 1, 4, 2, 100, 100, True, 32, 50.0),
    ("window 20 masked rows Sq 100 Sk 77", 1, 4, 4, 100, 77, False, 20, 0.0),
]
# The edges of the bf16 kernels' tiles and items (64-key tiles and items
# of 128 query rows in the dq launch, 64 a consumer; items of 64 keys and
# steps of 64 rows in the dkdv launch, whose consumers split an item's
# steps when items are few and walk items of their own when there are 4
# or more an SM: the MHA case below, 4 x 32 x 5 items) and of the scalar
# kernels' 32; GQA 8; and q, k scaled by 4 (a peaked softmax, where dS
# cancels most): label, B, H, KV, Sq, Sk, causal, q / k scale.
ATTN_BWD_EDGES = [
    ("edge S 63", 1, 4, 4, 63, 63, True, 1.0),
    ("edge S 65", 1, 4, 4, 65, 65, True, 1.0),
    ("edge gqa 2 S 127", 1, 4, 2, 127, 127, True, 1.0),
    ("edge gqa 2 S 129", 1, 4, 2, 129, 129, True, 1.0),
    ("edge non-causal Sq 1 Sk 300", 1, 4, 4, 1, 300, False, 1.0),
    ("edge gqa 2 S 257", 1, 4, 2, 257, 257, True, 1.0),
    ("gqa 8 S 129", 1, 8, 1, 129, 129, True, 1.0),
    ("large logits (q, k x 4) gqa 4 S 129", 1, 8, 2, 129, 129, True, 4.0),
    ("mha 32/32 B 4 S 257, dkdv items a consumer", 4, 32, 32, 257, 257, True, 1.0),
]


def attention_bwd_phase(torch, dev, failures) -> dict:
    """The backward kernel's dq, dk, dv against autograd of attention_ref in
    fp32 on the same inputs, then timed at stablelm_3b's train shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def compare(label, q, k, v, dout, dtype, *, causal, window=0, softcap=0.0,
                deterministic=False, regions=None) -> tuple[float, dict]:
        """(largest max abs error, ``regions``' rms readings or {})."""
        opts = dict(causal=causal, window=window, softcap=softcap)
        out = fa.flash_attention_cuda(q, k, v, **opts)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, **opts)
        if deterministic:   # no atomics: a second call gives the same bits
            again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, **opts)
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            print(f"[kernel] flash_attention_bwd {label} {dtype}: two calls bitwise equal "
                  f"(dq, dk, dv): {same}")
            if not same:
                failures.append(f"flash_attention_bwd {label} {dtype}: two calls differ")
        ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.attention_ref(*ref_in, **opts), ref_in, dout.float())
        torch.cuda.synchronize()
        tol = GRAD_TOL[dtype]
        errs = [float((g.float() - w).abs().max()) for g, w in zip(got, want)]
        ok = all(bool(torch.isfinite(g).all()) and g.dtype == t.dtype and g.shape == t.shape
                 and torch.allclose(g.float(), w, **tol) for g, w, t in zip(got, want, (q, k, v)))
        print(f"[kernel] flash_attention_bwd {label:<42} {dtype:<8} max_abs_err dq {errs[0]:.3e} "
              f"dk {errs[1]:.3e} dv {errs[2]:.3e} (rtol={tol['rtol']}, atol={tol['atol']}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention_bwd {label} {dtype}: max_abs_err {max(errs):.3e}")
        rms = {} if regions is None else region_rms_gate(
            torch, f"flash_attention_bwd {label}", got, want, regions, failures)
        return max(errs), rms

    d256 = {"float32": 0.0, "bfloat16": 0.0}   # the worst max abs error of the D 256 cases
    for i, D in enumerate((16, 32, 64, 80, 128, 256)):
        for j, (label, B, H, KV, Sq, Sk, causal, window, softcap) in enumerate(ATTN_BWD_CASES):
            for dtype in ("float32", "bfloat16"):
                seed = 800 + 40 * i + 4 * j
                q = randn(torch, (B, H, Sq, D), dtype, seed, dev)
                k, v = (randn(torch, (B, KV, Sk, D), dtype, seed + n, dev) for n in (1, 2))
                dout = randn(torch, (B, H, Sq, D), dtype, seed + 3, dev)
                err, _ = compare(f"D {D} {label}", q, k, v, dout, dtype, causal=causal,
                                 window=window, softcap=softcap,
                                 deterministic=dtype == "bfloat16")
                if D == 256:
                    d256[dtype] = max(d256[dtype], err)
    for i, D in enumerate((80, 128)):
        for j, (label, B, H, KV, Sq, Sk, causal, scale) in enumerate(ATTN_BWD_EDGES):
            for dtype in ("float32", "bfloat16"):
                seed = 1100 + 40 * i + 4 * j
                q = randn(torch, (B, H, Sq, D), "float32", seed, dev, scale).to(
                    getattr(torch, dtype))
                k = randn(torch, (B, KV, Sk, D), "float32", seed + 1, dev, scale).to(q.dtype)
                v = randn(torch, (B, KV, Sk, D), dtype, seed + 2, dev)
                dout = randn(torch, (B, H, Sq, D), dtype, seed + 3, dev)
                compare(f"D {D} {label}", q, k, v, dout, dtype, causal=causal)
                if scale != 1.0:
                    exact_error_ratios(torch, f"D {D} {label}", q, k, v, dout, dtype,
                                       causal=causal)
    for j, (label, B, H, KV, Sq, Sk, D, causal) in enumerate(FAMILY_BWD_EDGES):
        for dtype in ("float32", "bfloat16"):
            seed = 1200 + 4 * j
            q, dout = (randn(torch, (B, H, Sq, D), dtype, seed + n, dev) for n in (0, 3))
            k, v = (randn(torch, (B, KV, Sk, D), dtype, seed + n, dev) for n in (1, 2))
            compare(f"D {D} {label}", q, k, v, dout, dtype, causal=causal)

    # The train path's shape, in the model's strided layout, in both dtypes.
    H, D = 32, 80
    shape = f"train ({BATCH},{H},{TRAIN_SEQ},{D}) causal"
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/models/layers.py:204 (no Pallas backward: the JAX package "
                         "differentiates this jnp attention, src/repro/train/steps.py:75)",
             "launches": None, "paths": []}
    for dtype in ("bfloat16", "float32"):
        q, k, v, dout = (model_layout(torch, BATCH, H, TRAIN_SEQ, D, dtype, 900 + n, dev)
                         for n in range(4))
        err, _ = compare(shape, q, k, v, dout, dtype, causal=True,
                         deterministic=dtype == "bfloat16")
        t = attention_bwd_timings(torch, q, k, v, dout, dev)
        path = BWD_PATHS[dtype]
        print(f"[time] flash_attention_bwd {shape} {dtype}: kernel {t['ms']:.4f} ms "
              f"({path['route']}: {' + '.join(path['kernels'])}), plain {t['plain_ms']:.4f} ms "
              f"(autograd of attention_ref, backward only), sdpa backward {t['library_ms']:.4f} "
              f"ms, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
        entry["paths"].append({"dtype": dtype, **path, "shape": f"{shape} {dtype}",
                               "max_abs_err": err, **t})
        if dtype == "bfloat16":
            entry.update(max_abs_err=err, shape=f"{shape} bf16", **t)
    entry["d256_cases_max_abs_err"] = d256
    entry[GEMMA2] = gemma2_bwd_timings(torch, dev, compare)
    entry["gemma2_paths"] = gemma2_kernel_paths(torch, dev, failures)
    return entry


def gemma2_kernel_paths(torch, dev, failures) -> dict:
    """The kernels a gemma2 call runs, by name in launch order
    (``kernel_split``, torch.profiler): a bf16 D 256 prefill call through
    either forward entry, the warpgroup prefill (``PREFILL_KERNEL``;
    so do D 64, 80 and 128 calls); a bf16 decode call over a full ring
    and the lse entry over a rank's half cache, the split decode's two
    (``SPLIT_DECODE_KERNELS``, the rule's split); a decode call below D
    256, GQA (qwen2_vl, split) and MHA (stablelm, and its lse entry), one
    launch of ``DECODE_KERNEL``; a bf16 backward call at
    D 256, 80 and 128 the wgmma path's two (``BWD_PATHS``).  Each kernel's
    device ms printed."""
    from repro_torch.kernels import flash_attention as fa

    q = randn(torch, (2, 16, 1, 256), "bfloat16", 1400, dev)
    k, v = (randn(torch, (2, 8, 4096, 256), "bfloat16", 1401 + i, dev) for i in range(2))
    qt, kt, vt, dot = (randn(torch, (1, H, 1024, 256), "bfloat16", 1410 + i, dev)
                       for i, H in enumerate((16, 8, 8, 16)))
    out = fa.flash_attention_cuda(qt, kt, vt, causal=True, softcap=50.0)
    below = {D: tuple(randn(torch, (2, H, 512, D), "bfloat16", 1420 + 10 * D + i, dev)
                      for i, H in enumerate((32, 8, 8))) for D in (64, 80, 128)}
    outs = {D: fa.flash_attention_cuda(*below[D], causal=True) for D in (80, 128)}
    pattern = r"(attn_decode_bf16|attn_decode_merge|attn_decode_tma|attn_bwd_\w+|attn_prefill_\w+)"
    # Below D 256 a decode call is one launch of DECODE_KERNEL, split or
    # not: qwen2_vl's (GQA 7, D 128; its keys split by the rule) and
    # stablelm's (MHA, D 80), the lse entry at a rank's half of stablelm's.
    dec = {name: (randn(torch, (8, H, 1, D), "bfloat16", 1430 + i, dev),
                  *(model_layout(torch, 8, KV, 575, D, "bfloat16", 1431 + i + j, dev, 576)
                    for j in (1, 2)))
           for i, (name, H, KV, D) in enumerate((("qwen2_vl", 28, 4, 128), ("stablelm", 32, 32, 80)))}
    checks = [
        ("prefill (1,16,1024,256) kv 8 causal window 512 softcap 50", [PREFILL_KERNEL],
         lambda: fa.flash_attention_cuda(qt, kt, vt, causal=True, window=512, softcap=50.0)),
        ("lse entry, prefill (1,16,1024,256) kv 8 causal softcap 50", [PREFILL_KERNEL],
         lambda: fa.flash_attention_lse_cuda(qt, kt, vt, causal=True, softcap=50.0)),
        *[(f"(not gemma2) {entry}prefill (2,32,512,{D}) kv 8 causal, below D 256",
           [PREFILL_KERNEL], lambda D=D, fn=fn: fn(*below[D], causal=True))
          for D in (64, 80, 128)
          for entry, fn in (("", fa.flash_attention_cuda), ("lse entry, ", fa.flash_attention_lse_cuda))],
        ("decode ring (2,16,1,256) kv 8 Sk 4096", SPLIT_DECODE_KERNELS,
         lambda: fa.flash_attention_cuda(q, k, v, causal=False, softcap=50.0)),
        ("lse entry, half a global cache (2,16,1,256) kv 8 Sk 2592", SPLIT_DECODE_KERNELS,
         lambda: fa.flash_attention_lse_cuda(q, k[:, :, :2592], v[:, :, :2592], causal=False,
                                             softcap=50.0)),
        ("(not gemma2) qwen2_vl decode (8,28,1,128) kv 4 Sk 575, its keys split "
         f"{fa._split_plan(dec['qwen2_vl'][0], dec['qwen2_vl'][1])[0]} ways", [DECODE_KERNEL],
         lambda: fa.flash_attention_cuda(*dec["qwen2_vl"], causal=False)),
        ("(not gemma2) stablelm decode (8,32,1,80) Sk 575", [DECODE_KERNEL],
         lambda: fa.flash_attention_cuda(*dec["stablelm"], causal=False)),
        ("(not gemma2) lse entry, stablelm's half cache (8,32,1,80) Sk 288", [DECODE_KERNEL],
         lambda: fa.flash_attention_lse_cuda(dec["stablelm"][0], dec["stablelm"][1][:, :, :288],
                                             dec["stablelm"][2][:, :, :288], causal=False)),
        ("backward (1,16,1024,256) kv 8 causal softcap 50", BWD_PATHS["bfloat16"]["kernels"],
         lambda: fa.flash_attention_bwd_cuda(qt, kt, vt, out, dot, causal=True, softcap=50.0)),
        *[(f"(not gemma2) backward (2,32,512,{D}) kv 8 causal, below D 256",
           BWD_PATHS["bfloat16"]["kernels"],
           lambda D=D: fa.flash_attention_bwd_cuda(*below[D], outs[D], below[D][0], causal=True))
          for D in (80, 128)],
    ]
    seen = {}
    for label, want, fn in checks:
        split, tries = kernel_split(torch, fn, pattern, want)
        names = [name for name, _ in split]
        ok = names == want
        print(f"[kernel] gemma2 {label}: kernels " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in split) + f" ({tries} profiled call(s); want "
            f"{' then '.join(want)}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"gemma2 {label} ran {names}, expected {want}")
        seen[label] = split
    return seen


def gemma2_bwd_timings(torch, dev, compare) -> dict:
    """The backward at gemma2_9b's train shapes, bf16 (1,16,8192,256) KV 8
    softcap 50, in the model's layout: the global layer (causal) and the
    local one (causal, window 4096), each held against autograd of
    attention_ref (``compare``, two calls bitwise equal; and each of dq,
    dk, dv at a relative rms of ATTN_D256_TRAIN_REL_RMS over all rows and
    keys and over each side of the window, ``region_rms_gate``), then timed
    beside its bound, the plain version's backward and SDPA's backward
    without softcap or window (not the same function), with the backend
    SDPA took."""
    H, KV, D, S, W, cap = 16, 8, 256, GEMMA2_TRAIN_SEQ, 4096, 50.0
    # At S = 2 W the local layer's window bites at query rows >= W (their
    # keys start at row - W + 1) and at keys < S - W (their rows end at
    # key + W - 1): each side gated on its own, so a fault confined to it
    # is not diluted by the rest of the tensor.
    regions = [("all", slice(None), slice(None)),
               (f"rows < {W}, keys < {S - W}", slice(0, W), slice(0, S - W)),
               (f"rows >= {W}, keys >= {S - W}", slice(W, S), slice(S - W, S))]
    out = {}
    for label, window, seed in (("global", 0, 1300), ("local", W, 1310)):
        q, dout = (model_layout(torch, 1, H, S, D, "bfloat16", seed + n, dev) for n in (0, 3))
        k, v = (model_layout(torch, 1, KV, S, D, "bfloat16", seed + n, dev) for n in (1, 2))
        shape = (f"gemma2 {label} (1,{H},{S},{D}) kv {KV} causal"
                 f"{f' window {window}' if window else ''} softcap {cap:g}")
        err, rms = compare(shape, q, k, v, dout, "bfloat16", causal=True, window=window,
                           softcap=cap, deterministic=True, regions=regions)
        t = attention_bwd_timings(torch, q, k, v, dout, dev, window=window, softcap=cap)
        path = BWD_PATHS["bfloat16"]
        print(f"[time] flash_attention_bwd {shape} bfloat16: kernel {t['ms']:.4f} ms "
              f"({path['route']}: {' + '.join(path['kernels'])}; earlier design "
              f"{EARLIER_GEMMA2[label]}), bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
              f"{t['ms'] / t['bound_ms']:.2f}x), plain {t['plain_ms']:.4f} ms (autograd of "
              f"attention_ref, backward only), sdpa backward {t['library_ms']:.4f} ms "
              f"({t['library_note']}; backend {t['sdpa_backend']})")
        out[label] = {"shape": f"{shape} bf16", "max_abs_err": err, **rms, **t}
        del q, k, v, dout
        torch.cuda.empty_cache()
    return out


def region_rms_gate(torch, label, got, want, regions, failures) -> dict:
    """Each of dq, dk, dv against autograd of attention_ref in fp32, as a
    relative rms over each region (name, query rows of dq, keys of dk and
    dv, along dim 2), gated at ATTN_D256_TRAIN_REL_RMS; prints each
    reading beside the reference gradient's own rms.  Returns {"rel_rms":
    {region: [dq, dk, dv]}, "grad_rms": {region: [dq, dk, dv]},
    "rel_rms_limit": the limit}."""
    limit = ATTN_D256_TRAIN_REL_RMS
    readings = {"rel_rms": {}, "grad_rms": {}, "rel_rms_limit": limit}
    for name, rows, keys in regions:
        parts = [(g[:, :, sl].float(), w[:, :, sl])
                 for g, w, sl in zip(got, want, (rows, keys, keys))]
        rel = [rel_rms(torch, g, w) for g, w in parts]
        own = [float(w.double().square().mean().sqrt()) for _, w in parts]
        ok = max(rel) <= limit
        print(f"[kernel] {label} {name}: rel rms dq {rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e} "
              f"(gradient rms {own[0]:.3e} / {own[1]:.3e} / {own[2]:.3e}; rel rms <= {limit}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} {name}: rel rms {max(rel):.3e} > {limit}")
        readings["rel_rms"][name] = rel
        readings["grad_rms"][name] = own
    return readings


def exact_error_ratios(torch, label, q, k, v, dout, dtype, *, causal):
    """Information: the kernel's dq, dk, dv and autograd of attention_ref in
    fp32, each against the gradient in fp64 (the same function written in
    float64), as err / (atol + rtol |exact|) at GRAD_TOL: where the fp32
    reference's own error is a visible share of the tolerance."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def attention_fp64(q, k, v):
        group = q.shape[1] // k.shape[1]
        kf, vf = (t.repeat_interleave(group, dim=1) for t in (k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", q, kf) / math.sqrt(q.shape[-1])
        if causal:
            qp = torch.arange(q.shape[2], device=q.device)[:, None]
            s = s.masked_fill(torch.arange(k.shape[2], device=q.device)[None, :] > qp,
                              float("-inf"))
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vf)

    tol = GRAD_TOL[dtype]
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, causal=causal)
    x64 = [t.detach().double().requires_grad_() for t in (q, k, v)]
    exact = torch.autograd.grad(attention_fp64(*x64), x64, dout.double())
    x32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    fp32 = torch.autograd.grad(ref.attention_ref(*x32, causal=causal), x32, dout.float())

    def ratios(grads):
        return " ".join(
            f"{float(((g.double() - e).abs() / (tol['atol'] + tol['rtol'] * e.abs())).max()):.3f}"
            for g, e in zip(grads, exact))

    print(f"[kernel] flash_attention_bwd {label:<42} {dtype:<8} against the fp64 gradient, err / "
          f"tol (dq dk dv): kernel {ratios(got)}, fp32 autograd of attention_ref "
          f"{ratios(fp32)} (information)")


def attention_bwd_timings(torch, q, k, v, dout, dev, *, window=0, softcap=0.0) -> dict:
    """The backward kernel, the plain version's backward (autograd of
    attention_ref, its graph built once) and SDPA's backward, causal, at
    one shape, and the bound.  SDPA has no window or softcap argument:
    with either, it is timed without them (``library_note``), and is not
    the same function; ``sdpa_backend`` names the backend its kernels
    show it took."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    opts = dict(causal=True, window=window, softcap=softcap)
    big = q.shape[2] * k.shape[2] > 2**24   # the plain version's scores take GBs: fewer calls
    out = fa.flash_attention_cuda(q, k, v, **opts)
    ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
    ref_out = ref.attention_ref(*ref_in, **opts)
    sdpa_in = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in, is_causal=True,
                                              enable_gqa=q.shape[1] != k.shape[1])
    sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, sdpa_in, dout,  # noqa: E731
                                           retain_graph=True)
    t = {
        "ms": time_ms(torch, lambda: fa.flash_attention_bwd_cuda(q, k, v, out, dout, **opts),
                      iters=10),
        "plain_ms": time_ms(torch, lambda: torch.autograd.grad(ref_out, ref_in, dout,
                                                               retain_graph=True),
                            iters=2 if big else 5, reps=3),
        "library_ms": time_ms(torch, sdpa_bwd, iters=10),
    }
    del ref_out, ref_in
    if window or softcap:
        t["library_note"] = ("SDPA causal without the "
                             + " and ".join(w for w, on in (("window", window),
                                                            ("softcap", softcap)) if on)
                             + ": not the same function")
        t["sdpa_backend"] = sdpa_backend(torch, sdpa_bwd)
    t["bound_ms"], t["bound_by"] = attention_bwd_bound_ms(torch, q, k, causal=True,
                                                          window=window, dev=dev)
    return t


def sdpa_backend(torch, fn) -> str:
    """Which SDPA backend ``fn`` ran, from the names of its CUDA kernels
    under torch.profiler, with the longest kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    names = " ".join(e.key.lower() for e in kernels)
    backend = ("cudnn" if "cudnn" in names else "flash" if "flash" in names else
               "memory-efficient" if "fmha" in names or "efficient" in names else "math")
    return f"{backend}, longest kernel {kernels[0].key[:60]!r}" if kernels else "no kernel"


# ----------------------------------------------- SSD and mLSTM backwards --

BF16_GRAD_REL_RMS = 2e-2   # a backward's gradient in bf16, against autograd of the plain version
# The attention backward's gradients at gemma2's train shapes, per region
# (``region_rms_gate``).  Rounding the exact gradient to bf16 alone gives
# a relative rms of ~1.7e-3, and a kernel that keeps its products' error
# below that reads about the same.  A window edge off by one key moves dq
# past the window by a relative rms that falls as ~1/sqrt(window), below
# BF16_GRAD_REL_RMS at 4096; tests/test_torch_flash_attention.py holds
# both sides of this limit at windows 512 and 1024.
ATTN_D256_TRAIN_REL_RMS = 5e-3
# The SSD backward's two paths, chosen by dtype alone.
SSD_BWD_PATHS = {
    "bfloat16": {"route": "warpgroup wgmma on TMA tiles, chunks over cluster blocks",
                 "kernels": ["ssd_bwd_gsum", "ssd_bwd_wgmma"]},
    "float32": {"route": "scalar fp32 FMA", "kernels": ["ssd_bwd", "ssd_bwd_reduce"]},
}
# The mLSTM backward's two paths, chosen by dtype alone.
MLSTM_BWD_PATHS = {
    "bfloat16": {"route": "tensor cores (mma.sync bf16)",
                 "kernels": ["mlstm_bwd_states_bf16", "mlstm_bwd_chunk_bf16",
                             "mlstm_bwd_dstates_bf16", "mlstm_bwd_out_bf16",
                             "mlstm_bwd_gates_bf16"]},
    "float32": {"route": "scalar fp32 FMA",
                "kernels": ["mlstm_bwd_states", "mlstm_bwd_main", "mlstm_bwd_reduce_qk",
                            "mlstm_bwd_reduce_gates"]},
}


def kernel_split(torch, fn, pattern, want, tries=5) -> tuple[list[tuple[str, float]], int]:
    """(name, device ms) of each kernel of one call of ``fn`` whose name
    matches ``pattern`` (its first group), in launch order, by
    torch.profiler; and the number of calls profiled.  While the record's
    names differ from ``want`` the call is profiled again, ``tries`` in
    all, before the caller holds the names against ``want``.  The
    profiler on the card has returned records that lack a call's first
    kernels, on one machine in every try: a kernel that starts near the
    opening of the profiled window, or the window's first kernel, can be
    left out.  So a throwaway kernel opens the window, and the call runs
    with the card idle and a margin of host time on each side of it, a
    margin that grows with each try."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        margin_s = 0.05 * attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            time.sleep(margin_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin_s)
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        split = [(m.group(1), e.self_device_time_total / 1e3) for e in events
                 for m in [re.search(pattern, e.name)] if m]
        if [name for name, _ in split] == want:
            break
    return split, attempt


def grad_check(torch, label, got, want, inputs, dtype, failures, exact=None,
               gate_exact=False) -> float:
    """A backward kernel's gradients against autograd of the plain version
    in fp32 on the same inputs.  fp32: each gradient within a relative rms
    of GRAD_REL_RMS and a max abs error of GRAD_REL_RMS times its largest
    entry.  Elementwise rtol/atol 1e-4 is not the gate: where an entry is
    small because its terms cancel, two fp32 summation orders differ by
    more, and the fp32 plain version itself misses it against the fp64
    gradient at the train shapes (``exact``: that gradient; each
    implementation's largest err / (1e-4 + 1e-4 |exact|) is printed).
    ``gate_exact``: at the shapes where the plain version meets that bound
    (ROADMAP C2), the kernel must meet it too, elementwise.  bf16: a
    relative rms of BF16_GRAD_REL_RMS.  Every gradient finite, in its
    input's dtype and shape.  Returns the largest max abs error."""
    errs = [float((g.float() - w).abs().max()) for g, w in zip(got, want)]
    rms = [rel_rms(torch, g.float(), w) for g, w in zip(got, want)]
    ok = all(bool(torch.isfinite(g).all()) and g.dtype == t.dtype and g.shape == t.shape
             for g, t in zip(got, inputs))
    if dtype == "float32":
        rel_max = [e / max(float(w.abs().max()), 1e-30) for e, w in zip(errs, want)]
        ok = ok and max(rms) <= GRAD_REL_RMS and max(rel_max) <= GRAD_REL_RMS
        limit = f"rel rms and max abs / max |want| <= {GRAD_REL_RMS}"
    else:
        ok = ok and max(rms) <= BF16_GRAD_REL_RMS
        limit = f"rel rms <= {BF16_GRAD_REL_RMS}"
    print(f"[kernel] {label:<58} {dtype:<8} max_abs_err "
          + " ".join(f"{e:.2e}" for e in errs) + " rel rms " + " ".join(f"{r:.1e}" for r in rms)
          + f" ({limit}) {'ok' if ok else 'FAIL'}")
    if exact is not None:
        def ratios(grads):
            return [float(((g.double() - e).abs() / (1e-4 + 1e-4 * e.abs())).max())
                    for g, e in zip(grads, exact)]

        mine = ratios(got)
        exact_ok = max(mine) <= 1.0
        print(f"[kernel] {label:<58} {dtype:<8} against the fp64 gradient, err / (1e-4 + 1e-4 "
              f"|exact|) at worst: kernel " + " ".join(f"{r:.2f}" for r in mine) + "; fp32 plain "
              + " ".join(f"{r:.2f}" for r in ratios(want))
              + (f" (C2 gate: kernel <= 1) {'ok' if exact_ok else 'FAIL'}" if gate_exact
                 else " (information)"))
        if gate_exact and not exact_ok:
            failures.append(f"{label} {dtype}: err / (1e-4 + 1e-4 |exact|) {max(mine):.2f} > 1 "
                            f"against the fp64 gradient")
    if not ok:
        failures.append(f"{label} {dtype}: max_abs_err {max(errs):.3e}, rel rms {max(rms):.3e}")
    return max(errs)


def ssd_bwd_bound_ms(x, N, chunk) -> tuple[float, str]:
    """Larger of bytes / bandwidth (x, dy, dt, A, B, C read once; dx, ddt,
    dA, dB, dC written once) and operations / peak: Q^2 (3N + 2P) on the
    lower triangle (C B^T, dy x^T, W^T dy, E B, E^T C) and 10 Q N P (the
    states, dS^T B, dS x, S_p dy, the dS update) per (b, h, chunk)."""
    B, S, H, P = x.shape
    e = x.element_size()
    nbytes = (3 * x.numel() + 4 * B * S * N) * e + 4 * (2 * B * S * H + 2 * H)
    flops = (chunk * chunk * (3 * N + 2 * P) + 10 * chunk * N * P) * B * H * -(-S // chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bwd_phase(torch, dev, failures) -> dict:
    """The SSD backward's dx, ddt, dA, dB, dC against autograd of
    ssd_chunked in fp32 on the same inputs (ssd_ref where S is ragged or
    the unmasked exp would overflow), then timed at zamba2_1p2b's train
    shape, two bf16 calls there bitwise equal."""
    from repro_torch.kernels import ref, ssd

    def plain(args, dy, dfinal, chunk, oracle, wide):
        t = [(a.detach().double() if wide else a.detach().float()).requires_grad_()
             for a in args]
        y, st = oracle(*t) if oracle else ref.ssd_chunked(*t, chunk)
        outs, cots = [y], [dy.to(y.dtype)]
        if dfinal is not None:
            outs.append(st)
            cots.append(dfinal.to(st.dtype))
        return torch.autograd.grad(outs, t, cots)

    def compare(label, args, dy, dfinal, chunk, dtype, oracle=None, c2=False) -> float:
        got = ssd.ssd_scan_bwd_cuda(*args, dy, dfinal, chunk=chunk)
        want = plain(args, dy, dfinal, chunk, oracle, False)
        exact = plain(args, dy, dfinal, chunk, oracle, True) if dtype == "float32" else None
        torch.cuda.synchronize()
        return grad_check(torch, f"ssd_bwd {label}", got, want, args, dtype, failures, exact,
                          gate_exact=c2)

    # label, B, S, H, P, N, chunk, final-state cotangent, model layout, oracle;
    # C2 marks the shapes where the fp32 kernel is held elementwise to the fp64
    # gradient (ROADMAP C2).
    cases = [
        ("(1,64,2,16) N 8 chunk 16", 1, 64, 2, 16, 8, 16, False, False, None),
        ("(2,128,3,16) N 8 chunk 32 +dfinal", 2, 128, 3, 16, 8, 32, True, False, None),
        ("(1,128,1,32) N 16 chunk 64 C2", 1, 128, 1, 32, 16, 64, False, False, None),
        ("(2,96,2,8) N 4 chunk 32", 2, 96, 2, 8, 4, 32, False, False, None),
        ("(1,40,2,4) N 4 chunk 4", 1, 40, 2, 4, 4, 4, False, False, None),
        ("(2,64,3,8) N 8 chunk 16 +dfinal", 2, 64, 3, 8, 8, 16, True, False, None),
        ("ragged S 100 chunk 32 vs ssd_ref +dfinal", 1, 100, 2, 16, 8, 32, True, False, "ref"),
        ("S 5 < chunk 8 vs ssd_ref", 2, 5, 2, 16, 8, 8, False, False, "ref"),
        ("(1,37,3,12) N 20 chunk 12 vs ssd_ref", 1, 37, 3, 12, 20, 12, False, False, "ref"),
        ("strided model layout (2,96,2,64) N 64 chunk 32", 2, 96, 2, 64, 64, 32, False, True,
         None),
        ("zamba2 widths ragged S 200 chunk 128 +dfinal C2", 2, 200, 4, 64, 64, 128, True, True,
         "ref"),
    ]
    for n, (label, B, S, H, P, N, chunk, with_final, ml, oracle) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            seed = 1300 + 10 * n
            args = ssd_inputs(torch, B, S, H, P, N, dtype, seed, dev, model_layout=ml)
            dy = randn(torch, (B, S, H, P), dtype, seed + 5, dev)
            dfinal = randn(torch, (B, H, N, P), "float32", seed + 6, dev) if with_final else None
            compare(label, args, dy, dfinal, chunk, dtype, ref.ssd_ref if oracle else None,
                    c2=label.endswith(" C2"))
    with phase_wall("kernels ssd backward bf16 edges"):
        for n, (label, B, S, H, P, N, chunk, with_final, ml, oracle) in enumerate(SSD_EDGES):
            args = ssd_inputs(torch, B, S, H, P, N, "bfloat16", 1500 + 10 * n, dev,
                              model_layout=ml)
            dy = randn(torch, (B, S, H, P), "bfloat16", 1505 + 10 * n, dev)
            dfinal = (randn(torch, (B, H, N, P), "float32", 1506 + 10 * n, dev)
                      if with_final else None)
            compare(label + (" +dfinal" if with_final else ""), args, dy, dfinal, chunk,
                    "bfloat16", ref.ssd_ref if oracle else None)
    # dt 0.8, A -1: a chunk of 128 spans a log-decay of ~100, past fp32's exp
    # range above the diagonal; autograd of the unmasked where(mask, exp, 0)
    # would be NaN there.  The gradient is finite and equals ssd_ref's.
    for dtype in ("float32", "bfloat16"):
        x, _, _, Bm, Cm = ssd_inputs(torch, 1, 256, 2, 8, 4, dtype, 1450, dev)
        dt = torch.full((1, 256, 2), 0.8, device=dev)
        A = torch.tensor([-1.0, -0.5], device=dev)
        dy = randn(torch, (1, 256, 2, 8), dtype, 1451, dev)
        compare("chunk 128, log-decay span ~100 vs ssd_ref", (x, dt, A, Bm, Cm), dy, None, 128,
                dtype, ref.ssd_ref)

    shape = f"train ({BATCH},{TRAIN_SEQ},64,64) N 64 chunk 128"
    entry = {"name": "ssd_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
             "replaces": "src/repro/models/ssm.py:170 (no Pallas backward: the JAX package "
                         "differentiates this jnp ssd_chunked, src/repro/train/steps.py:75)",
             "launches": None, "paths": []}
    for dtype in ("bfloat16", "float32"):
        args = ssd_inputs(torch, BATCH, TRAIN_SEQ, 64, 64, 64, dtype, 1460, dev,
                          model_layout=True)
        dy = randn(torch, (BATCH, TRAIN_SEQ, 64, 64), dtype, 1465, dev)
        err = compare(shape, args, dy, None, 128, dtype)
        if dtype == "bfloat16":
            a, b = (ssd.ssd_scan_bwd_cuda(*args, dy, chunk=128) for _ in range(2))
            same = all(bool(torch.equal(u, v)) for u, v in zip(a, b))
            print(f"[kernel] ssd_bwd {shape} bf16: two calls bitwise equal: {same}")
            if not same:
                failures.append("ssd_bwd: two bf16 calls at the train shape differ")
            del a, b
        t_in = [a.detach().float().requires_grad_() for a in args]
        y_plain = ref.ssd_chunked(*t_in, 128)[0]
        t = {"ms": time_ms(torch, lambda: ssd.ssd_scan_bwd_cuda(*args, dy, chunk=128), iters=5,
                           reps=3),
             "plain_ms": time_ms(torch, lambda: torch.autograd.grad(y_plain, t_in, dy.float(),
                                                                    retain_graph=True),
                                 iters=2, reps=3),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = ssd_bwd_bound_ms(args[0], 64, 128)
        path = SSD_BWD_PATHS[dtype]
        print(f"[time] ssd_bwd {shape} {dtype}: kernel {t['ms']:.4f} ms ({path['route']}: "
              f"{' + '.join(path['kernels'])}), plain {t['plain_ms']:.4f} ms (autograd of "
              f"ssd_chunked, backward only), no single PyTorch call, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
        entry["paths"].append({"dtype": dtype, **path, "shape": f"{shape} {dtype}",
                               "max_abs_err": err, **t})
        if dtype == "bfloat16":
            entry.update(max_abs_err=err, shape=f"{shape} bf16", **t)
        del y_plain, t_in, args, dy
        torch.cuda.empty_cache()
    return entry


def mlstm_bwd_bound_ms(q, chunk) -> tuple[float, str]:
    """Larger of bytes / bandwidth (q, k, v, dh and both gates read once;
    dq, dk, dv and the gates' gradients written once) and operations / peak:
    5 Q^2 D on the lower triangle (q k^T, dnum v^T, P^T dnum, dqk k,
    dqk^T q) and 12 Q D^2 (the states, S_p dnum, q S_p, dS v, dS^T k, the
    dS update) per (b, h, chunk)."""
    B, S, H, D = q.shape
    nbytes = (7 * q.numel() + 4 * B * S * H) * q.element_size()
    flops = (5 * chunk * chunk * D + 12 * chunk * D * D) * B * H * -(-S // chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def floor_share(torch, q, k, ig, fg) -> float:
    """Share of rows whose normaliser max(|den|, e^{-m}) takes the floor
    e^{-m}, for one chunk (S <= chunk), from the forward's formulas."""
    import torch.nn.functional as F

    D = q.shape[-1]
    qq, kk = q.float() / math.sqrt(D), k.float()
    b = torch.cumsum(F.logsigmoid(fg.float()), dim=1)                  # (B,S,H)
    diff = b[:, :, None, :] - b[:, None, :, :] + ig.float()[:, None, :, :]
    S = q.shape[1]
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device))
    diff = diff.masked_fill(~mask[None, :, :, None], float("-inf"))
    m = diff.amax(dim=2)
    den = (torch.einsum("bihd,bjhd->bijh", qq, kk) * torch.exp(diff - m[:, :, None, :])).sum(2)
    return float((den.abs() < torch.exp(-m)).float().mean())


def mlstm_bwd_phase(torch, dev, failures) -> dict:
    """The mLSTM backward's dq, dk, dv, d i_gate, d f_gate against autograd
    of mlstm_chunked in fp32 on the same inputs (mlstm_ref where S is
    ragged), then timed at xlstm_125m's train shape, two bf16 calls there
    bitwise equal."""
    from repro_torch.kernels import mlstm, ref

    def plain(args, dh, chunk, oracle, wide):
        t = [(a.detach().double() if wide else a.detach().float()).requires_grad_()
             for a in args]
        out = oracle(*t)[0] if oracle else ref.mlstm_chunked(*t, chunk)[0]
        return torch.autograd.grad(out, t, dh.to(out.dtype))

    def compare(label, args, dh, chunk, dtype, oracle=None) -> float:
        got = mlstm.mlstm_scan_bwd_cuda(*args, dh, chunk=chunk)
        want = plain(args, dh, chunk, oracle, False)
        exact = plain(args, dh, chunk, oracle, True) if dtype == "float32" else None
        torch.cuda.synchronize()
        return grad_check(torch, f"mlstm_bwd {label}", got, want, args, dtype, failures, exact,
                          gate_exact=label.endswith(" C2"))

    cases = [  # label, B, S, H, D, chunk, gate scale, model layout, oracle
        ("(1,64,2,16) chunk 16", 1, 64, 2, 16, 16, None, False, None),
        ("(2,128,2,16) chunk 32", 2, 128, 2, 16, 32, None, False, None),
        ("(1,96,1,32) chunk 32", 1, 96, 1, 32, 32, None, False, None),
        ("(2,64,2,8) chunk 16", 2, 64, 2, 8, 16, None, False, None),
        ("(2,48,2,12) chunk 16", 2, 48, 2, 12, 16, None, False, None),
        ("(1,40,2,20) chunk 8", 1, 40, 2, 20, 8, None, False, None),
        ("(1,96,3,64) chunk 32", 1, 96, 3, 64, 32, None, False, None),
        ("(1,128,2,96) chunk 64", 1, 128, 2, 96, 64, None, False, None),
        ("ragged S 100 chunk 32 vs mlstm_ref", 2, 100, 2, 16, 32, None, False, "ref"),
        ("S 5 < chunk 8 vs mlstm_ref", 2, 5, 2, 32, 8, None, False, "ref"),
        ("strided gates (2,64,4,32) chunk 16", 2, 64, 4, 32, 16, None, True, None),
        ("ragged S 200 D 384 chunk 128 vs mlstm_ref C2", 1, 200, 2, 384, 128, None, False,
         "ref"),
        ("(1,256,1,512) chunk 128", 1, 256, 1, 512, 128, None, False, None),
    ] + [(f"gates +-20 (1,32,1,8) chunk 8 #{i}", 1, 32, 1, 8, 8, 20.0, False, None)
         for i in range(3)]
    for n, (label, B, S, H, D, chunk, gs, ml, oracle) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            seed = 1500 + 10 * n
            args = mlstm_inputs(torch, B, S, H, D, dtype, seed, dev, gate_scale=gs,
                                model_layout=ml)
            dh = randn(torch, (B, S, H, D), dtype, seed + 5, dev)
            compare(label, args, dh, chunk, dtype, ref.mlstm_ref if oracle else None)
    # The e^{-m} floor of the normaliser winning: small q, k and an input
    # gate near -6 keep |den| below e^{-m} on most rows, where den takes no
    # gradient.
    for dtype in ("float32", "bfloat16"):
        q, k, v, ig, fg = mlstm_inputs(torch, 1, 32, 2, 16, "float32", 1700, dev)
        q, k, ig = q * 0.1, k * 0.1, ig - 6.0
        args = tuple(t.to(getattr(torch, dtype)) for t in (q, k, v, ig, fg))
        share = floor_share(torch, *args[:2], *args[3:])
        dh = randn(torch, (1, 32, 2, 16), dtype, 1705, dev)
        compare(f"floor e^-m wins on {share:.0%} of rows (1,32,2,16) chunk 32", args, dh, 32,
                dtype)
        if share == 0.0:
            failures.append("mlstm_bwd: the floor case never reached the e^{-m} branch")

    shape = f"train ({BATCH},{TRAIN_SEQ},4,384) chunk 128"
    entry = {"name": "mlstm_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/mlstm_bwd.cu",
             "replaces": "src/repro/models/xlstm.py:159 (no Pallas backward: the JAX package "
                         "differentiates this jnp mlstm_chunked, src/repro/train/steps.py:75)",
             "launches": None, "paths": []}
    for dtype in ("bfloat16", "float32"):
        args = mlstm_inputs(torch, BATCH, TRAIN_SEQ, 4, 384, dtype, 1710, dev, model_layout=True)
        dh = randn(torch, (BATCH, TRAIN_SEQ, 4, 384), dtype, 1715, dev)
        err = compare(shape, args, dh, 128, dtype)
        if dtype == "bfloat16":
            a, b = (mlstm.mlstm_scan_bwd_cuda(*args, dh, chunk=128) for _ in range(2))
            same = all(bool(torch.equal(u, v)) for u, v in zip(a, b))
            print(f"[kernel] mlstm_bwd {shape} bf16: two calls bitwise equal: {same}")
            if not same:
                failures.append("mlstm_bwd: two bf16 calls at the train shape differ")
            del a, b
        t_in = [a.detach().float().requires_grad_() for a in args]
        h_plain = ref.mlstm_chunked(*t_in, 128)[0]
        t = {"ms": time_ms(torch, lambda: mlstm.mlstm_scan_bwd_cuda(*args, dh, chunk=128),
                           iters=3, reps=3),
             "plain_ms": time_ms(torch, lambda: torch.autograd.grad(h_plain, t_in, dh.float(),
                                                                    retain_graph=True),
                                 iters=2, reps=3),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = mlstm_bwd_bound_ms(args[0], 128)
        path = MLSTM_BWD_PATHS[dtype]
        print(f"[time] mlstm_bwd {shape} {dtype}: kernel {t['ms']:.4f} ms ({path['route']}: "
              f"{' + '.join(path['kernels'])}), plain {t['plain_ms']:.4f} "
              f"ms (autograd of mlstm_chunked, backward only), no single PyTorch call, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
        split, profiled = kernel_split(
            torch, lambda: mlstm.mlstm_scan_bwd_cuda(*args, dh, chunk=128),
            r"(mlstm_bwd_\w+)", path["kernels"])
        print(f"[time] mlstm_bwd {shape} {dtype}: one call by kernel (profiler, record "
              f"{profiled}): " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in split))
        if [name for name, _ in split] != path["kernels"]:
            failures.append(f"mlstm_bwd {dtype}: a call ran {[n for n, _ in split]}, expected "
                            f"{path['kernels']}")
        entry["paths"].append({"dtype": dtype, **path, "shape": f"{shape} {dtype}",
                               "max_abs_err": err, **t,
                               "ms_by_kernel": {name: ms for name, ms in split}})
        if dtype == "bfloat16":
            entry.update(max_abs_err=err, shape=f"{shape} bf16", **t)
        del h_plain, t_in, args, dh
        torch.cuda.empty_cache()
    return entry


# --------------------------------------------------------------------- ssd --


def ssd_inputs(torch, B, S, H, P, N, dtype, seed, dev, *, model_layout=False):
    """x, dt, A, B, C on the card: x/B/C in ``dtype``, dt post-softplus and
    A negative in fp32, as the model makes them.  ``model_layout``: x, B
    and C are slices of one (B,S,H*P+2N) tensor, as ``mamba2_block``
    passes them."""
    import torch.nn.functional as F

    if model_layout:
        xbc = randn(torch, (B, S, H * P + 2 * N), dtype, seed, dev)
        xs, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
        x = xs.reshape(B, S, H, P)
    else:
        x = randn(torch, (B, S, H, P), dtype, seed, dev)
        Bm = randn(torch, (B, S, N), dtype, seed + 3, dev)
        Cm = randn(torch, (B, S, N), dtype, seed + 4, dev)
    dt = F.softplus(randn(torch, (B, S, H), "float32", seed + 1, dev))
    A = -torch.exp(randn(torch, (H,), "float32", seed + 2, dev, 0.5))
    return x, dt, A, Bm, Cm


def ssd_bound_ms(x, dt, A, Bm, Cm, chunk) -> tuple[float, str]:
    """Larger of bytes / bandwidth (x, dt, A, B, C read once; y and the fp32
    final state written once) and operations / peak: 2 Q (Q N + Q P + 2 N P)
    per (b, h, chunk)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    e = x.element_size()
    nbytes = (2 * x.numel() + Bm.numel() + Cm.numel()) * e + 4 * (dt.numel() + A.numel()
                                                                  + B * H * N * P)
    flops = 2 * chunk * (chunk * N + chunk * P + 2 * N * P) * B * H * -(-S // chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The bf16 kernels' plans at their edges (label, B, S, H, P, N, chunk,
# final-state cotangent (backward), model layout, ragged: ssd_ref): nc > 8
# with a ragged last chunk (clusters of blocks of several chunks), H 3, 5
# and 7 (head groups that do not divide H), S < chunk, and a view TMA
# cannot describe (rows of 24 bytes, loaded by plain loads).
SSD_EDGES = [
    ("nc 35 ragged (1,1100,3,16) N 8 chunk 32 vs ssd_ref", 1, 1100, 3, 16, 8, 32, True, False,
     True),
    ("H 5 (1,256,5,32) N 16 chunk 64", 1, 256, 5, 32, 16, 64, False, False, False),
    ("H 7 (2,384,7,64) N 64 chunk 128 model layout", 2, 384, 7, 64, 64, 128, True, True, False),
    ("H 3 S 5 < chunk 8 vs ssd_ref", 2, 5, 3, 16, 8, 8, True, False, True),
    ("no TMA view (1,37,3,12) N 20 chunk 12 vs ssd_ref", 1, 37, 3, 12, 20, 12, False, False,
     True),
]
# The kernels a call of each path launches, in order, by profiler name.
SSD_KERNELS = {("bfloat16", "forward"): ["ssd_fwd_wgmma"],
               ("bfloat16", "backward"): ["ssd_bwd_wgmma", "ssd_bwd_gsum"],
               ("float32", "forward"): ["ssd_fwd"],
               ("float32", "backward"): ["ssd_bwd", "ssd_bwd_reduce"]}


def ssd_kernel_paths(torch, dev, failures) -> None:
    """By profiler name, a call of each dtype's forward and backward at H 7
    runs only its path's kernels, as many launches as SSD_KERNELS lists."""
    from repro_torch.kernels import ssd

    for dtype in ("bfloat16", "float32"):
        args = ssd_inputs(torch, 2, 384, 7, 64, 64, dtype, 480, dev, model_layout=True)
        dy = randn(torch, (2, 384, 7, 64), dtype, 485, dev)
        for kind, fn in (("forward", lambda: ssd.ssd_scan_cuda(*args, chunk=128)),
                         ("backward", lambda: ssd.ssd_scan_bwd_cuda(*args, dy, chunk=128))):
            want = SSD_KERNELS[(dtype, kind)]
            split, tries = kernel_split(torch, fn, r"(ssd_\w+?)(?:<|\(|$)", want)
            names = [name for name, _ in split]
            ok = names == want
            print(f"[kernel] ssd {kind} {dtype} call by profiler ({tries} profiled): "
                  + ", ".join(f"{name} {ms:.4f} ms" for name, ms in split)
                  + f"; expected {want} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"ssd {kind} {dtype} ran {names}, expected {want}")


def ssd_kernel_phase(torch, dev, failures) -> dict:
    from repro_torch.kernels import ref, ssd

    def check(label, got, want, tol) -> float:
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got.float(), want.float(), **tol)
        print(f"[kernel] ssd {label:<50} max_abs_err={err:.3e} (rtol={tol['rtol']}, "
              f"atol={tol['atol']:.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"ssd {label}: max_abs_err {err:.3e}")
        return err

    def compare(label, args, chunk, dtype, oracle=None) -> float:
        """y and the final state against ssd_chunked (or ``oracle``)."""
        y, st = ssd.ssd_scan_cuda(*args, chunk=chunk)
        want_y, want_st = oracle(*args) if oracle else ref.ssd_chunked(*args, chunk)
        torch.cuda.synchronize()
        return max(check(f"{label} y", y, want_y, SSD_TOL[dtype]),
                   check(f"{label} state", st, want_st, SSD_TOL[dtype]))

    cases = [(1, 64, 2, 16, 8, 16), (2, 128, 3, 16, 8, 32), (1, 128, 1, 32, 16, 64),
             (2, 96, 2, 8, 4, 32)]   # tests/test_kernels.py
    for seed, (B, S, H, P, N, chunk) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            compare(f"({B},{S},{H},{P}) N {N} chunk {chunk} {dtype}",
                    ssd_inputs(torch, B, S, H, P, N, dtype, 300 + 10 * seed, dev), chunk, dtype)
    for dtype in ("float32", "bfloat16"):
        compare(f"ragged S 100 chunk 32 vs ssd_ref {dtype}",
                ssd_inputs(torch, 1, 100, 2, 16, 8, dtype, 350, dev), 32, dtype,
                oracle=ref.ssd_ref)
    # bf16: widths that the tensor-core kernel pads to its 16-wide tiles.
    for seed, (B, S, H, P, N, chunk) in enumerate([(1, 40, 2, 4, 4, 4), (2, 64, 3, 4, 4, 16),
                                                     (1, 48, 2, 8, 8, 4), (2, 64, 3, 8, 8, 16)]):
        compare(f"({B},{S},{H},{P}) N {N} chunk {chunk} bfloat16",
                ssd_inputs(torch, B, S, H, P, N, "bfloat16", 390 + 10 * seed, dev), chunk,
                "bfloat16")
    for dtype, tol in (("float32", dict(rtol=1e-3, atol=1e-3)), ("bfloat16", SSD_TOL["bfloat16"])):
        x, _, _, Bm, Cm = ssd_inputs(torch, 1, 32, 1, 8, 4, dtype, 360, dev)
        dt = torch.full((1, 32, 1), 0.5, device=dev)
        A = torch.full((1,), -50.0, device=dev)
        y, _ = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=8)
        local = (torch.einsum("bsn,bsn->bs", Cm.float(), Bm.float())[:, :, None, None] * 0.5
                 * x.float())
        check(f"decay A=-50: y ~ dt (C.B) x {dtype}", y, local, tol)

    with phase_wall("kernels ssd bf16 edges"):
        for seed, (label, B, S, H, P, N, chunk, fin, ml, oracle) in enumerate(SSD_EDGES):
            compare(f"{label} bfloat16",
                    ssd_inputs(torch, B, S, H, P, N, "bfloat16", 420 + 10 * seed, dev,
                               model_layout=ml), chunk, "bfloat16",
                    oracle=ref.ssd_ref if oracle else None)
        args = ssd_inputs(torch, 2, 384, 7, 64, 64, "bfloat16", 470, dev, model_layout=True)
        a, b = (ssd.ssd_scan_cuda(*args, chunk=128) for _ in range(2))
        same = all(bool(torch.equal(u, v)) for u, v in zip(a, b))
        print(f"[kernel] ssd (2,384,7,64) N 64 chunk 128 bf16: two calls bitwise equal: {same}")
        if not same:
            failures.append("ssd: two bf16 calls differ")
        ssd_kernel_paths(torch, dev, failures)

    # The serve path's shape, in the model's strided layout.
    shape = f"serve ({BATCH},{PROMPT},64,64) N 64 chunk 128 bf16"
    sargs = ssd_inputs(torch, BATCH, PROMPT, 64, 64, 64, "bfloat16", 370, dev, model_layout=True)
    err = compare(shape, sargs, 128, "bfloat16")

    t = {"ms": time_ms(torch, lambda: ssd.ssd_scan_cuda(*sargs, chunk=128)),
         "plain_ms": time_ms(torch, lambda: ref.ssd_chunked(*sargs, 128), iters=5, reps=3),
         "library_ms": None}
    t["bound_ms"], t["bound_by"] = ssd_bound_ms(*sargs, 128)
    print(f"[time] ssd {shape}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"no single PyTorch call, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    return {
        "name": "ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:24",
        "launches": None,
        "max_abs_err": err,
        "shape": shape,
        **t,
    }


# ------------------------------------------------------------------- mlstm --


def mlstm_inputs(torch, B, S, H, D, dtype, seed, dev, *, gate_scale=None, model_layout=False):
    """q, k, v, i_gate, f_gate on the card, all in ``dtype``: q/k/v unit
    normal, i ~ N(0,1), f ~ N(1,1) (tests/test_kernels.py), or both gates
    N(0, gate_scale^2).  ``model_layout``: the gates are the two halves of
    one (B,S,2H) tensor, as ``mlstm_block`` passes them."""
    q, k, v = (randn(torch, (B, S, H, D), dtype, seed + i, dev) for i in range(3))
    if model_layout:
        gates = randn(torch, (B, S, 2 * H), "float32", seed + 3, dev)
        gates[..., H:] += 1.0
        ig, fg = torch.split(gates.to(getattr(torch, dtype)), H, dim=-1)
        return q, k, v, ig, fg
    ig = randn(torch, (B, S, H), "float32", seed + 3, dev)
    fg = randn(torch, (B, S, H), "float32", seed + 4, dev)
    if gate_scale is None:
        fg = fg + 1.0
    else:
        ig, fg = ig * gate_scale, fg * gate_scale
    return q, k, v, ig.to(getattr(torch, dtype)), fg.to(getattr(torch, dtype))


def mlstm_bound_ms(q, chunk) -> tuple[float, str]:
    """Larger of bytes / bandwidth (q, k, v and both gates read once; h and
    the fp32 final S, n, m written once) and operations / peak:
    4 Q D (Q + D) per (b, h, chunk)."""
    B, S, H, D = q.shape
    e = q.element_size()
    nbytes = (4 * q.numel() + 2 * B * S * H) * e + 4 * B * H * (D * D + D + 1)
    flops = 4 * chunk * D * (chunk + D) * B * H * -(-S // chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlstm_tc_flops(B, S, H, D, chunk) -> dict:
    """FLOP the bf16 kernels issue as mma at these sizes: q k^T on the
    16 x 16 tiles on or below the diagonal, once per (b, h, chunk); q S,
    the state update and W v, each twice (bf16 hi + lo of S, of cw k, of
    W).  Padded rows and columns (chunk and D rounded up to 16) count."""
    QP, DP = -(-chunk // 16) * 16, -(-D // 16) * 16
    tiles = (QP // 16) * (QP // 16 + 1) // 2
    n = B * H * -(-S // chunk)
    return {"q k^T": n * tiles * 2 * 256 * DP, "q S": n * 2 * 2 * QP * DP * DP,
            "update": n * 2 * 2 * QP * DP * DP, "W v": n * 2 * 2 * tiles * 256 * DP}


def mlstm_kernel_phase(torch, dev, failures) -> dict:
    from repro_torch.kernels import mlstm, ref

    def check(label, got, want, tol) -> float:
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got.float(), want.float(), **tol)
        print(f"[kernel] mlstm {label:<52} max_abs_err={err:.3e} (rtol={tol['rtol']}, "
              f"atol={tol['atol']:.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"mlstm {label}: max_abs_err {err:.3e}")
        return err

    def compare(label, args, chunk, tol, oracle=None) -> float:
        """h and the final (S, n, m) against mlstm_chunked (or ``oracle``)."""
        h, st = mlstm.mlstm_scan_cuda(*args, chunk=chunk)
        want_h, want_st = oracle(*args) if oracle else ref.mlstm_chunked(*args, chunk)
        torch.cuda.synchronize()
        return max([check(f"{label} h", h, want_h, tol)]
                   + [check(f"{label} {n}", got, want, tol)
                      for n, got, want in zip("Snm", st, want_st)])

    cases = [(1, 64, 2, 16, 16), (2, 128, 2, 16, 32), (1, 96, 1, 32, 32),
             (2, 64, 2, 8, 16)]   # tests/test_kernels.py
    for seed, (B, S, H, D, chunk) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            compare(f"({B},{S},{H},{D}) chunk {chunk} {dtype}",
                    mlstm_inputs(torch, B, S, H, D, dtype, 500 + 10 * seed, dev), chunk,
                    MLSTM_TOL[dtype])
    for seed in range(3):
        compare(f"gates +-20 (1,32,1,8) chunk 8 #{seed} vs mlstm_ref",
                mlstm_inputs(torch, 1, 32, 1, 8, "float32", 550 + 10 * seed, dev,
                             gate_scale=20.0), 8, MLSTM_EXTREME_TOL, oracle=ref.mlstm_ref)
    compare("ragged S 100 chunk 32 vs mlstm_ref float32",
            mlstm_inputs(torch, 2, 100, 2, 16, "float32", 580, dev), 32,
            MLSTM_TOL["float32"], oracle=ref.mlstm_ref)
    compare("ragged S 200 D 384 chunk 128 vs mlstm_ref float32",
            mlstm_inputs(torch, 1, 200, 2, 384, "float32", 585, dev), 128,
            MLSTM_TOL["float32"], oracle=ref.mlstm_ref)
    compare("strided gates (2,64,4,32) chunk 16 bfloat16",
            mlstm_inputs(torch, 2, 64, 4, 32, "bfloat16", 590, dev, model_layout=True), 16,
            MLSTM_TOL["bfloat16"])
    # bf16 only, the tensor-core kernels (tests/test_torch_cuda.py): chunks
    # and head dims that do not fill 16-wide tiles, every value-column
    # width, ragged lengths (S 16 against chunk 128 is the serve warm-up's
    # shape) and gates of +-20, all against mlstm_chunked.
    for seed, (B, S, H, D, chunk) in enumerate([
            (2, 40, 2, 16, 4), (1, 48, 2, 16, 12), (2, 80, 2, 32, 20), (2, 64, 2, 24, 8),
            (2, 64, 2, 8, 8), (2, 48, 2, 12, 16), (1, 40, 2, 20, 8), (1, 96, 3, 64, 32),
            (1, 128, 2, 96, 64), (1, 256, 1, 512, 128)]):
        compare(f"({B},{S},{H},{D}) chunk {chunk} bfloat16",
                mlstm_inputs(torch, B, S, H, D, "bfloat16", 620 + 10 * seed, dev), chunk,
                MLSTM_TOL["bfloat16"])
    for seed, (S, chunk, D) in enumerate([(37, 16, 8), (37, 16, 32), (200, 128, 384),
                                          (16, 128, 384), (5, 8, 96)]):
        compare(f"ragged S {S} D {D} chunk {chunk} bfloat16",
                mlstm_inputs(torch, 2, S, 2, D, "bfloat16", 700 + 10 * seed, dev), chunk,
                MLSTM_TOL["bfloat16"])
    for seed in range(3):
        for D, S, chunk in ((8, 32, 8), (384, 256, 128)):
            compare(f"gates +-20 (1,{S},1,{D}) chunk {chunk} #{seed} bfloat16",
                    mlstm_inputs(torch, 1, S, 1, D, "bfloat16", 750 + 10 * seed, dev,
                                 gate_scale=20.0), chunk, MLSTM_TOL["bfloat16"])

    # The serve path's shape, in the model's layout.
    shape = f"serve ({BATCH},{PROMPT},4,384) chunk 128 bf16"
    sargs = mlstm_inputs(torch, BATCH, PROMPT, 4, 384, "bfloat16", 600, dev, model_layout=True)
    err = compare(shape, sargs, 128, MLSTM_TOL["bfloat16"])

    t = {"ms": time_ms(torch, lambda: mlstm.mlstm_scan_cuda(*sargs, chunk=128)),
         "plain_ms": time_ms(torch, lambda: ref.mlstm_chunked(*sargs, 128), iters=5, reps=3),
         "library_ms": None}
    t["bound_ms"], t["bound_by"] = mlstm_bound_ms(sargs[0], 128)
    t["graph_ms"] = graph_ms(torch, [lambda: mlstm.mlstm_scan_cuda(*sargs, chunk=128)] * 10)
    print(f"[time] mlstm {shape}: kernel {t['ms']:.4f} ms ({t['graph_ms']:.4f} ms a call in a "
          f"CUDA graph of 10), plain {t['plain_ms']:.4f} ms, no single PyTorch call, bound "
          f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    work = mlstm_tc_flops(BATCH, PROMPT, 4, 384, 128)
    total = sum(work.values())
    useful = 4 * 128 * 384 * (128 + 384) * BATCH * 4 * (PROMPT // 128)
    print(f"[time] mlstm: the bf16 kernels issue {total / 1e9:.2f} GFLOP of mma ("
          + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in work.items())
          + f"; q k^T once per (b, h, chunk), the other three with hi + lo): "
          f"{total / t['ms'] / 1e9:.1f} TFLOP/s issued; the function's own {useful / 1e9:.2f} "
          f"GFLOP at {useful / t['ms'] / 1e9:.1f} TFLOP/s")
    return {
        "name": "mlstm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm.py:23",
        "launches": None,
        "max_abs_err": err,
        "shape": shape,
        **t,
    }


# ------------------------------------------------------------------- serve --


def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm, ssd

    fa.launches = 0
    fa.lse_launches = 0
    fa.bwd_launches = 0
    ssd.launches = 0
    ssd.bwd_launches = 0
    mlstm.launches = 0
    mlstm.bwd_launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm, ssd

    return {"flash_attention": fa.launches, "flash_attention_bwd": fa.bwd_launches,
            "ssd": ssd.launches, "mlstm": mlstm.launches, "ssd_bwd": ssd.bwd_launches,
            "mlstm_bwd": mlstm.bwd_launches, "flash_attention_lse": fa.lse_launches}


def serve_phase(torch, dev, entry, failures, counts):
    from repro_torch.launch import serve
    from repro_torch.models import Model

    t0 = time.perf_counter()
    model, params = serve.build_model(ARCH, full=True, device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(p.numel() for p in params.values())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.hd}, {n_params / 1e9:.3f} B params in "
          f"{cfg.dtype}, initialised in {time.perf_counter() - t0:.1f}s")
    prompts = serve.make_prompts(model, BATCH, PROMPT, seed=1)
    # Warm-up at a short prompt: CUDA loads each kernel module at its first
    # use, and cuBLAS sets itself up, so a cold first run times those too.
    cold = serve.generate(model, params, prompts[:, :16], 4)
    print(f"[serve] warm-up (prompt 16, 4 tokens): prefill {cold.prefill_s * 1e3:.1f} ms, "
          f"decode {cold.decode_s * 1e3:.1f} ms")

    reset_counts()
    res = serve.generate(model, params, prompts, GEN)
    counts[ARCH] = read_counts()
    launches = counts[ARCH]["flash_attention"]
    step_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"[serve] prefill {BATCH}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_tok_s:.1f} tok/s ({GEN - 1} steps in {res.decode_s:.3f}s, "
          f"{step_ms:.2f} ms a step); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    print(f"[serve] attention kernel share: prefill "
          f"{attention_share([(cfg.n_layers, entry)], res.prefill_s * 1e3)}; decode at most "
          f"{cfg.n_layers} x {entry['decode']['ms']:.4f} ms = "
          f"{cfg.n_layers * entry['decode']['ms'] / step_ms:.1%} of a step")
    print(f"[serve] sample output ids: {res.generated[0, :12].tolist()}")
    want = cfg.n_layers * (1 + GEN - 1)
    print(f"[serve] flash_attention launches: {launches} (expected {want})")
    if launches != want:
        failures.append(f"flash_attention launched {launches} times, expected {want}")
    others = {k: v for k, v in counts[ARCH].items() if k != "flash_attention" and v}
    if others:
        failures.append(f"{ARCH} serve launched other kernels: {others}")
    if not res.finite:
        failures.append("non-finite logits in the serve run")

    # The gate: the same weights (bf16 values are exact in fp32) and prompts
    # in fp32, prefilled through the kernel and through the plain attention,
    # must agree to the model-level fp32 tolerance of tests/test_models.py.
    cfg32 = cfg.replace(dtype="float32", logit_dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    model32 = Model(cfg32, dev)
    lk = last_logits(torch, model32, params32, prompts, failures)
    lp = last_logits(torch, model32, params32, prompts, failures, plain=True)
    gate(torch, "[serve] fp32 prefill last logits, kernel vs plain attention", lk, lp, failures)
    del params32, lk, lp

    # Information only: the served bf16 prefill against the same prefill
    # with the plain attention.  The two round attention outputs
    # differently by up to one bf16 ulp, and 32 layers of a bf16 residual
    # stream carry that into every logit, so this gap is rounding, not a
    # tolerance: the fp32 gate above holds the kernel.
    last = last_logits(torch, model, params, prompts, failures, plain=True)
    bf16_gap(torch, "[serve] bf16 prefill last logits, kernel vs plain attention",
             res.prefill_logits.float(), last, failures, EARLIER_BF16_GAP[ARCH])


def serve_elastic_phase(torch, dev, failures, counts):
    """The elastic serving plane (``repro_torch.serving``) through
    ``repro_torch.launch.serve.main(["--scenario", "all", "--executor",
    "both"])`` with the live runtime's slots on the card: it must return 0,
    sim and live must give equal ``serve_parity_key`` on every serve
    scenario, and it must launch no kernel (the service prices decode
    steps, as the JAX package's does; it runs no model).  Each replay that
    ``main`` makes is recorded with its host wall, and each scenario's line
    gives the resizes, requests, KV bytes moved and the modelled
    latencies."""
    import repro_torch.serving as serving
    from repro_torch.device import card_label
    from repro_torch.launch import serve
    from repro_torch.malleability.policies import SERVE_SCENARIO_NAMES

    tag = "[serve elastic]"
    argv = ["--scenario", "all", "--executor", "both"]
    replays = {}   # (scenario, executor) -> (report, host seconds)
    run_serve = serving.run_serve

    def timed(name, *, executor, **kwargs):
        t0 = time.perf_counter()
        rep = run_serve(name, executor=executor, **kwargs)
        replays[name, executor] = rep, time.perf_counter() - t0
        return rep

    reset_counts()
    serving.run_serve = timed   # run_elastic imports it from the package at call time
    try:
        rc = serve.main(argv)
    finally:
        serving.run_serve = run_serve
    counts["serve elastic"] = read_counts()
    label = card_label(dev)
    agree = 0
    for name in SERVE_SCENARIO_NAMES:
        (sim, t_sim), (live, t_live) = replays[name, "sim"], replays[name, "live"]
        same = serving.serve_parity_key(sim) == serving.serve_parity_key(live)
        agree += same
        print(f"{tag} {name}: {len(live.records)} resizes ("
              + ", ".join(f"{r.kind} {r.nodes_before}->{r.nodes_after}" for r in live.records)
              + f"), {live.completed} of {live.submitted} requests completed, {live.dropped} "
              f"dropped, {live.migrated} migrated / {live.requeued} requeued; "
              f"{live.bytes_moved / 1e6:.1f} MB of KV pages moved "
              f"({live.bytes_cross_rack / 1e6:.1f} MB cross-rack); latency p50 "
              f"{live.p50_latency_s:.3f} s, p99 {live.p99_latency_s:.3f} s (modelled: "
              f"{serving.serve_config(name).step_time_s} s a decode step plus each resize's "
              f"modelled downtime, {live.downtime_s:.4f} s in all; no model runs); host wall of "
              f"the replay: sim {t_sim * 1e3:.1f} ms, live {t_live * 1e3:.1f} ms (slots on "
              f"{label}); sim == live {same}")
    n = len(SERVE_SCENARIO_NAMES)
    print(f"{tag} repro_torch.launch.serve.main({argv}) returned {rc}; sim == live on {agree} "
          f"of {n} serve scenarios; kernel launches {counts['serve elastic']}")
    if rc != 0 or agree != n:
        failures.append(f"serve elastic: main returned {rc}, sim == live on {agree} of {n}")
    if any(counts["serve elastic"].values()):
        failures.append(f"serve elastic launched kernels: {counts['serve elastic']}")


def gate(torch, label, got, want, failures):
    """The fp32 model-level check of tests/test_models.py."""
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, **MODEL_TOL)
    print(f"{label}: max_abs_err={err:.3e} (rtol={MODEL_TOL['rtol']}, "
          f"atol={MODEL_TOL['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: max_abs_err {err:.3e}")


def bf16_gap(torch, label, got, want, failures, earlier=None, ids=True):
    """Printed as information; only non-finite values fail.  ``earlier``:
    the same gap with the scalar kernels, for comparison; ``ids``: the
    values are logits, so also the share of rows with the same greedy id."""
    err = float((got - want).abs().max())
    rel_rms = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"{label} (information): max_abs_err={err:.3e}"
          f"{f' (scalar kernels: {earlier})' if earlier else ''} at max |value| "
          f"{float(want.abs().max()):.3f}, relative rms {rel_rms:.3e}"
          + (f", same greedy id in {same:.0%} of rows" if ids else ""))
    if not bool(torch.isfinite(want).all()):
        failures.append(f"{label}: non-finite logits in the plain run")


@contextlib.contextmanager
def plain_versions(failures):
    """Every kernel swapped for its plain version, in this run only: the
    port has no switch for it.  Fails the run if a kernel launches inside."""
    from unittest import mock

    from repro_torch.kernels import ops, ref

    def ssd_plain(x, dt, A, Bmat, Cmat, *, chunk):
        return ref.ssd_chunked(x, dt, A, Bmat, Cmat, chunk)

    def mlstm_plain(q, k, v, i_gate, f_gate, *, chunk):
        return ref.mlstm_chunked(q, k, v, i_gate, f_gate, chunk)

    before = read_counts()
    with mock.patch.object(ops, "flash_attention", ref.attention_ref), \
            mock.patch.object(ops, "ssd_scan", ssd_plain), \
            mock.patch.object(ops, "mlstm_scan", mlstm_plain):
        yield
    if read_counts() != before:
        failures.append("a run with the plain versions launched a kernel")


def positions(torch, model, pos):
    """Token positions as the model reads them: (B, S), or the (3, B, S)
    M-RoPE positions of a text prompt (t, h and w alike), as
    ``repro_torch.launch.serve`` feeds them."""
    return torch.stack([pos, pos, pos]) if model.cfg.mrope_sections else pos


def last_logits(torch, model, params, prompts, failures, *, plain=False):
    """The prefill's last-position logits (B, V) in fp32, through the
    kernels or (``plain``) their plain versions."""
    B, P = prompts.shape
    pos = torch.arange(P, dtype=torch.int32, device=prompts.device).expand(B, P)
    with torch.inference_mode(), (plain_versions(failures) if plain
                                  else contextlib.nullcontext()):
        return model.forward(params, {"tokens": prompts, "positions": positions(
            torch, model, pos)})[0][:, -1].float()


def prefill_then_decode(torch, model, params, prompts, tokens, failures, *, plain=False):
    """One-pass prefill of ``prompts``, then one decode step per column of
    ``tokens``: (the prefill's last logits (B, V), the steps' logits
    (B, n, V)), in fp32, through the kernels or their plain versions."""
    B, P = prompts.shape
    n = tokens.shape[1]
    dev = prompts.device
    with torch.inference_mode(), (plain_versions(failures) if plain
                                  else contextlib.nullcontext()):
        cache = model.init_cache(B, P + n)
        pos = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
        last = model.prefill(params, cache, {"tokens": prompts, "positions": positions(
            torch, model, pos)})[:, -1].float()
        steps = []
        for i in range(n):
            lg, cache = model.decode_step(params, cache, {
                "tokens": tokens[:, i:i + 1], "cache_pos": P + i,
                "positions": positions(torch, model, torch.full(
                    (B, 1), P + i, dtype=torch.int32, device=dev))})
            steps.append(lg[:, -1].float())
    return last, torch.stack(steps, dim=1)


def hybrid_phase(torch, dev, fa_entry, ssd_entry, failures, counts):
    from repro_torch.launch import serve
    from repro_torch.models import Model

    t0 = time.perf_counter()
    model, params = serve.build_model(HYBRID, full=True, device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_attn = cfg.n_layers // cfg.attn_every
    d_in = cfg.ssm_expand * cfg.d_model
    n_params = sum(p.numel() for p in params.values())
    print(f"[hybrid] {cfg.name}: {cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, "
          f"{d_in // cfg.ssm_head_dim} SSM heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}; one shared attention block "
          f"({cfg.n_heads} heads x {cfg.hd}, d_ff {cfg.d_ff}) applied {n_attn} times; "
          f"{n_params / 1e9:.3f} B params in {cfg.dtype}, initialised in "
          f"{time.perf_counter() - t0:.1f}s")
    prompts = serve.make_prompts(model, BATCH, PROMPT, seed=1)
    cold = serve.generate(model, params, prompts[:, :16], 4)   # 16: ragged against chunk 128
    print(f"[hybrid] warm-up (prompt 16, 4 tokens): prefill {cold.prefill_s * 1e3:.1f} ms, "
          f"decode {cold.decode_s * 1e3:.1f} ms, finite {cold.finite}")
    if not cold.finite:
        failures.append("non-finite logits in the hybrid warm-up run (prompt 16)")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = serve.generate(model, params, prompts, GEN)
    counts[HYBRID] = read_counts()
    step_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"[hybrid] prefill {BATCH}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_tok_s:.1f} tok/s ({GEN - 1} steps in {res.decode_s:.3f}s, "
          f"{step_ms:.2f} ms a step); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"[hybrid] sample output ids: {res.generated[0, :12].tolist()}")
    for name, want in (("ssd", cfg.n_layers), ("flash_attention", n_attn * GEN),
                       ("flash_attention_bwd", 0), ("mlstm", 0)):
        got = counts[HYBRID][name]
        print(f"[hybrid] {name} launches: {got} (expected {want})")
        if got != want:
            failures.append(f"{HYBRID}: {name} launched {got} times, expected {want}")
    if not res.finite:
        failures.append("non-finite logits in the hybrid serve run")

    # The attention kernel at this model's shapes (head dim 64), checked and
    # timed; with the SSD kernel's time, the kernels' shares of the run.
    H, D, Sk_dec = cfg.n_heads, cfg.hd, PROMPT + GEN - 1
    att = {}
    for label, S, Sk, causal, seed in (("prefill", PROMPT, PROMPT, True, 400),
                                       ("decode", 1, Sk_dec, False, 410)):
        q = model_layout(torch, BATCH, H, S, D, "bfloat16", seed, dev)
        if label == "prefill":
            kv_sets = [(model_layout(torch, BATCH, H, Sk, D, "bfloat16", seed + 1, dev,
                                     PROMPT + GEN),
                        model_layout(torch, BATCH, H, Sk, D, "bfloat16", seed + 2, dev,
                                     PROMPT + GEN))]
        else:
            kv_sets = decode_sets(torch, BATCH, H, Sk, D, seed + 1, dev)
        shape = f"{label} ({BATCH},{H},{S},{D}) Sk {Sk}{' causal' if causal else ''} bf16"
        err = attention_check(torch, "[kernel] flash_attention", shape, q, *kv_sets[0],
                              "bfloat16", failures, causal=causal)
        att[label] = {"shape": shape, "max_abs_err": err,
                      **attention_timings(torch, q, kv_sets, causal, dev)}
        print_attention_time(shape, att[label], q)
    fa_entry[HYBRID] = att
    pre_ms = res.prefill_s * 1e3
    print(f"[hybrid] kernel shares of the prefill: ssd {cfg.n_layers} x "
          f"{ssd_entry['ms']:.4f} ms = {cfg.n_layers * ssd_entry['ms'] / pre_ms:.1%}, "
          f"attention {attention_share([(n_attn, att['prefill'])], pre_ms)}; attention in "
          f"decode at most "
          f"{n_attn} x {att['decode']['ms']:.4f} ms = "
          f"{n_attn * att['decode']['ms'] / step_ms:.1%} of a step")

    # The gates, in fp32 on the same weights and prompts: the prefill's last
    # logits, and 4 decode steps after it (they read the prefill's final SSM
    # and conv states and its attention cache), through the kernels against
    # the same through both plain versions.
    cfg32 = cfg.replace(dtype="float32", logit_dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    model32 = Model(cfg32, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (BATCH, 4), generator=g, device=dev)
    lk, sk = prefill_then_decode(torch, model32, params32, prompts, tokens, failures)
    lp, sp = prefill_then_decode(torch, model32, params32, prompts, tokens, failures, plain=True)
    gate(torch, "[hybrid] fp32 prefill last logits, kernels vs plain versions", lk, lp, failures)
    gate(torch, "[hybrid] fp32 4 decode steps after the prefill, kernels vs plain versions",
         sk, sp, failures)
    del params32, lk, lp, sk, sp

    last = last_logits(torch, model, params, prompts, failures, plain=True)
    bf16_gap(torch, "[hybrid] bf16 prefill last logits, kernels vs plain versions",
             res.prefill_logits.float(), last, failures, EARLIER_BF16_GAP[HYBRID])


def slstm_pass(torch, model, params, dev) -> tuple[float, int]:
    """One sLSTM block's pass over a (BATCH, PROMPT) input, as the prefill
    runs it (a Python loop of PROMPT steps): warm host-clock ms, and its
    kernel launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.xlstm import slstm_block

    lp = {k.removeprefix("blocks/"): v[0] for k, v in params.items() if k.startswith("blocks/")}
    x = randn(torch, (BATCH, PROMPT, model.cfg.d_model), model.cfg.dtype, 700, dev)
    with torch.inference_mode():
        slstm_block(lp, "slstm", model.cfg, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slstm_block(lp, "slstm", model.cfg, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            slstm_block(lp, "slstm", model.cfg, x)
            torch.cuda.synchronize()
    launches = sum(n for _, n in device_events(torch, prof).values())
    return ms, launches


def xlstm_phase(torch, dev, mlstm_entry, failures, counts):
    from repro_torch.launch import serve
    from repro_torch.models import Model

    t0 = time.perf_counter()
    model, params = serve.build_model(XLSTM, full=True, device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    every = cfg.xlstm_slstm_every
    n_mlstm = cfg.n_layers // every * (every - 1)
    dp = int(cfg.xlstm_proj_factor * cfg.d_model)
    n_params = sum(p.numel() for p in params.values())
    print(f"[xlstm] {cfg.name}: {cfg.n_layers} blocks ({n_mlstm} mLSTM, "
          f"{cfg.n_layers - n_mlstm} sLSTM), d_model {cfg.d_model}, {cfg.n_heads} heads; "
          f"mLSTM inner {dp}, head dim {dp // cfg.n_heads}, chunk {cfg.xlstm_chunk}; sLSTM "
          f"head dim {cfg.d_model // cfg.n_heads}; vocab {cfg.vocab}; {n_params / 1e6:.1f} M "
          f"params in {cfg.dtype}, initialised in {time.perf_counter() - t0:.1f}s")
    prompts = serve.make_prompts(model, BATCH, PROMPT, seed=1)
    cold = serve.generate(model, params, prompts[:, :16], 4)   # 16: ragged against chunk 128
    print(f"[xlstm] warm-up (prompt 16, 4 tokens): prefill {cold.prefill_s * 1e3:.1f} ms, "
          f"decode {cold.decode_s * 1e3:.1f} ms, finite {cold.finite}")
    if not cold.finite:
        failures.append("non-finite logits in the xlstm warm-up run (prompt 16)")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = serve.generate(model, params, prompts, GEN)
    counts[XLSTM] = read_counts()
    step_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"[xlstm] prefill {BATCH}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_tok_s:.1f} tok/s ({GEN - 1} steps in {res.decode_s:.3f}s, "
          f"{step_ms:.2f} ms a step); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"[xlstm] sample output ids: {res.generated[0, :12].tolist()}")
    for name, want in (("mlstm", n_mlstm), ("ssd", 0), ("flash_attention", 0),
                       ("flash_attention_bwd", 0)):
        got = counts[XLSTM][name]
        print(f"[xlstm] {name} launches: {got} (expected {want})")
        if got != want:
            failures.append(f"{XLSTM}: {name} launched {got} times, expected {want}")
    if not res.finite:
        failures.append("non-finite logits in the xlstm serve run")
    pre_ms = res.prefill_s * 1e3
    slstm_ms, slstm_launches = slstm_pass(torch, model, params, dev)
    n_slstm = cfg.n_layers - n_mlstm
    print(f"[xlstm] shares of the prefill: mLSTM kernel {n_mlstm} x {mlstm_entry['ms']:.4f} ms "
          f"= {n_mlstm * mlstm_entry['ms'] / pre_ms:.1%}; sLSTM blocks {n_slstm} x "
          f"{slstm_ms:.1f} ms = {n_slstm * slstm_ms / pre_ms:.1%} ({slstm_launches} kernel "
          f"launches a block over the prompt, {slstm_launches / PROMPT:.1f} a step)")

    # The gates, in fp32 on the same weights and prompts: the prefill's last
    # logits, and 4 decode steps after it (they read the prefill's final
    # mLSTM and sLSTM states), through the kernel against the same through
    # the plain versions.
    cfg32 = cfg.replace(dtype="float32", logit_dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    model32 = Model(cfg32, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (BATCH, 4), generator=g, device=dev)
    lk, sk = prefill_then_decode(torch, model32, params32, prompts, tokens, failures)
    lp, sp = prefill_then_decode(torch, model32, params32, prompts, tokens, failures, plain=True)
    gate(torch, "[xlstm] fp32 prefill last logits, kernel vs plain versions", lk, lp, failures)
    gate(torch, "[xlstm] fp32 4 decode steps after the prefill, kernel vs plain versions",
         sk, sp, failures)
    del params32, lk, lp, sk, sp

    # The bf16 gap to the plain versions at two points of the same prefill:
    # the first mLSTM block's output (the kernel's own error: both runs feed
    # it the same input) and the last logits (after 11 more blocks).
    first_k, last_k = first_mlstm_and_logits(torch, model, params, prompts, failures)
    first_p, last_p = first_mlstm_and_logits(torch, model, params, prompts, failures, plain=True)
    bf16_gap(torch, "[xlstm] bf16 first mLSTM block's output, kernel vs plain versions",
             first_k, first_p, failures, ids=False)
    bf16_gap(torch, "[xlstm] bf16 prefill last logits, kernel vs plain versions",
             last_k, last_p, failures)


def first_mlstm_and_logits(torch, model, params, prompts, failures, *, plain=False):
    """A prefill's first mLSTM block output (B, S, d) and last logits (B, V),
    in fp32, through the kernels or (``plain``) their plain versions."""
    from unittest import mock

    from repro_torch.models import transformer

    seen = []
    block = transformer.mlstm_block

    def recording(*args, **kwargs):
        out = block(*args, **kwargs)
        if not seen:
            seen.append(out[0].float())
        return out

    with mock.patch.object(transformer, "mlstm_block", recording):
        last = last_logits(torch, model, params, prompts, failures, plain=plain)
    return seen[0], last


# ------------------------------------------------ gemma2 and the MoE family --


def gemma2_phase(torch, dev, fa_entry, failures, counts):
    """Full gemma2_9b served (bf16, batch 2, a prompt past its window, so
    its 21 local layers' ring caches wrap), the attention kernel timed at
    its four shapes, the bf16 gap to the plain attention, then the fp32
    gate at full width and GEMMA2_GATE_LAYERS layers (2 rings)."""
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.models.transformer import init_cache_shapes, local_layers

    tag = f"[{GEMMA2}]"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, params = serve.build_model(GEMMA2, full=True, device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    W, B, P = cfg.sliding_window, GEMMA2_BATCH, GEMMA2_PROMPT
    n_params = sum(p.numel() for p in params.values())
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers (even ones local, window {W}), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv x {cfg.hd}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, softcaps {cfg.attn_softcap} / {cfg.final_softcap}; "
          f"{n_params / 1e9:.3f} B params in {cfg.dtype}, initialised in "
          f"{time.perf_counter() - t0:.1f}s (peak {torch.cuda.max_memory_allocated(dev) / 2**30:.1f}"
          f" GiB: the fp32 draw, then its bf16 cast)")
    shapes = init_cache_shapes(cfg, B, P + GEN)
    print(f"{tag} cache at batch {B}, {P} + {GEN} positions: "
          + ", ".join(f"{name} {shape}" for name, (shape, *_rest) in shapes.items()))
    if set(shapes) != {"k_loc", "v_loc", "k", "v"} or shapes["k_loc"][0][2] != W:
        failures.append(f"{GEMMA2}: cache {shapes} has no window-sized rings")
    prompts = serve.make_prompts(model, B, P, seed=1)
    cold = serve.generate(model, params, prompts[:, :16], 4)
    print(f"{tag} warm-up (prompt 16, 4 tokens): prefill {cold.prefill_s * 1e3:.1f} ms, "
          f"decode {cold.decode_s * 1e3:.1f} ms, finite {cold.finite}")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = serve.generate(model, params, prompts, GEN)
    counts[GEMMA2] = read_counts()
    step_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"{tag} prefill {B}x{P} tokens: {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_tok_s:.1f} tok/s ({GEN - 1} steps in {res.decode_s:.3f}s, "
          f"{step_ms:.2f} ms a step, {EARLIER_GEMMA2['decode step']} with the unsplit decode "
          f"kernel; the rings written at pos % {W} from pos {P}); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"{tag} sample output ids: {res.generated[0, :12].tolist()}")
    for name, want in (("flash_attention", cfg.n_layers * GEN), ("flash_attention_bwd", 0),
                       ("ssd", 0), ("mlstm", 0)):
        got = counts[GEMMA2][name]
        print(f"{tag} {name} launches: {got} (expected {want})")
        if got != want:
            failures.append(f"{GEMMA2}: {name} launched {got} times, expected {want}")
    if not (res.finite and cold.finite):
        failures.append(f"non-finite logits in the {GEMMA2} serve run")

    # The attention kernel at this model's four shapes: the global (causal)
    # and local (window) layers' prefill, and decode over a full ring and
    # over the global cache at its longest; SDPA without softcap beside it.
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    att = {}
    for label, Sq, Sk, causal, window, seed in (
            ("prefill global", P, P, True, 0, 500), ("prefill local", P, P, True, W, 510),
            ("decode ring", 1, W, False, 0, 520), ("decode global", 1, P + GEN - 1, False, 0, 530)):
        q = model_layout(torch, B, H, Sq, D, "bfloat16", seed, dev)
        if Sq > 1:
            kv_sets = [tuple(model_layout(torch, B, KV, Sk, D, "bfloat16", seed + i, dev)
                             for i in (1, 2))]
        else:
            kv_sets = decode_sets(torch, B, KV, Sk, D, seed + 1, dev, s_alloc=Sk)
        shape = (f"{label} ({B},{H},{Sq},{D}) kv {KV} Sk {Sk}{' causal' if causal else ''}"
                 f"{f' window {window}' if window else ''} softcap {cfg.attn_softcap:g} bf16")
        err = attention_check(torch, tag, shape, q, *kv_sets[0], "bfloat16", failures,
                              causal=causal, window=window, softcap=cfg.attn_softcap)
        t = attention_timings(torch, q, kv_sets, causal, dev, window=window,
                              softcap=cfg.attn_softcap, iters=5 if Sq > 1 else None)
        key = label.replace(" ", "_")
        att[key] = {"shape": shape, "max_abs_err": err, **t}
        print_attention_time(shape + (f"; earlier design {EARLIER_GEMMA2[key]}"
                                      if key in EARLIER_GEMMA2 else ""), t)
        del q, kv_sets
    fa_entry[GEMMA2] = att
    n_loc = len(local_layers(cfg))
    terms = [(n_loc, att["prefill_local"]), (cfg.n_layers - n_loc, att["prefill_global"])]
    print(f"{tag} attention kernel share of the prefill: "
          f"{attention_share(terms, res.prefill_s * 1e3)} of {res.prefill_s * 1e3:.1f} ms; "
          f"decode at most "
          f"{n_loc} x {att['decode_ring']['ms']:.4f} + {cfg.n_layers - n_loc} x "
          f"{att['decode_global']['ms']:.4f} ms of a {step_ms:.2f} ms step")

    # Information: the served bf16 prefill against the same prefill with the
    # plain attention (rounding over 42 bf16 layers, not a tolerance).
    last = last_logits(torch, model, params, prompts, failures, plain=True)
    bf16_gap(torch, f"{tag} bf16 prefill last logits, kernel vs plain attention",
             res.prefill_logits.float(), last, failures)
    del last, res

    # The gate, in fp32 at full width and GEMMA2_GATE_LAYERS layers (the
    # first 2 of them local, with rings): the prefill of the same prompts,
    # which wraps the rings, and 4 decode steps after it, through the
    # kernel against the same with the plain attention.
    L = GEMMA2_GATE_LAYERS
    small = cfg.replace(n_layers=L, dtype="float32", logit_dtype="float32")
    params32 = {k: (v[:L] if k.startswith("blocks/") else v).float() for k, v in params.items()}
    del model, params
    torch.cuda.empty_cache()
    model32 = Model(small, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (B, 4), generator=g, device=dev)
    lk, sk = prefill_then_decode(torch, model32, params32, prompts, tokens, failures)
    lp, sp = prefill_then_decode(torch, model32, params32, prompts, tokens, failures, plain=True)
    gate(torch, f"{tag} fp32 at full width and {L} layers ({(L + 1) // 2} rings), prefill last "
         f"logits, kernel vs plain attention", lk, lp, failures)
    gate(torch, f"{tag} fp32 at full width and {L} layers, 4 decode steps after the prefill "
         f"(ring slots {P % W}..{(P + 3) % W}), kernel vs plain attention", sk, sp, failures)
    del params32, model32, lk, lp, sk, sp
    torch.cuda.empty_cache()


class Routes:
    """Wraps ``layers.moe_route`` and keeps each call's routed (token,
    expert) pairs: their experts and whether each was kept (within the
    capacity)."""

    def __init__(self):
        from repro_torch.models import layers

        self.calls: list = []
        self._real = layers.moe_route

    def __call__(self, *args):
        out = self._real(*args)
        self.calls.append((out[1], out[3]))
        return out

    @staticmethod
    def dropped(calls) -> float:
        """The share of the pairs of ``calls`` dropped past the capacity."""
        return 1 - sum(int(keep.sum()) for _, keep in calls) / sum(
            keep.numel() for _, keep in calls)

    def record(self, layers, fn):
        """fn() with every routing call recorded here."""
        from unittest import mock

        with mock.patch.object(layers, "moe_route", self):
            return fn()


def moe_phase(torch, dev, fa_entry, failures, counts):
    """phi35_moe_42b at full width: served at MOE_SERVE_LAYERS layers (bf16,
    batch 8, prompt 512, 64 tokens; the share of routed pairs dropped at
    prefill and at decode; the fp32 gate at MOE_GATE_LAYERS layers), then
    trained at MOE_TRAIN_LAYERS layers (4 steps, fp32 masters, remat) and
    the fp32 step gate at 1 layer."""
    from repro_torch.configs import arch_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.device import card_label
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli
    from repro_torch.models import Model, layers

    tag = f"[{MOE}]"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, params = serve.build_model(MOE, full=True, device=dev, seed=0, layers=MOE_SERVE_LAYERS)
    torch.cuda.synchronize()
    cfg = model.cfg
    full = arch_config(MOE)
    n_params = sum(p.numel() for p in params.values())
    print(f"{tag} {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv x {cfg.hd}, {cfg.n_experts} experts top-{cfg.top_k} of d_ff "
          f"{cfg.d_ff}, capacity factor {cfg.capacity_factor}), depth cut from {full.n_layers} to "
          f"{cfg.n_layers} layers: {n_params / 1e9:.3f} B params in {cfg.dtype} (the whole "
          f"model: {full.param_count() / 1e9:.1f} B), initialised in "
          f"{time.perf_counter() - t0:.1f}s (peak {torch.cuda.max_memory_allocated(dev) / 2**30:.1f}"
          f" GiB)")
    prompts = serve.make_prompts(model, BATCH, PROMPT, seed=1)
    cold = serve.generate(model, params, prompts[:, :16], 4)
    print(f"{tag} warm-up (prompt 16, 4 tokens): prefill {cold.prefill_s * 1e3:.1f} ms, "
          f"decode {cold.decode_s * 1e3:.1f} ms, finite {cold.finite}")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = serve.generate(model, params, prompts, GEN)
    counts[MOE] = read_counts()
    step_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"{tag} prefill {BATCH}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_tok_s:.1f} tok/s ({GEN - 1} steps in {res.decode_s:.3f}s, {step_ms:.2f} ms "
          f"a step); peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"{tag} sample output ids: {res.generated[0, :12].tolist()}")
    for name, want in (("flash_attention", cfg.n_layers * GEN), ("flash_attention_bwd", 0),
                       ("ssd", 0), ("mlstm", 0)):
        got = counts[MOE][name]
        print(f"{tag} {name} launches: {got} (expected {want})")
        if got != want:
            failures.append(f"{MOE}: {name} launched {got} times, expected {want}")
    if not (res.finite and cold.finite):
        failures.append(f"non-finite logits in the {MOE} serve run")

    # The attention kernel at this model's shapes (head dim 128, GQA 32/8).
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    att = {}
    for label, Sq, Sk, causal, seed in (("prefill", PROMPT, PROMPT, True, 600),
                                        ("decode", 1, PROMPT + GEN - 1, False, 610)):
        q = model_layout(torch, BATCH, H, Sq, D, "bfloat16", seed, dev)
        if Sq > 1:
            kv_sets = [tuple(model_layout(torch, BATCH, KV, Sk, D, "bfloat16", seed + i, dev)
                             for i in (1, 2))]
        else:
            kv_sets = decode_sets(torch, BATCH, KV, Sk, D, seed + 1, dev)
        shape = f"{label} ({BATCH},{H},{Sq},{D}) kv {KV} Sk {Sk}{' causal' if causal else ''} bf16"
        err = attention_check(torch, tag, shape, q, *kv_sets[0], "bfloat16", failures,
                              causal=causal)
        att[label] = {"shape": shape, "max_abs_err": err,
                      **attention_timings(torch, q, kv_sets, causal, dev)}
        print_attention_time(shape, att[label], q)
    fa_entry[MOE] = att

    # The routing of the same run again, counted (not the timed run): the
    # prefill's calls route B x P tokens at a capacity of
    # int(B P k 1.25 / E), a decode step's B tokens at int(B k 1.25 / E).
    drops = Routes()
    drops.record(layers, lambda: serve.generate(model, params, prompts, GEN))
    L = cfg.n_layers
    cap_pre = max(int(BATCH * PROMPT * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
    cap_dec = max(int(BATCH * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
    print(f"{tag} routed (token, expert) pairs dropped past the capacity: prefill "
          f"{drops.dropped(drops.calls[:L]):.2%} (capacity {cap_pre} per expert, {L} calls), decode "
          f"{drops.dropped(drops.calls[L:]):.2%} (capacity {cap_dec}, {len(drops.calls) - L} calls)")

    # Information: the bf16 prefill against the same with the plain
    # attention, and how many routed pairs pick another expert in each
    # layer between the two (a flip changes that token's whole output).
    kern, plain = Routes(), Routes()
    kern.record(layers, lambda: last_logits(torch, model, params, prompts, failures))
    last = plain.record(layers, lambda: last_logits(torch, model, params, prompts, failures,
                                                    plain=True))
    bf16_gap(torch, f"{tag} bf16 prefill last logits, kernel vs plain attention",
             res.prefill_logits.float(), last, failures)
    print(f"{tag} bf16 prefill, kernel vs plain attention (information): routed pairs whose "
          "expert differs, by layer: " + ", ".join(
              f"{float((a != b).float().mean()):.2%}"
              for (a, _), (b, _) in zip(kern.calls, plain.calls)))
    del last, res, kern, plain

    # The serve gate in fp32 at MOE_GATE_LAYERS layers of the same weights:
    # the prefill's last logits and 4 decode steps after it.
    G = MOE_GATE_LAYERS
    params32 = {k: (v[:G] if k.startswith("blocks/") else v).float() for k, v in params.items()}
    del model, params
    torch.cuda.empty_cache()
    model32 = Model(cfg.replace(n_layers=G, dtype="float32", logit_dtype="float32"), dev)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (BATCH, 4), generator=g, device=dev)
    lk, sk = prefill_then_decode(torch, model32, params32, prompts, tokens, failures)
    lp, sp = prefill_then_decode(torch, model32, params32, prompts, tokens, failures, plain=True)
    gate(torch, f"{tag} fp32 at full width and {G} layers, prefill last logits, kernel vs plain "
         "attention", lk, lp, failures)
    gate(torch, f"{tag} fp32 at full width and {G} layers, 4 decode steps after the prefill, "
         "kernel vs plain attention", sk, sp, failures)
    del params32, model32, lk, lp, sk, sp
    torch.cuda.empty_cache()

    # Training at MOE_TRAIN_LAYERS layers through repro_torch.launch.train.
    tcfg = full.replace(n_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, state, step_fn = train_cli.build(tcfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    print(f"{tag} train: depth cut to {tcfg.n_layers} layers, {n_params / 1e9:.3f} B params as "
          f"fp32 masters (params, grads and AdamW mu / nu: {16 * n_params / 1e9:.1f} GB), compute "
          f"{tcfg.dtype}, remat {tcfg.remat}; initialised in {time.perf_counter() - t0:.1f}s")
    data = SyntheticTokens(tcfg, BATCH, TRAIN_SEQ, seed=0)

    def dropped(params, batch) -> str:
        """The share of routed pairs each layer drops in a forward of batch."""
        drops = Routes()
        with torch.no_grad():
            drops.record(layers, lambda: model.loss(params, to_device(batch, dev)))
        return ", ".join(f"layer {i} {drops.dropped([c]):.2%}" for i, c in enumerate(drops.calls))

    at_init = dropped(state.params, data.sample(0))
    reset_counts()
    state, records = train_cli.train(model, state, step_fn, data.iter(), TRAIN_STEPS,
                                     log=lambda line: print(f"{tag} {line}"))
    path = f"train {MOE}"
    counts[path] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for r in records:
        print(f"{tag} step {r.step}: loss {r.loss:.4f}, grad norm {r.grad_norm:.4f}, "
              f"{r.seconds * 1e3:.1f} ms")
    step_s = statistics.median(r.seconds for r in records[1:])
    print(f"{tag} step time {step_s * 1e3:.1f} ms (median of steps 1-{TRAIN_STEPS - 1}; step 0, "
          f"cold, {records[0].seconds * 1e3:.1f} ms), {BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, "
          f"peak memory {peak / 2**30:.1f} GiB ({peak / 1e9:.1f} GB), on {card_label(dev)}")
    finite = all(math.isfinite(r.loss) and math.isfinite(r.grad_norm) for r in records)
    print(f"{tag} every loss and grad norm finite: {finite}")
    if not finite:
        failures.append(f"non-finite loss or grads in the {MOE} train run")
    for name, want in train_launches(tcfg).items():
        got = counts[path][name]
        print(f"{tag} {name} launches: {got} in {TRAIN_STEPS} steps (expected "
              f"{TRAIN_STEPS} x {want} = {TRAIN_STEPS * want})")
        if got != TRAIN_STEPS * want:
            failures.append(f"{path}: {name} launched {got} times, expected {TRAIN_STEPS * want}")
    print(f"{tag} routed pairs dropped in a train batch's forward (capacity {cap_pre}): at "
          f"init, batch 0: {at_init}; after the {TRAIN_STEPS} steps, batch {TRAIN_STEPS}: "
          f"{dropped(state.params, data.sample(TRAIN_STEPS))}")
    del model, state, step_fn
    torch.cuda.empty_cache()
    step_gate(torch, dev, full, 1, to_device(data.sample(0), dev), tag, "plain attention",
              failures)


# ---------------------------------------------------- the five families --

# The families of the phases after phi35_moe_42b, each at its published
# widths and head layout through the entry points a user calls: served
# through ``repro_torch.launch.serve`` (batch 8, prompt 512, 64 greedy
# tokens, bf16) at ``serve`` layers, the full depth where one card holds it;
# their fp32 serve gate at ``gate`` layers; trained through
# ``repro_torch.launch.train`` (8 x 512, fp32 masters, AdamW, remat) at
# ``train`` layers for FAMILY_TRAIN_STEPS steps, and the fp32 step gate at
# ``step_gate`` layers.  ``train`` None: one layer's fp32 params, grads and
# AdamW state do not fit one card (the phase prints the reckoning). yi_34b
# serves whole: 68.8 GB of bf16 params, drawn and cast layer by layer, under
# FAMILY_SERVE_PEAK with its cache and prefill.
FAMILIES = {
    "qwen2_vl_7b": dict(serve=28, gate=2, train=8, step_gate=1),
    "musicgen_medium": dict(serve=48, gate=4, train=48, step_gate=2),
    "yi_34b": dict(serve=60, gate=2, train=4, step_gate=1),
    "llama4_scout_17b": dict(serve=8, gate=2, train=None, step_gate=None),
    "command_r_plus_104b": dict(serve=8, gate=2, train=None, step_gate=None),
}
FAMILY_TRAIN_STEPS = 3
# The flex_attention timings (information, the last phase; ~95 s, most of
# it compiling) run only while the run has used less than this: the
# host-bound phases before them took 1.5-2x longer on one card machine
# than on another.
FLEX_BY_S = 950
FAMILY_SERVE_PEAK = 76 * 2**30
CARD_BYTES = 80e9


def family_phase(torch, dev, arch, fa_entry, bwd_entry, failures, counts):
    """One of ``FAMILIES`` served, then trained (or its reckoning)."""
    run = FAMILIES[arch]
    family_serve(torch, dev, arch, run, fa_entry, failures, counts)
    torch.cuda.empty_cache()
    if not failures:
        family_train(torch, dev, arch, run, bwd_entry, failures, counts)
    torch.cuda.empty_cache()


def family_serve(torch, dev, arch, run, fa_entry, failures, counts):
    """``arch`` at full width and ``run["serve"]`` layers through
    ``repro_torch.launch.serve`` (bf16, batch 8, prompt 512, 64 tokens):
    prefill ms, decode ms a step and tok/s, peak memory and the init's
    wall; finite logits, one attention launch a layer in the prefill and
    in each decode step and no other kernel, the peak under
    FAMILY_SERVE_PEAK; the attention kernel at the model's prefill and
    decode shapes against ``attention_ref``, timed beside its bound, the
    plain version and SDPA; the share of routed pairs dropped (MoE); the
    bf16 gap to the plain attention (printed); then the fp32 prefill's
    last logits and 4 decode steps after it at ``run["gate"]`` layers of
    the same weights, kernel against plain attention, within MODEL_TOL."""
    from repro_torch.configs import arch_config
    from repro_torch.launch import serve
    from repro_torch.models import Model, layers

    tag = f"[{arch}]"
    full = arch_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, params = serve.build_model(arch, full=True, device=dev, seed=0, layers=run["serve"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    n_params = sum(p.numel() for p in params.values())
    extra = (f", M-RoPE sections {cfg.mrope_sections}" if cfg.mrope_sections else "") + (
        f", {cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts} shared of d_ff "
        f"{cfg.d_ff}, capacity factor {cfg.capacity_factor}" if cfg.n_experts else "")
    print(f"{tag} {cfg.name} at full width: d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv x {cfg.hd} (GQA group {cfg.q_per_kv}){extra}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}; {cfg.n_layers} of {full.n_layers} layers: {n_params / 1e9:.3f} B "
          f"params in {cfg.dtype} ({2 * n_params / 1e9:.1f} GB; the whole model "
          f"{full.param_count() / 1e9:.2f} B), drawn and cast layer by layer in {init_s:.1f} s "
          f"(peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB)")
    prompts = serve.make_prompts(model, BATCH, PROMPT, seed=1)
    cold = serve.generate(model, params, prompts[:, :16], 4)
    print(f"{tag} warm-up (prompt 16, 4 tokens): prefill {cold.prefill_s * 1e3:.1f} ms, "
          f"decode {cold.decode_s * 1e3:.1f} ms, finite {cold.finite}")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = serve.generate(model, params, prompts, GEN)
    counts[arch] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"{tag} prefill {BATCH}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_tok_s:.1f} tok/s ({GEN - 1} steps in {res.decode_s:.3f}s, {step_ms:.2f} ms "
          f"a step); peak memory {peak / 2**30:.2f} GiB (gate {FAMILY_SERVE_PEAK / 2**30:.0f} GiB)")
    print(f"{tag} sample output ids: {res.generated[0, :12].tolist()}")
    for name, want in (("flash_attention", cfg.n_layers * GEN), ("flash_attention_bwd", 0),
                       ("ssd", 0), ("mlstm", 0), ("flash_attention_lse", 0)):
        got = counts[arch][name]
        print(f"{tag} {name} launches: {got} (expected {want})")
        if got != want:
            failures.append(f"{arch}: {name} launched {got} times, expected {want}")
    if not (res.finite and cold.finite):
        failures.append(f"non-finite logits in the {arch} serve run")
    if peak >= FAMILY_SERVE_PEAK:
        failures.append(f"{arch} served at {peak / 2**30:.2f} GiB, past "
                        f"{FAMILY_SERVE_PEAK / 2**30:.0f} GiB")

    # The attention kernel at this model's serve shapes, in its layout.
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    att = {}
    for label, Sq, Sk, causal, seed in (("prefill", PROMPT, PROMPT, True, 1500),
                                        ("decode", 1, PROMPT + GEN - 1, False, 1510)):
        q = model_layout(torch, BATCH, H, Sq, D, "bfloat16", seed, dev)
        if Sq > 1:
            kv_sets = [tuple(model_layout(torch, BATCH, KV, Sk, D, "bfloat16", seed + i, dev)
                             for i in (1, 2))]
        else:
            kv_sets = decode_sets(torch, BATCH, KV, Sk, D, seed + 1, dev)
        shape = f"{label} ({BATCH},{H},{Sq},{D}) kv {KV} Sk {Sk}{' causal' if causal else ''} bf16"
        err = attention_check(torch, tag, shape, q, *kv_sets[0], "bfloat16", failures,
                              causal=causal)
        att[label] = {"shape": shape, "max_abs_err": err,
                      **attention_timings(torch, q, kv_sets, causal, dev)}
        print_attention_time(f"{arch} {shape}", att[label], q)
        del q, kv_sets
    fa_entry[arch] = att
    print(f"{tag} attention kernel share: prefill "
          f"{attention_share([(cfg.n_layers, att['prefill'])], res.prefill_s * 1e3)}; decode at most "
          f"{cfg.n_layers} x {att['decode']['ms']:.4f} ms = "
          f"{cfg.n_layers * att['decode']['ms'] / step_ms:.1%} of a step")

    if cfg.n_experts:
        # the same run's routing, counted (not the timed run)
        drops = Routes()
        drops.record(layers, lambda: serve.generate(model, params, prompts, GEN))
        L = cfg.n_layers
        cap_pre = max(int(BATCH * PROMPT * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
        cap_dec = max(int(BATCH * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
        print(f"{tag} routed (token, expert) pairs dropped past the capacity: prefill "
              f"{drops.dropped(drops.calls[:L]):.2%} (capacity {cap_pre} per expert, {L} calls), "
              f"decode {drops.dropped(drops.calls[L:]):.2%} (capacity {cap_dec}, "
              f"{len(drops.calls) - L} calls)")
        del drops

    # Information: the served bf16 prefill against the same with the
    # plain attention (rounding over the layers, not a tolerance).
    last = last_logits(torch, model, params, prompts, failures, plain=True)
    bf16_gap(torch, f"{tag} bf16 prefill last logits, kernel vs plain attention",
             res.prefill_logits.float(), last, failures)
    del last, res

    # The gate in fp32 at run["gate"] layers of the same weights, each leaf
    # cut and cast as the bf16 one is let go (yi_34b's bf16 copy and an
    # fp32 one would not fit together).
    G = run["gate"]
    params32 = {}
    for k in list(params):
        v = params.pop(k)
        params32[k] = (v[:G] if k.startswith("blocks/") else v).float()
        del v
    del model, params
    torch.cuda.empty_cache()
    model32 = Model(cfg.replace(n_layers=G, dtype="float32", logit_dtype="float32"), dev)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (BATCH, 4), generator=g, device=dev)
    lk, sk = prefill_then_decode(torch, model32, params32, prompts, tokens, failures)
    lp, sp = prefill_then_decode(torch, model32, params32, prompts, tokens, failures, plain=True)
    gate(torch, f"{tag} fp32 at full width and {G} layers, prefill last logits, kernel vs plain "
         "attention", lk, lp, failures)
    gate(torch, f"{tag} fp32 at full width and {G} layers, 4 decode steps after the prefill, "
         "kernel vs plain attention", sk, sp, failures)
    del params32, model32, lk, lp, sk, sp


def family_train(torch, dev, arch, run, bwd_entry, failures, counts):
    """``arch`` at full width and ``run["train"]`` layers trained
    FAMILY_TRAIN_STEPS steps on 8 x 512 through ``repro_torch.launch.train``
    (fp32 masters, bf16, remat, seed 0; qwen2_vl and musicgen on
    ``SyntheticTokens``' embeddings, qwen2_vl with its (3, B, S)
    positions): finite losses and grad norms, step ms, tokens/s, peak
    memory, the attention kernels' calls a step; the backward kernel at
    the model's train shape against autograd of ``attention_ref``, timed
    beside its bound, the plain version's backward and SDPA's; then the
    fp32 step gate at ``run["step_gate"]`` layers.  Where one card cannot
    hold a layer (``run["train"]`` None), the reckoning instead."""
    from repro_torch.configs import arch_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.device import card_label
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import train as train_cli

    tag = f"[train {arch}]"
    full = arch_config(arch)
    layer = full.replace(n_layers=1).param_count() - full.replace(n_layers=0).param_count()
    one = full.replace(n_layers=1).param_count()
    if run["train"] is None:
        print(f"{tag} not trained on one card: one layer at full width is {layer / 1e9:.3f} B "
              f"params and the embedding and head {(one - layer) / 1e9:.3f} B; at 1 layer the "
              f"fp32 params, grads and AdamW mu / nu (16 bytes a param) take "
              f"{16 * one / 1e9:.1f} GB before activations, {20 * one / 1e9:.1f} GB with the fp32 "
              f"step gate's copy of the grads, against the card's {CARD_BYTES / 1e9:.0f} GB; it "
              "waits for more than one card")
        return

    # The backward kernel at this model's train shape, in its layout.
    H, KV, D = full.n_heads, full.n_kv_heads, full.hd
    q, dout = (model_layout(torch, BATCH, H, TRAIN_SEQ, D, "bfloat16", 1600 + n, dev)
               for n in (0, 3))
    k, v = (model_layout(torch, BATCH, KV, TRAIN_SEQ, D, "bfloat16", 1600 + n, dev)
            for n in (1, 2))
    shape = f"train ({BATCH},{H},{TRAIN_SEQ},{D}) kv {KV} causal bf16"
    got = fa.flash_attention_bwd_cuda(q, k, v, fa.flash_attention_cuda(q, k, v, causal=True),
                                      dout, causal=True)
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*ref_in, causal=True), ref_in, dout.float())
    errs = [float((a.float() - b).abs().max()) for a, b in zip(got, want)]
    ok = all(bool(torch.isfinite(a).all()) and torch.allclose(a.float(), b, **GRAD_TOL["bfloat16"])
             for a, b in zip(got, want))
    print(f"{tag} flash_attention_bwd {shape}: max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} "
          f"dv {errs[2]:.3e} against autograd of attention_ref "
          f"(rtol={GRAD_TOL['bfloat16']['rtol']}, atol={GRAD_TOL['bfloat16']['atol']}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{tag} flash_attention_bwd {shape}: max_abs_err {max(errs):.3e}")
    del got, want, ref_in
    t = attention_bwd_timings(torch, q, k, v, dout, dev)
    path = BWD_PATHS["bfloat16"]
    print(f"[time] flash_attention_bwd {arch} {shape}: kernel {t['ms']:.4f} ms ({path['route']}: "
          f"{' + '.join(path['kernels'])}), plain {t['plain_ms']:.4f} ms (autograd of "
          f"attention_ref, backward only), sdpa backward {t['library_ms']:.4f} ms, bound "
          f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    bwd_entry[arch] = {"shape": shape, "max_abs_err": max(errs), **t}
    del q, k, v, dout
    torch.cuda.empty_cache()

    cfg = full.replace(n_layers=run["train"])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, state, step_fn = train_cli.build(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    inputs = "embeddings" if cfg.embed_inputs else "tokens"
    print(f"{tag} full width, {cfg.n_layers} of {full.n_layers} layers: {n_params / 1e9:.3f} B "
          f"params as fp32 masters (params, grads and AdamW mu / nu: {16 * n_params / 1e9:.1f} "
          f"GB), compute {cfg.dtype}, remat {cfg.remat}, loss chunk {cfg.loss_chunk}; "
          f"{BATCH} x {TRAIN_SEQ} {inputs}"
          f"{', (3, B, S) M-RoPE positions' if cfg.mrope_sections else ''}; initialised in "
          f"{time.perf_counter() - t0:.1f}s")
    data = SyntheticTokens(cfg, BATCH, TRAIN_SEQ, seed=0)
    reset_counts()
    state, records = train_cli.train(model, state, step_fn, data.iter(), FAMILY_TRAIN_STEPS,
                                     log=lambda line: print(f"{tag} {line}"))
    path = f"train {arch}"
    counts[path] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for r in records:
        print(f"{tag} step {r.step}: loss {r.loss:.4f}, grad norm {r.grad_norm:.4f}, "
              f"{r.seconds * 1e3:.1f} ms")
    step_s = statistics.median(r.seconds for r in records[1:])
    print(f"{tag} step time {step_s * 1e3:.1f} ms (median of steps 1-{FAMILY_TRAIN_STEPS - 1}; "
          f"step 0, cold, {records[0].seconds * 1e3:.1f} ms), {BATCH * TRAIN_SEQ / step_s:.0f} "
          f"tokens/s, peak memory {peak / 2**30:.1f} GiB ({peak / 1e9:.1f} GB), on "
          f"{card_label(dev)}")
    finite = all(math.isfinite(r.loss) and math.isfinite(r.grad_norm) for r in records)
    print(f"{tag} every loss and grad norm finite: {finite}")
    if not finite:
        failures.append(f"non-finite loss or grads in the {arch} train run")
    per_step = train_launches(cfg)
    for name, want in per_step.items():
        got = counts[path][name]
        print(f"{tag} {name} launches: {got} in {FAMILY_TRAIN_STEPS} steps (expected "
              f"{FAMILY_TRAIN_STEPS} x {want} = {FAMILY_TRAIN_STEPS * want})")
        if got != FAMILY_TRAIN_STEPS * want:
            failures.append(f"{path}: {name} launched {got} times, expected "
                            f"{FAMILY_TRAIN_STEPS * want}")
    bwd_ms = per_step["flash_attention_bwd"] * t["ms"]
    print(f"{tag} attention backward share of a step: {per_step['flash_attention_bwd']} x "
          f"{t['ms']:.4f} ms = {bwd_ms:.1f} ms, {bwd_ms / (step_s * 1e3):.1%}")
    del model, state, step_fn
    torch.cuda.empty_cache()
    step_gate(torch, dev, full, run["step_gate"], to_device(data.sample(0), dev), tag,
              "plain attention", failures)


# ------------------------------------------------------------------- train --


def train_phase(torch, dev, fa_entry, bwd_entry, failures, counts) -> int:
    """Full stablelm_3b trained 4 steps through ``repro_torch.launch.train``,
    then the fp32 gate at full width and 4 layers against the plain twin.
    Returns the peak memory of the 4 steps (bytes)."""
    from repro_torch.configs import arch_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.device import card_label
    from repro_torch.launch import train as train_cli

    cfg = arch_config(ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, state, step_fn = train_cli.build(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"x {cfg.hd}, {n_params / 1e9:.3f} B params as fp32 masters (params, grads and AdamW "
          f"mu / nu: {16 * n_params / 1e9:.1f} GB), compute {cfg.dtype}, remat {cfg.remat}; "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    data = SyntheticTokens(cfg, BATCH, TRAIN_SEQ, seed=0)

    reset_counts()
    state, records = train_cli.train(model, state, step_fn, data.iter(), TRAIN_STEPS,
                                     log=lambda line: print(f"[train] {line}"))
    path = f"train {ARCH}"
    counts[path] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for r in records:
        print(f"[train] step {r.step}: loss {r.loss:.4f}, grad norm {r.grad_norm:.4f}, "
              f"{r.seconds * 1e3:.1f} ms")
    step_s = statistics.median(r.seconds for r in records[1:])
    print(f"[train] step time {step_s * 1e3:.1f} ms (median of steps 1-{TRAIN_STEPS - 1}; step 0, "
          f"cold, {records[0].seconds * 1e3:.1f} ms), {BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, "
          f"peak memory {peak / 2**30:.1f} GiB ({peak / 1e9:.1f} GB), on {card_label(dev)}")
    if not all(math.isfinite(r.loss) and math.isfinite(r.grad_norm) for r in records):
        failures.append("non-finite loss or grads in the stablelm_3b train run")
    print("[train] every loss and grad norm finite (the fp32 global norm is finite only if "
          f"every grad element is): {all(math.isfinite(r.grad_norm) for r in records)}")
    per_step = train_launches(cfg)
    for name, want in per_step.items():
        got = counts[path][name]
        print(f"[train] {name} launches: {got} in {TRAIN_STEPS} steps (expected "
              f"{TRAIN_STEPS} x {want} = {TRAIN_STEPS * want})")
        if got != TRAIN_STEPS * want:
            failures.append(f"{path}: {name} launched {got} times, expected {TRAIN_STEPS * want}")
    bwd_ms = per_step["flash_attention_bwd"] * bwd_entry["ms"]
    print(f"[train] attention kernel shares of a step: forward "
          f"{attention_share([(per_step['flash_attention'], fa_entry)], step_s * 1e3)}, backward "
          f"{per_step['flash_attention_bwd']} x {bwd_entry['ms']:.4f} ms = "
          f"{bwd_ms / (step_s * 1e3):.1%}")
    profile_train_step(torch, model, state, step_fn, to_device(data.sample(TRAIN_STEPS), dev),
                       cfg.dtype, failures)
    del model, state, step_fn
    torch.cuda.empty_cache()

    # Information: the same 4 steps from the same seed with the plain
    # attention.  Both run bf16 compute, whose rounding differs between the
    # two paths and grows over the steps, so the losses are printed beside
    # each other, not gated (the fp32 gate below holds the kernels).
    model, state, step_fn = train_cli.build(cfg, device=dev, seed=0)
    with plain_versions(failures):
        _, plain = train_cli.train(model, state, step_fn, data.iter(), TRAIN_STEPS,
                                   log=lambda line: None)
    print("[train] the same steps with the plain attention (information): losses "
          + ", ".join(f"{r.loss:.4f}" for r in plain) + " against the kernels' "
          + ", ".join(f"{r.loss:.4f}" for r in records) + "; grad norms "
          + ", ".join(f"{r.grad_norm:.4f}" for r in plain) + " against "
          + ", ".join(f"{r.grad_norm:.4f}" for r in records))
    if not all(math.isfinite(r.loss) for r in plain):
        failures.append("non-finite loss in the plain-attention train run")
    del model, state, step_fn
    torch.cuda.empty_cache()

    # The gate: full width, 4 layers, fp32 (TF32 off, as main() sets), one
    # step through the kernels against the same step with the plain
    # attention; then the same in bf16, printed.
    step_gate(torch, dev, cfg, GATE_LAYERS, to_device(data.sample(0), dev), "[train]",
              "plain attention", failures)
    return peak


def step_gate(torch, dev, cfg, layers, batch, tag, plain_name, failures):
    """At full width and ``layers`` layers, one fp32 step through the
    kernels against the same step with the plain versions (``plain_name``):
    the loss, every grad leaf (MODEL_TOL, and a relative rms of at most
    GRAD_REL_RMS) and the params after AdamW; then the same in bf16,
    printed.  Each step draws its params from seed 0 anew (no copy is
    held), and the first step's grads and params wait on the host, so the
    card holds one step's params, grads and AdamW state at a time."""
    from repro_torch.models import Model

    n = cfg.replace(n_layers=layers).param_count()
    print(f"{tag} step gate at {layers} layers: {n / 1e9:.3f} B params; the card holds one "
          f"step's fp32 params, grads, AdamW mu / nu and a copy of the grads "
          f"({20 * n / 1e9:.1f} GB) beside the activations of batch "
          f"{tuple(batch['labels'].shape)}; the host the first step's grads and params "
          f"({8 * n / 1e9:.1f} GB)")
    for dtype in ("float32", "bfloat16"):
        small = cfg.replace(n_layers=layers, dtype=dtype, logit_dtype=dtype)
        model = Model(small, dev)
        got = one_step(torch, model, batch, failures, host=True)
        want = one_step(torch, model, batch, failures, plain=True)
        label = (f"{tag} {dtype} step at full width, depth cut to {layers} layers, "
                 f"kernels vs {plain_name}")
        loss_err = abs(got[0] - want[0])
        grads = {k: (got[1][k].to(dev), want[1][k]) for k in want[1]}
        worst = max(((rel_rms(torch, a, b), k) for k, (a, b) in grads.items()))
        ok_grads = all(torch.allclose(a, b, **MODEL_TOL) for a, b in grads.values())
        del grads
        p_err, ok_params = 0.0, True
        for k in want[2]:
            a = got[2][k].to(dev)
            p_err = max(p_err, float((a - want[2][k]).abs().max()))
            ok_params = ok_params and torch.allclose(a, want[2][k], **MODEL_TOL)
            del a
        if dtype == "float32":
            ok_loss = loss_err <= MODEL_TOL["atol"] + MODEL_TOL["rtol"] * abs(want[0])
            ok_grads = worst[0] <= GRAD_REL_RMS and ok_grads
            print(f"{label}: loss {got[0]:.6f} vs {want[0]:.6f} (|gap| {loss_err:.3e}, "
                  f"rtol={MODEL_TOL['rtol']}, atol={MODEL_TOL['atol']}) "
                  f"{'ok' if ok_loss else 'FAIL'}; grads: worst leaf relative rms {worst[0]:.3e} "
                  f"({worst[1]}; at most {GRAD_REL_RMS}, and each leaf within rtol/atol) "
                  f"{'ok' if ok_grads else 'FAIL'}; params after AdamW max_abs_err {p_err:.3e} "
                  f"{'ok' if ok_params else 'FAIL'}")
            for ok, what in ((ok_loss, "loss"), (ok_grads, "grads"), (ok_params, "params")):
                if not ok:
                    failures.append(f"{tag} fp32 train gate: {what}")
        else:
            print(f"{label} (information): loss {got[0]:.6f} vs {want[0]:.6f} (|gap| "
                  f"{loss_err:.3e}); grads: worst leaf relative rms {worst[0]:.3e} ({worst[1]}); "
                  f"params after AdamW max_abs_err {p_err:.3e}")
            if not math.isfinite(got[0]) or not math.isfinite(want[0]):
                failures.append(f"{tag} bf16 train gate: non-finite loss")
        del model, got, want
        torch.cuda.empty_cache()


def gemma2_train_phase(torch, dev, fa_entry, bwd_entry, failures, counts):
    """Full-width gemma2_9b at GEMMA2_TRAIN_LAYERS layers trained
    TRAIN_STEPS steps on batch 1 x GEMMA2_TRAIN_SEQ through
    ``repro_torch.launch.train`` (fp32 masters, bf16, remat, seed 0):
    finite losses and grad norms, the attention kernels' calls a step, a
    profiled step (the bf16 backward kernels by name), step time,
    tokens/s, peak memory and the attention backward's share; then the
    fp32 step gate at GEMMA2_STEP_GATE_LAYERS layers on 1 x
    GEMMA2_STEP_GATE_SEQ."""
    from repro_torch.configs import arch_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.device import card_label
    from repro_torch.launch import train as train_cli
    from repro_torch.models.transformer import local_layers

    tag = f"[train {GEMMA2}]"
    full = arch_config(GEMMA2)
    cfg = full.replace(n_layers=GEMMA2_TRAIN_LAYERS)
    S = GEMMA2_TRAIN_SEQ
    n_loc = len(local_layers(cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, state, step_fn = train_cli.build(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    print(f"{tag} full width (d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv x "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, softcaps {cfg.attn_softcap} / "
          f"{cfg.final_softcap}), depth cut from {full.n_layers} to {cfg.n_layers} layers "
          f"({n_loc} local with window {cfg.sliding_window}, {cfg.n_layers - n_loc} global): "
          f"{n_params / 1e9:.3f} B params as fp32 masters (params, grads and AdamW mu / nu: "
          f"{16 * n_params / 1e9:.1f} GB), compute {cfg.dtype}, remat {cfg.remat}; batch 1 x {S}; "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    data = SyntheticTokens(cfg, 1, S, seed=0)
    reset_counts()
    state, records = train_cli.train(model, state, step_fn, data.iter(), TRAIN_STEPS,
                                     log=lambda line: print(f"{tag} {line}"))
    path = f"train {GEMMA2}"
    counts[path] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for r in records:
        print(f"{tag} step {r.step}: loss {r.loss:.4f}, grad norm {r.grad_norm:.4f}, "
              f"{r.seconds * 1e3:.1f} ms")
    step_s = statistics.median(r.seconds for r in records[1:])
    print(f"{tag} step time {step_s * 1e3:.1f} ms (median of steps 1-{TRAIN_STEPS - 1}; step 0, "
          f"cold, {records[0].seconds * 1e3:.1f} ms; {EARLIER_GEMMA2['train step']} with the "
          f"mma.sync D 256 backward), {S / step_s:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.1f} GiB ({peak / 1e9:.1f} GB), on {card_label(dev)}")
    finite = all(math.isfinite(r.loss) and math.isfinite(r.grad_norm) for r in records)
    print(f"{tag} every loss and grad norm finite: {finite}")
    if not finite:
        failures.append(f"non-finite loss or grads in the {GEMMA2} train run")
    for name, want in train_launches(cfg).items():
        got = counts[path][name]
        print(f"{tag} {name} launches: {got} in {TRAIN_STEPS} steps (expected "
              f"{TRAIN_STEPS} x {want} = {TRAIN_STEPS * want})")
        if got != TRAIN_STEPS * want:
            failures.append(f"{path}: {name} launched {got} times, expected {TRAIN_STEPS * want}")
    t = bwd_entry[GEMMA2]
    bwd_ms = n_loc * t["local"]["ms"] + (cfg.n_layers - n_loc) * t["global"]["ms"]
    print(f"{tag} attention backward share of a step, from the kernel phase's times: {n_loc} x "
          f"{t['local']['ms']:.4f} + {cfg.n_layers - n_loc} x {t['global']['ms']:.4f} ms = "
          f"{bwd_ms:.1f} ms, {bwd_ms / (step_s * 1e3):.1%}")
    profile_train_step(torch, model, state, step_fn, to_device(data.sample(TRAIN_STEPS), dev),
                       cfg.dtype, failures, tag=tag)
    del model, state, step_fn
    torch.cuda.empty_cache()
    fwd = gemma2_train_fwd_timings(torch, dev, cfg)
    fa_entry[f"{GEMMA2} train"] = fwd
    fwd_ms = 2 * (n_loc * fwd["local"]["ms"] + (cfg.n_layers - n_loc) * fwd["global"]["ms"])
    print(f"{tag} attention forward share of a step (each layer's forward twice under remat): "
          f"2 x ({n_loc} x {fwd['local']['ms']:.4f} + {cfg.n_layers - n_loc} x "
          f"{fwd['global']['ms']:.4f}) ms = {fwd_ms:.1f} ms, {fwd_ms / (step_s * 1e3):.1%}")
    gate_data = SyntheticTokens(cfg, 1, GEMMA2_STEP_GATE_SEQ, seed=0)
    step_gate(torch, dev, full, GEMMA2_STEP_GATE_LAYERS, to_device(gate_data.sample(0), dev), tag,
              "plain attention", failures)


def gemma2_train_fwd_timings(torch, dev, cfg) -> dict:
    """The forward kernel at gemma2_9b's train shape (1, 16, GEMMA2_TRAIN_SEQ,
    256) KV 8 in the model's layout, the global (causal) and local (window)
    layers, beside the bound (``PREFILL_KERNEL``), the plain version,
    and SDPA without the softcap and window (not the same function)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    H, KV, D, S, W = cfg.n_heads, cfg.n_kv_heads, cfg.hd, GEMMA2_TRAIN_SEQ, cfg.sliding_window
    out = {}
    for label, window, seed in (("global", 0, 1700), ("local", W, 1710)):
        q = model_layout(torch, 1, H, S, D, "bfloat16", seed, dev)
        k, v = (model_layout(torch, 1, KV, S, D, "bfloat16", seed + i, dev) for i in (1, 2))
        opts = dict(causal=True, window=window, softcap=cfg.attn_softcap)
        ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, **opts), iters=10, reps=3)
        plain = time_ms(torch, lambda: ref.attention_ref(q, k, v, **opts), iters=2, reps=3)
        sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters=10, reps=3)
        bound, by = bound_ms(torch, q, k, v, causal=True, window=window, dev=dev)
        print(f"[time] flash_attention gemma2 train forward {label} (1,{H},{S},{D}) kv {KV} "
              f"causal{f' window {window}' if window else ''} softcap {cfg.attn_softcap:g} bf16 "
              f"({PREFILL_KERNEL}): kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{ms / bound:.2f}x, {bound / ms:.1%} of the bound's rate), plain {plain:.4f} ms, "
              f"sdpa causal without the softcap{' and window' if window else ''} (not the same "
              f"function) {sdpa:.4f} ms")
        shape = (f"(1,{H},{S},{D}) kv {KV} causal{f' window {window}' if window else ''}"
                 f" softcap {cfg.attn_softcap:g} bf16")
        out[label] = {"shape": shape, "ms": ms, "bound_ms": bound, "bound_by": by,
                      "plain_ms": plain, "library_ms": sdpa}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def train_launches(cfg) -> dict:
    """Kernel calls a train step makes: each layer's forward kernel once,
    twice under remat (the backward recomputes the layer), and its backward
    kernel once."""
    fwd = 1 + int(cfg.remat)
    attn = ssd = mlstm = 0
    if cfg.family == "hybrid":
        every = max(cfg.attn_every, 1)
        ssd = cfg.n_layers
        attn = sum(1 for i in range(cfg.n_layers) if i % every == every - 1)
    elif cfg.family == "ssm":
        mlstm = cfg.n_layers // cfg.xlstm_slstm_every * (cfg.xlstm_slstm_every - 1)
    else:
        attn = cfg.n_layers
    return {"flash_attention": fwd * attn, "flash_attention_bwd": attn, "ssd": fwd * ssd,
            "ssd_bwd": ssd, "mlstm": fwd * mlstm, "mlstm_bwd": mlstm}


def ssd_log_decay_span(torch, model, params, batch) -> float:
    """The largest |sum of dt A| over one chunk of any Mamba2 layer in a
    forward of ``batch`` at ``params``: the span past which exp of the
    upper triangle, unmasked, overflows fp32 (~88.7)."""
    from unittest import mock

    from repro_torch.kernels import ops

    spans = []
    real = ops.ssd_scan

    def recording(x, dt, A, Bmat, Cmat, *, chunk):
        a = torch.nn.functional.pad(dt * A, (0, 0, 0, (-dt.shape[1]) % chunk))
        spans.append(float(a.reshape(a.shape[0], -1, chunk, a.shape[-1]).sum(2).abs().max()))
        return real(x, dt, A, Bmat, Cmat, chunk=chunk)

    with torch.no_grad(), mock.patch.object(ops, "ssd_scan", recording):
        model.loss(params, batch)
    return max(spans)


def recurrent_train_phase(torch, dev, arch, failures, counts):
    """Full zamba2_1p2b or xlstm_125m trained RECURRENT_TRAIN_STEPS steps through
    ``repro_torch.launch.train`` (fp32 masters, bf16 compute, remat, 8 x
    512, seed 0): finite losses and grad norms and the kernels' calls a
    step; a profiled step; the same steps with the plain versions (printed);
    then the fp32 gate at full width and reduced depth against the plain
    twin."""
    from repro_torch.configs import arch_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.device import card_label
    from repro_torch.launch import train as train_cli

    tag = f"[train {arch}]"
    cfg = arch_config(arch)
    steps = RECURRENT_TRAIN_STEPS[arch]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, state, step_fn = train_cli.build(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    print(f"{tag} {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B params as "
          f"fp32 masters, compute {cfg.dtype}, remat {cfg.remat}; initialised in "
          f"{time.perf_counter() - t0:.1f}s")
    data = SyntheticTokens(cfg, BATCH, TRAIN_SEQ, seed=0)
    if cfg.family == "hybrid":
        span = ssd_log_decay_span(torch, model, state.params, to_device(data.sample(0), dev))
        print(f"{tag} largest per-chunk log-decay span |sum dt A| over every Mamba2 layer at "
              f"init, first batch: {span:.2f} (exp overflows fp32 past ~88.7: the vjp of an "
              f"exp masked after it would be NaN {'here' if span > 88.7 else 'only past it'})")

    reset_counts()
    state, records = train_cli.train(model, state, step_fn, data.iter(), steps,
                                     log=lambda line: print(f"{tag} {line}"))
    path = f"train {arch}"
    counts[path] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for r in records:
        print(f"{tag} step {r.step}: loss {r.loss:.4f}, grad norm {r.grad_norm:.4f}, "
              f"{r.seconds * 1e3:.1f} ms")
    step_s = statistics.median(r.seconds for r in records[1:])
    print(f"{tag} step time {step_s * 1e3:.1f} ms (median of steps 1-{steps - 1}; step 0, "
          f"cold, {records[0].seconds * 1e3:.1f} ms), {BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, "
          f"peak memory {peak / 2**30:.1f} GiB ({peak / 1e9:.1f} GB), on {card_label(dev)}")
    finite = all(math.isfinite(r.loss) and math.isfinite(r.grad_norm) for r in records)
    print(f"{tag} every loss and grad norm finite: {finite}")
    if not finite:
        failures.append(f"non-finite loss or grads in the {arch} train run")
    for name, want in train_launches(cfg).items():
        got = counts[path][name]
        print(f"{tag} {name} launches: {got} in {steps} steps (expected "
              f"{steps} x {want} = {steps * want})")
        if got != steps * want:
            failures.append(f"{path}: {name} launched {got} times, expected {steps * want}")
    profile_train_step(torch, model, state, step_fn, to_device(data.sample(steps), dev),
                       cfg.dtype, failures, tag=tag, attention=cfg.family == "hybrid",
                       ssd=cfg.family == "hybrid", mlstm=arch == XLSTM)
    del model, state, step_fn
    torch.cuda.empty_cache()

    # Information: the same steps with the plain versions (bf16 rounding
    # differs between the two paths and grows over the steps).
    model, state, step_fn = train_cli.build(cfg, device=dev, seed=0)
    with plain_versions(failures):
        _, plain = train_cli.train(model, state, step_fn, data.iter(), steps,
                                   log=lambda line: None)
    print(f"{tag} the same steps with the plain versions (information): losses "
          + ", ".join(f"{r.loss:.4f}" for r in plain) + " against the kernels' "
          + ", ".join(f"{r.loss:.4f}" for r in records) + "; grad norms "
          + ", ".join(f"{r.grad_norm:.4f}" for r in plain) + " against "
          + ", ".join(f"{r.grad_norm:.4f}" for r in records))
    if not all(math.isfinite(r.loss) for r in plain):
        failures.append(f"non-finite loss in the plain {arch} train run")
    del model, state, step_fn
    torch.cuda.empty_cache()
    step_gate(torch, dev, cfg, RECURRENT_GATE_LAYERS[arch], to_device(data.sample(0), dev), tag,
              "plain versions", failures)


def elastic_phase(torch, dev, train_peak, failures, counts):
    """Full stablelm_3b through the elastic loop on ``steady-cycle``, then
    the RESTART gate of ``restart-vs-shrink`` at full width, 4 layers."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import restore_tree
    from repro_torch.configs import arch_config
    from repro_torch.device import card_label
    from repro_torch.elastic import ElasticTrainer, PytreeBytesModel
    from repro_torch.malleability import get_scenario, record_parity_key, run_scenario_sim
    from repro_torch.malleability.scenarios import RuntimeAdapter, param_bytes_for_arch
    from repro_torch.models import Model

    label = card_label(dev)
    cfg = arch_config(ARCH)
    sc = get_scenario(ELASTIC_SCENARIO)
    model = Model(cfg, dev)
    engine = dataclasses.replace(sc.default_engine(), bytes_model=PytreeBytesModel(model))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = ElasticTrainer.from_scenario(model, sc, engine=engine, lr=3e-4, batch=BATCH,
                                           seq=TRAIN_SEQ)
    trainer._init_state()
    torch.cuda.synchronize()
    print(f"[elastic] {cfg.name} on {sc.name!r}: {sc.pool_nodes()} logical slots, all on this "
          f"card ({label}); stage 3 records placements and moves no byte, and est/downtime are "
          f"the {sc.profile} cost model's modelled cluster times, not card times; initialised "
          f"in {time.perf_counter() - t0:.1f}s")

    reset_counts()
    t0 = time.perf_counter()
    hist = trainer.run(ELASTIC_STEPS)
    path = f"elastic {ARCH}"
    counts[path] = read_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[elastic] {ELASTIC_STEPS} steps in {wall:.1f}s; losses "
          + ", ".join(f"{r.loss:.4f}" for r in hist))
    print("[elastic] step times (ms, host clock ended by the loss's sync): "
          + ", ".join(f"{r.seconds * 1e3:.1f}" for r in hist))
    nodes = [r.n_nodes for r in hist]
    want_nodes = [1] * 5 + [4] * 5 + [1] * 5 + [4] * 5 + [1] * 5
    print(f"[elastic] nodes per step: {nodes}")
    if nodes != want_nodes:
        failures.append(f"{path}: nodes per step {nodes}, expected {want_nodes}")
    if not all(math.isfinite(r.loss) for r in hist):
        failures.append(f"{path}: non-finite loss")
    for n in sorted(set(nodes)):
        times = [r.seconds for r in hist[1:] if r.n_nodes == n]
        print(f"[elastic] step time at {n} node(s): {statistics.median(times) * 1e3:.1f} ms "
              f"(median of {len(times)}; min {min(times) * 1e3:.1f}, max "
              f"{max(times) * 1e3:.1f}) on {label}")

    # records against the simulator with the same engine
    sim = run_scenario_sim(sc, engine=engine)
    sim = [r for r in sim if r.step < ELASTIC_STEPS]
    got = [record_parity_key(RuntimeAdapter._convert(r))[1:] for r in trainer.runtime.history]
    want = [record_parity_key(r)[1:] for r in sim]
    if len(got) != 4 or got != want:
        failures.append(f"{path}: records {got} differ from the simulator's {want}")
    total = param_bytes_for_arch(ARCH)
    for rec, w, t in zip(trainer.runtime.history, trainer.wall_log, trainer.transfer_log):
        print(f"[elastic] step {w['step']} {rec.kind} {rec.mechanism} {rec.nodes_before}->"
              f"{rec.nodes_after}: host wall on the card {w['host_s'] * 1e3:.2f} ms ({label}); "
              f"modelled cluster est {rec.est_wall_s * 1e3:.2f} ms, downtime "
              f"{rec.downtime_s * 1e3:.2f} ms; stage 3 bytes moved {t['bytes_moved']} "
              f"(charged {t['charged_bytes_moved']}), stayed {t['bytes_stayed']}, total "
              f"{t['bytes_total']} (the pytree: {total})")
        if t["bytes_moved"] != t["charged_bytes_moved"] or t["bytes_total"] != total:
            failures.append(f"{path}: stage 3 at step {t['step']} logged {t}")
    if len(trainer.transfer_log) != 4:
        failures.append(f"{path}: {len(trainer.transfer_log)} stage-3 entries, expected 4")
    per_step = train_launches(cfg)
    for name, n in per_step.items():
        print(f"[elastic] {name} launches: {counts[path][name]} (expected "
              f"{ELASTIC_STEPS} x {n} = {ELASTIC_STEPS * n})")
        if counts[path][name] != ELASTIC_STEPS * n:
            failures.append(f"{path}: {name} launched {counts[path][name]} times")
    print(f"[elastic] peak memory {peak / 2**30:.2f} GiB against the train phase's "
          f"{train_peak / 2**30:.2f} GiB on {label}")
    if peak > train_peak:
        failures.append(f"{path}: peak memory {peak} above the train phase's {train_peak}")
    del trainer, model, engine
    torch.cuda.empty_cache()

    # RESTART at full width, 4 layers: the params right after it (step 5)
    # are the step-4 snapshot on disk, and the params the trainer held when
    # it saved that snapshot.  Six steps reach it.
    small = cfg.replace(n_layers=GATE_LAYERS)
    rsc = get_scenario("restart-vs-shrink")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = ElasticTrainer.from_scenario(Model(small, dev), rsc, lr=3e-4, batch=BATCH,
                                               seq=TRAIN_SEQ, checkpoint_dir=ckpt_dir,
                                               checkpoint_every=2)
        t0 = time.perf_counter()
        trainer.run(RESTART_STEP - 1)   # saves step 4's snapshot after step 3
        at_save = {k: p.detach().to("cpu", copy=True) for k, p in trainer.state.params.items()}
        # The params the first step after the RESTART starts from, as the
        # step function is handed them (read only; the step runs as it would).
        after_restart = {}
        step_fn = trainer._step_fn

        def observed_step(state, batch):
            if len(trainer.history) == RESTART_STEP:
                after_restart.update({k: p.detach().to("cpu", copy=True)
                                      for k, p in state.params.items()})
            return step_fn(state, batch)

        trainer._step_fn = observed_step
        hist = trainer.run(2)
        print(f"[elastic] {rsc.name!r} at full width, {GATE_LAYERS} layers: {len(hist)} steps "
              f"in {time.perf_counter() - t0:.1f}s, nodes {[r.n_nodes for r in hist]}")
        for rec, w in zip(trainer.runtime.history, trainer.wall_log):
            extra = ""
            if w["bytes_read"]:
                extra = (f"; of it {w['wait_s'] * 1e3:.2f} ms waiting for the last "
                         f"snapshot's write to land, then {w['bytes_read']} bytes read back "
                         f"from the store in {w['read_s'] * 1e3:.2f} ms, "
                         f"{w['bytes_read'] / w['read_s'] / 1e9:.2f} GB/s (disk, then host "
                         "to card; host clock)")
            print(f"[elastic]   step {w['step']} {rec.kind} {rec.mechanism} "
                  f"{rec.nodes_before}->{rec.nodes_after}: host wall on the card "
                  f"{w['host_s'] * 1e3:.2f} ms{extra} ({label}); modelled cluster est "
                  f"{rec.est_wall_s * 1e3:.2f} ms, downtime {rec.downtime_s * 1e3:.2f} ms")
        restored = {t["step"]: t["restored_from_step"] for t in trainer.transfer_log
                    if "restored_from_step" in t}
        snap = restore_tree({"params": trainer.state.params}, ckpt_dir,
                            RESTART_STEP - 1)["params"]
        same_disk = bool(after_restart) and all(
            torch.equal(after_restart[k], v) for k, v in snap.items())
        same_held = bool(after_restart) and all(
            torch.equal(after_restart[k], v) for k, v in at_save.items())
        print(f"[elastic] restores (step: snapshot step) {restored}; params right after the "
              f"RESTART bitwise equal to the snapshot on disk: {same_disk}, to the params "
              f"held when it was saved: {same_held}")
        if restored != {RESTART_STEP: RESTART_STEP - 1} or not (same_disk and same_held):
            failures.append(f"restart-vs-shrink: restores {restored}, equal to the snapshot "
                            f"on disk {same_disk}, to the params saved {same_held}")
        if not all(math.isfinite(r.loss) for r in hist):
            failures.append("restart-vs-shrink: non-finite loss")
        del trainer, at_save, after_restart, snap
    torch.cuda.empty_cache()


def rel_rms(torch, got, want) -> float:
    return float((got.double() - want.double()).square().mean().sqrt()
                 / want.double().square().mean().sqrt().clamp_min(1e-30))


def one_step(torch, model, batch, failures, *, plain=False, host=False):
    """One train step from params drawn from seed 0 (as
    ``repro_torch.launch.train.build`` draws them), through the kernels or
    (``plain``) the plain attention: (loss, grads, params after AdamW),
    grads and params in fp32, on the host with ``host``."""
    from repro_torch.optim import adamw_init, adamw_update, global_norm
    from repro_torch.train import loss_and_grads

    params, _ = model.init(torch.Generator(device=model.device).manual_seed(0))
    params = {k: p.requires_grad_() for k, p in params.items()}
    with plain_versions(failures) if plain else contextlib.nullcontext():
        loss, grads = loss_and_grads(model, params, batch)
    with torch.no_grad():
        # adamw_update consumes grads: keep a copy
        kept = {k: g.float().to("cpu" if host else g.device, copy=True) for k, g in grads.items()}
        adamw_update(grads, adamw_init(params), params, 3e-4, grad_norm=global_norm(grads))
        del grads
        after = {k: (p.detach().float().cpu() if host else p.detach().float())
                 for k, p in params.items()}
    return float(loss), kept, after


def device_events(torch, prof) -> dict[str, tuple[float, int]]:
    """(device ms, count) of a finished profile's device events (kernels,
    copies, sets) by name, read from its raw records: building the
    profiler's event tree for ``key_averages`` takes minutes over a step
    of ~260,000 launches (xlstm's), reading the records seconds."""
    out: dict[str, tuple[float, int]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, n = out.get(e.name(), (0.0, 0))
            out[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return out


def profile_train_step(torch, model, state, step_fn, batch, dtype, failures,
                       tag="[train]", attention=True, ssd=False, mlstm=False):
    """Where a warm train step's time goes: one more step split in its two
    phases by host clock (each ended by a device sync), then one under
    torch.profiler: the device's busy share, its kernels by group, and the
    attention, SSD and mLSTM backwards' kernels by name, which must be
    those of the compute dtype's path (``BWD_PATHS``, ``SSD_BWD_PATHS``,
    ``MLSTM_BWD_PATHS``), or none for a model
    without attention, Mamba2 or mLSTM layers; the SSD and mLSTM
    backwards' shares of the step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import adamw_update, global_norm
    from repro_torch.train import loss_and_grads

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = loss_and_grads(model, state.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        adamw_update(grads, state.opt, state.params, 3e-4, grad_norm=global_norm(grads))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    print(f"{tag} a step's phases (host clock, synced): loss and grads {(t1 - t0) * 1e3:.1f} ms, "
          f"global norm and AdamW over {sum(p.numel() for p in state.params.values()) / 1e9:.3f} B "
          f"fp32 params {(t2 - t1) * 1e3:.1f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_events(torch, prof)
    busy = sum(ms for ms, _ in kernels.values())
    groups: dict[str, float] = {}
    for key, (ms, _) in kernels.items():
        name = key.lower()
        group = ("attention backward kernel" if "attn_bwd" in name else
                 "attention forward kernel" if "attn_" in name else
                 "SSD backward kernel" if "ssd_bwd" in name else
                 "SSD forward kernel" if "ssd_fwd" in name else
                 "mLSTM backward kernel" if "mlstm_bwd" in name else
                 "mLSTM forward kernel" if "mlstm_" in name else
                 "matmul (cuBLAS)" if any(w in name for w in ("gemm", "xmma", "nvjet", "cutlass"))
                 else "other (elementwise, reductions, copies, AdamW)")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"{tag} profiled step: {wall_ms:.1f} ms wall, device busy {busy:.1f} ms "
          f"({busy / wall_ms:.1%}), {sum(n for _, n in kernels.values())} kernel launches; by "
          f"group: " + ", ".join(f"{g} {ms:.1f} ms ({ms / busy:.1%})"
                                 for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for key, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"{tag}   {ms:9.2f} ms {n:6d}x  {key[:90]}")

    def by_name(pattern):
        found: dict[str, tuple[float, int]] = {}
        for key, (ms, n) in kernels.items():
            m = re.search(pattern, key)
            if m:
                t, c = found.get(m.group(1), (0.0, 0))
                found[m.group(1)] = (t + ms, c + n)
        return found

    bwd = by_name(r"(attn_bwd_\w+)")
    print(f"{tag} attention backward kernels in the profiled step: " + ", ".join(
        f"{name} {ms:.2f} ms in {n} launches" for name, (ms, n) in sorted(bwd.items())))
    want = BWD_PATHS[dtype]["kernels"] if attention else []
    if sorted(bwd) != sorted(want):
        failures.append(f"profiled {dtype} train step ran the attention backward kernels "
                        f"{sorted(bwd)}, expected {want}")
    ssd_bwd = by_name(r"(ssd_bwd\w*)")
    if ssd_bwd:
        ms = sum(v[0] for v in ssd_bwd.values())
        print(f"{tag} SSD backward share of the profiled step: {ms:.1f} ms of {busy:.1f} ms device "
              f"time ({ms / busy:.1%}), {ms / wall_ms:.1%} of the wall; kernels: " + ", ".join(
                  f"{name} {t:.2f} ms in {n} launches" for name, (t, n) in sorted(ssd_bwd.items())))
    want = SSD_BWD_PATHS[dtype]["kernels"] if ssd else []
    if sorted(ssd_bwd) != want:
        failures.append(f"profiled {dtype} train step ran the SSD backward kernels "
                        f"{sorted(ssd_bwd)}, expected {want}")
    mlstm_bwd = by_name(r"(mlstm_bwd_\w+)")
    if mlstm_bwd:
        ms = sum(v[0] for v in mlstm_bwd.values())
        print(f"{tag} mLSTM backward share of the profiled step: {ms:.1f} ms of {busy:.1f} ms "
              f"device time ({ms / busy:.1%}), {ms / wall_ms:.1%} of the wall; kernels: "
              + ", ".join(f"{name} {t:.2f} ms in {n} launches"
                          for name, (t, n) in sorted(mlstm_bwd.items())))
    want = sorted(MLSTM_BWD_PATHS[dtype]["kernels"]) if mlstm else []
    if sorted(mlstm_bwd) != want:
        failures.append(f"profiled {dtype} train step ran the mLSTM backward kernels "
                        f"{sorted(mlstm_bwd)}, expected {want}")



# ----------------------------------------------------------- train parallel --


def predicted_comm_bytes(torch, cfg, mesh_shape, batch, seq) -> dict:
    """The bytes one train step's collectives move on a rank of a (data,
    model) mesh, by (operation, axis), from the shapes alone, as
    ``ProcessMesh.comm_bytes`` counts them (an all-gather's output, a
    reduce-scatter's input, an all-reduce's tensor).

    Params: each gather from the storage shard toward the compute layout
    (the port's ``param_layout``: minor axes first), in the compute dtype
    where the param is cast, and the reduce-scatter that is its transpose,
    in fp32 (the masters' dtype) whatever the compute dtype.  The model
    gathers a param where it uses it: the embedding table, the head, the
    final norm and zamba2's shared block once a forward; each stacked
    block param layer by layer at the start of its checkpointed unit, so
    under remat twice (the forward and the recompute, which
    ``torch.utils.checkpoint``'s early stop does not cut, since every
    gather precedes the unit's first saved tensor), its reduce-scatters
    once.  The layers' slices of a leaf move its bytes in all.
    Activations, on a model axis above 1 (X = one data shard's whole
    sequence, B/data x S x d_model, in the compute dtype): the embedding's
    reduce-scatter; per block, the gather of its input and, where its
    contraction is split over 'model', the reduce-scatter of its output:
    attention's, the MLP's, the MoE layer's gathers of its tokens and of
    the experts' outputs (E, cap + 1, d) plus the shared expert's MLP;
    the Mamba2 block's, with its gated norm's all-reduce of (B/data, S,
    1) fp32 between them; the mLSTM block's; the sLSTM block's, with the
    gather of its recurrence's features (X) before the FFN; each with its
    transpose in the backward.  Under remat the forward's collectives of
    a checkpointed unit (a dense block; a Mamba2 layer with the shared
    block after it; an xLSTM unit) run twice (the recompute), but for the
    unit's last reduce-scatter: ``torch.utils.checkpoint`` stops a
    recompute once it has every tensor the backward saved, and the unit's
    output is not one.  Then the logits' gather, and the
    vocabulary-parallel loss's all-reduces of (B/data, S) fp32 (max, sum
    of exponentials, picked logit; the last two again backward).  Over
    'data': the loss's sum forward and backward and its count; on every
    axis, the grad norm."""
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import Mesh, ShardingContext, spec_axes
    from repro_torch.train import param_layout

    D, M = mesh_shape
    sizes = {"data": D, "model": M}
    out: dict = {}

    def add(op, axis, n):
        if sizes[axis] > 1:
            out[(op, axis)] = out.get((op, axis), 0) + n

    model = Model(cfg, "cpu")
    layout = param_layout(model, ShardingContext(mesh=Mesh(tuple(range(D * M)), ("data", "model"),
                                                           mesh_shape)))
    c = torch.empty((), dtype=cfg.compute_dtype).element_size()
    for k, shape in model.abstract_params()[0].items():
        item = c if k in layout.cast else 4
        gathers = 2 if cfg.remat and k.startswith("blocks/") else 1
        src = [spec_axes(e) for e in layout.storage[k]]
        dst = [spec_axes(e) for e in layout.compute[k]]
        local = [d // math.prod(sizes[a] for a in e) for d, e in zip(shape.shape, src)]
        for i, (se, de) in enumerate(zip(src, dst)):
            keep = 0
            while keep < min(len(se), len(de)) and se[keep] == de[keep]:
                keep += 1
            for ax in reversed(se[keep:]):
                local[i] *= sizes[ax]
                add("all_gather", ax, math.prod(local) * item * gathers)
                add("reduce_scatter", ax, math.prod(local) * 4)
        used = {a for e in src for a in e}
        for ax in sizes:
            if ax not in used:
                add("all_reduce", ax, math.prod(shape.shape) // math.prod(
                    sizes[a] for a in used) * 4)
    if M > 1:
        Bl = batch // D
        X = Bl * seq * cfg.d_model * c
        passes = 2 if cfg.remat else 1

        def split(param):
            return "model" in layout.compute[param]

        def dense_block(prefix):
            ev = [("gather", X)] + [("scatter", X)] * split(f"{prefix}/attn/wq")
            if cfg.family == "moe":
                cap = max(int(Bl * seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
                ev += [("gather", X), ("gather", cfg.n_experts * (cap + 1) * cfg.d_model * c)]
                if cfg.n_shared_experts:
                    ev += [("gather", X)] + [("scatter", X)] * split(f"{prefix}/moe/shared/wo")
            else:
                ev += [("gather", X)] + [("scatter", X)] * split(f"{prefix}/mlp/wo")
            return ev

        if cfg.family == "hybrid":
            every = max(cfg.attn_every, 1)
            mamba = [("gather", X)] + [("reduce", Bl * seq * 4), ("scatter", X)] * split(
                "blocks/mamba/A_log")
            units = [mamba + (dense_block("shared_attn") if i % every == every - 1 else [])
                     for i in range(cfg.n_layers)]
        elif cfg.family == "ssm":
            unit = []
            for i in range(cfg.xlstm_slstm_every - 1):
                unit += [("gather", X)] + [("scatter", X)] * split(f"blocks/mlstm{i}/wq")
            unit += ([("gather", X)] + [("gather", X)] * split("blocks/slstm/r")
                     + [("scatter", X)] * split("blocks/slstm/ff_down"))
            units = [unit] * (cfg.n_layers // cfg.xlstm_slstm_every)
        else:
            units = [dense_block("blocks")] * cfg.n_layers
        if not cfg.embed_inputs:
            add("reduce_scatter", "model", X)
            add("all_gather", "model", X)
        for unit in units:
            for i, (kind, n) in enumerate(unit):
                times = 1 if i == len(unit) - 1 and kind == "scatter" else passes
                if kind == "reduce":
                    add("all_reduce", "model", n * (times + 1))
                    continue
                fwd, bwd = ("all_gather", "reduce_scatter") if kind == "gather" else \
                    ("reduce_scatter", "all_gather")
                add(fwd, "model", n * times)
                add(bwd, "model", n)
        add("all_gather", "model", X)
        add("reduce_scatter", "model", X)
        if cfg.vocab % M == 0:
            add("all_reduce", "model", 5 * Bl * seq * 4)
    add("all_reduce", "data", 12)
    for ax in sizes:
        add("all_reduce", ax, 4)
    return out


def _shard_rel_rms(torch, mesh, layout, got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's relative rms of ``got`` against ``want`` (this
    rank's storage shards of both), over every rank: each element counted
    once."""
    from repro_torch.parallel import collectives

    keys = sorted(want)
    sums = []
    for k in keys:
        first = all(mesh.axis_index(a) == 0 for a in mesh.replicated_axes(layout.storage[k]))
        a, b = got[k].detach().double(), want[k].detach().to(got[k].device).double()
        sums.append(torch.stack([(a - b).square().sum(), b.square().sum()]) * float(first))
    total = collectives.sum_over(torch.stack(sums), mesh, mesh.axis_names)
    rms = (total[:, 0] / total[:, 1].clamp_min(1e-300)).sqrt()
    i = int(rms.argmax())
    return float(rms[i]), keys[i]


def _shard_close(torch, mesh, got: dict, want: dict) -> tuple[float, int]:
    """The largest absolute error of ``got`` against ``want`` (this rank's
    storage shards of both) over every rank, and how many elements lie
    outside MODEL_TOL (an element replicated over ranks counted on each)."""
    from repro_torch.parallel import collectives

    err, outside = torch.zeros((), dtype=torch.float64), torch.zeros((), dtype=torch.float64)
    for k in sorted(want):
        a, b = got[k].detach().double().cpu(), want[k].detach().double().cpu()
        err = torch.maximum(err, (a - b).abs().max())
        outside += (~torch.isclose(a, b, **MODEL_TOL)).sum()
    for ax in mesh.axis_names:
        err = collectives.all_reduce(err, mesh, ax, op="max")
    return float(err), int(collectives.sum_over(outside, mesh, mesh.axis_names))


def _mesh_run(torch, ctx, cfg, batch, seq, steps) -> dict:
    """``steps`` steps of ``cfg`` on the mesh through the training entry
    points (``build_init_fn(model, ctx)``, ``build_train_step(model, ctx)``,
    ``repro_torch.launch.train.train`` with each rank's batch shard), from
    seed 0, counting this rank's kernel launches and collective bytes.
    ``peak`` is the card's peak allocation from the init on (the ranks
    draw the full params in turn), ``step_peak`` the peak during the
    steps, ``fwd_bwd_peak`` the peak inside their ``loss_and_grads`` (the
    forward and backward, where the gathered weights live; AdamW's
    per-leaf temporaries come after it), and ``storage`` the rank's shards
    of the params, grads and AdamW moments (the grads shaped as the
    params); ``peak_rss`` the process's peak resident host memory so far,
    in bytes (``ru_maxrss`` counts KiB on Linux)."""
    import resource
    from unittest import mock

    from repro_torch.data import SyntheticTokens, make_batch_on_mesh
    from repro_torch.launch import train as train_cli
    from repro_torch.models import Model
    from repro_torch.train import build_init_fn, build_train_step
    from repro_torch.train import steps as train_steps

    mesh = ctx.mesh
    dev = mesh.device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = Model(cfg, dev)
    t0 = time.perf_counter()
    state = build_init_fn(model, ctx)(torch.Generator(device=dev).manual_seed(0))
    step_fn = build_train_step(model, ctx)
    init_s = time.perf_counter() - t0
    peaks = {"init": torch.cuda.max_memory_allocated(dev), "step": 0, "fwd_bwd": 0}
    torch.cuda.reset_peak_memory_stats(dev)
    loss_and_grads = train_steps.loss_and_grads

    def measured(*args, **kwargs):
        peaks["step"] = max(peaks["step"], torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        out = loss_and_grads(*args, **kwargs)
        peaks["fwd_bwd"] = max(peaks["fwd_bwd"], torch.cuda.max_memory_allocated(dev))
        return out

    data = SyntheticTokens(cfg, batch, seq, seed=0)
    mesh.comm_bytes.clear()
    reset_counts()
    with mock.patch.object(train_steps, "loss_and_grads", measured):
        state, records = train_cli.train(model, state, step_fn, data.iter(), steps,
                                         log=lambda _: None,
                                         place=lambda b: make_batch_on_mesh(b, cfg, ctx))
    step_peak = max(peaks["step"], peaks["fwd_bwd"], torch.cuda.max_memory_allocated(dev))
    held = [state.params, state.params, state.opt.mu, state.opt.nu]   # params, grads, mu, nu
    out = {"counts": read_counts(), "init_s": init_s,
           "comm": {f"{op} {ax}": n / steps for (op, ax), n in mesh.comm_bytes.items()},
           "losses": [r.loss for r in records], "grad_norms": [r.grad_norm for r in records],
           "seconds": [r.seconds for r in records],
           "peak": max(peaks["init"], step_peak), "step_peak": step_peak,
           "fwd_bwd_peak": peaks["fwd_bwd"],
           "storage": sum(t.numel() * t.element_size() for tree in held for t in tree.values()),
           "peak_rss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
           "params": sum(p.numel() for p in state.params.values())}
    del state, step_fn, model
    torch.cuda.empty_cache()
    return out


def _gate_vs_single(torch, ctx, cfg, batch, seq, keep_single=False) -> dict:
    """One step on the mesh against the single-process step on the card
    (``loss_and_grads`` then ``adamw_update``), both from seed 0 on the
    same batch: every rank runs the single-process step in turn (rank
    order, one at a time on the card) and keeps its storage shard of the
    params and of AdamW's ``mu`` after it.  After one step ``mu`` is
    (1 - b1) times the clipped gradient, so its worst leaf reads the
    gradients leaf by leaf, and the grad norms (before clipping) read
    their scale; AdamW's first step is about sign(g), so the params
    alone would not see an error in a gradient's size."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticTokens, make_batch_on_mesh, to_device
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init, adamw_update, global_norm
    from repro_torch.train import build_init_fn, build_train_step, loss_and_grads, param_layout

    mesh = ctx.mesh
    dev = mesh.device
    model = Model(cfg, dev)
    layout = param_layout(model, ctx)
    host = SyntheticTokens(cfg, batch, seq, seed=0).sample(0)
    want = {}
    for turn in range(mesh.size):
        if turn == mesh.rank:
            params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
            params = {k: p.requires_grad_() for k, p in params.items()}
            loss, grads = loss_and_grads(model, params, to_device(host, dev))
            with torch.no_grad():
                gnorm = global_norm(grads)
                _, opt = adamw_update(grads, adamw_init(params), params, 3e-4, grad_norm=gnorm)
            single_loss, single_norm = float(loss), float(gnorm)
            want, want_mu = ({k: t.detach()[mesh.shard_slices(layout.storage[k],
                                                               tuple(t.shape))].cpu()
                              for k, t in tree.items()} for tree in (params, opt.mu))
            del params, grads, loss, opt
            torch.cuda.empty_cache()
        dist.barrier()
    state = build_init_fn(model, ctx)(torch.Generator(device=dev).manual_seed(0))
    state, metrics = build_train_step(model, ctx, lr=3e-4)(
        state, make_batch_on_mesh(host, cfg, ctx))
    worst = _shard_rel_rms(torch, mesh, layout, state.params, want)
    worst_mu = _shard_rel_rms(torch, mesh, layout, state.opt.mu, want_mu)
    out = {"loss": float(metrics["loss"]), "single_loss": single_loss, "worst": worst,
           "grad_norm": float(metrics["grad_norm"]), "single_grad_norm": single_norm,
           "worst_mu": worst_mu, "params_close": _shard_close(torch, mesh, state.params, want)}
    if keep_single:   # this rank's shards of the single-process step's params and mu
        out["single"] = (want, want_mu)
    del state
    torch.cuda.empty_cache()
    return out


def _moe_twin(torch, ctx, cfg, batch, seq) -> dict:
    """One fp32 step of ``cfg`` on the mesh's ranks on the card (kernels),
    then the same step by the same ranks on the CPU (gloo, the plain
    versions) from the same initial shards and batch: the losses, the
    grad norms, and the worst leaf of the params and of AdamW's ``mu``
    (the clipped gradient) after it."""
    import dataclasses

    from repro_torch.data import SyntheticTokens, make_batch_on_mesh
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import ShardingContext
    from repro_torch.train import TrainState, build_init_fn, build_train_step, param_layout

    mesh = ctx.mesh
    dev = mesh.device
    host = SyntheticTokens(cfg, batch, seq, seed=0).sample(0)
    model = Model(cfg, dev)
    state = build_init_fn(model, ctx)(torch.Generator(device=dev).manual_seed(0))
    init = {k: p.detach().to("cpu", copy=True) for k, p in state.params.items()}
    state, card = build_train_step(model, ctx, lr=3e-4)(state, make_batch_on_mesh(host, cfg, ctx))
    # the card's results stay on the card: the host holds the CPU twin
    on_card, card_mu = ({k: t.detach().clone() for k, t in tree.items()}
                        for tree in (state.params, state.opt.mu))
    del state
    torch.cuda.empty_cache()
    cpu_ctx = ShardingContext(mesh=dataclasses.replace(mesh, device=torch.device("cpu")))
    cpu_model = Model(cfg, "cpu")
    params = {k: p.requires_grad_() for k, p in init.items()}
    state = TrainState(params=params, opt=adamw_init(params), step=torch.zeros((), dtype=torch.int32))
    t0 = time.perf_counter()
    state, twin = build_train_step(cpu_model, cpu_ctx, lr=3e-4)(
        state, make_batch_on_mesh(host, cfg, cpu_ctx))
    twin_s = time.perf_counter() - t0
    cpu_layout = param_layout(cpu_model, cpu_ctx)
    worst = _shard_rel_rms(torch, cpu_ctx.mesh, cpu_layout, on_card, state.params)
    worst_mu = _shard_rel_rms(torch, cpu_ctx.mesh, cpu_layout, card_mu, state.opt.mu)
    return {"loss": float(card["loss"]), "twin_loss": float(twin["loss"]), "worst": worst,
            "grad_norm": float(card["grad_norm"]), "twin_grad_norm": float(twin["grad_norm"]),
            "worst_mu": worst_mu, "twin_s": twin_s}


def _single_run(torch, dev, cfg, batch, seq, steps) -> dict:
    """The same steps as ``_mesh_run`` in this one process
    (``repro_torch.launch.train``'s ``build`` and ``train``)."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train as train_cli

    model, state, step_fn = train_cli.build(cfg, device=dev, seed=0)
    _, records = train_cli.train(model, state, step_fn, SyntheticTokens(cfg, batch, seq, seed=0)
                                 .iter(), steps, log=lambda _: None)
    del model, state, step_fn
    torch.cuda.empty_cache()
    return {"losses": [r.loss for r in records], "seconds": [r.seconds for r in records]}


def parallel_ranks(out_dir: str):
    """One rank of ``[train parallel]`` (spawned by
    ``repro_torch.launch.mesh.spawn``): its results go to
    ``out_dir/rank<r>.json``."""
    import os
    import resource

    import torch
    import torch.distributed as dist

    from repro_torch.configs import arch_config
    from repro_torch.device import card_label
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import ShardingContext
    from repro_torch.train import param_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // math.prod(PAR_MESH)))  # the CPU twin
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(PAR_MESH[1], device=dev)
    ctx = ShardingContext(mesh=mesh, mode="train")
    dense, moe = arch_config(ARCH), arch_config(MOE)
    res = {"device": str(dev), "card": card_label(dev), "backend": mesh.backend,
           "coords": mesh.coords(), "peak_rss": {}}
    t0 = time.perf_counter()

    def done(part):
        # this rank's peak resident host memory so far (Linux: KiB); gloo
        # stages CUDA tensors through pinned host buffers, which count
        res["peak_rss"][part] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        if mesh.rank == 0:
            print(f"[train parallel] rank 0: {part} done at {time.perf_counter() - t0:.1f}s, peak "
                  f"host memory {res['peak_rss'][part] / 2**30:.2f} GiB", flush=True)

    # The CPU twin first: its four fp32 copies of phi3.5's layer are the
    # host's largest load, and gloo's pinned staging buffers, which the
    # card runs leave cached in each rank, are small then.
    res["moe_gate"] = _moe_twin(torch, ctx, moe.replace(n_layers=PAR_MOE_GATE_LAYERS,
                                                        dtype="float32", logit_dtype="float32"),
                                PAR_MOE_GATE_BATCH, PAR_MOE_GATE_SEQ)
    done("moe twin")
    res["dense"] = _mesh_run(torch, ctx, dense.replace(n_layers=PAR_LAYERS), BATCH, TRAIN_SEQ,
                             PAR_STEPS)
    done("dense")
    res["dense_full"] = _mesh_run(torch, ctx, dense.replace(n_layers=PAR_FULL_LAYERS), BATCH,
                                  TRAIN_SEQ, PAR_FULL_STEPS)
    done(f"dense at {PAR_FULL_LAYERS} layers")
    if mesh.rank == 0:   # the same steps in one process, for the losses beside the mesh's
        res["dense_single"] = _single_run(torch, dev, dense.replace(n_layers=PAR_LAYERS),
                                          BATCH, TRAIN_SEQ, PAR_STEPS)
    dist.barrier()
    gate = {dtype: _gate_vs_single(torch, ctx, dense.replace(
        n_layers=PAR_GATE_LAYERS, dtype=dtype, logit_dtype=dtype), PAR_GATE_BATCH, PAR_GATE_SEQ,
        keep_single=True) for dtype in ("float32", "bfloat16")}
    # the single-process bf16 step against the fp32 one, on the same leaves
    (p32, mu32), (p16, mu16) = (gate[dtype].pop("single") for dtype in ("float32", "bfloat16"))
    layout = param_layout(Model(dense.replace(n_layers=PAR_GATE_LAYERS), dev), ctx)
    gate["bfloat16"]["single_vs_fp32"] = {
        "loss": gate["bfloat16"]["single_loss"] - gate["float32"]["single_loss"],
        "grad_norm": gate["bfloat16"]["single_grad_norm"] / gate["float32"]["single_grad_norm"] - 1,
        "worst_mu": _shard_rel_rms(torch, mesh, layout, mu16, mu32),
        "worst": _shard_rel_rms(torch, mesh, layout, p16, p32)}
    res["dense_gate"] = gate
    del p32, mu32, p16, mu16
    done("dense gate")
    res["moe"] = _mesh_run(torch, ctx, moe.replace(n_layers=PAR_MOE_LAYERS), BATCH, TRAIN_SEQ,
                           PAR_MOE_STEPS)
    done("moe")
    for arch, p in PAR_RECURRENT.items():
        cfg = arch_config(arch)
        res[arch] = _mesh_run(torch, ctx, cfg.replace(n_layers=p["layers"]), p["batch"],
                              p["seq"], p["steps"])
        res[f"{arch} gate"] = _gate_vs_single(
            torch, ctx, cfg.replace(n_layers=p["gate_layers"], dtype="float32",
                                    logit_dtype="float32"), p["gate_batch"], p["gate_seq"])
        done(arch)
    with open(Path(out_dir) / f"rank{mesh.rank}.json", "w") as f:
        json.dump(res, f)


def _fp32_gate_line(label, g, recurrent=False) -> bool:
    """Print an fp32 mesh-vs-single-process gate (``_gate_vs_single``);
    True where it holds.  A recurrent family's leaves are held as its
    single-process step gate holds them (see GRAD_REL_RMS beside
    PAR_GATE_GRAD)."""
    gap = abs(g["loss"] - g["single_loss"])
    norm_gap = abs(g["grad_norm"] - g["single_grad_norm"]) / g["single_grad_norm"]
    mu_gate = GRAD_REL_RMS if recurrent else PAR_GATE_GRAD
    err, outside = g["params_close"]
    params_ok = outside == 0 if recurrent else g["worst"][0] < PAR_GATE_REL_RMS
    ok = gap < PAR_GATE_LOSS and norm_gap < PAR_GATE_GRAD and g["worst_mu"][0] < mu_gate \
        and params_ok
    print(f"{label}: loss {g['loss']:.7f} vs {g['single_loss']:.7f} (|gap| {gap:.3e}, < "
          f"{PAR_GATE_LOSS}); grad norm {g['grad_norm']:.7f} vs {g['single_grad_norm']:.7f} "
          f"(relative gap {norm_gap:.3e}, < {PAR_GATE_GRAD}); AdamW mu (the clipped gradient): "
          f"worst leaf relative rms {g['worst_mu'][0]:.3e} ({g['worst_mu'][1]}; < {mu_gate}); "
          f"params after AdamW: worst leaf relative rms {g['worst'][0]:.3e} ({g['worst'][1]}"
          + (f"), max_abs_err {err:.3e}, {outside} elements outside rtol={MODEL_TOL['rtol']}, "
             f"atol={MODEL_TOL['atol']}" if recurrent else f"; < {PAR_GATE_REL_RMS})")
          + f" {'ok' if ok else 'FAIL'}")
    return ok


def train_parallel_phase(torch, dev, failures, counts):
    """Four ranks on the one card (gloo), one process each, through
    ``repro_torch.launch.mesh.spawn``: stablelm_3b (8 layers and 32),
    phi35_moe_42b, zamba2_1p2b and xlstm_125m trained on a (data 2, model
    2) mesh, the growth with depth of what a rank holds beyond its
    storage shards, and the fp32 gates.  Returns the ranks' results
    (``[dryrun]`` reads them)."""
    import os
    import tempfile

    from repro_torch.configs import arch_config
    from repro_torch.launch.mesh import backend_for, spawn

    tag = "[train parallel]"
    world = math.prod(PAR_MESH)
    backend, why = backend_for(dev, world)
    print(f"{tag} backend {backend}: {why} (chosen once by repro_torch.launch.mesh.backend_for; "
          f"the NCCL route, one card a rank, cannot be exercised on one card: unverified)")
    # four processes share the card: let each allocator return what it frees
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        try:
            spawn(parallel_ranks, world, (out,), init_file=os.path.join(out, "store"),
                  device="cuda", timeout=900)
        except Exception as e:   # a rank failed: its traceback is in the message
            failures.append(f"{tag} a rank failed: {e}")
            return
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    print(f"{tag} {world} ranks ran every part in {time.perf_counter() - t0:.1f}s (spawn, kernel "
          f"loads, init and the CPU twin included)")
    for r, res in enumerate(ranks):
        print(f"{tag} rank {r} {res['coords']}: {res['device']}, {res['card']}, backend "
              f"{res['backend']}; peak host memory after each part: "
              + ", ".join(f"{part} {b / 2**30:.2f} GiB" for part, b in res["peak_rss"].items()))
    runs_of = [("dense", ARCH, PAR_LAYERS, BATCH, TRAIN_SEQ, PAR_STEPS),
               ("dense_full", ARCH, PAR_FULL_LAYERS, BATCH, TRAIN_SEQ, PAR_FULL_STEPS),
               ("moe", MOE, PAR_MOE_LAYERS, BATCH, TRAIN_SEQ, PAR_MOE_STEPS)]
    runs_of += [(arch, arch, p["layers"], p["batch"], p["seq"], p["steps"])
                for arch, p in PAR_RECURRENT.items()]
    for key, arch, layers, batch, seq, steps in runs_of:
        cfg = arch_config(arch).replace(n_layers=layers)
        runs = [res[key] for res in ranks]
        label = f"{tag} {arch} at full width, {layers} layers, mesh data {PAR_MESH[0]} x model " \
                f"{PAR_MESH[1]}, batch {batch} x {seq}"
        total = sum(p for p in (run["params"] for run in runs))
        print(f"{label}: {cfg.param_count() / 1e9:.3f} B params, {total / 1e9:.3f} B stored over the "
              f"ranks (fp32 masters; AdamW mu / nu beside them), init {max(r['init_s'] for r in runs):.1f}s")
        for r, run in enumerate(runs):
            print(f"{tag}   rank {r}: losses " + ", ".join(f"{x:.4f}" for x in run["losses"])
                  + "; grad norms " + ", ".join(f"{x:.4f}" for x in run["grad_norms"])
                  + "; step times " + ", ".join(f"{x * 1e3:.1f}" for x in run["seconds"])
                  + f" ms; peak memory {run['peak'] / 2**30:.2f} GiB (during the steps "
                  f"{run['step_peak'] / 2**30:.2f}, in their forward and backward "
                  f"{run['fwd_bwd_peak'] / 2**30:.2f}); storage {run['storage'] / 2**30:.2f} GiB "
                  f"(params, grads, mu, nu shards); held beyond storage in the forward and "
                  f"backward {(run['fwd_bwd_peak'] - run['storage']) / 2**30:.2f} GiB (in the "
                  f"whole step {(run['step_peak'] - run['storage']) / 2**30:.2f}); peak host "
                  f"memory {run['peak_rss'] / 2**30:.2f} GiB")
        step_s = max(statistics.median(run["seconds"][1:]) for run in runs)
        print(f"{tag}   step time {step_s * 1e3:.1f} ms (the slowest rank's median of steps "
              f"1-{steps - 1}), {batch * seq / step_s:.0f} tokens/s on {world} ranks, peak "
              f"memory {max(run['peak'] for run in runs) / 2**30:.2f} GiB a rank, "
              f"{sum(run['peak'] for run in runs) / 2**30:.1f} GiB over the ranks, on "
              f"{ranks[0]['card']}")
        if not all(math.isfinite(x) for run in runs for x in run["losses"] + run["grad_norms"]):
            failures.append(f"{tag} {arch}: non-finite loss or grads")
        if len({tuple(run["losses"]) for run in runs}) != 1:
            failures.append(f"{tag} {arch}: the ranks disagree on the loss")
        if key == "dense":
            single = ranks[0]["dense_single"]
            print(f"{tag}   the same steps in one process (information, bf16 rounds "
                  "differently): losses " + ", ".join(f"{x:.4f}" for x in single["losses"])
                  + "; step times " + ", ".join(f"{x * 1e3:.1f}" for x in single["seconds"])
                  + " ms")
        want = predicted_comm_bytes(torch, cfg, PAR_MESH, batch, seq)
        for r, run in enumerate(runs):
            got = {tuple(k.split()): v for k, v in run["comm"].items()}
            if got != want:
                failures.append(f"{tag} {arch} rank {r}: collective bytes {got} != predicted {want}")
        print(f"{tag}   collective bytes a step, each rank (measured = predicted from the shapes): "
              + ", ".join(f"{op} over {ax} {runs[0]['comm'].get(f'{op} {ax}', 0) / 1e6:.2f} MB"
                          f" (predicted {want[(op, ax)] / 1e6:.2f})" for op, ax in sorted(want)))
        per_step = train_launches(cfg)
        summed = {name: sum(run["counts"][name] for run in runs) for name in COUNTERS}
        counts[f"train parallel {arch}" + (f" {layers} layers" if key == "dense_full" else "")] = \
            summed
        for r, run in enumerate(runs):
            for name in COUNTERS:
                exp = steps * per_step.get(name, 0)
                if run["counts"][name] != exp:
                    failures.append(f"{tag} {arch} rank {r}: {name} launched "
                                    f"{run['counts'][name]} times, expected {exp}")
        print(f"{tag}   kernel launches per rank in {steps} steps: " + "; ".join(
            f"{name} " + ", ".join(str(run["counts"][name]) for run in runs)
            + f" (expected {steps} x {n})" for name, n in per_step.items() if n)
            + f"; each on the rank's heads ({_local_heads(cfg)})")
        if key in PAR_RECURRENT:
            p = PAR_RECURRENT[key]
            ok = _fp32_gate_line(f"{tag} {arch} float32 step at full width, {p['gate_layers']} "
                                 f"layers, {p['gate_batch']} x {p['gate_seq']}, {world} ranks vs "
                                 f"the single-process step", ranks[0][f"{arch} gate"],
                                 recurrent=True)
            if not ok:
                failures.append(f"{tag} {arch} fp32 gate against the single-process step")

    def growth(peak):
        return max((res["dense_full"][peak] - res["dense_full"]["storage"])
                   - (res["dense"][peak] - res["dense"]["storage"]) for res in ranks)

    ok = growth("fwd_bwd_peak") < PAR_HELD_GROWTH
    print(f"{tag} {ARCH} held beyond storage in the forward and backward, {PAR_FULL_LAYERS} "
          f"layers less {PAR_LAYERS}: {growth('fwd_bwd_peak') / 2**30:.3f} GiB on the worst rank "
          f"(< {PAR_HELD_GROWTH / 2**30:.1f}: each block gathered in its unit) "
          f"{'ok' if ok else 'FAIL'}; in the whole step (information: AdamW's temporaries are "
          f"a leaf's size, and a stacked leaf grows with depth) {growth('step_peak') / 2**30:.3f}")
    if not ok:
        failures.append(f"{tag} {ARCH}: what a rank holds beyond storage in the forward and "
                        f"backward grew by {growth('fwd_bwd_peak') / 2**30:.3f} GiB from "
                        f"{PAR_LAYERS} to {PAR_FULL_LAYERS} layers")
    gate = ranks[0]["dense_gate"]
    for dtype, g in gate.items():
        label = (f"{tag} {ARCH} {dtype} step at full width, {PAR_GATE_LAYERS} layers, "
                 f"{PAR_GATE_BATCH} x {PAR_GATE_SEQ}, {world} ranks vs the single-process step")
        if dtype == "float32":
            if not _fp32_gate_line(label, g):
                failures.append(f"{tag} fp32 gate against the single-process step")
            continue
        gap = abs(g["loss"] - g["single_loss"])
        norm_gap = abs(g["grad_norm"] - g["single_grad_norm"]) / g["single_grad_norm"]
        one = g["single_vs_fp32"]
        print(f"{label} (information): loss {g['loss']:.6f} vs {g['single_loss']:.6f} (|gap| "
              f"{gap:.3e}); grad norm relative gap {norm_gap:.3e}; AdamW mu: worst leaf "
              f"relative rms {g['worst_mu'][0]:.3e} ({g['worst_mu'][1]}); params after AdamW: "
              f"worst leaf relative rms {g['worst'][0]:.3e} ({g['worst'][1]}). Beside it, the "
              f"single-process bf16 step vs the single-process fp32 step: loss gap "
              f"{abs(one['loss']):.3e}; grad norm relative gap {abs(one['grad_norm']):.3e}; "
              f"AdamW mu: worst leaf relative rms {one['worst_mu'][0]:.3e} ({one['worst_mu'][1]}); "
              f"params: worst leaf relative rms {one['worst'][0]:.3e} ({one['worst'][1]})")
    twin = ranks[0]["moe_gate"]
    gap = abs(twin["loss"] - twin["twin_loss"])
    limit = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * abs(twin["twin_loss"])
    norm_gap = abs(twin["grad_norm"] - twin["twin_grad_norm"]) / twin["twin_grad_norm"]
    ok = (gap <= limit and norm_gap <= GRAD_REL_RMS and twin["worst_mu"][0] <= GRAD_REL_RMS
          and twin["worst"][0] <= GRAD_REL_RMS)
    print(f"{tag} {MOE} float32 step at full width, {PAR_MOE_GATE_LAYERS} layer, "
          f"{PAR_MOE_GATE_BATCH} x {PAR_MOE_GATE_SEQ}: {world} ranks on the card vs the same ranks "
          f"on the CPU (gloo, plain versions; {twin['twin_s']:.1f}s): loss {twin['loss']:.7f} vs "
          f"{twin['twin_loss']:.7f} (|gap| {gap:.3e}, at most {limit:.3e}); grad norm "
          f"{twin['grad_norm']:.7f} vs {twin['twin_grad_norm']:.7f} (relative gap "
          f"{norm_gap:.3e}, at most {GRAD_REL_RMS}); AdamW mu (the clipped gradient): worst leaf "
          f"relative rms {twin['worst_mu'][0]:.3e} ({twin['worst_mu'][1]}; at most "
          f"{GRAD_REL_RMS}); params after AdamW: worst leaf relative rms {twin['worst'][0]:.3e} "
          f"({twin['worst'][1]}; at most {GRAD_REL_RMS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{tag} {MOE} fp32 gate against the CPU twin")
    return ranks


# ------------------------------------------------------------------ dryrun --

# The production cells [dryrun] runs on fake ranks and prints (arch, shape, mesh).
DRYRUN_CELLS = (("stablelm_3b", "train_4k", "single"), ("gemma2_9b", "decode_32k", "single"),
                ("zamba2_1p2b", "long_500k", "multi"))
DRYRUN_PEAK_TOL = 0.15


def dryrun_phase(torch, failures, par_ranks):
    """The dry run's twin of ``[train parallel]``'s stablelm_3b cell (8
    layers, (2, 2), 8 x 512; ``repro_torch.launch.dryrun.run_config`` on
    fake ranks, abstract tensors, no card) for every rank, against what
    the ranks measured: a step's collective bytes by (operation, axis)
    and each kernel's launches equal, the step's peak within
    DRYRUN_PEAK_TOL of ``torch.cuda.max_memory_allocated`` over the
    steps; then three production cells, their records printed."""
    from repro_torch.configs import arch_config
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch import dryrun

    tag = "[dryrun]"
    cfg = arch_config(ARCH).replace(n_layers=PAR_LAYERS)
    cell = ShapeCell("train parallel", TRAIN_SEQ, BATCH, "train")
    t0 = time.perf_counter()
    for r, res in enumerate(par_ranks):
        run = res["dense"]
        rec = dryrun.run_config(cfg, cell, PAR_MESH, ("data", "model"), r)
        want = rec["collectives"]["per_op_axis"]
        if run["comm"] != want:
            failures.append(f"{tag} rank {r}: measured collective bytes {run['comm']} != the "
                            f"twin's {want}")
        launches = {k: v // PAR_STEPS for k, v in run["counts"].items() if v}
        if launches != rec["kernel_launches"]:
            failures.append(f"{tag} rank {r}: launches a step {launches} != the twin's "
                            f"{rec['kernel_launches']}")
        peak, got = rec["per_device"]["peak_hbm_est"], run["step_peak"]
        rel = got / peak - 1
        if abs(rel) > DRYRUN_PEAK_TOL:
            failures.append(f"{tag} rank {r}: peak {got} vs the twin's {peak} ({rel:+.1%})")
        print(f"{tag} {ARCH} {PAR_LAYERS} layers, {BATCH} x {TRAIN_SEQ}, mesh {PAR_MESH} rank {r} "
              f"{res['coords']}: peak a step predicted {peak / 2**30:.3f} GiB (arguments "
              f"{rec['per_device']['argument_bytes'] / 2**30:.3f} + what the step creates at its "
              f"peak), measured {got / 2**30:.3f} GiB on the card ({rel:+.1%}, within "
              f"{DRYRUN_PEAK_TOL:.0%}); collective bytes a step "
              + ("equal" if run["comm"] == want else "DIFFER") + f" ({len(want)} (op, axis) "
              f"pairs, {sum(want.values()) / 1e9:.3f} GB); kernel launches a step "
              + ("equal" if launches == rec["kernel_launches"] else "DIFFER")
              + f" {rec['kernel_launches']}; {rec['per_device']['flops'] / 1e12:.2f} TFLOP a "
              f"step (predicted); traced in {rec['trace_s']:.1f}s")
    for arch, shape, mesh in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, mesh)
        if rec["status"] != "ok":
            failures.append(f"{tag} {arch} {shape} {mesh}: {rec['status']}")
        pd = rec["per_device"]
        print(f"{tag} {arch} {shape} {mesh} ({rec['n_chips']} fake ranks, rank 0; predictions "
              f"under the H100 data-sheet profile): peak {pd['peak_hbm_est'] / 2**30:.2f} GiB of "
              f"80, {pd['flops'] / 1e12:.2f} TFLOP, collectives "
              f"{rec['collectives']['total_bytes'] / 1e9:.3f} GB, traced in {rec['trace_s']}s")
        print(f"{tag} record: {json.dumps(rec, sort_keys=True)}")
    print(f"{tag} done in {time.perf_counter() - t0:.1f}s (no card used)")


# ----------------------------------------------------------- serve parallel --

# [serve parallel]: four ranks on the card (gloo), the (data 2, model 2)
# mesh of [train parallel], serving through build_prefill_step (the
# prompt in train mode) and build_serve_step.  stablelm_3b at full width
# and depth in decode mode (the cache's sequence over 'model'), zamba2_1p2b
# at full width in long mode (the batch whole, the cache's sequence over
# data and model: four ways); bf16, each against one process's greedy
# tokens; their fp32 gates at a cut depth against one process's logits.
# A decode step gathers a rank's storage shards of the serving params
# (FSDP over 'data', as the JAX package's serving layout stores them) and
# the whole wq, wk, wv over 'model' through gloo's host copies: ~4 GB a rank
# and 4.4-4.9 s a step on an H100 over gloo, so each run decodes 4 tokens
# (8 until the D 256 prefill's timings needed the room; 4 in the fp32
# gates) to keep the script inside its limit.
SERVE_PAR = {
    "stablelm": dict(arch="stablelm_3b", mode="decode", batch=8, prompt=512, gen=4,
                     gate_layers=4, gate_gen=4),
    "zamba2": dict(arch="zamba2_1p2b", mode="long", batch=1, prompt=4096, gen=4,
                   gate_layers=6, gate_gen=4),
}


def _single_serve(torch, model, params, prompts, gen) -> dict:
    """One process: the prompt's prefill, then ``gen`` greedy tokens;
    (the greedy ids (B, gen), the logits of the prefill's last position
    and of each step (B, gen + 1, V) fp32 on the host)."""
    import numpy as np

    dev = model.device
    B, P = prompts.shape
    with torch.no_grad():
        cache = model.init_cache(B, P + gen)
        lg = model.prefill(params, cache, {"tokens": torch.as_tensor(prompts, device=dev)})[:, -1]
        out, ids = [lg.float().cpu()], []
        for t in range(gen):
            ids.append(out[-1].argmax(-1))
            lg, cache = model.decode_step(params, cache, {
                "tokens": ids[-1][:, None].to(dev), "cache_pos": P + t,
                "positions": torch.full((B, 1), P + t, dtype=torch.int32, device=dev)})
            out.append(lg[:, -1].float().cpu())
    return {"ids": torch.stack(ids, 1).numpy(), "logits": torch.stack(out, 1).numpy()}


def _serve_mesh_run(torch, mesh, key, cfg, p, gen, out_dir) -> dict:
    """One serving run of ``cfg`` on the mesh (``p`` from ``SERVE_PAR``):
    the ranks draw the params in turn from seed 0 and keep their storage
    shards of the serving params (rank 0 first serves them in one process,
    the reference); then the prompt's prefill and ``gen`` decode steps fed
    one process's greedy ids.  This rank's logits (its batch rows) go to
    ``out_dir``; returns its kernel launches, the prefill's and a decode
    step's collective bytes, the times and the peak memory."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch.models import Model
    from repro_torch.parallel.sharding import ShardingContext, use_sharding
    from repro_torch.train import build_prefill_step, build_serve_step, param_layout, place_batch

    dev = mesh.device
    ctx = ShardingContext(mesh=mesh, mode=p["mode"])
    model = Model(cfg, dev)
    layout = param_layout(model, ctx)
    B, P = p["batch"], p["prompt"]
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (B, P))
    shards, single = {}, None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            full = model.serving_params(model.init(torch.Generator(device=dev).manual_seed(0))[0])
            shards = {k: v[mesh.shard_slices(layout.storage[k], tuple(v.shape))].clone()
                      for k, v in full.items()}
            if mesh.rank == 0:
                single = _single_serve(torch, model, full, prompts, gen)
                np.save(Path(out_dir) / f"{key}_single.npy", single["logits"])
            del full
            torch.cuda.empty_cache()
        dist.barrier()
    box = [None if single is None else single["ids"]]
    dist.broadcast_object_list(box, src=0)
    ids = box[0]
    rows = slice(None)
    if p["mode"] == "decode":        # this rank's data shard of the batch
        n = B // mesh.axis_size("data")
        rows = slice(mesh.axis_index("data") * n, (mesh.axis_index("data") + 1) * n)
    torch.cuda.reset_peak_memory_stats(dev)
    mesh.comm_bytes.clear()
    reset_counts()
    with torch.no_grad():
        with use_sharding(ctx):
            cache = model.init_cache(B, P + gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prompt = place_batch({"tokens": prompts}, cfg, dataclasses.replace(ctx, mode="train"))
        lg = build_prefill_step(model, ctx, B, P + gen)(shards, cache, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_bytes = dict(mesh.comm_bytes)
        mesh.comm_bytes.clear()
        out = [lg[:, -1].float().cpu()]
        step = build_serve_step(model, ctx)
        t0 = time.perf_counter()
        for t in range(gen):
            lg, cache = step(shards, cache, {
                "tokens": torch.as_tensor(ids[rows, t:t + 1], device=dev), "cache_pos": P + t,
                "positions": torch.full((out[0].shape[0], 1), P + t, dtype=torch.int32,
                                        device=dev)})
            out.append(lg[:, -1].float().cpu())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    np.save(Path(out_dir) / f"{key}_rank{mesh.rank}.npy", torch.stack(out, 1).numpy())
    res = {"counts": read_counts(), "prefill_s": prefill_s, "decode_s": decode_s,
           "prefill_bytes": {f"{op} {ax}": v for (op, ax), v in prefill_bytes.items()},
           "step_bytes": {f"{op} {ax}": v / gen for (op, ax), v in mesh.comm_bytes.items()},
           "peak": torch.cuda.max_memory_allocated(dev),
           "rows": [rows.start or 0, rows.stop or B], "ids": ids.tolist()}
    del shards, cache, model
    torch.cuda.empty_cache()
    return res


def serve_parallel_ranks(out_dir: str):
    """One rank of ``[serve parallel]`` (spawned by
    ``repro_torch.launch.mesh.spawn``): its results go to
    ``out_dir/serve_rank<r>.json`` and its logits beside them."""
    import torch

    from repro_torch.configs import arch_config
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(PAR_MESH[1], device=dev)
    res = {"coords": mesh.coords()}
    for key, p in SERVE_PAR.items():
        cfg = arch_config(p["arch"])
        res[key] = _serve_mesh_run(torch, mesh, key, cfg, p, p["gen"], out_dir)
        gate = cfg.replace(n_layers=p["gate_layers"], dtype="float32", logit_dtype="float32")
        res[f"{key} gate"] = _serve_mesh_run(torch, mesh, f"{key}_gate", gate, p, p["gate_gen"],
                                             out_dir)
    with open(Path(out_dir) / f"serve_rank{mesh.rank}.json", "w") as f:
        json.dump(res, f)


def serve_twin_bytes(cfg, p, rank) -> dict:
    """The dry run's prediction of one decode step's collective bytes on a
    rank of the mesh, by (operation, axis)."""
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch import dryrun

    kind = "decode" if p["mode"] == "decode" else "long_decode"
    gen = p["gen"]
    rec = dryrun.run_config(cfg, ShapeCell("serve", p["prompt"] + gen, p["batch"], kind),
                            PAR_MESH, ("data", "model"), rank)
    return rec["collectives"]["per_op_axis"]


def serve_parallel_phase(torch, dev, failures, counts):
    """Four ranks on the one card (gloo) serve stablelm_3b (decode mode)
    and zamba2_1p2b (long mode) at full width: greedy ids against one
    process, the fp32 gates at a cut depth, a decode step's collective
    bytes against the dry run's twin on every rank, and the attention
    launches (``flash_attention_lse`` on every decode step's attention)."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.configs import arch_config
    from repro_torch.launch.mesh import spawn

    tag = "[serve parallel]"
    world = math.prod(PAR_MESH)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        try:
            spawn(serve_parallel_ranks, world, (out,), init_file=os.path.join(out, "store"),
                  device="cuda", timeout=900)
        except Exception as e:   # a rank failed: its traceback is in the message
            failures.append(f"{tag} a rank failed: {e}")
            return
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"serve_rank{r}.json")) as f:
                ranks.append(json.load(f))
        logits = {k: (np.load(os.path.join(out, f"{k}_single.npy")),
                      [np.load(os.path.join(out, f"{k}_rank{r}.npy")) for r in range(world)])
                  for key in SERVE_PAR for k in (key, f"{key}_gate")}
    print(f"{tag} {world} ranks ran every part in {time.perf_counter() - t0:.1f}s (spawn, draws "
          f"and the single-process references included)")
    serve_parallel_report(ranks, logits, {k: arch_config(p["arch"]) for k, p in SERVE_PAR.items()},
                          failures, counts)


def serve_parallel_report(ranks, logits, configs, failures, counts):
    """``[serve parallel]``'s checks and lines, from the ranks' results and
    logits (``configs``: each ``SERVE_PAR`` key's full config)."""
    import numpy as np

    tag = "[serve parallel]"
    for key, p in SERVE_PAR.items():
        cfg = configs[key]
        for run_key, run_cfg, gen in ((key, cfg, p["gen"]),
                                      (f"{key}_gate", cfg.replace(
                                          n_layers=p["gate_layers"], dtype="float32",
                                          logit_dtype="float32"), p["gate_gen"])):
            runs = [res[run_key.replace("_gate", " gate")] for res in ranks]
            single, mine = logits[run_key]
            label = (f"{tag} {p['arch']} {run_cfg.dtype} at full width, {run_cfg.n_layers} "
                     f"layers, {p['mode']} mode on data {PAR_MESH[0]} x model {PAR_MESH[1]}, "
                     f"batch {p['batch']}, prompt {p['prompt']}, {gen} tokens")
            print(f"{label}: prefill {max(r['prefill_s'] for r in runs) * 1e3:.1f} ms, decode "
                  f"{max(r['decode_s'] for r in runs) / gen * 1e3:.1f} ms a step (the slowest "
                  f"rank; the serving params' shards are gathered every step), peak memory "
                  + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in runs) + " GiB a rank")
            ties, worst_gap = 0, 0.0
            for r, (run, got) in enumerate(zip(runs, mine)):
                lo, hi = run["rows"]
                want = single[lo:hi]
                if not np.isfinite(got).all():
                    failures.append(f"{tag} {run_key} rank {r}: non-finite logits")
                diff = np.abs(got - want)
                worst_gap = max(worst_gap, float(diff.max()))
                if run_cfg.dtype == "float32":
                    ok = np.allclose(got, want, **MODEL_TOL)
                    if not ok:
                        failures.append(f"{tag} {run_key} rank {r}: logits off one process's, "
                                        f"max_abs_err {float(diff.max()):.3e}")
                    continue
                # greedy ids: the mesh's choice at every step where one
                # process's top two are further apart than the two runs' gap
                top2 = np.sort(want, axis=-1)[..., -2:]
                margin = top2[..., 1] - top2[..., 0]
                row_gap = diff.max(axis=-1)
                decided = margin > 2 * row_gap
                same = got.argmax(-1) == want.argmax(-1)
                ties = max(ties, int((~decided).sum()))
                if not same[decided].all():
                    failures.append(f"{tag} {run_key} rank {r}: {int((~same[decided]).sum())} "
                                    f"greedy ids differ from one process's")
                run["same"] = float(same.mean())
            if run_cfg.dtype == "float32":
                print(f"{label} vs one process, logits at the prefill and every step: "
                      f"max_abs_err={worst_gap:.3e} (rtol={MODEL_TOL['rtol']}, "
                      f"atol={MODEL_TOL['atol']})")
            else:
                print(f"{label} vs one process (fed one process's greedy ids): the same greedy id "
                      f"in {min(r['same'] for r in runs):.0%} of (row, step) pairs on the worst "
                      f"rank; {ties} pairs where one process's top two are within twice the "
                      f"runs' gap (not held); bf16 logit gap max_abs_err={worst_gap:.3e} "
                      f"(information)")
            counts[f"serve parallel {run_key}"] = {
                name: sum(run["counts"][name] for run in runs) for name in COUNTERS}
            # the prefill (train mode) launches the forward on every
            # attention layer (and zamba2's SSD on every Mamba2 layer), each
            # decode step the log-sum-exp entry on every attention layer
            if cfg.family == "hybrid":
                attn = run_cfg.n_layers // max(cfg.attn_every, 1)
                want_counts = {"ssd": run_cfg.n_layers}
            else:
                attn, want_counts = run_cfg.n_layers, {}
            want_counts.update(flash_attention=attn, flash_attention_lse=attn * gen)
            for r, run in enumerate(runs):
                got = {k: v for k, v in run["counts"].items() if v}
                if got != want_counts:
                    failures.append(f"{tag} {run_key} rank {r}: launches {got}, expected "
                                    f"{want_counts}")
            print(f"{tag}   kernel launches per rank (prefill + {gen} steps): "
                  + "; ".join(f"{k} {v}" for k, v in sorted(want_counts.items()))
                  + " (every rank; flash_attention_lse on the decode steps)")
            twin_cfg = run_cfg
            for r, run in enumerate(runs):
                want = serve_twin_bytes(twin_cfg, dict(p, gen=gen), r)
                if run["step_bytes"] != want:
                    failures.append(f"{tag} {run_key} rank {r}: a decode step's collective "
                                    f"bytes {run['step_bytes']} != the dry run's {want}")
            print(f"{tag}   collective bytes a decode step, each rank (measured = the dry "
                  f"run's twin): " + ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in
                                               sorted(runs[0]["step_bytes"].items()))
                  + "; the prefill's (information): " + ", ".join(
                      f"{k} {v / 1e6:.2f} MB" for k, v in sorted(runs[0]["prefill_bytes"].items())))


def _local_heads(cfg) -> str:
    """What a rank of ``PAR_MESH`` computes of ``cfg``'s heads."""
    m = PAR_MESH[1]
    if cfg.family == "hybrid":
        H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        return (f"{H // m} of {H} SSD heads, {cfg.n_heads // m} of {cfg.n_heads} attention "
                f"heads in the shared block")
    if cfg.family == "ssm":
        return f"{cfg.n_heads // m} of {cfg.n_heads} mLSTM and sLSTM heads"
    if cfg.family == "moe":
        return (f"{cfg.n_heads // m} of {cfg.n_heads} attention heads, {cfg.n_experts // m} of "
                f"{cfg.n_experts} experts")
    return f"{cfg.n_heads // m} of {cfg.n_heads} attention heads"


if __name__ == "__main__":
    sys.exit(main())
