#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero, printing no result, on
any failure.  In order:

1. device: the card's name and power limit (``nvidia-smi``); then the
   clock's self-check: every time below is the device's time on a call's
   launches alone (``time_device``: the stream is held before the first
   event, L2 is flushed inside the hold, the median of the reps is kept),
   with the host's time a call reported apart as ``host_us``; ``torch.add``
   on a (16, 256) bf16 tensor must read at most 0.010 ms, and every timed
   kernel at least 0.95 of its bound;
2. build: compiles every kernel of the serving paths from the sources in
   this checkout, one ``nvcc`` per source (flash attention, SSD scan, int8
   quantize/dequantize, the ring-attention step), all started together,
   and prints each one's ptxas usage; for each instantiation of the two
   attention kernels and of the SSD scan, its registers, spill bytes and
   ``HGMMA`` count (``cuobjdump -sass``): the bf16 ones must run wgmma and
   spill nothing, the fp32 ones must not run wgmma; and the quant vector
   body's 13 instantiations, none spilling, with the opcodes a warp runs
   for its row tile;
3. NCCL: the default process group as a world of one over a ``file://``
   store under ``build/`` (NCCL for CUDA tensors, gloo for CPU ones);
   ``allreduce``, ``allgather``, ``broadcast``, ``shift`` and a cart's
   ``shift_exchange`` on the ring of one, through the port's communicator,
   must each return its input; so must the persistent ``allreduce_init`` on
   a bf16 tensor and on an aggregate of three dtype buckets, started twice;
   an RMA window (``core/onesided.py``) over a bf16 tensor (put, rput in
   pages, get, accumulate SUM, fetch_and_op, compare_and_swap), over an
   aggregate of three dtype buckets and a dynamic window's attach/detach
   give what the reference's rules give on a one-rank window; a
   ``DistGraphComm`` self-loop's ``neighbor_alltoall``,
   ``neighbor_alltoallv`` and ``neighbor_alltoall_init`` (started twice)
   return their input;
4. flash attention against its plain version on the card, at gemma2-9b
   width (b 2, h 16, hk 8, d 256, softcap 50, bf16; one fp32 case) and at
   zamba2-7b's (b 2, s 4096, h = hk = 32, d 112, bf16; one fp32 case),
   and at the shape phi4-mini's training step gives it (b 2, s 2048, h 24,
   hk 8, d 128, bf16), at paligemma-3b's serve (b 2, s 4352 = 256 image
   tokens + 4096, h 8, hk 1, d 256, prefix 256, bf16; one fp32 case) and
   at seamless-m4t-large-v2's encoder (b 2, s 2048, h = hk = 16, d 64, not
   causal, bf16; one fp32 case), at deepseek-v2's MLA, whose values are
   narrower than its keys (b 2, s 4096, h = hk = 128, dk 192, dv 128,
   causal, bf16; one fp32 case and a ragged GQA case with dv 64), and at
   grok-1's serve (b 2, s 4096, h 48, hk 8, d 128, softcap 30, bf16; the
   plain version of a case whose fp32 scores pass ``PLAIN_SCORE_BYTES``
   runs over groups of KV heads), bf16 cases within the limit that one bf16
   pass of P adds (``P_BF16``): error, the kernel's median time, the plain
   version's, the bound, and ``library_ms`` —
   ``F.scaled_dot_product_attention`` on the same inputs and mask but the
   softcap (its own causal flag, or the case's window or prefix mask as a
   boolean tensor), a yardstick the port never calls;
5. the SSD scan against ``ref.ssd_chunked`` on the card, y and the final
   state, at mamba2-2.7b width (b 2, l 4096, h 80, p 64, n 128, bf16, and
   the same in fp32; and l 2048, the shape of mamba2's training step) and
   zamba2-7b's (h 112, n 64), grouped, a 48-token
   chunk, fp32 with a 64-token chunk, and two bf16 edges: a ragged last
   tile with p 48 and n 96, and rows whose bytes are not a multiple of 16
   (the kernel's element-by-element load path); x, B and C are views of
   one tensor, as the model passes them.  Each case logs the launch shape
   (p tile, blocks per SM, registers).  The three bf16 full-width cases
   are timed.  No single PyTorch call computes the scan, so its ``library_ms``
   is null.  Every output element of both kernels is held within the
   limits stated at ``BF16_RTOL`` (a bf16 y with the derived term stated
   under ``P_BF16``);
6. the int8 quantize and dequantize kernels against their plain versions
   (``core/compress.py``) on the card, **bit for bit** (``torch.equal`` on
   the payload, the scales and the dequantized output): gemma2-9b's
   global-layer prefill call (1,553,664 rows of 256, bf16, and the same in
   fp32), width 128, zamba2's width 112 (bf16 and fp32; rows 128 apart;
   a view one element in), width 100 and 16, the flat API on a
   ragged 25,600-element payload (100 rows, which the Pallas kernel
   rejects), rows of zeros, rows whose x / scale lands on exact halves,
   ±absmax rows, and rows holding a NaN or an inf (NaN where the plain
   version has NaN), at width 256 and again at 112 with those elements in
   the row's last 16-byte chunk, and the vector body's other widths (bf16
   8, 32, 64; fp32 4 to 64 and 200).  Each case logs the quantize body
   that ``kernel.quant_body`` chose and must have chosen (the vector body
   for rows of whole 16-byte chunks, the warp body otherwise); the warp
   body runs on every case and the vector body wherever it was chosen,
   through the C entry and uncounted, each bit for bit; both must have been
   chosen, every vector-body instantiation must have run, and the C entry
   must refuse the vector body on a view it cannot load.  The quantize of
   both prefill calls and of a decode step's call at zamba2's and gemma2's
   shapes (64 x 112, 16 x 256) is timed in both bodies, with its host time
   and the vector body's SASS instructions per element by pipe and the
   issue time they imply (``SASS_PIPES``);
   the dequantize of one global decode layer (73,984 rows) and of a
   zamba2 layer.  Rows over 256 take the wide body (a block a row): every
   width the int8 moments quantize along (``WIDE_MOMENTS``, a piece's rows
   in fp32, the quantize and the dequantize into fp32 timed), bf16 rows,
   rows that do not start on a 16-byte boundary, and the edge rows and the
   scaled rows at 4,096 and 152,064; all three bodies must be chosen, and
   the C entry must refuse a body on rows of the other kind.  No
   single PyTorch call computes the quantize (it needs the row's absmax
   first), so its ``library_ms`` is null; the dequantize's is
   ``torch.mul(q, s, out=bf16)``, held equal to the kernel as well;
7. the ring-attention step against its plain twin (``ref.ring_step_ref``)
   on the card: a 4-rank ring emulated in one process (each rank's 4
   steps, the carry chained) at phi4-mini width (h 24, hk 8, d 128) and at
   zamba2's shared attention (h = hk = 32, d 112), bf16 and fp32, causal
   and not, 3,950 tokens in 4 shards of 1,000 (a ragged tail): the
   normalised output within the stated limits of the twin's and of
   ``flash_attention.ref.mha`` on the full sequence; one step from a
   finite mid-schedule carry, every carry element (bf16 cases and the
   carry's acc with the ``P_BF16`` term, m and l without); the two skip
   invariants (a shard wholly in the causal future, and one with no valid
   row, leave the carry exactly as it was, from a mid-schedule and from
   the initial carry); the ring of one from the initial carry against the
   flash kernel, bit for bit (they share the tile body: at d 128, and at d
   192, where a K panel lies wholly past d); and the ring of one at
   phi4-mini's serve (b 2, s 8192) and at its ring-plan training shape
   (b 2, s 2048), each held
   against the twin one Q chunk at a time and timed, with the bound, the
   twin's time (the sum over its chunks) and ``library_ms``:
   ``F.scaled_dot_product_attention`` (causal, GQA), a yardstick;
8. examples: the port's examples (``examples_torch/``) that a world of
   one runs, each in a process of its own as a user starts it (``python
   examples_torch/<name>.py``: the card, the NCCL world of one), at the
   reference scripts' own sizes, ``EXAMPLES_JOBS`` at a time (fault
   recovery beside only the runs that launch no kernel, then the others): the paper's
   listings (``quickstart``), async file I/O, ``serve_batched`` (gemma2's
   and mamba2's smoke models), the continuous-batching engine, fault
   recovery, ``train_lm`` (its ~100M model, 300 steps), the sessions,
   disaggregation and the expert fabric (``pipeline_expert_train``, whose
   pipeline demo skips on an odd world, as the reference's).  Each must
   exit 0 and print its own check lines, and launch exactly the kernels
   it runs (flash in seven, SSD in mamba2's, none in the other three; the
   counts zeroed before the script and read after it, in its process);
   its wall time and launches are printed on a line of their own;
9. serve: ``repro_torch.launch.serve`` on the full gemma2-9b config (42
   layers, 2 requests of 4608 tokens, over the 4096 window), the full
   mamba2-2.7b (64 layers, 2 x 4096) and zamba2-7b at full width, its
   depth cut to 27 of 81 layers (``SERVE_LAYERS``: 4 shared-attention
   applications and the 3 tail layers, through ``Server``; 2 x 4096),
   random weights from a seed, 16 new tokens each; then
   gemma2-9b and zamba2-7b again with the int8 KV cache, through
   ``Server`` with ``kv_cache_dtype="int8"`` (the CLI has no flag for it),
   with the same weights and prompts.  Launch counts are zeroed just before
   each serve and read just after; every kernel of the path must have
   launched exactly its expected number of times per prefill and per decode
   step; the decode step is the server's persistent request, which runs
   eagerly once, then captures a CUDA graph and replays it, so the counts
   run through replays.  A second, warm ``generate`` (which captures again)
   must repeat the tokens, and an eager greedy loop of ``bundle.decode`` on
   a fresh prefill of the same prompts must give them too (its tokens/s
   beside the warm generate's); one prefill and four decode steps are
   profiled, eager and as four replays of the server's request captured on
   that cache (the capturing start timed apart, the replays' launches
   exact; the step's program, recorded at the first generate's capture and
   not again at that capture or a replay, holds exactly the capture's
   launches as kernel ops; for gemma2's int8 cache the capture is taken
   again with the program recorded at it, timed beside the capture without
   the recorder).  An int8 serve must give the bf16
   serve's first token and hold its KV cache in 0.5 (1 + 4 / head_dim) of
   the bf16 cache's bytes; the prefill and first-decode logits' max |Δ| and
   the share of later tokens that agree are logged.  Last, phi4-mini in
   full (32 layers, 2 x 8192) through ``Server(cfg, replace(pcfg,
   ring_attention=True), scfg, comm)`` on the NCCL communicator: 32 ring
   launches per prefill, none per decode step and no flash; the same
   weights through the flash path must give the same first token (the
   prefill logits' max |Δ| is logged).  Then the full granite-3-8b (40
   layers, 2 x 4096) and qwen1.5-32b (64 layers, 2 x 1024: its weights
   take 70.4 GB), whose random init draws each stacked leaf one layer at
   a time; then the prefix-LM VLM paligemma-3b (18 layers, 2 x 4096
   text tokens after 256 image tokens each, 18 flash launches a prefill)
   and the encoder-decoder seamless-m4t-large-v2 (24 + 24 layers, 2 x 2048
   frames and tokens, 48 a prefill), each request's image embeddings or
   frames drawn by the launcher; then the MoE family at published width
   with every expert, depth cut (``SERVE_LAYERS``, through ``Server`` with
   ``replace(cfg, num_layers=...)``): grok-1 at 4 of 64 layers (21.3 B
   params, 8 experts top-2, 4 flash launches a prefill) and deepseek-v2 at
   5 of 60 (dense_0 and 4 MoE layers of 160 routed and 2 shared experts,
   top-6, MLA: 5 a prefill), 2 x 4096-token prompts, no kernel in decode;
10. small inputs: the gemma2, mamba2, zamba2, paligemma, seamless, grok and
   deepseek smoke models in fp32 (and
   gemma2 and zamba2 with the int8 cache, phi4-mini with the ring, whose
   kernel must launch once per layer) generate the same tokens on the card
   as on the CPU path (held against the JAX reference by the CPU tests);
11. engine: the continuous-batching ``Engine`` (``runtime/engine.py``) on
    the full phi4-mini (32 layers, d 3072, GQA 24/8 of 128), one weight
    tree for every setup.  A: 8 prompts of 256-2048 tokens left-padded to a
    2048 bucket, 8 slots, every budget 32, no pool cap: every request's
    tokens must equal ``Server.generate`` on the same padded prompts bit for
    bit, with the bf16 and with the int8 cache.  B: 24 requests, budgets of
    8-64 from the seed, 8 slots of 2048 + 64 tokens in blocks of 16 under a
    pool of 910 blocks: at least one preemption and one request admitted
    mid-flight, every request its budget's length, the pool drained, a
    second run's tokens identical; the share of tokens equal to the fixed
    batches' is logged, as are useful tokens/s against the same requests as
    fixed batches of 8 through ``Server.generate``, four profiled graph
    replays of the decode step on the slot table, a one-row admission
    prefill profiled and the peak memory.  Each run's launches are exact
    (flash 32 a prefill, the throwaway prefill included, none in a decode
    step; with the int8 cache the quantize 2 a prefill and 64 a decode step,
    the dequantize 64 a step), and each run captures the decode step once.
    Then the phi4-mini, grok-1 and deepseek-v2 smoke models in fp32 through
    the engine with preemption, card against CPU: the same tokens and
    stats, agreeing with each device's fixed-batch oracle on the same
    requests (all of them for the dense model; ROADMAP C15);
    Then disaggregated serving: ``DisaggregatedServer`` on the full
    phi4-mini over the NCCL world of one (prefill and decode on the card,
    the KV cache handed over through an RMA window in 4 pages), 2 requests
    of 4096 tokens, 16 new tokens, with the bf16 and the int8 cache: the
    tokens equal ``Server.generate``'s on the same weights bit for bit, a
    second generate repeats them, ``kv_bytes`` is the cache's own bytes,
    the launches are exact (flash 32 a prefill, none in the handoff or a
    decode step; with int8 the quantize 2 a prefill and 64 a step, the
    dequantize 64 a step), the decode step captured once a generate; the
    phases' times and the handoff's GB/s logged beside its bytes bound.
    Then the placement phase (``shard``, ``phase_shard``): placed serving
    and training on the mesh of one, bit for bit the plain path, and on the
    full phi4-mini's placed weights the ring prefill (2 x 8192, the ring
    step 32 a prefill), the engine (bf16 and int8, flash 32 an admission
    prefill) and the ring plan's placed state at 2 layers (the ring step 8
    in 2 steps), each against its plain run; then ``moe_neighbor`` over
    ``expert_dispatch_graph`` on the grok-1 smoke model in fp32, equal to
    ``mlp.moe`` on the same inputs, card against CPU;
12. train: ``repro_torch.runtime.trainer.Trainer`` on the card.
    ``train_small``: tests/test_trainer.py's tiny dense model and the mamba2
    smoke model in fp32, 40 steps, every loss within 1e-4 relative of the
    CPU run from the same init and batches, the loss down by more than 0.1;
    then the same run on the card with saves every 10 steps under
    ``build/`` and a worker failure injected at step 26: the trainer drops
    the step's graph, restores step 20, captures again (2 captures) and
    ends bit for bit where the uninterrupted run did;
    ``train_checkpoint``: phi4-mini at full width and 2 layers (b 2 x 2048)
    saves at steps 2 and 4 through the async manager under ``build/``, and a
    fresh ``Trainer`` restored from step 2 takes steps 3 and 4 bit for bit
    as the uninterrupted run did; ``elastic`` (``core/epoch.py`` on the NCCL
    world of one, the same model and batch, 4 steps): the eager
    ``Trainer(persistent=False)`` bit for bit the graph ``Trainer``, flash
    launched 2 x layers a step; one epoch transition (a grow by no members)
    revokes the old epoch (``ERR_REVOKED``), releases its graph (device
    memory after the successor's capture within 1% of before), builds the
    step once more (``trace:train_step`` 2, one capture each) and keeps the
    steps bit for bit the uninterrupted run's; evicting the only rank (and
    ``train --evict-at 2:0``) raises ``ERR_PROC_FAILED`` with no graph left;
    then the full phi4-mini (32 layers) and
    mamba2-2.7b at full width and 32 of its 64 layers (``TRAIN_LAYERS``)
    train 4 steps at b 2 x 2048 (remat full, fp32
    moments), after the same steps run eagerly through ``make_train_step``
    from the same seed: the trainer's steps (step 1 eager, then one graph
    captured and replayed) must give the eager steps' losses and grad norms
    bit for bit, the step's program recorded once (at the capture) with
    exactly the capture's launches as kernel ops, its ``cost_analysis()``
    logged; finite losses and grad norms, every parameter leaf changed,
    flash (phi4-mini) or SSD (mamba2) launched exactly twice per layer and
    step (the forward and remat's recompute), step time, tokens/s and peak
    memory of both runs logged beside the card, and one warm step (a
    replay) profiled.  With int8 moments (``TRAIN_FULL``): phi4-mini again,
    its step time and peak beside the fp32 run's, and granite-3-8b (at 20
    of its 40 layers, ``TRAIN_LAYERS``; its fp32 moments do not fit at
    40), the quantize and the
    dequantize launched exactly twice a moment piece and step; and
    ``train_small``'s tiny model with int8 moments, held to the CPU run for
    its first ``TRAIN_SMALL_INT8_HELD`` steps (the reference's int8 moments
    diverge, ROADMAP C10), then finite and bit for bit through the restore.
    Last, with fp32 moments, the full paligemma-3b (flash 36 times a step:
    the forward and the recompute of 18 layers, over 256 image tokens and
    2048 text tokens) and seamless-m4t-large-v2 (96: 24 encoder layers
    over 256 frames and 24 decoder layers over 2048 tokens); and with int8
    moments, depth cut (``TRAIN_LAYERS``), grok-1 at 1 layer (2 flash
    launches a step) and deepseek-v2 at dense_0 and 1 MoE layer (3: the
    leading dense layer is not rematted, as in the reference); every
    parameter leaf is held whole against its initial copy.  Then ``tune``
    (``phase_tune``): the tuner (``repro_torch.tune``, the H100's roofline
    of ``core/tool.py``) over every applicable arch x ``SHAPES`` cell on 1,
    4 and 8 cards, twice, equal; ``train --plan auto`` through
    ``launch.train.resolve_plan`` for the full phi4-mini at b 2 x 2048, 4
    steps (graph from step 2), flash launched once a layer and step if the
    winner's remat is none, twice otherwise, the first loss bit for bit
    the data-plan phase's, the winner's predicted step and peak beside the
    warm step and ``max_memory_allocated``; ``serve --plan auto`` for
    phi4-mini at full width and 8 layers, the winner ``d1``, tokens bit for
    bit the plain server's, flash once a layer a prefill.  Then ``dryrun``
    (``phase_dryrun``): the dry run (``repro_torch.launch.dryrun``, its
    stand-ins on the card's device type, nothing launched), each cell a
    process of its own, one after another: phi4-mini
    ``train_4k`` on the fake ``pod_16x16`` world (256 ranks; flash traced
    as the custom op, collectives counted), the ``tune`` cell (b 2 x 2048,
    one card, no remat) beside the tuner's prediction and the ``tune``
    phase's measured peak and step, and qwen1.5-32b's 2 x 4096 prefill on
    four cards as ``d4``, over the card, and on the grid of ``serve --plan
    auto``'s winner, not ``d4`` and within the card (ROADMAP C22), each
    one's trace time, peak a card against ``HBM_BYTES``, dominant term and
    useful-flops ratio;
    ``tune.load_calibration`` reads the pod artifact and the tuner's
    calibrated step is printed, and the ``tune`` phase's trainer's
    ``cost_analysis()`` (its program recorded at its capture) beside the
    ``tune`` cell's counted flops and bytes.  Then ``analyze`` (``phase_analyze``),
    under the ``analysis_recording`` cvar: phi4-mini at full width and 4
    layers served with the int8 cache (flash and the quant kernels launch)
    and 2 ``Trainer`` steps (one capture), 0 findings; a seeded start
    fired while the previous start's future is unconsumed, exactly one
    ``ERR_REQUEST``; a warm decode replay and an eager immediate allreduce
    timed with recording on and off.
    Then the two plans that re-form the fabric, on the NCCL world of one:
    ``train_phi4_mini_3_8b_ring``, the full phi4-mini with
    ``pcfg.ring_attention`` (a ring of one, which bypasses the rotation)
    through ``Trainer`` as above, the ring-step kernel launched exactly
    twice per layer and step (64) and flash never, the graph steps bit for
    bit the eager ring steps, every leaf changed, the losses and the first
    grad norm within ``TRAIN_RING_RTOL`` of the flash run's, its step time,
    tokens/s and peak beside the flash run's; and
    ``train_phi4_mini_3_8b_pipeline``, the full phi4-mini through
    ``make_pipeline_train_step`` on a (1, 1) cart (which bypasses every
    exchange), 2 microbatches of 1 x 2048, 4 eager steps: losses and grad
    norms within ``TRAIN_PIPELINE_RTOL`` of the data plan's, flash launched
    exactly microbatches x layers x 2 (128) times a step, step time and
    peak beside the data plan's eager steps;
13. grad sync: ``PartitionedGradSync`` with int8 error feedback on the NCCL
    world of one over phi4-mini's gradient tree at full width (2 layers),
    bit for bit the same call with the plain row functions, the residual m
    - C(m), one quantize and one dequantize a leaf, two ``pready`` orders
    bit-equal; the call and its error-feedback share timed;
14. the ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
    last.

Every phase prints its wall time on a line of its own, ``{"phase": ...,
"wall_s": ...}``, as it ends, and the run's total, ``{"run_s": ...}``,
before the ``kernels`` line.

Also writes everything it prints as JSON to ``artifacts/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import tool as _tool  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound's rates, the
# bf16 peak and the HBM rate from the hardware model the tuner scores with
PEAK_FLOPS = {"bfloat16": _tool.PEAK_FLOPS_BF16, "float32": 67e12}
HBM_BYTES_PER_S = _tool.HBM_BANDWIDTH
# Each element is held as |kernel - plain| <= atol + rtol * |plain|, where
# plain is the plain version in fp32 on the same values (it upcasts its
# inputs in any case).  Both compute in fp32; a bf16 output is the kernel's
# value rounded once, within half a bf16 ulp of it (2^-8 relative), so its
# rtol adds 2^-8 to the fp32 limits.
BF16_RTOL = 2.0 ** -8
# bf16 attention rounds P to bf16 once for its second product (as production
# flash kernels and SDPA do): each p moves by at most 2^-8 p, so an output
# by at most 2^-8 (sum_k p_k |v_k|) / l, the plain version run on |v|.  The
# bf16 attention cases add P_BF16 times that to their limit, and log their
# worst share of the limit without it.
P_BF16 = 2.0 ** -8
# bf16 SSD likewise rounds two fp32 operands of y to bf16 once each, the
# masked, decayed C B^T and the carried state for C H_in^T: every decay
# factor is non-negative, so y moves by at most 2^-8 times the plain version
# run on |x|, |B| and |C|.  Its y limit adds P_BF16 times that; its state,
# which the kernel keeps to fp32 accuracy (X w split into two bf16 terms),
# keeps the fp32 limits.
FLASH_FP32_TOL = 1e-4  # flash: atol, rtol 0
SSD_FP32_TOL = 5e-5    # SSD: atol and rtol, as tests/test_kernels.py
NEW_TOKENS = 16
QUANT, DEQUANT = "quantize_int8_rows", "dequantize_int8_rows"
RING = "ring_step_fwd"
# the ring step's carry is fp32 state, held at fp32 limits where it is
# compared element by element (sums taken in another order)
RING_CARRY_RTOL = 1e-5
# arch, layers, d_model, prompt length, KV cache dtype, ring attention,
# kernel launches per prefill and per decode step (a kernel not named
# launches none): gemma2 quantizes k and v of its local and global stacks
# once each per prefill, and k_new, v_new and reads the cache in each of 42
# layers per step; zamba2 does the same for its one stack of shared-
# attention layers (4 at the 27 layers SERVE_LAYERS cuts it to); phi4-mini's ring of one launches the ring step
# once in each of its 32 layers and decodes with no kernel
SERVES = [
    ("gemma2_9b", 42, 3584, 4608, "bfloat16", False, {"flash_attention_fwd": 42}, {}),
    ("mamba2_2_7b", 64, 2560, 4096, "bfloat16", False, {"ssd_scan_fwd": 64}, {}),
    ("zamba2_7b", 27, 3584, 4096, "bfloat16", False,
     {"flash_attention_fwd": 4, "ssd_scan_fwd": 27}, {}),
    ("gemma2_9b", 42, 3584, 4608, "int8", False, {"flash_attention_fwd": 42, QUANT: 4},
     {QUANT: 84, DEQUANT: 84}),
    ("zamba2_7b", 27, 3584, 4096, "int8", False,
     {"flash_attention_fwd": 4, "ssd_scan_fwd": 27, QUANT: 2}, {QUANT: 8, DEQUANT: 8}),
    ("phi4_mini_3_8b", 32, 3072, 8192, "bfloat16", True, {RING: 32}, {}),
    # the two dense archs served nowhere else; qwen1.5-32b's bf16 weights
    # are 70.4 GB of the card's 80 and its cache 1.31 MB a token (64 layers,
    # 40 KV heads of 128), so its prompts are 1024 tokens: with a profiled
    # second prefill's cache beside the first, 78.6 GB at the peak
    ("granite_3_8b", 40, 4096, 4096, "bfloat16", False, {"flash_attention_fwd": 40}, {}),
    ("qwen1_5_32b", 64, 5120, 1024, "bfloat16", False, {"flash_attention_fwd": 64}, {}),
    # the prefix-LM VLM: 256 image tokens before each 4096-token prompt, 18
    # flash launches a prefill; the encoder-decoder: 2048 frames through 24
    # non-causal encoder layers and 2048 tokens through 24 causal decoder
    # layers, 48 a prefill (its cross-attention is plain, as the reference's)
    ("paligemma_3b", 18, 2048, 4096, "bfloat16", False, {"flash_attention_fwd": 18}, {}),
    ("seamless_m4t_large_v2", 24, 1024, 2048, "bfloat16", False,
     {"flash_attention_fwd": 48}, {}),
    # the MoE family and MLA + MoE at their published widths with every
    # expert, depth cut to fit the card (SERVE_LAYERS): grok-1's 4 layers
    # are 21.3 B params (42.6 GB of bf16 weights), deepseek-v2's dense_0
    # and 4 MoE layers 17.3 B (34.6 GB); decode runs no kernel (plain
    # decode attention, the absorbed MLA decode)
    ("grok_1_314b", 4, 6144, 4096, "bfloat16", False, {"flash_attention_fwd": 4}, {}),
    ("deepseek_v2_236b", 5, 5120, 4096, "bfloat16", False, {"flash_attention_fwd": 5}, {}),
]
# the serves whose depth is cut (of grok-1's 64 layers and deepseek-v2's 60
# to fit the card; of zamba2-7b's 81 to keep the run inside its time, at
# 4 shared-attention applications of 6 layers and the 3 tail layers): they
# go through ``Server`` with ``replace(cfg, num_layers=...)``, the
# launcher's config, seed and prompts otherwise
SERVE_LAYERS = {"grok_1_314b": 4, "deepseek_v2_236b": 5, "zamba2_7b": 27}

# the port's kernel bodies, as the profiler names them
PORT_KERNELS = ("fwd_kernel<", "ssd_kernel<", "quant_kernel<", "quant_vec_kernel<",
                "quant_wide_kernel<", "step_kernel<")
# Hopper's pipes in lanes a clock per SM (CUDA C++ Programming Guide, the
# arithmetic instruction throughput table, compute capability 9.0) and the
# SASS opcodes each runs: the quant vector body's instructions are counted
# by pipe, and the time they take to issue at these rates is logged beside
# its bound; an opcode named here under no pipe is counted as "other"
SASS_PIPES = {
    "fp32": (128, ("FFMA", "FMUL", "FADD")),
    "integer": (64, ("IMAD", "IADD3", "LOP3", "SHF", "IMNMX", "VIMNMX", "ISETP", "FSETP",
                     "FMNMX", "SEL", "FSEL", "PRMT", "LEA", "MOV", "PLOP3", "IABS")),
    "conversion": (16, ("F2I", "I2F", "F2F", "FRND", "MUFU", "I2I")),
    "shuffle": (32, ("SHFL",)),
}
# warp instructions an SM issues a clock (four schedulers), and the H100
# SXM's boost clock: a lower clock under load makes every issue time longer
SASS_ISSUE_PER_CLOCK = 4
SM_CLOCK_HZ = 1.98e9

RESULTS: dict = {}
# the bf16 serves' tokens, logits and KV bytes, which the int8 serves are read against
BF16_SERVES: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def log_row(row: dict) -> None:
    log(json.dumps({k: (round(v, 6) if isinstance(v, float) else v) for k, v in row.items()}))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


#: the serve path whose decode capture is timed with and without the
#: recorder of the step's program (``core/hloanalysis.py``)
RECORD_TIMED_PATH = "gemma2_9b_int8"


@contextlib.contextmanager
def _counting_records():
    """Every recording of a request's program in the block: the list of the
    step functions recorded (``hloanalysis.record``, which a
    ``PersistentRequest`` calls at its capture or first eager start)."""

    from repro_torch.core import hloanalysis

    seen, real = [], hloanalysis.record

    def counting(fn, *args, **kwargs):
        seen.append(fn)
        return real(fn, *args, **kwargs)

    hloanalysis.record = counting
    try:
        yield seen
    finally:
        hloanalysis.record = real


def _program_against_capture(path: str, req) -> dict:
    """The request's recorded program (``req.compiled``, recorded at a
    capture: never recorded anew here) against its last capture: each
    kernel op's count must equal the launches the capture recorded."""

    check(req._program is not None, f"{path}: no program was recorded at the capture")
    program = req.compiled
    ops = {k.removeprefix("repro_torch."): n for k, n in program.kernels().items()}
    launched = {k: n for k, n in req._launches.items() if n}
    check(ops == launched, f"{path}: the program's kernel ops {ops} != the capture's "
                           f"launches {launched}")
    return {"ops": len(program.ops), "kernel_ops": ops, "capture_launches": launched}


# The clock (``time_device``).  Each rep holds the stream with a spin kernel
# (``torch.cuda._sleep``) before its first event, so that the flush, e0,
# every launch of fn and e1 are all queued before the device reaches e0: the
# events then bracket the device's time on fn's launches alone, not the host
# work in the wrapper before each launch (which is reported apart, as
# host_us).  Inside the held region, before e0, L2 is flushed: a write of
# 2 x 50 MB evicts fn's inputs and the last rep's outputs, and a read of as
# many clean bytes then evicts the write's dirty lines, whose write-back
# would otherwise land inside the timed window.
L2_FLUSH_BYTES = 128 * 2 ** 20
# torch.cuda._sleep spins a number of cycles; the H100 SXM clocks at most
# 1.98 GHz, so a hold of this many cycles a ms lasts at least that long
CYCLES_PER_MS = 1_980_000
# the least a hold lasts, and how much longer than one call's host time
MIN_HOLD_MS = 1.0
HOLD_OVER_HOST = 4.0
# after a rep the host did not queue within its hold, the hold doubles up to
# this; a timing makes at most RETIME_ATTEMPTS x reps attempts
MAX_HOLD_MS = 64.0
RETIME_ATTEMPTS = 3
# the clock's self-check: one small PyTorch launch must read at most this
CLOCK_SELF_CHECK_MS = 0.010
# no timed kernel may read below this share of its bound
BOUND_FLOOR = 0.95
_FLUSH: dict = {}


def time_device(fn, reps: int) -> dict:
    """Median over ``reps`` of the device time of ``fn``'s launches (ms),
    and median host time of one call of ``fn`` (µs), after one warm call;
    ``hold_ms`` is the last rep's hold and ``held`` whether every kept rep's
    host time fit inside its hold (else the device may have idled between
    e0 and e1)."""

    import torch

    if not _FLUSH:
        n = L2_FLUSH_BYTES // 4
        _FLUSH.update(w=torch.empty(n, device="cuda"), r=torch.zeros(n, device="cuda"),
                      out=torch.empty((), device="cuda"))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    warm_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    hold_ms = max(MIN_HOLD_MS, HOLD_OVER_HOST * warm_host_ms)
    times, late, host_s = [], [], []
    # a rep whose queueing outlasted its hold (a host hiccup) is set aside and
    # timed again with the hold doubled, up to RETIME_ATTEMPTS x reps attempts
    # in all; late reps fill the count only where too few were held, and then
    # ``held`` is false
    for _ in range(RETIME_ATTEMPTS * reps):
        if len(times) == reps:
            break
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(int(hold_ms * CYCLES_PER_MS))
        _FLUSH["w"].fill_(1.0)
        torch.sum(_FLUSH["r"], dim=0, out=_FLUSH["out"])
        e0.record()
        t1 = time.perf_counter()
        fn()
        host_s.append(time.perf_counter() - t1)
        e1.record()
        ok = (time.perf_counter() - t0) * 1e3 < hold_ms
        e1.synchronize()
        (times if ok else late).append(e0.elapsed_time(e1))
        if not ok:
            hold_ms = min(2 * hold_ms, MAX_HOLD_MS)
    held = len(times) == reps
    times += late[: reps - len(times)]
    return {"ms": statistics.median(times), "host_us": statistics.median(host_s) * 1e6,
            "hold_ms": hold_ms, "held": held, "reps_retimed": len(host_s) - reps}


def time_ms(fn, reps: int) -> float:
    """The device time of ``fn``'s launches (``time_device``), in ms."""

    return time_device(fn, reps)["ms"]


def _kernel_timed(row: dict, fn, reps: int) -> dict:
    """``ms`` and ``host_us`` of a kernel's wrapper into ``row``."""

    t = time_device(fn, reps)
    row.update(ms=t["ms"], host_us=t["host_us"], hold_ms=t["hold_ms"], held=t["held"],
               reps_retimed=t["reps_retimed"])
    return row


def _bound_held(name: str, row: dict) -> None:
    """A kernel that reads below ``BOUND_FLOOR`` of its bound is a fault of
    the clock (or of the bound): the phase fails."""

    check(row["ms"] >= BOUND_FLOOR * row["bound_ms"],
          f"{name}: {row['ms']} ms reads below {BOUND_FLOOR} x its bound {row['bound_ms']} ms")
    check(row["held"], f"{name}: the host did not queue the kernel within the {row['hold_ms']} "
                       f"ms hold")


def phase_clock():
    """The clock's self-check: ``torch.add`` on a (16, 256) bf16 tensor, one
    launch of a few µs on the device, must read at most
    ``CLOCK_SELF_CHECK_MS``; its host time per call is logged beside it."""

    import torch

    x = torch.randn((16, 256), device="cuda").to(torch.bfloat16)
    t = time_device(lambda: torch.add(x, x), 20)
    RESULTS["clock_self_check"] = {"case": "torch.add (16, 256) bf16", **t,
                                   "limit_ms": CLOCK_SELF_CHECK_MS}
    log_row(RESULTS["clock_self_check"])
    check(t["ms"] <= CLOCK_SELF_CHECK_MS,
          f"clock self-check: torch.add (16, 256) reads {t['ms']} ms > {CLOCK_SELF_CHECK_MS}")


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    RESULTS["device"] = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}
    # fp32 products in full fp32: the fp32 tolerance assumes no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _kernel_modules() -> list:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.kernels.ring_attention import kernel as rk
    from repro_torch.kernels.ssd_scan import kernel as sk

    return [fk, sk, qk, rk]


def _reset_launches() -> None:
    for m in _kernel_modules():
        m.reset_launches()


def _launches() -> dict:
    """Launches of every kernel entry point since the last reset."""

    fk, sk, qk, rk = _kernel_modules()
    return {"flash_attention_fwd": fk.LAUNCHES, "ssd_scan_fwd": sk.LAUNCHES, **qk.LAUNCHES,
            RING: rk.LAUNCHES}


def _ptxas_usage(text: str) -> dict:
    """Registers and spill bytes (stores + loads) of each function in
    ``nvcc -Xptxas -v``'s report."""

    usage, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$.]+)", line)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            usage[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["registers"] = int(m.group(1))
    return usage


def _sass_functions(lib_path) -> dict:
    """Each function of a built library (``cuobjdump -sass``) → its
    instructions as ``(address, text)`` under ``code``, and its branch
    labels (``.L_x_N``) → the address they mark, under ``labels``."""

    from repro_torch.kernels import nvcc

    sass = subprocess.run([str(nvcc.toolkit_binary("cuobjdump")), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    funcs, fn, pending = {}, None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn, pending = m.group(1), []
            funcs[fn] = {"code": [], "labels": {}}
            continue
        if fn is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            funcs[fn]["labels"].update(dict.fromkeys(pending, addr))
            pending = []
            funcs[fn]["code"].append((addr, m.group(2)))
    return funcs


def _hgmma_counts(lib_path) -> dict:
    """``HGMMA`` (wgmma) instructions in each function of a built library."""

    return {fn: sum("HGMMA" in text for _, text in f["code"])
            for fn, f in _sass_functions(lib_path).items()}


_SASS_OPCODE = re.compile(r"(?:@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9_]*)")


def _tile_opcodes(func: dict) -> dict:
    """Opcode counts from a function's entry to its first unpredicated
    EXIT: the path one warp of the quant vector body runs for its row tile
    (the call sites of its out-of-line blocks included), without those
    blocks, which nvcc lays out after the EXIT (the slow division,
    ``store_exact``, the divergent shuffles' fallbacks)."""

    counts: dict = {}
    for _, text in func["code"]:
        op = _SASS_OPCODE.match(text).group(1)
        counts[op] = counts.get(op, 0) + 1
        if text == "EXIT":
            return counts
    check(False, "quant vector body: no unpredicated EXIT in its SASS")
    return counts


def phase_build():
    """Build every library afresh (its ptxas report is read here); for each
    instantiation of the attention and SSD kernels, registers, spills and
    HGMMA count: the bf16 ones must run wgmma and spill nothing, the fp32
    ones none; the quant vector body's instantiations, none spilling, and
    the opcodes of the path each one's warps run for a row tile."""

    fk, sk, qk, rk = _kernel_modules()  # first: nvcc's users import it through the core
    from repro_torch.kernels import nvcc

    libs = [m.LIBRARY for m in _kernel_modules()]
    t0 = time.perf_counter()
    nvcc.build_all(libs, force=True)
    RESULTS["build_s"] = time.perf_counter() - t0
    log(f"built {', '.join(lib.name for lib in libs)} in {RESULTS['build_s']:.1f}s")
    for lib in libs:
        usage = [l.split("info    : ")[-1] for l in lib.log.splitlines()
                 if "registers" in l or "spill" in l]
        log(f"{lib.name} ptxas: " + " | ".join(usage))
    RESULTS["attention_instantiations"] = {}
    # (library, kernel body, bf16 instantiations, all instantiations): the
    # attention kernels have one per head width, the SSD kernel bf16 ones
    # for n <= 64 and n <= 128 and one fp32
    for lib, body, n_bf16, n_all in ((fk.LIBRARY, "fwd_kernel", 3, 7),
                                     (rk.LIBRARY, "step_kernel", 3, 7),
                                     (sk.LIBRARY, "ssd_kernel", 2, 3)):
        usage, hgmma = _ptxas_usage(lib.log), _hgmma_counts(lib.build())
        rows = {fn: {**usage.get(fn, {}), "hgmma": n} for fn, n in hgmma.items() if body in fn}
        log(f"{lib.name} instantiations: " + json.dumps(rows))
        bf16 = [fn for fn in rows if "__nv_bfloat16" in fn]
        check(len(bf16) == n_bf16 and len(rows) == n_all,
              f"{lib.name}: {len(bf16)} bf16 of {len(rows)} instantiations, "
              f"want {n_bf16} of {n_all}")
        for fn, row in rows.items():
            check("spill_bytes" in row, f"{lib.name}: no ptxas report for {fn}")
            if fn in bf16:
                check(row["hgmma"] > 0 and row["spill_bytes"] == 0,
                      f"{lib.name}: bf16 {fn} has {row['hgmma']} HGMMA and "
                      f"{row['spill_bytes']} bytes of spills")
            else:
                check(row["hgmma"] == 0, f"{lib.name}: fp32 {fn} runs wgmma")
        if lib is sk.LIBRARY:
            RESULTS["ssd_instantiations"] = rows
        else:
            RESULTS["attention_instantiations"][lib.name] = rows
    # the quant vector body: one instantiation per (dtype, lanes a row,
    # chunks a lane), none spilling; the opcodes a warp runs for its row
    # tile are kept for the timed cases' issue times
    usage, vec = _ptxas_usage(qk.LIBRARY.log), {}
    for fn, func in _sass_functions(qk.LIBRARY.build()).items():
        m = re.search(r"quant_vec_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELi(\d+)E", fn)
        if m:
            dtype = "float32" if m.group(1) == "f" else "bfloat16"
            r, log_g, k = (int(g) for g in m.groups()[1:])
            vec[f"{dtype} R{r} G{2 ** log_g} K{k}"] = {
                "dtype": dtype, "rows_in_flight": r, "log_g": log_g, "k": k,
                **usage.get(fn, {}), "tile_opcodes": _tile_opcodes(func)}
    log("quant vector-body instantiations: " + json.dumps(
        {name: {k: v for k, v in row.items() if k != "tile_opcodes"} for name, row in vec.items()}))
    check(len(vec) == 13 and all(r.get("spill_bytes") == 0 for r in vec.values()),
          f"quant: {len(vec)} vector-body instantiations (want 13), or one spills")
    RESULTS["quant_vec_instantiations"] = vec


def _held(name, out, plain, atol, rtol, abs_v=None) -> dict:
    """Hold ``out`` elementwise within ``atol + rtol * |plain|`` of the fp32
    ``plain``, plus ``P_BF16 * abs_v`` where ``abs_v`` (the plain version
    run on |v|) is given; the worst element's share of its limit, and mean
    |plain|, are logged so the limit can be read against the values, and
    with ``abs_v`` also the worst share of the limit without the term and the
    count of elements outside it."""

    diff = (out.float() - plain).abs()
    old = atol + rtol * plain.abs()
    limit = old if abs_v is None else old + P_BF16 * abs_v
    ratio = (diff / limit).max().item()
    err = diff.max().item()
    extra = "" if abs_v is None else f" + {P_BF16} plain(|.|)"
    check(math.isfinite(err) and ratio <= 1.0,
          f"{name}: max abs err {err}, worst element at {ratio} of atol {atol} + rtol {rtol}"
          f"{extra}")
    row = {"max_abs_err": err, "atol": atol, "rtol": rtol, "worst_err_over_limit": ratio,
           "mean_abs_plain": plain.abs().mean().item()}
    if abs_v is not None:
        row.update(p_bf16=P_BF16, worst_err_over_old_limit=(diff / old).max().item(),
                   n_outside_old_limit=int((diff > old).sum().item()))
    return row


# the plain attention holds its fp32 scores (b, h, s, s) three times over:
# a case whose scores pass this many bytes runs it over groups of KV heads
PLAIN_SCORE_BYTES = 8e9


def _mha_by_heads(q, k, v, **kw):
    """``ref.mha`` on the whole case, or over groups of KV heads (and their
    query heads) where its scores would pass ``PLAIN_SCORE_BYTES``: the
    same function, its outputs concatenated."""

    import torch

    from repro_torch.kernels.flash_attention import ref

    b, s, h, _ = q.shape
    hk = k.shape[2]
    g = h // hk
    per_kv_head = 4 * b * g * s * k.shape[1]
    n = max(1, min(hk, int(PLAIN_SCORE_BYTES // per_kv_head)))
    while hk % n:
        n -= 1
    if n == hk:
        return ref.mha(q, k, v, **kw)
    return torch.cat([ref.mha(q[:, :, i * g:(i + n) * g], k[:, :, i:i + n], v[:, :, i:i + n],
                              **kw) for i in range(0, hk, n)], dim=2)


def _attention_case(name, seed, *, b, s, h, hk, d, dtype, reps, dv=None, **kw):
    """Kernel vs plain on one shape (values of width ``dv``, ``d`` if not
    given): error, times and bound."""

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    dv = dv or d
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, hk, dv), generator=gen, device="cuda").to(dt)
    out = fk.flash_attention_fwd(q, k, v, **kw)
    check(out.shape == (b, s, h, dv), f"flash {name}: output {tuple(out.shape)}")
    plain = _mha_by_heads(q.float(), k.float(), v.float(), **kw)
    bf16 = dtype == "bfloat16"
    abs_v = _mha_by_heads(q.float(), k.float(), v.float().abs(), **kw) if bf16 else None
    torch.cuda.synchronize()
    held = _held(f"flash {name}", out, plain, FLASH_FP32_TOL, BF16_RTOL if bf16 else 0.0, abs_v)
    row = {"case": name, "shape": [b, s, h, hk, d] + ([dv] if dv != d else []),
           "dtype": dtype, **held,
           **{k_: v_ for k_, v_ in kw.items() if k_ != "scale"}}
    if reps:
        mask = ref.attention_mask(
            s, s, causal=kw.get("causal", True), sliding_window=kw.get("sliding_window"),
            prefix_len=kw.get("prefix_len"), device="cuda")
        pairs = int(mask.sum().item()) * b * h
        # Q K^T over d and P V over dv, two operations a multiply-add
        flops = 2 * (d + dv) * pairs
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # the yardstick computes the case's function but the softcap: SDPA's
        # own causal mask, or the case's mask as a boolean tensor where a
        # window or a prefix changes it
        masked = kw.get("sliding_window") is not None or kw.get("prefix_len") is not None
        sdpa_mask = mask if masked else None
        sdpa_causal = kw.get("causal", True) and not masked
        _kernel_timed(row, lambda: fk.flash_attention_fwd(q, k, v, **kw), reps)
        row.update(
            library_call=("SDPA, boolean mask" if masked
                          else f"SDPA, is_causal={sdpa_causal}"),
            plain_ms=time_ms(lambda: _mha_by_heads(q, k, v, **kw), max(2, reps // 4)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, is_causal=sdpa_causal, scale=kw.get("scale"),
                enable_gqa=True), reps),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes,
        )
        _bound_held(f"flash {name}", row)
    log_row(row)
    del q, k, v, out, plain, abs_v
    torch.cuda.empty_cache()
    return row


def phase_kernels():
    gemma = dict(b=2, h=16, hk=8, d=256, causal=True, logit_softcap=50.0, scale=256.0 ** -0.5)
    rows = [
        _attention_case("global_4608", 0, s=4608, dtype="bfloat16", reps=10, **gemma),
        _attention_case("local_4608_w4096", 1, s=4608, dtype="bfloat16", reps=10,
                        sliding_window=4096, **gemma),
        _attention_case("ragged_4601_w4096", 2, s=4601, dtype="bfloat16", reps=0,
                        sliding_window=4096, **gemma),
        _attention_case("prefix300_1000", 3, s=1000, dtype="bfloat16", reps=0, prefix_len=300,
                        sliding_window=512, **gemma),
        _attention_case("fp32_1000", 4, s=1000, dtype="float32", reps=0, **gemma),
        _attention_case("zamba2_4096_d112", 5, b=2, s=4096, h=32, hk=32, d=112,
                        dtype="bfloat16", reps=10, causal=True),
        _attention_case("zamba2_fp32_1000_d112", 6, b=1, s=1000, h=32, hk=32, d=112,
                        dtype="float32", reps=0, causal=True),
        # the 64-wide tile: one batch, one KV head, a ragged length; a
        # padded d 32 without the causal mask
        _attention_case("mqa_b1_333_d64", 7, b=1, s=333, h=4, hk=1, d=64, dtype="bfloat16",
                        reps=0, causal=True),
        _attention_case("full_200_d32", 8, b=1, s=200, h=2, hk=2, d=32, dtype="bfloat16",
                        reps=0, causal=False),
        # the shape phi4-mini's training step gives the kernel (the unpadded
        # 128-wide tile, GQA 24/8, no softcap)
        _attention_case("phi4_train_2048_d128", 9, b=2, s=2048, h=24, hk=8, d=128,
                        dtype="bfloat16", reps=10, causal=True, scale=128.0 ** -0.5),
        # the shapes the engine's phi4-mini path gives the kernel: an
        # admission side batch of 8 rows at the 2048 bucket, and resumes,
        # which re-prefill prompt + generated[:-1] at lengths off the tile
        _attention_case("phi4_engine_admit_8x2048", 18, b=8, s=2048, h=24, hk=8, d=128,
                        dtype="bfloat16", reps=0, causal=True, scale=128.0 ** -0.5),
        _attention_case("phi4_engine_resume_1x2071", 19, b=1, s=2071, h=24, hk=8, d=128,
                        dtype="bfloat16", reps=0, causal=True, scale=128.0 ** -0.5),
        _attention_case("phi4_engine_resume_2x2093", 20, b=2, s=2093, h=24, hk=8, d=128,
                        dtype="bfloat16", reps=0, causal=True, scale=128.0 ** -0.5),
        # paligemma-3b's serve: 256 image tokens, a bidirectional prefix,
        # before 4096 text tokens; MQA (8 query heads over 1 KV head) at d 256
        _attention_case("paligemma_prefix256", 10, b=2, s=4352, h=8, hk=1, d=256,
                        dtype="bfloat16", reps=10, causal=True, prefix_len=256,
                        scale=256.0 ** -0.5),
        _attention_case("paligemma_fp32_1000", 11, b=1, s=1000, h=8, hk=1, d=256,
                        dtype="float32", reps=0, causal=True, prefix_len=256,
                        scale=256.0 ** -0.5),
        # seamless-m4t-large-v2's encoder: 2 x 2048 frames, bidirectional,
        # 16 heads of 64
        _attention_case("seamless_encoder", 12, b=2, s=2048, h=16, hk=16, d=64,
                        dtype="bfloat16", reps=10, causal=False, scale=64.0 ** -0.5),
        _attention_case("seamless_encoder_fp32_1000", 13, b=1, s=1000, h=16, hk=16, d=64,
                        dtype="float32", reps=0, causal=False, scale=64.0 ** -0.5),
        # deepseek-v2's MLA: 128 heads, keys of nope 128 + rope 64 = 192 (the
        # 256-wide tile) and values of 128, scale 1 / sqrt(192)
        _attention_case("deepseek_mla_4096_dk192_dv128", 14, b=2, s=4096, h=128, hk=128,
                        d=192, dv=128, dtype="bfloat16", reps=10, causal=True,
                        scale=192.0 ** -0.5),
        _attention_case("deepseek_mla_fp32_1000", 15, b=1, s=1000, h=16, hk=16, d=192, dv=128,
                        dtype="float32", reps=0, causal=True, scale=192.0 ** -0.5),
        # ragged, a value width under one 64-column panel, GQA
        _attention_case("mla_ragged_333_dk192_dv64", 16, b=1, s=333, h=4, hk=2, d=192, dv=64,
                        dtype="bfloat16", reps=0, causal=True, scale=192.0 ** -0.5),
        # grok-1's serve: 48 query heads over 8 KV heads of 128, softcap 30
        _attention_case("grok_4096_softcap30", 17, b=2, s=4096, h=48, hk=8, d=128,
                        dtype="bfloat16", reps=10, causal=True, logit_softcap=30.0,
                        scale=128.0 ** -0.5),
    ]
    RESULTS["kernel_cases"] = rows


def _ssd_case(name, seed, *, b, l, h, p, n, g, dtype, chunk=128, reps=0):
    """SSD kernel vs ``ref.ssd_chunked`` on one shape, y and the final
    state: errors, the instantiation's launch shape (registers, p tile,
    blocks per SM) and, with ``reps``, times and bound.  x, B and C are
    views of one (b, l, h p + 2 g n) tensor, as the model passes them; rows
    whose bytes are not a multiple of 16 send a bf16 call down the kernel's
    element-by-element load path."""

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt_ = getattr(torch, dtype)
    di, gn = h * p, g * n
    xbc = torch.randn((b, l, di + 2 * gn), generator=gen, device="cuda").to(dt_)
    x = xbc[..., :di].unflatten(-1, (h, p))
    B = xbc[..., di:di + gn].unflatten(-1, (g, n))
    C = xbc[..., di + gn:].unflatten(-1, (g, n))
    dts = 0.1 * F.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda"))
    y, state = sk.ssd_scan_fwd(x, dts, A, B, C, chunk=chunk, return_state=True)
    py, pstate = ref.ssd_chunked(x.float(), dts, A, B.float(), C.float(), chunk=chunk)
    bf16 = dtype == "bfloat16"
    abs_y = (ref.ssd_chunked(x.float().abs(), dts, A, B.float().abs(), C.float().abs(),
                             chunk=chunk)[0] if bf16 else None)
    torch.cuda.synchronize()
    shape = sk.launch_shape(dt_, n)
    inst = next((row for fn, row in RESULTS.get("ssd_instantiations", {}).items()
                 if ("__nv_bfloat16" in fn) == bf16
                 and (not bf16 or f"Li{64 if n <= 64 else 128}E" in fn)), {})
    row = {"case": name, "shape": [b, l, h, p, n, g], "chunk": chunk, "dtype": dtype,
           "row_stride": xbc.stride(1), **shape, "registers": inst.get("registers")}
    # the fp32 state is held at the fp32 limits in every case; a bf16 y adds
    # half a bf16 ulp to rtol and the derived term of its two bf16 operands
    y_rtol = SSD_FP32_TOL + (BF16_RTOL if bf16 else 0.0)
    for part, out, plain, rtol, abs_v in (("y", y, py, y_rtol, abs_y),
                                          ("state", state, pstate, SSD_FP32_TOL, None)):
        held = _held(f"ssd {name} {part}", out, plain, SSD_FP32_TOL, rtol, abs_v)
        row.update({f"{k_}_{part}": v_ for k_, v_ in held.items()})
    if bf16:
        row["derived_term_y"] = f"{P_BF16} ssd(|x|, dt, A, |B|, |C|)"
    row["max_abs_err"] = max(row["max_abs_err_y"], row["max_abs_err_state"])
    if reps:
        q, nc = chunk, l // chunk
        flops = b * h * nc * (q * (q + 1) // 2 * (2 * n + 2 * p) + 4 * q * p * n)
        es = x.element_size()
        nbytes = (2 * x.numel() + B.numel() + C.numel()) * es \
            + dts.numel() * 4 + state.numel() * 4
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
        _kernel_timed(row, lambda: sk.ssd_scan_fwd(x, dts, A, B, C, chunk=chunk,
                                                   return_state=True), reps)
        row.update(
            plain_ms=time_ms(lambda: ref.ssd_chunked(x, dts, A, B, C, chunk=chunk),
                             max(2, reps // 4)),
            library_ms=None,
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes,
        )
        _bound_held(f"ssd {name}", row)
    log_row(row)
    del xbc, x, B, C, y, state, py, pstate, abs_y
    torch.cuda.empty_cache()
    return row


def phase_ssd():
    mamba2 = dict(b=2, l=4096, h=80, p=64, n=128)
    RESULTS["ssd_cases"] = [
        _ssd_case("mamba2_4096", 10, g=1, dtype="bfloat16", reps=10, **mamba2),
        _ssd_case("zamba2_4096", 11, b=2, l=4096, h=112, p=64, n=64, g=1,
                  dtype="bfloat16", reps=10),
        _ssd_case("grouped_g2", 12, g=2, dtype="bfloat16", **mamba2),
        _ssd_case("chunk48_fp32", 13, b=2, l=48, h=8, p=64, n=128, g=1, dtype="float32",
                  chunk=48),
        _ssd_case("fp32_1024", 14, b=1, l=1024, h=8, p=64, n=128, g=2, dtype="float32",
                  chunk=64),
        _ssd_case("mamba2_fp32_4096", 15, g=1, dtype="float32", **mamba2),
        # the bf16 body's edges: a ragged last tile (l 1000 in 64-row tiles),
        # three p tiles of 16, n 96 on the 128 template, grouped; then rows
        # of 260 elements (520 bytes, not a multiple of 16), which take the
        # element-by-element load path, with a last p tile of 8 columns and
        # n 50 on the 64 template
        _ssd_case("ragged_p48_n96_g2", 16, b=1, l=1000, h=6, p=48, n=96, g=2,
                  dtype="bfloat16", chunk=40),
        _ssd_case("unaligned_p40_n50", 17, b=2, l=200, h=4, p=40, n=50, g=1,
                  dtype="bfloat16", chunk=40),
        # the shape mamba2-2.7b's training step gives the kernel
        _ssd_case("mamba2_train_2048", 18, g=1, dtype="bfloat16", reps=10,
                  **{**mamba2, "l": 2048}),
    ]


def _bit_equal(name, out, plain) -> float:
    """``out`` must equal ``plain`` exactly: same dtype and shape, the same
    value in every element, NaN where ``plain`` is NaN; returns the max
    |out - plain| over the elements that differ (0.0)."""

    check(out.dtype == plain.dtype and out.shape == plain.shape,
          f"{name}: {out.dtype} {tuple(out.shape)} vs {plain.dtype} {tuple(plain.shape)}")
    differ = (out != plain) & ~(out.isnan() & plain.isnan())
    mismatches = int(differ.sum().item())
    err = (out.float() - plain.float())[differ].abs().max().item() if mismatches else 0.0
    check(mismatches == 0,
          f"{name}: {mismatches} elements differ from the plain version, max abs err {err}")
    return err


def _quant_bound(rows, width, in_bytes, out_bytes, ops_per_element):
    """Bytes: each input element read once, each output written once, and
    one fp32 scale a row; operations over the fp32 rate (the arithmetic is
    fp32 whatever the storage type)."""

    nbytes = rows * width * (in_bytes + out_bytes) + rows * 4
    flops = rows * width * ops_per_element
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def _vec_instantiation(x) -> str:
    """The name (``phase_build``'s) of the vector body's instantiation that
    quantizes ``x``: lanes a row and chunks a lane by the row's chunks."""

    chunks = x.shape[1] * x.element_size() // 16
    log_g, k = (5, 2) if chunks > 32 else ((chunks - 1).bit_length(), 1)
    dtype = str(x.dtype).removeprefix("torch.")
    return next(n for n, r in RESULTS["quant_vec_instantiations"].items()
                if (r["dtype"], r["log_g"], r["k"]) == (dtype, log_g, k))


def _vec_issue(x) -> dict:
    """The vector body's path for a row tile on ``x`` (rows, width), from
    its SASS: instructions per element by pipe (every lane of a warp
    counted, idle ones too) and the time issuing them takes at each pipe's
    rate, and at four warp instructions a clock, over the card's SMs
    (``SASS_PIPES``); each warp runs one tile."""

    import torch

    rows, width = x.shape
    name = _vec_instantiation(x)
    inst = RESULTS["quant_vec_instantiations"][name]
    tile_rows = inst["rows_in_flight"] * (32 >> inst["log_g"])
    tiles = -(-rows // tile_rows)
    lanes_a_second = torch.cuda.get_device_properties(0).multi_processor_count * SM_CLOCK_HZ
    ops = inst["tile_opcodes"]
    piped = {pipe: sum(n for op, n in ops.items() if op in names)
             for pipe, (_, names) in SASS_PIPES.items()}
    total = sum(ops.values())
    issue_ms = {pipe: tiles * n * 32 / (SASS_PIPES[pipe][0] * lanes_a_second) * 1e3
                for pipe, n in piped.items()}
    issue_ms["all_instructions"] = tiles * total / (SASS_ISSUE_PER_CLOCK * lanes_a_second) * 1e3
    per_element = 32 / (tile_rows * width)
    return {"sass_instantiation": name, "sass_tile_instructions": total,
            "sass_per_element": {**{p_: n * per_element for p_, n in piped.items()},
                                 "all": total * per_element},
            "sass_other": {op: n for op, n in ops.items()
                           if not any(op in names for _, names in SASS_PIPES.values())},
            "sass_issue_ms": issue_ms}


def _quantize_with(x, body, library=None):
    """``x`` quantized by ``body`` through the C entry point of ``library``
    (the kernel's, by default), as the wrapper launches it but uncounted:
    a launch to compare or time one body → (cudaError, q, s)."""

    import torch

    from repro_torch.kernels.quant import kernel as qk

    rows, width = x.shape
    q = torch.empty((rows, width), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    entry = (library or qk.LIBRARY).entry("quantize_int8_rows")
    rc = entry(x.data_ptr(), q.data_ptr(), s.data_ptr(), qk._DTYPE_CODES[x.dtype], rows, width,
               x.stride(0), body, torch.cuda.current_stream().cuda_stream)
    return rc, q, s


def _quant_case(name, x, *, reps=0, want_q=None, body=None, dequant_reps=0):
    """Quantize ``x`` (rows, width) with the wrapper, with each body the
    shape allows (the warp body at widths up to 256, the one the wrapper
    chose; ``_quantize_with``) and with the plain version on the card,
    then dequantize the wrapper's payload into bf16 and fp32 with both:
    every output equal.  ``body`` is the body the wrapper must choose for
    ``x`` (``kernel.quant_body``).  With ``reps``, times the wrapper and
    its bound (|x|, max, divide, round and the two-sided clip: 6 operations
    an element), the warp body too where the vector body was chosen, and
    the vector body's SASS issue times; with ``dequant_reps``, the
    dequantize into fp32 (the optimizer's moments) and its bound."""

    import torch

    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.kernels.quant import ref

    rows, width = x.shape
    chosen = qk.quant_body(width, x.element_size(), x.stride(0), x.data_ptr())
    check(body is None or chosen == body, f"quant {name}: body {chosen}, want {body}")
    q, s = qk.quantize_int8_rows(x)
    pq, ps = ref.quantize_int8_rows(x)
    torch.cuda.synchronize()
    row = {"case": name, "shape": [rows, width], "dtype": str(x.dtype).removeprefix("torch."),
           "row_stride": x.stride(0), "body": chosen, "body_name": _BODY_NAMES[chosen]}
    log(f"quant {name}: {_BODY_NAMES[chosen]} body")
    errs = [_bit_equal(f"quant {name} payload", q, pq), _bit_equal(f"quant {name} scales", s, ps)]
    if want_q is not None:
        check(torch.equal(q.cpu(), want_q), f"quant {name}: payload differs from the expected")
    bodies = sorted({chosen} | ({qk.WARP_BODY} if width <= qk.MAX_WIDTH else set()))
    for b in bodies:
        rc, bq, bs = _quantize_with(x, b)
        check(rc == 0, f"quant {name}: body {b} launch failed: cudaError {rc}")
        errs += [_bit_equal(f"quant {name} body {b} payload", bq, pq),
                 _bit_equal(f"quant {name} body {b} scales", bs, ps)]
        del bq, bs
    if qk.VECTOR_BODY in bodies:
        row["vector_instantiation"] = _vec_instantiation(x)
    derrs = []
    for dt in (torch.bfloat16, torch.float32):
        derrs.append(_bit_equal(f"dequant {name} -> {dt}", qk.dequantize_int8_rows(q, s, dt),
                                ref.dequantize_int8_rows(q, s, dt)))
    row.update(max_abs_err_quant=max(errs), max_abs_err_dequant=max(derrs), bit_equal=True)
    if reps:
        _kernel_timed(row, lambda: qk.quantize_int8_rows(x), reps)
        row.update(
            plain_ms=time_ms(lambda: ref.quantize_int8_rows(x), max(2, reps // 4)),
            library_ms=None,
            **_quant_bound(rows, width, x.element_size(), 1, 6),
        )
        _bound_held(f"quant {name}", row)
        for b in bodies:
            if b != chosen:
                t = time_device(lambda b=b: _quantize_with(x, b), reps)
                other = _BODY_NAMES[b]
                row.update({f"{other}_body_ms": t["ms"], f"{other}_body_host_us": t["host_us"]})
                check(t["ms"] >= BOUND_FLOOR * row["bound_ms"] and t["held"],
                      f"quant {name}: {other} body {t['ms']} ms against bound {row['bound_ms']}")
        if qk.VECTOR_BODY in bodies:
            row.update(_vec_issue(x))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    if dequant_reps:
        t = time_device(lambda: qk.dequantize_int8_rows(q, s, torch.float32), dequant_reps)
        bound = _quant_bound(rows, width, 1, 4, 2)
        row["dequant_fp32"] = {
            "ms": t["ms"], "host_us": t["host_us"], "hold_ms": t["hold_ms"], "held": t["held"],
            "plain_ms": time_ms(lambda: ref.dequantize_int8_rows(q, s, torch.float32),
                                max(2, dequant_reps // 4)),
            "library_ms": time_ms(lambda: torch.mul(q, s), dequant_reps),
            **bound, "share_of_bound": bound["bound_ms"] / t["ms"]}
        _bound_held(f"dequant {name}", row["dequant_fp32"])
    log_row(row)
    del q, s, pq, ps
    torch.cuda.empty_cache()
    return row


_BODY_NAMES = {0: "warp", 1: "vector", 2: "wide"}


def _edge_rows():
    """Rows of 256 → (x, expected payload): zeros (scale 1.0); exact halves
    at scale 1 and 2 (x / scale = k + 0.5, rounded to even); ±absmax
    (±127); tiny values; a NaN (the row's scale is 1, the NaN quantizes to
    0), an inf (scale inf, every element 0, dequantized to NaN), and both
    (scale 1, -inf clipped to -127), as the reference quantizes them."""

    import torch

    halves = torch.arange(-63, 64, dtype=torch.float32) + 0.5
    x = torch.zeros((8, 256))
    x[1, :127], x[1, 127] = halves, 127.0
    x[2, :127], x[2, 127] = 2 * halves, 254.0
    x[3, 0::2], x[3, 1::2] = 5.5, -5.5
    x[4, 0], x[4, 1:] = -3.0e-3, 1.0e-3
    x[5, :4], x[5, 4:] = torch.tensor([1.0, math.nan, -3.0, 0.5]), 0.25
    x[6, :4], x[6, 4:] = torch.tensor([2.0, math.inf, -1.0, 0.0]), 1.0
    x[7, :4], x[7, 4:] = torch.tensor([math.nan, -math.inf, 4.0, 1.0]), 0.25
    want = torch.zeros((8, 256), dtype=torch.int8)
    want[1, :127] = want[2, :127] = torch.round(halves).to(torch.int8)
    want[1, 127] = want[2, 127] = 127
    want[3, 0::2], want[3, 1::2] = 127, -127
    want[4, 0], want[4, 1:] = -127, 42
    want[5, 0], want[5, 2] = 1, -3
    want[7, 1:4] = torch.tensor([-127, 4, 1])
    return x, want


def _scaled_rows(rows, width, gen):
    """fp32 rows at scales 2^-135 to 2^120, so that the vector body divides
    some with the reciprocal of the scale and some (scales under 2^-100,
    denormal rows) with ``/``: even rows hold j + 1/2 (j from -width/2) and
    127 times a row factor, whose quotients by the scale land on or next to
    halves; odd rows normal draws times the factor."""

    import torch

    e = torch.randint(-135, 121, (rows, 1), generator=gen, device="cuda").double()
    factor = (1 + torch.rand((rows, 1), generator=gen, device="cuda").double()) * 2.0 ** e
    halves = torch.arange(width, device="cuda").double() - width // 2 + 0.5
    halves[-1] = 127.0
    x = torch.randn((rows, width), generator=gen, device="cuda").double()
    x[0::2] = halves
    return (x * factor).float()


def _edge_rows_at_end(width):
    """The edge rows of ``_edge_rows`` with their special elements in the
    row's last 16-byte chunk (its last 4 columns are in it in fp32 and in
    bf16), for rows of ``width`` < 256 → (x, expected payload): zeros; 111
    exact halves and the absmax at scale 1 and 2; ±absmax; tiny values with
    the largest last; a NaN, an inf, and a NaN with -inf (-127) in the last
    4 columns; a ninth row like the eighth, alone in the vector body's last
    row tile."""

    import torch

    n = width - 1
    halves = torch.arange(-63, 64, dtype=torch.float32)[-n:] + 0.5
    x = torch.zeros((9, width))
    x[1, :n], x[1, n] = halves, 127.0
    x[2, :n], x[2, n] = 2 * halves, 254.0
    x[3, 0::2], x[3, 1::2] = 5.5, -5.5
    x[4, :n], x[4, n] = 1.0e-3, -3.0e-3
    x[5, :-4], x[5, -4:] = 0.25, torch.tensor([1.0, math.nan, -3.0, 0.5])
    x[6, :-4], x[6, -4:] = 1.0, torch.tensor([2.0, math.inf, -1.0, 0.0])
    x[7, :-4], x[7, -4:] = 0.25, torch.tensor([math.nan, -math.inf, 4.0, 1.0])
    x[8] = x[7]
    want = torch.zeros((9, width), dtype=torch.int8)
    want[1, :n] = want[2, :n] = torch.round(halves).to(torch.int8)
    want[1, n] = want[2, n] = 127
    want[3, 0::2], want[3, 1::2] = 127, -127
    want[4, :n], want[4, n] = 42, -127
    want[5, -4:] = torch.tensor([1, 0, -3, 0], dtype=torch.int8)
    want[7, -4:] = want[8, -4:] = torch.tensor([0, -127, 4, 1], dtype=torch.int8)
    return x, want


def _edge_rows_wide(width):
    """``_edge_rows_at_end(128)`` in the last 128 columns of zero rows of
    ``width`` > 256 → (x, expected payload): the NaN, the inf and the
    exact halves in the row's last 16-byte chunk, the zeros quantizing to 0
    under every row's scale."""

    import torch

    x128, want128 = _edge_rows_at_end(128)
    x = torch.zeros((x128.shape[0], width))
    want = torch.zeros((x128.shape[0], width), dtype=torch.int8)
    x[:, -128:], want[:, -128:] = x128, want128
    return x, want


# the int8 moments' rows (optimizer step, fp32): each width the train paths
# quantize along, at the rows of one piece (optim.clip.PIECE elements)
WIDE_MOMENTS = (("phi4_mini_d_model", 3072), ("phi4_mini_d_ff", 8192),
                ("granite_d_model", 4096), ("granite_kv", 1024), ("granite_d_ff", 12800),
                ("qwen_d_ff", 27392), ("qwen_lm_head", 152064))


def _wide_cases(randn, gen) -> list:
    """The wide body and the wide dequantize: every width of ``WIDE_MOMENTS``
    at its piece's rows in fp32, timed (the dequantize into fp32 too); bf16
    and unaligned rows; the edge rows and the rows at scales 2^-135 to
    2^120 at 4,096 and 152,064."""

    import torch

    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.optim.clip import PIECE

    wide, fp32, bf16 = qk.WIDE_BODY, torch.float32, torch.bfloat16
    cases = [_quant_case(f"moments_{name}", randn(PIECE // width, width, fp32), reps=10,
                         dequant_reps=10, body=wide) for name, width in WIDE_MOMENTS]
    cases += [
        _quant_case("w4096_bf16", randn(16_384, 4096, bf16), body=wide),
        # 2,002-byte rows: whole chunks in rows that start on one, the rest one by one
        _quant_case("w1001_bf16", randn(3001, 1001, bf16), body=wide),
        # a view one element in: a quarter of its rows start on a 16-byte boundary
        _quant_case("w4096_view_offset_1", randn(2049, 4097, fp32)[:, 1:], body=wide),
        _quant_case("w257_fp32", randn(3001, 257, fp32), body=wide),
    ]
    for width in (4096, 152_064):
        x, want = _edge_rows_wide(width)
        cases.append(_quant_case(f"edge_rows_w{width}", x.cuda(), want_q=want, body=wide))
        cases.append(_quant_case(f"edge_rows_w{width}_bf16", x.cuda().to(bf16), want_q=want,
                                 body=wide))
        x = _scaled_rows(PIECE // width, width, gen)
        cases.append(_quant_case(f"w{width}_scales_2^-135_to_2^120", x, body=wide))
        del x
    return cases


def _dequant_timed(name, rows, width, seed, reps):
    """The dequantize of one cache layer into bf16, timed with its bound
    (convert and multiply: 2 operations an element), the plain version's
    time and the library's: ``torch.mul(q, s, out=bf16)``, which promotes
    to fp32 and rounds the product once, as the kernel does, and is held
    equal to it too."""

    import torch

    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.kernels.quant import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, width), generator=gen, device="cuda").to(torch.bfloat16)
    q, s = qk.quantize_int8_rows(x)
    out = qk.dequantize_int8_rows(q, s, torch.bfloat16)
    lib_out = torch.empty_like(out)
    err = max(_bit_equal(f"dequant {name}", out, ref.dequantize_int8_rows(q, s, torch.bfloat16)),
              _bit_equal(f"dequant {name} against torch.mul", out, torch.mul(q, s, out=lib_out)))
    row = {"case": name, "shape": [rows, width], "dtype": "int8 -> bfloat16",
           "max_abs_err_dequant": err, "bit_equal": True}
    _kernel_timed(row, lambda: qk.dequantize_int8_rows(q, s, torch.bfloat16), reps)
    row.update(plain_ms=time_ms(lambda: ref.dequantize_int8_rows(q, s, torch.bfloat16),
                                max(2, reps // 4)),
               library_ms=time_ms(lambda: torch.mul(q, s, out=lib_out), reps),
               **_quant_bound(rows, width, 1, 2, 2))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    _bound_held(f"dequant {name}", row)
    log_row(row)
    return row


def phase_quant():
    import torch

    from repro_torch.core import compress
    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.kernels.quant import ops

    gen = torch.Generator(device="cuda").manual_seed(20)

    def randn(rows, width, dtype):
        return (3.0 * torch.randn((rows, width), generator=gen, device="cuda")).to(dtype)

    bf16, fp32 = torch.bfloat16, torch.float32
    gemma2_prefill = 21 * 2 * (4608 + NEW_TOKENS) * 8   # global stack, k or v
    zamba2_prefill = 13 * 2 * (4096 + NEW_TOKENS) * 32  # the full 81 layers' shared stack
    vec, warp = qk.VECTOR_BODY, qk.WARP_BODY
    cases = [
        _quant_case("gemma2_global_prefill", randn(gemma2_prefill, 256, bf16), reps=20, body=vec),
        _quant_case("gemma2_global_prefill_fp32", randn(gemma2_prefill, 256, fp32), body=vec),
        _quant_case("width128", randn(100_003, 128, bf16), body=vec),
        _quant_case("zamba2_prefill_w112", randn(zamba2_prefill, 112, bf16), reps=20, body=vec),
        _quant_case("zamba2_w112_fp32", randn(100_001, 112, fp32), body=vec),
        _quant_case("ragged_rows_w256", randn(1001, 256, bf16), body=vec),
        # rows 128 apart, of which 112 are read: the vector body
        _quant_case("w112_row_stride_128", randn(100_001, 128, bf16)[:, :112], body=vec),
        # a view one element in: neither its address nor its stride is 16-byte aligned
        _quant_case("w112_view_offset_1", randn(100_001, 113, bf16)[:, 1:], body=warp),
        # 200-byte rows are not whole 16-byte chunks
        _quant_case("w100_bf16", randn(100_001, 100, bf16), body=warp),
        _quant_case("w16_bf16", randn(100_001, 16, bf16), body=vec),
        # a decode step's k_new (or v_new): zamba2 (b 2, 32 KV heads of 112) and
        # gemma2 (b 2, 8 of 256), 26 and 84 of these a step
        _quant_case("zamba2_decode_k_new", randn(2 * 32, 112, bf16), reps=20, body=vec),
        _quant_case("gemma2_decode_k_new", randn(2 * 8, 256, bf16), reps=20, body=vec),
    ]
    # every other instantiation of the vector body (lanes a row 1 to 8 in
    # bf16, 1 to 16 in fp32; fp32 200: two chunks a lane, the second absent
    # on 14 of 32 lanes)
    for width, dtype in ((8, bf16), (32, bf16), (64, bf16), (4, fp32), (8, fp32), (16, fp32),
                         (32, fp32), (64, fp32), (200, fp32)):
        name = f"w{width}_{str(dtype).removeprefix('torch.')}"
        cases.append(_quant_case(name, randn(3001, width, dtype), body=vec))
    x, want = _edge_rows()
    cases.append(_quant_case("edge_rows", x.cuda(), want_q=want, body=vec))
    cases.append(_quant_case("edge_rows_bf16", x.cuda().to(bf16), want_q=want, body=vec))
    # the same at zamba2's width, with the NaN, inf and halves in the last
    # chunk; 9 rows, so two share a warp and the ninth is alone in its tile
    x, want = _edge_rows_at_end(112)
    cases.append(_quant_case("edge_rows_w112", x.cuda(), want_q=want, body=vec))
    cases.append(_quant_case("edge_rows_w112_bf16", x.cuda().to(bf16), want_q=want, body=vec))
    # the division at every scale: the reciprocal's rows and the others
    for width in (112, 256):
        x = _scaled_rows(100_000, width, gen)
        cases.append(_quant_case(f"w{width}_scales_2^-135_to_2^120", x, body=vec))
        cases.append(_quant_case(f"w{width}_scales_2^-135_to_2^120_bf16", x.to(bf16), body=vec))
    cases += _wide_cases(randn, gen)
    ran = {c["body"] for c in cases}
    check(ran == {vec, warp, qk.WIDE_BODY},
          f"quant: the wrapper ran bodies {sorted(ran)}, want all three")
    held = {c["vector_instantiation"] for c in cases if "vector_instantiation" in c}
    built = set(RESULTS["quant_vec_instantiations"])
    check(held == built, f"quant: vector-body instantiations never run: {sorted(built - held)}")
    # the C entry refuses the vector body on a shape that does not allow it
    rc, _, _ = _quantize_with(randn(64, 113, bf16)[:, 1:], vec)
    check(rc != 0, "quant: the vector body ran on a view one element in")
    # and the wide body only the rows the other two cannot take, and they none of those
    for x, b in ((randn(64, 256, fp32), qk.WIDE_BODY), (randn(64, 257, fp32), warp),
                 (randn(64, 264, bf16), vec)):
        rc, _, _ = _quantize_with(x, b)
        check(rc != 0, f"quant: body {b} ran on rows of {x.shape[1]}")

    # the flat API on a ragged payload: 100 rows, which the Pallas kernel rejects
    flat = 3.0 * torch.randn((25_600,), generator=gen, device="cuda")
    q, s, pad = ops.quantize_int8(flat)
    pq, ps, ppad = compress.quantize_int8(flat)
    check(pad == ppad == 0 and q.numel() == 25_600 and s.numel() == 100, "flat API shapes")
    flat_errs = [_bit_equal("flat payload", q, pq), _bit_equal("flat scales", s, ps),
                 _bit_equal("flat dequant", ops.dequantize_int8(q, s, pad, flat.shape, fp32),
                            compress.dequantize_int8(q, s, pad, flat.shape, fp32))]
    cases.append({"case": "flat_25600_ragged_100_rows", "max_abs_err_quant": max(flat_errs[:2]),
                  "max_abs_err_dequant": flat_errs[2], "bit_equal": True})
    log(json.dumps(cases[-1]))
    RESULTS["quant_cases"] = cases
    # one global layer's cache read per decode step: 2 x 4624 x 8 rows
    RESULTS["dequant_cases"] = [
        _dequant_timed("gemma2_global_decode_layer", 2 * (4608 + NEW_TOKENS) * 8, 256, 21, 20),
        _dequant_timed("zamba2_decode_layer", 2 * (4096 + NEW_TOKENS) * 32, 112, 22, 20),
    ]


def phase_nccl():
    """The default process group on the card: a world of one over a
    ``file://`` store under ``build/``, NCCL for CUDA tensors (gloo beside
    it for CPU tensors).  ``allreduce``, ``allgather``, ``broadcast`` and
    ``shift`` on the ring of one, and a cart's ``shift_exchange``, through
    the port's communicator: each result equals its input."""

    import datetime

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import topology
    from repro_torch.core.communicator import world

    store = ROOT / "build" / "nccl_world_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    comm = world(device_type="cuda")
    check(comm.size() == 1 and comm.device == torch.device("cuda", 0),
          f"world of one on cuda:0, got {comm} on {comm.device}")
    check("nccl" in str(dist.get_backend()), f"backend {dist.get_backend()}")
    gen = torch.Generator(device="cuda").manual_seed(30)
    x = torch.randn((4096,), generator=gen, device="cuda")
    cart = topology.cart_create(comm, (1,), (True,), tag="nccl-ring-of-one")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results = {"allreduce": comm.allreduce(x), "allgather": comm.allgather(x),
                   "broadcast": comm.broadcast(x, root=0), "shift": comm.shift(x),
                   "cart_shift_exchange": cart.shift_exchange(x, 0, 1).get()}
        torch.cuda.synchronize()
    for name, out in results.items():
        check(out.is_cuda and torch.equal(out, x), f"NCCL world of one: {name} changed its input")
    kernels = sorted({e.key for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA})
    RESULTS["nccl"] = {"backend": str(dist.get_backend()), "equal": sorted(results),
                       "device_kernels": kernels,
                       "allreduce_init": _persistent_allreduce(comm, gen),
                       "window": _window_checks(comm, gen),
                       "dist_graph": _graph_checks(comm, gen)}
    log("NCCL world of one: " + json.dumps(RESULTS["nccl"]))


def _window_checks(comm, gen) -> dict:
    """RMA windows (``core/onesided.py``) on the world of one: a bf16
    tensor window (put, rput in pages, get, accumulate SUM, fetch_and_op,
    compare_and_swap), an aggregate of fp32, int32 and bf16 leaves (three
    packed buffers: rput in pages, get, accumulate SUM) and a dynamic
    window's attach/detach; each result what the reference's rules give on
    a one-rank window (a pair (0, 0) is a local copy, a reduction over one
    rank its input)."""

    import torch

    from repro_torch.core import errors, onesided
    from repro_torch.core.descriptors import ReduceOp, WindowSpec

    def bf16(n):
        return torch.randn((n,), generator=gen, device="cuda").to(torch.bfloat16)

    x, y, z = bf16(4096), bf16(4096), bf16(4096)
    win = onesided.Window(comm, torch.zeros_like(x), WindowSpec(num_pages=4)).fence()
    win.put(x, [(0, 0)])
    check(torch.equal(win.buffer, x), "window put on the world of one")
    win.fence()
    win.fence()
    futs = [win.rput(y, [(0, 0)], page=p) for p in range(4)]
    win.fence()
    check(all(f.test() for f in futs) and torch.equal(win.buffer, y), "window rput in 4 pages")
    win.fence()
    check(torch.equal(win.get([(0, 0)]), y), "window get")
    win.accumulate(z, target=0, op=ReduceOp.SUM)
    check(torch.equal(win.buffer, y + z), "window accumulate SUM")
    old = win.fetch_and_op(torch.tensor(2.0, device="cuda"), target=0, op=ReduceOp.SUM, index=3)
    check(torch.equal(old, (y + z)[3]) and torch.equal(win.buffer[3], (y + z)[3] + 2),
          "window fetch_and_op")
    first = win.buffer[0].item()
    old = win.compare_and_swap(first, 42.0, target=0, index=0)
    check(old.item() == first and win.buffer[0].item() == 42.0, "window compare_and_swap")
    win.fence()

    agg = {"w": torch.randn((64, 3), generator=gen, device="cuda"),
           "n": torch.randint(-9, 9, (5,), generator=gen, device="cuda", dtype=torch.int32),
           "h": bf16(7)}
    win = onesided.Window(comm, {k: torch.zeros_like(v) for k, v in agg.items()},
                          WindowSpec(num_pages=3)).fence()
    for p in range(3):
        win.rput(agg, [(0, 0)], page=p)
    win.fence()
    buffers = len(win._buffers)
    check(buffers == 3 and all(torch.equal(win.buffer[k], v) for k, v in agg.items()),
          "aggregate window rput in 3 pages")
    win.fence()
    got = win.get([(0, 0)])
    win.accumulate(agg, target=0, op=ReduceOp.SUM)
    check(all(torch.equal(got[k], v) and torch.equal(win.buffer[k], v + v)
              for k, v in agg.items()), "aggregate window get / accumulate SUM")
    win.fence()

    win = onesided.Window(comm, torch.zeros_like(x), WindowSpec(dynamic=True, num_pages=4))
    win.attach([1]).fence()
    win.put(x, [(0, 0)], page=1)
    try:
        win.put(x, [(0, 0)], page=2)
        refused = "none"
    except errors.Error as e:
        refused = e.klass.name
    win.fence()
    win.detach([1])
    span = slice(1024, 2048)
    check(refused == "ERR_RMA_RANGE" and torch.equal(win.buffer[span], x[span])
          and not win.buffer[:1024].any() and not win.attached_pages,
          f"dynamic window: a put to a detached page gave {refused}")
    return {"bf16": "put, rput x4 pages, get, accumulate SUM, fetch_and_op, compare_and_swap",
            "aggregate_buffers": buffers, "dynamic_detached_put": refused, "equal": True}


def _graph_checks(comm, gen) -> dict:
    """A ``DistGraphComm`` self-loop on the world of one: neighbor_alltoall,
    neighbor_alltoallv and neighbor_alltoall_init (started twice) each
    return their input."""

    import torch

    from repro_torch.core import topology

    g = topology.dist_graph_create_adjacent(comm, [[0]], [[0]])
    x = torch.randn((1, 64, 128), generator=gen, device="cuda").to(torch.bfloat16)
    check(torch.equal(g.neighbor_alltoall(x).get(), x), "neighbor_alltoall on a self-loop")
    blocks, rc = g.neighbor_alltoallv(x, [[64]]).get()
    check(torch.equal(blocks, x) and rc.tolist() == [64], "neighbor_alltoallv on a self-loop")
    req = g.neighbor_alltoall_init(x)
    for _ in range(2):
        v = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
        out = req.start(v).get()
        check(out.is_cuda and torch.equal(out, v), "neighbor_alltoall_init on a self-loop")
    return {"degrees": [g.indegree(), g.outdegree()], "starts": req.starts, "equal": True}


def _persistent_allreduce(comm, gen) -> dict:
    """``allreduce_init`` on the world of one: a bf16 tensor, and an
    aggregate of fp32, int32 and bf16 leaves (three dtype buckets), each
    started twice on new values; every result must equal its input."""

    import torch

    def aggregate():
        return {"w": torch.randn((64, 3), generator=gen, device="cuda"),
                "n": torch.randint(-9, 9, (5,), generator=gen, device="cuda", dtype=torch.int32),
                "h": torch.randn((7,), generator=gen, device="cuda").to(torch.bfloat16)}

    single = comm.allreduce_init(torch.zeros((4096,), device="cuda", dtype=torch.bfloat16))
    tree = comm.allreduce_init(aggregate())
    for _ in range(2):
        x = torch.randn((4096,), generator=gen, device="cuda").to(torch.bfloat16)
        check(torch.equal(single.start(x).get(), x), "allreduce_init on the world of one changed x")
        value = aggregate()
        out = tree.start(value).get()
        check(all(out[k].is_cuda and torch.equal(out[k], v) for k, v in value.items()),
              "allreduce_init of an aggregate on the world of one changed it")
    row = {"buckets": len(tree.requests), "starts": [single.starts, tree.starts], "equal": True,
           "captures": any(r.captures for r in tree.requests + single.requests)}
    check(row["buckets"] == 3 and row["starts"] == [2, 2] and not row["captures"],
          f"allreduce_init: {row}")
    return row


def _ring_tol(dtype) -> float:
    return BF16_RTOL if dtype == "bfloat16" else 0.0


def _fresh_carry(b, h, s, d):
    import torch

    from repro_torch.kernels.ring_attention import ref

    return (torch.full((b, h, s, 1), ref.NEG_INF, device="cuda"),
            torch.zeros((b, h, s, 1), device="cuda"), torch.zeros((b, h, s, d), device="cuda"))


def _ring_schedule_case(name, seed, *, n, shard, global_len, b, h, hk, d, dtype, causal):
    """A ring of ``n`` ranks emulated in one process: for each rank, its
    ``n`` steps over the shard of source ``(rank - step) mod n``, the carry
    chained, kernel and plain twin side by side (the same bf16 or fp32
    values, the twin in fp32).  The normalised output of the whole schedule
    is held against the twin's, and against ``flash_attention.ref.mha`` on
    the full sequence."""

    import torch

    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ring_attention import kernel as rk
    from repro_torch.kernels.ring_attention import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    s = n * shard
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
    for t in (q, k, v):
        t[:, global_len:] = 0  # the padded tail, as the model pads it
    lens = [max(0, min(shard, global_len - r * shard)) for r in range(n)]
    scale = d ** -0.5
    bf16 = dtype == "bfloat16"
    outs, plains, abs_vs = [], [], []
    for r in range(n):
        qt = q[:, r * shard:(r + 1) * shard].transpose(1, 2)
        carry, pcarry = _fresh_carry(b, h, shard, d), _fresh_carry(b, h, shard, d)
        acarry = _fresh_carry(b, h, shard, d)  # the twin on |v|, for the bf16 limit
        for step in range(n):
            src = (r - step) % n
            kt = k[:, src * shard:(src + 1) * shard].transpose(1, 2)
            vt = v[:, src * shard:(src + 1) * shard].transpose(1, 2)
            offs = dict(q_offset=r * shard, k_offset=src * shard, kv_len=lens[src])
            info = torch.tensor(list(offs.values()), dtype=torch.int32, device="cuda")
            carry = rk.ring_step_fwd(qt, kt, vt, *carry, info=info, scale=scale, causal=causal)
            pcarry = ref.ring_step_ref(qt.float(), kt.float(), vt.float(), *pcarry, scale=scale,
                                       causal=causal, **offs)
            if bf16:
                acarry = ref.ring_step_ref(qt.float(), kt.float(), vt.float().abs(), *acarry,
                                           scale=scale, causal=causal, **offs)
        outs.append(carry[2] / carry[1].clamp_min(1e-30))
        plains.append(pcarry[2] / pcarry[1].clamp_min(1e-30))
        abs_vs.append(acarry[2] / acarry[1].clamp_min(1e-30))

    def joined(parts):
        return torch.cat(parts, dim=2)[:, :, :global_len].transpose(1, 2)

    out, plain = joined(outs), joined(plains)
    abs_v = joined(abs_vs) if bf16 else None
    torch.cuda.synchronize()
    row = {"case": name, "ranks": n, "shard": shard, "global_len": global_len,
           "shape": [b, h, hk, d], "dtype": dtype, "causal": causal, "launches": n * n}
    row.update(_held(f"ring {name}", out, plain, FLASH_FP32_TOL, _ring_tol(dtype), abs_v))
    qg, kg, vg = (t[:, :global_len].float() for t in (q, k, v))
    mha = fref.mha(qg, kg, vg, causal=causal, scale=scale)
    mha_abs_v = fref.mha(qg, kg, vg.abs(), causal=causal, scale=scale) if bf16 else None
    held = _held(f"ring {name} against mha", out, mha, FLASH_FP32_TOL, _ring_tol(dtype),
                 mha_abs_v)
    row.update({f"{k_}_mha": v_ for k_, v_ in held.items()})
    log_row(row)
    del q, k, v, outs, plains, abs_vs, out, plain, abs_v, mha, mha_abs_v
    torch.cuda.empty_cache()
    return row


def _ring_carry_cases(seed, *, b=2, s=1000, h=24, hk=8, d=128):
    """One step from a finite mid-schedule carry (m above -1e30, l and acc
    nonzero), every carry element held against the twin; and the two skip
    invariants, exactly: a shard wholly in the causal future and one with
    no valid row leave the carry as it was."""

    import torch

    from repro_torch.kernels.ring_attention import kernel as rk
    from repro_torch.kernels.ring_attention import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, hk, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, hk, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    m = 0.5 * torch.randn((b, h, s, 1), generator=gen, device="cuda")
    l = 1.0 + torch.rand((b, h, s, 1), generator=gen, device="cuda")
    acc = torch.randn((b, h, s, d), generator=gen, device="cuda")
    scale = d ** -0.5
    rows = []
    offs = dict(q_offset=1000, k_offset=500, kv_len=900)
    info = torch.tensor(list(offs.values()), dtype=torch.int32, device="cuda")
    got = rk.ring_step_fwd(q, k, v, m.clone(), l.clone(), acc.clone(), info=info, scale=scale,
                           causal=True)
    want = ref.ring_step_ref(q.float(), k.float(), v.float(), m, l, acc, scale=scale,
                             causal=True, **offs)
    # the bf16 term of the unnormalised acc: this step's p |v| alone
    abs_v = ref.ring_step_ref(q.float(), k.float(), v.float().abs(), m, l,
                              torch.zeros_like(acc), scale=scale, causal=True, **offs)[2]
    torch.cuda.synchronize()
    row = {"case": "mid_schedule_carry", "shape": [b, h, hk, s, d], **offs}
    for part, g, w in zip(("m", "l", "acc"), got, want):
        held = _held(f"ring carry {part}", g, w, FLASH_FP32_TOL, RING_CARRY_RTOL,
                     abs_v if part == "acc" else None)
        row.update({f"{k_}_{part}": v_ for k_, v_ in held.items()})
    row["max_abs_err"] = max(row[f"max_abs_err_{p_}"] for p_ in ("m", "l", "acc"))
    log_row(row)
    rows.append(row)
    for name, kw in (("future_shard", dict(q_offset=0, k_offset=4 * s, kv_len=s, causal=True)),
                     ("empty_shard", dict(q_offset=0, k_offset=0, kv_len=0, causal=False))):
        for start, carry in (("mid_schedule", (m, l, acc)), ("initial", _fresh_carry(b, h, s, d))):
            before = [t.clone() for t in carry]
            after = rk.ring_step_fwd(q, k, v, *[t.clone() for t in carry], scale=scale, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b_) for a, b_ in zip(after, before)),
                  f"ring {name} from the {start} carry changed the carry")
        rows.append({"case": name, "carry_unchanged": True, **kw})
        log_row(rows[-1])
    return rows


def _ring_of_one(name, seed, *, b, s, h, hk, d, dtype, reps, chunk=1024):
    """The ring of one at the serve's shape, as ``ops`` lays it out (q a
    head-major view, k and v stacked contiguous): one launch from the
    initial carry, held against the twin run one Q chunk at a time (its
    scores would be a (b, h, s, s) fp32 tensor); timed, with the twin's
    time as the sum over its chunks, the bound and ``library_ms``:
    ``F.scaled_dot_product_attention`` (causal, GQA) on the same tensors,
    a yardstick that normalises and takes no carry."""

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ring_attention import kernel as rk
    from repro_torch.kernels.ring_attention import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
    qt = q.transpose(1, 2)
    kv = torch.stack([k, v]).transpose(2, 3).contiguous()
    scale = d ** -0.5
    info = torch.tensor([0, 0, s], dtype=torch.int32, device="cuda")
    carry = rk.ring_step_fwd(qt, kv[0], kv[1], *_fresh_carry(b, h, s, d), info=info,
                             scale=scale, causal=True)
    out = carry[2] / carry[1].clamp_min(1e-30)

    def plain_chunks(vv):
        parts = []
        for c0 in range(0, s, chunk):
            pc = _fresh_carry(b, h, min(chunk, s - c0), d)
            _, pl, pacc = ref.ring_step_ref(qt[:, :, c0:c0 + chunk], kv[0], vv, *pc,
                                            q_offset=c0, k_offset=0, kv_len=s, scale=scale,
                                            causal=True)
            parts.append(pacc / pl.clamp_min(1e-30))
        return torch.cat(parts, dim=2)

    plain = plain_chunks(kv[1])
    abs_v = plain_chunks(kv[1].abs()) if dtype == "bfloat16" else None
    torch.cuda.synchronize()
    row = {"case": name, "shape": [b, s, h, hk, d], "dtype": dtype, "causal": True}
    row.update(_held(f"ring {name}", out, plain, FLASH_FP32_TOL, _ring_tol(dtype), abs_v))
    del plain, out, abs_v
    pairs = b * h * s * (s + 1) // 2
    flops = 4 * d * pairs
    carry_bytes = 2 * sum(t.numel() * 4 for t in carry)  # read and written once
    nbytes = (q.numel() + k.numel() + v.numel()) * q.element_size() + carry_bytes
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    _kernel_timed(row, lambda: rk.ring_step_fwd(qt, kv[0], kv[1], *carry, info=info,
                                                scale=scale, causal=True), reps)
    row.update(
        plain_ms=time_ms(lambda: plain_chunks(kv[1]), 2),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kv[0], kv[1], is_causal=True, scale=scale, enable_gqa=True), reps),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        flops=flops, bytes=nbytes, pairs=pairs,
    )
    _bound_held(f"ring {name}", row)
    log_row(row)
    del q, k, v, qt, kv, carry
    torch.cuda.empty_cache()
    return row


def _ring_equals_flash(name, seed, *, b, s, h, hk, d, dtype="bfloat16"):
    """The ring of one and the flash kernel share the tile body
    (``flash_tile.cuh``): from the initial carry over the whole causal
    sequence, the ring's acc / l rounded to the input's type must be the
    flash kernel's output bit for bit."""

    import torch

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ring_attention import kernel as rk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
    kv = torch.stack([k, v]).transpose(2, 3).contiguous()
    info = torch.tensor([0, 0, s], dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    _, l, acc = rk.ring_step_fwd(q.transpose(1, 2), kv[0], kv[1], *_fresh_carry(b, h, s, d),
                                 info=info, scale=scale, causal=True)
    ring = (acc / l.clamp_min(1e-30)).to(dt).transpose(1, 2)
    flash = fk.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    diff = (ring.float() - flash.float()).abs().max().item()
    row = {"case": name, "shape": [b, s, h, hk, d], "dtype": dtype,
           "ring_of_one_equals_flash_bitwise": torch.equal(ring, flash), "max_abs_diff": diff}
    log_row(row)
    check(row["ring_of_one_equals_flash_bitwise"],
          f"ring {name}: the ring of one differs from flash by up to {diff}")
    return row


def phase_ring():
    """The ring-step kernel against its plain twin on the card."""

    phi4 = dict(b=2, h=24, hk=8, d=128)
    zamba2 = dict(b=2, h=32, hk=32, d=112)
    ragged = dict(n=4, shard=1000, global_len=3950)
    RESULTS["ring_cases"] = [
        _ring_schedule_case("phi4_4x1000_bf16_causal", 40, dtype="bfloat16", causal=True,
                            **ragged, **phi4),
        _ring_schedule_case("phi4_4x1000_bf16_full", 41, dtype="bfloat16", causal=False,
                            **ragged, **phi4),
        _ring_schedule_case("phi4_4x1000_fp32_causal", 42, dtype="float32", causal=True,
                            **ragged, **phi4),
        _ring_schedule_case("zamba2_4x1000_bf16_causal", 43, dtype="bfloat16", causal=True,
                            **ragged, **zamba2),
        _ring_schedule_case("zamba2_4x1000_fp32_full", 44, dtype="float32", causal=False,
                            **ragged, **zamba2),
        # the 64- and 256-wide tiles of the ring's bf16 path
        _ring_schedule_case("mqa_2x300_d64_bf16_causal", 47, dtype="bfloat16", causal=True,
                            n=2, shard=300, global_len=550, b=1, h=4, hk=1, d=64),
        _ring_schedule_case("gqa_2x300_d256_bf16_full", 48, dtype="bfloat16", causal=False,
                            n=2, shard=300, global_len=590, b=2, h=4, hk=2, d=256),
        *_ring_carry_cases(45),
    ]
    # the ring of one against flash: the 128-wide tile, and at d 192 the
    # 256-wide one with a K panel that no TMA box fills
    RESULTS["ring_equals_flash"] = [
        _ring_equals_flash("phi4_1000_d128", 49, b=2, s=1000, h=24, hk=8, d=128),
        _ring_equals_flash("gqa_777_d192", 50, b=1, s=777, h=4, hk=2, d=192),
    ]
    RESULTS["ring_of_one"] = _ring_of_one("phi4_ring_of_one_8192", 46, s=8192,
                                          dtype="bfloat16", reps=10, **phi4)
    # the ring of one at the shape phi4-mini trains with the ring plan
    RESULTS["ring_of_one_train"] = _ring_of_one("phi4_ring_of_one_train_2048", 51, s=2048,
                                                dtype="bfloat16", reps=10, **phi4)


def _kv_bytes(tree) -> int:
    """Bytes of every KV cache in a cache tree: payload and scales."""

    import dataclasses

    from repro_torch.models.attention import KVCache, MLACache

    if isinstance(tree, KVCache):
        return sum(t.numel() * t.element_size()
                   for t in (tree.k, tree.v, tree.k_scale, tree.v_scale) if t is not None)
    if isinstance(tree, MLACache):
        return sum(t.numel() * t.element_size() for t in (tree.ckv, tree.k_rope))
    if isinstance(tree, dict):
        return sum(_kv_bytes(v) for v in tree.values())
    if dataclasses.is_dataclass(tree):
        return sum(_kv_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0


def _serve(arch, prompt_len, kv, ring):
    """(server, tokens, stats): the bf16 cache through the launcher (through
    ``Server`` where ``SERVE_LAYERS`` cuts the depth); the int8 cache through
    ``Server`` with ``kv_cache_dtype="int8"``, and ring
    attention through ``Server(cfg, replace(pcfg, ring_attention=True),
    scfg, comm)`` on the NCCL world's communicator (the CLI has a flag for
    neither, in the reference either); the launcher's config, seed and
    prompts otherwise."""

    import dataclasses

    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Server, ServerConfig

    if kv == "bfloat16" and not ring and arch not in SERVE_LAYERS:
        return serve.run(["--arch", arch, "--requests", "2", "--prompt-len", str(prompt_len),
                          "--new-tokens", str(NEW_TOKENS)])
    cfg = base.get_config(arch)
    if arch in SERVE_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS[arch])
    pcfg = dataclasses.replace(base.get_parallel(arch), kv_cache_dtype=kv, ring_attention=ring)
    server = Server(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=NEW_TOKENS),
                    make_host_communicator(device="cuda"))
    tokens, stats = server.generate(serve.requests(cfg, 2, prompt_len))
    return server, tokens, stats


def phase_serve(arch, layers, d_model, prompt_len, kv, ring, per_prefill, per_step):
    """Serve ``arch`` at its full config with a ``kv`` cache, with or
    without ring attention; the kernels' counts are zeroed just before and
    read just after.  The graph decode's tokens are held against an eager
    ``bundle.decode`` loop's, and four replays are profiled beside four
    eager steps."""

    import numpy as np
    import torch

    from repro_torch.launch import serve

    path = arch + ("" if kv == "bfloat16" else f"_{kv}") + ("_ring" if ring else "")
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    server, tokens, stats = _serve(arch, prompt_len, kv, ring)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = server.cfg
    prefills = server.prefill_calls
    steps = prefills * (NEW_TOKENS - 1)  # no stop token: every generate decodes in full
    log(f"served {cfg.name} ({kv} KV cache): {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B params; wall {wall:.1f}s (init included); "
        f"launches {launches}; peak {peak_gb:.2f} GB from {start_gb:.2f} GB allocated "
        f"before the serve")
    log("cold stats " + json.dumps(stats))
    check(cfg.num_layers == layers and cfg.d_model == d_model,
          f"not the {arch} config at {layers} layers")
    check(server.pcfg.kv_cache_dtype == kv, f"{path}: cache {server.pcfg.kv_cache_dtype}")
    check(server.pcfg.ring_attention == ring, f"{path}: ring {server.pcfg.ring_attention}")
    check(prefills >= 1, f"{path}: no prefill ran")
    for name, n in launches.items():
        want = per_prefill.get(name, 0) * prefills + per_step.get(name, 0) * steps
        check(n == want, f"{path}: {name} launches {n} != {per_prefill.get(name, 0)} x "
                         f"{prefills} prefills + {per_step.get(name, 0)} x {steps} decode steps")
    check(tokens.shape == (2, NEW_TOKENS), f"tokens shape {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token outside the vocab")

    # the launcher's requests, drawn again (with their image embeddings or frames)
    reqs = serve.requests(cfg, 2, prompt_len)
    params_gb = sum(t.numel() * t.element_size() for t in _tensors(server.params)) / 1e9
    torch.cuda.reset_peak_memory_stats()
    warm_tokens, warm = server.generate(reqs)
    warm_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("warm stats " + json.dumps(warm) + f"; params {params_gb:.2f} GB, "
        f"peak of the warm generate {warm_peak_gb:.2f} GB")
    check(np.array_equal(warm_tokens, tokens), f"{path}: warm generate changed the greedy tokens")
    batch, _ = server._pad_batch(reqs)
    # the prefill sees the communicator when the ring is on, as the server's does
    mesh = server.comm if ring else None
    with torch.inference_mode():
        logits, cache = server.bundle.prefill(server.params, batch, server.pcfg, mesh,
                                              extra_capacity=NEW_TOKENS)
        check(bool(torch.isfinite(logits).all()), f"{path}: non-finite prefill logits")
        # the eager greedy loop: bundle.decode on the same prefill, timed as
        # Server.generate times its decode loop
        tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1).to(torch.int32)[:, None]
        eager, t0 = [tok], time.perf_counter()
        for _ in range(NEW_TOKENS - 1):
            out_logits, cache = server.bundle.decode(server.params, cache, tok, server.pcfg)
            if len(eager) == 1:
                step_logits = out_logits
            tok = torch.argmax(out_logits[:, -1, : cfg.vocab_size], dim=-1).to(torch.int32)[:, None]
            eager.append(tok)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        del out_logits
        eager_tokens = torch.cat(eager, dim=1).cpu().numpy()
        check(bool(torch.isfinite(step_logits).all()), f"{path}: non-finite decode logits")
        check(np.array_equal(tokens, eager_tokens),
              f"{path}: graph decode tokens {tokens.tolist()} != eager bundle.decode's "
              f"{eager_tokens.tolist()}")
        profiles = {
            "prefill": _profile(lambda: server.bundle.prefill(
                server.params, batch, server.pcfg, mesh, extra_capacity=NEW_TOKENS)),
            "decode_x4": _profile(lambda: [server.bundle.decode(
                server.params, cache, tok, server.pcfg) for _ in range(4)]),
        }
        graph = _graph_decode(path, server, cache, tok, per_step)
        profiles["decode_x4_graph"] = graph.pop("profile")
    kv_bytes = _kv_bytes(cache)
    row = {
        "kv_cache_dtype": kv, "cold": stats, "warm": warm, "prefill_calls": prefills,
        "decode_steps": steps, "launches": launches, "params_gb": params_gb,
        "kv_cache_gb": kv_bytes / 1e9, "mem_gb_at_start": start_gb,
        "peak_mem_gb_serve": peak_gb, "peak_mem_gb_warm_generate": warm_peak_gb,
        "graph_tokens_equal_eager": True,
        "eager_tokens_per_s": 2 * NEW_TOKENS / eager_s, "graph_tokens_per_s": warm["tokens_per_s"],
        "graph_decode": graph, "profiles": profiles,
    }
    log(f"{path} decode, graph against eager: " + json.dumps(
        {k: row[k] for k in ("eager_tokens_per_s", "graph_tokens_per_s")} | graph))
    seen = {"tokens": tokens, "prefill_logits": logits[:, -1].float().cpu(),
            "step_logits": step_logits[:, -1].float().cpu(), "kv_bytes": kv_bytes}
    if ring:
        row.update(_against_flash(path, server, batch, seen))
    elif kv == "bfloat16":
        BF16_SERVES[arch] = seen
    else:
        row.update(_against_bf16(path, cfg, seen, BF16_SERVES[arch]))
    RESULTS.setdefault("serve", {})[path] = row
    del server, logits, step_logits, cache
    torch.cuda.empty_cache()
    return path, launches


def _graph_decode(path, server, cache, tok, per_step) -> dict:
    """The server's decode request (its graph released at the end of the
    last ``generate``) started on ``cache``: the capturing start timed
    alone, then four replays profiled, whose launches must be exactly
    ``per_step`` a replay; the graph is released after."""

    import torch

    req = server._decode_request(cache, tok)
    check(req.captures and req.starts > 0 and req.settled is False,
          f"{path}: the decode request does not capture (captures {req.captures}, "
          f"starts {req.starts})")
    captured = req.captured
    with _counting_records() as recorded:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        req(server.params, cache, tok)
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        check(req.captured == captured + 1, f"{path}: the start did not capture")
        _reset_launches()
        profile = _profile(lambda: [req(server.params, cache, tok) for _ in range(4)])
        launches = _launches()
    # the program was recorded at the first generate's capture: not at this
    # capture, nor at a replay
    check(recorded == [], f"{path}: the program recorded {len(recorded)} times at a later "
                          f"capture and its replays")
    program = _program_against_capture(path, req)
    req.release()
    # _profile runs its function twice: 8 replays
    for name, n in launches.items():
        want = 8 * per_step.get(name, 0)
        check(n == want, f"{path}: {name} launches {n} over 8 graph replays, want {want}")
    row = {"capture_and_replay_ms": capture_ms, "launches_8_replays": launches,
           "captures_this_server": req.captured, "profile": profile, "program": program}
    if path == RECORD_TIMED_PATH:
        # the capture again with the program recorded at it: its time beside
        # the capture without the recorder, and its kernel ops against its
        # own launches
        req._program = None
        with _counting_records() as recorded:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            req(server.params, cache, tok)
            torch.cuda.synchronize()
            row["capture_and_replay_recorded_ms"] = (time.perf_counter() - t0) * 1e3
        check(len(recorded) == 1, f"{path}: {len(recorded)} recordings at one capture")
        row["program_recorded_at_capture"] = _program_against_capture(path, req)
        req.release()
        log(f"{path} decode capture: {capture_ms:.1f} ms, "
            f"{row['capture_and_replay_recorded_ms']:.1f} ms with the program recorded; "
            f"program {json.dumps(row['program_recorded_at_capture'])}")
    return row


def _against_flash(path, server, batch, seen) -> dict:
    """The ring serve read against the same weights without the ring: the
    flash path's prefill must give the same first token; the prefill
    logits' max |Δ| is logged."""

    import dataclasses

    import numpy as np
    import torch

    flash_pcfg = dataclasses.replace(server.pcfg, ring_attention=False)
    with torch.inference_mode():
        logits, _ = server.bundle.prefill(server.params, batch, flash_pcfg, None,
                                          extra_capacity=NEW_TOKENS)
    first = torch.argmax(logits[:, -1, : server.cfg.vocab_size], dim=-1).cpu().numpy()
    check(np.array_equal(first, seen["tokens"][:, 0]),
          f"{path}: first token {seen['tokens'][:, 0]} != the flash path's {first}")
    out = {"first_token_equal_flash": True,
           "prefill_logits_max_abs_diff_flash": (seen["prefill_logits"]
                                                 - logits[:, -1].float().cpu()).abs().max().item()}
    log(f"{path} against the flash path: " + json.dumps(out))
    return out


def _against_bf16(path, cfg, seen, bf16) -> dict:
    """The int8 serve read against the bf16 serve of the same weights and
    prompts: the first token must be the same (the cache's type does not
    enter the prefill) and the KV cache 0.5 (1 + 4 / head_dim) of its bytes
    (int8 payload plus one fp32 scale a row of head_dim)."""

    import numpy as np

    check(np.array_equal(seen["tokens"][:, 0], bf16["tokens"][:, 0]),
          f"{path}: first token {seen['tokens'][:, 0]} != the bf16 serve's "
          f"{bf16['tokens'][:, 0]}")
    ratio = seen["kv_bytes"] / bf16["kv_bytes"]
    want = 0.5 * (1 + 4 / cfg.head_dim)
    check(abs(ratio - want) < 1e-12, f"{path}: KV cache bytes {ratio} of bf16's, want {want}")
    out = {
        "first_token_equal": True,
        "later_tokens_agree": float((seen["tokens"][:, 1:] == bf16["tokens"][:, 1:]).mean()),
        "prefill_logits_max_abs_diff": (seen["prefill_logits"] - bf16["prefill_logits"])
        .abs().max().item(),
        "first_decode_logits_max_abs_diff": (seen["step_logits"] - bf16["step_logits"])
        .abs().max().item(),
        "kv_bytes_ratio": ratio, "kv_bytes_ratio_want": want,
        "kv_cache_gb_bf16": bf16["kv_bytes"] / 1e9,
    }
    log(f"{path} against the bf16 serve: " + json.dumps(out))
    return out


def _profile(fn, top: int = 6) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler,
    device-side events only): the ``top`` kernels and every kernel of the
    port; and the device's busy share of the call's wall time, timed once
    more without the profiler."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        {"kernel": evt.key[:90], "ms": evt.self_device_time_total / 1e3, "count": evt.count}
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r["ms"])
    busy_ms = sum(r["ms"] for r in rows)
    result = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "busy_share": busy_ms / wall_ms if busy_ms else None, "top": rows[:top],
              "port_kernels": [r for r in rows if any(k in r["kernel"] for k in PORT_KERNELS)]}
    log("profile " + json.dumps(result))
    return result


def phase_small_model(arch, kv="bfloat16", ring=False):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = dataclasses.replace(base.get_smoke_config(arch), dtype="float32")
    pcfg = dataclasses.replace(base.get_parallel(arch), kv_cache_dtype=kv, ring_attention=ring)
    scfg = ServerConfig(max_batch=2, max_new_tokens=8)
    gpu = Server(cfg, pcfg, scfg, device="cuda")
    cpu = Server(cfg, pcfg, scfg, device="cpu")
    cpu.params = _to_cpu(gpu.params)
    # the launcher's requests (with their image embeddings or frames)
    reqs = serve.requests(cfg, 2, 24)
    _reset_launches()
    t_gpu, _ = gpu.generate(reqs)
    if ring:
        check(_launches()[RING] == cfg.num_layers,
              f"{arch} ring smoke model: {_launches()[RING]} ring launches on the card, want "
              f"{cfg.num_layers}")
    t_cpu, _ = cpu.generate(reqs)
    path = arch + ("" if kv == "bfloat16" else f"_{kv}") + ("_ring" if ring else "")
    log(f"{path} smoke model fp32, card vs CPU path: tokens {t_gpu.tolist()} vs "
        f"{t_cpu.tolist()}")
    check(np.array_equal(t_gpu, t_cpu), f"{path}: card and CPU path generate different tokens")
    RESULTS.setdefault("small_model", {})[path] = {"tokens_equal": True, "tokens": t_gpu.tolist()}
    del gpu
    torch.cuda.empty_cache()


# -- the continuous-batching engine ------------------------------------------------

# phase engine: phi4-mini at full width and depth (32 layers, d 3072, GQA 24/8
# of 128; its KV cache is 128 KiB a token), random bf16 weights from seed 0,
# one parameter tree for every setup.  A (batch-equal): 8 prompts of
# 256-2048 tokens, left-padded to the 2048 bucket, 8 slots, every budget 32,
# no pool cap: the engine's tokens must be Server.generate's on the same
# padded prompts bit for bit, with the bf16 and the int8 cache.  B (ragged):
# 24 requests, budgets of 8-64 drawn from the seed, 8 slots of 2048 + 64
# tokens in blocks of 16 (132 blocks a slot) under a pool of 910 blocks
# (seven slots' worth of 130): eight rows never fit at once, so rows wait,
# are admitted mid-flight and are preempted
ENGINE_ARCH = "phi4_mini_3_8b"
ENGINE_BUCKET = 2048
ENGINE_SLOTS = 8
ENGINE_PROMPT_LENS = (256, 2048)
ENGINE_A_NEW = 32
ENGINE_B_REQUESTS = 24
ENGINE_B_BUDGETS = (8, 64)
ENGINE_B_BLOCK_TOKENS = 16
ENGINE_B_POOL_BLOCKS = 910
# the smoke engines, card against CPU: the reference's engine tests' shape
# (6 ragged prompts in a bucket of 8, 4 slots of 6 new tokens) under a pool
# of 14 blocks of 2 tokens, which forces preemptions
ENGINE_SMALL = ("phi4_mini_3_8b", "grok_1_314b", "deepseek_v2_236b")


def _engine_requests(n, vocab, seed, budgets=None):
    """``n`` prompts of ENGINE_PROMPT_LENS tokens and, with ``budgets``, a
    budget each in that range, drawn from one generator."""

    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(ENGINE_PROMPT_LENS[0], ENGINE_PROMPT_LENS[1] + 1, size=n)
    prompts = [rng.integers(1, vocab, size=(int(m),), dtype=np.int32) for m in lens]
    if budgets is None:
        return prompts, None
    return prompts, [int(b) for b in rng.integers(budgets[0], budgets[1] + 1, size=n)]


def _padded(prompts, bucket):
    """The prompts left-padded to the bucket: the fixed-batch oracle's
    requests (the engine pads the same way)."""

    import numpy as np

    from repro_torch.runtime.server import Request

    return [Request(tokens=np.concatenate([np.zeros((bucket - len(p),), np.int32), p]))
            for p in prompts]


def _server_like(server, kv, max_new, max_batch=None):
    """A Server on ``server``'s weights with another cache type, token
    ceiling or slot count, and persistent requests of its own."""

    import copy
    import dataclasses

    srv = copy.copy(server)
    srv.pcfg = dataclasses.replace(server.pcfg, kv_cache_dtype=kv)
    srv.scfg = dataclasses.replace(server.scfg, max_new_tokens=max_new,
                                   max_batch=max_batch or server.scfg.max_batch)
    srv._prefill_reqs, srv._decode_reqs = {}, {}
    return srv


def _oracle(server, prompts, bucket, budgets=None):
    """Server.generate over the padded prompts in fixed batches of
    ``max_batch``, in arrival order: (rows of tokens, wall seconds).  With
    ``budgets``, each batch decodes only to its own largest budget (a Server
    of that ceiling on the same weights), as a fixed-batch deployment that
    knew the budgets would."""

    rows, mb = [], server.scfg.max_batch
    t0 = time.perf_counter()
    for i in range(0, len(prompts), mb):
        srv = server if budgets is None else _server_like(
            server, server.pcfg.kv_cache_dtype, max(budgets[i:i + mb]))
        tokens, _ = srv.generate(_padded(prompts[i:i + mb], bucket))
        rows += list(tokens)
    return rows, time.perf_counter() - t0


def _engine_run(path, server, ecfg, prompts, budgets):
    """One ``Engine.run`` over the requests, launches zeroed just before and
    read just after: the handles, the engine and a row of its stats, the
    launches, the prefills it ran (its initial throwaway prefill included),
    the decode captures, the wall time from the engine's construction (its
    throwaway prefill of the slot table included) and of its steps alone,
    the peak memory once the engine has built its slot table, and each step
    after which the peak rose, with the peak.  Every request must finish
    with its budget's length, the pool must drain, and the run must capture
    the decode step once; flash runs 32 times a prefill and never in a
    decode step, and with the int8 cache the quantize runs twice a prefill
    (k and v) and the quantize and dequantize 64 times a decode step (k and
    v in each of 32 layers)."""

    import torch

    from repro_torch.runtime.engine import Engine

    def captured():
        return sum(r.captured for r in server._decode_reqs.values())

    layers = server.cfg.num_layers
    _reset_launches()
    prefills0, captured0 = server.prefill_calls, captured()
    t0 = time.perf_counter()
    eng = Engine(server, ecfg)
    handles = [eng.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak_after_init_gb = torch.cuda.max_memory_allocated() / 1e9
    peaks, step = [], eng.step

    def step_and_read_peak():
        done = step()
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not peaks or peak > peaks[-1][1]:
            peaks.append((eng.stats()["steps"], peak))
        return done

    eng.step = step_and_read_peak   # run() calls self.step
    t1 = time.perf_counter()
    eng.run()
    end = time.perf_counter()
    del eng.step   # no cycle through the wrapper: the slot table goes with the engine
    launches = _launches()
    stats = eng.stats()
    prefills = server.prefill_calls - prefills0
    steps = stats["steps"]
    check(all(h.state == "finished" and len(h.generated) == b for h, b in zip(handles, budgets)),
          f"{path}: a request did not finish with its budget's length")
    check(stats["pool_live_blocks"] == 0, f"{path}: {stats['pool_live_blocks']} blocks left live")
    captures = captured() - captured0
    check(captures == 1, f"{path}: {captures} decode captures in one run")
    check(eng._decode_req._graph is None, f"{path}: the run kept its decode graph")
    # the admissions' prefills and inserts run eagerly: nothing else captures
    check(not any(r.captures for r in server._prefill_reqs.values()),
          f"{path}: a prefill request captures")
    int8 = server.pcfg.kv_cache_dtype == "int8"
    want = {"flash_attention_fwd": layers * prefills,
            QUANT: (2 * prefills + 2 * layers * steps) if int8 else 0,
            DEQUANT: 2 * layers * steps if int8 else 0}
    for name, n in launches.items():
        check(n == want.get(name, 0), f"{path}: {name} launches {n}, want {want.get(name, 0)} "
                                      f"({prefills} prefills, {steps} decode steps)")
    return handles, eng, {"stats": stats, "launches": launches, "prefills": prefills,
                          "decode_captures": captures, "wall_s": end - t0,
                          "init_s": init_s, "steps_s": end - t1,
                          "peak_gb_after_init": peak_after_init_gb,
                          "peak_gb_rose_after_step": peaks}


def _batch_equal(path, base, kv, gen):
    """Setup A with a ``kv`` cache: the engine against Server.generate on
    the same padded prompts, bit for bit."""

    from repro_torch.runtime.engine import EngineConfig

    srv = _server_like(base, kv, ENGINE_A_NEW)
    prompts, _ = _engine_requests(ENGINE_SLOTS, srv.cfg.vocab_size, gen)
    oracle, oracle_s = _oracle(srv, prompts, ENGINE_BUCKET)
    handles, eng, run = _engine_run(
        path, srv, EngineConfig(prompt_bucket=ENGINE_BUCKET, block_tokens=ENGINE_B_BLOCK_TOKENS),
        prompts, [ENGINE_A_NEW] * ENGINE_SLOTS)
    for i, (h, row) in enumerate(zip(handles, oracle)):
        check(row.tolist() == h.generated,
              f"{path}: request {i}: engine {h.generated} != Server.generate {row.tolist()}")
    check(run["prefills"] == 2,
          f"{path}: {run['prefills']} prefills, want the throwaway and one admission")
    row = {"card": RESULTS["device"]["nvidia_smi"], "kv_cache_dtype": kv,
           "tokens_equal_server_generate": True, **run, "server_generate_s": oracle_s}
    log(f"{path}: {json.dumps(row)}")
    del eng, srv
    return row, run["launches"]


def phase_engine():
    """The continuous-batching engine (``runtime/engine.py``) serving the
    full phi4-mini: setups A (bf16, then int8) and B (twice, then the same
    requests as fixed batches), four profiled decode replays of B's slot
    table, an admission prefill profiled, peak memory."""

    import torch

    from repro_torch.configs import base
    from repro_torch.runtime.engine import EngineConfig
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = base.get_config(ENGINE_ARCH)
    check(cfg.num_layers == 32 and cfg.d_model == 3072 and cfg.num_heads == 24
          and cfg.num_kv_heads == 8 and cfg.head_dim == 128, "not the phi4-mini config")
    t0 = time.perf_counter()
    base_srv = Server(cfg, base.get_parallel(ENGINE_ARCH),
                      ServerConfig(max_batch=ENGINE_SLOTS, max_new_tokens=ENGINE_A_NEW),
                      device="cuda")
    torch.cuda.synchronize()
    log(f"engine: {cfg.name} {cfg.param_count() / 1e9:.2f}B params, init "
        f"{time.perf_counter() - t0:.1f}s")
    out, launches = {}, {}
    for kv in ("bfloat16", "int8"):
        path = f"engine_A_{kv}"
        out[path], launches[path] = _batch_equal(path, base_srv, kv, gen=1)

    # B: the ragged traffic, twice, then as fixed batches
    srv = _server_like(base_srv, "bfloat16", ENGINE_B_BUDGETS[1])
    prompts, budgets = _engine_requests(ENGINE_B_REQUESTS, cfg.vocab_size, 2, ENGINE_B_BUDGETS)
    ecfg = EngineConfig(prompt_bucket=ENGINE_BUCKET, block_tokens=ENGINE_B_BLOCK_TOKENS,
                        pool_blocks=ENGINE_B_POOL_BLOCKS)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(2):
        handles, eng, run = _engine_run(f"engine_B_run{i + 1}", srv, ecfg, prompts, budgets)
        first = min(h.first_token_s for h in handles)
        runs.append({"tokens": [h.generated for h in handles], **run,
                     "admitted_mid_flight": sum(h.first_token_s > first for h in handles),
                     "resumes": sum(h.preemptions for h in handles)})
        if i == 0:
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            launches["engine_B"] = run["launches"]
            with torch.inference_mode():
                graph = _graph_decode("engine_B", srv, eng.cache, eng.tok, {})
        del eng, handles
    check(runs[0]["tokens"] == runs[1]["tokens"], "engine_B: a second run gave other tokens")
    b = runs[0]
    check(b["stats"]["preemptions"] >= 1, "engine_B: no preemption")
    check(b["admitted_mid_flight"] >= 1, "engine_B: no request admitted mid-flight")
    useful = sum(budgets)
    oracle, fixed_s = _oracle(srv, prompts, ENGINE_BUCKET, budgets)
    equal = sum(int(a == c) for t, row, n in zip(b["tokens"], oracle, budgets)
                for a, c in zip(t, row.tolist()[:n]))
    batch = {"tokens": torch.as_tensor(_padded(prompts[:1], ENGINE_BUCKET)[0].tokens[None],
                                       device=srv.device)}
    # a fresh request's admission: one row, the bucket deep, headroom to the slot's end
    with torch.inference_mode():
        admission = _profile(lambda: srv._prefill_request(
            batch, extra_capacity=ENGINE_B_BUDGETS[1])(srv.params, batch))
    row = {"card": RESULTS["device"]["nvidia_smi"], "requests": ENGINE_B_REQUESTS,
           "budgets": budgets,
           "prompt_lens": [len(p) for p in prompts], "pool_blocks": ENGINE_B_POOL_BLOCKS,
           "block_tokens": ENGINE_B_BLOCK_TOKENS, "stats": b["stats"], "prefills": b["prefills"],
           "launches": b["launches"], "decode_captures": [r["decode_captures"] for r in runs],
           "admitted_mid_flight": b["admitted_mid_flight"], "resumes": b["resumes"],
           "second_run_identical": True, "useful_tokens": useful,
           "engine_s": [r["wall_s"] for r in runs],
           "engine_steps_s": [r["steps_s"] for r in runs],
           "engine_useful_tokens_per_s": [useful / r["wall_s"] for r in runs],
           "fixed_batches_s": fixed_s, "fixed_batches_useful_tokens_per_s": useful / fixed_s,
           "fixed_batches_generated_tokens": sum(len(r) for r in oracle),
           "fixed_batches_budgets": [max(budgets[i:i + ENGINE_SLOTS])
                                     for i in range(0, len(budgets), ENGINE_SLOTS)],
           "tokens_equal_fixed_batch_share": equal / useful,
           "peak_mem_gb": peak_gb, "peak_mem_gb_after_init": b["peak_gb_after_init"],
           "peak_mem_gb_rose_after_step": b["peak_gb_rose_after_step"],
           "graph_decode": graph,
           "admission_prefill_1x2048": admission}
    log("engine_B: " + json.dumps({k: v for k, v in row.items()
                                    if k not in ("budgets", "prompt_lens", "graph_decode",
                                                 "admission_prefill_1x2048")}))
    out["engine_B"] = row
    RESULTS["engine"] = out
    del srv, base_srv
    torch.cuda.empty_cache()
    return launches


def phase_engine_small(arch):
    """A smoke model in fp32 through the engine with preemption, card
    against CPU: the same tokens and stats; and each against its device's
    fixed-batch oracle, agreeing on the same requests (every one for the
    dense model; the MoE models' capacity-bounded dispatch drops tokens by
    the batch's other rows, ROADMAP C15)."""

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = dataclasses.replace(base.get_smoke_config(arch), dtype="float32")
    scfg = ServerConfig(max_batch=4, max_new_tokens=6)
    gpu = Server(cfg, base.get_parallel(arch), scfg, device="cuda")
    cpu = Server(cfg, base.get_parallel(arch), scfg, device="cpu")
    cpu.params = _to_cpu(gpu.params)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, size=(int(rng.integers(2, 9)),), dtype=np.int32)
               for _ in range(6)]
    got = {}
    for name, srv in (("card", gpu), ("cpu", cpu)):
        eng = Engine(srv, EngineConfig(prompt_bucket=8, block_tokens=2, pool_blocks=14))
        handles = [eng.submit(p) for p in prompts]
        eng.run()
        rows, _ = _oracle(srv, prompts, 8)
        got[name] = ([h.generated for h in handles], eng.stats(),
                     [h.generated == r.tolist() for h, r in zip(handles, rows)])
    (t_gpu, s_gpu, a_gpu), (t_cpu, s_cpu, a_cpu) = got["card"], got["cpu"]
    log(f"engine {arch} smoke fp32, card vs CPU path: tokens {t_gpu} vs {t_cpu}; stats "
        f"{s_gpu}; agrees with the fixed-batch oracle {a_gpu} vs {a_cpu}")
    check(t_gpu == t_cpu and s_gpu == s_cpu, f"engine {arch}: card and CPU engines differ")
    check(s_gpu["preemptions"] > 0, f"engine {arch}: no preemption")
    check(a_gpu == a_cpu, f"engine {arch}: card and CPU agree with their oracles differently")
    check(cfg.family != "dense" or all(a_gpu), f"engine {arch}: differs from the oracle")
    RESULTS.setdefault("engine_small", {})[arch] = {
        "tokens_equal_cpu": True, "stats": s_gpu, "agrees_with_oracle": a_gpu}
    del gpu
    torch.cuda.empty_cache()


# -- disaggregated prefill/decode and the expert-parallel dispatch -------------

DISAGG_ARCH = "phi4_mini_3_8b"
DISAGG_PROMPT = 4096
DISAGG_PAGES = 4
# kernel launches of one disaggregated generate (16 new tokens: 15 decode
# steps): flash 32 a prefill and none in the handoff or a decode step; with
# the int8 cache the quantize 2 a prefill (k and v of the stacked cache)
# and 64 a step (k_new, v_new of 32 layers), the dequantize 64 a step
DISAGG_LAUNCHES = {
    "bfloat16": ({"flash_attention_fwd": 32}, {}),
    "int8": ({"flash_attention_fwd": 32, QUANT: 2}, {QUANT: 64, DEQUANT: 64}),
}


def _cache_bytes(cfg, pcfg, batch, length) -> int:
    """Bytes of every leaf of the model's cache for ``batch`` rows of
    ``length`` tokens (the structure built on the meta device)."""

    from repro_torch.core.futures import flatten
    from repro_torch.models import transformer

    cache = transformer.init_cache(cfg, pcfg, batch, length, device="meta")
    return sum(t.numel() * t.element_size() for t in flatten(cache)[0])


def phase_disaggregate(kv):
    """``DisaggregatedServer`` serving the full phi4-mini on the NCCL world
    of one (the degenerate set: prefill and decode on the card, the handoff
    over a one-rank bridge): 2 requests of 4096 tokens, 16 new tokens, the
    KV cache in ``DISAGG_PAGES`` pages through the RMA window.  The tokens
    must equal ``Server.generate``'s bit for bit (``dis.prefill`` is a plain
    ``Server`` on the same seed), a second generate must repeat them,
    ``kv_bytes`` must be the cache's own bytes, the launches exact and the
    decode step captured once a generate.  Logs the phases' times and the
    handoff's rate beside its bytes bound (the cache read and written
    once)."""

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.runtime.server import DisaggregatedServer, ServerConfig

    path = f"disaggregate_{kv}"
    cfg = base.get_config(DISAGG_ARCH)
    check(cfg.num_layers == 32 and cfg.d_model == 3072 and cfg.num_heads == 24
          and cfg.num_kv_heads == 8 and cfg.head_dim == 128, "not the phi4-mini config")
    pcfg = dataclasses.replace(base.get_parallel(DISAGG_ARCH), kv_cache_dtype=kv)
    t0 = time.perf_counter()
    dis = DisaggregatedServer(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=NEW_TOKENS),
                              kv_pages=DISAGG_PAGES, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(dis.prefill is not None and dis.decode is not None, f"{path}: a group is missing")
    reqs = serve.requests(cfg, 2, DISAGG_PROMPT)
    per_prefill, per_step = DISAGG_LAUNCHES[kv]
    runs = []
    for i in range(2):
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        tokens, stats = dis.generate(reqs)
        wall = time.perf_counter() - t1
        launches = _launches()
        (decode,) = dis.decode._decode_reqs.values()
        steps = NEW_TOKENS - 1
        for name, n in launches.items():
            want = per_prefill.get(name, 0) + per_step.get(name, 0) * steps
            check(n == want, f"{path} run {i + 1}: {name} launches {n} != "
                             f"{per_prefill.get(name, 0)} + {per_step.get(name, 0)} x {steps}")
        check(decode.captured == i + 1, f"{path}: {decode.captured} decode captures "
                                        f"after {i + 1} generates")
        runs.append({"tokens": tokens, "stats": stats, "launches": launches, "wall_s": wall,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(np.array_equal(runs[0]["tokens"], runs[1]["tokens"]),
          f"{path}: a second generate gave other tokens")
    base_tokens, base_stats = dis.prefill.generate(reqs)
    check(np.array_equal(runs[0]["tokens"], base_tokens),
          f"{path}: tokens {runs[0]['tokens'].tolist()} != Server.generate's "
          f"{base_tokens.tolist()}")
    check(runs[0]["tokens"].shape == (2, NEW_TOKENS), f"{path}: tokens shape")
    want_bytes = _cache_bytes(cfg, pcfg, 2, DISAGG_PROMPT + NEW_TOKENS)
    stats = runs[1]["stats"]
    check(all(r["stats"]["kv_bytes"] == want_bytes for r in runs),
          f"{path}: kv_bytes {stats['kv_bytes']} != the cache's {want_bytes}")
    check(stats["kv_pages"] == DISAGG_PAGES, f"{path}: kv_pages {stats['kv_pages']}")
    bound_ms = 2 * want_bytes / HBM_BYTES_PER_S * 1e3
    row = {
        "card": RESULTS["device"]["nvidia_smi"], "kv_cache_dtype": kv, "init_s": init_s,
        "tokens_equal_server_generate": True, "second_generate_identical": True,
        "kv_bytes": want_bytes, "kv_pages": DISAGG_PAGES,
        "transfer_bound_ms": bound_ms,
        "runs": [{k: v for k, v in r.items() if k != "tokens"} for r in runs],
        "transfer_gb_per_s": [r["stats"]["kv_bytes"] / r["stats"]["transfer_s"] / 1e9
                              for r in runs],
        "server_generate": {k: base_stats[k] for k in ("prefill_s", "decode_s",
                                                       "tokens_per_s")},
    }
    log(f"{path}: " + json.dumps(row))
    RESULTS.setdefault("disaggregate", {})[path] = row
    del dis
    torch.cuda.empty_cache()
    return path, runs[0]["launches"]


# the placement phase: every arch's specs at these folds (pure logic, on
# the meta device), then DTensor serving and training on the mesh of one
SHARD_FOLDS = ((("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16)),
               (("data", "model"), (1, 4)))
SHARD_ARCH = "phi4_mini_3_8b"
SHARD_PROMPT = 4096
SHARD_SSM_LAYERS = 4
# the placed serve's own checks run phi4-mini at full width and 8 of its
# 32 layers (the placed calls' time is DTensor's host dispatch, a layer at
# a time; cut from 16 to keep the run, its examples phase added, within
# its time); the ring prefill and the engine over the placed server run
# all 32
SHARD_SERVE_LAYERS = 8
# the sequence-sharded merged decode's merge (o·l/l over the mesh of one)
# may round apart from the plain decode, so it is held by its first decode
# step's logits against the plain path's: within this share of (1 + their
# largest magnitude), the limit tools/shard_ranks.py holds tensor
# parallelism to
MERGED_LOGITS_TOL = 2e-2


def _shard_launches(kind: str, layers: int) -> tuple[dict, dict]:
    """(per prefill, per decode step) launches of a generate (16 new
    tokens, 15 decode steps) over ``layers`` layers: flash one a layer of
    the prefill; with the int8 cache the quantize 2 a prefill and 2 a layer
    and step, the dequantize 2 a layer and step; mamba2: the SSD scan one a
    layer of the prefill (decode is plain); the ring prefill: the ring
    step once a layer (a ring of one), no flash."""

    return {"bfloat16": ({"flash_attention_fwd": layers}, {}),
            "int8": ({"flash_attention_fwd": layers, QUANT: 2},
                     {QUANT: 2 * layers, DEQUANT: 2 * layers}),
            "ssm": ({"ssd_scan_fwd": layers}, {}),
            "ring": ({RING: layers}, {})}[kind]
# (a) the ring prefill on placed weights: the full phi4-mini, 2 x 8192
SHARD_RING_PROMPT = 8192
# (b) the ring plan's placed state: phi4-mini at full width, 2 layers, b 2
# x 2048, 2 steps (the ring step 2 a layer and step: the forward and
# remat's recompute); held to the plain ring plan within the placed
# trainer tests' limit (tests/port/test_torch_sharded.py)
SHARD_RING_TRAIN_LAYERS, SHARD_RING_TRAIN_STEPS = 2, 2
SHARD_RING_TRAIN_RTOL = 1e-4
# (c) the engine over the placed server: 4 slots, prompts of 64-512 tokens
# in a 512 bucket, budgets of 4-16, blocks of 16, no pool cap
SHARD_ENGINE_SLOTS, SHARD_ENGINE_BUCKET, SHARD_ENGINE_REQUESTS = 4, 512, 6
SHARD_ENGINE_BUDGETS = (4, 16)


def _meta_params(cfg):
    """``cfg``'s parameter tree on the meta device (shapes only): the
    init with its draws replaced by empty meta tensors."""

    import torch

    from repro_torch.models import api, common

    class _MetaGen:
        device = torch.device("meta")

    draw = common._draw
    common._draw = lambda gen, shape, stddev: torch.empty(shape, device="meta")
    try:
        return api.build(cfg).init(_MetaGen())
    finally:
        common._draw = draw


def _placement_summary(tree, specs, shape) -> dict:
    """Leaves, split leaves and the largest rank's bytes of ``tree`` under
    ``specs`` on a mesh of ``shape`` ({axis: size})."""

    import math as _m

    from repro_torch.core.futures import flatten
    from repro_torch.sharding import rules

    leaves, spec_list = flatten(tree)[0], rules.spec_leaves(specs)
    whole = per_rank = split = 0
    for leaf, spec in zip(leaves, spec_list):
        n = leaf.numel() * leaf.element_size()
        parts = _m.prod(_m.prod(shape[a] for a in ((ax,) if isinstance(ax, str) else ax))
                        for ax in spec if ax is not None)
        whole += n
        per_rank += n // parts
        split += parts > 1
    return {"leaves": len(leaves), "split_leaves": split, "gb": whole / 1e9,
            "per_rank_gb": per_rank / 1e9}


def _shard_placements() -> dict:
    """Every arch's parameter, cache and batch specs at ``SHARD_FOLDS``,
    and what each rank holds under them."""

    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.sharding import rules

    out = {}
    for arch in base.ARCHITECTURES:
        cfg, pcfg = base.get_config(arch), base.get_parallel(arch)
        params = _meta_params(cfg)
        cache = None
        if cfg.family != "encdec":
            from repro_torch.models import api

            cache = api.build(cfg).init_cache(pcfg, 32, 4096, "meta")
        batch = {"tokens": torch.empty((32, 4096), dtype=torch.int32, device="meta")}
        row = {}
        for names, dims in SHARD_FOLDS:
            shape = dict(zip(names, dims))
            pc = dataclasses.replace(pcfg, data_axes=tuple(n for n in names if n != "model"))
            fold = {"params": _placement_summary(params, rules.param_specs(params, shape, pc),
                                                 shape)}
            if cache is not None:
                fold["cache"] = _placement_summary(
                    cache, rules.cache_specs(cache, shape, pc, cfg), shape)
            fold["batch"] = rules.batch_spec(batch, shape, pc)["tokens"]
            row["x".join(map(str, dims))] = fold
        out[arch] = row
    return out


def _placed(tree, device_mesh, pcfg):
    """A parameter tree placed under ``param_specs`` on ``device_mesh``."""

    from repro_torch.sharding import rules

    return rules.distribute(tree, rules.param_specs(tree, rules.mesh_shape(device_mesh), pcfg),
                            device_mesh)


def _shard_generate(path, server, reqs, kind, want_tokens, generates,
                    bitwise: bool = True, keep: list | None = None) -> dict:
    """One placed generate: its tokens against ``want_tokens`` bit for bit
    (else counted), its launches exact, one more decode capture; the
    tokens appended to ``keep``, where given."""

    import numpy as np
    import torch

    per_prefill, per_step = _shard_launches(kind, server.cfg.num_layers)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens, stats = server.generate(reqs)
    wall = time.perf_counter() - t0
    launches = _launches()
    if keep is not None:
        keep.append(tokens)
    steps = NEW_TOKENS - 1
    for name in set(launches) | set(per_prefill) | set(per_step):
        want = per_prefill.get(name, 0) + per_step.get(name, 0) * steps
        check(launches.get(name, 0) == want,
              f"{path}: {name} launches {launches.get(name, 0)} != {want}")
    check(np.isfinite(tokens).all() and tokens.shape == want_tokens.shape,
          f"{path}: tokens of shape {tokens.shape}")
    check(not bitwise or np.array_equal(tokens, want_tokens),
          f"{path}: DTensor tokens {tokens.tolist()} != the plain path's {want_tokens.tolist()}")
    decodes = list(server._decode_reqs.values())
    check(sum(d.captured for d in decodes) == generates,
          f"{path}: {[d.captured for d in decodes]} decode captures after {generates} "
          f"placed generates")
    return {"launches": launches, "wall_s": wall, "prefill_s": stats["prefill_s"],
            "tokens_per_s": stats["tokens_per_s"],
            "tokens_equal": int((tokens == want_tokens).sum()), "tokens": tokens.size,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _first_decode_logits(server, reqs):
    """The first decode step's whole logits (fp32) after a prefill of
    ``reqs``, from a decode request of its own (dropped after, so it
    captures nothing)."""

    import torch

    batch, _ = server._pad_batch(reqs)
    server._decode_reqs.clear()
    with torch.inference_mode():
        logits, cache = server._prefill_request(batch)(server.params, batch)
        tok = server._sample(logits, None)[:, None]
        dec, _ = server._decode_request(cache, tok)(server.params, cache, tok)
        dec = dec.full_tensor() if hasattr(dec, "full_tensor") else dec
        server._decode_reqs.clear()
        return dec.float()


def _placed_cache(server, reqs) -> list:
    """The placements of the prefill cache's leaves (DTensors, or the
    refusal says which is not)."""

    import torch

    from repro_torch.core.futures import flatten
    from repro_torch.sharding.local import is_dtensor

    batch, _ = server._pad_batch(reqs)
    with torch.inference_mode():
        _, cache = server._prefill_request(batch)(server.params, batch)
    leaves = flatten(cache)[0]
    check(all(is_dtensor(t) for t in leaves), "shard: a prefill cache leaf is not a DTensor")
    return sorted({str(tuple(t.placements)) for t in leaves})


def _decode_replays(server, reqs) -> dict:
    """A fresh decode request on a fresh prefill's cache: its eager first
    start, its capturing second start and eight replays, each timed on the
    host clock between synchronisations; the graph released after."""

    import torch

    batch, _ = server._pad_batch(reqs)
    with torch.inference_mode():
        logits, cache = server._prefill_request(batch)(server.params, batch)
        tok = server._sample(logits, None)[:, None]
        req = server._decode_request(cache, tok)
        check(req.starts == 0, "shard: the decode request is not fresh")
        marks = [time.perf_counter()]
        for _ in range(2 + 8):
            logits, cache = req(server.params, cache, tok)
            if len(marks) < 3:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        check(req.captured == 1, f"shard: {req.captured} captures for ten starts")
        req.release()
    return {"eager_ms": (marks[1] - marks[0]) * 1e3, "capture_ms": (marks[2] - marks[1]) * 1e3,
            "replay_ms": (marks[3] - marks[2]) / 8 * 1e3}


def _shard_serve(results) -> dict:
    """phi4-mini at full width, ``SHARD_SERVE_LAYERS`` of its 32 layers (2
    x 4096, 16 new tokens): plain
    tokens with the bf16 and the int8 cache, then the same weights placed
    on the mesh of one give them bit for bit.  The sequence-sharded merged
    decode (its merge's arithmetic and all-reduces run over the mesh of
    one) is held by its first decode step's logits on two prompt sets,
    within ``MERGED_LOGITS_TOL``, and its tokens counted against the plain
    path's.  Logs the plain and the placed generates' times, and a decode
    capture and its replays on each."""

    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.runtime.server import Request, Server, ServerConfig
    from repro_torch.sharding.local import is_dtensor

    full = base.get_config(SHARD_ARCH)
    check(full.num_layers == 32 and full.d_model == 3072, "not the phi4-mini config")
    cfg = dataclasses.replace(full, num_layers=SHARD_SERVE_LAYERS)
    pcfg = base.get_parallel(SHARD_ARCH)
    reqs = serve.requests(cfg, 2, SHARD_PROMPT)
    server = Server(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=NEW_TOKENS),
                    device="cuda")
    mesh = server.comm.device_mesh
    check(tuple(mesh.mesh.shape) == (1, 1), f"shard: mesh {tuple(mesh.mesh.shape)}")

    def use(pc):
        server.pcfg = pc
        server._prefill_reqs.clear()
        server._decode_reqs.clear()

    # the merged decode's second reading: the same prompts reversed
    reqs_b = [Request(tokens=r.tokens[::-1].copy()) for r in reqs]
    plain = {}
    for kv in ("bfloat16", "int8"):
        use(dataclasses.replace(pcfg, kv_cache_dtype=kv))
        runs = [server.generate(reqs) for _ in range(2)]
        plain[kv] = runs[0][0]
        results[f"plain_phi4_{kv}"] = [{k: st[k] for k in ("prefill_s", "decode_s",
                                                          "tokens_per_s")} for _, st in runs]
    use(pcfg)
    plain["reversed"] = server.generate(reqs_b)[0]
    first = {"prompts": _first_decode_logits(server, reqs),
             "reversed": _first_decode_logits(server, reqs_b)}
    results["plain_phi4_decode_graph"] = _decode_replays(server, reqs)
    with torch.inference_mode():
        server.params = _placed(server.params, mesh, pcfg)
    check(server.placed and is_dtensor(server.params["embed"]), "shard: params not placed")
    generates = 0
    for kv in ("int8", "bfloat16"):
        use(dataclasses.replace(pcfg, kv_cache_dtype=kv))
        generates = 1
        results[f"phi4_{kv}"] = _shard_generate(f"shard_phi4_{kv}", server, reqs, kv,
                                                plain[kv], generates)
        results[f"phi4_{kv}"]["cache_placements"] = _placed_cache(server, reqs)
        generates += 1
        results[f"phi4_{kv}"]["second"] = _shard_generate(
            f"shard_phi4_{kv}_again", server, reqs, kv, plain[kv], generates)
    use(pcfg)
    results["phi4_decode_graph"] = _decode_replays(server, reqs)
    use(dataclasses.replace(pcfg, seq_shard_cache=True, flash_decode_merge=True))
    merged = {}
    for name, rs, want in (("prompts", reqs, plain["bfloat16"]),
                           ("reversed", reqs_b, plain["reversed"])):
        got = _first_decode_logits(server, rs)
        err = float((got - first[name]).abs().max())
        scale = float(first[name].abs().max())
        row = _shard_generate(f"shard_phi4_merged_{name}", server, rs, "bfloat16", want, 1,
                              bitwise=False)
        merged[name] = {**row, "max_abs_err_first_decode": err, "logits_absmax": scale}
        check(err <= MERGED_LOGITS_TOL * (1 + scale),
              f"shard_phi4_merged_{name}: first decode logits {err} from the plain path's "
              f"(limit {MERGED_LOGITS_TOL} x (1 + {scale}))")
    results["phi4_merged_decode"] = merged
    launches = {}
    rows = [results["phi4_int8"], results["phi4_bfloat16"], *merged.values()]
    for row in rows:
        for name, n in row["launches"].items():
            launches[name] = launches.get(name, 0) + n
    del server
    _free()
    return launches


@contextlib.contextmanager
def _capture_times():
    """Every CUDA graph capture made inside, timed (ms, the device
    synchronised on both sides): ``futures._graph_capture`` wrapped."""

    import torch

    from repro_torch.core import futures

    base, times = futures._graph_capture, []

    def timed(fn, args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = base(fn, args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    futures._graph_capture = timed
    try:
        yield times
    finally:
        futures._graph_capture = base


def _case_line(case: str, row: dict) -> None:
    """A shard case's wall time, peak memory and capture times, on a line
    of its own."""

    print(json.dumps({"case": case, **{k: row[k] for k in ("wall_s", "peak_gb", "capture_ms")}}),
          flush=True)


def _shard_ring_generate(path, server, reqs, want_tokens, keep=None) -> dict:
    """One ring-prefill generate (``ring_attention`` on the server's
    communicator, a ring of one): launches exact, the ring step 32 a
    prefill; its tokens against ``want_tokens`` bit for bit (none for the
    plain run, whose tokens go to ``keep``)."""

    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    with _capture_times() as caps:
        row = _shard_generate(
            path, server, reqs, "ring",
            want_tokens if want_tokens is not None else np.zeros((len(reqs), NEW_TOKENS)),
            1, bitwise=want_tokens is not None, keep=keep)
    row["capture_ms"] = caps
    _case_line(path, row)
    return row


def _shard_engine_requests(vocab):
    """(prompts, budgets) of the placed engine case, from one generator."""

    import numpy as np

    rng = np.random.default_rng(7)
    lens = rng.integers(SHARD_ENGINE_BUCKET // 8, SHARD_ENGINE_BUCKET + 1,
                        size=SHARD_ENGINE_REQUESTS)
    prompts = [rng.integers(1, vocab, size=(int(m),), dtype=np.int32) for m in lens]
    budgets = rng.integers(SHARD_ENGINE_BUDGETS[0], SHARD_ENGINE_BUDGETS[1] + 1,
                           size=SHARD_ENGINE_REQUESTS)
    return prompts, [int(b) for b in budgets]


def _shard_engine(path, server, kv, prompts, budgets) -> tuple[list, dict]:
    """One ``Engine.run`` over ``server``'s weights with a ``kv`` cache
    (``_engine_run``: launches exact, flash 32 an admission prefill, one
    decode capture): each request's tokens and the run's row."""

    import torch

    from repro_torch.runtime.engine import EngineConfig

    srv = _server_like(server, kv, max(budgets), max_batch=SHARD_ENGINE_SLOTS)
    torch.cuda.reset_peak_memory_stats()
    with _capture_times() as caps:
        handles, eng, row = _engine_run(path, srv, EngineConfig(
            prompt_bucket=SHARD_ENGINE_BUCKET, block_tokens=16), prompts, budgets)
    row.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, capture_ms=caps,
               useful_tokens_per_s=sum(budgets) / row["wall_s"])
    tokens = [list(h.generated) for h in handles]
    del handles, eng, srv
    _case_line(path, row)
    return tokens, row


def _shard_ring_engine(results) -> dict:
    """The full phi4-mini (32 layers) on the plain weights, then on the
    same weights placed on the mesh of one: (a) the ring prefill at 2 x
    ``SHARD_RING_PROMPT`` (the ring step 32 a prefill), the placed run's
    tokens the plain ring server's bit for bit; (c) the engine with the
    bf16 and the int8 cache, each request's tokens the plain engine's bit
    for bit (flash 32 an admission prefill, one decode capture a run).
    Returns the placed runs' launches."""

    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.runtime.server import Server, ServerConfig

    cfg, pcfg = base.get_config(SHARD_ARCH), base.get_parallel(SHARD_ARCH)
    ring_pcfg = dataclasses.replace(pcfg, ring_attention=True)
    server = Server(cfg, ring_pcfg, ServerConfig(max_batch=2, max_new_tokens=NEW_TOKENS),
                    device="cuda")
    ring_reqs = serve.requests(cfg, 2, SHARD_RING_PROMPT)
    engine_reqs = _shard_engine_requests(cfg.vocab_size)

    def use(pc):
        # the ring prefill's configuration, or the engine's (without the
        # ring: its admissions run flash); the engines' servers copy it
        server.pcfg = pc
        server._prefill_reqs.clear()
        server._decode_reqs.clear()

    kept = []
    plain_ring = _shard_ring_generate("shard_ring_prefill_plain", server, ring_reqs, None, kept)
    use(pcfg)
    plain_engine = {kv: _shard_engine(f"shard_engine_plain_{kv}", server, kv, *engine_reqs)
                    for kv in ("bfloat16", "int8")}
    with torch.inference_mode():
        server.params = _placed(server.params, server.comm.device_mesh, pcfg)
    check(server.placed, "shard: the ring server's params are not placed")
    # (a) the ring prefill on the placed weights
    use(ring_pcfg)
    ring = _shard_ring_generate("shard_ring_prefill_placed", server, ring_reqs, kept[0])
    results["ring_prefill"] = {"plain": plain_ring, "placed": ring,
                               "prompt_len": SHARD_RING_PROMPT}
    # (c) the engine over the placed server
    use(pcfg)
    engine, launches = {}, dict(ring["launches"])
    for kv in ("bfloat16", "int8"):
        tokens, row = _shard_engine(f"shard_engine_placed_{kv}", server, kv, *engine_reqs)
        check(tokens == plain_engine[kv][0],
              f"shard_engine_placed_{kv}: tokens {tokens} != the plain engine's "
              f"{plain_engine[kv][0]}")
        engine[kv] = {"plain": plain_engine[kv][1], "placed": row, "tokens_equal": True}
        for name, n in row["launches"].items():
            launches[name] = launches.get(name, 0) + n
    results["engine_placed"] = engine
    del server
    _free()
    return launches


def _shard_ssm(results) -> dict:
    """mamba2-2.7b at full width, ``SHARD_SSM_LAYERS`` of 64 layers (2 x
    4096): the placed model's tokens bit for bit the plain model's, the SSD
    scan run through ``local_map`` once a layer of a prefill."""

    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = dataclasses.replace(base.get_config("mamba2_2_7b"), num_layers=SHARD_SSM_LAYERS)
    pcfg = base.get_parallel("mamba2_2_7b")
    reqs = serve.requests(cfg, 2, SHARD_PROMPT)
    server = Server(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=NEW_TOKENS),
                    device="cuda")
    plain, _ = server.generate(reqs)
    with torch.inference_mode():
        server.params = _placed(server.params, server.comm.device_mesh, pcfg)
    server._prefill_reqs.clear()
    server._decode_reqs.clear()
    results["mamba2_layers"] = _shard_generate("shard_mamba2", server, reqs, "ssm", plain, 1)
    launches = results["mamba2_layers"]["launches"]
    del server
    _free()
    return launches


def _shard_train(results, moments, cross: bool) -> dict:
    """phi4-mini at full width, 2 layers, b 2 x 2048, 4 steps (step 1
    eager, then one graph captured and replayed): the plain ``Trainer``,
    then a ``Trainer`` whose state is placed (fsdp + tensor on the mesh of
    one) from the same seed; losses and grad norms bit for bit.  With
    ``cross``, the placed run's checkpoint restores into a plain
    ``Trainer`` and the plain run's into a placed one, bit for bit."""

    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import base
    from repro_torch.core.futures import flatten
    from repro_torch.sharding.local import is_dtensor

    cfg = dataclasses.replace(base.get_config(SHARD_ARCH), num_layers=2)
    pcfg = dataclasses.replace(base.get_parallel(SHARD_ARCH), moment_dtype=moments)
    check(pcfg.fsdp and pcfg.attn_plan == "tp_heads", "shard: not the fsdp + tensor layout")
    dirs = {k: ROOT / "build" / f"shard_ckpt_{k}" for k in ("plain", "placed")}
    kw = dict(steps=TRAIN_STEPS, seq=TRAIN_SEQ, batch=TRAIN_BATCH, checkpoint_every=TRAIN_STEPS)
    runs, finals = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for kind in ("plain", "placed"):
            shutil.rmtree(dirs[kind], ignore_errors=True)
            torch.cuda.reset_peak_memory_stats()
            trainer = _trainer(cfg, pcfg, "cuda",
                               checkpoint_dir=str(dirs[kind]) if cross else None, **kw)
            if kind == "placed":
                trainer.placed = True
            t0 = time.perf_counter()
            result = trainer.run()
            torch.cuda.synchronize()
            leaves = flatten((trainer.params, trainer.opt_state))[0]
            check(all(is_dtensor(t) for t in leaves) == (kind == "placed"),
                  f"shard_train {moments}: the {kind} state's leaves")
            runs[kind] = {"losses": [(m["loss"], m["grad_norm"]) for m in result["metrics"]],
                          "run_s": time.perf_counter() - t0,
                          "step_s": [m["duration_s"] for m in result["metrics"]],
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "captured": trainer._request.captured}
            finals[kind] = [(t.to_local() if is_dtensor(t) else t).detach().cpu()
                            for t in leaves]
            check(trainer._request.captured == 1,
                  f"shard_train {moments} {kind}: {trainer._request.captured} captures")
            del trainer, result, leaves
            _free()
        check(runs["placed"]["losses"] == runs["plain"]["losses"],
              f"shard_train {moments}: placed {runs['placed']['losses']} != plain "
              f"{runs['plain']['losses']}")
        for src, dst in (("placed", "plain"), ("plain", "placed")) if cross else ():
            reader = _trainer(cfg, pcfg, "cuda", checkpoint_dir=str(dirs[src]), **kw)
            reader.placed = dst == "placed"
            params, opt_state = reader.init_state()
            params, opt_state, step = reader._restore(params, opt_state)
            check(step == TRAIN_STEPS, f"shard_train {moments}: restored step {step}")
            got = [(t.to_local() if is_dtensor(t) else t).detach().cpu()
                   for t in flatten((params, opt_state))[0]]
            check(all(is_dtensor(t) for t in flatten(params)[0]) == (dst == "placed"),
                  f"shard_train {moments}: restored into {dst}")
            check(len(got) == len(finals[src]) and all(
                torch.equal(a, b) for a, b in zip(got, finals[src])),
                f"shard_train {moments}: {src} checkpoint restored into {dst} differs")
            del reader, params, opt_state, got
            _free()
    finally:
        torch.use_deterministic_algorithms(False)
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    results[f"train_{moments}"] = {**runs, "equal_bitwise": True, "checkpoints_cross":
                                   ["placed->plain", "plain->placed"] if cross else []}
    return {}


def _shard_ring_train(results) -> dict:
    """(b) The ring plan's placed state: phi4-mini at full width and
    ``SHARD_RING_TRAIN_LAYERS`` layers, b 2 x 2048, ``ring_attention`` on
    the world of one (a ring of one), ``SHARD_RING_TRAIN_STEPS`` steps
    (step 1 eager, step 2 captured and replayed): the plain ring plan, then
    the same with ``placed`` set; the ring step 2 a layer and step and no
    flash, every leaf of the placed state a DTensor, the losses and grad
    norms within ``SHARD_RING_TRAIN_RTOL`` of the plain run's."""

    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.core.futures import flatten
    from repro_torch.sharding.local import is_dtensor

    cfg = dataclasses.replace(base.get_config(SHARD_ARCH), num_layers=SHARD_RING_TRAIN_LAYERS)
    pcfg = dataclasses.replace(base.get_parallel(SHARD_ARCH), ring_attention=True)
    steps = SHARD_RING_TRAIN_STEPS
    runs, launches = {}, {}
    for kind in ("plain", "placed"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _capture_times() as caps:
            trainer = _trainer(cfg, pcfg, "cuda", steps=steps, seq=TRAIN_SEQ, batch=TRAIN_BATCH)
            trainer.placed = kind == "placed"
            _reset_launches()
            result = trainer.run()
            torch.cuda.synchronize()
            launches = _launches()
        wall = time.perf_counter() - t0
        path = f"shard_ring_train_{kind}"
        check(trainer._ring_line is not None and trainer._ring_line.size() == 1,
              f"{path}: not the ring of one")
        leaves = flatten((trainer.params, trainer.opt_state))[0]
        check(all(is_dtensor(t) for t in leaves) == (kind == "placed"),
              f"{path}: the {kind} state's leaves")
        want = 2 * SHARD_RING_TRAIN_LAYERS * steps
        check(launches.get(RING, 0) == want and not launches.get("flash_attention_fwd"),
              f"{path}: launches {launches}, want the ring step {want} and no flash")
        runs[kind] = {"losses": [(m["loss"], m["grad_norm"]) for m in result["metrics"]],
                      "step_s": [m["duration_s"] for m in result["metrics"]],
                      "launches": launches, "wall_s": wall, "capture_ms": caps,
                      "captured": trainer._request.captured,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        _case_line(path, runs[kind])
        del trainer, result, leaves
        _free()
    for (lp, gp), (lq, gq) in zip(runs["plain"]["losses"], runs["placed"]["losses"]):
        check(abs(lq - lp) <= SHARD_RING_TRAIN_RTOL * abs(lp)
              and abs(gq - gp) <= SHARD_RING_TRAIN_RTOL * abs(gp),
              f"shard_ring_train: placed {runs['placed']['losses']} against plain "
              f"{runs['plain']['losses']}")
    results["ring_train"] = {**runs, "layers": SHARD_RING_TRAIN_LAYERS, "steps": steps,
                             "equal_bitwise": runs["plain"]["losses"] == runs["placed"]["losses"]}
    return runs["placed"]["launches"]


def phase_shard():
    """The sharding rules on the card: every arch's placements at the folds
    (16, 16), (2, 16, 16) and (1, 4), logged; then on the NCCL world of
    one and its device mesh of one (``rules.distribute`` called here), the
    phi4-mini (full width, ``SHARD_SERVE_LAYERS`` layers) served from
    DTensor weights (bf16 and int8 cache), mamba2 at
    ``SHARD_SSM_LAYERS`` layers, and phi4-mini trained at 2 layers with fp32 and
    int8 moments: all bit for bit the plain path's, launches exact, one
    decode capture a generate, the checkpoints crossing both ways; the
    sequence-sharded merged decode held by its first decode logits.  Then
    the full phi4-mini (32 layers), plain and then placed: (a) the ring
    prefill at 2 x 8192 (the ring step 32 a prefill, the plain ring
    server's tokens), (c) the engine with
    the bf16 and the int8 cache (each request's tokens the plain engine's);
    and (b) the ring plan's placed state at 2 layers against the plain ring
    plan.  Each case prints its wall time, peak and capture times."""

    results = {"card": RESULTS["device"]["nvidia_smi"]}
    t0 = time.perf_counter()
    results["placements"] = _shard_placements()
    results["placements_s"] = time.perf_counter() - t0
    launches = dict.fromkeys(_launches(), 0)
    t1 = time.perf_counter()
    for part in (_shard_serve, _shard_ring_engine, _shard_ssm):
        for name, n in part(results).items():
            launches[name] += n
    results["serve_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    for moments in ("float32", "int8"):
        # the checkpoints cross once, with the int8 moments: their payloads
        # and row-split scales are the placed state's every kind of leaf,
        # at a quarter of the fp32 state's 8 GB of writes
        _shard_train(results, moments, cross=moments == "int8")
    for name, n in _shard_ring_train(results).items():
        launches[name] += n
    results["train_s"] = time.perf_counter() - t2
    results["phase_s"] = time.perf_counter() - t0
    log("shard: " + json.dumps({k: v for k, v in results.items() if k != "placements"}))
    log("shard placements: " + json.dumps(results["placements"]))
    RESULTS["shard"] = results
    return "shard", launches


def phase_moe_neighbor():
    """``mlp.moe_neighbor`` over ``expert_dispatch_graph`` on the world of
    one (a self-loop: every expert is local, the two neighbor exchanges
    cross the one-rank graph) against ``mlp.moe`` on the same inputs, on
    the grok-1 smoke model in fp32 at a capacity that drops nothing; card
    against CPU."""

    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.core import topology
    from repro_torch.core.communicator import world
    from repro_torch.models import mlp

    cfg = dataclasses.replace(base.get_smoke_config("grok_1_314b"), dtype="float32")
    gen = torch.Generator().manual_seed(31)
    p_cpu = mlp.init_moe(gen, cfg, torch.float32)
    x_cpu = torch.randn((2, 64, cfg.d_model), generator=gen)
    t = x_cpu.shape[0] * x_cpu.shape[1]
    cap = t * cfg.moe_top_k
    got = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        comm = world(device_type=device)
        graph = topology.dist_graph_create_adjacent(
            comm, *mlp.expert_dispatch_graph(comm.size(), cfg.num_experts))
        p = {k: v.to(device) for k, v in p_cpu.items()}
        x = x_cpu.to(device)
        y_nb, aux_nb = mlp.moe_neighbor(p, x.reshape(t, -1), cfg, graph, capacity=cap)
        y_moe, aux_moe = mlp.moe(p, x, cfg, capacity=cap)
        got[name] = (y_nb.cpu(), y_moe.reshape(t, -1).cpu(),
                     {k: float(v) for k, v in aux_nb.items()},
                     {k: float(v) for k, v in aux_moe.items()})
    (nb, moe, aux_nb, aux_moe), (nb_cpu, moe_cpu, _, _) = got["card"], got["cpu"]
    err_moe = (nb - moe).abs().max().item()
    err_cpu = (nb - nb_cpu).abs().max().item()
    row = {"experts": cfg.num_experts, "top_k": cfg.moe_top_k, "tokens": t, "capacity": cap,
           "max_abs_err_vs_moe": err_moe, "bit_equal_moe": bool(torch.equal(nb, moe)),
           "max_abs_err_card_vs_cpu": err_cpu, "aux": aux_nb, "aux_moe": aux_moe}
    log("moe_neighbor: " + json.dumps(row))
    check(err_moe <= 1e-6, f"moe_neighbor differs from moe on the card by {err_moe}")
    check(torch.allclose(nb, nb_cpu, rtol=1e-5, atol=1e-5) and torch.allclose(moe, moe_cpu,
                                                                             rtol=1e-5,
                                                                             atol=1e-5),
          f"moe_neighbor: card against CPU {err_cpu}")
    check(aux_nb["dropped_fraction"] == 0.0, "moe_neighbor dropped rows at full capacity")
    RESULTS["moe_neighbor"] = row


# -- training ------------------------------------------------------------------

# phase train_small: (name, config source, seq, batch, lr).  The tiny dense
# config and lr are tests/test_trainer.py's; mamba2's smoke model learns
# the stream more slowly, and at lr 1e-3 gains less than the 0.1 asked in 40
# steps, so it trains at 1e-2
# the third spec is the tiny model with int8 moments (the reference's _Q8):
# its updates are discontinuous in the gradient, and elements whose nu
# stores 0 step by lr mu_hat / eps, so the reference itself diverges on it
# (ROADMAP C10) and the card's run parts from the CPU's once a stored
# moment differs; the card is held to the CPU run for TRAIN_SMALL_INT8_HELD
# steps (step 1's update reads no stored moment), finite after, and bit for
# bit through the forced failure and restore
TRAIN_SMALL = (("tiny", None, 64, 4, 1e-3, "float32"),
               ("mamba2_smoke", "mamba2_2_7b", 64, 4, 1e-2, "float32"),
               ("tiny_int8", None, 64, 4, 1e-3, "int8"))
TRAIN_SMALL_STEPS = 40
TRAIN_SMALL_RTOL = 1e-4
TRAIN_SMALL_INT8_HELD = 2
# the full training paths: arch, layers, d_model, the kernel and its launches
# per layer and step (the forward and remat's recompute; the backward
# recomputes through the plain version), the moments' dtype; with int8
# moments the quant kernels run in every step (one dequantize and one
# quantize a moment and piece of whole rows).  granite-3-8b's fp32 moments
# (65.4 GB) do not fit beside its weights and grads: it trains with int8 only
TRAIN_FULL = (("phi4_mini_3_8b", 32, 3072, "flash_attention_fwd", "float32"),
              ("phi4_mini_3_8b", 32, 3072, "flash_attention_fwd", "int8"),
              ("mamba2_2_7b", 32, 2560, "ssd_scan_fwd", "float32"),
              ("granite_3_8b", 20, 4096, "flash_attention_fwd", "int8"),
              ("paligemma_3b", 18, 2048, "flash_attention_fwd", "float32"),
              ("seamless_m4t_large_v2", 24, 1024, "flash_attention_fwd", "float32"),
              ("grok_1_314b", 1, 6144, "flash_attention_fwd", "int8"),
              ("deepseek_v2_236b", 2, 5120, "flash_attention_fwd", "int8"))
# the training runs whose depth is cut: grok-1 at 1 layer (6.5 B params, its
# untied embedding and head included; 2 layers, 11.5 B, would not fit even
# with int8 moments), deepseek-v2 at dense_0 and 1 MoE layer (5.4 B): at 3
# layers (9.3 B) the plain attention's recompute in the backward (fp32
# scores of 128 heads, 4 GiB each) asks past the card's 80 GB; mamba2-2.7b
# at 32 of 64 layers and granite-3-8b at 20 of 40, to keep the run inside
# its time
TRAIN_LAYERS = {"grok_1_314b": 1, "deepseek_v2_236b": 2, "mamba2_2_7b": 32,
                "granite_3_8b": 20}
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 2048, 2, 4
# the ring plan's and the pipeline's phi4-mini against its flash / data-plan
# run on the same weights and batches: bf16 activations rounded in another
# order (the repo's bf16 tolerance)
TRAIN_RING_RTOL = TRAIN_PIPELINE_RTOL = 2e-2
PIPELINE_MICROBATCHES = 2


def _tiny_cfg():
    """tests/test_trainer.py's tiny dense model."""

    from repro_torch.configs.base import ModelConfig

    return ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)


def _trainer(cfg, pcfg, device, *, steps, seq, batch, lr=3e-4, injector=None, **tcfg):
    """A ``Trainer`` that logs every step.  Its straggler deadline is
    infinite: the phases time the steps, and a slow first step is no sick
    worker here (the straggler policy is held by the CPU tests)."""

    from repro_torch.runtime.faults import StragglerPolicy
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    return Trainer(cfg, pcfg, TrainerConfig(steps=steps, lr=lr, log_every=1, **tcfg),
                   device=device, seq_len=seq, global_batch=batch, injector=injector,
                   straggler=StragglerPolicy(deadline_factor=math.inf))


def _free() -> None:
    """Release a phase's trainers: a trainer whose ``init_state`` is
    wrapped (``_capture_init``) sits in a reference cycle, which only the
    collector breaks."""

    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _capture_init(trainer) -> dict:
    """Wrap ``trainer.init_state`` to keep, before any step updates them in
    place, a CPU copy of the initial parameters (``cpu_params``)."""

    from repro_torch.core.futures import flatten, unflatten

    seen, init = {}, trainer.init_state

    def wrapped():
        params, opt_state = init()
        leaves, treedef = flatten(params)
        seen["cpu_params"] = unflatten(treedef, [p.detach().to("cpu", copy=True) for p in leaves])
        return params, opt_state

    trainer.init_state = wrapped
    return seen


def _changed_leaves(seen, params) -> int:
    """How many leaves of ``params`` differ from the init anywhere, each
    leaf held whole against its CPU copy, one at a time on the card (an
    untied embedding changes only in the rows of the batch's tokens: its
    first row may keep its bf16 bits through a few steps of decay)."""

    import torch

    from repro_torch.core.futures import flatten

    return sum(not torch.equal(a.to(p.device), p.detach())
               for a, p in zip(flatten(seen["cpu_params"])[0], flatten(params)[0]))


def phase_train_small(name, arch, seq, batch, lr, moments):
    """``Trainer`` on the card and on the CPU from the same init (the card's,
    copied) and batches, fp32, remat full, ``moments`` the moments' dtype:
    every step's loss within ``TRAIN_SMALL_RTOL`` relative, the kernel
    launched twice per layer and step, and the loss down by more than 0.1
    over the run; with int8 moments, the first ``TRAIN_SMALL_INT8_HELD``
    steps' losses within ``TRAIN_SMALL_RTOL``, every loss finite, and the
    quant kernels launched twice a moment piece and step."""

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.runtime.trainer import Trainer

    cfg = _tiny_cfg() if arch is None else base.get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    pcfg = dataclasses.replace(base.ParallelConfig() if arch is None else base.get_parallel(arch),
                               remat="full", moment_dtype=moments)
    kernel = "ssd_scan_fwd" if cfg.family == "ssm" else "flash_attention_fwd"
    kw = dict(steps=TRAIN_SMALL_STEPS, seq=seq, batch=batch, lr=lr)
    card = _trainer(cfg, pcfg, "cuda", **kw)
    seen = _capture_init(card)
    _reset_launches()
    card_losses = [m["loss"] for m in card.run()["metrics"]]
    launches = _launches()
    cpu = _trainer(cfg, pcfg, "cpu", **kw)
    cpu_params = Trainer._trainable(seen["cpu_params"])
    cpu.init_state = lambda: (cpu_params, cpu.opt.init(cpu_params))
    cpu_losses = [m["loss"] for m in cpu.run()["metrics"]]
    rel = np.abs(np.array(card_losses) - cpu_losses) / np.abs(cpu_losses)
    held = TRAIN_SMALL_INT8_HELD if moments == "int8" else TRAIN_SMALL_STEPS
    row = {"config": name, "moments": moments, "steps": TRAIN_SMALL_STEPS, "seq": seq,
           "batch": batch, "lr": lr, "first_loss": card_losses[0], "last_loss": card_losses[-1],
           "max_rel_diff_card_cpu": float(rel.max()), "steps_held": held,
           "max_rel_diff_held_steps": float(rel[:held].max()), "rtol": TRAIN_SMALL_RTOL,
           "launches": launches, "device": RESULTS["device"]["nvidia_smi"]}
    log_row(row)
    for k, n in launches.items():
        want = {kernel: 2 * cfg.num_layers}.get(k, 0)
        if moments == "int8" and k in (QUANT, DEQUANT):
            want = 2 * _moment_pieces(card.params)
        check(n == want * TRAIN_SMALL_STEPS,
              f"train_small {name}: {k} launches {n}, want {want * TRAIN_SMALL_STEPS}")
    check(np.all(np.isfinite(card_losses)) and np.all(np.isfinite(cpu_losses))
          and rel[:held].max() <= TRAIN_SMALL_RTOL,
          f"train_small {name}: card and CPU losses {rel[:held].max()} apart (relative) "
          f"over the first {held} steps")
    if moments != "int8":
        check(card_losses[-1] < card_losses[0] - 0.1,
              f"train_small {name}: loss {card_losses[0]} -> {card_losses[-1]}")
    row["restore"] = _failure_and_restore(name, card, cfg, pcfg, kw)
    RESULTS.setdefault("train_small", {})[name] = {**row, "card_losses": card_losses,
                                                   "cpu_losses": cpu_losses}
    del card, cpu, seen, cpu_params
    _free()


# the forced failure of train_small: checkpoints every TRAIN_SMALL_SAVE
# steps, a failure injected before step TRAIN_SMALL_FAIL + 1 (restoring step 20)
TRAIN_SMALL_SAVE, TRAIN_SMALL_FAIL = 10, 25


def _failure_and_restore(name, card, cfg, pcfg, kw) -> dict:
    """The run of ``card`` again from the same seed, with saves under
    ``build/`` and a worker failure injected: the trainer drops the step's
    graph, restores the last checkpoint, captures again, and must end where
    ``card`` did, bit for bit (the resumed steps' losses and grad norms, the
    final parameters and optimizer state)."""

    import shutil

    import torch

    from repro_torch.core.futures import flatten
    from repro_torch.runtime.faults import FaultInjector

    ckpt_dir = ROOT / "build" / f"train_small_{name}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    failed = _trainer(cfg, pcfg, "cuda", **kw, checkpoint_dir=str(ckpt_dir),
                      checkpoint_every=TRAIN_SMALL_SAVE,
                      injector=FaultInjector(fail_at_steps=(TRAIN_SMALL_FAIL,)))
    result = failed.run()
    resumed_from = TRAIN_SMALL_FAIL // TRAIN_SMALL_SAVE * TRAIN_SMALL_SAVE
    resumed = [(m["step"], m["loss"], m["grad_norm"]) for m in result["metrics"]][
        TRAIN_SMALL_FAIL:]
    want = [(m["step"], m["loss"], m["grad_norm"]) for m in card.metrics_history][resumed_from:]
    same = all(torch.equal(a, b) for a, b in zip(
        flatten((failed.params, failed.opt_state))[0], flatten((card.params, card.opt_state))[0]))
    out = {"restarts": result["restarts"], "graph_captures": failed._request.captured,
           "resumed_from_step": resumed_from, "resumed_steps": len(resumed),
           "resumed_equal_bitwise": resumed == want and same}
    log(f"train_small {name} forced failure at step {TRAIN_SMALL_FAIL + 1}: " + json.dumps(out))
    check(result["restarts"] == 1 and result["final_step"] == TRAIN_SMALL_STEPS,
          f"train_small {name}: restarts {result['restarts']}, final step {result['final_step']}")
    check(failed._request.captured == 2, f"train_small {name}: {failed._request.captured} "
                                         f"captures, want 2 (the restored state captured again)")
    check(resumed == want, f"train_small {name}: resumed steps {resumed} != {want}")
    check(same, f"train_small {name}: the restored run's state differs from the uninterrupted's")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del failed
    return out


def phase_train_checkpoint():
    """phi4-mini at full width and 2 layers, b 2 x 2048: four steps with an
    async save at step 2 (overlapping steps 3 and 4) and at step 4, under
    ``build/``; a fresh ``Trainer`` restores step 2 and takes steps 3 and
    4, which must equal the uninterrupted run's bit for bit (losses, grad
    norms, parameters and optimizer state).  The checkpoint is deleted
    after."""

    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import base
    from repro_torch.core.futures import flatten

    cfg = dataclasses.replace(base.get_config("phi4_mini_3_8b"), num_layers=2)
    pcfg = base.get_parallel("phi4_mini_3_8b")
    ckpt_dir = ROOT / "build" / "train_checkpoint"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(steps=4, seq=TRAIN_SEQ, batch=TRAIN_BATCH, checkpoint_dir=str(ckpt_dir),
              checkpoint_every=2)
    # bit for bit needs the deterministic kernels where PyTorch has a choice
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        whole = _trainer(cfg, pcfg, "cuda", **kw)
        result = whole.run()
        whole_s = time.perf_counter() - t0
        check(result["ckpt_failures"] == 0 and whole.ckpt.steps() == [2, 4],
              f"train_checkpoint: saves {whole.ckpt.steps()}, {result['ckpt_failures']} failed")
        # no periodic saves: the fresh run only restores and steps
        fresh = _trainer(cfg, pcfg, "cuda", **{**kw, "checkpoint_every": 0})
        t0 = time.perf_counter()
        params, opt_state = fresh.init_state()
        tree, step = fresh.ckpt.restore({"params": params, "opt": opt_state}, step=2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(step == 2 and fresh.ckpt.extra(2) == {"step": 2}, f"restored step {step}")
        params = fresh._trainable(tree["params"])
        fresh.compile(params, tree["opt"])
        params, opt_state, step = fresh._run_span(params, tree["opt"], 2, 4)
    finally:
        torch.use_deterministic_algorithms(False)
    want = [(m["loss"], m["grad_norm"]) for m in result["metrics"][2:]]
    got = [(m["loss"], m["grad_norm"]) for m in fresh.metrics_history]
    check(got == want, f"train_checkpoint: resumed steps 3-4 {got} != {want}")
    same = all(torch.equal(a, b) for a, b in zip(
        flatten((params, opt_state))[0], flatten((whole.params, whole.opt_state))[0]))
    check(same, "train_checkpoint: resumed state differs from the uninterrupted run's")
    ckpt_bytes = sum(f.stat().st_size for f in (ckpt_dir / "step_00000002").iterdir())
    row = {"config": "phi4_mini_3_8b 2 layers", "d_model": cfg.d_model, "seq": TRAIN_SEQ,
           "batch": TRAIN_BATCH, "losses": [m["loss"] for m in result["metrics"]],
           "resumed_equal_bitwise": True, "checkpoint_gb": ckpt_bytes / 1e9,
           "uninterrupted_run_s": whole_s, "restore_s": restore_s,
           "step_s": [m["duration_s"] for m in result["metrics"]],
           "device": RESULTS["device"]["nvidia_smi"]}
    log_row(row)
    RESULTS["train_checkpoint"] = row
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del whole, fresh, params, opt_state, tree
    _free()


# the elastic phase: phi4-mini at full width and ELASTIC_LAYERS layers (a
# full-depth fp32 state would write ~46 GB a save), b TRAIN_BATCH x
# TRAIN_SEQ, ELASTIC_STEPS steps; the epoch transition (a grow by no
# members) before step ELASTIC_GROW_AT + 1, the eviction before step
# ELASTIC_EVICT_AT + 1; memory after the transition within
# ELASTIC_MEMORY_RTOL of before it
ELASTIC_LAYERS, ELASTIC_STEPS, ELASTIC_GROW_AT, ELASTIC_EVICT_AT = 2, 4, 2, 2
ELASTIC_MEMORY_RTOL = 0.01


def _memory() -> dict:
    """Device memory allocated and reserved, the cache's free blocks
    returned first (what a graph's released pool gives back shows)."""

    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved()}


def phase_elastic():
    """The elastic epochs on the NCCL world of one (``core/epoch.py``),
    phi4-mini at full width and 2 layers, b 2 x 2048, fp32 moments, with
    PyTorch's deterministic algorithms:

    (a) ``Trainer(persistent=False)``, 4 eager steps, bit for bit the graph
        ``Trainer``'s (losses and grad norms), flash launched 2 x layers a
        step, no step request;
    (b) one epoch transition of the graph ``Trainer``, a grow by no members
        before step 3 (``CommEpoch.grow`` of an empty group advances the
        generation over the same pool): the old epoch raises
        ``ERR_REVOKED``, its graph is released, device memory (allocated
        and reserved, the cache emptied) after the successor's capture is
        within 1% of before the transition, ``trace:train_step`` counts 2
        builds and the successor captures once; the losses are the
        uninterrupted run's, bit for bit.  The transition's own time and
        the two capturing steps' times are logged;
    (c) ``FaultInjector.evict_rank(2, 0)``, the only rank evicted before
        step 3, raises ``ERR_PROC_FAILED`` with the step's graph released
        and the epoch revoked; so does ``train --evict-at 2:0`` on the
        smoke model;
    (d) the phase's wall time, steps and peak beside the card."""

    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.core import errors, tool
    from repro_torch.launch import train as launch
    from repro_torch.runtime.faults import FaultInjector

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(base.get_config("phi4_mini_3_8b"), num_layers=ELASTIC_LAYERS)
    pcfg = base.get_parallel("phi4_mini_3_8b")
    kw = dict(steps=ELASTIC_STEPS, seq=TRAIN_SEQ, batch=TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        graph = _trainer(cfg, pcfg, "cuda", **kw)
        uninterrupted = [(m["loss"], m["grad_norm"]) for m in graph.run()["metrics"]]
        capture_s = graph.metrics_history[1]["duration_s"]
        check(graph._request.captured == 1, f"elastic: {graph._request.captured} captures")
        del graph
        _free()

        # (a) the eager step
        _reset_launches()
        eager = _trainer(cfg, pcfg, "cuda", persistent=False, **kw)
        eager_result = eager.run()
        launches = _launches()
        eager_losses = [(m["loss"], m["grad_norm"]) for m in eager_result["metrics"]]
        check(eager._request is None, "elastic: the eager trainer built a step request")
        check(eager_losses == uninterrupted,
              f"elastic: eager steps {eager_losses} != the graph steps {uninterrupted}")
        for k, n in launches.items():
            want = 2 * ELASTIC_LAYERS * ELASTIC_STEPS if k == "flash_attention_fwd" else 0
            check(n == want, f"elastic: eager {k} launches {n}, want {want}")
        del eager
        _free()

        # (b) one transition: a grow by no members
        seen = {}
        moved = _trainer(cfg, pcfg, "cuda",
                         injector=FaultInjector().admit_rank(ELASTIC_GROW_AT), **kw)

        def grow(count, params, opt_state):
            seen["old"], seen["request"] = moved.epoch, moved._request
            seen["before"] = _memory()
            t0 = time.perf_counter()
            out = moved._admit((), params, opt_state)
            seen["transition_s"] = time.perf_counter() - t0
            return out

        moved._grow = grow
        builds = tool.pvar_read()["trace:train_step"]
        moved_result = moved.run()
        builds = tool.pvar_read()["trace:train_step"] - builds
        after = _memory()
        moved_losses = [(m["loss"], m["grad_norm"]) for m in moved_result["metrics"]]
        old, old_request = seen["old"], seen["request"]
        try:
            old.comm
            revoked = False
        except errors.RevokedError:
            revoked = True
        before = seen["before"]
        drift = {k: after[k] / before[k] - 1 for k in before}
        row = {"config": f"phi4_mini_3_8b {ELASTIC_LAYERS} layers", "seq": TRAIN_SEQ,
               "batch": TRAIN_BATCH, "steps": ELASTIC_STEPS, "losses": moved_losses,
               "eager_equal_graph_bitwise": True, "eager_step_s":
               [m["duration_s"] for m in eager_result["metrics"]],
               "graph_step_s": [m["duration_s"] for m in moved_result["metrics"]],
               "epoch_0_capture_step_s": capture_s,
               "epoch_1_capture_step_s": moved.metrics_history[ELASTIC_GROW_AT + 1]["duration_s"],
               "transition_s": seen["transition_s"], "builds": builds,
               "epoch": moved_result["epoch"], "old_epoch_revoked": revoked,
               "old_graph_released": old_request._graph is None,
               "memory_before_b": before, "memory_after_b": after, "memory_drift": drift,
               "launches_eager": launches}
        check(revoked, "elastic: the old epoch's communicator is still live")
        check(old_request._graph is None, "elastic: the old epoch's graph was not released")
        check(moved_result["epoch"] == 1 and builds == 2 and moved._request is not old_request
              and moved._request.captured == 1 and old_request.captured == 1,
              f"elastic: epoch {moved_result['epoch']}, {builds} builds, captures "
              f"{old_request.captured} + {moved._request.captured}")
        check(all(abs(d) <= ELASTIC_MEMORY_RTOL for d in drift.values()),
              f"elastic: device memory {after} after the transition, {before} before it")
        check(moved_losses == uninterrupted,
              f"elastic: steps across the transition {moved_losses} != {uninterrupted}")
        del moved, old, old_request, seen
        _free()

        # (c) evicting the only rank
        evicted = _trainer(cfg, pcfg, "cuda",
                           injector=FaultInjector().evict_rank(ELASTIC_EVICT_AT, 0), **kw)
        klass = None
        try:
            evicted.run()
        except errors.Error as e:
            klass = e.klass
        check(klass is errors.ErrorClass.ERR_PROC_FAILED,
              f"elastic: evicting the only rank raised {klass}")
        check(evicted.epoch.revoked and evicted._request.captured == 1
              and evicted._request._graph is None,
              "elastic: the evicted rank's step graph is still alive")
        del evicted
        _free()
        cli = None
        try:
            launch.run(["--arch", "phi4_mini_3_8b", "--smoke", "--steps", "3", "--batch", "2",
                        "--seq", "64", "--evict-at", f"{ELASTIC_EVICT_AT}:0"])
        except errors.Error as e:
            cli = e.klass
        check(cli is errors.ErrorClass.ERR_PROC_FAILED,
              f"elastic: train --evict-at {ELASTIC_EVICT_AT}:0 raised {cli}")
        _free()
    finally:
        torch.use_deterministic_algorithms(False)
    row.update(evict_only_rank="ERR_PROC_FAILED", cli_evict="ERR_PROC_FAILED",
               phase_s=time.perf_counter() - t_phase,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               device=RESULTS["device"]["nvidia_smi"])
    log_row(row)
    RESULTS["elastic"] = row
    return "elastic", launches


def _moment_pieces(params) -> int:
    """The int8 moments' pieces of whole rows in one AdamW update of
    ``params`` (``optim.adamw``: at most ``PIECE`` elements, at least one
    row a piece; a 0-d leaf has none): each takes one dequantize and one
    quantize a moment."""

    from repro_torch.core.futures import flatten
    from repro_torch.optim.clip import PIECE

    n = 0
    for p in flatten(params)[0]:
        if p.ndim:
            rows, width = p.numel() // p.shape[-1], p.shape[-1]
            n += -(-rows // max(1, PIECE // width))
    return n


def phase_train(arch, layers, d_model, kernel, moments, ring=False):
    """``arch`` at its full config trains ``TRAIN_STEPS`` steps at b
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` through ``Trainer`` (remat full,
    ``moments`` the moments' dtype), its steps replaying one CUDA graph from
    step 2: losses and grad norms equal to the eager steps'
    (``_eager_train``) bit for bit, parameters changed, the kernel launched
    exactly twice per layer and step (and with int8 moments the quantize
    and the dequantize twice a moment piece and step, ``_moment_pieces``);
    step time, tokens/s and peak memory of both runs are logged beside the
    card (an int8 run beside the same arch's fp32 run, where there is one),
    and one warm step is profiled.

    ``ring``: the ring plan's attention (``pcfg.ring_attention``) on the
    NCCL world of one — a ring of one, which bypasses the rotation: the
    ring-step kernel runs every layer's attention, forward and remat's
    recompute, and its backward recomputes through the plain ring.  The
    losses and the first grad norm are held within ``TRAIN_RING_RTOL`` of
    the flash run's (``train_<arch>``, the same weights and batches), and
    its step time and peak are logged beside them."""

    import dataclasses
    import math

    import torch

    from repro_torch.configs import base
    from repro_torch.core.futures import flatten

    cfg = base.get_config(arch)
    if arch in TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS[arch])
    pcfg = dataclasses.replace(base.get_parallel(arch), moment_dtype=moments,
                               ring_attention=ring)
    check(cfg.num_layers == layers and cfg.d_model == d_model,
          f"not the {arch} config at {layers} layers")
    path = f"train_{arch}" + ("_int8" if moments == "int8" else "") + ("_ring" if ring else "")
    if ring:
        kernel = RING
    eager = _eager_train(cfg, pcfg)
    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(cfg, pcfg, "cuda", steps=TRAIN_STEPS, seq=TRAIN_SEQ, batch=TRAIN_BATCH)
    seen = _capture_init(trainer)
    _reset_launches()
    t0 = time.perf_counter()
    with _counting_records() as recorded:
        result = trainer.run()
    wall = time.perf_counter() - t0
    launches = _launches()
    # the step's program: recorded once, at the capture (step 2), never at
    # the eager step 1 or a replay; its kernel ops are the capture's launches
    step_recordings = sum(fn is trainer._request._fn for fn in recorded)
    check(step_recordings == 1, f"{path}: the step's program recorded {step_recordings} times "
                                f"in {TRAIN_STEPS} steps")
    program = _program_against_capture(path, trainer._request)
    program.update(trainer._request.cost_analysis())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics = result["metrics"]
    # the encoder-decoder runs the kernel in its encoder's layers too; the
    # leading dense layers are not rematted (as in the reference): once
    per_step = {kernel: 2 * (cfg.num_layers + cfg.encoder_layers) - cfg.first_dense_layers}
    if moments == "int8":
        pieces = _moment_pieces(trainer.params)
        per_step.update({QUANT: 2 * pieces, DEQUANT: 2 * pieces})
    for name, n in launches.items():
        want = per_step.get(name, 0) * TRAIN_STEPS
        check(n == want, f"{path}: {name} launches {n}, want {want}")
    check(len(metrics) == TRAIN_STEPS and all(math.isfinite(m["loss"])
                                              and math.isfinite(m["grad_norm"])
                                              for m in metrics), f"{path}: {metrics}")
    n_leaves = len(flatten(trainer.params)[0])
    changed = _changed_leaves(seen, trainer.params)
    check(changed == n_leaves, f"{path}: {n_leaves - changed} of {n_leaves} parameter leaves "
                               f"unchanged after {TRAIN_STEPS} steps")
    warm_s = [m["duration_s"] for m in metrics[1:]]
    step_s = sorted(warm_s)[len(warm_s) // 2]
    losses = [(m["loss"], m["grad_norm"]) for m in metrics]
    row = {"arch": arch, "moments": moments, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "params_b": cfg.param_count() / 1e9, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
           "step_s": [m["duration_s"] for m in metrics], "warm_step_s": step_s,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "peak_mem_gb": peak_gb,
           "wall_s_init_included": wall, "launches": launches,
           "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items() if n},
           f"{kernel}_per_step": launches[kernel] / TRAIN_STEPS, "leaves_changed": changed,
           "graph_captures": trainer._request.captured, "program": program,
           "capture_step_s": metrics[1]["duration_s"],
           "losses_equal_eager_bitwise": losses == eager["losses"], "eager": eager,
           "device": RESULTS["device"]["nvidia_smi"]}
    fp32 = RESULTS.get("train", {}).get(f"train_{arch}")
    if ring:
        check(fp32 is not None, f"{path}: no flash run of {arch} to hold the ring against")
        row["bypasses"] = "the rotation: a ring of one (one rank), no KV exchange"
        row["beside_flash"] = {
            "warm_step_s": [fp32["warm_step_s"], step_s],
            "tokens_per_s": [fp32["tokens_per_s"], row["tokens_per_s"]],
            "peak_mem_gb": [fp32["peak_mem_gb"], peak_gb],
            "losses": [fp32["losses"], row["losses"]],
            "grad_norm_1": [fp32["grad_norms"][0], row["grad_norms"][0]]}
        for a, b in zip(row["losses"] + row["grad_norms"][:1],
                        fp32["losses"] + fp32["grad_norms"][:1]):
            check(abs(a - b) <= TRAIN_RING_RTOL * abs(b),
                  f"{path}: (losses, grad norm 1) {row['beside_flash']} apart by more than "
                  f"{TRAIN_RING_RTOL} relative")
    if moments == "int8" and fp32 is not None:
        row["beside_fp32_moments"] = {
            "warm_step_s": [fp32["warm_step_s"], step_s],
            "peak_mem_gb": [fp32["peak_mem_gb"], peak_gb],
            "eager_peak_mem_gb": [fp32["eager"]["peak_mem_gb"], eager["peak_mem_gb"]],
            "step_ratio_int8_over_fp32": step_s / fp32["warm_step_s"]}
    log_row(row)
    check(trainer._request.captured == 1, f"{path}: {trainer._request.captured} graph captures")
    check(losses == eager["losses"], f"{path}: graph steps' (loss, grad norm) {losses} != the "
                                     f"eager steps' {eager['losses']}")
    check(peak_gb < 80, f"{path}: peak {peak_gb} GB")
    check(trainer.opt_state.step.item() == TRAIN_STEPS, f"{path}: optimizer step count")
    batch = trainer._batch(TRAIN_STEPS)
    row["profile_step"] = _profile(lambda: trainer._compiled(trainer.params, trainer.opt_state,
                                                             batch))
    RESULTS.setdefault("train", {})[path] = row
    del trainer, seen, batch
    _free()
    return path, launches


def phase_train_pipeline():
    """The full phi4-mini (32 layers) through ``make_pipeline_train_step``
    on a (data 1, stage 1) cart of the NCCL world of one, which bypasses
    every exchange (no stage boundary, no data average):
    ``PIPELINE_MICROBATCHES`` microbatches of 1 x ``TRAIN_SEQ``, fp32
    moments, remat full, ``TRAIN_STEPS`` eager steps from the data-plan
    trainer's init and batches.  Losses and grad norms within
    ``TRAIN_PIPELINE_RTOL`` relative of the data plan's
    (``train_phi4_mini_3_8b``: the mean of two equal microbatches' token
    means is the batch's), flash launched microbatches x layers x 2 times a
    step and nothing else; step time and peak beside the data plan's eager
    steps."""

    import dataclasses
    import math

    import torch

    from repro_torch.configs import base
    from repro_torch.configs.base import ParallelPlan
    from repro_torch.core import topology
    from repro_torch.runtime.trainer import make_pipeline_train_step

    arch, path = "phi4_mini_3_8b", "train_phi4_mini_3_8b_pipeline"
    data = RESULTS["train"][f"train_{arch}"]
    cfg = base.get_config(arch)
    pcfg = dataclasses.replace(base.get_parallel(arch), moment_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(cfg, pcfg, "cuda", steps=TRAIN_STEPS, seq=TRAIN_SEQ, batch=TRAIN_BATCH)
    cart = topology.cart_create(trainer.comm, (1, 1), (False, False),
                                axis_names=("data", "stage"), tag="pipeline/cart/1x1")
    params, opt_state = trainer.init_state()
    step = make_pipeline_train_step(trainer.cfg, trainer.pcfg, trainer.tcfg, trainer.opt, cart,
                                    plan=ParallelPlan(microbatches=PIPELINE_MICROBATCHES))
    losses, step_s = [], []
    _reset_launches()
    for i in range(TRAIN_STEPS):
        batch = trainer._batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {"flash_attention_fwd": PIPELINE_MICROBATCHES * cfg.num_layers * 2}
    for name, n in launches.items():
        want = per_step.get(name, 0) * TRAIN_STEPS
        check(n == want, f"{path}: {name} launches {n}, want {want}")
    check(all(math.isfinite(x) for pair in losses for x in pair), f"{path}: {losses}")
    warm = sorted(step_s[1:])[(len(step_s) - 1) // 2]
    row = {"arch": arch, "layers": cfg.num_layers, "cart": [1, 1],
           "microbatches": PIPELINE_MICROBATCHES, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "bypasses": "every exchange: one stage and one data rank (no stage shift, no "
                       "stage sum, no data average)",
           "losses": [x for x, _ in losses], "grad_norms": [g for _, g in losses],
           "step_s": step_s, "warm_step_s": warm, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / warm,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items() if n},
           "beside_data_plan": {
               "losses": [data["losses"], [x for x, _ in losses]],
               "grad_norms": [data["grad_norms"], [g for _, g in losses]],
               "eager_warm_step_s": [data["eager"]["warm_step_s"], warm],
               "eager_peak_mem_gb": [data["eager"]["peak_mem_gb"], peak_gb]},
           "device": RESULTS["device"]["nvidia_smi"]}
    log_row(row)
    for (a, g), b, h in zip(losses, data["losses"], data["grad_norms"]):
        check(abs(a - b) <= TRAIN_PIPELINE_RTOL * abs(b) and
              abs(g - h) <= TRAIN_PIPELINE_RTOL * abs(h),
              f"{path}: {row['beside_data_plan']} apart by more than {TRAIN_PIPELINE_RTOL}")
    RESULTS.setdefault("train", {})[path] = row
    del trainer, params, opt_state, metrics, step, batch
    _free()
    return path, launches


# phase grad_sync: phi4-mini at full width, depth cut to this many layers
# (the embedding, 200,064 x 3,072, is its largest leaf at any depth)
GRAD_SYNC_LAYERS = 2


def _grad_sync_call(sync, grads, ef, plain: bool):
    """One ``sync(grads, ef)`` on the card → (result, new residual,
    launches, seconds); with ``plain``, the quant ops' row functions are
    their plain versions for the call (``kernels/quant/ops.py`` looks them
    up at each call), so the same call runs without the kernels."""

    import torch

    from repro_torch.kernels.quant import ops, ref

    saved = ops.quantize_int8_rows, ops.dequantize_int8_rows
    if plain:
        ops.quantize_int8_rows, ops.dequantize_int8_rows = (ref.quantize_int8_rows,
                                                            ref.dequantize_int8_rows)
    try:
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        out, new_ef = sync(grads, ef)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches()
    finally:
        ops.quantize_int8_rows, ops.dequantize_int8_rows = saved
    return out, new_ef, launches, seconds


def phase_grad_sync():
    """``PartitionedGradSync(inner, outer, compression=INT8)`` with error
    feedback on the NCCL world of one, folded 1 x 1 onto ("outer",
    "inner"), over a phi4-mini gradient tree at full width
    (``GRAD_SYNC_LAYERS`` layers): bf16 leaves of the parameters' shapes
    from numpy seed 0, and a residual from a first call.  The second call's
    result and residual equal, bit for bit, the same call with the plain
    row functions on the same values, and the residual is m - C(m) (m = g +
    e, C the flat quantize and dequantize); one quantize and one dequantize
    launch a leaf; two ``pready`` orders over two buckets (the norms'
    gradients in fp32) give bit-equal results.  The world of one skips the
    int8 cross-pod stage (``outer.size() == 1``, as in the reference: the
    gloo tests hold it).  The call and its error-feedback share are timed."""

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.core import compress, datatypes
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.descriptors import Compression
    from repro_torch.core.futures import flatten, unflatten
    from repro_torch.core.session import default_session
    from repro_torch.models import api as model_api
    from repro_torch.optim import ErrorFeedbackState, PartitionedGradSync
    from repro_torch.optim.grad_sync import _compress_with_feedback

    cfg = dataclasses.replace(base.get_config("phi4_mini_3_8b"), num_layers=GRAD_SYNC_LAYERS)
    with torch.no_grad():
        params = model_api.build(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    leaves, treedef = flatten(params)
    shapes = [tuple(p.shape) for p in leaves]
    del params, leaves
    _free()
    rng = np.random.default_rng(0)

    def draw():
        return unflatten(treedef, [
            torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(
                torch.bfloat16) for shape in shapes])

    sess = default_session(device_type="cuda")
    comm = Communicator.from_group(sess.group("repro://world"), tag="repro://world",
                                   shape=(1, 1), axis_names=("outer", "inner"))
    inner, outer = comm.split("inner"), comm.split("outer")
    sync = PartitionedGradSync(inner, outer, compression=Compression.INT8)
    log(f"grad_sync: outer.size() == {outer.size()}: the int8 cross-pod stage is skipped on "
        f"the world of one (the gloo tests hold it)")
    first = draw()
    _, ef, _, first_s = _grad_sync_call(sync, first, ErrorFeedbackState.init(first), False)
    del first
    grads = draw()
    out, new_ef, launches, call_s = _grad_sync_call(sync, grads, ef, False)
    pout, pef, plain_launches, plain_s = _grad_sync_call(sync, grads, ef, True)
    n = len(shapes)
    check({k: v for k, v in launches.items() if v} == {QUANT: n, DEQUANT: n}
          and not any(plain_launches.values()),
          f"grad_sync: launches {launches} (want one quantize and one dequantize a leaf, "
          f"{n} leaves), plain call {plain_launches}")
    err = 0.0
    for a, b in zip(flatten((out, new_ef.residual))[0], flatten((pout, pef.residual))[0]):
        err = max(err, _bit_equal("grad_sync against the plain rows", a, b))
    del pout, pef
    for g, e, r in zip(flatten(grads)[0], flatten(ef.residual)[0],
                       flatten(new_ef.residual)[0]):
        m = g.float() + e
        q, sc, pad = compress.quantize_int8(m)
        _bit_equal("grad_sync residual m - C(m)", r,
                   m - compress.dequantize_int8(q, sc, pad, m.shape, torch.float32))
    del out, new_ef, m
    _free()
    # the error-feedback share of the call: every leaf's compression alone
    t0 = time.perf_counter()
    for g, e in zip(flatten(grads)[0], flatten(ef.residual)[0]):
        _compress_with_feedback(g, e)
    torch.cuda.synchronize()
    ef_s = time.perf_counter() - t0
    # two buckets: the norms' gradients (a d_model vector a layer) in fp32
    mixed = unflatten(treedef, [
        g.float() if g.shape[-1] == cfg.d_model and g.numel() <= cfg.num_layers * cfg.d_model
        else g for g in flatten(grads)[0]])
    check(len(datatypes.pack(mixed)[0]) == 2, "grad_sync: the mixed tree is not two buckets")
    nosync = PartitionedGradSync(inner, outer, compression=Compression.NONE)
    a, _ = nosync(mixed, None, pready_order=(0, 1))
    b, _ = nosync(mixed, None, pready_order=(1, 0))
    for x, y in zip(flatten(a)[0], flatten(b)[0]):
        _bit_equal("grad_sync pready orders", x, y)
    row = {"config": f"phi4_mini_3_8b {GRAD_SYNC_LAYERS} layers", "leaves": n,
           "grad_elements": sum(math.prod(sh) for sh in shapes),
           "launches": launches, "bit_equal_plain": True, "residual_is_m_minus_Cm": True,
           "orders_bit_equal": True, "first_call_s": first_s, "call_s": call_s,
           "plain_call_s": plain_s, "ef_share_s": ef_s, "max_abs_err": err,
           "device": RESULTS["device"]["nvidia_smi"]}
    log_row(row)
    RESULTS["grad_sync"] = row
    del grads, ef, mixed, a, b
    _free()
    return "grad_sync_phi4_mini", launches


# the tuner (repro_torch.tune, the H100's roofline): the device counts of
# its sweep over every applicable (arch x SHAPES) cell, the arch it tunes on
# the card, and serve --plan auto's depth (cut, widths full) and requests
TUNE_DEVICES = (1, 4, 8)
TUNE_ARCH = "phi4_mini_3_8b"
TUNE_SERVE_LAYERS, TUNE_SERVE_PROMPT, TUNE_SERVE_REQUESTS = 8, 2048, 2


def _tune_sweep(session) -> dict:
    """The tuner's verdict on every applicable (arch x shape) cell of
    ``SHAPES`` on each of ``TUNE_DEVICES`` cards (one slice, nothing
    registered): the winner's slug, predicted step and peak, and the
    candidates scored."""

    from repro_torch import tune
    from repro_torch.configs import base

    out = {}
    for arch in base.ARCHITECTURES:
        cfg = base.get_config(arch)
        for name, shape in base.SHAPES.items():
            if not base.shape_applicable(cfg, shape)[0]:
                continue
            for n in TUNE_DEVICES:
                r = tune.tune(arch, shape, n, slices=1, register=False, session=session)
                out[f"{arch} {name} {n}"] = {
                    "plan": r.plan.slug(), "step_s": r.score.step_s,
                    "peak_gb": r.score.peak_bytes / 1e9, "fits": r.score.fits,
                    "candidates": r.n_candidates}
    return out


def phase_tune():
    """The tuner on the card.  The sweep (``_tune_sweep``) twice, equal,
    its time and winners on one line.  ``train --plan auto``: the plan
    ``launch.train.resolve_plan`` tunes for the full phi4-mini at b
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` on this one card trains
    ``TRAIN_STEPS`` steps through ``Trainer`` (step 1 eager, one graph
    from step 2): flash launched once a layer and step if the winner's
    remat is none (the backward recomputes through the plain version),
    twice otherwise; the first loss bit for bit the data-plan phase's
    (``train_phi4_mini_3_8b``: the same seed and batch); the winner's
    predicted step and peak logged beside the warm step and
    ``torch.cuda.max_memory_allocated``.  ``serve --plan auto``: phi4-mini
    at full width and ``TUNE_SERVE_LAYERS`` layers through
    ``launch.serve.run`` (the one-card winner d1), tokens bit for bit the
    plain ``Server``'s on the same prompts, flash once a layer a prefill."""

    import dataclasses

    import numpy as np
    import torch

    from repro_torch import tune
    from repro_torch.configs import base
    from repro_torch.core.session import default_session
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Server, ServerConfig

    session = default_session()
    t0 = time.perf_counter()
    sweeps = [_tune_sweep(session) for _ in range(2)]
    sweep_s = time.perf_counter() - t0
    check(sweeps[0] == sweeps[1], "tune: two sweeps of the same cells disagree")
    log(json.dumps({"tune_sweep": {"cells": len(sweeps[0]), "two_sweeps_s": sweep_s,
                                   "winners": {k: v["plan"] for k, v in sweeps[0].items()}}}))
    row = {"sweep": sweeps[0], "two_sweeps_s": sweep_s}
    launches = {}

    # train --plan auto
    cfg, pcfg = base.get_config(TUNE_ARCH), base.get_parallel(TUNE_ARCH)
    args = train._parser().parse_args(["--arch", TUNE_ARCH, "--plan", "auto", "--batch",
                                       str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)])
    plan = train.resolve_plan(args, cfg, session.group().size())
    shape = base.ShapeConfig(f"train_{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")
    predicted = tune.tune(TUNE_ARCH, shape, 1, config=cfg, space=base.plan_space(TUNE_ARCH),
                          register=False, session=session)
    check(predicted.plan == plan, f"tune: {predicted.plan} against the CLI's {plan}")
    remat = plan.remat if plan.remat is not None else pcfg.remat
    path = f"tune_train_{TUNE_ARCH}"
    _free()
    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(cfg, pcfg, "cuda", steps=TRAIN_STEPS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                       plan=plan)
    _reset_launches()
    result = trainer.run()
    launches[path] = _launches()
    peak = torch.cuda.max_memory_allocated()
    metrics = result["metrics"]
    warm = sorted(m["duration_s"] for m in metrics[1:])[(len(metrics) - 1) // 2]
    per_step = {"flash_attention_fwd": cfg.num_layers * (1 if remat == "none" else 2)}
    data_plan = RESULTS["train"][f"train_{TUNE_ARCH}"]
    row["train"] = {
        "plan": plan.slug(), "remat": remat, "candidates": predicted.n_candidates,
        "predicted": predicted.score.as_dict(), "losses": [m["loss"] for m in metrics],
        "grad_norms": [m["grad_norm"] for m in metrics],
        "step_s": [m["duration_s"] for m in metrics], "warm_step_s": warm,
        "max_memory_allocated": peak, "card_bytes": torch.cuda.get_device_properties(0).total_memory,
        "measured_over_predicted_step": warm / predicted.score.step_s,
        "measured_over_predicted_peak": peak / predicted.score.peak_bytes,
        "data_plan_first_loss": data_plan["losses"][0],
        "data_plan_warm_step_s": data_plan["warm_step_s"],
        "data_plan_peak_gb": data_plan["peak_mem_gb"], "launches": launches[path],
        "graph_captures": trainer._request.captured,
        "program": _program_against_capture(path, trainer._request)
        | trainer._request.cost_analysis()}
    log_row({"tune_train": row["train"]})
    for name, n in launches[path].items():
        want = per_step.get(name, 0) * TRAIN_STEPS
        check(n == want, f"{path}: {name} launches {n}, want {want} (remat {remat})")
    check(trainer._request.captured == 1, f"{path}: {trainer._request.captured} captures")
    check(all(math.isfinite(m["loss"]) for m in metrics), f"{path}: {metrics}")
    check(metrics[0]["loss"] == data_plan["losses"][0],
          f"{path}: first loss {metrics[0]['loss']} against the data plan's "
          f"{data_plan['losses'][0]}")
    del trainer, result
    _free()

    # serve --plan auto, at full width and a cut depth
    small = dataclasses.replace(cfg, num_layers=TUNE_SERVE_LAYERS)
    get_config = base.get_config
    base.get_config = lambda arch: small if arch == TUNE_ARCH else get_config(arch)
    try:
        _reset_launches()
        server, tokens, stats = serve.run(
            ["--arch", TUNE_ARCH, "--plan", "auto", "--requests", str(TUNE_SERVE_REQUESTS),
             "--prompt-len", str(TUNE_SERVE_PROMPT), "--new-tokens", str(NEW_TOKENS)])
        path = f"tune_serve_{TUNE_ARCH}"
        launches[path] = _launches()
    finally:
        base.get_config = get_config
    served = tune.tune(TUNE_ARCH, base.ShapeConfig(f"prefill_{TUNE_SERVE_PROMPT}",
                                                   TUNE_SERVE_PROMPT, TUNE_SERVE_REQUESTS,
                                                   "prefill"),
                       1, config=small, space=base.plan_space(TUNE_ARCH), register=False,
                       session=session)
    grid = tuple(server.comm.shape)
    del server
    _free()
    plain = Server(small, pcfg, ServerConfig(max_batch=TUNE_SERVE_REQUESTS,
                                             max_new_tokens=NEW_TOKENS),
                   make_host_communicator(device="cuda"))
    want, plain_stats = plain.generate(serve.requests(small, TUNE_SERVE_REQUESTS,
                                                      TUNE_SERVE_PROMPT))
    del plain
    _free()
    row["serve"] = {"plan": served.plan.slug(), "grid": grid, "layers": TUNE_SERVE_LAYERS,
                    "prompt_len": TUNE_SERVE_PROMPT, "predicted": served.score.as_dict(),
                    "prefill_s": stats["prefill_s"], "plain_prefill_s": plain_stats["prefill_s"],
                    "tokens_per_s": stats["tokens_per_s"],
                    "tokens_equal_plain": bool(np.array_equal(tokens, want)),
                    "launches": launches[path]}
    log_row({"tune_serve": row["serve"]})
    check(served.plan.slug() == "d1" and grid == (1, 1), f"{path}: plan {row['serve']}")
    check(row["serve"]["tokens_equal_plain"], f"{path}: tokens differ from the plain server's")
    for name, n in launches[path].items():
        want_n = TUNE_SERVE_LAYERS if name == "flash_attention_fwd" else 0
        check(n == want_n, f"{path}: {name} launches {n}, want {want_n}")
    RESULTS["tune"] = row
    return launches


DRYRUN_ARCH = "phi4_mini_3_8b"
#: qwen1.5-32b's serve at 2 x 4096 on four cards (ROADMAP C22)
QWEN_SERVE = ("qwen1_5_32b", 4096, 2, 4)
#: the dry run's cells, each a ``python -m repro_torch.launch.dryrun`` of
#: its own (a process holds one fake world): the pod cell, the ``tune``
#: phase's cell on a grid of one (the winner's remat, none) with the
#: tuner's prediction, and qwen1.5-32b's 2 x 4096 prefill on four cards as
#: ``d4`` (the plan C22 ran out of memory on) and on the grid ``serve --plan
#: auto`` tunes (``_qwen_grid``)
DRYRUN_CELLS = {
    "pod": ["--arch", DRYRUN_ARCH, "--shape", "train_4k"],
    "tune_cell": ["--arch", DRYRUN_ARCH, "--shape", f"train_{TRAIN_SEQ}", "--batch",
                  str(TRAIN_BATCH), "--grid", "1x1", "--overrides", '{"remat": "none"}',
                  "--plan", "auto"],
    "qwen_d4": ["--arch", QWEN_SERVE[0], "--shape", f"prefill_{QWEN_SERVE[1]}", "--batch",
                str(QWEN_SERVE[2]), "--grid", f"{QWEN_SERVE[3]}x1", "--plan", "data=4"],
    # a cell of each class that failed on torch 2.11 before ROADMAP C26's
    # repair: E2 (the ring buffer's roll), E1 (a flatten of split heads in
    # the decode attention), E3 (the MoE counts over split rows)
    "c26_e2": ["--arch", "gemma2_9b", "--shape", "prefill_32k"],
    "c26_e1": ["--arch", "granite_3_8b", "--shape", "decode_32k"],
    "c26_e3": ["--arch", "deepseek_v2_236b", "--shape", "prefill_32k"],
}
DRYRUN_LIMIT_S = 300
# the cells' processes at once: every cell (host work, one thread each;
# the card's machine has 8 cores)
DRYRUN_JOBS = 7
# qwen's tuned cell: its traced peak within this factor of the tuner's
# prediction either way (ROADMAP C27)
QWEN_PEAK_FACTOR = 1.25


def _qwen_grid() -> str:
    """``DxM`` of the grid ``serve --plan auto`` folds qwen1.5-32b's 2 x
    4096 serve onto four cards (``launch/serve.py``)."""

    from repro_torch import tune
    from repro_torch.configs import base

    arch, seq, batch, devices = QWEN_SERVE
    plan = tune.search(base.get_config(arch), base.ShapeConfig(f"prefill_{seq}", seq, batch,
                                                               "prefill"),
                       devices, space=base.plan_space(arch),
                       default_remat=base.get_parallel(arch).remat).plan
    d, m = (plan.fold_dims() + (1,))[:2]
    return f"{d}x{m}"


def _dryrun_record(name: str, args: list, out: Path) -> dict:
    """Run one cell of the dry run (host work on fake tensors: no kernel
    launches, and only a CUDA context on the card) into ``out``; its
    record."""

    from repro_torch.launch import dryrun

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--device", "cuda",
             "--artifacts", str(out)],
            capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=DRYRUN_LIMIT_S)
        rc, text = proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, text = None, f"{e.stdout or ''}{e.stderr or ''}"
    check(rc == 0, f"dryrun {name}: exit {rc}\n{text[-3000:]}")
    opt = dict(zip(args[::2], args[1::2]))
    tag = dryrun.cell_tag(opt.get("--plan"), opt.get("--tag", ""))
    rec = json.loads(dryrun.artifact_path(opt["--arch"], opt["--shape"], False, tag,
                                          grid=opt.get("--grid"), artifacts=out).read_text())
    check(rec["status"] == "ok", f"dryrun {name}: {rec}")
    return rec


def phase_dryrun():
    """The dry run (``repro_torch.launch.dryrun``) with stand-ins on the
    card's device type, each cell in a process of its own, ``DRYRUN_JOBS``
    at a time: phi4-mini ``train_4k`` on the fake ``pod_16x16`` world (256
    ranks): its trace time, peak a card against ``HBM_BYTES``, dominant term
    and useful-flops ratio; phi4-mini at b ``TRAIN_BATCH`` x ``TRAIN_SEQ`` on
    a grid of one (the ``tune`` phase's cell and plan): its traced peak and
    compute term beside the tuner's prediction and the ``tune`` phase's
    measured ``max_memory_allocated`` and warm step; and qwen1.5-32b's 2 x
    4096 prefill on four cards as ``d4``, which the tuner must predict over
    ``HBM_BYTES`` and at no less than its traced peak, and on the grid of ``serve --plan
    auto``'s winner, which must not be ``d4`` and whose traced peak must
    fit the card (C22) and lie within ``QWEN_PEAK_FACTOR`` of the tuner's
    prediction (C27); and one formerly failing cell of each of C26's
    classes (gemma2 ``prefill_32k``, granite ``decode_32k``, deepseek
    ``prefill_32k``), which must trace.  ``tune.load_calibration`` reads the pod artifact's
    flops ratio from the run's directory, and the tuner's calibrated step
    for the ``tune`` cell is printed beside the measured one.  No kernel
    launches here."""

    import tempfile

    from repro_torch import tune
    from repro_torch.configs import base
    from repro_torch.core import tool

    card = RESULTS["device"]["nvidia_smi"]
    cells = dict(DRYRUN_CELLS)
    cells["qwen_auto"] = ["--arch", QWEN_SERVE[0], "--shape", f"prefill_{QWEN_SERVE[1]}",
                          "--batch", str(QWEN_SERVE[2]), "--grid", _qwen_grid(),
                          "--plan", "auto"]
    (ROOT / "build").mkdir(exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="dryrun_", dir=ROOT / "build"))
    with ThreadPoolExecutor(DRYRUN_JOBS) as ex:
        futures = {name: ex.submit(_dryrun_record, name, args, out)
                   for name, args in cells.items()}
        recs = {name: f.result() for name, f in futures.items()}
    pod, cell = recs["pod"], recs["tune_cell"]
    qwen_d4, qwen = recs["qwen_d4"], recs["qwen_auto"]
    for name, rec in recs.items():
        log_row({"dryrun": name, "card": card, "mesh": rec["mesh"], "chips": rec["chips"],
                 "trace_s": rec["trace_s"],
                 "peak_gb_per_card": rec["memory"]["peak_bytes_per_device"] / 1e9,
                 "peak_gb_by_category": {k: v / 1e9 for k, v
                                         in rec["memory"]["peak_by_category"].items() if v},
                 "hbm_gb": tool.HBM_BYTES / 1e9,
                 "fits": rec["memory"]["peak_bytes_per_device"] <= tool.HBM_BYTES,
                 "dominant": rec["roofline"]["dominant"],
                 "useful_flop_ratio": rec["useful_flop_ratio"],
                 "compute_s": rec["roofline"]["compute_s"],
                 "memory_s": rec["roofline"]["memory_s"],
                 "collective_s": rec["roofline"]["collective_s"],
                 "kernels_traced": rec["roofline"]["kernels"],
                 "plan": rec.get("plan_slug"),
                 "predicted_peak_gb": (rec["predicted_roofline"]["peak_bytes"] / 1e9
                                       if "predicted_roofline" in rec else None)})
    traced_gb = qwen["memory"]["peak_bytes_per_device"] / 1e9
    predicted_gb = qwen["predicted_roofline"]["peak_bytes"] / 1e9
    log(f"dryrun qwen {qwen['plan_slug']}: traced peak {traced_gb:.2f} GB a card, the "
        f"tuner's predicted peak {predicted_gb:.2f} GB")
    check(pod["chips"] == 256 and pod["roofline"]["collectives"]["total_operand_bytes"] > 0,
          f"dryrun pod: {pod['chips']} chips, no collectives")
    check(pod["roofline"]["kernels"].get("repro_torch.flash_attention_fwd", 0) > 0,
          f"dryrun pod: flash not traced: {pod['roofline']['kernels']}")
    # the tuner charges d4 more than it traces (a prefill's cache twice,
    # where the prefill holds it once since ROADMAP C27) and over the card
    check(qwen_d4["plan_slug"] == "d4"
          and qwen_d4["memory"]["peak_bytes_per_device"]
          <= qwen_d4["predicted_roofline"]["peak_bytes"]
          and not qwen_d4["predicted_roofline"]["fits"],
          f"dryrun qwen d4: traced {qwen_d4['memory']}, predicted "
          f"{qwen_d4['predicted_roofline']}")
    check(qwen["plan_slug"] != "d4" and qwen["predicted_roofline"]["fits"]
          and qwen["memory"]["peak_bytes_per_device"] <= tool.HBM_BYTES,
          f"dryrun qwen: the tuned {qwen['plan_slug']} on {qwen['mesh']} traced "
          f"{qwen['memory']}, predicted {qwen['predicted_roofline']}")
    check(1 / QWEN_PEAK_FACTOR <= traced_gb / predicted_gb <= QWEN_PEAK_FACTOR,
          f"dryrun qwen {qwen['plan_slug']}: traced {traced_gb:.2f} GB against the predicted "
          f"{predicted_gb:.2f} (C27)")
    calib = tune.load_calibration(DRYRUN_ARCH, "train_4k", out)
    check(calib.get("flops_scale") == 1.0 / pod["useful_flop_ratio"],
          f"dryrun: calibration {calib} from ratio {pod['useful_flop_ratio']}")
    cfg = base.get_config(DRYRUN_ARCH)
    shape = base.ShapeConfig(f"train_{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = base.ParallelPlan(**cell["plan"])
    calibrated = tune.score_plan(cfg, shape, plan, calibration=calib)
    measured = RESULTS.get("tune", {}).get("train", {})
    row = {
        "card": card, "plan": cell["plan_slug"],
        "calibration": calib,
        "predicted_step_s": cell["predicted_roofline"]["step_s"],
        "calibrated_step_s": calibrated.step_s,
        "measured_warm_step_s": measured.get("warm_step_s"),
        "predicted_peak_gb": cell["predicted_roofline"]["peak_bytes"] / 1e9,
        "traced_peak_gb": cell["memory"]["peak_bytes_per_device"] / 1e9,
        "measured_max_memory_allocated_gb": (measured["max_memory_allocated"] / 1e9
                                             if measured else None),
        "traced_compute_s": cell["roofline"]["compute_s"],
        "traced_memory_s": cell["roofline"]["memory_s"],
        "predicted_compute_s": cell["predicted_roofline"]["compute_s"],
        "qwen": {rec["plan_slug"]: {"grid": rec["mesh"],
                                    "predicted_peak_gb": rec["predicted_roofline"]["peak_bytes"]
                                    / 1e9,
                                    "traced_peak_gb": rec["memory"]["peak_bytes_per_device"]
                                    / 1e9}
                 for rec in (qwen_d4, qwen)},
    }
    log_row({"dryrun_tune_cell": row})
    # the program the tune phase's trainer recorded at its capture (the same
    # configuration: b TRAIN_BATCH x TRAIN_SEQ, one card, no remat) beside
    # the dry run's count of that cell
    program = measured.get("program", {})
    cost = {"card": card, "program_flops": program.get("flops"),
            "program_bytes_accessed": program.get("bytes accessed"),
            "program_ops": program.get("ops"),
            "dryrun_hlo_flops": cell["roofline"]["hlo_flops"],
            "dryrun_hlo_bytes": cell["roofline"]["hlo_bytes"]}
    if program:
        cost["flops_program_over_dryrun"] = program["flops"] / cell["roofline"]["hlo_flops"]
        cost["bytes_program_over_dryrun"] = (program["bytes accessed"]
                                             / cell["roofline"]["hlo_bytes"])
    log_row({"program_cost_against_dryrun": cost})
    row["program_cost"] = cost
    RESULTS["dryrun"] = {"cells": recs, "tune_cell": row}
    return {}


ANALYZE_LAYERS = 4
ANALYZE_PROMPT = 2048
ANALYZE_DECODE_REPS = 8
ANALYZE_EAGER_REPS = 200


def phase_analyze():
    """The analyzer on the card, under ``analysis_recording``: the full-width
    phi4-mini at ``ANALYZE_LAYERS`` layers served with the int8 cache (flash
    and the quant kernels launch), then 2 ``Trainer`` steps at b
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` (step 1 eager, step 2 captured): the
    checkers find nothing in this rank's ledger.  Then one seeded defect, a
    persistent start fired while the previous start's future is unconsumed:
    exactly one finding, ``ERR_REQUEST``.  A warm decode step (the server's
    graph replay, which runs no hook) is timed with recording on and off,
    and so is an eager immediate allreduce and its ``get``, where the hooks
    run."""

    import dataclasses

    import torch

    from repro_torch.analysis import checkers, events
    from repro_torch.configs import base
    from repro_torch.core import tool
    from repro_torch.core.communicator import world
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Server, ServerConfig

    launches = {}
    cfg = dataclasses.replace(base.get_config(DRYRUN_ARCH), num_layers=ANALYZE_LAYERS)
    pcfg = dataclasses.replace(base.get_parallel(DRYRUN_ARCH), kv_cache_dtype="int8")
    events.reset()
    tool.cvar_set("analysis_recording", True)
    try:
        _reset_launches()
        server = Server(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=NEW_TOKENS),
                        make_host_communicator(device="cuda"))
        reqs = serve.requests(cfg, 2, ANALYZE_PROMPT)
        tokens, stats = server.generate(reqs)
        launches["analyze_serve"] = _launches()
        _reset_launches()
        trainer = _trainer(dataclasses.replace(cfg), base.get_parallel(DRYRUN_ARCH), "cuda",
                           steps=2, seq=TRAIN_SEQ, batch=TRAIN_BATCH)
        result = trainer.run()
        launches["analyze_train"] = _launches()
        captured = trainer._request.captured
        del trainer
        _free()
        recorded = len(events.ledger())
        clean = checkers.run_all(events.merge([events.ledger()]))

        # the seeded defect: start 2 fired while start 1's future is unconsumed
        events.reset()
        comm = world(device_type="cuda")
        x = torch.ones(1024, device="cuda")
        req = comm.persistent(lambda t: t * 2, x)
        first = req.start(x)
        req.start(x).get()
        seeded = checkers.run_all(events.merge([events.ledger()]))
        first.get()

        # a warm decode step (the server's graph replay on a fresh prefill's
        # cache: a capture, then ANALYZE_DECODE_REPS replays), recording on
        # and off
        batch, _ = server._pad_batch(reqs)
        decode = {}
        for on in (True, False):
            tool.cvar_set("analysis_recording", on)
            with torch.inference_mode():
                logits, cache = server.bundle.prefill(server.params, batch, server.pcfg,
                                                      extra_capacity=NEW_TOKENS)
                tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1).to(torch.int32)
                tok = tok[:, None]
                req = server._decode_request(cache, tok)
                req(server.params, cache, tok)
                req(server.params, cache, tok)    # the capturing start
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ANALYZE_DECODE_REPS):
                    req(server.params, cache, tok)
                torch.cuda.synchronize()
                decode["on" if on else "off"] = (time.perf_counter() - t0) / ANALYZE_DECODE_REPS
                req.release()
            del logits, cache

        # what recording costs where its hooks run: an eager immediate
        # allreduce (a hook at the call, one at its future's get), recording
        # on and off, twice each; a replay runs no hook, so the decode times
        # above are equal by construction
        y = torch.ones(1024, device="cuda")
        eager: dict = {"on": [], "off": []}
        for on in (True, False, True, False):
            tool.cvar_set("analysis_recording", on)
            events.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ANALYZE_EAGER_REPS):
                comm.immediate_allreduce(y).get()
            torch.cuda.synchronize()
            eager["on" if on else "off"].append((time.perf_counter() - t0) / ANALYZE_EAGER_REPS)
    finally:
        tool.cvar_set("analysis_recording", False)
        events.reset()
    del server
    _free()
    row = {"events": recorded, "findings": [str(f) for f in clean],
           "seeded": [f.as_dict() for f in seeded],
           "serve_tokens_per_s": stats["tokens_per_s"],
           "train_losses": [m["loss"] for m in result["metrics"]], "captures": captured,
           "decode_step_s_recording_on": decode["on"],
           "decode_step_s_recording_off": decode["off"],
           "eager_allreduce_us_recording_on": min(eager["on"]) * 1e6,
           "eager_allreduce_us_recording_off": min(eager["off"]) * 1e6,
           "launches": launches}
    log_row({"analyze": row})
    check(recorded > 0, "analyze: nothing recorded")
    check(clean == [], f"analyze: findings on a clean run: {row['findings']}")
    check([f.code.name for f in seeded] == ["ERR_REQUEST"], f"analyze: seeded {row['seeded']}")
    check(captured == 1 and all(math.isfinite(m["loss"]) for m in result["metrics"]),
          f"analyze: train {row['train_losses']}, {captured} captures")
    check(launches["analyze_serve"]["flash_attention_fwd"] == ANALYZE_LAYERS
          and launches["analyze_serve"][QUANT] > 0 and launches["analyze_serve"][DEQUANT] > 0,
          f"analyze: serve launches {launches['analyze_serve']}")
    RESULTS["analyze"] = row
    return launches


def _eager_train(cfg, pcfg) -> dict:
    """The reference for ``phase_train``'s graph steps: the same trainer's
    init and batches through ``make_train_step`` called eagerly,
    ``TRAIN_STEPS`` steps; (loss, grad norm) a step, each step's time and
    the peak memory.  Its state is freed before the graph run starts."""

    import torch

    from repro_torch.runtime.trainer import make_train_step

    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(cfg, pcfg, "cuda", steps=TRAIN_STEPS, seq=TRAIN_SEQ, batch=TRAIN_BATCH)
    params, opt_state = trainer.init_state()
    # the trainer's own step: with the ring, the communicator for the loss
    step = make_train_step(trainer.cfg, trainer.pcfg, trainer.tcfg, trainer.opt,
                           mesh=trainer.comm if trainer._ring_line is not None else None,
                           comm=trainer.comm)
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        batch = trainer._batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    row = {"losses": losses, "step_s": step_s,
           "warm_step_s": sorted(step_s[1:])[(len(step_s) - 1) // 2],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del trainer, params, opt_state, metrics, step, batch
    _free()
    return row


#: the port's examples (``examples_torch/``) a world of one runs, each as a
#: user starts it (``python examples_torch/<name>.py``, one process, the
#: NCCL world of one) at the reference script's own sizes: (name, its
#: arguments, the kernels its run must launch, none other, and lines its
#: own checks print).  ``train_lm`` trains its default ~100M model (300
#: steps) into a fresh checkpoint directory; ``pipeline_expert_train``
#: skips its pipeline demo on an odd world, as the reference's does, and
#: runs no attention; ``long_context_train`` and ``elastic_train`` need a
#: world of four (``tools/example_ranks.py``).
EXAMPLES = (
    ("quickstart", (), (), ("position: [1. 1. 1.]", "chained broadcasts: 3 (expect 3)",
                            "task graph (fork/join): 100.0")),
    ("async_checkpoint", (), (), ("restored step 1: bf16 bucket round-tripped exactly",
                                  "torn save surfaced as typed failure",
                                  "when_all + then over I/O requests: ['a', 'b', 'c']")),
    ("serve_batched", (), ("flash_attention_fwd",), ("arch=gemma2_9b  generated (4, 24)",)),
    ("serve_batched", ("--arch", "mamba2_2_7b"), ("ssd_scan_fwd",),
     ("arch=mamba2_2_7b  generated (4, 24)",)),
    ("continuous_batching_serve", (), ("flash_attention_fwd",),
     ("parity: every request matches the fixed-batch oracle token-for-token",)),
    ("fault_tolerant_train", (), ("flash_attention_fwd",),
     ("finished step 40 after 2 recoveries",)),
    ("train_lm", ("--checkpoint-dir", "build/examples/train_lm"), ("flash_attention_fwd",),
     ("model: demo_100m", "steps: 300  loss:")),
    ("session_train_serve", (), ("flash_attention_fwd",),
     ("trained to step 10", "served (4, 8) tokens")),
    ("disaggregated_serve", (), ("flash_attention_fwd",),
     ("token-for-token parity with the single-group baseline: OK (4, 12)",)),
    ("pipeline_expert_train", (), (), ("pipeline demo needs an even device count; skipping",
                                       "dispatched 8 tokens over the graph")),
)
#: examples run at once (the machine's 8 cores start them; the card runs
#: them side by side), and each one's limit
EXAMPLES_JOBS = 4
EXAMPLE_LIMIT_S = 240
EXAMPLE_MARKER = "EXAMPLE_LAUNCHES "

#: one example in a fresh process: its counts zeroed before the script
#: runs, read after it, on a line of their own
_EXAMPLE_RUNNER = r"""
import json, runpy, sys
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.quant import kernel as qk
from repro_torch.kernels.ring_attention import kernel as rk
from repro_torch.kernels.ssd_scan import kernel as sk

for m in (fk, sk, qk, rk):
    m.reset_launches()
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print(MARKER + json.dumps({"flash_attention_fwd": fk.LAUNCHES, "ssd_scan_fwd": sk.LAUNCHES,
                           **qk.LAUNCHES, "ring_step_fwd": rk.LAUNCHES}), flush=True)
""".replace("MARKER", repr(EXAMPLE_MARKER))


def _example(name: str, args: tuple, kernels: tuple, lines: tuple) -> tuple[str, dict]:
    """Run one example; its path name and its launches."""

    import shutil

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    path = ":".join(["example", name, *args[1:2]]) if args[:1] == ("--arch",) else \
        f"example:{name}"
    if "--checkpoint-dir" in args:
        shutil.rmtree(ROOT / args[args.index("--checkpoint-dir") + 1], ignore_errors=True)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _EXAMPLE_RUNNER, str(ROOT / "examples_torch" / f"{name}.py"),
             *args], capture_output=True, text=True, env=env, cwd=str(ROOT),
            timeout=EXAMPLE_LIMIT_S)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = None, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    wall = time.perf_counter() - t0
    check(rc == 0, f"{path}: exit {rc}\n{out[-2000:]}\n{err[-3000:]}")
    for want in lines:
        check(want in out, f"{path}: no line with {want!r}\n{out[-2000:]}")
    (counts,) = [json.loads(line[len(EXAMPLE_MARKER):]) for line in out.splitlines()
                 if line.startswith(EXAMPLE_MARKER)]
    launched = sorted(k for k, v in counts.items() if v)
    check(launched == sorted(kernels),
          f"{path}: launched {launched} ({counts}), expected {sorted(kernels)}")
    if "--checkpoint-dir" in args:
        shutil.rmtree(ROOT / args[args.index("--checkpoint-dir") + 1], ignore_errors=True)
    row = {"example": path, "wall_s": wall, "launches": counts,
           "lines": [line for line in out.splitlines()
                     if not line.startswith(EXAMPLE_MARKER)][-4:]}
    log_row(row)
    RESULTS.setdefault("examples", []).append(row)
    return path, counts


def phase_examples():
    """Every example a world of one runs, ``EXAMPLES_JOBS`` at a time: exit
    0, its own check lines, the kernels it must launch counted and no
    other, its wall time.  The launches by path."""

    # fault recovery first, beside only the runs that launch no kernel: its
    # 2 ms graph steps are held to the straggler deadline (3x their median),
    # which another process's work on the host (``train_lm``'s 1.2 GB
    # checkpoint saves) stretched them past, and a third recovery failed
    # its count (ROADMAP C35); then the others, the longest first
    first = [spec for spec in EXAMPLES if spec[0] == "fault_tolerant_train" or not spec[2]]
    rest = sorted((spec for spec in EXAMPLES if spec not in first),
                  key=lambda spec: spec[0] != "train_lm")
    launches = {}
    for wave in (first, rest):
        with ThreadPoolExecutor(EXAMPLES_JOBS) as pool:
            launches.update(pool.map(lambda spec: _example(*spec), wave))
    return launches


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _kernel_line(name, source, replaces, max_abs_err, main_case, launches):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(by_path[name] for by_path in launches.values()),
        "launches_by_path": {path: by_path[name] for path, by_path in launches.items()},
        "max_abs_err": max_abs_err,
        "ms": main_case["ms"],
        # host time of one wrapper call, apart from ms (device time)
        "host_us": main_case["host_us"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }


def _phase(fn, *args, **kwargs):
    """Run the phase ``fn(*args, **kwargs)`` and print its wall time as a
    line of its own, ``{"phase": ..., "wall_s": ...}``."""

    name = ":".join([fn.__name__.removeprefix("phase_")]
                    + [str(a) for a in args
                       if isinstance(a, (str, int)) and not isinstance(a, bool)]
                    + [k for k, v in kwargs.items() if v])
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    row = {"phase": name, "wall_s": time.perf_counter() - t0}
    RESULTS.setdefault("phase_wall_s", []).append(row)
    print(json.dumps(row), flush=True)
    return out


def main() -> int:
    import torch

    import repro_torch.kernels.flash_attention.kernel  # noqa: F401  (the port is here)

    t_run = time.perf_counter()
    for phase in (phase_device, phase_clock, phase_build, phase_nccl, phase_kernels,
                  phase_ssd, phase_quant, phase_ring):
        _phase(phase)
    launches = dict(_phase(phase_examples))
    launches.update(_phase(phase_serve, *spec) for spec in SERVES)
    for arch in ("gemma2_9b", "mamba2_2_7b", "zamba2_7b", "paligemma_3b",
                 "seamless_m4t_large_v2", "grok_1_314b", "deepseek_v2_236b"):
        _phase(phase_small_model, arch)
    for arch in ("gemma2_9b", "zamba2_7b"):
        _phase(phase_small_model, arch, "int8")
    _phase(phase_small_model, "phi4_mini_3_8b", ring=True)
    launches.update(_phase(phase_engine))
    for arch in ENGINE_SMALL:
        _phase(phase_engine_small, arch)
    launches.update(_phase(phase_disaggregate, kv) for kv in ("bfloat16", "int8"))
    launches.update([_phase(phase_shard)])
    _phase(phase_moe_neighbor)
    for spec in TRAIN_SMALL:
        _phase(phase_train_small, *spec)
    _phase(phase_train_checkpoint)
    launches.update([_phase(phase_elastic)])
    launches.update(_phase(phase_train, *spec) for spec in TRAIN_FULL)
    launches.update(_phase(phase_tune))
    _phase(phase_dryrun)
    launches.update(_phase(phase_analyze))
    launches.update([_phase(phase_train, *TRAIN_FULL[0], ring=True),
                     _phase(phase_train_pipeline)])
    launches.update([_phase(phase_grad_sync)])
    RESULTS["run_s"] = time.perf_counter() - t_run
    print(json.dumps({"run_s": RESULTS["run_s"]}), flush=True)

    flash, ssd = RESULTS["kernel_cases"], RESULTS["ssd_cases"]
    quant, dequant = RESULTS["quant_cases"], RESULTS["dequant_cases"]
    ring = RESULTS["ring_cases"] + [RESULTS["ring_of_one"], RESULTS["ring_of_one_train"]]
    kernels = [
        _kernel_line("flash_attention_fwd",
                     "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
                     "src/repro/kernels/flash_attention/kernel.py:37",
                     max(r["max_abs_err"] for r in flash), flash[0], launches),
        _kernel_line("ssd_scan_fwd", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_fwd.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:29",
                     max(r["max_abs_err"] for r in ssd), ssd[0], launches),
        _kernel_line(QUANT, "src/repro_torch/kernels/quant/csrc/quant_int8.cu",
                     "src/repro/kernels/quant/kernel.py:20",
                     max(r["max_abs_err_quant"] for r in quant), quant[0], launches),
        _kernel_line(DEQUANT, "src/repro_torch/kernels/quant/csrc/quant_int8.cu",
                     "src/repro/kernels/quant/kernel.py:56",
                     max(r["max_abs_err_dequant"] for r in quant + dequant), dequant[0],
                     launches),
        _kernel_line(RING, "src/repro_torch/kernels/ring_attention/csrc/ring_step_fwd.cu",
                     "src/repro/kernels/ring_attention/kernel.py:51",
                     max(r["max_abs_err"] for r in ring if "max_abs_err" in r),
                     RESULTS["ring_of_one"], launches),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched on the main paths")
    RESULTS["kernels"] = kernels
    out = ROOT / "artifacts"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
