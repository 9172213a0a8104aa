#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. the card's name and power limit (nvidia-smi) and the kernels' build;
  2. every kernel against its plain PyTorch version on the card, at every
     layer shape of sparse-cnn-s at batch 64, int8 and fp32 instantiations
     (the int8 one of the four compressed kernels on the tensor cores,
     csrc/os_mma.cuh; the stem on its direct path, and its implicit-GEMM
     path at a larger C and in int8), with random nonzero biases: int8 and
     int32 exact, fp32 within rtol = atol = 1e-5, the stem's requantized
     codes within one code on at most 0.1 % of entries (fp32 summation
     order). Both models: one pattern shared across each layer's outputs
     (tc kernels) and a pattern per output column (``pattern=None``, bw
     kernels); then a grouped format (DBBFormat(8, 3, 4)) at l4 and the
     head, and nnz of 1, 2, 4 and 8 at l4's shape on both the tc and the bw
     kernel; each layer timed by CUDA events (kernel, plain version, library
     call) and by torch.profiler's device time (kernel, and the library call
     with all its CUDA kernels; ``repro_torch.kernels.timing``, which allows
     for a profiler pass that delivers only some of its kernel records); each
     compressed layer's int8 plan (tile rows, A staging) logged, and the
     profiler's kernel names show that the tc conv and the tc head ran their
     gather stagers (TapMux, GatherMux) and the stem the path its plan
     chose; beside each tc conv layer, for information, torch._int_mm over
     the pre-gathered compressed im2col matrix (the GEMM alone), and the
     layer at request batch 1 (checked exactly, and its device time);
  2b. ResNet-50 v1.5 (``resnet50-v1.5``) at batch 64: its 7 x 7 stride-2
     stem on the direct path, the int8 max-pool, and the tc conv's 1 x 1
     (PointMux) and residual (ResidualFlush) instances at stage 1's and
     stage 4's shapes, a strided 1 x 1 projection and a strided 3 x 3 on the
     residual instance, each exactly its plain version (the stem's codes
     within one code) and timed as phase 2 times a layer; then the
     full-size model, seeded and calibrated, through its plan at bucket 64,
     the launch counts at 0 just before: logits equal to the unplanned INT8
     forward's bit for bit, one replay launching one stem, one max-pool,
     36 tc convs, 16 residual convs and the head, the plan and the
     unplanned forward timed in turns, and the device time per kernel and
     the idle share of planned forwards;
  3. sparse-cnn-s end to end through ``repro_torch.launch.serve``, once per
     pattern: request batches of 1, 8 and 64, one stem, seven conv and one
     head launch per forward on that pattern's kernels, each batch's logits
     against the plain chain on the same card and images (equal when the
     stem codes agree, else within 1e-3 relative L2); then a torch.profiler
     pass over served forwards at batch 1 and 64 (device time per kernel,
     the card's idle share);
  4. the committed golden fixtures of the JAX reference
     (tests/data/torch_parity_cnn.npz and torch_parity_cnn_bw.npz) through
     ``interop.params_from_numpy``;
  5. sparse-cnn-s served through frozen plans on CUDA graphs
     (``SparseCNN.plan_set``, ``models/plan.py``), once per pattern, with
     the launch counts at 0 just before: buckets 1 … 64, seven captures at
     warmup and none after; each bucket's replay equal to the unplanned
     forward bit for bit at batches 1, 8 and 64, and a ragged 5 and 100
     (64 + 36 padded to 64) equal to serving each image alone; a replay's
     captured launches one stem, seven convs and one head; the unplanned
     and planned forward timed in turns (unplanned, planned, planned,
     unplanned) on CUDA events, and the profiler's device-busy and idle
     share of planned forwards at batch 1 and 64; the continuous-batching
     server (``launch/server.py``) over 256 Poisson requests of 1–8 images
     at half its measured capacity: every request's logits equal to its
     own plan serve, no capture after warmup, the books balanced; then NaN
     through the server (an injected NaN row fails its request alone, a
     NaN bias in the last conv flushes to code 0 at the head's input as in
     the reference, a NaN bias in the head fails every request with
     NumericalFault); last, a re-quantized model's plan raises
     StalePlanError;
  6. the flush's NaN and ±inf (NaN and ±inf in the scale and bias rows, a
     NaN requantize scale, with and without ReLU, fp32 and int8 outputs)
     through all five kernels against their plain versions;
  7. the LM serving path, starcoder2-7b at full width (32 layers, d_model
     4608, 36 query and 4 KV heads, d_ff 18432, vocab 49152):
     a. the tc matmul's bf16 and int8 instantiations against their plain
        versions at every projection shape (4608->4608, 4608->512,
        4608->18432, 18432->4608) at 4 rows (decode) and 1024 (prefill):
        int8 and int32 exact, bf16 within one bf16 ulp plus the bound on
        the difference of two fp32 sums of the same products taken in
        different orders (K_c·2^-24·Σ|a||w|), and at most 0.1 % of the
        entries beyond one ulp of |plain|; each timed as phase 2 times a layer,
        beside torch.matmul bf16 on the decoded dense weight or
        torch._int_mm on the decoded int8 weight, each bf16 shape with its
        tile plan (``core.bf16_mma_plan``: tile, split-K, B chunk);
     b. greedy generation through ``repro_torch.launch.serve`` with the
        launch counts at 0 just before: compressed bf16 weights drawn and
        compressed on the card leaf by leaf (seed 0), batch 4, a 256-token
        prompt, 32 tokens, every projection on the bf16 kernel, the prefill
        and the decode step each captured once into a CUDA graph and
        replayed (two captures, none after); the launches (the counters'
        capture and warm-up counts plus a replay's launches times the
        replays) one per projection per forward enqueued; prefill ms, ms
        per decode step, steps/s and the host's enqueue times beside the
        decode bound from the bytes a step reads, and beside an eager run
        of the same model (``graph=False``) whose tokens and kept decode
        logits the replays equal bit for bit; the logits of 4 decode steps
        against a fresh forward over the prompt and the tokens fed
        (relative L2 <= 2e-2); the profiler's busy and idle share of
        replayed decode steps and prefills; then the dense bf16 baseline
        (torch.matmul) the same way;
     c. INT8 prefill through a frozen plan (``serve_lm_plan``, counts at 0
        just before): calibrate on 4x256 through the bf16 kernel, quantize,
        ``LM.plan``; its logits equal the unplanned INT8 forward's bit for
        bit; planned and unplanned timed in turns; captures and a replay's
        launches;
     d. the JAX golden fixture tests/data/torch_parity_lm.npz (qwen2-tiny,
        fp32) through the kernels: the next token equal, prefill and decode
        logits within 1e-5 relative L2, the quantized forward within 1e-3;
  8. the MoE decoder, moonshot-v1-16b-a3b at full width and depth (48
     layers, d_model 2048, 16 heads, 64 experts of d_ff 1408, top-6, 2
     shared experts, vocab 163840; 28.89 B weights):
     a. the bf16 tc matmul at its compressed projection shapes
        (2048->2048, 2048->2816, 2816->2048) at 4 and 1024 rows, as 7a;
     b. generation as 7b, compressed (the expert stacks stay bf16, as the
        reference leaves them) then dense, peak GB logged, with the routed
        experts' share of a replayed step against their bytes bound; no
        fresh-forward gate: decode routes expert choice over the batch's 4
        tokens (cap 1), a forward within each example (cap 24), so the
        same token meets other experts, as in the reference;
     c. the JAX MoE fixture tests/data/torch_parity_moe.npz (moonshot's
        smoke config, fp32) through generate's graphs: the next token
        equal, prefill and decode logits within 1e-5 relative L2;
     d. the INT8 prefill plan as 7c (the shared experts staged int8, the
        router and the experts raw), bit for bit against the unplanned
        forward;
  9. the recurrent decoders at full width and depth, each in turn and
     freed before the next is built: recurrentgemma-2b (26 layers: 18
     RG-LRU and 8 local-attention blocks, d_model 2560, 10 query heads and
     one KV head of 256, d_ff 7680, vocab 256000 tied, logit soft-cap 30;
     2.894 B weights) and rwkv6-3b (32 RWKV6 blocks, d_model 2560, 40 heads
     of 64, d_ff 8960, vocab 65536; 3.074 B weights):
     a. the tc matmul's bf16 and int8 instantiations at each model's
        projection shapes (2560->2560, 2560->256, 2560->7680, 7680->2560;
        2560->2560, 2560->8960, 8960->2560: K_c 960, 2880, 3360) at 4 and
        1024 rows, as 7a;
     b. generation as 7b, compressed then dense, with peak GB; the
        fresh-forward gate (2e-2) holds an fp32 copy of the same weights,
        generated through graphs on the fp32 instantiation of the kernel:
        these random-weight stacks amplify bf16 rounding with depth (a bf16
        forward of rwkv6-3b is ~0.5 from its fp32 forward, and so is a bf16
        decode), so the served model's decode and forward are logged, not
        gated; the decode bound counts the tied table that the logits read
        whole, the K/V of the local blocks only, and the recurrent state
        read and written;
     c. each model's JAX fixture (tests/data/torch_parity_rglru.npz,
        torch_parity_rwkv.npz: the smoke config, fp32) through generate's
        graphs, as 8c;
     d. the INT8 prefill plan as 7c (the recurrent projections staged with
        a dynamic activation scale), bit for bit against the unplanned
        forward;
 10. MLA, deepseek-v3-671b at published width (d_model 7168, 128 heads,
     q LoRA 1536, latent 512 + 64 RoPE dims, 256 experts of d_ff 2048,
     top-8, one shared, vocab 129280) cut to 2 layers (24.87 B weights;
     the dense expert stacks, 22.5 GB a layer, leave no room for a third
     on one card):
     a. the tc matmul's bf16 and int8 instantiations at its projection
        shapes (7168->1536, 1536->24576, 7168->576, 512->32768,
        16384->7168; the shared expert's 7168->2048 and 2048->7168) at 4
        and 1024 rows, as 7a;
     b. generation as 8b, compressed then dense, each build dropped (its
        graphs and caches too) before the next is drawn, peak GB logged;
        the launches per forward kind (a decode step reads ``wkv_b``
        decoded and skips its projection); in place of a fresh-forward
        gate (the MoE routes decode and prefill apart), layer 0's mixer on
        an fp32 copy of its weights: its absorbed decode over the prompt's
        positions within 1e-4 relative L2 of its full-sequence forward,
        the bf16 distance logged; the decode bound reads the decoded
        ``wkv_b`` and the latent cache, writing one slot;
     c. the JAX fixture tests/data/torch_parity_mla.npz (the smoke config,
        fp32) through generate's graphs, as 8c, and its quantized forward
        within 1e-3, as 7d;
     d. the INT8 prefill plan as 7c (every MLA projection staged with its
        calibrated scale), bit for bit against the unplanned forward;
 11. the frontends and cross-attention at full width and depth, each model
     in turn and freed before the next is built: musicgen-medium (48
     layers, d_model 1536, 24 heads of 64, d_ff 6144 GELU, LayerNorm, 4
     codebooks of 2048 summed at the input and a 4 x 2048 head, cross-
     attention after every self-attention to a 128-slot text memory; 1.84 B
     weights; a 256-frame prompt, ~5 s of EnCodec frames at 50 Hz) and
     internvl2-2b (24 layers, d_model 2048, 16 query and 8 KV heads of 128,
     d_ff 8192, vocab 92553; 1.89 B weights; a 512-token prompt: one 448 x
     448 tile's 256 vision embeddings over the first positions, then 256
     text tokens); the encoders' outputs are seeded stand-ins, as in the
     reference:
     a. the tc matmul's bf16 and int8 instantiations at each model's
        projection shapes (1536->1536, 1536->6144, 6144->1536; 2048->2048,
        2048->1024, 2048->8192, 8192->2048) at 4 rows and the prefill's
        (1024; 2048), the cross wk/wv at the memory's 512 rows, as 7a;
     b. generation as 7b, compressed then dense, with peak GB, the side
        inputs static buffers of the prefill's graph: a musicgen prefill
        runs 10 compressed projections a layer, a decode step 8 (the cross
        K/V are the prefill's, read from the cache), audio tokens (4, 32,
        4); the fresh-forward gate (2e-2) on the served model, the forward
        fed the same memory and vision embeddings; the decode bound reads
        the cross K/V and not the cross wk/wv;
     c. each model's JAX fixture (tests/data/torch_parity_audio.npz,
        torch_parity_vlm.npz: the smoke config, fp32) through generate's
        graphs, as 8c, and its quantized forward within 1e-3, as 7d;
     d. ``LM.plan`` and ``serve_lm_plan`` refuse both (the reference's
        ``LM.plan`` does), so the calibrated INT8 prefill runs unplanned:
        one int8 launch per projection per forward, timed, its logits'
        distance from the bf16 forward's logged;
 12. the self-healing serving tier (``launch/supervisor.py``,
     ``checkpoint/store.py``, the server's swap and demotion) on
     sparse-cnn-s at full size, shared patterns, buckets 1 … 64, with the
     launch counts at 0 just before:
     a. the quantized state saved by the port's store and restored onto the
        card into a fresh model, every leaf equal bit for bit (save and
        restore ms, bytes); the checkpoint the JAX package wrote
        (tests/data/torch_parity_ckpt) restored bit for bit, its logits
        within the fixture's 1e-3 of torch_parity_cnn.npz's; each of the
        four corruptions (a flipped byte, a torn write, an edited manifest,
        a missing archive) raises CorruptCheckpointError and
        ``fallback=True`` walks back one step;
     b. Poisson requests of 1–8 images at half the throughput a
        saturated run of 1024 requests measured (half the host-path
        capacity, phase 5's rate, saturates the server) through
        ``serve_continuous`` under the Supervisor, without reloads and with
        3 hot reloads mid-traffic (restore, rebuild, 7 captures, swap, each
        timed). The traffic is sized to the host: a probe run of 1024
        requests with one reload at that rate times a reload, and the
        interval between reloads is at least ``SELFHEAL_PROBE_MARGIN`` = 3
        probe reloads and at least 2048 requests, the run 4 intervals
        (8192 requests or more): every request equal to its own plan serve bit for bit,
        nothing dropped, no capture after warmup, 3 reloads, each swap back
        before the last arrival and followed by batches on the new set, the
        memory reserved after the last no more than after the first plus
        one plan set's pool, p50/p99 beside the run without; then a
        corrupted checkpoint's reload raises while the old set serves the
        same logits (``reload_failures`` 1);
     c. over the first 4096 requests, a transient dispatcher kill
        (``kills=1`` at the first tick with work after the 2nd dispatch:
        one restart, every admitted request completed, the rest refused at
        submit in the restart's gap), a kill
        inside the 8th dispatch (its requests fail with ServerCrashed, the
        rest served or refused) and a crash loop over 256 requests
        (``max_restarts=2``: the breaker opens, health 'failed', no hang),
        the restart's ms;
     d. ``fallback_plan_set`` (the same kernels staged without graphs),
        bucket 8 failed at the injector's ``pre_bucket``: two strikes
        demote it, its dispatches launch the kernels eagerly and equal its
        graph's bit for bit, its plan's replays stop; healed, the 4th
        dispatch promotes it (``promotions`` 1); bucket 8's ms eager beside
        its graph's; a fresh run of 256 requests shows no demotion;
 13. tuning (``kernels/autotune.py``, ``kernels/calibrate.py``), on a cache
     file in a temporary directory (``REPRO_AUTOTUNE_CACHE``, set for the
     whole run, so phases 2–12 run on an empty cache and the rules'
     choices, as before the autotuner; each run searches afresh):
     a. ``calibrate(force=True)``: the roofline constants fitted to the
        probes (bf16 launches), each finite and positive, and the residual;
     b. sparse-cnn-s, both patterns, ``plan_set(tune='search')`` over
        buckets 1 … 64: every launch choice a search times is first held
        against the kernel's plain version on the same inputs; every
        signature's default and tuned device µs, tuned ≤ default; the tuned
        sets' logits equal the ``'off'`` sets' bit for bit at every bucket;
        a rebuild with ``'cache'`` (registry cleared) runs no search and
        makes the same choices;
     c. starcoder2-7b: its bf16 projections searched at M = 4 and 1024,
        then ``generate`` (4 × 256 prompt, 32 tokens) in turns untuned,
        tuned, tuned, untuned (ms per step and prefill ms, beside phase
        7b's run), the tuned replay equal to an eager run bit for bit; then
        the calibrated INT8 prefill plan at 4 × 256 (M = 1024) with
        ``tune='search'`` equal to the ``'off'`` plan bit for bit, both
        timed in turns;
 14. training and accounting, with the earlier phases' models freed and the
     peak-memory counter reset first:
     a. parity on the card: codeqwen1.5-7b's smoke config cut as
        tests/test_substrate.py cuts it (2 layers, d_model 64, d_ff 128,
        vocab 256) in an fp32 copy, TF32 off: 3 ``train_step``s on the card
        against the same 3 on the CPU from one parameter set (losses within
        1e-5 relative; parameters and state within rtol 2e-4, atol 2e-5,
        but entries whose first gradient is nonzero and below 1e-6, where
        Adam steps by the sign of rounding noise, which may go beyond it
        if they moved, on both devices, within AdamW's reach); the
        kill-resume twin on the card (6 steps straight against 3, a
        checkpoint at step 2, a resume and 3 more, rtol 2e-4, atol 2e-5);
        3 steps with int8 error-feedback gradient compression, the residual
        finite;
     b. the trainer at full width: starcoder2-7b at published width cut to
        ``TRAIN_LAYERS`` = 8 (2.19 B parameters, 35.0 GB of training state
        at 16 bytes a parameter), remat 'full', through ``Trainer`` with the
        launcher's defaults (seq 256, batch 8, peak lr 3e-4, warm-up 5), 12
        steps, ``PruneSchedule(0, 8)``, no checkpoint directory. Gates:
        every loss finite, the last below the first, every DBB leaf on its
        3/8 bound after the last step. Logged: ms a step end to end (CUDA
        events from the end of step 2 to the end of step 12, over 10: the
        batch's copy to the card, the loss read and the loop's host work
        inside), tokens/s and ``mfu`` (6 × the non-embedding parameters ×
        tokens plus the attention's products, no recompute, over that step
        and 989 TFLOP/s) from it; the median of steps 3–12 of the step
        function, forward and backward, optimizer and ``constrain`` on
        events; the host's data wait; peak memory;
     c. the accounting: ``ops.sparse_matmul(a, w, act_fmt=act_fmt(
        measure_activation(a)))`` at starcoder2's four projection shapes,
        M = 1024, on the activations the trained model's layer 0 reads (the
        post-GELU one at w_down) with its weights compressed at 3/8, and at
        the paper's assumed 4/8, each against its plain version on the card,
        beside the unpruned call; then sparse-cnn-s at batch 64, both
        patterns, ``forward(collect_act_stats=True)`` on the card's fp32
        kernels against the CPU's plain versions (logits within rtol = atol
        = 1e-5, zero fractions within 1e-4, absmax within 1e-5 relative),
        ``layer_costs`` and the pareto
        design's ``model_workload`` at the measured activation sparsity
        beside the assumed 0.5;
 15. distribution on a one-rank (1, 1) ("data", "model") mesh (NCCL, a
     rendezvous file under build/dist); the multi-rank numerics are checked
     on the CPU only (tests/test_torch_distributed.py, 8 gloo ranks):
     a. the sharded decode step: starcoder2-7b at full width and depth,
        compressed, its parameters wrapped as DTensors with
        ``DTensor.from_local`` (no second copy); one prefill, then 8 eager
        greedy decode steps unsharded and 8 sharded under the decode rules,
        each from its own copy of the prefill's cache. Gates: the logits
        equal bit for bit at every step, and the bf16 tc kernel's launches
        (inside ``local_map``) equal the unsharded run's. Logged: eager ms
        a step both ways (DTensor's host cost) and the aten ops one more
        step dispatches each way, those on DTensors apart;
     b. the sharded training step: starcoder2-7b at published width cut to
        ``DIST_LAYERS`` = 2, 2 steps of ``Trainer`` on the mesh (the
        launcher's ``--distributed`` path, training rules) against 2
        unsharded from the same seeded state; losses and parameters within
        5e-3 (bit for bit logged), the step counts equal, each leaf's Adam
        moments within 5e-2 and the fp32 master's update within 0.25 of the
        unsharded run's, relative;
     c. 15b's sharded parameters saved and restored with ``shardings=``,
        equal bit for bit;
 16. the mesh (phase 16):
     a. data-parallel serving under one controller: sparse-cnn-s (shared
        patterns) through ``CNNServer(mesh=make_local_mesh((2, 1), ("data",
        "model"), [cuda:0, cuda:0]))``, two replicas of ``plan_set(dp=2)``
        on the card, each bucket split 2 ways; 256 Poisson requests each
        way in turns (one device, mesh, mesh, one device) and the ragged 5;
        every logit
        equal to the one-device plan set's bit for bit, no capture after
        warmup, each replica frozen to its bucket's launch choices; p50,
        p99 and images/s both ways; the kernels' launches from 0 just before
        the mesh server is built (captured, and replayed);
     b. the dry run (``repro_torch.launch.dryrun``), one process a cell, all
        at once: starcoder2-7b (context) prefill_32k and decode_32k and
        qwen2-72b (q-sharded) train_4k on a fake (16, 16) world, qwen2-72b
        train_4k on (2, 16, 16); each ``ok`` with collectives, and rank 0's
        argument bytes equal to the specs' count; the records logged
        (counts and host seconds, no device time);
     c. 15a's decode in starcoder2-7b's context mode at tp 16 on the
        one-rank mesh: every attention block through the context decode,
        whose combine over one rank is the one-device path; the logits equal
        the unsharded decode's bit for bit;
 17. the families on the one-rank mesh in their production modes (the rules
     at tp 16), each at published width cut to ``DIST_LAYERS`` = 2 layers
     (recurrentgemma-2b to its 3-block pattern, so that a local block is
     included):
     a. moonshot-v1-16b-a3b (the MoE's dispatch and combine at prefill, its
        routing over the batch at decode), deepseek-v3-671b (MLA's absorbed
        decode on a sharded ``wkv_b``), rwkv6-3b (feature mode),
        recurrentgemma-2b (context mode, a prompt of ``local_window`` tokens
        and a ring of as many slots, which wraps at the first step) and
        musicgen-medium (context mode, its cross memory), compressed: one
        prefill and 8 eager greedy decode steps unsharded and sharded
        (``LM.distribute(local=True)``); the prefill's and every step's
        logits equal bit for bit, and the bf16 tc kernel's launches equal
        each way;
     b. 2 steps of ``Trainer`` on the mesh against 2 unsharded for
        moonshot-v1-16b-a3b and musicgen-medium (its loss on vocab shards),
        under 15b's gates;
     c. the dry run's cells, one process each, all at once and while 17a
        and 17b run: moonshot-v1-16b-a3b train_4k, deepseek-v3-671b
        decode_32k and rwkv6-3b prefill_32k on (16, 16), recurrentgemma-2b
        and musicgen-medium train_4k on (2, 16, 16), as 16b's;
 18. one JSON line of the six kernels (launches, errors, times, bounds).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository's ``src/repro_torch`` beside this file, it exits
nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
FIXTURES = {"matrix": ROOT / "tests" / "data" / "torch_parity_cnn.npz",
            None: ROOT / "tests" / "data" / "torch_parity_cnn_bw.npz"}

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
BATCH = 64
REQUESTS = 8
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def port_kernel(name: str) -> bool:
    return kernel_family(name) != "other"


def kernel_names(fn, tries: int = 5) -> set:
    """Names of the CUDA kernels that one call of ``fn`` ran, from
    torch.profiler; a pass that delivers no kernel events is run again, and
    after ``tries`` such passes the set is empty. Device-side copies of
    spans are no kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.spans import is_span

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA and not is_span(ev)}
        if names:
            return names
    return set()


def require_instance(fn, core: str, loader: str, what: str) -> str:
    """Fail unless one call of ``fn`` ran a kernel of the template ``core``
    with the stager or loader ``loader``; returns what was seen. A profiler
    that delivers no kernel events fails it too: the instance is unseen."""
    names = kernel_names(fn)
    if not names:
        raise AssertionError(f"{what}: the profiler delivered no kernel events, so the "
                             f"{core} kernel with {loader} was not seen")
    hits = sorted(n for n in names if core in n and loader in n)
    if not hits:
        raise AssertionError(f"{what}: no {core} kernel with {loader} among {sorted(names)}")
    return hits[0]


def bound(nbytes: int, ops: int, ops_per_s: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_codes(got, want, what: str) -> int:
    """Requantized codes from an fp32 accumulator: within one code, on at
    most 0.1 % of entries. Returns the largest difference."""
    d = (got.int() - want.int()).abs()
    dmax, frac = int(d.max()), float((d > 0).float().mean())
    if dmax > 1 or frac > 1e-3:
        raise AssertionError(f"{what}: codes differ by up to {dmax} on {frac:.2%} of entries")
    return dmax


def check_exact(got, want, what: str) -> float:
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        d = (got.double() - want.double()).abs().max() if got.shape == want.shape else "shape"
        raise AssertionError(f"{what}: not equal to the plain version (max diff {d})")
    return 0.0


def check_close(got, want, what: str) -> float:
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{what}: max |diff| {float((got - want).abs().max())} "
                             "beyond rtol = atol = 1e-5")
    return float((got - want).abs().max())


# ---------------------------------------------------------------- phase 2


def rnd(gen, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(dev)


def codes(gen, dev, *shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)


def dequant_scales(gen, dev, n, kc):
    # int8 codes (std ~73) times int8 weights (std ~40) over kc nonzero terms,
    # scaled so the requantized output codes spread over about ±40
    return ((torch.rand(n, generator=gen) + 1.0) / (2900.0 * kc ** 0.5)).to(dev)


def layer_shapes(cfg, batch):
    """(layer, input shape) for every layer of the model at ``batch``."""
    from repro_torch.core.sparse_conv import DBBConv2d
    from repro_torch.models.cnn import SparseCNN

    h = cfg.image_size
    out = []
    for m in SparseCNN(cfg).layers():
        if isinstance(m, DBBConv2d):
            out.append((m, (batch, h, h, m.in_channels)))
            h = m.out_hw(h, h)[0]
        else:
            out.append((m, (batch, m.in_features)))
    return out


def timed(run, plain, library, **rec):
    """The record of one layer: the kernel's, its plain version's and the
    library call's times by CUDA events, and the device times of the kernel
    and of the library call (all its CUDA kernels)."""
    from repro_torch.kernels.timing import device_ms, event_ms

    return dict(rec, ms=event_ms(run, REPS), plain_ms=event_ms(plain, REPS),
                library_ms=event_ms(library, REPS), device_ms=device_ms(run, keep=port_kernel),
                library_device_ms=device_ms(library))


def stem_layer(m, xshape, out_scale, gen, dev):
    """The dense stem: fp32 in, int8 codes out (the main path), fp32 out, and
    the int8 instantiation, each against the plain version; the path its
    plan chose (the direct conv) seen in the profiler's kernel names; then
    the implicit-GEMM path in fp32 at a C the direct path does not take."""
    from repro_torch.kernels import im2col_conv as stem_k

    f = m.out_channels
    bias = rnd(gen, dev, f, scale=0.5)
    x, w = rnd(gen, dev, *xshape), rnd(gen, dev, m.kh, m.kw, m.in_channels, f, scale=0.2)
    kw = dict(bias=bias, relu=True, out_scale=out_scale, stride=m.stride, padding=m.padding)
    run = lambda: stem_k.im2col_conv(x, w, **kw)  # noqa: E731
    plain = lambda: stem_k.im2col_conv_plain(x, w, **kw)  # noqa: E731
    err = check_codes(run(), plain(), "stem fp32->int8")
    kw32 = dict(bias=bias, relu=True, stride=m.stride, padding=m.padding)
    check_close(stem_k.im2col_conv(x, w, **kw32), stem_k.im2col_conv_plain(x, w, **kw32),
                "stem fp32")
    xq, wq = codes(gen, dev, *xshape), codes(gen, dev, m.kh, m.kw, m.in_channels, f)
    ki = dict(stride=m.stride, padding=m.padding)
    check_exact(stem_k.im2col_conv(xq, wq, **ki), stem_k.im2col_conv_plain(xq, wq, **ki),
                "stem int8")
    path = stem_k.conv_path(x.dtype, m.in_channels, m.kh, m.kw, m.stride)
    core, loader = ("direct_conv", "HaloTile") if path == "direct" else ("os_gemm", "Tap")
    seen = require_instance(run, core, loader, "stem")
    log(f"[kernels] stem: the {path} path; the profiler saw {seen}")
    xg, wg = rnd(gen, dev, 4, 16, 16, 16), rnd(gen, dev, m.kh, m.kw, 16, f, scale=0.1)
    if stem_k.conv_path(xg.dtype, 16, m.kh, m.kw, 1) != "gemm":
        raise AssertionError("the C = 16 probe of the implicit-GEMM path takes the direct path")
    check_close(stem_k.im2col_conv(xg, wg, **kw32), stem_k.im2col_conv_plain(xg, wg, **kw32),
                "conv fp32 at C = 16 (implicit GEMM)")
    xn = x.permute(0, 3, 1, 2).contiguous()
    wn = w.permute(3, 2, 0, 1).contiguous()
    pad = 1 if m.padding == "SAME" else m.padding[0][0]
    library = lambda: F.conv2d(xn, wn, bias, stride=m.stride, padding=pad)  # noqa: E731
    out = run()
    nb_ = nbytes(x, w, bias, out)
    ops = 2 * out.numel() * m.kh * m.kw * m.in_channels
    b_ms, b_by = bound(nb_, ops, FP32_OPS_PER_S)
    return timed(run, plain, library, err=err, bound_ms=b_ms, bound_by=b_by, bytes=nb_, ops=ops,
                 plan=f"{path} path", out_bytes=nbytes(out))


def sparse_layer(m, xshape, fmt, bw, out_scale, gen, dev, what):
    """One compressed layer (a conv or the head) in ``fmt`` on the tc kernel
    (``bw`` False: a pattern shared across the outputs) or the bw kernel
    (a pattern per column, or per group, indices read in place). Holds
    three instantiations against the plain version with random nonzero
    biases: int8 as the main path runs it (requantized codes, or fp32 at l7
    and the head) and the raw int32 accumulator exactly, fp32 within 1e-5;
    the head's int8 also at request batches 1 and 8 and requantized to
    codes. Returns the layer's timed record."""
    from repro_torch.core.quant import quantize_dbb
    from repro_torch.core.sparse_conv import DBBConv2d
    from repro_torch.core.vdbb import dbb_decode, dbb_encode, dbb_encode_conv, gather_compressed
    from repro_torch.kernels import vdbb_im2col_conv as conv_k
    from repro_torch.kernels import vdbb_matmul as head_k
    from repro_torch.kernels.core import mma_gather_plan, mma_plan, mma_tap_plan
    from repro_torch.kernels.ref import im2col_explicit
    from repro_torch.kernels.timing import device_ms

    conv = isinstance(m, DBBConv2d)
    mode = "bw" if bw else "tc"
    if conv:
        f, k = m.out_channels, m.kh * m.kw * m.in_channels
        kernel = getattr(conv_k, f"vdbb_im2col_conv_{mode}")
        plain = getattr(conv_k, f"vdbb_im2col_conv_{mode}_plain")
        geom, taps = dict(stride=m.stride, padding=m.padding), (m.kh, m.kw)
        dw = dbb_encode_conv(rnd(gen, dev, m.kh, m.kw, m.in_channels, f, scale=k ** -0.5),
                             fmt, prune=True)
    else:
        f, k = m.out_features, m.in_features
        kernel = getattr(head_k, f"vdbb_matmul_{mode}")
        plain = getattr(head_k, f"vdbb_matmul_{mode}_plain")
        geom, taps = {}, ()
        dw = dbb_encode(rnd(gen, dev, k, f, scale=k ** -0.5), fmt, prune=True)

    def idx(w):
        return w.indices if bw else w.indices[:, :, 0].contiguous()

    qw = quantize_dbb(dw)
    bias = rnd(gen, dev, f, scale=0.5)
    xq = codes(gen, dev, *xshape)
    kc = qw.values.shape[0] * qw.values.shape[1]
    # the int8 instantiation's tile rows and A staging on the tensor cores:
    # the bw kernels copy A in chunks, the tc kernels gather it
    rows = xshape[0] * (math.prod(m.out_hw(xshape[1], xshape[2])) if conv else 1)
    if bw:
        tile = mma_plan(what, rows, k, xshape[-1], xq.data_ptr())
    elif conv:
        tile = mma_tap_plan(what, rows, kc, m.kh, m.kw, xshape[2], xshape[-1])
    else:
        tile = mma_gather_plan(what, rows, kc)
    scales = dequant_scales(gen, dev, f, kc)
    args = (xq, qw.values, idx(qw), fmt, *taps)
    kw = dict(scales=scales, bias=bias, **geom)
    if conv:
        kw.update(relu=True, out_scale=out_scale)
    run = lambda: kernel(*args, **kw)  # noqa: E731
    err = check_exact(run(), plain(*args, **kw), f"{what} int8")
    if tile.gathered:
        seen = require_instance(run, "os_mma", "TapMux" if conv else "GatherMux", what)
        log(f"[kernels] {what}: {tile}; the profiler saw {seen}")
    check_exact(kernel(*args, **geom), plain(*args, **geom), f"{what} int32")
    if not conv:  # the head at each request batch: fp32 dequant, int32, int8 codes
        for b in (1, 8, xshape[0]):
            ab = (xq[:b].contiguous(), *args[1:])
            for kwb in (kw, {}, dict(kw, relu=True, out_scale=0.05)):
                check_exact(kernel(*ab, **kwb), plain(*ab, **kwb), f"{what} int8 at batch {b}")
    a32 = (rnd(gen, dev, *xshape), dw.values, idx(dw), fmt, *taps)
    k32 = dict(bias=bias, relu=conv, **geom)
    check_close(kernel(*a32, **k32), plain(*a32, **k32), f"{what} fp32")
    if conv:
        xn = a32[0].permute(0, 3, 1, 2).contiguous()
        wn = dbb_decode(dw).reshape(m.kh, m.kw, m.in_channels, f).permute(3, 2, 0, 1).contiguous()
        library = lambda: F.conv2d(xn, wn, bias, stride=m.stride, padding=1)  # noqa: E731
    else:
        wdense = dbb_decode(qw.as_dbb()).contiguous()
        library = lambda: torch._int_mm(xq, wdense)  # noqa: E731
    out = run()
    # the real tensors' bytes (values plus the shared or per-column positions)
    # and the compressed MACs at the int8 tensor-core rate
    nb_ = nbytes(xq, qw.values, args[2], scales, bias, out)
    ops = 2 * out.numel() * kc
    b_ms, b_by = bound(nb_, ops, INT8_OPS_PER_S)
    staging = f"{tile.chunk} B chunks" if not tile.gathered else "A gathered in byte lanes"
    rec = timed(run, lambda: plain(*args, **kw), library, err=err, bound_ms=b_ms,
                bound_by=b_by, bytes=nb_, ops=ops, plan=f"{tile.tile_rows}x64 tile, {staging}",
                out_bytes=nbytes(out))
    if conv and not bw:
        # information only: the same product as one torch._int_mm over the
        # compressed im2col matrix gathered beforehand, the gather left out
        cols = im2col_explicit(xq, m.kh, m.kw, **geom).reshape(rows, -1)
        ac = gather_compressed(cols, args[2], fmt.bz).contiguous()
        wc = qw.values.reshape(kc, f).contiguous()
        check_exact(torch._int_mm(ac, wc), kernel(*args, **geom).reshape(rows, f),
                    f"{what} torch._int_mm over the gathered matrix")
        rec["gemm_device_ms"] = device_ms(lambda: torch._int_mm(ac, wc))
        # the latency point: the same layer at request batch 1, checked and timed
        a1 = (xq[:1].contiguous(), *args[1:])
        check_exact(kernel(*a1, **kw), plain(*a1, **kw), f"{what} int8 at batch 1")
        rec["device_ms_b1"] = device_ms(lambda: kernel(*a1, **kw), keep=port_kernel)
    return rec


def log_record(label, name, xshape, r):
    def ms(v):
        return str(v if v is None else round(v, 4))

    log(f"[kernels] {label:<13s} {name:<15s} {str(tuple(xshape)):<23s} {r['ms']:<8.4f} "
        f"{ms(r['device_ms']):<10s} {r['plain_ms']:<9.4f} {r['library_ms']:<11.4f} "
        f"{ms(r['library_device_ms']):<11s} {r['bound_ms']:.5f} ({r['bound_by']})"
        + (f"  [{r['plan']}]" if r.get("plan") else "")
        + (f"  torch._int_mm over the gathered matrix: device {ms(r['gemm_device_ms'])};"
           f" at batch 1: device {ms(r['device_ms_b1'])}" if "gemm_device_ms" in r else ""))


def check_kernels(cfgs, gen, dev):
    """Phase 2. ``cfgs`` maps a pattern ('matrix' or None) to its model's
    config. Every layer of each model at batch 64 through its kernel, then
    a grouped format and the nnz sweep. Returns per-kernel records of the
    models' layers for the JSON line."""
    from repro_torch.core.vdbb import DBBFormat
    from repro_torch.kernels import build

    recs = {name: [] for name in build.KERNELS}
    log(f"[kernels] layer         kernel          shape                   ms       device_ms  "
        f"plain_ms  library_ms  lib_dev_ms  bound_ms (by)")
    for pattern, cfg in cfgs.items():
        mode = "tc" if pattern == "matrix" else "bw"
        layers = layer_shapes(cfg, BATCH)
        n_conv = len(layers) - 1
        for li, (m, xshape) in enumerate(layers):
            out_scale = 0.05 if li + 1 < n_conv else None  # l7 flushes fp32 into GAP
            if li == 0:
                if mode != "tc":
                    continue  # one dense stem serves both models
                name, r = "im2col_conv", stem_layer(m, xshape, out_scale, gen, dev)
            else:
                name = ("vdbb_matmul_" if li == n_conv else "vdbb_conv_") + mode
                r = sparse_layer(m, xshape, m.fmt, mode == "bw", out_scale, gen, dev,
                                 f"{mode} l{li}")
            recs[name].append(r)
            log_record(f"{mode} l{li}", name, xshape, r)

    layers = layer_shapes(cfgs[None], BATCH)
    grouped = DBBFormat(8, 3, 4)
    for li in (4, len(layers) - 1):
        m, xshape = layers[li]
        name = "vdbb_conv_bw" if li < len(layers) - 1 else "vdbb_matmul_bw"
        r = sparse_layer(m, xshape, grouped, True, 0.05, gen, dev, f"group=4 l{li}")
        log_record(f"g4 l{li}", name, xshape, r)
    # the paper's variable density: nnz of 8 at l4's shape, both modes
    m, xshape = layers[4]
    for nnz in (1, 2, 4, 8):
        for mode, group in (("tc", "matrix"), ("bw", None)):
            r = sparse_layer(m, xshape, DBBFormat(8, nnz, group), mode == "bw", 0.05, gen, dev,
                             f"nnz={nnz} {mode} l4")
            log_record(f"nnz{nnz} {mode} l4", f"vdbb_conv_{mode}", xshape, r)
    return recs


def log_summary(recs) -> None:
    """Each conv kernel's device time beside the library conv's, in sum and
    layer by layer, and the bw convs' beside their tc twins'; the tc convs'
    beside torch._int_mm's over the pre-gathered matrices; each head's beside
    torch._int_mm's; the stem's beside F.conv2d's."""
    def total(rs, key):
        vals = [r[key] for r in rs]
        return None if None in vals else round(sum(vals), 5)

    def ratios(num, den, key="device_ms"):
        return [None if None in (a["device_ms"], b[key]) else round(a["device_ms"] / b[key], 3)
                for a, b in zip(num, den)]

    bw, tc = recs["vdbb_conv_bw"], recs["vdbb_conv_tc"]
    for mode, rs in (("tc", tc), ("bw", bw)):
        log(f"[kernels] {mode} convs: device {total(rs, 'device_ms')} ms, library conv device "
            f"{total(rs, 'library_device_ms')} ms; per layer {mode}/library device "
            f"{ratios(rs, rs, 'library_device_ms')}")
    log(f"[kernels] tc convs: torch._int_mm over the gathered matrices, device "
        f"{total(tc, 'gemm_device_ms')} ms; at batch 1, device {total(tc, 'device_ms_b1')} ms; "
        f"per layer bw/tc device {ratios(bw, tc)}")
    for mode in ("bw", "tc"):
        head = recs[f"vdbb_matmul_{mode}"]
        log(f"[kernels] {mode} head: device {total(head, 'device_ms')} ms, torch._int_mm device "
            f"{total(head, 'library_device_ms')} ms")
    stem = recs["im2col_conv"]
    log(f"[kernels] stem: device {total(stem, 'device_ms')} ms, F.conv2d device "
        f"{total(stem, 'library_device_ms')} ms")


# --------------------------------------------------------------- phase 2b

RESNET_SMOKE = False  # the arch's reduced config (a CPU rehearsal of this phase)
# (label, counted kernel, input shape, F, k, stride, residual): ResNet-50
# v1.5's convs at stage 1's and stage 4's shapes, the strided 1 x 1
# projection into stage 2, and a strided 3 x 3 on the residual instance
RESNET_LAYERS = (
    ("stage1 c1", "vdbb_conv_tc", (BATCH, 56, 56, 256), 64, 1, 1, False),
    ("stage1 c3", "vdbb_conv_tc_residual", (BATCH, 56, 56, 64), 256, 1, 1, True),
    ("stage2 proj", "vdbb_conv_tc", (BATCH, 56, 56, 256), 512, 1, 2, False),
    ("3x3 stride 2", "vdbb_conv_tc_residual", (BATCH, 56, 56, 128), 128, 3, 2, True),
    ("stage4 c1", "vdbb_conv_tc", (BATCH, 7, 7, 2048), 512, 1, 1, False),
    ("stage4 c3", "vdbb_conv_tc_residual", (BATCH, 7, 7, 512), 2048, 1, 1, True),
)
# one replay of resnet50-v1.5: the stem and its max-pool, 16 blocks' first
# two convs and 4 projections on the tc conv, 16 last convs on its residual
# instance, the head on the tc matmul
RESNET_REPLAY = {"im2col_conv": 1, "im2col_conv_maxpool": 1, "vdbb_conv_tc": 36,
                 "vdbb_conv_tc_residual": 16, "vdbb_matmul_tc": 1, "vdbb_matmul_tc_bf16": 0,
                 "vdbb_matmul_tc_wgmma": 0, "vdbb_conv_bw": 0, "vdbb_matmul_bw": 0}


def resnet_conv(label, xshape, f, k, stride, residual, gen, dev):
    """One of ResNet's compressed convs on the tc conv (3/8, a pattern
    shared across F), int8 codes in: int8 codes out exactly the plain
    version's, and with the residual the last block's fp32 flush too; the
    profiler sees the mux (PointMux at 1 x 1, TapMux at 3 x 3) and, with
    the residual, the ResidualFlush instance. Returns the timed record
    (library: F.conv2d fp32 on the decoded weight, plus the shortcut)."""
    from repro_torch.core.quant import quantize_dbb
    from repro_torch.core.vdbb import DBBFormat, dbb_decode, dbb_encode_conv
    from repro_torch.kernels import vdbb_im2col_conv as conv_k
    from repro_torch.kernels.core import mma_tap_plan

    fmt = DBBFormat(8, 3, "matrix")
    n, h, w, c = xshape
    p = k // 2
    ho, wo = (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1
    dw = dbb_encode_conv(rnd(gen, dev, k, k, c, f, scale=(k * k * c) ** -0.5), fmt, prune=True)
    qw = quantize_dbb(dw)
    idx = qw.indices[:, :, 0].contiguous()
    xq = codes(gen, dev, *xshape)
    kc = qw.values.shape[0] * qw.values.shape[1]
    res = (codes(gen, dev, n, ho, wo, f), torch.tensor(0.02, device=dev)) if residual else None
    bias = rnd(gen, dev, f, scale=0.5)
    kw = dict(scales=dequant_scales(gen, dev, f, kc), bias=bias, relu=True, out_scale=0.05,
              stride=stride, padding=((p, p), (p, p)), residual=res)
    args = (xq, qw.values, idx, fmt, k, k)
    run = lambda: conv_k.vdbb_im2col_conv_tc(*args, **kw)  # noqa: E731
    plain = lambda: conv_k.vdbb_im2col_conv_tc_plain(*args, **kw)  # noqa: E731
    what = f"resnet {label}"
    err = check_exact(run(), plain(), f"{what} int8")
    if residual:
        k32 = dict(kw, out_scale=None)
        check_exact(conv_k.vdbb_im2col_conv_tc(*args, **k32),
                    conv_k.vdbb_im2col_conv_tc_plain(*args, **k32), f"{what} fp32 flush")
    seen = require_instance(run, "os_mma", "PointMux" if k == 1 else "TapMux", what)
    if residual != ("ResidualFlush" in seen):
        raise AssertionError(f"{what}: the profiler saw {seen}, residual={residual}")
    tile = mma_tap_plan(what, n * ho * wo, kc, k, k, w, c)
    xn = rnd(gen, dev, n, c, h, w)
    wn = dbb_decode(dw).reshape(k, k, c, f).permute(3, 2, 0, 1).contiguous()
    rn = rnd(gen, dev, n, f, ho, wo) if residual else 0.0
    library = lambda: F.conv2d(xn, wn, bias, stride=stride, padding=p) + rn  # noqa: E731
    out = run()
    # a strided 1 x 1 conv reads only the pixels it lands on
    x_bytes = n * ho * wo * c if k == 1 else xq.numel()
    nb_ = x_bytes + nbytes(qw.values, idx, kw["scales"], bias, out, *(res or ()))
    ops = 2 * out.numel() * kc
    b_ms, b_by = bound(nb_, ops, INT8_OPS_PER_S)
    return timed(run, plain, library, err=err, bound_ms=b_ms, bound_by=b_by, bytes=nb_, ops=ops,
                 plan=f"{tile.tile_rows}x64 tile, {seen.split('(')[0]}", out_bytes=nbytes(out))


def resnet_maxpool(gen, dev, xshape):
    """The max-pool after the stem (3 x 3, stride 2, pad 1) on int8 codes:
    exactly the plain version (F.max_pool2d), its kernel seen by the
    profiler. Returns the timed record (library: F.max_pool2d on fp32)."""
    from repro_torch.kernels import maxpool as pool_k

    xq = codes(gen, dev, *xshape)
    run = lambda: pool_k.maxpool(xq, 3, 2, 1)  # noqa: E731
    plain = lambda: pool_k.maxpool_plain(xq, 3, 2, 1)  # noqa: E731
    err = check_exact(run(), plain(), "resnet max-pool")
    seen = require_instance(run, "maxpool", "Geometry", "resnet max-pool")
    xn = rnd(gen, dev, xshape[0], xshape[3], xshape[1], xshape[2])
    library = lambda: F.max_pool2d(xn, 3, 2, 1)  # noqa: E731
    out = run()
    nb_ = nbytes(xq, out)
    b_ms, b_by = bound(nb_, 0, INT8_OPS_PER_S)
    return timed(run, plain, library, err=err, bound_ms=b_ms, bound_by=b_by, bytes=nb_, ops=0,
                 plan=seen.split("(")[0], out_bytes=nbytes(out))


def resnet_phase(gen, dev) -> dict:
    """Phase 2b: ResNet-50 v1.5's new pieces at batch 64 against their plain
    versions and timed (the 7 x 7 stride-2 stem on its direct path, the
    max-pool, the tc conv's 1 x 1 PointMux and residual instances at stage
    1's and stage 4's shapes, a strided 1 x 1 and 3 x 3); then the full-size
    model, seeded and calibrated, served through its plan at bucket 64 with
    the launch counts at 0 just before: the plan's logits equal the
    unplanned INT8 forward's bit for bit, one replay launches
    RESNET_REPLAY, the two timed in turns (unplanned, planned, planned,
    unplanned) on CUDA events, and the profiler's device time per kernel
    and idle share over planned forwards. Returns the records
    ({kernel: [record]}), the replay's launches and the timings."""
    from repro_torch.configs.cnn import get_cnn_config, smoke_cnn_config
    from repro_torch.kernels import build
    from repro_torch.kernels.timing import event_ms
    from repro_torch.launch import serve
    from repro_torch.models.cnn import SparseCNN

    recs = {"vdbb_conv_tc_residual": [], "im2col_conv_maxpool": []}
    cfg = (smoke_cnn_config if RESNET_SMOKE else get_cnn_config)("resnet50-v1.5")
    stem = SparseCNN(cfg).layers()[0]
    h = cfg.image_size
    r = stem_layer(stem, (BATCH, h, h, stem.in_channels), 0.05, gen, dev)
    log_record("resnet stem", "im2col_conv", (BATCH, h, h, stem.in_channels), r)
    ho = stem.out_hw(h, h)[0]
    shape = (BATCH, ho, ho, stem.out_channels)
    r = resnet_maxpool(gen, dev, shape)
    recs["im2col_conv_maxpool"].append(r)
    log_record("resnet pool", "im2col_conv_maxpool", shape, r)
    for label, name, xshape, f, k, stride, residual in RESNET_LAYERS:
        r = resnet_conv(label, xshape, f, k, stride, residual, gen, dev)
        if name in recs:
            recs[name].append(r)
        log_record(f"resnet {label}", name, xshape, r)

    model, x = serve.build_model("resnet50-v1.5", calib_batch=BATCH, device=dev, seed=5,
                                 smoke=RESNET_SMOKE)
    build.reset_launches()
    ps = model.plan_set(buckets=(BATCH,), tune="off")
    with torch.no_grad():
        got, want = ps.serve(x), model(x)
    check_exact(got, want, "resnet50-v1.5 plan against the unplanned INT8 forward")
    graphs = ps.plans[BATCH].graph_launches
    replayed = next(iter(graphs.values())) if graphs else {}
    if replayed != RESNET_REPLAY:
        raise AssertionError(f"resnet50-v1.5: one replay launches {replayed}, "
                             f"want {RESNET_REPLAY}")
    log(f"[resnet] plan at bucket {BATCH}: logits equal the unplanned INT8 forward's; one "
        f"replay launches {replayed}")
    with torch.no_grad():
        turns = [event_ms(lambda fn=fn: fn(x), REPS) for fn in (model, ps.serve, ps.serve, model)]
    timing = {"unplanned_ms": (turns[0] + turns[3]) / 2, "planned_ms": (turns[1] + turns[2]) / 2,
              "turns_ms": turns}
    prof = profile_forwards(ps.serve, x, RESNET_REPLAY)
    log(f"[resnet] in turns: {json.dumps(timing)}; planned at batch {BATCH}: per forward "
        f"{json.dumps(prof)}")
    del model, x, ps
    return {"recs": recs, "replayed": replayed, "timing": timing, "profile": prof}


# ---------------------------------------------------------------- phase 3

# launches per forward of each serving path: the other mode's kernels at 0
PER_FORWARD = {
    "matrix": {"im2col_conv": 1, "vdbb_conv_tc": 7, "vdbb_matmul_tc": 1,
               "vdbb_matmul_tc_bf16": 0, "vdbb_matmul_tc_wgmma": 0, "vdbb_conv_bw": 0,
               "vdbb_matmul_bw": 0, "vdbb_conv_tc_residual": 0, "im2col_conv_maxpool": 0},
    None: {"im2col_conv": 1, "vdbb_conv_tc": 0, "vdbb_matmul_tc": 0,
           "vdbb_matmul_tc_bf16": 0, "vdbb_matmul_tc_wgmma": 0, "vdbb_conv_bw": 7,
           "vdbb_matmul_bw": 1, "vdbb_conv_tc_residual": 0, "im2col_conv_maxpool": 0},
}


def plain_version(w, tc_plain, bw_plain):
    """The plain version for a compressed weight's pattern, and the indices
    it takes: one row shared across the outputs (tc) or as stored (bw)."""
    if w.fmt.group_size(w.shape[1]) == w.shape[1]:
        return tc_plain, w.indices[:, :, 0].contiguous()
    return bw_plain, w.indices


def plain_chain(model, x):
    """The int8-resident chain through the kernels' plain versions, on the
    same card: the yardstick of the served logits."""
    from repro_torch.core.quant import QuantDBBWeight, resolve_quant_input
    from repro_torch.kernels import im2col_conv as stem_k
    from repro_torch.kernels import vdbb_im2col_conv as conv_k
    from repro_torch.kernels import vdbb_matmul as head_k

    layers = model.layers()
    convs, head = layers[:-1], layers[-1]
    stem_out = None
    for i, m in enumerate(convs):
        out_scale = convs[i + 1].aq if i + 1 < len(convs) else None
        conv = dict(bias=m.b, relu=True, out_scale=out_scale, stride=m.stride,
                    padding=m.padding)
        if isinstance(m.w, QuantDBBWeight):
            fn, idx = plain_version(m.w, conv_k.vdbb_im2col_conv_tc_plain,
                                    conv_k.vdbb_im2col_conv_bw_plain)
            x = fn(x, m.w.values, idx, m.w.fmt, m.kh, m.kw, scales=m.aq * m.w.scales, **conv)
        else:
            x = stem_k.im2col_conv_plain(x, m.w, **conv)
            stem_out = x
    xq, s_a = resolve_quant_input(x.mean(dim=(1, 2)), head.aq)
    fn, idx = plain_version(head.w, head_k.vdbb_matmul_tc_plain, head_k.vdbb_matmul_bw_plain)
    logits = fn(xq, head.w.values, idx, head.w.fmt, scales=s_a * head.w.scales, bias=head.b)
    return logits, stem_out


def end_to_end(dev, pattern):
    """Phase 3: serve sparse-cnn-s with ``pattern`` through ``launch.serve``
    with every launch count at 0 just before; returns (the launches of that
    run, images/s per request batch, the model, its inputs)."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    build.reset_launches()
    model, x, served = serve.serve("sparse-cnn-s", batches=(1, 8, BATCH), pattern=pattern,
                                   requests=REQUESTS, device=dev, seed=0, plan=False, log=log)
    main_counts = build.launch_counts()
    want = PER_FORWARD[pattern]
    idle = [k for k, n in want.items() if n and not main_counts[k]]
    if idle:
        raise AssertionError(f"pattern={pattern}: kernels {idle} never launched on the main path")
    for b, r in served.items():
        if r["launches_per_forward"] != want:
            raise AssertionError(f"pattern={pattern} batch {b}: launches per forward "
                                 f"{r['launches_per_forward']}, want {want}")
        logits = r["logits"]
        if logits.shape != (b, 1000) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"batch {b}: logits {tuple(logits.shape)} not finite (b, 1000)")
        # the served logits of each request batch against the plain chain on
        # the same images; a rerun with intermediates gives the stem codes
        xb = x[:b].contiguous()
        with torch.no_grad():
            inter = []
            check_exact(model(xb, intermediates=inter), logits, f"batch {b}: rerun logits")
            ref, ref_stem = plain_chain(model, xb)
        check_codes(inter[0], ref_stem, f"batch {b}: served stem codes")
        if torch.equal(inter[0], ref_stem):
            check_exact(logits, ref, f"batch {b}: served logits")
            log(f"[serve] pattern={pattern} batch {b}: logits equal the plain chain's on the card")
        else:
            err = rel_l2(logits, ref)
            if err > 1e-3:
                raise AssertionError(f"batch {b}: served logits rel L2 {err} > 1e-3 "
                                     "vs the plain chain")
            log(f"[serve] pattern={pattern} batch {b}: logits within rel L2 {err:.3e} of the "
                "plain chain's")
    return main_counts, {b: r["images_per_s"] for b, r in served.items()}, model, x


# ------------------------------------------------------------ where the time goes

# kernel template -> {operand loader or stager -> kernel}, first match wins.
# On os_gemm (the CUDA cores: fp32, and the stem's int8) the bw conv's A
# loader is the stem's Tap, so its B loader (the expand) decides; on os_mma
# (the int8 tensor cores) the A stager decides (the bw kernels' cp.async
# chunks, the tc kernels' gathers); bf16_mma (the bf16 tensor cores) runs
# only the tc matmul's bf16 gather; the stem's direct conv is a template of
# its own.
KERNEL_OF_LOADER = {
    # the tc conv's residual instance (a ResNet block's last conv): os_mma
    # with its flush's type in the name, so it is matched first
    "ResidualFlush": {"PointMux": "vdbb_conv_tc_residual", "TapMux": "vdbb_conv_tc_residual"},
    "maxpool": {"Geometry": "im2col_conv_maxpool"},
    # the tc matmul's staged int8 core at prefill rows (wgmma): its name
    # (os_mma_sm90::kernel<nnz, GatherMuxSmem>) holds os_mma's and
    # GatherMux's too, so it is matched first
    "sm90": {"GatherMuxSmem": "vdbb_matmul_tc_wgmma"},
    "os_mma": {"TapChunks": "vdbb_conv_bw", "RowChunks": "vdbb_matmul_bw",
               "GatherMux": "vdbb_matmul_tc", "TapMux": "vdbb_conv_tc",
               "PointMux": "vdbb_conv_tc"},
    "bf16_mma": {"WordGather": "vdbb_matmul_tc_bf16"},
    "os_gemm": {"ExpandTaps": "vdbb_conv_bw", "ExpandCols": "vdbb_matmul_bw",
                "GatherTap": "vdbb_conv_tc", "GatherCols": "vdbb_matmul_tc",
                "Tap": "im2col_conv"},
    "direct_conv": {"HaloTile": "im2col_conv"},
}


def kernel_family(name: str) -> str:
    """The port's kernel a CUDA kernel name belongs to, else 'other'. The
    kernels are instances of three GEMM templates told apart by their
    operand loaders, and of the stem's direct conv; ``name`` may be demangled
    (``os_mma::kernel<128, 16, ..., TapChunks, ExpandTile>(...)``) or
    mangled (``_ZN6os_mma6kernel...``), so the names are matched as
    substrings."""
    for core, loaders in KERNEL_OF_LOADER.items():
        if core in name:
            for loader, kernel in loaders.items():
                if loader in name:
                    return kernel
    return "other"


def profile_forwards(fn, x, per_forward, reps: int = 4) -> dict:
    """Device time per kernel and the device's idle share over ``reps``
    served forwards ``fn(x)`` (the model, or a plan's serve), from
    torch.profiler's CUDA activity. Idle is the share
    of the host-clock window in which no kernel ran. A pass may deliver only
    some of its kernel records, so a port kernel's time is the mean of its
    records times its launches (``per_forward`` a forward); ``records``
    gives how many came, to set against those launches. Device-side copies
    of spans (a plan serve's ``plan.replay`` runs from its first kernel to
    its last) are no work and are left out."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.spans import is_span

    with torch.no_grad():
        fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    spans, dur, other = [], {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or is_span(ev):
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        fam = kernel_family(ev.name)
        dur.setdefault(fam, []).append(b - a)
        if fam == "other":
            other[ev.name[:80]] = other.get(ev.name[:80], 0.0) + (b - a)
    per = {fam: (sum(d) / len(d) * per_forward[fam] * reps if per_forward.get(fam) else sum(d))
           / reps / 1e3 for fam, d in dur.items()}
    records = {fam: len(d) for fam, d in dur.items()}
    if not spans:
        return {"device_ms": None, "wall_ms": wall_us / reps / 1e3, "idle": None, "per_kernel_ms": {}}
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    return {"device_ms": busy / reps / 1e3, "wall_ms": wall_us / reps / 1e3,
            "idle": max(0.0, 1.0 - busy / wall_us), "per_kernel_ms": per, "records": records,
            "top_other_ms": {name: us / reps / 1e3 for name, us in top}}


# ---------------------------------------------------------------- phase 4


def golden(dev, pattern):
    """Phase 4: the JAX reference's fixture of ``pattern`` through the port
    on the card."""
    import numpy as np

    from repro_torch.configs import smoke_cnn_config
    from repro_torch.interop import params_from_numpy, unflatten
    from repro_torch.models.cnn import SparseCNN

    with np.load(FIXTURES[pattern]) as z:
        tree = unflatten(z)
    cfg = dataclasses.replace(smoke_cnn_config("sparse-cnn-tiny", pattern=pattern),
                              convs_per_stage=2)
    model = SparseCNN(cfg).load_state(params_from_numpy(tree["params"], dev))
    x = torch.as_tensor(tree["input"]).to(dev)
    want_inter = [torch.as_tensor(tree["intermediates"][str(i)]).to(dev)
                  for i in range(len(tree["intermediates"]))]
    with torch.no_grad():
        inter = []
        logits = model(x, intermediates=inter)
        check_codes(inter[0], want_inter[0], "fixture stem codes")
        convs = model.layers()[:-1]
        for i in range(1, len(convs)):
            out_scale = convs[i + 1].aq if i + 1 < len(convs) else None
            got = convs[i].quant_serve(want_inter[i - 1], relu=True, out_scale=out_scale)
            check_exact(got, want_inter[i], f"fixture layer l{i}")
        head = model.layers()[-1].quant_serve(torch.as_tensor(tree["pooled"]).to(dev))
        check_exact(head, torch.as_tensor(tree["logits"]).to(dev), "fixture head")
    err = rel_l2(logits, torch.as_tensor(tree["logits"]).to(dev))
    if err > 1e-3:
        raise AssertionError(f"fixture logits: rel L2 {err} > 1e-3 vs JAX")
    log(f"[golden] JAX fixture, pattern={pattern}: layers exact, logits within rel L2 {err:.3e}")


# ---------------------------------------------------------------- phase 5

SERVER_REQUESTS = 256


def check_nan_same(got, want, what: str, exact: bool = True) -> None:
    """NaN exactly where the plain version has NaN; elsewhere equal, or for
    the stem within its tolerances (``exact`` False: fp32 summation order)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against the plain "
                             f"version's {want.dtype} {tuple(want.shape)}")
    if got.dtype.is_floating_point:
        if not torch.equal(got.isnan(), want.isnan()):
            raise AssertionError(f"{what}: NaN where the plain version has none, or none "
                                 "where it has NaN")
        got, want = got.nan_to_num(0.0), want.nan_to_num(0.0)
    if exact:
        check_exact(got, want, what)
    elif got.dtype.is_floating_point:
        check_close(got, want, what)
    else:
        check_codes(got, want, what)


def solo(plan_set, x):
    """Each image of ``x`` served alone through the bucket-1 plan."""
    return torch.cat([plan_set.plans[1].serve(x[i: i + 1]) for i in range(x.shape[0])])


def planned_path(dev, pattern) -> dict:
    """Phase 5 for one pattern; the launch counts at 0 just before it. Returns
    the record of the phase: launches (counted at capture and eager warm-up),
    the launches its graphs replayed, the timings and the server's summary."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.timing import event_ms
    from repro_torch.launch import serve
    from repro_torch.launch.faults import FaultInjector
    from repro_torch.launch.server import CNNServer, NumericalFault, auto_rate
    from repro_torch.models.plan import StalePlanError

    t0 = time.time()
    build.reset_launches()
    model, x = serve.build_model("sparse-cnn-s", calib_batch=BATCH, device=dev, seed=0,
                                 pattern=pattern)
    ps = model.plan_set(max_batch=BATCH)
    traces = ps.warmup()
    if ps.buckets != (1, 2, 4, 8, 16, 32, 64) or traces != 7:
        raise AssertionError(f"pattern={pattern}: buckets {ps.buckets}, {traces} captures at "
                             "warmup; want 1 … 64 and 7")
    want = PER_FORWARD[pattern]
    with torch.no_grad():
        for b in (1, 8, BATCH):
            xb = x[:b].contiguous()
            check_exact(ps.plans[b].serve(xb), model(xb), f"pattern={pattern} batch {b}: "
                        "planned logits against the unplanned forward")
        for b in ps.buckets:
            got = next(iter(ps.plans[b].graph_launches.values()))
            if {k: got.get(k, 0) for k in want} != want:
                raise AssertionError(f"pattern={pattern} bucket {b}: a replay launches {got}, "
                                     f"want {want}")
        gen = torch.Generator().manual_seed(2)
        x100 = torch.randn(100, *x.shape[1:], generator=gen).to(dev)
        for n in (5, 100):
            check_exact(ps.serve(x100[:n]), solo(ps, x100[:n]),
                        f"pattern={pattern} ragged {n}: served against each image alone")
    # no host sync inside a serve of tensors on the card, on this thread or
    # another (the server's dispatcher replays what warmup captured here)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in (1, 8, BATCH):
            ps.plans[b].serve(x[:b])
        ps.serve(x100[:5])
        errors = []

        def other_thread():
            try:
                ps.serve(x100)
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        worker = threading.Thread(target=other_thread)
        worker.start()
        worker.join(60)
        if worker.is_alive() or errors:
            raise AssertionError(f"pattern={pattern}: a serve on another thread: {errors}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[plan] pattern={pattern}: {traces} captures at warmup; replays equal the unplanned "
        f"forward at batches 1, 8, 64, ragged 5 and 100 equal each image alone; no host sync "
        f"inside a serve (sync debug mode 'error'), on this thread or another; a replay "
        f"launches {want}; tiles at 64: {json.dumps(ps.tiles[BATCH])}")

    # timing in turns: unplanned, planned, planned, unplanned
    turns = {}
    with torch.no_grad():
        for b in (1, 8, BATCH):
            xb = x[:b].contiguous()
            fns = {"unplanned": lambda: model(xb), "planned": lambda: ps.plans[b].serve(xb)}
            for name in ("unplanned", "planned", "planned", "unplanned"):
                turns.setdefault(b, {}).setdefault(name, []).append(event_ms(fns[name], 50))
    timing = {}
    for b, r in turns.items():
        timing[b] = {k: (v if b != BATCH else [b / (t / 1e3) for t in v]) for k, v in r.items()}
    log(f"[plan] pattern={pattern} in turns (unplanned, planned, planned, unplanned; CUDA "
        f"events over 50 calls): ms per request at batch 1 {json.dumps(timing[1])}, at batch "
        f"8 {json.dumps(timing[8])}; images/s at batch 64 {json.dumps(timing[BATCH])}")
    profiles = {}
    for b in (1, BATCH):
        xb = x[:b].contiguous()
        prof = profile_forwards(ps.plans[b].serve, xb, want, reps=20)
        seen = [k for k, n in want.items() if n and prof["records"].get(k)] \
            if prof["device_ms"] is not None else []
        missing = [k for k, n in want.items() if n and k not in seen]
        note = ("the profiler saw every kernel inside the graph replays" if not missing else
                f"the profiler dropped {missing} inside the graph replays: their launches are "
                "the capture's counts")
        profiles[b] = prof
        log(f"[profile] pattern={pattern} batch {b} planned: per forward {json.dumps(prof)}; "
            f"{note}")

    # the server: 256 Poisson requests of 1-8 images at half the capacity
    rng = np.random.default_rng(7)
    pool = x100.cpu().numpy()
    sizes = rng.integers(1, 9, SERVER_REQUESTS)
    starts = [int(rng.integers(0, pool.shape[0] - n + 1)) for n in sizes]
    requests = [pool[a: a + n] for a, n in zip(starts, sizes)]
    rate, bucket_us = auto_rate(ps, x.shape[1:])
    rate_rps = rate / float(sizes.mean())  # half the capacity in images, as requests
    log(f"[server] pattern={pattern}: auto rate {rate:.1f} images/s (bucket 64 takes "
        f"{bucket_us:.1f} us on the host path), {rate_rps:.1f} requests/s of "
        f"{float(sizes.mean()):.2f} images")
    run = serve.serve_continuous(ps, requests, rate=rate_rps, max_wait_ms=5.0, seed=3, log=log)
    if run["failures"] or any(r is None for r in run["results"]):
        raise AssertionError(f"pattern={pattern}: server failures {run['failures']}")
    if run["retraces_after_warmup"] != 0 or not run["summary"]["accounting_ok"]:
        raise AssertionError(f"pattern={pattern}: {run['retraces_after_warmup']} captures after "
                             f"warmup, books {run['summary']}")
    for i, (req, got) in enumerate(zip(requests, run["results"])):
        check_exact(torch.from_numpy(got), torch.from_numpy(ps.serve(req)),
                    f"pattern={pattern} server request {i}: against its own plan serve")
    # the same offer with the interpreter's switch interval cut from 5 ms to
    # 0.5 ms: how long the dispatcher waits for the lock the submitting
    # thread holds
    interval = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        fast = serve.serve_continuous(ps, requests, rate=rate_rps, max_wait_ms=5.0, seed=3,
                                      log=log)
    finally:
        sys.setswitchinterval(interval)
    if fast["failures"] or not fast["summary"]["accounting_ok"]:
        raise AssertionError(f"pattern={pattern}: server failures {fast['failures']}")
    for name, r in (("5 ms", run), ("0.5 ms", fast)):
        s = r["summary"]
        per_batch = s["completed"] / s["throughput_rps"] / s["batches"] * 1e3
        log(f"[server] pattern={pattern} switch interval {name}: p50 {s['p50_us']} us, p99 "
            f"{s['p99_us']} us, {s['throughput_rps']} images/s; {per_batch:.3f} ms of the run "
            f"(first arrival to last logits) per batch of {s['completed'] / s['batches']:.1f} "
            f"images, a batch's serve {r['health']['service_estimate_s'] * 1e3:.3f} ms (EMA)")

    # NaN through the server: an injected NaN row fails its request alone
    inj = FaultInjector()
    batch = [pool[16 * i: 16 * i + 16] for i in range(4)]  # 64 images: one flush by count
    inj.poison(batch[2], "nan")
    with CNNServer(ps, max_wait_ms=1000.0, faults=inj) as srv:
        srv.warmup()
        futures = [srv.submit(r) for r in batch]
        for i, f in enumerate(futures):
            if i == 2:
                try:
                    f.result(timeout=60)
                    raise AssertionError("the NaN-poisoned request completed")
                except NumericalFault:
                    pass
            else:
                check_exact(torch.from_numpy(f.result(timeout=60)),
                            torch.from_numpy(ps.serve(batch[i])), "poison's neighbour")
    if srv.stats.bucket_counts != {BATCH: 1} or srv.retraces_after_warmup:
        raise AssertionError(f"poisoned co-batch: {srv.stats.summary()}")
    # a NaN bias in the last conv: code 0 at the head's input, finite logits
    conv, head = model.layers()[-2], model.layers()[-1]
    saved = conv.b.clone(), head.b.clone()
    conv.b[3] = float("nan")
    few = [pool[i: i + 2] for i in range(0, 8, 2)]
    with CNNServer(model.plan_set(buckets=(1, 2, 4, 8)), max_wait_ms=1.0) as srv:
        srv.warmup()
        got = [srv.submit(r).result(timeout=60) for r in few]
    with torch.no_grad():
        ref = model(torch.from_numpy(np.concatenate(few)).to(dev)).cpu()
    if not bool(torch.isfinite(ref).all()):
        raise AssertionError("a NaN bias in the last conv gave non-finite logits")
    check_exact(torch.from_numpy(np.concatenate(got)), ref, "NaN last-conv bias through the server")
    # a NaN bias in the head: NaN logits, every request fails alone
    head.b[7] = float("nan")
    with CNNServer(model.plan_set(buckets=(1, 2, 4, 8)), max_wait_ms=1.0) as srv:
        srv.warmup()
        futures = [srv.submit(r) for r in few]
        faults = 0
        for f in futures:
            try:
                f.result(timeout=60)
            except NumericalFault:
                faults += 1
    s = srv.stats.summary()
    if faults != len(few) or s["completed"] or not s["accounting_ok"]:
        raise AssertionError(f"NaN head bias: {faults} NumericalFault of {len(few)}, {s}")
    log(f"[server] pattern={pattern} NaN: an injected NaN row failed its request alone in a "
        "64-image co-batch; a NaN last-conv bias gave finite logits equal to the unplanned "
        f"forward; a NaN head bias failed all {len(few)} requests with NumericalFault")
    if ps.trace_count != 7:
        raise AssertionError(f"pattern={pattern}: {ps.trace_count} captures, want 7")

    # staleness: the biases restored, the plan set passes its check; a
    # re-quantize in place fails it
    conv.b.copy_(saved[0])
    head.b.copy_(saved[1])
    ps.check(model.state())
    with torch.no_grad():
        _, stats = model(x * 2.0, collect_act_stats=True)
    model.quantize(stats)
    try:
        ps.check(model.state())
        raise AssertionError("a re-quantized model's plan set passed its check")
    except StalePlanError:
        pass
    torch.cuda.synchronize()
    counts = build.launch_counts()
    idle = [k for k, n in want.items() if n and not counts[k]]
    if idle:
        raise AssertionError(f"pattern={pattern}: kernels {idle} never launched on the planned path")
    replayed = {k: 0 for k in want}
    for b in ps.buckets:
        plan = ps.plans[b]
        for k, n in next(iter(plan.graph_launches.values())).items():
            replayed[k] = replayed.get(k, 0) + n * plan.replays
    log(f"[plan] pattern={pattern}: launches counted (eager warm-ups and captures) {counts}; "
        f"launched by graph replays {replayed}; StalePlanError after a re-quantize "
        f"({time.time() - t0:.1f} s)")
    return {"counts": counts, "replayed": replayed, "timing": timing, "profiles": profiles,
            "server": run["summary"], "server_fast_switch": fast["summary"]}


# ---------------------------------------------------------------- phase 6


def check_nan_flush(cfgs, gen, dev) -> None:
    """Phase 6: NaN and ±inf in the flush rows of every kernel at an
    sparse-cnn-s layer shape (batch 8), against the plain versions."""
    from repro_torch.core.quant import quantize_dbb
    from repro_torch.core.vdbb import dbb_encode, dbb_encode_conv
    from repro_torch.kernels import im2col_conv as stem_k
    from repro_torch.kernels import vdbb_im2col_conv as conv_k
    from repro_torch.kernels import vdbb_matmul as head_k

    def rows(f, scale):
        s = (torch.rand(f, generator=gen) + 1.0) * scale
        b = torch.randn(f, generator=gen)
        s[1], s[2] = float("nan"), float("inf")
        b[3], b[4], b[5] = float("nan"), float("-inf"), float("inf")
        nan_out = torch.full((f,), 0.05)
        nan_out[7] = float("nan")
        return s.to(dev), b.to(dev), nan_out.to(dev)

    def cases(s, b, nan_out):
        for relu in (False, True):
            for out_scale in (None, 0.05, nan_out):
                yield dict(scales=s, bias=b, relu=relu, out_scale=out_scale)

    n = 0
    for pattern, cfg in cfgs.items():
        mode = "tc" if pattern == "matrix" else "bw"
        layers = layer_shapes(cfg, 8)
        m, xshape = layers[4]
        f = m.out_channels
        dw = dbb_encode_conv(rnd(gen, dev, m.kh, m.kw, m.in_channels, f, scale=0.05), m.fmt,
                             prune=True)
        qw = quantize_dbb(dw)
        idx = qw.indices if mode == "bw" else qw.indices[:, :, 0].contiguous()
        args = (codes(gen, dev, *xshape), qw.values, idx, m.fmt, m.kh, m.kw)
        kernel = getattr(conv_k, f"vdbb_im2col_conv_{mode}")
        plain = getattr(conv_k, f"vdbb_im2col_conv_{mode}_plain")
        for kw in cases(*rows(f, 1e-4)):
            kw.update(stride=m.stride, padding=m.padding)
            check_nan_same(kernel(*args, **kw), plain(*args, **kw), f"{mode} conv NaN flush {kw}")
            n += 1
        hm, hshape = layers[-1]
        hw = quantize_dbb(dbb_encode(rnd(gen, dev, hm.in_features, hm.out_features, scale=0.05),
                                     hm.fmt, prune=True))
        hidx = hw.indices if mode == "bw" else hw.indices[:, :, 0].contiguous()
        hargs = (codes(gen, dev, *hshape), hw.values, hidx, hm.fmt)
        kernel = getattr(head_k, f"vdbb_matmul_{mode}")
        plain = getattr(head_k, f"vdbb_matmul_{mode}_plain")
        for kw in cases(*rows(hm.out_features, 1e-4)):
            check_nan_same(kernel(*hargs, **kw), plain(*hargs, **kw), f"{mode} head NaN flush")
            n += 1
    m, xshape = layer_shapes(cfgs["matrix"], 8)[0]
    x, w = rnd(gen, dev, *xshape), rnd(gen, dev, m.kh, m.kw, m.in_channels, m.out_channels,
                                       scale=0.2)
    for kw in cases(*rows(m.out_channels, 1.0)):
        kw.update(stride=m.stride, padding=m.padding)
        check_nan_same(stem_k.im2col_conv(x, w, **kw), stem_k.im2col_conv_plain(x, w, **kw),
                       "stem NaN flush", exact=False)
        n += 1
    torch.cuda.synchronize()
    log(f"[nan] {n} NaN/inf flush cases through the five kernels equal their plain versions "
        "(NaN through ReLU, NaN codes 0, ±inf clipped to ±127)")


# ---------------------------------------------------------------- phase 7

LM_ARCH = "starcoder2-7b"
LM_SMOKE = False  # the arch's reduced config (a CPU rehearsal of this phase)
LM_BATCH, LM_PROMPT, LM_GEN = 4, 256, 32
LM_KEEP = (0, 10, 20, 30)  # decode steps whose logits meet a fresh forward
LM_SHAPES = {"wq/wo": (4608, 4608, 2), "wk/wv": (4608, 512, 2), "w_up": (4608, 18432, 1),
             "w_down": (18432, 4608, 1)}  # (K, N, projections of the shape in a layer)
LM_ROWS = {"decode": LM_BATCH, "prefill": LM_BATCH * LM_PROMPT}
LM_FIXTURE = ROOT / "tests" / "data" / "torch_parity_lm.npz"


def lm_kernel(k, n, m, dtype, gen, dev, what):
    """The tc matmul at one starcoder2-7b projection shape and row count, in
    ``dtype`` (bf16: the generate path; int8: the INT8 plan's), against its
    plain version; returns the timed record."""
    from repro_torch.core.quant import quantize_dbb
    from repro_torch.core.vdbb import DBBFormat, dbb_decode, dbb_encode
    from repro_torch.kernels import vdbb_matmul as mm
    from repro_torch.kernels.core import bf16_mma_plan
    from repro_torch.kernels.ref import bf16_reorder_bound, check_bf16
    from repro_torch.kernels.timing import device_ms

    fmt = DBBFormat(8, 3, "matrix")
    dw = dbb_encode(rnd(gen, dev, k, n, scale=k ** -0.5), fmt, prune=True)
    idx = dw.indices[:, :, 0].contiguous()
    kc = dw.values.shape[0] * dw.values.shape[1]
    ops_ = 2 * m * kc * n
    if dtype == torch.bfloat16:
        a, vals = rnd(gen, dev, m, k).bfloat16(), dw.values.bfloat16().contiguous()
        run = lambda: mm.vdbb_matmul_tc(a, vals, idx, fmt)  # noqa: E731
        plain = lambda: mm.vdbb_matmul_tc_plain(a, vals, idx, fmt)  # noqa: E731
        order = bf16_reorder_bound(a, vals, idx, fmt.bz)
        err, beyond = check_bf16(run(), plain(), order, f"{what} bf16")
        wd = dbb_decode(dw).bfloat16().contiguous()
        library = lambda: a @ wd  # noqa: E731
        lib_call = "torch.matmul bf16 on the decoded dense weight"
        b_ms, b_by = bound(nbytes(a, vals, idx, run()), ops_, BF16_OPS_PER_S)
        plan = bf16_mma_plan("vdbb_matmul_tc", m, n, kc, (a.data_ptr(), vals.data_ptr()), k=k)
        rec = dict(err=err, beyond_plain_ulp=beyond, plan=dataclasses.asdict(plan))
    else:
        qw = quantize_dbb(dw)
        a, vals = codes(gen, dev, m, k), qw.values
        scales = dequant_scales(gen, dev, n, kc)
        # as the INT8 plan runs it: staged (the wgmma core at prefill rows),
        # and beside it the unstaged call (os_mma.cuh)
        staged, tiles = mm.stage_vdbb_matmul(qw.as_dbb(), m, scales=scales)
        run = lambda: staged(a)  # noqa: E731
        old = lambda: mm.vdbb_matmul_tc(a, vals, idx, fmt, scales=scales)  # noqa: E731
        plain = lambda: mm.vdbb_matmul_tc_plain(a, vals, idx, fmt, scales=scales)  # noqa: E731
        check_exact(run(), plain(), f"{what} int8 (fp32 dequant)")
        check_exact(old(), plain(), f"{what} int8 os_mma.cuh (fp32 dequant)")
        check_exact(mm.stage_vdbb_matmul(qw.as_dbb(), m)[0](a),
                    mm.vdbb_matmul_tc_plain(a, vals, idx, fmt), f"{what} int8 (int32)")
        wq = dbb_decode(qw.as_dbb()).contiguous()
        library, lib_call = (lambda: torch._int_mm(a, wq)), "torch._int_mm on the decoded int8 weight"  # noqa: E731
        try:
            library()
        except RuntimeError as e:  # the yardstick only: e.g. too few rows for _int_mm
            library, lib_call = None, f"none: torch._int_mm refused ({str(e).splitlines()[0]})"
        b_ms, b_by = bound(nbytes(a, vals, idx, scales, run()), ops_, INT8_OPS_PER_S)
        rec = dict(err=0.0, plan=tiles, os_mma_device_ms=device_ms(old, keep=port_kernel))
    from repro_torch.kernels.timing import event_ms

    rec.update(ms=event_ms(run, REPS), plain_ms=event_ms(plain, REPS),
               device_ms=device_ms(run, keep=port_kernel), bound_ms=b_ms, bound_by=b_by,
               ops=ops_, library_call=lib_call,
               library_ms=None if library is None else event_ms(library, REPS),
               library_device_ms=None if library is None else device_ms(library))
    return rec


def lm_kernels(gen, dev, shapes=None, dtypes=("bf16", "int8"), layers=32,
               unit="one layer's", rows=None) -> dict:
    """Phase 7a (8a at moonshot's shapes, bf16 only; 9a–11a at the other
    models'): {dtype name: {(shape, phase): record}} at each of ``shapes``
    (default ``LM_SHAPES``: (K, N, projections of the shape in ``unit``[,
    the phases it runs at])) and each phase's rows (``rows``, default
    ``LM_ROWS``: decode and prefill)."""
    shapes = LM_SHAPES if shapes is None else shapes
    rows = LM_ROWS if rows is None else rows

    def phases(spec):
        return spec[3] if len(spec) > 3 else tuple(rows)
    kinds = {"bf16": torch.bfloat16, "int8": torch.int8}
    out = {key: {} for key in dtypes}
    log(f"[lm kernels] shape              rows  dtype  ms        device_ms  plain_ms  "
        f"library_ms  lib_dev_ms  bound_ms (by)")

    def ms(v):
        return "None" if v is None else f"{v:.4f}"

    for name, spec in shapes.items():
        k, n = spec[:2]
        for phase in phases(spec):
            m = rows[phase]
            for key in dtypes:
                dtype = kinds[key]
                r = lm_kernel(k, n, m, dtype, gen, dev, f"{name} {k}->{n} at M={m}")
                out[key][(name, phase)] = r
                log(f"[lm kernels] {name:<7s} {k:>5d}->{n:<5d}  {m:<5d} {key:<6s} {r['ms']:<9.4f} "
                    f"{ms(r['device_ms']):<10s} {r['plain_ms']:<9.4f} {ms(r['library_ms']):<11s} "
                    f"{ms(r['library_device_ms']):<11s} {r['bound_ms']:.5f} ({r['bound_by']})"
                    + (f"; plan {json.dumps(r['plan'])}; max diff {r['err']:.3g}, "
                       f"{r['beyond_plain_ulp']} entries beyond one ulp of |plain|"
                       if key == "bf16" else f"; plan {json.dumps(r['plan'])}; os_mma.cuh "
                       f"{ms(r['os_mma_device_ms'])} ms") + f"  [{r['library_call']}]")
    for key in out:
        for phase in rows:
            at = [s for s, spec in shapes.items() if phase in phases(spec)]
            per = sum(shapes[s][2] for s in at)
            per_layer = {}
            for f in ("device_ms", "bound_ms", "library_device_ms"):
                # None where the profiler delivered no record of a shape's call
                vals = [out[key][(s, phase)][f] for s in at]
                per_layer[f] = (None if None in vals else
                                sum(v * shapes[s][2] for s, v in zip(at, vals)))
            dev_ms = per_layer["device_ms"]
            log(f"[lm kernels] {key} {phase}: {unit} {per} projections, device "
                f"{ms(dev_ms)} ms, library {ms(per_layer['library_device_ms'])} ms, "
                f"bound {per_layer['bound_ms']:.5f} ms; x{layers} layers "
                f"{ms(None if dev_ms is None else dev_ms * layers)} ms")
    return out


def tensor_bytes(tree, skip=()) -> int:
    """Bytes of every tensor in a parameter tree (compressed values and
    positions included), leaving out the top-level keys in ``skip``."""
    total = 0
    for k, v in tree.items():
        if k in skip:
            continue
        if isinstance(v, dict):
            total += tensor_bytes(v)
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        else:
            total += sum(t.numel() * t.element_size() for t in
                         (v.values, v.indices, getattr(v, "scales", None)) if t is not None)
    return total


def decode_skips(model, path) -> bool:
    """Whether a decode step leaves the DBB leaf at ``path`` unread: an
    MLA block's ``wkv_b`` (the absorbed decode reads it decoded) and a
    cross block's ``wk``/``wv`` (the memory's K/V are the prefill's, in
    the cache)."""
    return ((model.cfg.mixer == "mla" and path[-1] == "wkv_b")
            or (len(path) > 1 and path[-2] == "cross" and path[-1] in ("wk", "wv")))


def projections(model, kind: str = "prefill") -> int:
    """The compressed projections one forward of ``kind`` runs: each DBB
    leaf once per layer group it is stacked over; at ``"decode"`` without
    those :func:`decode_skips` names."""
    from repro_torch.models.common import dbb_leaves

    return sum(model.cfg.num_groups if path[0] == "layers" else 1
               for path, _ in dbb_leaves(model.defs())
               if not (kind == "decode" and decode_skips(model, path)))


def decode_bound(model, prompt_len=None) -> tuple:
    """The least time a decode step could take, from the bytes it must move:
    every weight but the embedding table, of which it reads B rows (B rows
    of each codebook's for audio), or all of it when the logits are tied to
    it, an MLA block's ``wkv_b`` as the step reads it, decoded to dense
    (``LM._absorb``) in place of the leaf, and no cross block's ``wk`` or
    ``wv`` (:func:`decode_skips`); each attention block's K/V at its cache's
    full length, ``prompt_len`` (default ``LM_PROMPT``) + ``LM_GEN`` (a
    local block's ring at most its window), and a cross block's memory K/V
    (``cross_len`` slots), read; an MLA block's ``c_kv`` and ``k_rope``,
    read, and one slot of each written; each recurrent block's state, read
    and written. Returns (ms, bytes)."""
    from repro_torch.models.attention import GQAttention
    from repro_torch.models.common import dbb_leaves, tree_get

    c = model.cfg
    plen = LM_PROMPT if prompt_len is None else prompt_len
    state = model.state()
    table = state["embed"]
    rows = (table.shape[0] if c.tie_embeddings else
            LM_BATCH * (c.num_codebooks if c.frontend == "audio" else 1))
    weights = tensor_bytes(state, skip=("embed",)) + rows * c.d_model * table.element_size()
    for (block, g), pair in model._absorbed.items():
        weights += sum(w.numel() * w.element_size() for w in pair)
        weights -= tensor_bytes({"wkv_b": state["layers"][block]["mixer"]["wkv_b"][g]})
    for path, _ in dbb_leaves(model.defs()):
        if c.mixer != "mla" and decode_skips(model, path):
            weights -= tensor_bytes({"w": tree_get(state, path)})
    cache = 0
    for kind in list(c.pattern) * c.num_groups + list(c.tail_pattern):
        leaves = model._mixer(kind).init_cache(LM_BATCH, plen + LM_GEN, c.compute_dtype, "meta")
        if c.cross_attn and kind != "rwkv":
            leaves = dict(leaves, **{f"cross_{k}": v for k, v in GQAttention(
                c, cross=True).init_cache(LM_BATCH, plen + LM_GEN, c.compute_dtype,
                                          "meta").items()})
        for k, v in leaves.items():
            n = v.numel() * v.element_size()
            if k in ("k", "v", "cross_k", "cross_v"):
                cache += n
            elif k in ("c_kv", "k_rope"):  # and one slot written
                cache += n + v[:, 0].numel() * v.element_size()
            else:
                cache += 2 * n
    return (weights + cache) / HBM_BYTES_PER_S * 1e3, weights + cache


def graphed(fn, dev):
    """``fn`` captured once into a CUDA graph (``models/plan.py:capture``,
    its own pool): a replay per call. Outside a card (a CPU rehearsal of
    the phase) ``fn`` itself."""
    if dev.type != "cuda":
        return lambda *_: fn()
    from repro_torch.models.plan import GraphPool, capture

    g, _, _ = capture(fn, GraphPool(), dev)
    return lambda *_: g.replay()


def main_path_launches(rec) -> dict:
    """The kernels' launches over a generate run: what the counters saw (the
    graphs' captures and eager warm-ups, or every eager call) plus each
    graph's launches a replay times its replays."""
    from repro_torch.kernels import build

    counts = build.launch_counts()
    return {k: n + sum(rec["replays"][kind] * per.get(k, 0)
                       for kind, per in rec["graph_launches"].items())
            for k, n in counts.items()}


def as_fp32(tree) -> dict:
    """A parameter tree with every floating tensor, compressed values
    included, in fp32."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = as_fp32(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.float()
        else:
            out[k] = dataclasses.replace(v, values=v.values.float())
    return out


def side_inputs(inputs) -> dict:
    """A prompt batch's side inputs (``memory``, ``vision_embeds``): what a
    forward takes beside the tokens."""
    return {k: v for k, v in inputs.items() if k != "tokens"}


def fp32_consistency(model, inputs) -> dict:
    """The model's weights in fp32 (the fp32 instantiation of the tc
    kernel): generate from the prompt batch ``inputs`` (tokens and side
    inputs) through graphs, then each kept decode step's logits against a
    fresh fp32 forward over the prompt and the tokens fed, with the same
    side inputs. {step: relative L2}."""
    from repro_torch.launch import serve
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(model.cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    m32 = LM(cfg).load_params(as_fp32(model.state()))
    prompt = inputs["tokens"]
    rec = serve.generate(m32, inputs, gen_len=LM_GEN, max_len=prompt.shape[1] + LM_GEN,
                         keep=LM_KEEP)
    with torch.no_grad():
        return {i: rel_l2(lg, m32.forward(torch.cat([prompt, rec["tokens"][:, : i + 1]], 1),
                                          **side_inputs(inputs))[:, -1:])
                for i, lg in rec["logits"].items()}


def lm_generate(dev, arch=LM_ARCH, fresh_gate="served", tag="lm generate",
                prompt_len=None) -> dict:
    """Phase 7b (``starcoder2-7b``), 8b (the MoE), 9b (the recurrent
    decoders), 10b (MLA; ``arch`` a name or a ``ModelConfig``, here
    deepseek-v3-671b cut to two layers) and 11b (the frontends; a prompt of
    ``prompt_len`` tokens, default ``LM_PROMPT``, with its side inputs):
    full-width generation through ``generate``'s CUDA graphs,
    compressed then dense, each against an eager run of the same model
    (``graph=False``) bit for bit. Returns the record: the compressed run's
    launches and both runs' times and bounds.

    ``fresh_gate`` holds the kept decode steps' logits within 2e-2 of a
    fresh forward over the same tokens: the served bf16 model's
    (``"served"``), or an fp32 copy of its weights' (``"fp32"``, the
    recurrent decoders: their random-weight stacks amplify bf16 rounding
    with depth, so a bf16 forward and a bf16 decode of the same tokens
    differ by more than the gate whatever computes them; the served
    model's distances are logged beside it); ``None``: no gate (the MoE's
    decode routes over the batch's tokens, a forward within each
    example). An MLA model gates its mixer in its place
    (:func:`mla_mixer_gate`)."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    out = {}
    name = getattr(arch, "name", arch)
    plen = LM_PROMPT if prompt_len is None else prompt_len
    for dense in (False, True):
        label = "dense" if dense else "compressed"
        gc.collect()  # the previous build's graphs, caches and weights
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        build.reset_launches()
        rec = serve.serve_lm(arch, batch=LM_BATCH, prompt_len=plen, gen=LM_GEN, device=dev,
                             seed=0, dense=dense, smoke=LM_SMOKE, keep=LM_KEEP, log=log)
        counts = main_path_launches(rec)
        model = rec["model"]
        c = model.cfg
        side = side_inputs(rec["inputs"])
        toks = rec["tokens"]
        books = (c.num_codebooks,) if c.frontend == "audio" else ()
        vocab = c.codebook_vocab if books else c.padded_vocab
        if toks.shape != (LM_BATCH, LM_GEN) + books or int(toks.min()) < 0 or int(toks.max()) >= vocab:
            raise AssertionError(f"{label}: generated tokens {tuple(toks.shape)} out of range")
        # every forward generate enqueued (eager warm-ups, the one each
        # capture records, replays), each through every projection it runs
        want = 0 if dense else sum(projections(model, kind) * n
                                   for kind, n in rec["forwards"].items())
        if counts["vdbb_matmul_tc_bf16"] != want or any(
                n for k, n in counts.items() if k != "vdbb_matmul_tc_bf16"):
            raise AssertionError(f"{label}: launches {counts}, want {want} of the bf16 tc matmul")
        graphs = dev.type == "cuda"
        if rec["captures"] != 2 or graphs != bool(rec["graph_launches"]):
            raise AssertionError(f"{label}: {rec['captures']} captures, graph launches "
                                 f"{rec['graph_launches']}: want the prefill's and the step's")
        eager = serve.generate(model, rec["inputs"], gen_len=LM_GEN, max_len=plen + LM_GEN,
                               keep=LM_KEEP, graph=False)
        if not torch.equal(eager["tokens"], toks) or any(
                not torch.equal(eager["logits"][i], lg) for i, lg in rec["logits"].items()):
            raise AssertionError(f"{label}: replayed decode differs from the eager decode")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9  # serving only: before the gate's forwards
        served = {}
        with torch.no_grad():
            for i, lg in rec["logits"].items():
                if not bool(torch.isfinite(lg).all()):
                    raise AssertionError(f"{label}: decode step {i} logits not finite")
                if fresh_gate:
                    seq = torch.cat([rec["prompt"], toks[:, : i + 1]], dim=1)
                    served[i] = rel_l2(lg, model.forward(seq, **side)[:, -1:])
        errs = fp32_consistency(model, rec["inputs"]) if fresh_gate == "fp32" else served
        if any(e > 2e-2 for e in errs.values()):
            raise AssertionError(f"{label}: decode logits rel L2 {errs} against fresh "
                                 f"{'fp32 ' if fresh_gate == 'fp32' else ''}forwards > 2e-2")
        mixer = mla_mixer_gate(model, rec["prompt"], label) if c.mixer == "mla" else None
        b_ms, b_bytes = decode_bound(model, plen)
        # where a replayed decode step's time goes: the device's busy and
        # idle share over 4 replays at the last position of a full-length
        # cache, and each kernel's share; then a replayed prefill's
        cache = model.init_cache(LM_BATCH, plen + LM_GEN)
        last = toks[:, -1:].contiguous()
        pos = torch.tensor(plen + LM_GEN - 1, device=dev)
        per_step = {"vdbb_matmul_tc_bf16": 0 if dense else projections(model, "decode")}
        per_prefill = {"vdbb_matmul_tc_bf16": 0 if dense else projections(model)}
        with torch.no_grad():
            step = graphed(lambda: model.decode_step(cache, last, pos)[0], dev)
            prof = profile_forwards(step, last, per_step)
            # the host's time to enqueue one replay on an idle card: in the
            # decode loop the host also waits once the launch queue is full
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t_enq = time.perf_counter()
            step()
            prof["replay_enqueue_ms"] = (time.perf_counter() - t_enq) * 1e3
            del step
            prefill = graphed(lambda: model.forward(rec["prompt"], **side), dev)
            prefill_prof = profile_forwards(prefill, rec["prompt"], per_prefill, reps=2)
            del prefill
        out[label] = dict(prefill_ms=rec["prefill_ms"], ms_per_step=rec["ms_per_step"],
                          eager_prefill_ms=eager["prefill_ms"],
                          eager_ms_per_step=eager["ms_per_step"],
                          prefill_host_ms=rec["prefill_host_ms"],
                          host_ms_per_step=rec["host_ms_per_step"],
                          eager_host_ms_per_step=eager["host_ms_per_step"],
                          steps_per_s=rec["steps_per_s"], decode_bound_ms=b_ms,
                          decode_bytes=b_bytes, consistency_rel_l2=errs,
                          served_consistency_rel_l2=served, launches=counts,
                          captures=rec["captures"], replays=rec["replays"],
                          replay_launches=rec["graph_launches"], graph_equals_eager=True,
                          decode_profile=prof, prefill_profile=prefill_prof,
                          peak_gb=peak_gb, mixer_consistency_rel_l2=mixer,
                          seconds=time.time() - t0)
        if c.is_moe:
            out[label]["experts"] = moe_experts(model, dev, prof.get("device_ms"))
        log(f"[{tag}] {label}: through graphs prefill {rec['prefill_ms']:.3f} ms, "
            f"{rec['ms_per_step']:.3f} ms per decode step ({rec['steps_per_s']:.2f} steps/s; the "
            f"host enqueues a prefill in {rec['prefill_host_ms']:.3f} ms and a step in "
            f"{rec['host_ms_per_step']:.3f}; {rec['captures']} captures, replays "
            f"{json.dumps(rec['replays'])}); eager prefill {eager['prefill_ms']:.3f} ms, "
            f"{eager['ms_per_step']:.3f} ms per step (host {eager['host_ms_per_step']:.3f}); "
            f"replayed decode logits and tokens equal to the eager run's; against the decode "
            f"bound {b_ms:.3f} ms ({b_bytes / 1e9:.3f} GB a step at 3.35 TB/s); decode logits "
            f"against fresh forwards, rel L2 {json.dumps({k: round(v, 6) for k, v in errs.items()})}"
            f" ({fresh_gate}; served {json.dumps({k: round(v, 6) for k, v in served.items()})}); "
            f"launches {counts}; peak {out[label]['peak_gb']:.2f} GB ({time.time() - t0:.1f} s)")
        log(f"[profile] {name} {label} replayed decode step: {json.dumps(prof)}")
        log(f"[profile] {name} {label} replayed prefill: {json.dumps(prefill_prof)}")
        if c.is_moe:
            log(f"[profile] {name} {label} routed experts: {json.dumps(out[label]['experts'])}")
        del rec, model, cache, eager, side
    return out


def moe_experts(model, dev, step_ms) -> dict:
    """The routed experts' share of a decode step: one layer's ``_global``
    (router, top-cap, dispatch, the three batched products, the combine)
    replayed from a graph at decode rows and profiled, times the layers,
    against their bytes bound (every expert's three (d, f) matrices: at
    batch 4 each of the 64 experts takes its top token)."""
    from repro_torch.models.common import tree_slice
    from repro_torch.models.mlp import MoEMLP

    c = model.cfg
    p = tree_slice(model.state()["layers"], 0)["b0"]["mlp"]
    x = torch.randn(LM_BATCH, 1, c.d_model, generator=torch.Generator().manual_seed(3)).to(
        dev, c.compute_dtype)
    mlp = MoEMLP(c)
    with torch.no_grad():
        routed = graphed(lambda: mlp._global(p, x), dev)
        prof = profile_forwards(routed, x, {})
        del routed
    one = prof.get("device_ms")
    nbytes_ = sum(p[k].numel() * p[k].element_size() for k in ("we_up", "we_gate", "we_down"))
    layers = c.num_layers
    return {"layer_device_ms": one, "step_device_ms": None if one is None else one * layers,
            "share_of_step": None if one is None or not step_ms else one * layers / step_ms,
            "bound_ms": nbytes_ * layers / HBM_BYTES_PER_S * 1e3, "layer_profile": prof}


def lm_plan(dev, arch=LM_ARCH, tag="lm plan") -> dict:
    """Phase 7c (and 8d, the MoE; 9d, 10d): the INT8 prefill plan at full
    width."""
    from repro_torch.kernels import build
    from repro_torch.kernels.core import WGMMA_MIN_M
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    t0 = time.time()
    build.reset_launches()
    rec = serve.serve_lm_plan(arch, batch=LM_BATCH, prompt_len=LM_PROMPT, steps=5, device=dev,
                              seed=0, smoke=LM_SMOKE, log=log)
    counts = build.launch_counts()
    if not rec["bit_identical"]:
        raise AssertionError("the INT8 plan's logits differ from the unplanned forward's")
    replay = next(iter(rec["graph_launches"].values()))
    # the staged products run the wgmma core at prefill rows (core.matmul_tc_plan)
    core = "vdbb_matmul_tc_wgmma" if LM_BATCH * LM_PROMPT >= WGMMA_MIN_M else "vdbb_matmul_tc"
    if rec["captures"] != 1 or replay.get(core) != projections(rec["model"]) or any(
            n for k, n in replay.items() if k != core):
        raise AssertionError(f"plan: {rec['captures']} captures, a replay launches {replay}")
    if not counts["vdbb_matmul_tc"] or not counts["vdbb_matmul_tc_bf16"]:
        raise AssertionError(f"plan path launches {counts}: the calibration runs the bf16 kernel, "
                             "the INT8 forward the int8 one")
    logits = rec["logits"]
    if logits.shape != (LM_BATCH, LM_PROMPT, rec["model"].cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"plan logits {tuple(logits.shape)} not finite")
    out = dict(timing=rec["timing"], captures=rec["captures"], replay_launches=replay,
               launches=counts, seconds=time.time() - t0)
    log(f"[{tag}] bit-identical to the unplanned INT8 forward; {rec['captures']} capture; a replay "
        f"launches {replay}; launches counted (calibration, capture, unplanned calls) {counts}; "
        f"in turns (unplanned, planned, planned, unplanned), ms per prefill "
        f"{json.dumps(rec['timing'])} ({time.time() - t0:.1f} s)")
    del rec
    return out


def lm_golden(dev) -> None:
    """Phase 7d: the JAX reference's qwen2-tiny fixture through the kernels."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.act_sparsity import ActStats
    from repro_torch.interop import params_from_numpy, unflatten
    from repro_torch.launch import serve
    from repro_torch.models.model import LM

    with np.load(LM_FIXTURE) as z:
        g = unflatten(z)
    model = LM(get_config("qwen2-tiny")).load_params(params_from_numpy(g["params"], dev))
    tokens = torch.as_tensor(g["tokens"]).to(dev)
    rec = serve.generate(model, {"tokens": tokens}, gen_len=2, max_len=tokens.shape[1] + 1,
                         keep=(0,))
    if not torch.equal(rec["tokens"][:, :1].cpu(), torch.as_tensor(g["next"])):
        raise AssertionError("LM fixture: the greedy next token differs from JAX's")
    with torch.no_grad():
        pre = rel_l2(model.forward(tokens)[:, -1:], torch.as_tensor(g["prefill"]).to(dev))
        dec = rel_l2(rec["logits"][0], torch.as_tensor(g["decode"]).to(dev))
        model.quantize([ActStats(name=str(n), absmax=float(a))
                        for n, a in zip(g["stats"]["names"], g["stats"]["absmax"])])
        qnt = rel_l2(model.forward(tokens)[:, -1:], torch.as_tensor(g["quant"]).to(dev))
    if pre > 1e-5 or dec > 1e-5 or qnt > 1e-3:
        raise AssertionError(f"LM fixture: prefill {pre}, decode {dec} (<= 1e-5), quantized {qnt} "
                             "(<= 1e-3) rel L2 against JAX")
    log(f"[golden] JAX LM fixture (qwen2-tiny, fp32): next token equal; rel L2 prefill {pre:.3e}, "
        f"decode {dec:.3e}, quantized forward {qnt:.3e}")


# ---------------------------------------------------------------- phase 8

MOE_ARCH = "moonshot-v1-16b-a3b"
# one layer's compressed projections: q, k, v, o (16 heads of 128, and 16 KV
# heads), and the two shared experts fused (2 x 1408): up, gate, down
MOE_SHAPES = {"wq/wk/wv/wo": (2048, 2048, 4), "w_up/w_gate": (2048, 2816, 2),
              "w_down": (2816, 2048, 1)}
MOE_FIXTURE = ROOT / "tests" / "data" / "torch_parity_moe.npz"


def smoke_golden(dev, arch=MOE_ARCH) -> None:
    """Phase 8c (the MoE), 9c (the recurrent decoders), 10c (MLA) and 11c
    (the frontends, fed the fixture's side inputs): the JAX reference's
    fixture of ``arch``'s smoke config in fp32 through the kernels and
    generate's graphs: the next token equal, prefill and decode logits
    within 1e-5 relative L2; where the fixture holds calibration stats
    (MLA's, the frontends'), the forward quantized with them within 1e-3,
    as 7d."""
    import numpy as np

    from repro_torch.configs import smoke_config
    from repro_torch.core.act_sparsity import ActStats
    from repro_torch.interop import params_from_numpy, unflatten
    from repro_torch.launch import serve
    from repro_torch.models.model import LM

    with np.load(SMOKE_FIXTURES[arch]) as z:
        g = unflatten(z)
    cfg = dataclasses.replace(smoke_config(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = LM(cfg).load_params(params_from_numpy(g["params"], dev))
    tokens = torch.as_tensor(g["tokens"]).to(dev)
    side = {k: torch.as_tensor(g[k]).to(dev) for k in ("memory", "vision_embeds") if k in g}
    rec = serve.generate(model, {"tokens": tokens, **side}, gen_len=2,
                         max_len=tokens.shape[1] + 1, keep=(0,))
    if not torch.equal(rec["tokens"][:, :1].cpu(), torch.as_tensor(g["next"])):
        raise AssertionError(f"{arch} fixture: the greedy next token differs from JAX's")
    with torch.no_grad():
        pre = rel_l2(model.forward(tokens, **side)[:, -1:], torch.as_tensor(g["prefill"]).to(dev))
    dec = rel_l2(rec["logits"][0], torch.as_tensor(g["decode"]).to(dev))
    if pre > 1e-5 or dec > 1e-5:
        raise AssertionError(f"{arch} fixture: prefill {pre}, decode {dec} rel L2 against JAX "
                             "(<= 1e-5)")
    quant = ""
    if "stats" in g:
        model.quantize([ActStats(name=str(n), absmax=float(a))
                        for n, a in zip(g["stats"]["names"], g["stats"]["absmax"])])
        with torch.no_grad():
            qnt = rel_l2(model.forward(tokens, **side)[:, -1:],
                         torch.as_tensor(g["quant"]).to(dev))
        if qnt > 1e-3:
            raise AssertionError(f"{arch} fixture: quantized forward {qnt} rel L2 against JAX "
                                 "(<= 1e-3)")
        quant = f", quantized forward {qnt:.3e}"
    log(f"[golden] JAX fixture ({arch} smoke, fp32, {rec['captures']} graphs): next "
        f"token equal; rel L2 prefill {pre:.3e}, decode {dec:.3e}{quant}")


# ---------------------------------------------------------------- phase 9

RECURRENT_ARCHS = ("recurrentgemma-2b", "rwkv6-3b")
# each model's compressed projections by shape: (K, N, projections of the
# shape in one forward). recurrentgemma: 18 RG-LRU blocks (w_x, w_gate,
# w_a, w_i, w_out) and 8 local-attention blocks (wq, wo; wk, wv: one KV head
# of 256), an MLP in each of the 26 (w_up, w_gate; w_down). rwkv6: 32
# blocks of time mix (w_r, w_k, w_v, w_g, w_o) and channel mix (w_r; w_k;
# w_v).
RECURRENT_SHAPES = {
    "recurrentgemma-2b": {"rec w_*, attn wq/wo": (2560, 2560, 18 * 5 + 8 * 2),
                          "attn wk/wv": (2560, 256, 8 * 2), "mlp w_up/w_gate": (2560, 7680, 26 * 2),
                          "mlp w_down": (7680, 2560, 26)},
    "rwkv6-3b": {"tm w_*, cm w_r": (2560, 2560, 32 * 6), "cm w_k": (2560, 8960, 32),
                 "cm w_v": (8960, 2560, 32)},
}
MLA_ARCH = "deepseek-v3-671b"
SMOKE_FIXTURES = {MOE_ARCH: MOE_FIXTURE,
                  "recurrentgemma-2b": ROOT / "tests" / "data" / "torch_parity_rglru.npz",
                  "rwkv6-3b": ROOT / "tests" / "data" / "torch_parity_rwkv.npz",
                  MLA_ARCH: ROOT / "tests" / "data" / "torch_parity_mla.npz"}


def recurrent_phase(gen, dev) -> dict:
    """Phase 9: each recurrent decoder in turn at full width and depth, the
    one freed before the next is built: its projection shapes on the bf16
    and int8 tc matmul (9a), generation compressed then dense through
    generate's graphs with the fresh-forward gate (9b), its JAX fixture
    (9c), the INT8 prefill plan (9d). Returns {arch: {"kernels", "generate",
    "plan"}}."""
    out = {}
    for arch in RECURRENT_ARCHS:
        t0 = time.time()
        kernels = lm_kernels(gen, dev, RECURRENT_SHAPES[arch], layers=1, unit="one forward's")
        generated = lm_generate(dev, arch, fresh_gate="fp32", tag=f"{arch} generate")
        smoke_golden(dev, arch)
        planned = lm_plan(dev, arch, tag=f"{arch} plan")
        out[arch] = dict(kernels=kernels, generate=generated, plan=planned,
                         seconds=time.time() - t0)
    return out


# --------------------------------------------------------------- phase 10

MLA_LAYERS = 2  # the published width at two layers: 24.87 B weights on one 80 GB card
# one layer's compressed projections by shape (K, N, projections of the
# shape in a layer): MLA's q LoRA (wq_a, wq_b: 128 heads of 192), the latent
# (wkv_a: 512 + 64; wkv_b: 128 heads of 128 + 128) and wo, then the one
# shared expert of d_ff 2048 (w_up, w_gate; w_down)
MLA_SHAPES = {"wq_a": (7168, 1536, 1), "wq_b": (1536, 24576, 1), "wkv_a": (7168, 576, 1),
              "wkv_b": (512, 32768, 1), "wo": (16384, 7168, 1),
              "shared w_up/w_gate": (7168, 2048, 2), "shared w_down": (2048, 7168, 1)}


def mla_config():
    """Phase 10's config: deepseek-v3-671b at published width cut to
    ``MLA_LAYERS`` layers (its smoke config for a CPU rehearsal)."""
    from repro_torch.configs import get_config, smoke_config

    if LM_SMOKE:
        return smoke_config(MLA_ARCH)
    return dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_LAYERS)


def mla_mixer_gate(model, prompt, label) -> dict:
    """Phase 10b's gate in place of a fresh forward: layer 0's
    ``MLAttention`` on an fp32 copy of its weights (TF32 off), its absorbed
    decode fed the prompt's positions one at a time against its
    full-sequence forward over the same input (layer 0's normed embeddings
    of the prompt) within 1e-4 relative L2; the same in the served dtype,
    logged. Returns {"fp32": …, "served": …}."""
    from repro_torch.models.attention import MLAttention
    from repro_torch.models.common import tree_slice

    c = model.cfg
    block = tree_slice(model.state()["layers"], 0)["b0"]
    b, s = prompt.shape
    positions = torch.arange(s, device=prompt.device).expand(b, s)
    out = {}
    with torch.no_grad():
        h = model._apply_norm(block["norm1"], model._embed(prompt))
        for key, dt in (("fp32", torch.float32), ("served", c.compute_dtype)):
            cfg = dataclasses.replace(c, param_dtype=dt, compute_dtype=dt)
            p = as_fp32(block["mixer"]) if dt == torch.float32 else block["mixer"]
            mla, x = MLAttention(cfg), h.to(dt)
            absorbed = mla.absorbed(p["wkv_b"], dt)
            want, _ = mla(p, x, positions)
            cache = mla.init_cache(b, s, dt, prompt.device)
            got = torch.cat([mla.decode(p, x[:, i:i + 1], cache, positions[0, i], absorbed)[0]
                             for i in range(s)], dim=1)
            out[key] = rel_l2(got, want)
    if out["fp32"] > 1e-4:
        raise AssertionError(f"{label}: layer 0's MLA decode is {out['fp32']} from its forward "
                             "in fp32 (rel L2 > 1e-4)")
    log(f"[mla mixer] {label}: layer 0's absorbed decode over {s} positions against its "
        f"forward, rel L2 fp32 {out['fp32']:.3e} (<= 1e-4), {c.compute_dtype} {out['served']:.3e}")
    return out


def mla_phase(gen, dev) -> dict:
    """Phase 10: deepseek-v3-671b at published width, two layers: the tc
    matmul's bf16 and int8 instantiations at its projection shapes (10a),
    generation compressed then dense through generate's graphs with the
    mixer gate (10b), its JAX fixture (10c), the INT8 prefill plan (10d).
    Returns {"kernels", "generate", "plan", "seconds"}."""
    t0 = time.time()
    cfg = mla_config()
    kernels = lm_kernels(gen, dev, MLA_SHAPES, layers=cfg.num_layers)
    generated = lm_generate(dev, cfg, fresh_gate=None, tag=f"{MLA_ARCH} generate")
    smoke_golden(dev, MLA_ARCH)
    planned = lm_plan(dev, cfg, tag=f"{MLA_ARCH} plan")
    return dict(kernels=kernels, generate=generated, plan=planned, seconds=time.time() - t0)


# --------------------------------------------------------------- phase 11

AUDIO_ARCH, VLM_ARCH = "musicgen-medium", "internvl2-2b"
SIDE_ARCHS = (AUDIO_ARCH, VLM_ARCH)
SMOKE_FIXTURES.update({AUDIO_ARCH: ROOT / "tests" / "data" / "torch_parity_audio.npz",
                       VLM_ARCH: ROOT / "tests" / "data" / "torch_parity_vlm.npz"})
# one layer's compressed projections by shape (K, N, projections of the
# shape in a layer[, the phases whose rows it runs at]). musicgen: self
# wq, wk, wv, wo and cross wq, wo (24 heads of 64) at the tokens' rows, the
# cross wk, wv at the memory's (prefill only), the GELU MLP's w_up, w_down;
# internvl2: wq, wo (16 heads of 128), wk, wv (8 KV heads), SwiGLU w_up,
# w_gate, w_down
SIDE_SHAPES = {
    AUDIO_ARCH: {"self w*, cross wq/wo": (1536, 1536, 6, ("decode", "prefill")),
                 "cross wk/wv": (1536, 1536, 2, ("memory",)),
                 "mlp w_up": (1536, 6144, 1, ("decode", "prefill")),
                 "mlp w_down": (6144, 1536, 1, ("decode", "prefill"))},
    VLM_ARCH: {"wq/wo": (2048, 2048, 2), "wk/wv": (2048, 1024, 2),
               "mlp w_up/w_gate": (2048, 8192, 2), "mlp w_down": (8192, 2048, 1)},
}


def side_prompt(cfg) -> int:
    """Phase 11's prompt length: ``LM_PROMPT`` tokens, after the vision
    embeddings' positions for a vision model (256 + 256 at full size)."""
    return LM_PROMPT + (cfg.num_vision_tokens if cfg.frontend == "vision" else 0)


def side_int8(dev, arch, prompt_len, tag) -> dict:
    """Phase 11d: ``serve_lm_plan`` and ``LM.plan`` refuse a frontend or
    cross-attention model, as the reference's ``LM.plan`` does, so the
    INT8 prefill runs unplanned: the compressed model calibrated on the
    prompt batch (side inputs included) through the bf16 kernel, quantized,
    then its forward over the same batch: the int8 kernel's launches (one
    per projection per forward, none of the bf16's), the logits finite and
    their distance from the bf16 forward's logged, ms by CUDA events."""
    from repro_torch.kernels import build
    from repro_torch.kernels.timing import event_ms
    from repro_torch.launch import serve

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    try:
        serve.serve_lm_plan(arch, batch=LM_BATCH, prompt_len=prompt_len, device=dev,
                            smoke=LM_SMOKE, log=log)
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError(f"{arch}: serve_lm_plan planned a model with side inputs")
    model = serve.build_lm(arch, device=dev, seed=0, smoke=LM_SMOKE)
    inputs = serve.prompt_tokens(model, batch=LM_BATCH, seq=prompt_len, seed=0)
    tokens, side = inputs["tokens"], side_inputs(inputs)
    with torch.no_grad():
        bf16, stats = model.forward(tokens, **side, collect_act_stats=True)
    model.quantize(stats)
    try:
        model.plan(batch=LM_BATCH, seq=prompt_len)
    except NotImplementedError:
        pass
    else:
        raise AssertionError(f"{arch}: LM.plan froze a model with side inputs")
    forwards = []

    def forward():
        forwards.append(1)
        return model.forward(tokens, **side)

    build.reset_launches()
    with torch.no_grad():
        logits = forward()
        ms = event_ms(forward, reps=3, warmup=1, device=dev)
    counts = build.launch_counts()
    want = projections(model) * len(forwards)  # the checked forward, the warm-up and 3 timed
    if counts["vdbb_matmul_tc"] != want or any(n for k, n in counts.items()
                                               if k != "vdbb_matmul_tc"):
        raise AssertionError(f"{arch} int8: launches {counts}, want {want} of the int8 tc matmul")
    if not bool(torch.isfinite(logits).all()) or logits.shape != bf16.shape:
        raise AssertionError(f"{arch} int8: logits {tuple(logits.shape)} not finite")
    dist = rel_l2(logits, bf16)
    out = dict(refused=refused, calibrated=len(stats), ms=ms, launches=counts,
               per_forward=projections(model), rel_l2_to_bf16=dist, seconds=time.time() - t0)
    log(f"[{tag}] LM.plan and serve_lm_plan refuse it ({refused}); the calibrated INT8 prefill "
        f"unplanned: {ms:.3f} ms ({LM_BATCH}x{prompt_len}), launches {counts} "
        f"({projections(model)} a forward), logits rel L2 {dist:.4f} from the bf16 forward's "
        f"({time.time() - t0:.1f} s)")
    del model, logits, bf16, inputs, tokens, side
    return out


def side_phase(gen, dev) -> dict:
    """Phase 11: each frontend or cross-attention model in turn at full
    width and depth, the one freed before the next is built: its projection
    shapes on the bf16 and int8 tc matmul at its phases' rows (11a),
    generation compressed then dense through generate's graphs with the
    fresh-forward gate (11b), its JAX fixture (11c), the INT8 prefill
    unplanned (11d). Returns {arch: {"kernels", "generate", "int8"}}."""
    from repro_torch.launch.serve import lm_config

    out = {}
    for arch in SIDE_ARCHS:
        t0 = time.time()
        cfg = lm_config(arch, smoke=LM_SMOKE)
        plen = side_prompt(cfg)
        rows = {"decode": LM_BATCH, "prefill": LM_BATCH * plen}
        if cfg.cross_attn:
            rows["memory"] = LM_BATCH * cfg.cross_len
        kernels = lm_kernels(gen, dev, SIDE_SHAPES[arch], layers=cfg.num_layers, rows=rows)
        generated = lm_generate(dev, arch, fresh_gate="served", tag=f"{arch} generate",
                                prompt_len=plen)
        smoke_golden(dev, arch)
        int8 = side_int8(dev, arch, plen, tag=f"{arch} int8")
        out[arch] = dict(kernels=kernels, generate=generated, int8=int8, prompt_len=plen,
                         seconds=time.time() - t0)
    return out


# --------------------------------------------------------------- phase 12

SELFHEAL_ARCH = "sparse-cnn-s"
SELFHEAL_SMOKE = False  # the arch's reduced config (a CPU rehearsal of this phase)
SELFHEAL_MAX_BATCH = BATCH
# enough arrivals (~5 s at half the server's throughput) that each
# reload's restore, captures and swap land while requests still arrive and
# leave batches to the set it swapped in
SELFHEAL_REQUESTS = 32 * SERVER_REQUESTS  # 12b's least traffic (12c takes half of it)
SELFHEAL_RELOAD_EVERY = SELFHEAL_REQUESTS // 4  # 12b's least interval between reloads
SELFHEAL_RELOADS = 3
SELFHEAL_PROBE_MARGIN = 3  # 12b: an interval between reloads lasts this many probe reloads
SELFHEAL_BUCKET = 8  # the bucket 12d fails
SELFHEAL_DIR = ROOT / "build" / "selfheal"  # the phase's checkpoints (git-ignored)
CKPT_FIXTURE = ROOT / "tests" / "data" / "torch_parity_ckpt"
CNN_TC = ("im2col_conv", "vdbb_conv_tc", "vdbb_matmul_tc")
CORRUPTIONS = ("flip", "truncate", "manifest", "missing")


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (NaN payloads and signed zeros too)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def check_leaves(got, want, what: str) -> int:
    """Every leaf of two state trees equal bit for bit, in flatten order;
    returns the leaves."""
    from repro_torch.checkpoint.store import flatten

    (gl, paths), (wl, _) = flatten(got), flatten(want)
    if len(gl) != len(wl):
        raise AssertionError(f"{what}: {len(gl)} leaves against {len(wl)}")
    for g, w, path in zip(gl, wl, paths):
        if not same_bits(g, w.to(g.device)):
            raise AssertionError(f"{what}: leaf {path} differs")
    return len(gl)


def selfheal_checkpoints(dev, model, root) -> dict:
    """12a: the port's store on the card, the reference's committed
    checkpoint, and the four corruptions."""
    import numpy as np

    from repro_torch.checkpoint import store
    from repro_torch.configs import smoke_cnn_config
    from repro_torch.interop import params_from_numpy, unflatten
    from repro_torch.launch.faults import corrupt_checkpoint
    from repro_torch.models.cnn import SparseCNN

    t0 = time.perf_counter()
    path = store.save(root / "a", 1, model.state())
    save_ms = (time.perf_counter() - t0) * 1e3
    size = sum(f.stat().st_size for f in path.iterdir())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, _ = store.restore(root / "a", model.state())
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    leaves = check_leaves(SparseCNN(model.cfg).load_state(tree).state(), model.state(),
                          "12a: the restored model")
    # the reference's checkpoint of torch_parity_cnn.npz's params
    with np.load(FIXTURES["matrix"]) as z:
        fx = unflatten(z)
    cfg = dataclasses.replace(smoke_cnn_config("sparse-cnn-tiny"), convs_per_stage=2)
    template = SparseCNN(cfg).init(torch.Generator().manual_seed(5), dev).compress()
    with torch.no_grad():
        _, stats = template(torch.randn(4, cfg.image_size, cfg.image_size, 3).to(dev),
                            collect_act_stats=True)
    template.quantize(stats)
    tree, manifest = store.restore(CKPT_FIXTURE, template.state())
    check_leaves(tree, params_from_numpy(fx["params"], dev), "12a: the reference's checkpoint")
    with torch.no_grad():
        logits = SparseCNN(cfg).load_state(tree)(torch.as_tensor(fx["input"]).to(dev))
    err = rel_l2(logits, torch.as_tensor(fx["logits"]).to(dev))
    if err > 1e-3:
        raise AssertionError(f"12a: the reference's checkpoint serves logits {err} from the "
                             "fixture's, beyond 1e-3")
    for mode in CORRUPTIONS:
        d = root / f"corrupt-{mode}"
        store.save(d, 1, model.state())
        store.save(d, 2, model.state())
        corrupt_checkpoint(d, step=2, mode=mode)
        try:
            store.restore(d, model.state())
            raise AssertionError(f"12a: a checkpoint damaged by {mode!r} restored")
        except store.CorruptCheckpointError:
            pass
        if store.restore(d, model.state(), fallback=True)[1]["step"] != 1:
            raise AssertionError(f"12a: fallback=True past a {mode!r} damage did not load step 1")
    rec = {"save_ms": save_ms, "restore_ms": restore_ms, "bytes": size, "leaves": leaves,
           "reference_rel_l2": err}
    log(f"[selfheal] 12a checkpoints: {leaves} leaves, {size} bytes, save {save_ms:.1f} ms, "
        f"restore onto {dev} {restore_ms:.1f} ms, restored bit for bit; the reference's "
        f"checkpoint (step {manifest['step']}) restored bit for bit, its logits {err:.3e} from "
        f"the fixture's; {', '.join(CORRUPTIONS)} each raised CorruptCheckpointError and "
        "fallback=True loaded step 1")
    return rec


def served_as_planned(run, requests, ps, what: str) -> int:
    """Every request served in ``run`` equals its own plan serve bit for
    bit; returns how many were served. The requests are views of one pool
    of images, so each distinct view is served by the plan once."""
    served, want = 0, {}
    for i, (req, got) in enumerate(zip(requests, run["results"])):
        if got is not None:
            key = (req.__array_interface__["data"][0], req.shape)
            if key not in want:
                want[key] = torch.from_numpy(ps.serve(req))
            check_exact(torch.from_numpy(got), want[key],
                        f"{what}: request {i} against its own plan serve")
            served += 1
    if run["summary"]["demotions"]:
        raise AssertionError(f"{what}: {run['summary']['demotions']} demotions in a served run")
    return served


def selfheal_phase(dev) -> dict:
    """Phase 12: the self-healing serving tier on ``SELFHEAL_ARCH`` at full
    size (shared patterns, buckets 1 … 64), the launch counts at 0 just
    before it. Returns its record."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import store
    from repro_torch.kernels import build
    from repro_torch.kernels.timing import event_ms
    from repro_torch.launch import serve
    from repro_torch.launch.faults import FaultInjected, FaultInjector, corrupt_checkpoint
    from repro_torch.launch.server import CNNServer, auto_rate
    from repro_torch.launch.supervisor import Supervisor
    from repro_torch.models.cnn import SparseCNN

    t_phase = time.time()
    shutil.rmtree(SELFHEAL_DIR, ignore_errors=True)
    build.reset_launches()
    model, x = serve.build_model(SELFHEAL_ARCH, calib_batch=SELFHEAL_MAX_BATCH, device=dev,
                                 seed=0, smoke=SELFHEAL_SMOKE)
    ps = model.plan_set(max_batch=SELFHEAL_MAX_BATCH)
    # one plan set's graphs: what its warmup keeps reserved (each capture
    # empties the allocator's cache, so measure with the cache empty)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    ps.warmup()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool_bytes = torch.cuda.memory_reserved() - before
    rec = {"checkpoint": selfheal_checkpoints(dev, model, SELFHEAL_DIR)}

    def rebuild(tree):
        return SparseCNN(model.cfg).load_state(tree).plan_set(buckets=ps.buckets)

    # 12b: hot reload under traffic, beside a run without
    rng = np.random.default_rng(7)
    pool = torch.randn(100, *x.shape[1:], generator=torch.Generator().manual_seed(2)).numpy()

    def draw(n):
        sizes = rng.integers(1, 9, n)
        return [pool[a: a + k] for a, k in zip(
            [int(rng.integers(0, pool.shape[0] - k + 1)) for k in sizes], sizes)]

    requests = draw(SELFHEAL_REQUESTS)
    sizes = np.array([r.shape[0] for r in requests])
    # auto_rate's half of the largest bucket's host-path capacity saturates
    # the server (its batching and futures cost host time too), and a queue
    # that only grows would hide what a reload costs: offer half of what a
    # saturated run of the server completes
    rate, _ = auto_rate(ps, x.shape[1:])
    probe = serve.serve_continuous(ps, requests[:SELFHEAL_REQUESTS // 8],
                                   rate=rate / float(sizes.mean()), max_wait_ms=5.0, seed=3,
                                   log=log)
    served_rate = probe["summary"]["throughput_rps"]
    rate_rps = 0.5 * served_rate / float(sizes.mean())
    log(f"[selfheal] 12b: auto_rate {rate:.0f} images/s saturates the server at "
        f"{served_rate} images/s; offering half of that, {rate_rps:.1f} requests/s")
    kw = dict(rate=rate_rps, max_wait_ms=5.0, seed=3, log=log)
    # size the traffic to this host: one probe reload (restore, rebuild,
    # captures, swap) under traffic at the offered rate, then an interval
    # between reloads of at least SELFHEAL_PROBE_MARGIN probe reloads
    n_probe = SELFHEAL_REQUESTS // 8
    trial = serve.serve_continuous(ps, requests[:n_probe], model=model,
                                   reload_every=n_probe // 2, ckpt_dir=SELFHEAL_DIR / "probe",
                                   **kw)
    probe_ms = sum(trial["reloads"][0][f"{k}_ms"] for k in ("restore", "rebuild", "capture",
                                                             "swap"))
    reload_every = max(SELFHEAL_RELOAD_EVERY,
                       math.ceil(SELFHEAL_PROBE_MARGIN * probe_ms / 1e3 * rate_rps))
    n_reload = (SELFHEAL_RELOADS + 1) * reload_every
    requests += draw(n_reload - len(requests))
    log(f"[selfheal] 12b: a probe reload took {probe_ms:.1f} ms under traffic; at "
        f"{rate_rps:.1f} requests/s a reload every {reload_every} requests "
        f"({reload_every / rate_rps:.2f} s, >= {SELFHEAL_PROBE_MARGIN} probe reloads), "
        f"{n_reload} requests")
    plain_run = serve.serve_continuous(ps, requests, **kw)
    run = serve.serve_continuous(ps, requests, model=model, reload_every=reload_every,
                                 ckpt_dir=SELFHEAL_DIR / "reload", **kw)
    want = (n_reload - 1) // reload_every
    for r in (plain_run, run):
        if r["failures"] or r["retraces_after_warmup"]:
            raise AssertionError(f"12b: failures {r['failures']}, "
                                 f"{r['retraces_after_warmup']} captures after warmup")
        if served_as_planned(r, requests, ps, "12b") != n_reload:
            raise AssertionError("12b: a request was not served")
    reloads = run["reloads"]
    if run["summary"]["reloads"] != want or len(reloads) != want or any(
            r["retraces_before_swap"] for r in reloads):
        raise AssertionError(f"12b: {run['summary']['reloads']} reloads, want {want}; {reloads}")
    # each swap returned while requests still arrived, and more than one
    # batch (so at least one begun after the swap) ran before the next swap
    # or the end: every swapped-in set served traffic
    marks = [r["batches_at_swap"] for r in reloads] + [run["summary"]["batches"]]
    late = [r["submitted_at_swap"] for r in reloads if r["submitted_at_swap"] >= n_reload]
    if late or any(b - a < 2 for a, b in zip(marks, marks[1:])):
        raise AssertionError(f"12b: swaps after the last arrival {late} or a swapped-in set "
                             f"that served no batch (batches at each swap and at the end "
                             f"{marks})")
    reserved = [r.get("reserved_bytes", 0) for r in reloads]
    if reserved[-1] > reserved[0] + pool_bytes:
        raise AssertionError(f"12b: {reserved[-1]} bytes reserved after the last reload, above "
                             f"{reserved[0]} after the first plus one plan set's {pool_bytes}")
    sup = Supervisor(CNNServer(ps, max_wait_ms=1.0), rebuild=rebuild, template=model.state())
    bad = SELFHEAL_DIR / "corrupt-reload"
    store.save(bad, 1, model.state())
    corrupt_checkpoint(bad, mode="flip")
    with sup:
        sup.warmup()
        y0 = sup.submit(requests[0]).result(timeout=60)
        try:
            sup.reload(bad)
            raise AssertionError("12b: a corrupted checkpoint reloaded")
        except store.CorruptCheckpointError:
            pass
        y1 = sup.submit(requests[0]).result(timeout=60)
    check_exact(torch.from_numpy(y1), torch.from_numpy(y0), "12b: served after a failed reload")
    if sup.reload_failures != 1 or sup.server.plan_set is not ps:
        raise AssertionError(f"12b: reload_failures {sup.reload_failures}, the old set replaced")
    s0, s1 = plain_run["summary"], run["summary"]
    rec["reload"] = {"reloads": reloads, "pool_bytes": pool_bytes, "probe_ms": probe_ms,
                     "reload_every": reload_every, "requests": n_reload,
                     "saturated_images_per_s": served_rate, "offered_requests_per_s": rate_rps,
                     "p50_us": [s0["p50_us"], s1["p50_us"]],
                     "p99_us": [s0["p99_us"], s1["p99_us"]],
                     "images_per_s": [s0["throughput_rps"], s1["throughput_rps"]]}
    phases = [[round(r[f"{k}_ms"], 3) for k in ("restore", "rebuild", "capture", "swap")]
              for r in reloads]
    log(f"[selfheal] 12b: {want} reloads under {n_reload} Poisson requests, every "
        f"request equal to its own plan serve, no capture after warmup; swaps at request "
        f"{[r['submitted_at_swap'] for r in reloads]}, batches at each swap and at the end "
        f"{marks}; ms (restore, rebuild, capture, swap) {phases}; "
        f"reserved after each {reserved} (one plan set's pool {pool_bytes}); p50 "
        f"{s0['p50_us']} -> {s1['p50_us']} us, p99 {s0['p99_us']} -> {s1['p99_us']} us without "
        "and with reloads; a corrupted checkpoint raised with the old set serving the same logits")

    # 12c: a transient kill, a kill inside a dispatch, a crash loop. A kill
    # fires at the first tick with new work after its dispatch count; after
    # the 2nd dispatch one always comes (the arrivals outlast two batches),
    # after the 8th a backlogged run may have taken every request already.
    # The kill inside a dispatch fires at the 8th dispatch.
    class DispatcherDeath(BaseException):
        """Not an Exception: the dispatch's isolation lets it through."""

    class KillInDispatch(FaultInjector):
        def pre_serve(self, pendings, xb):
            xb = super().pre_serve(pendings, xb)
            if self.dispatches == 8:
                raise DispatcherDeath("the dispatcher died inside a dispatch")
            return xb

    restart, n_restart = {}, SELFHEAL_REQUESTS // 2
    for name, inj in (("kill", FaultInjector(kill_after_dispatches=2, kills=1)),
                      ("in-dispatch", KillInDispatch())):
        r = serve.serve_continuous(ps, requests[:n_restart], faults=inj, **kw)
        s = r["summary"]
        if s["restarts"] != 1 or inj.restarts != 1 or set(r["failures"]) - {"ServerCrashed"}:
            raise AssertionError(f"12c {name}: {s}, failures {r['failures']}")
        completed = served_as_planned(r, requests, ps, f"12c {name}")
        lost = r["failures"].get("ServerCrashed", 0) - r["refused"]  # admitted, then failed
        if completed + r["refused"] + lost != n_restart:
            raise AssertionError(f"12c {name}: {completed} served, {r['refused']} refused, "
                                 f"{lost} failed of {n_restart}")
        if name == "kill" and (not s["requeued"] or s["failed"] or lost):
            raise AssertionError(f"12c: a kill with work in hand requeued {s['requeued']} "
                                 f"samples and failed {s['failed']}: every admitted request "
                                 "must complete")
        if name == "in-dispatch" and not (s["failed"] and lost):
            raise AssertionError("12c: the request inside the dying dispatch did not fail")
        restart[name] = {"completed": completed, "refused": r["refused"], "failed": lost,
                         "requeued_samples": s["requeued"], "failed_samples": s["failed"],
                         **{f"{k}_ms": v for k, v in r["last_restart"].items()}}
    t0 = time.time()
    loop = serve.serve_continuous(ps, requests[:SERVER_REQUESTS],
                                  faults=FaultInjector(kill_after_dispatches=2), max_restarts=2,
                                  **kw)
    if loop["health"]["status"] != "failed" or loop["summary"]["restarts"] != 2:
        raise AssertionError(f"12c: a crash loop left {loop['health']}")
    restart["loop"] = {"seconds": time.time() - t0, "reason": loop["health"]["reason"],
                       "failures": loop["failures"]}
    rec["restart"] = restart
    log(f"[selfheal] 12c: {json.dumps(restart)}")

    # 12d: bucket SELFHEAL_BUCKET demoted to the same kernels without graphs
    b = SELFHEAL_BUCKET
    t0 = time.perf_counter()
    fb = model.fallback_plan_set(ps)
    fallback_ms = (time.perf_counter() - t0) * 1e3
    eager_plan = fb[b].__self__
    if any(fn.__self__.graphs or fn.__self__.graph_launches for fn in fb.values()):
        raise AssertionError("12d: the fallback captured graphs")
    reqs = [pool[i * b: (i + 1) * b] for i in range(pool.shape[0] // b)]
    inj = FaultInjector()
    srv = CNNServer(ps, max_wait_ms=1.0, faults=inj, fallback=fb, demote_after=2,
                    probe_every=4)
    served = []  # (logits, request), checked once the bucket is back
    with srv:
        srv.warmup()
        inj.fail_bucket(b)
        try:
            srv.submit(reqs[0]).result(timeout=60)
            raise AssertionError("12d: the first strike served")
        except FaultInjected:
            pass
        replays = ps.plans[b].replays
        launched = build.launch_counts()
        for i in range(1, 8):  # the second strike demotes; a failed probe at the 4th after
            served.append((srv.submit(reqs[i]).result(timeout=60), reqs[i]))
            if i == 1:
                health = srv.health()
        if health["status"] != "degraded" or list(health["demoted"]) != [b]:
            raise AssertionError(f"12d: health {health} after the second strike")
        if ps.plans[b].replays != replays:
            raise AssertionError("12d: the demoted bucket's plan kept replaying")
        counts = build.launch_counts()
        demoted_launches = {k: counts[k] - launched[k] for k in CNN_TC}
        if dev.type == "cuda" and not all(demoted_launches.values()):
            raise AssertionError(f"12d: the demoted bucket launched {demoted_launches}: "
                                 "the fallback must run the kernels")
        inj.heal_bucket(b)
        for i in range(8, 12):
            served.append((srv.submit(reqs[i]).result(timeout=60), reqs[i]))
            if not srv.demoted_buckets():
                break
        back = srv.submit(reqs[0]).result(timeout=60)
    for got, req in served:
        check_exact(torch.from_numpy(got), torch.from_numpy(ps.serve(req)),
                    "12d: a demoted dispatch against the bucket's graph")
    check_exact(torch.from_numpy(back), torch.from_numpy(ps.serve(reqs[0])),
                "12d: promoted back to the graphs")
    s = srv.stats.summary()
    if (s["demotions"], s["promotions"]) != (1, 1) or srv.demoted_buckets():
        raise AssertionError(f"12d: demotions {s['demotions']}, promotions {s['promotions']}")
    ms = {}  # the demoted bucket and the largest, eager and through the graphs
    for bb in (b, ps.buckets[-1]):
        xb = torch.from_numpy(np.resize(pool, (bb,) + pool.shape[1:])).to(dev)
        ms[bb] = {"eager": event_ms(lambda: fb[bb](xb), 20, device=dev),
                  "graphs": event_ms(lambda: ps.plans[bb].serve(xb), 20, device=dev)}
    fresh = serve.serve_continuous(ps, requests[:SERVER_REQUESTS], **kw)
    served_as_planned(fresh, requests, ps, "12d: a fresh run after the promotion")
    rec["demotion"] = {"bucket": b, "fallback_build_ms": fallback_ms, "bucket_ms": ms,
                       "served_equal": len(served), "demoted_launches": demoted_launches,
                       "reason": health["demoted"][b]}
    log(f"[selfheal] 12d: bucket {b} demoted after 2 strikes ({health['demoted'][b]}), served "
        f"by the same kernels without graphs ({json.dumps(demoted_launches)} launches), its "
        f"{len(served)} dispatches equal to the graph's bit for bit, its plan's replays "
        f"unchanged, promoted at a probe after the heal; the fallback's build and "
        f"verification {fallback_ms:.0f} ms; ms per dispatch (eager, graphs) "
        f"{json.dumps(ms)}; a fresh run: no demotion")
    del fb, eager_plan, srv
    torch.cuda.synchronize()
    counts = build.launch_counts()
    idle = [k for k in CNN_TC if not counts[k]]
    if idle:
        raise AssertionError(f"phase 12: kernels {idle} never launched on its path")
    rec["launches"] = counts
    shutil.rmtree(SELFHEAL_DIR, ignore_errors=True)
    log(f"[selfheal] launches (captures and eager runs) {counts} ({time.time() - t_phase:.1f} s)")
    return rec


# --------------------------------------------------------------- phase 13

TUNE_SMOKE = False  # the models' reduced configs (a CPU rehearsal of this phase)
TUNE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


@contextlib.contextmanager
def temporary_tune_cache():
    """``REPRO_AUTOTUNE_CACHE`` names a file in a fresh temporary directory
    for the duration (every plan's default cache), removed after: the run
    reads no cache it did not write. Yields the path."""
    d = tempfile.mkdtemp(prefix="chip-smoke-tune-")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(Path(d) / "autotune.json")
    try:
        yield Path(os.environ["REPRO_AUTOTUNE_CACHE"])
    finally:
        if old is None:
            os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_AUTOTUNE_CACHE"] = old
        shutil.rmtree(d, ignore_errors=True)


def searched(path) -> dict:
    """The signatures the searches measured, read back from the cache file:
    {key: {default, default_us, tuned, tuned_us, speedup, candidates}}.
    Raises unless each tuned time is at most its default's."""
    from repro_torch.kernels import autotune

    out = {}
    for key, e in sorted(autotune.TuneCache(path).entries.items()):
        parsed = autotune.parse_key(key)
        if parsed is None or parsed[0] != "cuda":
            continue
        if e["measured_us"] > e["default_us"]:
            raise AssertionError(f"{key}: tuned {e['measured_us']} us above the default's "
                                 f"{e['default_us']}")
        out[key] = dict(default=e["default_tiles"], default_us=e["default_us"],
                        tuned=e["tiles"], tuned_us=e["measured_us"],
                        speedup=e["default_us"] / e["measured_us"],
                        candidates=e["n_candidates"])
    return out


def rebuild_from_cache(build, want_tiles, what: str):
    """``build()`` (a ``tune='cache'`` build) with the registry cleared, so
    every choice comes from the cache file: it must run no search and make
    the choices ``want_tiles`` records. Returns what it built."""
    from repro_torch.kernels import autotune, core

    core.clear_tuned()
    before = autotune.searches()
    got = build()
    if autotune.searches() != before or got.tiles != want_tiles:
        raise AssertionError(f"{what}: the 'cache' rebuild ran {autotune.searches() - before} "
                             "searches or made other choices than the search")
    return got


def tune_cnn(dev, pattern, path) -> dict:
    """13b for one pattern."""
    from repro_torch.kernels import autotune
    from repro_torch.launch import serve

    t0 = time.time()
    model, x = serve.build_model("sparse-cnn-s", calib_batch=TUNE_BUCKETS[-1], device=dev,
                                 seed=0, pattern=pattern, smoke=TUNE_SMOKE)
    off = model.plan_set(buckets=TUNE_BUCKETS, tune="off")
    before = autotune.searches()
    t_search = time.time()
    tuned = model.plan_set(buckets=TUNE_BUCKETS, tune="search", cache=autotune.TuneCache(path))
    search_s = time.time() - t_search
    with torch.no_grad():
        for b in TUNE_BUCKETS:
            xb = x[:b].contiguous()
            check_exact(tuned.plans[b].serve(xb), off.plans[b].serve(xb),
                        f"pattern={pattern} bucket {b}: the tuned plan's logits against 'off'")
    rebuild_from_cache(lambda: model.plan_set(buckets=TUNE_BUCKETS, tune="cache", cache=path),
                       tuned.tiles, f"pattern={pattern}")
    changed = {b: {name: t for name, t in tiles.items() if t != off.tiles[b].get(name)}
               for b, tiles in tuned.tiles.items()}
    rec = dict(searches=autotune.searches() - before, search_s=search_s,
               changed={b: c for b, c in changed.items() if c}, seconds=time.time() - t0)
    log(f"[tuning] pattern={pattern}: {rec['searches']} searches in {search_s:.1f} s over buckets "
        f"{TUNE_BUCKETS}; logits equal to the 'off' plans' at every bucket; the 'cache' rebuild "
        f"ran no search and made the same choices; stages whose choice moved "
        f"{json.dumps(rec['changed'])} ({rec['seconds']:.1f} s)")
    return rec


def tune_lm(dev, path, untuned=None) -> dict:
    """13c: starcoder2-7b's bf16 projections searched at M = 4 and 1024,
    generate untuned and tuned in turns, graph = eager under the tuned
    registry; then the INT8 prefill plan searched, equal to 'off'."""
    from repro_torch.kernels import autotune, core
    from repro_torch.launch import serve

    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    cache = autotune.TuneCache(path)
    model = serve.build_lm(LM_ARCH, device=dev, seed=0, smoke=LM_SMOKE)
    prompt = serve.prompt_tokens(model, batch=LM_BATCH, seq=LM_PROMPT, seed=0)
    before = autotune.searches()
    for m in (LM_BATCH, LM_BATCH * LM_PROMPT):
        model._tune_gemms(m, tune="search", cache=cache)
    bf16_searches = autotune.searches() - before
    tuned = core.tuned_entries()
    runs = {}

    def gen(which, graph=True):
        core.clear_tuned()
        if which == "tuned":
            for (kind, sig), t in tuned.items():
                core.set_tuned(kind, sig, t)
        return serve.generate(model, prompt, gen_len=LM_GEN, max_len=LM_PROMPT + LM_GEN,
                              keep=LM_KEEP, graph=graph)

    for which in ("untuned", "tuned", "tuned", "untuned"):
        r = gen(which)
        runs.setdefault(which, []).append(r)
    eager = gen("tuned", graph=False)
    first = runs["tuned"][0]
    if not torch.equal(eager["tokens"], first["tokens"]) or any(
            not torch.equal(eager["logits"][i], lg) for i, lg in first["logits"].items()):
        raise AssertionError("tuning: the tuned replayed decode differs from the eager decode")
    timing = {w: dict(prefill_ms=[r["prefill_ms"] for r in rs],
                      ms_per_step=[r["ms_per_step"] for r in rs]) for w, rs in runs.items()}
    del runs, eager, first
    # the INT8 prefill plan: calibrated on the prompt, quantized, 'off' against 'search'
    tokens = prompt["tokens"]
    with torch.no_grad():
        _, stats = model.forward(tokens, collect_act_stats=True)
    model.quantize(stats)
    before = autotune.searches()
    off = model.plan(batch=LM_BATCH, seq=LM_PROMPT, tune="off")
    searched_plan = model.plan(batch=LM_BATCH, seq=LM_PROMPT, tune="search", cache=cache)
    int8_searches = autotune.searches() - before
    with torch.no_grad():
        check_exact(searched_plan(tokens), off(tokens), "tuning: the INT8 plan searched "
                    "against 'off'")
    plan_timing = serve.time_in_turns({"off": lambda: off(tokens),
                                       "tuned": lambda: searched_plan(tokens)},
                                      ("off", "tuned", "tuned", "off"), 5, dev)
    rec = dict(bf16_searches=bf16_searches, int8_searches=int8_searches,
               generate=timing, phase_7b=untuned, int8_plan_ms=plan_timing,
               seconds=time.time() - t0)
    log(f"[tuning] {LM_ARCH}: {bf16_searches} bf16 searches (M = {LM_BATCH}, "
        f"{LM_BATCH * LM_PROMPT}); generate in turns (untuned, tuned, tuned, untuned) "
        f"{json.dumps(timing)}, phase 7b's untuned run {json.dumps(untuned)}; the tuned replay "
        f"equal to an eager run bit for bit; the INT8 plan at M = {LM_BATCH * LM_PROMPT}: "
        f"{int8_searches} searches, equal to 'off' bit for bit, ms per prefill in turns "
        f"{json.dumps(plan_timing)} ({rec['seconds']:.1f} s)")
    del model, off, searched_plan
    return rec


def tuning_phase(dev, untuned=None) -> dict:
    """Phase 13 on the run's temporary cache file (``REPRO_AUTOTUNE_CACHE``);
    ``untuned`` is phase 7b's compressed run, logged beside 13c's. The
    registry is left empty."""
    from repro_torch.kernels import autotune, calibrate, core

    t0 = time.time()
    path = autotune.default_cache_path()
    core.clear_tuned()
    cal = calibrate.calibrate(autotune.TuneCache(path), force=True, device=dev)
    consts = dict(peak_macs=cal.peak_macs, hbm_bw=cal.hbm_bw,
                  step_overhead_s=cal.step_overhead_s)
    if not all(math.isfinite(v) and v > 0 for v in consts.values()):
        raise AssertionError(f"tuning: calibration constants {consts}")
    log(f"[tuning] calibration ({cal.backend}, {cal.source}): {cal.peak_macs:.4e} MAC/s, "
        f"{cal.hbm_bw:.4e} B/s, {cal.step_overhead_s * 1e6:.4f} us a step, rms relative "
        f"residual {cal.residual:.4f} ({time.time() - t0:.1f} s)")
    cnn = {str(p): tune_cnn(dev, p, path) for p in ("matrix", None)}
    lm = tune_lm(dev, path, untuned)
    found = searched(path)
    for key, r in found.items():
        log(f"[tuning] {key}: default {r['default']} {r['default_us']:.3f} us, tuned "
            f"{r['tuned']} {r['tuned_us']:.3f} us ({r['speedup']:.3f}x, {r['candidates']} "
            "candidates)")
    core.clear_tuned()
    calibrate.clear_active()
    return dict(calibration=dict(consts, residual=cal.residual, source=cal.source), cnn=cnn,
                lm=lm, searched=found, seconds=time.time() - t0)


# ------------------------------------------------------- the kernels line


# --------------------------------------------------------------- phase 14

TRAIN_SMOKE = False  # the reduced configs (a CPU rehearsal of this phase)
TRAIN_ARCH = "starcoder2-7b"
TRAIN_LAYERS = 8  # published width at 8 layers: 2.19 B parameters, 35.0 GB of training state
TRAIN_STEPS = 12
TRAIN_SEQ, TRAIN_BATCH = 256, 8  # the launcher's defaults
TRAIN_ANNEAL = 8  # PruneSchedule(0, 8): dense at step 0, the 3/8 bound from step 8
TRAIN_DIR = ROOT / "build" / "train"  # 14a's checkpoints (git-ignored)
PARITY_STEPS = 3
# the small model of tests/test_substrate.py, in an fp32 copy
PARITY_CUT = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256)
ACCT_BATCH = BATCH  # sparse-cnn-s images for the stats forward
ACCT_ROWS = (4, 256)  # 1024 rows of activations for sparse_matmul
BYTES_PER_PARAM = 16  # bf16 parameter and gradient, fp32 m, v and master


class Stamps:
    """Points in each training step's stream, by name: CUDA events on a
    card, the host clock otherwise (a CPU rehearsal)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.steps: list = []

    def start(self) -> None:
        self.steps.append({})
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.steps[-1][name] = ev

    def ms(self, step: int, a: str, b: str, last: int = None) -> float:
        """From point ``a`` of ``step`` to point ``b`` of ``last`` (default
        the same step)."""
        e0, e1 = self.steps[step][a], self.steps[step if last is None else last][b]
        return e0.elapsed_time(e1) if self.cuda else (e1 - e0) * 1e3


def parity_config():
    """14a's model: codeqwen1.5-7b's smoke config cut as tests/test_substrate.py
    cuts it, computed in fp32."""
    from repro_torch.configs import smoke_config

    return dataclasses.replace(smoke_config("codeqwen1.5-7b"), **PARITY_CUT,
                               param_dtype=torch.float32, compute_dtype=torch.float32)


def tree_to(tree, dev):
    from repro_torch.checkpoint import store

    return store.unflatten(tree, [t.detach().to(dev).clone() for t in store.flatten(tree)[0]])


def trees_close(got, want, what, *, noise=None, start=None, lrs=(), opt=None, rtol=2e-4,
                atol=2e-5) -> dict:
    """Every leaf of ``got`` within (rtol, atol) of ``want`` (on the CPU), and
    no DBB kept set different. An entry beyond (rtol, atol) must be a
    ``noise`` entry (its first gradient nonzero and below 1e-6, so Adam's
    step has the sign of rounding) that moved, in each run, no further
    from ``start`` than AdamW can move any parameter in ``len(lrs)``
    updates (``adamw.reach``, plus 1e-7 for fp32 rounding). Returns the
    worst ratio to (rtol, atol) and the count of entries held to the reach."""
    from repro_torch.checkpoint import store
    from repro_torch.optim.adamw import reach

    gl, wl = store.flatten(got)[0], store.flatten(want)[0]
    noise = noise or [None] * len(wl)
    start = store.flatten(start)[0] if start is not None else [None] * len(wl)
    worst, n_reach, flips = 0.0, 0, 0
    for g, w, nz, w0 in zip(gl, wl, noise, start):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        flips += int(((g == 0) != (w == 0)).sum())
        ratio = (g - w).abs() / (atol + rtol * w.abs())
        beyond = ratio > 1.0
        if bool(beyond.any()):
            if nz is None or bool((beyond & ~nz).any()):
                raise AssertionError(f"{what}: worst ratio {float(ratio.max()):.3g} to rtol "
                                     f"{rtol}, atol {atol} beyond the noise entries")
            w0 = w0.detach().float().cpu()[beyond]
            lim = torch.from_numpy(reach(lrs, w0.numpy(), opt)) + 1e-7
            if any(bool(((x[beyond] - w0).abs() > lim).any()) for x in (g, w)):
                raise AssertionError(f"{what}: a noise entry moved beyond AdamW's reach")
            n_reach += int(beyond.sum())
            ratio = torch.where(beyond, torch.zeros_like(ratio), ratio)
        worst = max(worst, float(ratio.max()))
    if flips:
        raise AssertionError(f"{what}: {flips} entries zero on one side only")
    return dict(worst_ratio=worst, held_to_reach=n_reach)


def noise_entries(model, batch) -> list:
    """Entries whose gradient at the model's parameters is nonzero and below
    1e-6 (a copy of the tree is differentiated)."""
    from repro_torch.checkpoint import store
    from repro_torch.train.step import to_device

    saved = model.params
    model.load_params(tree_to(saved, model.device))
    try:
        leaves = store.flatten(model.params)[0]
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(to_device(batch, model.device))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    finally:
        model.load_params(saved)
    return [((g != 0) & (g.abs() < 1e-6)).cpu() for g in grads]


def train_parity(dev) -> dict:
    """14a: the fp32 small model on the card against the CPU: 3 train
    steps from one parameter set (losses within 1e-5 relative, parameters
    within rtol 2e-4, atol 2e-5), the kill-resume twin on the card (6
    steps straight against 3, a checkpoint at step 2, a resume and 3 more,
    rtol 2e-4, atol 2e-5) and 3 steps with int8 error-feedback gradient
    compression (the residual finite)."""
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import OptConfig, init_state, schedule
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.step import make_train_step, to_device

    t0 = time.time()
    cfg = parity_config()
    opt = OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    data = DataConfig(seq_len=16, global_batch=2)
    src = SyntheticTokens(cfg, data)
    cpu = LM(cfg).init(torch.Generator().manual_seed(0), "cpu").constrain()
    card = LM(cfg).load_params(tree_to(cpu.params, dev))
    noise, start = noise_entries(cpu, src.batch(0)), tree_to(cpu.params, "cpu")
    runs = {}
    for name, m in (("cpu", cpu), ("card", card)):
        step_fn, st = make_train_step(m, opt), init_state(m.params, opt)
        runs[name] = []
        for step in range(PARITY_STEPS):
            _, st, met = step_fn(m.params, st, to_device(src.batch(step), m.device), step)
            runs[name].append(float(met["loss"]))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"]))
    if loss_err > 1e-5:
        raise AssertionError(f"14a: card losses {runs['card']} against the CPU's {runs['cpu']}")
    steps = trees_close(card.params, cpu.params, "14a: 3 steps, card against CPU", noise=noise,
                        start=start, lrs=[schedule(s, opt) for s in range(PARITY_STEPS)], opt=opt)

    # the kill-resume twin, on the card
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    def train(total, sub, every=100):
        t = Trainer(LM(cfg), opt, data, LoopConfig(total_steps=total, ckpt_dir=str(TRAIN_DIR / sub),
                                                   ckpt_every=every, log_every=100), device=dev)
        return t.run(generator=torch.Generator(dev).manual_seed(0))

    try:
        pa, sa, _ = train(6, "a")
        train(3, "b", every=2)
        resumed_from = store.latest_step(TRAIN_DIR / "b")
        pb, sb, _ = train(6, "b")
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if resumed_from != 2:
        raise AssertionError(f"14a: the resume found step {resumed_from}, not 2")
    diff = max(float((a.detach().float() - b.detach().float()).abs().max())
               for a, b in zip(store.flatten((pa, sa))[0], store.flatten((pb, sb))[0]))
    resume = trees_close((pb, sb), (pa, sa), "14a: kill-resume on the card")

    # int8 error-feedback gradient compression
    ef_opt = dataclasses.replace(opt, grad_compression=True)
    m = LM(cfg).load_params(tree_to(cpu.params, dev))
    step_fn, st = make_train_step(m, ef_opt), init_state(m.params, ef_opt)
    ef_losses = []
    for step in range(PARITY_STEPS):
        _, st, met = step_fn(m.params, st, to_device(src.batch(step), dev), step)
        ef_losses.append(float(met["loss"]))
    ef_ok = all(bool(torch.isfinite(e).all()) for e in store.flatten(st["ef"])[0])
    if not ef_ok or not all(math.isfinite(x) for x in ef_losses):
        raise AssertionError(f"14a: grad compression: losses {ef_losses}, ef finite {ef_ok}")
    rec = dict(losses=runs, loss_rel_err=loss_err, steps=steps, resume=resume,
               resume_max_abs_diff=diff, ef_losses=ef_losses, seconds=time.time() - t0)
    log(f"[train 14a] {json.dumps(rec)}")
    return rec


def train_config():
    """14b's model: starcoder2-7b at published width cut to TRAIN_LAYERS
    (remat 'full', the registry's)."""
    from repro_torch.configs import get_config, smoke_config

    if TRAIN_SMOKE:
        return smoke_config(TRAIN_ARCH)
    return dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)


def model_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of a training step (no recompute): 6 × the parameters a
    token's products read (all but the embedding table, which is looked
    up) × tokens, plus the attention's scores and context, forward and
    backward, 12 × layers × seq × heads × head_dim × tokens (the port
    computes every score and masks them)."""
    from repro_torch.models.model import lm_defs

    embed = math.prod(lm_defs(cfg)["embed"].shape)
    return (6 * (cfg.param_count() - embed) * tokens
            + 12 * cfg.num_layers * seq * cfg.num_heads * cfg.hd * tokens)


def train_full(dev) -> tuple:
    """14b: starcoder2-7b at full width cut to TRAIN_LAYERS through
    ``Trainer``: the launcher's defaults, PruneSchedule(0, TRAIN_ANNEAL), no
    checkpoint directory, each step's parts on events. Gates: every loss
    finite, the last below the first, every DBB leaf on its 3/8 bound after
    the last step. Returns (record, the trained model)."""
    from repro_torch.core.sparse_linear import PruneSchedule
    from repro_torch.core.vdbb import satisfies_dbb
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.common import dbb_leaves, tree_get
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.step import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cfg = train_config()
    model = LM(cfg)
    sched = PruneSchedule(0, TRAIN_ANNEAL)
    opt = OptConfig(peak_lr=3e-4, warmup_steps=max(TRAIN_STEPS // 20, 5), decay_steps=TRAIN_STEPS)
    seq, batch = (16, 2) if TRAIN_SMOKE else (TRAIN_SEQ, TRAIN_BATCH)
    trainer = Trainer(model, opt, DataConfig(seq_len=seq, global_batch=batch),
                      LoopConfig(total_steps=TRAIN_STEPS, log_every=1), sched, device=dev)
    stamps = Stamps(dev)
    inner = make_train_step(model, opt, sched, mark=stamps.mark)

    def step_fn(*args):
        stamps.start()
        return inner(*args)

    trainer.step_fn = step_fn
    params, _, history = trainer.run(generator=torch.Generator(dev).manual_seed(0))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    losses = [x for _, x in history]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"14b: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"14b: the last loss {losses[-1]} is not below the first {losses[0]}")
    for path, pdef in dbb_leaves(model.defs()):
        w = tree_get(params, path).detach()
        if not all(satisfies_dbb(sl, pdef.dbb) for sl in w.reshape(-1, *w.shape[-2:])):
            raise AssertionError(f"14b: {'.'.join(path)} breaks its {pdef.dbb.nnz}/8 bound")
    steady = range(2, TRAIN_STEPS)  # steps 3 … 12
    # end to end: from the end of step 2 to the end of step 12, so the batch's
    # copy to the card, the loss read and the loop's host work are inside
    ms_step = stamps.ms(1, "constrain", "constrain", last=TRAIN_STEPS - 1) / len(steady)
    part = {name: statistics.median([stamps.ms(i, a, b) for i in steady])
            for name, (a, b) in {"step_fn": ("start", "constrain"),
                                 "forward_backward": ("start", "backward"),
                                 "optimizer": ("backward", "update"),
                                 "constrain": ("update", "constrain")}.items()}
    tokens = seq * batch
    flops = model_flops(cfg, tokens, seq)
    n = cfg.param_count()
    rec = dict(
        arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
        params=n, state_bytes_reckoned=BYTES_PER_PARAM * n, remat=cfg.remat, seq=seq,
        batch=batch, steps=TRAIN_STEPS, losses=losses, ms_per_step=ms_step,
        ms_parts=part, outside_step_fn_ms=ms_step - part["step_fn"],
        optimizer_share=part["optimizer"] / ms_step, constrain_share=part["constrain"] / ms_step,
        tokens_per_s=tokens / (ms_step / 1e3),
        model_flops_per_step=flops,
        mfu=flops / (ms_step / 1e3) / BF16_OPS_PER_S,
        data_wait_ms_median=statistics.median(trainer.data_wait_s[2:]) * 1e3,
        data_wait_ms_max=max(trainer.data_wait_s) * 1e3,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, seconds=wall)
    log(f"[train 14b] {json.dumps(rec)}")
    return rec, model


def projection_inputs(model, tokens) -> dict:
    """The activations layer 0's projections read in a forward of
    ``tokens``, by name (``wq`` for the 4608 -> 4608 and 4608 -> 512 shapes,
    ``w_up``, ``w_down``: the post-GELU hidden activation), caught where
    ``apply_linear`` hands them to the activation collector."""
    from repro_torch.core import act_sparsity

    want = {"g0.b0.mixer.wq": "wq", "g0.b0.mlp.w_up": "w_up", "g0.b0.mlp.w_down": "w_down"}
    got = {}

    def catch(x, name="", macs=0):
        if name in want and want[name] not in got:
            got[want[name]] = x.detach().reshape(-1, x.shape[-1]).contiguous()

    with act_sparsity.collect_activations() as col, torch.no_grad():
        col.add = catch  # keep the tensors instead of measuring them
        model.forward(tokens)
    return got


def gated_matmuls(model, dev) -> tuple:
    """14c: ``ops.sparse_matmul(a, w, act_fmt=act_fmt(measure_activation(a)))``
    at starcoder2's four projection shapes, M = 1024, on the activations the
    trained model's layer 0 reads (bf16; its weights compressed at 3/8), and
    at the paper's assumed half-sparse bound (4/8), each against its plain
    version on the card (one bf16 ulp plus the reordering bound), beside the
    unpruned call. Returns the records and the launches of the eight gated
    calls, each read from counts set to 0 just before it (the timing's
    repeats and the plain versions not counted)."""
    from repro_torch.core.act_sparsity import ActStats, act_dbb_prune, act_fmt, measure_activation
    from repro_torch.core.vdbb import dbb_encode
    from repro_torch.kernels import build
    from repro_torch.kernels import ops
    from repro_torch.kernels import vdbb_matmul as mm
    from repro_torch.kernels.ref import bf16_reorder_bound, check_bf16
    from repro_torch.kernels.timing import device_ms, event_ms

    cfg = model.cfg
    gen = torch.Generator(dev).manual_seed(3)
    b, s = (2, 16) if TRAIN_SMOKE else ACCT_ROWS
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    acts = projection_inputs(model, tokens)
    p = model.params["layers"]["b0"]
    layer = {k: v[0].detach() for k, v in {**p["mixer"], **p["mlp"]}.items()
             if isinstance(v, torch.Tensor) and v.dim() == 3}
    shapes = {"wq/wo": ("wq", "wq"), "wk/wv": ("wq", "wk"), "w_up": ("w_up", "w_up"),
              "w_down": ("w_down", "w_down")}
    out, launches = {}, {}
    for shape, (act_name, w_name) in shapes.items():
        a = acts[act_name]
        w = layer[w_name]
        dw = dbb_encode(w, cfg.dbb, prune=True)
        stats = measure_activation(a)
        rec = dict(m=a.shape[0], k=w.shape[0], n=w.shape[1], zero_frac=stats.zero_frac)
        for label, fmt in (("measured", act_fmt(stats)), ("assumed_0.5", act_fmt(ActStats(zero_frac=0.5)))):
            build.reset_launches()
            got = ops.sparse_matmul(a, dw, act_fmt=fmt)
            for k, n in build.launch_counts().items():
                if n:
                    launches[k] = launches.get(k, 0) + n
            ap = act_dbb_prune(a, fmt)
            idx = dw.indices[:, :, 0].contiguous()
            want = mm.vdbb_matmul_tc_plain(ap, dw.values, idx, dw.fmt)
            err, beyond = check_bf16(got, want, bf16_reorder_bound(ap, dw.values, idx, dw.fmt.bz),
                                     f"14c sparse_matmul {shape} {label}")
            run = lambda: ops.sparse_matmul(a, dw, act_fmt=fmt)  # noqa: E731
            rec[label] = dict(act_fmt=f"{fmt.nnz}/{fmt.bz}", err=err, beyond_plain_ulp=beyond,
                              ms=event_ms(run, REPS, device=dev),
                              device_ms=device_ms(run) if dev.type == "cuda" else None)
        unpruned = lambda: ops.vdbb_matmul(a, dw)  # noqa: E731
        rec["unpruned"] = dict(ms=event_ms(unpruned, REPS, device=dev),
                               device_ms=device_ms(unpruned) if dev.type == "cuda" else None)
        out[shape] = rec
    return out, launches


def cnn_accounting(dev) -> dict:
    """14c: sparse-cnn-s at batch ACCT_BATCH, both patterns, compressed fp32
    weights: ``forward(collect_act_stats=True)`` on the card (the stem, the
    convs and the head on their fp32 kernels, the counts at 0 just before)
    against the same forward on the CPU's plain versions (logits within
    rtol = atol = 1e-5, as phase 2 holds an fp32 kernel; zero fractions
    within 1e-4, absmax within 1e-5 relative); then ``layer_costs`` and the
    paper's pareto design's ``model_workload`` at the measured activation
    sparsity beside the assumed 0.5."""
    from repro_torch.configs import get_cnn_config, smoke_cnn_config
    from repro_torch.core.energy_model import PARETO_DESIGN, model_workload
    from repro_torch.kernels import build
    from repro_torch.models.cnn import SparseCNN

    out = {}
    for pattern in ("matrix", None):
        cfg = (smoke_cnn_config if TRAIN_SMOKE else get_cnn_config)("sparse-cnn-s", pattern=pattern)
        batch = 4 if TRAIN_SMOKE else ACCT_BATCH
        gen = torch.Generator().manual_seed(5)
        x = torch.randn(batch, cfg.image_size, cfg.image_size, cfg.in_channels, generator=gen)
        stats, logits = {}, {}
        for where in ("cpu", "card"):
            d = torch.device("cpu") if where == "cpu" else dev
            model = SparseCNN(cfg).init(torch.Generator().manual_seed(0), d).compress()
            build.reset_launches()
            with torch.no_grad():
                logits[where], stats[where] = model(x.to(d), collect_act_stats=True)
            if where == "card":
                counts = {k: n for k, n in build.launch_counts().items() if n}
            if not bool(torch.isfinite(logits[where]).all()):
                raise AssertionError(f"14c: pattern={pattern} {where} logits not finite")
        got, want = logits["card"].cpu(), logits["cpu"]
        logit_err = check_close(got, want, f"14c: pattern={pattern} logits, card against CPU")
        logit_rel_l2 = float((got - want).norm() / want.norm())
        zf = max(abs(a.zero_frac - b.zero_frac) for a, b in zip(stats["card"], stats["cpu"]))
        am = max(abs(a.absmax - b.absmax) / max(b.absmax, 1e-30)
                 for a, b in zip(stats["card"], stats["cpu"]))
        if zf > 1e-4 or am > 1e-5:
            raise AssertionError(f"14c: pattern={pattern} stats on the card against the CPU: "
                                 f"zero fractions {zf}, absmax {am}")
        costs = model.layer_costs(batch, stats=stats["card"])
        measured = model_workload(PARETO_DESIGN, [(c, f, None) for _, c, f in costs])
        assumed = model_workload(PARETO_DESIGN, [(c, f, None) for _, c, f in model.layer_costs(batch)])
        out[str(pattern)] = dict(
            launches=counts, logits_max_abs_diff=logit_err, logits_rel_l2=logit_rel_l2,
            zero_frac_max_diff=zf, absmax_max_rel_diff=am,
            zero_frac={s.name: s.zero_frac for s in stats["card"]},
            measured_tops_per_w=measured["tops_per_w"], assumed_tops_per_w=assumed["tops_per_w"],
            measured_mean_act_sparsity=measured["mean_act_sparsity"],
            measured_effective_tops=measured["effective_tops"])
        del model
    return out


def train_phase(dev) -> dict:
    """Phase 14: training and accounting. The earlier phases' models are
    freed and the peak-memory counter reset first."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rec = {"parity": train_parity(dev)}
    full, model = train_full(dev)
    rec["train"] = full
    rec["sparse_matmul"], rec["sparse_matmul_launches"] = gated_matmuls(model, dev)
    if dev.type == "cuda" and rec["sparse_matmul_launches"] != {"vdbb_matmul_tc_bf16": 8}:
        raise AssertionError(f"14c: sparse_matmul launched {rec['sparse_matmul_launches']}, "
                             "want the bf16 tc kernel once a call")
    log(f"[train 14c] sparse_matmul {json.dumps(rec['sparse_matmul'])}; launches "
        f"{rec['sparse_matmul_launches']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rec["cnn"] = cnn_accounting(dev)
    log(f"[train 14c] accounting {json.dumps(rec['cnn'])}")
    launched = {k for r in rec["cnn"].values() for k in r["launches"]}
    want = {"im2col_conv", "vdbb_conv_tc", "vdbb_matmul_tc", "vdbb_conv_bw", "vdbb_matmul_bw"}
    if dev.type == "cuda" and not want <= launched:
        raise AssertionError(f"phase 14: kernels {sorted(want - launched)} never launched on "
                             "the stats forwards")
    rec["seconds"] = time.time() - t0
    log(f"[train] phase 14 {rec['seconds']:.1f} s")
    return rec


# --------------------------------------------------------------- phase 15

DIST_SMOKE = False  # the reduced configs (a CPU rehearsal of this phase)
DIST_ARCH = "starcoder2-7b"
DIST_STEPS = 8  # 15a: eager decode steps each way
DIST_LAYERS = 2  # 15b: published width at 2 layers, so that the training state fits twice
DIST_TRAIN_STEPS = 2
DIST_DIR = ROOT / "build" / "dist"  # the rendezvous file and 15c's checkpoint (git-ignored)
DIST_TOL = 5e-3  # the reference's tests/test_distributed.py bound for a sharded train step
# 15b's optimizer state against the unsharded run's, relative (as
# tests/test_torch_distributed.py:check_state): each leaf's m and v, and the
# fp32 master's update over the whole tree
DIST_MOMENT_GAP = 5e-2
DIST_UPDATE_GAP = 0.25


@contextlib.contextmanager
def one_rank_world(dev):
    """A one-rank process group (NCCL on a card, gloo on the CPU) joined
    through a rendezvous file under ``DIST_DIR``, and the (1, 1) ("data",
    "model") mesh over it; the group is torn down on every path."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    DIST_DIR.mkdir(parents=True, exist_ok=True)
    rdv = DIST_DIR / "rendezvous"
    rdv.unlink(missing_ok=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{rdv}", rank=0, world_size=1,
                            device_id=dev if dev.type == "cuda" else None)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type=dev.type)
    finally:
        dist.destroy_process_group()
        rdv.unlink(missing_ok=True)


def stamp(dev):
    """A point in the stream: a recorded CUDA event on a card, the host
    clock otherwise; :func:`span_ms` reads two."""
    if dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def span_ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3


def count_ops(step) -> dict:
    """The aten ops that ``step()`` dispatches: all of them, and those on
    DTensors (each one DTensor's sharding propagation and redistribution
    on the host; the local ops they run beneath are not counted again)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = dtensor = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.dtensor += any(issubclass(t, DTensor) for t in types)
            return func(*args, **(kwargs or {}))

    with Count() as c:
        step()
    return {"ops": c.ops, "dtensor_ops": c.dtensor}


def dist_decode(dev, mesh, tp: int = 1) -> dict:
    """15a: ``DIST_ARCH`` at full width and depth, compressed. One prefill,
    then ``DIST_STEPS`` eager greedy decode steps unsharded and as many on
    the model's own tensors wrapped as DTensors on the mesh
    (``LM.distribute(local=True)``: no second copy) under the decode
    rules at tensor-parallel degree ``tp`` (16c: 16, starcoder2-7b's
    context mode, the cache's sequence on 'model'), each from its own copy
    of the prefill's cache. Gates: the logits equal bit for bit at every
    step (the same kernel at the same shapes on one rank) and the bf16 tc
    kernel's launches, counted inside ``local_map``, equal the unsharded
    run's (on a card: a decode step's projections a step)."""
    from repro_torch.checkpoint.store import full_tensor as full
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models.common import distribute_tree, sharding_rules
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import attn_mode, make_rules

    gc.collect()
    torch.cuda.empty_cache()
    model = serve.build_lm(DIST_ARCH, device=dev, seed=0, smoke=DIST_SMOKE)
    cfg = model.cfg
    prompt = serve.prompt_tokens(model, batch=LM_BATCH, seq=LM_PROMPT, seed=0)
    with torch.no_grad():
        logits, prefill = model.forward(prompt["tokens"], return_cache=True)
    first = logits[:, -1:].argmax(-1)
    max_len = LM_PROMPT + DIST_STEPS
    rules = make_rules(cfg, tp=tp, mode="decode")
    sharded = LM(cfg).load_params(model.params).distribute(mesh, rules, local=True)
    specs = model.cache_pspecs(rules)

    def run(m, cache, rules_ctx):
        build.reset_launches()
        tok, out, marks = first, [], []
        with torch.no_grad(), rules_ctx:
            for i in range(DIST_STEPS):
                marks.append(stamp(dev))
                lg, _ = m.decode_step(cache, tok, LM_PROMPT + i)
                lg = full(lg)
                tok = lg[:, -1:].argmax(-1)
                out.append(lg)
            marks.append(stamp(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = [span_ms(a, b) for a, b in zip(marks, marks[1:])]
        return out, build.launch_counts(), ms

    plain_lg, plain_counts, plain_ms = run(
        model, serve.pad_cache(prefill, LM_PROMPT, max_len), contextlib.nullcontext())
    cache = distribute_tree(serve.pad_cache(prefill, LM_PROMPT, max_len), specs, mesh, local=True)
    dist_lg, dist_counts, dist_ms = run(sharded, cache, sharding_rules(rules, mesh))
    same = [torch.equal(a, b) for a, b in zip(plain_lg, dist_lg)]
    name = "vdbb_matmul_tc_bf16"
    want = projections(model, "decode") * DIST_STEPS if dev.type == "cuda" else 0
    ops = {}  # one more step each way, untimed, from a fresh cache, its ops counted
    for label, m, ctx, local in (("unsharded", model, contextlib.nullcontext(), False),
                                 ("sharded", sharded, sharding_rules(rules, mesh), True)):
        c = serve.pad_cache(prefill, LM_PROMPT, max_len)
        if local:
            c = distribute_tree(c, specs, mesh, local=True)
        with torch.no_grad(), ctx:
            ops[label] = count_ops(lambda: full(m.decode_step(c, first, LM_PROMPT)[0]))
        del c
    extra_ms = statistics.mean(dist_ms[1:]) - statistics.mean(plain_ms[1:])
    rec = dict(arch=cfg.name, params=cfg.param_count(), steps=DIST_STEPS, batch=LM_BATCH,
               prompt=LM_PROMPT, attn_mode=attn_mode(cfg, tp), bit_equal_steps=sum(same),
               ops_per_step=ops,
               extra_us_per_dtensor_op=1e3 * extra_ms / max(ops["sharded"]["dtensor_ops"], 1),
               max_abs_diff=max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(plain_lg, dist_lg)),
               launches={"unsharded": plain_counts[name], "sharded": dist_counts[name],
                         "want": want},
               eager_ms_per_step={"unsharded": statistics.mean(plain_ms[1:]),
                                  "sharded": statistics.mean(dist_ms[1:])},
               first_step_ms={"unsharded": plain_ms[0], "sharded": dist_ms[0]})
    if not all(same):
        raise AssertionError(f"sharded decode logits differ from the unsharded at steps "
                             f"{[i for i, ok in enumerate(same) if not ok]}: {rec}")
    if plain_counts[name] != dist_counts[name] or dist_counts[name] != want or any(
            n for k, n in dist_counts.items() if k != name):
        raise AssertionError(f"sharded decode launches {dist_counts}, {plain_counts} unsharded; "
                             f"want {want} of {name} each")
    return rec


def dist_config():
    """15b's model: ``DIST_ARCH`` at published width cut to ``DIST_LAYERS``."""
    from repro_torch.configs import get_config, smoke_config

    if DIST_SMOKE:
        return smoke_config(DIST_ARCH)
    return dataclasses.replace(get_config(DIST_ARCH), num_layers=DIST_LAYERS)


def dist_train(dev, mesh, cfg=None, tp=None) -> tuple:
    """15b: ``DIST_TRAIN_STEPS`` steps of ``Trainer`` sharded on the mesh
    (the launcher's ``--distributed`` path: the parameters and state as
    DTensors by ``LM.pspecs`` under the training rules, each step's batch
    kept by slice) against as many unsharded from the same seeded state and
    batches (seq and batch as 14b's). Gates: the losses and every parameter
    within ``DIST_TOL`` (bit for bit is expected on one rank and logged);
    the step counts equal, each leaf's ``m`` and ``v`` within
    ``DIST_MOMENT_GAP`` of the unsharded run's and the fp32 master's update
    (``master - p0``) within ``DIST_UPDATE_GAP`` over the whole tree,
    relative to their own 2-norms (an update skipped, or one built from
    unreduced gradients, is as far as its own size). ``cfg`` (17b: another
    family's) replaces :func:`dist_config`'s, ``tp`` the mesh's own degree
    in the rules (17b: 16, the family's production mode). Returns (record,
    the sharded model, its rules)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import tp_degree
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.sharding.rules import attn_mode, make_rules
    from repro_torch.train.loop import LoopConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg or dist_config()
    opt = OptConfig(peak_lr=3e-4, warmup_steps=0, decay_steps=DIST_TRAIN_STEPS)
    seq, batch = (16, 2) if DIST_SMOKE else (TRAIN_SEQ, TRAIN_BATCH)
    rules = make_rules(cfg, tp=tp or tp_degree(mesh), mode="train")
    from repro_torch.checkpoint.store import flatten, full_tensor as full

    out, p0 = {}, None
    for label, on_mesh in (("unsharded", False), ("sharded", True)):
        model = LM(cfg).init(torch.Generator(dev).manual_seed(0), dev)
        model.constrain()
        if p0 is None:
            p0 = [x.detach().clone() for x in flatten(model.params)[0]]
        if on_mesh:
            model.distribute(mesh, rules, local=True)
        t = Trainer(model, opt, DataConfig(seq_len=seq, global_batch=batch),
                    LoopConfig(total_steps=DIST_TRAIN_STEPS, log_every=1), device=dev,
                    mesh=mesh if on_mesh else None, rules=rules if on_mesh else None)
        a = stamp(dev)
        _, state, history = t.run(model.params, init_state(model.params, opt), 0)
        b = stamp(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[label] = (model, [x for _, x in history], span_ms(a, b) / DIST_TRAIN_STEPS, state)
        del t
        gc.collect()
        torch.cuda.empty_cache()

    (m0, l0, ms0, s0), (m1, l1, ms1, s1) = out.pop("unsharded"), out.pop("sharded")
    gaps = state_gaps(s1, s0, p0, None if "master" in s0 else (m1.params, m0.params))
    del s0, s1, p0
    pairs = list(zip(flatten(m0.params)[0], flatten(m1.params)[0]))
    diff = max(float((a.detach().float() - full(b).detach().float()).abs().max())
               for a, b in pairs)
    bits = all(torch.equal(a.detach(), full(b).detach()) for a, b in pairs) and l0 == l1
    rec = dict(arch=cfg.name, layers=cfg.num_layers, params=cfg.param_count(), seq=seq,
               batch=batch, attn_mode=attn_mode(cfg, tp or tp_degree(mesh)),
               steps=DIST_TRAIN_STEPS, losses={"unsharded": l0, "sharded": l1},
               max_param_diff=diff, bit_equal=bits, state_gaps=gaps,
               ms_per_step={"unsharded": ms0, "sharded": ms1},
               placements=sorted({str(tuple(x.placements)) for x in flatten(m1.params)[0]}))
    if len(l1) != DIST_TRAIN_STEPS or any(abs(a - b) > DIST_TOL for a, b in zip(l0, l1)):
        raise AssertionError(f"15b: losses {l1} sharded against {l0}")
    if not diff <= DIST_TOL:
        raise AssertionError(f"15b: parameters {diff} apart, beyond {DIST_TOL}")
    if gaps["count"] != [DIST_TRAIN_STEPS] * 2 or not (
            gaps["m"][0] <= DIST_MOMENT_GAP and gaps["v"][0] <= DIST_MOMENT_GAP
            and gaps["update"] <= DIST_UPDATE_GAP):
        raise AssertionError(f"15b: the optimizer state differs from the unsharded run's: {gaps}")
    del m0, pairs
    return rec, m1, rules


def state_gaps(got: dict, want: dict, p0: list, params=None) -> dict:
    """A sharded run's optimizer state against an unsharded one's from the
    same parameters ``p0``: the step counts, the largest relative 2-norm gap
    of a leaf's ``m`` and of its ``v`` (and which leaf), and the gap of the
    fp32 master's update over the whole tree (an fp32 model keeps no master:
    its parameters', ``params`` = (sharded, unsharded))."""
    from repro_torch.checkpoint.store import flatten, full_tensor as full

    def sq(x):
        return float(x.double().square().sum())

    out = {"count": [int(full(got["count"])), int(full(want["count"]))]}
    for key in ("m", "v"):
        worst = (0.0, "")
        for path, a, b in zip(flatten(want[key])[1], flatten(got[key])[0], flatten(want[key])[0]):
            g = math.sqrt(sq(full(a) - b) / max(sq(b), 1e-300))
            worst = max(worst, (g, path))
        out[key] = list(worst)
    num = den = 0.0
    have, ref = (got["master"], want["master"]) if params is None else params
    for a, b, c in zip(flatten(have)[0], flatten(ref)[0], p0):
        num += sq(full(a) - b)
        den += sq(b - c.float())
    out["update"] = math.sqrt(num / den)
    return out


def dist_restore(dev, model, mesh, rules) -> dict:
    """15c: 15b's sharded parameters saved (the logical arrays, by rank 0)
    and restored with ``shardings=`` on the mesh, equal bit for bit to what
    was saved. (Its fp32 optimizer state, 6 times the bytes, stays out of
    the phase's time; the CPU tests restore one.)"""
    from repro_torch.checkpoint import store
    from repro_torch.models.common import named_shardings

    full = store.full_tensor
    ckpt = DIST_DIR / "ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.time()
    store.save(ckpt, DIST_TRAIN_STEPS, model.params)
    t1 = time.time()
    got, manifest = store.restore(ckpt, model.params,
                                  shardings=named_shardings(model.pspecs(rules), mesh))
    t2 = time.time()
    want, have = store.flatten(model.params)[0], store.flatten(got)[0]
    same = [torch.equal(full(a).detach(), full(b)) for a, b in zip(want, have)]
    nbytes = sum(x.numel() * x.element_size() for x in want)
    placed = all(tuple(a.placements) == tuple(b.placements) for a, b in zip(want, have))
    shutil.rmtree(ckpt, ignore_errors=True)
    rec = dict(leaves=len(want), bytes=nbytes, save_s=t1 - t0, restore_s=t2 - t1,
               bit_equal=all(same), placements_equal=placed, step=manifest["step"])
    if not all(same) or not placed:
        raise AssertionError(f"15c: the restore differs from what was saved: {rec}")
    return rec


def dist_phase(dev, smi: str = "") -> dict:
    """Phase 15: the sharded decode and train steps and the restore on a
    one-rank mesh. The multi-rank numerics are checked on the CPU only
    (tests/test_torch_distributed.py, an 8-rank gloo world)."""
    t0 = time.time()
    with one_rank_world(dev) as mesh:
        rec = {"decode": dist_decode(dev, mesh)}
        log(f"[dist 15a] {smi}: {json.dumps(rec['decode'])}")
        rec["train"], model, rules = dist_train(dev, mesh)
        log(f"[dist 15b] {smi}: {json.dumps(rec['train'])}")
        rec["restore"] = dist_restore(dev, model, mesh, rules)
        log(f"[dist 15c] {json.dumps(rec['restore'])}")
        del model
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.time() - t0
    log(f"[dist] phase 15 {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------- phase 16

MESH_SMOKE = False  # sparse-cnn-s's reduced config (a CPU rehearsal of this phase)
MESH_DP = 2  # 16a: two replicas of the plan set, both on the one card
MESH_MAX_BATCH = BATCH
DRYRUN_CELLS = (("starcoder2-7b", "prefill_32k", False), ("starcoder2-7b", "decode_32k", False),
                ("qwen2-72b", "train_4k", False), ("qwen2-72b", "train_4k", True))
DRYRUN_DIR = ROOT / "build" / "dryrun_smoke"  # 16b's records (git-ignored)
DRYRUN_TIMEOUT_S = 600


def replay_launches(ps) -> dict:
    """What a plan set's graph replays launched: each plan's (each
    replica's) per-replay launches times its replays."""
    out = {}
    for plan in ps.plans.values():
        for r in getattr(plan, "replicas", (plan,)):
            for per in r.graph_launches.values():
                for k, n in per.items():
                    out[k] = out.get(k, 0) + n * r.replays
    return out


def mesh_serve(dev) -> dict:
    """16a: sparse-cnn-s (shared patterns) served by ``CNNServer`` over a
    ``make_local_mesh((2, 1), ("data", "model"))`` of the one card twice,
    against the one-device server over the same plan set (``plan_set(dp=2)``,
    buckets 2 … 64): 256 Poisson requests of 1–8 images at half the
    capacity each way, in turns (one device, mesh, mesh, one device), then
    the ragged 5 (padded to bucket 8, split 4 + 4).
    Gates: every request's logits and the ragged batch's equal the
    one-device plan set's bit for bit, no capture after warmup, every
    kernel of the path launched. The launch counts are at 0 just before the
    first mesh server is built: its replicas' captures are counted there,
    and their replays from the graphs' per-replay counts."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.server import auto_rate
    from repro_torch.models.plan import frozen_choices

    gc.collect()
    torch.cuda.empty_cache()
    model, x = serve.build_model("sparse-cnn-s", calib_batch=BATCH, device=dev, seed=0,
                                 smoke=MESH_SMOKE)
    ps = model.plan_set(max_batch=MESH_MAX_BATCH, dp=MESH_DP)
    ps.warmup()
    rng = np.random.default_rng(7)
    pool = torch.randn(100, *x.shape[1:], generator=torch.Generator().manual_seed(2)).numpy()
    sizes = rng.integers(1, 9, SERVER_REQUESTS)
    starts = [int(rng.integers(0, pool.shape[0] - n + 1)) for n in sizes]
    requests = [pool[a: a + n] for a, n in zip(starts, sizes)]
    rate, _ = auto_rate(ps, x.shape[1:])
    rate_rps = rate / float(sizes.mean())
    mesh = make_local_mesh((MESH_DP, 1), ("data", "model"), [dev] * MESH_DP)
    runs = []  # in turns: one device, mesh, mesh, one device
    for i, name in enumerate(("one_device", "mesh", "mesh", "one_device")):
        if i == 1:
            build.reset_launches()
        r = serve.serve_continuous(ps, requests, rate=rate_rps, max_wait_ms=5.0, seed=3,
                                   mesh=mesh if name == "mesh" else None, log=log)
        runs.append((name, r))
        if i == 1:  # the first mesh run's launches, and the ragged 5 through its replicas
            sharded = r["plan_set"]
            captures = sharded.trace_count
            ragged = sharded.serve(pool[:5])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            counts = build.launch_counts()
            replayed = replay_launches(sharded)
    for name, r in runs:
        if r["failures"] or r["retraces_after_warmup"] or not r["summary"]["accounting_ok"]:
            raise AssertionError(f"16a {name}: failures {r['failures']}, "
                                 f"{r['retraces_after_warmup']} captures after warmup")
        for i, (req, got) in enumerate(zip(requests, r["results"])):
            check_exact(torch.from_numpy(got), torch.from_numpy(ps.serve(req)),
                        f"16a {name} request {i}: against the one-device plan set")
    check_exact(torch.from_numpy(ragged), torch.from_numpy(ps.serve(pool[:5])),
                "16a ragged 5 over the mesh")
    if sharded.trace_count != captures:
        raise AssertionError("16a: the ragged batch captured a new graph")
    frozen = all(frozen_choices(rep) == frozen_choices(ps.plans[b])
                 for b, plan in sharded.plans.items() for rep in plan.replicas)
    if not frozen:
        raise AssertionError("16a: a replica took other launch choices than its bucket's plan")
    path = ("im2col_conv", "vdbb_conv_tc", "vdbb_matmul_tc")
    if dev.type == "cuda" and not all(counts[k] and replayed.get(k) for k in path):
        raise AssertionError(f"16a: kernels of the path not launched: captured {counts}, "
                             f"replayed {replayed}")
    return {"arch": model.cfg.name, "dp": MESH_DP, "buckets": list(ps.buckets),
            "requests": SERVER_REQUESTS, "images": int(sizes.sum()), "rate_rps": rate_rps,
            "bit_equal_requests": {k: 2 * SERVER_REQUESTS for k in ("one_device", "mesh")},
            "ragged_equal": True,
            "captures": captures, "launches": {k: counts[k] for k in path},
            "replay_launches": {k: replayed.get(k, 0) for k in path},
            "summary": {k: [{m: r["summary"][m] for m in ("p50_us", "p99_us", "throughput_rps",
                                                           "batches", "bucket_counts")}
                             for name, r in runs if name == k] for k in ("one_device", "mesh")}}


def dryrun_cells(cells=None, out_dir=None, tag="16b") -> dict:
    """16b: the dry run's CLI in a process of its own per cell, all at once
    (the fake world is a process's default group; the card stays hidden):
    ``DRYRUN_CELLS`` on the (16, 16) mesh and one on (2, 16, 16) (17c:
    ``cells``, records in ``out_dir``). Gates: each record ``ok``, with
    collectives, and every step's rank-0 argument bytes (its DTensors'
    local shards) equal to the specs' count."""
    from repro_torch.launch import dryrun

    cells = DRYRUN_CELLS if cells is None else cells
    out_dir = DRYRUN_DIR if out_dir is None else out_dir
    env = dict(os.environ, REPRO_DRYRUN_DIR=str(out_dir), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", PYTHONPATH=str(SRC))
    procs = []
    t0 = time.time()
    for arch, shape, mp in cells:
        args = ["--arch", arch, "--shape", shape, "--force"] + (["--multi-pod"] if mp else [])
        procs.append(subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    out = {}
    for (arch, shape, mp), proc in zip(cells, procs):
        try:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        key = dryrun.cell_key(arch, shape, mp, 0.625)
        path = out_dir / f"{key}.json"
        if proc.returncode or not path.is_file():
            raise AssertionError(f"{tag} {key}: exit {proc.returncode}\n{stdout[-2000:]}\n"
                                 f"{stderr[-4000:]}")
        rec = json.loads(path.read_text())
        checked = rec["memory"]["argument_bytes_checked"]
        if (rec["status"] != "ok" or not sum(rec["collectives"]["counts"].values())
                or not rec["cost"]["flops"] or any(c["local"] != c["spec"] for c in checked)):
            raise AssertionError(f"{tag} {key}: {json.dumps(rec)[:4000]}")
        out[key] = {k: rec[k] for k in ("attn_mode", "mesh", "compile_s", "memory", "cost",
                                        "collectives", "hlo_caveat")}
        if "micro" in rec:
            out[key]["micro_seconds"] = [rec["micro"][s]["seconds"] for s in ("l1", "l2")]
    out["wall_s"] = time.time() - t0
    return out


def context_decode(dev, mesh) -> dict:
    """16c: 15a's decode in starcoder2-7b's own mode at tp 16, context
    parallel (the cache split along its sequence on 'model'), on the
    one-rank mesh: every attention block takes the context decode
    (``attention.decode_context``; counted here), whose combine over one
    rank is the one-device path, so the logits equal the unsharded decode's
    bit for bit."""
    from repro_torch.models import attention

    calls = [0]
    inner = attention.decode_context

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    attention.decode_context = counted
    try:
        rec = dist_decode(dev, mesh, tp=16)
    finally:
        attention.decode_context = inner
    from repro_torch.configs import get_config, smoke_config

    cfg = (smoke_config if DIST_SMOKE else get_config)(DIST_ARCH)
    want = cfg.num_layers * (DIST_STEPS + 1)  # the timed steps and the one whose ops are counted
    if rec["attn_mode"] != "context" or calls[0] != want:
        raise AssertionError(f"16c: attention mode {rec['attn_mode']}, {calls[0]} context "
                             f"decodes, want {want}")
    rec["context_decodes"] = calls[0]
    return rec


def mesh_phase(dev, smi: str = "") -> dict:
    """Phase 16: data-parallel CNN serving on a local mesh (16a), the dry
    run on fake 256- and 512-rank worlds (16b) and the context-parallel
    decode on the one-rank mesh (16c)."""
    t0 = time.time()
    rec = {"serve": mesh_serve(dev)}
    log(f"[mesh 16a] {smi}: {json.dumps(rec['serve'])}")
    rec["dryrun"] = dryrun_cells()
    for key, r in rec["dryrun"].items():
        log(f"[mesh 16b] {key}: {json.dumps(r)}")
    with one_rank_world(dev) as mesh:
        rec["context_decode"] = context_decode(dev, mesh)
    log(f"[mesh 16c] {smi}: {json.dumps(rec['context_decode'])}")
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.time() - t0
    log(f"[mesh] phase 16 {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------- phase 17

# 17a: each family in its production mode (the rules at tp 16) on the one-rank mesh
FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v3-671b", "rwkv6-3b", "recurrentgemma-2b",
                "musicgen-medium")
FAMILY_TP = 16
# 17b, each in its dtype: the MoE in fp32. Expert choice is discontinuous, and
# on one rank the sharded step sums a row's gradients in another order around
# its local_map (bf16: the router's Adam moment 3.1 % from the unsharded one
# on the CPU smoke config, against a 5 % gate); fp32 holds the mesh, not the
# tie-breaking of bf16 rounding
FAMILY_TRAIN = (("moonshot-v1-16b-a3b", torch.float32), ("musicgen-medium", None))
FAMILY_CELLS = (("moonshot-v1-16b-a3b", "train_4k", False),  # 17c
                ("deepseek-v3-671b", "decode_32k", False), ("rwkv6-3b", "prefill_32k", False),
                ("recurrentgemma-2b", "train_4k", True), ("musicgen-medium", "train_4k", True))
FAMILY_DIR = ROOT / "build" / "dryrun_families"  # 17c's records (git-ignored)


def family_config(arch, dtype=None):
    """17's model: ``arch`` at published width cut to ``DIST_LAYERS``
    pattern blocks, or one whole pattern where it is longer (recurrentgemma's
    rec, rec, local: so that a local block is included); ``dtype`` its
    parameters and activations, if given."""
    from repro_torch.configs import get_config, smoke_config

    cfg = (smoke_config if DIST_SMOKE else get_config)(arch)
    # the published remat (the smoke configs keep none): its recompute runs in
    # the backward, outside the step's rules
    cfg = dataclasses.replace(cfg, num_layers=max(DIST_LAYERS, len(cfg.pattern)),
                              remat=get_config(arch).remat)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    return cfg


def greedy_tokens(cfg, logits):
    """The argmax token (B, 1), fed to every codebook of an audio model, as
    ``launch/serve.py:generate``."""
    tok = logits[:, -1:].argmax(-1)
    if cfg.frontend == "audio":
        tok = (tok % cfg.codebook_vocab)[..., None].expand(*tok.shape, cfg.num_codebooks)
    return tok


def family_decode(dev, mesh, arch) -> dict:
    """17a: ``arch`` (``family_config``) compressed, one prefill and
    ``DIST_STEPS`` eager greedy decode steps unsharded, and the same on the
    model's own tensors wrapped as DTensors (``LM.distribute(local=True)``)
    under the prefill's and the decode's rules at tp ``FAMILY_TP`` (each
    family's production mode: the MoE's dispatch and combine, MLA's absorbed
    decode on a sharded ``wkv_b``, rwkv6's feature mode, the windowed ring
    split along its sequence, the cross memory). A model with local
    attention takes a prompt of ``local_window`` tokens and a ring of as
    many slots, so that the ring wraps at the first step. Gates: the
    prefill's and every step's logits equal bit for bit, and the bf16 tc
    kernel's launches equal each way (a projection per forward on a card)."""
    from repro_torch.checkpoint.store import full_tensor as full
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models.common import distribute, distribute_tree, sharding_rules
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import attn_mode, make_rules

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    cfg = family_config(arch)
    model = LM(cfg).init(torch.Generator(dev).manual_seed(0), dev, compress=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.time() - t0
    ring = "local" in cfg.pattern
    plen = cfg.local_window if ring else LM_PROMPT
    max_len = plen if ring else plen + DIST_STEPS
    prompt = serve.prompt_tokens(model, batch=LM_BATCH, seq=plen, seed=0)
    side = {k: prompt[k] for k in serve.SIDE_INPUTS if k in prompt}
    rules = {m: make_rules(cfg, tp=FAMILY_TP, mode=m) for m in ("prefill", "decode")}
    sharded = LM(cfg).load_params(model.params).distribute(mesh, rules["decode"], local=True)
    name = "vdbb_matmul_tc_bf16"

    def prefill(m, ctx, dist_in):
        build.reset_launches()
        batch = {"tokens": prompt["tokens"], **side}
        if dist_in:
            dp = rules["prefill"]["batch"]
            batch = {k: distribute(v, mesh, (dp, "model") if k == "tokens" else (dp,),
                                   local=True) for k, v in batch.items()}
        with torch.no_grad(), ctx:
            tokens = batch.pop("tokens")
            logits, cache = m.forward(tokens, return_cache=True, **batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return full(logits), cache, build.launch_counts()[name]

    def decode(m, cache, first, ctx):
        build.reset_launches()
        tok, out, marks = first, [], []
        with torch.no_grad(), ctx:
            for i in range(DIST_STEPS):
                marks.append(stamp(dev))
                lg = full(m.decode_step(cache, tok, plen + i)[0])
                tok = greedy_tokens(cfg, lg)
                out.append(lg)
            marks.append(stamp(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = [span_ms(a, b) for a, b in zip(marks, marks[1:])]
        return out, build.launch_counts()[name], ms

    lg0, cache0, pre0 = prefill(model, contextlib.nullcontext(), False)
    lg1, cache1, pre1 = prefill(sharded, sharding_rules(rules["prefill"], mesh), True)
    first = greedy_tokens(cfg, lg0[:, -1:])
    del cache1
    full_cache = serve.pad_cache(cache0, plen, max_len)
    plain, dec0, ms0 = decode(model, full_cache, first, contextlib.nullcontext())
    cache = distribute_tree(serve.pad_cache(cache0, plen, max_len), model.cache_pspecs(
        rules["decode"]), mesh, local=True)
    dist_lg, dec1, ms1 = decode(sharded, cache, first, sharding_rules(rules["decode"], mesh))
    del cache, full_cache, cache0
    same = [torch.equal(a, b) for a, b in zip(plain, dist_lg)]
    want = {"prefill": projections(model, "prefill"),
            "decode": projections(model, "decode") * DIST_STEPS} if dev.type == "cuda" else (
        {"prefill": 0, "decode": 0})
    rec = dict(arch=cfg.name, layers=cfg.num_layers, params=cfg.param_count(),
               attn_mode=attn_mode(cfg, FAMILY_TP), batch=LM_BATCH, prompt=plen, cache=max_len,
               steps=DIST_STEPS, build_s=build_s, prefill_bit_equal=torch.equal(lg0, lg1),
               bit_equal_steps=sum(same),
               launches={"prefill": {"unsharded": pre0, "sharded": pre1},
                         "decode": {"unsharded": dec0, "sharded": dec1}, "want": want},
               eager_ms_per_step={"unsharded": statistics.mean(ms0[1:]),
                                  "sharded": statistics.mean(ms1[1:])})
    del model, sharded
    if not rec["prefill_bit_equal"] or not all(same):
        raise AssertionError(f"17a {arch}: sharded logits differ from the unsharded (prefill "
                             f"equal {rec['prefill_bit_equal']}, steps "
                             f"{[i for i, ok in enumerate(same) if not ok]}): {rec}")
    if (pre0, dec0) != (pre1, dec1) or (dev.type == "cuda" and (pre1, dec1) != (
            want["prefill"], want["decode"])):
        raise AssertionError(f"17a {arch}: {name} launches {rec['launches']}")
    return rec


def family_phase(dev, smi: str = "") -> dict:
    """Phase 17: the families on the one-rank mesh in their production
    modes: 17a each family's sharded prefill and decode against the
    unsharded ones, 17b the sharded ``Trainer`` of the MoE and of the audio
    model (its loss on vocab shards) under 15b's gates, 17c the dry run's
    cells of the families in subprocesses, all at once."""
    t0 = time.time()
    rec = {"decode": {}, "train": {}}
    box = {}

    def run_cells():
        try:
            box["cells"] = dryrun_cells(FAMILY_CELLS, FAMILY_DIR, tag="17c")
        except BaseException as e:  # noqa: BLE001 -- raised below, on the main thread
            box["error"] = e

    # 17c first: its processes run on the host's cores while the card works
    worker = threading.Thread(target=run_cells, daemon=True)
    worker.start()
    cuda = dev.type == "cuda"

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None

    with one_rank_world(dev) as mesh:
        for arch in FAMILY_ARCHS:
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            rec["decode"][arch] = dict(family_decode(dev, mesh, arch), peak_gb=peak_gb())
            log(f"[family 17a] {smi}: {json.dumps(rec['decode'][arch])}")
        for arch, dtype in FAMILY_TRAIN:
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            r, model, _ = dist_train(dev, mesh, family_config(arch, dtype), FAMILY_TP)
            r.update(dtype=str(model.cfg.param_dtype), peak_gb=peak_gb())
            del model
            gc.collect()
            torch.cuda.empty_cache()
            rec["train"][arch] = r
            log(f"[family 17b] {smi}: {json.dumps(r)}")
    worker.join()
    if "error" in box:
        raise box["error"]
    rec["dryrun"] = box["cells"]
    for key, r in rec["dryrun"].items():
        log(f"[family 17c] {key}: {json.dumps(r)}")
    rg = {k: r for k, r in rec["dryrun"].items() if k.startswith("recurrentgemma")}
    log(f"[family 17c] recurrentgemma-2b's cells' seconds: "
        f"{json.dumps({k: r['compile_s'] for k, r in rg.items()})}")
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.time() - t0
    log(f"[family] phase 17 {rec['seconds']:.1f} s")
    return rec


def kernels_line(recs, counts, planned, lm_recs, lm_gen, lm_planned, moe_recs, moe_gen,
                 decoders, frontends, selfheal, training=None, distributed=None,
                 meshed=None, families=None, resnet=None) -> list:
    """The kernels' JSON line, one entry per counted kernel from phase 2's
    records (``recs``: {kernel: [record]}; the bf16 tc matmul's from 7a) and
    the main paths' launches (``counts``), each with the same kernel at the
    LM models' shapes beside it (phases 7–11's records), its launches on
    phase 12's path (``selfheal``), on phase 14c's (``training``: the
    stats forwards and ``sparse_matmul``; the trainer runs no kernel) and
    on phase 15a's sharded decode (``distributed``, the bf16 tc matmul's),
    on phase 16a's mesh serving (``meshed``: counted at the replicas'
    captures, and launched by their replays) and on phase 17a's sharded
    prefills and decodes (``families``, the bf16 tc matmul's). The
    residual instance and the max-pool take their records and launches
    from phase 2b's ResNet-50 (``resnet``: its replay's launches)."""
    from repro_torch.kernels import build

    line = []
    conv_library = "F.conv2d fp32 on decoded weights (TF32 off)"
    head_library = "torch._int_mm on the decoded int8 weight"
    library_call = {"im2col_conv": "F.conv2d fp32 (TF32 off)",
                    "vdbb_conv_tc": conv_library, "vdbb_matmul_tc": head_library,
                    "vdbb_matmul_tc_bf16": "torch.matmul bf16 on the decoded dense weight",
                    "vdbb_matmul_tc_wgmma": head_library,
                    "vdbb_conv_bw": conv_library, "vdbb_matmul_bw": head_library,
                    "vdbb_conv_tc_residual": conv_library + ", the shortcut added",
                    "im2col_conv_maxpool": "F.max_pool2d"}

    def total(rs, key):
        vals = [r[key] for r in rs]
        return None if None in vals else sum(vals)

    def at_shapes(by_shape, launches) -> dict:
        """A kernel's records {(shape, phase): record} at one model's shapes,
        summed, beside its launches on that model's main path."""
        rs = list(by_shape.values())
        return {"shapes": [f"{s}:{p}" for s, p in by_shape], "launches": launches,
                "max_abs_err": max(r["err"] for r in rs),
                **{k: total(rs, k) for k in ("ms", "plain_ms", "device_ms", "bound_ms",
                                             "library_ms", "library_device_ms")}}

    for name, rs in recs.items():
        k = build.kernel_of(name)
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": counts[name],
            "max_abs_err": max(r["err"] for r in rs),
            "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
            "device_ms": (None if any(r["device_ms"] is None for r in rs)
                          else sum(r["device_ms"] for r in rs)),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": total(rs, "library_ms"),
            "library_device_ms": total(rs, "library_device_ms"),
            "library_call": library_call[name], "layers": len(rs),
            "graph_replay_launches": sum(r["replayed"].get(name, 0) for r in planned.values())
            + (resnet["replayed"].get(name, 0) if resnet else 0),
            "selfheal_launches": selfheal["launches"].get(name, 0),
            "accounting_launches": None if training is None else (
                sum(r["launches"].get(name, 0) for r in training["cnn"].values())
                + training["sparse_matmul_launches"].get(name, 0)),
            "mesh_serve_launches": None if meshed is None else (
                meshed["serve"]["launches"].get(name, 0)),
            "mesh_serve_replay_launches": None if meshed is None else (
                meshed["serve"]["replay_launches"].get(name, 0)),
        })
        if name == "vdbb_matmul_tc_bf16":  # the LM shapes, decode and prefill rows
            line[-1].update(shapes=[f"{s}:{p}" for s, p in lm_recs["bf16"]],
                            main_path="LM generate (phase 7b)")
            # the same kernel at moonshot's shapes (phase 8), the recurrent
            # decoders' and MLA's (9, 10) and the frontends' (11)
            moe_c = moe_gen["compressed"]
            line[-1]["moe"] = dict(
                at_shapes(moe_recs, moe_c["launches"][name]),
                graph_replay_launches_per_step=moe_c["replay_launches"]["decode"][name])
            for arch, r in {**decoders, **frontends}.items():
                gen_c = r["generate"]["compressed"]
                line[-1][arch] = dict(
                    at_shapes(r["kernels"]["bf16"], gen_c["launches"][name]),
                    graph_replay_launches={kind: per[name] for kind, per
                                           in gen_c["replay_launches"].items()})
            line[-1]["graph_replay_launches"] = (
                lm_gen["compressed"]["replay_launches"]["decode"][name])
            line[-1]["sharded_decode_launches"] = (
                None if distributed is None else distributed["decode"]["launches"]["sharded"])
            line[-1]["family_launches"] = None if families is None else {
                arch: {k: r["launches"][k]["sharded"] for k in ("prefill", "decode")}
                for arch, r in families["decode"].items()}
        if name == "vdbb_matmul_tc_wgmma":  # the INT8 plans' products at prefill rows
            line[-1].update(main_path="LM INT8 plan (phase 7c)",
                            graph_replay_launches_per_prefill=(
                                lm_planned["replay_launches"].get(name, 0)))
            for arch, r in decoders.items():
                line[-1][arch] = dict(
                    at_shapes({sp: x for sp, x in r["kernels"]["int8"].items()
                               if sp[1] == "prefill"}, r["plan"]["launches"].get(name, 0)),
                    graph_replay_launches_per_prefill=r["plan"]["replay_launches"].get(name, 0))
        if name == "vdbb_matmul_tc":  # the same kernel's int8 path at the LM shapes
            line[-1]["lm"] = dict(
                at_shapes(lm_recs["int8"], lm_planned["launches"].get(name, 0)),
                # torch._int_mm refuses 4 rows: the library call at prefill rows only
                prefill={k: total([r for (_, p), r in lm_recs["int8"].items()
                                   if p == "prefill"], k)
                         for k in ("ms", "device_ms", "library_ms", "library_device_ms")},
                graph_replay_launches_per_prefill=lm_planned["replay_launches"].get(name, 0))
            for arch, r in decoders.items():  # the recurrent decoders' and MLA's plans
                line[-1][arch] = dict(
                    at_shapes(r["kernels"]["int8"], r["plan"]["launches"].get(name, 0)),
                    graph_replay_launches_per_prefill=r["plan"]["replay_launches"].get(name, 0))
            for arch, r in frontends.items():  # phase 11d: the INT8 prefill, unplanned
                line[-1][arch] = dict(at_shapes(r["kernels"]["int8"], r["int8"]["launches"][name]),
                                      launches_per_unplanned_prefill=r["int8"]["per_forward"])
    return line


# ------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    with temporary_tune_cache():  # phases 2–12 on an empty cache; phase 13 searches into it
        return run()


def run() -> int:
    from repro_torch.kernels import build, ops  # noqa: F401  (registers the kernels)

    # full fp32 for the library calls timed beside the kernels (F.conv2d) and
    # the MoE router; bf16 products (the MoE's experts) accumulate in fp32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t0 = time.time()
    phase_s = {}

    def phase_done(name):
        phase_s[name] = round(time.time() - t0 - sum(phase_s.values()), 1)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    build.build_all()
    log(f"[build] {len(build.SOURCES)} sources in {time.time() - t0:.1f} s -> {build.build_dir()}")
    for src in build.SOURCES:  # ptxas -v: registers, shared memory, spills per kernel
        entry = "?"
        for line in build.library_path(src).with_suffix(".log").read_text().splitlines():
            found = re.search(r"entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
            elif "registers" in line or "spill" in line:
                log(f"[build] {src} {kernel_family(entry)} {entry}: {line.strip()}")

    from repro_torch.configs import get_cnn_config

    patterns = ("matrix", None)  # shared across the outputs (tc), per column (bw)
    cfgs = {p: get_cnn_config("sparse-cnn-s", pattern=p) for p in patterns}
    gen = torch.Generator().manual_seed(1)
    phase_done("1 build")
    recs, counts = check_kernels(cfgs, gen, dev), {}
    log(f"[kernels] every kernel matches its plain version ({time.time() - t0:.1f} s)")
    log_summary(recs)
    # the flush (os_accumulate, csrc/epilogue.cuh) has no launch of its own:
    # its least time is writing each layer's output once
    for pattern, names in (("matrix", ("im2col_conv", "vdbb_conv_tc", "vdbb_matmul_tc")),
                           ("None", ("im2col_conv", "vdbb_conv_bw", "vdbb_matmul_bw"))):
        out_b = sum(r["out_bytes"] for n in names for r in recs[n])
        log(f"[kernels] flush (os_accumulate) pattern={pattern}, batch {BATCH}: the layers' "
            f"outputs {out_b} bytes, bound {out_b / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes)")
    phase_done("2 kernels")
    resnet = resnet_phase(gen, dev)
    recs.update(resnet["recs"])
    counts.update({k: resnet["replayed"][k] for k in resnet["recs"]})
    phase_done("2b ResNet-50 v1.5")

    # each serving path with the counts at 0 just before it; a kernel's
    # launches are those of the first path that runs it
    ips = {}
    for pattern in patterns:
        main_counts, ips[str(pattern)], model, x = end_to_end(dev, pattern)
        log(f"[serve] pattern={pattern} main-path launches (calibration, warm-ups and "
            f"{REQUESTS} requests at each batch): {main_counts} ({time.time() - t0:.1f} s)")
        for name, n in main_counts.items():
            if PER_FORWARD[pattern][name]:
                counts.setdefault(name, n)
        for b in (1, BATCH):
            prof = profile_forwards(model, x[:b].contiguous(), PER_FORWARD[pattern])
            log(f"[profile] pattern={pattern} batch {b}: per forward {json.dumps(prof)}")
        del model, x
    phase_done("3 serve")

    for pattern in patterns:
        golden(dev, pattern)
    phase_done("4 golden")

    planned = {str(p): planned_path(dev, p) for p in patterns}
    phase_done("5 plans and server")
    check_nan_flush(cfgs, gen, dev)
    phase_done("6 NaN flush")

    lm_recs = lm_kernels(gen, dev)
    recs["vdbb_matmul_tc_bf16"] = list(lm_recs["bf16"].values())
    phase_done("7a LM kernels")
    lm_gen = lm_generate(dev)
    counts["vdbb_matmul_tc_bf16"] = lm_gen["compressed"]["launches"]["vdbb_matmul_tc_bf16"]
    phase_done("7b LM generate")
    lm_planned = lm_plan(dev)
    # the INT8 plan's products at prefill rows run the wgmma core
    recs["vdbb_matmul_tc_wgmma"] = [r for (_, p), r in lm_recs["int8"].items() if p == "prefill"]
    counts["vdbb_matmul_tc_wgmma"] = lm_planned["launches"]["vdbb_matmul_tc_wgmma"]
    phase_done("7c LM plan")
    lm_golden(dev)
    phase_done("7d LM golden")
    moe_recs = lm_kernels(gen, dev, MOE_SHAPES, dtypes=("bf16",), layers=48)["bf16"]
    phase_done("8a MoE kernels")
    moe_gen = lm_generate(dev, MOE_ARCH, fresh_gate=None, tag="moe generate")
    phase_done("8b MoE generate")
    smoke_golden(dev, MOE_ARCH)
    phase_done("8c MoE golden")
    moe_planned = lm_plan(dev, MOE_ARCH, tag="moe plan")
    phase_done("8d MoE plan")
    recurrent = recurrent_phase(gen, dev)
    phase_done("9 recurrent decoders")
    decoders = {**recurrent, MLA_ARCH: mla_phase(gen, dev)}
    phase_done("10 MLA")
    frontends = side_phase(gen, dev)
    phase_done("11 frontends and cross-attention")
    selfheal = selfheal_phase(dev)
    phase_done("12 self-healing tier")
    tuning = tuning_phase(dev, {k: lm_gen["compressed"][k] for k in ("prefill_ms", "ms_per_step")})
    phase_done("13 tuning")
    training = train_phase(dev)
    phase_done("14 training and accounting")
    distributed = dist_phase(dev, smi)
    phase_done("15 distribution on a one-rank mesh")
    meshed = mesh_phase(dev, smi)
    phase_done("16 mesh serving, the dry run and the context decode")
    families = family_phase(dev, smi)
    phase_done("17 the families on a one-rank mesh")

    line = kernels_line(recs, counts, planned, lm_recs, lm_gen, lm_planned, moe_recs, moe_gen,
                        decoders, frontends, selfheal, training, distributed, meshed, families,
                        resnet)
    log(f"[serve] images/s per request batch (unplanned): {json.dumps(ips)}")
    log(f"[plan] in turns per pattern: {json.dumps({p: r['timing'] for p, r in planned.items()})}")
    log(f"[server] per pattern: {json.dumps({p: r['server'] for p, r in planned.items()})}")
    log(f"[server] per pattern, switch interval 0.5 ms: "
        f"{json.dumps({p: r['server_fast_switch'] for p, r in planned.items()})}")
    log(f"[lm] generate: {json.dumps(lm_gen)}")
    log(f"[lm] plan: {json.dumps(lm_planned, default=str)}")
    log(f"[moe] generate: {json.dumps(moe_gen)}")
    log(f"[moe] plan: {json.dumps(moe_planned, default=str)}")
    for arch, r in decoders.items():
        log(f"[{arch}] generate: {json.dumps(r['generate'])}")
        log(f"[{arch}] plan: {json.dumps(r['plan'], default=str)}")
    for arch, r in frontends.items():
        log(f"[{arch}] generate: {json.dumps(r['generate'])}")
        log(f"[{arch}] int8: {json.dumps(r['int8'], default=str)}")
    log(f"[selfheal] {json.dumps(selfheal)}")
    log(f"[tuning] {json.dumps(tuning)}")
    log(f"[training] {json.dumps(training)}")
    log(f"[distributed] {json.dumps(distributed)}")
    log(f"[meshed] {json.dumps(meshed)}")
    log(f"[families] {json.dumps(families)}")
    log(f"[done] {time.time() - t0:.1f} s; seconds per phase {json.dumps(phase_s)}")
    log(smi)  # the card's name and power limit again, beside the numbers
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
