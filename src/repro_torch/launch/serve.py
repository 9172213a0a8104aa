"""Serving on the card (port of ``repro/launch/serve.py``): INT8 sparse-CNN
serving, greedy LM generation on compressed weights, and LM prefill through
a frozen INT8 plan.

Seeded init -> compress -> calibrate (an fp32 pass through the fp32
instantiation of the same kernels) -> quantize -> serve request batches on
the int8-resident chain: one stem kernel, one IM2COL × VDBB kernel per
compressed conv, global average pooling, one head GEMM kernel.

By default each request batch is served through a frozen plan
(``SparseCNN.plan_set``, one CUDA graph per batch size); ``--no-plan``
serves the unplanned forward, so one call can time both:

  python -m repro_torch.launch.serve --arch sparse-cnn-s --batch 1 8 64 --requests 8

``--tune off|cache|search`` (default ``cache``, as the reference) resolves
each plan's launch choices (the int8 tile rows, the bf16 tile and split,
the stem's path): ``cache`` takes what the autotune cache holds
(``REPRO_AUTOTUNE_CACHE``, else ``~/.cache/repro/autotune.json``) and never
measures, ``search`` measures a launch the cache lacks on the card and
persists its winner (``kernels/autotune.py``), ``off`` keeps the kernels'
rules. With an empty cache every mode makes the rules' choices.

Prints the logits' shape, images/s (CUDA events around ``--requests``
forwards per batch size) and the kernel launches per forward (a plan's: the
launches its graph captured). ``serve(..., pattern=None)`` serves the
paper's per-column patterns through the bw kernels; the default
``pattern='matrix'`` shares one pattern across each layer's outputs (the tc
kernels).

``--server`` runs the continuous-batching tier (``launch/server.py``)
instead, under the self-healing ``launch/supervisor.py`` (a crashed
dispatcher restarts): a plan set of buckets 1, 2, 4, … ``--max-batch``, the
request queue and micro-batcher, and Poisson arrivals of ``--requests``
single-image requests at ``--rate`` requests/s (by default half the
measured capacity of the largest bucket). ``--reload-every N`` saves the
quantized weights as a verified checkpoint at startup and hot-reloads them
every N requests mid-traffic. It reports p50/p99 latency, images/s, the
aggregation shape, the captures after warmup and the supervisor's
restarts, requeued samples, reloads and demoted buckets:

  python -m repro_torch.launch.serve --arch sparse-cnn-s --server --requests 512
  python -m repro_torch.launch.serve --arch sparse-cnn-s --server --reload-every 64

An LM arch (``configs/registry.py``) runs batched greedy generation: seeded
weights drawn on the device and compressed leaf by leaf into the VDBB layout
(``--dense``: the dense baseline, every projection a ``torch.matmul``),
prefill of a ``--prompt-len`` prompt, then ``--gen`` tokens, each decode step
one token through every projection's tc kernel (bf16 operands) against the
KV cache; on a card the prefill and the decode step are each captured once
into a CUDA graph and replayed. A MoE arch (``moonshot-v1-16b-a3b``) runs
the same way, its expert stacks dense, and so do the recurrent decoders
(``recurrentgemma-2b``: RG-LRU and local attention; ``rwkv6-3b``), whose
decode carries a fixed-size state beside (or instead of) the KV cache, and
the frontends' models: ``internvl2-2b`` takes 256 vision embeddings over
the first positions of a longer prompt, ``musicgen-medium`` 4 codebooks a
position and cross-attends to a 128-slot text memory; both inputs are
seeded stand-ins for the encoders, as in the reference. It prints prefill
ms, ms per decode step and decode steps/s:

  python -m repro_torch.launch.serve --arch starcoder2-7b --batch 4 --prompt-len 256 --gen 32
  python -m repro_torch.launch.serve --arch rwkv6-3b --batch 4 --prompt-len 256 --gen 32
  python -m repro_torch.launch.serve --arch musicgen-medium --batch 4 --prompt-len 256 --gen 32
  python -m repro_torch.launch.serve --arch internvl2-2b --batch 4 --prompt-len 512 --gen 32

``--lm-plan`` serves LM prefill through a frozen plan instead: compress,
calibrate (a bf16 forward through the same kernel), INT8-quantize, then
``LM.plan`` (one CUDA graph), checked bit for bit against the unplanned
INT8 forward and timed in turns with it (``--steps`` calls each); a
frontend or cross-attention model refuses it, as the reference:

  python -m repro_torch.launch.serve --arch starcoder2-7b --lm-plan --batch 4 --prompt-len 256

``--device cpu --smoke`` runs either on the CPU at the arch's reduced
config, through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import (ARCHS, CNN_ARCHS, get_cnn_config, get_config, make_batch,
                                 smoke_cnn_config, smoke_config)
from repro_torch.kernels import build
from repro_torch.models.cnn import SparseCNN
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, check_plannable
from repro_torch.train.step import SIDE_INPUTS, make_prefill, make_serve_step


def build_model(arch: str, *, calib_batch: int, device, seed: int = 0,
                smoke: bool = False, sparsity=0.625, pattern="matrix"):
    """Seeded, compressed, calibrated and quantized model, plus the
    calibration batch. ``sparsity`` and ``pattern`` choose the DBB format
    (``configs.cnn``). Weights and inputs are drawn on the CPU from one
    ``torch.Generator`` and moved to ``device``."""
    dev = resolve_device(device)
    cfg = (smoke_cnn_config if smoke else get_cnn_config)(arch, sparsity=sparsity,
                                                          pattern=pattern)
    gen = torch.Generator().manual_seed(seed)
    model = SparseCNN(cfg).init(gen, dev).compress()
    x = torch.randn(calib_batch, cfg.image_size, cfg.image_size, cfg.in_channels,
                    generator=gen).to(dev)
    with torch.no_grad():
        _, stats = model(x, collect_act_stats=True)
    model.quantize(stats)
    return model, x


def time_requests(fn, x, requests: int) -> tuple:
    """``requests`` calls of ``fn(x)`` after one warm-up: (logits, seconds on
    CUDA events, launches of each kernel over the timed calls). The launch
    counters keep running; the counts returned are their growth over the
    timed calls (a plan's graph replays launch without counting)."""
    with torch.no_grad():
        fn(x)
        torch.cuda.synchronize(x.device)
        before = build.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(requests):
            logits = fn(x)
        end.record()
        torch.cuda.synchronize(x.device)
    counts = {k: v - before[k] for k, v in build.launch_counts().items()}
    return logits, start.elapsed_time(end) / 1e3, counts


def serve(arch: str = "sparse-cnn-s", *, batches=(64,), requests: int = 8,
          device=None, seed: int = 0, smoke: bool = False, sparsity=0.625,
          pattern="matrix", plan: bool = True, tune: str = "cache", log=print) -> tuple:
    """Serve ``requests`` batches of each size in ``batches`` on the card,
    through a plan set whose buckets are ``batches``, its launch choices
    resolved under ``tune`` (``plan=False``: the unplanned forward).
    Returns ``(model, inputs, results)``: the quantized model, the seeded
    input batch (requests of batch b take its first b images) and
    ``{batch: {"logits", "images_per_s", "launches_per_forward"}}``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("serving is timed with CUDA events and runs on a card")
    model, xcal = build_model(arch, calib_batch=max(batches), device=dev, seed=seed,
                              smoke=smoke, sparsity=sparsity, pattern=pattern)
    fmt = model.cfg.fmt
    shared = "per column" if fmt.group is None else f"shared by group={fmt.group}"
    log(f"[serve] {model.cfg.name}: INT8-calibrated, nnz={fmt.nnz}/{fmt.bz}, pattern {shared}, "
        f"{model.cfg.param_count() / 1e6:.2f} M weights, on {torch.cuda.get_device_name(dev)}")
    plans = model.plan_set(buckets=batches, tune=tune) if plan else None
    if plans is not None:
        log(f"[serve] plan set: buckets {plans.buckets}, one CUDA graph each (tune={tune})")
    out = {}
    for b in batches:
        xb = xcal[:b].contiguous()
        fn = model if plans is None else plans.plans[b].serve
        logits, secs, counts = time_requests(fn, xb, requests)
        if plans is None:
            per_fwd = {k: v / requests for k, v in counts.items()}
        else:
            per_fwd = plans.plans[b].graph_launches[(tuple(xb.shape), xb.dtype)]
        ips = b * requests / secs
        log(f"[serve] batch {b}{'' if plan else ' (unplanned)'}: logits {tuple(logits.shape)}, "
            f"{ips:.1f} images/s ({secs / requests * 1e3:.4f} ms per request), launches per "
            f"forward {per_fwd}")
        out[b] = {"logits": logits, "images_per_s": ips, "launches_per_forward": per_fwd}
    return model, xcal, out


def serve_continuous(plan_set, requests, *, rate: float, max_wait_ms: float = 5.0,
                     max_queue=None, shed: str = "reject", deadline_s=None, seed: int = 0,
                     model=None, reload_every=None, ckpt_dir=None, faults=None,
                     max_restarts: int = 5, tune: str = "cache", log=print) -> dict:
    """Offer ``requests`` (numpy arrays of one or more images) to a
    :class:`~repro_torch.launch.server.CNNServer` over ``plan_set`` under a
    :class:`~repro_torch.launch.supervisor.Supervisor` (``max_restarts``
    crashes within its window open the breaker), at Poisson arrivals of
    ``rate`` requests/s after its warmup; ``faults`` installs an injector.

    ``reload_every`` (with ``model``, the quantized ``SparseCNN`` the plan
    set was built from) saves ``model.state()`` as a verified checkpoint at
    startup (in ``ckpt_dir``, by default a temporary directory removed
    afterwards) and hot-reloads it every ``reload_every`` requests
    mid-traffic: restore, a fresh ``SparseCNN`` on the device loaded with
    the restored state, its plan set warmed and swapped in, on a thread of
    its own while the arrivals go on. ``tune`` is the mode ``plan_set`` was
    built with: a reload resolves with ``'cache'`` after a ``'search'``
    build (it takes what the search persisted, never searches again), else
    with the same mode, as the reference's.

    Shed, expired and failed requests, and submits refused in a restart's
    gap, are tallied, not raised. Returns ``{"results"}`` (logits or None
    per request), ``"failures"`` (a tally by error), ``"refused"`` (the
    requests whose submit raised, also in ``"failures"``), ``"summary"``
    (``ServerStats.summary()``, accounting checked),
    ``"retraces_after_warmup"``, ``"health"``, ``"reloads"`` (per reload:
    the request it started at, the step, the phases' ms, the captures
    after warmup of the set it replaced, the requests submitted and the
    batches dispatched when the swap returned and, on a card,
    ``torch.cuda.memory_reserved()`` once the batch in flight at the swap
    has ended, after a ``gc.collect()`` and an ``empty_cache()``: what the
    live plan sets hold), ``"last_restart"`` (the
    supervisor's) and ``"checkpoint"`` (save ms and bytes, with
    ``reload_every``)."""
    import gc
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from repro_torch.checkpoint.store import save
    from repro_torch.launch.server import (CNNServer, Overloaded, ServerCrashed,
                                           poisson_arrivals)
    from repro_torch.launch.supervisor import Supervisor

    if reload_every is not None and model is None:
        raise ValueError("reload_every needs the model the plan set was built from")
    arrivals = poisson_arrivals(rate, len(requests), seed=seed)
    srv = CNNServer(plan_set, max_wait_ms=max_wait_ms, max_queue=max_queue, shed=shed,
                    faults=faults)

    retune = "cache" if tune == "search" else tune

    def rebuild(tree):  # a fresh model on the device, loaded with the restored state
        return SparseCNN(model.cfg).load_state(tree).plan_set(buckets=plan_set.buckets,
                                                              tune=retune)

    sup = Supervisor(srv, max_restarts=max_restarts,
                     rebuild=None if model is None else rebuild,
                     template=None if model is None else model.state())
    cuda = next(iter(plan_set.plans.values())).device.type == "cuda"
    own_dir = reload_every is not None and ckpt_dir is None
    checkpoint = None
    if reload_every is not None:
        ckpt_dir = Path(tempfile.mkdtemp(prefix="serve-ckpt-") if own_dir else ckpt_dir)
        t0 = time.perf_counter()
        path = save(ckpt_dir, 1, model.state())
        checkpoint = {"save_ms": (time.perf_counter() - t0) * 1e3,
                      "bytes": sum(f.stat().st_size for f in path.iterdir())}
        log(f"[serve] hot reload every {reload_every} requests from the verified checkpoint "
            f"{path} ({checkpoint['bytes']} bytes, saved in {checkpoint['save_ms']:.1f} ms)")
    results, failures, futures, pending = [], {}, [], []
    refused = 0

    def tally(name):
        failures[name] = failures.get(name, 0) + 1

    def reload(i):
        before = sup.retraces_after_warmup
        step, fp = sup.reload(ckpt_dir)
        rec = {"at": i, "step": step, **{f"{k}_ms": v for k, v in sup.last_reload.items()},
               "retraces_before_swap": before, "submitted_at_swap": len(futures),
               "batches_at_swap": sup.stats.batches}
        if cuda:  # what the live plan sets hold: the pools of released sets returned
            # the batch in flight at the swap holds the replaced set until it
            # ends, which the next batch's start shows (or a quiet second)
            quiet = time.monotonic() + 1.0
            while sup.stats.batches <= rec["batches_at_swap"] and time.monotonic() < quiet:
                time.sleep(1e-3)
            gc.collect()
            torch.cuda.empty_cache()
            rec["reserved_bytes"] = torch.cuda.memory_reserved()
        log(f"[serve] hot reload from request {i}: step {step}, plan set {fp[:12]} swapped "
            f"in; ms restore {rec['restore_ms']:.1f}, rebuild {rec['rebuild_ms']:.1f}, capture "
            f"{rec['capture_ms']:.1f}, swap {rec['swap_ms']:.3f}")
        return rec

    try:
        # a reload runs on its own thread, so arrivals go on while it captures
        with sup, ThreadPoolExecutor(max_workers=1, thread_name_prefix="reload") as reloader:
            sup.warmup()
            t0 = time.monotonic()
            for i, (x, t_arr) in enumerate(zip(requests, arrivals)):
                lag = t_arr - (time.monotonic() - t0)
                if lag > 0:
                    time.sleep(lag)
                if reload_every is not None and i and i % reload_every == 0:
                    pending.append(reloader.submit(reload, i))
                try:
                    futures.append(sup.submit(x, deadline_s=deadline_s))
                except (Overloaded, ServerCrashed) as e:  # shed, or a restart's gap
                    tally(type(e).__name__)
                    refused += 1
                    futures.append(None)
            reloads = [f.result() for f in pending]
            timeout_s = sup.request_timeout_s()
            for f in futures:
                try:
                    results.append(None if f is None else f.result(timeout=timeout_s))
                except Exception as e:  # noqa: BLE001 -- tallied; the run goes on
                    tally(type(e).__name__)
                    results.append(None)
            health = sup.health()
    finally:
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    sup.stats.assert_accounting()
    s = sup.stats.summary()
    log(f"[serve] {s['completed']}/{s['offered']} images of {len(requests)} requests in "
        f"{s['batches']} batches {s['bucket_counts']} (padded_frac {s['padded_frac']}); "
        f"failures {failures or 'none'}")
    log(f"[serve] supervisor: restarts {s['restarts']}, requeued {s['requeued']}, reloads "
        f"{s['reloads']}, demoted buckets {sorted(health['demoted']) or 'none'}")
    log(f"[serve] p50 {s['p50_us']} us, p99 {s['p99_us']} us, {s['throughput_rps']} images/s, "
        f"captures after warmup {sup.retraces_after_warmup}, health {health['status']}")
    return {"results": results, "failures": failures, "refused": refused, "summary": s,
            "retraces_after_warmup": sup.retraces_after_warmup, "health": health,
            "reloads": reloads, "last_restart": sup.last_restart, "checkpoint": checkpoint}


# ---------------------------------------------------------------- the LM


# the sequence caches, by key, and the axis each grows along: K/V (…, S,
# kv, hd), MLA's latent c_kv (…, S, r) and k_rope (…, S, qk_rope_dim)
SEQ_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}
# a cross block's memory K/V: cross_len slots that decode reads whole
CROSS = "cross"


def pad_cache(cache, plen: int, max_len: int):
    """The prefill's cache (sequence length ``plen``) as the decode cache
    of capacity ``max_len``, allocated once. Leaves are told apart by key
    (``SEQ_AXIS``): a sequence cache (K/V, MLA's ``c_kv`` and ``k_rope``)
    gets the prefill's entries in slots 0 … plen - 1 of its sequence axis
    and zeros after, the layout of the reference's ``pad_to_cap``; a
    recurrent block's state (fixed-size: ``h``, ``conv``, ``s``,
    ``shift``, ``cm_shift``) and a cross block's memory K/V (the ``cross``
    subtree: padding would add zero keys to every cross softmax) are
    copied as they are. The reference pads by shape, which also pads a
    state leaf whose axis happens to equal ``plen``, the batch axis of a
    ``c_kv`` when the batch does, and the cross K/V when ``plen`` equals
    ``cross_len``."""
    out = {}
    for k, v in cache.items():
        if k == CROSS:
            out[k] = {name: t.clone() for name, t in v.items()}
        elif isinstance(v, dict):
            out[k] = pad_cache(v, plen, max_len)
        elif k in SEQ_AXIS:
            axis = v.dim() + SEQ_AXIS[k]
            shape = list(v.shape)
            shape[axis] = max_len
            out[k] = v.new_zeros(shape)
            out[k].narrow(axis, 0, plen).copy_(v)
        else:
            out[k] = v.clone()
    return out


def restore_state(cache, prefill_cache) -> None:
    """Set every recurrent state leaf of ``cache`` back to the prefill's,
    in place (a decode step advances it; a sequence cache's slots are
    rewritten by the step at their position; a cross block's memory K/V
    are never written)."""
    for k, v in cache.items():
        if k == CROSS:
            continue
        if isinstance(v, dict):
            restore_state(v, prefill_cache[k])
        elif k not in SEQ_AXIS:
            v.copy_(prefill_cache[k])


def generate(model: LM, prompt_batch, *, gen_len: int, max_len: int, keep=(),
             prefill_reps: int = 3, graph: bool = True) -> dict:
    """Greedy batched generation: prefill, then ``gen_len - 1`` decode steps;
    decode step i consumes generated token i at position ``prompt_len + i``.

    On a card the prefill (at (B, prompt_len)) and the decode step (at (B,
    ``max_len``)) are each captured once into a CUDA graph
    (``models/plan.py:capture``), as the reference jits both, and every
    prefill and decode step after is one replay. Static buffers hold the
    prompt, the token fed to the step and its position (a 0-d int64 tensor);
    the step writes the cache in place, takes the argmax into the token
    buffer and the generated tokens, and advances the position, all on the
    card; a recurrent block's state is advanced in place. The warm-up
    step's writes are undone before step 0 (the position, the token and
    the recurrent state set back to the prefill's; the K/V slot it wrote
    is written again by step 0). ``graph=False`` runs the same two
    functions eagerly, op by op: a replay is held against that bit for
    bit. On the CPU nothing is captured: ``graph=True`` runs them eagerly
    too and counts each as a staged signature, as ``ModelPlan`` does.

    The prompt batch's ``memory`` and ``vision_embeds`` ride beside its
    tokens as static buffers of the prefill; the step reads no side input.
    An audio model feeds the argmax's index within a codebook to every
    codebook, as the reference.

    Returns ``{"tokens": (B, gen_len) int32 ((B, gen_len, num_codebooks)
    for audio), "steps_per_s", "prefill_ms",
    "ms_per_step", "prefill_host_ms", "host_ms_per_step", "logits": {i: the
    logits of decode step i for i in keep}, "forwards": {"prefill": n,
    "decode": n}, "captures", "replays": {"prefill": n, "decode": n},
    "graph_launches": {"prefill": {kernel: n}, "decode": {...}}}``. Times by
    CUDA events on a card (the host clock on the CPU), each part warm:
    ``prefill_ms`` is the mean of ``prefill_reps`` prefills after an untimed
    one, and the decode loop is timed after an untimed step 0, which the
    timed step 0 then writes over with the same values. The ``host`` times
    are the host clock's until the calls return, before any synchronize:
    the time to enqueue the work (one prefill; the decode loop per step).
    ``forwards`` counts every forward enqueued: eager runs (warm-ups
    included), the one each capture records, and replays. ``captures``
    counts the graphs (staged signatures on the CPU), ``replays`` their
    replays and ``graph_launches`` what one replay of each launches (on a
    card): the launch counters see a capture and its eager warm-up, not a
    replay, so a kernel's launches are its count plus ``graph_launches`` ×
    ``replays``, one forward's launches × ``forwards``."""
    from repro_torch.kernels.timing import event_ms
    from repro_torch.models.plan import GraphPool, capture

    prefill, step = make_prefill(model), make_serve_step(model)
    c = model.cfg
    dev = model.device
    graphed = graph and dev.type == "cuda"
    # static buffers: the prompt and its side inputs, the token fed to the
    # step (audio: one per codebook), its position, the generated tokens
    prompt = {k: v.to(dev).clone() for k, v in prompt_batch.items()
              if k == "tokens" or k in SIDE_INPUTS}
    b, plen = prompt["tokens"].shape[:2]
    books = (c.num_codebooks,) if c.frontend == "audio" else ()
    tok = torch.zeros((b, 1) + books, dtype=torch.int32, device=dev)
    pos = torch.zeros((), dtype=torch.int64, device=dev)
    out = torch.zeros((b, gen_len) + books, dtype=torch.int32, device=dev)
    forwards = {"prefill": 0, "decode": 0}
    replays = {"prefill": 0, "decode": 0}
    graph_launches = {}

    def greedy(logits):
        """The argmax token (B, 1); audio: its index within a codebook's
        vocabulary, fed to every codebook, as the reference."""
        nxt = logits.argmax(dim=-1).to(torch.int32)
        if books:
            nxt = (nxt % c.codebook_vocab)[..., None].expand(b, 1, *books)
        return nxt

    def prefill_fn():
        forwards["prefill"] += 1
        last, kv = prefill(prompt)
        nxt = greedy(last)
        tok.copy_(nxt)
        out[:, :1].copy_(nxt)
        pos.fill_(plen)
        return last, kv

    def compiled(kind, fn):
        """``fn`` captured (on a card with ``graph``) -> a replay; else ``fn``."""
        if not graphed:
            return fn
        g, static_out, graph_launches[kind] = capture(fn, GraphPool(), dev)

        def replay():
            g.replay()
            forwards[kind] += 1
            replays[kind] += 1
            return static_out

        return replay

    with torch.no_grad():
        run_prefill = compiled("prefill", prefill_fn)
        prefill_ms = event_ms(run_prefill, reps=prefill_reps, warmup=1, device=dev)
        t0 = time.perf_counter()
        _, kv = run_prefill()
        prefill_host_ms = (time.perf_counter() - t0) * 1e3
        cache = pad_cache(kv, plen, max_len)  # written in place by every step

        def step_fn():
            forwards["decode"] += 1
            logits, _ = step(cache, {"tokens": tok}, pos)
            nxt = greedy(logits)
            tok.copy_(nxt)
            out.index_copy_(1, pos.reshape(1) - (plen - 1), nxt)
            pos.add_(1)
            return logits

        if gen_len > 1:  # a warm-up step (a capture runs one itself), then back to step 0
            run_step = compiled("decode", step_fn)
            if not graphed:
                run_step()
            pos.fill_(plen)
            tok.copy_(out[:, :1])
            restore_state(cache, kv)
        kept, host = {}, []

        def decode():
            t0 = time.perf_counter()
            for i in range(gen_len - 1):
                logits = run_step()
                if i in keep:
                    kept[i] = logits.clone()
            host.append((time.perf_counter() - t0) * 1e3)

        decode_ms = event_ms(decode, reps=1, warmup=0, device=dev)
    steps = max(gen_len - 1, 1)
    return {"tokens": out.clone(), "steps_per_s": steps / max(decode_ms, 1e-9) * 1e3,
            "prefill_ms": prefill_ms, "ms_per_step": decode_ms / steps,
            "prefill_host_ms": prefill_host_ms, "host_ms_per_step": host[0] / steps,
            "logits": kept, "forwards": forwards,
            "captures": (1 + (gen_len > 1)) * graph, "replays": replays,
            "graph_launches": graph_launches}


def lm_config(arch, *, smoke: bool = False, sparsity=0.625, dense: bool = False):
    """The config of ``arch``: a registry name (its ``smoke`` variant on
    request), or a ``ModelConfig`` taken as it is (a depth cut, say), its
    DBB format dropped for ``dense``."""
    if isinstance(arch, ModelConfig):
        return dataclasses.replace(arch, dbb=None) if dense else arch
    return (smoke_config if smoke else get_config)(arch, sparsity=None if dense else sparsity)


def build_lm(arch, *, device=None, seed: int = 0, smoke: bool = False, sparsity=0.625,
             dense: bool = False) -> LM:
    """Seeded LM of ``arch`` (a name or a ``ModelConfig``, as
    :func:`lm_config`) on ``device``: weights drawn there from one
    ``torch.Generator``, each DBB-tagged leaf compressed as soon as it is
    drawn (``dense``: the dense baseline)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(lm_config(arch, smoke=smoke, sparsity=sparsity, dense=dense)).init(
        gen, dev, compress=True)


def prompt_tokens(model: LM, *, batch: int, seq: int, seed: int = 0) -> dict:
    """A seeded prompt batch, drawn on the model's device: its tokens and
    the side inputs the model takes (``memory``, ``vision_embeds``;
    ``configs.make_batch``)."""
    gen = torch.Generator(device=model.device).manual_seed(seed + 1)
    return make_batch(model.cfg, batch=batch, seq=seq, generator=gen, kind="serve")


def serve_lm(arch, *, batch: int = 4, prompt_len: int = 32, gen: int = 16, device=None,
             seed: int = 0, smoke: bool = False, sparsity=0.625, dense: bool = False,
             keep=(), log=print) -> dict:
    """Build ``arch`` (a name or a ``ModelConfig``) and generate ``gen``
    tokens greedily after a ``prompt_len`` prompt. Returns :func:`generate`'s record with the
    ``model``, the ``prompt`` tokens and the whole prompt batch as
    ``inputs`` (the tokens and their side inputs)."""
    model = build_lm(arch, device=device, seed=seed, smoke=smoke, sparsity=sparsity,
                     dense=dense)
    c = model.cfg
    where = (torch.cuda.get_device_name(model.device) if model.device.type == "cuda"
             else "the CPU (plain versions)")
    weights = (f"VDBB-compressed, nnz={c.dbb.nnz}/{c.dbb.bz}" if c.dbb is not None
               else "dense")
    log(f"[serve] {c.name}: {c.param_count() / 1e6:.2f} M weights, {weights}, "
        f"{str(c.compute_dtype).replace('torch.', '')}, on {where}")
    prompt = prompt_tokens(model, batch=batch, seq=prompt_len, seed=seed)
    side = ", ".join(f"{k} {tuple(prompt[k].shape)}" for k in SIDE_INPUTS if k in prompt)
    if side:
        log(f"[serve] side inputs: {side}")
    rec = generate(model, prompt, gen_len=gen, max_len=prompt_len + gen, keep=keep)
    log(f"[serve] generated {tuple(rec['tokens'].shape)} tokens: prefill "
        f"({batch}x{prompt_len}) {rec['prefill_ms']:.3f} ms, {rec['ms_per_step']:.3f} ms per "
        f"decode step, {rec['steps_per_s']:.2f} decode steps/s")
    return dict(rec, model=model, prompt=prompt["tokens"], inputs=prompt)


def time_in_turns(fns: dict, order, reps: int, device) -> dict:
    """``reps`` calls of each named function in ``order`` (e.g. unplanned,
    planned, planned, unplanned), ms per call each time (``event_ms``: CUDA
    events on a card, the host clock on the CPU), each function warmed up
    once before the first turn."""
    from repro_torch.kernels.timing import event_ms

    out = {}
    with torch.no_grad():
        for name in fns:
            fns[name]()  # warm-up
        for name in order:
            out.setdefault(name, []).append(event_ms(fns[name], reps=reps, warmup=0,
                                                     device=device))
    return out


def serve_lm_plan(arch, *, batch: int = 4, prompt_len: int = 32, steps: int = 16,
                  device=None, seed: int = 0, smoke: bool = False, sparsity=0.625,
                  tune: str = "cache", log=print) -> dict:
    """LM prefill of ``arch`` (a name or a ``ModelConfig``) served through a
    frozen plan: compress, calibrate (one
    forward recording every projection's input), INT8-quantize,
    ``LM.plan`` (its launch choices under ``tune``), validate each request
    row against the plan's sample spec,
    then check that the plan's logits equal the unplanned INT8 forward's bit
    for bit and time both in turns. A model with a frontend or
    cross-attention raises ``NotImplementedError`` first, as ``LM.plan``.
    Returns ``{"bit_identical", "plan",
    "model", "tokens", "logits", "timing", "captures", "graph_launches"}``."""
    from repro_torch.launch.server import validate_request

    cfg = lm_config(arch, smoke=smoke, sparsity=sparsity)
    check_plannable(cfg)  # before the build: a frontend or cross-attention cannot be planned
    if cfg.dbb is None:
        raise SystemExit("--lm-plan needs a DBB config (drop --dense)")
    model = build_lm(arch, device=device, seed=seed, smoke=smoke, sparsity=sparsity)
    tokens = prompt_tokens(model, batch=batch, seq=prompt_len, seed=seed)["tokens"]
    with torch.no_grad():
        _, stats = model.forward(tokens, collect_act_stats=True)
    model.quantize(stats)
    c = model.cfg
    log(f"[serve] {c.name}: INT8-calibrated VDBB LM (nnz={c.dbb.nnz}/{c.dbb.bz}, "
        f"{len(stats)} calibrated projections)")
    plan = model.plan(batch=batch, seq=prompt_len, tune=tune)
    log(f"[serve] frozen plan: {len(plan.layers)} stages ({tune})")
    for row in tokens.cpu().numpy():
        validate_request(row[None], plan.sample_spec)
    with torch.no_grad():
        planned = plan(tokens)
        unplanned = model.forward(tokens)
    bit = bool(torch.equal(planned, unplanned))
    log(f"[serve] plan vs unplanned forward bit-identical: {bit}")
    timing = time_in_turns({"unplanned": lambda: model.forward(tokens),
                            "planned": lambda: plan(tokens)},
                           ("unplanned", "planned", "planned", "unplanned"), steps,
                           model.device)
    log(f"[serve] prefill ({batch}x{prompt_len}) in turns, ms per call: "
        + ", ".join(f"{k} {['%.3f' % t for t in v]}" for k, v in timing.items()))
    return {"bit_identical": bit, "plan": plan, "model": model, "tokens": tokens,
            "logits": planned, "timing": timing, "captures": plan.trace_count,
            "graph_launches": plan.graph_launches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="sparse-cnn-s", choices=sorted(CNN_ARCHS) + sorted(ARCHS))
    ap.add_argument("--batch", type=int, nargs="+", default=None,
                    help="request batch sizes to serve (CNN; default 64), or the one LM "
                         "batch (default 4)")
    ap.add_argument("--requests", type=int, default=8,
                    help="timed requests per batch size (with --server: requests offered)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="reduced config of the arch")
    ap.add_argument("--sparsity", type=float, default=0.625,
                    help="weight sparsity: 0.625 -> 3/8 DBB, 0 -> dense")
    ap.add_argument("--dense", action="store_true", help="LM: the dense baseline")
    ap.add_argument("--prompt-len", type=int, default=32, help="LM: prompt tokens")
    ap.add_argument("--gen", type=int, default=16, help="LM: tokens generated")
    ap.add_argument("--steps", type=int, default=16,
                    help="LM --lm-plan: timed prefill calls per turn")
    ap.add_argument("--lm-plan", action="store_true",
                    help="LM: serve prefill through a frozen INT8 plan instead of generating")
    ap.add_argument("--tune", choices=("off", "cache", "search"), default="cache",
                    help="plans' launch choices: the autotune cache's (default), a search "
                         "on the card for what it lacks, or the kernels' rules")
    ap.add_argument("--plan", action=argparse.BooleanOptionalAction, default=True,
                    help="serve through a frozen plan set (--no-plan: the unplanned forward)")
    ap.add_argument("--server", action="store_true",
                    help="the continuous-batching tier under Poisson arrivals")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="server: the largest bucket and aggregation cap")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="server: the longest a partial batch waits")
    ap.add_argument("--rate", type=float, default=None,
                    help="server: offered requests/s (default: half the measured capacity)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="server: admission bound in samples (default: unbounded)")
    ap.add_argument("--shed", choices=("reject", "block"), default="reject",
                    help="server: at --max-queue, reject (Overloaded) or block the submitter")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="server: per-request deadline (DeadlineExceeded past it)")
    ap.add_argument("--reload-every", type=int, default=None,
                    help="server: checkpoint the quantized weights at startup and hot-reload "
                         "them (verify, rebuild, capture, swap) every N requests mid-traffic")
    args = ap.parse_args(argv)
    if args.arch in ARCHS:
        batch = args.batch[0] if args.batch else 4
        if args.lm_plan:
            return serve_lm_plan(args.arch, batch=batch, prompt_len=args.prompt_len,
                                 steps=args.steps, device=args.device, seed=args.seed,
                                 smoke=args.smoke, sparsity=args.sparsity, tune=args.tune)
        return serve_lm(args.arch, batch=batch, prompt_len=args.prompt_len, gen=args.gen,
                        device=args.device, seed=args.seed, smoke=args.smoke,
                        sparsity=args.sparsity, dense=args.dense)
    args.batch = args.batch or [64]
    if not args.server:
        serve(args.arch, batches=args.batch, requests=args.requests, device=args.device,
              seed=args.seed, smoke=args.smoke, sparsity=args.sparsity, plan=args.plan,
              tune=args.tune)
        return
    from repro_torch.launch.server import auto_rate

    model, x = build_model(args.arch, calib_batch=args.max_batch, device=args.device,
                           seed=args.seed, smoke=args.smoke, sparsity=args.sparsity)
    plan_set = model.plan_set(max_batch=args.max_batch, tune=args.tune)
    print(f"[serve] plan set: buckets {plan_set.buckets} (tune={args.tune}), max-wait "
          f"{args.max_wait_ms} ms, max-queue {args.max_queue} ({args.shed})")
    rate = args.rate
    if rate is None:
        rate, bucket_us = auto_rate(plan_set, x.shape[1:])
        print(f"[serve] auto rate: {rate:.1f} requests/s (half the capacity; the largest "
              f"bucket takes {bucket_us:.0f} us)")
    pool = x.cpu().numpy()
    requests = [pool[i % pool.shape[0]][None] for i in range(args.requests)]
    serve_continuous(plan_set, requests, rate=rate, max_wait_ms=args.max_wait_ms,
                     max_queue=args.max_queue, shed=args.shed,
                     deadline_s=args.deadline_ms / 1e3 if args.deadline_ms else None,
                     seed=args.seed, model=model, reload_every=args.reload_every,
                     tune=args.tune)


if __name__ == "__main__":
    main()
