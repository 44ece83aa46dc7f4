#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card
(``python3 chip_smoke.py``, no arguments).  Phases, each of which raises
on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel) into
   ``build/repro_torch/``;
3. hold each kernel against its plain PyTorch version on the card:
   paged decode on the conformance cases of ``kernels/cases.py`` (the
   other registered configs' shapes among them: gemma2-2b's 8 heads on
   4 kv heads of 256 with window 4096 and softcap 50 over lists that run
   past the window, granite-20b's 48 heads on one kv head of 128,
   qwen1.5-4b's 20 heads of 128, at K1 = 1 and 4, each also launched
   twice for identical bits, with its launch plan printed) and the serve
   shapes (Hq = Hkv = 16, dh = 64, page 16, K1 = 1 for a
   decode step and K1 = 4 for a verify step), f32 and bf16 pools, with
   and without the int8 wire epilogue (within 2e-5, the wire within one
   int8 step); ``lif_encode`` (in both of its compute
   types, float32 and bfloat16, with and without its decode epilogue),
   ``pack4``, ``pack4_counts`` (the wire's bias fused into the pack, f32
   and bf16 counts), ``unpack4`` and ``unpack4_decode`` (the wire's
   unbias and rate decode fused into the unpack, f32 and bf16 results)
   on their conformance cases (every byte value among them), on the
   edges of their vector layouts (``LIF_TAIL_CASES``,
   ``PACK4_TAIL_CASES``, and buffers not aligned for the vector
   accesses) and at the serve shapes [4, 1024], [120, 1024] and [256,
   1024], every output exactly;
   ``count_matmul`` on its conformance sweep (M in {1, 4, 33, 256}, K in
   {128, 300, 1024}, N in {200, 1024, 2816}, and the edges of each of its
   designs: every M in 1..17 at ragged K and N, prefill rows at ragged K
   and N; T in {7, 15}, float32 and bf16 weights and results; float32
   within rtol = atol = 2e-5, bf16 the rounding of a float32 sum within
   that of the plain version's); then paged decode and ``count_matmul``
   twice on the same inputs at their serve shapes, which must give the
   same bits;
4. serve the full-width ``qwen1.5-0.5b`` (d_model 1024, 16 heads of 64,
   d_ff 2816, vocab 151936) at L = ``N_LAYERS`` = 8 of its 24 layers
   (phases 4-8; HNN mode; float32 weights from
   the port's seeded init) through ``ServingEngine``: eight requests of
   16-120 prompt tokens and 32 new tokens each on four slots, once per
   coded-boundary codec — ``spike_fused`` (the main path of the first
   slice), then ``spike`` (the T-tick IF encoder, ``lif_encode`` at
   every coded boundary, the wire roundtrips' decode in its epilogue),
   ``spike_pack4`` (``pack4_counts`` before and ``unpack4_decode`` after
   every coded exchange) and ``sparse_topk``.  For
   each codec the kernel walk's run is timed with every launch count set
   to 0 just before it and read just after: paged decode must launch L
   times per decode step, ``lif_encode`` 4 x L times per decode step
   and per prefill under ``spike``, ``pack4`` and ``unpack4`` L x (2
   per decode step + 4 per prefill) under ``spike_pack4``, and every
   page must be free at the end.  In the checked run every wire
   roundtrip under ``spike`` must be a ``lif_encode`` launch with the
   epilogue, and every pack and unpack under ``spike_pack4`` a
   ``pack4_counts`` and an ``unpack4_decode`` launch.  The reference walk (same boundary
   kernel counts, no paged decode) and a second kernel-walk run (every
   launch of every kernel checked against its plain version on its live
   inputs) are traced at every coded wire: their greedy streams must
   agree up to each request's first coded value that rounds the other
   way — where the values it rounds from must agree to float noise — or
   to a reference top-1/top-2 logit margin of 1e-4.  In ANN mode (codec
   ``none``), where nothing rounds on a wire, the two walks' streams
   must agree up to the margin rule alone.  Last, the same model in its
   published dtype, bfloat16, serves the same requests under ``spike``
   (``lif_encode`` in its bf16 mode), checked the same way; in its
   checked run the count matmul shadow is on: at every boundary whose
   decoded output feeds a projection, ``count_matmul`` runs on the int8
   wire counts once per consuming weight (wq, wk, wv after the attention
   input, w1, w3 after the MLP input: L x 5 launches per decode step
   and per prefill), each launch held to its plain version, and the
   served streams must not change.  SNN mode (``hnn_mode="snn"``, the
   SNN roundtrips given seeded thresholds of their own) serves the same
   requests under ``spike_fused`` and ``spike`` the same way, with one
   more ``lif_encode`` launch per layer and decode step and two per
   prefill under ``spike``, each exact;
5. speculative decoding with the n-gram drafter (``spec_k = 3``, so
   paged decode at K1 = 4 and the boundary kernels on 16 rows): eight
   cyclic prompts of 16-120 tokens (period ``len // 4``) x 32 new
   tokens, under ``none`` (ANN mode), ``spike_fused``, ``spike`` and
   ``spike_pack4``, each beside a ``spec_k=0`` run of the same requests:
   launch counts per verify step as per decode step, every live launch
   checked (paged decode at K1 = 4 against its plain version, the
   boundary kernels exactly), and the streams equal to the ``spec_k=0``
   streams up to each request's first coded value that rounds the
   other way (``WireTrace``, ``rounding_splits``) or a margin of 1e-4;
   verify steps, the mean accepted length and tokens/s printed;
6. stochastic sampling: 4096 draws within total-variation distance 0.06
   of the host reference with no filter, top-k 8 and top-p 0.6, and the
   main path served twice at temperature 0.8 (top-k 50, top-p 0.9, two
   greedy requests) with one seed: the same streams twice, and the
   greedy requests' streams those of the greedy run;
7. the dispatch/commit pipeline: the main path's requests served at
   ``async_depth=1`` beside ``async_depth=0`` under ``spike_fused``,
   ``spike`` and ``spike_pack4``, plainly and with ``spec_k=3``: each
   kernel launched as many times per step and prefill as in the
   synchronous run, every pipelined decode dispatch free of host syncs
   (``torch.cuda.set_sync_debug_mode("error")``), the streams equal to
   the synchronous ones up to the split rule, every page free and the
   limbo empty; tokens/s and the median step time of both depths;
8. faults: a ``multitenant`` trace replayed on the logical clock at
   ``async_depth=1`` under ``spike_fused``, fault-free and with a seeded
   ``FaultInjector`` (preemption, replica loss, suspend): each stream
   equal to the fault-free replay's (after a work-preserving resume, to
   the continuation of its re-prefilled prompt), the ``SLOMonitor``'s
   TTFT / TPOT / step percentiles and attainment on the host clock;
9. the rest of the dense attention family at its published widths, in
   float32 with seeded weights: ``gemma2-2b`` (26 layers, d_model 2304,
   vocab 256000; local/global windows, both softcaps, post-norms, GeGLU,
   tied embeddings) serves the main path's requests under ``none`` (ANN
   mode), ``spike_fused``, ``spike`` and ``spike_pack4`` as in phase 4
   (26 paged-decode launches a decode step), a ``spec_k=3`` serve under
   ``spike_fused`` as in phase 5, a long-context serve (prompts of 4,200
   and 4,500 tokens, 16 new, ``prefill_len`` 4608, ``max_seq`` 4640),
   whose windowed launches must skip pages wholly outside the window,
   and the ``launch.serve`` steps (a [2, 256] prefill, then 8 greedy
   decode steps over its dense cache, equal to the engine's streams for
   the same prompts up to the margin rule); ``granite-20b`` at 4 of its
   52 layers (its full depth, 105 GiB in float32, does not fit one card)
   serves them under ``none`` and ``spike_fused``, each at ``spec_k`` 0
   and 3, every live paged-decode launch held to its plain version;
10. the MoE family, every earlier model freed first: full-width
   ``qwen2-moe-a2.7b`` (24 layers, d_model 2048, 16 MHA heads of 128,
   60 experts top-4 and 4 shared of 1408, 14.32 B parameters, 53.4 GiB
   in float32, seeded) serves the main path's requests under ``none``,
   ``spike_fused`` and ``spike`` as in phase 4 (``lif_encode`` at a MoE
   layer's two attention boundaries: its MoE block has no coded
   exchange at world size 1; ``spike_pack4`` cut for time), every router
   traced (``WireTrace``: its probabilities and choices, and each row's
   kept assignments beside every row's choices), so the walks agree up
   to a rounding split, a routing split (a router's k-th and (k+1)-th
   probabilities within float noise of each other) or a capacity split
   (another row of the step, a dead slot's among them, chose other
   experts); the ``spike_fused`` run is served again for the same
   streams and margins; the cyclic prompts at ``spec_k`` 3 beside 0
   under ``spike_fused`` (agreement and both runs' dropped assignments
   printed, not gated: capacity depends on the step's rows); the CUDA
   kernels of one decode step.  ``llama4-maverick-400b-a17b`` at full
   width, 2 of its 48 layers (a dense and a MoE block of 128 experts,
   bfloat16): ``none`` and ``spike_fused`` (its spec runs cut for
   time).
   Then ``qwen2-moe-a2.7b`` at 2 layers trains 20 AdamW steps under
   ``spike_fused`` and ``spike`` as in phase 11 (each MoE layer's
   ``sp_disp`` moved by the first step, its ``sp_comb`` gradient
   exactly 0); dropped assignments per step printed throughout;
11. training: the boundaries' backward kernels — K1 ``roundtrip_bwd``
   (f32 and bf16) and K2 ``lif_encode_bwd`` (f32) — against their
   plain versions at [1024, 1024] (the training runs' boundary, one
   microbatch), [2048, 1024] and [37, 1024] (K1's dx bit-equal, its
   sums within 1e-5 of their terms' magnitudes, each K2 output element
   within 1e-5 of itself plus 1e-6 of the output's largest entry, both
   the same bits twice); then full-width ``qwen1.5-0.5b`` at
   ``TRAIN_LAYERS`` = 8 of its 24 layers (f32, seeded init) trains
   ``TRAIN_STEPS`` = 30 AdamW steps (lr 1e-3,
   warmup 5, two microbatches of 4 x 256 ``SyntheticLM`` tokens) under
   ``none`` (ANN), ``spike_fused``, ``spike``, ``spike_pack4`` and
   ``spike_fused+bwd8``: every loss and grad norm finite, the loss
   down by at least 1 nat (the last 5 steps' mean against step 0),
   every layer's boundary thetas and log-scales moved by the first step
   under the spike codecs, each step's launches those the path predicts
   (``train_launches``), and under every spike codec one step's
   gradients with the kernels, leaf by leaf, within 1e-5 of the leaf's
   largest entry of those with the plain versions; each step's loss, penalty, occupancy,
   firing rate and time, the median step and the peak memory printed;
   then ``train_cli.main`` in this process (reduced config): a resume
   from its step-4 checkpoint gives the losses of an uninterrupted
   6-step run within 1e-4;
12. time the launch floor (a one-element ``zero_()``) and each kernel,
   its plain version and its bound at the shapes the serve path gives
   it (``lif_encode`` in both compute types at the decode and the
   prefill rows, with and without the epilogue; ``pack4`` from both
   entry points; ``unpack4`` from both, ``unpack4_decode`` in f32 and
   bf16 beside the four launches it replaces; paged decode also against PyTorch's
   ``scaled_dot_product_attention`` on the gathered K/V of the same live
   tokens, ``count_matmul`` — at [4, 1024] and [256, 1024] times both
   weight shapes it meets, [1024, 2816] (w1, w3) and [1024, 1024] (wq,
   wk, wv) — against ``torch.matmul`` of the decoded float32
   activations and float32 weights, as yardsticks only); count the
   CUDA kernels and memory operations of one decode step of four slots
   of the full 24-layer model, f32, under ``spike_fused``, ``spike`` and
   ``spike_pack4``, with
   ``torch.profiler`` (after every timing); print one ``kernels`` JSON
   line (paged decode's entry at the main path's decode shape, and
   under ``by_shape`` at every served decode and verify shape of the
   four configs and on the other configs' conformance cases, each with
   its launches, rows per block, row groups and warps, the MoE
   family's decode and verify shapes among them, llama4's over a bf16
   pool; the boundary kernels also at the MoE widths 2048 and 5120; K1
   and K2 at their checked shapes, their launches the ``spike``
   training run's);
13. print ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result.  It imports nothing of JAX.

``python3 chip_smoke.py --paged-times SRC`` prints only paged decode's
kernel and plain times at the main path's decode and verify shapes and
on the other configs' cases, for the package under ``SRC``.

``python3 chip_smoke.py --kernels-per-step SRC`` builds the kernels of
the package under ``SRC`` (the ``src`` directory of a checkout, another
commit's too) and prints only its kernels per decode step (in all and by
kernel name) and a digest
of the streams it serves under the codecs it counts (``streams_sha256``,
as the full run prints them), so that two commits are compared in one
call.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 FLOP/s
# outside the tensor cores — the paged-decode and lif_encode kernels' f32
# math; the pack kernels' few integer operations per byte are set
# against the same scalar rate (they stay far below the byte time)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# dense bf16 tensor-core rate: the rate of count_matmul's design for more
# than 16 rows and bf16 weights (three bf16 products per f32 product)
BF16_TC_FLOP_PER_S = 989e12
MARGIN = 1e-4
#: the depth at which the main path's phases serve qwen1.5-0.5b (of its
#: 24 layers; its widths are not cut): with gemma2-2b and granite-20b
#: served at full width too, the full depth took the smoke to 945 s of
#: its 1200 s on a slower host.  The kernels per decode step are counted
#: at the full 24 layers, comparable with earlier readings.
N_LAYERS = 8
#: the main path's codecs, in the order they are served
CODECS = ("spike_fused", "spike", "spike_pack4", "sparse_topk")
#: the boundary kernels, each equal to its plain version
BOUNDARY_KERNELS = ("lif_encode", "pack4", "unpack4")
#: the weights that consume a boundary's decoded output, per layer: wq,
#: wk, wv after the attention input and w1, w3 after the MLP input
SHADOW_WEIGHTS = 5
REPLACES = {"paged_decode": "src/repro/kernels/paged_decode.py:143",
            "lif_encode": "src/repro/kernels/lif_encode.py:63",
            "count_matmul": "src/repro/kernels/count_matmul.py:59",
            "pack4": "src/repro/kernels/pack4.py:42",
            "unpack4": "src/repro/kernels/pack4.py:59"}
SOURCE = {"paged_decode": "src/repro_torch/csrc/paged_decode.cu",
          "lif_encode": "src/repro_torch/csrc/lif_encode.cu",
          "count_matmul": "src/repro_torch/csrc/count_matmul.cu",
          "pack4": "src/repro_torch/csrc/pack4.cu",
          "unpack4": "src/repro_torch/csrc/pack4.cu"}


#: the main path's architecture; runs of the others carry their name
MAIN_ARCH = "qwen1.5-0.5b"


def arch_label(cfg) -> str:
    return "" if cfg.name == MAIN_ARCH else f"{cfg.name} "


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, flush, n=20, reps=7):
    """Device time of one call of ``fn`` in ms, cold L2: ``n`` calls,
    each after a write of ``flush`` (larger than the 50 MB L2), are
    captured in one CUDA graph and a second graph holds the flushes
    alone; the median over ``reps`` replays of (work - flushes) / n,
    timed with CUDA events.  Replaying graphs keeps the host's launch
    cost out of the device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    work, flushes = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(work):
        for _ in range(n):
            flush.zero_()
            fn()
    with torch.cuda.graph(flushes):
        for _ in range(n):
            flush.zero_()

    def replay_ms(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    times = [(replay_ms(work) - replay_ms(flushes)) / n for _ in range(reps)]
    return float(np.median(times))


def compare_kernel(arrays, window, cap, pool_dtype):
    """Kernel vs plain version on the card, wire off and on.  Returns the
    largest absolute difference over o, lse and the decoded wire."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cases import to_tensors
    from repro_torch.kernels.paged_decode import paged_decode_plain
    ts = to_tensors(arrays, "cuda", pool_dtype)
    err = 0.0
    o, lse = ops.paged_flash_decode(*ts, window=window, cap=cap)
    po, plse = paged_decode_plain(*ts, window=window, cap=cap)
    torch.cuda.synchronize()
    if not (torch.isfinite(o).all() and o.shape == po.shape
            and lse.shape == plse.shape):
        raise AssertionError("kernel output not finite or misshapen")
    torch.testing.assert_close(o, po, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
    err = max(err, float((o - po).abs().max()),
              float((lse - plse).abs().max()))
    w, s, lse_w = ops.paged_flash_decode(*ts, window=window, cap=cap,
                                         encode_wire=True)
    pw, ps, _ = paged_decode_plain(*ts, window=window, cap=cap,
                                   encode_wire=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(lse_w, lse, rtol=0.0, atol=0.0)
    dec, pdec = w.float() * s, pw.float() * ps
    # a value within float rounding of a half step may round either way
    if not bool(((dec - pdec).abs() <= ps + 1e-6).all()):
        raise AssertionError("wire epilogue more than one step off")
    return max(err, float((dec - pdec).abs().max()))


def smoke_requests(vocab):
    """The served workload: eight requests of 16-120 seeded prompt
    tokens, 32 new tokens each.  Returns (prompt lengths, requests)."""
    rng = np.random.RandomState(0)
    lens = rng.randint(16, 121, 8)
    return lens, [(rng.randint(0, vocab, int(L)).tolist(), 32)
                  for L in lens]


def streams_digest(streams):
    """16 hex digits of a hash over a run's greedy streams (rid ->
    tokens), to compare two commits' served tokens."""
    return hashlib.sha256(json.dumps(sorted(streams.items())).encode()
                          ).hexdigest()[:16]


def serve_case(cfg, slot_lens, seed=7, K1=1):
    """Kernel inputs at the serve shape: a pool of 64 pages of one layer,
    four slots whose lists an allocator built for ``slot_lens`` tokens,
    each querying its last K1 positions (K1 = 1: a decode step; K1 =
    SPEC_K + 1: a verify step)."""
    from repro_torch.models.blocks_attn import attn_dims
    from repro_torch.serving.kv_cache import SlotAllocator
    d = attn_dims(cfg)
    psz, max_seq = 16, 256
    alloc = SlotAllocator(len(slot_lens), max_seq, psz)
    rng = np.random.RandomState(seed)
    for L in slot_lens:
        alloc.alloc(L)
    shape = (alloc.num_pages, psz, d["Hkv"], d["dh"])
    q = rng.standard_normal((len(slot_lens), K1, d["Hq"], d["dh"]))
    arrays = (q.astype(np.float32),
              rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal(shape).astype(np.float32),
              alloc.page_list_loc[:, 0].copy(),
              alloc.page_list_pos[:, 0].copy(),
              np.asarray(slot_lens, np.int32)[:, None] - K1
              + np.arange(K1, dtype=np.int32))
    return arrays


def visible_keys(arrays, window=0):
    """Per (slot, query) the number of keys the query sees — listed
    pages' positions at or before its own and, with ``window``, inside
    the window — and per slot the keys some query sees.  Returns
    (sees [B, K1], union [B]), the work this run's data needs."""
    _, kp, _, clp, clo, qpos = arrays
    psz = kp.shape[1]
    kpos = clo[:, :, None] + np.arange(psz)                   # [B, ppc, psz]
    ok = (clp >= 0)[:, :, None].repeat(psz, 2).reshape(len(clp), -1)
    kpos = kpos.reshape(len(clp), -1)
    seen = (kpos[:, None, :] <= qpos[:, :, None]) & ok[:, None, :]
    if window:
        seen &= (qpos[:, :, None] - kpos[:, None, :]) < window
    return seen.sum(-1), seen.any(1).sum(-1)


def time_paged(arrays, window=0, cap=0.0, pool_dtype=torch.float32):
    """(kernel ms, plain ms, SDPA ms or None, bound ms, bound_by) of
    paged decode on a case's arrays (``pool_dtype`` pools, float32
    unless given) with the wire epilogue on, as the coded decode and
    verify steps run it.  SDPA, the
    yardstick, attends over each slot's listed keys gathered densely in
    list order, each query masked to the keys it sees (GQA heads
    shared); no PyTorch call computes a softcapped score, so there is
    none where ``cap`` is set."""
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels.cases import to_tensors
    q, kp, vp, clp, clo, qpos = to_tensors(arrays, "cuda", pool_dtype)
    kw = dict(window=window, cap=cap, encode_wire=True)
    flush = torch.empty(96 * 2**20 // 4, dtype=torch.float32,
                        device="cuda")
    ms = cuda_ms(lambda: PD.paged_decode_cuda(q, kp, vp, clp, clo, qpos,
                                              **kw), flush)
    plain_ms = cuda_ms(lambda: PD.paged_decode_plain(
        q, kp, vp, clp, clo, qpos, **kw), flush)
    B, K1, Hq, dh = q.shape
    _, psz, Hkv, _ = kp.shape
    lib_ms = None
    if not cap:
        ppc = clp.shape[1]
        safe = torch.where(clp >= 0, clp, 0).long()
        k_d = kp[safe].reshape(B, ppc * psz, Hkv, dh).transpose(1, 2)
        v_d = vp[safe].reshape(B, ppc * psz, Hkv, dh).transpose(1, 2)
        kpos = (clo[:, :, None] + torch.arange(psz, device="cuda")
                ).reshape(B, -1)
        ok = (clp >= 0)[:, :, None].expand(B, ppc, psz).reshape(B, -1)
        mask = (kpos[:, None, :] <= qpos[:, :, None]) & ok[:, None, :]
        if window:
            mask &= (qpos[:, :, None] - kpos[:, None, :]) < window
        # up to the last key some query sees (a slot's allocated lists
        # hold pages past its length)
        L = int(mask.any(1).any(0).nonzero().max()) + 1
        k_d = k_d[:, :, :L].contiguous()
        v_d = v_d[:, :, :L].contiguous()
        mask = mask[:, None, :, :L]                          # [B,1,K1,L]
        q_d = q.permute(0, 2, 1, 3).to(kp.dtype).contiguous()
        lib_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q_d, k_d, v_d, attn_mask=mask, enable_gqa=Hq != Hkv),
            flush)
    # least work: every key some query sees, K and V once, q, the list,
    # and the wire outputs (int8 partial, f32 scale, f32 lse); 4 flops
    # per (query head, key it sees, dim)
    sees, union = visible_keys(arrays, window)
    nbytes = (2 * int(union.sum()) * Hkv * dh * kp.element_size()
              + q.numel() * 4 + B * K1 * Hq * dh + 2 * B * K1 * Hq * 4
              + 2 * clp.numel() * 4 + qpos.numel() * 4)
    flops = 4 * int(sees.sum()) * Hq * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (ms, plain_ms, lib_ms, max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def boundary_bound(entry, args, kw):
    """(bound ms, bound_by) of one boundary-kernel call: each input byte
    read once and each output byte written once over the HBM rate, or
    the algorithm's operations over the f32 rate, whichever is larger."""
    x = args[0]
    n = x.numel()
    if entry == "lif_encode":
        # x, theta and scale in, int8 counts out.  One op per channel
        # for theta/s; eight per element for x/s, the absolute value,
        # the gate's subtract and compare, the clip, the select, the sign
        # and the int8 conversion; then, only where this run's data
        # opens the gate on a nonzero drive, one population's add,
        # compare and reset per tick (the other population's drive is 0
        # and it never fires) and two ops to read the count off the final
        # membrane.  The decode epilogue reads decode_scale and writes
        # one value of x's dtype per element, one multiply each
        md = kw.get("math_dtype", torch.float32)
        theta, scale = args[1].to(md), args[2].to(md)
        xn = x.to(md) / scale
        live = int(((xn.abs() - theta / scale >= 0) & (xn != 0)).sum())
        C = x.shape[1]
        nbytes = n * x.element_size() + 2 * C * 4 + n
        flops = C + 8 * n + (3 * kw["T"] + 2) * live
        if kw.get("decode_scale") is not None:
            nbytes += C * 4 + n * x.element_size()
            flops += n
    elif entry == "pack4":
        nbytes, flops = n + n // 2, n          # a shift and an or a byte out
    elif entry == "pack4_counts":
        # counts in, bytes out; an add and a conversion a count, a shift
        # and an or a byte out
        nbytes, flops = n * x.element_size() + n // 2, 3 * n
    elif entry == "unpack4_decode":
        # bytes and the decode factors in, values out; per value a
        # nibble's shift and mask, the subtract and the multiply
        out_size = args[2].element_size()
        nbytes = n + 2 * n * out_size + args[2].numel() * out_size
        flops = 4 * 2 * n
    else:
        nbytes, flops = 3 * n, 3 * n           # and, shift, and a byte in
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def time_boundary(entry, args, kw, flush):
    """(kernel ms, plain ms, bound ms, bound_by) of one boundary-kernel
    entry point on the given (live) inputs."""
    _, module, attr, plain = _boundary_fns()[entry]
    ms = cuda_ms(lambda: getattr(module, attr)(*args, **kw), flush)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), flush)
    return (ms, plain_ms) + boundary_bound(entry, args, kw)


class _Patch:
    """Replace ``module.name`` by ``fn(original, *args, **kw)`` while
    active."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)
        # an instance's method lives on its class: patched, then deleted
        # again (a bound method kept on the instance would keep it alive)
        self.own = self.name in vars(self.module)
        setattr(self.module, self.name,
                lambda *a, **kw: self.fn(orig, *a, **kw))

    def __exit__(self, *exc):
        if self.own:
            setattr(self.module, self.name, self.orig)
        else:
            delattr(self.module, self.name)


def _boundary_fns():
    """Entry point -> (kernel it launches, module, CUDA launch attribute,
    plain version).  ``pack4_counts`` (the bias fused into the pack) is a
    launch of the ``pack4`` kernel, ``unpack4_decode`` (the unbias and
    the decode fused into the unpack) one of ``unpack4``."""
    from repro_torch.kernels import lif_encode as LE
    from repro_torch.kernels import pack4 as PK
    return {"lif_encode": ("lif_encode", LE, "lif_encode_cuda",
                           LE.lif_encode_plain),
            "pack4": ("pack4", PK, "pack4_cuda", PK.pack4_plain),
            "pack4_counts": ("pack4", PK, "pack4_counts_cuda",
                             PK.pack4_counts_plain),
            "unpack4": ("unpack4", PK, "unpack4_cuda", PK.unpack4_plain),
            "unpack4_decode": ("unpack4", PK, "unpack4_decode_cuda",
                               PK.unpack4_decode_plain)}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def same_bits(got, want):
    """Whether every output of a boundary kernel equals its plain
    version's: the same dtype, shape and values."""
    got, want = _outputs(got), _outputs(want)
    return len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


def check_exact(entry, *args, **kw):
    """One launch of a boundary kernel against its plain version on the
    same CUDA inputs; every output (the counts and, with the decode
    epilogue, the decoded values) must be equal.  Returns the largest
    absolute difference (0)."""
    _, module, attr, plain = _boundary_fns()[entry]
    got = getattr(module, attr)(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError(f"{entry}: kernel differs from its plain "
                             f"version on inputs of shape "
                             f"{tuple(args[0].shape)} ({kw})")
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(_outputs(got), _outputs(want)))


def check_boundary_kernels():
    """Every conformance case of ``lif_encode`` (in both compute types,
    with and without the decode epilogue; the vector layout's edges also
    on bf16 activations), ``pack4``, ``pack4_counts`` (f32 and bf16
    counts, T = 7 and 15), ``unpack4`` and ``unpack4_decode`` (f32 and
    bf16 results, T = 7 and 1, log-scales of 0 and seeded ones, and
    unaligned views), and random inputs at the serve shapes, kernel ==
    plain on the card.  Returns ({kernel: largest abs difference},
    {entry point: launches checked})."""
    from repro_torch.kernels.cases import (LIF_CASES, LIF_MOE_PREFILL_CASES,
                                           LIF_TAIL_CASES,
                                           PACK4_CASES, PACK4_TAIL_CASES,
                                           UNPACK4_LOG_SCALES, lif_tensors,
                                           pack4_case, pack4_counts_case,
                                           unpack4_log_scale)
    err = dict.fromkeys(BOUNDARY_KERNELS, 0.0)
    n = collections.Counter()
    bf = torch.bfloat16

    def check(entry, *args, **kw):
        kernel = _boundary_fns()[entry][0]
        err[kernel] = max(err[kernel], check_exact(entry, *args, **kw))
        n[entry] += 1

    def check_lif(x, theta, scale, T):
        # the decode factor as the codec computes it, in x's dtype
        ds = (scale.to(x.dtype) / T).float()
        for md in (torch.float32, bf):
            check("lif_encode", x, theta, scale, T=T, math_dtype=md)
            check("lif_encode", x, theta, scale, T=T, math_dtype=md,
                  decode_scale=ds)

    for name in LIF_CASES + LIF_TAIL_CASES + LIF_MOE_PREFILL_CASES:
        x, theta, scale, T = lif_tensors(name, "cuda")
        check_lif(x, theta, scale, T)
        if name in LIF_TAIL_CASES:
            check_lif(x.to(bf), theta, scale, T)
    def check_unpack4_decode(packed, log_scale, Ts=(7, 1)):
        # the decode factor as the codec computes it, in each dtype
        for dt in (torch.float32, bf):
            scale = torch.exp(log_scale).to(dt)
            for T in Ts:
                check("unpack4_decode", packed, T, scale / T)

    for name in PACK4_CASES + PACK4_TAIL_CASES:
        v = torch.tensor(pack4_case(name), device="cuda")
        check("pack4", v)
        check("unpack4", v)
        for kind in UNPACK4_LOG_SCALES:
            check_unpack4_decode(v, torch.tensor(
                unpack4_log_scale(kind, 2 * v.shape[1]), device="cuda"))
        for T in (7, 15):
            c = torch.tensor(pack4_counts_case(name, T), device="cuda")
            for dt in (torch.float32, bf):
                check("pack4_counts", c.to(dt), T)
    # packed bytes 1 byte and decode factors 1 element into their
    # buffers: the scalar paths of a width the vector layout takes
    v = torch.tensor(pack4_case("tail_m257_c8"), device="cuda")
    buf = torch.empty(v.numel() + 1, dtype=torch.uint8, device="cuda")
    view = buf[1:].view(v.shape)
    view.copy_(v)
    check("unpack4", view)
    for dt in (torch.float32, bf):
        ds = torch.exp(torch.tensor(unpack4_log_scale("seeded", 16),
                                    device="cuda")).to(dt) / 7
        dbuf = torch.empty(17, dtype=dt, device="cuda")
        dbuf[1:].copy_(ds)
        for packed, d in ((view, ds), (v, dbuf[1:]), (view, dbuf[1:])):
            check("unpack4_decode", packed, 7, d)
    rng = np.random.RandomState(11)
    for M in (4, 120, 256):
        C = 1024
        t = lambda a: torch.tensor(a, device="cuda")  # noqa: E731
        x = t(rng.standard_normal((M, C)).astype(np.float32))
        theta = t(rng.uniform(0.0, 0.3, C).astype(np.float32))
        scale = t(np.exp(rng.uniform(-1.0, 1.0, C)).astype(np.float32))
        for T in (15, 7):
            check_lif(x, theta, scale, T)
            # bf16 activations, thresholds and scales, as the bf16 codec
            # hands them over (theta and scale as float32 values)
            check_lif(x.to(bf), theta.to(bf).float(), scale.to(bf).float(),
                      T)
        check("pack4", t(rng.randint(0, 15, (M, C)).astype(np.uint8)))
        packed = t(rng.randint(0, 256, (M, C // 2)).astype(np.uint8))
        check("unpack4", packed)
        check_unpack4_decode(packed, t(rng.uniform(-1.0, 1.0, C)
                                       .astype(np.float32)), Ts=(7,))
        counts = t(rng.randint(-7, 8, (M, C)).astype(np.float32))
        for dt in (torch.float32, bf):
            check("pack4_counts", counts.to(dt), 7)
    return err, n


def time_boundary_kernels(runs, errs, flush):
    """Time the launch floor (a one-element ``zero_()``) and the boundary
    kernels on the live inputs of their codec's checked run (``runs``:
    codec -> ``serve_codec`` result), at each shape the path gave them.
    Returns their entries of the ``kernels`` line, each timed shape
    under ``by_shape``."""
    one = torch.zeros(1, device="cuda")
    floor_ms = cuda_ms(lambda: one.zero_(), flush)
    print(f"launch floor: a one-element zero_() takes {floor_ms:.5f} ms",
          flush=True)
    print(json.dumps({"launch_floor_ms": floor_ms}), flush=True)
    timed = {name: [] for name in BOUNDARY_KERNELS}

    def time_entry(entry, args, kw, yardstick=None, **tags):
        """Time one entry point; ``yardstick``, a call that computes the
        same function in several launches, is timed beside it."""
        k_ms, p_ms, b_ms, b_by = time_boundary(entry, args, kw, flush)
        row = {"shape": list(args[0].shape), "entry": entry, **tags,
               "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
               "bound_by": b_by, "over_floor_ms": k_ms - floor_ms}
        more = ""
        if yardstick is not None:
            row["unfused_ms"] = cuda_ms(yardstick, flush)
            more = f", unfused {row['unfused_ms']:.5f} ms"
        timed[_boundary_fns()[entry][0]].append(row)
        print(f"{entry} at {row['shape']} {tags}: kernel {k_ms:.5f} ms "
              f"({k_ms - floor_ms:+.5f} over the floor), plain {p_ms:.5f} "
              f"ms, bound {b_ms:.6f} ms ({b_by}){more}", flush=True)

    def live(chk, entry, n_shapes, epilogue=False):
        """The live samples of one entry point, decode rows first."""
        keys = sorted((k for k in chk.samples
                       if k[0] == entry and k[2] == epilogue),
                      key=lambda k: k[1])
        if len(keys) != n_shapes:
            raise AssertionError(f"{entry} (epilogue {epilogue}): live "
                                 f"shapes {[k[1] for k in keys]}, expected "
                                 f"{n_shapes}")
        return [chk.samples[k] for k in keys]

    # lif_encode in both compute modes: the decode rows with the epilogue
    # (wire roundtrips) and without (coded psums), the prefill rows
    # without (gathers and reduce-scatters) and, on the same inputs, with
    for mode, run in (("float32", "spike"), ("bfloat16", "spike/bf16")):
        chk = runs[run][1]
        (dec_args, dec_kw), = live(chk, "lif_encode", 1, epilogue=True)
        plain_samples = live(chk, "lif_encode", 2)
        if plain_samples[0][0][0].shape != dec_args[0].shape:
            raise AssertionError("lif_encode: the epilogue ran at another "
                                 "row count than the decode's psums")
        for args, kw in plain_samples:
            time_entry("lif_encode", args, kw, math_dtype=mode,
                       epilogue=False)
            time_entry("lif_encode", args,
                       {**kw, "decode_scale": dec_kw["decode_scale"]},
                       math_dtype=mode, epilogue=True)
    # the packs: today's uint8 entry on the biased wire of the live
    # counts (built here, outside the clock), and the fused bias; unpack
    chk = runs["spike_pack4"][1]
    for args, kw in live(chk, "pack4_counts", 2):
        wire = (args[0] + args[1]).to(torch.uint8)
        time_entry("pack4", [wire], {})
        time_entry("pack4_counts", args, kw)
    # the unpacks: the uint8 entry on the live packed bytes, and the
    # fused decode in f32 (the live call) and in bf16 (the live factor
    # rounded to bf16), each beside the four launches it replaces (the
    # uint8 unpack, the cast, the unbias and the multiply)
    from repro_torch.kernels import pack4 as PK
    for (packed, T, ds), kw in live(chk, "unpack4_decode", 2):
        time_entry("unpack4", [packed], {})
        for dt in (torch.float32, torch.bfloat16):
            d = ds.to(dt)
            time_entry("unpack4_decode", [packed, T, d], kw,
                       yardstick=lambda p=packed, T=T, d=d: (
                           PK.unpack4_cuda(p).to(d.dtype) - T) * d,
                       dtype=str(dt)[6:])
    home = {"lif_encode": "spike", "pack4": "spike_pack4",
            "unpack4": "spike_pack4"}
    # the headline numbers are those of the served call at the decode
    # rows: the served path packs only through ``pack4_counts`` and
    # unpacks only through ``unpack4_decode`` (f32 here)
    served = {"lif_encode": "lif_encode", "pack4": "pack4_counts",
              "unpack4": "unpack4_decode"}
    out = []
    for name in BOUNDARY_KERNELS:
        first = next(r for r in timed[name] if r["entry"] == served[name])
        out.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": runs[home[name]][0][name],
            "max_abs_err": errs[name],
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")},
            "library_ms": None, "shape": first["shape"],
            "by_shape": timed[name]})
    return out


def time_config_row(rows, flush, config, entry, args, kw, launches):
    """Time one boundary entry point on ``args`` for ``config`` and add
    its row (with its launches on the served path) to ``rows[kernel]``."""
    k_ms, p_ms, b_ms, b_by = time_boundary(entry, args, kw, flush)
    kernel = _boundary_fns()[entry][0]
    row = {"config": config, "shape": list(args[0].shape), "entry": entry,
           "epilogue": kw.get("decode_scale") is not None,
           "launches": launches, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    rows[kernel].append(row)
    print(f"{entry} at {row['shape']} ({config}, epilogue "
          f"{row['epilogue']}): kernel {k_ms:.5f} ms, plain {p_ms:.5f} "
          f"ms, bound {b_ms:.6f} ms ({b_by}), launches {launches}",
          flush=True)


def time_moe_boundaries(moe_runs, flush):
    """The boundary kernels at the MoE family's widths, 2048 (qwen2-moe:
    ``lif_encode`` on the live inputs of its ``spike`` checked run,
    decode and prefill rows, with its launches there) and 5120 (llama4),
    and the packs at both: where no served run launches a kernel (the
    ``spike_pack4`` run was cut for time, llama4's codecs launch none)
    the conformance cases ``moe_m*_c*`` stand in, at 0 launches.
    Returns {kernel name: rows for its ``by_shape``}."""
    from repro_torch.kernels.cases import (lif_tensors, pack4_case,
                                           pack4_counts_case,
                                           unpack4_log_scale)
    rows = {name: [] for name in BOUNDARY_KERNELS}

    def add(*a):
        time_config_row(rows, flush, *a)

    chk = moe_runs["spike"][1]
    for key, (args, kw) in sorted(chk.samples.items(), key=str):
        if key[0] == "lif_encode":
            add(QWEN2MOE, key[0], args, kw, chk.by_shape[key[:2]])
    for name in ("moe_m4_c5120", "moe_m256_c5120"):
        x, theta, scale, T = lif_tensors(name, "cuda")
        add(LLAMA4, "lif_encode", [x, theta, scale], {"T": T}, 0)
        add(LLAMA4, "lif_encode", [x, theta, scale],
            {"T": T, "decode_scale": (scale / T).float()}, 0)
    for config, C in ((QWEN2MOE, 2048), (LLAMA4, 5120)):
        counts = torch.tensor(pack4_counts_case(f"moe_m4_c{C}", 7),
                              device="cuda")
        add(config, "pack4_counts", [counts, 7], {}, 0)
        packed = torch.tensor(pack4_case(f"moe_m4_c{C // 2}"),
                              device="cuda")
        ds = torch.exp(torch.tensor(unpack4_log_scale("seeded", C),
                                    device="cuda")) / 7
        add(config, "unpack4_decode", [packed, 7, ds], {}, 0)
    return rows


def check_count_matmul():
    """The count matmul's conformance sweep on the card: every shape of
    ``COUNT_MATMUL_SHAPES`` and ``COUNT_MATMUL_RAGGED_SHAPES`` at T = 7
    and 15, float32 and bf16 weights, float32 and bf16 results, each
    launch against the plain version's float32 sum by
    ``count_matmul_agrees``.  Returns (largest abs
    difference of a float32 result, largest bf16 steps of a bf16 result
    from the rounding of the plain sum, launches)."""
    from repro_torch.kernels import count_matmul as CM
    from repro_torch.kernels.cases import (COUNT_MATMUL_RAGGED_SHAPES,
                                           COUNT_MATMUL_SHAPES,
                                           count_matmul_agrees,
                                           count_matmul_case)
    err, steps, n = 0.0, 0, 0
    for M, K, N in COUNT_MATMUL_SHAPES + COUNT_MATMUL_RAGGED_SHAPES:
        for T in (7, 15):
            c, w, sc = (torch.tensor(a, device="cuda") for a in
                        count_matmul_case(M, K, N, T, seed=M + K + N + T))
            for wt in (w, w.to(torch.bfloat16)):
                want = CM.count_matmul_plain(c, wt, sc, T=T,
                                             out_dtype=torch.float32)
                for od in (torch.float32, torch.bfloat16):
                    got = CM.count_matmul_cuda(c, wt, sc, T=T, out_dtype=od)
                    torch.cuda.synchronize()
                    ok, st = count_matmul_agrees(got, want)
                    if not ok or got.shape != (M, N) or got.dtype != od:
                        raise AssertionError(
                            f"count_matmul [{M},{K}]x[{K},{N}] T={T} "
                            f"{wt.dtype}->{od}: kernel disagrees with its "
                            "plain version")
                    if od == torch.float32:
                        err = max(err, float((got - want).abs().max()))
                    steps, n = max(steps, st), n + 1
    return err, steps, n


def count_matmul_bound(M, K, N, w_bytes, out_bytes, tensor_cores=False):
    """(bound ms, bound_by) of one count matmul: int8 counts, W, the f32
    scale and the result each moved once over the HBM rate, or its
    2 M K N operations over the f32 rate, whichever is larger.  With
    ``tensor_cores``, the bound of the kernel's design for more than 16
    rows and bf16 W instead: its 3 x 2 M K N bf16 operations (three bf16
    planes of each activation) over the dense bf16 tensor-core rate."""
    nbytes = M * K + K * N * w_bytes + 4 * K + M * N * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * 2 * M * K * N / BF16_TC_FLOP_PER_S * 1e3 if tensor_cores
             else 2 * M * K * N / F32_FLOP_PER_S * 1e3)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def time_count_matmul(args, kw, flush):
    """(kernel ms, plain ms, library ms, bound ms, bound_by, tensor-core
    bound ms or None) of one count matmul on the given (live) inputs; the
    library yardstick is ``torch.matmul`` of the decoded float32
    activations and float32 W, TF32 off (the decode is done before the
    clock starts)."""
    from repro_torch.kernels import count_matmul as CM
    counts, w, scale = args
    ms = cuda_ms(lambda: CM.count_matmul_cuda(counts, w, scale, **kw), flush)
    plain_ms = cuda_ms(lambda: CM.count_matmul_plain(counts, w, scale, **kw),
                       flush)
    a = counts.float() * (scale * CM.inv_T(kw["T"]))
    w32 = w.float()
    lib_ms = cuda_ms(lambda: torch.matmul(a, w32), flush)
    (M, K), N = counts.shape, w.shape[1]
    out_bytes = torch.empty((), dtype=kw["out_dtype"]).element_size()
    sizes = (M, K, N, w.element_size(), out_bytes)
    tc = (count_matmul_bound(*sizes, tensor_cores=True)[0]
          if M > 16 and w.dtype == torch.bfloat16 else None)
    return (ms, plain_ms, lib_ms) + count_matmul_bound(*sizes) + (tc,)


def check_repeatable(s_case):
    """Paged decode (f32 and bf16 pools, wire off and on) and
    ``count_matmul`` (bf16 W, f32 and bf16 results, the four timed
    shapes), each launched twice on the same inputs at its serve shape:
    the two results must be equal bit for bit.  Returns the launches
    compared."""
    from repro_torch.kernels import count_matmul as CM
    from repro_torch.kernels.cases import count_matmul_case
    n = paged_repeatable(s_case)
    for M in (4, 256):
        for N in (2816, 1024):
            c, w, sc = (torch.tensor(a, device="cuda") for a in
                        count_matmul_case(M, 1024, N, 15, seed=M + N))
            w = w.to(torch.bfloat16)
            for od in (torch.float32, torch.bfloat16):
                a = CM.count_matmul_cuda(c, w, sc, T=15, out_dtype=od)
                b = CM.count_matmul_cuda(c, w, sc, T=15, out_dtype=od)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(f"count_matmul [{M},1024]x[1024,"
                                         f"{N}] {od}: two launches differ")
                n += 1
    return n


def paged_repeatable(arrays, window=0, cap=0.0):
    """Paged decode launched twice on the same inputs, f32 and bf16
    pools, wire off and on: the two results must be equal bit for bit.
    Returns the launch pairs compared."""
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels.cases import to_tensors
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        ts = to_tensors(arrays, "cuda", dt)
        for wire in (False, True):
            kw = dict(window=window, cap=cap, encode_wire=wire)
            a = PD.paged_decode_cuda(*ts, **kw)
            b = PD.paged_decode_cuda(*ts, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"paged_decode {dt} wire={wire}: two "
                                     "launches differ")
            n += 1
    return n


class LaunchCheck:
    """Check every kernel launch of a kernel-walk engine run against the
    plain version on the same (live) inputs.  Paged decode: o and lse,
    or the wire scale and lse, within float rounding, and the int8 wire
    within one step.  Boundary kernels, every entry point: every output
    exactly equal (``lif_encode``'s decoded values too).  Count matmul:
    by ``count_matmul_agrees`` against the plain version's float32 sum.
    Keeps the first live inputs of each entry point at each shape, with
    and without the decode epilogue (for timing)."""

    def __init__(self):
        self.launches = collections.Counter()
        self.entries = collections.Counter()     # by entry point
        #: boundary-kernel launches by (entry point, input shape)
        self.by_shape = collections.Counter()
        self.flipped = 0         # wire values one step from the plain one
        # (entry point, input shape, epilogue) or ("count_matmul",
        # (M, K, N)) -> (args, kw) of the first such live launch
        self.samples = {}
        self.epilogues = 0       # lif_encode launches with the epilogue
        self.cm_off = 0          # bf16 count-matmul outputs off bf16(plain)
        self.cm_outputs = 0
        self.cm_steps = 0        # most bf16 steps where the tolerance is
        #                          finer than half a step
        self.k1 = collections.Counter()   # paged decode launches by K1
        #: windowed paged-decode launches, and the live list entries
        #: (summed over them) whose keys all lie outside the window of
        #: every query of their slot: pages the window drops
        self.windowed = 0
        self.window_dropped = 0

    def patches(self):
        from repro_torch.kernels import count_matmul as CM
        from repro_torch.kernels import paged_decode as PD
        out = [_Patch(PD, "paged_decode_cuda", self._paged),
               _Patch(CM, "count_matmul_cuda", self._count_matmul)]
        for entry, (kernel, module, attr, plain) in _boundary_fns().items():
            out.append(_Patch(module, attr, self._exact(entry, kernel,
                                                        plain)))
        return out

    def _count_matmul(self, orig, counts, w, scale, **kw):
        from repro_torch.kernels.cases import count_matmul_agrees
        from repro_torch.kernels.count_matmul import count_matmul_plain
        out = orig(counts, w, scale, **kw)
        want = count_matmul_plain(counts, w, scale, T=kw["T"],
                                  out_dtype=torch.float32)
        ok, steps = count_matmul_agrees(out, want)
        if not ok:
            raise AssertionError("count_matmul: a live launch disagrees "
                                 "with the plain version")
        self.launches["count_matmul"] += 1
        if out.dtype == torch.bfloat16:
            self.cm_off += int((out != want.to(out.dtype)).sum())
            self.cm_outputs += out.numel()
            self.cm_steps = max(self.cm_steps, steps)
        key = ("count_matmul", tuple(counts.shape) + (w.shape[1],))
        if key not in self.samples:
            self.samples[key] = ([counts.clone(), w.clone(), scale.clone()],
                                 kw)
        return out

    def _exact(self, entry, kernel, plain):
        def launch(orig, *args, **kw):
            out = orig(*args, **kw)
            if not same_bits(out, plain(*args, **kw)):
                raise AssertionError(f"{entry}: a live launch differs from "
                                     "the plain version")
            self.launches[kernel] += 1
            self.entries[entry] += 1
            self.by_shape[entry, tuple(args[0].shape)] += 1
            epilogue = kw.get("decode_scale") is not None
            self.epilogues += epilogue
            key = (entry, tuple(args[0].shape), epilogue)
            if key not in self.samples:
                clone = lambda a: a.clone() if torch.is_tensor(a) else a  # noqa: E731
                self.samples[key] = ([clone(a) for a in args],
                                     {k: clone(v) for k, v in kw.items()})
            return out
        return launch

    def _paged(self, orig, *args, **kw):
        from repro_torch.kernels.paged_decode import paged_decode_plain
        out = orig(*args, **kw)
        plain = paged_decode_plain(*args, **kw)
        self.launches["paged_decode"] += 1
        self.k1[args[0].shape[1]] += 1
        if kw.get("window"):
            _, kp, _, clp, clo, qpos = args
            last = clo + kp.shape[1] - 1                     # [B, ppc]
            early = qpos.min(1).values[:, None] - last >= kw["window"]
            self.windowed += 1
            self.window_dropped += int(((clp >= 0) & early).sum())
        if kw.get("encode_wire"):
            (w, s, lse), (pw, ps, plse) = out, plain
            torch.testing.assert_close(s, ps, rtol=1e-5, atol=0.0)
            steps = (w.int() - pw.int()).abs()
            if int(steps.max()) > 1:
                raise AssertionError("kernel wire more than one step off")
            self.flipped += int((steps > 0).sum())
        else:
            (o, lse), (po, plse) = out, plain
            torch.testing.assert_close(o, po, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
        return out


class WireTrace:
    """Record every coded value the decode or verify steps of one engine
    run put on a wire: the spike counts of each boundary encode with the
    values they were rounded from, and the int8 attention partial with
    its scale; and every MoE block's routing decisions: the experts a
    row chose with the router probabilities they were chosen from
    ("routing"), and the assignments the capacity rule kept with every
    row's choices of that step ("capacity").  Each row is keyed by the token it produces: (rid, token
    index, site), where the site counts the step's wire events in order
    (the same order at K1 = 1 and at K1 > 1).  A verify step's row j of
    a slot with n committed tokens produces token n + j if the j drafts
    before it are committed tokens; each row keeps those drafts, so that
    ``rows`` can drop the others once the streams are known.
    ``schedule`` lists every event's (wire kind, slot progress) in
    order, so two runs can be held to one schedule.  A prefill's values
    are kept apart (``prefill_rows``): per admission, keyed by (rid,
    committed tokens it re-prefilled, position), then by site, with its
    attention output ("attention f32", no wire: a prefill attends
    without the decode's int8 partial) where a decode step has its
    attention wire."""

    def __init__(self, prefill=True):
        self.eng = None
        self._step = None
        #: trace the prefills too (False: decode and verify steps only —
        #: a long prompt's rows would hold gigabytes on the card)
        self.prefill = prefill
        self.schedule = []
        self._rows = {}          # (rid, t, site) -> (kind, pre, wire, drafts)
        #: (rid, prior, position) -> {site: (kind, pre, wire)}
        self.prefill_rows = collections.defaultdict(dict)

    def patches(self):
        from repro_torch.core import boundary, spike
        from repro_torch.models import blocks_moe, common
        from repro_torch.models import model as M
        return [_Patch(M, "forward_decode", self._forward),
                _Patch(M, "forward_verify", self._forward),
                _Patch(self.eng, "_admit", self._admit),
                _Patch(spike, "encode", self._encode),
                _Patch(spike, "encode_decode", self._encode_decode),
                _Patch(boundary, "coded_combine_partials", self._combine),
                _Patch(common, "flash_attention", self._attend),
                _Patch(blocks_moe, "_route", self._route),
                _Patch(blocks_moe, "_dispatch_slots", self._slots)]

    def _admit(self, orig, entry):
        req, prior, _, prompt = self.eng._entry_parts(entry)
        self._step = ({"prefill": (req.rid, len(prior), len(prompt)),
                       "site": 0} if self.prefill else None)
        try:
            return orig(entry)
        finally:
            self._step = None

    def _forward(self, orig, params, cache, tokens, *a, **kw):
        feed = tokens.reshape(tokens.shape[0], -1).cpu().numpy()
        self._step = {"prog": self.eng.slot_progress(), "feed": feed,
                      "site": 0}
        try:
            return orig(params, cache, tokens, *a, **kw)
        finally:
            self._step = None

    def _record(self, kind, pre, wire):
        step = self._step
        if step is None:
            return
        if pre.dim() == 2:          # a recurrent block's decode row [B, C]
            pre, wire = pre[:, None], wire[:, None]
        site = step["site"]
        step["site"] += 1
        if "prefill" in step:       # [1, prefill_len, C]
            rid, prior, n = step["prefill"]
            for j in range(n):
                self.prefill_rows[rid, prior, j][site] = (
                    kind, pre[0, j], None if wire is None else wire[0, j])
            return
        self.schedule.append((kind, step["prog"]))
        for b, prog in enumerate(step["prog"]):
            if prog is None:
                continue
            rid, n = prog
            for j in range(pre.shape[1]):
                self._rows[rid, n + j, site] = (
                    kind, pre[b, j], wire[b, j],
                    step["feed"][b, 1:j + 1].tolist())

    def _encode(self, orig, x, params, cfg):
        counts = orig(x, params, cfg)
        self._record("spike counts", x.detach().float().clone(),
                     counts.detach().to(torch.int8))
        return counts

    def _encode_decode(self, orig, x, params, cfg):
        # one event, unless it ran (and so reported) ``encode`` itself
        site = None if self._step is None else self._step["site"]
        counts, dec = orig(x, params, cfg)
        if self._step is not None and self._step["site"] == site:
            self._record("spike counts", x.detach().float().clone(),
                         counts.detach().to(torch.int8))
        return counts, dec

    def _combine(self, orig, wire, scale, lse, *a, **kw):
        self._record("attention wire", (wire.float() * scale).detach(),
                     wire.detach().clone())
        return orig(wire, scale, lse, *a, **kw)

    def _route(self, orig, cfg, d, h, wr):
        # a MoE block's router: its probabilities, and the experts chosen
        gates, idx, probs = orig(cfg, d, h, wr)
        B, S = h.shape[:2]
        self._record("routing", probs.detach().view(B, S, -1).clone(),
                     idx.view(B, S, -1).clone())
        return gates, idx, probs

    def _slots(self, orig, idx, E, C):
        # the capacity rule: each row's kept assignments, beside the
        # experts every row of the step chose (dead slots' among them),
        # which decide them
        keep, row = orig(idx, E, C)
        if self._step is not None:
            T, k = idx.shape
            B = 1 if "prefill" in self._step else len(self._step["feed"])
            every = idx.reshape(1, 1, T * k).clone().expand(B, T // B,
                                                            T * k)
            self._record("capacity", every,
                         keep.view(B, T // B, k).to(torch.int8))
        return keep, row

    def _attend(self, orig, *a, **kw):
        out = orig(*a, **kw)
        if self._step is not None and "prefill" in self._step:
            self._record("attention f32", out.detach().float().clone(), None)
        return out

    def rows(self, streams):
        """(rid, token index) -> {site: (kind, rounded-from, wire)} of the
        rows that produced a token of ``streams``."""
        out = collections.defaultdict(dict)
        for (rid, t, site), (kind, pre, wire, drafts) in self._rows.items():
            s = streams[rid]
            if t < len(s) and drafts == s[t - len(drafts):t]:
                out[rid, t][site] = (kind, pre, wire)
        return out


def rounding_splits(tr_a, tr_b, a, b, noise=1e-4, kinds=None):
    """Per request, the first token whose producing row put a different
    coded value on any wire in the run traced by ``tr_a`` (streams
    ``a``) and the one traced by ``tr_b`` (streams ``b``), among the
    tokens both runs produced from the same stream so far.  Raises
    unless each such first difference is a rounding split: the values
    rounded from agree to float noise (spike counts: within ``noise`` of
    the row's magnitude — 1e-4 in float32, one bf16 ulp of the row's
    largest value, 2**-7 of it, in bfloat16) or one int8 step (attention
    partial); a routing split: a MoE router chose other experts from
    probabilities that agree to ``ROUTE_NOISE`` times that noise, where
    its k-th and (k+1)-th probabilities lie within float noise of each
    other (1e-6 of the k-th, or twice the runs' difference if that is
    larger); or a
    capacity split: the row's routing agreed but the capacity rule kept
    other assignments, because another row of the step (another
    request's, whose own first difference is checked in its turn, or a
    dead slot's) chose other experts; or if a token both runs produced
    from one stream has no traced row.  Returns (rid -> token index,
    wire kind -> [requests split there first, largest relative gap seen
    at those splits]); ``kinds``, if given, gets each split request's
    kind."""
    rows_a, rows_b = tr_a.rows(a), tr_b.rows(b)
    cut, splits = {}, {}
    for rid in sorted(b):
        for t in range(1, min(len(a[rid]), len(b[rid]))):
            if a[rid][t - 1] != b[rid][t - 1]:
                break                   # the rows were fed different tokens
            ra, rb = rows_a.get((rid, t)), rows_b.get((rid, t))
            if ra is None or rb is None or ra.keys() != rb.keys():
                raise AssertionError(f"request {rid} token {t}: the runs "
                                     "traced different rows")
            diff = [k for k in sorted(ra)
                    if not torch.equal(ra[k][2], rb[k][2])]
            if not diff:
                continue
            kind, pre_a, wire_a = ra[diff[0]]
            pre_b = rb[diff[0]][1]
            if kind == "capacity":
                if torch.equal(pre_a, pre_b):
                    raise AssertionError(
                        f"request {rid} token {t}: the capacity rule kept "
                        "other assignments of equal routing")
                gap = 0.0
            else:
                gap = float((pre_a - pre_b).abs().max()
                            / pre_b.abs().max().clamp(min=1e-30))
                limit = {"attention wire": 1.0 / 127 + 1e-5,
                         "routing": ROUTE_NOISE * noise}.get(kind, noise)
                if gap > limit:
                    raise AssertionError(
                        f"request {rid} token {t}: {kind} differ with "
                        f"values {gap:.3g} apart — not a rounding split")
            if kind == "routing":
                tie = route_tie(pre_a, pre_b, wire_a.shape[-1])
                if tie > max(ROUTE_TIE, 2 * gap):
                    raise AssertionError(
                        f"request {rid} token {t}: the router chose other "
                        f"experts at a top-k margin of {tie:.3g} of the "
                        "k-th probability — not a routing split")
            cut[rid] = t
            if kinds is not None:
                kinds[rid] = kind
            n, worst = splits.get(kind, (0, 0.0))
            splits[kind] = [n + 1, max(worst, gap)]
            break
    return cut, splits


#: a routing split's largest top-k margin, relative to the k-th
#: probability: float noise
ROUTE_TIE = 1e-6
#: how far, in units of the spike counts' noise, two runs' router
#: probabilities may lie apart at a routing split: a router carries its
#: input's rounding through a d_model-long product and the softmax (in
#: bf16, one ulp of a few of llama4's 5120 inputs moved a probability by
#: 0.008 of the row's largest, just over one ulp)
ROUTE_NOISE = 4


def route_tie(pa, pb, k):
    """The smaller of two runs' margins between a row's k-th and
    (k+1)-th router probabilities, relative to the k-th."""
    out = []
    for p in (pa, pb):
        top = torch.sort(p.double(), descending=True).values
        out.append(float((top[k - 1] - top[k]) / top[k - 1]))
    return min(out)


def _first_split(rid, pairs, noise):
    """The first (where, kind, relative gap of the values) of ``pairs``
    [(where, rows_a, rows_b)], rows {site: (kind, rounded-from, wire)}
    paired in site order, whose wires differ; raises unless that is a
    rounding split (the limits of ``rounding_splits``).  A decode row's
    int8 attention wire paired with a prefill row's attention output
    must agree to half an int8 step of each head (the decode's rounding,
    with 1% for float noise), and a spike count right after it may then
    differ at any gap: its input carries that rounding, which the
    prefill's does not.  None when every wire is equal."""
    for where, ra, rb in pairs:
        if not ra or len(ra) != len(rb):
            raise AssertionError(f"faults: request {rid} {where}: the runs "
                                 "traced different rows")
        after_int8 = False
        for (_, (kind, pre_a, wa)), (_, (kind_b, pre_b, wb)) in zip(
                sorted(ra.items()), sorted(rb.items())):
            if (kind, kind_b) == ("attention wire", "attention f32"):
                half = pre_a.abs().amax(-1, keepdim=True) / 254
                dev = float(((pre_b - pre_a).abs()
                             / half.clamp(min=1e-30)).max())
                if dev > 1.01:
                    raise AssertionError(
                        f"faults: request {rid} {where}: the attention "
                        f"output is {dev:.3g} half int8 steps from the "
                        "decode's attention wire")
                after_int8 = True
                continue
            if kind != kind_b:
                raise AssertionError(f"faults: request {rid} {where}: {kind} "
                                     f"paired with {kind_b}")
            if torch.equal(pre_a if wa is None else wa,
                           pre_b if wb is None else wb):
                after_int8 = False
                continue
            gap = float((pre_a - pre_b).abs().max()
                        / pre_b.abs().max().clamp(min=1e-30))
            if after_int8 and kind == "spike counts":
                return where, "spike counts after the int8 attention", gap
            limit = 1.0 / 127 + 1e-5 if kind == "attention wire" else noise
            if gap > limit:
                raise AssertionError(f"faults: request {rid} {where}: {kind} "
                                     f"differ with values {gap:.3g} apart — "
                                     "not a rounding split")
            return where, kind, gap
    return None


def resume_splits(tr_a, tr_b, a, b, points, prompt_len, margins_a,
                  noise=1e-4):
    """Where each request of ``points`` (rid -> the stream indices at
    which the run traced by ``tr_b`` re-admitted it with its committed
    tokens as part of the prompt) first parts from the fault-free run
    traced by ``tr_a``, and why.  Walked in causal order: the decode
    rows of each token (``WireTrace.rows``) and, at a resume point r,
    the re-admission's prefill: its prompt positions against the
    fault-free prefill's, its positions of the r committed tokens
    against the fault-free decode rows that produced those tokens (per
    layer the same four spike boundaries and the attention between the
    first two, in the same order; ``_first_split`` says how a prefill's
    attention output is held to a decode's int8 wire).  Before the first
    resume point every wire value must be bit-equal.  The first
    difference must be a rounding split (``rounding_splits``'s limits),
    or a token that parts with no wire split before it at a fault-free
    margin of at most MARGIN.  Returns rid -> [token index, where
    ("token t" or "re-prefill position p"), "spike counts" |
    "attention wire" | "margin", the values' relative gap or the
    margin]."""
    rows_a, rows_b = tr_a.rows(a), tr_b.rows(b)
    out = {}
    for rid, pts in points.items():
        sa, sb, P = a[rid], b[rid], prompt_len[rid]
        n = min(len(sa), len(sb))
        for t in range(1, n + 1):
            if sa[t - 1] != sb[t - 1]:
                d = t - 1
                if d < pts[0]:
                    raise AssertionError(f"faults: request {rid} parts at "
                                         f"token {d}, before its resume "
                                         f"point {pts[0]}")
                if margins_a[rid][d] > MARGIN:
                    raise AssertionError(
                        f"faults: request {rid} token {d}: {sb[d]} != "
                        f"{sa[d]} at margin {margins_a[rid][d]:.3g} with no "
                        "wire split before it")
                out[rid] = [d, f"token {d}", "margin", margins_a[rid][d]]
                break
            if t == n:
                continue
            if t in pts:            # token t came from a re-prefill
                pre_b = tr_b.prefill_rows
                pairs = [(f"re-prefill position {j}",
                          tr_a.prefill_rows[rid, 0, j], pre_b[rid, t, j])
                         for j in range(P)]
                pairs += [(f"re-prefill position {P + i - 1}",
                           rows_a.get((rid, i), {}), pre_b[rid, t, P + i - 1])
                          for i in range(1, t + 1)]
            else:
                ra, rb = rows_a.get((rid, t), {}), rows_b.get((rid, t), {})
                if ra.keys() != rb.keys():
                    raise AssertionError(f"faults: request {rid} token {t}: "
                                         "the runs traced different rows")
                pairs = [(f"token {t}", ra, rb)]
            split = _first_split(rid, pairs, noise)
            if split is None:
                continue
            if t < pts[0]:
                raise AssertionError(f"faults: request {rid} {split[0]}: a "
                                     "wire value differs before the resume "
                                     f"point {pts[0]}")
            out[rid] = [t, *split]
            break
        else:
            raise AssertionError(f"faults: request {rid} differs from the "
                                 "fault-free run, but no split was found")
    return out


class DropCount:
    """Counts, on the card and without a host sync, the assignments the
    MoE blocks' capacity rule dropped in one engine run, by the step's
    token count: the decode (or verify) steps' T = slots x K1, the
    prefills' ``prefill_len``."""

    def __init__(self):
        self.eng = None
        self.by_T = {}

    def patches(self):
        from repro_torch.models import blocks_moe
        return [_Patch(blocks_moe, "_dispatch_slots", self._slots)]

    def _slots(self, orig, idx, E, C):
        keep, row = orig(idx, E, C)
        T = idx.shape[0]
        got = self.by_T.get(T)
        n = (~keep).sum()
        self.by_T[T] = n if got is None else got + n
        return keep, row

    def summary(self, eng):
        """{"decode": dropped per decode (or verify) step, "prefill":
        dropped per prefill, summed over the MoE layers}.  A step's T is
        slots x K1; any other T is a prefill's (``prefill_len``, or a
        recurrent family's exact prompt length)."""
        by_T = {T: int(v) for T, v in self.by_T.items()}
        dec = by_T.pop(eng.ecfg.num_slots * (eng.spec_k + 1), 0)
        return {"decode": dec / max(eng.decode_steps, 1),
                "prefill": sum(by_T.values()) / max(eng.prefills, 1)}


@contextlib.contextmanager
def hooked(eng, hooks):
    """``hooks`` (``LaunchCheck``, ``WireTrace``) watch ``eng`` while
    active."""
    patches = []
    for h in hooks:
        h.eng = eng
        patches.extend(h.patches())
    for p in patches:
        p.__enter__()
    try:
        yield
    finally:
        for p in reversed(patches):
            p.__exit__(None, None, None)
        for h in hooks:
            h.eng = None         # a kept hook must not keep the engine


def serve(cfg, params, requests, kernel, device="cuda", hooks=(),
          shadow=False, temps=None, no_sync_dispatch=False, max_seq=256,
          **knobs):
    """One engine run; returns (streams, margins, engine, seconds,
    decode-only step times).  ``hooks`` (``LaunchCheck``, ``WireTrace``)
    watch the run; ``shadow`` turns the count matmul
    shadow on (``Context.count_matmul_shadow``); ``temps`` are the
    requests' temperatures (greedy without); ``no_sync_dispatch`` runs
    every dispatch under ``torch.cuda.set_sync_debug_mode("error")``, so
    that a dispatch that makes the host wait for the card raises;
    ``knobs`` are further ``EngineConfig`` fields (``spec_k``, ``top_k``,
    ``top_p``, ``seed``, ``async_depth``, ``prefill_len``); ``max_seq``
    the engine's context length (256: the main path's).  Every page and
    slot must be free, the limbo empty and every dispatched step
    committed at the end."""
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    eng = ServingEngine(cfg, params, EngineConfig(
        num_slots=4, max_seq=max_seq, page_size=16, attn_kernel=kernel,
        **knobs), device=device)
    if shadow:
        eng.ctx = eng.ctx.with_(count_matmul_shadow=True)
    if no_sync_dispatch:
        eng.dispatch = no_sync(eng.dispatch)
    for rid, (prompt, new) in enumerate(requests):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new,
                           temperature=0.0 if temps is None else temps[rid]))
    out, steps = {}, []
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (
        lambda: None)
    with hooked(eng, hooks):
        sync()
        t0 = time.perf_counter()
        while not eng.idle:
            queued = eng.queue_depth
            t = time.perf_counter()
            for req, toks in eng.step():
                out[req.rid] = toks
            if eng.queue_depth == queued:       # no admission this tick
                steps.append(time.perf_counter() - t)
        sync()
        secs = time.perf_counter() - t0
    check_drained(eng)
    return out, eng.margins, eng, secs, steps


def check_drained(eng):
    """Raise unless the engine is idle with every slot and page free,
    the limbo empty and every dispatched step committed."""
    alloc = eng.cache.allocator
    if (not eng.idle or alloc.pages_in_use or alloc.pages_in_limbo
            or alloc.num_free != alloc.num_slots
            or alloc._dispatched != alloc._committed):
        raise AssertionError(
            f"not drained after the run: {alloc.pages_in_use} pages mapped, "
            f"{alloc.pages_in_limbo} in limbo, {alloc.num_free} of "
            f"{alloc.num_slots} slots free, {alloc._dispatched} steps "
            f"dispatched and {alloc._committed} committed")


def no_sync(dispatch):
    """``dispatch`` run under ``torch.cuda.set_sync_debug_mode("error")``:
    a synchronizing call inside it (a blocking copy, ``.item()``, a
    ``nonzero``) raises instead of making the host wait."""
    def run():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def check_streams(fused, ref, ref_margins, cut=None):
    """Fused and reference streams agree token for token up to the first
    position whose reference margin is at most MARGIN, or (``cut``: rid
    -> token index) where a coded value first rounded the other way.
    Returns (tokens compared, requests cut by a rounding split, requests
    cut by a margin)."""
    cut = cut or {}
    compared, by_split, by_margin = 0, 0, 0
    for rid in sorted(ref):
        for t, (a, b) in enumerate(zip(ref[rid], fused[rid])):
            if t >= cut.get(rid, len(ref[rid])):
                by_split += 1
                break
            if ref_margins[rid][t] <= MARGIN:
                by_margin += 1
                break
            if a != b:
                raise AssertionError(
                    f"request {rid} token {t}: fused {b} != reference {a} "
                    f"at margin {ref_margins[rid][t]:.3g}")
            compared += 1
        else:
            if len(ref[rid]) != len(fused[rid]):
                raise AssertionError(f"request {rid}: stream lengths differ")
    return compared, by_split, by_margin


_ATTN = dict(enc_dec=4, enc_pre=4, rt=2, x_dec=2, x_pre=4, snn_dec=1,
             snn_pre=2, pen=2, attn=1, shadow=SHADOW_WEIGHTS)
#: what one layer of each block kind puts on the wire at world size 1:
#: boundary encodes per decode step (``enc_dec``: its wire roundtrips
#: ``rt`` and coded psums) and per prefill (``enc_pre``: its coded
#: gathers and reduce-scatters, which a train step's forward runs too),
#: coded exchanges per decode step and prefill (``x_dec`` / ``x_pre``:
#: the psums, gathers and reduce-scatters; a wire roundtrip exchanges
#: nothing), SNN roundtrips per decode step and prefill in SNN mode,
#: eq-10 penalties in training (``pen``), paged-decode launches per
#: decode step (``attn``) and the weights the count matmul shadow feeds
#: (``shadow``).  Attention then a dense MLP: 2 + 2 boundaries.  A MoE
#: FFN has no coded exchange at world size 1 (its ``sp_disp`` penalty
#: counts); RWKV's time-mix and channel-mix have two boundaries each and
#: roundtrip both outputs in an SNN prefill (its decode does not); an
#: mLSTM, sLSTM or mamba mixer has one boundary in and one out
BLOCK_WIRES = {
    "attn": _ATTN, "global": _ATTN, "local": _ATTN,
    "attn_moe": dict(_ATTN, enc_dec=2, enc_pre=2, rt=1, x_dec=1, x_pre=2,
                     shadow=3),
    "rwkv": dict(_ATTN, snn_dec=0, attn=0, shadow=0),
    "mlstm": dict(enc_dec=2, enc_pre=2, rt=1, x_dec=1, x_pre=2, snn_dec=0,
                  snn_pre=0, pen=1, attn=0, shadow=0),
}
BLOCK_WIRES["slstm"] = BLOCK_WIRES["mamba"] = BLOCK_WIRES["mlstm"]
BLOCK_WIRES["mamba_mlp"] = dict(_ATTN, snn_pre=1, attn=0, shadow=0)
BLOCK_WIRES["mamba_moe"] = dict(BLOCK_WIRES["mlstm"], snn_dec=1, snn_pre=1,
                                pen=2)


def per_model(cfg, key):
    """``BLOCK_WIRES[kind][key]`` summed over every layer of ``cfg``."""
    return cfg.n_units * sum(BLOCK_WIRES[k][key] for k in cfg.pattern)


def snn_roundtrips(eng):
    """SNN mode's extra roundtrips in one engine run: per attention
    layer, one after the MLP (or MoE) output of every decode (or verify)
    step, and two per prefill, after the attention and the MLP outputs
    (the decode and verify attention blocks take none, as in the
    reference); per RWKV layer two per prefill only (``BLOCK_WIRES``); 0
    outside SNN mode."""
    if eng.cfg.hnn_mode != "snn":
        return 0
    return (per_model(eng.cfg, "snn_dec") * eng.decode_steps
            + per_model(eng.cfg, "snn_pre") * eng.prefills)


def block_counts(cfg):
    """(layers without a MoE FFN, layers with one: ``attn_moe``,
    ``mamba_moe``) of a config."""
    moe = sum(cfg.pattern.count(k) for k in ("attn_moe", "mamba_moe"))
    return cfg.n_layers - moe * cfg.n_units, moe * cfg.n_units


def expected_launches(codec, walk, eng, shadow=False):
    """Launches of each kernel in one engine run (``BLOCK_WIRES``): paged
    decode once per attention layer and decode (or verify) step on the
    kernel walk; ``lif_encode`` at each coded boundary per decode step
    and per prefill under ``spike`` (a dense layer's 4: 2 wire
    roundtrips and 2 coded psums, 2 coded gathers and 2 coded
    reduce-scatters; a MoE layer's 2, its attention's) and at each SNN
    roundtrip in SNN mode; ``pack4`` and ``unpack4`` once per coded
    exchange under ``spike_pack4`` (``unpack4`` as ``unpack4_decode``):
    2 per dense layer and decode step (the coded psums; a wire roundtrip
    exchanges nothing) and 4 per prefill, half that a MoE layer;
    ``count_matmul`` only with the shadow on: once per consuming weight
    (5 per dense layer, 3 — wq, wk, wv — per MoE layer) per decode step
    and per prefill."""
    steps, pre, cfg = eng.decode_steps, eng.prefills, eng.cfg
    want = {"paged_decode": (per_model(cfg, "attn") * steps
                             if walk == "fused" else 0),
            "lif_encode": 0, "pack4": 0, "unpack4": 0,
            "count_matmul": (per_model(cfg, "shadow") * (steps + pre)
                             if shadow else 0),
            "roundtrip_bwd": 0, "lif_encode_bwd": 0}
    if codec == "spike":
        want["lif_encode"] = (per_model(cfg, "enc_dec") * steps
                              + per_model(cfg, "enc_pre") * pre
                              + snn_roundtrips(eng))
    if codec == "spike_pack4":
        want["pack4"] = want["unpack4"] = (per_model(cfg, "x_dec") * steps
                                           + per_model(cfg, "x_pre") * pre)
    return want


def check_fused_variants(label, codec, check, want, eng):
    """The served roundtrips took the decode epilogue, the served packs
    the fused bias, the served unpacks the fused unbias and decode:
    every wire roundtrip (2 a dense layer, 1 a MoE layer, and every SNN
    roundtrip) is a ``lif_encode`` launch with the epilogue, every pack
    a ``pack4_counts``, every unpack an ``unpack4_decode``."""
    roundtrips = (per_model(eng.cfg, "rt") * eng.decode_steps
                  + snn_roundtrips(eng))
    fused_want = {"epilogues": roundtrips if codec == "spike" else 0,
                  "pack4_counts": want["pack4"], "pack4": 0,
                  "unpack4_decode": want["unpack4"], "unpack4": 0}
    fused_got = {"epilogues": check.epilogues,
                 **{e: check.entries[e] for e in (
                     "pack4_counts", "pack4", "unpack4_decode",
                     "unpack4")}}
    if fused_got != fused_want:
        raise AssertionError(f"{label}: fused variants {fused_got}, "
                             f"expected {fused_want}")


def serve_codec(cfg, params, requests, codec, shadow=False,
                trace_prefill=True, **knobs):
    """One codec's main path: the kernel-walk run, timed, with every
    launch count set to 0 just before it and read just after; then the
    reference walk and the kernel walk again, traced at every wire, the
    kernel walk with each launch checked on its live inputs (and, with
    ``shadow``, the count matmul shadow on, its counts set to 0 just
    before and read just after).  Returns (launch counts of the timed
    run, the ``LaunchCheck``, tokens/s, median decode step ms, launch
    counts of the checked run, ``streams_digest`` of the served
    streams, (the served streams, their margins)).  ``knobs`` go to
    every ``serve`` (``max_seq``, ``prefill_len``); ``trace_prefill``
    False traces the decode steps only."""
    from repro_torch.kernels import ops
    cfg_c = cfg.replace(codec=codec)
    bf16 = cfg.dtype == torch.bfloat16
    label = (f"{arch_label(cfg)}{cfg.hnn_mode}/{codec}"
             + ("/bf16" if bf16 else ""))
    ops.reset_launch_counts()
    fused, margins, eng, secs, steps = serve(cfg_c, params, requests,
                                             "fused", **knobs)
    launches = ops.launch_counts()
    want = expected_launches(codec, "fused", eng)
    if launches != want or eng.decode_steps == 0:
        raise AssertionError(f"{label}: launches {launches}, expected {want} "
                             f"for {eng.decode_steps} decode steps and "
                             f"{eng.prefills} prefills")
    for rid, (prompt, new) in enumerate(requests):
        toks = fused[rid]
        if len(toks) != new or not all(0 <= x < cfg.vocab for x in toks):
            raise AssertionError(f"{label} request {rid}: bad stream {toks}")
    n_tok = sum(len(v) for v in fused.values())
    tok_s, step_ms = n_tok / secs, 1e3 * float(np.median(steps))
    digest = streams_digest(fused)
    print(f"serve {label} fused: {n_tok} tokens in {secs:.3f} s = "
          f"{tok_s:.1f} tok/s, {eng.decode_steps} decode steps, "
          f"{eng.prefills} prefills, median decode step {step_ms:.3f} ms, "
          f"launches {launches}, streams sha256 {digest}", flush=True)

    ops.reset_launch_counts()
    tr_r = WireTrace(trace_prefill)
    ref, ref_margins, eng_r, secs_r, steps_r = serve(
        cfg_c, params, requests, "reference", hooks=(tr_r,), **knobs)
    if ops.launch_counts() != expected_launches(codec, "reference", eng_r):
        raise AssertionError(f"{label} reference walk: launches "
                             f"{ops.launch_counts()}")
    print(f"serve {label} reference (traced): {n_tok / secs_r:.1f} "
          f"tok/s, median decode step {1e3 * np.median(steps_r):.3f} ms",
          flush=True)
    tr_f, check = WireTrace(trace_prefill), LaunchCheck()
    moe = block_counts(cfg)[1] > 0
    drops = DropCount()
    ops.reset_launch_counts()
    traced, _, eng_t, *_ = serve(cfg_c, params, requests, "fused",
                                 hooks=(tr_f, check) + ((drops,) if moe
                                                        else ()),
                                 shadow=shadow, **knobs)
    checked = ops.launch_counts()
    if traced != fused:
        raise AssertionError(f"{label}: two kernel-walk runs gave different "
                             "streams")
    want_t = expected_launches(codec, "fused", eng_t, shadow)
    if checked != want_t or {k: check.launches[k] for k in want_t} != want_t:
        raise AssertionError(f"{label}: checked run launches {checked}, "
                             f"checked {check.launches}, expected {want_t}")
    check_fused_variants(label, codec, check, want_t, eng_t)
    if tr_f.schedule != tr_r.schedule:
        raise AssertionError(f"{label}: the traced runs took different "
                             "schedules")
    kinds = {}
    cut, splits = rounding_splits(tr_f, tr_r, fused, ref,
                                  2.0**-7 if bf16 else 1e-4, kinds)
    first = ", ".join(f"{n} at {kind} (values rounded from within "
                      f"{gap:.2g} of each other)"
                      for kind, (n, gap) in sorted(splits.items()))
    compared, by_split, by_margin = check_streams(fused, ref, ref_margins,
                                                  cut)
    if moe:
        drops = drops.summary(eng_t)
        print(f"moe {label}: dropped assignments {drops}; "
              f"{agreement_rules(fused, ref, ref_margins, cut, kinds)}",
              flush=True)
    else:
        drops = None
    shadowed = (f"; count matmul shadow: {check.launches['count_matmul']} "
                f"launches checked, {check.cm_off} of {check.cm_outputs} "
                f"bf16 outputs one or more bf16 steps from the rounding of "
                f"the plain float32 sum (at most {check.cm_steps} where the "
                "tolerance is finer than half a step), served streams "
                "unchanged" if shadow else "")
    print(f"streams {label}: launches checked on live inputs "
          f"{dict(check.launches)} ({check.flipped} paged-decode wire values "
          f"one step from the plain version's, every boundary-kernel launch "
          f"exact, {check.epilogues} lif_encode launches with the decode "
          f"epilogue, {check.entries['pack4_counts']} pack4 launches with "
          f"the bias fused, {check.entries['unpack4_decode']} unpack4 "
          f"launches with the unbias and decode fused{shadowed}); fused == "
          f"reference on {compared} of "
          f"{n_tok} "
          f"tokens: {by_split} requests compared up to the first coded value "
          f"that rounded the other way [{first}], {by_margin} up to a margin "
          f"<= {MARGIN}",
          flush=True)
    return (launches, check, tok_s, step_ms, checked, digest,
            (fused, margins), drops)


def agreement_rules(fused, ref, ref_margins, cut, kinds):
    """Which rule ended each request's agreement of two walks: the token
    index and the split kind (``rounding_splits``), a margin of at most
    MARGIN, or none (agreed to the end)."""
    out = {}
    for rid in sorted(ref):
        m = next((t for t, v in enumerate(ref_margins[rid]) if v <= MARGIN),
                 None)
        c = cut.get(rid)
        if c is not None and (m is None or c <= m):
            out[rid] = f"{kinds[rid]} split at token {c}"
        elif m is not None:
            out[rid] = f"margin at token {m}"
        else:
            out[rid] = "agreed to the end"
    return f"agreement ended by: {out}"


#: draft tokens per verify step of the spec phase: K1 = SPEC_K + 1
SPEC_K = 3
#: the spec phase's codecs, each served with and without spec
SPEC_CODECS = ("none", "spike_fused", "spike", "spike_pack4")


def spec_requests():
    """The spec phase's workload: eight cyclic prompts of 16-120 tokens,
    each of period ``len // 4`` (as ``serve_bench.py --repetitive``
    builds them), 32 new tokens each; numpy seed 0."""
    rng = np.random.RandomState(0)
    lens = rng.randint(16, 121, 8)
    return [((rng.randint(0, 256, max(int(L) // 4, 1)).tolist() * int(L))
             [:int(L)], 32) for L in lens]


def serve_spec(cfg, params, requests, codec):
    """Speculative decoding with the n-gram drafter (``spec_k=3``,
    K1 = 4) beside ``spec_k=0`` on the same requests, kernel walk.  The
    spec run is timed with every launch count set to 0 just before it
    and read just after (one paged-decode launch per layer and verify
    step, the boundary kernels as in a decode step); a second spec run
    checks every launch on its live inputs (paged decode at K1 = 4, the
    boundary kernels exactly) and must serve the same streams.  The
    streams must equal the ``spec_k=0`` streams up to each request's
    first coded value that rounds the other way (both runs traced by
    ``WireTrace``; a verify step multiplies [16, 1024] rows where a
    decode step multiplies [4, 1024], and the two may round apart) or
    a ``spec_k=0`` margin of 1e-4.  A config with MoE blocks is not held
    to that rule (capacity depends on the step's token count, so a
    ``spec_k=3`` run routes at another C than a ``spec_k=0`` one): its
    agreement and both runs' dropped assignments are printed.  Returns
    a summary dict."""
    from repro_torch.kernels import ops
    cfg_c = cfg.replace(codec=codec)
    label = f"{arch_label(cfg)}{cfg.hnn_mode}/{codec}"
    coded = cfg_c.hnn_mode != "ann" and codec != "none"
    gate = block_counts(cfg)[1] == 0
    drops_v, drops_s = DropCount(), DropCount()
    van, van_margins, eng_v, secs_v, steps_v = serve(
        cfg_c, params, requests, "fused", hooks=() if gate else (drops_v,))
    ops.reset_launch_counts()
    spec, _, eng, secs, steps = serve(cfg_c, params, requests, "fused",
                                      spec_k=SPEC_K)
    launches = ops.launch_counts()
    want = expected_launches(codec, "fused", eng)
    if launches != want or eng.spec_verifies == 0:
        raise AssertionError(f"spec {label}: launches {launches}, expected "
                             f"{want} for {eng.decode_steps} verify steps "
                             f"and {eng.prefills} prefills")
    for rid, (prompt, new) in enumerate(requests):
        if len(spec[rid]) != new or not all(0 <= x < cfg.vocab
                                            for x in spec[rid]):
            raise AssertionError(f"spec {label} request {rid}: bad stream "
                                 f"{spec[rid]}")
    tr_v, tr_s, check = WireTrace(), WireTrace(), LaunchCheck()
    trace = coded and gate
    if trace:
        serve(cfg_c, params, requests, "fused", hooks=(tr_v,))
    ops.reset_launch_counts()
    traced, _, eng_t, *_ = serve(
        cfg_c, params, requests, "fused", spec_k=SPEC_K,
        hooks=((tr_s, check) if trace else (check,))
        + (() if gate else (drops_s,)))
    if traced != spec:
        raise AssertionError(f"spec {label}: two runs gave different "
                             "streams")
    want_t = expected_launches(codec, "fused", eng_t)
    if (ops.launch_counts() != want_t
            or {k: check.launches[k] for k in want_t} != want_t
            or dict(check.k1) != {SPEC_K + 1: want_t["paged_decode"]}):
        raise AssertionError(f"spec {label}: checked run launches "
                             f"{ops.launch_counts()}, checked "
                             f"{check.launches}, K1 {dict(check.k1)}, "
                             f"expected {want_t}")
    check_fused_variants(f"spec {label}", codec, check, want_t, eng_t)
    n_tok = sum(len(v) for v in spec.values())
    if not gate:
        agree = {rid: next((t for t, (x, y) in enumerate(zip(spec[rid],
                                                             van[rid]))
                            if x != y), len(spec[rid])) for rid in spec}
        moe_drops = {"spec_k=3": drops_s.summary(eng_t),
                     "spec_k=0": drops_v.summary(eng_v)}
        print(f"spec {label} (not gated): spec == spec_k=0 on "
              f"{sum(agree.values())} of {n_tok} tokens, each request up "
              f"to token {agree}; dropped assignments {moe_drops}",
              flush=True)
    cut, splits = (rounding_splits(tr_s, tr_v, spec, van) if trace
                   else ({}, {}))
    compared, by_split, by_margin = (
        check_streams(spec, van, van_margins, cut) if gate
        else (sum(agree.values()), 0, 0))
    out = {"launches": launches, "verify_steps": eng.decode_steps,
           "decode_steps_spec_k0": eng_v.decode_steps,
           "mean_accepted_len": eng.mean_accepted_len(),
           "tok_s": n_tok / secs, "tok_s_spec_k0": n_tok / secs_v,
           "median_step_ms": 1e3 * float(np.median(steps)),
           "median_step_ms_spec_k0": 1e3 * float(np.median(steps_v)),
           "tokens_compared": compared, "cut_by_split": by_split,
           "cut_by_margin": by_margin,
           "split_points": {str(r): t for r, t in sorted(cut.items())},
           "streams_sha256": streams_digest(spec)}
    if not gate:
        out.update(gated=False, agree_up_to={str(r): t for r, t in
                                             sorted(agree.items())},
                   dropped=moe_drops)
    first = ", ".join(f"{n} at {kind} (values rounded from within "
                      f"{gap:.2g} of each other)"
                      for kind, (n, gap) in sorted(splits.items()))
    print(f"spec {label}: {eng.decode_steps} verify steps (spec_k=0: "
          f"{eng_v.decode_steps} decode steps), mean accepted length "
          f"{out['mean_accepted_len']:.3f}, {out['tok_s']:.1f} tok/s "
          f"(spec_k=0: {out['tok_s_spec_k0']:.1f}), median step "
          f"{out['median_step_ms']:.3f} ms (spec_k=0: "
          f"{out['median_step_ms_spec_k0']:.3f}), launches {launches}; "
          f"checked run: {dict(check.launches)} launches checked on live "
          f"inputs, paged decode at K1 = {sorted(check.k1)}, "
          f"{check.flipped} wire values one step from the plain "
          f"version's, every boundary-kernel launch exact; spec == "
          f"spec_k=0 on {compared} of {n_tok} tokens: {by_split} requests "
          f"compared up to the first coded value that rounded the other "
          f"way [{first}] at tokens {out['split_points']}, {by_margin} up "
          f"to a margin <= {MARGIN}", flush=True)
    return out


def host_reference_probs(row, temp, top_k=0, top_p=0.0):
    """Exact next-token distribution of the reference sampler: the
    logits filtered on the host (top-k threshold, then the smallest
    top-probability nucleus with mass >= top_p), softmax at ``temp``
    (a copy of the repository's test reference, in float64)."""
    lt = np.asarray(row, np.float64) / temp
    if top_k:
        thr = np.sort(lt)[-top_k]
        lt = np.where(lt < thr, -np.inf, lt)
    if 0.0 < top_p < 1.0:
        p = np.exp(lt - lt[np.isfinite(lt)].max())
        p = p / p.sum()
        order = np.argsort(-p)
        keep = np.cumsum(p[order]) - p[order] < top_p   # minimal nucleus
        mask = np.zeros(lt.shape, bool)
        mask[order[keep]] = True
        lt = np.where(mask, lt, -np.inf)
    e = np.exp(lt - lt[np.isfinite(lt)].max())
    e[~np.isfinite(e)] = 0.0
    return e / e.sum()


def check_sampling_tv():
    """4096 draws of one row on the card, with no filter, top-k 8 and
    top-p 0.6, each within total-variation distance 0.06 of the host
    reference distribution (the CPU test's bound, row and draws).
    Returns {setting: distance}."""
    from repro_torch.serving import sampling
    V, DRAWS, TEMP = 64, 4096, 0.7
    row = np.random.RandomState(5).randn(V) * 2.0
    logits = torch.tensor(np.broadcast_to(row, (DRAWS, V)),
                          dtype=torch.float32, device="cuda")
    tv = {}
    for name, kw in (("none", {}), ("top_k=8", {"top_k": 8}),
                     ("top_p=0.6", {"top_p": 0.6})):
        gen = torch.Generator(device="cuda").manual_seed(11)
        tok = sampling.sample(logits, np.full(DRAWS, TEMP, np.float32), gen,
                              sampling.SamplingConfig(**kw)).cpu().numpy()
        emp = np.bincount(tok, minlength=V) / DRAWS
        tv[name] = float(0.5 * np.abs(emp - host_reference_probs(
            row, TEMP, **kw)).sum())
        if not tv[name] < 0.06:
            raise AssertionError(f"sampling {name}: TV distance {tv[name]}")
    return tv


def serve_sampled(cfg, params, requests, greedy, greedy_margins):
    """Temperature 0.8 with top-k 50 and top-p 0.9, requests 1 and 5
    greedy, served twice with seed 1: the two runs must give the same
    streams, and the greedy requests the greedy run's streams
    (``greedy``, ``greedy_margins``) under the margin rule.  Returns a
    summary dict."""
    temps = [0.0 if rid in (1, 5) else 0.8 for rid in range(len(requests))]
    knobs = dict(temps=temps, top_k=50, top_p=0.9, seed=1)
    a, _, eng, secs, _ = serve(cfg, params, requests, "fused", **knobs)
    b, *_ = serve(cfg, params, requests, "fused", **knobs)
    if a != b:
        raise AssertionError("sampled runs with one seed gave different "
                             "streams")
    for rid, (_, new) in enumerate(requests):
        if len(a[rid]) != new or not all(0 <= x < cfg.vocab
                                         for x in a[rid]):
            raise AssertionError(f"sampled request {rid}: bad stream")
    kept = [rid for rid, t in enumerate(temps) if t == 0]
    compared, _, by_margin = check_streams(
        {r: a[r] for r in kept}, {r: greedy[r] for r in kept},
        greedy_margins)
    differ = sum(a[r] != greedy[r] for r, t in enumerate(temps) if t > 0)
    n_tok = sum(len(v) for v in a.values())
    out = {"tok_s": n_tok / secs, "greedy_tokens_compared": compared,
           "greedy_cut_by_margin": by_margin,
           "sampled_streams_unlike_greedy": differ,
           "streams_sha256": streams_digest(a)}
    print(f"serve sampled {cfg.hnn_mode}/{cfg.codec}: {n_tok} tokens at "
          f"{out['tok_s']:.1f} tok/s, two runs of seed 1 equal, greedy "
          f"requests {kept} equal the greedy run on {compared} tokens "
          f"({by_margin} cut by a margin), {differ} of "
          f"{len(temps) - len(kept)} sampled streams differ from greedy",
          flush=True)
    return out


#: the async phase's codecs: the main path's and those whose coded
#: boundaries run the boundary kernels
ASYNC_CODECS = ("spike_fused", "spike", "spike_pack4")


def serve_async(cfg, params, requests, codec, spec_ks=(0, SPEC_K)):
    """The dispatch/commit pipeline: the main path's requests served at
    ``async_depth=1`` beside ``async_depth=0``, plainly and with
    ``spec_k=3`` (n-gram), kernel walk.  Every run is counted with the
    launch counts set to 0 just before it and read just after, and must
    launch each kernel as many times per decode (or verify) step and
    prefill as the synchronous run does (``expected_launches``); every
    dispatch of a pipelined decode run runs under ``no_sync`` (a verify
    dispatch joins the pipeline first: the n-gram drafter reads the
    committed tokens; ``spec_ks`` the spec_k of each pair).  The pipelined
    streams must equal the synchronous ones up to each request's first
    coded value that rounds the other way (both runs traced by
    ``WireTrace`` when the streams differ) or a margin of 1e-4.  Returns
    a summary dict."""
    from repro_torch.kernels import ops
    cfg_c = cfg.replace(codec=codec)
    label = f"{cfg.hnn_mode}/{codec}"
    out = {}
    for spec_k in spec_ks:
        runs = {}
        for depth in (0, 1):
            ops.reset_launch_counts()
            streams, margins, eng, secs, steps = serve(
                cfg_c, params, requests, "fused", async_depth=depth,
                spec_k=spec_k, no_sync_dispatch=depth > 0 and not spec_k)
            launches = ops.launch_counts()
            want = expected_launches(codec, "fused", eng)
            if launches != want or eng.decode_steps == 0:
                raise AssertionError(
                    f"async {label} depth {depth} spec_k {spec_k}: launches "
                    f"{launches}, expected {want} for {eng.decode_steps} "
                    f"steps and {eng.prefills} prefills")
            n_tok = sum(len(v) for v in streams.values())
            runs[depth] = {
                "streams": streams, "margins": margins,
                "tok_s": n_tok / secs,
                "median_step_ms": 1e3 * float(np.median(steps)),
                "decode_steps": eng.decode_steps, "prefills": eng.prefills,
                "launches": launches}
        sync, pipe = runs[0], runs[1]
        cut = {}
        if pipe["streams"] != sync["streams"]:
            tr0, tr1 = WireTrace(), WireTrace()
            s0 = serve(cfg_c, params, requests, "fused", spec_k=spec_k,
                       hooks=(tr0,))[0]
            s1 = serve(cfg_c, params, requests, "fused", spec_k=spec_k,
                       async_depth=1, hooks=(tr1,))[0]
            if (s0, s1) != (sync["streams"], pipe["streams"]):
                raise AssertionError(f"async {label}: traced runs changed "
                                     "their streams")
            cut = rounding_splits(tr1, tr0, s1, s0)[0]
        compared, by_split, by_margin = check_streams(
            pipe["streams"], sync["streams"], sync["margins"], cut)
        n_tok = sum(len(v) for v in sync["streams"].values())
        key = "spec" if spec_k else "decode"
        out[key] = {
            **{f"depth{d}": {k: v for k, v in r.items()
                             if k not in ("streams", "margins")}
               for d, r in runs.items()},
            "equal_streams": pipe["streams"] == sync["streams"],
            "tokens_compared": compared, "cut_by_split": by_split,
            "cut_by_margin": by_margin,
            "streams_sha256": streams_digest(pipe["streams"])}
        print(f"async {label} spec_k={spec_k}: async_depth=1 "
              f"{pipe['tok_s']:.1f} tok/s, median step "
              f"{pipe['median_step_ms']:.3f} ms, {pipe['decode_steps']} "
              f"steps; async_depth=0 {sync['tok_s']:.1f} tok/s, median step "
              f"{sync['median_step_ms']:.3f} ms, {sync['decode_steps']} "
              f"steps ({card_line()}); launches per step and prefill those "
              f"of the synchronous run ({pipe['launches']} against "
              f"{sync['launches']}); "
              + ("every pipelined dispatch free of host syncs; "
                 if not spec_k else "")
              + f"streams equal on {compared} of {n_tok} tokens "
              f"({by_split} requests compared up to a rounding split, "
              f"{by_margin} up to a margin <= {MARGIN}); no page mapped or "
              "in limbo after the run", flush=True)
    return out


class PreemptKinds:
    """Engine observer: preemptions counted by kind."""

    def __init__(self):
        self.kinds = collections.Counter()

    def on_preempt(self, rid, kind):
        self.kinds[kind] += 1


#: the faults phase's fault plan: seeded preemption, replica loss and
#: suspend, each of which strikes within the trace's first 15 ticks
FAULT_PLAN = dict(seed=0, p_preempt=0.06, p_replica_loss=0.05,
                  p_suspend=0.04, max_faults=8)


def faults_trace(cfg):
    """The faults phase's ``multitenant`` preset trace (1.5 s at 8
    requests/s, prompts of at most 120 tokens, at most 32 new, seed 0)
    in ``cfg``'s vocabulary."""
    from repro_torch.serving import preset_trace
    return preset_trace("multitenant", 1.5, seed=0, prefill_len=120,
                        max_gen=32, load=8.0, vocab=cfg.vocab)


def fault_replays(params, trace, device="cuda"):
    """(fault_free, faulted): replays of ``trace`` on the logical clock
    through an engine of 4 slots at ``async_depth=1`` on ``params``,
    each drained page- and limbo-clean.  ``fault_free(cfg, hooks)``
    returns (streams, engine); ``faulted(cfg, hooks, monitor)`` replays
    with ``FAULT_PLAN``'s injector and returns (streams, engine,
    injector, preemptions by kind, rid -> prior tokens of each
    admission, seconds)."""
    from repro_torch.serving import (EngineConfig, FaultInjector, FaultPlan,
                                     ServingEngine, replay)

    def engine(c):
        return ServingEngine(c, params, EngineConfig(
            num_slots=4, max_seq=256, page_size=16, async_depth=1),
            device=device)

    def fault_free(c, hooks=()):
        eng = engine(c)
        with hooked(eng, hooks):
            streams = replay(eng, trace)
        check_drained(eng)
        return streams, eng

    def faulted(c, hooks=(), monitor=None):
        """One replay with ``FAULT_PLAN``'s injector.  Returns (streams,
        engine, injector, preemptions by kind, rid -> prior tokens of
        each admission, seconds)."""
        eng = engine(c)
        admits = collections.defaultdict(list)
        admit = eng._admit

        def logged_admit(entry):
            req, prior = eng._entry_parts(entry)[:2]
            admits[req.rid].append(list(prior))
            return admit(entry)

        eng._admit = logged_admit
        kinds = PreemptKinds()
        eng.observers.append(kinds)
        injector = FaultInjector(FaultPlan(**FAULT_PLAN))
        observers = (injector,) if monitor is None else (monitor, injector)
        with hooked(eng, hooks):
            t0 = time.perf_counter()
            streams = replay(eng, trace, observers=observers)
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        check_drained(eng)
        return streams, eng, injector, kinds, dict(admits), secs

    return fault_free, faulted


def faults_ann(cfg, params, device="cuda", trace=None, replays=None):
    """The faulted replay under codec ``none`` (ANN mode, no wire to
    round) must serve the fault-free replay's streams exactly, with at
    least one work-preserving re-admission (a re-prefill of prompt plus
    committed tokens).  Returns a summary dict."""
    trace = trace or faults_trace(cfg)
    fault_free, faulted = replays or fault_replays(params, trace, device)
    cfg_n = cfg.replace(hnn_mode="ann", codec="none")
    ref_n = fault_free(cfg_n)[0]
    got_n, _, inj_n, _, admits_n, secs = faulted(cfg_n)
    resumes_n = sum(1 for v in admits_n.values() for p in v if p)
    parted = sorted((rid for rid in ref_n if got_n.get(rid) != ref_n[rid]),
                    key=str)
    if parted or sorted(got_n) != sorted(ref_n) or not resumes_n:
        raise AssertionError(f"faults under codec none: {len(parted)} "
                             f"streams part from the fault-free replay's "
                             f"({parted}), {resumes_n} work-preserving "
                             "re-admissions")
    return {"injected": dict(inj_n.injected), "resumes": resumes_n,
            "streams_equal_fault_free": len(ref_n),
            "tokens": sum(map(len, ref_n.values())), "seconds": secs}



def serve_faults(cfg, params, device="cuda"):
    """A ``multitenant`` preset trace (1.5 s at 8 requests/s, prompts of
    at most 120 tokens, at most 32 new, seed 0) replayed on the logical
    clock (50 ticks a trace second) through the engine at
    ``async_depth=1`` under ``spike_fused``, once fault-free and once
    with a ``FaultInjector`` (``FAULT_PLAN``) and an ``SLOMonitor`` on
    the host clock.  A preempted request restarts from scratch; a
    suspended one is re-admitted with its committed tokens as part of
    its prompt.  Each request's faulted stream must equal its fault-free
    one, except after a work-preserving re-admission: the fault-free
    replay and a second faulted one (which must serve the same streams
    and re-admissions as the first) are traced with ``WireTrace``, and
    ``resume_splits`` must find every parting at or after the first
    resume point with every wire value bit-equal before it; the tokens
    from each resume point on must also equal a fault-free serve of the
    same re-prefilled prompt (a prefill multiplies other shapes than a
    decode step, and a spike count may round apart).  Then the same
    faulted replay under codec ``none`` (ANN mode, no wire to round)
    must serve the fault-free replay's streams exactly, with at least one
    work-preserving re-admission.  Launches per step and prefill as in a
    fault-free run; every page free and the limbo empty at the end of
    every replay.  Returns a summary dict."""
    from repro_torch.kernels import ops
    from repro_torch.serving import SLOMonitor
    cfg_c = cfg.replace(codec="spike_fused")
    trace = faults_trace(cfg)
    fault_free, faulted = fault_replays(params, trace, device)
    tr_ref, tr_got = WireTrace(), WireTrace()
    ref, ref_eng = fault_free(cfg_c, [tr_ref])
    monitor = SLOMonitor()
    ops.reset_launch_counts()
    got, eng, injector, kinds, admits, secs = faulted(cfg_c, monitor=monitor)
    launches = ops.launch_counts()
    want = expected_launches("spike_fused", "fused", eng)
    if launches != want:
        raise AssertionError(f"faults: launches {launches}, expected {want}")
    if sorted(got) != sorted(ref):
        raise AssertionError("faults: the faulted replay lost requests")
    kinds_seen = dict(injector.injected)
    if not all(kinds_seen.values()):
        raise AssertionError(f"faults: not every fault kind struck "
                             f"{kinds_seen}")
    again, *_, admits_again, _ = faulted(cfg_c, [tr_got])
    if again != got or admits_again != admits:
        raise AssertionError("faults: a second faulted replay served other "
                             "streams or re-admissions than the first")
    # requests whose stream parts from the fault-free one: from their last
    # admission from scratch on, each re-admission's prior tokens are a
    # resume point
    prompts = {tr.req.rid: (list(tr.req.prompt), tr.req.max_new_tokens)
               for tr in trace.requests}
    differ, conts = {}, []
    compared = 0
    for rid in sorted(ref, key=str):
        a, b = ref[rid], got[rid]
        if a == b:
            compared += len(a)
            continue
        last = max(i for i, p in enumerate(admits[rid]) if not p)
        points = sorted({len(p) for p in admits[rid][last:] if p})
        if not points:
            raise AssertionError(f"faults: request {rid} differs with no "
                                 "work-preserving re-admission")
        differ[rid] = points
        prompt, new = prompts[rid]
        for r in points:
            conts.append((rid, r, (prompt + b[:r], new - r)))
        compared += points[0]
    splits = resume_splits(tr_ref, tr_got, ref, got, differ,
                           {r: len(p) for r, (p, _) in prompts.items()},
                           ref_eng.margins)
    if conts:
        cont = serve(cfg_c, params, [c[2] for c in conts], "fused",
                     device=device)[0]
        for k, (rid, r, _) in enumerate(conts):
            points = differ[rid] + [len(got[rid])]
            end = points[points.index(r) + 1]
            if got[rid][r:end] != cont[k][:end - r]:
                raise AssertionError(
                    f"faults: request {rid} from resume point {r} differs "
                    "from the continuation of its re-prefilled prompt")
            compared += end - r
    # no wire to round: the faulted replay serves the fault-free streams
    none = faults_ann(cfg, params, device, trace, (fault_free, faulted))
    rep = monitor.report()
    out = {"card": card_line(), "requests": len(trace), "seconds": secs,
           "decode_steps": eng.decode_steps, "prefills": eng.prefills,
           "launches": launches, "injected": kinds_seen,
           "preemptions": dict(kinds.kinds), "suspends": eng.suspends,
           "streams_equal_fault_free": len(ref) - len(differ),
           "resume_points_of_other_streams": {
               str(r): p for r, p in differ.items()},
           "splits": {str(r): s for r, s in splits.items()},
           "tokens_compared": compared,
           "none": none,
           "ttft_ms": rep["ttft_ms"], "tpot_ms": rep["tpot_ms"],
           "step_us": rep["step_us"], "slo": rep["slo"],
           "restarts": rep["requests"]["restarts"],
           "tokens_per_s": rep["tokens_per_s"],
           "peak_pages_in_limbo": rep["pool"]["peak_pages_in_limbo"]}
    print(f"faults ({card_line()}): {len(trace)} requests of the multitenant "
          f"trace at async_depth=1 in {secs:.2f} s, {eng.decode_steps} steps, "
          f"{eng.prefills} prefills; injected {kinds_seen}, preemptions "
          f"{dict(kinds.kinds)}, suspends {eng.suspends}, restarts "
          f"{out['restarts']}; {out['streams_equal_fault_free']} of "
          f"{len(ref)} streams equal the fault-free replay's, the others "
          "part at or after a resume point "
          f"({out['resume_points_of_other_streams']}) "
          f"with every wire value bit-equal before it, first at "
          f"{out['splits']} (token, why, gap), and equal the continuation "
          f"of their re-prefilled prompts after it; a second faulted replay "
          f"served the same streams; {compared} tokens compared; under "
          f"codec none (injected {none['injected']}, "
          f"{none['resumes']} work-preserving re-admissions) all "
          f"{none['streams_equal_fault_free']} streams ({none['tokens']} "
          "tokens) equal the fault-free replay's; TTFT p50/p99 "
          f"{rep['ttft_ms']['p50']:.2f}/{rep['ttft_ms']['p99']:.2f} ms, "
          f"TPOT p50/p99 {rep['tpot_ms']['p50']:.2f}/"
          f"{rep['tpot_ms']['p99']:.2f} ms, step p50/p99 "
          f"{rep['step_us']['p50'] / 1e3:.2f}/"
          f"{rep['step_us']['p99'] / 1e3:.2f} ms, attainment "
          f"{rep['slo']['attainment']:.3f}; launches {launches}; no page "
          "mapped or in limbo after any replay", flush=True)
    return out


def kernels_per_step(cfg, params, codec):
    """The device work of one decode step at a full batch, from
    ``torch.profiler``: four requests admitted and decoding, and one step
    with no admission profiled.  The profiler loses a varying number of
    the launches made in the first instants of its window (a step that
    starts there loses 1-94 of its opening launches: the staging copies,
    the KV write targets, the embedding gather, the first norm, with or
    without a warm-up step), so the step starts 0.1 s in.  Returns
    ({"kernels": CUDA kernels, "memory_ops": copies and sets}, {kernel
    name: launches}), or None when the profiler records no device
    activity.  The first dict also holds the step's summed device time
    and its wall time under the profiler (``device_ms``, ``wall_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import EngineConfig, Request, ServingEngine
    eng = ServingEngine(cfg.replace(codec=codec), params, EngineConfig(
        num_slots=4, max_seq=256, page_size=16, attn_kernel="fused"),
        device="cuda")
    rng = np.random.RandomState(5)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=rng.randint(
            0, cfg.vocab, 32).tolist(), max_new_tokens=16))
    for _ in range(3):
        eng.step()
    pre, steps = eng.prefills, eng.decode_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if (eng.prefills, eng.decode_steps, eng.num_active) != (pre, steps + 1,
                                                             4):
        raise AssertionError(f"{codec}: the profiled step was not one "
                             "decode step of four slots")
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    names = collections.Counter(e.name for e in dev)
    mem = sum(n for k, n in names.items() if k.startswith(("Memcpy",
                                                           "Memset")))
    # the step's device time (one stream: no overlap) against its wall
    # time under the profiler: the device's busy share
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return {"kernels": len(dev) - mem, "memory_ops": mem,
            "device_ms": busy, "wall_ms": wall * 1e3}, names


#: the published widths each served config must have (its config
#: file's source), so that a registry edit cannot shrink a smoke run
WIDTHS = {
    "qwen1.5-0.5b": dict(d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
                         d_ff=2816, vocab=151936),
    "gemma2-2b": dict(n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
                      d_head=256, d_ff=9216, vocab=256000, window=4096,
                      attn_softcap=50.0, final_softcap=30.0, post_norm=True,
                      tie_embeddings=True),
    "granite-20b": dict(d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
                        d_ff=24576, vocab=49152),
    "qwen2-moe-a2.7b": dict(d_model=2048, n_heads=16,
                            n_kv_heads=16, d_head=128, vocab=151936,
                            n_experts=60, top_k=4, n_shared_experts=4,
                            d_ff_expert=1408, qkv_bias=True),
    "llama4-maverick-400b-a17b": dict(
        d_model=5120, n_heads=40, n_kv_heads=8, d_head=128, d_ff=8192,
        vocab=202048, n_experts=128, top_k=1, n_shared_experts=1,
        d_ff_expert=8192, pattern=("attn", "attn_moe")),
    "rwkv-paper": dict(n_layers=6, d_model=512, n_heads=8, d_ff=2048,
                       vocab=256, pattern=("rwkv",), norm="layernorm"),
    "xlstm-125m": dict(n_layers=12, d_model=768, n_heads=4, d_ff=0,
                       vocab=50304, norm="layernorm",
                       pattern=("mlstm", "mlstm", "mlstm", "slstm")),
    "jamba-1.5-large-398b": dict(
        d_model=8192, n_heads=64, n_kv_heads=8, d_head=128, d_ff=24576,
        vocab=65536, n_experts=16, top_k=2, d_ff_expert=24576, d_state=16,
        d_conv=4, expand=2, rope_kind="none"),
}


def full_width(arch, n_layers=None, dtype=torch.float32, pattern=None):
    """A registered config at its published widths in ``dtype`` (float32
    unless given; depth cut to ``n_layers`` if given, the layer pattern
    to ``pattern``, a slice of the published one, if given) and its
    seeded weights on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params
    cfg = get_config(arch).replace(dtype=dtype)
    if pattern is not None:
        pub = cfg.pattern
        if not any(pub[i:i + len(pattern)] == pattern
                   for i in range(len(pub))):
            raise AssertionError(f"{pattern} is no slice of {arch}'s {pub}")
        cfg = cfg.replace(pattern=pattern)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    got = {k: getattr(cfg, k) for k in WIDTHS[arch]}
    if got != WIDTHS[arch]:
        raise AssertionError(f"unexpected {arch} config: {got}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")


def serve_ann(cfg, params, requests, **knobs):
    """ANN mode (codec ``none``), where nothing rounds on a wire: the
    kernel-walk run, timed, with every launch count set to 0 just before
    it and read just after (one paged-decode launch per layer and decode
    step); the kernel walk again with every paged-decode launch checked
    on its live inputs (the same streams); the reference walk, whose
    streams the kernel walk's must equal up to the margin rule.  With
    MoE blocks both are traced at their routers (``WireTrace``, decode
    steps), and a request may also part at a routing or capacity split
    (``rounding_splits``); their drops are counted.  Returns what
    ``serve_codec`` returns (the ``LaunchCheck`` of the checked run; no
    traced wire)."""
    from repro_torch.kernels import ops
    cfg_a = cfg.replace(hnn_mode="ann", codec="none")
    label = f"{arch_label(cfg)}ann/none"
    ops.reset_launch_counts()
    fused, margins, eng, secs, steps = serve(cfg_a, params, requests,
                                             "fused", **knobs)
    launches = ops.launch_counts()
    want = expected_launches("none", "fused", eng)
    if launches != want or eng.decode_steps == 0:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} for {eng.decode_steps} decode steps")
    check = LaunchCheck()
    # a MoE config's router may split the walks: trace it
    moe = block_counts(cfg)[1] > 0
    tr_f, tr_r, drops = WireTrace(False), WireTrace(False), DropCount()
    ops.reset_launch_counts()
    checked_streams, _, eng_t, *_ = serve(
        cfg_a, params, requests, "fused",
        hooks=(check,) + ((tr_f, drops) if moe else ()), **knobs)
    checked = ops.launch_counts()
    if checked_streams != fused or check.launches["paged_decode"] != want[
            "paged_decode"]:
        raise AssertionError(f"{label}: the checked run served other "
                             f"streams or checked {dict(check.launches)}")
    ref, ref_margins, *_ = serve(cfg_a, params, requests, "reference",
                                 hooks=(tr_r,) if moe else (), **knobs)
    cut, kinds = {}, {}
    if moe:
        if tr_f.schedule != tr_r.schedule:
            raise AssertionError(f"{label}: the traced runs took different "
                                 "schedules")
        bf16 = cfg.dtype == torch.bfloat16
        cut, _ = rounding_splits(tr_f, tr_r, fused, ref,
                                 2.0**-7 if bf16 else 1e-4, kinds)
        drops = drops.summary(eng_t)
        print(f"moe {label}: dropped assignments {drops}; "
              f"{agreement_rules(fused, ref, ref_margins, cut, kinds)}",
              flush=True)
    else:
        drops = None
    compared, by_split, by_margin = check_streams(fused, ref, ref_margins,
                                                  cut)
    n_tok = sum(len(v) for v in fused.values())
    tok_s, step_ms = n_tok / secs, 1e3 * float(np.median(steps))
    digest = streams_digest(fused)
    print(f"serve {label} fused: {n_tok} tokens in {secs:.3f} s = "
          f"{tok_s:.1f} tok/s, {eng.decode_steps} decode steps, "
          f"{eng.prefills} prefills, median decode step {step_ms:.3f} ms, "
          f"launches {launches}, streams sha256 {digest}; checked run: "
          f"{check.launches['paged_decode']} paged-decode launches held to "
          f"the plain version on their live inputs; fused == reference on "
          f"{compared} of {n_tok} tokens ({by_margin} requests compared up "
          f"to a margin <= {MARGIN}, {by_split} up to a routing or "
          "capacity split)", flush=True)
    return (launches, check, tok_s, step_ms, checked, digest,
            (fused, margins), drops)


#: the long-context serve: two prompts past the gemma2 window
LONG_PROMPTS, LONG_NEW = (4200, 4500), 16
LONG_KNOBS = dict(max_seq=4640, prefill_len=4608)


def serve_long(cfg, params):
    """Two requests of 4,200 and 4,500 prompt tokens and 16 new tokens
    (``prefill_len`` 4608, ``max_seq`` 4640, pages of 16) under
    ``spike_fused``, as ``serve_codec`` serves (decode steps traced, not
    the prefills): the local layers' window (4096) drops pages in the
    prefill's attention and in every decode step.  The checked run must
    make one windowed paged-decode launch per local layer and decode
    step, and those launches must skip pages wholly outside the
    window."""
    rng = np.random.RandomState(3)
    requests = [(rng.randint(0, cfg.vocab, n).tolist(), LONG_NEW)
                for n in LONG_PROMPTS]
    out = serve_codec(cfg, params, requests, "spike_fused",
                      trace_prefill=False, **LONG_KNOBS)
    check = out[1]
    local = sum(k == "local" for k in cfg.pattern) * cfg.n_units
    if check.windowed != local * check.launches["paged_decode"] // (
            cfg.n_layers) or check.window_dropped == 0:
        raise AssertionError(f"long context: {check.windowed} windowed "
                             f"launches dropped {check.window_dropped} "
                             "pages")
    print(f"long context {cfg.name}: {check.windowed} windowed paged-decode "
          f"launches checked, {check.window_dropped} live list entries "
          "wholly outside the window skipped", flush=True)
    return out


def serve_dense(cfg, params, S=256, new=9):
    """The port's ``launch.serve`` steps under codec ``none`` (ANN): a
    [2, S] prefill, its dense cache given room for the new tokens, then
    ``new - 1`` greedy decode steps at positions S, S + 1, ...; the
    greedy tokens must equal the engine's streams for the same prompts
    (``prefill_len`` S) up to the engine's margin rule.  The dense path
    runs no hand kernel (the reference's dense decode is plain array
    code), which the launch counts show.  A recurrent family's cache
    carries its state leaves, which the decode steps update."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as SV
    cfg_a = cfg.replace(hnn_mode="ann", codec="none")
    dev = params["embed"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.RandomState(9)
    tok = rng.randint(0, cfg.vocab, (2, S))
    prefill = SV.make_prefill_step(cfg_a, device=dev)
    decode = SV.make_decode_step(cfg_a, device=dev)
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": torch.tensor(
        tok, device=dev)})
    # room for the new tokens' KV; a recurrent state keeps its shape
    cache = {p: {key: {n: torch.cat([c, c.new_zeros(
        c.shape[:2] + (new - 1,) + c.shape[3:])], dim=2)
        if key == "kv" else c for n, c in leaves.items()}
        for key, leaves in leaf.items()} for p, leaf in cache.items()}
    out = [SV.greedy_sample(logits)]
    for t in range(new - 1):
        logits, cache = decode(params, cache, out[-1], S + t)
        out.append(SV.greedy_sample(logits))
    dense = torch.stack(out, 1).cpu().tolist()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    eng, margins, *_ = serve(cfg_a, params, [(row.tolist(), new)
                                             for row in tok], "fused",
                             max_seq=S + 16, prefill_len=S)
    compared, _, by_margin = check_streams(dict(enumerate(dense)), eng,
                                           margins)
    print(f"launch.serve {cfg.name} ann/none: [2, {S}] prefill and "
          f"{new - 1} dense decode steps in {secs:.3f} s, launches "
          f"{launches}; dense == engine on {compared} of {2 * new} tokens "
          f"({by_margin} requests compared up to a margin <= {MARGIN})",
          flush=True)
    return {"tokens_compared": compared, "cut_by_margin": by_margin,
            "seconds": secs}


def serve_gemma2():
    """Full-width ``gemma2-2b`` (26 layers, d_model 2304, 8 heads on 4 kv
    heads of 256, d_ff 9216, vocab 256000, windows of 4096 on the local
    layers, softcaps 50 and 30, post-norms, GeGLU, tied embeddings) in
    float32 with seeded weights: the main path's requests under ANN
    ``none``, ``spike_fused``, ``spike`` and ``spike_pack4``; a
    ``spec_k=3`` serve under ``spike_fused``; the long-context serve;
    the ``launch.serve`` walk.  Returns (runs, spec summary, long run,
    dense summary)."""
    cfg, params = full_width("gemma2-2b")
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"gemma2-2b: {n_par} parameters in float32", flush=True)
    requests = smoke_requests(cfg.vocab)[1]
    serve(cfg, params, [(p, 4) for p, _ in requests[:2]], "fused")
    runs = {"ann/none": serve_ann(cfg, params, requests)}
    for codec in ("spike_fused", "spike", "spike_pack4"):
        runs[codec] = serve_codec(cfg, params, requests, codec)
    spec = serve_spec(cfg, params, spec_requests(), "spike_fused")
    long = serve_long(cfg, params)
    dense = serve_dense(cfg, params)
    del params
    torch.cuda.empty_cache()
    return runs, spec, long, dense


#: granite-20b's depth in the smoke: its 52 layers at full width are
#: 28.2 B parameters (105 GiB in float32), beyond one card
GRANITE_LAYERS = 4


def serve_granite():
    """Full-width ``granite-20b`` (d_model 6144, 48 heads on one kv head
    of 128, d_ff 24576, vocab 49152) at ``GRANITE_LAYERS`` layers, f32,
    seeded weights: the main path's requests under ANN ``none`` and
    ``spike_fused``, each at ``spec_k`` 0 and 3, every live paged-decode
    launch held to its plain version.  Returns (runs, spec summaries)."""
    cfg, params = full_width("granite-20b", GRANITE_LAYERS)
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"granite-20b at {cfg.n_layers} layers: {n_par} parameters in "
          "float32", flush=True)
    requests = smoke_requests(cfg.vocab)[1]
    serve(cfg, params, [(p, 4) for p, _ in requests[:2]], "fused")
    runs = {"ann/none": serve_ann(cfg, params, requests),
            "spike_fused": serve_codec(cfg, params, requests,
                                       "spike_fused")}
    spec = {"none": serve_spec(cfg.replace(hnn_mode="ann"), params,
                               requests, "none"),
            "spike_fused": serve_spec(cfg, params, requests,
                                      "spike_fused")}
    del params
    torch.cuda.empty_cache()
    return runs, spec


#: the MoE family in the smoke: qwen2-moe-a2.7b at its full depth and
#: width (14.32 B parameters, 53.4 GiB in float32), llama4-maverick at
#: one of its 24 units (a dense and a MoE block of 128 experts; its
#: full depth is beyond one card) in its published bfloat16, and
#: qwen2-moe's training at 2 of its 24 layers
QWEN2MOE = "qwen2-moe-a2.7b"
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_LAYERS = 2
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 20
MOE_TRAIN_CODECS = (("hnn", "spike_fused"), ("hnn", "spike"))


def free_card():
    """Release what the models of a finished phase left on the card."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_qwen2moe():
    """Full-width ``qwen2-moe-a2.7b`` (24 layers, d_model 2048, 16 MHA
    heads of 128 with QKV biases, 60 experts top-4 of 1408 and 4 shared,
    vocab 151936) in float32 with seeded weights: the main path's
    requests under ANN ``none``, ``spike_fused`` and ``spike`` (its
    ``spike_pack4`` run was cut for time; both walks, every live launch checked, the walks
    agreeing up to a rounding, routing or capacity split), the
    ``spike_fused`` run served once more for the same bits (streams and
    every margin), and the cyclic prompts under ``spike_fused`` at
    ``spec_k`` 3 beside 0 (agreement and drops printed, not gated);
    then the CUDA kernels of one decode step under ``spike_fused``.
    Returns (runs, spec summary, kernels per step)."""
    cfg, params = full_width(QWEN2MOE)
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"{QWEN2MOE}: {n_par} parameters in float32, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    requests = smoke_requests(cfg.vocab)[1]
    serve(cfg, params, [(p, 4) for p, _ in requests[:2]], "fused")
    runs = {"ann/none": serve_ann(cfg, params, requests)}
    # decode rows traced only: the walks are compared there
    for codec in ("spike_fused", "spike"):
        runs[codec] = serve_codec(cfg, params, requests, codec,
                                  trace_prefill=False)
    again, margins, *_ = serve(cfg, params, requests, "fused")
    first, first_margins = runs["spike_fused"][6]
    if again != first or margins != first_margins:
        raise AssertionError(f"{QWEN2MOE} spike_fused: a second serve gave "
                             "other bits")
    print(f"{QWEN2MOE} spike_fused: served again, the same streams and "
          "every margin equal", flush=True)
    spec = serve_spec(cfg, params, spec_requests(), "spike_fused")
    counts = step_kernels(QWEN2MOE, cfg, params)
    del params
    free_card()
    return runs, spec, counts


def serve_llama4():
    """Full-width ``llama4-maverick-400b-a17b`` (d_model 5120, 40 heads
    on 8 kv heads of 128, 128 experts top-1 of 8192 and one shared,
    vocab 202048) at ``LLAMA4_LAYERS`` = 2 layers — one unit: a dense
    block and a MoE block — in bfloat16 with seeded weights: the main
    path's requests under ANN ``none`` and ``spike_fused`` (both walks,
    every live launch checked, the split rule; its ``spec_k=3`` runs were
    cut for time).  Returns the runs."""
    cfg, params = full_width(LLAMA4, LLAMA4_LAYERS, torch.bfloat16)
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"{LLAMA4} at {cfg.n_layers} layers: {n_par} parameters in "
          f"bfloat16, {torch.cuda.memory_allocated() / 2**30:.1f} GiB on "
          "the card", flush=True)
    requests = smoke_requests(cfg.vocab)[1]
    serve(cfg, params, [(p, 4) for p, _ in requests[:2]], "fused")
    runs = {"ann/none": serve_ann(cfg, params, requests),
            "spike_fused": serve_codec(cfg, params, requests,
                                       "spike_fused", trace_prefill=False)}
    del params
    free_card()
    return runs


def train_moe():
    """Full-width ``qwen2-moe-a2.7b`` at ``MOE_TRAIN_LAYERS`` = 2 layers,
    f32: ``MOE_TRAIN_STEPS`` = 20 AdamW steps (the dense runs' data,
    microbatches and optimizer) under ``spike_fused`` and ``spike``, each
    held as ``train_run`` holds the dense runs (each MoE layer's
    ``sp_disp`` moved by the first step, its ``sp_comb`` gradient exactly
    0)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(**TRAIN_DATA))
    return {f"{hnn}/{codec}": train_run(hnn, codec, data, arch=QWEN2MOE,
                                        n_layers=MOE_TRAIN_LAYERS,
                                        steps=MOE_TRAIN_STEPS)
            for hnn, codec in MOE_TRAIN_CODECS}


RWKV = "rwkv-paper"
XLSTM = "xlstm-125m"
JAMBA = "jamba-1.5-large-398b"
#: the slice of jamba's published 8-layer unit the smoke serves: one
#: layer of each of its block kinds (mamba + MLP, mamba + MoE,
#: attention), 12.93 B parameters at full width
JAMBA_PATTERN = ("mamba_mlp", "mamba_moe", "attn")
REC_TRAIN_STEPS = 30
#: (hnn_mode, codec, the loss drop the run must reach: None for
#: ``TRAIN_MIN_DROP``, 1 nat).  Under ``spike`` the reference's own
#: rwkv-paper training stalls near 5.3 nats as its firing rate climbs to
#: ~0.82: it falls 0.323 nat in 30 steps at lr 1e-3 and 0.320 at 2e-3
#: (``tests/_ref_rwkv_train.py jax spike``, f32, full width, on the
#: CPU), so the port is held to a fall of 0.2 there
REC_TRAIN_CODECS = (("ann", "none", None), ("hnn", "spike_fused", None),
                    ("hnn", "spike", 0.2))


def step_kernels(label, cfg, params, codec="spike_fused"):
    """The CUDA kernels of one decode step under ``codec``
    (``kernels_per_step``), printed; raises when the profiler records no
    device activity."""
    got = kernels_per_step(cfg, params, codec)
    if got is None:
        raise AssertionError(f"kernels per decode step {label}: the "
                             "profiler recorded no device activity")
    counts, names = got
    top = ", ".join(f"{n} x {k[:48]}" for k, n in names.most_common(6))
    print(f"kernels per decode step {label} {codec}: {counts} (most "
          f"launched: {top})", flush=True)
    return counts


def serve_rwkv():
    """Full-width ``rwkv-paper`` (the paper's own LM, §4.1 Table 4: 6
    layers, d_model 512, d_ff 2048, vocab 256, layer norms; 21 M
    parameters) in float32 with seeded weights: the main path's
    requests under ANN ``none``, ``spike_fused``, ``spike`` and
    ``spike_pack4`` (both walks, every live launch checked; no
    attention, so the walks are one path) and SNN ``spike_fused``,
    whose prefill roundtrips both block outputs locally (the reference's
    decode does not); then the CUDA kernels of one decode step.
    Returns (runs, kernels per step)."""
    cfg, params = full_width(RWKV)
    requests = smoke_requests(cfg.vocab)[1]
    serve(cfg, params, [(p, 4) for p, _ in requests[:2]], "fused")
    runs = {"ann/none": serve_ann(cfg, params, requests)}
    for codec in ("spike_fused", "spike", "spike_pack4"):
        runs[codec] = serve_codec(cfg, params, requests, codec)
    runs["snn/spike_fused"] = serve_codec(cfg.replace(hnn_mode="snn"),
                                          params, requests, "spike_fused")
    kernels = step_kernels(RWKV, cfg, params)
    del params
    free_card()
    return runs, kernels


def serve_spec_fallback(cfg, params, requests, plain):
    """``spec_k=3`` on a recurrent family under ``spike_fused``: the
    engine forces ``spec_k=0`` (a state cannot roll a rejected draft
    back), so the run must serve ``plain``'s streams (the ``spec_k=0``
    run) exactly, with no verify step (``forward_verify`` raises while it
    runs) and the launches of a decode run.  Returns a summary dict."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    def refuse(orig, *a, **kw):
        raise AssertionError("a recurrent family launched a verify step")

    label = f"{arch_label(cfg)}spec_k={SPEC_K}/spike_fused"
    ops.reset_launch_counts()
    with _Patch(M, "forward_verify", refuse):
        streams, _, eng, secs, _ = serve(cfg.replace(codec="spike_fused"),
                                         params, requests, "fused",
                                         spec_k=SPEC_K)
    launches = ops.launch_counts()
    want = expected_launches("spike_fused", "fused", eng)
    if (eng.spec_k, eng.spec_verifies) != (0, 0) or launches != want:
        raise AssertionError(f"{label}: spec_k {eng.spec_k}, "
                             f"{eng.spec_verifies} verifies, launches "
                             f"{launches}, expected {want}")
    if streams != plain:
        raise AssertionError(f"{label}: the streams differ from spec_k=0's")
    n_tok = sum(map(len, streams.values()))
    print(f"serve {label}: the engine served spec_k={eng.spec_k}, no verify "
          f"step; the spec_k=0 streams on all {n_tok} tokens", flush=True)
    return {"spec_k_served": eng.spec_k, "equal_streams": True,
            "tokens": n_tok, "seconds": secs}


def serve_xlstm():
    """Full-width ``xlstm-125m`` (12 layers: three mLSTM blocks and an
    sLSTM block a unit, d_model 768, 4 heads of 192, vocab 50304; 115 M
    parameters) in float32 with seeded weights: the main path's requests
    under ANN ``none``, ``spike_fused`` and ``spike``; ``spec_k=3``
    beside the ``spike_fused`` run (``serve_spec_fallback``);
    ``async_depth=1`` beside 0 under ``spike_fused``, every pipelined
    dispatch free of host syncs; the ``launch.serve`` steps (a [2, 256]
    prefill and 8 greedy decode steps over the dense cache and state,
    ANN); the faults phase's replay under codec ``none``, fault-free and
    with the injector, bit-equal (suspends re-prefill prompt plus
    committed tokens at their exact length); then the CUDA kernels of
    one decode step.  Returns a summary dict."""
    cfg, params = full_width(XLSTM)
    requests = smoke_requests(cfg.vocab)[1]
    serve(cfg, params, [(p, 4) for p, _ in requests[:2]], "fused")
    runs = {"ann/none": serve_ann(cfg, params, requests)}
    for codec in ("spike_fused", "spike"):
        runs[codec] = serve_codec(cfg, params, requests, codec)
    out = {"runs": runs,
           "spec": serve_spec_fallback(cfg, params, requests,
                                       runs["spike_fused"][6][0]),
           "async": serve_async(cfg, params, requests, "spike_fused",
                                spec_ks=(0,)),
           "launch_serve": serve_dense(cfg, params),
           "faults_none": faults_ann(cfg, params)}
    print(f"faults {XLSTM} ({card_line()}): under codec none "
          f"{out['faults_none']}", flush=True)
    out["kernels"] = step_kernels(XLSTM, cfg, params)
    del params
    free_card()
    return out


def serve_jamba():
    """``jamba-1.5-large-398b`` at its published widths (d_model 8192,
    mamba d_inner 16384 and d_state 16, 64 heads on 8 kv heads of 128
    with no RoPE, 16 experts top-2 of 24576, dense MLP 24576, vocab
    65536) and a cut of depth: ``JAMBA_PATTERN``, one layer of each of
    its block kinds, 12.93 B parameters in bfloat16, its published
    dtype; the published unit of 8 layers is 43 B.  The main path's
    requests under ANN ``none`` and ``spike_fused``, both walks, every
    live launch checked, the walks agreeing up to a rounding, routing or
    capacity split.  Returns the runs."""
    free_card()
    cfg, params = full_width(JAMBA, len(JAMBA_PATTERN), torch.bfloat16,
                             pattern=JAMBA_PATTERN)
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"{JAMBA} at {cfg.pattern}: {n_par} parameters in bfloat16, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    requests = smoke_requests(cfg.vocab)[1]
    serve(cfg, params, [(p, 4) for p, _ in requests[:2]], "fused")
    runs = {"ann/none": serve_ann(cfg, params, requests),
            "spike_fused": serve_codec(cfg, params, requests,
                                       "spike_fused", trace_prefill=False)}
    del params
    free_card()
    return runs


def train_rwkv():
    """Full-width ``rwkv-paper`` in float32: ``REC_TRAIN_STEPS`` = 30
    AdamW steps of the dense runs' data, microbatches and optimizer
    under ANN ``none``, ``spike_fused`` and ``spike``, each held as
    ``train_run`` holds the dense runs (a loss drop of at least 1 nat,
    0.2 under ``spike``, whose reference stalls: ``REC_TRAIN_CODECS``;
    K1 and K2 against their plain versions, every boundary moved by the
    first step, the launches per step)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(**TRAIN_DATA))
    return {f"{hnn}/{codec}": train_run(hnn, codec, data, arch=RWKV,
                                        steps=REC_TRAIN_STEPS,
                                        min_drop=min_drop)
            for hnn, codec, min_drop in REC_TRAIN_CODECS}


def rec_summary(label, runs):
    return {f"{label} {k}": {"tok_s": r[2], "median_step_ms": r[3],
                             "streams_sha256": r[5], "launches": r[0],
                             "dropped": r[7]}
            for k, r in runs.items()}


def time_rec_boundaries(rec, flush):
    """The boundary kernels at the recurrent families' widths: 512
    (``rwkv-paper``: ``lif_encode`` on the live inputs of its ``spike``
    checked run, the packs on those of its ``spike_pack4`` run, decode
    rows, with their launches there), 768 (``xlstm-125m``: ``lif_encode``
    on its ``spike`` run's live inputs; the packs on the conformance
    cases) and 8192 (jamba, whose served codecs launch none: the
    conformance cases ``rec_m4_c*``, at 0 launches).  Returns {kernel
    name: rows for its ``by_shape``}."""
    from repro_torch.kernels.cases import (lif_tensors, pack4_case,
                                           pack4_counts_case,
                                           unpack4_log_scale)
    rows = {name: [] for name in BOUNDARY_KERNELS}

    def add(*a):
        time_config_row(rows, flush, *a)

    for config, run, entries in (
            (RWKV, rec[RWKV]["spike"], ("lif_encode",)),
            (RWKV, rec[RWKV]["spike_pack4"], ("pack4_counts",
                                              "unpack4_decode")),
            (XLSTM, rec[XLSTM]["spike"], ("lif_encode",))):
        chk = run[1]
        for key, (args, kw) in sorted(chk.samples.items(), key=str):
            if key[0] in entries and args[0].shape[0] == 4:
                add(config, key[0], args, kw, chk.by_shape[key[:2]])
    for config, C in ((XLSTM, 768), (JAMBA, 8192)):
        if config == JAMBA:
            x, theta, scale, T = lif_tensors(f"rec_m4_c{C}", "cuda")
            add(config, "lif_encode", [x, theta, scale], {"T": T}, 0)
            add(config, "lif_encode", [x, theta, scale],
                {"T": T, "decode_scale": (scale / T).float()}, 0)
        counts = torch.tensor(pack4_counts_case(f"rec_m4_c{C}", 7),
                              device="cuda")
        add(config, "pack4_counts", [counts, 7], {}, 0)
        packed = torch.tensor(pack4_case(f"rec_m4_c{C // 2}"),
                              device="cuda")
        ds = torch.exp(torch.tensor(unpack4_log_scale("seeded", C),
                                    device="cuda")) / 7
        add(config, "unpack4_decode", [packed, 7, ds], {}, 0)
    return rows


def recurrent_phase(clock, card):
    """The recurrent-state families: ``rwkv-paper`` served and trained,
    ``xlstm-125m`` served (with the spec fallback, the pipeline, the
    ``launch.serve`` steps and the ANN faults replay), the jamba cut
    served.  Returns {"rwkv-paper": runs, "xlstm-125m": runs,
    "jamba-1.5-large-398b": runs} for the kernel timings."""
    free_card()
    r_runs, r_kernels = serve_rwkv()
    clock.mark(f"{RWKV} serving")
    r_train = train_rwkv()
    clock.mark(f"{RWKV} training")
    x = serve_xlstm()
    clock.mark(XLSTM)
    j_runs = serve_jamba()
    clock.mark(f"{JAMBA} cut")
    print(json.dumps({"recurrent": {
        "serve": {**rec_summary(RWKV, r_runs),
                  **rec_summary(XLSTM, x["runs"]),
                  **rec_summary(JAMBA, j_runs)},
        "spec_fallback": {f"{XLSTM} spike_fused": x["spec"]},
        "async": {f"{XLSTM} spike_fused": x["async"]},
        "launch_serve": {XLSTM: x["launch_serve"]},
        "faults_none": {XLSTM: x["faults_none"]},
        "kernels_per_decode_step": {f"{RWKV} spike_fused": r_kernels,
                                    f"{XLSTM} spike_fused": x["kernels"]},
        "train": r_train, "card": card}}), flush=True)
    return {RWKV: r_runs, XLSTM: x["runs"], JAMBA: j_runs}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def launch_plan_of(arrays, pool_dtype=torch.float32):
    """{rows_per_block, row_groups, warps} of paged decode on a case."""
    from repro_torch.kernels.paged_decode import launch_plan
    q, kp, _, clp, _, _ = arrays
    plan = launch_plan(q.shape[0], q.shape[1], q.shape[2], kp.shape[2],
                       q.shape[3], kp.shape[1], clp.shape[1], pool_dtype)
    return dict(zip(("rows_per_block", "row_groups", "warps"), plan))


#: the codecs whose kernels per decode step are counted: those whose
#: boundaries run the boundary kernels, ``spike_fused`` as the control
STEP_CODECS = ("spike_fused", "spike", "spike_pack4")


def count_step_kernels(label, cfg, params):
    """Print the CUDA kernels of one decode step under ``STEP_CODECS``,
    for the package on ``sys.path``, and every kernel's launches by name
    (so that two readings can be told apart).  Raises when the profiler
    records no device activity, so that the phase measures or fails."""
    counts, by_name = {}, {}
    for codec in STEP_CODECS:
        got = kernels_per_step(cfg, params, codec)
        if got is None:
            raise AssertionError(f"kernels per decode step {label} {codec}: "
                                 "the profiler recorded no device activity")
        counts[codec], names = got
        by_name[codec] = dict(sorted(names.items()))
        top = ", ".join(f"{n} x {k[:48]}" for k, n in names.most_common(6))
        print(f"kernels per decode step {label} {codec}: {counts[codec]} "
              f"(most launched: {top})", flush=True)
    print(json.dumps({"kernels_per_decode_step": {label: counts}}),
          flush=True)
    print(json.dumps({"kernel_launches_by_name": {label: by_name}}),
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# training: the boundaries' backward kernels and full-width train steps
# ---------------------------------------------------------------------------

#: the backward kernels' check shapes: the training runs' boundary (one
#: microbatch, 4 x 256 tokens of d_model 1024; the kernels line's
#: numbers), a whole batch of 8 x 256 tokens, and a ragged row count
TRAIN_SHAPES = ((1024, 1024), (2048, 1024), (37, 1024))
#: (hnn_mode, codec) of each training run
TRAIN_CODECS = (("ann", "none"), ("hnn", "spike_fused"), ("hnn", "spike"),
                ("hnn", "spike_pack4"), ("hnn", "spike_fused+bwd8"))
TRAIN_STEPS = 30
#: the depth at which the dense training runs train qwen1.5-0.5b (of its
#: 24 layers; widths not cut): host-bound 24-layer steps took the phase
#: to 290-390 s and the whole smoke to 1112 s of its 1200 s on a slower
#: host, once the MoE family's phase was added
TRAIN_LAYERS = 8
TRAIN_MICRO = 2
TRAIN_DATA = dict(vocab=256, seq_len=256, global_batch=8, seed=0)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
#: how far (nats) the mean loss of the last 5 steps must lie below step 0's
TRAIN_MIN_DROP = 1.0
#: the boundaries of a layer, each with a learned theta and log_scale
BOUNDARIES = ("sp_in", "sp_out", "sp_in2", "sp_out2")
TRAIN_REPLACES = {
    "roundtrip_bwd": "src/repro/core/spike.py:309 (spike.roundtrip_vjp, "
                     "jnp; no pallas_call)",
    "lif_encode_bwd": "src/repro/core/spike.py:196 (jax.grad of "
                      "lif_rate_encode_signed, jnp; no pallas_call)"}
TRAIN_SOURCE = {"roundtrip_bwd": "src/repro_torch/csrc/roundtrip_bwd.cu",
                "lif_encode_bwd": "src/repro_torch/csrc/lif_encode.cu"}
#: where the training phase runs (a CPU rehearsal sets "cpu")
TRAIN_DEVICE = "cuda"
#: the training path's backward kernels (K1, K2)
TRAIN_KERNELS = ("roundtrip_bwd", "lif_encode_bwd")


def backward_inputs(M, C, dtype, seed):
    """x, g [M, C] in ``dtype``; theta in [0, 0.3), s = exp(log_scale),
    log_scale in [-1, 1), [C] float32: a boundary's backward inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(M, C, generator=gen, device="cuda") * 0.8).to(dtype)
    g = torch.randn(M, C, generator=gen, device="cuda").to(dtype)
    theta = 0.3 * torch.rand(C, generator=gen, device="cuda")
    s = torch.exp(2 * torch.rand(C, generator=gen, device="cuda") - 1)
    return x, g, theta, s


def check_train_kernels():
    """K1 (``roundtrip_bwd``) and K2 (``lif_encode_bwd``) against their
    plain versions on the training shapes: K1 in f32 and bf16, its dx
    bit-equal, dtheta and dlog_scale within 1e-5 x the sum of their
    terms' magnitudes per channel; K2 (f32) each output element within
    ``k2_close``; both the same bits on a second launch.  Returns
    ({kernel: max abs err}, {kernel: [(args, kw)]} samples to time)."""
    from repro_torch.kernels import lif_encode as LE
    from repro_torch.kernels import roundtrip_bwd as RB
    errs = {k: 0.0 for k in TRAIN_KERNELS}
    samples = {k: [] for k in TRAIN_KERNELS}
    for i, (M, C) in enumerate(TRAIN_SHAPES):
        for dt in (torch.float32, torch.bfloat16):
            x, g, theta, s = backward_inputs(M, C, dt, 10 + i)
            args, kw = (x, g, theta, s, s / 15), {"T": 15}
            got = RB.roundtrip_bwd_cuda(*args, **kw)
            again = RB.roundtrip_bwd_cuda(*args, **kw)
            dx, dth, dls = RB.roundtrip_bwd_terms(*args, **kw)
            torch.cuda.synchronize()
            if not same_bits(got, again):
                raise AssertionError("roundtrip_bwd: two launches differ")
            if not same_bits(got[0], dx):
                raise AssertionError(f"roundtrip_bwd {M}x{C} {dt}: dx differs "
                                     "from the plain version's bits")
            for out, terms, name in ((got[1], dth, "dtheta"),
                                     (got[2], dls, "dlog_scale")):
                err = (out - terms.sum(0)).abs()
                if (err > 1e-5 * terms.abs().sum(0)).any():
                    raise AssertionError(f"roundtrip_bwd {M}x{C} {dt}: {name} "
                                         f"off by {float(err.max()):.3g}")
                errs["roundtrip_bwd"] = max(errs["roundtrip_bwd"],
                                            float(err.max()))
            samples["roundtrip_bwd"].append((args, kw))
        x, g, theta, s = backward_inputs(M, C, torch.float32, 20 + i)
        args = (x / s, theta / s, g)
        got = LE.lif_encode_bwd_cuda(*args, T=15)
        again = LE.lif_encode_bwd_cuda(*args, T=15)
        want = LE.lif_encode_bwd_plain(*args, T=15)
        torch.cuda.synchronize()
        if not same_bits(got, again):
            raise AssertionError("lif_encode_bwd: two launches differ")
        for a, w, name in zip(got, want, ("dxn", "dthn")):
            if not k2_close(a, w):
                raise AssertionError(
                    f"lif_encode_bwd {M}x{C}: {name} off by "
                    f"{float((a - w).abs().max()):.3g} (largest entry "
                    f"{float(w.abs().max()):.3g})")
            errs["lif_encode_bwd"] = max(errs["lif_encode_bwd"],
                                         float((a - w).abs().max()))
        samples["lif_encode_bwd"].append((args, {"T": 15}))
    return errs, samples



def k2_close(a, w):
    """K2's bound, per element of one output: |a - w| <= 1e-5 |w| +
    1e-6 max |w| (the surrogate chain makes a few entries ~1e6 times the
    typical one, so a bound on the largest entry alone would pass a
    wrong typical entry)."""
    return bool(((a - w).abs() <= 1e-5 * w.abs()
                 + 1e-6 * w.abs().max()).all())


def time_train_kernels(samples, flush):
    """(kernel, plain, bound ms, bound_by) of each backward kernel at
    each checked shape."""
    from repro_torch.kernels import lif_encode as LE
    from repro_torch.kernels import roundtrip_bwd as RB
    fns = {"roundtrip_bwd": (RB.roundtrip_bwd_cuda, RB.roundtrip_bwd_plain),
           "lif_encode_bwd": (LE.lif_encode_bwd_cuda,
                              LE.lif_encode_bwd_plain)}
    out = {}
    for name, cases in samples.items():
        kernel, plain = fns[name]
        for args, kw in cases:
            x = args[0]
            M, C = x.shape
            if name == "roundtrip_bwd":
                # x, g read, dx written; theta, s, s/T read, dth, dls
                # written; ~25 operations an element
                n_bytes = 3 * M * C * x.element_size() + 5 * C * 4
                ops = 25 * M * C
            else:
                # xn, g read, dxn, dthn written, thn read; each of the
                # two populations' T ticks: 5 forward, 10 backward ops
                n_bytes = 4 * M * C * 4 + C * 4
                ops = (2 * kw["T"] * 15 + 16) * M * C
            b_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            b_ops = ops / F32_FLOP_PER_S * 1e3
            key = f"{name} [{M},{C}] {str(x.dtype)[6:]}"
            out[key] = (cuda_ms(lambda: kernel(*args, **kw), flush),
                        cuda_ms(lambda: plain(*args, **kw), flush),
                        max(b_bytes, b_ops),
                        "bytes" if b_bytes >= b_ops else "operations")
    return out


def train_launches(codec, cfg, n_micro):
    """Kernel launches of one train step: per dense layer and microbatch,
    ``roundtrip_bwd`` at each of the 4 coded collectives' backward under
    a spike codec; under ``spike``, ``lif_encode_bwd`` at each of the 2
    boundary penalties' backward, and ``lif_encode`` at the 4 coded
    collectives and the 2 penalties, in the forward and again in the
    per-block recompute of the backward; under ``spike_pack4``,
    ``pack4`` and ``unpack4`` at the 4 coded collectives, forward and
    recompute.  A MoE layer has 2 coded collectives (its attention's; the
    MoE block has none at world size 1) and 2 penalties (``sp_in`` and
    the MoE block's ``sp_disp``); an RWKV layer a dense layer's 4 and 2
    (``BLOCK_WIRES``)."""
    want = {k: 0 for k in ("paged_decode", "lif_encode", "count_matmul",
                           "pack4", "unpack4") + TRAIN_KERNELS}
    # the forward's coded collectives are a prefill's (``BLOCK_WIRES``)
    coded = per_model(cfg, "enc_pre") * n_micro   # coded collectives
    pens = per_model(cfg, "pen") * n_micro        # boundary penalties
    mode = codec.split("+")[0]
    if mode in ("spike", "spike_fused", "spike_pack4"):
        want["roundtrip_bwd"] = coded
    if mode == "spike":
        want["lif_encode_bwd"] = pens
        want["lif_encode"] = 2 * (coded + pens)
    if mode == "spike_pack4":
        want["pack4"] = want["unpack4"] = 2 * coded
    return want


def plain_backward_patches():
    """Patches that send the training path's kernels to their plain
    versions (the launch counts still move: compare outside a counted
    run)."""
    from repro_torch.kernels import lif_encode as LE
    from repro_torch.kernels import pack4 as PK
    from repro_torch.kernels import roundtrip_bwd as RB
    plain = lambda fn: (lambda orig, *a, **kw: fn(*a, **kw))  # noqa: E731
    return [_Patch(RB, "roundtrip_bwd_cuda", plain(RB.roundtrip_bwd_plain)),
            _Patch(LE, "lif_encode_bwd_cuda", plain(LE.lif_encode_bwd_plain)),
            _Patch(LE, "lif_encode_cuda", plain(LE.lif_encode_plain)),
            _Patch(PK, "pack4_counts_cuda", plain(PK.pack4_counts_plain)),
            _Patch(PK, "unpack4_decode_cuda",
                   plain(PK.unpack4_decode_plain))]


def grads_against_plain(cfg, params, batch):
    """One train step's gradients with the kernels and with their plain
    versions on the same params and batch: the largest ratio over the
    leaves of a leaf's largest difference to its largest entry (0 where
    both are 0), the global gradient norm, and the kernels' gradients."""
    from repro_torch.launch import train as TT
    from repro_torch.optim.adamw import tree_leaves
    step = TT.make_train_step(cfg, microbatches=TRAIN_MICRO,
                              with_optimizer=False, device=TRAIN_DEVICE)
    _, g_k, _ = step(params, batch)
    with contextlib.ExitStack() as stack:
        for patch in plain_backward_patches():
            stack.enter_context(patch)
        _, g_p, _ = step(params, batch)
    norm = float(TT.global_grad_norm(g_k))
    worst = 0.0
    for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)):
        diff, top = float((a - b).abs().max()), float(b.abs().max())
        worst = max(worst, diff / top if top else (0.0 if diff == 0
                                                    else float("inf")))
    return worst, norm, g_k


def learned_boundaries(kind):
    """(the boundaries of a block kind whose theta and log_scale learn at
    world size 1, those that get no gradient there): a MoE block's
    ``sp_disp`` learns from its penalty; its ``sp_comb`` codes the
    combine exchange of tp > 1 only."""
    if kind == "attn_moe":
        return ("sp_in", "sp_out", "sp_disp"), ("sp_comb",)
    return BOUNDARIES, ()


def train_run(hnn, codec, data, arch=MAIN_ARCH, n_layers=None,
              steps=TRAIN_STEPS, min_drop=None):
    """``steps`` AdamW steps of a full-width config (``arch``, f32,
    seeded init; qwen1.5-0.5b; all its layers unless ``n_layers`` cuts
    the depth) under one codec: losses, penalties, occupancies and
    firing rates per step, the median step time, the peak memory, the
    launches per step; raises if a loss or grad norm is not finite, if
    the loss does not fall by 1 nat (the mean of the last 5 steps
    against step 0; ``min_drop`` nats where given), if a learned
    boundary's theta or log_scale has not
    moved after the first step under a spike codec (or a MoE block's
    ``sp_comb`` has a nonzero gradient or moved but by weight decay), if
    a kernel's launches per step are not the path's, or if, under a
    spike codec, a leaf of the kernels' gradients parts from the plain
    versions' by more than 1e-5 of that leaf's largest entry."""
    from repro_torch.core import spike
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TT
    from repro_torch.optim import adamw
    # the run's own memory: above what earlier phases still hold
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = full_width(arch, n_layers)
    cfg = cfg.replace(hnn_mode=hnn, codec=codec)
    coded = codec != "none"
    label = f"{arch_label(cfg)}{hnn}/{codec}"
    out = {}
    learned, frozen = {}, {}
    for i, kind in enumerate(cfg.pattern):
        learned[f"pos{i}"], frozen[f"pos{i}"] = learned_boundaries(kind)
    if coded:
        rel, norm, g_k = grads_against_plain(cfg, params, data.batch(0))
        out["grads_vs_plain"] = {"max_leaf_rel_diff": rel, "grad_norm": norm}
        print(f"train {label}: kernels against plain versions, largest "
              f"difference {rel:.3g} of its leaf's largest entry (global "
              f"norm {norm:.4g})", flush=True)
        if not rel <= 1e-5:
            raise AssertionError(f"train {label}: kernel gradients part from "
                                 f"the plain versions' by {rel:.3g} of a "
                                 "leaf's largest entry")
        for pos, names in frozen.items():
            for b in names:
                for k in ("theta", "log_scale"):
                    if g_k["units"][pos][b][k].any():
                        raise AssertionError(f"train {label}: {pos} {b} {k} "
                                             "has a nonzero gradient")
        del g_k
    init = {(pos, b, k): params["units"][pos][b][k].clone()
            for pos in learned for b in learned[pos] + frozen[pos]
            for k in ("theta", "log_scale")}
    opt = adamw.init_opt_state(params)
    opt_cfg = adamw.AdamWConfig(**{**TRAIN_OPT, "total_steps": steps})
    step = TT.make_train_step(cfg, microbatches=TRAIN_MICRO,
                              opt_cfg=opt_cfg, device=TRAIN_DEVICE)
    rates = []
    real = spike.sparsity_loss

    def recorded(counts, T, *a):
        rates.append(spike.firing_rate(counts.detach(), T))
        return real(counts, T, *a)

    hist, times = [], []
    want = train_launches(codec, cfg, TRAIN_MICRO)
    total = collections.Counter()
    spike.sparsity_loss = recorded
    try:
        for i in range(steps):
            rates.clear()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, data.batch(i))
            rec = {k: float(v) for k, v in m.items()}
            times.append(time.perf_counter() - t0)
            rec["firing_rate"] = (float(torch.stack(rates).mean())
                                  if rates else 0.0)
            hist.append(rec)
            if ops.launch_counts() != want:
                raise AssertionError(f"train {label} step {i}: launches "
                                     f"{ops.launch_counts()}, expected {want}")
            total.update(ops.launch_counts())
            if not (np.isfinite(rec["loss"]) and np.isfinite(
                    rec["grad_norm"])):
                raise AssertionError(f"train {label} step {i}: {rec}")
            if i == 0 and coded:
                check_boundaries_moved(label, cfg, params, init, frozen,
                                       opt_cfg)
            print(f"train {label} step {i}: loss {rec['loss']:.4f} penalty "
                  f"{rec['penalty']:.6f} occupancy {rec['occupancy']:.4f} "
                  f"firing rate {rec['firing_rate']:.4f} grad norm "
                  f"{rec['grad_norm']:.4f} ({times[-1] * 1e3:.0f} ms)",
                  flush=True)
    finally:
        spike.sparsity_loss = real
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    out["profile"] = profile_train_step(step, params, opt,
                                        data.batch(steps))
    losses = [r["loss"] for r in hist]
    drop = losses[0] - float(np.mean(losses[-5:]))
    min_drop = TRAIN_MIN_DROP if min_drop is None else min_drop
    if drop < min_drop:
        raise AssertionError(f"train {label}: loss fell by {drop:.3f} nat, "
                             f"less than {min_drop}")
    out.update({"steps": steps, "loss_drop": drop,
                "run_seconds": time.perf_counter() - t_run,
                "median_step_ms": float(np.median(times[1:])) * 1e3,
                "first_step_ms": times[0] * 1e3, "peak_gib": peak,
                "launches_per_step": want, "launches": dict(total),
                "history": {k: [r[k] for r in hist] for k in hist[0]}})
    print(f"train {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
          f"the last 5 {losses[0] - drop:.4f}), median step "
          f"{out['median_step_ms']:.1f} ms, the run {out['run_seconds']:.1f} "
          f"s, peak memory {peak:.2f} GiB, "
          f"launches per step {want}", flush=True)
    return out


def check_boundaries_moved(label, cfg, params, init, frozen, opt_cfg):
    """After the first step: every unit's learned boundaries moved, and
    each frozen one (gradient exactly 0) moved by its weight decay alone,
    ``p - lr * wd * p`` (a stacked [U, D] leaf is decayed as a
    matrix)."""
    from repro_torch.optim import adamw
    lr = adamw.schedule(opt_cfg, torch.ones((), dtype=torch.int32,
                                            device=TRAIN_DEVICE))
    for (pos, b, k), v0 in init.items():
        now = params["units"][pos][b][k]
        if b in frozen[pos]:
            want = v0 - lr * (opt_cfg.weight_decay * v0)
            if not torch.allclose(now, want, rtol=1e-6, atol=0.0):
                raise AssertionError(f"train {label}: {pos} {b} {k} moved "
                                     "by more than its weight decay")
            continue
        for u in range(cfg.n_units):
            if torch.equal(now[u], v0[u]):
                raise AssertionError(f"train {label}: unit {u} {pos} {b} "
                                     f"{k} did not move in the first step")


def profile_train_step(step, params, opt, batch):
    """One more train step under ``torch.profiler``: its wall time, its
    CUDA kernels, their summed device time (one stream: no overlap) and
    its share of the wall time, and the kernels taking the most device
    time; None when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        t0 = time.perf_counter()
        _, _, m = step(params, opt, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            n += 1
    if not n:
        return None
    busy = sum(by_name.values()) / 1e3
    top = [(k[:80], round(v / 1e3, 3)) for k, v in by_name.most_common(8)]
    print(f"train step profile: wall {wall * 1e3:.1f} ms, {n} device "
          f"operations, {busy:.1f} ms of device time ({busy / wall / 10:.1f}"
          f"% busy); most time: {top}", flush=True)
    return {"wall_ms": wall * 1e3, "device_ops": n, "device_ms": busy,
            "top_ms": top}


def train_cli_resume():
    """``train_cli.main`` in this process on the reduced config (the
    checkpoints stay small): 6 steps; 4 steps with a checkpoint every 2;
    a second launch for 6 that resumes at 4.  The resumed losses must
    equal the uninterrupted run's within 1e-4 relative (the embedding's
    backward adds with atomics on the card).  Inside the warmup (8
    steps) the learning rate does not depend on ``--steps``."""
    import shutil
    from repro_torch.launch import train_cli
    root = ROOT / "build" / "train_cli"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, steps):
        return train_cli.main([
            "--reduced", "--steps", str(steps), "--batch", "8", "--seq",
            "64", "--ckpt-every", "2", "--warmup", "8", "--log-every", "2",
            "--device", TRAIN_DEVICE, "--ckpt-dir", str(root / name)])[1]

    straight = [m["loss"] for m in run("straight", 6)]
    first = run("resumed", 4)
    rest = [m["loss"] for m in run("resumed", 6)]
    shutil.rmtree(root, ignore_errors=True)
    if len(first) != 4 or len(rest) != 2 or not np.allclose(
            rest, straight[4:], rtol=1e-4, atol=0):
        raise AssertionError(f"train_cli resume: {rest} after 4 steps, "
                             f"uninterrupted {straight}")
    print(f"train_cli: 4 steps, then a resume at step 4: losses {rest}, "
          f"uninterrupted {straight[4:]}", flush=True)
    return {"uninterrupted": straight, "resumed": rest}


def train_runs():
    """The five full-width training runs and the CLI's resume."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(**TRAIN_DATA))
    runs = {f"{hnn}/{codec}": train_run(hnn, codec, data,
                                        n_layers=TRAIN_LAYERS)
            for hnn, codec in TRAIN_CODECS}
    return runs, train_cli_resume()


def train_kernel_entries(errs, samples, runs, flush):
    """The ``kernels`` line's entries of K1 and K2: each timed at every
    checked shape (``by_shape``), its top-level numbers at the training
    shape in f32, its launches those of the ``spike`` run's steps."""
    times = time_train_kernels(samples, flush)
    out = []
    for name in TRAIN_KERNELS:
        by_shape = [{"shape": key.split(" ", 1)[1], "ms": t[0],
                     "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
                     "library_ms": None}
                    for key, t in times.items() if key.startswith(name + " ")]
        for row in by_shape:
            print(f"{name} {row['shape']}: kernel {row['ms']:.5f} ms, plain "
                  f"{row['plain_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
                  f"({row['bound_by']})", flush=True)
        top = by_shape[0]
        out.append({"name": name, "route": "cuda",
                    "source": TRAIN_SOURCE[name],
                    "replaces": TRAIN_REPLACES[name],
                    "launches": runs["hnn/spike"]["launches"][name],
                    "max_abs_err": errs[name],
                    **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
                    "shape": top["shape"], "by_shape": by_shape})
    return out


class PhaseClock:
    """Prints each phase's seconds on the host clock as it ends, so a
    run shows where the smoke's time limit goes."""

    def __init__(self):
        self.t = self.t0 = time.perf_counter()

    def mark(self, name):
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.1f} s (total "
              f"{now - self.t0:.1f} s)", flush=True)
        self.t = now


def paged_times():
    """Paged decode's kernel and plain ms (f32 pools, wire on) at the main
    path's decode and verify shapes and on the other configs' cases
    that the package on ``sys.path`` has, for the package on
    ``sys.path`` (another checkout's too), so that two commits' kernels
    are timed in one call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import cases
    build.build(["paged_decode"])
    cfg = get_config(MAIN_ARCH)
    lens = smoke_requests(cfg.vocab)[0]
    out = {}
    for K1 in (1, SPEC_K + 1):
        case = serve_case(cfg, [int(L) + 16 for L in lens[:4]], K1=K1)
        out[f"{MAIN_ARCH} K1={K1}"] = time_paged(case)[:2]
    for name in getattr(cases, "ARCH_CASES", ()):
        arrays, window, cap = cases.case_arrays(name)
        out[name] = time_paged(arrays, window, cap)[:2]
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    modes = ("--kernels-per-step", "--paged-times")
    if argv and (len(argv) != 2 or argv[0] not in modes):
        print("usage: chip_smoke.py [--kernels-per-step SRC | "
              "--paged-times SRC]", file=sys.stderr)
        return 2
    src = Path(argv[1]).resolve() if argv else SRC
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv and argv[0] == "--paged-times":
        print(json.dumps({"paged_times": {str(argv[1]): paged_times()}}),
              flush=True)
        return 0
    if argv:
        # only the kernel count, for the package under ``src`` (another
        # checkout's, to compare two commits in one call)
        from repro_torch.kernels import build
        build.build()
        cfg, params = full_width(MAIN_ARCH)
        count_step_kernels(str(argv[1]), cfg, params)
        requests = smoke_requests(cfg.vocab)[1]
        print(json.dumps({"streams_sha256": {str(argv[1]): {
            codec: streams_digest(serve(cfg.replace(codec=codec), params,
                                        requests, "fused")[0])
            for codec in STEP_CODECS}}}), flush=True)
        return 0

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.cases import (ARCH_CASES, CASE_POOL, CASES,
                                           case_arrays)
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params

    card = card_line()
    print(f"card: {card}", flush=True)
    clock = PhaseClock()

    t = time.perf_counter()
    logs = build.build()
    print(f"build: {sorted(build.SOURCES)} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

    cfg, params = full_width(MAIN_ARCH, N_LAYERS)
    if (cfg.n_layers, cfg.hnn_mode, cfg.codec) != (N_LAYERS, "hnn",
                                                   "spike_fused"):
        raise AssertionError(f"unexpected serving config {cfg}")

    lens, requests = smoke_requests(cfg.vocab)

    max_err = 0.0
    for name in sorted(CASES):
        arrays, window, cap = case_arrays(name)
        for dt in (torch.float32, torch.bfloat16):
            e = compare_kernel(arrays, window, cap, dt)
            max_err = max(max_err, e)
            print(f"check paged_decode {name} {str(dt)[6:]}: max abs err "
                  f"{e:.3g}", flush=True)
    for name in ARCH_CASES:
        arrays, window, cap = case_arrays(name)
        n = paged_repeatable(arrays, window, cap)
        plans = {str(dt)[6:]: launch_plan_of(arrays, dt)
                 for dt in (torch.float32, torch.bfloat16)}
        print(f"check paged_decode {name}: {n} pairs of launches equal bit "
              f"for bit; launch plan {plans}", flush=True)
    s_case = serve_case(cfg, [int(L) + 16 for L in lens[:4]])
    v_case = serve_case(cfg, [int(L) + 16 for L in lens[:4]], K1=SPEC_K + 1)
    for name, case in (("serve_shape", s_case), ("verify_shape", v_case)):
        for dt in (torch.float32, torch.bfloat16):
            e = compare_kernel(case, 0, 0.0, dt)
            max_err = max(max_err, e)
            print(f"check paged_decode {name} {str(dt)[6:]}: max abs err "
                  f"{e:.3g}", flush=True)

    errs, n_checked = check_boundary_kernels()
    for name in BOUNDARY_KERNELS:
        entries = {e: n_checked[e] for e, f in _boundary_fns().items()
                   if f[0] == name}
        print(f"check {name}: conformance cases, vector-layout edges and "
              f"serve shapes exact, launches per entry point {entries} "
              f"(max abs err {errs[name]:.3g})", flush=True)
    cm_err, cm_steps, cm_n = check_count_matmul()
    errs["count_matmul"] = cm_err
    print(f"check count_matmul: {cm_n} conformance launches agree with the "
          f"plain version (float32 results: max abs err {cm_err:.3g}; bf16 "
          f"results at most {cm_steps} bf16 steps from the rounding of the "
          "plain float32 sum where the tolerance is finer than half a "
          "step)", flush=True)
    n_rep = check_repeatable(s_case)
    print(f"check repeatable: {n_rep} pairs of launches of paged_decode and "
          "count_matmul at their serve shapes equal bit for bit",
          flush=True)

    clock.mark("build and kernel checks")
    # warm-up (library handles, the caching allocator, first launches),
    # outside every timed and counted run
    serve(cfg, params, [(p, 4) for p, _ in requests[:2]], "fused")

    # every codec of the coded boundary: the main path of each
    runs = {codec: serve_codec(cfg, params, requests, codec)
            for codec in CODECS[:1]}

    # ANN mode (codec none): nothing rounds on a wire, so the streams
    # must agree wherever the margin allows
    runs["ann/none"] = serve_ann(cfg, params, requests)

    runs.update((codec, serve_codec(cfg, params, requests, codec))
                for codec in CODECS[1:])

    clock.mark("main path, five codecs")
    # the published dtype, bfloat16, under ``spike``: lif_encode in its
    # bf16 mode, and the count matmul shadow on the live wire counts
    cfg16 = get_config(MAIN_ARCH, n_layers=N_LAYERS)
    if cfg16.dtype != torch.bfloat16 or cfg16.replace(
            dtype=torch.float32) != cfg:
        raise AssertionError(f"unexpected bf16 serving config {cfg16}")
    gen16 = torch.Generator(device="cuda").manual_seed(0)
    params16 = init_params(model_defs(cfg16), gen16, cfg16.dtype,
                           device="cuda")
    serve(cfg16, params16, [(p, 4) for p, _ in requests[:2]], "fused")
    runs["spike/bf16"] = serve_codec(cfg16, params16, requests, "spike",
                                     shadow=True)
    del params16

    # SNN mode: the block outputs of prefill and every MLP spike-coded
    # too, ``lif_encode`` at those roundtrips under ``spike``
    cfg_snn = cfg.replace(hnn_mode="snn")
    params_snn = init_params(model_defs(cfg_snn), torch.Generator(
        device="cuda").manual_seed(0), cfg.dtype, device="cuda")
    # the init gives ``sp_snn2`` the thresholds of the MLP's output
    # boundary, and a roundtrip of what that boundary decoded returns it
    # unchanged: the SNN roundtrips get seeded thresholds of their own
    gen_snn = torch.Generator(device="cuda").manual_seed(1)
    for name in ("sp_snn", "sp_snn2"):
        theta = params_snn["units"]["pos0"][name]["theta"]
        theta.copy_(0.05 + 0.25 * torch.rand(theta.shape, generator=gen_snn,
                                             device="cuda"))
    for codec in ("spike_fused", "spike"):
        runs[f"snn/{codec}"] = serve_codec(cfg_snn, params_snn, requests,
                                           codec)
        same = runs[f"snn/{codec}"][5] == runs[codec][5]
        print(f"snn/{codec}: streams {'equal' if same else 'differ from'} "
              "those of HNN mode", flush=True)
    del params_snn

    clock.mark("bf16 and SNN")
    # speculative decoding with the n-gram drafter, K1 = SPEC_K + 1
    spec_reqs = spec_requests()
    spec = {}
    for codec in SPEC_CODECS:
        cfg_s = cfg.replace(hnn_mode="ann") if codec == "none" else cfg
        spec[codec] = serve_spec(cfg_s, params, spec_reqs, codec)
    print(json.dumps({"spec": spec}), flush=True)

    clock.mark("spec")
    # stochastic sampling: the distribution on the card, and seeded
    # sampled serving beside the greedy run of the main path
    tv = check_sampling_tv()
    print(f"sampling on the card: TV distance over 4096 draws {tv} "
          "(each < 0.06)", flush=True)
    sampled = serve_sampled(cfg, params, requests, *runs["spike_fused"][6])
    print(json.dumps({"sampling": {"tv": tv, **sampled}}), flush=True)

    clock.mark("sampling")
    # the dispatch/commit pipeline (async_depth=1) beside the synchronous
    # loop, then a fault-injected trace replay through it
    async_runs = {codec: serve_async(cfg, params, requests, codec)
                  for codec in ASYNC_CODECS}
    print(json.dumps({"async": async_runs}), flush=True)
    print(json.dumps({"faults": serve_faults(cfg, params)}), flush=True)

    # the rest of the dense attention family at full width: gemma2-2b
    # (every decode-path codec, spec, a context past its window, the
    # launch.serve steps), then granite-20b's MQA at cut depth
    clock.mark("async and faults")
    g_runs, g_spec, g_long, g_dense = serve_gemma2()
    clock.mark("gemma2-2b")
    gr_runs, gr_spec = serve_granite()
    clock.mark("granite-20b")
    # the MoE family: every earlier model freed first (qwen2-moe's
    # weights take 53.4 GiB of the card)
    del params
    free_card()
    print(f"before the MoE family: {torch.cuda.memory_allocated() / 2**30:.2f}"
          " GiB allocated on the card", flush=True)
    q_runs, q_spec, q_kernels = serve_qwen2moe()
    clock.mark(QWEN2MOE)
    l_runs = serve_llama4()
    clock.mark(LLAMA4)
    moe_train = train_moe()
    print(json.dumps({"moe": {
        "serve": {f"{arch} {k}": {"tok_s": r[2], "median_step_ms": r[3],
                                  "streams_sha256": r[5], "dropped": r[7],
                                  "launches": r[0]}
                  for arch, rs in ((QWEN2MOE, q_runs), (LLAMA4, l_runs))
                  for k, r in rs.items()},
        "spec": {f"{QWEN2MOE} spike_fused": q_spec},
        "kernels_per_decode_step": {f"{QWEN2MOE} spike_fused": q_kernels},
        "train": moe_train, "card": card}}), flush=True)
    clock.mark("MoE training")
    # the recurrent-state families (rwkv-paper, xlstm-125m, the jamba cut)
    rec = recurrent_phase(clock, card)
    serve_line = dict(runs)
    serve_line.update((f"gemma2-2b {k}", r) for k, r in g_runs.items())
    serve_line["gemma2-2b long/spike_fused"] = g_long
    serve_line.update((f"granite-20b {k}", r) for k, r in gr_runs.items())
    print(json.dumps({"serve": {k: {"tok_s": r[2], "median_step_ms": r[3],
                                    "streams_sha256": r[5]}
                                for k, r in serve_line.items()}}),
          flush=True)
    print(json.dumps({"spec_archs": {"gemma2-2b spike_fused": g_spec,
                                     **{f"granite-20b {k}": v
                                        for k, v in gr_spec.items()}},
                      "launch_serve": g_dense}), flush=True)

    # training: the boundaries' backward kernels on the training shapes,
    # full-width qwen1.5-0.5b under five codecs, the CLI's resume
    t_errs, t_samples = check_train_kernels()
    print(f"check roundtrip_bwd, lif_encode_bwd on {list(TRAIN_SHAPES)}: "
          "dx bit-equal, sums within 1e-5 of their terms' magnitudes, K2 "
          "each element within 1e-5 of itself + 1e-6 of its output's "
          f"largest, repeatable (max abs err {t_errs})", flush=True)
    t_runs, t_cli = train_runs()
    print(json.dumps({"train": {"runs": t_runs, "cli": t_cli,
                                "card": card}}), flush=True)
    clock.mark("training")

    # paged decode at every served shape (the served lists of the main
    # path's requests, each config's local layer where it has windows)
    # and on the other configs' conformance cases, f32 pools, the wire
    # epilogue on as the coded steps run it
    cfg_g = get_config("gemma2-2b")
    cfg_gr = get_config("granite-20b")
    g_lens = smoke_requests(cfg_g.vocab)[0]
    gr_lens = smoke_requests(cfg_gr.vocab)[0]
    shapes = [
        ("qwen1.5-0.5b decode", s_case, 0, 0.0,
         runs["spike_fused"][0]["paged_decode"]),
        ("qwen1.5-0.5b verify", v_case, 0, 0.0,
         spec["spike_fused"]["launches"]["paged_decode"]),
        ("gemma2-2b decode", serve_case(cfg_g, [int(L) + 16 for L in
                                                g_lens[:4]]),
         cfg_g.window, cfg_g.attn_softcap,
         g_runs["spike_fused"][0]["paged_decode"]),
        ("gemma2-2b verify", serve_case(cfg_g, [int(L) + 16 for L in
                                                g_lens[:4]],
                                        K1=SPEC_K + 1),
         cfg_g.window, cfg_g.attn_softcap,
         g_spec["launches"]["paged_decode"]),
        ("granite-20b decode", serve_case(cfg_gr, [int(L) + 16 for L in
                                                   gr_lens[:4]]),
         0, 0.0, gr_runs["spike_fused"][0]["paged_decode"]),
        ("granite-20b verify", serve_case(cfg_gr, [int(L) + 16 for L in
                                                   gr_lens[:4]],
                                          K1=SPEC_K + 1),
         0, 0.0, gr_spec["spike_fused"]["launches"]["paged_decode"]),
    ]
    f32 = torch.float32
    shapes = [row + (f32,) for row in shapes]
    # the MoE family's decode and verify shapes: qwen2-moe's f32 pool,
    # llama4's bf16 one (its spike_fused runs' launches)
    # (llama4's verify shape: its spec runs were cut for time; 0
    # launches)
    for arch, pool, run, verify_launches in (
            (QWEN2MOE, f32, q_runs["spike_fused"],
             q_spec["launches"]["paged_decode"]),
            (LLAMA4, torch.bfloat16, l_runs["spike_fused"], 0)):
        cfg_m = get_config(arch)
        m_lens = [int(L) + 16 for L in smoke_requests(cfg_m.vocab)[0][:4]]
        shapes += [(f"{arch} decode", serve_case(cfg_m, m_lens), 0, 0.0,
                    run[0]["paged_decode"], pool),
                   (f"{arch} verify", serve_case(cfg_m, m_lens,
                                                 K1=SPEC_K + 1), 0, 0.0,
                    verify_launches, pool)]
    # jamba's attention layer over its bf16 pool (decode only: spec is
    # forced off for a recurrent family)
    cfg_j = get_config(JAMBA)
    j_lens = [int(L) + 16 for L in smoke_requests(cfg_j.vocab)[0][:4]]
    shapes.append((f"{JAMBA} decode", serve_case(cfg_j, j_lens), 0, 0.0,
                   rec[JAMBA]["spike_fused"][0]["paged_decode"],
                   torch.bfloat16))
    shapes += [(name,) + case_arrays(name)
               + (None, getattr(torch, CASE_POOL.get(name, "float32")))
               for name in ARCH_CASES]
    paged = []
    for name, arrays, window, cap, launches, pool in shapes:
        ms, plain_ms, lib_ms, bound_ms, bound_by = time_paged(
            arrays, window, cap, pool)
        plan = launch_plan_of(arrays, pool)
        paged.append({"name": name, "shape": list(arrays[0].shape),
                      "K1": int(arrays[0].shape[1]), "window": window,
                      "cap": cap, "pool": str(pool)[6:],
                      "launches": launches, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, **plan})
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"paged_decode {name} {list(arrays[0].shape)} "
              f"{str(pool)[6:]} pool: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib}, bound {bound_ms:.5f} ms "
              f"({bound_by}), launches {launches}, plan {plan}", flush=True)
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": SOURCE["paged_decode"], "replaces": REPLACES["paged_decode"],
        "launches": paged[0]["launches"], "max_abs_err": max_err,
        **{k: paged[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
        "by_shape": paged}]

    flush = torch.empty(96 * 2**20 // 4, dtype=torch.float32, device="cuda")
    kernels.extend(time_boundary_kernels(runs, errs, flush))
    for rows_of in (time_moe_boundaries(q_runs, flush),
                    time_rec_boundaries(rec, flush)):
        for name, rows in rows_of.items():
            next(k for k in kernels if k["name"] == name)[
                "by_shape"].extend(rows)
    kernels.extend(train_kernel_entries(t_errs, t_samples, t_runs, flush))

    # the count matmul on the bf16 spike run's live wire counts, at the
    # decode and the prefill shape of the MLP input ([M, 1024] x
    # [1024, 2816], w1 and w3) and of the attention input ([M, 1024] x
    # [1024, 1024], wq, wk and wv), bf16 W and result
    check, cm_launches = runs["spike/bf16"][1], runs["spike/bf16"][4]
    by_shape = []
    for N in (cfg.d_ff, cfg.d_model):
        for M in (4, 256):
            key = ("count_matmul", (M, cfg.d_model, N))
            if key not in check.samples:
                raise AssertionError(f"count_matmul: no live launch at "
                                     f"{key[1]}; saw "
                                     f"{sorted(k for k in check.samples)}")
            args, kw = check.samples[key]
            k_ms, p_ms, l_ms, b_ms, b_by, tc_ms = time_count_matmul(
                args, kw, flush)
            by_shape.append({"shape": list(key[1]), "ms": k_ms,
                             "plain_ms": p_ms, "library_ms": l_ms,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "tc_bound_ms": tc_ms})
            tc = (f", tensor-core bound {tc_ms:.6f} ms" if tc_ms is not None
                  else "")
            print(f"count_matmul at [{M},{cfg.d_model}]x[{cfg.d_model},{N}] "
                  f"bf16: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, matmul "
                  f"{l_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}){tc}",
                  flush=True)
    kernels.append({
        "name": "count_matmul", "route": "cuda",
        "source": SOURCE["count_matmul"],
        "replaces": REPLACES["count_matmul"],
        "launches": cm_launches["count_matmul"],
        "max_abs_err": errs["count_matmul"],
        **{k: v for k, v in by_shape[0].items()
           if k not in ("shape", "tc_bound_ms")},
        "shape": by_shape[0]["shape"], "by_shape": by_shape})
    clock.mark("kernel timings")
    # after every timing, so that the profiler's device tracing cannot
    # touch one; at the main path's full depth
    cfg, params = full_width(MAIN_ARCH)
    count_step_kernels("this checkout", cfg, params)
    clock.mark("kernels per decode step")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
