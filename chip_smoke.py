#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card
(``python3 chip_smoke.py``, no arguments).  Phases, each of which raises
on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel) into
   ``build/repro_torch/``;
3. hold the paged-decode kernel against its plain PyTorch version on the
   card: the six conformance cases of ``kernels/cases.py`` and the serve
   shape (Hq = Hkv = 16, dh = 64, page 16, K1 = 1), with f32 and bf16
   pools, with and without the int8 wire epilogue;
4. serve the full-width ``qwen1.5-0.5b`` (24 layers, d_model 1024, 16
   heads of 64, d_ff 2816, vocab 151936; HNN mode, ``spike_fused``
   codec; float32 weights from the port's seeded init) through
   ``ServingEngine``: eight requests of 16-120 prompt tokens and 32 new
   tokens each on four slots.  The kernel walk's run is timed, must
   launch the kernel 24 times per decode step and free every page.  The
   reference walk and a second kernel-walk run (every launch checked
   against the plain version on its live inputs) are traced at every
   coded wire: their greedy streams must agree up to each request's
   first coded value that rounds the other way — where the values it
   rounds from must agree to float noise — or to a reference top-1/
   top-2 logit margin of 1e-4.  In ANN mode (codec ``none``), where
   nothing rounds on a wire, the two walks' streams must agree up to
   the margin rule alone;
5. time the kernel, its plain version and, as a yardstick only, PyTorch's
   ``scaled_dot_product_attention`` on the gathered K/V of the same live
   tokens, and print one ``kernels`` JSON line;
6. print ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

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
# outside the tensor cores — the paged-decode kernel's f32 math
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
MARGIN = 1e-4
N_LAYERS = 24


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


def serve_case(cfg, slot_lens, seed=7):
    """Kernel inputs at the serve shape: a pool of 64 pages of one layer,
    four slots whose lists an allocator built for ``slot_lens`` tokens,
    each querying its last position."""
    from repro_torch.models.blocks_attn import attn_dims
    from repro_torch.serving.kv_cache import SlotAllocator
    d = attn_dims(cfg)
    psz, max_seq = 16, 256
    alloc = SlotAllocator(len(slot_lens), max_seq, psz)
    rng = np.random.RandomState(seed)
    for L in slot_lens:
        alloc.alloc(L)
    shape = (alloc.num_pages, psz, d["Hkv"], d["dh"])
    q = rng.standard_normal((len(slot_lens), 1, d["Hq"], d["dh"]))
    arrays = (q.astype(np.float32),
              rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal(shape).astype(np.float32),
              alloc.page_list_loc[:, 0].copy(),
              alloc.page_list_pos[:, 0].copy(),
              np.asarray(slot_lens, np.int32)[:, None] - 1)
    return arrays


def time_kernel(arrays, cfg):
    """(kernel ms, plain ms, SDPA ms, bound ms, bound_by) at the serve
    shape with the wire epilogue on, as the spike_fused decode runs."""
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels.cases import to_tensors
    q, kp, vp, clp, clo, qpos = to_tensors(arrays, "cuda")
    flush = torch.empty(96 * 2**20 // 4, dtype=torch.float32,
                        device="cuda")
    ms = cuda_ms(lambda: PD.paged_decode_cuda(q, kp, vp, clp, clo, qpos,
                                              encode_wire=True), flush)
    plain_ms = cuda_ms(lambda: PD.paged_decode_plain(
        q, kp, vp, clp, clo, qpos, encode_wire=True), flush)
    # yardstick: SDPA over the already gathered live tokens of each slot
    B, _, Hq, dh = q.shape
    lens = arrays[5][:, 0] + 1
    Lmax = int(lens.max())
    k_d = torch.zeros((B, Hq, Lmax, dh), device="cuda")
    v_d = torch.zeros_like(k_d)
    for b in range(B):
        rows = torch.tensor(clp[b][clp[b] >= 0].tolist(), device="cuda")
        kk = kp[rows].reshape(-1, Hq, dh)[:lens[b]]
        vv = vp[rows].reshape(-1, Hq, dh)[:lens[b]]
        k_d[b, :, :lens[b]] = kk.transpose(0, 1)
        v_d[b, :, :lens[b]] = vv.transpose(0, 1)
    mask = (torch.arange(Lmax, device="cuda")[None, :]
            < torch.tensor(lens, device="cuda")[:, None])[:, None, None, :]
    q_d = q.permute(0, 2, 1, 3).contiguous()
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_d, k_d, v_d, attn_mask=mask), flush)
    # least work: every live token's K and V row once, q, and the wire
    # outputs (int8 partial, f32 scale, f32 lse); 4 flops per score entry
    tokens = int(lens.sum())
    nbytes = (2 * tokens * kp.shape[2] * dh * kp.element_size()
              + q.numel() * 4 + B * Hq * dh + 2 * B * Hq * 4
              + 2 * clp.numel() * 4 + qpos.numel() * 4)
    flops = 4 * tokens * Hq * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (ms, plain_ms, lib_ms, max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


class _Patch:
    """Replace ``module.name`` by ``fn(original, *args, **kw)`` while
    active."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name,
                lambda *a, **kw: self.fn(orig, *a, **kw))

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class LaunchCheck:
    """Check every paged-decode launch of a kernel-walk engine run
    against the plain version on the same (live) inputs: o and lse, or
    the wire scale and lse, within float rounding, and the int8 wire
    within one step."""

    def __init__(self):
        self.launches = 0
        self.flipped = 0         # wire values one step from the plain one

    def patches(self):
        from repro_torch.kernels import paged_decode as PD
        return [_Patch(PD, "paged_decode_cuda", self._launch)]

    def _launch(self, orig, *args, **kw):
        from repro_torch.kernels.paged_decode import paged_decode_plain
        out = orig(*args, **kw)
        plain = paged_decode_plain(*args, **kw)
        self.launches += 1
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
    """Record every coded value the decode steps of one engine run put on
    a wire: the spike counts of each boundary encode with the values they
    were rounded from, and the int8 attention partial with its scale,
    each tagged with the (rid, token index) every slot was producing."""

    def __init__(self, num_slots):
        self.num_slots = num_slots
        self.eng = None
        self.events = []         # (kind, rounded-from, wire, progress)

    def patches(self):
        from repro_torch.core import boundary, spike
        return [_Patch(spike, "encode", self._encode),
                _Patch(boundary, "coded_combine_partials", self._combine)]

    def _decode_shaped(self, x):
        return x.shape[0] == self.num_slots and x.shape[1] == 1

    def _encode(self, orig, x, params, cfg):
        counts = orig(x, params, cfg)
        if self._decode_shaped(x):
            self.events.append(("spike counts", x.detach().float().clone(),
                                counts.detach().to(torch.int8),
                                self.eng.slot_progress()))
        return counts

    def _combine(self, orig, wire, scale, lse, *a, **kw):
        self.events.append(("attention wire",
                            (wire.float() * scale).detach().clone(),
                            wire.detach().clone(), self.eng.slot_progress()))
        return orig(wire, scale, lse, *a, **kw)


def first_rounding_splits(tr_f, tr_r):
    """Per request, the first token whose decode step put a different
    coded value on any wire in the two traced runs.  Raises unless each
    such first difference is a rounding split: the values rounded from
    agree to float noise (spike counts: within 1e-4 of the row's
    magnitude) or one int8 step (attention partial).  Returns (rid ->
    token index, largest relative gap seen at a split)."""
    if len(tr_f.events) != len(tr_r.events):
        raise AssertionError("the traced runs took different schedules")
    cut, worst = {}, 0.0
    for (kind, pre_f, w_f, prog), (kind_r, pre_r, w_r, prog_r) in zip(
            tr_f.events, tr_r.events):
        if kind != kind_r or prog != prog_r:
            raise AssertionError("the traced runs took different schedules")
        rows = (w_f != w_r).flatten(1).any(1).nonzero().flatten().tolist()
        for b in rows:
            if prog[b] is None or prog[b][0] in cut:
                continue
            rid, t = prog[b]
            cut[rid] = t
            gap = float((pre_f[b] - pre_r[b]).abs().max()
                        / pre_r[b].abs().max().clamp(min=1e-30))
            limit = 1e-4 if kind == "spike counts" else 1.0 / 127 + 1e-5
            if gap > limit:
                raise AssertionError(
                    f"request {rid} token {t}: {kind} differ with values "
                    f"{gap:.3g} apart — not a rounding split")
            worst = max(worst, gap if kind == "spike counts" else 0.0)
    return cut, worst


def serve(cfg, params, requests, kernel, device="cuda", hooks=()):
    """One engine run; returns (streams, margins, engine, seconds,
    decode-only step times).  ``hooks`` (``LaunchCheck``, ``WireTrace``)
    watch the run."""
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    eng = ServingEngine(cfg, params, EngineConfig(
        num_slots=4, max_seq=256, page_size=16, attn_kernel=kernel),
        device=device)
    for rid, (prompt, new) in enumerate(requests):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
    out, steps = {}, []
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (
        lambda: None)
    patches = []
    for h in hooks:
        h.eng = eng
        patches.extend(h.patches())
    for p in patches:
        p.__enter__()
    try:
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
    finally:
        for p in reversed(patches):
            p.__exit__(None, None, None)
    alloc = eng.cache.allocator
    if alloc.pages_in_use or alloc.num_free != alloc.num_slots:
        raise AssertionError("pages still mapped after the run")
    return out, eng.margins, eng, secs, steps


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.cases import CASES, case_arrays
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params

    card = card_line()
    print(f"card: {card}", flush=True)

    t = time.perf_counter()
    logs = build.build()
    print(f"build: {sorted(build.SOURCES)} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

    cfg = get_config("qwen1.5-0.5b").replace(dtype=torch.float32)
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff,
            cfg.vocab, cfg.hnn_mode, cfg.codec) != (
            N_LAYERS, 1024, 16, 64, 2816, 151936, "hnn", "spike_fused"):
        raise AssertionError(f"unexpected serving config {cfg}")

    rng = np.random.RandomState(0)
    lens = rng.randint(16, 121, 8)
    requests = [(rng.randint(0, cfg.vocab, int(L)).tolist(), 32)
                for L in lens]

    max_err = 0.0
    for name in sorted(CASES):
        arrays, window, cap = case_arrays(name)
        for dt in (torch.float32, torch.bfloat16):
            e = compare_kernel(arrays, window, cap, dt)
            max_err = max(max_err, e)
            print(f"check paged_decode {name} {str(dt)[6:]}: max abs err "
                  f"{e:.3g}", flush=True)
    s_case = serve_case(cfg, [int(L) + 16 for L in lens[:4]])
    for dt in (torch.float32, torch.bfloat16):
        e = compare_kernel(s_case, 0, 0.0, dt)
        max_err = max(max_err, e)
        print(f"check paged_decode serve_shape {str(dt)[6:]}: max abs err "
              f"{e:.3g}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")

    # main path: HNN / spike_fused, kernel walk — timed and counted
    ops.reset_launch_counts()
    fused, _, eng_f, secs, steps = serve(cfg, params, requests, "fused")
    launches = ops.launch_counts()["paged_decode"]
    if launches != N_LAYERS * eng_f.decode_steps or launches == 0:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{eng_f.decode_steps} decode steps")
    for rid, (prompt, new) in enumerate(requests):
        toks = fused[rid]
        if len(toks) != new or not all(0 <= x < cfg.vocab for x in toks):
            raise AssertionError(f"request {rid}: bad stream {toks}")
    n_tok = sum(len(v) for v in fused.values())
    print(f"serve hnn/spike_fused fused: {n_tok} tokens in {secs:.3f} s = "
          f"{n_tok / secs:.1f} tok/s, {eng_f.decode_steps} decode steps, "
          f"median decode step {1e3 * np.median(steps):.3f} ms, "
          f"{launches} kernel launches", flush=True)

    # the reference walk and the kernel walk again, both traced at every
    # wire, the kernel walk with each launch checked on its live inputs
    ops.reset_launch_counts()
    tr_r = WireTrace(4)
    ref, ref_margins, _, secs_r, steps_r = serve(
        cfg, params, requests, "reference", hooks=(tr_r,))
    if ops.launch_counts()["paged_decode"] != 0:
        raise AssertionError("the reference walk launched the kernel")
    print(f"serve hnn/spike_fused reference (traced): "
          f"{n_tok / secs_r:.1f} tok/s, median decode step "
          f"{1e3 * np.median(steps_r):.3f} ms", flush=True)
    tr_f, check = WireTrace(4), LaunchCheck()
    traced, *_ = serve(cfg, params, requests, "fused", hooks=(tr_f, check))
    if traced != fused:
        raise AssertionError("two kernel-walk runs gave different streams")
    cut, worst = first_rounding_splits(tr_f, tr_r)
    compared, by_split, by_margin = check_streams(fused, ref, ref_margins,
                                                  cut)
    print(f"streams hnn/spike_fused: {check.launches} kernel launches "
          f"checked on live inputs ({check.flipped} wire values one step "
          f"from the plain version's); fused == reference on {compared} "
          f"of {n_tok} tokens: {by_split} requests compared up to the "
          f"first coded value that rounded the other way (values rounded "
          f"from within {worst:.2g} of each other), {by_margin} up to a "
          f"margin <= {MARGIN}", flush=True)

    # ANN mode (codec none): nothing rounds on a wire, so the streams
    # must agree wherever the margin allows
    cfg_ann = cfg.replace(hnn_mode="ann", codec="none")
    check = LaunchCheck()
    fused_a, *_ = serve(cfg_ann, params, requests, "fused", hooks=(check,))
    ref_a, ref_margins_a, *_ = serve(cfg_ann, params, requests, "reference")
    compared_a, _, by_margin_a = check_streams(fused_a, ref_a, ref_margins_a)
    print(f"streams ann/none: {check.launches} kernel launches checked; "
          f"fused == reference on {compared_a} of {n_tok} tokens "
          f"({by_margin_a} requests compared up to a margin <= {MARGIN})",
          flush=True)

    ms, plain_ms, lib_ms, bound_ms, bound_by = time_kernel(s_case, cfg)
    print(f"paged_decode at the serve shape: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by})", flush=True)
    print(json.dumps({"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:143",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
