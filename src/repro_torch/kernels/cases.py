"""Conformance cases for the port's kernels.

The same inputs check each plain version against the JAX package on the
CPU (``tests/test_torch_paged_decode.py``, ``test_torch_lif_encode.py``,
``test_torch_pack4.py``) and each CUDA kernel against its plain version
on the card (``chip_smoke.py``, ``tests/test_torch_gpu.py``), all drawn
from a numpy ``RandomState`` or built exactly:

* paged decode: random pools and well-formed compacted lists (distinct
  pool rows, ascending positions) with each slot's queries at its write
  frontier, K1 = 1 to 4 queries a slot (``verify_mha_k1_4`` is the
  speculative verify step's serve shape; ``gemma2_local_*``,
  ``granite_mqa_*``, ``qwen4b_mha_k1_4``, ``qwen2moe_mha_*`` and
  ``llama4_gqa_*`` the other registered configs' decode and verify
  shapes);
* ``lif_encode``: random activations, thresholds and scales; drives
  that land on and next to a half-integer tick count (where the IF
  encoder and the closed form part); zeros, -0.0, saturation and zero
  thresholds; the MoE family's widths (``moe_m{rows}_c{width}``);
* ``pack4`` / ``unpack4``: every byte value, and random 4-bit wires of
  ragged row counts; ``pack4_counts``: signed counts in {-T..T} of the
  same shapes; ``unpack4_decode``: the same bytes with log-scales of 0
  and seeded ones (``UNPACK4_LOG_SCALES``);
* the edges of the boundary kernels' vector layouts
  (``LIF_TAIL_CASES``, ``PACK4_TAIL_CASES``): channel counts that are
  no multiple of the vector width (odd ones among them), ragged ends,
  over 1, 4 and 257 rows, and more rows than one grid dimension holds;
* ``count_matmul``: counts spanning -T..T with all-zero rows and
  columns, random weights and positive scales, over ragged and serve
  shapes (``COUNT_MATMUL_SHAPES``) and the edges of each CUDA design
  (``COUNT_MATMUL_RAGGED_SHAPES``), with the agreement rule its checks
  share (``count_matmul_agrees``).
"""
from __future__ import annotations

import numpy as np
import torch


def rand_case(seed, B, K1, Hq, Hkv, dh, P_loc, psz, ppc, n_live=None,
              partial_last=False):
    """Numpy arrays ``(q, k_pool, v_pool, cl_page, cl_pos, qpos)``."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, K1, Hq, dh)).astype(np.float32)
    k_pool = rng.standard_normal((P_loc, psz, Hkv, dh)).astype(np.float32)
    v_pool = rng.standard_normal((P_loc, psz, Hkv, dh)).astype(np.float32)
    clp = np.full((B, ppc), -1, np.int32)
    clo = np.full((B, ppc), -1, np.int32)
    qpos = np.zeros((B, K1), np.int32)
    for b in range(B):
        n = rng.randint(1, ppc + 1) if n_live is None else n_live
        if n:
            clp[b, :n] = rng.choice(P_loc, n, replace=False)
            clo[b, :n] = np.sort(rng.choice(ppc * 4, n, replace=False)) * psz
            last = int(clo[b, n - 1])
            off = rng.randint(0, psz) if partial_last else psz - 1
            qpos[b] = last + max(off, K1 - 1) - np.arange(K1)[::-1]
    return q, k_pool, v_pool, clp, clo, qpos


#: name -> (rand_case kwargs, window, cap, slot rows emptied to all -1)
CASES = {
    "gqa": (dict(seed=0, B=5, K1=1, Hq=4, Hkv=2, dh=16, P_loc=12, psz=8,
                 ppc=4), 0, 0.0, ()),
    "window_softcap": (dict(seed=1, B=4, K1=2, Hq=4, Hkv=4, dh=16,
                            P_loc=10, psz=8, ppc=4), 16, 8.0, ()),
    "k1_3": (dict(seed=2, B=5, K1=3, Hq=8, Hkv=2, dh=16, P_loc=12, psz=8,
                  ppc=4), 0, 0.0, ()),
    "partial_last_page": (dict(seed=3, B=6, K1=1, Hq=4, Hkv=4, dh=16,
                               P_loc=9, psz=8, ppc=3, partial_last=True),
                          0, 0.0, ()),
    "pool_much_larger": (dict(seed=4, B=3, K1=2, Hq=4, Hkv=4, dh=16,
                              P_loc=128, psz=8, ppc=2, n_live=1),
                         0, 0.0, ()),
    "evicted_row": (dict(seed=5, B=3, K1=2, Hq=4, Hkv=4, dh=16, P_loc=8,
                         psz=8, ppc=3), 0, 0.0, (1,)),
    # the serve shape's list length (16 entries): every entry a live page,
    # and six live pages before a tail of ten -1 entries, as a slot of
    # ~88 tokens has them
    "full_list": (dict(seed=6, B=3, K1=1, Hq=4, Hkv=2, dh=16, P_loc=20,
                       psz=8, ppc=16, n_live=16), 0, 0.0, ()),
    "minus_one_tail": (dict(seed=7, B=4, K1=1, Hq=4, Hkv=4, dh=16,
                            P_loc=32, psz=8, ppc=16, n_live=6), 0, 0.0, ()),
    # the speculative verify step's serve shape: four slots of mixed
    # lengths, K1 = spec_k + 1 = 4 queries each, the full-width model's
    # 16 MHA heads of 64 over pages of 16
    "verify_mha_k1_4": (dict(seed=8, B=4, K1=4, Hq=16, Hkv=16, dh=64,
                             P_loc=64, psz=16, ppc=16), 0, 0.0, ()),
    # the other registered configs' decode (K1 = 1) and verify (K1 = 4)
    # shapes over pages of 16: gemma2-2b's local layers (8 heads on 4 kv
    # heads of 256, window 4096, softcap 50) with lists whose positions
    # run past 4096, so the window masks whole pages; granite-20b's MQA
    # (48 heads on one kv head of 128); qwen1.5-4b's 20 MHA heads of 128
    "gemma2_local_k1": (dict(seed=10, B=4, K1=1, Hq=8, Hkv=4, dh=256,
                             P_loc=96, psz=16, ppc=80), 4096, 50.0, ()),
    "gemma2_local_k1_4": (dict(seed=11, B=4, K1=4, Hq=8, Hkv=4, dh=256,
                               P_loc=96, psz=16, ppc=80), 4096, 50.0, ()),
    "granite_mqa_k1": (dict(seed=12, B=4, K1=1, Hq=48, Hkv=1, dh=128,
                            P_loc=64, psz=16, ppc=16), 0, 0.0, ()),
    "granite_mqa_k1_4": (dict(seed=13, B=4, K1=4, Hq=48, Hkv=1, dh=128,
                              P_loc=64, psz=16, ppc=16), 0, 0.0, ()),
    "qwen4b_mha_k1_4": (dict(seed=14, B=4, K1=4, Hq=20, Hkv=20, dh=128,
                             P_loc=64, psz=16, ppc=16), 0, 0.0, ()),
    # the MoE family's attention: qwen2-moe-a2.7b's 16 MHA heads of 128
    # (served in float32) and llama4-maverick's 40 heads on 8 kv heads
    # of 128 (5 query heads a kv head, 20 rows in a verify step; served
    # in bfloat16), at K1 = 1 and 4
    "qwen2moe_mha_k1": (dict(seed=15, B=4, K1=1, Hq=16, Hkv=16, dh=128,
                             P_loc=64, psz=16, ppc=16), 0, 0.0, ()),
    "qwen2moe_mha_k1_4": (dict(seed=16, B=4, K1=4, Hq=16, Hkv=16, dh=128,
                               P_loc=64, psz=16, ppc=16), 0, 0.0, ()),
    "llama4_gqa_k1": (dict(seed=17, B=4, K1=1, Hq=40, Hkv=8, dh=128,
                           P_loc=64, psz=16, ppc=16), 0, 0.0, ()),
    "llama4_gqa_k1_4": (dict(seed=18, B=4, K1=4, Hq=40, Hkv=8, dh=128,
                             P_loc=64, psz=16, ppc=16), 0, 0.0, ()),
    # jamba-1.5-large's attention layer: 64 heads on 8 kv heads of 128
    # (8 query rows a kv head), served in bfloat16; K1 = 1 only, since
    # a recurrent family serves with spec_k = 0
    "jamba_gqa_k1": (dict(seed=19, B=4, K1=1, Hq=64, Hkv=8, dh=128,
                          P_loc=64, psz=16, ppc=16), 0, 0.0, ()),
}


#: the cases of the configs other than the main path's (their decode
#: and verify shapes)
ARCH_CASES = ("gemma2_local_k1", "gemma2_local_k1_4", "granite_mqa_k1",
              "granite_mqa_k1_4", "qwen4b_mha_k1_4", "qwen2moe_mha_k1",
              "qwen2moe_mha_k1_4", "llama4_gqa_k1", "llama4_gqa_k1_4",
              "jamba_gqa_k1")
#: each MoE case's pool dtype on its served path (the card's checks run
#: every case in both)
MOE_CASE_POOL = {"qwen2moe_mha_k1": "float32", "qwen2moe_mha_k1_4": "float32",
                 "llama4_gqa_k1": "bfloat16", "llama4_gqa_k1_4": "bfloat16"}
#: the pool dtype of every case served in another dtype than float32
CASE_POOL = {**MOE_CASE_POOL, "jamba_gqa_k1": "bfloat16"}


def case_arrays(name):
    """``(arrays, window, cap)`` of a named case, evicted rows applied."""
    kw, window, cap, dead = CASES[name]
    q, kp, vp, clp, clo, qpos = rand_case(**kw)
    for b in dead:
        clp[b] = -1
        clo[b] = -1
    return (q, kp, vp, clp, clo, qpos), window, cap


def to_tensors(arrays, device, pool_dtype=torch.float32):
    """Explicit device copies; pools cast to ``pool_dtype``."""
    q, kp, vp, clp, clo, qpos = arrays
    t = lambda a, dt=None: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    return (t(q), t(kp, pool_dtype), t(vp, pool_dtype), t(clp), t(clo),
            t(qpos))


# ---------------------------------------------------------------------------
# lif_encode
# ---------------------------------------------------------------------------

LIF_CASES = ("random_t15", "random_t7", "random_bf16", "half_ticks_t15",
             "half_ticks_t7", "edges", "moe_m4_c2048", "moe_m4_c5120",
             "rec_m4_c512", "rec_m4_c768", "rec_m4_c8192")
#: the recurrent families' boundary widths at four decode rows:
#: rwkv-paper's d_model 512, xlstm-125m's 768, jamba-1.5-large's 8192
#: (``rec_m4_c*`` of ``LIF_CASES`` and, packed, of ``PACK4_CASES``;
#: random activations at T = 15)
REC_WIDTHS = (512, 768, 8192)
#: the MoE family's boundary widths (qwen2-moe-a2.7b's d_model 2048,
#: llama4-maverick's 5120) at a prefill's 256 rows (their decode rows,
#: four slots, are ``moe_m4_c*`` of ``LIF_CASES``): random activations
#: at T = 15, checked on the card only
LIF_MOE_PREFILL_CASES = ("moe_m256_c2048", "moe_m256_c5120")
#: rows and channels at the edges of the kernels' vector layouts (a
#: lif_encode thread takes two channels, a pack thread 16 bytes):
#: random activations at T = 15
TAIL_ROWS = (1, 4, 257)
TAIL_CHANNELS = (1, 2, 6, 8, 10, 17, 1030)
#: and 70000 rows of 2, more than the 65535 blocks of a grid's rows
LIF_TAIL_CASES = tuple(f"tail_m{M}_c{C}" for M in TAIL_ROWS
                       for C in TAIL_CHANNELS) + ("tail_m70000_c2",)


def _half_ticks(T, scales):
    """x whose drive x/scale sits on (k + 1/2)/T, k = 0..T-1, and one
    float either side of it, both signs: 6 rows; the columns are the T
    ticks at each scale in turn.  Returns (x [6, T*len], scale)."""
    d = ((np.arange(T) + 0.5) / T).astype(np.float32)
    scale = np.repeat(np.float32(scales), T)
    x = (np.tile(d, len(scales)) * scale).astype(np.float32)
    rows = [x, np.nextafter(x, np.float32(np.inf)),
            np.nextafter(x, np.float32(0))]
    return np.stack(rows + [-r for r in rows]), scale


def _edges():
    """Zeros, -0.0, saturation (|x| >= scale), drives far past it, a
    zero threshold, and values at, below and above the threshold."""
    scale = np.float32([1.0, 1.0, 0.5, 2.0, 1.0, 1.0, 3.0, 0.25])
    theta = np.float32([0.0, 0.1, 0.0, 0.5, 1e-3, 0.0, 0.2, 0.0])
    rows = [np.zeros(8), -np.zeros(8), scale, -scale, 2 * scale,
            -3 * scale, np.full(8, 1e30), theta, -theta, 0.5 * theta,
            np.nextafter(theta, np.float32(np.inf)), np.full(8, 1e-30)]
    return np.stack(rows).astype(np.float32), theta, scale


def lif_case(name):
    """``(x f32 [M, C], theta f32 [C], scale f32 [C], T, x dtype name)``
    of a named ``lif_encode`` case; a bf16 case's x holds bf16 values."""
    if name.startswith("random"):
        seed, M, C, T = {"random_t15": (0, 8, 128, 15),
                         "random_t7": (1, 33, 100, 7),
                         "random_bf16": (2, 16, 64, 15)}[name]
        rng = np.random.RandomState(seed)
        x = (rng.standard_normal((M, C)) * 1.5).astype(np.float32)
        theta = rng.uniform(0.0, 0.3, C).astype(np.float32)
        scale = np.exp(rng.uniform(-1.0, 1.0, C)).astype(np.float32)
        if name == "random_bf16":
            x = torch.tensor(x).to(torch.bfloat16).float().numpy()
            return x, theta, scale, T, "bfloat16"
        return x, theta, scale, T, "float32"
    if name.startswith(("tail_", "moe_", "rec_")):
        M, C = (int(v) for v in name.split("_m", 1)[1].split("_c"))
        rng = np.random.RandomState(M * 10007 + C)
        x = (rng.standard_normal((M, C)) * 1.5).astype(np.float32)
        theta = rng.uniform(0.0, 0.3, C).astype(np.float32)
        scale = np.exp(rng.uniform(-1.0, 1.0, C)).astype(np.float32)
        return x, theta, scale, 15, "float32"
    if name.startswith("half_ticks"):
        T = int(name[len("half_ticks_t"):])
        x, scale = _half_ticks(T, [1.0, 0.75, 2.5])
        return x, np.zeros_like(scale), scale, T, "float32"
    if name == "edges":
        x, theta, scale = _edges()
        return x, theta, scale, 15, "float32"
    raise KeyError(name)


def lif_tensors(name, device):
    """A ``lif_encode`` case as tensors ``(x, theta, scale, T)``."""
    x, theta, scale, T, dt = lif_case(name)
    return (torch.tensor(x, dtype=getattr(torch, dt), device=device),
            torch.tensor(theta, device=device),
            torch.tensor(scale, device=device), T)


# ---------------------------------------------------------------------------
# pack4 / unpack4
# ---------------------------------------------------------------------------

PACK4_CASES = ("all_bytes", "wire_ragged", "wire_row", "moe_m4_c1024",
               "moe_m4_c2048", "moe_m4_c2560", "moe_m4_c5120",
               "rec_m4_c256", "rec_m4_c384", "rec_m4_c4096", "rec_m4_c512",
               "rec_m4_c768", "rec_m4_c8192")
#: the vector layout's edges for the packs (16 bytes in a thread): the
#: even channel counts of ``TAIL_CHANNELS``
PACK4_TAIL_CASES = tuple(f"tail_m{M}_c{C}" for M in TAIL_ROWS
                         for C in TAIL_CHANNELS if C % 2 == 0)


def pack4_case(name):
    """uint8 ``[M, C]`` (C even) of a named case: every byte value as 8
    rows of 32 (to pack and to unpack), random 4-bit wires — the biased
    counts of ``spike_pack4`` — over 37 rows of 18 or 1 row of 2048, or
    (``tail_m{M}_c{C}``) random bytes of any value.  ``moe_m4_c{C}``: a
    random 4-bit wire of four decode rows; packed, the MoE family's
    widths 2048 and 5120 (C), and as packed bytes, unpacked to them
    (C = 1024, 2560); ``rec_m4_c{C}`` likewise at the recurrent
    families' widths 512, 768 and 8192 (packed bytes: C = 256, 384,
    4096)."""
    if name.startswith(("moe_", "rec_")):
        M, C = (int(v) for v in name[len("moe_m"):].split("_c"))
        return np.random.RandomState(M * 131 + C).randint(
            0, 15, (M, C)).astype(np.uint8)
    if name == "all_bytes":
        return np.arange(256, dtype=np.uint8).reshape(8, 32)
    if name.startswith("tail_"):
        M, C = (int(v) for v in name[len("tail_m"):].split("_c"))
        rng = np.random.RandomState(M * 10007 + C)
        return rng.randint(0, 256, (M, C)).astype(np.uint8)
    shape = {"wire_ragged": (37, 18), "wire_row": (1, 2048)}[name]
    return np.random.RandomState(3).randint(0, 15, shape).astype(np.uint8)


def pack4_counts_case(name, T):
    """float32 signed counts in {-T..T} of the shape of ``pack4_case(name)``
    (exact in bf16 too)."""
    shape = pack4_case(name).shape
    rng = np.random.RandomState(shape[0] * 131 + shape[1] + T)
    return rng.randint(-T, T + 1, shape).astype(np.float32)


#: the log-scales a packed wire's decode is checked at: 0 (the seeded
#: init's, a decode factor of exactly 1/T) and random ones
UNPACK4_LOG_SCALES = ("zero", "seeded")


def unpack4_log_scale(kind, C):
    """float32 ``log_scale`` [C] of an ``UNPACK4_LOG_SCALES`` kind: zeros,
    or uniform in [-1, 1] seeded by C."""
    if kind == "zero":
        return np.zeros(C, np.float32)
    if kind == "seeded":
        return np.random.RandomState(C + 17).uniform(-1.0, 1.0, C).astype(
            np.float32)
    raise KeyError(kind)


# ---------------------------------------------------------------------------
# count_matmul
# ---------------------------------------------------------------------------

#: (M, K, N) of the card's conformance sweep: decode rows (1, 4), a ragged
#: batch (33) and a prefill (256); K and N ragged and at the serve widths
COUNT_MATMUL_SHAPES = tuple((M, K, N) for M in (1, 4, 33, 256)
                            for K in (128, 300, 1024)
                            for N in (200, 1024, 2816))
#: (M, K, N) that reach each design of the CUDA kernel at its edges:
#: every decode row count 1..16 (the W-streaming design's three row
#: buckets) and 17 (the first of the tiled designs), each at a ragged K
#: and N whose rows 16-byte loads cannot take (300, 130) and at K and N
#: they can, ragged at the tile edge (1024, 1000); then prefill rows at a
#: ragged K and N (77: no vector load of the scales either)
COUNT_MATMUL_RAGGED_SHAPES = tuple(
    (M, K, N) for M in range(1, 18) for K, N in ((300, 130), (1024, 1000))
) + ((256, 77, 200), (256, 1000, 130), (256, 1024, 1000))
#: rtol = atol of a float32 result (``tests/test_kernels.py``)
COUNT_MATMUL_TOL = 2e-5


def count_matmul_case(M, K, N, T, seed=0):
    """``(counts int8 [M, K], w f32 [K, N], scale f32 [K])``: counts
    uniform in -T..T with every third row (from the second) and every
    fifth column (from the first) all zero; w normal with the standard
    deviation 0.02 of the model's projections at init
    (``models.params.pdef``), so the sums have the magnitudes of served
    traffic; scale in [0.5, 2)."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(-T, T + 1, (M, K)).astype(np.int8)
    counts[1::3] = 0
    counts[:, ::5] = 0
    w = (0.02 * rng.standard_normal((K, N))).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, K).astype(np.float32)
    return counts, w, scale


def count_matmul_agrees(got, want32, tol=COUNT_MATMUL_TOL):
    """Whether ``got`` (f32 or bf16) agrees with a float32 sum ``want32``
    of the same product: f32 within rtol = atol = ``tol``; bf16 the
    rounding of some f32 value within that tolerance of ``want32`` — the
    same value, or one bf16 step apart where the two f32 sums round
    differently, and more only where the tolerance itself spans several
    bf16 steps (sums that cancel to within a few atol of 0).  Returns
    ``(ok, steps)``: for bf16, the largest number of bf16 steps between
    ``got`` and ``bf16(want32)`` among the outputs whose tolerance is
    finer than half a bf16 step (at most 1 for a right kernel), else
    0."""
    want32 = want32.float()
    slack = tol + tol * want32.abs()
    if got.dtype == torch.float32:
        return bool(((got - want32).abs() <= slack).all()), 0
    lo, hi = (want32 - slack).to(got.dtype), (want32 + slack).to(got.dtype)
    ok = bool(((got >= lo) & (got <= hi)).all())
    _, e = torch.frexp(want32)
    fine = (slack < torch.ldexp(torch.full_like(want32, 0.5), e - 8)) & (
        want32 != 0)
    return ok, bf16_steps(got[fine], want32.to(got.dtype)[fine])


def bf16_steps(a, b):
    """The largest number of representable bf16 values between ``a`` and
    ``b`` (bf16 tensors of one shape), counted across 0."""
    def ordinal(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    if a.numel() == 0:
        return 0
    return int((ordinal(a) - ordinal(b)).abs().max())
