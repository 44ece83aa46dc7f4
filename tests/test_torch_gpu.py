"""The port's CUDA kernel and engine on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a
CUDA kernel has no CPU mode.  On the GPU machine run
``python -m pytest -m gpu tests/test_torch_gpu.py``.  The file imports
no JAX, so it collects where only PyTorch is installed.

* The paged-decode kernel against its plain version on the same CUDA
  inputs, for every conformance case, f32 and bf16 pools, with and
  without the int8 wire epilogue (o and lse within 2e-5; the wire within
  one quantization step).
* The ``lif_encode`` (float32 and bf16 compute types), ``pack4`` and
  ``unpack4`` kernels against their plain versions on every conformance
  case, exactly (integer outputs).
* ``lif_encode`` with its decode epilogue (counts and decoded values)
  and the fused ``pack4_counts`` against their plain versions, exactly,
  on every conformance case and on the edges of the kernels' vector
  layout (``LIF_TAIL_CASES``, ``PACK4_TAIL_CASES``, and buffers not
  aligned for the vector accesses), where today's ``ops.lif_encode`` and
  ``ops.pack4`` are held to their plain versions too; the codec's
  ``encode_decode`` equals ``encode`` then ``decode`` on the card.
* The redesigned ``unpack4`` and the fused ``unpack4_decode`` (unpack,
  unbias and rate decode, f32 and bf16) against their plain versions,
  exactly, on every conformance case, the vector layout's edges and
  buffers not aligned for the vector accesses; the wrapper refuses a
  CPU tensor, a wrong dtype and a decode factor of the wrong length;
  the codec's ``unpack4_decode`` is one launch on the card and equals
  the unpack, ``wire_u8_to_counts`` and ``decode``.
* The ``count_matmul`` kernel against its plain version's float32 sum on
  its conformance sweep and on the edges of each of its designs
  (``COUNT_MATMUL_RAGGED_SHAPES``: every row count 1..17, ragged K and
  N, prefill rows) (``count_matmul_agrees``: float32 results within
  rtol = atol = 2e-5, bf16 results the rounding of a float32 sum within
  that), TF32 off.
* Both redesigned kernels give the same bits on two launches with the
  same inputs (no atomics; fixed reduction orders), at the serve shapes;
  paged decode also against its plain version there, and with bf16 rows
  that are no multiple of 16 bytes (4-byte copies).
* The reduced model served on the card: kernel walk and reference walk
  give the same greedy streams under the margin rule, and the kernel
  ran once per layer per decode step.  In bfloat16 (the configs'
  default dtype) the kernel walk serves with the same launch count and
  frees every page; its streams are not compared, since bf16 rounding
  ties flip argmax.  With the ``spike`` and ``spike_pack4`` codecs the
  boundary kernels run once per coded boundary site; in bf16 under
  ``spike`` with the count matmul shadow on, ``count_matmul`` runs five
  times per layer per decode step and prefill and the streams equal
  those served without it.
* Paged decode at the speculative verify step's serve shape (K1 = 4,
  16 heads of 64, an allocator's lists) against its plain version.
* Paged decode at every decode (K1 = 1) and verify (K1 = 4) shape of
  the four registered configs (gemma2-2b's 8 heads on 4 kv heads of
  256 with its window and softcap, granite-20b's 48 heads on one kv
  head, qwen1.5-4b's 20 heads of 128), f32 and bf16 pools, against its
  plain version and bit for bit on a second launch, as on the new
  conformance cases; every such shape has a launch plan (granite-20b's
  f32 verify step among them, 192 query rows a kv head), and a shape
  that fits no block is refused with ``ValueError`` before any launch.
* The dense per-slot decode of ``launch.serve`` on the card: the
  quickstart's prefill and decode steps equal the plain path's on the
  CPU.
* Speculative decoding with the n-gram drafter on the card: launch
  counts per verify step, every page free, and in ANN mode the
  ``spec_k=0`` streams under the margin rule.  Sampled serving
  (temperature, top-k, top-p) repeats under one seed, and its greedy
  requests keep the greedy streams.
* The dispatch/commit pipeline on the card: ``async_depth=1`` serves the
  ``async_depth=0`` streams with the same launches per step and prefill,
  every page free and the limbo empty; with the card held busy ahead of
  each dispatch, a dispatch makes no synchronizing call (sync debug mode
  "error") and returns before its step has run, garbage written into the
  host feeds right after it changes nothing, and a commit reads its
  tokens only once the step's event has been reached.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    ARCH_CASES, CASES, COUNT_MATMUL_RAGGED_SHAPES, COUNT_MATMUL_SHAPES,
    LIF_CASES, LIF_TAIL_CASES, PACK4_CASES, PACK4_TAIL_CASES, UNPACK4_LOG_SCALES,
    case_arrays, count_matmul_agrees, count_matmul_case, lif_tensors,
    pack4_case, pack4_counts_case, rand_case, to_tensors, unpack4_log_scale)
from repro_torch.kernels.count_matmul import count_matmul_plain  # noqa: E402
from repro_torch.kernels.lif_encode import lif_encode_plain  # noqa: E402
from repro_torch.kernels import pack4 as PK  # noqa: E402
from repro_torch.kernels.pack4 import (  # noqa: E402
    pack4_counts_plain, pack4_plain, unpack4_decode_plain, unpack4_plain)
from repro_torch.kernels.paged_decode import paged_decode_plain  # noqa: E402

pytestmark = pytest.mark.gpu
MARGIN = 1e-4


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(name, pool_dtype):
    _require_cuda()
    arrays, window, cap = case_arrays(name)
    ts = to_tensors(arrays, "cuda", getattr(torch, pool_dtype))
    o, lse = ops.paged_flash_decode(*ts, window=window, cap=cap)
    po, plse = paged_decode_plain(*ts, window=window, cap=cap)
    torch.testing.assert_close(o, po, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
    w, s, lse_w = ops.paged_flash_decode(*ts, window=window, cap=cap,
                                         encode_wire=True)
    pw, ps, _ = paged_decode_plain(*ts, window=window, cap=cap,
                                   encode_wire=True)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=0.0)
    assert torch.equal(lse_w, lse)
    assert bool(((w.float() * s - pw.float() * ps).abs()
                 <= ps + 1e-6).all())


@pytest.mark.parametrize("name", LIF_CASES)
def test_lif_encode_matches_plain_on_card(name):
    _require_cuda()
    x, theta, scale, T = lif_tensors(name, "cuda")
    before = ops.launch_counts()["lif_encode"]
    got = ops.lif_encode(x, theta, scale, T=T)
    assert ops.launch_counts()["lif_encode"] == before + 1
    assert torch.equal(got, lif_encode_plain(x, theta, scale, T=T))


@pytest.mark.parametrize("name", LIF_CASES)
def test_lif_encode_bf16_mode_matches_plain_on_card(name):
    _require_cuda()
    x, theta, scale, T = lif_tensors(name, "cuda")
    bf = torch.bfloat16
    got = ops.lif_encode(x, theta, scale, T=T, math_dtype=bf)
    assert torch.equal(got, lif_encode_plain(x, theta, scale, T=T,
                                             math_dtype=bf))


@pytest.mark.parametrize("T", [7, 15])
@pytest.mark.parametrize("M", sorted({m for m, _, _ in COUNT_MATMUL_SHAPES}))
def test_count_matmul_matches_plain_on_card(M, T):
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    for m, K, N in COUNT_MATMUL_SHAPES:
        if m != M:
            continue
        c, w, sc = (torch.tensor(a, device="cuda") for a in
                    count_matmul_case(M, K, N, T, seed=M + K + N + T))
        for wt in (w, w.to(torch.bfloat16)):
            want = count_matmul_plain(c, wt, sc, T=T,
                                      out_dtype=torch.float32)
            for od in (torch.float32, torch.bfloat16):
                before = ops.launch_counts()["count_matmul"]
                got = ops.count_matmul(c, wt, sc, T=T, out_dtype=od)
                assert ops.launch_counts()["count_matmul"] == before + 1
                assert got.dtype == od and got.shape == (M, N)
                assert count_matmul_agrees(got, want)[0], (K, N, wt.dtype,
                                                           od)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_count_matmul_design_edges_on_card(w_dtype):
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    for M, K, N in COUNT_MATMUL_RAGGED_SHAPES:
        c, w, sc = (torch.tensor(a, device="cuda") for a in
                    count_matmul_case(M, K, N, 15, seed=M * K + N))
        wt = w.to(getattr(torch, w_dtype))
        want = count_matmul_plain(c, wt, sc, T=15, out_dtype=torch.float32)
        for od in (torch.float32, torch.bfloat16):
            got = ops.count_matmul(c, wt, sc, T=15, out_dtype=od)
            assert got.dtype == od and got.shape == (M, N)
            assert count_matmul_agrees(got, want)[0], (M, K, N, w_dtype, od)


@pytest.mark.parametrize("M,N", [(4, 2816), (4, 1024), (256, 2816),
                                 (256, 1024)])
def test_count_matmul_repeats_bit_for_bit_on_card(M, N):
    _require_cuda()
    c, w, sc = (torch.tensor(a, device="cuda") for a in
                count_matmul_case(M, 1024, N, 15, seed=M + N))
    wt = w.to(torch.bfloat16)
    for od in (torch.float32, torch.bfloat16):
        a = ops.count_matmul(c, wt, sc, T=15, out_dtype=od)
        b = ops.count_matmul(c, wt, sc, T=15, out_dtype=od)
        assert torch.equal(a, b)


@pytest.mark.parametrize("K1", [1, 4])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_live", [6, 16])
def test_paged_decode_serve_shape_on_card(n_live, pool_dtype, K1):
    """The serve shape (16 heads of 64, pages of 16, 16 list entries a
    slot), a decode step (K1 = 1) or a speculative verify step (K1 = 4):
    six live pages before a -1 tail, or every entry live; against the
    plain version, wire off and on, and bit for bit on a second
    launch."""
    _require_cuda()
    arrays = rand_case(seed=n_live, B=4, K1=K1, Hq=16, Hkv=16, dh=64,
                       P_loc=64, psz=16, ppc=16, n_live=n_live)
    ts = to_tensors(arrays, "cuda", getattr(torch, pool_dtype))
    o, lse = ops.paged_flash_decode(*ts)
    po, plse = paged_decode_plain(*ts)
    torch.testing.assert_close(o, po, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
    o2, lse2 = ops.paged_flash_decode(*ts)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    w, s, lse_w = ops.paged_flash_decode(*ts, encode_wire=True)
    pw, ps, _ = paged_decode_plain(*ts, encode_wire=True)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=0.0)
    assert int((w.int() - pw.int()).abs().max()) <= 1
    w2, s2, lse_w2 = ops.paged_flash_decode(*ts, encode_wire=True)
    assert torch.equal(w, w2) and torch.equal(s, s2)
    assert torch.equal(lse_w, lse) and torch.equal(lse_w2, lse)


def test_paged_decode_unaligned_rows_on_card():
    """bf16 rows of 12 values (24 bytes) take 4-byte copies, not 16."""
    _require_cuda()
    arrays = rand_case(seed=9, B=3, K1=2, Hq=4, Hkv=2, dh=12, P_loc=16,
                       psz=8, ppc=6)
    ts = to_tensors(arrays, "cuda", torch.bfloat16)
    for wire in (False, True):
        got = ops.paged_flash_decode(*ts, encode_wire=wire)
        want = paged_decode_plain(*ts, encode_wire=wire)
        if wire:
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0.0)
            assert int((got[0].int() - want[0].int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(got[0], want[0], rtol=2e-5,
                                       atol=2e-5)
        torch.testing.assert_close(got[-1], want[-1], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", PACK4_CASES)
def test_pack4_unpack4_match_plain_on_card(name):
    _require_cuda()
    v = torch.tensor(pack4_case(name), device="cuda")
    packed = ops.pack4(v)
    assert torch.equal(packed, pack4_plain(v))
    assert torch.equal(ops.unpack4(v), unpack4_plain(v))
    assert torch.equal(ops.unpack4(packed), unpack4_plain(packed))


@pytest.mark.parametrize("codec", ["spike", "spike_pack4"])
def test_engine_on_card_boundary_kernels(codec):
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = reduced(get_config("qwen1.5-0.5b")).replace(dtype=torch.float32,
                                                      codec=codec)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")
    rng = np.random.RandomState(2)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, L).tolist(),
                    max_new_tokens=6)
            for i, L in enumerate(rng.randint(1, 60, 5))]
    ops.reset_launch_counts()
    eng = ServingEngine(cfg, params, EngineConfig(num_slots=2, max_seq=64,
                                                  page_size=8))
    out = eng.run(reqs)
    n = ops.launch_counts()
    L, steps, pre = cfg.n_layers, eng.decode_steps, eng.prefills
    if codec == "spike":
        want = {"lif_encode": 4 * L * (steps + pre), "pack4": 0}
    else:
        want = {"lif_encode": 0, "pack4": L * (2 * steps + 4 * pre)}
    assert steps > 0 and pre == len(reqs)
    assert n["lif_encode"] == want["lif_encode"]
    assert n["pack4"] == n["unpack4"] == want["pack4"]
    assert eng.cache.allocator.pages_in_use == 0
    assert all(len(out[r.rid]) == 6 for r in reqs)


def test_engine_on_card_fused_matches_reference():
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = reduced(get_config("qwen1.5-0.5b")).replace(dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, L).tolist(),
                    max_new_tokens=8)
            for i, L in enumerate(rng.randint(1, 60, 6))]
    runs = {}
    for kernel in ("fused", "reference"):
        ops.reset_launch_counts()
        eng = ServingEngine(cfg, params, EngineConfig(
            num_slots=3, max_seq=64, page_size=8, attn_kernel=kernel))
        runs[kernel] = (eng.run(reqs), eng.margins)
        launches = ops.launch_counts()["paged_decode"]
        want = cfg.n_layers * eng.decode_steps if kernel == "fused" else 0
        assert launches == want
        assert eng.cache.allocator.pages_in_use == 0
    (fused, _), (ref, margins) = runs["fused"], runs["reference"]
    for rid in ref:
        for t, (a, b) in enumerate(zip(ref[rid], fused[rid])):
            if margins[rid][t] <= MARGIN:
                break
            assert a == b, (rid, t)


def test_engine_on_card_bf16_serves():
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = reduced(get_config("qwen1.5-0.5b"))
    assert cfg.dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, L).tolist(),
                    max_new_tokens=6)
            for i, L in enumerate(rng.randint(1, 60, 5))]
    ops.reset_launch_counts()
    eng = ServingEngine(cfg, params, EngineConfig(num_slots=2, max_seq=64,
                                                  page_size=8))
    out = eng.run(reqs)
    assert ops.launch_counts()["paged_decode"] == (cfg.n_layers
                                                   * eng.decode_steps) > 0
    assert eng.cache.buffers["pos0"]["kv"]["k"].dtype == torch.bfloat16
    assert eng.cache.allocator.pages_in_use == 0
    for r in reqs:
        assert len(out[r.rid]) == 6
        assert all(0 <= t < cfg.vocab for t in out[r.rid])


def test_engine_on_card_bf16_spike_count_matmul_shadow():
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = reduced(get_config("qwen1.5-0.5b")).replace(codec="spike")
    assert cfg.dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, cfg.vocab, L).tolist(), 6)
            for L in rng.randint(1, 60, 5)]
    outs = []
    for shadow in (False, True):
        ops.reset_launch_counts()
        eng = ServingEngine(cfg, params, EngineConfig(num_slots=2,
                                                      max_seq=64,
                                                      page_size=8))
        eng.ctx = eng.ctx.with_(count_matmul_shadow=shadow)
        outs.append(eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                             for i, (p, m) in enumerate(reqs)]))
        n = ops.launch_counts()
        L, steps, pre = cfg.n_layers, eng.decode_steps, eng.prefills
        assert n["lif_encode"] == 4 * L * (steps + pre) > 0
        assert n["count_matmul"] == (5 * L * (steps + pre) if shadow else 0)
        assert eng.cache.allocator.pages_in_use == 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LIF_CASES + LIF_TAIL_CASES)
def test_lif_encode_decode_epilogue_matches_plain_on_card(name, x_dtype):
    """Counts and decoded values of one launch, both compute types, equal
    to the plain version's; one launch counted."""
    _require_cuda()
    x, theta, scale, T = lif_tensors(name, "cuda")
    x = x.to(getattr(torch, x_dtype))
    ds = (scale.to(x.dtype) / T).float()
    for md in (torch.float32, torch.bfloat16):
        before = ops.launch_counts()["lif_encode"]
        counts, dec = ops.lif_encode(x, theta, scale, T=T, math_dtype=md,
                                     decode_scale=ds)
        assert ops.launch_counts()["lif_encode"] == before + 1
        want_c, want_d = lif_encode_plain(x, theta, scale, T=T,
                                          math_dtype=md, decode_scale=ds)
        assert dec.dtype == x.dtype and dec.shape == x.shape
        assert torch.equal(counts, want_c) and torch.equal(dec, want_d)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LIF_TAIL_CASES)
def test_lif_encode_tails_match_plain_on_card(name, x_dtype):
    _require_cuda()
    x, theta, scale, T = lif_tensors(name, "cuda")
    x = x.to(getattr(torch, x_dtype))
    for md in (torch.float32, torch.bfloat16):
        got = ops.lif_encode(x, theta, scale, T=T, math_dtype=md)
        assert torch.equal(got, lif_encode_plain(x, theta, scale, T=T,
                                                 math_dtype=md))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_boundary_kernels_on_unaligned_rows_on_card(x_dtype):
    """Contiguous views that start 2 or 4 bytes into their buffers (a
    width the vector layout takes when aligned): the scalar paths."""
    _require_cuda()
    dt = getattr(torch, x_dtype)
    x, theta, scale, T = lif_tensors("tail_m257_c8", "cuda")
    buf = torch.empty(x.numel() + 1, dtype=dt, device="cuda")
    xv = buf[1:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0 and xv.is_contiguous()
    ds = (scale.to(dt) / T).float()
    got = ops.lif_encode(xv, theta, scale, T=T, math_dtype=dt,
                         decode_scale=ds)
    want = lif_encode_plain(xv, theta, scale, T=T, math_dtype=dt,
                            decode_scale=ds)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    c = torch.tensor(pack4_counts_case("tail_m257_c10", 7), device="cuda")
    cbuf = torch.empty(c.numel() + 1, dtype=dt, device="cuda")
    cv = cbuf[1:].view(c.shape)
    cv.copy_(c)
    assert torch.equal(ops.pack4_counts(cv, 7), pack4_counts_plain(cv, 7))
    w = torch.tensor(pack4_case("tail_m257_c10"), device="cuda")
    wbuf = torch.empty(w.numel() + 1, dtype=torch.uint8, device="cuda")
    wv = wbuf[1:].view(w.shape)
    wv.copy_(w)
    assert torch.equal(ops.pack4(wv), pack4_plain(wv))


@pytest.mark.parametrize("name", PACK4_TAIL_CASES)
def test_pack4_unpack4_tails_match_plain_on_card(name):
    _require_cuda()
    v = torch.tensor(pack4_case(name), device="cuda")
    assert torch.equal(ops.pack4(v), pack4_plain(v))
    assert torch.equal(ops.unpack4(v), unpack4_plain(v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PACK4_CASES + PACK4_TAIL_CASES)
def test_pack4_counts_matches_plain_on_card(name, dtype):
    """The bias fused into the pack, T = 7 and 15, against the plain
    version; counted as a ``pack4`` launch."""
    _require_cuda()
    for T in (7, 15):
        c = torch.tensor(pack4_counts_case(name, T), device="cuda").to(
            getattr(torch, dtype))
        before = ops.launch_counts()["pack4"]
        got = ops.pack4_counts(c, T)
        assert ops.launch_counts()["pack4"] == before + 1
        assert torch.equal(got, pack4_counts_plain(c, T))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_decode_matches_encode_then_decode_on_card(dtype):
    """The served wire roundtrip's one launch against the codec's encode
    then decode on the same card, at the decode and a prefill shape."""
    _require_cuda()
    from repro_torch.core import spike as TS
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(13)
    p = {"theta": torch.tensor(rng.uniform(0.0, 0.3, 1024)
                               .astype(np.float32), device="cuda"),
         "log_scale": torch.tensor(rng.uniform(-1.0, 1.0, 1024)
                                   .astype(np.float32), device="cuda")}
    cfg = TS.SpikeConfig(T=15, faithful=True)
    for shape in ((4, 1, 1024), (1, 256, 1024)):
        x = torch.tensor(rng.standard_normal(shape).astype(np.float32)
                         * 1.5, device="cuda").to(dt)
        before = ops.launch_counts()["lif_encode"]
        counts, dec = TS.encode_decode(x, p, cfg)
        assert ops.launch_counts()["lif_encode"] == before + 1
        assert counts.dtype == torch.int8 and dec.dtype == dt
        want = TS.encode(x, p, cfg)
        assert torch.equal(counts.to(dt), want)
        assert torch.equal(dec, TS.decode(want, p, cfg, dt))


def _decode_scales(C, dtype):
    """The decode factors ``exp(log_scale).to(dtype)`` of every
    ``UNPACK4_LOG_SCALES`` kind, on the card (divide by T for the
    factor)."""
    return [torch.exp(torch.tensor(unpack4_log_scale(kind, C),
                                   device="cuda")).to(dtype)
            for kind in UNPACK4_LOG_SCALES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PACK4_CASES + PACK4_TAIL_CASES)
def test_unpack4_decode_matches_plain_on_card(name, dtype):
    """The redesigned unpack and the fused unpack-and-decode, T = 7 and
    1, at log-scales of 0 and seeded ones, against their plain versions;
    the fused call counted as an ``unpack4`` launch."""
    _require_cuda()
    dt = getattr(torch, dtype)
    p = torch.tensor(pack4_case(name), device="cuda")
    assert torch.equal(ops.unpack4(p), unpack4_plain(p))
    for scale in _decode_scales(2 * p.shape[1], dt):
        for T in (7, 1):
            before = ops.launch_counts()["unpack4"]
            got = ops.unpack4_decode(p, T, scale / T)
            assert ops.launch_counts()["unpack4"] == before + 1
            assert got.dtype == dt
            assert torch.equal(got, unpack4_decode_plain(p, T, scale / T))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpack4_unaligned_views_on_card(dtype):
    """Packed bytes and decode factors in contiguous views that start 1
    byte or 1 element into their buffers, at a width the vector layout
    takes when aligned: the scalar paths."""
    _require_cuda()
    dt = getattr(torch, dtype)
    p = torch.tensor(pack4_case("tail_m257_c8"), device="cuda")
    buf = torch.empty(p.numel() + 1, dtype=torch.uint8, device="cuda")
    pv = buf[1:].view(p.shape)
    pv.copy_(p)
    assert pv.data_ptr() % 4 != 0 and pv.is_contiguous()
    assert torch.equal(ops.unpack4(pv), unpack4_plain(pv))
    for scale in _decode_scales(2 * p.shape[1], dt):
        ds = scale / 7
        dbuf = torch.empty(ds.numel() + 1, dtype=dt, device="cuda")
        dv = dbuf[1:]
        dv.copy_(ds)
        assert dv.data_ptr() % 16 != 0
        for pp, d in ((pv, ds), (p, dv), (pv, dv)):
            assert torch.equal(ops.unpack4_decode(pp, 7, d),
                               unpack4_decode_plain(pp, 7, d))


def test_unpack4_decode_cuda_refuses_bad_inputs():
    """A CPU tensor, a wrong dtype of either input and a decode factor
    of the wrong length raise before any launch."""
    _require_cuda()
    p = torch.zeros(4, 8, dtype=torch.uint8, device="cuda")
    ds = torch.ones(16, device="cuda")
    for args in ((p.cpu(), 7, ds), (p, 7, ds.cpu()), (p.float(), 7, ds),
                 (p, 7, ds.half()), (p, 7, ds[:8]), (p, 7, ds.double())):
        with pytest.raises(ValueError):
            PK.unpack4_decode_cuda(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spike_unpack4_decode_is_one_launch_on_card(dtype):
    """The codec's receiving side of a packed wire, at the decode and a
    prefill shape: one ``unpack4`` launch, equal to the unpack,
    ``wire_u8_to_counts`` and ``decode`` on the same card."""
    _require_cuda()
    from repro_torch.core import spike as TS
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(14)
    p = {"log_scale": torch.tensor(rng.uniform(-1.0, 1.0, 1024)
                                   .astype(np.float32), device="cuda")}
    cfg = TS.SpikeConfig(T=7)
    for shape in ((1, 4, 1, 512), (1, 1, 256, 512)):
        packed = torch.tensor(rng.randint(0, 256, shape).astype(np.uint8),
                              device="cuda")
        before = ops.launch_counts()["unpack4"]
        got = TS.unpack4_decode(packed, p, cfg, dt)
        assert ops.launch_counts()["unpack4"] == before + 1
        assert got.dtype == dt and got.shape == shape[:-1] + (1024,)
        want = TS.decode(TS.wire_u8_to_counts(TS.unpack4(packed), cfg.T, dt),
                         p, cfg, dt)
        assert torch.equal(got, want)


def _reduced_on_card(seed, **overrides):
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params
    cfg = reduced(get_config("qwen1.5-0.5b")).replace(dtype=torch.float32,
                                                      **overrides)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")


def _cyclic_requests(seed, n=6, new=12):
    rng = np.random.RandomState(seed)
    return [((rng.randint(0, 256, max(L // 4, 1)).tolist() * L)[:L], new)
            for L in rng.randint(4, 40, n).tolist()]


@pytest.mark.parametrize("codec", ["none", "spike", "spike_pack4"])
def test_engine_on_card_spec_matches_vanilla(codec):
    """Speculative decoding with the n-gram drafter (spec_k = 3) on the
    card, ANN mode under ``none``: one paged-decode launch per layer and
    verify step, the boundary kernels as per decode step, every page
    free at the end, and under ``none`` the ``spec_k=0`` streams under
    the margin rule (in HNN mode a verify step's [B*K1, D] matmuls may
    round apart from a decode step's, and a spike count with them)."""
    _require_cuda()
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    hnn = "ann" if codec == "none" else "hnn"
    cfg, params = _reduced_on_card(4, codec=codec, hnn_mode=hnn)
    reqs = _cyclic_requests(4)
    runs = {}
    for k in (0, 3):
        ops.reset_launch_counts()
        eng = ServingEngine(cfg, params, EngineConfig(
            num_slots=3, max_seq=64, page_size=8, spec_k=k))
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                       for i, (p, m) in enumerate(reqs)])
        n = ops.launch_counts()
        L, steps, pre = cfg.n_layers, eng.decode_steps, eng.prefills
        assert n["paged_decode"] == L * steps > 0
        assert n["lif_encode"] == (4 * L * (steps + pre)
                                   if codec == "spike" else 0)
        assert n["pack4"] == n["unpack4"] == (
            L * (2 * steps + 4 * pre) if codec == "spike_pack4" else 0)
        assert eng.cache.allocator.pages_in_use == 0
        assert all(len(out[i]) == m for i, (_, m) in enumerate(reqs))
        runs[k] = out, eng
    assert runs[3][1].spec_verifies > 0
    if codec == "none":
        (ref, eng0), (spec, _) = runs[0], runs[3]
        for rid in ref:
            for t, (a, b) in enumerate(zip(ref[rid], spec[rid])):
                if eng0.margins[rid][t] <= MARGIN:
                    break
                assert a == b, (rid, t)


def test_engine_on_card_sampled_runs_repeat():
    """Temperature 0.8 with top-k 50 and top-p 0.9 beside greedy
    requests, on the card: one seed serves the same streams twice, and
    the greedy requests keep the streams of an all-greedy run."""
    _require_cuda()
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg, params = _reduced_on_card(5, hnn_mode="ann", codec="none")
    reqs = _cyclic_requests(5)
    temps = [0.0 if i in (1, 4) else 0.8 for i in range(len(reqs))]

    def serve(temps, spec_k=0):
        eng = ServingEngine(cfg, params, EngineConfig(
            num_slots=3, max_seq=64, page_size=8, top_k=50, top_p=0.9,
            seed=1, spec_k=spec_k))
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m,
                               temperature=t)
                       for i, ((p, m), t) in enumerate(zip(reqs, temps))])
        assert eng.cache.allocator.pages_in_use == 0
        return out, eng.margins

    a, _ = serve(temps)
    assert serve(temps)[0] == a
    greedy, margins = serve([0.0] * len(reqs))
    spec, _ = serve(temps, spec_k=3)
    assert serve(temps, spec_k=3)[0] == spec
    for rid, t in enumerate(temps):
        if t > 0:
            continue
        for out in (a, spec):
            for i, (x, y) in enumerate(zip(greedy[rid], out[rid])):
                if margins[rid][i] <= MARGIN:
                    break
                assert x == y, (rid, i)


def _drained(eng):
    alloc = eng.cache.allocator
    return (eng.idle and alloc.pages_in_use == 0 and alloc.pages_in_limbo == 0
            and alloc._dispatched == alloc._committed
            and alloc.num_free == alloc.num_slots)


def _mixed_requests(seed, vocab, n=6, new=8):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, L).tolist(), new)
            for L in rng.randint(1, 60, n).tolist()]


@pytest.mark.parametrize("codec", ["spike_fused", "spike", "spike_pack4"])
def test_engine_on_card_async_matches_sync(codec):
    _require_cuda()
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg, params = _reduced_on_card(6, codec=codec)
    reqs = _mixed_requests(6, cfg.vocab)
    runs = {}
    for depth in (0, 1):
        ops.reset_launch_counts()
        eng = ServingEngine(cfg, params, EngineConfig(
            num_slots=3, max_seq=64, page_size=8, async_depth=depth))
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                       for i, (p, m) in enumerate(reqs)])
        n = ops.launch_counts()
        L, steps, pre = cfg.n_layers, eng.decode_steps, eng.prefills
        assert n["paged_decode"] == L * steps > 0
        assert n["lif_encode"] == (4 * L * (steps + pre)
                                   if codec == "spike" else 0)
        assert n["pack4"] == n["unpack4"] == (
            L * (2 * steps + 4 * pre) if codec == "spike_pack4" else 0)
        assert _drained(eng)
        runs[depth] = out, eng.margins
    assert runs[1] == runs[0]


def test_engine_on_card_commit_waits_for_its_event():
    _require_cuda()
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg, params = _reduced_on_card(7)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(_mixed_requests(7, cfg.vocab))]
    ecfg = dict(num_slots=3, max_seq=64, page_size=8)
    ref = ServingEngine(cfg, params, EngineConfig(**ecfg)).run(reqs)
    eng = ServingEngine(cfg, params, EngineConfig(**ecfg, async_depth=1))
    eng.warmup(reqs[0].prompt)
    for r in reqs:
        eng.submit(r)
    alloc = eng.cache.allocator
    arrays = (eng._tokens, eng._pos, alloc.block_table, alloc.page_list_loc,
              alloc.page_list_pos)
    results, queued = {}, 0
    while not eng.idle:
        torch.cuda._sleep(20_000_000)       # the card stays busy a while
        torch.cuda.set_sync_debug_mode("error")
        try:
            launched = eng.dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if launched:
            rec = eng._inflight[-1]
            queued += not rec.result.event.query()
            saved = [a.copy() for a in arrays]
            for a in arrays:
                a[...] = 3
            torch.cuda._sleep(2_000_000)
            for a, s in zip(arrays, saved):
                a[...] = s
        while len(eng._inflight) > (1 if launched else 0):
            oldest = eng._inflight[0]
            eng.commit()
            assert oldest.result.event.query()
        results.update((r.rid, o) for r, o in eng._retired)
        eng._retired = []
    assert results == ref
    assert queued > 0 and _drained(eng)


ARCHS = ("qwen1.5-0.5b", "gemma2-2b", "granite-20b", "qwen1.5-4b")


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCH_CASES)
def test_arch_cases_repeat_bit_for_bit_on_card(name, pool_dtype, wire):
    _require_cuda()
    arrays, window, cap = case_arrays(name)
    ts = to_tensors(arrays, "cuda", getattr(torch, pool_dtype))
    kw = dict(window=window, cap=cap, encode_wire=wire)
    a = ops.paged_flash_decode(*ts, **kw)
    b = ops.paged_flash_decode(*ts, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _arch_shape(arch, K1, seed):
    """Random pools at ``arch``'s attention dims, pages of 16, and the
    lists an allocator builds for four slots of 40-250 tokens, each
    querying its last K1 positions; the local window and softcap."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks_attn import attn_dims
    from repro_torch.serving.kv_cache import SlotAllocator
    cfg = get_config(arch)
    d = attn_dims(cfg)
    rng = np.random.RandomState(seed)
    lens = rng.randint(40, 251, 4)
    alloc = SlotAllocator(4, 256, 16)
    for L in lens:
        alloc.alloc(int(L))
    shape = (alloc.num_pages, 16, d["Hkv"], d["dh"])
    arrays = (rng.standard_normal((4, K1, d["Hq"], d["dh"])).astype(
        np.float32),
        rng.standard_normal(shape).astype(np.float32),
        rng.standard_normal(shape).astype(np.float32),
        alloc.page_list_loc[:, 0].copy(), alloc.page_list_pos[:, 0].copy(),
        (lens[:, None] - K1 + np.arange(K1)).astype(np.int32))
    window = cfg.window if "local" in cfg.pattern else 0
    return arrays, window, cfg.attn_softcap


@pytest.mark.parametrize("K1", [1, 4])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_served_arch_shapes_on_card(arch, pool_dtype, K1):
    """Each registered config's decode and verify shape: within 2e-5 of
    the plain version, the wire within one step, and the same bits on a
    second launch."""
    _require_cuda()
    arrays, window, cap = _arch_shape(arch, K1, seed=K1)
    ts = to_tensors(arrays, "cuda", getattr(torch, pool_dtype))
    kw = dict(window=window, cap=cap)
    o, lse = ops.paged_flash_decode(*ts, **kw)
    po, plse = paged_decode_plain(*ts, **kw)
    torch.testing.assert_close(o, po, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
    o2, lse2 = ops.paged_flash_decode(*ts, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    w, s, lse_w = ops.paged_flash_decode(*ts, encode_wire=True, **kw)
    pw, ps, _ = paged_decode_plain(*ts, encode_wire=True, **kw)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=0.0)
    assert int((w.int() - pw.int()).abs().max()) <= 1
    assert torch.equal(lse_w, lse)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_plan_takes_every_served_shape(arch, pool_dtype):
    """Every decode and verify shape of the registered configs (four
    slots) has a launch plan: at most 8 query rows a block, at least one
    warp."""
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_decode import launch_plan
    from repro_torch.models.blocks_attn import attn_dims
    d = attn_dims(get_config(arch))
    for K1 in (1, 4):
        plan = launch_plan(4, K1, d["Hq"], d["Hkv"], d["dh"], 16, 16,
                           getattr(torch, pool_dtype))
        assert plan is not None, (arch, K1)
        rows, groups, warps = plan
        nq = K1 * d["Hq"] // d["Hkv"]
        assert rows <= 8 and 1 <= warps <= 8
        assert (groups - 1) * rows < nq <= groups * rows


def test_granite_f32_verify_step_launches_on_card():
    """48 query heads on one kv head at K1 = 4 from an f32 pool: 192
    rows, which one block cannot hold, run as 24 groups of 8 (four
    slots: 96 blocks, which halving would take past one a SM)."""
    _require_cuda()
    from repro_torch.kernels.paged_decode import launch_plan
    assert launch_plan(4, 4, 48, 1, 128, 16, 16, torch.float32)[:2] == (
        8, 24)
    arrays, window, cap = case_arrays("granite_mqa_k1_4")
    ts = to_tensors(arrays, "cuda", torch.float32)
    o, lse = ops.paged_flash_decode(*ts)
    torch.testing.assert_close(o, paged_decode_plain(*ts)[0], rtol=2e-5,
                               atol=2e-5)


def test_paged_decode_refuses_a_shape_that_fits_no_block():
    """Heads of 4096 f32 values: one warp's two stages of K and V pages
    alone exceed shared memory, so the wrapper raises before launching."""
    _require_cuda()
    from repro_torch.kernels import paged_decode as PD
    arrays = rand_case(seed=0, B=1, K1=1, Hq=1, Hkv=1, dh=4096, P_loc=2,
                       psz=16, ppc=1)
    ts = to_tensors(arrays, "cuda")
    before = ops.paged_flash_decode.launches
    with pytest.raises(ValueError):
        ops.paged_flash_decode(*ts)
    assert ops.paged_flash_decode.launches == before
    assert PD.launch_plan(1, 1, 1, 1, 4096, 16, 1) is None


def test_dense_decode_steps_on_card_match_the_cpu():
    """``launch.serve`` on the card: a [2, 32] prefill of reduced
    gemma2-2b (f32, codec ``none``) and four decode steps at
    pos = 31 + t over its dense cache, against the same steps on the
    CPU (logits within 1e-4: the card's matmuls sum in other orders)."""
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch import serve as SV
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params
    cfg = reduced(get_config("gemma2-2b", hnn_mode="ann",
                             codec="none")).replace(dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")
    cpu = _to_cpu(params)
    tok = np.random.RandomState(0).randint(0, cfg.vocab, (2, 32))
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu)):
        pre = SV.make_prefill_step(cfg, device=dev)
        dec = SV.make_decode_step(cfg, device=dev)
        logits, cache = pre(p, {"tokens": torch.tensor(tok, device=dev)})
        seq = [logits]
        nxt = SV.greedy_sample(logits)
        for t in range(4):
            if dev == "cpu":
                nxt = out["cuda_tokens"][t].cpu()
            logits, cache = dec(p, cache, nxt, 31 + t)
            seq.append(logits)
            if dev == "cuda":
                out.setdefault("cuda_tokens", []).append(nxt)
                nxt = SV.greedy_sample(logits)
        out[dev] = [x.cpu() for x in seq]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


# ---------------------------------------------------------------------------
# training: the boundaries' backward kernels (K1 roundtrip_bwd, K2 the
# faithful encoder's surrogate gradient) and a train step on the card
# ---------------------------------------------------------------------------

TRAIN_SHAPES = [(1024, 1024), (2048, 1024), (37, 1024), (5, 33), (1, 1)]


def _close_per_element(a, w):
    """|a - w| <= 1e-5 |w| + 1e-6 max |w|, element by element: the
    surrogate chain makes a few entries ~1e6 times the typical one, so
    a bound on the largest entry alone would pass a wrong typical one."""
    return bool(((a - w).abs() <= 1e-5 * w.abs()
                 + 1e-6 * w.abs().max()).all())


def _backward_inputs(M, C, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(M, C, generator=gen, device="cuda") * 0.8).to(dtype)
    g = torch.randn(M, C, generator=gen, device="cuda").to(dtype)
    theta = 0.3 * torch.rand(C, generator=gen, device="cuda")
    s = torch.exp(2 * torch.rand(C, generator=gen, device="cuda") - 1)
    return x, g, theta, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,C", TRAIN_SHAPES)
def test_roundtrip_bwd_matches_plain_on_card(M, C, dtype):
    """K1: dx equal to the plain version's bits, dtheta and dlog_scale
    within 1e-5 of the sum of their terms' magnitudes per channel, and
    the same bits on a second launch."""
    _require_cuda()
    from repro_torch.kernels import roundtrip_bwd as RB
    x, g, theta, s = _backward_inputs(M, C, getattr(torch, dtype), M + C)
    args = (x, g, theta, s, s / 15)
    got = RB.roundtrip_bwd_cuda(*args, T=15)
    again = RB.roundtrip_bwd_cuda(*args, T=15)
    dx, dth, dls = RB.roundtrip_bwd_terms(*args, T=15)
    assert got[0].dtype == x.dtype and torch.equal(got[0], dx)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for out, terms in ((got[1], dth), (got[2], dls)):
        assert ((out - terms.sum(0)).abs()
                <= 1e-5 * terms.abs().sum(0)).all()


@pytest.mark.parametrize("M,C", TRAIN_SHAPES)
def test_lif_encode_bwd_matches_plain_on_card(M, C):
    """K2: each output element within 1e-5 of the plain version's
    (autograd through the surrogate tick loop) plus 1e-6 of that
    output's largest entry, the same bits on a second launch."""
    _require_cuda()
    from repro_torch.kernels import lif_encode as LE
    x, g, theta, s = _backward_inputs(M, C, torch.float32, 7 * M + C)
    args = (x / s, theta / s, g)
    got = LE.lif_encode_bwd_cuda(*args, T=15)
    again = LE.lif_encode_bwd_cuda(*args, T=15)
    want = LE.lif_encode_bwd_plain(*args, T=15)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert _close_per_element(a, w)


def test_backward_kernels_refuse_bad_inputs():
    _require_cuda()
    from repro_torch.kernels import lif_encode as LE
    from repro_torch.kernels import roundtrip_bwd as RB
    x, g, theta, s = _backward_inputs(4, 8, torch.float32, 0)
    with pytest.raises(ValueError):
        LE.lif_encode_bwd_cuda(x.bfloat16(), theta, g.bfloat16(), T=15)
    with pytest.raises(ValueError):
        LE.lif_encode_bwd_cuda(x, theta, g, T=LE.BWD_MAX_T + 1)
    with pytest.raises(ValueError):
        LE.lif_encode_bwd_cuda(x.cpu(), theta.cpu(), g.cpu(), T=15)
    with pytest.raises(ValueError):
        RB.roundtrip_bwd_cuda(x, g.bfloat16(), theta, s, s / 15, T=15)
    with pytest.raises(ValueError):
        RB.roundtrip_bwd_cuda(x, g, theta[:4], s, s / 15, T=15)


def test_faithful_encode_gradient_on_card():
    """A faithful encode that wants a gradient runs the ``lif_encode``
    kernel forward and K2 backward (one launch each), with the counts
    and gradients (each element within 1e-5 of itself plus 1e-6 of its
    gradient's largest entry) of PyTorch's autograd through the plain
    tick loop on the same card; bf16 with a gradient is refused.  (Against the CPU the surrogate chain, up to 15
    factors near -9, magnifies last-place differences past that bound.)"""
    _require_cuda()
    from repro_torch.core import spike
    x, g, theta, s = _backward_inputs(64, 96, torch.float32, 3)
    cfg = spike.SpikeConfig(T=15, faithful=True)
    outs = []
    for route in ("kernels", "autograd"):
        tx = x.detach().requires_grad_()
        p = {"theta": theta.detach().requires_grad_(),
             "log_scale": torch.log(s).detach().requires_grad_()}
        ops.reset_launch_counts()
        if route == "kernels":
            y = spike.encode(tx, p, cfg)
        else:
            sc = torch.exp(p["log_scale"])
            y = spike.lif_rate_encode_signed(tx / sc, p["theta"] / sc, 15)
        (y * g).sum().backward()
        n = ops.launch_counts()
        assert (n["lif_encode"], n["lif_encode_bwd"]) == (
            (1, 1) if route == "kernels" else (0, 0))
        outs.append([t.detach().cpu() for t in
                     (y, tx.grad, p["theta"].grad, p["log_scale"].grad)])
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert _close_per_element(a, b)
    with pytest.raises(NotImplementedError):
        spike.encode(x.bfloat16().requires_grad_(),
                     {"theta": theta, "log_scale": torch.log(s)}, cfg)


@pytest.mark.parametrize("codec", ["spike_fused", "spike", "spike_pack4"])
def test_train_step_on_card_matches_cpu(codec, monkeypatch):
    """One AdamW step of reduced qwen1.5-0.5b (f32, two microbatches) on
    the card, through K1 (and K2 under ``spike``), against the same step
    with the plain versions on the card (each leaf within 1e-5 of its
    largest entry) and on the CPU (metrics within 1e-4, the gradients
    within 1e-4 of the global gradient norm: between devices the
    surrogate chain magnifies last-place differences), and the kernels
    launched as the path predicts."""
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as TT
    from repro_torch.optim.adamw import tree_leaves
    cfg = reduced(get_config("qwen1.5-0.5b", codec=codec)).replace(
        dtype=torch.float32)
    params = TT.init_train_params(cfg, 0, device="cuda")
    cpu = _to_cpu(params)
    batch = SyntheticLM(DataConfig(seq_len=32, global_batch=4)).batch(0)
    res = {}
    for dev, p in (("cuda", params), ("cpu", cpu)):
        ops.reset_launch_counts()
        step = TT.make_train_step(cfg, microbatches=2, device=dev,
                                  with_optimizer=False)
        res[dev] = step(p, batch)
        if dev == "cuda":
            n = ops.launch_counts()
            L = cfg.n_layers
            assert n["roundtrip_bwd"] == 4 * L * 2
            assert n["lif_encode_bwd"] == (2 * L * 2 if codec == "spike"
                                           else 0)
    from repro_torch.kernels import lif_encode as LE
    from repro_torch.kernels import roundtrip_bwd as RB
    for mod, name in ((RB, "roundtrip_bwd"), (LE, "lif_encode_bwd"),
                      (LE, "lif_encode"), (PK, "pack4_counts"),
                      (PK, "unpack4_decode")):
        monkeypatch.setattr(mod, name + "_cuda", getattr(mod, name + "_plain"))
    gp_card = TT.make_train_step(cfg, microbatches=2, device="cuda",
                                 with_optimizer=False)(params, batch)[1]
    for a, b in zip(tree_leaves(res["cuda"][1]), tree_leaves(gp_card)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    (lc, gc, mc), (lp, gp, mp) = res["cuda"], res["cpu"]
    for k in mc:
        assert abs(float(mc[k]) - float(mp[k])) <= 1e-4, k
    norm = float(TT.global_grad_norm(gp))
    for a, b in zip(tree_leaves(gc), tree_leaves(gp)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * norm


# ---------------------------------------------------------------------------
# the MoE family: its attention and boundary shapes, the MoE block
# ---------------------------------------------------------------------------

MOE_ARCHS = ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("K1", [1, 4])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_paged_decode_moe_arch_shapes_on_card(arch, pool_dtype, K1):
    """qwen2-moe's 16 MHA heads of 128 and llama4's 40 heads on 8 kv
    heads of 128 (20 query rows a kv head at K1 = 4): the checks of
    ``test_paged_decode_served_arch_shapes_on_card``."""
    test_paged_decode_served_arch_shapes_on_card(arch, pool_dtype, K1)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_plan_takes_every_moe_shape(arch, pool_dtype):
    test_launch_plan_takes_every_served_shape(arch, pool_dtype)


@pytest.mark.parametrize("name", ("moe_m256_c2048", "moe_m256_c5120"))
def test_lif_encode_moe_prefill_rows_match_plain_on_card(name):
    """``lif_encode`` at the MoE widths' prefill rows, in both compute
    types (their decode rows are among ``LIF_CASES``)."""
    test_lif_encode_matches_plain_on_card(name)
    test_lif_encode_bf16_mode_matches_plain_on_card(name)


def _moe_block(arch, dtype, seed=0):
    """Reduced ``arch``'s MoE block parameters (seeded, on the card) and
    its config."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models import blocks_moe as MOE
    from repro_torch.models.params import init_params
    cfg = reduced(get_config(arch)).replace(dtype=getattr(torch, dtype))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = init_params(MOE.moe_defs(cfg), gen, cfg.dtype, device="cuda")
    p["ln2"].normal_(0.0, 0.1, generator=gen)
    p["wr"].mul_(15.0)           # decisive routing: std 0.3
    return cfg, p


@pytest.mark.parametrize("mode,B,S", [("prefill", 1, 64), ("decode", 4, 1),
                                      ("decode", 4, 4), ("train", 2, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_same_bits_twice_on_card(arch, dtype, mode, B, S):
    """The MoE block on the card: the same bits on a second call (the
    combine sums each token's k outputs in a fixed order, no atomics),
    its routing equal to the CPU's on the same input, and its output
    within 1e-4 of the CPU's (f32)."""
    _require_cuda()
    from repro_torch.models import blocks_moe as MOE
    from repro_torch.models.context import make_context
    cfg, p = _moe_block(arch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=gen,
                    device="cuda").to(cfg.dtype)
    ctx = make_context(cfg, mode)
    with torch.no_grad():
        a, _, _ = MOE.moe_fwd(p, x, ctx)
        b, _, _ = MOE.moe_fwd(p, x, ctx)
        assert torch.equal(a, b)
        if dtype == "float32":
            cpu = _to_cpu(p)
            c, _, _ = MOE.moe_fwd(cpu, x.cpu(), ctx)
            h = MOE.common.norm(x, p["ln2"], cfg.norm)
            hc = MOE.common.norm(x.cpu(), cpu["ln2"], cfg.norm)
            d = MOE.moe_dims(cfg)
            _, idx, _ = MOE._route(cfg, d, h, p["wr"])
            _, idxc, _ = MOE._route(cfg, d, hc, cpu["wr"])
            assert torch.equal(idx.cpu(), idxc)
            torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-4)


def test_moe_engine_on_card_launches_and_drains():
    """Reduced llama4 (f32, ``spike``) served by the engine on the card:
    paged decode once per layer and step, ``lif_encode`` at the two
    coded boundaries of each dense layer's attention and MLP and the
    attention's two of each MoE layer (none in the MoE block at tp = 1),
    decode steps and prefills; every page free at the end."""
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = reduced(get_config("llama4-maverick-400b-a17b",
                             codec="spike")).replace(dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")
    eng = ServingEngine(cfg, params, EngineConfig(num_slots=4, max_seq=64,
                                                  page_size=16))
    rng = np.random.RandomState(0)
    ops.reset_launch_counts()
    out = eng.run([Request(rid=i, prompt=rng.randint(0, 256, 9 + i).tolist(),
                           max_new_tokens=6) for i in range(6)])
    n = ops.launch_counts()
    dense = cfg.pattern.count("attn") * cfg.n_units
    moe = cfg.pattern.count("attn_moe") * cfg.n_units
    steps, pre = eng.decode_steps, eng.prefills
    assert n["paged_decode"] == cfg.n_layers * steps
    assert n["lif_encode"] == (4 * dense + 2 * moe) * (steps + pre)
    assert all(len(v) == 6 for v in out.values())
    assert eng.cache.allocator.pages_in_use == 0


# ---------------------------------------------------------------------------
# the recurrent-state families: jamba's attention shape, the boundary
# widths 512 / 768 / 8192, and each family served on the card
# ---------------------------------------------------------------------------

REC_ARCHS = {"rwkv-paper": {}, "xlstm-125m": {},
             "jamba-1.5-large-398b": {"n_layers": 8}}


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_decode_jamba_shape_on_card(pool_dtype):
    """jamba's 64 heads on 8 kv heads of 128 at K1 = 1 (spec is forced
    off for a recurrent family): the checks of
    ``test_paged_decode_served_arch_shapes_on_card``, and a launch plan."""
    test_paged_decode_served_arch_shapes_on_card("jamba-1.5-large-398b",
                                                 pool_dtype, 1)
    from repro_torch.kernels.paged_decode import launch_plan
    assert launch_plan(4, 1, 64, 8, 128, 16, 16,
                       getattr(torch, pool_dtype)) is not None


@pytest.mark.parametrize("C", [512, 768, 8192])
def test_boundary_kernels_at_recurrent_widths_on_card(C):
    """``lif_encode`` (both compute types, with and without the decode
    epilogue), ``pack4_counts`` and ``unpack4_decode`` at the recurrent
    families' widths and four decode rows, exactly equal to their plain
    versions (the ``rec_m4_c*`` cases of ``LIF_CASES`` and
    ``PACK4_CASES``)."""
    _require_cuda()
    x, theta, scale, T = lif_tensors(f"rec_m4_c{C}", "cuda")
    for md in (torch.float32, torch.bfloat16):
        for ds in (None, (scale / T).float()):
            got = ops.lif_encode(x, theta, scale, T=T, math_dtype=md,
                                 decode_scale=ds)
            want = lif_encode_plain(x, theta, scale, T=T, math_dtype=md,
                                    decode_scale=ds)
            got, want = ((got,), (want,)) if ds is None else (got, want)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    counts = torch.tensor(pack4_counts_case(f"rec_m4_c{C}", 7),
                          device="cuda")
    assert torch.equal(PK.pack4_counts_cuda(counts, 7),
                       pack4_counts_plain(counts, 7))
    packed = torch.tensor(pack4_case(f"rec_m4_c{C // 2}"), device="cuda")
    ds = torch.exp(torch.tensor(unpack4_log_scale("seeded", C),
                                device="cuda")) / 7
    assert torch.equal(PK.unpack4_decode_cuda(packed, 7, ds),
                       unpack4_decode_plain(packed, 7, ds))


@pytest.mark.parametrize("arch", sorted(REC_ARCHS))
def test_recurrent_engine_on_card_matches_cpu(arch):
    """A reduced recurrent family (f32, ANN, the seeded init) served by
    the engine on the card and on the CPU: the same greedy streams under
    the margin rule, exact-length prefills, paged decode once per
    attention layer and step (jamba's one), every page free at the
    end."""
    _require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = reduced(get_config(arch, hnn_mode="ann", codec="none")).replace(
        dtype=torch.float32, **REC_ARCHS[arch])
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(model_defs(cfg), gen, cfg.dtype, device="cuda")
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 256, L).tolist(), 6) for L in (4, 10, 16, 10)]
    out = {}
    for dev, p in (("cuda", params), ("cpu", _to_cpu(params))):
        eng = ServingEngine(cfg, p, EngineConfig(num_slots=3, max_seq=64,
                                                 page_size=16, spec_k=3),
                            device=dev)
        ops.reset_launch_counts()
        out[dev] = (eng.run([Request(rid=i, prompt=q, max_new_tokens=m)
                             for i, (q, m) in enumerate(reqs)]),
                    eng.margins, ops.launch_counts(), eng)
        assert eng.spec_k == 0 and eng.cache.allocator.pages_in_use == 0
    streams, margins, n, eng = out["cpu"]
    got, _, n_card, eng_card = out["cuda"]
    attn = cfg.pattern.count("attn") * cfg.n_units
    assert n_card["paged_decode"] == attn * eng_card.decode_steps
    for rid, toks in streams.items():
        for t, (a, b) in enumerate(zip(toks, got[rid])):
            if margins[rid][t] <= MARGIN:
                break
            assert a == b, (rid, t)
