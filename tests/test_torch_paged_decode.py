"""The port's paged-decode attention against the JAX oracle.

On the CPU the port's wrapper runs the kernel's plain version; it is
held against ``repro.kernels.ref.paged_decode_ref`` and against the JAX
wrapper ``ops.paged_flash_decode`` with its default off-TPU dispatch
(``interpret=None``).  The interpreted Pallas body is not a usable
oracle here: it calls ``pl.load``, which the installed jax lacks.

Cases (``repro_torch.kernels.cases``): GQA, window + softcap, K1 = 3, a
partially filled last page, a pool much larger than the live pages, an
evicted (all -1) slot row, and the verify step's serve shape (K1 = 4,
16 heads of 64).  ``o`` and ``lse`` agree within rtol/atol
2e-5 (float32 on both sides, different summation order); the int8
epilogue agrees with ``boundary.quantize_partial`` of the JAX partial
within one quantization step, since a value within float rounding of a
half step may round either way.

The CUDA kernel itself needs the card: ``tests/test_torch_gpu.py``
holds it against this plain version there, as ``chip_smoke.py`` does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boundary as JB  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.cases import CASES, case_arrays, to_tensors  # noqa: E402

torch.set_num_threads(1)

NAMES = sorted(CASES)
_ref = jax.jit(jref.paged_decode_ref, static_argnames=("window", "cap"))
_JAX = {}


def _jax(name):
    """The JAX results of a case, computed once: oracle (o, lse), the
    wrapper's default dispatch (o, lse) and its wire (wire, scale, lse),
    and ``quantize_partial`` of the oracle's partial."""
    if name not in _JAX:
        arrays, window, cap = case_arrays(name)
        jarr = [jnp.array(a) for a in arrays]
        ref = _ref(*jarr, window=window, cap=cap)
        dflt = jops.paged_flash_decode(*jarr, window=window, cap=cap,
                                       interpret=None)
        wire = jops.paged_flash_decode(*jarr, window=window, cap=cap,
                                       encode_wire=True, interpret=None)
        _JAX[name] = [[np.asarray(x) for x in r] for r in
                      (ref, dflt, wire, JB.quantize_partial(ref[0]))]
    return _JAX[name]


def _port(arrays, window, cap, encode_wire=False, device="cpu",
          pool_dtype=torch.float32):
    ts = to_tensors(arrays, device, pool_dtype)
    out = ops.paged_flash_decode(*ts, window=window, cap=cap,
                                 encode_wire=encode_wire)
    return [o.cpu().numpy() for o in out]


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_jax_oracle(name):
    arrays, window, cap = case_arrays(name)
    o, lse = _port(arrays, window, cap)
    for oe, le in _jax(name)[:2]:
        np.testing.assert_allclose(o, oe, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(lse, le, rtol=2e-5, atol=2e-5)
    assert np.isfinite(o).all()
    for b in CASES[name][3]:
        assert (lse[b] == np.float32(-1e30)).all()


#: cases whose heads are 16 wide.  At dh = 16 the port's scores and
#: XLA's agree to well within 1e-6 of the scale, which
#: ``test_wire_epilogue_within_one_step`` asks of them.  At the serve
#: width, dh = 64, the 64-term dot products of unit-normal rows differ
#: by reassociation by about 1e-6 of a score, and the partial with them
#: (``verify_mha_k1_4``: up to 1.1e-6 of a row's largest value, the
#: scale up to 1.05e-6 relative); ``test_wire_epilogue_at_serve_width``
#: holds those cases' scale to ``WIDE_SCALE_RTOL``.
NARROW = [n for n in NAMES if CASES[n][0]["dh"] == 16]
WIDE = [n for n in NAMES if n not in NARROW]
#: 4x the largest reading (1.05e-6 on ``verify_mha_k1_4``), still far
#: below what a wrong scale reads: dividing the row maximum by 128 in
#: place of 127 moves it by 7.8e-3
WIDE_SCALE_RTOL = 4e-6


def _check_wire(name, scale_rtol):
    arrays, window, cap = case_arrays(name)
    wire, scale, lse = _port(arrays, window, cap, encode_wire=True)
    o, lse_o = _port(arrays, window, cap)
    _, _, (wj, sj, _), (we, se) = _jax(name)
    assert wire.dtype == np.int8 and scale.shape == se.shape
    np.testing.assert_array_equal(lse, lse_o)
    np.testing.assert_allclose(scale, se, rtol=scale_rtol)
    dec = wire.astype(np.float32) * scale
    dec_j = we.astype(np.float32) * se
    assert (np.abs(dec - dec_j) <= se + 1e-7).all()
    assert np.abs(wire.astype(np.int32)).max() <= 127
    # the JAX wrapper's own epilogue on the same inputs: same contract
    assert (np.abs(dec - wj.astype(np.float32) * sj) <= se + 1e-7).all()


@pytest.mark.parametrize("name", NARROW)
def test_wire_epilogue_within_one_step(name):
    _check_wire(name, 1e-6)


@pytest.mark.parametrize("name", WIDE)
def test_wire_epilogue_at_serve_width(name):
    _check_wire(name, WIDE_SCALE_RTOL)


def test_cpu_wrapper_counts_no_launch():
    arrays, window, cap = case_arrays("gqa")
    before = ops.paged_flash_decode.launches
    _port(arrays, window, cap)
    assert ops.paged_flash_decode.launches == before
