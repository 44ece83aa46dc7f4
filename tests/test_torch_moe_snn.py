"""The MoE block in SNN mode (``hnn_mode="snn"``) against the JAX
reference's: the block's output takes the ``sp_snn2`` roundtrip, under
``spike_fused`` and ``spike``, in prefill and decode (the checks of
``test_torch_moe.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_moe import assert_outputs_close, run_both  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("codec", ["spike_fused", "spike"])
def test_snn_block_matches_jax(codec):
    """SNN mode: the block's output takes the ``sp_snn2`` roundtrip."""
    for shape in (("prefill", 1, 32), ("decode", 3, 1)):
        r = run_both("qwen2-moe-a2.7b", "float32", shape, hnn="snn",
                     codec=codec)
        np.testing.assert_array_equal(r["tidx"], r["jidx"])
        assert_outputs_close(r, "float32")


