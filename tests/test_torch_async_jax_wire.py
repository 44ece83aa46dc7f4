"""``test_torch_async_jax.py``'s check under the two wire codecs,
``spike_pack4`` and ``sparse_topk``: the port's pipelined streams at
``async_depth`` 1 and 2 (plainly, with ``spec_k=3``, under a tight pool
and with EOS in flight) against the JAX model-level steps."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_async_jax import check_async_against_jax  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("codec", ["spike_pack4", "sparse_topk"])
def test_async_streams_agree_with_jax(codec, depth):
    check_async_against_jax(codec, depth)
