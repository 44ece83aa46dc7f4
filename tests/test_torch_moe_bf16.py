"""The MoE block in bfloat16 (the configs' published dtype) against the
JAX reference's: the checks of ``test_torch_moe.py``, in a file of
their own so that JAX's per-op compiles of each dtype fit one file's
time."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_moe import (ARCHS, SHAPES, check_block,  # noqa: E402
                            check_combine, shape_id)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax_bf16(arch, shape):
    check_block(arch, shape, "bfloat16")


def test_fixed_order_combine_same_bits_bf16():
    check_combine("bfloat16")
