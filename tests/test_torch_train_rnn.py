"""Training the recurrent-state families (here ``rwkv-paper``; the
others in ``test_torch_train_xlstm.py`` and ``test_torch_train_jamba.py``,
one JAX model compiling per case): the port's ``forward_loss``
and the gradient of every parameter leaf against
``jax.value_and_grad`` of the reference's (``test_torch_train_loss.
check_forward_loss``: 2 x 32 tokens of ``examples/quickstart.py``'s
batch, tolerance 1e-5 relative and absolute per element), on reduced
``rwkv-paper``, ``xlstm-125m`` and one unit of ``jamba-1.5-large-398b``
(``n_layers=8`` on both sides), with the JAX init's parameters and the
constant leaves seeded (``_torch_rec.seed_leaves``: RWKV's decays,
bonuses and mixes, mamba's dt bias, A and skip, the norm scales).

ANN (codec ``none``) for all three; HNN ``spike_fused`` for
``rwkv-paper`` (the eq-10 penalty at ``sp_in`` and ``sp_in2``, K1's
plain version in every coded collective's backward) and
``xlstm-125m``; HNN ``spike`` for ``rwkv-paper`` (the penalty's
surrogate through 15 IF ticks, whose reference gradient moves with
float noise: held by ``assert_leaves_conditioned``, as in
``test_torch_train_loss.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rec import seed_leaves  # noqa: E402
from test_torch_train_loss import check_forward_loss  # noqa: E402

torch.set_num_threads(1)

CASES = (("rwkv-paper", None, "ann", "none"),
         ("rwkv-paper", None, "hnn", "spike_fused"),
         ("rwkv-paper", None, "hnn", "spike"))


@pytest.mark.parametrize("arch,over,hnn,codec", CASES)
def test_forward_loss_and_grads_match_jax(arch, over, hnn, codec):
    check(arch, over, hnn, codec)


def check(arch, over, hnn, codec):
    _, metrics, grads = check_forward_loss(hnn, codec, arch, over,
                                           seed=seed_leaves)
    if arch == "rwkv-paper" and codec != "none":
        # both channel-mix boundaries carry the penalty's gradient
        assert any("sp_in2" in k and abs(g).sum() > 0
                   for k, g in grads.items())
