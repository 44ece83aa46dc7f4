"""The port's training forward of the MoE family against the JAX
reference's.

Reduced ``qwen2-moe-a2.7b`` in float32 with the JAX package's own init
on a 1x1 mesh, on ``examples/quickstart.py``'s batch (2 x 32 uniform
tokens from ``PRNGKey(1)``, labels rolled): ``forward_loss`` (the NLL,
the eq-10 penalty of every boundary — ``sp_disp`` of each MoE block
among them — plus 0.01 x each MoE block's aux loss, and the occupancy)
and the gradient of every parameter leaf equal
``jax.value_and_grad(M.forward_loss)`` under ``shard_map``, with PR
27's tolerances (``test_torch_train_loss.check_forward_loss``: 1e-5;
under ``spike`` the per-leaf float-noise rule).  ANN ``none`` and HNN
``spike_fused`` here, HNN ``spike`` in ``test_torch_train_moe_spike.py``.

Training routes at capacity factor 1.25: 64 tokens, top-2 of 8
experts, C = 20, and on this batch assignments are dropped (counted on
the port's side).  At world size 1 the MoE block has no coded exchange:
``sp_comb``'s gradient is exactly 0 on both sides, ``sp_disp``'s
theta and log-scale get theirs from the penalty alone.  The reference
reads loss 5.58891, NLL 5.56668, penalty 0.022230 and occupancy
0.97205 here, under both spike codecs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_loss import check_forward_loss  # noqa: E402

from repro_torch.models import blocks_moe as TMOE  # noqa: E402

torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"
#: the reference's numbers on this batch (f32, 1x1 mesh, PRNGKey(0)
#: init): NLL, penalty, occupancy under the spike codecs
ORACLE = {"loss": 5.56668, "penalty": 0.022230, "occupancy": 0.97205}


class CountDrops:
    """Counts the port's dropped assignments while active."""

    def __enter__(self):
        self.dropped, self.total, self.C = 0, 0, set()
        self._orig = TMOE._dispatch_slots

        def spy(idx, E, C):
            keep, row = self._orig(idx, E, C)
            self.dropped += int((~keep).sum())
            self.total += keep.numel()
            self.C.add(C)
            return keep, row

        TMOE._dispatch_slots = spy
        return self

    def __exit__(self, *exc):
        TMOE._dispatch_slots = self._orig


def check_moe_loss(hnn, codec):
    with CountDrops() as drops:
        loss, metrics, grads = check_forward_loss(hnn, codec, arch=ARCH)
    # the forward and the per-block recompute of the backward
    assert drops.C == {20} and drops.dropped > 0
    comb = [k for k in grads if "sp_comb" in k]
    disp = [k for k in grads if "sp_disp" in k]
    assert comb and disp
    for k in comb:
        assert not np.asarray(grads[k]).any(), k
    if codec != "none":
        for k, want in ORACLE.items():
            np.testing.assert_allclose(metrics[k], want, rtol=2e-5, err_msg=k)
        assert all(np.abs(grads[k]).max() > 0 for k in disp)
    else:
        assert metrics["penalty"] > 0          # 0.01 x the aux loss
    return metrics, grads


@pytest.mark.parametrize("hnn,codec", [("ann", "none"),
                                       ("hnn", "spike_fused")])
def test_moe_forward_loss_matches_jax(hnn, codec):
    metrics, grads = check_moe_loss(hnn, codec)
    if codec == "spike_fused":
        ls = max(np.abs(v).max() for k, v in grads.items()
                 if "sp_disp" in k and "log_scale" in k)
        np.testing.assert_allclose(ls, 6.67e-6, rtol=2e-3)
