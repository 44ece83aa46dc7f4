"""The MoE family through the port's launch entry points.

``launch.serve``'s single-request steps of reduced
``llama4-maverick-400b-a17b`` (a dense and a MoE block a unit, top-1
of 8 experts) under ``spike_fused`` against ``repro.launch.serve``'s
on a 1x1 mesh (``test_torch_dense_decode.py``'s checks: the
quickstart's [2, 32] prefill and four decode steps over the dense
cache; the teacher-forced logits).  ``make_logits_step`` builds its
context in train mode, as the reference's does, so its MoE blocks
route at capacity factor 1.25: 64 tokens, C = 10, and on these tokens
assignments are dropped, on both sides alike.  Then ``train_cli.main``
trains reduced ``qwen2-moe-a2.7b`` for two steps on the CPU, with
finite losses.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dense_decode import (check_logits_step,  # noqa: E402
                                     check_quickstart_sequence)
from test_torch_train_moe import CountDrops  # noqa: E402

from repro_torch.launch import train_cli  # noqa: E402

torch.set_num_threads(1)

ARCH = "llama4-maverick-400b-a17b"


def test_launch_serve_steps_match_reference():
    check_quickstart_sequence("spike_fused", ARCH)


def test_logits_step_routes_in_train_mode():
    with CountDrops() as drops:
        check_logits_step("spike_fused", ARCH)
    assert drops.C == {10} and drops.dropped > 0


def test_train_cli_trains_moe(tmp_path):
    _, hist = train_cli.main([
        "--arch", "qwen2-moe-a2.7b", "--reduced", "--steps", "2",
        "--batch", "4", "--seq", "32", "--device", "cpu", "--log-every",
        "1", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2
    assert all(np.isfinite(m["loss"]) for m in hist)
