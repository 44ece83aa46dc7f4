"""The paper's Table 4 setup through the port's training CLI in
SNN mode (``test_torch_table4.py``'s check: the first step's loss
within 1e-5, relative, of the reference CLI's on the same arguments)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_table4 import check  # noqa: E402

torch.set_num_threads(1)


def test_table4_snn_first_loss_matches_jax(tmp_path, monkeypatch):
    check("snn", tmp_path, monkeypatch)
