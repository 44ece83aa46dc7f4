"""SNN mode (``hnn_mode="snn"``) of the port against the JAX reference.

In SNN mode the reference spike-codes intra-chip activations too: a
local encode -> decode roundtrip (``_maybe_snn``) on two extra
boundary params per layer, ``sp_snn`` after the attention output of
prefill and ``sp_snn2`` after every MLP output, prefill and decode
alike; the decode attention block applies none.  The reduced
``qwen1.5-0.5b`` in float32 with the JAX init, carried across with
``params_from_jax``, under ``spike_fused``, ``spike`` and
``spike_pack4``:

* ``params_from_jax`` carries ``sp_snn`` and ``sp_snn2``;
* prefill logits and prompt KV, and five teacher-forced decode steps
  over a shared pool through both attention walks, equal JAX's within
  ``LOGIT_TOL`` = 1e-5 (``test_torch_model.py``'s checks and
  tolerances);
* with codec ``none`` nothing is coded, and SNN mode serves exactly
  what ANN mode serves on the same weights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_model import (JaxModel, check_prefill,  # noqa: E402
                              check_teacher_forced)

from repro_torch.checkpoint.convert import (params_from_jax,  # noqa: E402
                                            tree_paths)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.context import make_context  # noqa: E402
from repro_torch.models.model import model_defs  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402

torch.set_num_threads(1)

CODECS = ("spike_fused", "spike", "spike_pack4")


class _Models(dict):
    """codec -> SNN-mode ``JaxModel``, each built on first use.

    Two changes to the init, made on the JAX tree before it is carried
    across, so that the SNN roundtrips change what they are given: the
    output projections ``wo`` and ``w2`` are scaled by 8 (at the init's
    0.02 the blocks' output partial sums are mostly below half a count
    step, so their boundaries decode zeros, which a roundtrip keeps),
    and the SNN roundtrips get seeded thresholds of their own, 0.05-0.3
    (at the init ``sp_snn2`` has the thresholds of the MLP's output
    boundary, and a roundtrip of what that boundary decoded returns it
    unchanged).  The log-scales stay 0, where torch's and XLA's ``exp``
    agree exactly."""

    def __missing__(self, codec):
        jm = JaxModel("snn", codec)
        rng = np.random.RandomState(15)
        units = dict(jm.params["units"])
        for pos, leaves in units.items():
            leaves = units[pos] = dict(leaves, wo=leaves["wo"] * 8,
                                       w2=leaves["w2"] * 8)
            for name in ("sp_snn", "sp_snn2"):
                theta = leaves[name]["theta"]
                leaves[name] = dict(leaves[name], theta=jnp.asarray(
                    rng.uniform(0.05, 0.3, theta.shape), theta.dtype))
        jm.params = dict(jm.params, units=units)
        jm.tparams = params_from_jax(jax.tree.map(np.asarray, jm.params),
                                     jm.tcfg, device="cpu")
        self[codec] = jm
        return jm


MODELS = _Models()


def test_params_carry_snn_boundaries():
    jm = MODELS["spike_fused"]
    assert jm.tcfg.hnn_mode == "snn"
    port = dict(tree_paths(jm.tparams))
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(jm.params)[0]}
    assert sorted(port) == sorted(flat)
    for name in ("sp_snn", "sp_snn2"):
        for leaf in ("theta", "log_scale"):
            key = f"['units']['pos0']['{name}']['{leaf}']"
            assert port[key].shape == (jm.tcfg.n_units, jm.tcfg.d_model)
            np.testing.assert_array_equal(port[key].numpy(),
                                          np.asarray(flat[key]))


@pytest.mark.parametrize("codec", CODECS)
def test_snn_prefill_logits_and_kv(codec):
    check_prefill(MODELS[codec])


@pytest.mark.parametrize("codec", CODECS)
def test_snn_teacher_forced_paged_decode(codec):
    check_teacher_forced(MODELS[codec])


def test_snn_without_a_codec_is_ann():
    """Codec ``none`` codes nothing: SNN mode's prefill and decode
    logits equal ANN mode's bit for bit on the same weights (SNN's extra
    boundary params unused)."""
    snn = reduced(get_config("qwen1.5-0.5b", hnn_mode="snn")).replace(
        codec="none", dtype=torch.float32)
    ann = snn.replace(hnn_mode="ann")
    p_snn = init_params(model_defs(snn), torch.Generator().manual_seed(0),
                        snn.dtype, device="cpu")
    units = {pos: {k: v for k, v in leaves.items()
                   if k not in ("sp_snn", "sp_snn2")}
             for pos, leaves in p_snn["units"].items()}
    p_ann = dict(p_snn, units=units)
    paths = lambda tree: [k for k, _ in tree_paths(tree)]  # noqa: E731
    assert paths(p_ann) == paths(init_params(
        model_defs(ann), torch.Generator().manual_seed(0), ann.dtype,
        device="cpu"))
    rng = np.random.RandomState(14)
    toks = torch.tensor(rng.randint(0, snn.vocab, (1, 32)), dtype=torch.int32)
    out = {}
    for cfg, params in ((snn, p_snn), (ann, p_ann)):
        ctx = make_context(cfg)
        logits, pre = TM.forward_prefill(params, toks, ctx,
                                         last_pos=torch.tensor([20]))
        cache = PagedKVCache(cfg, num_slots=1, max_seq=64, page_size=8,
                             num_pages=8, device="cpu")
        cache.allocator.alloc(21)
        cache.insert(pre, cache.block_table[0])
        cache.ensure(0, 22)
        dec, _ = TM.forward_decode(
            params, cache.buffers, torch.tensor([int(toks[0, 21])]),
            torch.tensor([21]), ctx,
            aux_extra={"block_table": torch.tensor(cache.block_table)})
        out[cfg.hnn_mode] = (logits, dec)
    for a, b in zip(out["snn"], out["ann"]):
        assert torch.equal(a, b)
