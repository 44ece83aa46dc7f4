"""The port's single-request serve steps against the reference's.

``repro_torch.launch.serve``'s ``make_prefill_step``,
``make_decode_step``, ``make_logits_step`` and ``greedy_sample`` on the
CPU, against ``repro.launch.serve``'s steps under ``shard_map`` on a
1x1 mesh, on reduced ``gemma2-2b`` in float32 (local/global windows of
16, both softcaps, post-norms) with the JAX init's biases and norm
scales seeded nonzero (``test_torch_model.seeded_leaves``), under
``none`` (ANN mode) and ``spike_fused`` (``spike`` in
``test_torch_dense_decode_spike.py``, so that each file's JAX steps
compile within its time):

* the quickstart's sequence: a prefill of ``smoke_shape``'s batch
  (B = 2, S = 32), then four greedy decode steps at ``pos = S - 1 + t``
  over the dense per-slot cache it returned.  Positions S and on lie
  past the cache: the step writes nothing there, and still attends to
  every entry;
* the same after the prefill with per-slot positions [B], one slot
  inside the cache (it overwrites its prompt's rows) and one past it;
* the teacher-forced full-sequence logits.

Both sides get the same tokens at every step (the JAX step's greedy
ones).  Logits agree within 1e-5 and the caches within 1e-5, as in
``test_torch_model.py`` (float32 on both sides, summed in different
orders); greedy tokens are equal wherever the JAX margin exceeds 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_model import MARGIN, margin, seeded_leaves  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeCell, smoke_shape  # noqa: E402
from repro.configs.reduced import reduced as jax_reduced  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.launch import train as TR  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402

from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402

torch.set_num_threads(1)

ARCH = "gemma2-2b"
TOL = 1e-5
CODECS = (("ann", "none"), ("hnn", "spike_fused"), ("hnn", "spike"))
#: the codecs this file runs
HERE = ("none", "spike_fused")
CELL = smoke_shape("decode")
B, S = CELL.global_batch, CELL.seq_len


class Steps:
    """Both sides' steps at one codec, built (and compiled) once."""

    def __init__(self, hnn, codec, arch=ARCH):
        self.jcfg = jax_reduced(jax_get_config(arch, hnn_mode=hnn)).replace(
            codec=codec, dtype=jnp.float32)
        self.tcfg = reduced(get_config(arch, hnn_mode=hnn)).replace(
            codec=codec, dtype=torch.float32)
        mesh = make_mesh((1, 1), ("data", "model"))
        plan = SP.make_plan(self.jcfg, ShapeCell("d", S, B, "decode"), mesh)
        tplan = SP.make_plan(self.jcfg, smoke_shape("train"), mesh)
        self.params = seeded_leaves(TR.init_sharded_params(
            self.jcfg, plan, mesh, jax.random.PRNGKey(0)))
        self.tparams = params_from_jax(jax.tree.map(np.asarray, self.params),
                                       self.tcfg, device="cpu")
        self.jpre = JSV.make_prefill_step(self.jcfg, plan, mesh)[0]
        self.jdec = JSV.make_decode_step(self.jcfg, plan, mesh)[0]
        self.jlog = JSV.make_logits_step(self.jcfg, tplan, mesh)
        self.tpre = TSV.make_prefill_step(self.tcfg, device="cpu")
        self.tdec = TSV.make_decode_step(self.tcfg, device="cpu")
        self.tlog = TSV.make_logits_step(self.tcfg, device="cpu")


_STEPS = {}


def steps(codec, arch=ARCH) -> Steps:
    if (codec, arch) not in _STEPS:
        hnn = {c: h for h, c in CODECS}[codec]
        _STEPS[codec, arch] = Steps(hnn, codec, arch)
    return _STEPS[codec, arch]


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(
        np.int32)


def _assert_caches_close(tcache, jcache):
    """Every leaf: KV and, at recurrent positions, the state."""
    assert sorted(tcache) == sorted(jcache)
    for pos in jcache:
        assert sorted(tcache[pos]) == sorted(jcache[pos])
        for key, leaves in jcache[pos].items():
            for n, want in leaves.items():
                np.testing.assert_allclose(tcache[pos][key][n].numpy(),
                                           np.asarray(want), atol=TOL,
                                           rtol=TOL, err_msg=f"{pos}/{n}")


def _assert_logits_close(tl, jl):
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, atol=TOL, rtol=0)
    greedy = TSV.greedy_sample(tl)
    assert greedy.dtype == torch.int32
    for b in range(jl.shape[0]):
        if margin(jl[b]) > MARGIN:
            assert int(greedy[b]) == int(np.argmax(jl[b]))


def _prefill(st, tok):
    jl, jcache = st.jpre(st.params, {"tokens": jnp.array(tok),
                                     "labels": jnp.array(tok)})
    tl, tcache = st.tpre(st.tparams, {"tokens": torch.tensor(tok)})
    assert tl.shape == (B, st.tcfg.vocab)
    _assert_logits_close(tl, jl)
    for c in jcache.values():
        for key, leaves in c.items():
            for leaf in leaves.values():
                assert leaf.shape[1:3 if key == "kv" else 2] == (
                    (B, S) if key == "kv" else (B,))
    _assert_caches_close(tcache, jcache)
    return np.asarray(jl), jcache, tcache


def _decode_walk(st, tok, positions):
    """Prefill, then one decode step per entry of ``positions`` (each an
    int or a [B] array), both sides fed the JAX step's greedy tokens."""
    jl, jcache, tcache = _prefill(st, tok)
    for pos in positions:
        nxt = np.argmax(jl, -1).astype(np.int32)
        jl, jcache = st.jdec(st.params, jcache, jnp.array(nxt),
                             jnp.asarray(pos, jnp.int32))
        tl, tcache = st.tdec(st.tparams, tcache, torch.tensor(nxt),
                             torch.as_tensor(pos, dtype=torch.int32))
        _assert_logits_close(tl, jl)
        _assert_caches_close(tcache, jcache)
        jl = np.asarray(jl)


@pytest.mark.parametrize("codec", HERE)
def test_quickstart_sequence_matches_reference(codec):
    check_quickstart_sequence(codec)


def check_quickstart_sequence(codec, arch=ARCH):
    """Prefill, then four steps at pos = S - 1 + t: the first rewrites
    the last prompt row, the others lie past the cache."""
    _decode_walk(steps(codec, arch), _tokens(1),
                 [S - 1 + t for t in range(4)])


@pytest.mark.parametrize("codec", HERE)
def test_per_slot_positions_match_reference(codec):
    check_per_slot_positions(codec)


def check_per_slot_positions(codec):
    """Per-slot positions: slot 0 steps on from inside the cache (its
    window of 16 then excludes the prompt's first rows) while slot 1
    lies past it."""
    _decode_walk(steps(codec), _tokens(2),
                 [np.array([20 + t, S + 3 + t], np.int32) for t in range(4)])


def test_past_the_cache_is_not_written():
    """A step whose positions all lie past the cache leaves it as it
    was; one inside writes only its slot's row at its position."""
    st = steps("none")
    _, _, tcache = _prefill(st, _tokens(3))
    before = {p: {n: t.clone() for n, t in c["kv"].items()}
              for p, c in tcache.items()}
    nxt = torch.zeros(B, dtype=torch.int32)
    st.tdec(st.tparams, tcache, nxt, S + 5)
    for p, c in tcache.items():
        for n in ("k", "v"):
            assert torch.equal(c["kv"][n], before[p][n])
    st.tdec(st.tparams, tcache, nxt, torch.tensor([7, S], dtype=torch.int32))
    for p, c in tcache.items():
        for n in ("k", "v"):
            changed = (c["kv"][n] != before[p][n]).any(-1).any(-1)
            assert changed[:, 0, 7].all() and changed.sum() == len(changed)


@pytest.mark.parametrize("codec", HERE)
def test_logits_step_matches_reference(codec):
    check_logits_step(codec)


def check_logits_step(codec, arch=ARCH):
    st = steps(codec, arch)
    tok = _tokens(4)
    jl = np.asarray(st.jlog(st.params, {"tokens": jnp.array(tok),
                                        "labels": jnp.array(tok)}))
    tl = st.tlog(st.tparams, {"tokens": torch.tensor(tok)})
    assert tl.shape == (B, S, st.tcfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), jl, atol=TOL, rtol=0)


def test_steps_need_a_card_or_the_cpu():
    cfg = steps("none").tcfg
    if not torch.cuda.is_available():
        for make in (TSV.make_prefill_step, TSV.make_decode_step,
                     TSV.make_logits_step):
            with pytest.raises(RuntimeError):
                make(cfg)
    dec = TSV.make_decode_step(cfg, device="meta")
    with pytest.raises(ValueError):
        dec(steps("none").tparams, {}, torch.zeros(B, dtype=torch.int32), 0)
