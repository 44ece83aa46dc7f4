"""The port's workload traces, SLO monitor and fault injector against the
JAX package's, on the CPU.

Both sides are host-side numpy, so everything is held to exact equality:

* ``make_trace`` / ``zoo_mix`` / ``preset_trace`` (every preset, several
  seeds, budgets, a fixed prompt length and distinct-token prompts):
  the same traces field by field, and the same ``RequestClass``
  validation errors;
* one scripted lifecycle — submits, admissions, first tokens, finishes,
  preemptions of each kind, a suspend, a migration, ticks of both step
  kinds with and without registered wire bytes — fed to a JAX and a
  port ``SLOMonitor`` on one fake clock: equal request records, step
  events, ``report()``, ``per_class_report()`` and ``step_trace()``;
  the trace file round-trips through ``write_trace`` / ``load_trace``;
* ``FaultInjector.next_fault`` sequences for one plan and seed, and
  what ``on_step`` does to a stub engine; ``FaultPlan`` validation;
* ``replay`` on the logical clock: the same submissions at the same
  ticks into a stub engine, and on the port's engine the streams of a
  plain ``run``, with a monitor on a fake clock.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import slo as JSLO  # noqa: E402
from repro.serving import workload as JW  # noqa: E402

from repro_torch.serving import slo as TSLO  # noqa: E402
from repro_torch.serving import workload as TW  # noqa: E402

torch.set_num_threads(1)


def trace_fields(trace):
    return (trace.horizon_s, trace.seed,
            [(tr.t, tr.cls, tr.req.rid, list(tr.req.prompt),
              tr.req.max_new_tokens, tr.req.temperature)
             for tr in trace.requests])


@pytest.mark.parametrize("name", sorted(JW.PRESETS))
def test_preset_traces_equal(name):
    assert sorted(TW.PRESETS) == sorted(JW.PRESETS)
    assert TW.PRESETS[name][1] == JW.PRESETS[name][1]
    for seed, prefill, gen, load, fixed in ((0, 16, 16, 8.0, None),
                                            (7, 120, 32, 3.0, None),
                                            (11, 32, 8, 20.0, 32)):
        kw = dict(horizon_s=4.0, seed=seed, prefill_len=prefill,
                  max_gen=gen, load=load, vocab=1000, fixed_prompt_len=fixed)
        j, t = JW.preset_trace(name, **kw), TW.preset_trace(name, **kw)
        assert len(j) > 0 and trace_fields(t) == trace_fields(j)
        assert sorted(t.by_class()) == sorted(j.by_class())


def test_make_trace_and_zoo_mix_equal():
    for prefill, gen, load in ((16, 16, 8.0), (120, 32, 2.5), (3, 2, 50.0)):
        jz, tz = JW.zoo_mix(prefill, gen, load), TW.zoo_mix(prefill, gen,
                                                            load)
        assert ([dataclasses.asdict(c) for c in tz]
                == [dataclasses.asdict(c) for c in jz])
    classes = [dict(name="a", rate=5.0, tail_p=0.3, tail_len=(20, 30),
                    temperature=0.7),
               dict(name="b", rate=2.0, arrival="onoff", on_s=0.3,
                    off_s=0.9, distinct_tokens=True, prompt_len=(3, 9))]
    for seed in (0, 1, 12345):
        j = JW.make_trace([JW.RequestClass(**c) for c in classes], 3.0,
                          seed=seed, vocab=64, max_prompt_len=24,
                          max_gen=6)
        t = TW.make_trace([TW.RequestClass(**c) for c in classes], 3.0,
                          seed=seed, vocab=64, max_prompt_len=24,
                          max_gen=6)
        assert len(j) > 0 and trace_fields(t) == trace_fields(j)


def test_request_class_and_trace_errors_match():
    bad = (dict(rate=0.0), dict(rate=1.0, arrival="burst"),
           dict(rate=1.0, prompt_len=(0, 4)), dict(rate=1.0,
                                                   gen_len=(5, 4)),
           dict(rate=1.0, tail_p=1.5))
    for kw in bad:
        with pytest.raises(ValueError) as je:
            JW.RequestClass("x", **kw)
        with pytest.raises(ValueError) as te:
            TW.RequestClass("x", **kw)
        assert str(te.value) == str(je.value)
    for mod in (JW, TW):
        with pytest.raises(ValueError):
            mod.make_trace([], 1.0)
        with pytest.raises(ValueError):
            mod.preset_trace("nope", 1.0)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def stub_engine(**kw):
    alloc = types.SimpleNamespace(pages_in_use=kw.pop("pages", 0),
                                  pages_in_limbo=kw.pop("limbo", 0))
    base = dict(spec_k=0, tokens_generated=0, decode_steps=0,
                queue_depth=0, num_active=0, spec_commits=0,
                spec_verifies=0, cache=types.SimpleNamespace(
                    allocator=alloc))
    return types.SimpleNamespace(**{**base, **kw})


def script(mon, clock, jax_side):
    """One lifecycle, step by step; the engine snapshots are stubs."""
    warmup = JSLO.WARMUP_RID if jax_side else TSLO.WARMUP_RID
    rids = ["t0/chat/0", "t0/chat/1", "t0/batch/0", 7]
    clock.t += 0.01
    mon.on_submit(warmup, 4)
    for i, rid in enumerate(rids):
        mon.on_submit(rid, 5 + i)
        clock.t += 0.003
    ticks = [
        dict(tokens_generated=3, decode_steps=1, queue_depth=1,
             num_active=3, pages=7),
        dict(tokens_generated=7, decode_steps=2, queue_depth=1,
             num_active=3, pages=8, limbo=2),
        dict(tokens_generated=12, decode_steps=3, spec_k=2,
             spec_commits=9, spec_verifies=4, num_active=4, pages=9),
        dict(tokens_generated=12, decode_steps=3, spec_k=2,
             spec_commits=9, spec_verifies=4),
        dict(tokens_generated=20, decode_steps=5, spec_k=2,
             spec_commits=17, spec_verifies=8, num_active=2, pages=4,
             limbo=1),
    ]
    events = [
        lambda: [mon.on_first_token(r) for r in rids[:3]],
        lambda: (mon.on_preempt(rids[1], "pool_pressure"),
                 mon.on_first_token(rids[3])),
        lambda: (mon.on_finish(rids[0], 6), mon.on_suspend([rids[2]]),
                 mon.on_migrate(rids[3], 0, 1, 4096)),
        lambda: (mon.on_first_token(rids[1]), mon.on_first_token(rids[2]),
                 mon.on_preempt(rids[2], "replica_loss")),
        lambda: (mon.on_first_token(rids[2]), mon.on_finish(rids[1], 9),
                 mon.on_finish(rids[2], 1), mon.on_finish(rids[3], 4),
                 mon.on_migrate(rids[0], 1, 0, 512)),
    ]
    for tick, event in zip(ticks, events):
        clock.t += 0.0172
        event()
        clock.t += 0.0041
        mon.on_step(stub_engine(**tick))


@pytest.mark.parametrize("register", ["none", "scalar", "streams"])
def test_slo_monitor_records_equal(register, tmp_path):
    kw = {"none": {},
          "scalar": {"wire_bytes_per_step": {"decode": 1000.0}},
          "streams": {"wire_streams_per_step": {
              "decode": {"psum": 600.0, "head_all_gather": 200.0},
              "verify": {"psum": 2400.0, "partial_combine": 300.0}}}}[
                  register]
    targets = dict(ttft_ms=70.0, tpot_ms=10.0)
    out = []
    for side, mod in ((True, JSLO), (False, TSLO)):
        clock = FakeClock()
        mon = mod.SLOMonitor(mod.SLOTargets(**targets), clock=clock, **kw)
        with pytest.warns(RuntimeWarning) if register == "scalar" else \
                _no_warning():
            script(mon, clock, side)
        path = tmp_path / f"{side}.jsonl"
        mon.write_trace(str(path))
        out.append(({r: dataclasses.asdict(v)
                     for r, v in mon.requests.items()},
                    [dataclasses.asdict(s) for s in mon.steps],
                    mon.report(), mon.per_class_report(), mon.step_trace(),
                    mod.load_trace(str(path))))
    j, t = out
    assert t == j
    report = t[2]
    assert report["requests"]["finished"] == 4
    assert report["faults"] == {"preemptions": 2, "suspends": 1}
    assert 0.0 < report["slo"]["attainment"] < 1.0
    assert TSLO.percentiles([3.0, 1.0, 2.0]) == JSLO.percentiles(
        [3.0, 1.0, 2.0])
    assert TSLO.percentiles([]) == JSLO.percentiles([])


class _no_warning:
    def __enter__(self):
        import warnings
        self.cm = warnings.catch_warnings()
        self.cm.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        return self.cm.__exit__(*exc)


class StubFaultEngine:
    """What ``FaultInjector.on_step`` calls, recorded."""

    def __init__(self, active, queue):
        self.active, self.queue_depth, self.calls = list(active), queue, []

    def active_slots(self):
        return list(self.active)

    def preempt_slot(self, slot, kind):
        self.calls.append(("preempt_slot", slot, kind))

    def suspend(self):
        self.calls.append(("suspend",))
        return ["snap"]

    def resume(self, entries):
        self.calls.append(("resume", tuple(entries)))


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_fault_injector_sequences_equal(seed):
    plan = dict(seed=seed, p_preempt=0.2, p_replica_loss=0.15,
                p_suspend=0.1, max_faults=9)
    ji, ti = JSLO.FaultInjector(JSLO.FaultPlan(**plan)), TSLO.FaultInjector(
        TSLO.FaultPlan(**plan))
    assert [ji.next_fault() for _ in range(300)] == [
        ti.next_fault() for _ in range(300)]
    ji, ti = JSLO.FaultInjector(JSLO.FaultPlan(**plan)), TSLO.FaultInjector(
        TSLO.FaultPlan(**plan))
    rng = np.random.RandomState(seed)
    for _ in range(80):
        active = sorted(rng.choice(8, rng.randint(0, 4), replace=False))
        queue = int(rng.randint(0, 2))
        je, te = StubFaultEngine(active, queue), StubFaultEngine(active,
                                                                 queue)
        ji.on_step(je)
        ti.on_step(te)
        assert te.calls == je.calls
    assert ti.injected == ji.injected and ti.total_injected == 9


def test_fault_plan_validation_matches():
    for kw in (dict(p_preempt=0.6, p_replica_loss=0.3, p_suspend=0.2),
               dict(p_suspend=1.01)):
        with pytest.raises(ValueError) as je:
            JSLO.FaultPlan(**kw)
        with pytest.raises(ValueError) as te:
            TSLO.FaultPlan(**kw)
        assert str(te.value) == str(je.value)
    assert dataclasses.asdict(TSLO.FaultPlan()) == dataclasses.asdict(
        JSLO.FaultPlan())
    assert dataclasses.asdict(TSLO.SLOTargets()) == dataclasses.asdict(
        JSLO.SLOTargets())


class StubServe:
    """An engine for ``replay``: each submitted request finishes two
    ticks after its submission, with its tick of submission as output."""

    def __init__(self):
        self.observers, self.tick, self.live = [], 0, []

    def submit(self, req):
        self.live.append((req, self.tick))

    def step(self):
        self.tick += 1
        done = [(r, [t]) for r, t in self.live if self.tick - t >= 2]
        self.live = [(r, t) for r, t in self.live if self.tick - t < 2]
        return done

    @property
    def idle(self):
        return not self.live

    num_active = 0


def test_replay_submits_on_the_logical_clock():
    for steps_per_s in (5.0, 50.0):
        j = JW.replay(StubServe(), JW.preset_trace("bursty", 3.0, seed=2),
                      steps_per_s=steps_per_s)
        t = TW.replay(StubServe(), TW.preset_trace("bursty", 3.0, seed=2),
                      steps_per_s=steps_per_s)
        assert t == j and len(t) > 3


@pytest.mark.parametrize("depth", [0, 1])
def test_replay_through_the_port_engine(depth):
    """A preset trace replayed into the port's engine gives the streams
    of a plain ``run`` of its requests; the monitor on a fake clock sees
    every request submitted, first-token and finished."""
    from test_torch_async import assert_drained, make_engine
    from test_torch_model import PREFILL
    trace = TW.preset_trace("multitenant", 1.5, seed=5, prefill_len=PREFILL,
                            max_gen=6, vocab=256)
    ref = make_engine("spike_fused").run([tr.req for tr in trace.requests])
    eng = make_engine("spike_fused", async_depth=depth)
    clock = FakeClock()
    mon = TSLO.SLOMonitor(clock=clock)

    class Tick:
        def on_step(self, engine):
            clock.t += 0.05

    out = TW.replay(eng, trace, observers=(mon, Tick()), steps_per_s=10.0)
    assert out == ref and len(out) == len(trace) > 3
    assert_drained(eng)
    rep = mon.report()
    assert rep["requests"] == {"submitted": len(trace),
                               "finished": len(trace), "restarts": 0}
    assert rep["ttft_ms"]["n"] == len(trace) and rep["tpot_ms"]["n"] > 0
