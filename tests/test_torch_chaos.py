"""The port's chaos harness (``repro_torch.serving.chaos``) against the JAX
package's (``repro.serving.chaos``).

``FaultPlan.seeded`` must draw JAX's plan; ``run_chaos`` over the same
trace, plan and weights (the JAX package's fp32 smoke weights carried
across) must give JAX's outcomes, fault counters, step count, shed rids
and tokens, with the pool audited after every step and 0 leaked pages;
every unfaulted request must keep the fault-free run's tokens. An empty
plan is the fault-free run. The CLI runs at the JAX CLI's settings.
Everything runs on the port's plain versions on the CPU.
"""
import dataclasses

import pytest

from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import run_chaos as jax_run_chaos
from repro.serving import synthetic_trace as jax_trace

from repro_torch.serving import (
    FaultPlan,
    Request,
    ServingEngine,
    assert_unfaulted_parity,
    count_leaked_pages,
    run_chaos,
    synthetic_trace,
)
from repro_torch.serving import chaos

from _torch_port import serving_pair

# the JAX chaos CLI's engine: 4 slots, ring 48, chunk 8, horizon 4, page 8
ENGINE = dict(num_slots=4, max_len=48, prefill_chunk=8, decode_horizon=4,
              page_size=8)
TRACE = dict(prompt_lens=(4, 16), gen_lens=(4, 16), mean_interarrival=1.0,
             priority_levels=2)


@pytest.fixture(scope="module")
def fp32():
    return serving_pair("fp32")


def _engine(fp32, **kw):
    _, (model, params, cfg), kv_bits = fp32
    return ServingEngine(model, params, cfg, device="cpu", kv_bits=kv_bits,
                         **{**ENGINE, **kw})


def _jax_engine(fp32, **kw):
    (jm, jp, jcfg), _, _ = fp32
    return JaxServingEngine(jm, jp, jcfg, **{**ENGINE, **kw})


def _same_report(rep, jrep):
    assert rep.outcomes == jrep.outcomes
    # straggler steps depend on wall time, not on the schedule
    drop = lambda counts: {k: v for k, v in counts.items()
                           if k != "straggler_steps"}
    assert drop(rep.counts) == drop(jrep.counts)
    assert rep.steps == jrep.steps
    assert rep.shed_rids == jrep.shed_rids
    assert rep.leaked_pages == jrep.leaked_pages == 0
    for rid, r in jrep.results.items():
        got = rep.results[rid]
        assert (got.status, got.tokens, got.finished_at) == (
            r.status, [int(t) for t in r.tokens], r.finished_at), rid
    assert rep.table() == jrep.table()


@pytest.mark.parametrize("seed", range(6))
def test_fault_plan_seeded_matches_jax(seed):
    rids = list(range(10 + 3 * seed))
    plan = FaultPlan.seeded(seed, rids, n_steps=20 + 7 * seed)
    jplan = JaxFaultPlan.seeded(seed, rids, n_steps=20 + 7 * seed)
    assert (plan.exhaust, plan.cancels, plan.nans, plan.bursts) == (
        jplan.exhaust, jplan.cancels, jplan.nans, jplan.bursts)
    assert plan.faulted_rids() == jplan.faulted_rids()
    assert not ({r for _, r in plan.cancels} & {r for _, r in plan.nans})


@pytest.mark.parametrize("seed,n,num_pages,n_steps,fast", [
    (0, 24, 12, 40, True), (3, 12, 12, 30, True), (1, 16, 10, 30, True),
    (0, 24, 12, 40, False)])
def test_run_chaos_matches_jax(fp32, seed, n, num_pages, n_steps, fast):
    """A seeded mixed plan on a starved pool (the JAX CLI's at seed 0), on
    the fast path and the stepwise one (its own schedule: faults are keyed
    by step, and a fast step may span several ticks): JAX's outcomes,
    counters, steps and tokens; 0 leaked pages; the unfaulted requests keep
    the fault-free run's tokens."""
    vocab = fp32[1][2].vocab_size
    plan = FaultPlan.seeded(seed, list(range(n)), n_steps=n_steps)
    jplan = JaxFaultPlan.seeded(seed, list(range(n)), n_steps=n_steps)
    jrep = jax_run_chaos(_jax_engine(fp32, num_pages=num_pages, fast=fast),
                         jax_trace(seed, n, vocab_size=vocab, **TRACE), jplan)
    rep = run_chaos(_engine(fp32, num_pages=num_pages, fast=fast),
                    synthetic_trace(seed, n, vocab_size=vocab, **TRACE), plan)
    _same_report(rep, jrep)
    clean = _engine(fp32).run(synthetic_trace(seed, n, vocab_size=vocab,
                                              **TRACE))
    compared = assert_unfaulted_parity(rep, clean, plan.faulted_rids())
    assert compared == n - len(plan.faulted_rids() | set(rep.shed_rids))
    assert rep.counts["cancelled"] + rep.counts["quarantined"] > 0


def test_empty_plan_is_the_fault_free_run(fp32):
    vocab = fp32[1][2].vocab_size
    trace = synthetic_trace(0, 10, vocab_size=vocab, **TRACE)
    clean = _engine(fp32).run([dataclasses.replace(r) for r in trace])
    rep = run_chaos(_engine(fp32), [dataclasses.replace(r) for r in trace],
                    FaultPlan())
    assert assert_unfaulted_parity(rep, clean, set()) == len(trace)
    assert rep.leaked_pages == 0 and not rep.shed_rids
    assert rep.counts["ok"] == len(trace)
    for rid, r in clean.items():
        assert rep.results[rid].finished_at == r.finished_at


def test_burst_and_exhaustion_faults_match_jax(fp32):
    """Bursts submitted mid-run and a reservation window drain cleanly, as
    in JAX; burst requests are unfaulted and served."""
    vocab = fp32[1][2].vocab_size
    reps = []
    for trace_fn, plan_cls, runner, eng in (
            (synthetic_trace, FaultPlan, run_chaos, _engine),
            (jax_trace, JaxFaultPlan, jax_run_chaos, _jax_engine)):
        trace = trace_fn(5, 6, vocab_size=vocab, **TRACE)
        burst = [dataclasses.replace(r, rid=100 + r.rid)
                 for r in trace_fn(6, 4, vocab_size=vocab, **TRACE)]
        plan = plan_cls(exhaust=[(2, 6, 5)], bursts=[(4, burst)])
        reps.append(runner(eng(fp32, num_pages=12), trace, plan))
    _same_report(*reps)
    served = {r for r, s in reps[0].outcomes.items() if s == "ok"}
    assert set(range(6)) | {100, 101, 102, 103} <= served


def test_count_leaked_pages_sees_a_leak(fp32):
    eng = _engine(fp32)
    eng.run([Request(rid=0, prompt=list(range(1, 10)), max_new_tokens=3)])
    assert count_leaked_pages(eng) == 0
    eng.pool._page_ref[eng.pool._free_pages[0]] += 1
    assert count_leaked_pages(eng) == 1
    assert count_leaked_pages(_engine(fp32, page_size=None)) == 0


def test_chaos_cli_smoke(tmp_path, capsys):
    """``python -m repro_torch.serving.chaos --smoke --device cpu``: the
    JAX CLI's settings, 0 leaked pages, the outcome table appended to
    ``--summary``."""
    summary = tmp_path / "summary.md"
    assert chaos._main(["--smoke", "--device", "cpu", "--summary",
                        str(summary)]) == 0
    out = capsys.readouterr().out
    assert "0 leaked pages" in out and "| leaked_pages | 0 |" in out
    assert summary.read_text().startswith("## chaos-smoke fault outcomes")
