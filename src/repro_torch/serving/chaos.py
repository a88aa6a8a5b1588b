"""Deterministic fault-injection chaos harness for the serving engine (port
of ``repro.serving.chaos``).

A ``FaultPlan`` is a seeded, fully host-side schedule of faults keyed by
engine-step index (the number of ``step()`` calls — deterministic for a
fixed engine config and trace, and independent of token values):

  * **pool exhaustion** — ``CachePool.reserve_pages`` withholds free pages
    for a window of steps, forcing admission up the exhaustion ladder
    (LRU eviction → preemption → head-of-line blocking);
  * **arrival bursts** — extra requests submitted mid-run (arrival = the
    clock at injection);
  * **cancellations** — ``engine.cancel(rid)`` at a chosen step;
  * **non-finite logits** — ``engine.inject_bad(rid)`` marks one row bad at
    its next host sync, exercising quarantine without poisoning device
    state.

``run_chaos`` steps the engine, applies due faults before each step, runs
``engine.check_invariants()`` (refcount conservation, free-heap
consistency, no slot maps a freed page) after EVERY step, and returns a
``ChaosReport``. The invariant under test: every request the plan did NOT
fault — preempted-then-resumed ones included — finishes with the tokens
of a fault-free run (``assert_unfaulted_parity``).

CLI (the JAX CLI's engine settings; the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.serving.chaos --smoke --device cpu
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .errors import ServingError
from .scheduler import Request


@dataclasses.dataclass
class FaultPlan:
    """Faults keyed by engine-step index. Build explicitly, or draw a mixed
    plan from a seed with ``FaultPlan.seeded``."""

    # (step, n_pages, hold_steps): reserve up to n_pages free pages at
    # `step`, return them hold_steps steps later
    exhaust: list = dataclasses.field(default_factory=list)
    # (step, rid): client cancellation issued before `step`
    cancels: list = dataclasses.field(default_factory=list)
    # (step, rid): non-finite logits injected for rid's row
    nans: list = dataclasses.field(default_factory=list)
    # (step, [Request, ...]): extra arrivals submitted before `step`
    bursts: list = dataclasses.field(default_factory=list)

    def faulted_rids(self) -> set:
        """Rids whose own tokens the plan corrupts or truncates (cancels +
        NaN injections). Exhaustion and bursts reshuffle scheduling only —
        requests they touch must STILL match the fault-free run."""
        return ({rid for _, rid in self.cancels}
                | {rid for _, rid in self.nans})

    @classmethod
    def seeded(cls, seed: int, rids: Sequence[int], n_steps: int, *,
               n_exhaust: int = 2, exhaust_pages: int = 4,
               exhaust_hold: int = 8, n_cancels: int = 2,
               n_nans: int = 2) -> "FaultPlan":
        """A mixed plan drawn deterministically from ``seed``: exhaustion
        windows at random steps, plus cancellations and NaN injections over
        disjoint random victims from ``rids`` (disjoint so each outcome is
        attributable to exactly one fault)."""
        rng = np.random.RandomState(seed)
        rids = list(rids)
        n_victims = min(len(rids), n_cancels + n_nans)
        victims = [rids[i] for i in
                   rng.choice(len(rids), size=n_victims, replace=False)]
        plan = cls()
        for _ in range(n_exhaust):
            plan.exhaust.append((int(rng.randint(0, max(1, n_steps))),
                                 exhaust_pages, exhaust_hold))
        for rid in victims[:n_cancels]:
            plan.cancels.append((int(rng.randint(0, max(1, n_steps))),
                                 int(rid)))
        for rid in victims[n_cancels:]:
            plan.nans.append((int(rng.randint(0, max(1, n_steps))),
                              int(rid)))
        return plan


@dataclasses.dataclass
class ChaosReport:
    results: dict            # rid → RequestResult (everything that finished)
    outcomes: dict           # rid → status string ("ok", "expired", ...)
    counts: dict             # status → count, plus engine fault counters
    steps: int               # engine steps driven
    leaked_pages: int        # pages neither free nor prefix-index-pinned
    shed_rids: list          # rids rejected at submit (QueueFull)

    def table(self) -> str:
        """Markdown fault-outcome table (the chaos-smoke step summary)."""
        lines = ["| outcome | count |", "|---|---|"]
        for key in ("ok", "preempted", "resumed", "shed", "cancelled",
                    "expired", "quarantined", "leaked_pages"):
            lines.append(f"| {key} | {self.counts.get(key, 0)} |")
        return "\n".join(lines)


class FaultInjector:
    """Replays one ``FaultPlan`` against one engine, keyed by step index.

    The harness half of the plan, apart from the step loop so that another
    driver than ``run_chaos`` can share it bit for bit (the JAX package's
    async server wires it into its step hooks). Call ``apply_due(step)``
    BEFORE the engine step with that index, ``release_due(step)`` after;
    ``drain()``
    returns any still-held pages once the run is over (a plan whose last
    hold outlives the work must not count as a leak)."""

    def __init__(self, engine, plan: FaultPlan):
        self.engine = engine
        self._exhaust = sorted(plan.exhaust)
        self._cancels = sorted(plan.cancels)
        self._nans = sorted(plan.nans)
        self._bursts = sorted(plan.bursts, key=lambda e: e[0])
        self._holds: list = []    # (release_step, reserved_pages)
        self.shed_rids: list = []  # burst requests rejected at submit

    @staticmethod
    def _due(events: list, now: int) -> list:
        out = []
        while events and events[0][0] <= now:
            out.append(events.pop(0))
        return out

    def pending(self) -> bool:
        """Whether any fault has yet to fire or any hold to release."""
        return bool(self._exhaust or self._cancels or self._nans
                    or self._bursts or self._holds)

    def holds_active(self) -> bool:
        return bool(self._holds)

    def apply_due(self, step: int) -> None:
        """Fire every fault scheduled at or before ``step`` (pre-step)."""
        engine = self.engine
        for _, n_pages, hold in self._due(self._exhaust, step):
            if engine.paged:
                self._holds.append((step + hold,
                                    engine.pool.reserve_pages(n_pages)))
        for _, rid in self._due(self._cancels, step):
            engine.cancel(rid)
        for _, rid in self._due(self._nans, step):
            engine.inject_bad(rid)
        for _, reqs in self._due(self._bursts, step):
            for r in reqs:
                try:
                    # re-stamping arrival can push it past the request's
                    # deadline — __post_init__ raises ValueError then
                    engine.submit(dataclasses.replace(
                        r, arrival=engine.clock))
                except (ServingError, ValueError):
                    self.shed_rids.append(r.rid)

    def release_due(self, step: int) -> None:
        """Return reserved pages whose hold window ended (post-step)."""
        for release_step, pages in [h for h in self._holds
                                    if h[0] <= step]:
            self.engine.pool.release_reserved(pages)
            self._holds.remove((release_step, pages))

    def drain(self) -> None:
        """Release every remaining hold unconditionally (end of run)."""
        for _, pages in self._holds:
            self.engine.pool.release_reserved(pages)
        self._holds.clear()


def count_leaked_pages(engine) -> int:
    """Pages still referenced but neither slot-mapped-and-live nor pinned by
    the ``PrefixIndex`` after a drain — must be zero; anything else is a
    refcount leak. Contiguous (non-paged) engines trivially report 0."""
    if not engine.paged:
        return 0
    pinned = (set(engine.prefix_index.pages())
              if engine.prefix_index is not None else set())
    leaked = 0
    for p in range(engine.pool.num_pages):
        if engine.pool.page_ref(p) > 0 and p not in pinned:
            leaked += 1
    return leaked


def run_chaos(engine, requests: Sequence[Request], plan: FaultPlan, *,
              max_steps: int = 100_000) -> ChaosReport:
    """Serve ``requests`` under ``plan``, checking pool invariants after
    every step. Raises AssertionError the moment bookkeeping is violated;
    returns the report once the engine drains and all holds are released."""
    shed_rids: list = []
    for r in requests:
        try:
            engine.submit(r)
        except ServingError:
            shed_rids.append(r.rid)

    injector = FaultInjector(engine, plan)
    results: dict = {}
    step = 0
    base = dict(engine.stats)

    while (engine._inflight or engine._parked
           or engine.scheduler.pending() or injector.pending()):
        if step >= max_steps:
            raise AssertionError(
                f"chaos run did not drain within {max_steps} steps")
        injector.apply_due(step)
        engine.step()
        step += 1
        injector.release_due(step)
        engine.check_invariants()
        results.update(engine.results)
        engine.results = {}
    shed_rids.extend(injector.shed_rids)

    leaked = count_leaked_pages(engine)
    outcomes = {rid: res.status for rid, res in results.items()}
    for rid in shed_rids:
        outcomes[rid] = "shed"
    counts: dict = {}
    for status in outcomes.values():
        counts[status] = counts.get(status, 0) + 1
    for key in ("preempted", "resumed", "shed", "cancelled", "expired",
                "quarantined", "straggler_steps"):
        counts[key] = engine.stats[key] - base[key]
    counts["leaked_pages"] = leaked
    return ChaosReport(results=results, outcomes=outcomes, counts=counts,
                       steps=step, leaked_pages=leaked, shed_rids=shed_rids)


def assert_unfaulted_parity(report: ChaosReport, clean_results: dict,
                            faulted_rids: set) -> int:
    """Every request the plan did not fault must have finished ok with
    tokens bit-identical to the fault-free run — preempted-then-resumed
    requests included (resume re-prefills through the prefix-reuse path and
    must reproduce the identical continuation). Returns the number of
    requests compared."""
    compared = 0
    for rid, clean in clean_results.items():
        if rid in faulted_rids or rid in report.shed_rids:
            continue
        got = report.results.get(rid)
        if got is None:
            raise AssertionError(f"unfaulted request {rid} never finished")
        if got.status != "ok":
            raise AssertionError(f"unfaulted request {rid} finished with "
                                 f"status {got.status!r}")
        if list(got.tokens) != list(clean.tokens):
            raise AssertionError(
                f"unfaulted request {rid} diverged from the fault-free run:\n"
                f"  chaos: {got.tokens}\n  clean: {clean.tokens}")
        compared += 1
    return compared


# ----------------------------------------------------------------- CLI
def _main(argv: Optional[Sequence[str]] = None) -> int:
    """Seeded chaos smoke over a smoke-size model: a mixed ``FaultPlan`` on
    a starved paged pool, invariants checked every step, unfaulted parity
    against a fault-free twin. Appends the fault-outcome table to
    ``--summary``."""
    import argparse
    import dataclasses as dc
    import pathlib

    from ..configs import get_config
    from ..device import resolve_device
    from ..models import build_model
    from .engine import ServingEngine
    from .trace import synthetic_trace

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=24, help="trace length")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny dims (the model is the smoke config either "
                         "way, as in the JAX CLI)")
    ap.add_argument("--summary", type=pathlib.Path, default=None,
                    help="append the fault-outcome table to this file")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = dc.replace(get_config("qwen2-0.5b", smoke=True),
                     name="qwen2-chaos-smoke")
    model = build_model(cfg)
    params = model.init(0, device=device)

    kw = dict(num_slots=4, max_len=48, prefill_chunk=8, decode_horizon=4,
              page_size=8, device=device)
    trace = synthetic_trace(args.seed, args.n, vocab_size=cfg.vocab_size,
                            prompt_lens=(4, 16), gen_lens=(4, 16),
                            mean_interarrival=1.0, priority_levels=2)
    # fault-free twin first (full page pool, no faults)
    clean = ServingEngine(model, params, cfg, **kw).run(
        [dc.replace(r) for r in trace])

    # chaos engine: a starved page pool (2 slots' worth for 4 slots), so
    # the plan's reservations push admission up the ladder
    engine = ServingEngine(model, params, cfg, num_pages=2 * (48 // 8), **kw)
    plan = FaultPlan.seeded(args.seed, [r.rid for r in trace], n_steps=40)
    report = run_chaos(engine, [dc.replace(r) for r in trace], plan)
    compared = assert_unfaulted_parity(report, clean, plan.faulted_rids())
    if report.leaked_pages:
        raise AssertionError(f"{report.leaked_pages} pages leaked at drain")

    table = report.table()
    print(f"chaos: {report.steps} steps, {compared} unfaulted requests "
          f"bit-identical, 0 leaked pages")
    print(table)
    if args.summary is not None:
        with open(args.summary, "a") as f:
            f.write("## chaos-smoke fault outcomes\n\n" + table + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
