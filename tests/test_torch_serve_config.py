"""The port's ``ServeConfig`` and launcher against the JAX package's
(``tests/test_serve_config.py`` restated, less its mesh case): the argparse
surface derived from the dataclass, every JAX field (``lint`` with a
test of its own) present with its flag and default, the validation, the artifact
round trip and precedence rule (``recipe`` baked), and the launcher's
behaviours — batch mode on the JAX calibration ids, ``--recipe`` /
``--save`` / ``--verbose``, the bounded queue's shed list, the SIGTERM
drain, and ``--serve-async``, whose admission report equals the JAX
launcher's on the same trace."""
import dataclasses
import os
import signal
import types

import numpy as np
import pytest

import repro
from repro.launch.serve_config import ServeConfig as JaxServeConfig
from repro.launch.serve_config import build_parser as jax_build_parser

import repro_torch
from repro_torch.data import calibration_tokens
from repro_torch.launch.serve_config import (
    ServeConfig,
    ServeConfigError,
    build_parser,
)
from repro_torch.quantized.qtensor import QTensor

import torch

#: the JAX fields the port lacks: none (``lint`` came with the graph
#: linter, and has a test of its own below)
NOT_PORTED: set = set()
LINT = {"lint"}


def _fake_artifact(recipe="serve-w8a8-kv8", kv_bits=8,
                   arch="qwen2-0.5b-smoke", mode="w8a8"):
    """Duck-typed QuantizedModel: just what from_artifact reads."""
    w = QTensor(torch.zeros((2, 4), dtype=torch.int8), torch.ones(1), mode)
    return types.SimpleNamespace(
        recipe=types.SimpleNamespace(name=recipe),
        cfg=types.SimpleNamespace(name=arch, kv_cache_bits=kv_bits),
        params={"blocks": {"attn": {"wq": w}}})


# ------------------------------------------------------- args <-> config

def test_defaults_round_trip_through_argparse():
    ns = build_parser().parse_args([])
    assert ServeConfig.from_args(ns) == ServeConfig()


def test_every_field_has_a_flag():
    ns = build_parser().parse_args([])
    for f in dataclasses.fields(ServeConfig):
        assert hasattr(ns, f.name), f"field {f.name} lost its CLI face"


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def _same_flags(names):
    jact, pact = _actions(jax_build_parser()), _actions(build_parser())
    for name in sorted(names):
        j, p = jact[name], pact[name]
        assert p.option_strings == j.option_strings, name
        assert p.default == j.default, name
        assert p.type == j.type, name
        assert type(p).__name__ == type(j).__name__, name
        if j.choices is not None:
            assert list(p.choices) == list(j.choices), name


def test_every_jax_field_but_lint_has_its_port_twin():
    """Each JAX ``ServeConfig`` field except ``lint`` (tested below) is a
    port field of the same name, with the same flag, default, type, choices
    and kind of switch; no JAX field is missing."""
    jax_fields = {f.name for f in dataclasses.fields(JaxServeConfig)}
    port_fields = {f.name for f in dataclasses.fields(ServeConfig)}
    assert jax_fields - port_fields == NOT_PORTED
    _same_flags(jax_fields - NOT_PORTED - LINT)
    assert ServeConfig().trace == JaxServeConfig().trace == 0


def test_lint_has_its_port_twin():
    """``lint`` (the graph linter before serving, warn-only) has the JAX
    field's flag, default and switch, and sits after ``deadline`` as
    there."""
    _same_flags(LINT)
    names = [f.name for f in dataclasses.fields(ServeConfig)]
    jax_names = [f.name for f in dataclasses.fields(JaxServeConfig)]
    assert names[names.index("deadline") + 1] == "lint"
    assert jax_names[jax_names.index("deadline") + 1] == "lint"
    assert ServeConfig().lint is False
    assert ServeConfig.from_args(build_parser().parse_args(["--lint"])).lint


def test_args_to_config_values():
    ns = build_parser().parse_args([
        "--arch", "qwen2-0.5b", "--smoke", "--quantize", "w8a8",
        "--kv-bits", "8", "--slots", "8", "--no-prefix-reuse",
        "--page-size", "16", "--trace", "12", "--qps", "1.5",
        "--serve-async", "--recipe", "serve-w8a8", "--max-queue", "3",
        "--timeout", "40", "--retry-attempts", "2", "--breaker-cooldown",
        "9", "--shed-pressure", "0.25", "--batch", "6", "--verbose",
        "--save", "/tmp/x",
    ])
    c = ServeConfig.from_args(ns)
    assert c.smoke and c.quantize == "w8a8" and c.kv_bits == 8
    assert c.slots == 8 and not c.prefix_reuse and c.page_size == 16
    assert c.trace == 12 and c.serve_async and c.qps == 1.5
    assert (c.recipe, c.max_queue, c.timeout, c.retry_attempts,
            c.breaker_cooldown, c.shed_pressure, c.batch, c.verbose,
            c.save) == ("serve-w8a8", 3, 40.0, 2, 9.0, 0.25, 6, True,
                        "/tmp/x")


INVALID = [dict(num_pages=4), dict(prefix_reuse=False),
           dict(serve_async=True), dict(shed_pressure=0.0),
           dict(shed_pressure=1.5), dict(max_queue=0),
           dict(serve_async=True, trace=4, qps=0.0),
           dict(serve_async=True, trace=4, retry_attempts=0),
           dict(deadline=0.0), dict(straggler_threshold=1.0)]


@pytest.mark.parametrize("kw", INVALID, ids=[
    "-".join(f"{k}={v}" for k, v in kw.items()) for kw in INVALID])
def test_validate_refuses_what_jax_refuses(kw):
    with pytest.raises(Exception):
        JaxServeConfig(**kw).validate()
    with pytest.raises(ServeConfigError):
        ServeConfig(**kw).validate()


def test_validate_flag_combinations():
    with pytest.raises(ServeConfigError, match="--num-pages needs"):
        ServeConfig(num_pages=4).validate()
    with pytest.raises(ServeConfigError, match="--no-prefix-reuse needs"):
        ServeConfig(prefix_reuse=False).validate()
    with pytest.raises(ServeConfigError, match="--serve-async needs --trace"):
        ServeConfig(serve_async=True).validate()
    with pytest.raises(ServeConfigError, match="shed-pressure"):
        ServeConfig(shed_pressure=0.0).validate()
    with pytest.raises(ServeConfigError, match="batch"):
        ServeConfig(batch=0).validate()
    c = ServeConfig(trace=4)
    assert c.validate() is c


# --------------------------------------------------- artifact round trip

def test_config_artifact_config_round_trip():
    art = ServeConfig.from_artifact(_fake_artifact(recipe="serve-w8a16-kv8",
                                                   mode="w8a16"))
    assert art.recipe == "serve-w8a16-kv8"
    assert art.quantize == "w8a16" and art.kv_bits == 8
    assert (art.arch, art.smoke) == ("qwen2-0.5b", True)
    merged, notes = ServeConfig().with_artifact(art)
    assert merged.kv_bits == 8 and merged.recipe == "serve-w8a16-kv8"
    assert notes == []
    again, _ = merged.with_artifact(art)
    assert again == merged


def test_kv_bits_mismatch_raises_naming_both_sides():
    art = ServeConfig.from_artifact(_fake_artifact(kv_bits=16,
                                                   recipe="serve-w8a16"))
    with pytest.raises(ServeConfigError) as ei:
        ServeConfig(kv_bits=8).with_artifact(art)
    msg = str(ei.value)
    assert "--kv-bits 8" in msg and "kv_cache_bits=16" in msg
    assert "re-quantize" in msg


def test_matching_kv_bits_is_fine():
    art = ServeConfig.from_artifact(_fake_artifact(kv_bits=8))
    merged, _ = ServeConfig(kv_bits=8).with_artifact(art)
    assert merged.kv_bits == 8


def test_baked_fields_keep_artifact_value_with_note():
    art = ServeConfig.from_artifact(_fake_artifact(recipe="serve-w8a8-kv8"))
    merged, notes = ServeConfig(quantize="none",
                                recipe="dfq-int8").with_artifact(art)
    assert merged.quantize == "w8a8" and merged.recipe == "serve-w8a8-kv8"
    assert sum("ignored" in n for n in notes) == 2
    assert any("--recipe dfq-int8 ignored" in n for n in notes)


def test_repro_torch_exports_serve_surface():
    assert repro_torch.ServeConfig is ServeConfig
    assert repro_torch.ServeConfigError is ServeConfigError
    assert callable(repro_torch.serve)


# ------------------------------------------------------------- launcher

SMOKE = dict(smoke=True, device="cpu", slots=2, prefill_chunk=4)


def test_batch_mode_serves_the_calibration_ids(capsys):
    """``trace=0`` (the default): ``batch`` requests of ``prompt_len`` JAX
    calibration ids, each ``gen_len`` tokens, all at tick 0."""
    run = repro_torch.serve(ServeConfig(batch=3, prompt_len=8, gen_len=4,
                                        **SMOKE))
    assert sorted(run.results) == [0, 1, 2]
    assert all(len(r.tokens) == 4 and r.status == "ok"
               for r in run.results.values())
    from repro.data import calibration_tokens as jax_calibration_tokens

    ids = calibration_tokens(0, 3, 8, 256, device="cpu").numpy()
    np.testing.assert_array_equal(ids, np.asarray(
        jax_calibration_tokens(0, 3, 8, 256)))
    assert all(r.prompt_len == 8 for r in run.results.values())
    assert "trace:" not in capsys.readouterr().out


def test_recipe_save_and_verbose(tmp_path, capsys):
    """``--recipe serve-w8a8`` with ``--kv-bits 8``: the KV precision is
    folded into the artifact's config (the recipe has no kv_cache stage),
    the saved artifact loads in the JAX package with it, ``--verbose``
    prints the per-site table, and ``--load`` serves it as saved."""
    d = str(tmp_path / "art")
    run = repro_torch.serve(ServeConfig(recipe="serve-w8a8", kv_bits=8,
                                        save=d, verbose=True, batch=2,
                                        prompt_len=6, gen_len=3, **SMOKE))
    out = capsys.readouterr().out
    assert "with recipe 'serve-w8a8'" in out and "kv cache: int8" in out
    assert "per-site weight SQNR (dB):\n" in out
    assert f"saved QuantizedModel to {d}" in out
    assert run.kv_bits == 8
    jq = repro.QuantizedModel.load(d)
    assert jq.recipe.name == "serve-w8a8" and jq.cfg.kv_cache_bits == 8
    again = repro_torch.serve(ServeConfig(load=d, batch=2, prompt_len=6,
                                          gen_len=3, **SMOKE))
    assert {k: r.tokens for k, r in again.results.items()} == {
        k: r.tokens for k, r in run.results.items()}
    art = ServeConfig.from_artifact(repro_torch.QuantizedModel.load(
        d, device="cpu"))
    assert (art.recipe, art.quantize, art.kv_bits) == ("serve-w8a8", "w8a8",
                                                       8)


def test_bounded_queue_sheds_on_the_synchronous_path():
    """``max_queue=2`` with five requests submitted at once: the queue
    refuses three with ``QueueFull`` (the run's shed list, the engine's
    shed counter), and the two it took are served."""
    run = repro_torch.serve(ServeConfig(batch=5, max_queue=2, prompt_len=6,
                                        gen_len=3, quantize="none", **SMOKE))
    assert run.shed == [2, 3, 4] and run.stats["shed"] == 3
    assert sorted(run.results) == [0, 1]
    assert run.async_summary is None and run.server_stats is None


def test_sigterm_drains_and_restores_the_handler(monkeypatch, capsys):
    """SIGTERM mid-run: admission closes (the queued requests stay
    unserved), the admitted ones finish, the report says so, and the
    previous handler is back afterwards."""
    from repro_torch.serving import ServingEngine

    step, calls = ServingEngine.step, []

    def step_then_signal(self):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(self)

    monkeypatch.setattr(ServingEngine, "step", step_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    run = repro_torch.serve(ServeConfig(batch=6, prompt_len=6, gen_len=4,
                                        quantize="none", **SMOKE))
    assert signal.getsignal(signal.SIGTERM) is before
    assert run.drained
    assert 0 < len(run.results) < 6
    assert all(r.status == "ok" and len(r.tokens) == 4
               for r in run.results.values())
    assert "drain: SIGTERM received" in capsys.readouterr().out


ASYNC = ["--smoke", "--serve-async", "--trace", "10", "--qps", "1.0",
         "--timeout", "48", "--max-queue", "4", "--quantize", "none"]


def _report(out):
    keep = ("async front-end:", "  ttft", "  admission:", "trace:")
    return [ln for ln in out.splitlines() if ln.startswith(keep)]


def test_serve_async_reports_what_the_jax_launcher_reports(capsys):
    """The same open-loop trace through both launchers (random weights of
    either package: admission depends on the lengths and ticks, not on
    the token values): the trace, SLO and admission lines are equal, and
    the port's run carries the summary and the server's counters."""
    from repro.launch.serve import main as jax_main
    from repro_torch.launch.serve import main

    jax_main(ASYNC)
    want = _report(capsys.readouterr().out)
    run = main(ASYNC + ["--device", "cpu"])
    got = _report(capsys.readouterr().out)
    assert got == want and len(want) == 4
    s = run.async_summary
    assert s["n_requests"] == 10 and run.server_stats["submitted"] >= 10
    assert run.server_stats["accepted"] == len(run.results)
    assert sum(run.server_stats["results"].values()) == len(run.results)
    assert set(run.server_stats) >= {"shed_breaker", "shed_priority",
                                     "shed_refused", "shed_queue",
                                     "deadlines_tightened", "breaker_opens"}
