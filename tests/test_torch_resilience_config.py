"""The port's pure-Python layers against the JAX package's: deadlines,
retries, breakers, degradation logs, seeded fault points, request traces
and their metrics, and ``AppConfig`` from the same files and ``APP_*``
overlay.  Each case drives both packages with the same inputs (a seed, a
spec, a fake clock) and asks for equal sequences.  Last, a subprocess with
``yaml`` blocked imports the whole port and builds an env-only config.
"""

import dataclasses
import json
import os
import pkgutil
import random
import subprocess
import sys

import pytest

import generativeaiexamples_tpu_torch
from generativeaiexamples_tpu.core import config as jconfig
from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.obs import metrics as jobs_metrics
from generativeaiexamples_tpu.obs import trace as jtrace
from generativeaiexamples_tpu.resilience import breaker as jbreaker
from generativeaiexamples_tpu.resilience import deadline as jdeadline
from generativeaiexamples_tpu.resilience import degrade as jdegrade
from generativeaiexamples_tpu.resilience import faults as jfaults
from generativeaiexamples_tpu.resilience import metrics as jmetrics
from generativeaiexamples_tpu.resilience import retry as jretry
from generativeaiexamples_tpu_torch.core import config as tconfig
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.obs import metrics as tobs_metrics
from generativeaiexamples_tpu_torch.obs import trace as ttrace
from generativeaiexamples_tpu_torch.resilience import breaker as tbreaker
from generativeaiexamples_tpu_torch.resilience import deadline as tdeadline
from generativeaiexamples_tpu_torch.resilience import degrade as tdegrade
from generativeaiexamples_tpu_torch.resilience import faults as tfaults
from generativeaiexamples_tpu_torch.resilience import metrics as tmetrics
from generativeaiexamples_tpu_torch.resilience import retry as tretry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BOTH = {
    "jax": dict(deadline=jdeadline, retry=jretry, breaker=jbreaker, degrade=jdegrade, faults=jfaults, metrics=jmetrics,
                trace=jtrace, obs=jobs_metrics),
    "torch": dict(deadline=tdeadline, retry=tretry, breaker=tbreaker, degrade=tdegrade, faults=tfaults,
                  metrics=tmetrics, trace=ttrace, obs=tobs_metrics),
}


@pytest.fixture(autouse=True)
def _clean():
    for m in BOTH.values():
        m["metrics"].reset_resilience()
    yield
    for m in BOTH.values():
        m["metrics"].reset_resilience()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _each(fn):
    """fn(modules) for both packages; returns {package: result}."""
    return {name: fn(m) for name, m in BOTH.items()}


def _same(fn):
    out = _each(fn)
    assert out["jax"] == out["torch"], out
    return out["torch"]


def test_deadline_sequences_match(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr("time.monotonic", clock)

    def run(m):
        D = m["deadline"].Deadline
        seq = []
        members = [D.after_ms(50), D.after_ms(200), D.after_ms(120)]
        loosest = D.latest(members)
        seq.append((loosest.remaining_ms(), D.latest(members + [None]), D.latest([]), D.after_ms(0).is_unlimited))
        for step in (0.0, 0.04, 0.02, 0.1, 0.05):
            clock.t += step
            seq.append([(d.remaining_ms(), d.expired(), d.cap_timeout(0.03), d.cap_timeout(None)) for d in members])
            try:
                members[0].check("stage")
                seq.append("ok")
            except m["deadline"].DeadlineExceeded as exc:
                seq.append(str(exc))
        clock.t = 1000.0
        return seq, m["metrics"].resilience_snapshot()["deadline_expired_total"]

    seq, expired = _same(run)
    assert expired == 3 and "deadline exceeded at stage" in seq


def test_retry_sequences_match(monkeypatch):
    def run(m):
        pauses = []
        monkeypatch.setattr(m["retry"].time, "sleep", pauses.append)
        policy = m["retry"].RetryPolicy(max_attempts=4, base_ms=10, max_ms=35, budget=m["retry"].RetryBudget(0.5, 2.0),
                                        name="store-search")
        backoffs = [policy.backoff_s(a, random.Random(11)) for a in range(1, 6)]
        breaker = m["breaker"].CircuitBreaker("store", window=8, min_calls=6, failure_threshold=0.5)
        calls = []
        outcomes = []
        for fail_first in (1, 2, 9, 0):
            def fn():
                calls.append(len(calls))
                if len(calls) <= fail_first:
                    raise ConnectionError("down")
                return "ok"

            calls.clear()
            try:
                outcomes.append(policy.call(fn, breaker=breaker, rng=random.Random(5)))
            except ConnectionError:
                outcomes.append("raised")
            except m["breaker"].CircuitOpenError as exc:
                outcomes.append(f"open:{exc.dep}")
            outcomes.append((len(calls), policy.budget.tokens(), breaker.state))
        snap = m["metrics"].resilience_snapshot()
        return backoffs, pauses, outcomes, snap["retries_total"]

    backoffs, pauses, outcomes, retries = _same(run)
    assert len(pauses) == retries > 0 and "raised" in outcomes and "open:store" in outcomes


def test_breaker_state_sequences_match():
    def run(m):
        clock = FakeClock()
        b = m["breaker"].CircuitBreaker("reranker", window=4, min_calls=2, failure_threshold=0.5, reset_timeout_s=5.0,
                                        half_open_max=2, clock=clock)
        seq = []
        rng = random.Random(3)
        for _ in range(60):
            op = rng.choice(["fail", "ok", "allow", "tick"])
            if op == "fail":
                b.record_failure()
            elif op == "ok":
                b.record_success()
            elif op == "allow":
                seq.append(b.allow())
            else:
                clock.t += rng.choice([1.0, 3.0, 6.0])
            seq.append((b.state, b.state_code(), b.retry_after_s(), b.open_total))
        return seq

    seq = _same(run)
    assert {s[0] for s in seq if isinstance(s, tuple)} == {"closed", "open", "half_open"}


def test_degrade_logs_and_metrics_lines_match():
    def run(m):
        logs = [m["degrade"].DegradeLog() for _ in range(3)]
        for stage, log in (("rerank", logs[0]), ("rerank", logs[0]), ("shrink_k", logs[0]), ("index_fallback", logs[1]),
                           ("cache_stale", None), ("custom_rung", logs[2])):
            m["degrade"].mark_degraded(stage, log)
        with m["degrade"].degrade_scope() as scoped:
            m["degrade"].mark_degraded("retrieval")
            m["degrade"].mark_degraded("retrieval")
        m["metrics"].record_retry()
        m["breaker"].get_breaker("store", window=2, min_calls=1).record_failure()
        return [log.stages() for log in logs], scoped.stages(), m["metrics"].resilience_metrics_lines()

    stages, scoped, lines = _same(run)
    assert stages[0] == ["rerank", "shrink_k"] and scoped == ["retrieval"]
    assert 'rag_degraded_total{stage="rerank"} 1' in lines and 'rag_breaker_state{dep="store"} 2' in lines


@pytest.mark.parametrize("spec", ["store:error=0.3", "embedder:error=1;reranker:error=0.5,count=3",
                                  "store:error=0.5,count=4;llm:error=0.2"])
def test_fault_rng_sequences_match(spec, monkeypatch):
    def run(m):
        m["faults"].reset_faults()
        injector = m["faults"].FaultInjector(seed=9)
        injector.configure(spec)
        fired = []
        for i in range(40):
            site = ("store", "embedder", "reranker", "llm")[i % 4]
            try:
                injector.inject(site)
                fired.append(None)
            except m["faults"].FaultInjected as exc:
                fired.append(exc.site)
        # The module-level injector arms from GAIE_FAULTS on first use.
        monkeypatch.setenv("GAIE_FAULTS", spec)
        m["faults"].reset_faults()
        module_fired = []
        for site in ("store", "embedder", "reranker") * 5:
            try:
                m["faults"].inject(site)
                module_fired.append(0)
            except m["faults"].FaultInjected:
                module_fired.append(1)
        monkeypatch.delenv("GAIE_FAULTS")
        m["faults"].reset_faults()
        return fired, injector.counts(), sorted(injector.active_sites()), module_fired

    fired, counts, _, module_fired = _same(run)
    assert any(fired) and sum(module_fired) > 0


def test_request_traces_and_histograms_match(monkeypatch):
    def run(m):
        m["obs"].reset_obs_metrics()
        clock = [100.0]
        monkeypatch.setattr(m["trace"].time, "perf_counter", lambda: clock[0])
        tr = m["trace"].RequestTrace(request_id="ab" * 16, route="/search")
        for stage, ms in (("cache_lookup", 0.3), ("queue_wait", 2.0), ("embed", 40.0), ("search", 6.0),
                          ("rerank", 900.0)):
            tr.add_stage(stage, ms, batch_size=4)
            clock[0] += ms / 1000.0
        with tr.stage("custom"):
            clock[0] += 0.5
        tr.set_attr("degraded", ["rerank"])
        snap = tr.finish(200)
        snap.pop("started_at")
        timing = tr.server_timing()
        monkeypatch.undo()
        return snap, timing, m["obs"].obs_metrics_lines()

    snap, timing, lines = _same(run)
    assert [s["stage"] for s in snap["stages"]] == ["cache_lookup", "queue_wait", "embed", "search", "rerank", "custom"]
    assert 'rag_request_latency_ms_count{route="/search"} 1' in lines


CONFIG_YAML = """
vector_store:
  name: memory
  nprobe: 9
retriever:
  top_k: 6
  score_threshold: 0.1
cache:
  semantic_entries: 64
  similarity_threshold: 0.97
resilience:
  faults: "store:error=0.5"
  retry_max_attempts: 5
ranking:
  model_engine: tpu
"""

ENV = {
    "APP_RETRIEVER_TOPK": "8",
    "APP_RETRIEVER_BATCHMAXSIZE": "16",
    "APP_CACHE_SERVESTALE": "false",
    "APP_EMBEDDINGS_MODELENGINE": "hash",
    "APP_EMBEDDINGS_DIMENSIONS": "256",
    "APP_VECTORSTORE_QUANTIZATION": "none",
    "APP_RESILIENCE_MINRERANKBUDGETMS": "80.5",
}


@pytest.mark.parametrize("source", ["defaults", "env", "yaml", "yaml+env", "json+env"])
def test_app_config_matches_reference_field_by_field(source, tmp_path, monkeypatch):
    for key in [k for k in os.environ if k.startswith("APP_")]:
        monkeypatch.delenv(key)
    path = None
    if "yaml" in source:
        path = tmp_path / "app.yaml"
        path.write_text(CONFIG_YAML)
    elif "json" in source:
        import yaml

        path = tmp_path / "app.json"
        path.write_text(json.dumps(yaml.safe_load(CONFIG_YAML)))
    if "env" in source:
        for key, value in ENV.items():
            monkeypatch.setenv(key, value)
    if path is not None:
        monkeypatch.setenv("APP_CONFIG_FILE", str(path))
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    try:
        ref, port = jconfiguration.get_config(), tconfiguration.get_config()
    finally:
        jconfiguration.reset_config_cache()
        tconfiguration.reset_config_cache()
    assert [f.name for f in dataclasses.fields(ref)] == [f.name for f in dataclasses.fields(port)]
    assert jconfig.to_dict(ref) == tconfig.to_dict(port)
    assert jconfig.format_help(jconfiguration.AppConfig) == tconfig.format_help(tconfiguration.AppConfig)
    if source == "defaults":
        r, c = port.retriever, port.cache
        knobs = (r.top_k, r.score_threshold, r.fetch_k_multiplier, r.batch_max_size, r.batch_wait_ms)
        assert knobs == (4, 0.25, 4, 32, 3)
        assert (c.enabled, c.semantic_enabled, c.max_entries, c.semantic_entries, c.similarity_threshold,
                c.serve_stale) == (True, True, 1024, 512, 0.98, True)
        assert port.ranking.model_engine == "none"
        assert (port.vector_store.name, port.vector_store.index_type, port.vector_store.quantization) == (
            "tpu", "exact", "none")
    if source == "yaml+env":
        assert (port.retriever.top_k, port.retriever.score_threshold, port.vector_store.nprobe) == (8, 0.1, 9)


def test_config_errors_match(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("retriever:\n  top_k: many\n")
    for pkg in (jconfig, tconfig):
        with pytest.raises(pkg.ConfigError, match="retriever.top_k: cannot interpret 'many' as int"):
            pkg.load_config((jconfiguration if pkg is jconfig else tconfiguration).AppConfig, path=str(bad), env=False)


_NO_YAML_PROBE = r"""
import importlib, os, pkgutil, sys
sys.modules["yaml"] = None  # import yaml -> ImportError
import generativeaiexamples_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from generativeaiexamples_tpu_torch.core.config import ConfigError
from generativeaiexamples_tpu_torch.core.configuration import get_config, reset_config_cache
cfg = get_config()
assert (cfg.retriever.top_k, cfg.embeddings.model_engine, cfg.cache.semantic_entries) == (7, "hash", 64), cfg
os.environ["APP_CONFIG_FILE"] = sys.argv[1]
reset_config_cache()
try:
    get_config()
except ConfigError as exc:
    print("yaml-refused:", exc)
os.environ["APP_CONFIG_FILE"] = sys.argv[2]
reset_config_cache()
assert get_config().retriever.top_k == 7  # env beats the JSON file's 3
assert get_config().vector_store.name == "memory"
from generativeaiexamples_tpu_torch.chains.factory import get_retriever
print("retriever:", type(get_retriever(device="cpu")).__name__, len(names))
"""


def test_port_imports_and_configures_without_yaml(tmp_path):
    yml = tmp_path / "app.yaml"
    yml.write_text("retriever:\n  top_k: 3\n")
    js = tmp_path / "app.json"
    js.write_text(json.dumps({"retriever": {"top_k": 3}, "vector_store": {"name": "memory"}}))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("PYTEST", "APP_"))}
    env.update(APP_RETRIEVER_TOPK="7", APP_EMBEDDINGS_MODELENGINE="hash", APP_CACHE_SEMANTICENTRIES="64")
    out = subprocess.run([sys.executable, "-c", _NO_YAML_PROBE, str(yml), str(js)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "yaml-refused:" in out.stdout and "needs PyYAML" in out.stdout
    n_modules = len(list(pkgutil.walk_packages(generativeaiexamples_tpu_torch.__path__,
                                               "generativeaiexamples_tpu_torch.")))
    assert f"retriever: Retriever {n_modules}" in out.stdout
