"""The port's async serving stack on the CPU, over real sockets: the SSE
streams of the deterministic strategies under every cache policy against
the reference's ``Decoder`` (events, tokens, forward-equivalents),
admission control and error answers, cancel, deadlines, drain, the
``/metrics`` exposition, the router's eviction (weights and runner-cache
runs go), the concurrency grain over the new modules, and the serving
CLI's selftest."""
import asyncio
import gc
import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import analyze_concurrency
from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro.models.model import init_model as jax_init_model
from repro_torch.configs import (DecodeConfig, RouterConfig, ServerConfig,
                                 get_config)
from repro_torch.convert import from_jax_params
from repro_torch.core import decode_cache_scope
from repro_torch.serving import (AsyncScheduler, Fault, FaultInjector,
                                 ModelRouter, ServerError, ServerThread,
                                 ServingClient, ServingEngine, params_bytes)

REPO = Path(__file__).resolve().parents[1]
JCFG = jax_get_config("llada-8b").reduced()
CFG = get_config("llada-8b").reduced()
BASE = dict(gen_length=16, block_size=8, steps=16, strategy="probability")
DCFG = DecodeConfig(**BASE)
STRATEGIES = ["probability", "fdm", "fdm_a"]
POLICIES = ["none", "prefix", "dual"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small CPU decodes: one torch thread, so parallel test workers
    do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def server(weights):
    """One server for the module: model 'tiny' on the port's engine."""
    _, tp = weights
    router = ModelRouter(RouterConfig(), device="cpu")
    router.register("tiny", lambda: ServingEngine(
        tp, CFG, DCFG, max_batch=4, device="cpu"))
    handle = ServerThread(router, ServerConfig(port=0)).start()
    yield handle
    handle.stop()


@pytest.fixture()
def client(server):
    return ServingClient(server.host, server.port, max_retries=0)


def _reference(jp, prompt, **over):
    """The reference's decode of one prompt (its host driver, whose
    forward-equivalents sum as the port's do): its per-block events,
    tokens and forward-equivalents."""
    dcfg = JaxDecodeConfig(**{**BASE, **over}, fused_loop=False)
    events = []
    out, stats = JaxDecoder(jp, JCFG, dcfg).generate(
        jax.random.PRNGKey(0), np.asarray(prompt, np.int32)[None],
        on_block_committed=lambda blk, lo, hi, x: events.append(
            (blk, lo, hi, np.asarray(x)[0, lo:hi].tolist())))
    return events, np.asarray(out)[0].tolist(), stats.forward_equivalents


def _prompt(n, seed):
    rs = np.random.default_rng(seed)
    return rs.integers(0, CFG.vocab_size - 1, n).tolist()


# --------------------------------------------------------------------------
# SSE streams against the reference decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sse_stream_matches_reference_decode(weights, client, strategy,
                                             policy):
    jp, _ = weights
    prompt = _prompt(7, seed=len(strategy) + 3 * len(policy))
    over = dict(strategy=strategy, cache_policy=policy)
    events = list(client.generate_stream(prompt, **over))
    assert [name for name, _ in events] == ["block", "block", "done"]
    want_events, want_tokens, want_fwd = _reference(jp, prompt, **over)
    assert [(e["block"], e["lo"], e["hi"], e["tokens"])
            for name, e in events if name == "block"] == want_events
    done = events[-1][1]
    assert done["status"] == "ok" and done["final"] is True
    assert done["tokens"] == want_tokens
    assert done["stats"]["forward_equivalents"] == want_fwd


def test_concurrent_mixed_requests_match_reference(weights, server):
    """Concurrent clients, two prompt lengths (two buckets, so no request
    is padded) and three strategies: every final token sequence equals
    the reference's decode of that prompt."""
    jp, _ = weights
    cases = [(_prompt(6, 1), None), (_prompt(6, 2), "fdm"),
             (_prompt(14, 3), None), (_prompt(14, 4), "fdm_a"),
             (_prompt(6, 5), "fdm"), (_prompt(14, 6), None)]
    results = [None] * len(cases)
    errors = []

    def worker(i, prompt, strategy):
        try:
            results[i] = ServingClient(server.host, server.port).generate(
                prompt, strategy=strategy, wait=True)
        except Exception as e:          # surfaced in the main thread
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i, p, s))
               for i, (p, s) in enumerate(cases)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for (prompt, strategy), res in zip(cases, results):
        over = {"strategy": strategy} if strategy else {}
        assert res["status"] == "ok"
        assert res["tokens"] == _reference(jp, prompt, **over)[1]


# --------------------------------------------------------------------------
# boundary answers over HTTP
# --------------------------------------------------------------------------

@pytest.mark.parametrize("over,status,text", [
    (dict(strategy="nope"), 400, "unknown strategy"),
    (dict(gen_length=12, block_size=8), 400, "not a multiple"),
    (dict(cache_policy="lru"), 400, "cache_policy"),
    (dict(steps="ten"), 400, "wrong type"),
    (dict(gen_length=1 << 20), 400, "server cap"),
    (dict(model="missing"), 400, "unknown model"),
    (dict(trace=True), 200, "done"),
    (dict(strategy="wino_r"), 200, "done"),
])
def test_bad_requests_answer_at_the_boundary(weights, client, over, status,
                                             text):
    """Bad requests answer at the boundary; ``trace`` and ``wino_r`` are
    ported and answer 200 with the reference's decode streamed, and a
    traced request's ``/v1/trace/{rid}`` carries the device's per-step
    counters, whose final commits sum to ``tokens_generated``."""
    if status == 200:
        prompt = [3, 5, 2]
        events = list(client.generate_stream(prompt, **over))
        assert [name for name, _ in events] == ["block", "block", text]
        want_events, want_tokens, want_fwd = _reference(weights[0], prompt,
                                                        **over)
        assert [(e["block"], e["lo"], e["hi"], e["tokens"])
                for name, e in events if name == "block"] == want_events
        done = events[-1][1]
        assert done["status"] == "ok" and done["tokens"] == want_tokens
        assert done["stats"]["forward_equivalents"] == want_fwd
        trace = client.trace(done["rid"], model="tiny")["traceEvents"]
        counters = [e["args"] for e in trace if e.get("name") == "commits"]
        if over.get("trace"):
            assert len(counters) == done["stats"]["steps"]
            assert sum(c["commits"] for c in counters) == \
                done["stats"]["tokens_generated"] == BASE["gen_length"]
        else:
            assert not counters
        return
    with pytest.raises(ServerError) as err:
        client.generate([3, 5, 2], **over)
    assert err.value.status == status
    assert text in err.value.message


def test_out_of_vocab_prompt_is_400(client):
    with pytest.raises(ServerError) as err:
        client.generate([3, CFG.vocab_size])
    assert err.value.status == 400 and "out-of-vocab" in err.value.message


def test_oversized_and_chunked_bodies_are_413(server):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    try:
        conn.putrequest("POST", "/v1/generate")
        conn.putheader("Content-Length", str(2 << 20))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert "too large" in json.loads(resp.read())["error"]
    finally:
        conn.close()
    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    try:
        conn.putrequest("POST", "/v1/generate")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert "chunked" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_unknown_routes_are_404(client):
    for path in ("/v2/nothing", "/v1/stream/123456", "/v1/trace/123456"):
        with pytest.raises(ServerError) as err:
            client._request("GET", path)
        assert err.value.status == 404, path


def test_backpressure_429_with_retry_after(weights):
    _, tp = weights
    router = ModelRouter(RouterConfig(), device="cpu")
    router.register("tiny", lambda: ServingEngine(tp, CFG, DCFG,
                                                  device="cpu"))
    handle = ServerThread(router, ServerConfig(
        port=0, max_queue_depth=0)).start()
    try:
        client = ServingClient(handle.host, handle.port, max_retries=0)
        with pytest.raises(ServerError) as err:
            client.generate([3, 5, 2])
        assert err.value.status == 429
        assert err.value.retry_after is not None
        assert err.value.retry_after >= 1
    finally:
        handle.stop()


# --------------------------------------------------------------------------
# request lifecycle: trace spans, cancel, deadline, drain
# --------------------------------------------------------------------------

def test_trace_endpoint_serves_the_scheduler_spans(client):
    res = client.generate(_prompt(6, 9), wait=True)
    trace = client.trace(res["rid"], model="tiny")
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"queue_wait", "batch_assembly", "decode_block[0]",
            "decode_block[1]", "emit"} <= names
    assert trace["otherData"]["tokens_generated"] == BASE["gen_length"]


def test_scheduler_cancel_and_deadline_events(weights):
    _, tp = weights

    async def main():
        engine = ServingEngine(tp, CFG, DCFG, max_batch=4, device="cpu")
        sched = AsyncScheduler(engine)
        # no worker yet: the queue holds still
        rid = sched.submit(np.full((6,), 3, np.int32))
        late = sched.submit(np.full((6,), 4, np.int32), deadline_s=-1.0)
        assert sched.cancel(rid) is True
        assert [e["type"] async for e in sched.events(rid)] == \
            ["cancelled"]
        await sched.start()
        terminal = await sched.result(late)
        assert terminal["type"] == "expired" and terminal["final"] is True
        assert sched.counters["cancelled"] == sched.counters["expired"] == 1
        assert sched.cancel(late) is False
        await sched.close()

    asyncio.run(main())


def test_cancel_over_http(weights):
    """A request queued behind a stalled batch is cancelled: its stream
    holds exactly the terminal ``cancelled`` event."""
    _, tp = weights
    stall = FaultInjector([Fault(kind="latency", rid=0, delay_s=1.0)])
    router = ModelRouter(RouterConfig(), device="cpu")
    router.register("tiny", lambda: ServingEngine(
        tp, CFG, DCFG, device="cpu", fault_injector=stall))
    handle = ServerThread(router, ServerConfig(port=0)).start()
    try:
        client = ServingClient(handle.host, handle.port, max_retries=0)
        first = client.generate([3, 5, 2, 7], wait=False)
        second = client.generate([3, 5, 2, 7], strategy="fdm", wait=False)
        assert client.cancel(second["rid"]) is True
        assert client.cancel(second["rid"]) is False
        assert [name for name, _ in client.stream(second["rid"])] == \
            ["cancelled"]
        assert list(client.stream(first["rid"]))[-1][0] == "done"
    finally:
        handle.stop()


def test_drain_ends_every_open_stream_with_shutdown(weights):
    """A drain whose deadline passes while the first batch is stalled:
    admission stops at once (503 with Retry-After, ``/healthz``
    "draining"), the in-flight batch stops at its next block boundary,
    and every open stream ends with exactly one terminal event —
    ``shutdown`` for all that did not finish."""
    _, tp = weights
    stall = FaultInjector([Fault(kind="latency", block=0, times=None,
                                 delay_s=0.5)])
    router = ModelRouter(RouterConfig(), device="cpu")
    router.register("tiny", lambda: ServingEngine(
        tp, CFG, DCFG, max_batch=2, device="cpu", fault_injector=stall))
    handle = ServerThread(router, ServerConfig(port=0)).start()
    try:
        client = ServingClient(handle.host, handle.port, max_retries=0)
        rids = [client.generate(_prompt(6 + i, i), wait=False)["rid"]
                for i in range(6)]
        streams = {}

        def read(rid):
            streams[rid] = list(ServingClient(
                handle.host, handle.port).stream(rid))

        readers = [threading.Thread(target=read, args=(r,)) for r in rids]
        for t in readers:
            t.start()
        drain = threading.Thread(target=handle.call,
                                 args=(handle.server.drain, 0.3))
        drain.start()
        for _ in range(200):
            if client.healthz()["status"] == "draining":
                break
            time.sleep(0.005)
        with pytest.raises(ServerError) as err:
            client.generate([3, 5, 2])
        assert err.value.status == 503 and err.value.retry_after >= 1
        drain.join(timeout=60)
        for t in readers:
            t.join(timeout=60)
        assert not drain.is_alive()
        assert not any(t.is_alive() for t in readers)
        finals = {rid: [e for _, e in events if e.get("final")]
                  for rid, events in streams.items()}
        assert all(len(f) == 1 for f in finals.values()), finals
        kinds = [f[0]["type"] for f in finals.values()]
        assert set(kinds) <= {"done", "shutdown"}
        assert "shutdown" in kinds
    finally:
        handle.stop()


# --------------------------------------------------------------------------
# /metrics and /healthz
# --------------------------------------------------------------------------

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                     r'(-?[0-9.e+-]+|NaN|[+-]Inf)$')


def test_metrics_exposition_parses(client):
    client.generate(_prompt(6, 11), wait=True)
    text = client.metrics_text()
    types = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ", 3)
            types[name] = mtype
        elif line.startswith("# HELP ") or not line:
            continue
        else:
            m = _SAMPLE.match(line)
            assert m, line
            base = re.sub(r"_(bucket|sum|count)$", "", m.group(1))
            assert m.group(1) in types or base in types, line
            float(m.group(3))
    for name in ("repro_up", "repro_queue_depth",
                 "repro_request_latency_seconds",
                 "repro_decode_cache_captures",
                 "repro_requests_finished_total"):
        assert name in types, name
    assert 'repro_requests_finished_total{model="tiny"}' in text
    health = client.healthz()
    assert health["ok"] is True and health["health"]["tiny"] == "ok"
    models = client.models()
    assert {"fdm", "fdm_a", "probability"} <= set(models["strategies"])
    assert models["models"]["tiny"]["resident"] is True


# --------------------------------------------------------------------------
# the router: eviction frees the weights and their runner-cache runs
# --------------------------------------------------------------------------

def _factory(seed, refs):
    def factory():
        jp = jax_init_model(jax.random.PRNGKey(seed), JCFG)
        tp = from_jax_params(jax.device_get(jp), device="cpu")
        refs.append(weakref.ref(tp["embed"]["tok"]))
        return ServingEngine(tp, CFG, DCFG, max_batch=2, device="cpu")
    return factory


def _decode_once(engine):
    rid = engine.submit(np.full((6,), 3, np.int32))
    engine.run_until_idle()
    return engine.result(rid).result


def test_router_eviction_drops_weights_and_runs():
    with decode_cache_scope() as cache:
        refs = []
        router = ModelRouter(RouterConfig(), device="cpu")
        router.register("a", _factory(1, refs))
        router.register("b", _factory(2, refs))
        one = params_bytes(router.engine("a").params)
        router.rcfg = RouterConfig(budget_bytes=int(one * 1.5))
        _decode_once(router.engine("a"))
        assert cache.info().entries == 1 and cache.info().runners == 1
        engine_a = router.touch("a")
        _decode_once(router.engine("b"))        # over budget: a evicted
        assert not router.resident("a") and router.resident("b")
        assert router.counters["evictions"] == 1
        assert router.last_eviction["name"] == "a"
        assert router.last_eviction["weights_bytes"] == one
        gc.collect()
        # a holder of the evicted engine holds no weights
        assert engine_a.params is None and refs[0]() is None
        assert cache.info().entries == 1 and cache.info().runners == 1
        with pytest.raises(RuntimeError, match="released"):
            _decode_once(engine_a)
        assert router.resident_bytes() <= int(one * 1.5)
        _decode_once(router.engine("a"))      # rebuilt from its factory
        assert router.resident("a") and not router.resident("b")
        assert refs[1]() is None


def test_router_requires_engines_on_its_device(weights):
    _, tp = weights
    router = ModelRouter(RouterConfig(), device="cpu")
    engine = ServingEngine(tp, CFG, DCFG, device="cpu")
    engine.device = torch.device("meta")
    router.register("x", lambda: engine)
    with pytest.raises(ValueError, match="this router serves"):
        router.engine("x")


def test_entry_points_raise_without_a_card(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tp = weights
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRouter(RouterConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tp, CFG, DCFG)


# --------------------------------------------------------------------------
# static concurrency grain and the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("relpath", [
    "src/repro_torch/serving/scheduler.py",
    "src/repro_torch/serving/server.py",
    "src/repro_torch/serving/engine.py",
    "src/repro_torch/serving/router.py",
    "src/repro_torch/serving/worker.py",
    "src/repro_torch/launch/serve.py",
])
def test_port_serving_stack_passes_concurrency_grain(relpath):
    source = (REPO / relpath).read_text()
    assert analyze_concurrency(relpath, source) == []


def test_serve_cli_selftest_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--selftest",
         "--device", "cpu", "--train-steps", "2"],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "done: status=ok" in res.stdout
    assert "selftest OK" in res.stdout
