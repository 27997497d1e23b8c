"""Supervision of the port's async scheduler on the CPU: the same seeded
fault schedules through the reference's ``AsyncScheduler`` and the
port's (terminal status per request, supervision counters, survivor
tokens), a retried ``random`` batch against its fault-free decode (the
batch carries a seed, and every attempt a fresh generator), the card's
OOM and sticky CUDA errors, the watchdog on the one worker thread, the
profiler hook, and the policy pieces against the reference's."""
import asyncio
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import DegradeConfig as JaxDegradeConfig
from repro.configs import LadderRung as JaxLadderRung
from repro.configs import SupervisorConfig as JaxSupervisorConfig
from repro.configs import get_config as jax_get_config
from repro.models.model import init_model as jax_init_model
from repro.serving import AsyncScheduler as JaxAsyncScheduler
from repro.serving import Fault as JaxFault
from repro.serving import FaultInjector as JaxFaultInjector
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.supervisor import Backoff as JaxBackoff
from repro.serving.supervisor import DegradationLadder as JaxLadder
from repro.serving.supervisor import classify_failure as jax_classify
from repro_torch.configs import (DecodeConfig, DegradeConfig, LadderRung,
                                 SupervisorConfig, get_config)
from repro_torch.convert import from_jax_params
from repro_torch.serving import (AsyncScheduler, Fault, FaultInjector,
                                 InjectedFault, ServingEngine, SimulatedOOM,
                                 is_context_poisoned, is_engine_fatal)
from repro_torch.serving.supervisor import (Backoff, DegradationLadder,
                                            WatchdogTimeout,
                                            classify_failure)

JCFG = jax_get_config("llada-8b").reduced()
CFG = get_config("llada-8b").reduced()
BASE = dict(gen_length=16, block_size=8, steps=16, strategy="probability")
DCFG = DecodeConfig(**BASE)
SV = dict(max_retries=2, backoff_base_s=0.001, backoff_cap_s=0.002,
          breaker_threshold=2, breaker_window_s=60.0)
SVCFG = SupervisorConfig(**SV)
ILLEGAL = "CUDA error: an illegal memory access was encountered"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.device_get(jp), device="cpu")


def _prompt(i=0):
    return np.asarray([3, 5, 2, 7, 4, 6 + i], np.int32)


# --------------------------------------------------------------------------
# one fault schedule, both stacks
# --------------------------------------------------------------------------

SCHEDULES = {
    # a poison request (every batch holding it fails) beside a transient
    # NaN-style corruption of the first attempt's second block
    "poison": dict(faults=[("error", dict(rid=2, times=None)),
                           ("nan", dict(batch_index=0, block=1))]),
    # seeded background chaos over every block
    "chaos": dict(faults=[], chaos=dict(chaos_rate=0.3, seed=7,
                                        chaos_kinds=("error", "nan"))),
    # two simulated OOMs: the breaker trips and the engine is rebuilt
    "oom": dict(faults=[("oom", dict(batch_index=0)),
                        ("oom", dict(batch_index=1))]),
}


def _injector(mod_fault, mod_injector, schedule):
    return mod_injector([mod_fault(kind=kind, **kw)
                         for kind, kw in schedule["faults"]],
                        **schedule.get("chaos", {}))


async def _serve(make_engine, make_scheduler, injector, n=4):
    """Submit ``n`` same-length prompts (one batch), arm the injector,
    run; returns the terminal events and the scheduler's counters."""
    engine = make_engine()
    rebuilds = []

    def rebuild():
        rebuilds.append(1)
        return make_engine()

    sched = make_scheduler(engine, rebuild)
    rids = [sched.submit(_prompt(i)) for i in range(n)]
    engine.set_fault_injector(injector)
    await sched.start()
    finals = {}
    for rid in rids:
        events = [e async for e in sched.events(rid)]
        terminal = [e for e in events if e.get("final")]
        assert len(terminal) == 1, events
        finals[rid] = terminal[0]
    counters = dict(sched.counters, rebuild_calls=len(rebuilds))
    await sched.close()
    return finals, counters


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fault_schedule_matches_reference(weights, name):
    jp, tp = weights
    schedule = SCHEDULES[name]
    want = asyncio.run(_serve(
        lambda: JaxServingEngine(jp, JCFG, JaxDecodeConfig(**BASE),
                                 max_batch=4),
        lambda e, rb: JaxAsyncScheduler(
            e, svcfg=JaxSupervisorConfig(**SV), rebuild_engine=rb),
        _injector(JaxFault, JaxFaultInjector, schedule)))
    got = asyncio.run(_serve(
        lambda: ServingEngine(tp, CFG, DCFG, max_batch=4, device="cpu"),
        lambda e, rb: AsyncScheduler(e, svcfg=SVCFG, rebuild_engine=rb),
        _injector(Fault, FaultInjector, schedule)))
    (want_finals, want_counters), (got_finals, got_counters) = want, got
    assert {r: e["type"] for r, e in got_finals.items()} == \
        {r: e["type"] for r, e in want_finals.items()}
    for key in ("retries", "requeued", "quarantined", "errors", "resets",
                "engine_faults", "engine_rebuilds", "finished",
                "batches", "rebuild_calls"):
        assert got_counters[key] == want_counters[key], key
    survivors = [r for r, e in want_finals.items() if e["type"] == "done"]
    for rid in survivors:
        assert got_finals[rid]["tokens"] == want_finals[rid]["tokens"]
    if name == "poison":
        assert got_finals[2]["type"] == "error"
        assert got_counters["quarantined"] == 1 and len(survivors) == 3
    if name == "oom":
        assert got_counters["engine_rebuilds"] == 1 and len(survivors) == 4


# --------------------------------------------------------------------------
# the port's own traps
# --------------------------------------------------------------------------

def test_retried_random_batch_equals_its_fault_free_decode(weights):
    """The decoder advances the generator it is given: a retry must draw
    from a fresh generator of the batch's seed, not from the one the
    failed attempt advanced."""
    _, tp = weights
    rdcfg = dataclasses.replace(DCFG, strategy="random")

    async def run(faults, seed=0):
        engine = ServingEngine(tp, CFG, rdcfg, max_batch=2, seed=seed,
                               device="cpu",
                               fault_injector=FaultInjector(faults))
        sched = AsyncScheduler(engine, svcfg=SVCFG)
        await sched.start()
        rid = sched.submit(_prompt())
        events = [e async for e in sched.events(rid)]
        retries = sched.counters["retries"]
        await sched.close()
        return [e["type"] for e in events], events[-1]["tokens"], retries

    kinds, clean, retries = asyncio.run(run([]))
    assert kinds == ["block", "block", "done"] and retries == 0
    kinds, retried, retries = asyncio.run(run(
        [Fault(kind="error", batch_index=0, block=1)]))
    assert kinds == ["block", "reset", "block", "block", "done"]
    assert retries == 1
    assert retried == clean
    # the strategy does draw: another seed decodes differently
    assert asyncio.run(run([], seed=1))[1] != clean


def test_card_oom_is_engine_fatal_by_type():
    msg = ("CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a "
           "total capacity of 79.19 GiB")
    oom = torch.OutOfMemoryError(msg)
    assert is_engine_fatal(oom)
    assert classify_failure(oom) == "fatal"
    # the reference's markers alone miss it: the card says "out of memory"
    assert jax_classify(RuntimeError(msg)) == "transient"
    assert is_engine_fatal(SimulatedOOM("x"))
    assert not is_engine_fatal(RuntimeError(msg))
    assert not is_engine_fatal(RuntimeError("boom"))


@pytest.mark.parametrize("msg,poisoned", [
    (ILLEGAL, True),
    ("CUDA error: device-side assert triggered", True),
    ("CUDA error: unspecified launch failure", True),
    ("CUDA error: out of memory", False),
    ("an illegal memory access happened somewhere", False),
    ("injected fault", False),
])
def test_sticky_cuda_errors_are_poisoned(msg, poisoned):
    assert is_context_poisoned(RuntimeError(msg)) is poisoned
    assert (classify_failure(RuntimeError(msg)) == "poisoned") is poisoned


def test_sticky_cuda_error_ends_in_errors_not_a_rebuild_loop(weights):
    """A lost CUDA context fails the batch and every later one with a
    terminal error, at once: no retry, no rebuild."""
    _, tp = weights

    async def main():
        engine = ServingEngine(tp, CFG, DCFG, max_batch=2, device="cpu")
        calls = []

        def sticky(batch):
            calls.append(len(batch.requests))
            raise RuntimeError(ILLEGAL)
            yield                                   # a generator

        engine.decode_batch_blocks = sticky
        rebuilds = []
        sched = AsyncScheduler(engine, svcfg=SVCFG,
                               rebuild_engine=lambda: rebuilds.append(1))
        await sched.start()
        first = [sched.submit(_prompt(i)) for i in range(2)]
        for rid in first:
            terminal = await sched.result(rid)
            assert terminal["type"] == "error" and ILLEGAL in \
                terminal["error"]
        later = sched.submit(_prompt(5))
        terminal = await sched.result(later)
        assert terminal["type"] == "error" and ILLEGAL in terminal["error"]
        assert calls == [2]                 # one attempt, never again
        assert rebuilds == []
        assert sched.counters["retries"] == 0
        assert sched.counters["errors"] == 3
        assert sched.health == "poisoned"
        await sched.close()

    asyncio.run(main())


def test_decode_work_runs_on_the_device_worker(weights):
    """Every block of every decode, and the rebuild after a tripped
    breaker, run on the one worker thread of the device."""
    _, tp = weights
    threads = set()

    def make():
        threads.add(threading.current_thread().name)
        return ServingEngine(
            tp, CFG, DCFG, max_batch=2, device="cpu",
            on_block_committed=lambda *_: threads.add(
                threading.current_thread().name))

    async def main():
        engine = make()
        threads.clear()
        engine.set_fault_injector(FaultInjector([
            Fault(kind="oom", batch_index=0),
            Fault(kind="oom", batch_index=1)]))
        sched = AsyncScheduler(engine, svcfg=SVCFG, rebuild_engine=make)
        await sched.start()
        terminal = await sched.result(sched.submit(_prompt()))
        assert terminal["type"] == "done"
        assert sched.counters["engine_rebuilds"] == 1
        await sched.close()

    asyncio.run(main())
    assert threads == {"repro-torch-cpu:0_0"}


def test_watchdog_abandons_a_stalled_block_on_the_shared_worker(weights):
    """A block slower than the watchdog: engine-fatal; the retries queue
    behind the abandoned resumption on the one worker, the request errors
    out, and the loop serves the next request."""
    _, tp = weights

    async def main():
        engine = ServingEngine(tp, CFG, DCFG, max_batch=2, device="cpu",
                               fault_injector=FaultInjector([Fault(
                                   kind="latency", delay_s=0.6, block=0,
                                   times=None, rid=0)]))
        svcfg = dataclasses.replace(SVCFG, watchdog_s=0.25, max_retries=1,
                                    breaker_threshold=99)
        sched = AsyncScheduler(engine, svcfg=svcfg)
        await sched.start()
        terminal = await sched.result(sched.submit(_prompt()))
        assert terminal["type"] == "error"
        assert "watchdog" in terminal["error"]
        assert sched.counters["watchdog_timeouts"] >= 1
        terminal = await sched.result(sched.submit(_prompt(1)))
        assert terminal["type"] == "done"
        await sched.close()

    asyncio.run(main())


def test_profile_dir_writes_a_trace_per_batch(weights, tmp_path):
    _, tp = weights

    async def main():
        engine = ServingEngine(tp, CFG, DCFG, max_batch=2, device="cpu")
        sched = AsyncScheduler(engine, profile_dir=str(tmp_path),
                               model="tiny")
        await sched.start()
        terminal = await sched.result(sched.submit(_prompt()))
        assert terminal["type"] == "done"
        await sched.close()

    asyncio.run(main())
    assert [p.name for p in tmp_path.iterdir()] == ["tiny-batch1.json"]


def test_engine_block_fault_and_clean_retry(weights):
    """At the engine: a failed attempt leaves no result, and re-driving
    the same batch decodes it as if nothing had happened."""
    _, tp = weights
    engine = ServingEngine(tp, CFG, DCFG, max_batch=2, device="cpu",
                           fault_injector=FaultInjector([Fault(
                               kind="error", batch_index=0, block=1)]))
    clean = ServingEngine(tp, CFG, DCFG, max_batch=2, device="cpu")
    rid = engine.submit(_prompt())
    clean.submit(_prompt())
    batch = engine.select_batch()
    with pytest.raises(InjectedFault):
        for _ in engine.decode_batch_blocks(batch):
            pass
    assert rid not in engine.done
    assert len(list(engine.decode_batch_blocks(batch))) == 2
    clean.run_until_idle()
    np.testing.assert_array_equal(engine.result(rid).result,
                                  clean.result(0).result)


# --------------------------------------------------------------------------
# the policy pieces against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depth,deadline,ema", [
    (0, None, 0.0), (5, None, 0.0), (8, None, 0.0), (5, 0.5, 0.2),
    (8, 0.5, 0.2), (3, 0.1, 0.2)])
def test_ladder_matches_reference(depth, deadline, ema):
    rungs = ((0.5, 0.5), (0.8, 0.25))
    port = DegradationLadder(DegradeConfig(rungs=tuple(
        LadderRung(*r) for r in rungs)), max_queue_depth=10)
    ref = JaxLadder(JaxDegradeConfig(rungs=tuple(
        JaxLadderRung(*r) for r in rungs)), max_queue_depth=10)
    rung = port.rung_for(depth, deadline, ema)
    assert rung == ref.rung_for(depth, deadline, ema)
    for over in ((None, None, None), (64, 16, 2), (12, 10, 8), (12, None,
                                                                 None)):
        assert port.cheapen_steps(rung, DCFG, *over) == \
            ref.cheapen_steps(rung, JaxDecodeConfig(**BASE), *over)


def test_backoff_and_classification_match_reference():
    port, ref = Backoff(0.1, 10.0, seed=3), JaxBackoff(0.1, 10.0, seed=3)
    assert [port.delay(a) for a in range(1, 12)] == \
        [ref.delay(a) for a in range(1, 12)]
    for exc in (InjectedFault("x"), SimulatedOOM("x"),
                RuntimeError("RESOURCE_EXHAUSTED"), RuntimeError("boom")):
        assert classify_failure(exc) == jax_classify(exc)
    assert classify_failure(WatchdogTimeout("slow")) == "fatal"
