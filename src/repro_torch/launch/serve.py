"""Serving CLI of the port: train small LLDM(s), then serve them over
HTTP/SSE.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --models tiny=llada-8b-tiny:sum --port 8000 --budget-mb 64

Starts the full stack — ``ModelRouter`` (bytes-budget LRU over engines)
→ ``AsyncScheduler`` per model (continuous batching, admission control)
→ stdlib HTTP/1.1 + SSE server — and prints copy-paste ``curl`` lines.
Per-request decode knobs (``strategy`` / ``steps`` / ``gen_length`` /
``block_size`` / ``cache_policy``) ride the JSON body; see
``repro_torch/serving/server.py`` for the endpoint surface.

``--selftest`` instead boots the server on an ephemeral port, runs one
streamed request through the blocking client, prints the events, and
exits — the offline end-to-end sanity check.

SIGTERM / SIGINT drain gracefully: admission stops (new submits answer
503 + Retry-After), in-flight and queued requests get up to the drain
deadline (``SupervisorConfig.drain_deadline_s``) to finish, leftover
streams receive terminal ``shutdown`` events, then the process exits.

The flags are the reference's ``repro.launch.serve``'s, plus
``--device`` (default ``cuda``: without a card it raises; ``--device
cpu`` runs the plain versions on the CPU).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import tempfile

from repro_torch.configs import (DecodeConfig, RouterConfig, ServerConfig,
                                 TrainConfig, default_block_size,
                                 get_config)
from repro_torch.data import CharTokenizer, TaskDataset
from repro_torch.serving import (ModelRouter, ServerThread, ServingClient,
                                 ServingEngine, ServingServer)
from repro_torch.training.checkpoint import load, save
from repro_torch.training.trainer import train


def build_model(arch: str, task: str, train_steps: int, strategy: str,
                ckpt_dir: str, device: str):
    """Train a small model on a task and PARK IT ON DISK; returns
    ``(ckpt_path, cfg, dcfg, tok, ds)``.  The registered engine factory
    loads from the checkpoint, so the factory closure never pins the
    params in RAM — otherwise the router's ``--budget-mb`` eviction
    would free nothing (the weak runner cache anchors on the params
    leaves, and a factory default holding them keeps every finalizer
    unfireable)."""
    cfg = get_config(arch)
    tok = CharTokenizer(cfg.vocab_size)
    ds = TaskDataset(task, tok)
    tcfg = TrainConfig(batch_size=64, seq_len=ds.seq_len,
                       steps=train_steps)
    print(f"warm-up training {cfg.name} on '{task}' ({tcfg.steps} steps)…")
    params, _ = train(cfg, tcfg, ds.batches(tcfg.batch_size),
                      device=device)
    path = os.path.join(ckpt_dir, f"{cfg.name}-{task}.npz")
    save(path, params, step=train_steps)
    del params
    gen = ds.seq_len - (1 + ds.prompt_len)
    dcfg = DecodeConfig(gen_length=gen,
                        block_size=default_block_size(gen), steps=gen,
                        strategy=strategy)
    return path, cfg, dcfg, tok, ds


def load_engine(ckpt_path: str, cfg, dcfg, max_batch: int,
                device: str) -> ServingEngine:
    """Engine factory body: load the checkpoint onto ``device`` and wrap
    it — called per (re)build by the router, on the device's worker."""
    params, _, _ = load(ckpt_path, device=device)
    return ServingEngine(params, cfg, dcfg, max_batch=max_batch,
                         device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="tiny=llada-8b-tiny:sum",
                    help="comma list of name=arch:task model specs")
    ap.add_argument("--strategy", default="fdm_a",
                    help="default decode strategy (per-request override "
                         "via the 'strategy' JSON field)")
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--budget-mb", type=int, default=0,
                    help="router residency budget in MiB (0 = unlimited)")
    ap.add_argument("--max-queue-depth", type=int, default=64)
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="default max queued seconds per request")
    ap.add_argument("--selftest", action="store_true",
                    help="serve on an ephemeral port, run one streamed "
                         "request, print its events, exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    router = ModelRouter(RouterConfig(
        budget_bytes=args.budget_mb << 20), device=args.device)
    ckpt_dir = tempfile.mkdtemp(prefix="repro-serve-")
    tokenizer = None
    first_ds = None
    for spec in args.models.split(","):
        name, _, rest = spec.partition("=")
        arch, _, task = rest.partition(":")
        if not (name and arch):
            raise SystemExit(f"bad --models entry {spec!r} "
                             f"(want name=arch:task)")
        path, cfg, dcfg, tok, ds = build_model(
            arch, task or "sum", args.train_steps, args.strategy,
            ckpt_dir, args.device)
        if tokenizer is None:
            tokenizer, first_ds = tok, ds
        # the factory loads from disk: evicted models genuinely free
        # their weights and rebuild on demand from the checkpoint
        router.register(
            name,
            lambda p=path, c=cfg, d=dcfg: load_engine(
                p, c, d, args.max_batch, args.device))

    scfg = ServerConfig(host=args.host,
                        port=0 if args.selftest else args.port,
                        max_queue_depth=args.max_queue_depth,
                        default_deadline_s=args.deadline_s)
    if args.selftest:
        _selftest(router, scfg, tokenizer, first_ds)
        return

    async def serve() -> None:
        server = ServingServer(router, scfg, tokenizer=tokenizer)
        host, port = await server.start()
        loop = asyncio.get_running_loop()
        drained = loop.create_future()

        def _on_sigterm() -> None:
            # graceful drain: admission stops (503 + Retry-After),
            # in-flight work finishes within the drain deadline,
            # leftover streams get terminal `shutdown` events
            if not drained.done():
                print("SIGTERM: draining "
                      f"(deadline {scfg.supervisor.drain_deadline_s:g}s)…")
                drained.set_result(None)

        try:
            loop.add_signal_handler(signal.SIGTERM, _on_sigterm)
            loop.add_signal_handler(signal.SIGINT, _on_sigterm)
        except NotImplementedError:
            pass                        # non-Unix event loop
        base = f"http://{host}:{port}"
        example = first_ds.prompts_only(
            first_ds.eval_batch(1))[0].tolist()
        print(f"serving {router.names()} on {base}")
        print("try:")
        print(f"  curl {base}/healthz")
        print(f"  curl -N -X POST {base}/v1/generate "
              f"-d '{json.dumps({'prompt': example, 'wait': True})}'")
        print(f"  rid=$(curl -s -X POST {base}/v1/generate "
              f"-d '{json.dumps({'prompt': example})}' "
              "| python -c 'import sys,json;"
              "print(json.load(sys.stdin)[\"rid\"])')")
        print(f"  curl -N {base}/v1/stream/$rid        # SSE blocks")
        print(f"  curl {base}/metrics")
        serve_task = asyncio.ensure_future(server.serve_forever())
        await drained
        # drain BEFORE tearing the accept loop down: open SSE readers
        # keep their connections and collect terminal events during the
        # drain window; only then does the listener close
        await server.drain()
        serve_task.cancel()
        try:
            await serve_task
        except (asyncio.CancelledError, RuntimeError):
            pass
        print("drained; bye")

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        print("\nbye")


def _selftest(router: ModelRouter, scfg: ServerConfig, tokenizer,
              ds) -> None:
    handle = ServerThread(router, scfg, tokenizer=tokenizer).start()
    try:
        client = ServingClient(handle.host, handle.port)
        print("healthz:", client.healthz())
        prompt = ds.prompts_only(ds.eval_batch(1))[0].tolist()
        print(f"streaming one request (prompt "
              f"{tokenizer.decode(prompt)!r}) …")
        status = None
        for name, event in client.generate_stream(prompt):
            if name == "block":
                print(f"  block {event['block']} cols "
                      f"[{event['lo']}:{event['hi']}] "
                      f"-> {event.get('text', event['tokens'])!r}")
            else:
                status = event.get("status")
                print(f"  {name}: status={status} "
                      f"latency={event.get('latency_s', 0):.3f}s")
        print("metrics head:")
        print("\n".join(client.metrics_text().splitlines()[:8]))
    finally:
        handle.stop()
    if status != "ok":
        raise SystemExit(f"selftest FAILED: the request ended {status!r}")
    print("selftest OK")


if __name__ == "__main__":
    main()
