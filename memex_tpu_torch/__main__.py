"""CLI entry point: `python -m memex_tpu_torch {serve,migrate,train,load,
download-model}`.

Port of memex_tpu/__main__.py. `serve` joins a multi-host process group
first when MEMEX_COORDINATOR is set (parallel/distributed.py), and drops
memex_tpu's other JAX parts (the XLA compile cache, the backend check
before warmup); the API server and the worker are the port's copies,
driven with a TorchRuntime. `serve`, `train` and `load` take `--device`, which defaults
to `cuda`; they fail when CUDA is not available unless `--device cpu` is
given: none moves to the CPU on its own.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from .config import Settings, load_dotenv
from .log import get_logger, init_logging

logger = get_logger("memex_tpu_torch.main")


def cmd_serve(args: argparse.Namespace) -> int:
    from .parallel.distributed import init_multihost
    from .runtime import TorchRuntime, require_device

    device = require_device(args.device, args.command)
    if device is None:
        return 2
    # Multi-host bring-up before the runtime (memex_tpu's order): the
    # sharded stores then span every rank. Each rank must receive the same
    # requests in the same order, as in memex_tpu; nothing here arranges it.
    init_multihost(device=device)
    roles = {r.strip().lower() for r in args.roles.split(",") if r.strip()}
    if not roles or not roles <= {"api", "worker"}:
        logger.error("invalid roles %r (expected Api,Worker)", args.roles)
        return 2
    settings = Settings.from_env(**{k: v for k, v in {
        "host": args.host,
        "port": args.port,
        "db_uri": args.database_connection,
        "vector_uri": args.vector_connection,
    }.items() if v is not None})
    rt = TorchRuntime(settings, device=device)

    worker = None
    if "worker" in roles:
        from .worker import Worker

        worker = Worker(rt)
        worker.start_background()

    stop = threading.Event()

    def handle_sig(signum, frame):
        logger.info("shutdown signal received")
        stop.set()

    signal.signal(signal.SIGINT, handle_sig)
    signal.signal(signal.SIGTERM, handle_sig)

    if "api" in roles:
        import asyncio

        from .api.server import start_async

        # Run every fused-path shape of the existing collections once before
        # taking traffic (the kernel build and first allocations land here,
        # not in a request). MEMEX_WARM_SERVE=0 opts out.
        if device.type == "cuda" and os.environ.get("MEMEX_WARM_SERVE", "1") != "0":
            try:
                for row in rt.db.query("SELECT DISTINCT collection FROM embeddings"):
                    n = rt.search_batcher.warmup(row["collection"])
                    logger.info("serve warmup: %s -> %d shapes", row["collection"], n)
            except Exception:
                logger.exception("serve warmup failed (continuing)")

        async def main():
            shutdown_event = asyncio.Event()

            def poll_stop():
                if stop.is_set():
                    shutdown_event.set()
                else:
                    asyncio.get_event_loop().call_later(0.2, poll_stop)

            asyncio.get_event_loop().call_later(0.2, poll_stop)
            await start_async(rt, shutdown_event)

        asyncio.run(main())
    else:
        stop.wait()

    if worker is not None:
        worker.shutdown()  # flushes checkpoints via rt.checkpoint_all()
    else:
        try:
            rt.checkpoint_all()
        except Exception:
            logger.exception("checkpoint on shutdown failed")
    return 0


def cmd_load(args: argparse.Namespace) -> int:
    """Bulk-enqueue documents from files/dirs (data-loader role)."""
    import glob

    from .db import queue
    from .runtime import TorchRuntime, require_device

    device = require_device(args.device, args.command)
    if device is None:
        return 2
    rt = TorchRuntime(Settings.from_env(), device=device)
    paths: list[str] = []
    for p in args.paths:
        if os.path.isdir(p):
            paths.extend(sorted(glob.glob(os.path.join(p, "**", "*"), recursive=True)))
        else:
            paths.append(p)
    items = []
    for p in paths:
        if not os.path.isfile(p):
            continue
        try:
            with open(p, "r", encoding="utf-8", errors="replace") as fh:
                content = fh.read()
        except OSError as exc:
            logger.warning("skipping %s: %s", p, exc)
            continue
        if content.strip():
            items.append((args.collection, content, queue.TaskType.Ingest))
    queue.enqueue_many(rt.db, items)
    logger.info("enqueued %d documents into %r", len(items), args.collection)
    if args.wait:
        from .worker import Worker

        worker = Worker(rt)
        try:
            if not worker.drain(timeout=args.timeout):
                logger.error("queue not drained after %.0fs", args.timeout)
                return 1
        finally:
            worker.shutdown()
    return 0


def cmd_download_model(args: argparse.Namespace) -> int:
    """Fetch model weights into a local dir. Needs network; in air-gapped
    environments place an HF-format checkpoint (model.safetensors +
    config.json + vocab.txt) at the target dir by any other means -- the
    loader (models/minilm.py) only reads local files."""
    target = args.target or os.path.join("models", args.model.split("/")[-1])
    needed = ["model.safetensors", "config.json", "vocab.txt"]
    if all(os.path.exists(os.path.join(target, f)) for f in needed):
        logger.info("model already present at %s", target)
        return 0
    try:
        from huggingface_hub import snapshot_download

        snapshot_download(
            repo_id=args.model,
            local_dir=target,
            allow_patterns=["*.safetensors", "config.json", "vocab.txt",
                            "tokenizer_config.json", "special_tokens_map.json"],
        )
    except Exception as exc:
        logger.error(
            "download failed (%s). If this host has no egress, copy an "
            "HF-format checkpoint (%s) into %s manually and set "
            "EMBEDDING_MODEL=%s.", exc, ", ".join(needed), target, target,
        )
        return 1
    missing = [f for f in needed if not os.path.exists(os.path.join(target, f))]
    if missing:
        logger.error("snapshot incomplete, missing: %s", missing)
        return 1
    logger.info("model ready at %s (set EMBEDDING_MODEL=%s)", target, target)
    return 0


def cmd_train(args: argparse.Namespace) -> int:
    """Fine-tune the encoder on an ingested collection and export the
    result in HF format (loadable via EMBEDDING_MODEL=<out>); prints the
    metrics as one JSON line."""
    import json

    from .runtime import TorchRuntime, require_device
    from .train import TrainConfig, train_encoder

    device = require_device(args.device, args.command)
    if device is None:
        return 2
    rt = TorchRuntime(Settings.from_env(), device=device)
    metrics = train_encoder(
        rt,
        args.collection,
        epochs=args.epochs,
        batch_size=args.batch_size,
        tc=TrainConfig(learning_rate=args.learning_rate),
        out_dir=args.out,
        resume=args.resume,
        checkpoint_path=args.checkpoint,
    )
    print(json.dumps(metrics))
    return 0


def cmd_migrate(args: argparse.Namespace) -> int:
    """Standalone migration runner."""
    from .db.connection import create_connection_by_uri

    uri = args.database_connection or Settings.from_env().db_uri
    create_connection_by_uri(uri, run_migrations=True)
    logger.info("migrations applied to %s", uri)
    return 0


def main(argv: list[str] | None = None) -> int:
    load_dotenv()
    init_logging()
    parser = argparse.ArgumentParser(prog="memex_tpu_torch",
                                     description="memex on PyTorch + CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="run the api/worker service")
    serve.add_argument("--host", default=None)
    serve.add_argument("--port", type=int, default=None)
    serve.add_argument("--roles", default="Api,Worker")
    serve.add_argument("--database-connection", default=None)
    serve.add_argument("--vector-connection", default=None)
    serve.add_argument("--device", default="cuda",
                       help="torch device for the encoder and indexes (default cuda)")
    serve.set_defaults(func=cmd_serve)

    migrate = sub.add_parser("migrate", help="apply schema migrations and exit")
    migrate.add_argument("--database-connection", default=None)
    migrate.set_defaults(func=cmd_migrate)

    tr = sub.add_parser("train", help="fine-tune the encoder on a collection")
    tr.add_argument("collection")
    tr.add_argument("--epochs", type=int, default=1)
    tr.add_argument("--batch-size", type=int, default=32)
    tr.add_argument("--learning-rate", type=float, default=2e-5)
    tr.add_argument("--out", default=None, help="export dir (HF format)")
    tr.add_argument("--resume", default=None, help="train-state .npz to resume")
    tr.add_argument("--checkpoint", default=None, help="train-state .npz to write")
    tr.add_argument("--device", default="cuda",
                    help="torch device to train on; every card of its type takes a "
                         "block of each batch (default cuda)")
    tr.set_defaults(func=cmd_train)

    dl = sub.add_parser("download-model", help="fetch embedding-model weights")
    dl.add_argument("--model", default="sentence-transformers/all-MiniLM-L12-v2")
    dl.add_argument("--target", default=None, help="output dir (default models/<name>)")
    dl.set_defaults(func=cmd_download_model)

    load = sub.add_parser("load", help="bulk-enqueue documents from files/dirs")
    load.add_argument("collection")
    load.add_argument("paths", nargs="+")
    load.add_argument("--wait", action="store_true", help="run a worker until drained")
    load.add_argument("--timeout", type=float, default=3600.0)
    load.add_argument("--device", default="cuda",
                      help="torch device for the worker's encoder and indexes (default cuda)")
    load.set_defaults(func=cmd_load)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
