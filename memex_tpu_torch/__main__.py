"""CLI entry point: `python -m memex_tpu_torch serve --roles Api,Worker
[--device cuda]`.

Port of memex_tpu/__main__.py's `serve` without its JAX parts (multi-host
bring-up, the XLA compile cache, the backend check before warmup). The
API server and the worker are memex_tpu's, driven with a TorchRuntime.
The device defaults to `cuda`, and the command fails when CUDA is not
available unless `--device cpu` is given: it never moves to the CPU on
its own.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from memex_tpu.config import Settings, load_dotenv
from memex_tpu.log import get_logger, init_logging

logger = get_logger("memex_tpu_torch.main")


def cmd_serve(args: argparse.Namespace) -> int:
    import torch

    from .runtime import TorchRuntime

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error("--device %s requested but CUDA is not available "
                     "(use --device cpu to serve from the CPU)", args.device)
        return 2
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
        from memex_tpu.worker import Worker

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

        from memex_tpu.api.server import start_async

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
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
