"""Chain-server entry point: ``python -m generativeaiexamples_tpu_torch.server``.

Serves the pipeline from ``APP_*`` (``--help-config`` prints the schema)
on the card, or on the CPU with ``--device cpu``.  SIGTERM and SIGINT shut
down cleanly: the server stops accepting; with ``durability.enabled`` the
ingest pipeline drains, the journal closes, the WAL is flushed and a final
snapshot is cut (``durability.final_snapshot_on_shutdown``), so the next
start replays nothing; then the chat LLM's scheduler thread and the
retrieval micro-batcher stop.
"""

from __future__ import annotations

import argparse
import signal
import threading

from generativeaiexamples_tpu_torch.core.config import format_help
from generativeaiexamples_tpu_torch.core.configuration import AppConfig
from generativeaiexamples_tpu_torch.core.logging import configure_logging, get_logger


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="PyTorch/CUDA RAG chain server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8081)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="count", default=None, help="-v info, -vv debug")
    parser.add_argument(
        "--help-config", action="store_true",
        help="print the annotated config schema (file + env vars) and exit",
    )
    args = parser.parse_args(argv)
    if args.help_config:
        print(format_help(AppConfig))
        return
    configure_logging(args.verbose)
    logger = get_logger("chain-server")

    from generativeaiexamples_tpu_torch.chains.factory import reset_factories, shutdown_durability
    from generativeaiexamples_tpu_torch.core.configuration import get_config
    from generativeaiexamples_tpu_torch.server.app import create_app

    server = create_app(host=args.host, port=args.port, device=args.device)

    def _stop(signum, frame):  # noqa: ARG001 - signal handler signature
        # shutdown() waits for serve_forever to return: call it off the
        # serving (main) thread.
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    logger.info("starting chain server on %s:%d", args.host, server.server_address[1])
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if get_config().durability.enabled:
            shutdown_durability()  # drain, flush the WAL, cut the final snapshot
        reset_factories()  # stops the scheduler thread and the batcher
        logger.info("chain server stopped")


if __name__ == "__main__":
    main()
