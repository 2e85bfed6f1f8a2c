"""``python -m horovod_tpu_torch.serve`` / ``hvdtrun serve`` — serve a
checkpointed model over HTTP.

Minimal deploy::

    python -m horovod_tpu_torch.serve --checkpoint /ckpts --model mlp \
        --mlp-sizes 784,256,128,10 --port 8000

The port's counterpart of the JAX package's serve CLI: the same flags,
plus ``--device`` (the card unless ``--device cpu`` asks for the CPU; a
replica under ``--replicas`` serves on ``cuda:<local rank>``).  The
checkpoint directory is a port ``CheckpointManager`` tree
(``step_NNN/checkpoint.pt``, a ``model.state_dict()`` as written by
training); the newest step is loaded at startup and newer steps are
hot-swapped in while serving (--reload-interval).  Flag defaults come
from the ``HVDT_SERVE_*`` knobs, so a launcher can configure a fleet
purely through the env contract.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

__all__ = ["main", "parse_args", "build_server"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve",
        description="Serve a checkpointed model over HTTP "
                    "(/predict, /healthz, /metrics).")
    p.add_argument("--checkpoint", required=True,
                   help="CheckpointManager directory (holds step_NNN/ "
                        "subdirectories).")
    p.add_argument("--model", choices=("mlp", "transformer"), default="mlp")
    p.add_argument("--mlp-sizes", default="784,256,128,10",
                   help="Comma layer sizes for --model mlp.")
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--d-ff", type=int, default=2048)
    p.add_argument("--seq", type=int, default=128,
                   help="Serving sequence length for --model transformer.")
    p.add_argument("--host", default=None,
                   help="Bind address (default: HVDT_SERVE_HOST).")
    p.add_argument("--port", type=int, default=None,
                   help="Bind port, 0 = ephemeral (default: "
                        "HVDT_SERVE_PORT).")
    p.add_argument("--buckets", default=None,
                   help="Comma batch-size bucket ladder (default: "
                        "HVDT_SERVE_BUCKETS).")
    p.add_argument("--engine", choices=("static", "continuous"),
                   default=None,
                   help="Inference engine: 'static' shape buckets or the "
                        "'continuous' paged-KV LLM decode engine "
                        "(transformer only; not in this package yet; "
                        "default: HVDT_SERVE_ENGINE).")
    p.add_argument("--max-batch-size", type=int, default=None)
    p.add_argument("--max-delay-ms", type=float, default=None)
    p.add_argument("--max-queue-depth", type=int, default=None)
    p.add_argument("--reload-interval", type=float, default=None,
                   help="Seconds between checkpoint polls (default: "
                        "HVDT_SERVE_RELOAD_INTERVAL_S).")
    p.add_argument("--compilation-cache-dir", default=None,
                   help="Directory for what the process compiles at run "
                        "time (step_pipeline.enable_compilation_cache).")
    p.add_argument("--no-warmup", action="store_true",
                   help="Skip capturing every bucket at startup.")
    p.add_argument("--device", default=None,
                   help="'cpu' to serve on the CPU; the card otherwise "
                        "(a replica worker: cuda:<local rank>).")
    # --- elastic serving control plane (serve/autoscale.py + router) ---
    p.add_argument("--replicas", type=int, default=None,
                   help="Run the elastic serving control plane with this "
                        "many replicas behind the router (default: "
                        "HVDT_SERVE_REPLICAS; omit for the single-"
                        "replica direct server).")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="Replica ceiling for the autoscaler / localhost "
                        "slot count (default: HVDT_SERVE_MAX_REPLICAS).")
    p.add_argument("--autoscale", action="store_true",
                   help="Enable the replica autoscaler (queue depth / "
                        "p99-vs-SLO from the KV heartbeats; implies the "
                        "elastic control plane).")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="p99 latency SLO in ms: the router ejects "
                        "breaching replicas, the autoscaler scales "
                        "while the fleet breaches (default: "
                        "HVDT_SERVE_SLO_P99_MS; 0 = off).")
    p.add_argument("--router-port", type=int, default=None,
                   help="Router bind port (default: "
                        "HVDT_SERVE_ROUTER_PORT; 0 = ephemeral).")
    p.add_argument("--host-discovery-script", default=None,
                   help="Discovery executable printing host[:slots]"
                        "[@pod] lines for the replica fleet (default: "
                        "localhost with --max-replicas slots).")
    p.add_argument("--target-file", default=None,
                   help="Operator override: a file holding the desired "
                        "replica count, polled by the driver (echo 3 > "
                        "FILE resizes the fleet; remove to hand control "
                        "back to the autoscaler).")
    # Internal: set by the serve driver on spawned replica workers
    # (rendezvous env contract; heartbeats, drains, exits 83).
    p.add_argument("--replica-worker", action="store_true",
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


_CONTROL_FLAGS = {"--replicas": 1, "--max-replicas": 1, "--autoscale": 0,
                  "--slo-p99-ms": 1, "--router-port": 1,
                  "--host-discovery-script": 1, "--target-file": 1,
                  "--replica-worker": 0}


def strip_control_flags(argv):
    """The serve argv minus the control-plane flags — what the driver
    hands each spawned replica worker (which adds --replica-worker)."""
    out, skip = [], 0
    for tok in argv:
        if skip:
            skip -= 1
            continue
        flag = tok.split("=", 1)[0]
        if flag in _CONTROL_FLAGS:
            skip = _CONTROL_FLAGS[flag] if "=" not in tok else 0
            continue
        out.append(tok)
    return out


def build_server(args):
    """Assemble (server, feature_shape) from parsed args — split out so
    tests and ``bench --serve`` can drive the exact CLI path
    in-process."""
    import numpy as np

    from ..common import config
    from ..common.basics import resolve_device
    from .engine import InferenceEngine, parse_buckets
    from .server import ModelServer

    engine_kind = (args.engine if getattr(args, "engine", None)
                   else config.get_str("HVDT_SERVE_ENGINE"))
    if engine_kind not in ("static", "continuous"):
        raise ValueError(f"HVDT_SERVE_ENGINE={engine_kind!r}: expected "
                         "'static' or 'continuous'")
    if engine_kind == "continuous":
        raise NotImplementedError(
            "the continuous engine is not ported yet (ROADMAP Queue 1, "
            "item 7 part 2: LLM serving)")
    buckets = parse_buckets(args.buckets)
    device = resolve_device(getattr(args, "device", None))
    if args.model == "mlp":
        from ..models.mlp import mlp_apply, mlp_init

        sizes = [int(s) for s in args.mlp_sizes.split(",")]
        params = mlp_init(0, sizes, device=device)
        apply_fn, feat_shape = mlp_apply, (sizes[0],)
        input_dtype = np.float32
    else:
        from ..models.transformer import (TransformerConfig,
                                          transformer_apply,
                                          transformer_init)

        cfg = TransformerConfig(vocab=args.vocab, layers=args.layers,
                                d_model=args.d_model, heads=args.heads,
                                kv_heads=args.heads, d_ff=args.d_ff,
                                max_seq=args.seq)
        params = transformer_init(0, cfg, device=device)
        apply_fn = lambda p, x: transformer_apply(p, x, cfg)  # noqa: E731
        feat_shape = (args.seq,)
        input_dtype = np.int32

    engine = InferenceEngine(apply_fn, params, buckets=buckets,
                             compile_cache=args.compilation_cache_dir)
    server = ModelServer(
        engine, host=args.host, port=args.port,
        checkpoint_dir=args.checkpoint,
        max_batch_size=args.max_batch_size,
        max_delay_ms=args.max_delay_ms,
        max_queue_depth=args.max_queue_depth,
        input_dtype=input_dtype)
    if server.watcher is not None and args.reload_interval is not None:
        server.watcher.poll_interval_s = float(args.reload_interval)
    return server, feat_shape


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = parse_args(argv)
    if args.replica_worker:
        # One replica under the serving driver: heartbeat into the
        # rendezvous KV, serve until drained, exit 83 for clean removal.
        from .replica import run_replica

        return run_replica(args)
    if args.replicas is not None or args.autoscale:
        # The elastic serving control plane: driver + replica fleet +
        # router in this process group (serve/autoscale.py).
        from .autoscale import run_serve_elastic

        return run_serve_elastic(args, strip_control_flags(argv))
    server, feat_shape = build_server(args)
    # Load the newest checkpoint BEFORE binding: a replica that cannot
    # find weights should say so immediately, then (deliberately) still
    # come up on the init template — a smoke deploy with an empty
    # directory is a supported first-run path.
    loaded = server.watcher.check_once() if server.watcher else None
    if loaded is None and (server.watcher is None
                           or server.watcher.current_step is None):
        print(f"serve: no checkpoint under {args.checkpoint!r} yet — "
              "serving freshly-initialized weights until one appears",
              file=sys.stderr)
    if not args.no_warmup:
        dtype = server.input_dtype
        import numpy as np

        server.engine.warmup(feat_shape, dtype=np.dtype(dtype))
    port = server.start()
    print(f"serving {args.model} on http://{server.host}:{port} "
          f"(buckets={list(server.engine.buckets)}, "
          f"checkpoint={args.checkpoint})", file=sys.stderr)
    try:
        while True:
            import time

            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
