"""The placement-service regime (`--service`): the counterpart of
bench.py's `bench_service`."""

from __future__ import annotations

import json
import sys
import time

from .shapes import make_cluster, make_gangs, regime_device


def bench_service(args, device=None) -> int:
    """Solve the stress backlog through the gRPC service boundary: the
    server subprocess owns the accelerator; this process only encodes,
    ships, and decodes. SURVEY hard part (d): the RPC hop + host->device
    transfer must amortize over whole-backlog batches — this measures it
    against the in-process engine wall.

    The server is `python -m grove_tpu_torch.service.server` on `device`
    (None: the card). Both sides need the grpc package: without it this
    raises an ImportError naming grpc, before anything starts; it never
    falls back to an in-process solve."""
    import os
    import signal
    import subprocess
    import tempfile

    try:
        import grpc  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "bench --service needs the grpc package (grpcio): the "
            "placement service's server and client speak gRPC"
        ) from exc
    device = regime_device(args, device)

    if args.small:
        args.nodes, args.gangs, args.iters = 512, 64, 3

    snapshot = make_cluster(args.nodes)
    gangs = make_gangs(args.gangs)

    sock = os.path.join(tempfile.mkdtemp(), "placement.sock")
    address = f"unix:{sock}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "grove_tpu_torch.service.server",
         "--address", address,
         *(["--device", str(device)] if device is not None else [])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        # scan a few lines for the banner (interpreter warnings may
        # precede it); a dead process means startup failed — surface its
        # output instead of hanging in a blocking read on a live pipe
        seen = []
        for _ in range(10):
            line = proc.stdout.readline()
            seen.append(line)
            if "listening" in line:
                break
            if not line or proc.poll() is not None:
                raise RuntimeError(
                    "placement service failed to start:\n" + "".join(seen)
                )
        else:
            proc.send_signal(signal.SIGTERM)
            raise RuntimeError(
                "placement service never reported listening:\n"
                + "".join(seen)
            )
        from ..service.client import RemotePlacementEngine
        from ..service.codec import encode_solve_request

        engine = RemotePlacementEngine(snapshot, address)
        engine.solve(gangs)  # warm-up: server-side compile + caches
        walls = []
        placed = 0
        for _ in range(args.iters):
            t0 = time.perf_counter()
            result = engine.solve(gangs)
            walls.append(time.perf_counter() - t0)
            placed = result.num_placed
        walls.sort()
        p99 = walls[min(len(walls) - 1, int(round(0.99 * (len(walls) - 1))))]
        wire = len(encode_solve_request(
            engine.epoch, gangs, snapshot.free.copy()))
        out = {
            "metric": f"gang placements/sec over the gRPC service boundary "
            f"({args.gangs} x 8-pod gangs, {args.nodes} nodes)",
            "value": round(args.gangs / p99, 1),
            "unit": "gangs/sec",
            "vs_baseline": 0.0,  # no serial comparison in service mode
            "p99_backlog_bind_seconds": round(p99, 4),
            "p50_backlog_bind_seconds": round(walls[len(walls) // 2], 4),
            "placed": placed,
            "request_bytes": wire,
            "engine": "service",
        }
        print(json.dumps(out))
        return 0
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            # a lingering server holds the accelerator and poisons the
            # next run's device acquisition (advisor r3)
            proc.kill()
            proc.wait(timeout=10)
