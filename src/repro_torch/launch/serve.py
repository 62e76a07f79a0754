"""End-to-end serving driver of the port: continuous batching over the
Ouroboros paged KV cache, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --requests 16 --max-new 32 --max-batch 8 --max-seq 512

Each completed request prints a stable ``REQ <uid> <tokens...>`` line,
then a ``served N requests`` summary and the engine stats.  Weights are
random, made from ``--seed``.  ``--device cpu`` runs the plain PyTorch
versions of the kernels (with ``--smoke`` for a model the CPU can hold).
``--mega`` serves through the fused decode mega-step (one device tick,
one ``(B,)`` flag read per tick) and records ``launches_per_tick`` in
the stats before serving.

Crash-safe mode: with ``--snapshot-dir`` a ``PreemptionGuard`` arms
SIGTERM/SIGINT; the loop finishes the tick in flight, snapshots the
whole serving state (arena words, KV pages, queue) into the directory
and exits with code 3.  A restart with ``--resume`` restores the newest
committed snapshot and serves on token for token, so the killed run's
``REQ`` lines followed by the resumed run's are the uninterrupted run's.

Observability: ``--metrics-file`` writes the metrics registry (engine
stats, fragmentation gauges, drained allocator telemetry) every
``--metrics-every`` steps and at the end, as Prometheus text or JSON
(a ``.json`` suffix); ``--trace-file`` writes a Chrome/Perfetto trace of
the engine's phase spans at exit, ticks that loaded a kernel library
tagged apart from steady ones.  ``python -m repro_torch.launch.obs_dump``
validates and summarizes both files and snapshot directories.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--defrag-threshold", type=float, default=None,
                    metavar="RATIO",
                    help="fire a proactive defrag wave when frag_ratio "
                         "exceeds RATIO (0-1; default: only the "
                         "allocation-failure retry defrags)")
    ap.add_argument("--num-shards", type=int, default=1,
                    help="shard the KV page allocator into N independent "
                         "arenas with overflow routing (core/shards.py); "
                         "per-shard occupancy lands in the engine stats")
    ap.add_argument("--mega", action="store_true",
                    help="fused decode mega-step: grow, decode, sample and "
                         "advance on the device with one (B,) flag read "
                         "per tick; launches_per_tick lands in the stats")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="arm crash-safe serving: SIGTERM/SIGINT finishes "
                         "the current tick, snapshots the whole serving "
                         "state into DIR (ckpt/checkpoint.py's atomic "
                         "layout) and exits with code 3")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest committed snapshot under "
                         "--snapshot-dir and serve on (token for token) "
                         "instead of submitting fresh requests")
    ap.add_argument("--metrics-file", default=None, metavar="PATH",
                    help="write the metrics registry (engine stats, frag "
                         "gauges, drained allocator telemetry) to PATH as "
                         "Prometheus text exposition (.json suffix: JSON) "
                         "every --metrics-every steps and at the end")
    ap.add_argument("--metrics-every", type=int, default=50,
                    metavar="STEPS",
                    help="steps between --metrics-file rewrites "
                         "(default 50)")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "engine's phase spans to PATH at exit (ticks that "
                         "loaded a kernel library tagged apart from steady "
                         "ticks)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.metrics_every < 1:
        ap.error("--metrics-every must be >= 1")
    if args.resume and not args.snapshot_dir:
        ap.error("--resume requires --snapshot-dir")

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    tracer = None
    if args.trace_file:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    eng = ServingEngine(model, params, max_batch=args.max_batch,
                        max_seq=args.max_seq,
                        defrag_threshold=args.defrag_threshold,
                        num_shards=args.num_shards, mega_step=args.mega,
                        max_new_cap=max(args.max_new, 16), tracer=tracer,
                        device=device)
    if args.mega:
        eng.launches_per_tick()  # recorded in the stats before serving

    def write_metrics():
        if args.metrics_file:
            eng.publish_metrics().write(
                args.metrics_file,
                fmt="json" if args.metrics_file.endswith(".json")
                else "prometheus")

    guard = None
    if args.snapshot_dir:
        from repro_torch.ft.runtime import PreemptionGuard
        guard = PreemptionGuard()

    if args.resume:
        step = eng.restore(args.snapshot_dir)
        print(f"resumed from snapshot step {step} under {args.snapshot_dir}",
              flush=True)
    else:
        rng = np.random.default_rng(args.seed)
        for _ in range(args.requests):
            plen = int(rng.integers(4, args.max_seq // 4))
            eng.submit(rng.integers(2, cfg.vocab_size, plen),
                       max_new_tokens=args.max_new)

    t0 = time.time()
    done = []
    drained = preempted = False
    for tick in range(100000):
        finished = eng.step()
        if tick % args.metrics_every == 0:
            write_metrics()
        for r in finished:
            # one stable line per completed stream: the killed run's
            # lines followed by the resumed run's are the uninterrupted
            # run's
            print("REQ", r.uid, *r.out_tokens, flush=True)
        done.extend(finished)
        drained = not eng.waiting and all(s is None for s in eng.slot_req)
        if drained:
            break
        if guard is not None and guard.should_stop:
            path = eng.snapshot(directory=args.snapshot_dir)
            print(f"preempted: snapshot committed to {path}", flush=True)
            preempted = True
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    write_metrics()
    if tracer is not None:
        tracer.write(args.trace_file)
        print(f"trace written to {args.trace_file} "
              f"({len(tracer.events)} events)", flush=True)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s)")
    print(f"allocator stats: {eng.stats}")
    if preempted:
        return 3
    return 0 if drained else 1


if __name__ == "__main__":
    sys.exit(main())
