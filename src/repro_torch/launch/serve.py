"""End-to-end serving driver of the port: continuous batching over the
Ouroboros paged KV cache, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --requests 16 --max-new 32 --max-batch 8 --max-seq 512

Each completed request prints a ``REQ <uid> <tokens...>`` line, then a
``served N requests`` summary and the engine stats.  Weights are random,
made from ``--seed``.  ``--device cpu`` runs the plain PyTorch versions
of the kernels (with ``--smoke`` for a model the CPU can hold).
``--mega`` serves through the fused decode mega-step (one device tick,
one ``(B,)`` flag read per tick) and records ``launches_per_tick`` in
the stats before serving.
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

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
    eng = ServingEngine(model, params, max_batch=args.max_batch,
                        max_seq=args.max_seq,
                        defrag_threshold=args.defrag_threshold,
                        num_shards=args.num_shards, mega_step=args.mega,
                        max_new_cap=max(args.max_new, 16), device=device)
    if args.mega:
        eng.launches_per_tick()  # recorded in the stats before serving
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.max_seq // 4))
        eng.submit(rng.integers(2, cfg.vocab_size, plen),
                   max_new_tokens=args.max_new)

    t0 = time.time()
    done = []
    drained = False
    for _ in range(100000):
        finished = eng.step()
        for r in finished:
            print("REQ", r.uid, *r.out_tokens, flush=True)
        done.extend(finished)
        drained = not eng.waiting and all(s is None for s in eng.slot_req)
        if drained:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s)")
    print(f"allocator stats: {eng.stats}")
    return 0 if drained else 1


if __name__ == "__main__":
    sys.exit(main())
