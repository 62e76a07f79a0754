"""Inspect observability artifacts of the port: pretty-print a
Prometheus metrics exposition or a Chrome trace JSON, decode the
telemetry words of a serving snapshot, or drive a quick live replay and
dump everything from it.

    # validate and summarize what launch/serve.py wrote
    PYTHONPATH=src python -m repro_torch.launch.obs_dump --metrics m.prom
    PYTHONPATH=src python -m repro_torch.launch.obs_dump --trace trace.json

    # per-class / per-shard occupancy heatmap of a snapshot directory
    # (either package's: the ctl words and the fingerprint sidecar are
    # read straight from the files, no model, no engine)
    PYTHONPATH=src python -m repro_torch.launch.obs_dump --snapshot ./snap

    # a smoke engine replays a scenario; dump metrics, telemetry, trace
    PYTHONPATH=src python -m repro_torch.launch.obs_dump --live \\
        [--arch qwen2-0.5b] [--scenario steady] [--mega] [--device cpu]

Every path validates before it prints (``obs.metrics.validate_exposition``,
``obs.trace.validate_trace``) and exits non-zero on a malformed file.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

_BLOCKS = " ▁▂▃▄▅▆▇█"


def dump_metrics(path: str) -> None:
    from repro_torch.obs.metrics import validate_exposition
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        doc = json.loads(text)
        print(f"{path}: JSON metrics, {len(doc)} families")
        for name, fam in sorted(doc.items()):
            print(f"  {fam['type']:<9} {name} "
                  f"({len(fam['samples'])} samples)")
        return
    n = validate_exposition(text)
    print(f"{path}: valid Prometheus exposition, {n} samples")
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            print(f"  {kind:<9} {name}")


def dump_trace(path: str, require_phases: bool = False) -> None:
    from repro_torch.obs.trace import load, validate_trace
    doc = load(path)
    n = validate_trace(doc, require_phases=require_phases)
    print(f"{path}: valid trace, {n} events")
    by = {}
    for ev in doc["traceEvents"]:
        key = (ev["name"].split("/")[0], ev["cat"])
        tot, cnt = by.get(key, (0.0, 0))
        by[key] = (tot + ev.get("dur", 0.0), cnt + 1)
    print(f"  {'phase':<16} {'cat':<8} {'count':>6} {'total ms':>10}")
    for (name, cat), (tot, cnt) in sorted(by.items()):
        print(f"  {name:<16} {cat:<8} {cnt:>6} {tot / 1e3:>10.2f}")


def dump_snapshot(directory: str, step=None) -> None:
    """The live-page heatmap (t_alloc − t_free: pages held, by class
    and shard) and the raw telemetry words of a snapshot, straight from
    its committed files."""
    import numpy as np
    from repro_torch.ckpt import checkpoint as CK

    meta_rec, s = CK.read_meta(directory, step)
    fp = (meta_rec.get("extra") or {}).get("fingerprint")
    if fp is None:
        raise SystemExit(f"{directory}: step {s} has no serving "
                         f"fingerprint sidecar (not an engine snapshot)")
    # the layout rendering in the fingerprint carries the ctl word map
    fields = [(m.group(3), int(m.group(1)), int(m.group(2)))
              for m in re.finditer(r"ctl\[(\d+):(\d+)\]\s+(\S+)",
                                   fp["arena_layout"])]
    info = meta_rec["leaves"]["arena_ctl"]
    ctl = np.atleast_2d(np.load(os.path.join(
        directory, f"step_{s:08d}", info["file"])))   # (S, ctl_words)
    print(f"{directory}: snapshot step {s}, arch {fp.get('arch')}, "
          f"variant {fp.get('variant')}, {fp.get('num_shards')} shard(s)")
    tele = {name: ctl[:, a:b] for name, a, b in fields
            if name.startswith("t_")}
    if not tele:
        raise SystemExit("snapshot has no telemetry region (no t_* ctl "
                         "words in its fingerprint)")
    held = tele["t_alloc"] - tele["t_free"]   # (S, C)
    peak = max(1, int(held.max()))
    print(f"\nlive pages held (t_alloc − t_free), peak {peak}:")
    print("        " + " ".join(f"c{c}" for c in range(held.shape[1])))
    for sh in range(held.shape[0]):
        cells = "  ".join(_BLOCKS[min(len(_BLOCKS) - 1,
                                      (int(v) * (len(_BLOCKS) - 1)
                                       + peak - 1) // peak)]
                          for v in held[sh])
        print(f"  shard{sh} {cells}   {held[sh].tolist()}")
    print("\ntelemetry words:")
    for name, a, b in fields:
        if name.startswith("t_"):
            print(f"  {name:<12} {ctl[:, a:b].squeeze().tolist()}")


def live(arch: str, scenario: str, mega: bool, device: str) -> None:
    """Replay ``scenario`` on a smoke engine with a tracer, then print
    the summary, the drained telemetry, and the validated metrics and
    trace.  On the card the first tick loads the kernel libraries, so
    the trace must hold compile and steady ticks; on the CPU no tick
    loads one and every tick is steady."""
    from repro_torch.obs.metrics import validate_exposition
    from repro_torch.obs.trace import Tracer, validate_trace
    from repro_torch.serve.replay import (SCENARIOS, engine_factory,
                                          generate_trace, replay)

    cfg, make = engine_factory(arch, device=device)
    eng = make(mega=mega, tracer=Tracer())
    trace = generate_trace(SCENARIOS[scenario], seed=0,
                           vocab_size=cfg.vocab_size)
    result = replay(eng, trace, scenario=scenario)
    print(f"replay summary ({arch}/{scenario}/"
          f"{'mega' if mega else 'host'} on {eng.device}):")
    print(json.dumps(result.summary(), indent=2, sort_keys=True))
    print("\nallocator telemetry (drained ctl words):")
    for k, v in eng.drain_telemetry().items():
        print(f"  {k:<12} {v.tolist()}")
    n = validate_exposition(eng.publish_metrics().to_prometheus())
    print(f"\nmetrics exposition: valid, {n} samples")
    doc = eng.tracer.to_json()
    on_card = eng.device.type == "cuda"
    validate_trace(doc, require_phases=on_card)
    print(f"trace: valid, {len(doc['traceEvents'])} events"
          + (" (compile and steady ticks both present)" if on_card
             else " (every tick steady: no kernel library on the CPU)"))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="validate and pretty-print observability artifacts")
    ap.add_argument("--metrics", metavar="PATH",
                    help="Prometheus text (or .json) metrics file")
    ap.add_argument("--trace", metavar="PATH",
                    help="Chrome trace_event JSON file")
    ap.add_argument("--require-phases", action="store_true",
                    help="the trace must separate compile from steady "
                         "ticks")
    ap.add_argument("--snapshot", metavar="DIR",
                    help="serving snapshot directory: decode the ctl "
                         "telemetry words and render the per-class/"
                         "per-shard occupancy heatmap (engine-free)")
    ap.add_argument("--step", type=int, default=None,
                    help="snapshot step (default: newest committed)")
    ap.add_argument("--live", action="store_true",
                    help="replay a scenario on a smoke engine and dump "
                         "metrics, telemetry and trace from it")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--scenario", default="steady")
    ap.add_argument("--mega", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (their plain versions), "
                         "for --live")
    args = ap.parse_args(argv)
    if not (args.metrics or args.trace or args.snapshot or args.live):
        ap.error("nothing to do: pass --metrics, --trace, --snapshot, "
                 "or --live")
    if args.metrics:
        dump_metrics(args.metrics)
    if args.trace:
        dump_trace(args.trace, require_phases=args.require_phases)
    if args.snapshot:
        dump_snapshot(args.snapshot, step=args.step)
    if args.live:
        live(args.arch, args.scenario, args.mega, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
