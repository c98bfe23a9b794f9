"""Thin a training run's ``metrics.json``.

Counterpart of ``sos_wsod_tpu/tools/filter_metrics.py`` (the reference's
filter_events.py, which thins tensorboard event files): the trainers write
JSON lines (``utils/events.py:JSONWriter``); this keeps every Nth iteration
and, with ``--keys``, the keys with one of the given prefixes.

    python -m sos_wsod_torch.tools.filter_metrics --input OUT/metrics.json \\
        --output thin.json [--keys loss_cls total_loss] [--every 20]
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence


def filter_metrics(lines: Sequence[str], keys: Optional[Sequence[str]] = None,
                   every: int = 1) -> List[dict]:
    """The records of ``lines`` at iterations divisible by ``every``; with
    ``keys``, each cut to "iteration" and the keys with one of those
    prefixes, and dropped when none is left."""
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if every > 1 and rec.get("iteration", 0) % every != 0:
            continue
        if keys:
            rec = {k: v for k, v in rec.items()
                   if k == "iteration" or any(k.startswith(p) for p in keys)}
            if len(rec) <= 1:
                continue
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True, help="metrics.json path")
    ap.add_argument("--output", required=True)
    ap.add_argument("--keys", nargs="*", default=None, help="key prefixes to keep (default: all)")
    ap.add_argument("--every", type=int, default=1, help="keep every Nth iteration")
    args = ap.parse_args(argv)
    with open(args.input) as f:
        recs = filter_metrics(f.readlines(), args.keys, args.every)
    with open(args.output, "w") as f:
        for r in recs:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    print(f"kept {len(recs)} records -> {args.output}")


if __name__ == "__main__":
    main()
