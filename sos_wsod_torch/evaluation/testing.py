"""Checks of evaluation results against TEST.EXPECTED_RESULTS.

Counterpart of ``sos_wsod_tpu/evaluation/testing.py`` (detectron2's
flatten_results_dict and verify_results): each expected entry is [task,
metric, expected, tolerance] and passes when |actual - expected| <
tolerance.
"""
from __future__ import annotations

import logging
import pprint
from typing import Dict, Mapping

logger = logging.getLogger(__name__)


def flatten_results_dict(results: Mapping) -> Dict[str, float]:
    """{'bbox': {'AP50': x}} -> {'bbox/AP50': x}."""
    out: Dict[str, float] = {}
    for k, v in results.items():
        if isinstance(v, Mapping):
            for kk, vv in flatten_results_dict(v).items():
                out[f"{k}/{kk}"] = vv
        else:
            out[str(k)] = v
    return out


def verify_results(cfg, results: Mapping) -> bool:
    """True when every entry of cfg.TEST.EXPECTED_RESULTS holds (a metric
    "a/b" reads results[task][a][b]); otherwise raises AssertionError
    listing every failure."""
    failures = []
    for task, metric, expected, tolerance in cfg.TEST.EXPECTED_RESULTS:
        actual = results[task]
        for part in str(metric).split("/"):
            actual = actual[part]
        ok = abs(float(actual) - float(expected)) < float(tolerance)
        logger.info("%s/%s: actual=%.4f expected=%.4f +/- %.4f -> %s", task, metric,
                    float(actual), float(expected), float(tolerance), "OK" if ok else "FAIL")
        if not ok:
            failures.append((task, metric, float(actual), float(expected), float(tolerance)))
    if failures:
        raise AssertionError("Result verification failed:\n" + pprint.pformat(failures)
                             + "\nFull results:\n" + pprint.pformat(dict(results)))
    return True
