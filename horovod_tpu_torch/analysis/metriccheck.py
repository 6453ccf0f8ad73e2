"""The port's metric-namespace lint (the reference's
``horovod_tpu/analysis/metriccheck.py``, over the port's registry).

Every metric the port declares in
:data:`horovod_tpu_torch.metrics.METRIC_SPECS` must match the registry's
``NAME_RE`` (``^hvd_tpu_[a-z0-9_]+$``: the reference's names, so dashboards
carry over), carry a ``(type, help)`` tuple with a known type and a
non-empty help string, and counters must end in ``_total`` (the
Prometheus naming convention). The registry factories enforce the same
rules at runtime for undeclared names; this check catches a bad
declaration before anything ever instantiates it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

VALID_TYPES = ("counter", "gauge", "histogram", "events")


def validate_specs(specs: Dict[str, Tuple[str, str]]) -> List[str]:
    """Return a list of error strings; empty means the table is clean."""
    from ..metrics import NAME_RE
    errors = []
    for name, spec in sorted(specs.items()):
        if not isinstance(spec, tuple) or len(spec) != 2:
            errors.append(f"{name}: spec must be a (type, help) tuple")
            continue
        kind, help_str = spec
        if not NAME_RE.match(name):
            errors.append(
                f"{name}: does not match {NAME_RE.pattern}")
        if kind not in VALID_TYPES:
            errors.append(f"{name}: unknown metric type {kind!r}")
        if not isinstance(help_str, str) or not help_str.strip():
            errors.append(f"{name}: missing help string")
        if kind == "counter" and not name.endswith("_total"):
            errors.append(
                f"{name}: counters must end in _total "
                f"(Prometheus naming convention)")
    return errors


def run(pkg_root: Optional[str] = None) -> Tuple[List[str], dict]:
    """The full lint: (errors, stats) — the shared report shape all
    eight lints of ``analysis/check.py`` use. ``pkg_root`` is accepted for
    driver uniformity; the registry is process-global."""
    del pkg_root
    from ..metrics import METRIC_SPECS
    return validate_specs(METRIC_SPECS), {"declared": len(METRIC_SPECS)}
