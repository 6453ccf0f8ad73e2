"""Merged-trace schema rules: the port's copy of the reference's
``tools/trace_report.py`` ``check_events`` (its ``--check`` lint), so the
trace-schema self-check of :mod:`.check` needs nothing outside the
package. The rules are the reference's:

- every event is an object with a known ``ph``, a numeric ``ts``
  (metadata excepted) and an integer ``pid``;
- "B"/"E" balance per (pid, tid), with no dangling end;
- every correlation id parses as ``name#world_version#seq``;
- per (pid, corr): at most one enqueue (B) and one complete (E) — the
  exactly-once-per-phase invariant the merger guarantees.

Pure stdlib: the correlation-id grammar is restated here
(``horovod_tpu_torch/trace.py`` ``parse_corr``, whose separator
:mod:`.check`'s self-check holds this one to).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

VALID_PHASES = ("B", "E", "X", "i", "C", "M", "b", "e")
CORR_SEP = "#"


def parse_corr(corr: str) -> Tuple[str, int, int]:
    """``name#world_version#seq`` -> parts; raises ValueError on a
    malformed id."""
    name, wv, seq = corr.rsplit(CORR_SEP, 2)
    return name, int(wv), int(seq)


def _corr_of(ev: dict) -> Optional[str]:
    args = ev.get("args")
    if isinstance(args, dict):
        c = args.get("corr")
        if isinstance(c, str):
            return c
    return None


def check_events(events: List[dict]) -> List[str]:
    """Validate the merged-trace schema; returns error strings (empty =
    clean)."""
    errors: List[str] = []
    depth: Dict[Tuple[int, int], int] = {}
    seen: Dict[Tuple[int, str], Dict[str, int]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in VALID_PHASES:
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"event {i}: missing numeric ts")
        if not isinstance(ev.get("pid"), int):
            errors.append(f"event {i}: missing integer pid")
            continue
        key = (ev.get("pid"), ev.get("tid", 0))
        if ph == "B":
            depth[key] = depth.get(key, 0) + 1
        elif ph == "E":
            if depth.get(key, 0) <= 0:
                errors.append(f"event {i}: dangling E on pid/tid {key}")
            else:
                depth[key] -= 1
        corr = _corr_of(ev)
        if corr is not None:
            try:
                parse_corr(corr)
            except (ValueError, TypeError):
                errors.append(f"event {i}: malformed correlation id "
                              f"{corr!r}")
                continue
            if ph in ("B", "E"):
                phases = seen.setdefault((ev["pid"], corr), {})
                phases[ph] = phases.get(ph, 0) + 1
                if phases[ph] > 1:
                    errors.append(
                        f"event {i}: correlation id {corr!r} appears "
                        f"{phases[ph]}x in phase {ph} on pid {ev['pid']}")
    for key, d in depth.items():
        if d != 0:
            errors.append(f"pid/tid {key}: {d} unclosed B span(s)")
    return errors
