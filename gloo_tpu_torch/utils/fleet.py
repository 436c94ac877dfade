"""Fleet observability document helpers (docs/fleet.md).

The in-band fleet plane (``Context.fleetobs_start()``) folds every
rank's metrics / profile / health snapshot up the host topology —
members to their host leader, leaders to rank 0 — and rank 0 merges the
stream into one **fleet document** served as ``/fleet`` by
:func:`gloo_tpu_torch.utils.telemetry.serve_telemetry` and returned by
``Context.fleet()``. This module is the consumer side of that document:

- :func:`reports` flattens the embedded per-rank reports out of the
  per-host nesting;
- :func:`coverage` answers "is rank 0 actually seeing the whole
  fleet" (expected / reported / missing / stale);
- :func:`unhealthy` lists the ranks whose own reports flag trouble
  (transport failure, watchdog stalls, op errors);
- :func:`summarize` folds all of the above plus the straggler
  leaderboard, slow links, and recent anomalies into one compact dict
  (what a dashboard or ``tools/profile_view.py --fleet`` renders);
- :func:`render` is the human-readable text form of a summary.

All helpers are pure functions over the parsed JSON document — they
never talk to the network; pair them with
``telemetry.fetch_route(url, "/fleet")`` for live use.

The port's copy of gloo_tpu/utils/fleet.py, kept so that the port
imports nothing of the JAX package: the same functions over the same
documents, which the port's own build of the native core emits.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = [
    "coverage",
    "render",
    "reports",
    "summarize",
    "unhealthy",
]


def reports(fleet: dict) -> Dict[int, dict]:
    """Flatten ``{rank: report}`` out of the document's per-host
    nesting. Ranks are ints (wire keys are JSON strings)."""
    out: Dict[int, dict] = {}
    for host in fleet.get("hosts", []) or []:
        for rank, report in (host.get("ranks") or {}).items():
            out[int(rank)] = report
    return out


def coverage(fleet: dict) -> dict:
    """Coverage verdict: ``{"expected", "reported", "missing": [...],
    "complete": bool}``. Prefers the document's own coverage section
    (rank 0 computes it against the live topology) and recomputes from
    the embedded reports when absent (e.g. a truncated document)."""
    cov = fleet.get("coverage")
    if cov is not None:
        expected = cov.get("expected", 0)
        reported = cov.get("reported", 0)
        # Both conditions: a stub document (no aggregation round yet)
        # reports 0 with an empty missing list — that is not coverage.
        return {
            "expected": expected,
            "reported": reported,
            "missing": list(cov.get("missing", [])),
            "complete": (reported >= expected
                         and not cov.get("missing", [])),
        }
    got = reports(fleet)
    expected = fleet.get("size", len(got))
    missing = [r for r in range(expected) if r not in got]
    return {"expected": expected, "reported": len(got),
            "missing": missing, "complete": not missing}


def unhealthy(fleet: dict) -> List[dict]:
    """Ranks whose own report flags trouble, most-errors first:
    ``[{"rank", "reasons": [...]}, ...]``. A missing/unparseable report
    is NOT listed here — that is a coverage problem, not a health
    verdict (see :func:`coverage`)."""
    out: List[dict] = []
    for rank, rep in sorted(reports(fleet).items()):
        reasons: List[str] = []
        if rep.get("ok") is False:
            peer = rep.get("failure_peer", -1)
            reasons.append(f"transport failure (peer {peer})")
        if rep.get("stalls", 0):
            reasons.append(f"{rep['stalls']} watchdog stall(s)")
        if rep.get("errors", 0):
            reasons.append(f"{rep['errors']} op error(s)")
        if reasons:
            out.append({"rank": rank, "reasons": reasons})
    out.sort(key=lambda e: -len(e["reasons"]))
    return out


def summarize(fleet: dict) -> dict:
    """One compact dict over the whole document: coverage, health,
    straggler leaderboard, slow links, anomaly tallies. Safe on stub
    documents (non-rank-0 / plane off): everything degrades to empty."""
    strag = fleet.get("straggler", {}) or {}
    anomalies = fleet.get("anomalies", {}) or {}
    recent = anomalies.get("recent", []) or []
    by_kind: Dict[str, int] = {}
    for ev in recent:
        kind = ev.get("kind", "?")
        by_kind[kind] = by_kind.get(kind, 0) + 1
    return {
        "enabled": bool(fleet.get("enabled")),
        "round": fleet.get("round", 0),
        "size": fleet.get("size", 0),
        "hosts": len(fleet.get("hosts", []) or []),
        "coverage": coverage(fleet),
        "unhealthy": unhealthy(fleet),
        "leaderboard": list(strag.get("leaderboard", [])),
        "slow_links": list(fleet.get("slow_links", []) or []),
        "anomalies_total": anomalies.get("total", 0),
        "recent_anomalies_by_kind": by_kind,
    }


def render(fleet: dict) -> str:
    """Human-readable text form of :func:`summarize` (the
    ``tools/*_view.py --fleet`` output)."""
    s = summarize(fleet)
    lines: List[str] = []
    if not s["enabled"]:
        note = fleet.get("note", "fleet plane not running here")
        lines.append(f"fleet: disabled/stub ({note})")
        return "\n".join(lines) + "\n"
    cov = s["coverage"]
    lines.append(
        f"fleet: round {s['round']}, {s['size']} ranks across "
        f"{s['hosts']} host(s), coverage {cov['reported']}/"
        f"{cov['expected']}"
        + (f" (missing: {cov['missing']})" if cov["missing"] else ""))
    if s["unhealthy"]:
        for e in s["unhealthy"]:
            lines.append(
                f"  unhealthy rank {e['rank']}: "
                + "; ".join(e["reasons"]))
    else:
        lines.append("  all reporting ranks healthy")
    if s["leaderboard"]:
        lines.append("  straggler leaderboard (blamed wait over the "
                     "detection window):")
        for row in s["leaderboard"][:5]:
            lines.append(
                f"    rank {row.get('rank')}: "
                f"{row.get('blamed_us', 0) / 1000.0:.1f}ms over "
                f"{row.get('blamed_ops', 0)} op(s)")
    if s["slow_links"]:
        for link in s["slow_links"]:
            lines.append(
                f"  slow link {link.get('rank')}->{link.get('peer')}: "
                f"{link.get('bw_bps', 0) / 1e6:.1f} MB/s vs median "
                f"{link.get('median_bps', 0) / 1e6:.1f} MB/s")
    total = s["anomalies_total"]
    if total or s["recent_anomalies_by_kind"]:
        kinds = ", ".join(f"{k}×{n}" for k, n
                          in sorted(s["recent_anomalies_by_kind"].items()))
        lines.append(f"  anomalies: {total} total"
                     + (f" (recent: {kinds})" if kinds else ""))
    else:
        lines.append("  no anomalies detected")
    return "\n".join(lines) + "\n"
