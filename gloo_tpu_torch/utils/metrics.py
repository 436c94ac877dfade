"""Metrics post-processing: Prometheus text exposition + histogram math.

`Context.metrics()` returns the native registry's structured snapshot
(see its docstring for the shape). This module turns snapshots into the
two forms a production deployment actually consumes:

- `to_prometheus(snapshot)` renders the Prometheus text exposition format
  (serve it from a /metrics endpoint or push it through a gateway);
- `histogram_quantile(hist, q)` estimates latency quantiles from the
  fixed power-of-two buckets (p50/p95 for dashboards and bench output);
- `merge_snapshots(snaps)` sums per-rank snapshots into a job-level view.

The native histograms store per-bucket (non-cumulative) counts as
[[upper_bound_us, count], ...]; Prometheus buckets are cumulative with a
trailing +Inf, and the conversion happens here so the hot path stays a
couple of relaxed atomic adds.

The port's copy of gloo_tpu/utils/metrics.py, kept so that the port
imports nothing of the JAX package: the same functions over the same
documents, which the port's own build of the native core emits.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional


def histogram_quantile(hist: dict, q: float) -> float:
    """Estimate the q-quantile (0 < q <= 1) in microseconds.

    Uses linear interpolation within the containing power-of-two bucket
    ([upper/2, upper]); the true value is within 2x, which is what
    log-bucketed histograms buy. Returns 0.0 for an empty histogram.
    """
    total = hist.get("count", 0)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0
    for upper, n in hist.get("buckets", []):
        if cum + n >= target:
            lower = upper / 2 if upper > 1 else 0
            frac = (target - cum) / n
            return lower + frac * (upper - lower)
        cum += n
    return float(hist.get("max_us", 0))


def summarize_ops(snapshot: dict) -> Dict[str, dict]:
    """Per-op {calls, bytes, errors, p50_us, p95_us, mean_us} digest —
    the compact form bench.py embeds in its JSON line."""
    out = {}
    for name, s in snapshot.get("ops", {}).items():
        hist = s.get("latency_us", {})
        count = hist.get("count", 0)
        out[name] = {
            "calls": s.get("calls", 0),
            "bytes": s.get("bytes", 0),
            "errors": s.get("errors", 0),
            "p50_us": round(histogram_quantile(hist, 0.50), 1),
            "p95_us": round(histogram_quantile(hist, 0.95), 1),
            "mean_us": round(hist.get("sum_us", 0) / count, 1)
            if count else 0.0,
        }
    return out


def _escape_label_value(value: object) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote, and line-feed must be escaped or the line
    is unparseable — and transport-failure messages (which become label
    values) routinely contain quotes and newlines."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, object]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _family(lines: List[str], name: str, kind: str, help_text: str) -> None:
    """Open one metric family: exactly one ``# HELP`` and one ``# TYPE``
    line, in that order, before the family's first sample — the
    exposition-format contract tests/test_prometheus_lint.py enforces.
    HELP text escapes backslash and line-feed (the only escapes the
    format defines for help lines)."""
    escaped = help_text.replace("\\", "\\\\").replace("\n", "\\n")
    lines.append(f"# HELP {name} {escaped}")
    lines.append(f"# TYPE {name} {kind}")


def _emit_histogram(lines: List[str], name: str, hist: dict,
                    labels: Dict[str, object]) -> None:
    cum = 0
    for upper, n in hist.get("buckets", []):
        cum += n
        lines.append(f"{name}_bucket"
                     f"{_fmt_labels({**labels, 'le': upper})} {cum}")
    lines.append(f"{name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} "
                 f"{hist.get('count', 0)}")
    lines.append(f"{name}_sum{_fmt_labels(labels)} "
                 f"{hist.get('sum_us', 0)}")
    lines.append(f"{name}_count{_fmt_labels(labels)} "
                 f"{hist.get('count', 0)}")


def to_prometheus(snapshot: dict,
                  extra_labels: Optional[Dict[str, object]] = None) -> str:
    """Render one rank's snapshot in the Prometheus text exposition
    format (version 0.0.4). Latency units stay microseconds — the metric
    names say so explicitly rather than silently converting."""
    base = dict(extra_labels or {})
    base["rank"] = snapshot.get("rank", 0)
    # Split sub-communicators stamp their group tag into the snapshot
    # (Context.group_tag()); label every family with it so one scrape
    # distinguishes e.g. a DP group's traffic from its TP sibling's.
    # Root contexts ("" group) stay unlabeled — unchanged series names.
    if snapshot.get("group"):
        base["group"] = snapshot["group"]
    lines: List[str] = []

    _family(lines, "gloo_tpu_collective_calls_total", "counter",
            "Collective/p2p calls issued, by op.")
    _family(lines, "gloo_tpu_collective_bytes_total", "counter",
            "Payload bytes moved by collectives, by op.")
    _family(lines, "gloo_tpu_collective_errors_total", "counter",
            "Collective calls that raised, by op.")
    _family(lines, "gloo_tpu_collective_latency_us", "histogram",
            "End-to-end collective latency (microseconds), by op.")
    for op, s in sorted(snapshot.get("ops", {}).items()):
        labels = {**base, "op": op}
        lines.append(f"gloo_tpu_collective_calls_total"
                     f"{_fmt_labels(labels)} {s.get('calls', 0)}")
        lines.append(f"gloo_tpu_collective_bytes_total"
                     f"{_fmt_labels(labels)} {s.get('bytes', 0)}")
        lines.append(f"gloo_tpu_collective_errors_total"
                     f"{_fmt_labels(labels)} {s.get('errors', 0)}")
        _emit_histogram(lines, "gloo_tpu_collective_latency_us",
                        s.get("latency_us", {}), labels)

    # Phase profiler aggregates (docs/profiling.md): one histogram per
    # (collective, algorithm, phase) — the scrape-side decomposition of
    # gloo_tpu_collective_latency_us into pack/post/wire_wait/reduce/
    # unpack (+ hier intra/inter/fanout).
    _family(lines, "gloo_tpu_phase_latency_us", "histogram",
            "Per-phase collective latency (microseconds), by "
            "op/algorithm/phase (docs/profiling.md).")
    for op, algos in sorted(snapshot.get("phases", {}).items()):
        for algo, phases in sorted(algos.items()):
            for phase, hist in sorted(phases.items()):
                labels = {**base, "op": op, "algorithm": algo,
                          "phase": phase}
                _emit_histogram(lines, "gloo_tpu_phase_latency_us",
                                hist, labels)

    _family(lines, "gloo_tpu_transport_sent_msgs_total", "counter",
            "Messages sent to a peer.")
    _family(lines, "gloo_tpu_transport_sent_bytes_total", "counter",
            "Bytes sent to a peer.")
    _family(lines, "gloo_tpu_transport_recv_msgs_total", "counter",
            "Messages received from a peer.")
    _family(lines, "gloo_tpu_transport_recv_bytes_total", "counter",
            "Bytes received from a peer.")
    _family(lines, "gloo_tpu_transport_last_progress_age_us", "gauge",
            "Microseconds since the pair last moved a byte.")
    _family(lines, "gloo_tpu_transport_recv_wait_us", "histogram",
            "Time waitRecv blocked on a peer (microseconds).")
    for peer, s in sorted(snapshot.get("transport", {}).items()):
        labels = {**base, "peer": peer}
        for field, metric in (("sent_msgs", "sent_msgs_total"),
                              ("sent_bytes", "sent_bytes_total"),
                              ("recv_msgs", "recv_msgs_total"),
                              ("recv_bytes", "recv_bytes_total"),
                              ("last_progress_age_us",
                               "last_progress_age_us")):
            lines.append(f"gloo_tpu_transport_{metric}"
                         f"{_fmt_labels(labels)} {s.get(field, 0)}")
        _emit_histogram(lines, "gloo_tpu_transport_recv_wait_us",
                        s.get("recv_wait_us", {}), labels)

    # Link-level wire telemetry (fleet observability plane,
    # docs/fleet.md): per-(peer, channel, direction) bytes, post counts,
    # and the windowed EWMA bandwidth / credit-RTT estimates the
    # slow-link detector consumes.
    _family(lines, "gloo_tpu_pair_bytes_total", "counter",
            "Wire bytes per (peer, channel, direction).")
    _family(lines, "gloo_tpu_pair_posts_total", "counter",
            "Send operations posted toward a peer (enqueue intent; a "
            "growing gap vs sent_msgs is a backed-up link).")
    _family(lines, "gloo_tpu_pair_bw_ewma", "gauge",
            "EWMA link bandwidth toward a peer, bytes/second.")
    _family(lines, "gloo_tpu_pair_rtt_ewma_us", "gauge",
            "EWMA link round-trip estimate toward a peer "
            "(shm credit grants / connect handshake), microseconds.")
    for peer, s in sorted(snapshot.get("transport", {}).items()):
        labels = {**base, "peer": peer}
        for direction, field in (("tx", "chan_tx"), ("rx", "chan_rx")):
            for channel, nbytes in sorted(
                    (s.get(field) or {}).items()):
                lines.append(
                    f"gloo_tpu_pair_bytes_total"
                    f"{_fmt_labels({**labels, 'channel': channel, 'direction': direction})}"
                    f" {nbytes}")
        lines.append(f"gloo_tpu_pair_posts_total{_fmt_labels(labels)} "
                     f"{s.get('tx_posts', 0)}")
        lines.append(f"gloo_tpu_pair_bw_ewma{_fmt_labels(labels)} "
                     f"{s.get('bw_ewma_bps', 0)}")
        lines.append(f"gloo_tpu_pair_rtt_ewma_us{_fmt_labels(labels)} "
                     f"{s.get('rtt_ewma_us', 0)}")

    # Multi-channel transport: wire bytes per data channel (channel "0"
    # is the primary connection; >= "1" carry stripes of large messages
    # when TPUCOLL_CHANNELS > 1) and per-loop-thread progress.
    _family(lines, "gloo_tpu_channel_tx_bytes_total", "counter",
            "Wire bytes transmitted per data channel (all peers).")
    _family(lines, "gloo_tpu_channel_rx_bytes_total", "counter",
            "Wire bytes received per data channel (all peers).")
    for channel, s in sorted(snapshot.get("channels", {}).items()):
        labels = {**base, "channel": channel}
        lines.append(f"gloo_tpu_channel_tx_bytes_total"
                     f"{_fmt_labels(labels)} {s.get('tx_bytes', 0)}")
        lines.append(f"gloo_tpu_channel_rx_bytes_total"
                     f"{_fmt_labels(labels)} {s.get('rx_bytes', 0)}")

    _family(lines, "gloo_tpu_loop_events_total", "counter",
            "Events handled per transport loop thread.")
    _family(lines, "gloo_tpu_loop_last_progress_age_us", "gauge",
            "Microseconds since a loop thread last made progress.")
    for loop, s in sorted(snapshot.get("loops", {}).items()):
        labels = {**base, "loop": loop}
        lines.append(f"gloo_tpu_loop_events_total"
                     f"{_fmt_labels(labels)} {s.get('events', 0)}")
        lines.append(f"gloo_tpu_loop_last_progress_age_us"
                     f"{_fmt_labels(labels)} "
                     f"{s.get('last_progress_age_us', -1)}")

    _family(lines, "gloo_tpu_connect_retries_total", "counter",
            "Bootstrap connect attempts that were retried.")
    lines.append(f"gloo_tpu_connect_retries_total{_fmt_labels(base)} "
                 f"{snapshot.get('retries', 0)}")
    _family(lines, "gloo_tpu_stash_pauses_total", "counter",
            "Times the early-arrival stash paused a sender.")
    lines.append(f"gloo_tpu_stash_pauses_total{_fmt_labels(base)} "
                 f"{snapshot.get('stash_pauses', 0)}")
    _family(lines, "gloo_tpu_trace_events_dropped_total", "counter",
            "Tracer events dropped at the ring bound.")
    lines.append(f"gloo_tpu_trace_events_dropped_total{_fmt_labels(base)} "
                 f"{snapshot.get('trace_events_dropped', 0)}")
    # Persistent collective plans (docs/design.md): cache traffic plus
    # the registration counter the plans flatten — a healthy training
    # loop shows hits climbing with ubuf_creates flat.
    _family(lines, "gloo_tpu_plan_hits_total", "counter",
            "Persistent-plan cache hits.")
    lines.append(f"gloo_tpu_plan_hits_total{_fmt_labels(base)} "
                 f"{snapshot.get('plan_hits', 0)}")
    _family(lines, "gloo_tpu_plan_misses_total", "counter",
            "Persistent-plan cache misses.")
    lines.append(f"gloo_tpu_plan_misses_total{_fmt_labels(base)} "
                 f"{snapshot.get('plan_misses', 0)}")
    _family(lines, "gloo_tpu_plan_evictions_total", "counter",
            "Persistent plans evicted from the LRU.")
    lines.append(f"gloo_tpu_plan_evictions_total{_fmt_labels(base)} "
                 f"{snapshot.get('plan_evictions', 0)}")
    _family(lines, "gloo_tpu_ubuf_creates_total", "counter",
            "UnboundBuffer registrations (flat under plan reuse).")
    lines.append(f"gloo_tpu_ubuf_creates_total{_fmt_labels(base)} "
                 f"{snapshot.get('ubuf_creates', 0)}")
    # Per-action series only; the total is their sum (scrapers derive
    # it), so one metric name never carries two label schemas.
    faults = snapshot.get("faults", {})
    _family(lines, "gloo_tpu_faults_injected_total", "counter",
            "Deterministic fault injections fired, by action.")
    for action, n in sorted(faults.items()):
        if action == "total":
            continue
        lines.append(f"gloo_tpu_faults_injected_total"
                     f"{_fmt_labels({**base, 'action': action})} {n}")

    # Fleet anomaly detectors (docs/fleet.md): same counters the /fleet
    # document reports, so scrape-side alerting and the in-band view
    # can never disagree. The "rank" label is the BLAMED rank (these
    # fire on rank 0, where the aggregation runs).
    anomalies = snapshot.get("anomalies", {})
    _family(lines, "gloo_tpu_anomaly_total", "counter",
            "Fleet anomaly detections, by kind and blamed rank.")
    for kind, by_rank in sorted((anomalies.get("kinds") or {}).items()):
        for blamed, n in sorted(by_rank.items(),
                                key=lambda kv: int(kv[0])):
            labels = {**base, "kind": kind, "rank": blamed}
            lines.append(f"gloo_tpu_anomaly_total"
                         f"{_fmt_labels(labels)} {n}")
    # Async engine gauges (Context.metrics() attaches them when the
    # context has live engines; the per-op detail lives in the lane
    # contexts' own snapshots, AsyncEngine.lane_metrics).
    async_ = snapshot.get("async")
    if async_:
        _family(lines, "gloo_tpu_async_in_flight", "gauge",
                "Async-engine collectives currently in flight.")
        lines.append(f"gloo_tpu_async_in_flight{_fmt_labels(base)} "
                     f"{async_.get('in_flight', 0)}")
        _family(lines, "gloo_tpu_async_lane_submitted_total", "counter",
                "Async ops submitted per engine lane.")
        _family(lines, "gloo_tpu_async_lane_completed_total", "counter",
                "Async ops completed per engine lane.")
        _family(lines, "gloo_tpu_async_lane_errors_total", "counter",
                "Async ops errored per engine lane.")
        for ei, eng in enumerate(async_.get("engines", [])):
            for lane, st in enumerate(eng.get("per_lane", [])):
                labels = {**base, "engine": ei, "lane": lane}
                for key in ("submitted", "completed", "errors"):
                    lines.append(f"gloo_tpu_async_lane_{key}_total"
                                 f"{_fmt_labels(labels)} "
                                 f"{st.get(key, 0)}")
    # Elastic membership plane (docs/elastic.md): ElasticContext.metrics()
    # attaches the agent status under "elastic" — the epoch gauge plus
    # the liveness/transition counters operators alert on.
    elastic = snapshot.get("elastic")
    if elastic:
        _family(lines, "gloo_tpu_elastic_epoch", "gauge",
                "Membership epoch this worker is bound to.")
        lines.append(f"gloo_tpu_elastic_epoch{_fmt_labels(base)} "
                     f"{elastic.get('epoch', 0)}")
        _family(lines, "gloo_tpu_elastic_members", "gauge",
                "Members of the current epoch.")
        lines.append(f"gloo_tpu_elastic_members{_fmt_labels(base)} "
                     f"{elastic.get('size', 0)}")
        _family(lines, "gloo_tpu_elastic_leases_renewed_total", "counter",
                "Liveness lease renewals.")
        lines.append(f"gloo_tpu_elastic_leases_renewed_total"
                     f"{_fmt_labels(base)} "
                     f"{elastic.get('leases_renewed', 0)}")
        _family(lines, "gloo_tpu_elastic_rebuilds_total", "counter",
                "Epoch transitions this worker completed.")
        lines.append(f"gloo_tpu_elastic_rebuilds_total{_fmt_labels(base)} "
                     f"{elastic.get('rebuilds', 0)}")
        _family(lines, "gloo_tpu_elastic_bumps_published_total", "counter",
                "Head-epoch bumps this worker published.")
        lines.append(f"gloo_tpu_elastic_bumps_published_total"
                     f"{_fmt_labels(base)} "
                     f"{elastic.get('bumps_published', 0)}")
    wd = snapshot.get("watchdog", {})
    _family(lines, "gloo_tpu_watchdog_stalls_total", "counter",
            "Straggler-watchdog stalls recorded.")
    lines.append(f"gloo_tpu_watchdog_stalls_total{_fmt_labels(base)} "
                 f"{wd.get('stalls', 0)}")
    last = wd.get("last")
    if last:
        _family(lines, "gloo_tpu_watchdog_last_stall_waited_us", "gauge",
                "Wait time of the most recent recorded stall.")
        labels = {**base, "op": last.get("op", ""),
                  "peer": last.get("peer", -1)}
        lines.append(f"gloo_tpu_watchdog_last_stall_waited_us"
                     f"{_fmt_labels(labels)} {last.get('waited_us', 0)}")
    return "\n".join(lines) + "\n"


def _merge_hist(acc: dict, hist: dict) -> dict:
    if not acc:
        return {k: (list(map(list, v)) if k == "buckets" else v)
                for k, v in hist.items()}
    by_le = {le: n for le, n in acc.get("buckets", [])}
    for le, n in hist.get("buckets", []):
        by_le[le] = by_le.get(le, 0) + n
    acc["buckets"] = sorted([le, n] for le, n in by_le.items())
    acc["count"] = acc.get("count", 0) + hist.get("count", 0)
    acc["sum_us"] = acc.get("sum_us", 0) + hist.get("sum_us", 0)
    acc["max_us"] = max(acc.get("max_us", 0), hist.get("max_us", 0))
    return acc


def merge_snapshots(snapshots: Iterable[dict]) -> dict:
    """Sum per-rank snapshots into one job-level view: op counters and
    histograms add; transport keeps the per-(rank, peer) detail keyed as
    "rank->peer"; watchdog stalls add and the most recent stall wins."""
    merged: dict = {"ranks": [], "ops": {}, "transport": {},
                    "watchdog": {"stalls": 0, "last": None}}
    for snap in snapshots:
        merged["ranks"].append(snap.get("rank"))
        for op, s in snap.get("ops", {}).items():
            acc = merged["ops"].setdefault(
                op, {"calls": 0, "bytes": 0, "errors": 0,
                     "latency_us": {}})
            acc["calls"] += s.get("calls", 0)
            acc["bytes"] += s.get("bytes", 0)
            acc["errors"] += s.get("errors", 0)
            acc["latency_us"] = _merge_hist(acc["latency_us"],
                                            s.get("latency_us", {}))
        for peer, s in snap.get("transport", {}).items():
            merged["transport"][f"{snap.get('rank')}->{peer}"] = s
        wd = snap.get("watchdog", {})
        merged["watchdog"]["stalls"] += wd.get("stalls", 0)
        last = wd.get("last")
        prev = merged["watchdog"]["last"]
        # Recency across ranks compares age_us (relative to each rank's
        # own snapshot instant), NOT at_us: steady-clock epochs are
        # per-host boot times and never comparable across machines.
        if last and (prev is None
                     or last.get("age_us", 0) < prev.get("age_us", 0)):
            merged["watchdog"]["last"] = dict(last,
                                              rank=snap.get("rank"))
    return merged
