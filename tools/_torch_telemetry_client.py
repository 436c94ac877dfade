"""Shared telemetry-endpoint client for the port's ``tools/`` viewers.

The counterpart of tools/_telemetry_client.py over gloo_tpu_torch.utils.
``torch_profile_view.py`` and ``torch_flightrec_view.py`` both accept live
``http://host:port`` sources next to dump files; this module is the one
place their endpoint handling lives so it cannot drift: a bounded
connect timeout (a dead rank must degrade to a warning, not hang the
viewer), the ``X-TpuColl-Token`` auth header for token-guarded
endpoints (``--token`` / ``TPUCOLL_TELEMETRY_TOKEN``), and the shared
``--fleet`` source mode that renders rank 0's merged ``/fleet``
document (docs/fleet.md) instead of the per-rank view.

Import AFTER the caller's ``sys.path`` bootstrap (the viewers insert
the repo root before their gloo_tpu_torch imports).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from gloo_tpu_torch.utils import fleet as fleet_util
from gloo_tpu_torch.utils.telemetry import fetch_route


def is_url(source: str) -> bool:
    return source.startswith("http://") or source.startswith("https://")


def add_endpoint_args(ap: argparse.ArgumentParser) -> None:
    """The endpoint flags both viewers share."""
    ap.add_argument("--timeout", type=float, default=10.0,
                    help="per-endpoint connect/read timeout in seconds "
                         "(default 10; a dead rank degrades to a "
                         "warning instead of hanging the viewer)")
    ap.add_argument("--token", default=None,
                    help="telemetry auth token sent as X-TpuColl-Token "
                         "(default: TPUCOLL_TELEMETRY_TOKEN)")
    ap.add_argument("--fleet", action="store_true",
                    help="fetch /fleet from the source(s) (rank 0's "
                         "merged fleet-observability document) and "
                         "render coverage, stragglers, slow links and "
                         "anomalies instead of the per-rank view")


def fetch(source: str, route: str, timeout: float = 10.0,
          token: Optional[str] = None):
    """Fetch ``route`` from one live endpoint; warn + return None on
    any failure (absence is evidence — the viewers treat an
    unreachable rank like a missing dump file)."""
    try:
        return fetch_route(source, route, timeout=timeout, token=token)
    except Exception as exc:  # noqa: BLE001 - CLI degrades per source
        print(f"warning: cannot fetch {source}{route}: {exc}",
              file=sys.stderr)
        return None


def run_fleet_mode(sources, timeout: float = 10.0,
                   token: Optional[str] = None) -> int:
    """The shared ``--fleet`` entry point: each source is a live
    endpoint (fetches ``/fleet``) or a saved fleet-document JSON file;
    render each. Exit 0 when every source yielded a document AND no
    document shows missing coverage or recent anomalies; 1 otherwise
    (scriptable, like flightrec_view --check)."""
    status = 0
    for src in sources:
        if is_url(src):
            doc = fetch(src, "/fleet", timeout=timeout, token=token)
        else:
            try:
                with open(src) as f:
                    doc = json.load(f)
            except Exception as exc:  # noqa: BLE001 - degrade per source
                print(f"warning: cannot load {src}: {exc}",
                      file=sys.stderr)
                doc = None
        if doc is None:
            status = 1
            continue
        if len(sources) > 1:
            print(f"== {src}")
        sys.stdout.write(fleet_util.render(doc))
        summary = fleet_util.summarize(doc)
        if (summary["coverage"]["missing"]
                or summary["recent_anomalies_by_kind"]):
            status = 1
    return status
