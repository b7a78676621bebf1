"""Dashboard UI: a single static page over the JSON API.

The reference served Jinja templates with Tailwind + Chart.js from
Flask; this is the
equivalent surface as one dependency-free page: jobs table with
per-stage progress and actions, add-job form, nodes panel, metrics,
activity feed, and a settings editor — all polling the same JSON
routes the tests drive (api/server.py).
"""

from __future__ import annotations

import os

_DIR = os.path.dirname(__file__)


def index_html() -> bytes:
    with open(os.path.join(_DIR, "index.html"), "rb") as fp:
        return fp.read()
