"""Path and record helpers (port of the JAX package's utils/misc.py)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


def ensure_dir(path: str) -> str:
    """mkdir -p and return the path."""
    os.makedirs(path, exist_ok=True)
    return path


def append_jsonl(path: str, record: Dict[str, Any]) -> None:
    """Append one JSON line to `path`, creating its directory."""
    ensure_dir(os.path.dirname(path) or ".")
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
