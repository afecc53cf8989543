"""Crash-safe artifact writes for the observability layer.

Every obs artifact (metrics registry dump, trace JSON, alert JSONL,
postmortem bundle) goes through :func:`atomic_write_text`: the bytes land
in a temporary sibling, are flushed and fsynced, and only then replace the
final path — matching ``checkpoint/io.save_pytree``'s discipline. A run
killed mid-save leaves either the previous complete artifact or the new
one on disk, never a truncated file that a CI bit-gate or a resume pass
would misread as a finished export.
"""
from __future__ import annotations

import os


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically (tmp + fsync + os.replace)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
