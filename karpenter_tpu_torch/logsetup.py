"""Structured logging for the controller runtime.

Equivalent of the reference's zap-via-knative setup with live level reload
from the config-logging ConfigMap (pkg/controllers/controllers.go:240-248):

- every module logs through ``get_logger("karpenter_tpu_torch.<area>")``;
- :func:`configure` installs one stream handler with a structured
  single-line format on the package root logger;
- :func:`set_level` re-levels the whole tree at runtime — wired to the
  live Config (config.py) by the Runtime so operators can turn on debug
  logging without a restart, mirroring the ConfigMap watch.

Nothing here touches the global root logger: embedding applications keep
their own logging topology, and tests can assert on records with the
standard ``caplog`` machinery.

The port's copy of karpenter_tpu/logsetup.py. Its root is the port's own,
so its loggers and handler never share a tree with the JAX package's.
"""

from __future__ import annotations

import logging
import sys
import threading

ROOT = "karpenter_tpu_torch"

LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def is_valid_level(name: str) -> bool:
    return str(name).lower() in LEVELS

_lock = threading.Lock()
_configured = False


class _Formatter(logging.Formatter):
    """level ts logger message — single line, machine-splittable."""

    default_msec_format = "%s.%03d"

    def format(self, record: logging.LogRecord) -> str:
        record.shortname = record.name[len(ROOT) + 1 :] if record.name.startswith(ROOT + ".") else record.name
        return super().format(record)


def get_logger(name: str = ROOT) -> logging.Logger:
    """Logger under the package tree; accepts short area names."""
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


def configure(level: str = "info", stream=None) -> logging.Logger:
    """Install the package handler (idempotent) and set the level."""
    global _configured
    root = logging.getLogger(ROOT)
    with _lock:
        if not _configured:
            handler = logging.StreamHandler(stream or sys.stderr)
            handler.setFormatter(
                _Formatter("%(levelname).1s%(asctime)s %(shortname)s: %(message)s", datefmt="%H:%M:%S")
            )
            root.addHandler(handler)
            root.propagate = False
            _configured = True
    set_level(level)
    return root


def set_level(level: str) -> None:
    """Re-level the whole package tree (live reload seam).

    Unknown names fall back to info — a bad ConfigMap value must never
    take logging down.
    """
    logging.getLogger(ROOT).setLevel(LEVELS.get(str(level).lower(), logging.INFO))


def current_level() -> str:
    lv = logging.getLogger(ROOT).getEffectiveLevel()
    for name, value in LEVELS.items():
        if value == lv:
            return name
    return str(lv)


def reset_for_tests() -> None:
    """Remove the handler (and restore propagation, so pytest's caplog sees
    records again) so repeated configure() calls in tests start clean."""
    global _configured
    root = logging.getLogger(ROOT)
    with _lock:
        for h in list(root.handlers):
            root.removeHandler(h)
        root.propagate = True
        _configured = False
