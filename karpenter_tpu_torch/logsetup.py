"""Logger naming for the controllers: every module logs through
``get_logger("<area>")`` under the package root.

The port's copy of karpenter_tpu/logsetup.py, cut to the logger names. Its
root is the port's own, so its loggers never share a tree with the JAX
package's. The handler setup and live re-levelling come with the port's
Runtime (ROADMAP A9).
"""

from __future__ import annotations

import logging

ROOT = "karpenter_tpu_torch"


def get_logger(name: str = ROOT) -> logging.Logger:
    """Logger under the package tree; accepts short area names."""
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
