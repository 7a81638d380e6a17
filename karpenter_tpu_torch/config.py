"""Live-tunable global configuration (pkg/config).

The reference watches a `karpenter-global-settings` ConfigMap for batch
window tuning with change-handler fan-out; here the Config object is directly
mutable with the same change-notification contract.

The port's copy of karpenter_tpu/config.py, whole.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

DEFAULT_BATCH_MAX_DURATION = 10.0
DEFAULT_BATCH_IDLE_DURATION = 1.0
DEFAULT_LOG_LEVEL = "info"


class Config:
    def __init__(
        self,
        batch_max_duration: float = DEFAULT_BATCH_MAX_DURATION,
        batch_idle_duration: float = DEFAULT_BATCH_IDLE_DURATION,
        log_level: str = DEFAULT_LOG_LEVEL,
    ):
        self._lock = threading.Lock()
        self._batch_max_duration = batch_max_duration
        self._batch_idle_duration = batch_idle_duration
        self._log_level = log_level
        self._handlers: List[Callable[["Config"], None]] = []

    @property
    def batch_max_duration(self) -> float:
        with self._lock:
            return self._batch_max_duration

    @property
    def batch_idle_duration(self) -> float:
        with self._lock:
            return self._batch_idle_duration

    @property
    def log_level(self) -> str:
        with self._lock:
            return self._log_level

    def on_change(self, handler: Callable[["Config"], None]) -> None:
        with self._lock:
            self._handlers.append(handler)

    def update(self, batch_max_duration=None, batch_idle_duration=None, log_level=None) -> None:
        changed = False
        with self._lock:
            if batch_max_duration is not None and batch_max_duration != self._batch_max_duration:
                self._batch_max_duration = batch_max_duration
                changed = True
            if batch_idle_duration is not None and batch_idle_duration != self._batch_idle_duration:
                self._batch_idle_duration = batch_idle_duration
                changed = True
            if log_level is not None and log_level != self._log_level:
                self._log_level = log_level
                changed = True
            handlers = list(self._handlers)
        if changed:
            for handler in handlers:
                handler(self)


# -- live ConfigMap watch (pkg/config/config.go:84-170) ----------------------

CONFIGMAP_NAME = "karpenter-global-settings"
CONFIGMAP_NAMESPACE = "karpenter"  # default system namespace (config.go:85-88)


def system_namespace() -> str:
    """The namespace the settings ConfigMap lives in — $SYSTEM_NAMESPACE,
    injected by the generated Deployment via the downward API, exactly the
    reference's informer wiring (suite_test.go: os.Getenv("SYSTEM_NAMESPACE"))."""
    import os

    return os.environ.get("SYSTEM_NAMESPACE") or CONFIGMAP_NAMESPACE

DEFAULT_CONFIGMAP_DATA = {
    "batchMaxDuration": "10s",
    "batchIdleDuration": "1s",
    "logLevel": DEFAULT_LOG_LEVEL,
}

_DURATION_SUFFIXES = (("ms", 0.001), ("s", 1.0), ("m", 60.0), ("h", 3600.0))


def parse_duration(value: str) -> float:
    """Go-style duration strings ('10s', '500ms', '1.5m') or bare seconds."""
    text = str(value).strip()
    for suffix, scale in _DURATION_SUFFIXES:
        if text.endswith(suffix) and text[: -len(suffix)].replace(".", "", 1).lstrip("-").isdigit():
            return float(text[: -len(suffix)]) * scale
    return float(text)


def watch_config(kube, config: Config, name: str = CONFIGMAP_NAME, namespace: Optional[str] = None):
    """Subscribe the Config to the settings ConfigMap.

    Mirrors the reference watcher (config.go:84-170): a content hash
    suppresses redundant change notifications (hashCM), and a malformed or
    invariant-violating value keeps the previous setting rather than taking
    the controller down. Missing keys fall back to the Config's values at
    watch time — i.e. CLI flags/env stay authoritative until the ConfigMap
    explicitly sets a key (three-tier config: flags < live ConfigMap);
    deleting the ConfigMap restores them.

    Returns an unsubscribe callable: a stopped/crashed Runtime must detach
    its watcher or the dead Config keeps re-leveling logs on every update.
    """
    from .logsetup import get_logger

    log = get_logger("config")
    if namespace is None:
        namespace = system_namespace()
    # the launch-time configuration is the fallback for unset/removed keys
    base = {
        "batchMaxDuration": f"{config.batch_max_duration}s",
        "batchIdleDuration": f"{config.batch_idle_duration}s",
        "logLevel": config.log_level,
    }
    state = {"hash": None}

    def on_event(event) -> None:
        cm = event.obj
        # both name AND namespace must match: a same-named ConfigMap in an
        # unrelated namespace must not drive (or reset) controller settings
        if cm.metadata.name != name or cm.metadata.namespace != namespace:
            return
        if getattr(event, "type", None) == "DELETED":
            data = dict(base)
        else:
            data = {**base, **(cm.data or {})}
        content = tuple(sorted(data.items()))
        digest = hash(content)
        if digest == state["hash"]:
            return
        if state["hash"] is not None:
            log.info("configuration change detected in %s", name)
        state["hash"] = digest
        updates = {}
        for key, field_name in (("batchMaxDuration", "batch_max_duration"), ("batchIdleDuration", "batch_idle_duration")):
            try:
                seconds = parse_duration(data[key])
            except ValueError:
                log.warning("invalid %s %r; keeping previous", key, data[key])
                continue
            if seconds <= 0:
                log.warning("invalid %s %r: must be positive; keeping previous", key, data[key])
                continue
            updates[field_name] = seconds
        # the same invariant Options.validate enforces at boot: idle <= max
        idle = updates.get("batch_idle_duration", config.batch_idle_duration)
        max_ = updates.get("batch_max_duration", config.batch_max_duration)
        if idle > max_:
            log.warning("batchIdleDuration %.3fs > batchMaxDuration %.3fs; keeping previous durations", idle, max_)
            updates.pop("batch_idle_duration", None)
            updates.pop("batch_max_duration", None)
        from .logsetup import is_valid_level

        level = str(data["logLevel"])
        if is_valid_level(level):
            updates["log_level"] = level
        else:
            log.warning("invalid logLevel %r; keeping previous", level)
        config.update(**updates)

    kube.watch("ConfigMap", on_event)
    return lambda: kube.unwatch("ConfigMap", on_event)
