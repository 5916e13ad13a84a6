"""Logging and metrics: a Python logger with a file handler, the JSONL
metrics writer and optional wandb (counterpart of
``uspace_tpu/utils/logging_utils.py``, on the standard ``logging`` module
in place of absl).

A ``metrics.jsonl`` record is ``{"step", "time", ...}`` with every value
coerced to float where it can be, the JAX package's format, so one reader
serves both packages.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

LOGGER_NAME = "uspace_tpu_torch"
logger = logging.getLogger(LOGGER_NAME)
_FILE_HANDLERS: Dict[str, logging.Handler] = {}


def set_logger(level: str = "info", log_file: Optional[str] = None) -> None:
    """The package logger at ``level``, echoed to stderr and, with
    ``log_file``, appended to it. Calling it again for the same file adds
    no second handler."""
    logger.setLevel(getattr(logging, level.upper()))
    if not any(getattr(h, "_uspace_console", False) for h in logger.handlers):
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        console._uspace_console = True
        logger.addHandler(console)
    if log_file is not None:
        path = os.path.abspath(log_file)
        if path not in _FILE_HANDLERS:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            handler = logging.FileHandler(path)
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
            logger.addHandler(handler)
            _FILE_HANDLERS[path] = handler


def close_log_file(log_file: str) -> None:
    """Detach and close the handler ``set_logger`` opened for ``log_file``."""
    handler = _FILE_HANDLERS.pop(os.path.abspath(log_file), None)
    if handler is not None:
        logger.removeHandler(handler)
        handler.close()


def dct2str(dct: Dict[str, Any]) -> str:
    """Compact scalar formatting (reference utils_uvit.py:23-24)."""

    def fmt(v):
        try:
            return f"{float(v):.6g}"
        except (TypeError, ValueError):
            return str(v)

    return " ".join(f"{k}={fmt(v)}" for k, v in dct.items())


class MetricsWriter:
    """Append-only JSONL metrics (the wandb-independent record); also
    forwards to wandb when asked for and installed, and to any registered
    callback sinks (each ``fn(step, record)``)."""

    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None, sinks=()):
        self.path = path
        self.sinks = list(sinks)
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except ImportError:
                logger.warning("wandb not installed; JSONL metrics only")

    def add_sink(self, fn) -> None:
        self.sinks.append(fn)

    def write(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        for fn in self.sinks:
            fn(step, rec)


def cnt_params(params) -> int:
    """Total parameter count of a module or of a dict of tensors
    (reference utils_uvit.cnt_params)."""
    tensors = (params.parameters() if hasattr(params, "parameters")
               else params.values())
    return sum(t.numel() for t in tensors)
