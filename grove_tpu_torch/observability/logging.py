"""Structured logging (internal/logger/ analog: leveled, text or json)."""

from __future__ import annotations

import json
import sys
from typing import Any, TextIO

_LEVELS = {"debug": 10, "info": 20, "error": 40}


class Logger:
    """Tiny zap-flavored structured logger driven by api.config.LogConfig."""

    def __init__(self, level: str = "info", format: str = "text",
                 name: str = "grove", stream: TextIO | None = None):
        self.level = _LEVELS.get(level, 20)
        self.format = format
        self.name = name
        self.stream = stream if stream is not None else sys.stderr

    def with_name(self, name: str) -> "Logger":
        child = Logger.__new__(Logger)
        child.level, child.format, child.stream = (
            self.level, self.format, self.stream
        )
        child.name = f"{self.name}.{name}"
        return child

    def _log(self, level: str, msg: str, kv: dict[str, Any]) -> None:
        if _LEVELS[level] < self.level:
            return
        if self.format == "json":
            rec = {"level": level, "logger": self.name, "msg": msg, **kv}
            print(json.dumps(rec, default=str), file=self.stream)
        else:
            pairs = " ".join(f"{k}={v}" for k, v in kv.items())
            print(f"{level.upper():5s} {self.name}: {msg}"
                  + (f" {pairs}" if pairs else ""), file=self.stream)

    def debug(self, msg: str, **kv: Any) -> None:
        self._log("debug", msg, kv)

    def info(self, msg: str, **kv: Any) -> None:
        self._log("info", msg, kv)

    def error(self, msg: str, **kv: Any) -> None:
        self._log("error", msg, kv)
