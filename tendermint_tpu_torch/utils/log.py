"""Loggers that take key=value fields, on the standard `logging` module:
the port's copy of `tendermint_tpu/utils/log.py` beside its field logger.

The JAX package's structured logger is called as
`logger.info("message", height=3, peer="ab12")`; the port's modules that
carry over such calls (the consensus state machine, the switch, the
reactors) log through this adapter, so the calls read the same. Fields
are appended to the message as `key=value` pairs; records go to the
`logging` logger of the given name, whose level and handlers the caller
configures.

TMLogger is the JAX package's leveled logger (tmlibs/log): a module name
under the "tm" root plus sticky fields, written in go-kit terminal style

    I[2026-07-30|06:10:01.123] entering new round  module=consensus height=5

by setup_logging(), which parses the reference's level spec
("state:info,p2p:error,*:debug", config/config.go:114) and sets the same
handler and levels on the port's own loggers (`tendermint_tpu_torch.*`,
where the field loggers write). bind() adds process-global fields to
every TMLogger line (the node binds its p2p id).
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Any, Dict, Optional


class FieldLogger:
    def __init__(self, name: str, **fields):
        self._logger = logging.getLogger(name)
        self.fields = fields

    def _log(self, level: int, msg: str, fields: dict) -> None:
        if not self._logger.isEnabledFor(level):
            return
        kv = {**self.fields, **fields}
        if kv:
            msg = msg + " " + " ".join(f"{k}={v}" for k, v in kv.items())
        self._logger.log(level, "%s", msg)

    def info(self, msg: str, **fields) -> None:
        self._log(logging.INFO, msg, fields)

    def error(self, msg: str, **fields) -> None:
        self._log(logging.ERROR, msg, fields)


def get_logger(name: str, **fields) -> FieldLogger:
    return FieldLogger(name, **fields)


_ROOT = "tm"
_PORT_ROOT = "tendermint_tpu_torch"
_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "error": logging.ERROR, "none": logging.CRITICAL + 10}

_setup_lock = threading.Lock()
_configured = False
_ctx_lock = threading.Lock()
_context: Dict[str, Any] = {}


def bind(**kv) -> None:
    """Bind process-global context fields onto every tm.* log line
    (lowest precedence: logger fields and per-call kv override)."""
    with _ctx_lock:
        _context.update(kv)


def unbind(*keys: str) -> None:
    with _ctx_lock:
        for k in keys:
            _context.pop(k, None)


def bound() -> Dict[str, Any]:
    with _ctx_lock:
        return dict(_context)


class KVFormatter(logging.Formatter):
    """go-kit terminal style: level char, timestamp, message, k=v pairs."""

    def format(self, record: logging.LogRecord) -> str:
        lvl = {"DEBUG": "D", "INFO": "I", "ERROR": "E"}.get(
            record.levelname, record.levelname[:1])
        ts = self.formatTime(record, "%Y-%m-%d|%H:%M:%S")
        msg = record.getMessage()
        fields: Dict[str, Any] = {"module": record.name.split(".", 1)[-1]
                                  if "." in record.name else record.name}
        fields.update(getattr(record, "kv", None) or {})
        kvs = " ".join(f"{k}={_render(v)}" for k, v in fields.items())
        out = f"{lvl}[{ts}.{int(record.msecs):03d}] {msg:<44} {kvs}"
        if record.exc_info:
            out += "\n" + self.formatException(record.exc_info)
        return out


def _render(v: Any) -> str:
    if isinstance(v, bytes):
        return v.hex()[:16]
    s = str(v)
    return f'"{s}"' if " " in s else s


class TMLogger:
    """Leveled KV logger bound to a module name + sticky fields
    (tmlibs/log.Logger.With)."""

    def __init__(self, name: str, fields: Optional[Dict[str, Any]] = None):
        self._logger = logging.getLogger(f"{_ROOT}.{name}")
        self.name = name
        self.fields = dict(fields or {})

    def with_fields(self, **kv) -> "TMLogger":
        return TMLogger(self.name, {**self.fields, **kv})

    def _log(self, level: int, msg: str, kv: Dict[str, Any]) -> None:
        if not self._logger.isEnabledFor(level):
            return
        merged = bound()          # global context first (lowest wins)
        merged.update(self.fields)
        merged.update(kv)
        self._logger.log(level, msg, extra={"kv": merged})

    def debug(self, msg: str, **kv) -> None:
        self._log(logging.DEBUG, msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._log(logging.INFO, msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._log(logging.ERROR, msg, kv)


def tm_logger(module: str, **fields) -> TMLogger:
    """The JAX package's get_logger(module, **fields)."""
    _ensure_setup()
    return TMLogger(module, fields or None)


def _ensure_setup() -> None:
    global _configured
    if _configured:
        return
    with _setup_lock:
        if _configured:
            return
        root = logging.getLogger(_ROOT)
        if not root.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(KVFormatter())
            root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True


def setup_logging(spec: str = "info", stream=None) -> None:
    """Configure levels from a reference-style spec (config/config.go:114):
    either a bare level ("info") or "module:level,...,*:level". A module
    names both tm.<module> and tendermint_tpu_torch.<module>."""
    global _configured
    h = logging.StreamHandler(stream or sys.stderr)
    h.setFormatter(KVFormatter())
    with _setup_lock:
        for name in (_ROOT, _PORT_ROOT):
            root = logging.getLogger(name)
            for old in list(root.handlers):
                root.removeHandler(old)
            root.addHandler(h)
            root.propagate = False
        _configured = True

    default = "info"
    per_module = {}
    for part in (spec or "info").split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            mod, lvl = part.rsplit(":", 1)
            if mod == "*":
                default = lvl
            else:
                per_module[mod] = lvl
        else:
            default = part
    for name in (_ROOT, _PORT_ROOT):
        logging.getLogger(name).setLevel(_LEVELS.get(default, logging.INFO))
    # reset previously-set per-module levels, then apply the new spec
    for name in list(logging.Logger.manager.loggerDict):
        if name.startswith((_ROOT + ".", _PORT_ROOT + ".")):
            logging.getLogger(name).setLevel(logging.NOTSET)
    for mod, lvl in per_module.items():
        for name in (_ROOT, _PORT_ROOT):
            logging.getLogger(f"{name}.{mod}").setLevel(
                _LEVELS.get(lvl, logging.INFO))
