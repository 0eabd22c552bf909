"""Loggers that take key=value fields, on the standard `logging` module.

The JAX package's structured logger is called as
`logger.info("message", height=3, peer="ab12")`; the port's modules that
carry over such calls (the consensus state machine, the switch, the
reactors) log through this adapter, so the calls read the same. Fields
are appended to the message as `key=value` pairs; records go to the
`logging` logger of the given name, whose level and handlers the caller
configures.
"""

from __future__ import annotations

import logging


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
