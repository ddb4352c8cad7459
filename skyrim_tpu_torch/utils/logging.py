"""loguru-like logger over stdlib logging (copy of skyrim_tpu/utils/logging.py).

Level semantics: debug=internals, info=progress, success=milestones,
warning/error.  ``SKYRIM_LOG_LEVEL`` sets the level.
"""

from __future__ import annotations

import logging
import os
import sys

SUCCESS = 25  # between INFO (20) and WARNING (30), mirroring loguru
logging.addLevelName(SUCCESS, "SUCCESS")


class _Logger:
    def __init__(self, name: str = "skyrim_tpu_torch"):
        self._logger = logging.getLogger(name)
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                logging.Formatter(
                    "%(asctime)s | %(levelname)-8s | %(name)s: %(message)s",
                    "%H:%M:%S",
                )
            )
            self._logger.addHandler(handler)
            self._logger.setLevel(os.environ.get("SKYRIM_LOG_LEVEL", "INFO"))
            self._logger.propagate = False

    def debug(self, msg, *a):
        self._logger.debug(msg, *a)

    def info(self, msg, *a):
        self._logger.info(msg, *a)

    def success(self, msg, *a):
        self._logger.log(SUCCESS, msg, *a)

    def warning(self, msg, *a):
        self._logger.warning(msg, *a)


logger = _Logger()
