"""Run logger + persisted run state (reference tools/logger.py:8-88); a copy
of ``myimagecaptioningmodel_tpu/training/logger.py`` (stdlib only).

The reference's crash-resume protocol lives here: a JSON file
``<log_path>/config`` holding ``{epoch, best_bleu, best_meteor,
train_encoder}``, rewritten on every mutation — restarting mid-training picks
up from ``logger.epoch`` (SURVEY §5.3). We keep that contract (the checkpoint
additionally embeds the same state for self-containedness) but drop the
singleton: a Logger is an instance bound to a log_path.

Output: stdout + append-only ``log.txt`` (same as the reference) plus a
structured ``log.jsonl`` for machine consumption (SURVEY §5.5 rebuild note).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class Logger:
    def __init__(
        self, log_path: str, encoder_trainable: bool = True, write: bool = True
    ) -> None:
        """``write=False`` (non-main processes in a multi-host run) keeps the
        full in-memory run state but never touches the filesystem — exactly
        one process owns ``<log_path>/config``, ``log.txt`` and
        ``log.jsonl``."""
        self.path = log_path
        self.write = write
        if write:
            os.makedirs(log_path, exist_ok=True)
        self._conf_path = os.path.join(log_path, "config")
        if not os.path.exists(self._conf_path):
            self._conf: Dict[str, Any] = {
                "epoch": 1,
                "best_bleu": 0,
                "best_meteor": 0,
                "train_encoder": encoder_trainable,
            }
            self._save_conf()
        else:
            with open(self._conf_path, "r", encoding="utf-8") as f:
                self._conf = json.load(f)
        self.is_first_init = self.epoch == 1

    def _save_conf(self) -> None:
        if not self.write:
            return
        with open(self._conf_path, "w", encoding="utf-8") as f:
            f.write(json.dumps(self._conf))

    # ---- persisted run state -------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._conf["epoch"]

    @epoch.setter
    def epoch(self, val: int) -> None:
        self._conf["epoch"] = val
        self._save_conf()

    @property
    def best_bleu(self) -> float:
        return self._conf["best_bleu"]

    @best_bleu.setter
    def best_bleu(self, val: float) -> None:
        self._conf["best_bleu"] = val
        self._save_conf()

    @property
    def best_meteor(self) -> float:
        return self._conf["best_meteor"]

    @best_meteor.setter
    def best_meteor(self, val: float) -> None:
        self._conf["best_meteor"] = val
        self._save_conf()

    @property
    def train_encoder(self) -> bool:
        return self._conf.get("train_encoder", False)

    @train_encoder.setter
    def train_encoder(self, val: bool) -> None:
        self._conf["train_encoder"] = val
        self._save_conf()

    # ---- log output ------------------------------------------------------------

    def log(self, content: str, end: str = "\n") -> None:
        print(content, end=end)
        if not self.write:
            return
        with open(os.path.join(self.path, "log.txt"), "a", encoding="utf-8") as f:
            f.write(content + end)

    def log_scalars(self, event: str, **scalars: Any) -> None:
        """Structured jsonl record (epoch loss, dev BLEU, timings, ...)."""
        if not self.write:
            return
        rec = {"time": time.time(), "event": event, **scalars}
        with open(os.path.join(self.path, "log.jsonl"), "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
