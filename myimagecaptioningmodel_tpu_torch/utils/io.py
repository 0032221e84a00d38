"""Small file utilities (reference tools/util.py:9-17 parity); a copy of
``myimagecaptioningmodel_tpu/utils/io.py``."""

from __future__ import annotations


def read_file(path: str, mode: str = "r") -> str:
    with open(path, mode=mode, encoding="utf-8") as f:
        return f.read()


def write_file(path: str, content: str, mode: str = "w") -> None:
    with open(path, mode=mode, encoding="utf-8") as f:
        f.write(content)
