"""Published peaks of the cards the benchmark knows, from ``peaks.json``."""

import functools
import json
import os
from typing import Optional


@functools.lru_cache(maxsize=1)
def _table() -> dict:
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f)


def peak(kind: str) -> Optional[dict]:
    return _table().get(kind)
