"""Natural ("human") sorting for dataset file lists.

A copy of ``tpuir/utils/natsort.py``: digit runs compare numerically,
everything else lexically, case-folded (``file2 < file10``).
"""

from __future__ import annotations

import re
from typing import Iterable, List

_DIGIT_RE = re.compile(r"(\d+)")


def natural_key(s: str):
    """Sort key that orders embedded integers numerically (file2 < file10)."""
    parts = _DIGIT_RE.split(str(s))
    key = []
    for i, p in enumerate(parts):
        if i % 2:  # digit run
            key.append((1, int(p), ""))
        elif p:
            key.append((0, 0, p.lower()))
    return key


def natsorted(items: Iterable[str]) -> List[str]:
    return sorted(items, key=natural_key)
