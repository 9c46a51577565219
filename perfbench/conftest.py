"""The benchmark's tests import the port from ``src`` and the benchmark as
the ``perfbench`` package, as ``run.py`` does."""
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
for _p in (str(_REPO / "src"), str(_REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
