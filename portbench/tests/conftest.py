"""The benchmark's CPU tests: run with
``python -m pytest portbench/tests`` from the checkout's root."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
