"""The benchmark's CPU tests: tiny runs of each cell and the harness's
arithmetic. A test that needs the card carries the `cuda` marker and
decides inside the test whether a card is there."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
