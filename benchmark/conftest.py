"""Test settings for everything under benchmark/: ``tests/tiny.py`` cuts
each kind of traffic by its own table, which has no entry yet for the DiT
kind (``traffic/generate_dit.py``); this gives it one before any test
copies the benchmark."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.tests import tiny  # noqa: E402

tiny.PARAMS.setdefault("generate_dit", dict(batch=3, frames=16, lengths=[4, 16], tokens=[4, 9],
                                            pool=2, check_among=3, check_requests=2,
                                            check_motions=2, trace_units=2))
