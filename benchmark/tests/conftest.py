"""CPU tests of the benchmark (run from the repository's root:
``python -m pytest benchmark/tests``).  Tests that need a CUDA card carry
the ``cuda`` marker and skip inside the test where there is none."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


# A Canu-style job for the generator's ``canu`` task, which no cell of the
# manifest runs yet: MHAP's default flags with a filter file, -p of each
# block in set-up, then -s block0.dat -q <dir of the other blocks>.
CANU_CONFIG = {"name": "canu-test", "task": "canu",
               "flags": {"-k": 16, "--num-hashes": 512,
                         "--num-min-matches": 3, "--threshold": 0.78,
                         "--ordered-kmer-size": 12,
                         "--ordered-sketch-size": 1536, "--max-shift": 0.2,
                         "--min-olap-length": 116, "--supress-noise": 2,
                         "--repeat-weight": 0.9, "--repeat-idf-scale": 10}}
CANU_TRAFFIC = {"reads": 8192,
                "length": {"median": 1400, "sigma": 0.45, "min": 500,
                           "max": 9000},
                "coverage": 25.0, "error": 0.11,
                "repeat": {"length": 2000, "share": 0.24},
                "filter": {"k": 16, "top": 40000, "cutoff": 0.0},
                "blocks": 2, "check": {"queries": 24}}


@pytest.fixture
def canu():
    """(configuration, traffic) of the Canu-style job."""
    return CANU_CONFIG, CANU_TRAFFIC
