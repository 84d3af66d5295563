import os
import sys

# keep smoke tests on ONE device — the 512-device override belongs ONLY
# to the dry-run (see launch/dryrun.py); distributed engine tests spawn
# subprocesses with their own XLA_FLAGS.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest

try:                                    # property tests are optional: the
    from hypothesis import settings     # suite must collect even without
                                        # the hypothesis wheel
    settings.register_profile("fast", max_examples=25, deadline=None)
    settings.load_profile("fast")
    HAVE_HYPOTHESIS = True
except ImportError:                     # not installed: skip the
    HAVE_HYPOTHESIS = False             # property-test files
    collect_ignore = ["test_compress.py", "test_keys.py",
                      "test_radix.py", "test_spline.py"]


@pytest.fixture(scope="session")
def small_spatial():
    from repro.data import spatial as ds
    x, y = ds.make("gaussian", 12000, seed=7)
    return x, y


@pytest.fixture(scope="session")
def built_index(small_spatial):
    from repro.core import build_index, fit
    x, y = small_spatial
    part = fit("kdtree", x, y, 12, seed=0)
    return x, y, part, build_index(x, y, part)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")


def range_oracle(x, y, rects):
    return np.array([np.sum((x >= r[0]) & (x <= r[2]) &
                            (y >= r[1]) & (y <= r[3])) for r in rects])


def knn_oracle(x, y, qx, qy, k):
    d2 = (x[None, :] - qx[:, None]) ** 2 + (y[None, :] - qy[:, None]) ** 2
    return np.sort(d2, axis=1)[:, :k]


def pip_oracle(px, py, poly, n):
    inside = np.zeros(len(px), bool)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        c = (((yi > py) != (yj > py)) &
             (px < (xj - xi) * (py - yi) / (yj - yi + 1e-30) + xi))
        inside ^= c
        j = i
    return inside
