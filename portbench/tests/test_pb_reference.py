"""The plain reference against a direct numpy.convolve, and the
comparison."""

import numpy as np
import pytest

from portbench import check
from portbench.inputs import Pool
from portbench.reference import Reference


def test_segment_equals_direct_convolution():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((3, 37)).astype(np.float32)
    x = rng.standard_normal((3, 200)).astype(np.float32)
    ref = Reference(h)
    for start, n in ((0, 50), (13, 1), (120, 80)):
        hist = np.zeros((3, 36 + n), dtype=np.float32)
        lo = start - 36
        src = x[:, max(lo, 0):start + n]
        hist[:, hist.shape[1] - src.shape[1]:] = src
        got = ref.segment(hist)
        for c in range(3):
            full = np.convolve(x[c].astype(np.float64), h[c].astype(
                np.float64))
            np.testing.assert_allclose(got[c], full[start:start + n],
                                       rtol=0, atol=1e-12)


def test_rel_err_and_verdict():
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 16)).astype(np.float32)
    pool = Pool(rng.standard_normal((3, 2, 64)).astype(np.float32))
    ref = Reference(h)
    start, n = 100, 50
    want = ref.segment(pool.frames(start - 15, start + n))
    seg = check.Segment(pool, start, want.astype(np.float32))
    err = check.rel_err([seg], h)
    assert 0 < err < 1e-6  # float32 rounding of the output alone
    bad = want.copy()
    bad[1, 3] += 1.0
    assert check.rel_err([check.Segment(pool, start, bad)], h) > 1e-2
    ok, table = check.verdict({"rel_err": err, "failed": 0},
                              {"rel_err": 1e-5, "failed": 0})
    assert ok and table["rel_err"] == {"value": err, "limit": 1e-5}
    assert not check.verdict({"rel_err": float("nan"), "failed": 0},
                             {"rel_err": 1e-5, "failed": 0})[0]
    assert not check.verdict({"rel_err": err, "failed": 1},
                             {"rel_err": 1e-5, "failed": 0})[0]


def test_reference_refuses_a_short_history():
    with pytest.raises(ValueError):
        Reference(np.ones((2, 8), np.float32)).segment(
            np.ones((2, 7), np.float32))
