"""The port's pattern generators give the JAX package's patterns bit for bit.

Both packages' numpy code runs here; the cases follow ``test_patterns.py``
(structured and clash-free junctions of types 1-3, with and without
dithering, random patterns, duplicate repair) plus the block patterns that
the model configs instantiate.
"""
import numpy as np
import pytest

from repro.core import block_pattern as jbp
from repro.core import sparsity as jsp
from repro.nn.common import SparsityConfig as JaxSparsityConfig
from repro_torch.core import block_pattern as tbp
from repro_torch.core import sparsity as tsp
from repro_torch.nn.common import SparsityConfig

# (n_left, n_right, rho, method, seed, cf_type, dither, z)
PATTERN_CASES = [
    (12, 8, 0.25, "clashfree", 0, 1, False, None),
    (16, 16, 0.25, "clashfree", 3, 1, True, 8),
    (24, 6, 0.33, "clashfree", 1, 2, False, None),
    (24, 6, 0.5, "clashfree", 2, 2, True, 12),
    (8, 32, 0.25, "clashfree", 4, 3, False, 8),
    (20, 30, 0.4, "clashfree", 5, 3, True, None),
    (64, 40, 0.125, "clashfree", 7, 1, False, None),
    (12, 12, 1.0, "clashfree", 0, 1, False, None),
    (100, 50, 0.02, "structured", 0, 1, False, None),
    (30, 45, 0.6, "structured", 9, 1, False, None),
    (48, 16, 0.75, "structured", 2, 1, False, None),
    (100, 50, 0.02, "random", 3, 1, False, None),
    (10, 10, 0.5, "random", 1, 1, False, None),
]

# (n_in, n_out, rho, block_in, block_out, method, seed, cf_type, dither)
BLOCK_CASES = [
    (64, 256, 0.5, 16, 16, "clashfree", 11, 1, False),
    (256, 64, 0.75, 16, 16, "clashfree", 13, 1, False),
    (2560, 10240, 0.5, 256, 1024, "clashfree", 12, 1, False),
    (10240, 2560, 0.75, 256, 512, "clashfree", 2013, 1, False),
    (96, 160, 0.5, 16, 32, "structured", 4, 1, False),
    (128, 128, 0.5, 16, 16, "clashfree", 5, 2, True),
    (128, 64, 0.25, 16, 16, "clashfree", 6, 3, True),
]


def _pattern(pkg, case):
    n_left, n_right, rho, method, seed, cf_type, dither, z = case
    return pkg.make_pattern(n_left, n_right, rho, method, seed=seed, z=z,
                            cf_type=cf_type, dither=dither)


def _block(pkg, case):
    n_in, n_out, rho, bi, bo, method, seed, cf_type, dither = case
    return pkg.make_block_pattern(n_in, n_out, rho, block_in=bi, block_out=bo,
                                  method=method, seed=seed, cf_type=cf_type,
                                  dither=dither)


def _case_id(case):
    return "-".join(str(c) for c in case)


ALL_CASES = [("pattern", c) for c in PATTERN_CASES] \
    + [("block", c) for c in BLOCK_CASES]


@pytest.mark.parametrize("kind,case", ALL_CASES,
                         ids=[f"{k}-{_case_id(c)}" for k, c in ALL_CASES])
def test_patterns_match_reference(kind, case):
    if kind == "pattern":
        ref, got = _pattern(jsp, case), _pattern(tsp, case)
        assert got.method == ref.method
        assert got.idx.dtype == ref.idx.dtype
        np.testing.assert_array_equal(got.idx, ref.idx)
        return
    ref, got = _block(jbp, case), _block(tbp, case)
    for name in ("block_idx", "out_idx", "out_slot"):
        assert getattr(got, name).dtype == np.int32
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert (got.block_in, got.block_out) == (ref.block_in, ref.block_out)


@pytest.mark.parametrize("idx,n_left", [
    (np.array([[0, 1, 2]]), 2),             # a row wider than n_left
    (np.array([[0, 0], [0, 1]]), 4),        # left id 0 in more entries than rows
    (np.array([[0, 0], [1, 1]]), 2),        # feasible: repaired, not raised
])
def test_repair_duplicates_matches_reference(idx, n_left):
    def run(pkg):
        try:
            return pkg._repair_duplicates(idx, n_left,
                                          np.random.default_rng(0))
        except ValueError as e:
            return str(e)
    ref, got = run(jsp), run(tsp)
    if isinstance(ref, str):
        assert got == ref
    else:
        np.testing.assert_array_equal(got, ref)


# (arch, n_in, n_out, rho, expected (bL, bR, n_lb, n_rb, d_in_b) or None)
FULL_WIDTH_JUNCTIONS = [
    ("gemma3_4b up/gate", 2560, 10240, 0.5, (256, 1024, 10, 10, 5)),
    ("gemma3_4b down", 10240, 2560, 0.75, (256, 512, 40, 5, 32)),
    ("qwen2_7b up/gate", 3584, 18944, 0.5, (256, 512, 14, 37, 14)),
    ("qwen2_7b down", 18944, 3584, 0.75, (256, 512, 74, 7, 74)),
]


@pytest.mark.parametrize("name,n_in,n_out,rho,expect", FULL_WIDTH_JUNCTIONS,
                         ids=[c[0] for c in FULL_WIDTH_JUNCTIONS])
def test_fit_block_pattern_full_width(name, n_in, n_out, rho, expect):
    """The full-width junctions fit the same blocks in both packages; at
    qwen2-7b's widths the block counts are coprime, so the pattern is
    dense (d_in_b == n_lb) whatever rho asks for."""
    ref = jbp.fit_block_pattern(n_in, n_out, rho,
                                JaxSparsityConfig(enabled=True), seed=11)
    got = tbp.fit_block_pattern(n_in, n_out, rho,
                                SparsityConfig(enabled=True), seed=11)
    np.testing.assert_array_equal(got.block_idx, ref.block_idx)
    assert (got.block_in, got.block_out, got.n_lb, got.n_rb,
            got.d_in_b) == expect
