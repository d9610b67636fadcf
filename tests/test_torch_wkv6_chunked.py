"""The chunked WKV-6 algorithm of ``kernels/csrc/wkv6.cu``, mirrored in
plain torch (``kernels/ref.py::wkv6_chunked_ref``), against the JAX
package on the CPU.

The mirror follows the kernel's chunking, its decay products and its
masking of the ragged last chunk, so a fault of the algorithm shows here
before the kernel runs on a card.  Inputs come from numpy seeds; both
sides get the same float32 values.  Tolerances are the reference's own
(``tests/test_kernels.py``: 1e-5 with f32 inputs, 3e-2 with bf16) up to
T = 64, and 1e-4 of max|o| beyond, where sums run 500 steps long.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import wkv6_ref as jax_wkv6_ref
from repro.kernels.wkv6 import wkv6_pallas
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.kernels.ref import wkv6_chunked_ref, wkv6_ref

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_LONG = 1e-4
CHUNKS = (4, wkv6_mod.CHUNK)
REF_SHAPES = [(1, 16, 1, 8, 8), (2, 32, 3, 8, 16), (2, 64, 2, 16, 64),
              (3, 48, 5, 4, 16)]


def _inputs(B, T, H, n, seed, strong=False):
    """The reference's kernel-test distributions, or strong decays:
    w = exp(-exp(x)), x ~ 2·N(0, 1) + 1, with some entries exactly 0.0
    and exactly 1.0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, n)) * 0.5 for _ in range(3))
    if strong:
        w = np.exp(-np.exp(2.0 * rng.standard_normal((B, T, H, n)) + 1.0))
        pick = rng.random((B, T, H, n))
        w[pick < 0.05] = 0.0
        w[pick > 0.95] = 1.0
    else:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, n))))
    u = rng.standard_normal((H, n)) * 0.5
    s0 = rng.standard_normal((B, H, n, n)) * 0.1
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u, s0))


def _round(a, dtype):
    """``a`` rounded to ``dtype`` and back: the values both sides see."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _check(got, want, T, tol):
    for g, x in zip(got, want):
        g, x = g.numpy(), np.asarray(x)
        assert np.isfinite(g).all()
        if T <= 64:
            np.testing.assert_allclose(g, x, atol=tol, rtol=tol)
        else:
            assert np.abs(g - x).max() <= TOL_LONG * np.abs(x).max()


def _run(arrays, chunk, tb=None):
    """(mirror, JAX oracle, Pallas interpret or None) on ``arrays``."""
    mirror = wkv6_chunked_ref(*(torch.from_numpy(a) for a in arrays),
                              chunk=chunk)
    jx = [jnp.asarray(a) for a in arrays]
    pallas = (None if tb is None
              else wkv6_pallas(*jx, tb=tb, interpret=True))
    return mirror, jax_wkv6_ref(*jx), pallas


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,n,tb", REF_SHAPES)
def test_mirror_matches_jax_at_reference_shapes(B, T, H, n, tb, dtype,
                                                chunk):
    arrays = _inputs(B, T, H, n, seed=B * T + H)
    arrays = tuple(_round(a, dtype) for a in arrays[:4]) + arrays[4:]
    mirror, want, pallas = _run(arrays, chunk, tb)
    _check(mirror, want, T, TOL[dtype])
    _check(mirror, pallas, T, TOL[dtype])


# T at the chunk's edges (C - 1, C, C + 1), one step, and ragged lengths.
T_CASES = {"1": lambda c: 1, "C-1": lambda c: c - 1, "C": lambda c: c,
           "C+1": lambda c: c + 1, "37": lambda c: 37, "513": lambda c: 513}


def _tb(T):
    """The largest time block of at most 64 that divides T."""
    return max(d for d in range(1, min(T, 64) + 1) if T % d == 0)


@pytest.mark.parametrize("strong", [False, True], ids=["sigmoid", "strong"])
@pytest.mark.parametrize("t_case", sorted(T_CASES))
@pytest.mark.parametrize("chunk", CHUNKS)
def test_mirror_ragged_T_at_head_size_64(chunk, t_case, strong):
    T = T_CASES[t_case](chunk)
    arrays = _inputs(2, T, 2, 64, seed=T + 7 * chunk, strong=strong)
    mirror, want, pallas = _run(arrays, chunk, _tb(T))
    _check(mirror, want, T, TOL["float32"])
    _check(mirror, pallas, T, TOL["float32"])


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("B,T,H,n,tb", REF_SHAPES)
def test_mirror_strong_decays_at_reference_shapes(B, T, H, n, tb, chunk):
    arrays = _inputs(B, T, H, n, seed=3 * T + n, strong=True)
    assert (arrays[3] == 0.0).any() and (arrays[3] == 1.0).any()
    mirror, want, pallas = _run(arrays, chunk, tb)
    _check(mirror, want, T, TOL["float32"])
    _check(mirror, pallas, T, TOL["float32"])


def test_mirror_matches_plain_step_loop_on_a_long_sequence():
    arrays = [torch.from_numpy(a)
              for a in _inputs(1, 300, 3, 32, seed=11, strong=True)]
    got = wkv6_chunked_ref(*arrays)
    want = wkv6_ref(*arrays)
    for g, x in zip(got, want):
        assert float((g - x).abs().max()) <= TOL_LONG * float(x.abs().max())


def test_mirror_chunk_is_the_kernels():
    src = os.path.join(os.path.dirname(wkv6_mod.__file__), "csrc", "wkv6.cu")
    with open(src) as f:
        text = f.read()
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", text).group(1))
    levels = int(re.search(r"constexpr int kLevels = (\d+);", text).group(1))
    assert chunk == wkv6_mod.CHUNK == 1 << levels


@pytest.mark.parametrize("chunk", [0, 3, 12])
def test_mirror_rejects_chunk_not_a_power_of_two(chunk):
    arrays = [torch.from_numpy(a) for a in _inputs(1, 4, 1, 8, seed=0)]
    with pytest.raises(ValueError, match="power of two"):
        wkv6_chunked_ref(*arrays, chunk=chunk)


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    arrays = [torch.from_numpy(a) for a in _inputs(1, 9, 2, 8, seed=1)]
    before = wkv6_mod.wkv6.launches
    want = wkv6_ref(*arrays)
    for g, x in zip(wkv6_mod.wkv6(*arrays), want):
        assert torch.equal(g, x)
    assert wkv6_mod.wkv6.launches == before
