"""The XLA forms of the device engine's sequential stages, each against a
plain reference on fuzzed and degenerate inputs:

* the staircase match finder (ops/matchfinder_jax) vs the spec lazy
  interval walk (matchfinder.find_all_matches), degenerate runs through
  the host-walk fallback included;
* the pointer-doubling token-chain marks (block planner and splitter)
  vs a NumPy forward walk;
* the Moffat–Katajainen and Kraft-limiting scans (ops/entropy_jax) vs
  the host HuffmanEncoder."""

import jax.numpy as jnp
import numpy as np
import pytest

from zultra_tpu.huffman import HuffmanEncoder
from zultra_tpu.matchfinder import find_all_matches
from zultra_tpu.ops.matchfinder_jax import _core_kernel, match_table_jax


def _lz_data(rng, n, alpha, p_match=0.3):
    out = []
    while len(out) < n:
        if rng.random() < p_match and len(out) > 10:
            off = int(rng.integers(1, min(len(out), 2000)))
            ln = int(rng.integers(3, 60))
            s = len(out) - off
            for i in range(ln):
                out.append(out[s + i])
        else:
            out.append(int(rng.integers(0, alpha)))
    return np.array(out[:n], np.uint8)


# -- staircase match finder -------------------------------------------------


@pytest.mark.parametrize("seed,alpha,start", [(0, 256, 0), (1, 40, 0),
                                              (2, 256, 512), (3, 8, 100)])
def test_staircase_equals_spec_walk(seed, alpha, start):
    rng = np.random.default_rng(seed)
    data = _lz_data(rng, 3000, alpha)
    end = len(data)
    ref = find_all_matches(data.copy(), start, end)
    got = match_table_jax(data, start, end)
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("kind", ["zeros", "period3"])
def test_staircase_degenerate_runs(kind):
    """Long single-byte and short-period runs overflow the staircase's
    membership budget; the segment falls back to the host walk and the
    table still equals the spec walk."""
    if kind == "zeros":
        data = np.zeros(3000, np.uint8)
    else:
        data = np.tile(np.array([7, 7, 9], np.uint8), 1000)[:2500]
    n = len(data)
    assert np.array_equal(find_all_matches(data.copy(), 0, n), match_table_jax(data, 0, n))


def test_staircase_flags_overflow_on_zeros():
    n, halo, core = 4096, 1024, 2048
    buf = np.zeros(n, np.int32)
    _, _, ovf = _core_kernel(jnp.asarray(buf), n, 16, halo, core)
    assert bool(ovf)


@pytest.mark.parametrize("seed", [7, 8])
def test_staircase_segment_layout(seed):
    """The uniform [halo | core | tail] sentinel layout: core rows equal
    the spec walk over the same buffer region (halo rows suppressed)."""
    rng = np.random.default_rng(seed)
    data = _lz_data(rng, 4096, 64)
    n, halo, core = 4096, 1024, 2048
    buf = 256 + np.arange(n, dtype=np.int32)
    buf[: halo + core + 258] = data[: halo + core + 258]
    lens, offs, ovf = _core_kernel(jnp.asarray(buf), n, 16, halo, core)
    ref = find_all_matches(data[: halo + core + 258].copy(), halo, halo + core + 258)
    ref_core = ref[halo : halo + core]
    assert not bool(ovf)
    assert np.array_equal(np.asarray(lens, np.int32), ref_core[:, :, 0])
    assert np.array_equal(np.asarray(offs, np.int32), ref_core[:, :, 1])


# -- token-chain marks ------------------------------------------------------


def _forward_walk(step, start, length):
    marks = np.zeros(step.shape, bool)
    for b in range(step.shape[0]):
        i = int(start[b])
        while i < int(length[b]):
            marks[b, i] = True
            i += int(step[b, i])
    return marks


def _random_steps(rng, lanes, n, density):
    lens = np.where(rng.random((lanes, n)) < density, rng.integers(3, 259, (lanes, n)), 0)
    return np.where(lens >= 3, lens, 1).astype(np.int32)


@pytest.mark.parametrize("seed,density", [(5, 0.4), (6, 0.05), (7, 0.95)])
def test_chain_mask_equals_forward_walk(seed, density):
    from zultra_tpu.ops.block_jax import _chain_mask

    rng = np.random.default_rng(seed)
    n = 2048
    step = _random_steps(rng, 3, n, density)
    length = np.array([n, n - 300, 1], np.int32)
    got = np.asarray(_chain_mask(jnp.asarray(step), jnp.asarray(length), n))
    assert np.array_equal(got, _forward_walk(step, np.zeros(3, np.int32), length))


def test_chain_mask_all_literals_and_empty():
    from zultra_tpu.ops.block_jax import _chain_mask

    n = 512
    step = np.ones((2, n), np.int32)
    length = np.array([n, 0], np.int32)
    got = np.asarray(_chain_mask(jnp.asarray(step), jnp.asarray(length), n))
    assert got[0].all()
    assert not got[1].any()


def test_chain_mask_many_lanes():
    from zultra_tpu.ops.block_jax import _chain_mask

    rng = np.random.default_rng(17)
    n, lanes = 512, 150
    step = _random_steps(rng, lanes, n, 0.3)
    length = rng.integers(0, n + 1, lanes).astype(np.int32)
    got = np.asarray(_chain_mask(jnp.asarray(step), jnp.asarray(length), n))
    assert np.array_equal(got, _forward_walk(step, np.zeros(lanes, np.int32), length))


@pytest.mark.parametrize("prev", [0, 37, 1000])
def test_splitter_token_chain_equals_forward_walk(prev):
    """The splitter's window-global greedy chain starts at ``prev`` (the
    first input byte) and stops at the window's real end."""
    from zultra_tpu.ops.split_jax import _token_structure

    rng = np.random.default_rng(prev)
    n, n_real = 4096, 3900
    row_len = np.where(rng.random(n) < 0.3, rng.integers(3, 259, n), 0).astype(np.int32)
    row_off = np.ones(n, np.int32)
    window = rng.integers(0, 256, n, dtype=np.uint8)
    *_, is_tok = _token_structure(
        jnp.asarray(window), jnp.asarray(row_len), jnp.asarray(row_off),
        jnp.int32(prev), jnp.int32(n_real), n,
    )
    step = np.where(row_len >= 3, row_len, 1)[None]
    ref = _forward_walk(step, np.array([prev]), np.array([n_real]))[0]
    assert np.array_equal(np.asarray(is_tok), ref)


# -- Moffat–Katajainen + Kraft scans ----------------------------------------


def _host_lengths(hist, max_len):
    S = hist.shape[0]
    enc = HuffmanEncoder(S, max_len, 0)
    enc.entropy = [int(x) for x in hist]
    enc.build_dynamic_codewords()
    return np.array(enc.code_length[:S])


def _check_build_lengths(hist, max_len):
    from zultra_tpu.ops.entropy_jax import build_lengths

    got = np.asarray(build_lengths(jnp.asarray(hist), max_len))
    for h, row in zip(hist, got):
        assert np.array_equal(_host_lengths(h, max_len), row), h.tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_mk_scans_offsets_alphabet(seed):
    """Offset alphabet, limit 7: empty, one-symbol, two-symbol and skewed
    lanes beside random ones."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 200, (16, 32)).astype(np.int32)
    hist[1] = 0
    hist[2] = 0
    hist[2, 7] = 5
    hist[3] = 0
    hist[3, 0] = 1
    hist[3, 31] = 1000
    hist[4, :] = rng.integers(0, 2, 32)
    _check_build_lengths(hist, 7)


def test_mk_scans_literal_alphabet():
    rng = np.random.default_rng(2)
    hist = rng.integers(0, 1000, (3, 288)).astype(np.int32)
    hist[1, 50:] = 0
    hist[2] = (rng.random(288) < 0.1) * rng.integers(1, 1 << 20, 288)
    _check_build_lengths(hist, 15)


def test_mk_scans_many_lanes():
    rng = np.random.default_rng(9)
    hist = rng.integers(0, 500, (300, 32)).astype(np.int32)
    hist[rng.random((300, 32)) < 0.4] = 0
    _check_build_lengths(hist, 7)


@pytest.mark.parametrize("S,max_len", [(19, 7), (288, 15)])
def test_mk_scans_deep_trees(S, max_len):
    """Exponential weights make unlimited MK depths exceed the limit, so
    the Kraft repair scans run on every lane."""
    rng = np.random.default_rng(S)
    hist = (2 ** rng.integers(0, 24, (6, S))).astype(np.int32)
    hist[:, : S // 3] = 0
    _check_build_lengths(hist, max_len)
