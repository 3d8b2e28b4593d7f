"""The CUDA cost-DP kernel's wrapper (ops/dp_cuda): operand packing,
unpacking, shape checks and the library build command, on the CPU; and
the kernel itself against the XLA scan on the GPU (``gpu`` marker).

CUDA has no interpret mode, so the kernel's arithmetic is checked here
through ``_kernel_model``: a NumPy transcription of cost_dp.cu's loop
over the packed operands, compared with the scan DP that the planner
runs off the GPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zultra_tpu import corpus
from zultra_tpu.constants import NMATCHES_PER_OFFSET
from zultra_tpu.ops import dp_cuda
from zultra_tpu.ops.block_jax import run_dp_scan

RING = 512
CLAMP = (1 << 26) - 1
INF = 1 << 26
BIG = 0xFFFFFFFF


def _kernel_model(lit, slots, varlen):
    """One lane of cost_dp.cu, position by position: returns the packed
    output (n,) of len | slot << 9."""
    n = lit.shape[0]
    ring = np.zeros(RING, np.int64)
    out = np.zeros(n, np.int64)
    ks = np.arange(3, 40)
    vk = varlen[:37].astype(np.int64)
    c1 = 0
    for p in range(n - 1, -1, -1):
        x = np.minimum(vk + ring[(p + ks) & (RING - 1)], CLAMP)
        packs = x * 64 + (63 - ks)
        best = (int(lit[p]) + c1) << 4
        blen = 0
        for m in range(NMATCHES_PER_OFFSET):
            w = int(slots[p, m])
            kind, ln, cst = w >> 16, w & 511, (w >> 9) & 127
            cand, l = INF, ln
            if kind == 1:
                eligible = packs[ks <= ln]
                wmin = int(eligible.min()) if eligible.size else BIG
                if ln >= 3:
                    cand, l = (wmin >> 6) + cst, 63 - (wmin & 63)
            elif kind == 2:
                cand = cst + (0 if ln < 40 else int(ring[(p + ln) & (RING - 1)]))
            key = cand * 16 + m + 1
            if key < best:
                best, blen = key, l
        cost, mcode = best >> 4, best & 15
        ring[p & (RING - 1)] = cost
        out[p] = (blen if mcode else 0) | (mcode << 9)
        c1 = cost
    return out.astype(np.int32)


def _lanes(seed, lanes, n_pad, density):
    return [jnp.asarray(a) for a in corpus.dp_lanes(seed, lanes, n_pad, density)]


@pytest.mark.parametrize("density", [0.05, 0.5, 0.95])
def test_kernel_model_matches_scan(density):
    """The kernel's packed formulation makes the scan's choices, block
    end inside lane 0 included."""
    n_pad = 4096
    args = _lanes(11, 2, n_pad, density)
    ref_len, ref_off = run_dp_scan(*args, n_pad)
    lit, slots, varlen = dp_cuda.pack_lanes(*args, n_pad)
    packed = np.stack([
        _kernel_model(np.asarray(lit[b]), np.asarray(slots[b]), np.asarray(varlen[b]))
        for b in range(lit.shape[0])
    ])
    got_len, got_off = dp_cuda.unpack_choices(jnp.asarray(packed), args[4])
    assert np.array_equal(np.asarray(got_len), np.asarray(ref_len))
    assert np.array_equal(np.asarray(got_off), np.asarray(ref_off))


def test_kernel_model_on_planner_block():
    """A real block's match table (a repeated source text, so long and
    short matches and a block end all occur) through the planner's
    first-pass code lengths."""
    from zultra_tpu import native

    src = (native.build.SRC / "zultra_native.cpp").read_bytes()[:6000]
    data = np.frombuffer(src * 2, np.uint8)[:4096]
    table = native.build_match_table(np.ascontiguousarray(data), 0).astype(np.int32)
    n_pad = 4096
    ll = np.full((1, 288), 8, np.int32)
    ol = np.full((1, 32), 5, np.int32)
    args = [jnp.asarray(ll), jnp.asarray(ol), jnp.asarray(data[None]),
            jnp.asarray(table[None, :, :, 0]), jnp.asarray(table[None, :, :, 1]),
            jnp.asarray([4000], jnp.int32)]
    ref_len, ref_off = run_dp_scan(*args, n_pad)
    lit, slots, varlen = dp_cuda.pack_lanes(*args, n_pad)
    packed = _kernel_model(np.asarray(lit[0]), np.asarray(slots[0]), np.asarray(varlen[0]))
    got_len, got_off = dp_cuda.unpack_choices(jnp.asarray(packed[None]), args[4])
    assert (np.asarray(ref_len) >= 40).any() and (np.asarray(ref_len)[0] > 0).sum() > 100
    assert np.array_equal(np.asarray(got_len), np.asarray(ref_len))
    assert np.array_equal(np.asarray(got_off), np.asarray(ref_off))


def test_pack_lane_fields():
    """Each slot word carries the clamped length, the right cost and the
    short/long kind; literal costs vanish past the block end."""
    n_pad = 512
    args = _lanes(3, 1, n_pad, 0.6)
    lit, slots, varlen = dp_cuda.pack_lanes(*args, n_pad)
    lit, slots, varlen = (np.asarray(x[0]) for x in (lit, slots, varlen))
    mlens = np.asarray(args[3][0])
    length = int(args[5][0])
    assert lit.shape == (n_pad,) and slots.shape == (n_pad, 8) and varlen.shape == (40,)
    assert (lit[length:] == 0).all() and (lit[:length] > 0).all()
    kind = slots >> 16
    ln = slots & 511
    cost = (slots >> 9) & 127
    assert ((kind == 2) == (mlens >= 40)).all()
    assert ((kind == 1) == ((mlens >= 3) & (mlens < 40))).all()
    remaining = np.maximum(length - np.arange(n_pad), 0)[:, None]
    assert (ln[kind > 0] == np.minimum(mlens, remaining)[kind > 0]).all()
    assert (cost[kind > 0] > 0).all() and (slots[kind == 0] == 0).all()
    assert (varlen[37:] == 1 << 26).all()


def test_unpack_selects_slot_offsets():
    moffs = jnp.asarray(np.arange(1, 1 + 2 * 3 * 8, dtype=np.int32).reshape(2, 3, 8))
    packed = jnp.asarray(np.array([[0, 7 | (1 << 9), 258 | (8 << 9)],
                                   [5 | (3 << 9), 0, 40 | (2 << 9)]], np.int32))
    best_len, best_off = dp_cuda.unpack_choices(packed, moffs)
    assert np.asarray(best_len).tolist() == [[0, 7, 258], [5, 0, 40]]
    m = np.asarray(moffs)
    assert np.asarray(best_off).tolist() == [[0, m[0, 1, 0], m[0, 2, 7]],
                                             [m[1, 0, 2], 0, m[1, 2, 1]]]


@pytest.mark.parametrize("n_pad", [0, 100, (1 << 21) + 32])
def test_pack_lanes_rejects_bad_widths(n_pad):
    args = _lanes(0, 1, 64, 0.5)
    with pytest.raises(ValueError):
        dp_cuda.pack_lanes(*args, n_pad)


def test_pack_lanes_batches_lanes_independently():
    """Lanes pack independently: a batch equals its lanes packed alone."""
    n_pad = 256
    args = _lanes(5, 3, n_pad, 0.5)
    batch = dp_cuda.pack_lanes(*args, n_pad)
    for b in range(3):
        alone = dp_cuda.pack_lanes(*[a[b : b + 1] for a in args], n_pad)
        for x, y in zip(batch, alone):
            assert np.array_equal(np.asarray(x[b : b + 1]), np.asarray(y))


def test_build_command_targets_hopper(tmp_path, monkeypatch):
    monkeypatch.setattr(dp_cuda, "_nvcc", lambda: "nvcc")
    cmd = dp_cuda._build_command(tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert str(dp_cuda.SOURCE) in cmd and jax.ffi.include_dir() in cmd
    assert dp_cuda.library_path().parent == dp_cuda.BUILD_DIR
    assert dp_cuda.library_path().name.startswith("libzultra_cost_dp-")


@pytest.mark.gpu
@pytest.mark.parametrize("n_pad", [4096, 1 << 16])
def test_cuda_kernel_matches_scan(gpu, n_pad):
    """On the card: the kernel against the scan, 16 lanes."""
    args = _lanes(n_pad, 16, n_pad, 0.5)
    ref = jax.jit(run_dp_scan, static_argnames="n_pad")(*args, n_pad=n_pad)
    got = jax.jit(dp_cuda.run_dp_cuda, static_argnames="n_pad")(*args, n_pad=n_pad)
    for a, b in zip(got, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b))
