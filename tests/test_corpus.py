"""The seeded corpora (zultra_tpu.corpus) that the chip smoke run and the
benchmark compress: deterministic, exactly sized, laid out as documented,
and compressed identically by the device and host engines."""

import zlib

import numpy as np
import pytest

import zultra_tpu as zt
from zultra_tpu import corpus


@pytest.mark.parametrize("make", [corpus.text_like, corpus.binary_like, corpus.mixed])
def test_corpus_is_seeded_and_sized(make):
    size = corpus.PIECE + 12345  # crosses a piece boundary
    a = make(size, 3)
    assert len(a) == size
    assert a == make(size, 3)
    assert a != make(size, 4)


def test_text_like_is_text():
    data = corpus.text_like(1 << 16, 0)
    allowed = set(b"abcdefghijklmnopqrstuvwxyz ,.;\n")
    assert set(data) <= allowed
    ratio = len(zlib.compress(data, 9)) / len(data)
    assert 0.2 < ratio < 0.5


def test_mixed_interleaves_binary_and_text():
    step = corpus.MIX_STEP
    data = corpus.mixed(16 * step + 100, 5)
    binary = corpus.binary_like(15 * 2 * step, 5)
    text = corpus.text_like(2 * step, 5)
    assert data[: 15 * step] == binary[: 15 * step]
    assert data[15 * step : 16 * step] == text[:step]
    assert data[16 * step :] == binary[15 * step : 15 * step + 100]


def test_dp_lanes_layout():
    ll, ol, window, mlens, moffs, lengths = corpus.dp_lanes(2, 3, 512, 0.5)
    assert ll.shape == (3, 288) and ol.shape == (3, 32) and window.shape == (3, 512)
    assert mlens.shape == moffs.shape == (3, 512, 8)
    assert (np.diff(mlens, axis=2) <= 0).all()  # lengths descend per row
    assert ((mlens == 0) | ((mlens >= 3) & (mlens <= 258))).all()
    assert ((moffs >= 1) & (moffs <= 32768)).all()
    assert lengths.tolist() == [170, 512, 512]


@pytest.mark.parametrize("make", [corpus.text_like, corpus.mixed])
def test_jaxdev_equals_native_on_corpus(make):
    from zultra_tpu.device_pipeline import compress_device

    data = make(70000, 9)
    zt.set_engine("native")
    try:
        ref = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    finally:
        zt.engine._active_engine = None
    got = compress_device(data, zt.FLAG_GZIP_FRAMING, 32768)
    assert got == ref
    assert zlib.decompress(got, 31) == data
