"""PyTorch port, restart intervals longer than a scan's MCU count
(ROADMAP Q13): streams of 8x8 RGB at interval 2, 7x13 at 3, 1x16
interleaved 4:2:0 at 5 and 2x30 planar 4:1:1 at 5
(scan_rows.RESTART_LONG), where every segment holds fewer blocks than the
interval.  The port's encoder writes the JAX encoder's bytes; its
decoder clips each segment's block count (models/decoder._make_plan) and
decodes them, where the JAX decoder raises ValueError.  So the oracle is
the JAX decode of the same frame encoded at interval 1: pixels and
quantized coefficients, which do not depend on the interval, tolerance
0.  The card holds the same streams against the port's CPU decode
(tests/test_torch_kernels.py, chip_smoke.py's [foreign] step)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import gpujpeg_tpu as gj
from gpujpeg_tpu import native as jnative

import gpujpeg_tpu_torch as gt

from tests import scan_rows
from tests import torch_threads  # noqa: F401

CASES = list(scan_rows.RESTART_LONG)


def _each(fn):
    """{case: fn(case)}, a thread a case.  Each case is a JAX program of
    its own geometry (an encode about 10 s cold, a decode about 5 s,
    mostly inside XLA, which releases the GIL), and in turn they take
    the file past a minute alone; each thread makes its own JAX
    sessions."""
    jnative.lib()         # its loader builds the library unlocked: load once
    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(zip(CASES, pool.map(fn, CASES)))


@pytest.fixture(scope="module")
def streams():
    """name -> (the JAX encoder's stream at the case's interval, the
    stream of the same frame at interval 1), the cases in threads
    (_each).  The interval-1 stream is the port's CPU encode:
    its bytes are the JAX encoder's (as test_bytes_equal_jax holds them
    at the long interval), and a JAX encode compiles for seconds a
    geometry."""
    def one(name):
        frame, p = scan_rows.restart_long(gj, name)
        return (bytes(gj.Encoder().encode(frame, p)),
                gt.Encoder(device="cpu").encode(
                    frame, scan_rows.restart_long(gt, name, rst=1)[1]))

    return _each(one)


@pytest.fixture(scope="module")
def jax_rst1(streams):
    """name -> (pixels, coefficients) of the interval-1 stream by the JAX
    decoder, the cases in threads."""
    def one(name):
        dec, data = gj.Decoder(), streams[name][1]
        return (np.asarray(dec.decode(data)),
                [np.asarray(c) for c in dec.decode_coefficients(data)])

    return _each(one)


@pytest.mark.parametrize("name", CASES)
def test_bytes_equal_jax(streams, name):
    """The port's CPU encode at the long interval writes the JAX bytes."""
    frame, p = scan_rows.restart_long(gt, name)
    assert gt.Encoder(device="cpu").encode(frame, p) == streams[name][0]


@pytest.mark.parametrize("name", CASES)
def test_segments_are_shorter_than_the_interval(streams, name):
    """The plan's block count of every segment is below the interval's
    (interval x blocks an MCU), and the interval-1 stream's plan has the
    same layout of blocks (one MCU a segment)."""
    rst = scan_rows.RESTART_LONG[name][1]
    dec = gt.Decoder(device="cpu")
    plan = dec.prepare(streams[name][0]).plan
    bpm = plan.pattern[0] if plan.geo.interleaved else 1
    assert plan.geo.param.restart_interval == rst
    assert (plan.nblocks < rst * bpm).all()
    assert int(plan.nblocks.sum()) == int(
        dec.prepare(streams[name][1]).plan.nblocks.sum())


@pytest.mark.parametrize("name", CASES)
def test_pixels_equal_jax_restart1(streams, jax_rst1, name):
    dec = gt.Decoder(device="cpu")
    got = dec.decode(streams[name][0])
    want = jax_rst1[name][0]
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(dec.decode_to_device(streams[name][0]).numpy(),
                          want)


@pytest.mark.parametrize("name", CASES)
def test_coefficients_equal_jax_restart1(streams, jax_rst1, name):
    got = gt.Decoder(device="cpu").decode_coefficients(streams[name][0])
    want = jax_rst1[name][1]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.int16 and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_jax_decoder_raises(streams, name):
    """The difference the port keeps on purpose: the JAX decoder raises
    ValueError on the long-interval stream its encoder wrote (PIL decodes
    it, as the port does)."""
    with pytest.raises(ValueError):
        gj.Decoder().decode(streams[name][0])
