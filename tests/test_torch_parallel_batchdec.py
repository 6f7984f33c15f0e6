"""PyTorch port, parallel/ (batch decode): BatchDecoder on CPU meshes,
every array gpujpeg_tpu.Decoder().decode's, the dense-stream repair
included.  Streams written by the JAX package; frames of at most
64 x 80."""

import numpy as np
import pytest

from gpujpeg_tpu_torch.models.decoder import CapacityError
from gpujpeg_tpu_torch.parallel import batch as tbatch, mesh as tmesh

from .test_encode import smooth_image
from .test_torch_parallel_decode import _jax_decode, _jax_stream


def test_batch_decoder_matches_jax():
    """Eight same-geometry streams over 'data' 8: each array is the JAX
    Decoder's."""
    rng = np.random.default_rng(23)
    streams = [_jax_stream(smooth_image(rng, 64, 80, 3), rst=4)
               for _ in range(8)]
    bd = tbatch.BatchDecoder(tmesh.make_mesh(8, data=8, seg=1, device="cpu"),
                             streams[0], batch_size=8)
    out = bd.decode_batch(streams)
    assert out.shape == (8, 64, 80, 3)
    for i, s in enumerate(streams):
        assert np.array_equal(out[i], _jax_decode(s)), i
    with pytest.raises(ValueError, match="expected 8"):
        bd.decode_batch(streams[:4])
    with pytest.raises(ValueError, match="not divisible"):
        tbatch.BatchDecoder(tmesh.make_mesh(8, data=8, seg=1, device="cpu"),
                            streams[0], batch_size=4)


def test_batch_decoder_dense_stream_repair():
    """A stream denser than the example (noise at the same tables, Q95,
    whose segments pass the example's row width) is refused by
    pack_stream and decoded by its device's Decoder.decode; the batch's
    arrays are the JAX Decoder's."""
    rng = np.random.default_rng(24)
    example = _jax_stream(smooth_image(rng, 32, 48, 3), quality=95, rst=2)
    dense = _jax_stream(rng.integers(0, 256, (32, 48, 3), np.uint8),
                        quality=95, rst=2)
    bd = tbatch.BatchDecoder(tmesh.make_mesh(2, data=2, seg=1, device="cpu"),
                             example, batch_size=2)
    with pytest.raises(CapacityError):
        bd.dec.pack_stream(dense, bd.geo, bd.max_words, bd.comp_widths,
                           bd.table_sig)
    out = bd.decode_batch([example, dense])
    assert np.array_equal(out[0], _jax_decode(example))
    assert np.array_equal(out[1], _jax_decode(dense))
