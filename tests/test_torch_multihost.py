"""PyTorch port, multi-process execution (parallel.dist): the routing unit
tests of tests/test_multihost.py with injected process maps, on CPU
meshes of the port, and REAL 2-process runs (torch.distributed over
Gloo, a CPU mesh of 2 places a process) of BatchEncoder.
encode_batch_local and BatchDecoder.decode_batch_local: every stream
must be byte for byte gpujpeg_tpu.Encoder().encode's and every array
gpujpeg_tpu.Decoder().decode's.  The workers import the port alone."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import gpujpeg_tpu as gj
from gpujpeg_tpu.types import ColorSpace, ImageParameters, PixelFormat

from gpujpeg_tpu_torch.parallel import dist
from gpujpeg_tpu_torch.parallel.batch import BatchEncoder
from gpujpeg_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds a worker may take; past it every worker is killed
WORKER_TIMEOUT = 120


def _cpu_mesh(n, data, seg):
    return make_mesh(n, data=data, seg=seg, device="cpu")


# -- routing math (unit, injected process maps) ---------------------------

def test_data_rows_of_process_injected():
    mesh = _cpu_mesh(8, 4, 2)
    # fake 2 processes: places 0-3 -> p0, 4-7 -> p1 (process-major)
    devs = list(np.asarray(mesh.devices).reshape(-1))
    proc = {d: (0 if i < 4 else 1) for i, d in enumerate(devs)}
    rows0 = dist.data_rows_of_process(mesh, 0, proc_of=proc.get)
    rows1 = dist.data_rows_of_process(mesh, 1, proc_of=proc.get)
    assert rows0 == [0, 1] and rows1 == [2, 3]


def test_data_rows_rejects_split_row():
    mesh = _cpu_mesh(8, 2, 4)
    devs = list(np.asarray(mesh.devices).reshape(-1))
    # a 'seg' row torn across processes must be rejected
    proc = {d: (i % 2) for i, d in enumerate(devs)}
    with pytest.raises(ValueError, match="spans processes"):
        dist.data_rows_of_process(mesh, 0, proc_of=proc.get)


def test_local_frame_indices_injected():
    mesh = _cpu_mesh(8, 4, 2)
    devs = list(np.asarray(mesh.devices).reshape(-1))
    proc = {d: (0 if i < 4 else 1) for i, d in enumerate(devs)}
    assert dist.local_frame_indices(mesh, 8, 0, proc.get) == [0, 1, 2, 3]
    assert dist.local_frame_indices(mesh, 8, 1, proc.get) == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="not divisible"):
        dist.local_frame_indices(mesh, 6, 0, proc.get)


def test_make_global_mesh_single_process():
    mesh = dist.make_global_mesh(seg=2, n_local=8, device="cpu")
    assert mesh.shape == {"data": 4, "seg": 2}
    assert {d.process_index for d in mesh.devices.reshape(-1)} == {0}
    with pytest.raises(ValueError, match="divide"):
        dist.make_global_mesh(seg=3, n_local=8, device="cpu")


def test_global_batch_and_outputs_injected():
    """make_global_batch keeps this process's frames by global index;
    local_rows and local_batch reassemble blocks keyed by their index
    slices, as over a JAX array's addressable shards."""
    mesh = _cpu_mesh(8, 4, 2)
    devs = list(np.asarray(mesh.devices).reshape(-1))
    proc = {d: (0 if i < 4 else 1) for i, d in enumerate(devs)}
    frames = [np.full((2, 2), b) for b in (4, 5, 6, 7)]
    got = dist.make_global_batch(mesh, ("data", "seg"), frames, 8, 1,
                                 proc.get)
    assert list(got) == [4, 5, 6, 7] and got[6][0, 0] == 6
    whole = dist.make_global_batch(mesh, (), list(range(8)), 8)
    assert whole == {b: b for b in range(8)}
    with pytest.raises(ValueError, match="feeds 4"):
        dist.make_global_batch(mesh, ("data",), frames[:3], 8, 1, proc.get)
    # (B, n_seg, 3) output: frames 4-5 / 6-7 of rows 2 / 3, one seg block
    # each place
    blocks = [dist.Shard((slice(b0, b0 + 2), slice(s, s + 1)),
                         np.full((2, 1, 3), 10 * b0 + s))
              for b0 in (4, 6) for s in (0, 1)]
    rows = dist.local_rows(blocks, mesh, 8)
    assert sorted(rows) == [4, 5, 6, 7]
    assert rows[5].shape == (2, 3) and rows[5][1, 0] == 41
    imgs = dist.local_batch([dist.Shard((slice(4, 6),),
                                        np.arange(4).reshape(2, 2))], 8)
    assert sorted(imgs) == [4, 5] and list(imgs[5]) == [2, 3]
    assert list(dist.allgather_max(np.array([3, 1]))) == [3, 1]


def test_initialize_without_env_is_a_noop(monkeypatch):
    for k in ("GPUJPEG_TPU_COORDINATOR", "GPUJPEG_TPU_NUM_PROCESSES",
              "GPUJPEG_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    dist.initialize()
    assert dist.process_count() == 1 and dist.process_index() == 0


def test_single_process_degradation():
    """encode_batch_local == encode_batch on one process."""
    from gpujpeg_tpu_torch import Parameters
    from gpujpeg_tpu_torch.types import (ColorSpace as TCS,
                                         ImageParameters as TIP,
                                         PixelFormat as TPF)

    pi = TIP(width=48, height=64, color_space=TCS.RGB,
             pixel_format=TPF.P444_U8_P012)
    be = BatchEncoder(_cpu_mesh(4, 4, 1),
                      Parameters(quality=85, restart_interval=2), pi)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (4, 64, 48, 3), np.uint8)
    streams, idx = be.encode_batch_local(list(frames))
    assert idx == [0, 1, 2, 3]
    assert streams == be.encode_batch(frames)


# -- real 2-process runs --------------------------------------------------

_WORKER = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1]); nproc = int(sys.argv[2])
    port = sys.argv[3]; outdir = sys.argv[4]; seg = int(sys.argv[5])
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from gpujpeg_tpu_torch import Encoder, Parameters
    from gpujpeg_tpu_torch.parallel import dist
    from gpujpeg_tpu_torch.parallel.batch import BatchDecoder, BatchEncoder
    from gpujpeg_tpu_torch.types import (ColorSpace, ImageParameters,
                                         PixelFormat)
    dist.initialize(f"127.0.0.1:{{port}}", nproc, pid)
    assert dist.process_count() == nproc and dist.process_index() == pid

    def frame(i):
        rng = np.random.default_rng(100 + i)
        return rng.integers(0, 256, (48, 64, 3), np.uint8)

    pi = ImageParameters(width=64, height=48, color_space=ColorSpace.RGB,
                         pixel_format=PixelFormat.P444_U8_P012)
    param = Parameters(quality=85, restart_interval=2)

    mesh = dist.make_global_mesh(seg=seg, n_local=2, device="cpu")
    B = mesh.shape["data"]
    idx = dist.local_frame_indices(mesh, B)
    be = BatchEncoder(mesh, param, pi)
    streams, got = be.encode_batch_local([frame(i) for i in idx])
    assert got == idx, (got, idx)
    for b, s in zip(got, streams):
        with open(os.path.join(outdir, f"enc_{{b:03d}}.jpg"), "wb") as f:
            f.write(s)

    # decode the same frames' streams back through the multi-process
    # path (seg=1 mesh: decode has no segment axis)
    if seg == 1:
        enc = Encoder(device="cpu")
        ex = enc.encode(frame(0), param, pi)
        bd = BatchDecoder(mesh, ex, B)
        imgs, got_d = bd.decode_batch_local(
            [enc.encode(frame(i), param, pi) for i in idx])
        assert got_d == idx
        for b, img in zip(got_d, imgs):
            np.save(os.path.join(outdir, f"dec_{{b:03d}}.npy"), img)
    need = dist.allgather_max(np.array([pid, 7 - pid]))
    assert list(need) == [nproc - 1, 7], need
    print("WORKER_OK", pid, flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_procs(tmp_path, seg: int):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO))
    outdir = tmp_path / "out"
    outdir.mkdir()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", str(port), str(outdir),
         str(seg)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"WORKER_OK {i}" in out
    return outdir


def _frame(b):
    rng = np.random.default_rng(100 + b)
    return rng.integers(0, 256, (48, 64, 3), np.uint8)


@pytest.mark.parametrize("seg,frames", [(1, 4), (2, 2)],
                         ids=["data4_seg1", "data2_seg2"])
def test_two_process_matches_jax(tmp_path, seg, frames):
    """2 real processes x 2 CPU places: data 4 x seg 1 (encode, then
    decode of the same streams) and data 2 x seg 2 (encode, one frame
    striped over each process's two places); every stream is the JAX
    Encoder's and every array the JAX Decoder's."""
    outdir = _run_two_procs(tmp_path, seg)
    pi = ImageParameters(width=64, height=48, color_space=ColorSpace.RGB,
                         pixel_format=PixelFormat.P444_U8_P012)
    param = gj.Parameters(quality=85, restart_interval=2)
    enc, dec = gj.Encoder(), gj.Decoder()
    for b in range(frames):
        p = outdir / f"enc_{b:03d}.jpg"
        assert p.exists(), f"frame {b} missing"
        want = bytes(enc.encode(_frame(b), param, pi))
        assert p.read_bytes() == want, f"frame {b} differs"
        if seg == 1:
            got = np.load(outdir / f"dec_{b:03d}.npy")
            assert np.array_equal(got, np.asarray(dec.decode(want))), b
    assert len(list(outdir.glob("enc_*.jpg"))) == frames
