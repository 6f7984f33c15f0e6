"""PyTorch port, the command-line tool (gpujpeg_tpu_torch.cli and the
tpujpegtool_torch launcher) against the JAX package's (gpujpeg_tpu.cli):
both run in-process on the same inputs, the port with -D cpu, and every
output file must be byte for byte the JAX tool's: -e (a PPM, a PGM and a
.tst input), -d (to PPM and Y4M), -C, -S 4:2:0 -i, -a, -N with
-O enc_*, -O dec_*, and -B 8 over a 16-frame Y4M.  The text that -I and -R
print is the JAX tool's too.  One case runs the launcher in a subprocess
and checks that neither JAX nor the JAX package was imported.  CPU,
64x48 frames."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpujpeg_tpu import cli as jcli
from gpujpeg_tpu.io import image as jimg, pnm as jpnm, y4m as jy4m
from gpujpeg_tpu.types import ColorSpace, ImageParameters, PixelFormat

import gpujpeg_tpu_torch as gt
from gpujpeg_tpu_torch import cli as tcli
from tests import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FRAMES = 48, 64, 16


def _gradient(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([(xx * 255 // w), (yy * 255 // h),
                  ((xx + yy) * 255 // (w + h))], -1)
    return np.clip(f + rng.integers(-12, 13, f.shape), 0, 255) \
        .astype(np.uint8)


def _inputs(d):
    """The input files, written with the JAX package's writers."""
    rgb = _gradient(H, W, 1)
    with open(d / "in.ppm", "wb") as f:
        f.write(jpnm.save_pnm(ImageParameters(width=W, height=H), rgb))
    with open(d / "in.pgm", "wb") as f:
        f.write(jpnm.save_pnm(ImageParameters(width=W, height=H),
                              rgb[..., 1]))
    rgba = np.concatenate([rgb, _gradient(H, W, 2)[..., :1]], axis=2)
    with open(d / "in.pam", "wb") as f:
        f.write(jpnm.save_pnm(ImageParameters(width=W, height=H), rgba))
    pi = ImageParameters(width=W, height=H,
                         color_space=ColorSpace.YCBCR_BT601,
                         pixel_format=PixelFormat.P420_U8_P0P1P2)
    base = np.random.default_rng(11).integers(64, 192, W * H * 3 // 2) \
        .astype(np.uint8)
    with open(d / "seq.y4m", "wb") as f:
        f.write(jy4m.save_y4m_frames(pi, [(base + i) % 255
                                          for i in range(FRAMES)]))


#: each group: (switches, [(input, output)]); an input "@x" is the JAX
#: tool's output x of an earlier group, so both tools decode one stream
GROUPS = {
    "encode": (["-e", "-q", "85", "-R"], [("in.ppm", "e.jpg"),
                                          ("in.pgm", "g.jpg"),
                                          ("64x48.random_5.tst", "t.jpg")]),
    "subsampled": (["-e", "-S", "4:2:0", "-i"], [("in.ppm", "s.jpg")]),
    "alpha": (["-e", "-a"], [("in.pam", "a.jpg")]),
    "enc_options": (["-e", "-N", "-O", "enc_hdr=Exif", "-O",
                     "enc_opt_flipped=true"], [("in.ppm", "o.jpg")]),
    "decode": (["-d"], [("@e.jpg", "d.ppm"), ("@s.jpg", "d.y4m")]),
    "dec_options": (["-d", "-O", "dec_opt_flipped=true", "-O",
                     "dec_opt_channel_remap=210"], [("@e.jpg", "f.ppm")]),
    "convert": (["-C"], [("in.ppm", "c.yuv"), ("seq.y4m", "c.rgb"),
                         ("in.ppm", "c.i420")]),
    "batch": (["-e", "-B", "8", "-c", "ycbcr-bt709", "-q", "85"],
              [("seq.y4m", "f_%03d.jpg")]),
    "info": (["-I", "@e.jpg"], []),
}


def _outputs(name):
    """The files a group writes."""
    if name == "batch":
        return ["f_%03d.jpg" % i for i in range(FRAMES)]
    return [o for _i, o in GROUPS[name][1]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group run by both tools: {group: {pkg: (rc, stdout, dir)}}."""
    src = tmp_path_factory.mktemp("inputs")
    _inputs(src)
    made = {}                     # the JAX tool's outputs, by file name
    out = {}

    def path(x):
        if x.startswith("@"):
            return made[x[1:]]
        return x if x.endswith(".tst") else str(src / x)

    for name, (switches, pairs) in GROUPS.items():
        out[name] = {}
        for pkg in ("jax", "port"):
            d = tmp_path_factory.mktemp(f"{name}_{pkg}")
            argv = [path(a) if a.startswith("@") else a for a in switches]
            for i, o in pairs:
                argv += [path(i), str(d / o)]
            if pkg == "port":
                argv = ["-D", "cpu"] + argv
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = (jcli if pkg == "jax" else tcli).main(argv)
            out[name][pkg] = (rc, buf.getvalue(), d)
        made.update({o: str(out[name]["jax"][2] / o)
                     for o in _outputs(name)})
    out["inputs"] = src
    return out


@pytest.mark.parametrize("name", [n for n in GROUPS if _outputs(n)])
def test_cli_files_match_jax(runs, name):
    """Every output file of the group is the JAX tool's, byte for byte."""
    (jrc, _jo, jd), (trc, _to, td) = runs[name]["jax"], runs[name]["port"]
    assert jrc == trc == 0
    for o in _outputs(name):
        with open(jd / o, "rb") as f0, open(td / o, "rb") as f1:
            want, got = f0.read(), f1.read()
        assert len(got) > 0 and got == want, o


@pytest.mark.parametrize("name", ["info", "encode"])
def test_cli_text_matches_jax(runs, name):
    """What -I and -R (with the encodes) print is the JAX tool's text."""
    (jrc, jo, _), (trc, to, _) = runs[name]["jax"], runs[name]["port"]
    assert jrc == trc == 0 and to == jo and to
    assert ("width: 64" in to) if name == "info" else \
        (to.count("component 0") == 3 and "component 2" in to)


def test_cli_batch_is_single_frame_encodes(runs):
    """-B writes each frame's single-frame encode (the port's Encoder on
    the frame, colour space from -c)."""
    _rc, _o, td = runs["batch"]["port"]
    with open(runs["inputs"] / "seq.y4m", "rb") as f:
        pi, frames = jy4m.load_y4m_frames(f.read())
    enc = gt.Encoder(device="cpu")
    pi_t = gt.ImageParameters(
        width=pi.width, height=pi.height,
        color_space=gt.ColorSpace.YCBCR_BT709,
        pixel_format=gt.PixelFormat[pi.pixel_format.name])
    for i, frame in enumerate(frames):
        with open(td / ("f_%03d.jpg" % i), "rb") as f:
            assert f.read() == enc.encode(frame, gt.Parameters(quality=85),
                                          pi_t)


def test_cli_decode_equals_session(runs):
    """The decoded PPM holds Decoder.decode's pixels of the stream."""
    _rc, _o, td = runs["decode"]["port"]
    with open(runs["encode"]["jax"][2] / "e.jpg", "rb") as f:
        want = gt.Decoder(device="cpu").decode(f.read())
    arr, pi = jimg.load(str(td / "d.ppm"))
    assert np.array_equal(arr, want)


@pytest.mark.parametrize("text", ["4:4:4", "4:2:2", "4:2:0", "4:4:0",
                                  "4:1:1", "4:2:0:4", "4", "3:2:0", "4:0:0"])
def test_cli_subsampling_parse(text):
    """parse_subsampling gives the JAX tool's factors or its exception."""
    out = []
    for mod in (jcli, tcli):
        try:
            out.append(mod.parse_subsampling(text))
        except Exception as e:
            out.append(type(e).__name__)
    assert out[1] == out[0]


def test_cli_device_switch():
    """-D takes a CUDA device index or cpu; anything else is a usage
    error."""
    p = tcli.build_argparser()
    assert p.parse_args(["-D", "cpu"]).device == "cpu"
    assert p.parse_args(["-D", "1"]).device == "cuda:1"
    assert p.parse_args([]).device is None
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            p.parse_args(["-D", "tpu"])


def test_cli_without_cuda_raises(monkeypatch, tmp_path):
    """Without -D the tool runs on CUDA and raises when there is none; it
    never carries on on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-e", "16x16.tst", str(tmp_path / "x.jpg")])
    assert not (tmp_path / "x.jpg").exists()


def test_cli_opengl_and_device_list(monkeypatch, capsys):
    """-o errors out pointing at decode_to_device's CUDA tensors; -L lists
    the CUDA devices (none here)."""
    assert tcli.main(["-D", "cpu", "-o"]) == 1
    assert "CUDA tensor" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: f"card {i}")
    assert tcli.main(["-L"]) == 0
    assert capsys.readouterr().out == "device 0: card 0\ndevice 1: card 1\n"
    assert tcli.main(["-D", "cpu", "x.jpg"]) == 1


def test_cli_last_output(runs):
    """Decoder.last_output is the resolved output of the last decode, as
    the JAX session's (the tool writes Y4M through it)."""
    from gpujpeg_tpu import Decoder as JDecoder
    from gpujpeg_tpu.types import PixelFormatRequest

    with open(runs["subsampled"]["jax"][2] / "s.jpg", "rb") as f:
        data = f.read()
    jd, td = JDecoder(), gt.Decoder(device="cpu")
    assert td.last_output is None
    req = (ImageParameters(color_space=ColorSpace.YCBCR_BT601_256LVLS,
                           pixel_format=PixelFormatRequest.STD),
           gt.ImageParameters(
               color_space=gt.ColorSpace.YCBCR_BT601_256LVLS,
               pixel_format=gt.types.PixelFormatRequest.STD))
    jd.decode(data, req[0])
    td.decode(data, req[1])
    a, b = jd.last_output, td.last_output
    assert (b.width, b.height, b.color_space.name, b.pixel_format.name,
            b.width_padding) == (a.width, a.height, a.color_space.name,
                                 a.pixel_format.name, a.width_padding)
    assert b.pixel_format == gt.PixelFormat.P420_U8_P0P1P2


def test_launcher_imports_no_jax():
    """The launcher runs in a process of its own and imports neither JAX
    nor the JAX package (-V; the same with python -m
    gpujpeg_tpu_torch.cli)."""
    launcher = os.path.join(ROOT, "tpujpegtool_torch")
    probe = (
        "import runpy, sys\n"
        f"sys.argv = [{launcher!r}, '-V']\n"
        "try:\n"
        f"    runpy.run_path({launcher!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gpujpeg_tpu'))\n"
        "print('imported', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-2:] == [
        f"tpujpegtool_torch {gt.__version__} (gpujpeg_tpu_torch)",
        "imported []"]
    out = subprocess.run([sys.executable, "-m", "gpujpeg_tpu_torch.cli",
                          "-V"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0 and out.stdout.startswith("tpujpegtool_torch")
