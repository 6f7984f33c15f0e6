"""tpujpegtool_torch: the command-line tool of the PyTorch port, with
gpujpegtool's surface (src/main.c) and tpujpegtool's switches
(gpujpeg_tpu.cli).

Encode, decode, convert and probe raw images and JPEG files on a CUDA
card through the port's Encoder and Decoder.  The switches mirror the
reference CLI (src/main.c:106-152, getopt table :485-510):

  -D selects the device: a CUDA device index (cuda:N) or "cpu" (the
     plain PyTorch versions of the kernels); without it the current CUDA
     device, and the tool raises when there is none;
  -L lists the CUDA devices;
  -o (OpenGL interop) errors out: decode_to_device returns the image as
     a CUDA tensor, which is the port's way to keep it on the card;
  -B N encodes a multi-frame Y4M input N frames at a time through
     parallel.BatchEncoder over a 'data' mesh of the largest count of
     CUDA devices dividing N (the one device -D N names; a CPU mesh with
     -D cpu), as tpujpegtool's -B does over its devices.

The output files are byte for byte those of tpujpegtool (the JAX
package's CLI) on the same inputs.

    python -m gpujpeg_tpu_torch.cli -e in.ppm out.jpg
    ./tpujpegtool_torch -d out.jpg back.ppm
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import __version__
from .io import formats, image as iio
from .io.formats import FileFormat
from .types import (ColorSpace, ImageParameters, Parameters, PixelFormat,
                    PixelFormatRequest, RESTART_AUTO, pixel_format_comp_count)


def parse_subsampling(text: str) -> Tuple[Tuple[int, int], ...]:
    """J:a:b[:A] -> per-component sampling factors (reference
    MK_SUBSAMPLING semantics; default 4:2:0 when flag given bare)."""
    parts = [int(x) for x in text.split(":")]
    if len(parts) < 3:
        raise ValueError(f"bad subsampling {text!r}")
    J, a, b = parts[:3]
    if J != 4 or a == 0:
        raise ValueError(f"unsupported subsampling {text!r}")
    h = J // a
    v = 2 if b == 0 else 1
    luma = (h, v)
    n = 4 if len(parts) > 3 else 3
    return (luma,) + ((1, 1),) * (n - 1)


def parse_device(text: str) -> str:
    """-D's value: a CUDA device index -> "cuda:N", or "cpu"."""
    if text == "cpu":
        return text
    try:
        return f"cuda:{int(text)}"
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"device must be a CUDA device index or 'cpu', got {text!r}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpujpegtool_torch",
        description="CUDA baseline JPEG encoder/decoder "
                    "(gpujpegtool-compatible CLI)",
        add_help=False)
    p.add_argument("-h", "--help", action="help")
    p.add_argument("-H", "--fullhelp", action="help")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-D", "--device", type=parse_device, default=None,
                   help="CUDA device index, or 'cpu' for the plain "
                        "PyTorch versions (default: the current CUDA "
                        "device)")
    p.add_argument("-L", "--device-list", action="store_true")
    p.add_argument("-s", "--size", type=str, default=None,
                   help="input image size WxH")
    p.add_argument("-f", "--pixel-format", type=str, default=None)
    p.add_argument("-c", "--colorspace", type=str, default=None)
    p.add_argument("-q", "--quality", type=int, default=75)
    p.add_argument("-r", "--restart", type=int, default=RESTART_AUTO)
    p.add_argument("-S", "--subsampled", type=str, nargs="?",
                   const="4:2:0", default=None)
    p.add_argument("-i", "--interleaved", action="store_true")
    p.add_argument("-g", "--segment-info", action="store_true")
    p.add_argument("-e", "--encode", action="store_true")
    p.add_argument("-d", "--decode", action="store_true")
    p.add_argument("-C", "--convert", action="store_true")
    p.add_argument("-R", "--component-range", action="store_true")
    p.add_argument("-n", "--iterate", type=int, default=1)
    p.add_argument("-B", "--batch", type=int, default=0, metavar="N",
                   help="video batch encode: read N frames per batch from "
                        "a multi-frame Y4M input and encode them through "
                        "parallel.BatchEncoder over the CUDA devices; "
                        "output path may contain "
                        "a printf pattern like out_%%03d.jpg")
    p.add_argument("-o", "--use-opengl", action="store_true")
    p.add_argument("-I", "--info", type=str, default=None, metavar="FILE")
    p.add_argument("-a", "--alpha", action="store_true")
    p.add_argument("-N", "--native", action="store_true")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-b", "--debug", action="store_true")
    p.add_argument("-O", dest="options", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("files", nargs="*")
    return p


def print_info(filename: str, device) -> int:
    from .models.decoder import Decoder

    with open(filename, "rb") as f:
        data = f.read()
    info = Decoder(device=device).get_image_info(data)
    print(f"width: {info.width}")
    print(f"height: {info.height}")
    print(f"component count: {info.comp_count}")
    if info.sampling:
        from .types import subsampling_name

        print("subsampling: "
              f"{subsampling_name(info.comp_count, info.sampling)}")
    print(f"color space: {formats.COLOR_SPACE_DISPLAY.get(info.color_space)}")
    print(f"interleaved: {'yes' if info.interleaved else 'no'}")
    print(f"restart interval: {info.restart_interval}")
    print(f"segment count: {info.segment_count}")
    print(f"header type: {info.header_type.name}")
    if info.quality is not None:
        print(f"quality: {info.quality}")
    if info.comment:
        print(f"comment: {info.comment}")
    return 0


def _channels(arr: np.ndarray, pi: ImageParameters, device) -> torch.Tensor:
    """A loaded image's (H, W, C) int32 channels on the device."""
    from .ops import sample

    return sample.unpack_to_channels(torch.from_numpy(arr).to(device), pi)


def component_range(arr: np.ndarray, pi: ImageParameters, device) -> None:
    """Per-component sample min/max (gpujpeg_image_range_info,
    gpujpeg_common.c:1382-1442)."""
    chans = _channels(arr, pi, device)
    for c in range(chans.shape[-1]):
        print(f"component {c}: min {int(chans[..., c].min())}, "
              f"max {int(chans[..., c].max())}")


def _image_params_for(path: str, args, exists: bool) -> ImageParameters:
    pi = iio.probe(path, file_exists=exists)
    if args.size:
        w, h = args.size.lower().split("x")
        pi = pi.with_(width=int(w), height=int(h))
    if args.pixel_format:
        pf = formats.pixel_format_by_name(args.pixel_format)
        if pf is None:
            raise SystemExit(f"unknown pixel format {args.pixel_format!r}")
        pi = pi.with_(pixel_format=pf)
    if args.colorspace:
        cs = formats.color_space_by_name(args.colorspace)
        if cs is None:
            raise SystemExit(f"unknown color space {args.colorspace!r}")
        pi = pi.with_(color_space=cs)
    return pi


def apply_options(args, enc=None, dec=None) -> None:
    """-O key=value passthrough (main.c -O, enc_*/dec_* prefixes)."""
    for spec in args.options:
        if spec == "help":
            from .models.decoder import Decoder
            from .models.encoder import Encoder

            print("encoder options:")
            print(Encoder.print_options())
            print("decoder options:")
            print(Decoder.print_options())
            raise SystemExit(0)
        if "=" not in spec:
            raise SystemExit(f"bad option {spec!r}, expected key=value")
        key, value = spec.split("=", 1)
        if key.startswith("enc_") and enc is not None:
            enc.set_option(key, value)
        elif key.startswith("dec_") and dec is not None:
            dec.set_option(key, value)


def _encode_params(args) -> Parameters:
    param = Parameters(
        quality=args.quality, restart_interval=args.restart,
        interleaved=args.interleaved, segment_info=args.segment_info)
    if args.subsampled:
        param = param.chroma_subsampled(parse_subsampling(args.subsampled))
    return param


def run_encode(args, enc, in_path: str, out_path: str) -> None:
    arr, pi_file = iio.load(in_path)
    pi = _image_params_for(in_path, args, exists=True)
    if pi.width == 0:
        pi = pi.with_(width=pi_file.width, height=pi_file.height)
    if pi.pixel_format == PixelFormat.NONE:
        pi = pi.with_(pixel_format=pi_file.pixel_format)
    if pi.color_space == ColorSpace.NONE:
        pi = pi.with_(color_space=pi_file.color_space)
    if pi.width == 0 or pi.height == 0:
        raise SystemExit(f"size unknown for {in_path}; use -s WxH")

    param = _encode_params(args)
    if args.native:
        if pi.color_space == ColorSpace.RGB:
            param = param.with_(color_space_internal=ColorSpace.RGB)
        elif pi.color_space == ColorSpace.YCBCR_BT709:
            param = param.with_(color_space_internal=ColorSpace.YCBCR_BT709)
    if args.alpha and pixel_format_comp_count(pi.pixel_format) == 4:
        param = param.with_(comp_count=4)

    if args.component_range:
        component_range(arr, pi, enc.device)

    if args.verbose > 1:
        enc.perf_stats = True       # per-phase breakdown (reference -v)
    out = None
    for it in range(max(args.iterate, 1)):
        t0 = time.perf_counter()
        out = enc.encode(arr, param, pi)
        dt = (time.perf_counter() - t0) * 1000
        if args.verbose or args.iterate > 1:
            st = enc.get_stats()
            if args.verbose > 1:
                st.print()
            print(f"Encode Image GPU:   {st.duration_in_gpu:10.4f} ms "
                  "(only in-device processing)", file=sys.stderr)
            print(f"Encode Image:       {dt:10.4f} ms", file=sys.stderr)
    if args.iterate > 1:
        print(f"encode {in_path}: {enc.aggregate.summary()}",
              file=sys.stderr)
    with open(out_path, "wb") as f:
        f.write(out)
    print(f"encoded {in_path} -> {out_path} "
          f"({len(out)} bytes)", file=sys.stderr)


def _batch_out_path(out_path: str, idx: int) -> str:
    if "%" in out_path:
        return out_path % idx
    root, ext = os.path.splitext(out_path)
    return f"{root}_{idx:03d}{ext}"


def batch_mesh(device, batch: int, named: bool):
    """The 'data' mesh of -B: the largest count of CUDA devices that
    divides the batch, as tpujpegtool's -B takes over jax.devices(); the
    one device -D names when `named`; on the CPU (-D cpu) every place is
    the CPU and the mesh takes the batch's size."""
    from .parallel.mesh import make_mesh

    if device.type == "cpu":
        return make_mesh(batch, data=batch, seg=1, device="cpu")
    if named:
        return make_mesh(1, data=1, seg=1, device=device)
    nd = torch.cuda.device_count()
    data_ext = max(k for k in range(1, min(nd, batch) + 1)
                   if batch % k == 0)
    return make_mesh(n_devices=data_ext, data=data_ext, seg=1)


def run_encode_y4m_batch(args, device, in_path: str, out_path: str) -> None:
    """Video-sequence batch encode: every FRAME of a Y4M file, args.batch
    frames at a time, through parallel.BatchEncoder over a 'data' mesh
    (batch_mesh; the reference's Y4M reader is single-frame,
    src/utils/y4m.c, and its CLI iterates files serially).  The tail
    batch is padded with its last frame, whose extra outputs are
    dropped.  The files are those of tpujpegtool's -B."""
    from .io import y4m
    from .parallel.batch import BatchEncoder

    with open(in_path, "rb") as f:
        data = f.read()
    pi, frames_it = y4m.load_y4m_frames(data)
    if args.colorspace:
        cs = formats.color_space_by_name(args.colorspace)
        if cs is None:
            raise SystemExit(f"unknown color space {args.colorspace!r}")
        pi = pi.with_(color_space=cs)
    param = _encode_params(args)
    batch = max(args.batch, 1)
    mesh = batch_mesh(device, batch, args.device is not None)
    data_ext = mesh.shape["data"]
    enc = BatchEncoder(mesh, param, pi)

    idx = 0
    t0 = time.perf_counter()
    chunk: list = []

    def flush(chunk):
        nonlocal idx
        real = len(chunk)
        while len(chunk) < batch:        # pad the tail batch (outputs
            chunk.append(chunk[-1])      # of the padding are dropped)
        outs = enc.encode_batch(chunk)
        for s in outs[:real]:
            p = _batch_out_path(out_path, idx)
            with open(p, "wb") as f:
                f.write(s)
            if args.verbose:
                print(f"encoded frame {idx} -> {p} ({len(s)} bytes)",
                      file=sys.stderr)
            idx += 1

    for frame in frames_it:
        chunk.append(frame)
        if len(chunk) == batch:
            flush(chunk)
            chunk = []
    if chunk:
        flush(chunk)
    dt = time.perf_counter() - t0
    print(f"encoded {idx} frames from {in_path} over a {data_ext}-device "
          f"'data' mesh ({device.type}) in {dt * 1000:.1f} ms "
          f"({idx / dt:.1f} frames/s)", file=sys.stderr)


def run_decode(args, dec, in_path: str, out_path: str) -> None:
    with open(in_path, "rb") as f:
        data = f.read()
    out_pi = _image_params_for(out_path, args, exists=False)
    out_fmt = formats.get_file_format(out_path)
    if (out_fmt == formats.FileFormat.Y4M
            and out_pi.pixel_format == PixelFormat.NONE):
        # Y4M stores planar 444/422/420: request the STD pseudo-format and
        # let the decoder resolve it (gpujpeg_decoder.h:238-240)
        out_pi = out_pi.with_(pixel_format=PixelFormatRequest.STD)

    if args.verbose > 1:
        dec.perf_stats = True       # per-phase breakdown (reference -v)
    arr = None
    for it in range(max(args.iterate, 1)):
        t0 = time.perf_counter()
        arr = dec.decode(data, out_pi if (out_pi.pixel_format
                                          != PixelFormat.NONE
                                          or out_pi.color_space
                                          != ColorSpace.NONE) else None)
        dt = (time.perf_counter() - t0) * 1000
        if args.verbose or args.iterate > 1:
            if args.verbose:
                dec.stats.print()
            print(f"Decode Image GPU:   "
                  f"{dec.stats.duration_in_gpu:10.4f} ms "
                  "(only in-device processing)", file=sys.stderr)
            print(f"Decode Image:       {dt:10.4f} ms", file=sys.stderr)
    if args.verbose and args.iterate > 1:
        print(dec.stats.summary(), file=sys.stderr)
    # the decoder records the resolved output parameters (pseudo formats
    # like STD/NATIVE resolve against the stream)
    pi = dec.last_output or out_pi
    if pi.pixel_format == PixelFormat.NONE or \
            isinstance(pi.pixel_format, PixelFormatRequest):
        pi = pi.with_(pixel_format=(PixelFormat.U8 if arr.ndim == 2 else
                                    PixelFormat.P444_U8_P012
                                    if arr.ndim == 3 and arr.shape[2] == 3
                                    else PixelFormat.P4444_U8_P0123))
    iio.save(out_path, pi, np.asarray(arr))
    print(f"decoded {in_path} -> {out_path}", file=sys.stderr)


def run_convert(args, device, in_path: str, out_path: str) -> None:
    """Colorspace/pixel-format conversion without JPEG (main.c -C), on
    the device (ops/color.convert, ops/sample)."""
    from .ops import color, sample

    arr, pi_in = iio.load(in_path)
    pi = _image_params_for(in_path, args, exists=True)
    if pi.width == 0:
        pi = pi.with_(width=pi_in.width, height=pi_in.height)
    if pi.pixel_format == PixelFormat.NONE:
        pi = pi.with_(pixel_format=pi_in.pixel_format,
                      color_space=pi_in.color_space)
    pi_out = iio.probe(out_path, file_exists=False)
    if pi_out.pixel_format == PixelFormat.NONE:
        pi_out = pi_out.with_(pixel_format=pi.pixel_format)
    if pi_out.color_space == ColorSpace.NONE:
        pi_out = pi_out.with_(color_space=pi.color_space)
    pi_out = pi_out.with_(width=pi.width, height=pi.height)

    chans = _channels(arr, pi, device)
    if chans.shape[-1] >= 3:
        rgb = color.convert(chans[..., :3], pi.color_space,
                            pi_out.color_space)
        chans = (torch.cat([rgb, chans[..., 3:]], dim=-1)
                 if chans.shape[-1] > 3 else rgb)
    out = sample.pack_channels(chans, pi_out).cpu().numpy()
    iio.save(out_path, pi_out, out)
    print(f"converted {in_path} -> {out_path}", file=sys.stderr)


def main(argv: Optional[list] = None) -> int:
    args = build_argparser().parse_args(argv)

    # leveled logging like the reference's -v/-b tiers
    # (gpujpeg_common.h:162-169): -vv = INFO, -vvv or -b = DEBUG
    lvl = logging.WARNING
    if args.debug or args.verbose >= 3:
        lvl = logging.DEBUG
    elif args.verbose >= 2:
        lvl = logging.INFO
    logging.basicConfig(stream=sys.stderr,
                        format="%(levelname)s %(name)s: %(message)s")
    logging.getLogger("gpujpeg_tpu_torch").setLevel(lvl)

    if args.version:
        print(f"tpujpegtool_torch {__version__} (gpujpeg_tpu_torch)")
        return 0
    if args.device_list:
        for i in range(torch.cuda.device_count()):
            print(f"device {i}: {torch.cuda.get_device_name(i)}")
        return 0
    from .device import resolve_device

    device = resolve_device(args.device)
    if args.info:
        return print_info(args.info, device)
    if args.use_opengl:
        print("OpenGL interop is not supported; Decoder.decode_to_device "
              "returns the image as a CUDA tensor, which keeps it on the "
              "card", file=sys.stderr)
        return 1

    files = args.files
    if not files or len(files) % 2 != 0:
        print("expected input/output file pairs", file=sys.stderr)
        return 1

    encoder = decoder = None
    for i in range(0, len(files), 2):
        in_path, out_path = files[i], files[i + 1]
        in_fmt = formats.get_file_format(in_path)
        out_fmt = formats.get_file_format(out_path)
        encode = args.encode or (not args.decode and not args.convert
                                 and out_fmt == FileFormat.JPEG)
        decode = args.decode or (not args.encode and not args.convert
                                 and in_fmt == FileFormat.JPEG)
        if args.convert:
            run_convert(args, device, in_path, out_path)
        elif encode and not decode:
            if args.batch > 0 and in_fmt == FileFormat.Y4M:
                run_encode_y4m_batch(args, device, in_path, out_path)
                continue
            if encoder is None:
                from .models.encoder import Encoder

                encoder = Encoder(device=device)
                apply_options(args, enc=encoder)
            run_encode(args, encoder, in_path, out_path)
        elif decode:
            if decoder is None:
                from .models.decoder import Decoder

                decoder = Decoder(device=device)
                apply_options(args, dec=decoder)
            run_decode(args, decoder, in_path, out_path)
        else:
            print(f"cannot infer direction for {in_path} -> {out_path}; "
                  "use -e or -d", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
