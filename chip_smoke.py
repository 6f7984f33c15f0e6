#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --parent DIR    # DIR: a checkout of the parent

Drives gpujpeg_tpu_torch only (never the JAX package) on one CUDA card.
Given --parent, it also builds DIR's csrc/huffdec_block.cu and times the
parent's phase C instances on the same words as this tree's, the direct
instance at 8K Q100 and the four-set one on the three-set streams
(ParentBlock, parent_ms in their records); with no argument those times
are not taken.  The steps:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from gpujpeg_tpu_torch/csrc and prints the
     build seconds and each kernel's ptxas resource line;
  3. runs each kernel against its plain PyTorch version on the card at the
     8K (7680x4320) shapes of the main path: the preprocessor and the DCT
     must match bit for bit, the Huffman coder's rows and row lengths
     exactly, on a seeded gradient-plus-noise frame and a uniform-noise
     frame; the token-row packer (on no tuned encode path; step 10 runs
     it on the Annex-K paths) on the plain tokenizer's token rows of the
     luma plane's coefficients (64,800 rows of 512 slots) must equal its
     plain version and the Huffman coder's bytes;
  4. encodes a 1920x1080 frame with Encoder(device="cuda") and with
     Encoder(device="cpu") and requires identical bytes;
  5. encodes three seeded 8K RGB frames through Encoder.encode at Q75,
     restart interval auto (the reference GPUJPEG's headline
     configuration), checks SOI/EOI and that the RST count equals segments
     minus scans, and prints per-frame wall ms (those three and
     EXTRA_FRAMES more), a stage breakdown and each kernel's CUDA-event
     time (the token-row packer's at step 3's luma token rows); the
     preprocessor writes a frame's three planes in one launch (checked on
     every path: 3 launches over the three frames) and its records are ms
     a frame;
  6. decodes on the card (gpujpeg_tpu_torch.Decoder), fed by step 5's 8K
     streams and one 8K noise stream:
     a. each decode kernel (phase-A scan, phase-C block decode, fused
        dequantization + IDCT + colour) against its plain version on the
        gradient and the noise stream: bstart/err, coefficients/err and
        pixels must match exactly;
     b. decodes a 1920x1080 stream with Decoder(device="cuda") and with
        Decoder(device="cpu") and requires identical pixels;
     c. decodes the three 8K streams through Decoder.decode (launch counts
        read over those three), prints their PSNR against the source
        frames, per-frame wall ms (those three and EXTRA_FRAMES more,
        bytes in to a host array out) and a stage breakdown;
     d. times each decode kernel at the main path's shapes; phase A's
        record also counts the tokens it walks (a DC a block, a nonzero
        AC coefficient, ZRLs and EOBs, from the decoded coefficients)
        and its ns a token, and phase C's record (the same tokens, each
        read through the plan's lookahead table Plan.block_lut) its ns a
        token;
  7. runs the interleaved 4:2:0 path (one scan, luma 2x2, chroma 1x1,
     Q75, restart interval auto = 1 MCU a segment; libjpeg's default
     layout):
     a. each kernel and mode of that path against its plain version at
        8K on a gradient and a noise frame, bit for bit: the decimating
        preprocessor (luma and chroma in one launch), the DCT storing MCU
        order (interleaved_rows, three fdct_quant launches, against
        interleaved_rows_plain: raster order, then a torch copy), the
        slot-pattern Huffman coder, the token-row packer (on no encode
        path; fed the plain tokenizer's token rows of
        the same coefficients, it must also give the Huffman coder's
        bytes), the Huffman decode phases in slot-pattern mode, the IDCT
        to planes and the postprocessor;
     b. encodes and decodes a 1920x1080 frame with device="cuda" and
        device="cpu" and requires identical bytes and pixels;
     c. encodes three seeded 8K frames through Encoder.encode and decodes
        their streams through Decoder.decode (launch counts read over
        each; the token-row packer must not run), checks SOI/EOI, the RST
        count and the PSNR, and prints per-frame wall ms (those three and
        EXTRA_FRAMES more) and a stage breakdown of each;
     d. times each kernel and mode of the path at its shapes, the
        MCU-order DCT beside the planar store's three launches on the
        same planes;
  8. the same four steps for interleaved 4:4:4 (one scan, Q75, restart
     auto = 2 MCUs a segment): the preprocessor (pre_rgb_to_planes:il_444),
     the MCU-order DCT, the slot-pattern Huffman coder and its
     coefficient-input mode (the three planes' coefficients as rows of 8
     blocks, a class flag a row, one interior masked block, a zero marker
     mid-scan) against their plain versions; decode through phases A and
     C in pattern mode, the IDCT planes (one launch a frame) and the
     postprocessor, each held against its plain version and timed (the
     records huffdec_scan:pattern_444, huffdec_block:pattern_444,
     idct_planes:444, post_rgb:444);
  9. the same four steps for planar 4:2:0 (three non-interleaved scans,
     luma 2x2, chroma 1x1, 8 blocks a segment): the decimating
     preprocessor (pre_rgb_to_planes:planar_420), the fused decode tail at
     dx = dy = 2 and phases A and C over the three scans against their
     plain versions (huffdec_scan:planar_420, huffdec_block:planar_420);
     encode through the decimating preprocessor, the DCT and the one-slot
     Huffman coder per component;
 10. [foreign]: the streams other encoders write (foreign_phases), in
     planar 4:4:4 and interleaved 4:2:0 at 8K: Annex-K tables at restart
     auto (the token-row packer on the encode's token rows, phases A and
     C on the stream, each against its plain version; pixels equal to
     the tuned stream's of the same frame), restart interval 0 (a scan
     one segment; pixels equal to restart auto's; phases A and C against
     their plain versions on 128x96 and 512x384 restart-0 streams; phase
     A's sync instance, which the decoder takes there, against its serial
     instance at 8K on the clean stream and on one with a bit flipped
     mid-scan, timed beside it; the main-path windows run the sync
     instance and never the serial one), three Huffman
     table sets (the Annex-K stream rewritten; the four-set kernel
     instances against their plain versions, pixels equal to the
     unmodified stream's), HD card bytes and pixels against the CPU's;
     then three 8K frames encoded and decoded on each path (launches
     counted; the packer must run on the Annex-K encodes), their wall ms
     and stages, and the packer's and both phases' ms on these streams;
     last, the streams whose restart interval exceeds a scan's MCU count
     (restart_long_streams: every segment shorter than the interval),
     decoded on the card and held against the CPU's decode at error 0;
 11. [session]: the session surface at 8K (session_phases): the DC
     fix-up kernel (csrc/dc_fixup.cu, which every decode path launches
     and every decode window checks) against its plain version
     _dc_fixup_t on the coefficients of the four tuned layouts and of
     restart-0 streams in planar 4:4:4 and interleaved 4:2:0, error 0,
     timed beside its bound and the torch cumsum chain; then, in planar
     4:4:4 and interleaved 4:2:0: Encoder.allocate and Decoder.warmup
     beside a fresh session's first frame; encode_pipelined and
     decode_pipelined over 12 frames in main-path windows, every stream
     byte for byte sequential encode()'s and every yielded array, all
     kept until the run has ended, sequential decode()'s; ms between
     yields beside the sequential ms a frame; compile_stream_pipeline's
     device-only decode (pixels and ms); get_stats() with perf_stats
     on; and estimate_memory against the measured peak of one encode in
     six layouts;
 12. [formats]: every pixel format, component count and sampling
     (formats_phases):
     a. the pre, post and dpost instances of the other formats at 8K
        against their plain versions, error 0, each timed beside its
        bound, its plain version and, where one PyTorch call computes the
        same (the U8 preprocessor: F.pad; the U8 postprocessor: a slice
        copy; dpost: three torch.matmul), that call: U8, UYVY, planar
        4:2:0 and 4:4:4 and RGBA inputs; RGBA outputs from 3 planes at
        4:4:4 and 4:2:0 and from 4 planes, U8, planar 4:2:0 and UYVY
        outputs; dpost's RGBA store at dx = dy = 1 and 2;
     b. HD (1920x1080) card bytes and arrays against the CPU's for every
        input and output format, 4:1:1, 4 components and the flip, remap
        and alignment options;
     c. three 8K frames of each FORMAT_LAYOUTS layout (greyscale U8 in
        and out; UYVY in, 4:2:2, UYVY out; RGBA with 4 components in and
        out; planar 4:2:0 in, interleaved 4:2:0, planar out via STD;
        interleaved 4:1:1 from planar 4:4:4; RGB in, RGBA out through
        dpost) through Encoder.encode and Decoder.decode in main-path
        windows: launch counts (the pre and post kernels ran, no plain
        pre- or postprocessor did), PSNR of the raw output against the
        input, wall ms (median and quartiles) and a stage split
        (get_stats under perf_stats);
 13. [relayout]: the four relayout and primitive kernels of
     csrc/relayout.cu (the H100 counterparts of the JAX package's TPU
     probes tools/proto_xbdkernel.py, tools/profile_transpose.py and
     tools/profile_prims.py; on no codec path) at those tools' 8K shapes
     on seeded words, each against its plain version on the card, timed
     beside its bound and the PyTorch call that computes the same; the xbd
     relayout's line names the instance its C entry takes (the 16-byte
     vector one at rst 8, or the generic one); the two row kernels
     (pair_sum_rows, pack_u8_quads) also print the median and minimum of
     200 launches, the same of an empty kernel launched as each is (its
     grid and block, through the same path) and of a
     device-to-device copy_ that moves the same bytes, read and written;
 14. [tool]: the direct route and the command-line tool (tool_phases):
     a. 8K Q100 at restart auto (one block a segment: 1,555,200 segments
        in planar 4:4:4 RGB) and greyscale U8: phase C's direct instance
        (huffdec_block:direct) against its plain version on a gradient
        and a noise stream, error 0; pixels equal to the same session's
        phases A and C with the fix-up through the same back half; three
        frames of each layout through Decoder.decode in main-path windows
        with 0 phase-A and 0 fix-up launches; the direct phase C's ms
        beside its bound and phases A + C + fix-up's ms on the same
        stream, its probe stages (rows staged and every block's first
        words loaded with no token decoded; the decode without the
        coefficient store), the tokens of the gradient and noise
        streams by the path each takes in the segment-row walk's
        9-bit table and in the direct table's two levels (token_paths),
        and, given --parent DIR, the parent tree's direct instance
        timed on the same words (ParentBlock); wall ms a frame (median
        and quartiles);
     b. tpujpegtool_torch in processes of its own on the card: an 8K PPM,
        an 8K PGM and 7680x4320.random_7.tst encoded at Q75 and the
        streams decoded back, a 4K 4:2:0 Y4M of 8 frames through -B 4,
        -I and -C; every file equal to the in-process sessions' bytes and
        arrays (the conversion to the CPU's), each call's wall seconds;
 15. [parallel]: parallel/ on the one card, every mesh place cuda:0
     (parallel_phases): references first (four seeded 8K RGB Q75 frames
     through Encoder.encode, an interleaved 4:2:0 encode, one 16K
     15360x8640 frame through the whole-frame Encoder and Decoder), then
     one main-path window: BatchEncoder over the four frames on a (1, 1)
     mesh, at seg 4 (planar 4:4:4), at seg 2 (interleaved 4:2:0) and the
     16K frame at seg 8, ShardedDecoder at seg 4 on the 8K and the 16K
     streams, BatchDecoder over the four 8K streams on a (4, 1) mesh;
     every stream byte for byte Encoder.encode's, every array
     Decoder.decode's, each Huffman launch of the window a stripe's (with
     its markers); walls a frame of the batch beside sequential
     encode and decode; the Huffman coder with a stripe's markers (every
     row marked) against its plain version, error 0
     (huffman_segments:stripe_markers); encode_to_device at restart
     interval 0 on an 8K frame in a window of its own, assembled to
     encode()'s bytes, the token-row packer's scan instance (chunks of a
     scan a CTA) on a whole luma scan against its plain version and its
     row instance (one warp walking the scan), both timed
     (pack_stuff_rows:restart0_444), and the 16K interleaved 4:4:4
     restart-0 scan (a worst-case row past 2^31 bytes) through
     encode_to_device, assembled to encode()'s bytes; the windows'
     launches add to the records of the kernels they launch;
 16. prints the decomposition line of the tiled kernels (fdct_quant,
     dpost_rgb at 4:4:4 and 4:2:0), of the Huffman coder (one slot,
     4:4:4 and 4:2:0 slot patterns, the 4:2:0 rows also with every
     coefficient 0), of phase C (planar 4:4:4, interleaved 4:2:0:
     full, every block's loads and window with no token decoded and the
     zero tiles stored, the decode without the coefficient store) and of
     the token-row packer (4:2:0 and 4:4:4 luma token rows: full, the
     lengths and the token quads' bits loaded with nothing coded, no byte
     store; also on the Annex-K token rows), timed at 8K in steps 5 to
     10:
     each kernel's CUDA-event ms in three stages built from its own
     source (csrc/tile.cuh gj::Stage) -- full, loads and stores only with
     no arithmetic (the Huffman coder: the coefficient loads alone), and
     full with no output store -- the H100
     counterpart of the JAX package's TPU probes tools/proto_xq.py and
     tools/profile_dpost5.py; the full stage is held against the plain
     version (error 0);
 17. prints one JSON line of per-kernel records, every kernel and mode
     (launches during its main path, error against the plain version,
     times, the bound from this run's inputs, the PyTorch library
     yardstick where one exists; the tokens and ns a token of phases A
     and C on each of the four paths; the preprocessor in ms a frame,
     one launch a frame; a note where a record is on no path);
 18. prints {"ok": true, "device": {...}} as its last line.

Launches are counted in windows around each path's three 8K frames
(end_window); a record's launches are its kernel's sum over those
windows, so the launches made to check or time a kernel never count.

Any failure raises and exits non-zero; with no CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

H8K, W8K = 4320, 7680
QUALITY = 75
#: 8K frames timed after the three whose launches are counted, per path
EXTRA_FRAMES = 9
#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, non-tensor f32
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
#: launches by kernel, summed over the main-path windows (end_window)
PATH_LAUNCHES: dict = {}


def end_window() -> None:
    """Add the launch counts of the main-path window that just ended (the
    counts were reset at its start) to PATH_LAUNCHES."""
    from gpujpeg_tpu_torch.ops import _kernels

    for name, n in _kernels.LAUNCHES.items():
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + n


def log(*a):
    print(*a, flush=True)


def make_frame(torch, kind: str, seed: int, h: int, w: int, dev):
    """Seeded (h, w, 3) uint8 frame made on the device: 'gradient' =
    smooth ramps plus +-24 noise (photographic-like density at Q75),
    'noise' = uniform bytes (densest coefficients, heavy stuffing)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if kind == "noise":
        return torch.randint(0, 256, (h, w, 3), generator=g, device=dev,
                             dtype=torch.uint8)
    yy = torch.arange(h, device=dev, dtype=torch.int32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    base = torch.stack([xx * 255 // w + 0 * yy, yy * 255 // h + 0 * xx,
                        (xx + yy) * 255 // (w + h)], dim=-1)
    noise = torch.randint(-24, 25, (h, w, 3), generator=g, device=dev,
                          dtype=torch.int32)
    return torch.clamp(base + noise, 0, 255).to(torch.uint8)


def event_ms(torch, fn, reps: int, flush=None) -> float:
    """Mean CUDA-event time of fn() over reps runs, each timed on its own;
    `flush` (a large tensor) is rewritten before each run so that the run
    finds its inputs outside the 50 MB L2, as the encoder does."""
    return sum(event_times(torch, fn, reps, flush)) / reps


def event_times(torch, fn, reps: int, flush=None) -> list:
    """The CUDA-event ms of each of reps runs of fn(), as event_ms times
    them, sorted."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.add_(1)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in pairs)


def probe_ms(torch, fn, plain, flush, err_of=None) -> dict:
    """CUDA-event ms of each decomposition stage of a tiled kernel
    (_kernels.PROBE_STAGES), fn(stage) launching that stage; the full
    stage's output (a tensor, or Huffman rows, lengths and needs, or what
    err_of(out, ref) compares) must equal plain() (its max_abs_err, 0)."""
    from gpujpeg_tpu_torch.ops import _kernels

    out, ref = fn("full"), plain()
    err = (err_of(out, ref) if err_of is not None
           else rows_err(torch, *out, *ref) if isinstance(out, tuple)
           else diff(out, ref))
    if err:
        raise AssertionError("a probe's full stage differs from the plain "
                             "version")
    out = {st: event_ms(torch, lambda: fn(st), 20, flush)
           for st in _kernels.PROBE_STAGES}
    out["max_abs_err"] = err
    return out


def once_ms(torch, fn):
    """(fn(), its CUDA-event ms) of one run, for the plain versions."""
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def pinned_frame(torch, frame):
    """(a host frame copied into pinned memory, the host ms of the copy):
    the sessions' staging (models/staging.py), ahead of a stage
    breakdown's upload."""
    t0 = time.perf_counter()
    pinned = torch.empty(frame.shape, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(torch.from_numpy(frame))
    return pinned, (time.perf_counter() - t0) * 1e3


def pinned_image(torch, pi):
    """A pinned (H, W, 3) uint8 block for a stage breakdown's download, as
    Decoder.decode copies its image into."""
    return torch.empty((pi.height, pi.width, 3), dtype=torch.uint8,
                       pin_memory=True)


def stream_word_bytes(nbits) -> int:
    """Bytes of the segment word matrix that the segments' bits fill (each
    row up to its last bit's word): what phases A and C must read, where
    the matrix is padded to its longest row."""
    return int(((nbits.long() + 31) // 32).sum()) * 4


def psnr(np, a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def diff(a, b) -> int:
    """Largest absolute difference of two integer tensors."""
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


def rows_err(torch, rows, rb, needs, p_rows, p_rb, p_needs) -> int:
    """Largest difference of two sets of byte rows inside their lengths
    (255 when the lengths differ) and of their needs vectors."""
    if not torch.equal(rb, p_rb):
        return 255
    inside = torch.arange(rows.shape[1], device=rows.device)[None, :] \
        < rb[:, None]
    return max(diff(needs, p_needs), diff(rows[inside], p_rows[inside]))


def check_stream(np, out: bytes, want_rst: int, what: str) -> None:
    """SOI first, EOI last, and want_rst RST markers (segments - scans)."""
    if out[:2] != b"\xff\xd8" or out[-2:] != b"\xff\xd9":
        raise AssertionError(f"{what} stream lacks SOI/EOI")
    data = np.frombuffer(out, np.uint8)
    ff = np.nonzero(data[:-1] == 0xFF)[0]
    nrst = int(((data[ff + 1] >= 0xD0) & (data[ff + 1] <= 0xD7)).sum())
    if nrst != want_rst:
        raise AssertionError(f"{what}: RST count {nrst} != {want_rst}")


def quartiles(np, walls) -> str:
    q = np.percentile(walls, [25, 50, 75])
    return (f"{len(walls)} frames: median {q[1]:.3f}, quartiles {q[0]:.3f} "
            f"/ {q[2]:.3f}; " + ", ".join(f"{w:.3f}" for w in walls))


def hd_check(torch, np, gt, dev, params, seed: int, what: str) -> None:
    """A 1920x1080 frame encoded and decoded with device=cuda and with
    device=cpu: the bytes and the pixels must be equal."""
    hd = make_frame(torch, "gradient", seed, 1080, 1920, dev).cpu().numpy()
    data = gt.Encoder(device=dev).encode(hd, params)
    if data != gt.Encoder(device="cpu").encode(hd, params):
        raise AssertionError(f"HD {what} encode on the card differs from "
                             "the CPU")
    got = gt.Decoder(device=dev).decode(data)
    if not np.array_equal(got, gt.Decoder(device="cpu").decode(data)):
        raise AssertionError(f"HD {what} decode on the card differs from "
                             "the CPU")
    log(f"[{what} hd] 1920x1080 Q75 {len(data)} bytes: card == cpu (bytes "
        f"and pixels), PSNR {psnr(np, got, hd):.2f} dB")


def pre_once_a_frame(launches, frames: int, what: str) -> None:
    """The preprocessor writes every plane of a frame in one launch."""
    if launches["pre_rgb_to_planes"] != frames:
        raise AssertionError(f"{what} encode: {launches['pre_rgb_to_planes']}"
                             f" preprocessor launches for {frames} frames")


def huffman_bound_ms(coefs, rb, extra: int = 0) -> float:
    """Bytes bound of one huffman_segments launch: every coefficient read
    once (the rows hold no pad blocks at 8K), both classes' tables, the
    markers, the realised rows and their lengths written once, plus
    `extra` bytes of inputs (mask, class flags)."""
    return (coefs.numel() * 2 + 2 * 272 * 4 + 4 * rb.numel()
            + int(rb.sum()) + 4 * rb.numel() + extra) / PEAK_BYTES_S * 1e3


def token_rows(torch, coefs, st):
    """The tokenizer's token rows (fusedpack.rows_tokens) of coefficient
    rows in the slot layout st, every block valid, made on the card a
    chunk at a time -> (bits, lens), int32 (R, blocks * 64)."""
    from gpujpeg_tpu_torch.ops import fusedpack

    R, B = coefs.shape[0], coefs.shape[1] // 64
    ok = torch.ones((R, B), dtype=torch.bool, device=coefs.device)
    cls = torch.tensor(st.slot_class, device=coefs.device).repeat(
        B // st.bpm).expand(R, B)
    return fusedpack.rows_tokens(coefs, st, ok, cls)


def pack_check(torch, bits, lens, markers, stride, coded):
    """pack_stuff_rows on token rows against its plain version and against
    the Huffman coder's (rows, row_bytes, needs) `coded` of the same
    coefficients -> (error, plain ms, bytes of the rows)."""
    from gpujpeg_tpu_torch.ops import fusedpack

    k_out = fusedpack.pack_stuff_rows(bits, lens, markers, stride)
    p_out, ms = once_ms(torch, lambda: fusedpack.pack_stuff_rows_plain(
        bits, lens, markers, stride))
    err = max(rows_err(torch, *k_out, *p_out), rows_err(torch, *k_out,
                                                         *coded))
    return err, ms, int(k_out[1].sum())


def pack_bound_ms(lens, markers, nbytes: int, slots: int = 4) -> float:
    """Bytes bound of one pack_stuff_rows launch: every length read, the
    bits of only the 4-slot quads that hold a token (the kernel skips a
    quad whose lengths are all 0), the markers, the realised rows and
    their lengths written.  slots=8 counts the bits in whole 32-byte
    sectors (two quads; rows start on 32 bytes when T % 8 == 0), what
    the card reads when a quad's neighbour holds no token."""
    groups = int((lens.view(lens.shape[0], -1, slots) != 0).any(-1).sum())
    return (lens.numel() * 4 + groups * 4 * slots + markers.numel() * 4
            + nbytes + lens.shape[0] * 4) / PEAK_BYTES_S * 1e3


def pack_times(torch, k, bits, lens, markers, stride, nbytes, flush):
    """A pack_stuff_rows record's ms, bound and probe stages (full | the
    lengths and the token quads' bits loaded, nothing coded | no byte
    store) on token rows."""
    from gpujpeg_tpu_torch.ops import fusedpack

    k["ms"] = event_ms(torch, lambda: fusedpack.pack_stuff_rows(
        bits, lens, markers, stride), 10, flush)
    k["bound_ms"] = pack_bound_ms(lens, markers, nbytes)
    k["probe"] = probe_ms(
        torch, lambda st: fusedpack.pack_stuff_rows_probe(
            bits, lens, markers, stride, st),
        lambda: fusedpack.pack_stuff_rows_plain(bits, lens, markers,
                                                stride), flush)
    k["probe"]["sector_bound_ms"] = pack_bound_ms(lens, markers, nbytes, 8)


def scan_call(words, nbits, p, instance=None):
    """Phase A as the decoder calls it: the plan's slot pattern and
    lookahead table; the instance huffdec_kernel.scan_instance picks, or
    `instance`."""
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

    return thd.scan_segments(words, nbits, p.nblocks, p.dc_luma, p.ac_luma,
                             p.tables, p.bps, p.pattern, p.scan_lut,
                             instance, sets=p.sets)


def scan_check(torch, words, nbits, p, instance=None):
    """Phase A's kernel (the chooser's instance, or `instance`) against its
    plain version on the same rows: (bstart, err, max_abs_err, plain
    ms)."""
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

    bstart, err = scan_call(words, nbits, p, instance)
    (p_bstart, p_err), ms = once_ms(torch, lambda: thd.scan_segments_plain(
        words, nbits, p.nblocks, p.dc_luma, p.ac_luma, p.tables, p.bps,
        p.pattern))
    return bstart, err, max(diff(bstart, p_bstart), diff(err, p_err)), ms


def scan_tokens(torch, coefs, p) -> int:
    """Tokens phase A walks in a frame, counted from the frame's decoded
    coefficients (64, nseg * bps): a DC token a block, a token a nonzero
    AC coefficient, a ZRL for every 16 zeros before one, and an EOB where
    a block's last nonzero AC coefficient lies before position 63."""
    dev = coefs.device
    nseg = coefs.shape[1] // p.bps
    valid = (torch.arange(p.bps, device=dev)[None, :]
             < p.nblocks.to(dev)[:, None]).reshape(-1)
    total = 0
    for c0 in range(0, coefs.shape[1], 1 << 18):
        co = coefs[1:, c0:c0 + (1 << 18)]
        ac = co != 0
        pos = torch.arange(1, 64, device=dev, dtype=torch.int32)[:, None]
        last = torch.where(ac, pos, 0).cummax(0).values
        prev = torch.cat([torch.zeros_like(last[:1]), last[:-1]])
        zrl = torch.where(ac, (pos - prev - 1) // 16, 0).sum(0)
        per_block = 1 + ac.sum(0) + zrl + (last[-1] < 63).int()
        total += int(per_block[valid[c0:c0 + (1 << 18)]].sum())
    assert nseg * p.bps == coefs.shape[1]
    return total


def scan_times(torch, k, words, nbits, coefs, p, flush, reps=20,
               serial_reps=0) -> None:
    """Phase A's ms a launch (mean of reps) at the path's shapes into
    record k, its bytes bound (the words the segments' bits fill, four
    per-segment vectors, the tables and the lookahead table read once,
    bstart and err written once), and its tokens a launch and ns a
    token; with serial_reps, also the serial instance's ms on the same
    rows (its mean of serial_reps, serial_ms) and the instance the
    chooser took."""
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

    k["ms"] = event_ms(torch, lambda: scan_call(words, nbits, p), reps,
                       flush)
    k["instance"] = thd.scan_instance(*words.shape)
    if k["instance"] == "sync":
        k["sync_stats"] = {}
        thd.scan_segments(words, nbits, p.nblocks, p.dc_luma, p.ac_luma,
                          p.tables, p.bps, p.pattern, p.scan_lut,
                          stats=k["sync_stats"])
    if serial_reps:
        k["serial_ms"] = event_ms(
            torch, lambda: scan_call(words, nbits, p, "serial"),
            serial_reps, flush)
    nseg = words.shape[0]
    read = (stream_word_bytes(nbits) + 4 * nseg * 4 + p.tables.numel() * 4
            + p.scan_lut.numel() * 2)
    k["bound_ms"] = (read + nseg * (p.bps + 1) * 4 + nseg) \
        / PEAK_BYTES_S * 1e3
    k["tokens"] = scan_tokens(torch, coefs, p)
    k["ns_per_token"] = k["ms"] * 1e6 / k["tokens"]
    if PARENT is not None and k["instance"] == "serial":
        # the parent tree's serial instance on the same rows, then this
        # tree's again (parent, change in turns)
        got, mine = PARENT.scan(torch, words, nbits, p), scan_call(words,
                                                                   nbits, p)
        k["parent_err"] = max(diff(got[0], mine[0]), diff(got[1], mine[1]))
        if k["parent_err"]:
            raise AssertionError("phase A: the parent's serial instance "
                                 "differs from this tree's")
        k["parent_ms"] = event_ms(
            torch, lambda: PARENT.scan(torch, words, nbits, p), reps, flush)
        k["ms_again"] = event_ms(torch, lambda: scan_call(words, nbits, p),
                                 reps, flush)


def scan_resources() -> dict:
    """Phase A's serial instances as built (gj_huffdec_scan_resources),
    by table sets loaded: registers a thread, static and dynamic shared
    bytes, local (spilled) bytes a thread and CTAs an SM; given --parent,
    the parent's ptxas line of each of its serial instances."""
    import ctypes

    from gpujpeg_tpu_torch.ops import _kernels

    fn = _kernels._lib("huffdec_scan").gj_huffdec_scan_resources
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = {}
    for sets in (2, 3, 4):
        v = (ctypes.c_int * 5)()
        rc = fn(sets, ctypes.addressof(v))
        if rc:
            raise RuntimeError(f"gj_huffdec_scan_resources({sets}): {rc}")
        out[f"sets_{sets}"] = dict(zip(
            ("registers", "static_smem", "local_bytes", "dynamic_smem",
             "ctas_an_sm"), list(v)))
    if PARENT is not None:
        # ptxas prints each entry function's name, then its resources
        name = None
        for line in PARENT.build_log["huffdec_scan"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            elif "Used" in line and name and "huffdec_scan_kernel" in name:
                out[f"parent_{name}"] = line.split("ptxas info    :")[-1] \
                    .strip()
    return out


def block_call(words, bstart, p):
    """Phase C as the decoder calls it: the plan's slot pattern and
    lookahead table."""
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

    return thd.decode_blocks(words, bstart, p.nblocks, p.dc_luma, p.ac_luma,
                             p.tables, p.pattern, p.block_lut)


def block_check(torch, words, bstart, p):
    """Phase C's kernel against its plain version on the same rows:
    (coefs, err, max_abs_err, plain ms)."""
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

    coefs, err = block_call(words, bstart, p)
    (p_coefs, p_err), ms = once_ms(torch, lambda: thd.decode_blocks_plain(
        words, bstart, p.nblocks, p.dc_luma, p.ac_luma, p.tables,
        p.pattern))
    return coefs, err, max(diff(coefs, p_coefs), diff(err, p_err)), ms


def block_times(torch, k, words, nbits, bstart, p, flush, tokens,
                probe=False) -> None:
    """Phase C's ms a launch at the path's shapes into record k, its bytes
    bound (the words the segments' bits fill, bstart, four per-segment
    vectors, the tables and the lookahead table read once, the
    coefficients and err written once), and phase A's token count of the
    same frame with its ns a token; with `probe`, its decomposition
    stages too."""
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

    k["ms"] = event_ms(torch, lambda: block_call(words, bstart, p), 20,
                       flush)
    args = (words, bstart, p.nblocks, p.dc_luma, p.ac_luma, p.tables,
            p.pattern)
    if probe:
        k["probe"] = probe_ms(
            torch, lambda st: thd.decode_blocks_probe(*args, p.block_lut,
                                                      st),
            lambda: thd.decode_blocks_plain(*args), flush,
            lambda out, ref: max(diff(out[0], ref[0]),
                                 diff(out[1], ref[1])))
    nseg = words.shape[0]
    L = nseg * p.bps
    read = (stream_word_bytes(nbits) + bstart.numel() * 4 + 4 * nseg * 4
            + p.tables.numel() * 4 + p.block_lut.numel() * 4)
    k["bound_ms"] = (read + L * 64 * 2 + L * 4) / PEAK_BYTES_S * 1e3
    k["tokens"] = tokens
    k["ns_per_token"] = k["ms"] * 1e6 / tokens


class ParentKernels:
    """The kernels this tree redesigned, as the parent tree has them
    (chip_smoke.py --parent DIR, DIR the root of a checkout of the parent
    commit): its csrc/huffdec_block.cu, huffdec_scan.cu and dc_fixup.cu,
    each built by nvcc into a library of its own beside the package's
    kernels (the three at once, while the package builds), their entry
    points called with the arguments the parent's wrappers passed, never
    counted in _kernels.LAUNCHES; the parent's instances timed on the
    same inputs as this tree's, in the same call."""

    SOURCES = ("huffdec_block", "huffdec_scan", "dc_fixup")
    #: the parent's entry points whose arguments this tree changed (P
    #: pointer, q int64, i int; the stream last): gj_huffdec_scan: words,
    #: nseg, W, nbits, nblocks, dc_sel, ac_sel, bpm, dc_pat, ac_pat, table
    #: sets (2 or 4), tables, scan_lut, bps, bstart, err; gj_dc_fixup: the
    #: DC row, nseg, bps, bpm, component pattern, components, the tiles'
    #: sums (null for rows of kShortSlots or fewer), tiles.  Phase C's two
    #: take this tree's arguments (_kernels._SIGNATURES).
    ARGS = {"gj_huffdec_scan": "P q i P P P P i i i i P P i P P",
            "gj_dc_fixup": "P q q i q i P i"}

    def __init__(self, root):
        from gpujpeg_tpu_torch.ops import _kernels

        out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "gpujpeg_tpu_torch", "_build", "parent")
        os.makedirs(out, exist_ok=True)
        self.src, self.path, self.proc = {}, {}, {}
        for name in self.SOURCES:
            src = os.path.join(root, "gpujpeg_tpu_torch", "csrc",
                               f"{name}.cu")
            if not os.path.isfile(src):
                raise FileNotFoundError(f"--parent: no {src}")
            self.src[name] = src
            self.path[name] = os.path.join(out, f"lib{name}_parent.so")
            self.proc[name] = subprocess.Popen(
                [_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-o",
                 self.path[name], src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        self.lib = {}
        self.build_log = {}
        # the parent fix-up's wrapper: rows of more than kShortSlots slots
        # take tiles of kTile (kScanThreads * kPer) and a sums scratch
        with open(self.src["dc_fixup"]) as f:
            text = f.read()
        const = {k: int(re.search(rf"constexpr int {k} = (\d+);", text)
                        .group(1))
                 for k in ("kShortSlots", "kScanThreads", "kPer")}
        self.fixup_short = const["kShortSlots"]
        self.fixup_tile = const["kScanThreads"] * const["kPer"]

    def load(self):
        """Wait for the builds (started with the package's) and load
        them."""
        import ctypes
        from gpujpeg_tpu_torch.ops import _kernels

        kinds = {"P": ctypes.c_void_p, "q": ctypes.c_int64,
                 "i": ctypes.c_int}
        for name in self.SOURCES:
            text, _ = self.proc[name].communicate()
            if self.proc[name].returncode != 0:
                raise RuntimeError(f"nvcc failed for the parent's "
                                   f"{name}.cu:\n{text}")
            self.build_log[name] = text
            for line in text.splitlines():
                if "Used" in line or "spill" in line:
                    log(f"[build] parent {name}: {line.strip()}")
            self.lib[name] = ctypes.CDLL(self.path[name])
        for entry in ("huffdec_block", "huffdec_block_direct"):
            getattr(self.lib["huffdec_block"], f"gj_{entry}").argtypes = \
                _kernels._SIGNATURES[entry]
        for name, sym in (("huffdec_scan", "gj_huffdec_scan"),
                          ("dc_fixup", "gj_dc_fixup")):
            getattr(self.lib[name], sym).argtypes = [
                kinds[c] for c in self.ARGS[sym].split()] + [kinds["P"]]
        return self

    def _call(self, fn, torch, *args):
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args]
        rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's {fn.__name__} failed to "
                               f"launch: error {rc}")

    def direct(self, torch, words, nbits, p):
        """The parent's direct instance: (coefs, err)."""
        from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

        coefs, err, args = thd._direct_args(
            words, nbits, p.nblocks, p.dc_luma, p.ac_luma, p.tables,
            p.pattern, p.direct_lut)
        self._call(self.lib["huffdec_block"].gj_huffdec_block_direct, torch,
                   *args)
        return coefs, err

    def block(self, torch, words, bstart, p):
        """The parent's segment-row instance: (coefs, err)."""
        from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

        nseg, bps = words.shape[0], bstart.shape[1] - 1
        coefs = torch.empty((64, nseg * bps), dtype=torch.int16,
                            device=words.device)
        err = torch.empty(nseg * bps, dtype=torch.int32,
                          device=words.device)
        self._call(self.lib["huffdec_block"].gj_huffdec_block, torch, words,
                   nseg, words.shape[1], bstart, bps, p.nblocks, p.dc_luma,
                   p.ac_luma, *p.pattern, thd.table_sets(p.tables),
                   p.tables, p.block_lut, coefs, err)
        return coefs, err

    def scan(self, torch, words, nbits, p):
        """The parent's serial phase A (its two- or four-set instance, as
        the table count picks): (bstart, err)."""
        from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

        nseg = words.shape[0]
        bstart = torch.empty((nseg, p.bps + 1), dtype=torch.int32,
                             device=words.device)
        err = torch.empty(nseg, dtype=torch.bool, device=words.device)
        self._call(self.lib["huffdec_scan"].gj_huffdec_scan, torch, words,
                   nseg, words.shape[1], nbits, p.nblocks, p.dc_luma,
                   p.ac_luma, *p.pattern, thd.table_sets(p.tables), p.tables,
                   p.scan_lut, p.bps, bstart, err)
        return bstart, err

    def fixup(self, torch, coefs, p):
        """The parent's DC fix-up on coefs, in place, with the scratch its
        wrapper allocated a call; -> its launches (1, or 2 for rows longer
        than kShortSlots)."""
        nseg = coefs.shape[1] // p.bps
        bpm, pat, ncomp = p.comp_pattern
        tiles = -(-p.bps // self.fixup_tile) \
            if p.bps > self.fixup_short else 0
        sums = (torch.empty((nseg * tiles, 4), dtype=torch.int32,
                            device=coefs.device) if tiles else None)
        self._call(self.lib["dc_fixup"].gj_dc_fixup, torch, coefs, nseg,
                   p.bps, bpm, pat, ncomp, sums, tiles)
        return 2 if tiles else 1


#: the parent tree's redesigned kernels (ParentKernels), when
#: chip_smoke.py is given --parent DIR; else None and no parent time is
#: taken
PARENT = None


def token_paths(torch, words, nbits, p) -> dict:
    """The tokens of a direct-route frame (each segment row one block, from
    bit 0 to its bit count) by the path each takes in phase C's
    instances, replayed with the plain decode's steps (huffdec_kernel.
    _peek32, _decode_token) on the card; for DC and AC apart: "fit",
    code and value within the segment-row walk's 9-bit table
    (block_lut's value in the entry), "window", the code within it and
    the value from the bit window, "long", a code of more than 9 bits
    (its canonical decode), and "second_level", a code of more than
    DIRECT_LUT_BITS bits (the direct table's second load); "blocks" and
    the most tokens a block."""
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

    tab = p.tables.to(torch.int64)
    ns = thd.table_sets(tab)
    L = words.shape[0]
    dev = words.device
    seg = torch.arange(L, device=dev)
    zero = torch.zeros(L, dtype=torch.int64, device=dev)
    bend = nbits.to(torch.int64)
    valid = p.nblocks.to(dev) > 0
    out = {k: dict(tokens=0, fit=0, window=0, long=0, second_level=0)
           for k in ("dc", "ac")}

    def count(key, clen, size):
        c = out[key]
        c["tokens"] += int(clen.numel())
        c["fit"] += int(((clen >= 1) & (clen + size <= thd.BLOCK_LUT_BITS))
                        .sum())
        c["window"] += int(((clen <= thd.BLOCK_LUT_BITS)
                            & (clen + size > thd.BLOCK_LUT_BITS)).sum())
        c["long"] += int((clen > thd.BLOCK_LUT_BITS).sum())
        c["second_level"] += int((clen > thd.DIRECT_LUT_BITS).sum())

    live = torch.nonzero(valid)[:, 0]
    clen, sym = thd._decode_token(
        tab, thd._slot_class(p.dc_luma.to(dev)[live], p.pattern[1],
                             zero[live], 0, ns),
        thd._peek32(words, seg[live], zero[live]) >> 16)
    count("dc", clen, sym & 15)
    cur = zero.clone()
    cur[live] = clen + (sym & 15)
    per_block = valid.to(torch.int64)
    act = thd._slot_class(p.ac_luma.to(dev), p.pattern[2], zero, ns, ns)
    pos = torch.ones(L, dtype=torch.int64, device=dev)
    live = live[(clen >= 1) & (cur[live] < bend[live])]
    for _ in range(thd.MAX_AC_STEPS):
        if not live.numel():
            break
        c = cur[live]
        clen, sym = thd._decode_token(tab, act[live],
                                      thd._peek32(words, seg[live], c) >> 16)
        count("ac", clen, sym & 15)
        per_block[live] += 1
        nxt = torch.where(sym == 0, 64, torch.where(
            sym == 0xF0, pos[live] + 16, pos[live] + (sym >> 4) + 1))
        cur[live] = c + clen + (sym & 15)
        pos[live] = nxt
        live = live[(clen >= 1) & (cur[live] <= bend[live]) & (nxt < 64)]
    out["blocks"] = int(valid.sum())
    out["max_tokens_a_block"] = int(per_block.max())
    return out


def planar_encode_stages(torch, enc, frame, params, stream, tag):
    """Stage breakdown of one encode of non-interleaved scans; returns
    what the per-launch timings reuse."""
    from gpujpeg_tpu_torch.ops import fusedpack, prepost_kernel

    dev = enc.device
    geo = enc.resolve(frame, params)
    classes = enc.classes(geo.param.quality)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    pinned, pin_ms = pinned_frame(torch, frame)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    x = pinned.to(dev, non_blocking=True)
    ev[1].record()
    planes = prepost_kernel.preprocess_packed(x, geo, geo.param_image)
    ev[2].record()
    coefs = [fusedpack.fdct_quant(planes[c.index], classes[c.table_index],
                                  c.segment_mcu_count)
             for c in geo.components]
    ev[3].record()
    rows, rbs = [], []
    for c, co in zip(geo.components, coefs):
        r, rb, _ = fusedpack.huffman_segments(co, c.mcu_count,
                                              classes[c.table_index])
        rows.append(r)
        rbs.append(rb)
    ev[4].record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = enc.assemble(geo, {"rows": rows, "row_bytes": rbs})
    t2 = time.perf_counter()
    if out != stream:
        raise AssertionError(f"stage-by-stage {tag} encode differs from "
                             "encode()")
    stages = dict(pin_copy_host_ms=pin_ms,
                  h2d_ms=ev[0].elapsed_time(ev[1]),
                  pre_ms=ev[1].elapsed_time(ev[2]),
                  fdct_3_planes_ms=ev[2].elapsed_time(ev[3]),
                  huffman_3_planes_ms=ev[3].elapsed_time(ev[4]),
                  device_wall_ms=(t1 - t0) * 1e3,
                  assemble_d2h_host_ms=(t2 - t1) * 1e3)
    log(f"[{tag}] stages (CUDA events; assembly on the host clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return x, planes, coefs, rows, rbs


def dpost_decode_stages(torch, np, dec, data, tag):
    """Stage breakdown of one decode through dpost_rgb; returns what the
    per-launch timings reuse."""
    from gpujpeg_tpu_torch.models import decoder as tdec
    from gpujpeg_tpu_torch.ops import prepost_kernel

    dev = dec.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hf = dec.prepare(data)
    t1 = time.perf_counter()
    p = hf.plan
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    host = pinned_image(torch, hf.out_pi)
    ev[0].record()
    words, nbits = dec.upload(hf)
    ev[1].record()
    bstart, _ea = scan_call(words, nbits, p)
    ev[2].record()
    coefs, _ec = block_call(words, bstart, p)
    ev[3].record()
    coefs = tdec.dc_fixup(coefs, p)
    ev[4].record()
    img = prepost_kernel.decode_post(coefs, p.qtabs, p.geo, hf.out_pi)
    ev[5].record()
    host.copy_(img)
    ev[6].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not np.array_equal(host.numpy(), dec.decode(data)):
        raise AssertionError(f"stage-by-stage {tag} decode differs from "
                             "decode()")
    stages = dict(parse_unstuff_host_ms=(t1 - t0) * 1e3,
                  h2d_words_ms=ev[0].elapsed_time(ev[1]),
                  scan_ms=ev[1].elapsed_time(ev[2]),
                  block_ms=ev[2].elapsed_time(ev[3]),
                  dc_fixup_ms=ev[3].elapsed_time(ev[4]),
                  dpost_ms=ev[4].elapsed_time(ev[5]),
                  d2h_image_ms=ev[5].elapsed_time(ev[6]),
                  device_wall_ms=(t2 - t1) * 1e3)
    log(f"[{tag}] stages (parse + unstuff on the host clock, the rest CUDA "
        f"events; {words.numel() * 4} B of words, {img.numel()} B of "
        "pixels): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return words, nbits, bstart, coefs, img, p, hf


def decode_phases(torch, np, gt, dev, streams, frames, noise_stream,
                  flush):
    """Step 6; returns (kernel records, launches over the main path)."""
    from gpujpeg_tpu_torch.models import decoder as tdec
    from gpujpeg_tpu_torch.ops import _kernels, prepost_kernel

    dec = gt.Decoder(device=dev)
    kernels = {
        "huffdec_scan": dict(
            source="gpujpeg_tpu_torch/csrc/huffdec_scan.cu",
            replaces="gpujpeg_tpu/ops/huffdec_kernel.py:590",
            bound_by="bytes", library_ms=None, err=0),
        "huffdec_block": dict(
            source="gpujpeg_tpu_torch/csrc/huffdec_block.cu",
            replaces="gpujpeg_tpu/ops/huffdec_kernel.py:283",
            bound_by="bytes", library_ms=None, err=0),
        "dpost_rgb": dict(
            source="gpujpeg_tpu_torch/csrc/dpost_rgb.cu",
            replaces="gpujpeg_tpu/ops/prepost_kernel.py:379",
            bound_by="operations", err=0),
    }

    def inputs(hf):
        p = hf.plan
        words = torch.from_numpy(hf.words).to(dev)
        nbits = torch.from_numpy(hf.nbits).to(dev)
        return p, words, nbits

    def record_err(name, err, what):
        kernels[name]["err"] = max(kernels[name]["err"], err)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({what})")

    # -- a. kernels against their plain versions at 8K ---------------------
    for what, data in (("gradient", streams[0]), ("noise", noise_stream)):
        hf = dec.prepare(data)
        p, words, nbits = inputs(hf)
        bstart, err_a, err, ms_a = scan_check(torch, words, nbits, p)
        record_err("huffdec_scan", err, what)
        coefs, err_c, err, ms_c = block_check(torch, words, bstart, p)
        record_err("huffdec_block", err, what)
        if bool(err_a.any()) or bool(err_c.any()):
            raise AssertionError(f"8K {what} stream decodes with errors")
        coefs = tdec.dc_fixup(coefs, p)
        geo, pi = p.geo, hf.out_pi
        img = prepost_kernel.decode_post(coefs, p.qtabs, geo, pi)
        p_img, ms_d = once_ms(
            torch, lambda: prepost_kernel.decode_post_plain(coefs, p.qtabs,
                                                            geo, pi))
        record_err("dpost_rgb", int((img.int() - p_img.int()).abs().max()),
                   what)
        if what == "gradient":
            kernels["huffdec_scan"]["plain_ms"] = ms_a
            kernels["huffdec_block"]["plain_ms"] = ms_c
            kernels["dpost_rgb"]["plain_ms"] = ms_d
        log(f"[dec kernels] 8K {what}: scan, block, dpost equal to plain; "
            f"{words.shape[0]} segments x {words.shape[1]} words, "
            f"{coefs.shape[1]} block slots; plain ms {ms_a:.1f} / "
            f"{ms_c:.1f} / {ms_d:.1f}")
        del coefs, img, p_img, words, bstart

    # -- b. HD pixels: card == CPU -----------------------------------------
    hd = make_frame(torch, "gradient", 22, 1080, 1920, dev).cpu().numpy()
    hd_stream = gt.Encoder(device="cpu").encode(hd, gt.Parameters(
        quality=QUALITY, restart_interval=gt.RESTART_AUTO))
    got = dec.decode(hd_stream)
    if not np.array_equal(got, gt.Decoder(device="cpu").decode(hd_stream)):
        raise AssertionError("HD decode on the card differs from the CPU")
    log(f"[dec hd] 1920x1080 Q75 {len(hd_stream)} bytes: card == cpu, "
        f"PSNR {psnr(np, got, hd):.2f} dB")

    # -- c. main path: the three 8K streams through Decoder.decode ---------
    torch.cuda.synchronize()
    _kernels.reset_launches()
    walls, psnrs = [], []
    for data, f in zip(streams, frames):
        t0 = time.perf_counter()
        out = dec.decode(data)
        walls.append((time.perf_counter() - t0) * 1e3)
        if out.shape != f.shape or out.dtype != np.uint8:
            raise AssertionError(f"8K decode gave {out.shape} {out.dtype}")
        psnrs.append(psnr(np, out, f))
    end_window()
    launches = {n: _kernels.LAUNCHES[n] for n in kernels}
    for name, n in {**launches, "dc_fixup": _kernels.LAUNCHES["dc_fixup"]
                    }.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "decode main path")
    if min(psnrs) < 20:
        raise AssertionError(f"8K decode PSNR {psnrs} dB: not the frames")
    log(f"[dec 8k] {len(streams)} streams 7680x4320 Q75: PSNR vs source "
        + ", ".join(f"{v:.2f}" for v in psnrs) + f" dB, launches {launches}")
    for i in range(EXTRA_FRAMES):
        t0 = time.perf_counter()
        dec.decode(streams[i % 3])
        walls.append((time.perf_counter() - t0) * 1e3)
    log("[dec 8k] wall ms per frame (bytes in, host array out), "
        + quartiles(np, walls))

    # stage breakdown of one more frame
    words, nbits, bstart, coefs, img, p, hf = dpost_decode_stages(
        torch, np, dec, streams[0], "dec 8k")

    # -- d. per-kernel times at the main path's shapes ---------------------
    scan_times(torch, kernels["huffdec_scan"], words, nbits, coefs, p, flush)
    block_times(torch, kernels["huffdec_block"], words, nbits, bstart, p,
                flush, kernels["huffdec_scan"]["tokens"], probe=True)
    dpost_times(torch, kernels["dpost_rgb"], coefs, img, p, hf, flush)
    log_times("dec time", kernels)
    return kernels, launches


def dpost_times(torch, k, coefs, img, p, hf, flush, probe=True) -> None:
    """dpost_rgb's time, bound and library yardstick at the path's shapes,
    into record k, and its decomposition stages unless probe is False
    (the probe's stages store RGB only)."""
    from gpujpeg_tpu_torch.ops import prepost_kernel

    k["ms"] = event_ms(torch, lambda: prepost_kernel.decode_post(
        coefs, p.qtabs, p.geo, hf.out_pi), 20, flush)
    if probe:
        k["probe"] = probe_ms(
            torch, lambda st: prepost_kernel.decode_post_probe(
                coefs, p.qtabs, p.geo, hf.out_pi, st),
            lambda: prepost_kernel.decode_post_plain(coefs, p.qtabs, p.geo,
                                                     hf.out_pi), flush)
    cols = prepost_kernel.component_columns(p.geo)
    nblk = sum(n for _, n in cols)        # each chroma sample counted once
    k["bound_ms"] = max(
        2 * 64 * 64 * nblk / PEAK_F32_FLOP_S,
        (nblk * 64 * 2 + img.numel() + 3 * 64 * 4 + 64 * 64 * 4)
        / PEAK_BYTES_S) * 1e3
    # yardstick: one f32 product of each component's dequantized (blocks,
    # 64) coefficients by the IDCT matrix (TF32 off); timed here only,
    # never called by the port
    nmat = prepost_kernel.idct_matrix(coefs.device)
    ys = [(coefs[:, f0:f0 + n].T.float() * p.qtabs[c]).contiguous()
          for c, (f0, n) in enumerate(cols)]
    k["library_ms"] = event_ms(
        torch, lambda: [torch.matmul(y, nmat) for y in ys], 10, flush)


#: the MCU-order DCT (fdct_quant's interleaved output map) over the two
#: interleaved paths: error against interleaved_rows_plain, launches in
#: the encode windows, and per path the times of one interleaved_rows
#: (three launches)
MCU_ORDER = {"err": 0, "launches": 0, "ms": [], "plain_ms": [],
             "planar_ms": [], "bound_ms": []}


def mcu_order_check(torch, planes, geo, classes, rows_in, what) -> float:
    """interleaved_rows (three fdct_quant launches storing MCU order) on
    the card against its plain version on the same planes; returns the
    plain version's ms."""
    from gpujpeg_tpu_torch.ops import fusedpack

    ref, ms = once_ms(torch, lambda: fusedpack.interleaved_rows_plain(
        planes, geo, classes))
    err = diff(rows_in, ref)
    MCU_ORDER["err"] = max(MCU_ORDER["err"], err)
    if err:
        raise AssertionError(f"fdct_quant:mcu_order differs from its plain "
                             f"version ({what})")
    return ms


def mcu_order_times(torch, planes, geo, classes, flush, plain_ms,
                    tag) -> None:
    """Times of the MCU-order DCT at the path's shapes beside the planar
    store's three launches on the same planes (raster order, no MCU copy)
    and its bound, into MCU_ORDER."""
    from gpujpeg_tpu_torch.ops import fusedpack

    ms = event_ms(torch, lambda: fusedpack.interleaved_rows(
        planes, geo, classes), 20, flush)
    planar = event_ms(torch, lambda: [fusedpack.fdct_quant(
        planes[c.index], classes[c.table_index], 1)
        for c in geo.components], 20, flush)
    samples = sum(p_.numel() for p_ in planes)       # one per coefficient
    out_bytes = (geo.segment_count * geo.segment_mcu_count
                 * geo.blocks_per_mcu * 128)
    bound = max(2 * 64 * samples / PEAK_F32_FLOP_S,
                (samples + out_bytes + 3 * 64 * 65 * 4) / PEAK_BYTES_S) * 1e3
    for key, v in (("ms", ms), ("planar_ms", planar), ("bound_ms", bound),
                   ("plain_ms", plain_ms)):
        MCU_ORDER[key].append(v)
    log(f"[{tag}] fdct_quant:mcu_order: {ms:.4f} ms for the 3 launches "
        f"into MCU order ({out_bytes} B), planar store of the same planes "
        f"{planar:.4f} ms, bound {bound:.4f} ms (operations), plain "
        f"{plain_ms:.3f} ms")


def idct_planes_check(torch, coefs, p, planes, record) -> float:
    """Hold one idct_planes launch's planes against the plain version of
    each component (record(error) raises on a difference); returns the
    plain versions' summed ms."""
    from gpujpeg_tpu_torch.ops import prepost_kernel

    ms_plain = 0.0
    for c, got in zip(p.geo.components, planes):
        ref, ms = once_ms(torch, lambda: prepost_kernel.idct_planes_plain(
            coefs, p.qtabs[c.index], p.geo, c))
        record(diff(got, ref))
        ms_plain += ms
    return ms_plain


def idct_planes_times(torch, k, coefs, p, flush) -> None:
    """ms of the one idct_planes launch of a frame, its bound and the
    summed torch.matmul yardstick of the components it covers, into record
    k."""
    from gpujpeg_tpu_torch.ops import prepost_kernel

    dev = coefs.device
    k["ms"] = event_ms(torch, lambda: prepost_kernel.idct_planes(
        coefs, p.qtabs, p.geo), 20, flush)
    nmat = prepost_kernel.idct_matrix(dev)
    lib, nblk = 0.0, 0
    for c in p.geo.components:
        # yardstick: one f32 product of the component's dequantized
        # (blocks, 64) coefficients by the IDCT matrix (TF32 off); timed
        # here only, never called by the port
        cols = prepost_kernel.block_columns(p.geo, c, dev)
        y = (coefs[:, cols].T.float() * p.qtabs[c.index]).contiguous()
        lib += event_ms(torch, lambda: torch.matmul(y, nmat), 10, flush)
        nblk += cols.numel()
        del y, cols
    k["library_ms"] = lib
    k["bound_ms"] = max(
        2 * 64 * 64 * nblk / PEAK_F32_FLOP_S,
        (nblk * 64 * 2 + nblk * 64 + p.qtabs.numel() * 4 + 64 * 64 * 4)
        / PEAK_BYTES_S) * 1e3


def interleaved_phases(torch, np, gt, dev, flush):
    """Step 7, the interleaved 4:2:0 path; returns (kernel records,
    launches over its main path).  Records of a new mode of an older
    kernel are named kernel:mode and count that kernel's launches."""
    from gpujpeg_tpu_torch.models import decoder as tdec
    from gpujpeg_tpu_torch.ops import _kernels, fusedpack, prepost_kernel

    params = gt.Parameters(
        quality=QUALITY, restart_interval=gt.RESTART_AUTO,
        interleaved=True).chroma_subsampled(((2, 2), (1, 1), (1, 1)))
    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    classes = enc.classes(QUALITY)
    kernels = {
        "pre_rgb_to_planes:decimate": dict(
            key="pre_rgb_to_planes",
            source="gpujpeg_tpu_torch/csrc/pre_rgb_to_planes.cu",
            replaces="gpujpeg_tpu/ops/prepost_kernel.py:88",
            bound_by="bytes", library_ms=None, err=0),
        "huffman_segments:pattern_420": dict(
            key="huffman_segments",
            source="gpujpeg_tpu_torch/csrc/huffman_segments.cu",
            # the megakernel's interleaved mode; the JAX package sends
            # 4:2:0 to XLA tokens and its deep-stuff kernel instead
            replaces="gpujpeg_tpu/ops/fusedpack.py:928",
            bound_by="bytes", library_ms=None, err=0),
        "pack_stuff_rows": dict(
            source="gpujpeg_tpu_torch/csrc/pack_stuff_rows.cu",
            replaces="gpujpeg_tpu/ops/fusedpack.py:107",
            bound_by="bytes", library_ms=None, err=0,
            note="on no tuned encode path (huffman_segments codes every "
                 "tuned scan); checked here on the plain tokenizer's 8K "
                 "4:2:0 token rows of the tuned tables; the Annex-K paths "
                 "run it (records pack_stuff_rows:annexk_*)"),
        "huffdec_scan:pattern": dict(
            key="huffdec_scan",
            source="gpujpeg_tpu_torch/csrc/huffdec_scan.cu",
            replaces="gpujpeg_tpu/ops/huffdec_kernel.py:590",
            bound_by="bytes", library_ms=None, err=0),
        "huffdec_block:pattern": dict(
            key="huffdec_block",
            source="gpujpeg_tpu_torch/csrc/huffdec_block.cu",
            replaces="gpujpeg_tpu/ops/huffdec_kernel.py:283",
            bound_by="bytes", library_ms=None, err=0),
        "idct_planes": dict(
            source="gpujpeg_tpu_torch/csrc/idct_planes.cu",
            # no pallas_call: the JAX package's XLA interleaved tail
            replaces="gpujpeg_tpu/models/decoder.py:305",
            bound_by="operations", err=0),
        "post_rgb": dict(
            source="gpujpeg_tpu_torch/csrc/post_rgb.cu",
            replaces="gpujpeg_tpu/ops/prepost_kernel.py:231",
            bound_by="bytes", library_ms=None, err=0),
    }

    def record_err(name, err, what):
        kernels[name]["err"] = max(kernels[name]["err"], err)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({what}, 4:2:0)")

    # -- a. kernels and modes against their plain versions at 8K -----------
    for fkind, seed in (("gradient", 31), ("noise", 32)):
        frame = make_frame(torch, fkind, seed, H8K, W8K, dev)
        geo = enc.resolve(frame, params)
        pi = geo.param_image
        planes = prepost_kernel.preprocess_packed(frame, geo, pi)
        ref, ms_pre = once_ms(
            torch, lambda: prepost_kernel.preprocess_packed_plain(frame, geo,
                                                                  pi))
        record_err("pre_rgb_to_planes:decimate",
                   max(diff(a, b) for a, b in zip(planes, ref)), fkind)
        del ref
        rows_in = fusedpack.interleaved_rows(planes, geo, classes)
        ms_mcu = mcu_order_check(torch, planes, geo, classes, rows_in,
                                 f"4:2:0 {fkind}")
        if fkind == "gradient":
            mcu_plain_ms = ms_mcu
        del planes
        st = fusedpack.interleaved_slots(geo, classes)
        nblocks = geo.mcu_count * geo.blocks_per_mcu
        markers = fusedpack.segment_markers(geo.segment_count, dev)
        rows, rb, needs = fusedpack.huffman_segments(rows_in, nblocks, st,
                                                     markers)
        p_out, ms_huff = once_ms(
            torch, lambda: fusedpack.huffman_segments_plain(
                rows_in, nblocks, st, markers))
        record_err("huffman_segments:pattern_420",
                   rows_err(torch, rows, rb, needs, *p_out), fkind)
        del p_out
        # pack_stuff_rows on the same rows' tokens from the plain tokenizer
        bits, lens = token_rows(torch, rows_in, st)
        stride = st.stride(rows_in.shape[1] // 64)
        err, ms_pack, p_bytes = pack_check(torch, bits, lens, markers,
                                           stride, (rows, rb, needs))
        record_err("pack_stuff_rows", err, fkind)
        if fkind == "gradient":
            pack_in = (bits, lens, markers, stride, p_bytes)
        del bits, lens
        data = enc.assemble(geo, {"rows": [rows], "row_bytes": [rb]})
        del rows
        hf = dec.prepare(data)
        p = hf.plan
        words = torch.from_numpy(hf.words).to(dev)
        nbits = torch.from_numpy(hf.nbits).to(dev)
        bstart, err_a, err, ms_a = scan_check(torch, words, nbits, p)
        record_err("huffdec_scan:pattern", err, fkind)
        coefs, err_c, err, ms_c = block_check(torch, words, bstart, p)
        record_err("huffdec_block:pattern", err, fkind)
        if bool(err_a.any()) or bool(err_c.any()):
            raise AssertionError(f"8K 4:2:0 {fkind} stream decodes with "
                                 "errors")
        del words
        coefs = tdec.dc_fixup(coefs, p)
        dplanes = prepost_kernel.idct_planes(coefs, p.qtabs, p.geo)
        ms_i = idct_planes_check(torch, coefs, p, dplanes,
                                 lambda e: record_err("idct_planes", e,
                                                      fkind))
        img = prepost_kernel.postprocess_packed(dplanes, p.geo, hf.out_pi)
        ref, ms_p = once_ms(
            torch, lambda: prepost_kernel.postprocess_packed_plain(dplanes,
                                                                   p.geo,
                                                                   hf.out_pi))
        record_err("post_rgb", diff(img, ref), fkind)
        if fkind == "gradient":
            for name, ms in (("pre_rgb_to_planes:decimate", ms_pre),
                             ("huffman_segments:pattern_420", ms_huff),
                             ("pack_stuff_rows", ms_pack),
                             ("huffdec_scan:pattern", ms_a),
                             ("huffdec_block:pattern", ms_c),
                             ("idct_planes", ms_i), ("post_rgb", ms_p)):
                kernels[name]["plain_ms"] = ms
        log(f"[il kernels] 8K 4:2:0 {fkind}: pre, fdct (MCU order), huffman "
            f"(pattern), pack (plain tokens), scan, block, idct, post equal "
            f"to plain; "
            f"{len(data)} B, {geo.segment_count} segments of {p.bps} "
            f"blocks, max row {int(needs[1])} B, stuffed zeros <= "
            f"{int(needs[0])}, stride {stride} B, PSNR "
            f"{psnr(np, img.cpu().numpy(), frame.cpu().numpy()):.2f} dB")
        del coefs, dplanes, img, ref, frame, rows_in

    # -- b. HD: card == CPU, bytes and pixels --------------------------------
    hd_check(torch, np, gt, dev, params, 23, "il 4:2:0")

    # -- c. main path: three 8K frames, encode then decode -------------------
    frames = [make_frame(torch, "gradient", 200 + i, H8K, W8K, dev)
              .cpu().numpy() for i in range(3)]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    walls, streams = [], []
    for f in frames:
        t0 = time.perf_counter()
        out = enc.encode(f, params)
        walls.append((time.perf_counter() - t0) * 1e3)
        streams.append(out)
    end_window()
    launches = {n: _kernels.LAUNCHES[n] for n in (
        "pre_rgb_to_planes", "fdct_quant", "huffman_segments")}
    pre_once_a_frame(launches, len(frames), "il 4:2:0")
    MCU_ORDER["launches"] += launches["fdct_quant"]
    if _kernels.LAUNCHES["pack_stuff_rows"]:
        raise AssertionError("the 4:2:0 encode went through pack_stuff_rows")
    launches["pack_stuff_rows"] = 0
    geo = enc.resolve(frames[0], params)
    for out in streams:
        check_stream(np, out, geo.segment_count - 1, "8K 4:2:0")
    log(f"[il 8k enc] 3 frames 7680x4320 4:2:0 Q75 rst "
        f"{geo.param.restart_interval} MCU: bytes "
        f"{[len(s) for s in streams]}, segments {geo.segment_count}, RST "
        f"markers ok, launches {launches}")
    for i in range(EXTRA_FRAMES):
        t0 = time.perf_counter()
        enc.encode(frames[i % 3], params)
        walls.append((time.perf_counter() - t0) * 1e3)
    log("[il 8k enc] wall ms per frame (host frame in, bytes out), "
        + quartiles(np, walls))

    f = frames[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    pinned, pin_ms = pinned_frame(torch, f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    x = pinned.to(dev, non_blocking=True)
    ev[1].record()
    planes = prepost_kernel.preprocess_packed(x, geo, geo.param_image)
    ev[2].record()
    rows_in = fusedpack.interleaved_rows(planes, geo, classes)
    ev[3].record()
    st = fusedpack.interleaved_slots(geo, classes)
    nblocks = geo.mcu_count * geo.blocks_per_mcu
    markers = fusedpack.segment_markers(geo.segment_count, dev)
    rows, rb, _ = fusedpack.huffman_segments(rows_in, nblocks, st, markers)
    ev[4].record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = enc.assemble(geo, {"rows": [rows], "row_bytes": [rb]})
    t2 = time.perf_counter()
    if out != streams[0]:
        raise AssertionError("stage-by-stage 4:2:0 encode differs from "
                             "encode()")
    stages = dict(pin_copy_host_ms=pin_ms,
                  h2d_ms=ev[0].elapsed_time(ev[1]),
                  pre_ms=ev[1].elapsed_time(ev[2]),
                  fdct_reorder_3_planes_ms=ev[2].elapsed_time(ev[3]),
                  huffman_pattern_ms=ev[3].elapsed_time(ev[4]),
                  device_wall_ms=(t1 - t0) * 1e3,
                  assemble_d2h_host_ms=(t2 - t1) * 1e3)
    log("[il 8k enc] stages (CUDA events; assembly on the host clock; "
        f"{rows_in.numel() * 2} B of coefficients in MCU order): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # per-launch times of the encode side at the path's shapes (frame 0)
    kernels["pre_rgb_to_planes:decimate"]["ms"] = event_ms(
        torch, lambda: prepost_kernel.preprocess_packed(
            x, geo, geo.param_image), 20, flush)       # 1 launch a frame
    kernels["huffman_segments:pattern_420"]["ms"] = event_ms(
        torch, lambda: fusedpack.huffman_segments(rows_in, nblocks, st,
                                                  markers), 10, flush)
    probe = probe_ms(
        torch, lambda stage: fusedpack.huffman_segments_probe(
            rows_in, nblocks, st, stage, markers),
        lambda: fusedpack.huffman_segments_plain(rows_in, nblocks, st,
                                                 markers), flush)
    # the same rows with every coefficient 0 (a DC and an EOB a block):
    # the coder's cost a row and a block that does not depend on the data
    zeros = torch.zeros_like(rows_in)
    probe["full_zero_coefficients"] = event_ms(
        torch, lambda: fusedpack.huffman_segments(zeros, nblocks, st,
                                                  markers), 10, flush)
    kernels["huffman_segments:pattern_420"]["probe"] = probe
    del zeros
    mcu_order_times(torch, planes, geo, classes, flush, mcu_plain_ms,
                    "il time")
    pack_times(torch, kernels["pack_stuff_rows"], *pack_in, flush)
    pl_bytes = sum(p_.numel() for p_ in planes)
    kernels["pre_rgb_to_planes:decimate"]["bound_ms"] = (
        x.numel() + pl_bytes) / PEAK_BYTES_S * 1e3
    kernels["huffman_segments:pattern_420"]["bound_ms"] = huffman_bound_ms(
        rows_in, rb)
    del rows, rows_in, planes, x, pack_in

    # decode of the three streams
    torch.cuda.synchronize()
    _kernels.reset_launches()
    dwalls, psnrs = [], []
    for data, f in zip(streams, frames):
        t0 = time.perf_counter()
        out = dec.decode(data)
        dwalls.append((time.perf_counter() - t0) * 1e3)
        if out.shape != f.shape or out.dtype != np.uint8:
            raise AssertionError(f"8K 4:2:0 decode gave {out.shape} "
                                 f"{out.dtype}")
        psnrs.append(psnr(np, out, f))
    end_window()
    launches.update({n: _kernels.LAUNCHES[n] for n in (
        "huffdec_scan", "huffdec_block", "dc_fixup", "idct_planes",
        "post_rgb")})
    if _kernels.LAUNCHES["dpost_rgb"]:
        raise AssertionError("the 4:2:0 decode went through dpost_rgb")
    for name, n in launches.items():
        if n <= 0 and name != "pack_stuff_rows":
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "4:2:0 path")
    if min(psnrs) < 20:
        raise AssertionError(f"8K 4:2:0 decode PSNR {psnrs} dB")
    log(f"[il 8k dec] 3 streams: PSNR vs source "
        + ", ".join(f"{v:.2f}" for v in psnrs) + f" dB, launches {launches}")
    for i in range(EXTRA_FRAMES):
        t0 = time.perf_counter()
        dec.decode(streams[i % 3])
        dwalls.append((time.perf_counter() - t0) * 1e3)
    log("[il 8k dec] wall ms per frame (bytes in, host array out), "
        + quartiles(np, dwalls))

    bstart, coefs, dplanes, img, words, nbits, p, hf = decode_stages(
        torch, np, dec, streams[0], "il 4:2:0")

    # -- d. per-launch times of the decode side at the path's shapes -------
    scan_times(torch, kernels["huffdec_scan:pattern"], words, nbits, coefs,
               p, flush)
    block_times(torch, kernels["huffdec_block:pattern"], words, nbits,
                bstart, p, flush, kernels["huffdec_scan:pattern"]["tokens"],
                probe=True)
    idct_planes_times(torch, kernels["idct_planes"], coefs, p, flush)
    kernels["post_rgb"]["ms"] = event_ms(
        torch, lambda: prepost_kernel.postprocess_packed(
            dplanes, p.geo, hf.out_pi), 20, flush)
    kernels["post_rgb"]["bound_ms"] = (
        sum(d.numel() for d in dplanes) + img.numel()) / PEAK_BYTES_S * 1e3
    log_times("il time", kernels)
    return kernels, {name: launches[k.get("key", name)]
                     for name, k in kernels.items()}


def main_path_8k(torch, np, gt, dev, enc, dec, params, seed0, what,
                 enc_kernels, dec_kernels, forbidden, extra=EXTRA_FRAMES):
    """Three seeded 8K frames through Encoder.encode, then their streams
    through Decoder.decode, launch counts read over each; checks SOI/EOI,
    the RST count, the PSNR, that every kernel named was launched and no
    forbidden one was, and prints the wall ms of those and `extra`
    more.  Returns (launches, frames, streams)."""
    from gpujpeg_tpu_torch.ops import _kernels

    frames = [make_frame(torch, "gradient", seed0 + i, H8K, W8K, dev)
              .cpu().numpy() for i in range(3)]
    geo = enc.resolve(frames[0], params)
    launches = {}
    for stage, names in (("enc", enc_kernels), ("dec", dec_kernels)):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        walls, outs = [], []
        for i, f in enumerate(frames):
            t0 = time.perf_counter()
            outs.append(enc.encode(f, params) if stage == "enc"
                        else dec.decode(streams[i]))
            walls.append((time.perf_counter() - t0) * 1e3)
        end_window()
        launches.update({n: _kernels.LAUNCHES[n] for n in names})
        for n in names:
            if launches[n] <= 0:
                raise AssertionError(f"kernel {n} was not launched on the "
                                     f"{what} path")
        if stage == "enc":
            pre_once_a_frame(launches, len(frames), what)
        for n in forbidden:
            if _kernels.LAUNCHES[n]:
                raise AssertionError(f"the {what} {stage} went through {n}")
        if stage == "enc":
            streams = outs
            for out in streams:
                check_stream(np, out, geo.segment_count - geo.scan_count,
                             f"8K {what}")
            log(f"[{what} 8k enc] 3 frames 7680x4320 Q75 rst "
                f"{geo.param.restart_interval}: bytes "
                f"{[len(s_) for s_ in streams]}, segments "
                f"{geo.segment_count} in {geo.scan_count} scan(s), RST "
                f"markers ok, launches {launches}")
        else:
            psnrs = [psnr(np, o, f) for o, f in zip(outs, frames)]
            if any(o.shape != f.shape for o, f in zip(outs, frames)) \
                    or min(psnrs) < 20:
                raise AssertionError(f"8K {what} decode: PSNR {psnrs} dB")
            log(f"[{what} 8k dec] 3 streams: PSNR vs source "
                + ", ".join(f"{v:.2f}" for v in psnrs)
                + f" dB, launches {launches}, instances "
                f"{dict(_kernels.INSTANCES)}")
        for i in range(extra):
            t0 = time.perf_counter()
            if stage == "enc":
                enc.encode(frames[i % 3], params)
            else:
                dec.decode(streams[i % 3])
            walls.append((time.perf_counter() - t0) * 1e3)
        log(f"[{what} 8k {stage}] wall ms per frame ("
            + ("host frame in, bytes out" if stage == "enc"
               else "bytes in, host array out") + "), "
            + quartiles(np, walls))
    return launches, frames, streams


def il444_phases(torch, np, gt, dev, flush):
    """Step 8, the interleaved 4:4:4 path (one scan, Q75, restart auto = 2
    MCUs a segment); returns (kernel records, launches over its main
    path)."""
    from gpujpeg_tpu_torch.ops import fusedpack, prepost_kernel

    params = gt.Parameters(quality=QUALITY, restart_interval=gt.RESTART_AUTO,
                           interleaved=True)
    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    classes = enc.classes(QUALITY)
    kernels = {
        "pre_rgb_to_planes:il_444": dict(
            key="pre_rgb_to_planes",
            source="gpujpeg_tpu_torch/csrc/pre_rgb_to_planes.cu",
            replaces="gpujpeg_tpu/ops/prepost_kernel.py:88",
            bound_by="bytes", library_ms=None, err=0),
        "huffman_segments:pattern": dict(
            key="huffman_segments",
            source="gpujpeg_tpu_torch/csrc/huffman_segments.cu",
            replaces="gpujpeg_tpu/ops/fusedpack.py:928",
            bound_by="bytes", library_ms=None, err=0),
        "huffman_segments:coefs": dict(
            key="huffman_segments",
            source="gpujpeg_tpu_torch/csrc/huffman_segments.cu",
            replaces="gpujpeg_tpu/ops/fusedpack.py:1006",
            bound_by="bytes", library_ms=None, err=0,
            note="coefficient-input mode: no codec path calls it (in the "
                 "JAX package only tools/profile_stages.py and its tests "
                 "do); launches counted on the 4:4:4 interleaved path, "
                 "which runs the same kernel"),
        "idct_planes:444": dict(
            key="idct_planes",
            source="gpujpeg_tpu_torch/csrc/idct_planes.cu",
            # no pallas_call: the JAX package's XLA interleaved tail
            replaces="gpujpeg_tpu/models/decoder.py:305",
            bound_by="operations", err=0),
        "huffdec_scan:pattern_444": dict(
            key="huffdec_scan",
            source="gpujpeg_tpu_torch/csrc/huffdec_scan.cu",
            replaces="gpujpeg_tpu/ops/huffdec_kernel.py:590",
            bound_by="bytes", library_ms=None, err=0),
        "huffdec_block:pattern_444": dict(
            key="huffdec_block",
            source="gpujpeg_tpu_torch/csrc/huffdec_block.cu",
            replaces="gpujpeg_tpu/ops/huffdec_kernel.py:283",
            bound_by="bytes", library_ms=None, err=0),
        "post_rgb:444": dict(
            key="post_rgb",
            source="gpujpeg_tpu_torch/csrc/post_rgb.cu",
            replaces="gpujpeg_tpu/ops/prepost_kernel.py:231",
            bound_by="bytes", library_ms=None, err=0),
    }

    def record_err(name, err, what):
        kernels[name]["err"] = max(kernels[name]["err"], err)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({what}, 4:4:4 interleaved)")

    def coefs_mode_inputs(planes, geo):
        """The three planes' coefficients as segment rows of 8 blocks with
        a class flag a row, one interior masked block and a zero marker
        mid-scan (the megakernel's coefficient-input contract)."""
        rows, luma, marks = [], [], []
        for c in geo.components:
            co = fusedpack.fdct_quant(planes[c.index],
                                      classes[c.table_index], 8)
            rows.append(co)
            luma.append(torch.full((co.shape[0],), int(c.table_index == 0),
                                   dtype=torch.int32, device=dev))
            marks.append(fusedpack.segment_markers(co.shape[0], dev))
        rows, luma = torch.cat(rows), torch.cat(luma)
        marks = torch.cat(marks)
        marks[marks.shape[0] // 2] = 0
        valid = torch.ones((rows.shape[0], 8), dtype=torch.bool, device=dev)
        valid[rows.shape[0] // 3, 5] = False
        return rows, valid, luma, marks

    # -- a. the two new modes against their plain versions at 8K ------------
    for fkind, seed in (("gradient", 41), ("noise", 42)):
        frame = make_frame(torch, fkind, seed, H8K, W8K, dev)
        geo = enc.resolve(frame, params)
        planes = prepost_kernel.preprocess_packed(frame, geo,
                                                  geo.param_image)
        ref, ms_pre = once_ms(
            torch, lambda: prepost_kernel.preprocess_packed_plain(
                frame, geo, geo.param_image))
        record_err("pre_rgb_to_planes:il_444",
                   max(diff(a, b) for a, b in zip(planes, ref)), fkind)
        del ref
        rows_in = fusedpack.interleaved_rows(planes, geo, classes)
        ms_mcu = mcu_order_check(torch, planes, geo, classes, rows_in,
                                 f"4:4:4 interleaved {fkind}")
        if fkind == "gradient":
            mcu_plain_ms = ms_mcu
        st = fusedpack.interleaved_slots(geo, classes)
        nblocks = geo.mcu_count * geo.blocks_per_mcu
        markers = fusedpack.segment_markers(geo.segment_count, dev)
        k_out = fusedpack.huffman_segments(rows_in, nblocks, st, markers)
        p_out, ms_pat = once_ms(torch, lambda: fusedpack.
                                huffman_segments_plain(rows_in, nblocks, st,
                                                       markers))
        record_err("huffman_segments:pattern",
                   rows_err(torch, *k_out, *p_out), fkind)
        max_row = int(k_out[2][1])
        del p_out, rows_in
        # phase A, then the IDCT planes of the decoded scan (one launch)
        # and the postprocessor
        hf = dec.prepare(enc.assemble(geo, {"rows": [k_out[0]],
                                            "row_bytes": [k_out[1]]}))
        words, nbits = dec.upload(hf)
        bstart, _e, err, ms_scan = scan_check(torch, words, nbits, hf.plan)
        record_err("huffdec_scan:pattern_444", err, fkind)
        _c, _e, err, ms_block = block_check(torch, words, bstart, hf.plan)
        record_err("huffdec_block:pattern_444", err, fkind)
        del words, bstart, _c, _e
        coefs, err_a, err_c = dec.coefficients_t(hf)
        if bool(err_a.any()) or bool(err_c.any()):
            raise AssertionError(f"8K 4:4:4 interleaved {fkind} stream "
                                 "decodes with errors")
        dplanes = prepost_kernel.idct_planes(coefs, hf.plan.qtabs,
                                             hf.plan.geo)
        ms_idct = idct_planes_check(torch, coefs, hf.plan, dplanes,
                                    lambda e: record_err("idct_planes:444",
                                                         e, fkind))
        img = prepost_kernel.postprocess_packed(dplanes, hf.plan.geo,
                                                hf.out_pi)
        ref, ms_post = once_ms(
            torch, lambda: prepost_kernel.postprocess_packed_plain(
                dplanes, hf.plan.geo, hf.out_pi))
        record_err("post_rgb:444", diff(img, ref), fkind)
        del k_out, hf, coefs, dplanes, img, ref
        cm = coefs_mode_inputs(planes, geo)
        k_out = fusedpack.entropy_fused(*cm, classes)
        cst = fusedpack.SlotTables(classes, (0,), (0,))
        p_out, ms_coefs = once_ms(torch, lambda: fusedpack.
                                  huffman_segments_plain(
                                      cm[0], None, cst, cm[3], cm[1], cm[2]))
        record_err("huffman_segments:coefs",
                   rows_err(torch, *k_out, *p_out), fkind)
        if fkind == "gradient":
            kernels["pre_rgb_to_planes:il_444"]["plain_ms"] = ms_pre
            kernels["huffman_segments:pattern"]["plain_ms"] = ms_pat
            kernels["huffman_segments:coefs"]["plain_ms"] = ms_coefs
            kernels["idct_planes:444"]["plain_ms"] = ms_idct
            kernels["huffdec_scan:pattern_444"]["plain_ms"] = ms_scan
            kernels["huffdec_block:pattern_444"]["plain_ms"] = ms_block
            kernels["post_rgb:444"]["plain_ms"] = ms_post
            coefs_in = cm
        log(f"[il444 kernels] 8K 4:4:4 interleaved {fkind}: pre, fdct (MCU "
            f"order), huffman pattern ({geo.segment_count} rows of "
            f"{geo.blocks_per_mcu} x "
            f"{geo.segment_mcu_count} blocks, max row {max_row} B) and "
            f"coefficient-input mode ({cm[0].shape[0]} rows of 8 blocks), "
            "scan and block (pattern), idct planes (one launch), post equal "
            "to plain")
        del p_out, k_out, planes, frame, cm

    # -- b. HD: card == CPU, bytes and pixels --------------------------------
    hd_check(torch, np, gt, dev, params, 43, "il444")

    # -- c. main path ---------------------------------------------------------
    launches, frames, streams = main_path_8k(
        torch, np, gt, dev, enc, dec, params, 300, "il444",
        ("pre_rgb_to_planes", "fdct_quant", "huffman_segments"),
        ("huffdec_scan", "huffdec_block", "dc_fixup", "idct_planes",
         "post_rgb"),
        ("pack_stuff_rows", "dpost_rgb"))
    MCU_ORDER["launches"] += launches["fdct_quant"]
    geo = enc.resolve(frames[0], params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    pinned, pin_ms = pinned_frame(torch, frames[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    x = pinned.to(dev, non_blocking=True)
    ev[1].record()
    planes = prepost_kernel.preprocess_packed(x, geo, geo.param_image)
    ev[2].record()
    rows_in = fusedpack.interleaved_rows(planes, geo, classes)
    ev[3].record()
    st = fusedpack.interleaved_slots(geo, classes)
    nblocks = geo.mcu_count * geo.blocks_per_mcu
    markers = fusedpack.segment_markers(geo.segment_count, dev)
    rows, rb, _ = fusedpack.huffman_segments(rows_in, nblocks, st, markers)
    ev[4].record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = enc.assemble(geo, {"rows": [rows], "row_bytes": [rb]})
    t2 = time.perf_counter()
    if out != streams[0]:
        raise AssertionError("stage-by-stage 4:4:4 interleaved encode "
                             "differs from encode()")
    stages = dict(pin_copy_host_ms=pin_ms,
                  h2d_ms=ev[0].elapsed_time(ev[1]),
                  pre_ms=ev[1].elapsed_time(ev[2]),
                  fdct_reorder_3_planes_ms=ev[2].elapsed_time(ev[3]),
                  huffman_pattern_ms=ev[3].elapsed_time(ev[4]),
                  device_wall_ms=(t1 - t0) * 1e3,
                  assemble_d2h_host_ms=(t2 - t1) * 1e3)
    log("[il444 8k enc] stages (CUDA events; assembly on the host clock; "
        f"{rows_in.numel() * 2} B of coefficients in MCU order): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    bstart, coefs, dplanes, img, words, nbits, p, hf = decode_stages(
        torch, np, dec, streams[0], "il444")

    # -- d. per-launch times at the path's shapes ----------------------------
    kernels["huffman_segments:pattern"]["ms"] = event_ms(
        torch, lambda: fusedpack.huffman_segments(rows_in, nblocks, st,
                                                  markers), 10, flush)
    kernels["huffman_segments:pattern"]["bound_ms"] = huffman_bound_ms(
        rows_in, rb)
    kernels["huffman_segments:pattern"]["probe"] = probe_ms(
        torch, lambda stage: fusedpack.huffman_segments_probe(
            rows_in, nblocks, st, stage, markers),
        lambda: fusedpack.huffman_segments_plain(rows_in, nblocks, st,
                                                 markers), flush)
    mcu_order_times(torch, planes, geo, classes, flush, mcu_plain_ms,
                    "il444 time")
    kernels["pre_rgb_to_planes:il_444"]["ms"] = event_ms(
        torch, lambda: prepost_kernel.preprocess_packed(
            x, geo, geo.param_image), 20, flush)       # 1 launch a frame
    kernels["pre_rgb_to_planes:il_444"]["bound_ms"] = (
        x.numel() + sum(p_.numel() for p_ in planes)) / PEAK_BYTES_S * 1e3
    del rows, rows_in, planes, x
    kernels["huffman_segments:coefs"]["ms"] = event_ms(
        torch, lambda: fusedpack.entropy_fused(*coefs_in, classes), 10,
        flush)
    _, c_rb, _ = fusedpack.entropy_fused(*coefs_in, classes)
    kernels["huffman_segments:coefs"]["bound_ms"] = huffman_bound_ms(
        coefs_in[0], c_rb, coefs_in[1].numel() + 4 * c_rb.numel())
    idct_planes_times(torch, kernels["idct_planes:444"], coefs, p, flush)
    scan_times(torch, kernels["huffdec_scan:pattern_444"], words, nbits,
               coefs, p, flush)
    block_times(torch, kernels["huffdec_block:pattern_444"], words, nbits,
                bstart, p, flush,
                kernels["huffdec_scan:pattern_444"]["tokens"])
    kernels["post_rgb:444"]["ms"] = event_ms(
        torch, lambda: prepost_kernel.postprocess_packed(
            dplanes, p.geo, hf.out_pi), 20, flush)
    kernels["post_rgb:444"]["bound_ms"] = (
        sum(d.numel() for d in dplanes) + img.numel()) / PEAK_BYTES_S * 1e3
    log_times("il444 time", kernels)
    return kernels, {name: launches[k["key"]] for name, k in kernels.items()}


def planar_phases(torch, np, gt, dev, flush):
    """Step 9, the planar 4:2:0 path (three non-interleaved scans, luma 2x2,
    chroma 1x1, Q75, restart auto = 8 blocks a segment); returns (kernel
    records, launches over its main path)."""
    from gpujpeg_tpu_torch.ops import prepost_kernel

    params = gt.Parameters(
        quality=QUALITY, restart_interval=gt.RESTART_AUTO).chroma_subsampled(
        ((2, 2), (1, 1), (1, 1)))
    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    kernels = {
        "pre_rgb_to_planes:planar_420": dict(
            key="pre_rgb_to_planes",
            source="gpujpeg_tpu_torch/csrc/pre_rgb_to_planes.cu",
            replaces="gpujpeg_tpu/ops/prepost_kernel.py:88",
            bound_by="bytes", library_ms=None, err=0),
        "dpost_rgb:subsampled": dict(
            key="dpost_rgb",
            source="gpujpeg_tpu_torch/csrc/dpost_rgb.cu",
            replaces="gpujpeg_tpu/ops/prepost_kernel.py:379",
            bound_by="operations", err=0),
        "huffdec_scan:planar_420": dict(
            key="huffdec_scan",
            source="gpujpeg_tpu_torch/csrc/huffdec_scan.cu",
            replaces="gpujpeg_tpu/ops/huffdec_kernel.py:590",
            bound_by="bytes", library_ms=None, err=0),
        "huffdec_block:planar_420": dict(
            key="huffdec_block",
            source="gpujpeg_tpu_torch/csrc/huffdec_block.cu",
            replaces="gpujpeg_tpu/ops/huffdec_kernel.py:283",
            bound_by="bytes", library_ms=None, err=0),
    }

    def record_err(name, err, what):
        kernels[name]["err"] = max(kernels[name]["err"], err)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({what})")

    # -- a. phases A and C and dpost at dx = dy = 2 against their plain
    # versions -------------------------------------------------------------
    for fkind, seed in (("gradient", 51), ("noise", 52)):
        frame = make_frame(torch, fkind, seed, H8K, W8K, dev)
        egeo = enc.resolve(frame, params)
        planes = prepost_kernel.preprocess_packed(frame, egeo,
                                                  egeo.param_image)
        ref, ms_pre = once_ms(
            torch, lambda: prepost_kernel.preprocess_packed_plain(
                frame, egeo, egeo.param_image))
        record_err("pre_rgb_to_planes:planar_420",
                   max(diff(a, b) for a, b in zip(planes, ref)), fkind)
        del planes, ref
        data = enc.encode(frame, params)
        hf = dec.prepare(data)
        words, nbits = dec.upload(hf)
        bstart, _e, err, ms_scan = scan_check(torch, words, nbits, hf.plan)
        record_err("huffdec_scan:planar_420", err, fkind)
        _c, _e, err, ms_block = block_check(torch, words, bstart, hf.plan)
        record_err("huffdec_block:planar_420", err, fkind)
        del words, bstart, _c, _e
        coefs, err_a, err_c = dec.coefficients_t(hf)
        if bool(err_a.any()) or bool(err_c.any()):
            raise AssertionError(f"8K planar 4:2:0 {fkind} stream decodes "
                                 "with errors")
        geo, pi = hf.plan.geo, hf.out_pi
        if prepost_kernel.dpost_decimation(geo) != (2, 2) or \
                not prepost_kernel.decode_post_supported(geo, pi):
            raise AssertionError("8K planar 4:2:0 does not take dpost")
        img = prepost_kernel.decode_post(coefs, hf.plan.qtabs, geo, pi)
        ref, ms = once_ms(torch, lambda: prepost_kernel.decode_post_plain(
            coefs, hf.plan.qtabs, geo, pi))
        record_err("dpost_rgb:subsampled", diff(img, ref), fkind)
        if fkind == "gradient":
            kernels["pre_rgb_to_planes:planar_420"]["plain_ms"] = ms_pre
            kernels["dpost_rgb:subsampled"]["plain_ms"] = ms
            kernels["huffdec_scan:planar_420"]["plain_ms"] = ms_scan
            kernels["huffdec_block:planar_420"]["plain_ms"] = ms_block
        log(f"[planar kernels] 8K planar 4:2:0 {fkind}: {len(data)} B, "
            f"{geo.segment_count} segments in 3 scans, pre, scan, block and "
            f"dpost (dx = dy = 2) equal to plain, PSNR "
            f"{psnr(np, img.cpu().numpy(), frame.cpu().numpy()):.2f} dB")
        del coefs, img, ref, frame

    # -- b. HD: card == CPU, bytes and pixels --------------------------------
    hd_check(torch, np, gt, dev, params, 53, "planar 4:2:0")

    # -- c. main path ---------------------------------------------------------
    launches, frames, streams = main_path_8k(
        torch, np, gt, dev, enc, dec, params, 400, "planar 4:2:0",
        ("pre_rgb_to_planes", "fdct_quant", "huffman_segments"),
        ("huffdec_scan", "huffdec_block", "dc_fixup", "dpost_rgb"),
        ("pack_stuff_rows", "idct_planes", "post_rgb"))
    x, planes, _, _, _ = planar_encode_stages(
        torch, enc, frames[0], params, streams[0], "planar 4:2:0 8k enc")
    egeo = enc.resolve(frames[0], params)
    kernels["pre_rgb_to_planes:planar_420"]["ms"] = event_ms(
        torch, lambda: prepost_kernel.preprocess_packed(
            x, egeo, egeo.param_image), 20, flush)     # 1 launch a frame
    kernels["pre_rgb_to_planes:planar_420"]["bound_ms"] = (
        x.numel() + sum(p_.numel() for p_ in planes)) / PEAK_BYTES_S * 1e3
    del x, planes
    words, nbits, bstart, coefs, img, p, hf = dpost_decode_stages(
        torch, np, dec, streams[0], "planar 4:2:0 8k dec")

    # -- d. times, bounds and yardstick at the path's shapes ----------------
    dpost_times(torch, kernels["dpost_rgb:subsampled"], coefs, img, p, hf,
                flush)
    scan_times(torch, kernels["huffdec_scan:planar_420"], words, nbits,
               coefs, p, flush)
    block_times(torch, kernels["huffdec_block:planar_420"], words, nbits,
                bstart, p, flush,
                kernels["huffdec_scan:planar_420"]["tokens"])
    log_times("planar time", kernels)
    return kernels, {name: launches[k_["key"]]
                     for name, k_ in kernels.items()}


def decode_stages(torch, np, dec, data, what):
    """Stage breakdown of one decode through idct_planes + post_rgb (an
    interleaved scan, or a stream dpost does not take); returns what the
    per-launch timings reuse."""
    from gpujpeg_tpu_torch.models import decoder as tdec
    from gpujpeg_tpu_torch.ops import prepost_kernel

    dev = dec.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hf = dec.prepare(data)
    t1 = time.perf_counter()
    p = hf.plan
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    host = pinned_image(torch, hf.out_pi)
    ev[0].record()
    words, nbits = dec.upload(hf)
    ev[1].record()
    bstart, _ea = scan_call(words, nbits, p)
    ev[2].record()
    coefs, _ec = block_call(words, bstart, p)
    ev[3].record()
    coefs = tdec.dc_fixup(coefs, p)
    ev[4].record()
    dplanes = prepost_kernel.idct_planes(coefs, p.qtabs, p.geo)
    ev[5].record()
    img = prepost_kernel.postprocess_packed(dplanes, p.geo, hf.out_pi)
    ev[6].record()
    host.copy_(img)
    ev[7].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not np.array_equal(host.numpy(), dec.decode(data)):
        raise AssertionError(f"stage-by-stage {what} decode differs from "
                             "decode()")
    stages = dict(parse_unstuff_host_ms=(t1 - t0) * 1e3,
                  h2d_words_ms=ev[0].elapsed_time(ev[1]),
                  scan_ms=ev[1].elapsed_time(ev[2]),
                  block_ms=ev[2].elapsed_time(ev[3]),
                  dc_fixup_ms=ev[3].elapsed_time(ev[4]),
                  idct_3_planes_ms=ev[4].elapsed_time(ev[5]),
                  post_ms=ev[5].elapsed_time(ev[6]),
                  d2h_image_ms=ev[6].elapsed_time(ev[7]),
                  device_wall_ms=(t2 - t1) * 1e3)
    log(f"[{what} 8k dec] stages (parse + unstuff on the host clock, the "
        f"rest CUDA events; {words.numel() * 4} B of words): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return bstart, coefs, dplanes, img, words, nbits, p, hf


#: the layouts of the [foreign] step: planar 4:4:4 (the reference's
#: headline) and interleaved 4:2:0 (libjpeg's default)
FOREIGN_LAYOUTS = (("444", False, None),
                   ("420", True, ((2, 2), (1, 1), (1, 1))))
#: 8K frames timed after the three counted ones on a restart-0 path
RESTART0_EXTRA_FRAMES = 3
#: launches of phase A's serial instance timed beside the sync instance
#: at restart interval 0 (a thread walks a scan, about 0.85 s a launch)
RESTART0_REPS = 3
#: frames (h, w) whose restart-0 streams hold phase A and C against their
#: plain versions (the plain scan steps a token of a scan at a time)
RESTART0_PLAIN = ((96, 128), (384, 512))


def foreign_params(gt, il, samp, tables, rst):
    p = gt.Parameters(quality=QUALITY, restart_interval=rst, interleaved=il,
                      huffman_tables=tables)
    return p.chroma_subsampled(samp) if samp else p


def token_scans(fusedpack, planes, geo, classes):
    """The scans of a token-route encode: (coefficient rows, real blocks,
    slot layout) a scan, as Encoder.encode_to_device and
    _encode_host_entropy make them."""
    if geo.interleaved:
        return [(fusedpack.interleaved_rows(planes, geo, classes),
                 geo.mcu_count * geo.blocks_per_mcu,
                 fusedpack.interleaved_slots(geo, classes))]
    return [(fusedpack.fdct_quant(planes[c.index], classes[c.table_index],
                                  c.segment_mcu_count), c.mcu_count,
             fusedpack.one_slot(classes[c.table_index]))
            for c in geo.components]


def token_args(fusedpack, coefs, n, st):
    """The token-row packer's inputs for a scan's coefficient rows: (bits,
    lens, markers, stride)."""
    R, B = coefs.shape[0], coefs.shape[1] // 64
    ok, cls = fusedpack._block_masks(R, B, st, n, None, None, coefs.device)
    bits, lens = fusedpack.rows_tokens(coefs, st, ok, cls)
    return (bits, lens, fusedpack.segment_markers(R, coefs.device),
            st.stride(B))


def token_encode_stages(torch, enc, frame, params, stream, tag):
    """Stage breakdown of one encode on the token route: Annex-K rows
    (tokens, token-row packer, assembly) or restart-0 scans (each scan's
    tokens, then the copy to the host and the host packer with the
    headers).  Returns the first scan's (coefficient rows, real blocks,
    slot layout) and, on the Annex-K route, its packer inputs."""
    from gpujpeg_tpu_torch import native
    from gpujpeg_tpu_torch.ops import fusedpack, prepost_kernel
    from gpujpeg_tpu_torch.stream import writer

    dev = enc.device
    geo = enc.resolve(frame, params)
    rst0 = geo.param.restart_interval == 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    pinned, pin_ms = pinned_frame(torch, frame)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    x = pinned.to(dev, non_blocking=True)
    ev[1].record()
    planes = prepost_kernel.preprocess_packed(x, geo, geo.param_image)
    ev[2].record()
    scans = token_scans(fusedpack, planes, geo,
                        enc.classes(QUALITY, geo.param.huffman_tables))
    ev[3].record()
    if rst0:
        toks = [fusedpack.scan_tokens(*sc) for sc in scans]
        ev[4].record()
        ev[5].record()
    else:
        pin = [token_args(fusedpack, *sc) for sc in scans]
        ev[4].record()
        rows = [fusedpack.pack_stuff_rows(*a) for a in pin]
        ev[5].record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if rst0:
        out = bytearray(writer.write_header(geo))
        for k, (b, ln) in enumerate(toks):
            out += writer.write_scan_header(geo, k)
            out += native.pack_tokens(b.cpu().numpy(), ln.cpu().numpy())
        out = bytes(out + b"\xff\xd9")
    else:
        out = enc.assemble(geo, {"rows": [r[0] for r in rows],
                                 "row_bytes": [r[1] for r in rows]})
    t2 = time.perf_counter()
    if out != stream:
        raise AssertionError(f"stage-by-stage {tag} encode differs from "
                             "encode()")
    stages = dict(pin_copy_host_ms=pin_ms,
                  h2d_ms=ev[0].elapsed_time(ev[1]),
                  pre_ms=ev[1].elapsed_time(ev[2]),
                  fdct_ms=ev[2].elapsed_time(ev[3]),
                  tokens_ms=ev[3].elapsed_time(ev[4]),
                  pack_stuff_rows_ms=ev[4].elapsed_time(ev[5]),
                  device_wall_ms=(t1 - t0) * 1e3)
    if rst0:
        del stages["pack_stuff_rows_ms"]
        stages["d2h_host_pack_tokens_ms"] = (t2 - t1) * 1e3
        stages["tokens"] = sum(int(ln.numel()) for _, ln in toks)
    else:
        stages["assemble_d2h_host_ms"] = (t2 - t1) * 1e3
    log(f"[{tag}] stages (CUDA events; the host part on the host clock): "
        + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in stages.items()))
    return scans[0], (None if rst0 else pin[0])


def plain_scans(torch, gt, dev) -> dict:
    """For each FOREIGN_LAYOUTS layout, a restart-0 stream of the last
    RESTART0_PLAIN size, written on the card, and a child process
    (python3 chip_smoke.py --plain-scan) that runs phase A's plain version
    on it on the CPU while the card works -> {tag: job}."""
    h, w = RESTART0_PLAIN[-1]
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "gpujpeg_tpu_torch", "_build", "smoke")
    os.makedirs(d, exist_ok=True)
    enc = gt.Encoder(device=dev)
    jobs = {}
    for li, (tag, il, samp) in enumerate(FOREIGN_LAYOUTS):
        frame = make_frame(torch, "gradient", 610 + li, h, w,
                           dev).cpu().numpy()
        data = enc.encode(frame, foreign_params(gt, il, samp, "annexk", 0))
        src = os.path.join(d, f"plain_{tag}.jpg")
        with open(src, "wb") as f:
            f.write(data)
        out = os.path.join(d, f"plain_{tag}.npz")
        if os.path.exists(out):
            os.remove(out)
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--plain-scan", src,
             out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        jobs[tag] = dict(data=data, out=out, proc=proc)
    return jobs


def plain_scan_result(np, job, timeout: float = 600):
    """A plain_scans job's (bstart, err) and its CPU ms, waiting for it."""
    log_text, _ = job["proc"].communicate(timeout=timeout)
    if job["proc"].returncode != 0:
        raise AssertionError(f"the plain-scan child failed:\n{log_text}")
    z = np.load(job["out"])
    return (z["bstart"], z["err"]), float(z["ms"])


def plain_scan_child(src: str, out: str) -> int:
    """--plain-scan: phase A's plain version on the CPU (one thread) on the
    stream at src, its bstart, err and ms saved to out (.npz)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gpujpeg_tpu_torch as gt
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

    torch.set_num_threads(1)
    with open(src, "rb") as f:
        hf = gt.Decoder(device="cpu").prepare(f.read())
    p = hf.plan
    t0 = time.perf_counter()
    bstart, err = thd.scan_segments_plain(
        torch.from_numpy(hf.words), torch.from_numpy(hf.nbits), p.nblocks,
        p.dc_luma, p.ac_luma, p.tables, p.bps, p.pattern)
    ms = (time.perf_counter() - t0) * 1e3
    np.savez(out, bstart=bstart.numpy(), err=err.numpy(), ms=ms)
    return 0


def corrupt_restart0(torch, np, hf, p, dev, tries=64) -> dict:
    """A restart-0 stream's words with one bit flipped from the middle of
    its first scan on, the first flip (of up to `tries`, 997 bits apart)
    that phase A reports: the sync instance's bstart and err against the
    serial instance's on the same words -> {err, bit, tries, flags}."""
    words0 = hf.words
    nbits = torch.from_numpy(hf.nbits).to(dev)
    for k in range(tries):
        bit = int(hf.nbits[0]) // 2 + 997 * k
        bad = words0.copy()
        bad.view(np.uint32)[0, bit >> 5] ^= np.uint32(1) << np.uint32(
            24 - 8 * ((bit >> 3) & 3) + 7 - (bit & 7))
        words = torch.from_numpy(bad).to(dev)
        got = scan_call(words, nbits, p)
        if bool(got[1].any()):
            want = scan_call(words, nbits, p, "serial")
            return dict(err=max(diff(got[0], want[0]),
                                diff(got[1], want[1])),
                        bit=bit, tries=k + 1, flags=got[1].tolist())
    raise AssertionError(f"no bit flip of {tries} that phase A reports")


def foreign_phases(torch, np, gt, dev, flush):
    """Step 10, [foreign]: the streams other encoders write, at 8K, in
    planar 4:4:4 and interleaved 4:2:0 (FOREIGN_LAYOUTS); returns (kernel
    records, launches over its main-path windows).

      a. Annex-K tables, restart auto: the token-row packer on the
         encode's token rows (its first scan: the luma plane, or the
         interleaved scan) against its plain version; phases A and C on
         the Annex-K stream against theirs; the decoded pixels equal to
         the tuned stream's of the same frame (the quantized coefficients
         depend on neither the tables nor the interval);
      b. restart interval 0 (a scan one segment), Annex-K: the 8K encode
         and decode, pixels equal to a.'s; phases A and C against their
         plain versions on 128x96 and 512x384 restart-0 streams (the
         plain phase A steps a token of the longest segment at a time,
         about 1 ms a step on the card: an 8K scan is millions of
         steps); phase A's sync instance against its serial instance on
         the 8K stream and on the same with one bit flipped mid-scan
         (corrupt_restart0);
      c. three table sets: a.'s 8K stream rewritten (the repo's
         legacy-decode rewrite, tests/scan_rows.three_sets), decoded
         by the four-set kernel instances, pixels equal to a.'s; phases A
         and C against their plain versions on it;
      d. HD: the card's Annex-K and restart-0 bytes equal the CPU's, the
         card's Annex-K pixels the CPU's and its restart-0 pixels its
         Annex-K ones (the CPU's plain phase A on a whole HD scan would
         take minutes);
      e. main-path windows: three 8K frames encoded and decoded on each
         new path (EXTRA_FRAMES more timed at restart auto,
         RESTART0_EXTRA_FRAMES at 0), the three-set streams decoded; stage
         breakdowns; per-launch times of the packer and both phases on
         each stream (at restart 0 the sync instance's, and
         RESTART0_REPS launches of the serial instance as serial_ms);
      f. the streams whose restart interval exceeds a scan's MCU count
         (restart_long_streams), outside the main-path windows."""
    from gpujpeg_tpu_torch.ops import _kernels, fusedpack
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
    from tests.scan_rows import three_sets

    kernels = {}

    def rec(name, note=None, key=None):
        key = key or name.split(":")[0]
        kernels[name] = dict(
            key=key, source=f"gpujpeg_tpu_torch/csrc/"
                            f"{_kernels.source_of(key)}.cu",
            replaces={"pack_stuff_rows": "gpujpeg_tpu/ops/fusedpack.py:107",
                      "huffdec_scan": "gpujpeg_tpu/ops/huffdec_kernel.py:590",
                      "huffdec_block":
                          "gpujpeg_tpu/ops/huffdec_kernel.py:283"}[
                              _kernels.source_of(key)],
            bound_by="bytes", library_ms=None, err=0,
            **({"note": note} if note else {}))
        return kernels[name]

    def record_err(name, err, what):
        kernels[name]["err"] = max(kernels[name]["err"], err)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({what})")

    launches = {}
    plain_jobs = plain_scans(torch, gt, dev)
    try:
        for li, (tag, il, samp) in enumerate(FOREIGN_LAYOUTS):
            foreign_layout(torch, np, gt, dev, flush, fusedpack, thd,
                           three_sets, _kernels, kernels, launches, rec,
                           record_err, plain_jobs, li, tag, il, samp)
    finally:
        for job in plain_jobs.values():
            if job["proc"].poll() is None:
                job["proc"].kill()
                job["proc"].wait()
    restart_long_streams(np, gt, dev)
    return kernels, launches


def restart_long_streams(np, gt, dev) -> None:
    """[foreign] f.: the streams whose restart interval exceeds a scan's
    MCU count (ROADMAP Q13, tests/scan_rows.RESTART_LONG: 8x8 RGB at
    interval 2, 7x13 at 3, 1x16 interleaved 4:2:0 at 5, 2x30 planar
    4:1:1 at 5), where every segment's nblocks is below the interval's
    blocks.  Each is decoded on the card: decode_coefficients through
    phases A and C and the DC fix-up, decode through its route (the
    direct instance at one block a segment); coefficients and pixels
    are held against the port's CPU decode at error 0
    (tests/test_torch_restart_long.py holds that against the JAX
    package).  Logs one JSON line, {name: record} with the interval,
    the plan's bps and nblocks, the launches of each call and the two
    errors; raises on any error, or on a phase not launched once."""
    from gpujpeg_tpu_torch.ops import _kernels
    from tests import scan_rows

    def launched():
        got = {k: n for k, n in _kernels.LAUNCHES.items() if n}
        _kernels.reset_launches()
        return got

    phases = ("huffdec_scan", "huffdec_block", "dc_fixup")
    out = {}
    for name, (_hw, rst, _il, _samp) in scan_rows.RESTART_LONG.items():
        frame, params = scan_rows.restart_long(gt, name)
        data = gt.Encoder(device="cpu").encode(frame, params)
        dec, cpu = gt.Decoder(device=dev), gt.Decoder(device="cpu")
        plan = dec.prepare(data).plan
        bpm = plan.pattern[0] if plan.geo.interleaved else 1
        _kernels.reset_launches()
        coefs = dec.decode_coefficients(data)
        coef_launches = launched()
        pixels = dec.decode(data)
        pixel_launches = launched()
        want_c, want = cpu.decode_coefficients(data), cpu.decode(data)
        nblocks = plan.nblocks.tolist()
        rec = out[name] = dict(
            interval=rst, blocks_per_mcu=bpm, bps=plan.bps,
            nblocks=nblocks, direct=plan.direct,
            coefs_launches=coef_launches, pixels_launches=pixel_launches,
            coef_err=max(int(np.abs(a.astype(np.int32)
                                    - b.astype(np.int32)).max())
                         for a, b in zip(coefs, want_c)),
            pixel_err=int(np.abs(pixels.astype(np.int32)
                                 - want.astype(np.int32)).max()))
        route = ("huffdec_block_direct",) if plan.direct else phases
        if (rec["coef_err"] or rec["pixel_err"]
                or any(a.shape != b.shape for a, b in zip(coefs, want_c))
                or pixels.shape != want.shape
                or max(nblocks) >= rst * bpm
                or any(coef_launches.get(k) != 1 for k in phases)
                or any(pixel_launches.get(k) != 1 for k in route)):
            raise AssertionError(f"restart interval past the scan: {name} "
                                 f"differs from the CPU decode: {rec}")
    log(f"[foreign] restart interval past the scan (card == cpu): "
        f"{json.dumps(out)}")


def foreign_layout(torch, np, gt, dev, flush, fusedpack, thd, three_sets,
                   _kernels, kernels, launches, rec, record_err, plain_jobs,
                   li, tag, il, samp):
    """foreign_phases' steps a. to e. for one layout."""
    t_layout = time.perf_counter()
    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    pa = foreign_params(gt, il, samp, "annexk", gt.RESTART_AUTO)
    p0 = foreign_params(gt, il, samp, "annexk", 0)
    pt = foreign_params(gt, il, samp, "tuned", gt.RESTART_AUTO)
    pk, sk, bk = (rec(f"pack_stuff_rows:annexk_{tag}"),
                  rec(f"huffdec_scan:annexk_{tag}"),
                  rec(f"huffdec_block:annexk_{tag}"))
    s0 = rec(f"huffdec_scan:restart0_{tag}",
             "the sync instance (gj_huffdec_scan_sync): plain_ms and "
             "max_abs_err on 128x96 and 512x384 restart-0 streams (the "
             "plain scan steps a token of the longest segment at a "
             "time; plain_ms_512x384_cpu the larger one's, run on the "
             "CPU in a child process), max_abs_err "
             "also against the serial instance on the clean and a "
             "corrupt 8K stream; ms, serial_ms (the serial instance, a "
             "thread a scan, same rows), bound and tokens on the 8K "
             "one", key="huffdec_scan_sync")
    b0 = rec(f"huffdec_block:restart0_{tag}",
             "max_abs_err on the 128x96 and 512x384 restart-0 streams "
             "and the 8K one, plain_ms on the 8K one; ms, bound and "
             "tokens on the 8K one")
    s3, b3 = (rec(f"huffdec_scan:three_sets_{tag}",
                  "four-set instance loading three sets' lookahead rows "
                  "(dynamic shared memory sized to the launch): the "
                  "Annex-K stream rewritten to three AC table sets; "
                  "two_set_ms the two-set instance on the same tokens "
                  "(the Annex-K stream, huffdec_scan:annexk_*'s ms), "
                  "parent_ms the parent tree's instance on the same words "
                  "(--parent), resources each serial instance's "
                  "registers, shared memory and CTAs an SM"),
              rec(f"huffdec_block:three_sets_{tag}",
                  "four-set instance, CTAs of 8 warps, its tables in "
                  "dynamic shared memory: the Annex-K stream rewritten "
                  "to three AC table sets; two_set_ms the two-set "
                  "instance on the same tokens (the Annex-K stream, "
                  "huffdec_block:annexk_*'s ms), parent_ms the parent "
                  "tree's four-set instance on the same words (--parent)"))
    what = f"8K {'il' if il else 'planar'} {tag}"

    # -- a. Annex-K, restart auto ---------------------------------------
    frame = make_frame(torch, "gradient", 600 + li, H8K, W8K, dev)
    frame_np = frame.cpu().numpy()
    geo = enc.resolve(frame_np, pa)
    planes, classes = enc._front(frame, geo)
    coefs, n, st = token_scans(fusedpack, planes, geo, classes)[0]
    del planes
    bits, lens, markers, stride = token_args(fusedpack, coefs, n, st)
    k_out = fusedpack.pack_stuff_rows(bits, lens, markers, stride)
    p_out, pk["plain_ms"] = once_ms(
        torch, lambda: fusedpack.pack_stuff_rows_plain(bits, lens,
                                                       markers, stride))
    record_err(f"pack_stuff_rows:annexk_{tag}",
               rows_err(torch, *k_out, *p_out), what)
    del k_out, p_out, bits, lens, coefs
    data_a = enc.encode(frame_np, pa)
    data_t = enc.encode(frame_np, pt)
    hf = dec.prepare(data_a)
    p = hf.plan
    words, nbits = dec.upload(hf)
    bstart, err_a, err, sk["plain_ms"] = scan_check(torch, words, nbits,
                                                    p)
    record_err(f"huffdec_scan:annexk_{tag}", err, what)
    _c, err_c, err, bk["plain_ms"] = block_check(torch, words, bstart, p)
    record_err(f"huffdec_block:annexk_{tag}", err, what)
    if bool(err_a.any()) or bool(err_c.any()):
        raise AssertionError(f"{what} Annex-K stream decodes with errors")
    del words, bstart, _c
    img_a = dec.decode(data_a)
    if not np.array_equal(img_a, dec.decode(data_t)):
        raise AssertionError(f"{what}: the Annex-K stream's pixels "
                             "differ from the tuned stream's")
    log(f"[foreign] {what} Annex-K: {len(data_a)} B (tuned "
        f"{len(data_t)} B), {p.geo.segment_count} segments; pack, scan, "
        "block equal to plain; pixels == the tuned stream's, PSNR "
        f"{psnr(np, img_a, frame_np):.2f} dB")

    # -- b. restart interval 0 ------------------------------------------
    data_0 = enc.encode(frame_np, p0)
    img_0 = dec.decode(data_0)
    if not np.array_equal(img_0, img_a):
        raise AssertionError(f"{what}: the restart-0 stream's pixels "
                             "differ from the restart-auto stream's")
    for h, w in RESTART0_PLAIN:
        if (h, w) == RESTART0_PLAIN[0]:
            small = make_frame(torch, "gradient", 610 + li, h, w,
                               dev).cpu().numpy()
            hf0 = dec.prepare(enc.encode(small, p0))
            w0, nb0 = dec.upload(hf0)
            bst0, ea0, err, ms = scan_check(torch, w0, nb0, hf0.plan,
                                            "sync")
            s0["plain_ms"] = ms
        else:
            # the plain scan of this stream ran on the CPU in a child
            # process (plain_scans) while the card worked
            hf0 = dec.prepare(plain_jobs[tag]["data"])
            w0, nb0 = dec.upload(hf0)
            bst0, ea0 = scan_call(w0, nb0, hf0.plan, "sync")
            want, ms = plain_scan_result(np, plain_jobs[tag])
            err = max(diff(bst0.cpu(), torch.from_numpy(want[0])),
                      diff(ea0.cpu(), torch.from_numpy(want[1])))
            s0[f"plain_ms_{w}x{h}_cpu"] = ms
        record_err(f"huffdec_scan:restart0_{tag}", err,
                   f"{w}x{h} restart 0")
        _c, ec0, err, _ms = block_check(torch, w0, bst0, hf0.plan)
        record_err(f"huffdec_block:restart0_{tag}", err,
                   f"{w}x{h} restart 0")
        if bool(ea0.any()) or bool(ec0.any()) or w0.shape[0] != \
                hf0.plan.geo.scan_count:
            raise AssertionError(f"{w}x{h} restart-0 stream: errors, "
                                 "or not a segment a scan")
        log(f"[foreign] {tag} {w}x{h} restart 0: {tuple(w0.shape)} "
            f"words; the sync instance and phase C equal to plain "
            f"(plain scan {ms:.1f} ms)")
    hf = dec.prepare(data_0)
    words, nbits = dec.upload(hf)
    if thd.scan_instance(*words.shape) != "sync":
        raise AssertionError(f"{what} restart 0: the chooser took the "
                             "serial instance")
    bstart, err_a = scan_call(words, nbits, hf.plan)
    ser = scan_call(words, nbits, hf.plan, "serial")
    record_err(f"huffdec_scan:restart0_{tag}",
               max(diff(bstart, ser[0]), diff(err_a, ser[1])),
               what + " restart 0, against the serial instance")
    _c, err_c, err, b0["plain_ms"] = block_check(torch, words, bstart,
                                                 hf.plan)
    record_err(f"huffdec_block:restart0_{tag}", err, what + " restart 0")
    if bool(err_a.any()) or bool(err_c.any()):
        raise AssertionError(f"{what} restart-0 stream decodes with "
                             "errors")
    flip = corrupt_restart0(torch, np, hf, hf.plan, dev)
    record_err(f"huffdec_scan:restart0_{tag}", flip["err"],
               what + " corrupt restart 0, against the serial instance")
    log(f"[foreign] {what} restart 0: {len(data_0)} B, "
        f"{words.shape[0]} segments x {words.shape[1]} words, "
        f"{hf.plan.bps} block slots a row; pixels == restart auto; "
        "sync instance == serial instance; a bit flipped at "
        f"{flip['bit']} ({flip['tries']} tries): err "
        f"{flip['flags']} and bstart == the serial instance's")
    del words, bstart, _c, ser

    # -- c. three table sets --------------------------------------------
    data_3 = three_sets(data_a)
    hf = dec.prepare(data_3)
    if tuple(hf.plan.tables.shape) != (8, 290):
        raise AssertionError("the three-set stream took no four-set plan")
    words, nbits = dec.upload(hf)
    bstart, err_a, err, s3["plain_ms"] = scan_check(torch, words, nbits,
                                                    hf.plan)
    record_err(f"huffdec_scan:three_sets_{tag}", err, what)
    _c, err_c, err, b3["plain_ms"] = block_check(torch, words, bstart,
                                                 hf.plan)
    record_err(f"huffdec_block:three_sets_{tag}", err, what)
    if bool(err_a.any()) or bool(err_c.any()):
        raise AssertionError(f"{what} three-set stream decodes with "
                             "errors")
    if not np.array_equal(dec.decode(data_3), img_a):
        raise AssertionError(f"{what}: the three-set stream's pixels "
                             "differ from the unmodified stream's")
    log(f"[foreign] {what} three table sets: scan and block (four-set "
        "instances) equal to plain, pixels == the unmodified stream's")
    del words, bstart, _c, frame, img_0

    # -- d. HD: card == CPU ---------------------------------------------
    hd = make_frame(torch, "gradient", 620 + li, 1080, 1920,
                    dev).cpu().numpy()
    hd_a = enc.encode(hd, pa)
    hd_0 = enc.encode(hd, p0)
    cpu = gt.Encoder(device="cpu")
    if hd_a != cpu.encode(hd, pa) or hd_0 != cpu.encode(hd, p0):
        raise AssertionError(f"HD {tag} Annex-K or restart-0 encode on "
                             "the card differs from the CPU")
    got_a = dec.decode(hd_a)
    if not np.array_equal(got_a, gt.Decoder(device="cpu").decode(hd_a)) \
            or not np.array_equal(dec.decode(hd_0), got_a):
        raise AssertionError(f"HD {tag} Annex-K or restart-0 decode on "
                             "the card differs")
    log(f"[foreign hd] 1920x1080 {tag}: Annex-K {len(hd_a)} B and "
        f"restart 0 {len(hd_0)} B card == cpu (bytes); Annex-K pixels "
        "card == cpu, restart-0 pixels == Annex-K's")

    # -- e. main-path windows, stages and times -------------------------
    tail = ("dc_fixup",) + (("idct_planes", "post_rgb") if il
                            else ("dpost_rgb",))
    la, frames, streams_a = main_path_8k(
        torch, np, gt, dev, enc, dec, pa, 630 + 10 * li,
        f"annexk {tag}", ("pre_rgb_to_planes", "fdct_quant",
                          "pack_stuff_rows"),
        ("huffdec_scan", "huffdec_block") + tail, ("huffman_segments",))
    l0, _f0, streams_0 = main_path_8k(
        torch, np, gt, dev, enc, dec, p0, 630 + 10 * li,
        f"restart0 {tag}", ("pre_rgb_to_planes", "fdct_quant"),
        ("huffdec_scan_sync", "huffdec_block") + tail,
        ("huffman_segments", "pack_stuff_rows", "pack_stuff_scan",
         "huffdec_scan"), RESTART0_EXTRA_FRAMES)
    streams_3 = [three_sets(d) for d in streams_a]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    walls = []
    for d, f in zip(streams_3, frames):
        t0 = time.perf_counter()
        out = dec.decode(d)
        walls.append((time.perf_counter() - t0) * 1e3)
        if psnr(np, out, f) < 20:
            raise AssertionError(f"8K three-set {tag} decode PSNR")
    end_window()
    l3 = dict(_kernels.LAUNCHES)
    log(f"[three_sets {tag} 8k dec] launches "
        f"{ {n: l3[n] for n in ('huffdec_scan', 'huffdec_block')} }, "
        "wall ms per frame, " + quartiles(np, walls))
    for name, ln in ((f"pack_stuff_rows:annexk_{tag}", la),
                     (f"huffdec_scan:annexk_{tag}", la),
                     (f"huffdec_block:annexk_{tag}", la),
                     (f"huffdec_scan:restart0_{tag}", l0),
                     (f"huffdec_block:restart0_{tag}", l0),
                     (f"huffdec_scan:three_sets_{tag}", l3),
                     (f"huffdec_block:three_sets_{tag}", l3)):
        launches[name] = ln[kernels[name]["key"]]
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on its path")

    _sc, pin = token_encode_stages(torch, enc, frames[0], pa,
                                   streams_a[0], f"annexk {tag} 8k enc")
    pack_times(torch, pk, *pin, int(fusedpack.pack_stuff_rows(*pin)[1]
                                    .sum()), flush)
    del pin, _sc
    token_encode_stages(torch, enc, frames[0], p0, streams_0[0],
                        f"restart0 {tag} 8k enc")
    stages = decode_stages if il else dpost_decode_stages
    for data, ks, kb, name, serial in (
            (streams_a[0], sk, bk, "annexk", 0),
            (streams_0[0], s0, b0, "restart0", RESTART0_REPS)):
        out = stages(torch, np, dec, data, f"{name} {tag}")
        if il:
            bstart, coefs, _dp, _img, words, nbits, p, _hf = out
        else:
            words, nbits, bstart, coefs, _img, p, _hf = out
        scan_times(torch, ks, words, nbits, coefs, p, flush, 20, serial)
        block_times(torch, kb, words, nbits, bstart, p, flush,
                    ks["tokens"])
        del out, words, bstart, coefs
    hf = dec.prepare(streams_3[0])
    words, nbits = dec.upload(hf)
    bstart, _e = scan_call(words, nbits, hf.plan)
    coefs, _e = block_call(words, bstart, hf.plan)
    scan_times(torch, s3, words, nbits, coefs, hf.plan, flush)
    block_times(torch, b3, words, nbits, bstart, hf.plan, flush,
                s3["tokens"])
    b3["two_set_ms"] = bk["ms"]
    s3["two_set_ms"] = sk["ms"]
    s3["resources"] = scan_resources()
    if PARENT is not None:
        got = PARENT.block(torch, words, bstart, hf.plan)
        b3["parent_err"] = max(diff(got[0], coefs), diff(got[1], _e))
        if b3["parent_err"]:
            raise AssertionError(f"{what} three sets: the parent's four-set "
                                 "instance differs from this tree's")
        b3["parent_ms"] = event_ms(
            torch, lambda: PARENT.block(torch, words, bstart, hf.plan), 20,
            flush)
        b3["ms_again"] = event_ms(
            torch, lambda: block_call(words, bstart, hf.plan), 20, flush)
        del got
    log(f"[foreign] {what} three sets: phase A four-set instance "
        f"{s3['ms']:.4f} ms"
        + (f" [parent {s3['parent_ms']:.4f}, again {s3['ms_again']:.4f}]"
           if PARENT is not None else "")
        + f", the two-set instance on the same tokens {sk['ms']:.4f} ms; "
        f"resources {s3['resources']}")
    log(f"[foreign] {what} three sets: phase C four-set instance "
        f"{b3['ms']:.4f} ms"
        + (f" [parent {b3['parent_ms']:.4f}, again {b3['ms_again']:.4f}]"
           if PARENT is not None else "")
        + f", the two-set instance on the same tokens {bk['ms']:.4f} ms")
    del words, bstart, coefs
    log_times(f"foreign {tag} time",
              {k: v for k, v in kernels.items() if k.endswith(tag)})
    log(f"[foreign {tag}] {time.perf_counter() - t_layout:.1f} s")


#: the [session] step's layouts: (tag, interleaved, sampling, restart)
SESSION_LAYOUTS = (("planar_444", False, None, -1),
                   ("il_420", True, ((2, 2), (1, 1), (1, 1)), -1),
                   ("il_444", True, None, -1),
                   ("planar_420", False, ((2, 2), (1, 1), (1, 1)), -1),
                   ("restart0_444", False, None, 0),
                   ("restart0_420", True, ((2, 2), (1, 1), (1, 1)), 0))
#: frames of each pipelined run (three distinct frames in turn)
SESSION_FRAMES = 12


def session_params(gt, tag):
    _t, il, samp, rst = next(x for x in SESSION_LAYOUTS if x[0] == tag)
    return foreign_params(gt, il, samp, "tuned",
                          gt.RESTART_AUTO if rst < 0 else rst)


def graph_nodes(torch, fn) -> dict:
    """The device operations one call of fn() queues, counted in a CUDA
    graph that captures it (kept after capture, its nodes read with
    libcuda's cuGraphGetNodes and cuGraphNodeGetType): {"kernels": n,
    "memsets": m, "nodes": all}, or {"not_measured": why}.  fn runs once
    on the capture stream first, so that nothing it makes once (a kept
    scratch) is captured."""
    import ctypes

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    try:
        cu = ctypes.CDLL("libcuda.so.1")
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, stream=stream):
            fn()
        graph = ctypes.c_void_p(g.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        rc = cu.cuGraphGetNodes(graph, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        rc = rc or cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
        kinds = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            rc = rc or cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                             ctypes.byref(kind))
            kinds.append(kind.value)
        del g
    except (AttributeError, RuntimeError, OSError, TypeError) as e:
        torch.cuda.synchronize()
        return {"not_measured": f"{type(e).__name__}: {e}"[:200]}
    torch.cuda.synchronize()
    if rc:
        return {"not_measured": f"libcuda error {rc}"}
    # CUgraphNodeType: 0 kernel, 2 memset
    return {"kernels": kinds.count(0), "memsets": kinds.count(2),
            "nodes": len(kinds)}


def fixup_times(torch, np, gt, dev, enc, dec, frame, flush) -> dict:
    """[session] a: the DC fix-up kernel against _dc_fixup_t on each
    layout's differential coefficients (phases A and C of an 8K stream of
    the frame), error 0; its ms beside its bound, the plain version once
    and the torch cumsum chain (library_ms); its launches a call
    (_kernels.LAUNCHES) and the device operations a call queues
    (graph_nodes); its probe stages (full, loads and stores alone, no
    store); given --parent, the parent tree's fix-up on the same
    coefficients, equal to this tree's, timed in turns (parent_ms, then
    this tree's ms_again); -> the dc_fixup record."""
    from gpujpeg_tpu_torch.models import decoder as tdec
    from gpujpeg_tpu_torch.ops import _kernels

    rec = dict(source="gpujpeg_tpu_torch/csrc/dc_fixup.cu",
               replaces="gpujpeg_tpu/models/decoder.py:390",
               bound_by="bytes", err=0, paths={},
               note="port-only (the JAX package integrates DC in XLA, no "
                    "pallas_call); ms, bound, plain and library of the "
                    "planar 4:4:4 tuned frame, every layout's in paths "
                    "(with the parent's ms given --parent, the launches "
                    "and device operations a call, the probe stages); "
                    "library_ms is the torch cumsum chain it replaces "
                    "(_dc_fixup_t, timed here, never used); launches over "
                    "every decode window")
    for tag, *_ in SESSION_LAYOUTS:
        data = enc.encode(frame, session_params(gt, tag))
        hf = dec.prepare(data)
        p = hf.plan
        words, nbits = dec.upload(hf)
        bstart, _ea = scan_call(words, nbits, p)
        coefs, _ec = block_call(words, bstart, p)
        del words, bstart
        nseg = coefs.shape[1] // p.bps
        got, ref = coefs.clone(), coefs.clone()
        _kernels.reset_launches()
        tdec.dc_fixup(got, p)
        launches = _kernels.LAUNCHES["dc_fixup"]
        _, plain_ms = once_ms(torch, lambda: tdec._dc_fixup_t(
            ref, nseg, p.bps, p.comp_slots))
        err = diff(got, ref)
        rec["err"] = max(rec["err"], err)
        if err:
            raise AssertionError(f"dc_fixup differs from _dc_fixup_t "
                                 f"({tag})")
        # the probe's full stage on the same coefficients
        pr = coefs.clone()
        tdec.dc_fixup_probe(pr, p, "full")
        probe_err = diff(pr, got)
        if probe_err:
            raise AssertionError(f"dc_fixup {tag}: the probe's full stage "
                                 "differs from the kernel")
        del pr
        tile, tiles, vecs, mode = tdec.fixup_layout(
            nseg, p.bps, coefs.data_ptr() % 16 == 0)
        path = dict(rows=nseg, slots_a_row=p.bps, layout=mode,
                    vectors_a_thread=vecs, tile_slots=tile, tiles=tiles,
                    launches_a_call=launches, plain_ms=plain_ms)
        if PARENT is not None:
            # the parent's fix-up of the same differential coefficients
            pg = coefs.clone()
            path["parent_launches_a_call"] = PARENT.fixup(torch, pg, p)
            path["parent_err"] = diff(pg, got)
            if path["parent_err"]:
                raise AssertionError(f"dc_fixup {tag}: the parent's fix-up "
                                     "differs from this tree's")
            del pg
        # from here on each launch integrates coefs again, in place
        path["ms"] = event_ms(torch, lambda: tdec.dc_fixup(coefs, p), 20,
                              flush)
        path["device_ops_a_call"] = graph_nodes(
            torch, lambda: tdec.dc_fixup(coefs, p))
        if PARENT is not None:
            path["parent_ms"] = event_ms(
                torch, lambda: PARENT.fixup(torch, coefs, p), 20, flush)
            path["ms_again"] = event_ms(
                torch, lambda: tdec.dc_fixup(coefs, p), 20, flush)
            path["parent_device_ops_a_call"] = graph_nodes(
                torch, lambda: PARENT.fixup(torch, coefs, p))
        path["probe"] = {st: event_ms(
            torch, lambda: tdec.dc_fixup_probe(coefs, p, st), 20, flush)
            for st in _kernels.PROBE_STAGES}
        path["probe"]["max_abs_err"] = probe_err
        path["library_ms"] = event_ms(torch, lambda: tdec._dc_fixup_t(
            coefs, nseg, p.bps, p.comp_slots), 10, flush)
        # the DC row read once and written once
        path["bound_ms"] = 4 * coefs.shape[1] / PEAK_BYTES_S * 1e3
        rec["paths"][tag] = path
        log(f"[session] dc_fixup {tag}: {nseg} rows x {p.bps} slots "
            f"(layout {mode}, {vecs} vectors a thread, {tiles} tiles of "
            f"{tile} slots), {launches} launch a call, "
            f"device operations {path['device_ops_a_call']}; equal to "
            f"_dc_fixup_t; {path['ms']:.4f} ms (bound "
            f"{path['bound_ms']:.4f})"
            + (f" [parent {path['parent_ms']:.4f} in "
               f"{path['parent_launches_a_call']} launches, device "
               f"operations {path['parent_device_ops_a_call']}; again "
               f"{path['ms_again']:.4f}]" if PARENT is not None else "")
            + f", probe {path['probe']}, torch cumsum chain "
            f"{path['library_ms']:.4f} ms, plain once {plain_ms:.3f} ms")
        del coefs, got, ref
    rec.update({k: rec["paths"]["planar_444"][k]
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    return rec


def steady(np, walls) -> str:
    """quartiles() of the ms between yields after the first (which holds
    the pipeline's fill)."""
    return quartiles(np, walls[1:])


def yield_ms(gen, keep=True):
    """(the outputs of a pipelined generator, kept or dropped; the host ms
    from the start to its first yield and between its yields)."""
    outs, walls = [], []
    t0 = time.perf_counter()
    for out in gen:
        t1 = time.perf_counter()
        walls.append((t1 - t0) * 1e3)
        t0 = t1
        if keep:
            outs.append(out)
        del out
    return outs, walls


def sequential_ms(fn, inputs) -> list:
    """Host ms of fn(x) for each input, one after the other."""
    walls = []
    for x in inputs:
        t0 = time.perf_counter()
        fn(x)
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def encode_split(torch, np, enc, order, params, tag) -> None:
    """The host's share of an encode, frame by frame: the copy into pinned
    memory (Staging.pinned), the queueing of the upload and the kernels
    (Encoder._device_rows), and the copy back with the assembly
    (Encoder.assemble, waiting for the frame's kernels)."""
    geo = enc.resolve(order[0], params)
    pin, launch, finish = [], [], []
    for f in order:
        t0 = time.perf_counter()
        x = enc._staging.pinned(torch.from_numpy(f))
        t1 = time.perf_counter()
        res = enc._device_rows(x, geo)
        t2 = time.perf_counter()
        enc.assemble(geo, res)
        t3 = time.perf_counter()
        pin.append((t1 - t0) * 1e3)
        launch.append((t2 - t1) * 1e3)
        finish.append((t3 - t2) * 1e3)
    log(f"[session {tag}] host split of sequential encodes (median ms): "
        f"pinned copy {np.median(pin):.3f}, queue upload and kernels "
        f"{np.median(launch):.3f}, rows back and assembly "
        f"{np.median(finish):.3f}")


def session_phases(torch, np, gt, dev, flush):
    """Step 11, [session]: the session surface at 8K Q75, restart auto, in
    planar 4:4:4 and interleaved 4:2:0; returns the dc_fixup record.

      a. the DC fix-up kernel against _dc_fixup_t on the four tuned
         layouts' coefficients and on restart-0 streams' (fixup_times);
      b. warm-up: Encoder.allocate, then a first encode, and
         Decoder.warmup, then a first decode, each in a fresh session,
         beside a fresh session's first frame without them (the kernel
         libraries are loaded in the process by then, and PyTorch's
         caching host allocator keeps the pinned blocks of earlier
         sessions);
      c. encode_pipelined over SESSION_FRAMES frames (three distinct ones
         in turn) in a main-path window: every stream byte for byte
         sequential encode()'s; ms between yields beside sequential
         encode()'s ms a frame, in the order sequential, pipelined
         (streams kept), pipelined (each dropped), sequential (each
         dropped); the host split of an encode (encode_split);
      d. decode_pipelined over those streams in a main-path window, every
         yielded array kept and compared with sequential decode() after
         the run (a later frame writing an earlier frame's array would
         show); then a run that drops each array and another sequential
         one; ms as in c;
      e. the device-only decode: compile_stream_pipeline's fn gives
         decode()'s pixels; its CUDA-event ms;
      f. get_stats() with perf_stats on, one frame of each session;
      g. estimate_memory of one 8K frame in the four tuned layouts, with
         Annex-K tables and at restart interval 0, against the peak of
         torch.cuda.max_memory_allocated over one encode of it (less what
         was allocated before): the estimate must not be below."""
    import io

    from gpujpeg_tpu_torch.ops import _kernels

    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    frame = make_frame(torch, "gradient", 700, H8K, W8K, dev).cpu().numpy()
    rec = fixup_times(torch, np, gt, dev, enc, dec, frame, flush)
    pi = gt.ImageParameters(width=W8K, height=H8K,
                            color_space=gt.ColorSpace.RGB,
                            pixel_format=gt.PixelFormat.P444_U8_P012)
    for li, tag in enumerate(("planar_444", "il_420")):
        params = session_params(gt, tag)
        il = tag.startswith("il")

        # -- b. warm-up ------------------------------------------------------
        def wall(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        data, cold_enc = wall(lambda: gt.Encoder(device=dev).encode(
            frame, params))
        warm = gt.Encoder(device=dev)
        _, alloc = wall(lambda: warm.allocate(params, pi))
        _, first_enc = wall(lambda: warm.encode(frame, params))
        _, cold_dec = wall(lambda: gt.Decoder(device=dev).decode(data))
        wdec = gt.Decoder(device=dev)
        _, warmup = wall(lambda: wdec.warmup(data))
        _, first_dec = wall(lambda: wdec.decode(data))
        log(f"[session {tag}] warm-up ms (fresh sessions): encode cold "
            f"first frame {cold_enc:.3f}; allocate {alloc:.3f} then first "
            f"frame {first_enc:.3f}; decode cold first frame "
            f"{cold_dec:.3f}; warmup {warmup:.3f} then first frame "
            f"{first_dec:.3f}")

        # -- c. pipelined encode ---------------------------------------------
        frames = [make_frame(torch, "gradient", 710 + 10 * li + i, H8K, W8K,
                             dev).cpu().numpy() for i in range(3)]
        order = [frames[i % 3] for i in range(SESSION_FRAMES)]
        seq = [enc.encode(f, params) for f in frames]
        seq_walls = sequential_ms(lambda f: enc.encode(f, params), order)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        outs, pwalls = yield_ms(enc.encode_pipelined(order, params))
        end_window()
        names = ("pre_rgb_to_planes", "fdct_quant", "huffman_segments")
        ln = {n: _kernels.LAUNCHES[n] for n in names}
        if min(ln.values()) <= 0 or _kernels.LAUNCHES["pack_stuff_rows"]:
            raise AssertionError(f"encode_pipelined {tag}: launches {ln}")
        bad = [i for i, o in enumerate(outs) if o != seq[i % 3]]
        if len(outs) != SESSION_FRAMES or bad:
            raise AssertionError(f"encode_pipelined {tag}: streams {bad} "
                                 "differ from sequential encode()")
        del outs
        p2 = yield_ms(enc.encode_pipelined(order, params), keep=False)[1]
        s2 = sequential_ms(lambda f: enc.encode(f, params), order)
        log(f"[session {tag}] encode_pipelined: {SESSION_FRAMES} streams "
            f"== sequential encode(), launches {ln}; ms between yields "
            f"after the first, streams kept (new memory for each): "
            f"{steady(np, pwalls)}; first {pwalls[0]:.3f}")
        log(f"[session {tag}] encode_pipelined, each stream dropped (as "
            f"the sequential runs drop theirs): ms between yields after "
            f"the first, {steady(np, p2)}; first {p2[0]:.3f}")
        log(f"[session {tag}] sequential encode() ms a frame (runs 1 and 2 "
            f"before and after the pipelined), run 1: "
            f"{quartiles(np, seq_walls)}; run 2: {quartiles(np, s2)}")
        encode_split(torch, np, enc, order, params, tag)

        # -- d. pipelined decode ---------------------------------------------
        streams = [seq[i % 3] for i in range(SESSION_FRAMES)]
        refs = [dec.decode(s) for s in seq]
        seq_walls = sequential_ms(dec.decode, streams)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        kept, pwalls = yield_ms(dec.decode_pipelined(streams))
        end_window()
        names = ("huffdec_scan", "huffdec_block", "dc_fixup") + (
            ("idct_planes", "post_rgb") if il else ("dpost_rgb",))
        ln = {n: _kernels.LAUNCHES[n] for n in names}
        if min(ln.values()) <= 0:
            raise AssertionError(f"decode_pipelined {tag}: launches {ln}")
        bad = [i for i, o in enumerate(kept)
               if not np.array_equal(o, refs[i % 3])]
        if len(kept) != SESSION_FRAMES or bad:
            raise AssertionError(f"decode_pipelined {tag}: arrays {bad} "
                                 "differ from sequential decode()")
        del kept
        d2 = yield_ms(dec.decode_pipelined(streams), keep=False)[1]
        s2 = sequential_ms(dec.decode, streams)
        log(f"[session {tag}] decode_pipelined: {SESSION_FRAMES} arrays "
            f"kept, each == sequential decode() after the run, launches "
            f"{ln}; ms between yields after the first, arrays kept (each a "
            f"new pinned block): {steady(np, pwalls)}; first "
            f"{pwalls[0]:.3f}")
        log(f"[session {tag}] decode_pipelined, each array dropped: ms "
            f"between yields after the first, {steady(np, d2)}")
        log(f"[session {tag}] sequential decode() ms a frame (runs 1 and 2 "
            f"before and after the pipelined), run 1: "
            f"{quartiles(np, seq_walls)}; run 2: {quartiles(np, s2)}")

        # -- e. device-only decode -------------------------------------------
        fn, words, nbits = dec.compile_stream_pipeline(seq[0])
        if not np.array_equal(fn(words, nbits).cpu().numpy(), refs[0]):
            raise AssertionError(f"compile_stream_pipeline {tag}: pixels "
                                 "differ from decode()")
        ms = event_ms(torch, lambda: fn(words, nbits), 10, flush)
        log(f"[session {tag}] compile_stream_pipeline fn == decode(); "
            f"device ms {ms:.4f} ({words.numel() * 4} B of words)")
        del fn, words, nbits, refs

        # -- f. stats ----------------------------------------------------------
        enc.perf_stats = dec.perf_stats = True
        enc.encode(frames[0], params)
        dec.decode(seq[0])
        enc.perf_stats = dec.perf_stats = False
        for name, st in (("encoder", enc.get_stats()),
                         ("decoder", dec.get_stats())):
            buf = io.StringIO()
            st.print(file=buf)
            log(f"[session {tag}] {name} get_stats(), perf_stats on: "
                + "; ".join(x.strip() for x in buf.getvalue().splitlines())
                + (f"; duration_memory_to {st.duration_memory_to:.4f} ms"
                   if name == "encoder" else ""))
        log(f"[session {tag}] aggregate {enc.aggregate.summary()}; decoder "
            f"{dec.get_stats().summary()}")

    # -- g. memory -------------------------------------------------------------
    cases = [(tag, session_params(gt, tag)) for tag in (
        "planar_444", "il_420", "il_444", "planar_420")]
    cases += [("annexk_444", foreign_params(gt, False, None, "annexk",
                                            gt.RESTART_AUTO)),
              ("restart0_444", session_params(gt, "restart0_444"))]
    for tag, params in cases:
        enc.encode(frame, params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        enc.encode(frame, params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        est = gt.Encoder.estimate_memory(params, pi)
        log(f"[session memory] {tag}: estimate_memory {est} B, peak of one "
            f"encode {peak} B ({est / max(peak, 1):.3f}x)")
        if est < peak:
            raise AssertionError(f"estimate_memory {tag} below the peak")
    return rec


#: the [formats] step's main-path layouts: tag -> (input kind, sampling
#: or None for the input format's own, interleaved, output request (a
#: PixelFormat or a PixelFormatRequest), the colour space of the input
#: and the output: YUV data (UYVY, planar) is the JPEG's YCbCr, so the
#: decoded raw output compares with the input)
FORMAT_LAYOUTS = {
    "grey": ("u8", None, False, "U8", "RGB"),
    "uyvy_422": ("uyvy", None, False, "P422_U8_P1020",
                 "YCBCR_BT601_256LVLS"),
    "rgba_four": ("rgba", None, False, "P4444_U8_P0123", "RGB"),
    "p420_il_420": ("p420", ((2, 2), (1, 1), (1, 1)), True, "STD",
                    "YCBCR_BT601_256LVLS"),
    "il_411": ("p444", ((4, 1), (1, 1), (1, 1)), True, "P444_U8_P0P1P2",
               "YCBCR_BT601_256LVLS"),
    "rgb_to_rgba": ("rgb", None, False, "P4444_U8_P0123", "RGB"),
}
#: 8K frames of each [formats] layout timed after the three counted
FORMAT_EXTRA = 3

#: the [formats] step's kernel instances: record -> (kernel, the layout
#: whose windows count its launches or None, the 8K case: for the
#: preprocessor an input kind and a sampling, for the postprocessor an
#: output format and a sampling, for dpost a sampling)
FORMAT_RECORDS = {
    "pre_rgb_to_planes:u8": ("pre_rgb_to_planes", "grey", ("u8", None)),
    "pre_rgb_to_planes:uyvy": ("pre_rgb_to_planes", "uyvy_422",
                               ("uyvy", None)),
    "pre_rgb_to_planes:p420": ("pre_rgb_to_planes", "p420_il_420",
                               ("p420", None)),
    "pre_rgb_to_planes:p444": ("pre_rgb_to_planes", "il_411",
                               ("p444", None)),
    "pre_rgb_to_planes:rgba": ("pre_rgb_to_planes", "rgba_four",
                               ("rgba", None)),
    "post_rgb:rgba_444": ("post_rgb", None,
                          ("P4444_U8_P0123", ((1, 1),) * 3)),
    "post_rgb:rgba_420": ("post_rgb", None,
                          ("P4444_U8_P0123", ((2, 2), (1, 1), (1, 1)))),
    "post_rgb:four": ("post_rgb", "rgba_four",
                      ("P4444_U8_P0123", ((1, 1),) * 4)),
    "post_rgb:u8": ("post_rgb", "grey", ("U8", ((1, 1),))),
    "post_rgb:p420": ("post_rgb", "p420_il_420",
                      ("P420_U8_P0P1P2", ((2, 2), (1, 1), (1, 1)))),
    "post_rgb:uyvy": ("post_rgb", "uyvy_422",
                      ("P422_U8_P1020", ((2, 1), (1, 1), (1, 1)))),
    "dpost_rgb:rgba_444": ("dpost_rgb", "rgb_to_rgba", ((1, 1),) * 3),
    "dpost_rgb:rgba_420": ("dpost_rgb", None,
                           ((2, 2), (1, 1), (1, 1))),
}
#: the vector instance (prepost_kernel.INSTANCES)
#: each pre and post record must launch at 8K
FORMAT_INSTANCE = {
    "pre_rgb_to_planes:u8": "u8_dx1", "pre_rgb_to_planes:uyvy": "uyvy_dx2",
    "pre_rgb_to_planes:p420": "planar_half_dx2",
    "pre_rgb_to_planes:p444": "planar_dx1",
    "pre_rgb_to_planes:rgba": "rgba_dx1",
    "post_rgb:rgba_444": "rgba_dx1", "post_rgb:rgba_420": "rgba_dx2",
    "post_rgb:four": "rgba_dx1", "post_rgb:u8": "u8_dx1",
    "post_rgb:p420": "planar_half_dx2", "post_rgb:uyvy": "uyvy_dx2"}
#: why no one PyTorch call computes a record's function (the records
#: without one; U8 in and out have F.pad and a slice copy)
FORMAT_NO_LIBRARY = {
    "pre_rgb_to_planes:uyvy": "UYVY pairs to 4:2:2 planes through the "
    "fixed-point RGB to YCbCr transform",
    "pre_rgb_to_planes:p420": "three planes upsampled, transformed in "
    "fixed point and decimated",
    "pre_rgb_to_planes:p444": "three planes transformed in fixed point",
    "pre_rgb_to_planes:rgba": "RGBA rows to four planes, three of them "
    "through the fixed-point transform",
    "post_rgb:rgba_444": "the fixed-point YCbCr to RGB transform, then "
    "RGBA rows with alpha 255",
    "post_rgb:rgba_420": "4:2:0 chroma upsampled, the fixed-point "
    "transform, RGBA rows",
    "post_rgb:four": "three planes through the fixed-point transform and "
    "a 4th raw, interleaved",
    "post_rgb:p420": "the fixed-point transform of every kept pixel, "
    "stored as decimated planes",
    "post_rgb:uyvy": "the fixed-point transform, packed as u y0 v y1 "
    "pairs"}
#: the JAX kernels the instances replace (or, where the JAX package runs
#: XLA for a format, the Pallas kernel of the same stage)
FORMAT_REPLACES = {"pre_rgb_to_planes": "gpujpeg_tpu/ops/prepost_kernel.py:88",
                   "post_rgb": "gpujpeg_tpu/ops/prepost_kernel.py:231",
                   "dpost_rgb": "gpujpeg_tpu/ops/prepost_kernel.py:379"}


def format_frame(torch, kind, seed, h, w, dev, pad=0):
    """A seeded raw frame of an input kind, made on the device and
    returned on the host: (H, W) greyscale, (H, W, 3) RGB, (H, W, 4) RGBA
    (alpha a ramp), flat UYVY or planar 4:2:0 / 4:4:4 buffers; flat
    packed rows padded by pad bytes."""
    rgb = make_frame(torch, "gradient", seed, h, w, dev)
    if kind == "u8":
        out = rgb[..., 0]
    elif kind == "rgb":
        out = rgb
    elif kind == "rgba":
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        alpha = ((xx * 3 + yy * 5) % 256).to(torch.uint8)
        out = torch.cat([rgb, alpha[..., None]], -1)
    elif kind == "uyvy":
        out = torch.stack([rgb[:, ::2, 1], rgb[:, ::2, 0], rgb[:, ::2, 2],
                           rgb[:, 1::2, 0]], -1).reshape(h, 2 * w)
    elif kind in ("p420", "p444"):
        s = 2 if kind == "p420" else 1
        out = torch.cat([rgb[..., 0].reshape(-1),
                         rgb[::s, ::s, 1].reshape(-1),
                         rgb[::s, ::s, 2].reshape(-1)])
    else:
        raise ValueError(kind)
    if pad:
        rows = out.reshape(h, -1)
        out = torch.cat([rows, torch.full((h, pad), 7, dtype=torch.uint8,
                                          device=dev)], 1).reshape(-1)
    elif kind == "uyvy":
        out = out.reshape(-1)
    return out.contiguous().cpu().numpy()


#: input kind -> its pixel format
FORMAT_OF = {"u8": "U8", "rgb": "P444_U8_P012", "rgba": "P4444_U8_P0123",
             "uyvy": "P422_U8_P1020", "p420": "P420_U8_P0P1P2",
             "p444": "P444_U8_P0P1P2"}


def format_params(gt, kind, samp, il, h, w, pad=0, cs="RGB"):
    """(Parameters, ImageParameters) of a [formats] input."""
    p = gt.Parameters(quality=QUALITY, restart_interval=gt.RESTART_AUTO,
                      interleaved=il)
    if samp:
        p = p.chroma_subsampled(samp)
    pi = gt.ImageParameters(width=w, height=h,
                            color_space=gt.ColorSpace[cs],
                            pixel_format=gt.PixelFormat[FORMAT_OF[kind]],
                            width_padding=pad)
    return p, pi


def format_request(gt, name, cs="RGB"):
    """ImageParameters asking a decoder for a format or a pseudo format."""
    from gpujpeg_tpu_torch.types import PixelFormatRequest

    pf = (gt.PixelFormat[name] if name in gt.PixelFormat.__members__
          else PixelFormatRequest[name])
    return gt.ImageParameters(color_space=gt.ColorSpace[cs],
                              pixel_format=pf)


class PlainCalls:
    """Counts the calls of the plain pre- and postprocessor inside a
    window (sample.preprocess and sample.postprocess, which every plain
    version of the pixel stages reaches): a card path must make none."""

    def __init__(self):
        from gpujpeg_tpu_torch.ops import sample

        self.sample = sample
        self.calls = 0
        self.real = (sample.preprocess, sample.postprocess)

    def __enter__(self):
        def count(fn):
            def wrapped(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return wrapped

        self.sample.preprocess = count(self.real[0])
        self.sample.postprocess = count(self.real[1])
        return self

    def __exit__(self, *exc):
        self.sample.preprocess, self.sample.postprocess = self.real
        return False


def format_instances(torch, np, gt, dev, flush, kernels):
    """[formats] a: each pre, post and dpost record at 8K against its plain
    version (error 0), its CUDA-event ms beside its bound, the plain
    version's ms and, where one PyTorch call computes the same, that
    call's ms.  A pre or post record must launch its vector instance
    (FORMAT_INSTANCE, counted in _kernels.INSTANCES); the generic
    instance runs on the same input, reached by patching the chooser,
    and is held at error 0 and timed beside it."""
    import torch.nn.functional as F

    from gpujpeg_tpu_torch.ops import _kernels, prepost_kernel
    from gpujpeg_tpu_torch.utils.geometry import get_geometry

    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    for name, (key, _lay, case) in FORMAT_RECORDS.items():
        k = kernels[name]
        library = None
        if key == "pre_rgb_to_planes":
            kind, samp = case
            raw = torch.from_numpy(format_frame(torch, kind, 900, H8K, W8K,
                                                dev)).to(dev)
            p, pi = format_params(gt, kind, samp, False, H8K, W8K)
            geo = enc.resolve(raw, p, pi)
            fn = lambda: prepost_kernel.preprocess_packed(raw, geo, pi)
            _kernels.reset_launches()
            got = fn()
            inst = dict(_kernels.INSTANCES)
            ref, k["plain_ms"] = once_ms(
                torch, lambda: prepost_kernel.preprocess_packed_plain(
                    raw, geo, pi))
            err_of = lambda out: max(diff(a, b) for a, b in zip(out, ref))
            k["err"] = err_of(got)
            out_bytes = sum(g_.numel() for g_ in got)
            k["bound_ms"] = (raw.numel() + out_bytes) / PEAK_BYTES_S * 1e3
            if kind == "u8":    # one plane: the frame zero-padded
                c0 = geo.components[0]
                library = lambda: F.pad(
                    raw, (0, c0.data_width - W8K, 0, c0.data_height - H8K))
            del got
        elif key == "post_rgb":
            pf, samp = case
            pi = format_request(gt, pf).with_(width=W8K, height=H8K)
            geo = get_geometry(gt.Parameters(
                quality=QUALITY, restart_interval=8).chroma_subsampled(samp),
                pi)
            g = torch.Generator(device=dev)
            g.manual_seed(901)
            planes = [torch.randint(0, 256, (c.data_height, c.data_width),
                                    generator=g, device=dev,
                                    dtype=torch.uint8)
                      for c in geo.components]
            fn = lambda: prepost_kernel.postprocess_packed(planes, geo, pi)
            _kernels.reset_launches()
            got = fn()
            inst = dict(_kernels.INSTANCES)
            ref, k["plain_ms"] = once_ms(
                torch, lambda: prepost_kernel.postprocess_packed_plain(
                    planes, geo, pi))
            err_of = lambda out: (diff(out, ref) if out.shape == ref.shape
                                  else 255)
            k["err"] = err_of(got)
            k["bound_ms"] = (sum(p_.numel() for p_ in planes)
                             + got.numel()) / PEAK_BYTES_S * 1e3
            if pf == "U8":      # one plane: its image part, copied
                library = lambda: planes[0][:H8K, :W8K].clone()
            del got
        else:
            frame = make_frame(torch, "gradient", 902, H8K, W8K,
                               dev).cpu().numpy()
            data = enc.encode(frame, gt.Parameters(
                quality=QUALITY, restart_interval=gt.RESTART_AUTO)
                .chroma_subsampled(case))
            hf = dec.prepare(data, format_request(gt, "P4444_U8_P0123"))
            coefs, _ea, _ec = dec.coefficients_t(hf)
            p = hf.plan
            if not prepost_kernel.decode_post_supported(p.geo, hf.out_pi):
                raise AssertionError(f"{name}: the 8K stream does not take "
                                     "dpost")
            fn = lambda: prepost_kernel.decode_post(coefs, p.qtabs, p.geo,
                                                    hf.out_pi)
            got = fn()
            ref, k["plain_ms"] = once_ms(
                torch, lambda: prepost_kernel.decode_post_plain(
                    coefs, p.qtabs, p.geo, hf.out_pi))
            k["err"] = diff(got, ref)
            if got.shape != (H8K, W8K, 4) or not bool(
                    (got[..., 3] == 255).all()):
                raise AssertionError(f"{name}: not RGBA with alpha 255")
            dpost_times(torch, k, coefs, got, p, hf, flush, probe=False)
            del got, ref, coefs
        torch.cuda.synchronize()
        if k["err"]:
            raise AssertionError(f"{name} differs from its plain version at "
                                 "8K")
        if key != "dpost_rgb":
            want = {f"{key}/{FORMAT_INSTANCE[name]}": 1}
            if inst != want:
                raise AssertionError(f"{name}: launched {inst}, not {want}")
            k["instance"] = FORMAT_INSTANCE[name]
            # mean (the records' ms) and median of 20: a launch now and
            # then takes 2-4x the others, which moves the mean
            ts = event_times(torch, fn, 20, flush)
            k["ms"], k["ms_median"] = sum(ts) / len(ts), ts[len(ts) // 2]
            if library is not None:
                ts = event_times(torch, library, 20, flush)
                k["library_ms"] = sum(ts) / len(ts)
                k["library_ms_median"] = ts[len(ts) // 2]
            chooser = ("pre_instance" if key == "pre_rgb_to_planes"
                       else "post_instance")
            real = getattr(prepost_kernel, chooser)
            setattr(prepost_kernel, chooser, lambda *a: 0)
            try:
                _kernels.reset_launches()
                gen = fn()
                torch.cuda.synchronize()
                if _kernels.INSTANCES != {f"{key}/generic": 1} or err_of(
                        gen):
                    raise AssertionError(f"{name}: the generic instance "
                                         "differs or did not run")
                del gen
                k["generic_ms"] = event_ms(torch, fn, 20, flush)
            finally:
                setattr(prepost_kernel, chooser, real)
            del ref
            if k["library_ms"] is None:
                k["library_note"] = ("none: " + FORMAT_NO_LIBRARY[name]
                                     + "; no one PyTorch call computes it")
        lib = k["library_ms"]
        log(f"[formats a] {name}: error 0 at 8K; {k['ms']:.4f} ms"
            + (f" (median {k['ms_median']:.4f})" if "ms_median" in k
               else "")
            + (f" [generic {k['generic_ms']:.4f}]" if "generic_ms" in k
               else "")
            + f" (bound {k['bound_ms']:.4f} ms by {k['bound_by']}, "
            f"{k['ms'] / k['bound_ms']:.2f}x), plain {k['plain_ms']:.3f} "
            "ms, library "
            + (k.get("library_note", "-") if lib is None
               else f"{lib:.4f} ms ({k['ms'] / lib:.2f}x)"
               + (f", median {k['library_ms_median']:.4f}"
                  if "library_ms_median" in k else ""))
            + (f"; instance {k['instance']}" if "instance" in k else ""))


#: [formats] b: input kinds and (sampling, interleaved, options) encoded
#: at HD on the card and on the CPU
FORMAT_HD_ENCODES = (
    ("u8", 0, None, False, ()), ("u8", 0, ((1, 1),) * 3, False, ()),
    ("rgb", 5, None, False, ()), ("rgb", 0, ((1, 1),), False, ()),
    ("rgba", 0, None, False, ()), ("rgba", 0, None, True, ()),
    ("rgba", 3, None, False, ()), ("uyvy", 4, None, False, ()),
    ("uyvy", 0, None, True, ()), ("p444", 0, None, False, ()),
    ("p420", 0, None, False, ()),
    ("rgb", 0, ((4, 1), (1, 1), (1, 1)), False, ()),
    ("p444", 0, ((4, 1), (1, 1), (1, 1)), True, ()),
    ("rgb", 0, ((2, 2), (2, 1), (2, 1)), True, ()),
    ("rgb", 0, None, False, (("enc_opt_flipped", "true"),
                             ("enc_opt_channel_remap", "2F0Z"))))


def format_hd(torch, np, gt, dev):
    """[formats] b: 1920x1080 card bytes and arrays against the CPU's for
    every input and output format, 4:1:1, 4 components and the
    options."""
    h, w = 1080, 1920
    streams = {}
    for i, (kind, pad, samp, il, opts) in enumerate(FORMAT_HD_ENCODES):
        raw = format_frame(torch, kind, 60 + i, h, w, dev, pad)
        p, pi = format_params(gt, kind, samp, il, h, w, pad)
        card, cpu = gt.Encoder(device=dev), gt.Encoder(device="cpu")
        for key, value in opts:
            card.set_option(key, value)
            cpu.set_option(key, value)
        data = card.encode(raw, p, pi)
        if data != cpu.encode(raw, p, pi):
            raise AssertionError(f"HD {kind} {samp} il={il} pad={pad} "
                                 f"{opts}: card bytes differ from the CPU's")
        streams[(kind, samp, il)] = data
    log(f"[formats b] HD encodes card == cpu: {len(FORMAT_HD_ENCODES)} "
        "input kinds and layouts (U8 2-D, RGB and RGBA flat with padded "
        "rows, RGBA at 4 components planar and interleaved, UYVY padded "
        "and interleaved, P444 and P420 planar, RGB at 1 component, U8 at "
        "3, 4:1:1 planar and interleaved, interleaved (2,2),(2,1),(2,1), "
        "flip and remap)")
    s420 = ((2, 2), (1, 1), (1, 1))
    rgb420 = gt.Encoder(device=dev).encode(
        format_frame(torch, "rgb", 90, h, w, dev),
        format_params(gt, "rgb", s420, False, h, w)[0])
    cases = [(rgb420, name, ()) for name in (
        "U8", "P444_U8_P012", "P4444_U8_P0123", "P422_U8_P1020",
        "P444_U8_P0P1P2", "P422_U8_P0P1P2", "P420_U8_P0P1P2", "NATIVE",
        "NO_ALPHA")]
    cases += [(streams[("u8", None, False)], "U8", ()),
              (streams[("u8", None, False)], "P420_U8_P0P1P2", ()),
              (streams[("rgba", None, False)], "P4444_U8_P0123", ()),
              (streams[("rgba", None, True)], "AUTODETECT", ()),
              (streams[("p444", ((4, 1), (1, 1), (1, 1)), True)],
               "P444_U8_P012", ()),
              (rgb420, "P444_U8_P012", (("dec_opt_flipped", "true"),
                                        ("dec_opt_channel_remap", "2F0"),
                                        ("dec_opt_alignment_bytes",
                                         "256")))]
    for data, name, opts in cases:
        card, cpu = gt.Decoder(device=dev), gt.Decoder(device="cpu")
        for key, value in opts:
            card.set_option(key, value)
            cpu.set_option(key, value)
        pi = format_request(gt, name)
        got, want = card.decode(data, pi), cpu.decode(data, pi)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"HD decode to {name} {opts}: card array "
                                 "differs from the CPU's")
    log(f"[formats b] HD decodes card == cpu: {len(cases)} (every output "
        "format and pseudo request of a 4:2:0 stream, greyscale, 4 "
        "components, 4:1:1, flip + remap + alignment)")


def format_main_path(torch, np, gt, dev):
    """[formats] c: three 8K frames of each FORMAT_LAYOUTS layout through
    Encoder.encode and their streams through Decoder.decode in main-path
    windows: launches (the pre and post kernels ran, through vector
    instances, and no plain version did), the PSNR of the decoded raw output against the input, wall ms
    (median and quartiles, FORMAT_EXTRA more frames) and a stage split
    (get_stats with perf_stats on).  Returns the launches by layout."""
    from gpujpeg_tpu_torch.ops import _kernels

    by_layout = {}
    for tag, (kind, samp, il, out, cs) in FORMAT_LAYOUTS.items():
        frames = [format_frame(torch, kind, 910 + i, H8K, W8K, dev)
                  for i in range(3)]
        p, pi = format_params(gt, kind, samp, il, H8K, W8K, cs=cs)
        req = format_request(gt, out, cs)
        enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
        launches = {}
        for stage in ("enc", "dec"):
            torch.cuda.synchronize()
            _kernels.reset_launches()
            walls, outs = [], []
            with PlainCalls() as plain:
                for i in range(3):
                    t0 = time.perf_counter()
                    outs.append(enc.encode(frames[i], p, pi)
                                if stage == "enc"
                                else dec.decode(streams[i], req))
                    walls.append((time.perf_counter() - t0) * 1e3)
            end_window()
            ln = {n: v for n, v in _kernels.LAUNCHES.items() if v}
            launches[stage] = ln
            inst = dict(_kernels.INSTANCES)
            if any(k_.endswith("/generic") for k_ in inst):
                raise AssertionError(f"[formats] {tag} {stage}: a generic "
                                     f"instance ran at 8K: {inst}")
            if plain.calls:
                raise AssertionError(f"[formats] {tag} {stage}: a plain "
                                     "pre/postprocessor ran on the card")
            need = (("pre_rgb_to_planes",) if stage == "enc" else
                    ("dpost_rgb",) if tag == "rgb_to_rgba" else
                    ("idct_planes", "post_rgb"))
            if any(ln.get(n, 0) != 3 for n in need):
                raise AssertionError(f"[formats] {tag} {stage}: launches "
                                     f"{ln}")
            if stage == "enc":
                streams = outs
                geo = enc.resolve(frames[0], p, pi)
                for s_ in streams:
                    check_stream(np, s_, geo.segment_count - geo.scan_count,
                                 f"8K {tag}")
                desc = (f"bytes {[len(s_) for s_ in streams]}, "
                        f"{geo.comp_count} components, sampling "
                        f"{[(c.samp_h, c.samp_v) for c in geo.components]}"
                        f", {'interleaved' if geo.interleaved else 'planar'}"
                        f" scans, rst {geo.param.restart_interval}")
            else:
                ref = frames
                if tag == "rgb_to_rgba":
                    ref = [np.concatenate([f, np.full(f.shape[:2] + (1,),
                                                      255, np.uint8)], -1)
                           for f in frames]
                if any(o.shape != r.shape for o, r in zip(outs, ref)):
                    raise AssertionError(f"[formats] {tag}: decoded shape "
                                         f"{outs[0].shape}, input "
                                         f"{ref[0].shape}")
                psnrs = [psnr(np, o, r) for o, r in zip(outs, ref)]
                if min(psnrs) < 20:
                    raise AssertionError(f"[formats] {tag}: PSNR {psnrs}")
                desc = (f"output {out} {outs[0].shape}, PSNR against the "
                        "input " + ", ".join(f"{v:.2f}" for v in psnrs)
                        + " dB")
            for i in range(FORMAT_EXTRA):
                t0 = time.perf_counter()
                if stage == "enc":
                    enc.encode(frames[i % 3], p, pi)
                else:
                    dec.decode(streams[i % 3], req)
                walls.append((time.perf_counter() - t0) * 1e3)
            log(f"[formats {tag} 8k {stage}] {desc}; launches {ln}, "
                f"instances {inst}; wall "
                "ms per frame (" + ("host frame in, bytes out" if stage ==
                                    "enc" else "bytes in, host array out")
                + "), " + quartiles(np, walls))
        enc.perf_stats = dec.perf_stats = True
        enc.encode(frames[0], p, pi)
        dec.decode(streams[0], req)
        es, ds = enc.get_stats(), dec.get_stats()
        log(f"[formats {tag} 8k stages] encode (CUDA events): upload "
            f"{es.duration_memory_to:.3f}, preprocessor "
            f"{es.duration_preprocessor:.3f}, DCT "
            f"{es.duration_dct_quantization:.3f}, Huffman "
            f"{es.duration_huffman_coder:.3f}, rows back "
            f"{es.duration_memory_from:.3f}, assembly (host) "
            f"{es.duration_stream:.3f} ms; decode: parse + unstuff (host) "
            f"{ds.duration_stream:.3f}, Huffman phases "
            f"{ds.duration_huffman_coder:.3f}, IDCT + pixels "
            f"{ds.duration_dct_quantization:.3f}, image back "
            f"{ds.duration_memory_from:.3f} ms")
        by_layout[tag] = launches
    return by_layout


def formats_phases(torch, np, gt, dev, flush):
    """Step 12, [formats]: every pixel format, component count and
    sampling; returns (kernel records, launches over its main-path
    windows).  a. the new instances at 8K (format_instances); b. HD card
    against CPU (format_hd); c. the FORMAT_LAYOUTS main paths
    (format_main_path)."""
    kernels = {}
    for name, (key, _lay, _c) in FORMAT_RECORDS.items():
        kernels[name] = dict(
            key=key, source=f"gpujpeg_tpu_torch/csrc/{key}.cu",
            replaces=FORMAT_REPLACES[key],
            bound_by="operations" if key == "dpost_rgb" else "bytes",
            library_ms=None, err=0)
    format_instances(torch, np, gt, dev, flush, kernels)
    format_hd(torch, np, gt, dev)
    by_layout = format_main_path(torch, np, gt, dev)
    launches = {}
    for name, (key, lay, _c) in FORMAT_RECORDS.items():
        if lay is None:
            launches[name] = 0
            kernels[name]["note"] = (
                "on no [formats] main-path layout; the instance is held "
                "against its plain version at 8K here and in "
                "tests/test_torch_kernels.py")
        else:
            stage = "enc" if key == "pre_rgb_to_planes" else "dec"
            launches[name] = by_layout[lay][stage].get(key, 0)
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{lay} path")
    return kernels, launches


def relayout_phase(torch, dev, flush):
    """Step 11: the relayout and primitive kernels of csrc/relayout.cu at
    the 8K shapes of the TPU probes they replace, on seeded u32 words;
    returns their kernel records (on no codec path: their launches are
    the main-path windows' counts, 0)."""
    from gpujpeg_tpu_torch.ops import relayout as rl

    g = torch.Generator(device=dev)
    g.manual_seed(61)

    def words(shape, high=1 << 32):
        return torch.randint(0, high, shape, generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def word_err(a, b) -> int:
        if a.shape != b.shape:
            return 1 << 32
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    def pack_library(x):
        R, C = x.shape
        return x.to(torch.uint8).view(R // 4, 4, C).permute(
            0, 2, 1).contiguous().view(torch.int32).view(R // 4, C)

    note = "probe; on no codec path"
    src = "gpujpeg_tpu_torch/csrc/relayout.cu"
    # name -> (replaces, note, [(kernel fn, plain fn, library fn, input)])
    cases = {
        "xbd_relayout": (
            "tools/proto_xbdkernel.py:47",
            note + "; also the function of tools/profile_transpose.py:71 "
            "(one block row a grid step); (4320, 1920) words, rst 8",
            [(lambda x: rl.xbd_relayout(x, 8),
              lambda x: rl.xbd_relayout_plain(x, 8),
              lambda x: rl.xbd_relayout_plain(x, 8),
              words((H8K, W8K // 4)))]),
        "transpose_u32": (
            "tools/profile_transpose.py:95",
            note + "; also tools/profile_prims.py:72; ms, plain, bound and "
            "library are means over (4224, 1920) and (1024, 23040) words",
            [(rl.transpose_u32, rl.transpose_u32_plain,
              lambda x: x.t().contiguous(), words(shape))
             for shape in ((4224, 1920), (1024, 23040))]),
        "pair_sum_rows": (
            "tools/profile_prims.py:102",
            note + "; (23040, 128) words",
            [(rl.pair_sum_rows, rl.pair_sum_rows_plain,
              lambda x: x[0::2] + x[1::2], words((23040, 128)))]),
        "pack_u8_quads": (
            "tools/profile_prims.py:135",
            note + "; (23040, 128) words of 0..255",
            [(rl.pack_u8_quads, rl.pack_u8_quads_plain, pack_library,
              words((23040, 128), 256))]),
    }
    kernels = {}
    for name, (replaces, nt, runs) in cases.items():
        k = dict(source=src, replaces=replaces, bound_by="bytes", err=0,
                 note=nt)
        ms, plain, lib, bound = [], [], [], []
        for fn, plain_fn, lib_fn, x in runs:
            got = fn(x)
            ref, p_ms = once_ms(torch, lambda: plain_fn(x))
            k["err"] = max(k["err"], word_err(got, ref),
                           word_err(lib_fn(x), ref))
            if k["err"]:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version at {tuple(x.shape)}")
            ms.append(event_ms(torch, lambda: fn(x), 20, flush))
            lib.append(event_ms(torch, lambda: lib_fn(x), 20, flush))
            plain.append(p_ms)
            bound.append((x.numel() + got.numel()) * 4 / PEAK_BYTES_S * 1e3)
            inst, floor = "", ""
            if name == "xbd_relayout":     # the C entry's rule, xbd_vector
                inst = (" (16-byte vector instance, rst 8)"
                        if rl.xbd_vector(x, 8) else " (generic instance)")
                k["note"] += "; instance:" + inst
            if name in ("pair_sum_rows", "pack_u8_quads"):
                inst = (" (16-byte vector instance)" if rl.row_vector(x)
                        else " (generic instance)")
                k.update(row_floor(torch, name, fn, x, got, flush))
                floor = (
                    f"; of 200: median {k['ms_median']:.4f} min "
                    f"{k['ms_min']:.4f} ms; empty kernel launched as it is: "
                    f"median {k['empty_ms_median']:.4f} min "
                    f"{k['empty_ms_min']:.4f} ms; copy_ of the same bytes: "
                    f"median {k['copy_ms_median']:.4f} min "
                    f"{k['copy_ms_min']:.4f} ms")
            log(f"[relayout] {name}{inst} {tuple(x.shape)} -> "
                f"{tuple(got.shape)}: equal to plain; {ms[-1]:.4f} ms (bound "
                f"{bound[-1]:.4f} ms by bytes), library {lib[-1]:.4f} ms, "
                f"plain {p_ms:.3f} ms{floor}")
            del got, ref
        k.update(ms=sum(ms) / len(ms), plain_ms=sum(plain) / len(plain),
                 library_ms=sum(lib) / len(lib),
                 bound_ms=sum(bound) / len(bound))
        kernels[name] = k
    return kernels


#: the keys of row_floor's records (ms of 200 launches each)
DIRECT_FRAMES = 3


def direct_streams(torch, np, gt, dev, enc, kind, params):
    """Three 8K frames of a layout of the direct route ("rgb": planar
    4:4:4, or "grey": U8) and their Q100 streams; the first stream's
    noise twin for the kernel check."""
    frames, streams = [], []
    for i in range(DIRECT_FRAMES + 1):
        f = make_frame(torch, "noise" if i == DIRECT_FRAMES else "gradient",
                       300 + i, H8K, W8K, dev)
        f = (f[..., 0].contiguous() if kind == "grey" else f).cpu().numpy()
        frames.append(f)
        streams.append(enc.encode(f, params))
    return frames, streams


def direct_phases(torch, np, gt, dev, flush):
    """Step 14 a, [tool]: the direct route of one block a segment at 8K
    Q100, restart auto (bps 1), in planar 4:4:4 RGB and greyscale U8;
    returns (the huffdec_block:direct record, its launches)."""
    from gpujpeg_tpu_torch.ops import _kernels, huffdec_kernel as thd

    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    params = gt.Parameters(quality=100, restart_interval=gt.RESTART_AUTO)
    rec = dict(source="gpujpeg_tpu_torch/csrc/huffdec_block.cu",
               replaces="gpujpeg_tpu/ops/huffdec_kernel.py:283",
               bound_by="bytes", library_ms=None, err=0, paths={},
               note="the direct instance (the JAX kernel's buffer mode, "
                    "with_cursor=False, sites :543/:552), phase C of one "
                    "block a segment from bit 0 to the segment's bit "
                    "count, a kernel of its own (rows staged a tile ahead, "
                    "the two-level direct_lut); ms, bound, plain and "
                    "tokens of the planar 4:4:4 frame, greyscale's in "
                    "paths, each with its probe stages, its token paths "
                    "(gradient and noise) and, given --parent, the parent "
                    "tree's instance on the same words (parent_ms); "
                    "launches over both layouts' windows of three frames")
    launches = 0

    def direct_call(words, nbits, p):
        return thd.decode_blocks_direct(words, nbits, p.nblocks, p.dc_luma,
                                        p.ac_luma, p.tables, p.pattern,
                                        p.direct_lut)

    for kind in ("rgb", "grey"):
        frames, streams = direct_streams(torch, np, gt, dev, enc, kind,
                                         params)
        paths = {}
        # -- the kernel against its plain version, gradient and noise -----
        for what, data in (("gradient", streams[0]), ("noise", streams[-1])):
            hf = dec.prepare(data)
            p = hf.plan
            if not p.direct or p.bps != 1:
                raise AssertionError(f"8K Q100 {kind}: bps {p.bps}, not the "
                                     "direct route")
            words, nbits = dec.upload(hf)
            coefs, err_c = direct_call(words, nbits, p)
            (p_coefs, p_err), ms = once_ms(
                torch, lambda: thd.decode_blocks_direct_plain(
                    words, nbits, p.nblocks, p.dc_luma, p.ac_luma, p.tables,
                    p.pattern))
            err = max(diff(coefs, p_coefs), diff(err_c, p_err))
            rec["err"] = max(rec["err"], err)
            if err or bool(err_c.any()):
                raise AssertionError(f"huffdec_block:direct differs from "
                                     f"its plain version or finds errors "
                                     f"({kind} {what})")
            # pixels: the same session's phases A and C and the fix-up,
            # through the same back half
            c_ac, e_a, e_c = dec._coefficients(p, words, nbits)
            via_ac = dec.back_half(c_ac, p, hf.out_pi).cpu().numpy()
            got = dec.decode(data)
            if not np.array_equal(got, via_ac) or bool(e_a.any()):
                raise AssertionError(f"8K Q100 {kind} {what}: the direct "
                                     "route's pixels differ from phases "
                                     "A+C's")
            paths[what] = token_paths(torch, words, nbits, p)
            log(f"[tool direct] 8K Q100 {kind} {what}: {len(data)} bytes, "
                f"{words.shape[0]} segments x {words.shape[1]} words; "
                "direct instance equal to plain (plain once "
                f"{ms:.1f} ms), pixels equal to phases A+C's; token paths "
                f"{json.dumps(paths[what])}")
            if what == "gradient":
                plain_ms = ms
            del coefs, p_coefs, c_ac, via_ac, words
        # -- main-path window: three frames through Decoder.decode ---------
        torch.cuda.synchronize()
        _kernels.reset_launches()
        walls = []
        for data, f in zip(streams[:DIRECT_FRAMES], frames):
            t0 = time.perf_counter()
            out = dec.decode(data)
            walls.append((time.perf_counter() - t0) * 1e3)
            if out.shape != f.shape or psnr(np, out, f) < 45:
                raise AssertionError(f"8K Q100 {kind} decode: {out.shape}, "
                                     f"PSNR {psnr(np, out, f):.2f} dB")
        end_window()
        counts = dict(_kernels.LAUNCHES)
        if counts["huffdec_block_direct"] != DIRECT_FRAMES or \
                counts["huffdec_scan"] or counts["huffdec_scan_sync"] or \
                counts["dc_fixup"] or counts["huffdec_block"]:
            raise AssertionError(f"8K Q100 {kind} window: launches {counts}")
        launches += counts["huffdec_block_direct"]
        for i in range(EXTRA_FRAMES):
            t0 = time.perf_counter()
            dec.decode(streams[i % DIRECT_FRAMES])
            walls.append((time.perf_counter() - t0) * 1e3)
        log(f"[tool direct] 8K Q100 {kind} window: launches "
            + str({n: c for n, c in counts.items() if c})
            + "; wall ms per frame (bytes in, host array out), "
            + quartiles(np, walls))
        # one more frame's stages, from the session's stats
        dec.perf_stats = True
        dec.decode(streams[0])
        dec.perf_stats = False
        st = dec.get_stats()
        stages = dict(parse_unstuff_ms=st.duration_stream,
                      phase_c_ms=st.duration_huffman_coder,
                      idct_pixels_ms=st.duration_dct_quantization,
                      image_back_ms=st.duration_memory_from,
                      device_ms=st.duration_in_gpu)
        log(f"[tool direct] 8K Q100 {kind} stages (get_stats under "
            "perf_stats: the parse on the host clock, the rest CUDA "
            "events): " + ", ".join(f"{k} {v:.3f}"
                                    for k, v in stages.items()))
        # -- times at the main path's shapes (the gradient stream) ---------
        hf = dec.prepare(streams[0])
        p = hf.plan
        words, nbits = dec.upload(hf)
        coefs, _e = direct_call(words, nbits, p)
        args = (words, nbits, p.nblocks, p.dc_luma, p.ac_luma, p.tables,
                p.pattern)
        ms = event_ms(torch, lambda: direct_call(words, nbits, p), 20, flush)
        extra = {}
        if PARENT is not None:
            # the parent tree's instance on the same words, then this
            # tree's again (parent, change in turns)
            got = PARENT.direct(torch, words, nbits, p)
            extra["parent_err"] = max(diff(got[0], coefs), diff(got[1], _e))
            if extra["parent_err"]:
                raise AssertionError(f"8K Q100 {kind}: the parent's direct "
                                     "instance differs from this tree's")
            extra["parent_ms"] = event_ms(
                torch, lambda: PARENT.direct(torch, words, nbits, p), 20,
                flush)
            extra["ms_again"] = event_ms(
                torch, lambda: direct_call(words, nbits, p), 20, flush)
            del got
        probe = probe_ms(
            torch, lambda st: thd.decode_blocks_direct_probe(
                *args, p.direct_lut, st),
            lambda: thd.decode_blocks_direct_plain(*args), flush,
            lambda out, ref: max(diff(out[0], ref[0]), diff(out[1], ref[1])))
        ac_ms = event_ms(torch, lambda: dec._coefficients(p, words, nbits),
                         10, flush)
        L = words.shape[0]
        read = (stream_word_bytes(nbits) + 4 * L * 4
                + p.direct_lut.numel() * 2)
        tokens = scan_tokens(torch, coefs, p)
        path = dict(ms=ms, plain_ms=plain_ms,
                    bound_ms=(read + L * 64 * 2 + L * 4) / PEAK_BYTES_S * 1e3,
                    **extra, a_c_fixup_ms=ac_ms, segments=L,
                    words_a_row=words.shape[1], tokens=tokens,
                    ns_per_token=ms * 1e6 / tokens, probe=probe,
                    token_paths=paths,
                    wall_ms_median=float(np.median(walls)), stages=stages)
        rec["paths"][kind] = path
        log(f"[tool direct] 8K Q100 {kind}: direct phase C {ms:.4f} ms "
            + (f"[parent {extra['parent_ms']:.4f}, again "
               f"{extra['ms_again']:.4f}] " if extra else "")
            + f"(bound {path['bound_ms']:.4f} ms by bytes, "
            f"{stream_word_bytes(nbits) / 1e6:.1f} MB of words, "
            f"{L * 128 / 1e6:.1f} MB of coefficients), phases A + C + "
            f"fix-up on the same stream {ac_ms:.4f} ms; {tokens} tokens, "
            f"{path['ns_per_token']:.4f} ns a token; probe stages (full | "
            f"loads, staged rows, zero tiles | no coefficient store) "
            f"{probe['full']:.4f} | {probe['load_store']:.4f} | "
            f"{probe['no_store']:.4f}")
        del words, coefs, frames, streams
    rec.update({k: rec["paths"]["rgb"][k]
                for k in ("ms", "plain_ms", "bound_ms", "tokens",
                          "ns_per_token", "parent_ms", "probe")
                if k in rec["paths"]["rgb"]})
    return rec, launches


def tool_call(args, cwd) -> tuple:
    """Run tpujpegtool_torch with args in cwd: (stdout, wall seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(here,
                                                       "tpujpegtool_torch"),
                          *args], cwd=cwd, capture_output=True, text=True,
                         timeout=300)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"tpujpegtool_torch {' '.join(args)} exited "
                             f"{out.returncode}:\n{out.stderr[-4000:]}")
    log(f"[tool cli] tpujpegtool_torch {' '.join(args)}: {wall:.2f} s")
    return out.stdout, wall


def cli_phase(torch, np, gt, dev) -> None:
    """Step 14 b, [tool]: the tool as a user runs it, a process of its own
    on the card, on PNM, PAM, Y4M, raw and .tst files (no PIL there): its
    files against in-process sessions' bytes and arrays."""
    import shutil

    from gpujpeg_tpu_torch.io import image as iio, pnm, tst, y4m
    from gpujpeg_tpu_torch.ops import color, sample

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "gpujpeg_tpu_torch", "_build", "tool")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        frame = make_frame(torch, "gradient", 400, H8K, W8K,
                           dev).cpu().numpy()
        with open(os.path.join(work, "in.ppm"), "wb") as f:
            f.write(pnm.save_pnm(gt.ImageParameters(width=W8K, height=H8K),
                                 frame))
        with open(os.path.join(work, "in.pgm"), "wb") as f:
            f.write(pnm.save_pnm(gt.ImageParameters(width=W8K, height=H8K),
                                 frame[..., 1]))
        h4, w4 = H8K // 2, W8K // 2
        pi4 = gt.ImageParameters(width=w4, height=h4,
                                 color_space=gt.ColorSpace.YCBCR_BT601,
                                 pixel_format=gt.PixelFormat.P420_U8_P0P1P2)
        seq = [torch.randint(0, 256, (w4 * h4 * 3 // 2,), device=dev,
                             dtype=torch.uint8,
                             generator=torch.Generator(device=dev)
                             .manual_seed(500 + i)).cpu().numpy()
               for i in range(8)]
        with open(os.path.join(work, "seq.y4m"), "wb") as f:
            f.write(y4m.save_y4m_frames(pi4, seq))
        tst_name = f"{W8K}x{H8K}.random_7.tst"
        walls = {}
        _, walls["encode"] = tool_call(
            ["-e", "-q", "75", "in.ppm", "out.jpg", tst_name, "tst.jpg",
             "in.pgm", "g.jpg"], work)
        _, walls["decode"] = tool_call(["-d", "out.jpg", "out.ppm", "g.jpg",
                                        "g.pgm"], work)
        _, walls["batch"] = tool_call(["-e", "-B", "4", "-q", "75",
                                       "seq.y4m", "f_%03d.jpg"], work)
        info, walls["info"] = tool_call(["-I", "out.jpg"], work)
        _, walls["convert"] = tool_call(["-C", "in.ppm", "c.yuv"], work)

        def read(name):
            with open(os.path.join(work, name), "rb") as f:
                return f.read()

        enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
        params = gt.Parameters(quality=75, restart_interval=gt.RESTART_AUTO)
        for src, jpg in (("in.ppm", "out.jpg"), (tst_name, "tst.jpg"),
                         ("in.pgm", "g.jpg")):
            arr, pi = iio.load(src if src.endswith(".tst")
                               else os.path.join(work, src))
            if read(jpg) != enc.encode(arr, params, pi):
                raise AssertionError(f"tool {src} -> {jpg} differs from "
                                     "Encoder.encode")
        want_tst, _ = tst.generate(tst_name)
        for jpg, out in (("out.jpg", "out.ppm"), ("g.jpg", "g.pgm")):
            arr, _pi = iio.load(os.path.join(work, out))
            if not np.array_equal(arr, dec.decode(read(jpg))):
                raise AssertionError(f"tool {jpg} -> {out} differs from "
                                     "Decoder.decode")
        for i, fr in enumerate(seq):
            if read("f_%03d.jpg" % i) != enc.encode(fr, params, pi4):
                raise AssertionError(f"tool -B frame {i} differs from "
                                     "Encoder.encode")
        if f"width: {W8K}\n" not in info or f"height: {H8K}\n" not in info:
            raise AssertionError(f"tool -I printed {info!r}")
        pi_yuv = iio.probe("c.yuv", file_exists=False)
        chans = sample.unpack_to_channels(torch.from_numpy(frame),
                                          gt.ImageParameters(
                                              width=W8K, height=H8K))
        want = sample.pack_channels(color.convert(
            chans, gt.ColorSpace.RGB, pi_yuv.color_space),
            pi_yuv.with_(width=W8K, height=H8K)).numpy()
        if read("c.yuv") != want.tobytes():
            raise AssertionError("tool -C differs from the CPU's convert")
        log(f"[tool cli] 8K PPM, PGM and .tst encode and decode, 4K Y4M x 8 "
            f"through -B 4, -I and -C: files equal to the in-process "
            f"sessions' bytes and arrays (random pattern {want_tst.nbytes} "
            f"bytes); wall s " + json.dumps(
                {k: round(v, 2) for k, v in walls.items()}))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def tool_phases(torch, np, gt, dev, flush):
    """Step 14, [tool]: a. the direct route at 8K Q100 (direct_phases);
    b. the command-line tool in processes of its own (cli_phase).
    Returns (kernel records, launches)."""
    rec, launches = direct_phases(torch, np, gt, dev, flush)
    cli_phase(torch, np, gt, dev)
    return ({"huffdec_block:direct": rec},
            {"huffdec_block:direct": launches})


PAR_FRAMES = 4
H16K, W16K = 8640, 15360


def walls_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of reps calls of fn()."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[reps // 2]


STAT_KEYS = ("duration_memory_to", "duration_in_gpu", "duration_memory_from",
             "duration_stream")


def whole16k_runs(torch, enc, frame, params, reps: int = 3,
                  before=None) -> dict:
    """reps whole-frame Encoder.encode calls of the 16K frame, each after
    before() where given: each one's host-clock ms and session stats,
    and the process's device memory reserved and host resident set
    after them (GiB)."""
    walls, stats = [], []
    for _ in range(reps):
        if before is not None:
            before()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode(frame, params)
        walls.append(round((time.perf_counter() - t0) * 1e3, 3))
        st = enc.get_stats()
        stats.append({k: round(getattr(st, k), 3) for k in STAT_KEYS})
    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    return dict(walls_ms=walls, stats=stats,
                reserved_gib=round(torch.cuda.memory_reserved() / 2**30, 3),
                rss_gib=round(rss / 2**20, 3))


def whole16k_child() -> int:
    """`python3 chip_smoke.py --whole16k`: the [parallel] phase's
    whole-frame 16K encode (the same seeded frame, after one untimed
    call) in a process that has done nothing else; prints whole16k_runs'
    readings as its last line."""
    import torch

    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gpujpeg_tpu_torch as gt

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    enc = gt.Encoder(device=dev)
    params = gt.Parameters(quality=QUALITY, restart_interval=gt.RESTART_AUTO)
    big = make_frame(torch, "gradient", 610, H16K, W16K, dev).cpu().numpy()
    enc.encode(big, params)
    print(json.dumps(whole16k_runs(torch, enc, big, params)), flush=True)
    return 0


def whole16k_compare(torch, enc, big, params, be16) -> None:
    """The whole-frame 16K encode's walls and stats in this process: back
    to back, each after be16's seg-8 encode of the same frame, and each
    after a pinned block of the frame's size was taken and kept, once
    the pinned allocator's cache of such blocks was drained (takes until
    one over 10 ms, at most 16), so that the staging's host copy needs a
    block allocated anew (every take's ms beside); and in a fresh
    process (whole16k_child); logged side by side."""
    here = os.path.abspath(__file__)
    mine = whole16k_runs(torch, enc, big, params)
    after = whole16k_runs(torch, enc, big, params,
                          before=lambda: be16.encode_batch(big[None]))
    held, take_ms = [], []

    def take():
        t0 = time.perf_counter()
        held.append(torch.empty(big.shape, dtype=torch.uint8,
                                pin_memory=True))
        take_ms.append(round((time.perf_counter() - t0) * 1e3, 3))

    for _ in range(16):
        take()
        if take_ms[-1] > 10:
            break
    pinned = whole16k_runs(torch, enc, big, params, before=take)
    pinned["take_pinned_ms"] = take_ms
    del held
    out = subprocess.run([sys.executable, here, "--whole16k"],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"chip_smoke.py --whole16k exited "
                             f"{out.returncode}:\n{out.stderr[-4000:]}")
    fresh = json.loads(out.stdout.strip().splitlines()[-1])
    log("[parallel 16k] whole-frame encode, this process vs a fresh one "
        "(host-clock ms, session stats ms, GiB): " + json.dumps(
            {"this_process": mine, "this_process_after_seg8": after,
             "this_process_pinned_taken": pinned,
             "fresh_process": fresh}))


def stripe_huffman(torch, enc, be, frame, flush):
    """huffman_segments with a stripe's markers (stripe 3 of be's 'seg'
    4: RST((3 * S + j) mod 8) after every row, the last included) on
    the stripe's luma coefficients, against its plain version -> its
    record."""
    from gpujpeg_tpu_torch.ops import fusedpack

    geo = be.geo_local
    h = geo.param_image.height
    planes, classes = enc._front(frame[3 * h:4 * h], geo)
    c = geo.components[0]
    tabs = classes[c.table_index]
    coefs = fusedpack.fdct_quant(planes[c.index], tabs, c.segment_mcu_count)
    markers = fusedpack.stripe_markers(coefs.shape[0], 3, coefs.device)
    out = fusedpack.huffman_segments(coefs, c.mcu_count, tabs, markers)
    ref, plain_ms = once_ms(torch, lambda: fusedpack.huffman_segments_plain(
        coefs, c.mcu_count, tabs, markers))
    err = rows_err(torch, *out, *ref)
    rows, rb = out[0], out[1]
    last = rows[-1, int(rb[-1]) - 2:int(rb[-1])].tolist()
    if err or last != [0xFF, 0xD0 + (4 * coefs.shape[0] - 1) % 8]:
        raise AssertionError(f"huffman_segments with stripe markers: error "
                             f"{err}, last row ends {last}")
    ms = event_ms(torch, lambda: fusedpack.huffman_segments(
        coefs, c.mcu_count, tabs, markers), 10, flush)
    return dict(source="gpujpeg_tpu_torch/csrc/huffman_segments.cu",
                replaces="gpujpeg_tpu/ops/fusedpack.py:459",
                bound_by="bytes", library_ms=None, err=err, ms=ms,
                plain_ms=plain_ms,
                bound_ms=huffman_bound_ms(coefs, rb),
                note="the Huffman coder with caller-given markers, every "
                     "row marked (parallel.BatchEncoder's stripes); "
                     "timed on stripe 3 of 4 of an 8K planar 4:4:4 luma "
                     "plane (1080 rows); launches: every huffman_segments "
                     "launch of the [parallel] encode window, the one-slot "
                     "planar stripes' and the slot-pattern interleaved "
                     "4:2:0 stripes'")


def restart0_rows(torch, gt, enc, frame, flush, big=None):
    """F4: encode_to_device at restart interval 0 on an 8K planar 4:4:4
    frame, in a window of its own: each scan one device row through the
    token-row packer's scan instance (chunks of the scan a CTA, joined by
    look-backs), assembled into encode()'s bytes; then that instance on
    the luma scan's tokens against its plain version and against the row
    instance (one warp walking the scan), both timed; and, given `big`
    (a 15360x8640 frame), its interleaved 4:4:4 restart-0 scan (a
    worst-case row past 2^31 bytes) through encode_to_device, assembled
    to encode()'s bytes -> (the record, its launches)."""
    from gpujpeg_tpu_torch.ops import _kernels, fusedpack

    p0 = gt.Parameters(quality=QUALITY, restart_interval=0)
    want = enc.encode(frame, p0)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    geo, res, meta = enc.encode_to_device(frame, p0)
    got = enc.assemble(geo, res, meta)
    wall = (time.perf_counter() - t0) * 1e3
    end_window()
    launches = _kernels.LAUNCHES["pack_stuff_scan"]
    inst = dict(_kernels.INSTANCES)
    if got != want or launches != geo.scan_count or \
            _kernels.LAUNCHES["pack_stuff_rows"] or \
            inst.get("pack_stuff_rows/scan") != geo.scan_count:
        raise AssertionError(f"restart-0 device rows: bytes equal "
                             f"{got == want}, launches "
                             f"{dict(_kernels.LAUNCHES)}, instances {inst}")
    strides = [int(r.shape[1]) for r in res["rows"]]
    del res, meta
    planes, classes = enc._front(frame, geo)
    c = geo.components[0]
    tabs = classes[c.table_index]
    coefs = fusedpack.fdct_quant(planes[0], tabs, c.mcu_count)
    bits, lens = fusedpack.scan_tokens(coefs, c.mcu_count, tabs)
    del planes, coefs
    n = int(bits.shape[0])
    stride = strides[0]
    out = fusedpack.pack_stuff_scan(bits, lens, 0, stride)
    ref, plain_ms = once_ms(torch, lambda: fusedpack.pack_stuff_scan_plain(
        bits, lens, 0, stride))
    T = -(-n // 4) * 4
    b = torch.zeros((1, T), dtype=torch.int32, device=bits.device)
    ln = torch.zeros_like(b)
    b[0, :n], ln[0, :n] = bits, lens
    markers = torch.zeros(1, dtype=torch.int32, device=bits.device)
    warp = fusedpack.pack_stuff_rows(b, ln, markers, stride)
    err = max(rows_err(torch, *out, *ref), rows_err(torch, *out, *warp))
    if err:
        raise AssertionError("the packer's scan instance on a restart-0 "
                             "scan differs from its plain version or the "
                             "row instance")
    ms = event_ms(torch, lambda: fusedpack.pack_stuff_scan(
        bits, lens, 0, stride), 20, flush)
    serial_ms = event_ms(torch, lambda: fusedpack.pack_stuff_rows(
        b, ln, markers, stride), 3, flush)
    del b, ln, warp
    nbytes = int(out[1].sum())
    # the tokens' lengths and bits read once, the row and its length
    # written once
    bound = (8 * n + nbytes + 4) / PEAK_BYTES_S * 1e3
    log(f"[parallel restart0] 8K planar 4:4:4 restart 0: encode_to_device "
        f"+ assemble {wall:.1f} ms, bytes equal to encode(), "
        f"{launches} packer launches (a scan a launch, the scan instance; "
        f"strides {strides} B); luma scan {n} tokens -> {nbytes} bytes: "
        f"scan instance {ms:.4f} ms a scan, row instance (one warp) "
        f"{serial_ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.4f} ms")
    rec = dict(source="gpujpeg_tpu_torch/csrc/pack_stuff_rows.cu",
               replaces="gpujpeg_tpu/ops/fusedpack.py:107",
               bound_by="bytes", library_ms=None, err=err, ms=ms,
               plain_ms=plain_ms, serial_ms=serial_ms, bound_ms=bound,
               tokens=n, ns_per_token=ms * 1e6 / n,
               instance="scan",
               serial_note="the row instance (gj_pack_stuff_rows, one "
                           "warp walking the scan as one row)",
               note="encode_to_device at restart interval 0 "
                    "(fusedpack.scan_rows): the packer's scan instance "
                    "(gj_pack_stuff_scan, chunks of 4096 tokens a CTA, "
                    "look-backs over bit offsets and 0xFF counts); ms a "
                    "scan on the 8K planar 4:4:4 luma scan; launches: one "
                    "a scan in the restart-0 window")
    if big is not None:
        p16 = gt.Parameters(quality=QUALITY, restart_interval=0,
                            interleaved=True)
        want = enc.encode(big, p16)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        geo, res, meta = enc.encode_to_device(big, p16)
        got = enc.assemble(geo, res, meta)
        wall16 = (time.perf_counter() - t0) * 1e3
        end_window()
        stride16 = int(res["rows"][0].shape[1])
        del res, meta
        if got != want or _kernels.LAUNCHES["pack_stuff_scan"] != 1 \
                or stride16 <= (1 << 31) - 1:
            raise AssertionError(f"16K interleaved 4:4:4 restart 0: bytes "
                                 f"equal {got == want}, stride {stride16}, "
                                 f"launches {dict(_kernels.LAUNCHES)}")
        launches += 1
        log(f"[parallel restart0] 15360x8640 interleaved 4:4:4 restart 0: "
            f"one scan of {geo.mcu_count * geo.blocks_per_mcu} blocks, "
            f"worst-case row {stride16} B (past 2^31), encode_to_device + "
            f"assemble {wall16:.1f} ms, {len(got)} bytes equal to "
            "encode()")
    return rec, launches


def parallel_phases(torch, np, gt, dev, flush):
    """Step 15, [parallel]: parallel/ on one card, every mesh place
    cuda:0 (a place may repeat a device).  References first, outside the
    window: PAR_FRAMES seeded 8K RGB frames through Encoder.encode
    (sequential walls), one interleaved 4:2:0 encode, one 16K
    (15360x8640) frame through the whole-frame Encoder and Decoder.
    Then one main-path window: BatchEncoder over the PAR_FRAMES frames
    on a (1, 1) mesh, at seg 4 (8K planar 4:4:4), at seg 2 (interleaved
    4:2:0) and the 16K frame at seg 8; ShardedDecoder at seg 4 on the 8K
    and 16K streams; BatchDecoder over the 8K streams on a (4, 1) mesh.
    Every stream must equal Encoder.encode's and every array
    Decoder.decode's.  Then the stripe-marker Huffman coder against its
    plain version, and F4's restart-0 device rows in a window of their
    own.  Returns (kernel records, launches by record)."""
    from gpujpeg_tpu_torch.ops import _kernels
    from gpujpeg_tpu_torch.parallel import batch as pb, mesh as pm

    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    params = gt.Parameters(quality=QUALITY, restart_interval=gt.RESTART_AUTO)
    p420 = gt.Parameters(quality=QUALITY, restart_interval=gt.RESTART_AUTO,
                         interleaved=True).chroma_subsampled(
        ((2, 2), (1, 1), (1, 1)))
    frames = [make_frame(torch, "gradient", 600 + i, H8K, W8K, dev)
              .cpu().numpy() for i in range(PAR_FRAMES)]
    big = make_frame(torch, "gradient", 610, H16K, W16K, dev).cpu().numpy()
    pi8 = enc.resolve(frames[0], params).param_image
    pi16 = enc.resolve(big, params).param_image
    # -- references (outside the window) ---------------------------------------
    want = [enc.encode(f, params) for f in frames]
    seq_ms = walls_ms(lambda: [enc.encode(f, params) for f in frames])
    want420 = enc.encode(frames[0], p420)
    t0 = time.perf_counter()
    want16 = enc.encode(big, params)
    enc16_ms = (time.perf_counter() - t0) * 1e3
    st16 = {k: round(getattr(enc.get_stats(), k), 3) for k in STAT_KEYS}
    geo16 = enc.resolve(big, params)
    check_stream(np, want16, geo16.segment_count - geo16.scan_count, "16K")
    pix = [dec.decode(s) for s in want]
    seq_dec_ms = walls_ms(lambda: [dec.decode(s) for s in want])
    t0 = time.perf_counter()
    pix16 = dec.decode(want16)
    dec16_ms = (time.perf_counter() - t0) * 1e3
    if pix16.shape != big.shape or psnr(np, pix16, big) < 25:
        raise AssertionError(f"16K whole-frame decode: {pix16.shape}, PSNR "
                             f"{psnr(np, pix16, big):.2f} dB")
    log(f"[parallel 16k] 15360x8640 Q75 planar 4:4:4: whole-frame encode "
        f"{enc16_ms:.1f} ms ({len(want16)} bytes, {geo16.segment_count} "
        f"segments, RST markers ok; stats {st16}), decode "
        f"{dec16_ms:.1f} ms, PSNR "
        f"{psnr(np, pix16, big):.2f} dB")

    def mesh(data, seg):
        return pm.make_mesh(data * seg, data=data, seg=seg, device=dev)

    be1 = pb.BatchEncoder(mesh(1, 1), params, pi8)
    be4 = pb.BatchEncoder(mesh(1, 4), params, pi8)
    be420 = pb.BatchEncoder(mesh(1, 2), p420, pi8)
    be16 = pb.BatchEncoder(mesh(1, 8), params, pi16)
    sd8 = pb.ShardedDecoder(mesh(1, 4), want[0])
    sd16 = pb.ShardedDecoder(mesh(1, 4), want16)
    bd = pb.BatchDecoder(mesh(PAR_FRAMES, 1), want[0], PAR_FRAMES)
    be1.encode_batch(frames)                      # sessions, staging
    # -- the main-path window ----------------------------------------------
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    got = be1.encode_batch(frames)
    batch_ms = (time.perf_counter() - t0) * 1e3
    got4 = be4.encode_batch(frames[:1])
    il0 = _kernels.LAUNCHES["huffman_segments"]
    got420 = be420.encode_batch(frames[:1])
    il_huff = _kernels.LAUNCHES["huffman_segments"] - il0
    got16 = be16.encode_batch(big[None])
    enc_counts = dict(_kernels.LAUNCHES)
    img8 = sd8.decode(want[0])
    img16 = sd16.decode(want16)
    imgs = bd.decode_batch(want)
    end_window()
    counts = dict(_kernels.LAUNCHES)
    bad = [what for what, ok in (
        ("BatchEncoder (1, 1)", got == want),
        ("BatchEncoder seg 4", got4 == want[:1]),
        ("BatchEncoder il 4:2:0 seg 2", got420 == [want420]),
        ("BatchEncoder 16K seg 8", got16 == [want16]),
        ("ShardedDecoder 8K seg 4", np.array_equal(img8, pix[0])),
        ("ShardedDecoder 16K seg 4", np.array_equal(img16, pix16)),
        ("BatchDecoder", all(np.array_equal(a, b)
                             for a, b in zip(imgs, pix)))) if not ok]
    if bad:
        raise AssertionError(f"[parallel] differs from the sessions: {bad}")
    # every stripe codes its scans with stripe markers: 3 a planar stripe,
    # 1 an interleaved one
    stripes = PAR_FRAMES * 3 + 4 * 3 + 2 * 1 + 8 * 3
    if enc_counts["huffman_segments"] != stripes or il_huff != 2:
        raise AssertionError(f"[parallel] {enc_counts['huffman_segments']} "
                             f"Huffman launches, {stripes} stripe scans")
    for name in ("pre_rgb_to_planes", "fdct_quant", "huffman_segments",
                 "huffdec_scan", "huffdec_block", "dc_fixup", "dpost_rgb"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "[parallel] path")
    log("[parallel] window: BatchEncoder (1, 1) x 8K x "
        f"{PAR_FRAMES}, seg 4, il 4:2:0 seg 2, 16K seg 8; ShardedDecoder "
        "8K and 16K seg 4; BatchDecoder (4, 1): every stream and array "
        "equal to Encoder.encode's and Decoder.decode's; launches "
        + str({n: c for n, c in counts.items() if c}))
    # -- walls (after the counts were read) --------------------------------
    b_ms = walls_ms(lambda: be1.encode_batch(frames))
    w = dict(
        batch_encode_ms_a_frame=b_ms / PAR_FRAMES,
        batch_encode_frames_s=PAR_FRAMES * 1e3 / b_ms,
        sequential_encode_ms_a_frame=seq_ms / PAR_FRAMES,
        sequential_encode_frames_s=PAR_FRAMES * 1e3 / seq_ms,
        first_window_batch_ms_a_frame=batch_ms / PAR_FRAMES,
        seg4_encode_ms=walls_ms(lambda: be4.encode_batch(frames[:1])),
        whole_encode_ms=walls_ms(lambda: enc.encode(frames[0], params)),
        seg8_16k_encode_ms=walls_ms(lambda: be16.encode_batch(big[None]),
                                    1),
        whole_16k_encode_ms=walls_ms(lambda: enc.encode(big, params), 1),
        whole_16k_encode_first_ms=enc16_ms,
        sharded_decode_8k_ms=walls_ms(lambda: sd8.decode(want[0])),
        whole_decode_8k_ms=walls_ms(lambda: dec.decode(want[0])),
        sharded_decode_16k_ms=walls_ms(lambda: sd16.decode(want16), 1),
        whole_decode_16k_ms=walls_ms(lambda: dec.decode(want16), 1),
        whole_decode_16k_first_ms=dec16_ms,
        batch_decode_ms_a_frame=walls_ms(
            lambda: bd.decode_batch(want)) / PAR_FRAMES,
        sequential_decode_ms_a_frame=seq_dec_ms / PAR_FRAMES)
    log("[parallel] wall ms (host clock, median of 3; 16K: one run after "
        "the first, whose ms are the _first keys): "
        + json.dumps({k: round(v, 3) for k, v in w.items()}))
    del got, got4, got16, img8, img16, imgs, pix, pix16
    whole16k_compare(torch, enc, big, params, be16)
    # -- the stripe-marker Huffman coder, then F4 --------------------------
    stripe = stripe_huffman(torch, enc, be4, frames[0], flush)
    rec0, launches0 = restart0_rows(torch, gt, enc, frames[0], flush, big)
    log_times("parallel", {"huffman_segments:stripe_markers": stripe,
                           "pack_stuff_rows:restart0_444": rec0})
    launches = {name: n for name, n in counts.items()}
    # the interleaved stripes' launches are slot-pattern ones
    launches["huffman_segments"] -= il_huff
    launches["huffman_segments:pattern_420"] = il_huff
    launches["huffman_segments:stripe_markers"] = \
        enc_counts["huffman_segments"]
    launches["pack_stuff_rows:restart0_444"] = launches0
    return ({"huffman_segments:stripe_markers": stripe,
             "pack_stuff_rows:restart0_444": rec0}, launches)


ROW_FLOOR_KEYS = ("ms_median", "ms_min", "empty_ms_median", "empty_ms_min",
                  "copy_ms_median", "copy_ms_min")


def row_floor(torch, name, fn, x, got, flush) -> dict:
    """The median and minimum CUDA-event ms of 200 launches of a row
    kernel, of 200 empty kernels launched as it is, and of 200
    device-to-device copy_ calls moving its bytes (input read and output
    written: half of them each way), each after the flush."""
    from gpujpeg_tpu_torch.ops import relayout as rl

    words = (x.numel() + got.numel()) // 2
    src = torch.empty(words, dtype=torch.int32, device=x.device)
    dst = torch.empty_like(src)
    rec = {}
    for key, run in (("ms", lambda: fn(x)),
                     ("empty_ms", lambda: rl.empty_launch(name, x)),
                     ("copy_ms", lambda: dst.copy_(src))):
        t = event_times(torch, run, 200, flush)
        rec[f"{key}_median"] = (t[99] + t[100]) / 2
        rec[f"{key}_min"] = t[0]
    return rec


def log_times(tag, kernels):
    for name, k in kernels.items():
        lib = k["library_ms"]
        tokens = (f", {k['tokens']} tokens, {k['ns_per_token']:.4f} ns a "
                  "token" if "tokens" in k else "")
        log(f"[{tag}] {name}: {k['ms']:.4f} ms per launch (bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}), plain "
            f"{k['plain_ms']:.3f} ms, library "
            f"{'-' if lib is None else format(lib, '.4f')} ms{tokens}")


def main() -> int:
    global PARENT
    if sys.argv[1:] == ["--whole16k"]:
        return whole16k_child()
    if sys.argv[1:2] == ["--plain-scan"]:
        return plain_scan_child(*sys.argv[2:4])
    parent_root = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        parent_root = sys.argv[2]
    elif sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (none, or "
              "--parent DIR)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import gpujpeg_tpu_torch as gt
    from gpujpeg_tpu_torch.ops import _kernels, fusedpack, prepost_kernel

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {kind}")

    # -- 2. build --------------------------------------------------------------
    if parent_root is not None:
        PARENT = ParentKernels(parent_root)    # nvcc runs beside the build
    build_s = _kernels.build()
    if PARENT is not None:
        PARENT.load()
    log(f"[build] kernels built in {build_s:.1f} s"
        + (f", and the parent's {', '.join(ParentKernels.SOURCES)} "
           f"({parent_root})"
           if PARENT is not None else ""))
    for name, text in _kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    enc = gt.Encoder(device=dev)
    params = gt.Parameters(quality=QUALITY, restart_interval=gt.RESTART_AUTO)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB

    # -- 3. kernels against their plain versions at 8K -------------------------
    kernels = {
        "pre_rgb_to_planes": dict(
            source="gpujpeg_tpu_torch/csrc/pre_rgb_to_planes.cu",
            replaces="gpujpeg_tpu/ops/prepost_kernel.py:88",
            bound_by="bytes", library_ms=None, err=0),
        "fdct_quant": dict(
            source="gpujpeg_tpu_torch/csrc/fdct_quant.cu",
            replaces="gpujpeg_tpu/ops/fusedpack.py:459",
            bound_by="operations", err=0),
        "huffman_segments": dict(
            source="gpujpeg_tpu_torch/csrc/huffman_segments.cu",
            replaces="gpujpeg_tpu/ops/fusedpack.py:459",
            bound_by="bytes", library_ms=None, err=0),
    }
    # the token-row packer on the luma plane's token rows (64,800 x 512
    # slots): on no encode path, the rows Annex-K's planar route would bring
    pack444 = dict(
        source="gpujpeg_tpu_torch/csrc/pack_stuff_rows.cu",
        replaces="gpujpeg_tpu/ops/fusedpack.py:107", bound_by="bytes",
        library_ms=None, err=0,
        note="on no tuned encode path; the plain tokenizer's 8K planar "
             "4:4:4 luma token rows of the tuned tables (64,800 x 512 "
             "slots); held against the plain version and the Huffman "
             "coder's rows; the Annex-K paths run it (records "
             "pack_stuff_rows:annexk_*)")
    for fkind, seed in (("gradient", 11), ("noise", 12)):
        frame = make_frame(torch, fkind, seed, H8K, W8K, dev)
        geo = enc.resolve(frame, params)
        pi = geo.param_image
        planes = prepost_kernel.preprocess_packed(frame, geo, pi)
        ref = prepost_kernel.preprocess_packed_plain(frame, geo, pi)
        torch.cuda.synchronize()
        err = max(int((a.int() - b.int()).abs().max())
                  for a, b in zip(planes, ref))
        kernels["pre_rgb_to_planes"]["err"] = max(
            kernels["pre_rgb_to_planes"]["err"], err)
        if err:
            raise AssertionError(f"pre kernel differs from plain ({fkind})")
        if fkind == "gradient":
            kernels["pre_rgb_to_planes"]["plain_ms"] = event_ms(
                torch, lambda: prepost_kernel.preprocess_packed_plain(
                    frame, geo, pi), 3)
        for c in geo.components:
            tabs = enc.class_tables(QUALITY, c.table_index == 0)
            rst = c.segment_mcu_count
            coefs = fusedpack.fdct_quant(planes[c.index], tabs, rst)
            p_coefs = fusedpack.fdct_quant_plain(planes[c.index], tabs, rst)
            torch.cuda.synchronize()
            err = int((coefs.int() - p_coefs.int()).abs().max())
            kernels["fdct_quant"]["err"] = max(kernels["fdct_quant"]["err"],
                                               err)
            if err:
                raise AssertionError(
                    f"fdct kernel differs from plain ({fkind}, comp "
                    f"{c.index}): {int((coefs != p_coefs).sum())} "
                    "coefficients")
            rows, rb, needs = fusedpack.huffman_segments(
                coefs, c.mcu_count, tabs)
            p_rows, p_rb, p_needs = fusedpack.huffman_segments_plain(
                coefs, c.mcu_count, tabs)
            torch.cuda.synchronize()
            stride = rows.shape[1]
            inside = torch.arange(stride, device=dev)[None, :] < rb[:, None]
            err = max(int((rb - p_rb).abs().max()),
                      int((needs - p_needs).abs().max()),
                      int((rows[inside].int() - p_rows[inside].int())
                          .abs().max()) if torch.equal(rb, p_rb) else 255)
            kernels["huffman_segments"]["err"] = max(
                kernels["huffman_segments"]["err"], err)
            if err:
                raise AssertionError(
                    f"huffman kernel differs from plain ({fkind}, comp "
                    f"{c.index})")
            if c.index == 0:
                st0 = fusedpack.one_slot(tabs)
                bits, lens = token_rows(torch, coefs, st0)
                err, ms, _ = pack_check(
                    torch, bits, lens, fusedpack.segment_markers(
                        coefs.shape[0], dev), stride, (rows, rb, needs))
                pack444["err"] = max(pack444["err"], err)
                if err:
                    raise AssertionError("pack_stuff_rows differs from its "
                                         f"plain version or the Huffman "
                                         f"coder (4:4:4 luma, {fkind})")
                if fkind == "gradient":
                    pack444["plain_ms"] = ms
                del bits, lens
            if fkind == "gradient" and c.index == 0:
                kernels["fdct_quant"]["plain_ms"] = event_ms(
                    torch, lambda: fusedpack.fdct_quant_plain(
                        planes[0], tabs, rst), 3)
                kernels["huffman_segments"]["plain_ms"] = event_ms(
                    torch, lambda: fusedpack.huffman_segments_plain(
                        coefs, c.mcu_count, tabs), 2)
            log(f"[kernels] 8K {fkind} comp {c.index}: pre, fdct, huffman "
                + ("and pack (plain tokens) " if c.index == 0 else "")
                + f"equal to plain; max row {int(needs[1])} B, stuffed "
                f"zeros <= {int(needs[0])}, stride {stride} B")
        del planes, ref, coefs, p_coefs, rows, p_rows

    # -- 4. HD bytes: card == CPU ----------------------------------------------
    hd = make_frame(torch, "gradient", 21, 1080, 1920, dev).cpu().numpy()
    out_cuda = enc.encode(hd, params)
    out_cpu = gt.Encoder(device="cpu").encode(hd, params)
    if out_cuda != out_cpu:
        raise AssertionError("HD encode on the card differs from the CPU")
    log(f"[hd] 1920x1080 Q75: {len(out_cuda)} bytes, card == cpu")

    # -- 5. main path: three 8K frames through Encoder.encode ------------------
    frames = [make_frame(torch, "gradient", 100 + i, H8K, W8K, dev)
              .cpu().numpy() for i in range(3)]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    walls, sizes, streams = [], [], []
    for f in frames:
        t0 = time.perf_counter()
        out = enc.encode(f, params)
        walls.append((time.perf_counter() - t0) * 1e3)
        sizes.append(len(out))
        streams.append(out)
        geo = enc.resolve(f, params)
        check_stream(np, out, geo.segment_count - geo.scan_count, "8K")
    end_window()
    launches = {name: _kernels.LAUNCHES[name] for name in kernels}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    pre_once_a_frame(launches, len(frames), "4:4:4")
    if _kernels.LAUNCHES["pack_stuff_rows"]:
        raise AssertionError("the 4:4:4 encode went through pack_stuff_rows")
    kernels["pack_stuff_rows:planar_444_luma"] = pack444
    launches["pack_stuff_rows:planar_444_luma"] = 0
    log(f"[8k] {len(frames)} frames 7680x4320 Q75 rst "
        f"{geo.param.restart_interval}: bytes {sizes}, segments "
        f"{geo.segment_count}, RST markers ok, launches {launches}")
    # more frames (after the launch counts were read) for the spread
    for i in range(EXTRA_FRAMES):
        t0 = time.perf_counter()
        enc.encode(frames[i % 3], params)
        walls.append((time.perf_counter() - t0) * 1e3)
    log("[8k] wall ms per frame (host frame in, bytes out), "
        + quartiles(np, walls))

    # stage breakdown of one more frame (after the launch counts were read)
    x, planes, coefs, rows, rbs = planar_encode_stages(
        torch, enc, frames[0], params, streams[0], "8k")

    # per-kernel CUDA-event times at the main path's shapes (frame 0)
    c0 = geo.components[0]
    kernels["pre_rgb_to_planes"]["ms"] = event_ms(
        torch, lambda: prepost_kernel.preprocess_packed(
            x, geo, geo.param_image), 20, flush)
    ms_f, ms_h, bound_f, bound_h, lib_f = [], [], [], [], []
    for c, co, rb in zip(geo.components, coefs, rbs):
        tabs = enc.class_tables(QUALITY, c.table_index == 0)
        ms_f.append(event_ms(torch, lambda: fusedpack.fdct_quant(
            planes[c.index], tabs, c.segment_mcu_count), 10, flush))
        ms_h.append(event_ms(torch, lambda: fusedpack.huffman_segments(
            co, c.mcu_count, tabs), 10, flush))
        ncoef = co.numel()
        b_bytes = planes[c.index].numel() + ncoef * 2 + 64 * 65 * 4
        bound_f.append(max(b_bytes / PEAK_BYTES_S,
                           2 * 64 * ncoef / PEAK_F32_FLOP_S) * 1e3)
        bound_h.append(huffman_bound_ms(co, rb))
        # yardstick: one float32 product of the same blocks (TF32 off);
        # timed here only, never called by the port
        blocks = planes[c.index].reshape(
            c.data_height // 8, 8, c.data_width // 8, 8).permute(
            0, 2, 1, 3).reshape(-1, 64).float()
        lib_f.append(event_ms(torch, lambda: torch.matmul(blocks, tabs.mq),
                              10, flush))
        del blocks
    kernels["fdct_quant"].update(ms=sum(ms_f) / 3, library_ms=sum(lib_f) / 3)
    tabs0 = enc.class_tables(QUALITY, True)
    kernels["fdct_quant"]["probe"] = probe_ms(
        torch, lambda st: fusedpack.fdct_quant_probe(
            planes[c0.index], tabs0, c0.segment_mcu_count, st),
        lambda: fusedpack.fdct_quant_plain(planes[c0.index], tabs0,
                                           c0.segment_mcu_count), flush)
    kernels["huffman_segments"]["ms"] = sum(ms_h) / 3
    kernels["huffman_segments"]["probe"] = probe_ms(
        torch, lambda st: fusedpack.huffman_segments_probe(
            coefs[0], c0.mcu_count, tabs0, st),
        lambda: fusedpack.huffman_segments_plain(coefs[0], c0.mcu_count,
                                                 tabs0), flush)
    kernels["fdct_quant"]["bound_ms"] = sum(bound_f) / 3
    kernels["huffman_segments"]["bound_ms"] = sum(bound_h) / 3
    bits, lens = token_rows(torch, coefs[0], fusedpack.one_slot(tabs0))
    pack_times(torch, pack444, bits, lens, fusedpack.segment_markers(
        coefs[0].shape[0], dev), rows[0].shape[1], int(rbs[0].sum()), flush)
    del bits, lens
    pre_bytes = x.numel() + 3 * c0.data_height * c0.data_width
    kernels["pre_rgb_to_planes"]["bound_ms"] = pre_bytes / PEAK_BYTES_S * 1e3
    log_times("time", kernels)

    # -- 6. decode ------------------------------------------------------------
    del x, planes, coefs, rows
    noise_stream = enc.encode(
        make_frame(torch, "noise", 13, H8K, W8K, dev).cpu().numpy(), params)
    dec_kernels, dec_launches = decode_phases(
        torch, np, gt, dev, streams, frames, noise_stream, flush)
    kernels.update(dec_kernels)
    launches.update(dec_launches)

    # -- 7-10. the interleaved 4:2:0, interleaved 4:4:4 and planar 4:2:0
    # paths, then the streams other encoders write ([foreign]) -------------
    for phases in (interleaved_phases, il444_phases, planar_phases,
                   foreign_phases):
        t_step = time.perf_counter()
        step_kernels, step_launches = phases(torch, np, gt, dev, flush)
        kernels.update(step_kernels)
        launches.update(step_launches)
        log(f"[{phases.__name__}] {time.perf_counter() - t_step:.1f} s")
    mo = MCU_ORDER
    kernels["fdct_quant:mcu_order"] = dict(
        source="gpujpeg_tpu_torch/csrc/fdct_quant.cu",
        # the DCT half of the megakernel's interleaved mode, fed by the XLA
        # relayout of gpujpeg_tpu/models/encoder.py:673-677
        replaces="gpujpeg_tpu/ops/fusedpack.py:928",
        bound_by="operations", library_ms=None, err=mo["err"],
        ms=sum(mo["ms"]) / 6, plain_ms=sum(mo["plain_ms"]) / 6,
        bound_ms=sum(mo["bound_ms"]) / 6,
        note="output map of fdct_quant storing MCU order; launches over "
             "the interleaved 4:2:0 and 4:4:4 encode paths; ms, plain and "
             "bound per launch, means over both paths' 3 launches")
    launches["fdct_quant:mcu_order"] = mo["launches"]
    log(f"[mcu order] fdct + MCU order ms (4:2:0, 4:4:4): "
        + ", ".join(f"{v:.4f}" for v in mo["ms"]) + "; planar store of the "
        "same planes: " + ", ".join(f"{v:.4f}" for v in mo["planar_ms"]))

    # -- 11. the session surface ---------------------------------------------
    t_step = time.perf_counter()
    kernels["dc_fixup"] = session_phases(torch, np, gt, dev, flush)
    log(f"[session_phases] {time.perf_counter() - t_step:.1f} s")

    # -- 12. every pixel format, component count and sampling ----------------
    t_step = time.perf_counter()
    step_kernels, step_launches = formats_phases(torch, np, gt, dev, flush)
    kernels.update(step_kernels)
    launches.update(step_launches)
    log(f"[formats_phases] {time.perf_counter() - t_step:.1f} s")

    # -- 13. relayout and primitive kernels ----------------------------------
    t_step = time.perf_counter()
    kernels.update(relayout_phase(torch, dev, flush))
    for name in ("xbd_relayout", "transpose_u32", "pair_sum_rows",
                 "pack_u8_quads", "dc_fixup"):
        launches[name] = PATH_LAUNCHES.get(name, 0)
    log(f"[relayout_phase] {time.perf_counter() - t_step:.1f} s")

    # -- 14. the direct route at Q100 and the command-line tool --------------
    t_step = time.perf_counter()
    step_kernels, step_launches = tool_phases(torch, np, gt, dev, flush)
    kernels.update(step_kernels)
    launches.update(step_launches)
    log(f"[tool_phases] {time.perf_counter() - t_step:.1f} s")

    # -- 15. parallel/: meshes of cuda:0, restart-0 device rows -------------
    t_step = time.perf_counter()
    step_kernels, step_launches = parallel_phases(torch, np, gt, dev, flush)
    kernels.update(step_kernels)
    for name, n in step_launches.items():
        # the [parallel] windows' launches add to each record's count
        if name in step_kernels:
            launches[name] = n
        elif name in launches:
            launches[name] += n
    log(f"[parallel_phases] {time.perf_counter() - t_step:.1f} s")

    # -- 16. decomposition line -----------------------------------------------
    log("[probe] decomposition ms at 8K (full | loads and stores only | "
        "full without the output store; the full stage's error against "
        "the plain version): " + json.dumps(
            {name: k["probe"] for name, k in kernels.items()
             if "probe" in k}))
    # -- 17. kernels line ----------------------------------------------------
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[name],
         "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"],
         **{key: k[key] for key in ROW_FLOOR_KEYS + (
             "tokens", "ns_per_token", "paths", "note", "instance",
             "generic_ms", "library_note", "library_ms_median",
             "serial_ms", "serial_note", "sync_stats",
             "plain_ms_512x384_cpu", "two_set_ms", "parent_ms",
             "parent_err", "ms_again", "resources")
             if key in k}}
        for name, k in kernels.items()]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(line))
    # -- 18. result ----------------------------------------------------------
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
