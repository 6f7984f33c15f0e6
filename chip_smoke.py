#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

    python3 chip_smoke.py

Drives gpujpeg_tpu_torch only (never the JAX package) on one CUDA card:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from gpujpeg_tpu_torch/csrc and prints the
     build seconds and each kernel's ptxas resource line;
  3. runs each kernel against its plain PyTorch version on the card at the
     8K (7680x4320) shapes of the main path: the preprocessor and the DCT
     must match bit for bit, the Huffman coder's rows and row lengths
     exactly, on a seeded gradient-plus-noise frame and a uniform-noise
     frame;
  4. encodes a 1920x1080 frame with Encoder(device="cuda") and with
     Encoder(device="cpu") and requires identical bytes;
  5. encodes three seeded 8K RGB frames through Encoder.encode at Q75,
     restart interval auto (the reference GPUJPEG's headline
     configuration), checks SOI/EOI and that the RST count equals segments
     minus scans, and prints per-frame wall ms (those three and nine more
     frames), a stage breakdown and each kernel's CUDA-event time;
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
        frames, per-frame wall ms (those three and nine more, bytes in to
        a host array out) and a stage breakdown;
     d. times each decode kernel at the main path's shapes;
  7. runs the interleaved 4:2:0 path (one scan, luma 2x2, chroma 1x1,
     Q75, restart interval auto = 1 MCU a segment; libjpeg's default
     layout):
     a. each kernel and mode of that path against its plain version at
        8K on a gradient and a noise frame, bit for bit: the decimating
        preprocessor, the token-row packer, the Huffman decode phases in
        slot-pattern mode, the IDCT to planes and the postprocessor;
     b. encodes and decodes a 1920x1080 frame with device="cuda" and
        device="cpu" and requires identical bytes and pixels;
     c. encodes three seeded 8K frames through Encoder.encode and decodes
        their streams through Decoder.decode (launch counts read over
        each), checks SOI/EOI, the RST count and the PSNR, and prints
        per-frame wall ms (those three and nine more) and a stage
        breakdown of each;
     d. times each kernel and mode of the path at its shapes;
  8. prints one JSON line of per-kernel records, every kernel and mode
     (launches during its main path, error against the plain version,
     times, the bound from this run's inputs, the PyTorch library
     yardstick where one exists);
  9. prints {"ok": true, "device": {...}} as its last line.

Any failure raises and exits non-zero; with no CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

H8K, W8K = 4320, 7680
QUALITY = 75
#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, non-tensor f32
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


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
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def once_ms(torch, fn):
    """(fn(), its CUDA-event ms) of one run, for the plain versions."""
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def stream_word_bytes(nbits) -> int:
    """Bytes of the segment word matrix that the segments' bits fill (each
    row up to its last bit's word): what phases A and C must read, where
    the matrix is padded to its longest row."""
    return int(((nbits.long() + 31) // 32).sum()) * 4


def psnr(np, a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def decode_phases(torch, np, gt, dev, streams, frames, noise_stream,
                  flush):
    """Step 6; returns (kernel records, launches over the main path)."""
    from gpujpeg_tpu_torch.models import decoder as tdec
    from gpujpeg_tpu_torch.ops import _kernels, huffdec_kernel as thd
    from gpujpeg_tpu_torch.ops import prepost_kernel

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
        return p, words, nbits, (p.nblocks, p.dc_luma, p.ac_luma, p.tables)

    def record_err(name, err, what):
        kernels[name]["err"] = max(kernels[name]["err"], err)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({what})")

    # -- a. kernels against their plain versions at 8K ---------------------
    for what, data in (("gradient", streams[0]), ("noise", noise_stream)):
        hf = dec.prepare(data)
        p, words, nbits, args = inputs(hf)
        bstart, err_a = thd.scan_segments(words, nbits, *args, p.bps)
        (p_bstart, p_err_a), ms_a = once_ms(
            torch, lambda: thd.scan_segments_plain(words, nbits, *args, p.bps))
        record_err("huffdec_scan", max(
            int((bstart - p_bstart).abs().max()),
            int((err_a != p_err_a).sum())), what)
        coefs, err_c = thd.decode_blocks(words, bstart, *args)
        (p_coefs, p_err_c), ms_c = once_ms(
            torch, lambda: thd.decode_blocks_plain(words, bstart, *args))
        record_err("huffdec_block", max(
            int((coefs.int() - p_coefs.int()).abs().max()),
            int((err_c - p_err_c).abs().max())), what)
        if bool(err_a.any()) or bool(err_c.any()):
            raise AssertionError(f"8K {what} stream decodes with errors")
        del p_coefs
        coefs = tdec._dc_fixup_t(coefs, words.shape[0], p.bps)
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
        del coefs, img, p_img, words, bstart, p_bstart

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
    launches = {n: _kernels.LAUNCHES[n] for n in kernels}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "decode main path")
    if min(psnrs) < 20:
        raise AssertionError(f"8K decode PSNR {psnrs} dB: not the frames")
    log(f"[dec 8k] {len(streams)} streams 7680x4320 Q75: PSNR vs source "
        + ", ".join(f"{v:.2f}" for v in psnrs) + f" dB, launches {launches}")
    for i in range(9):
        t0 = time.perf_counter()
        dec.decode(streams[i % 3])
        walls.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(walls, [25, 50, 75])
    log(f"[dec 8k] wall ms per frame (bytes in, host array out), "
        f"{len(walls)} frames: median {q[1]:.3f}, quartiles {q[0]:.3f} / "
        f"{q[2]:.3f}; " + ", ".join(f"{w:.3f}" for w in walls))

    # stage breakdown of one more frame
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hf = dec.prepare(streams[0])
    t1 = time.perf_counter()
    p = hf.plan
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    ev[0].record()
    words = torch.from_numpy(hf.words).to(dev)
    nbits = torch.from_numpy(hf.nbits).to(dev)
    ev[1].record()
    args = (p.nblocks, p.dc_luma, p.ac_luma, p.tables)
    bstart, _ea = thd.scan_segments(words, nbits, *args, p.bps)
    ev[2].record()
    coefs, _ec = thd.decode_blocks(words, bstart, *args)
    ev[3].record()
    coefs = tdec._dc_fixup_t(coefs, words.shape[0], p.bps)
    ev[4].record()
    img = prepost_kernel.decode_post(coefs, p.qtabs, p.geo, hf.out_pi)
    ev[5].record()
    host = img.cpu()
    ev[6].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not np.array_equal(host.numpy(), dec.decode(streams[0])):
        raise AssertionError("stage-by-stage decode differs from decode()")
    stages = dict(parse_unstuff_host_ms=(t1 - t0) * 1e3,
                  h2d_words_ms=ev[0].elapsed_time(ev[1]),
                  scan_ms=ev[1].elapsed_time(ev[2]),
                  block_ms=ev[2].elapsed_time(ev[3]),
                  dc_fixup_ms=ev[3].elapsed_time(ev[4]),
                  dpost_ms=ev[4].elapsed_time(ev[5]),
                  d2h_image_ms=ev[5].elapsed_time(ev[6]),
                  device_wall_ms=(t2 - t1) * 1e3)
    log(f"[dec 8k] stages (parse + unstuff on the host clock, the rest CUDA "
        f"events; {words.numel() * 4} B of words, {img.numel()} B of "
        "pixels): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # -- d. per-kernel times at the main path's shapes ---------------------
    kernels["huffdec_scan"]["ms"] = event_ms(
        torch, lambda: thd.scan_segments(words, nbits, *args, p.bps), 20,
        flush)
    kernels["huffdec_block"]["ms"] = event_ms(
        torch, lambda: thd.decode_blocks(words, bstart, *args), 20, flush)
    kernels["dpost_rgb"]["ms"] = event_ms(
        torch, lambda: prepost_kernel.decode_post(coefs, p.qtabs, p.geo,
                                                  hf.out_pi), 20, flush)
    nseg, W = words.shape
    L = coefs.shape[1]
    seg_bytes = 4 * nseg * 4 + p.tables.numel() * 4   # nbits + 3 flags
    w_bytes = stream_word_bytes(nbits)
    kernels["huffdec_scan"]["bound_ms"] = (
        w_bytes + seg_bytes + bstart.numel() * 4 + nseg) / PEAK_BYTES_S * 1e3
    kernels["huffdec_block"]["bound_ms"] = (
        w_bytes + seg_bytes + bstart.numel() * 4 + L * 64 * 2 + L * 4) \
        / PEAK_BYTES_S * 1e3
    nblk = sum(c.mcu_count for c in p.geo.components)
    d_ops = 2 * 64 * 64 * nblk
    d_bytes = nblk * 64 * 2 + img.numel() + 3 * 64 * 4 + 64 * 64 * 4
    kernels["dpost_rgb"]["bound_ms"] = max(
        d_ops / PEAK_F32_FLOP_S, d_bytes / PEAK_BYTES_S) * 1e3
    # yardstick: one f32 product of each component's (blocks, 64)
    # dequantized coefficients by the IDCT matrix (TF32 off); timed here
    # only, never called by the port
    nmat = prepost_kernel.idct_matrix(dev)
    ys = [(coefs[:, f0:f0 + n].T.float() * p.qtabs[c]).contiguous()
          for c, (f0, n) in enumerate(
              prepost_kernel.component_columns(p.geo))]
    kernels["dpost_rgb"]["library_ms"] = event_ms(
        torch, lambda: [torch.matmul(y, nmat) for y in ys], 10, flush)
    del ys
    for name, k in kernels.items():
        log(f"[dec time] {name}: {k['ms']:.4f} ms per launch (bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}), plain "
            f"{k['plain_ms']:.3f} ms, library "
            f"{'-' if k['library_ms'] is None else format(k['library_ms'], '.4f')}"
            " ms")
    return kernels, launches


def interleaved_phases(torch, np, gt, dev, flush):
    """Step 7, the interleaved 4:2:0 path; returns (kernel records,
    launches over its main path).  Records of a new mode of an older
    kernel are named kernel:mode and count that kernel's launches."""
    from gpujpeg_tpu_torch.models import decoder as tdec
    from gpujpeg_tpu_torch.ops import _kernels, fusedpack
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd
    from gpujpeg_tpu_torch.ops import prepost_kernel

    params = gt.Parameters(
        quality=QUALITY, restart_interval=gt.RESTART_AUTO,
        interleaved=True).chroma_subsampled(((2, 2), (1, 1), (1, 1)))
    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    kernels = {
        "pre_rgb_to_planes:decimate": dict(
            key="pre_rgb_to_planes",
            source="gpujpeg_tpu_torch/csrc/pre_rgb_to_planes.cu",
            replaces="gpujpeg_tpu/ops/prepost_kernel.py:88",
            bound_by="bytes", library_ms=None, err=0),
        "pack_stuff_rows": dict(
            source="gpujpeg_tpu_torch/csrc/pack_stuff_rows.cu",
            replaces="gpujpeg_tpu/ops/fusedpack.py:107",
            bound_by="bytes", library_ms=None, err=0),
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

    def diff(a, b):
        return int((a.int() - b.int()).abs().max()) if a.numel() else 0

    def rows_err(rows, rb, needs, p_rows, p_rb, p_needs):
        if not torch.equal(rb, p_rb):
            return 255
        inside = torch.arange(rows.shape[1], device=rows.device)[None, :] \
            < rb[:, None]
        return max(diff(needs, p_needs), diff(rows[inside], p_rows[inside]))

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
        bits, lens = enc.interleaved_tokens(
            enc.interleaved_coefs(planes, geo), geo)
        markers = fusedpack.segment_markers(geo.segment_count, dev)
        stride = enc.interleaved_stride(geo)
        rows, rb, needs = fusedpack.pack_stuff_rows(bits, lens, markers,
                                                    stride)
        p_out, ms_pack = once_ms(
            torch, lambda: fusedpack.pack_stuff_rows_plain(bits, lens,
                                                           markers, stride))
        record_err("pack_stuff_rows", rows_err(rows, rb, needs, *p_out),
                   fkind)
        del p_out, bits, lens, planes
        data = enc.assemble(geo, {"rows": [rows], "row_bytes": [rb]})
        del rows
        hf = dec.prepare(data)
        p = hf.plan
        words = torch.from_numpy(hf.words).to(dev)
        nbits = torch.from_numpy(hf.nbits).to(dev)
        args = (p.nblocks, p.dc_luma, p.ac_luma, p.tables)
        bstart, err_a = thd.scan_segments(words, nbits, *args, p.bps,
                                          p.pattern)
        (p_bstart, p_err_a), ms_a = once_ms(
            torch, lambda: thd.scan_segments_plain(words, nbits, *args, p.bps,
                                                   p.pattern))
        record_err("huffdec_scan:pattern",
                   max(diff(bstart, p_bstart), diff(err_a, p_err_a)), fkind)
        coefs, err_c = thd.decode_blocks(words, bstart, *args, p.pattern)
        (p_coefs, p_err_c), ms_c = once_ms(
            torch, lambda: thd.decode_blocks_plain(words, bstart, *args,
                                                   p.pattern))
        record_err("huffdec_block:pattern",
                   max(diff(coefs, p_coefs), diff(err_c, p_err_c)), fkind)
        if bool(err_a.any()) or bool(err_c.any()):
            raise AssertionError(f"8K 4:2:0 {fkind} stream decodes with "
                                 "errors")
        del p_coefs, words
        coefs = tdec._dc_fixup_t(coefs, p.geo.segment_count, p.bps,
                                 p.comp_slots)
        dplanes, ms_i = [], 0.0
        for c in p.geo.components:
            q = p.qtabs[c.index]
            got = prepost_kernel.idct_planes(coefs, q, p.geo, c)
            ref, ms = once_ms(
                torch, lambda: prepost_kernel.idct_planes_plain(coefs, q,
                                                                p.geo, c))
            record_err("idct_planes", diff(got, ref), fkind)
            dplanes.append(got)
            ms_i += ms / 3
        img = prepost_kernel.postprocess_packed(dplanes, p.geo, hf.out_pi)
        ref, ms_p = once_ms(
            torch, lambda: prepost_kernel.postprocess_packed_plain(dplanes,
                                                                   p.geo,
                                                                   hf.out_pi))
        record_err("post_rgb", diff(img, ref), fkind)
        if fkind == "gradient":
            for name, ms in (("pre_rgb_to_planes:decimate", ms_pre),
                             ("pack_stuff_rows", ms_pack),
                             ("huffdec_scan:pattern", ms_a),
                             ("huffdec_block:pattern", ms_c),
                             ("idct_planes", ms_i), ("post_rgb", ms_p)):
                kernels[name]["plain_ms"] = ms
        log(f"[il kernels] 8K 4:2:0 {fkind}: pre, pack, scan, block, idct, "
            f"post equal to plain; {len(data)} B, {geo.segment_count} "
            f"segments of {p.bps} blocks, max row {int(needs[1])} B, "
            f"stuffed zeros <= {int(needs[0])}, stride {stride} B, "
            f"PSNR {psnr(np, img.cpu().numpy(), frame.cpu().numpy()):.2f} "
            "dB")
        del coefs, dplanes, img, ref, frame

    # -- b. HD: card == CPU, bytes and pixels --------------------------------
    hd = make_frame(torch, "gradient", 23, 1080, 1920, dev).cpu().numpy()
    hd_stream = enc.encode(hd, params)
    if hd_stream != gt.Encoder(device="cpu").encode(hd, params):
        raise AssertionError("HD 4:2:0 encode on the card differs from the "
                             "CPU")
    got = dec.decode(hd_stream)
    if not np.array_equal(got, gt.Decoder(device="cpu").decode(hd_stream)):
        raise AssertionError("HD 4:2:0 decode on the card differs from the "
                             "CPU")
    log(f"[il hd] 1920x1080 4:2:0 Q75 {len(hd_stream)} bytes: card == cpu "
        f"(bytes and pixels), PSNR {psnr(np, got, hd):.2f} dB")

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
    launches = {n: _kernels.LAUNCHES[n] for n in (
        "pre_rgb_to_planes", "fdct_quant", "pack_stuff_rows")}
    geo = enc.resolve(frames[0], params)
    for out in streams:
        data = np.frombuffer(out, np.uint8)
        if out[:2] != b"\xff\xd8" or out[-2:] != b"\xff\xd9":
            raise AssertionError("8K 4:2:0 stream lacks SOI/EOI")
        ff = np.nonzero(data[:-1] == 0xFF)[0]
        nrst = int(((data[ff + 1] >= 0xD0) & (data[ff + 1] <= 0xD7)).sum())
        if nrst != geo.segment_count - 1:
            raise AssertionError(f"RST count {nrst} != "
                                 f"{geo.segment_count - 1}")
    log(f"[il 8k enc] 3 frames 7680x4320 4:2:0 Q75 rst "
        f"{geo.param.restart_interval} MCU: bytes "
        f"{[len(s) for s in streams]}, segments {geo.segment_count}, RST "
        f"markers ok, launches {launches}")
    for i in range(9):
        t0 = time.perf_counter()
        enc.encode(frames[i % 3], params)
        walls.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(walls, [25, 50, 75])
    log(f"[il 8k enc] wall ms per frame (host frame in, bytes out), "
        f"{len(walls)} frames: median {q[1]:.3f}, quartiles {q[0]:.3f} / "
        f"{q[2]:.3f}; " + ", ".join(f"{w:.3f}" for w in walls))

    f = frames[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    x = torch.from_numpy(f).to(dev)
    ev[1].record()
    planes = prepost_kernel.preprocess_packed(x, geo, geo.param_image)
    ev[2].record()
    il_coefs = enc.interleaved_coefs(planes, geo)
    ev[3].record()
    bits, lens = enc.interleaved_tokens(il_coefs, geo)
    ev[4].record()
    markers = fusedpack.segment_markers(geo.segment_count, dev)
    stride = enc.interleaved_stride(geo)
    rows, rb, _ = fusedpack.pack_stuff_rows(bits, lens, markers, stride)
    ev[5].record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = enc.assemble(geo, {"rows": [rows], "row_bytes": [rb]})
    t2 = time.perf_counter()
    if out != streams[0]:
        raise AssertionError("stage-by-stage 4:2:0 encode differs from "
                             "encode()")
    stages = dict(h2d_ms=ev[0].elapsed_time(ev[1]),
                  pre_ms=ev[1].elapsed_time(ev[2]),
                  fdct_reorder_3_planes_ms=ev[2].elapsed_time(ev[3]),
                  tokenize_ms=ev[3].elapsed_time(ev[4]),
                  pack_ms=ev[4].elapsed_time(ev[5]),
                  device_wall_ms=(t1 - t0) * 1e3,
                  assemble_d2h_host_ms=(t2 - t1) * 1e3)
    log("[il 8k enc] stages (CUDA events; assembly on the host clock; "
        f"{bits.numel() * 8} B of tokens): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # per-launch times of the encode side at the path's shapes (frame 0)
    kernels["pre_rgb_to_planes:decimate"]["ms"] = event_ms(
        torch, lambda: prepost_kernel.preprocess_packed(
            x, geo, geo.param_image), 20, flush) / 2     # 2 launches
    kernels["pack_stuff_rows"]["ms"] = event_ms(
        torch, lambda: fusedpack.pack_stuff_rows(bits, lens, markers,
                                                 stride), 10, flush)
    pl_bytes = sum(p_.numel() for p_ in planes)
    kernels["pre_rgb_to_planes:decimate"]["bound_ms"] = (
        x.numel() + pl_bytes) / 2 / PEAK_BYTES_S * 1e3
    # every length is read; bits only in the 4-slot quads that hold a token
    # (the kernel skips a quad whose lengths are all 0)
    quads = int((lens.view(lens.shape[0], -1, 4) != 0).any(-1).sum())
    kernels["pack_stuff_rows"]["bound_ms"] = (
        lens.numel() * 4 + quads * 16 + markers.numel() * 4 + int(rb.sum())
        + rb.numel() * 4) / PEAK_BYTES_S * 1e3
    del bits, lens, rows, il_coefs, planes, x

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
    launches.update({n: _kernels.LAUNCHES[n] for n in (
        "huffdec_scan", "huffdec_block", "idct_planes", "post_rgb")})
    if _kernels.LAUNCHES["dpost_rgb"]:
        raise AssertionError("the 4:2:0 decode went through dpost_rgb")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "4:2:0 path")
    if min(psnrs) < 20:
        raise AssertionError(f"8K 4:2:0 decode PSNR {psnrs} dB")
    log(f"[il 8k dec] 3 streams: PSNR vs source "
        + ", ".join(f"{v:.2f}" for v in psnrs) + f" dB, launches {launches}")
    for i in range(9):
        t0 = time.perf_counter()
        dec.decode(streams[i % 3])
        dwalls.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(dwalls, [25, 50, 75])
    log(f"[il 8k dec] wall ms per frame (bytes in, host array out), "
        f"{len(dwalls)} frames: median {q[1]:.3f}, quartiles {q[0]:.3f} / "
        f"{q[2]:.3f}; " + ", ".join(f"{w:.3f}" for w in dwalls))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hf = dec.prepare(streams[0])
    t1 = time.perf_counter()
    p = hf.plan
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    ev[0].record()
    words = torch.from_numpy(hf.words).to(dev)
    nbits = torch.from_numpy(hf.nbits).to(dev)
    ev[1].record()
    args = (p.nblocks, p.dc_luma, p.ac_luma, p.tables)
    bstart, _ea = thd.scan_segments(words, nbits, *args, p.bps, p.pattern)
    ev[2].record()
    coefs, _ec = thd.decode_blocks(words, bstart, *args, p.pattern)
    ev[3].record()
    coefs = tdec._dc_fixup_t(coefs, words.shape[0], p.bps, p.comp_slots)
    ev[4].record()
    dplanes = [prepost_kernel.idct_planes(coefs, p.qtabs[c.index], p.geo, c)
               for c in p.geo.components]
    ev[5].record()
    img = prepost_kernel.postprocess_packed(dplanes, p.geo, hf.out_pi)
    ev[6].record()
    host = img.cpu()
    ev[7].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not np.array_equal(host.numpy(), dec.decode(streams[0])):
        raise AssertionError("stage-by-stage 4:2:0 decode differs from "
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
    log(f"[il 8k dec] stages (parse + unstuff on the host clock, the rest "
        f"CUDA events; {words.numel() * 4} B of words): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # -- d. per-launch times of the decode side at the path's shapes -------
    kernels["huffdec_scan:pattern"]["ms"] = event_ms(
        torch, lambda: thd.scan_segments(words, nbits, *args, p.bps,
                                         p.pattern), 20, flush)
    kernels["huffdec_block:pattern"]["ms"] = event_ms(
        torch, lambda: thd.decode_blocks(words, bstart, *args, p.pattern),
        20, flush)
    ms_i, lib_i, bound_i = [], [], []
    nmat = prepost_kernel.idct_matrix(dev)
    L = coefs.shape[1]
    for c in p.geo.components:
        q = p.qtabs[c.index]
        ms_i.append(event_ms(torch, lambda: prepost_kernel.idct_planes(
            coefs, q, p.geo, c), 20, flush))
        # yardstick: one f32 product of the component's dequantized
        # (blocks, 64) coefficients by the IDCT matrix (TF32 off); timed
        # here only, never called by the port
        cols = prepost_kernel.block_columns(p.geo, c, dev)
        y = (coefs[:, cols].T.float() * q).contiguous()
        lib_i.append(event_ms(torch, lambda: torch.matmul(y, nmat), 10,
                              flush))
        nblk = cols.numel()
        bound_i.append(max(2 * 64 * 64 * nblk / PEAK_F32_FLOP_S,
                           (nblk * 64 * 2 + nblk * 64 + 64 * 4
                            + 64 * 64 * 4) / PEAK_BYTES_S) * 1e3)
        del y, cols
    kernels["idct_planes"].update(ms=sum(ms_i) / 3,
                                  library_ms=sum(lib_i) / 3,
                                  bound_ms=sum(bound_i) / 3)
    kernels["post_rgb"]["ms"] = event_ms(
        torch, lambda: prepost_kernel.postprocess_packed(
            dplanes, p.geo, hf.out_pi), 20, flush)
    nseg = words.shape[0]
    seg_bytes = 4 * nseg * 4 + p.tables.numel() * 4
    w_bytes = stream_word_bytes(nbits)
    kernels["huffdec_scan:pattern"]["bound_ms"] = (
        w_bytes + seg_bytes + bstart.numel() * 4 + nseg) / PEAK_BYTES_S * 1e3
    kernels["huffdec_block:pattern"]["bound_ms"] = (
        w_bytes + seg_bytes + bstart.numel() * 4 + L * 64 * 2 + L * 4) \
        / PEAK_BYTES_S * 1e3
    kernels["post_rgb"]["bound_ms"] = (
        sum(d.numel() for d in dplanes) + img.numel()) / PEAK_BYTES_S * 1e3
    for name, k in kernels.items():
        lib = k["library_ms"]
        log(f"[il time] {name}: {k['ms']:.4f} ms per launch (bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}), plain "
            f"{k['plain_ms']:.3f} ms, library "
            f"{'-' if lib is None else format(lib, '.4f')} ms")
    return kernels, {name: launches[k.get("key", name)]
                     for name, k in kernels.items()}


def main() -> int:
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
    build_s = _kernels.build()
    log(f"[build] kernels built in {build_s:.1f} s")
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
            if fkind == "gradient" and c.index == 0:
                kernels["fdct_quant"]["plain_ms"] = event_ms(
                    torch, lambda: fusedpack.fdct_quant_plain(
                        planes[0], tabs, rst), 3)
                kernels["huffman_segments"]["plain_ms"] = event_ms(
                    torch, lambda: fusedpack.huffman_segments_plain(
                        coefs, c.mcu_count, tabs), 2)
            log(f"[kernels] 8K {fkind} comp {c.index}: pre, fdct, huffman "
                f"equal to plain; max row {int(needs[1])} B, stuffed "
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
        data = np.frombuffer(out, np.uint8)
        if out[:2] != b"\xff\xd8" or out[-2:] != b"\xff\xd9":
            raise AssertionError("8K stream lacks SOI/EOI")
        ff = np.nonzero(data[:-1] == 0xFF)[0]
        nrst = int(((data[ff + 1] >= 0xD0) & (data[ff + 1] <= 0xD7)).sum())
        if nrst != geo.segment_count - geo.scan_count:
            raise AssertionError(f"RST count {nrst} != "
                                 f"{geo.segment_count - geo.scan_count}")
    launches = {name: _kernels.LAUNCHES[name] for name in kernels}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    log(f"[8k] {len(frames)} frames 7680x4320 Q75 rst "
        f"{geo.param.restart_interval}: bytes {sizes}, segments "
        f"{geo.segment_count}, RST markers ok, launches {launches}")
    # nine more frames (after the launch counts were read) for the spread
    for i in range(9):
        t0 = time.perf_counter()
        enc.encode(frames[i % 3], params)
        walls.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(walls, [25, 50, 75])
    log(f"[8k] wall ms per frame (host frame in, bytes out), {len(walls)} "
        f"frames: median {q[1]:.3f}, quartiles {q[0]:.3f} / {q[2]:.3f}; "
        + ", ".join(f"{w:.3f}" for w in walls))

    # stage breakdown of one more frame (after the launch counts were read)
    f = frames[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    x = torch.from_numpy(f).to(dev)
    ev[1].record()
    planes = prepost_kernel.preprocess_packed(x, geo, geo.param_image)
    ev[2].record()
    coefs = []
    for c in geo.components:
        tabs = enc.class_tables(QUALITY, c.table_index == 0)
        coefs.append(fusedpack.fdct_quant(planes[c.index], tabs,
                                          c.segment_mcu_count))
    ev[3].record()
    rows, rbs = [], []
    for c, co in zip(geo.components, coefs):
        tabs = enc.class_tables(QUALITY, c.table_index == 0)
        r, rb, _ = fusedpack.huffman_segments(co, c.mcu_count, tabs)
        rows.append(r)
        rbs.append(rb)
    ev[4].record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = enc.assemble(geo, {"rows": rows, "row_bytes": rbs})
    t2 = time.perf_counter()
    if out != enc.encode(f, params):
        raise AssertionError("stage-by-stage encode differs from encode()")
    stages = dict(h2d_ms=ev[0].elapsed_time(ev[1]),
                  pre_ms=ev[1].elapsed_time(ev[2]),
                  fdct_3_planes_ms=ev[2].elapsed_time(ev[3]),
                  huffman_3_planes_ms=ev[3].elapsed_time(ev[4]),
                  device_wall_ms=(t1 - t0) * 1e3,
                  assemble_d2h_host_ms=(t2 - t1) * 1e3)
    log("[8k] stages (CUDA events; assembly on the host clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

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
        h_bytes = ncoef * 2 + 272 * 4 + int(rb.sum()) + 4 * rb.numel()
        bound_h.append(h_bytes / PEAK_BYTES_S * 1e3)
        # yardstick: one float32 product of the same blocks (TF32 off);
        # timed here only, never called by the port
        blocks = planes[c.index].reshape(
            c.data_height // 8, 8, c.data_width // 8, 8).permute(
            0, 2, 1, 3).reshape(-1, 64).float()
        lib_f.append(event_ms(torch, lambda: torch.matmul(blocks, tabs.mq),
                              10, flush))
        del blocks
    kernels["fdct_quant"].update(ms=sum(ms_f) / 3, library_ms=sum(lib_f) / 3)
    kernels["huffman_segments"]["ms"] = sum(ms_h) / 3
    kernels["fdct_quant"]["bound_ms"] = sum(bound_f) / 3
    kernels["huffman_segments"]["bound_ms"] = sum(bound_h) / 3
    pre_bytes = x.numel() + 3 * c0.data_height * c0.data_width
    kernels["pre_rgb_to_planes"]["bound_ms"] = pre_bytes / PEAK_BYTES_S * 1e3
    for name, k in kernels.items():
        log(f"[time] {name}: {k['ms']:.4f} ms per launch (bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}), plain "
            f"{k['plain_ms']:.3f} ms, library "
            f"{'-' if k['library_ms'] is None else format(k['library_ms'], '.4f')}"
            " ms")

    # -- 6. decode ------------------------------------------------------------
    del x, planes, coefs, rows
    noise_stream = enc.encode(
        make_frame(torch, "noise", 13, H8K, W8K, dev).cpu().numpy(), params)
    dec_kernels, dec_launches = decode_phases(
        torch, np, gt, dev, streams, frames, noise_stream, flush)
    kernels.update(dec_kernels)
    launches.update(dec_launches)

    # -- 7. the interleaved 4:2:0 path ----------------------------------------
    il_kernels, il_launches = interleaved_phases(torch, np, gt, dev, flush)
    kernels.update(il_kernels)
    launches.update(il_launches)

    # -- 8. kernels line -----------------------------------------------------
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[name],
         "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"]}
        for name, k in kernels.items()]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(line))
    # -- 9. result -----------------------------------------------------------
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
