"""Mesh-sharded batch coding: frames x restart-segment stripes
(gpujpeg_tpu.parallel.batch).

New capability relative to the reference (single-GPU, one image at a
time; host-thread scaling only, test/misc/mt_encode.c), with the JAX
package's two axes:

  'data' -- frames of a batch; no communication between them
  'seg'  -- horizontal stripes of each frame whose restart segments are
            bit-identical to the same segments of the whole-frame encode:
            DC prediction resets at every restart marker, so a stripe of
            whole segment rows codes on its own

Each stripe is coded on its mesh place's device by an Encoder session of
that device, at the stripe's geometry (the whole frame's parameters, the
stripe's height): the preprocessor, the DCT and the Huffman coder, the
same kernels as Encoder.encode (csrc/pre_rgb_to_planes.cu,
csrc/fdct_quant.cu, csrc/huffman_segments.cu; Annex-K tables through the
tokenizer and csrc/pack_stuff_rows.cu).  The caller gives the coder its
markers: every segment of stripe s of scan k, the stripe's last included,
is followed by RST((s * S_k + j) mod 8), S_k the stripe's segments in
scan k, so the stripes concatenate into the frame's RST sequence
(fusedpack.stripe_markers).  The per-segment byte counts come back with
the rows; the host stitch cuts the rows to them, concatenates the
stripes scan by scan and drops each scan's frame-final marker.  At
restart interval 0 (one segment a scan, so 'seg' is 1) a frame's scan
tokens come back instead and are packed on the host, as Encoder.encode
packs them.  The stream equals Encoder.encode's, as the JAX package's
does, with two exceptions that the JAX package shares (ROADMAP queue
3): a flat planar frame at seg > 1 is cut into equal byte chunks, not
into stripes of each plane (Q11), and the stitch writes no segment-info
headers (Q12).

ShardedDecoder decodes one frame's stripes over 'seg' (each place runs
the decoder's whole device pipeline on its stripe's segment rows, and
the image is the stripes in row order); BatchDecoder decodes a batch of
same-geometry streams over 'data'.  Every device of a mesh gets its own
Encoder or Decoder session, with its own streams and pinned staging;
places that share a torch device share its session.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..models import encoder as enc_mod
from ..models.decoder import (CapacityError, Decoder, HostFrame, _bucket,
                              _table_signature, pinned_empty,
                              resolve_output)
from ..stream import reader, segments as segprep, writer as jwriter
from ..types import ImageParameters, Parameters
from ..utils.geometry import Geometry, get_geometry
from .mesh import Mesh

log = logging.getLogger("gpujpeg_tpu_torch")


def stripe_alignment(geo: Geometry) -> int:
    """Smallest stripe height (in pixels) such that stripes coincide with
    whole restart segments for every scan; 0 if the geometry cannot be
    segment-sharded by rows."""
    rst = geo.param.restart_interval
    if rst <= 0:
        return 0
    lcm_px = 1
    for c in geo.components:
        # smallest number of MCU rows whose MCU count is a segment multiple
        k = rst // np.gcd(rst, c.mcu_count_x)
        stripe_px = k * c.mcu_size_y * (geo.max_v // c.samp_v)
        lcm_px = np.lcm(lcm_px, stripe_px)
    return int(lcm_px)


def shardable(geo: Geometry, n_seg_shards: int) -> bool:
    a = stripe_alignment(geo)
    H = geo.param_image.height
    return a > 0 and H % (a * n_seg_shards) == 0


def feasible_seg_shards(geo: Geometry, n_max: int) -> int:
    """Largest seg-shard count <= n_max the geometry supports (1 = no
    segment sharding, frames-only parallelism)."""
    for s in range(n_max, 0, -1):
        if s == 1 or shardable(geo, s):
            return s
    return 1


def _comp_scan_width(W: int, seg_lens: np.ndarray, lo: int, hi: int) -> int:
    """A component's row width in words with its guard word, as the JAX
    package sizes its phase-A scan (gpujpeg_tpu.models.decoder.
    _comp_scan_width): the pipeline's width W, or less for a component
    whose segments are shorter.  The port's kernels take any width; the
    widths only make pack refuse the streams the JAX class refuses."""
    mb = int(seg_lens[lo:hi].max())
    return min(W, _bucket(max(1, (mb + 3) // 4), lo=4) + 1)


def _on(device: torch.device):
    """The context that makes `device` current where it is a CUDA one."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _stripes(raw, n_seg: int) -> list:
    """A frame's n_seg equal parts along its first axis, as the JAX
    package's in_specs P("data", "seg") split it: rows of an (H, W[, C])
    frame, equal byte chunks of a flat one."""
    if raw.shape[0] % n_seg:
        raise ValueError(f"a frame of {raw.shape[0]} leading elements does "
                         f"not split into {n_seg} equal stripes")
    h = raw.shape[0] // n_seg
    return [raw[s * h:(s + 1) * h] for s in range(n_seg)]


class _Sessions:
    """One session of a class a torch device, made at first use."""

    def __init__(self, cls) -> None:
        self.cls = cls
        self.by_device: Dict[torch.device, object] = {}

    def __call__(self, device: torch.device):
        s = self.by_device.get(device)
        if s is None:
            s = self.by_device[device] = self.cls(device=device)
        return s


def make_batch_encode_fn(mesh: Mesh, param: Parameters,
                         pi: ImageParameters, caps=None):
    """Sharded batch encode: -> (fn, geo_local).

    fn(raws, indices=None, batch_size=None) queues the frames raws (their
    global indices in the batch `indices`, range(len(raws)) by default,
    of a batch of batch_size frames, len(raws) by default) and returns,
    a frame each, the list of its stripes' device results
    (Encoder._device_rows at geo_local, shard s; at restart interval 0,
    where 'seg' is 1, the frame's scan tokens, Encoder._device_tokens),
    nothing waited for.
    Frame b's stripes run on the mesh places of 'data' row b // (
    batch_size / data extent), stripe s on place (row, s); every segment
    is followed by its marker (the stitch drops each scan's
    frame-final one).  param must be adjusted (enc_mod.adjust_params).
    caps is taken for the JAX package's signature and not read: the rows
    have a worst-case stride."""
    n_seg = mesh.shape["seg"]
    data = mesh.shape["data"]
    H = pi.height
    if H % n_seg:
        raise ValueError(f"height {H} does not split into {n_seg} stripes")
    geo_local = get_geometry(param, pi.with_(height=H // n_seg))
    if n_seg > 1 and not shardable(get_geometry(param, pi), n_seg):
        raise ValueError("geometry not row-shardable into whole segments")
    enc_mod.check_tables(geo_local)
    sessions = _Sessions(enc_mod.Encoder)
    rst0 = param.restart_interval == 0

    def fn(raws, indices: Optional[Sequence[int]] = None,
           batch_size: Optional[int] = None) -> list:
        B = len(raws) if batch_size is None else batch_size
        if B % data:
            raise ValueError(f"batch_size {B} not divisible by the mesh "
                             f"'data' extent {data}")
        per = B // data
        out = []
        for i, raw in enumerate(raws):
            row = (i if indices is None else indices[i]) // per
            parts = []
            for s, stripe in enumerate(_stripes(raw, n_seg)):
                dev = mesh.device(row, s)
                with _on(dev):
                    ses = sessions(dev)
                    parts.append((dev, ses._device_tokens(stripe, geo_local)
                                  if rst0 else ses._device_rows(
                                      stripe, geo_local, shard=s)))
            out.append(parts)
        return out

    fn.sessions = sessions
    return fn, geo_local


class BatchEncoder:
    """Encode batches of equally-sized frames across a device mesh.  caps
    is taken for the JAX class's signature and not read: the rows have a
    worst-case stride, so no capacities converge."""

    def __init__(self, mesh: Mesh, param: Parameters, pi: ImageParameters,
                 caps=None):
        self.mesh = mesh
        self.param = enc_mod.adjust_params(param, pi)
        self.pi = pi
        self.geo = get_geometry(self.param, pi)
        self.n_seg = mesh.shape["seg"]
        self.fn, self.geo_local = make_batch_encode_fn(
            mesh, self.param, pi, caps)

    def _streams(self, queued: list) -> List[bytes]:
        """The streams of fn's queued frames: a frame at a time, its
        stripes' row counts, then their rows cut to the longest row of
        each scan, copied back on their sessions' download streams after
        their kernels; the later frames' kernels run meanwhile.  At
        restart interval 0 a frame's scan tokens come back instead and
        are packed on the host, as Encoder.encode packs them."""
        header = jwriter.write_header(self.geo)
        geo_l = self.geo_local
        bounds = geo_l.scan_seg_bounds
        out = []
        for parts in queued:
            if "tokens" in parts[0][1]:
                (dev, res), = parts
                with _on(dev):
                    scans = self.fn.sessions(dev)._fetch_tokens(res)
                out.append(enc_mod.pack_scans(header, self.geo, scans))
                continue
            rows_s, rb_s = [], []
            for dev, res in parts:
                stage = self.fn.sessions(dev)._staging
                with _on(dev):
                    rb = stage.download(res["rb"], res["done"]).get().numpy()
                    fetches = []
                    for k in range(geo_l.scan_count):
                        seg = rb[int(bounds[k]):int(bounds[k + 1])]
                        width = int(seg.max()) if len(seg) else 0
                        fetches.append(stage.download(
                            res["rows"][k][:, :width], res["done"]))
                    rows_s.append([f.get().contiguous().numpy()
                                   for f in fetches])
                rb_s.append(rb)
            out.append(self._stitch(header, rows_s, np.stack(rb_s)))
        return out

    def encode_batch(self, raws) -> list:
        """raws: (B, ...) uint8 frames (B a multiple of the mesh 'data'
        extent) -> list of JPEG byte strings.  Every frame's and stripe's
        kernels are queued before the first row comes back, so the host
        stitch of frame b overlaps the kernels of the frames after it."""
        return self._streams(self.fn(raws))

    def encode_batch_local(self, local_frames):
        """MULTI-PROCESS batch encode: each process passes only ITS OWN
        frames (the global batch rows local_frame_indices selects, in
        that order) and gets back (streams, global_indices) for exactly
        those frames.  A frame's stripes stay on its own process's
        devices by mesh construction (dist.make_global_mesh), so no pixel
        or codestream byte crosses processes; the rows have a worst-case
        stride, so the processes agree on no capacity either.  Degrades
        to encode_batch on a single process."""
        from . import dist

        local_frames = list(local_frames)
        if dist.process_count() == 1:
            return (self.encode_batch(local_frames),
                    list(range(len(local_frames))))
        rows_mine = dist.data_rows_of_process(self.mesh)
        if not rows_mine:
            raise ValueError("this process owns no mesh 'data' rows")
        if len(local_frames) % len(rows_mine):
            raise ValueError(
                f"{len(local_frames)} local frames do not split evenly "
                f"over this process's {len(rows_mine)} 'data' rows")
        B = (len(local_frames) // len(rows_mine)) * self.mesh.shape["data"]
        frames = dist.make_global_batch(self.mesh, ("data", "seg"),
                                        local_frames, B)
        idx = list(frames)
        return self._streams(self.fn([frames[b] for b in idx], idx, B)), idx

    def _stitch(self, header: bytes, rows_s: list,
                rb_s: np.ndarray) -> bytes:
        """Reorder shard-local segments into global scan order and emit.

        rows_s[s][k] holds stripe s's rows of scan k, cut to their longest
        row; rb_s (n_seg, the stripe's segments) their byte counts.  Scan
        k's segments are its stripes' in stripe order; each scan's
        frame-final RST marker (present because a stripe cannot know it
        is last) is stripped here."""
        geo, geo_l = self.geo, self.geo_local
        parts = [header]
        for k in range(geo.scan_count):
            parts.append(jwriter.write_scan_header(geo, k))
            b0 = int(geo_l.scan_seg_bounds[k])
            b1 = int(geo_l.scan_seg_bounds[k + 1])
            for s in range(self.n_seg):
                rb = rb_s[s, b0:b1]
                if s == self.n_seg - 1:
                    rb = rb.copy()
                    rb[-1] -= 2       # drop frame-final RST of this scan
                parts.append(native.assemble_rows(rows_s[s][k], rb))
        parts.append(b"\xff\xd9")
        return b"".join(parts)


class ShardedDecoder:
    """Decode ONE frame with its restart-segment rows striped over the
    mesh 'seg' axis, the decode-side counterpart of BatchEncoder's 'seg'
    sharding, for frames too big or too slow for one device (the 16K
    case).  Restart segments are independent coding units (the reference
    decodes one a thread, gpujpeg_huffman_gpu_decoder.cu:390-407), so a
    stripe of whole segment rows decodes on its own: place s of mesh row
    0 runs the decoder's whole device pipeline (phases A and C, the DC
    fix-up, dpost or the IDCT planes and the postprocessor; phase C alone
    on the direct route) on its stripe's rows through a stripe-local plan
    (Decoder._plan, _pixels), and the image is the stripes in row order.

    Non-interleaved scans only, as in the JAX class.  Streams of the
    example's geometry and tables decode; pack refuses another geometry
    or other tables (ValueError) and a segment wider than the example's
    row or per-component widths (CapacityError; decode it on a plain
    Decoder), as the JAX method does.  The port's kernels have no split
    capacities, so decode_to_device never falls back."""

    def __init__(self, mesh: Mesh, example_stream: bytes):
        self.mesh = mesh
        n = mesh.shape["seg"]
        self.n_seg = n
        self.devices = [mesh.device(0, s) for s in range(n)]
        self.sessions = _Sessions(Decoder)
        self.dec = self.sessions(self.devices[0])
        ps = reader.parse(example_stream)
        param = reader.parsed_to_parameters(ps)
        out_pi = resolve_output(ps, None, 0)
        geo = get_geometry(param, out_pi.with_(width_padding=0))
        if geo.interleaved:
            raise ValueError("seg-sharded decode supports non-interleaved "
                             "scans only")
        H = geo.param_image.height
        a = stripe_alignment(geo)
        if not (a > 0 and H % (a * n) == 0):
            raise ValueError(
                f"height {H} not stripeable into {n} whole-segment "
                f"shards (alignment {a})")
        self.out_pi_l = out_pi.with_(width_padding=0, height=H // n)
        geo_l = get_geometry(param, self.out_pi_l)
        self.geo, self.geo_l = geo, geo_l
        self.table_sig = _table_signature(ps)
        # each place's stripe-local plan, on its device
        self.plans = {d: self.sessions(d)._plan(ps, geo_l)
                      for d in dict.fromkeys(self.devices)}

        # shard-major row permutation: global segment rows are
        # comp-major (comp0 segs, comp1 segs, ...); shard s needs
        # [comp_c rows s*Sl_c:(s+1)*Sl_c for every c] contiguously
        comp_bases, base = [], 0
        for c in geo.components:
            comp_bases.append(base)
            base += c.segment_count
        perm = []
        for s in range(n):
            for c, cb in zip(geo.components, comp_bases):
                Sl = c.segment_count // n
                perm.extend(range(cb + s * Sl, cb + (s + 1) * Sl))
        self.perm = np.asarray(perm, np.int64)

        bounds = self.dec._segment_bounds(ps, geo)
        seg_lens = bounds[1] - bounds[0]
        self.max_words = _bucket((int(seg_lens.max()) + 3) // 4)
        W = self.max_words + 1
        # per-component widths from GLOBAL maxima, as the JAX class's
        self.comp_widths = []
        for c, cb in zip(geo.components, comp_bases):
            S = c.segment_count
            self.comp_widths.append(
                (cb, cb + S, _comp_scan_width(W, seg_lens, cb, cb + S)))
        self._buf: Optional[np.ndarray] = None
        self._uploads: list = []

    def pack(self, data: bytes, out=None):
        """Host prep: permuted (words, nbits) for the sharded decode, the
        words unstuffed into `out` when given (a (segments,
        (max_words + 1) * 4) uint8 buffer).  Raises CapacityError when
        the stream is denser than the example (decode it on a plain
        Decoder instead)."""
        ps = reader.parse(data)
        param = reader.parsed_to_parameters(ps)
        out_pi = resolve_output(ps, None, 0)
        g = get_geometry(param, out_pi.with_(width_padding=0))
        if g != self.geo:
            raise ValueError("stream geometry differs from the example")
        if _table_signature(ps) != self.table_sig:
            raise ValueError("stream tables differ from the example")
        st, en = self.dec._segment_bounds(ps, self.geo)
        lens = en - st
        if (int(lens.max()) + 3) // 4 > self.max_words:
            raise CapacityError("segment wider than the compiled row")
        for lo, hi, wc in self.comp_widths:
            if (int(lens[lo:hi].max()) + 3) // 4 > wc - 1:
                raise CapacityError(
                    f"segments {lo}:{hi} exceed the compiled "
                    f"per-component width {wc - 1}")
        st = np.ascontiguousarray(st[self.perm])
        en = np.ascontiguousarray(en[self.perm])
        return segprep.pack_segments_matrix(ps.data, (st, en),
                                            self.max_words, out=out)

    def _scratch(self) -> Optional[np.ndarray]:
        """The reused pinned buffer the words are unstuffed into on CUDA
        (a fresh matrix page-faults inside the unstuff, as
        Decoder._words_scratch says), once the uploads from it of the
        frame before have ended; None on the CPU (torch.from_numpy
        aliases the array there)."""
        if self.devices[0].type != "cuda":
            return None
        for ev in self._uploads:
            ev.synchronize()
        self._uploads = []
        shape = (self.geo.segment_count, (self.max_words + 1) * 4)
        if self._buf is None:
            self._buf = pinned_empty(shape[0] * shape[1]).reshape(shape)
        return self._buf

    def decode_to_device(self, data: bytes) -> torch.Tensor:
        """The frame's uint8 image on the first place's device: each
        stripe's rows uploaded to its place's device (its session's
        staging, from a reused pinned buffer) and decoded there, the
        stripes concatenated by rows."""
        words, nbits = self.pack(data, self._scratch())
        words = words.view(np.int32)
        nbits = np.ascontiguousarray(nbits, np.int32)
        nl = len(words) // self.n_seg
        imgs = []
        for s, dev in enumerate(self.devices):
            dec = self.sessions(dev)
            with _on(dev):
                (w, nb), done = dec._staging.upload(
                    torch.from_numpy(words[s * nl:(s + 1) * nl]),
                    torch.from_numpy(nbits[s * nl:(s + 1) * nl]))
                if done is not None:
                    self._uploads.append(done)
                imgs.append(dec._pixels(self.plans[dev], self.out_pi_l, w,
                                        nb, options=False)[0])
        first = self.devices[0]
        with _on(first):
            return torch.cat([im.to(first) for im in imgs])

    def decode(self, data: bytes) -> np.ndarray:
        """decode_to_device's image in a pinned host block (the first
        place's session's download stream)."""
        img = self.decode_to_device(data)
        with _on(self.devices[0]):
            return self.dec._staging.download(img).get().numpy()


def bitmerge_worst(geo_l: Geometry) -> int:
    """The JAX package's worst-case merge-tree capacities have no
    counterpart: the port's rows have a worst-case stride.  Returns the
    largest such stride of the geometry's segment rows, in bytes."""
    from ..ops import fusedpack

    bits = [fusedpack.block_bits(geo_l.param.quality, luma,
                                 geo_l.param.huffman_tables)
            for luma in (True, False)]
    if geo_l.interleaved:
        return fusedpack.bits_stride(geo_l.segment_mcu_count * sum(
            bits[c.table_index] * c.samp_h * c.samp_v
            for c in geo_l.components))
    return max(fusedpack.bits_stride(c.segment_mcu_count
                                     * bits[c.table_index])
               for c in geo_l.components)


class BatchDecoder:
    """Decode batches of same-geometry streams across the mesh 'data'
    axis, the decode-side counterpart of BatchEncoder (the reference's
    multi-stream story is host threads, test/misc/mt_encode.c).

    The tables, the row width and the output converge on the example
    stream (the compile_stream_pipeline contract); the streams of 'data'
    row r decode on place (r, 0)'s device through its session's device
    pipeline (Decoder._stream_pipeline_parts).  Use a mesh with seg=1:
    decode has no segment axis."""

    def __init__(self, mesh: Mesh, example_stream: bytes,
                 batch_size: int):
        self.mesh = mesh
        data = mesh.shape["data"]
        if batch_size % data:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"the mesh 'data' extent {data}")
        self.rows = [mesh.device(r, 0) for r in range(data)]
        self.sessions = _Sessions(Decoder)
        self.dec = self.sessions(self.rows[0])
        #: each device's (plan, output) of the example's pipeline
        self._plans = {}
        for d in dict.fromkeys(self.rows):
            with _on(d):
                parts = self.sessions(d)._stream_pipeline_parts(
                    example_stream)
            self._plans[d] = parts[7:9]
        (_fn, _w, _n, geo, max_words, comp_widths, table_sig, _plan,
         _out) = parts
        self.geo, self.max_words = geo, max_words
        self.comp_widths = comp_widths
        self.table_sig = table_sig
        self.batch_size = batch_size

    def _decode(self, streams: Dict[int, bytes]):
        """{global index: stream} -> ({global index: image}, the block
        whose slot k holds the k-th stream's image, None when every
        stream fell back): every stream
        parsed and unstuffed into one of its device session's two reused
        pinned buffers, uploaded and decoded there (the steps of
        decode_pipelined), before the first image is waited for; the
        images come back on each session's download stream into the
        slots of one pinned (len(streams), ...) block, so the batch is
        one array with no host copy.  A stream that pack_stream refuses
        with CapacityError is decoded by its device's Decoder.decode in
        its turn."""
        per = self.batch_size // self.mesh.shape["data"]
        jobs = {}
        for b, s in streams.items():
            dev = self.rows[b // per]
            dec = self.sessions(dev)
            plan, out_pi = self._plans[dev]
            with _on(dev):
                dec._swap_scratch()
                try:
                    w, n = dec._pack(s, self.geo, self.max_words,
                                     self.comp_widths, self.table_sig,
                                     scratch=True)
                    words, nbits = dec.upload(HostFrame(
                        plan, out_pi, w.view(np.int32),
                        np.ascontiguousarray(n, np.int32)))
                except CapacityError:
                    jobs[b] = None
                    continue
                except BaseException:
                    dec._drop_scratch()
                    raise
                img, bad = dec._pixels(plan, out_pi, words, nbits)
                jobs[b] = (img, bad, dec._staging.event())
        shapes = {tuple(j[0].shape) for j in jobs.values() if j is not None}
        block = None
        if shapes:
            cuda = any(d.type == "cuda" for d in self.rows)
            block = torch.empty((len(jobs),) + shapes.pop(),
                                dtype=torch.uint8, pin_memory=cuda)
        fetches = {}
        for k, (b, job) in enumerate(jobs.items()):
            if job is None:
                continue
            dev = self.rows[b // per]
            stage = self.sessions(dev)._staging
            with _on(dev):
                fetches[b] = (k, stage.download(job[0], job[2],
                                                out=block[k]),
                              stage.download(job[1], job[2]))
        out = {}
        for k, (b, job) in enumerate(jobs.items()):
            if job is None:
                # denser than the pipeline admits: the validating
                # single-stream decode on the same device
                dev = self.rows[b // per]
                with _on(dev):
                    img = self.sessions(dev).decode(streams[b])
                if block is not None:
                    block[k].copy_(torch.from_numpy(img))
                    img = block[k].numpy()
                out[b] = img
                continue
            _k, image, bad = fetches[b]
            out[b] = image.get().numpy()
            if bool(bad.get()):
                log.warning("corrupt segment(s) during Huffman decode")
        return out, None if block is None else block.numpy()

    def decode_batch(self, streams) -> np.ndarray:
        """streams: list of JPEG byte strings (len == batch_size, same
        geometry and tables as the example) -> (B, ...) decoded images,
        in one pinned host block on CUDA."""
        if len(streams) != self.batch_size:
            raise ValueError(f"expected {self.batch_size} streams, got "
                             f"{len(streams)}")
        out, block = self._decode(dict(enumerate(streams)))
        if block is not None:
            return block
        return np.stack([out[b] for b in range(len(streams))])

    def decode_batch_local(self, local_streams):
        """MULTI-PROCESS batch decode: each process passes only ITS OWN
        streams (the global batch rows local_frame_indices selects) and
        gets back (images, global_indices) for exactly those frames;
        nothing crosses processes.  Degrades to decode_batch on one
        process."""
        from . import dist

        local_streams = list(local_streams)
        if dist.process_count() == 1:
            if len(local_streams) != self.batch_size:
                raise ValueError(
                    f"expected {self.batch_size} streams, got "
                    f"{len(local_streams)}")
            res = self.decode_batch(local_streams)
            return list(res), list(range(len(local_streams)))
        rows_mine = dist.data_rows_of_process(self.mesh)
        if not rows_mine:
            raise ValueError("this process owns no mesh 'data' rows")
        B = (len(local_streams) // len(rows_mine)) \
            * self.mesh.shape["data"]
        if B != self.batch_size:
            raise ValueError(
                f"global batch {B} != configured {self.batch_size}")
        mine = dist.make_global_batch(self.mesh, ("data",), local_streams, B)
        out, _block = self._decode(mine)
        idx = list(mine)
        return [out[b] for b in idx], idx
