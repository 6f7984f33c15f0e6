#!/usr/bin/env python3
"""Design steps of phase C's direct instance and of the DC fix-up, timed
on one CUDA card.

    python3 chip_variants.py [OUT.json]

Builds csrc/huffdec_block.cu and csrc/dc_fixup.cu as they stand and as
each variant below rewrites them (a source edit a step, each built by
nvcc into a library of its own under gpujpeg_tpu_torch/_build/variants/),
and times every library on the same inputs, in turns (each variant, then
each again in reverse order): the direct instance
(gj_huffdec_block_direct) on the 8K Q100 streams of chip_smoke.py's
[tool] step (planar 4:4:4 and grey, a gradient and its noise twin), the
fix-up (gj_dc_fixup, FIXUP_VARIANTS) on the differential DC of the six
[session] layouts.  Every variant's output is held against the tree's
(max_abs_err, 0).  Prints a JSON line a stream or layout and, given
OUT.json, writes them there.  It imports nothing of JAX and exits
non-zero without a card.

The variants take one step of the design out at a time:
  double_buffered      rows double-buffered at every width (the launch
                       picks single buffering where more CTAs then fit:
                       24 warps an SM instead of 16 at 8K Q100);
  half_ctas            half the CTAs the card holds (the walk's dependence
                       on resident warps);
  second_level_inline  the second-level load taken in the common path,
                       where the compiler predicates it;
  global_rows          rows read from global memory, not staged;
  three_words_ahead    the window's load issued a word earlier;
  lut_10_bits          a first level of 10 bits (its table built so);
  crossing_branch      the window's move to the next word as a branch,
                       not selects and a predicated load.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

FIRST = "        e = direct_first(tac, peek);\n"
VARIANTS = {
    "double_buffered": [("        const int rc = one > two\n",
                         "        const int rc = false\n")],
    "half_ctas": [("    const int grid = want < fit ? (int)want : fit;\n"
                   "    const bool vec = nseg % 8 == 0",
                   "    const int grid = want < fit / 2 ? (int)want "
                   ": fit / 2;\n    const bool vec = nseg % 8 == 0")],
    "second_level_inline": [(FIRST, FIRST + "        if (e & kDirSub) e = "
                             "direct_second(tac, e, peek);\n")],
    "global_rows": [("constexpr int kMaxStagedW = 1024;",
                     "constexpr int kMaxStagedW = 0;")],
    "three_words_ahead": [
        ("    uint32_t nx = row.raw(2);",
         "    uint32_t nx = row.raw(2), nx2 = row.raw(3);"),
        ("int rem = bend - adv, sh = adv, k = 1, next = 3;",
         "int rem = bend - adv, sh = adv, k = 1, next = 4;"),
        ("""        row.raw_if(cross, next, nx);
""", """        nx = cross ? nx2 : nx;
        row.raw_if(cross, next, nx2);
""")],
    "lut_10_bits": [("constexpr int kDirBits = 11;",
                     "constexpr int kDirBits = 10;")],
    "crossing_branch": [("""        const bool cross = sh >= 32;
        sh -= cross ? 32 : 0;
        hi = cross ? lo : hi;
        lo = cross ? swapped(nx) : lo;
        row.raw_if(cross, next, nx);
        next += cross;
""", """        if (sh >= 32) {
            sh -= 32;
            hi = lo;
            lo = swapped(nx);
            nx = row.raw(next++);
        }
""")],
}


#: variants that read a table of another first-level width
LUT_BITS = {"lut_10_bits": 10}


#: the DC fix-up's design steps (csrc/dc_fixup.cu), each taken out:
#:   tile_rows_everywhere  no thread layout: rows of 6 and 8 slots take
#:                         the warp and CTA scan of tiles of whole rows;
#:   chain_one_vector      chained tiles of one vector a thread (2,048
#:                         slots, twice the tiles);
#:   long_pauses           the look-back's pause between polls grows to
#:                         1,024 ns, not 128
FIXUP_VARIANTS = {
    "tile_rows_everywhere": [("        if (vec && (kVecSlots * vecs) % bps "
                              "== 0) {",
                              "        if (false) {")],
    "chain_one_vector": [("constexpr int kChainVecs = 2;",
                          "constexpr int kChainVecs = 1;")],
    "long_pauses": [("pause = pause < 128 ? 2 * pause : pause;",
                     "pause = pause < 1024 ? 2 * pause : pause;")],
}


def build(_kernels, source="huffdec_block", variants=None):
    """{variant: loaded library} of csrc/<source>.cu, "tree" the source as
    it stands and each of `variants` (default VARIANTS) with its edits;
    every nvcc at once."""
    variants = VARIANTS if variants is None else variants
    csrc = os.path.join(HERE, "gpujpeg_tpu_torch", "csrc")
    base = open(os.path.join(csrc, f"{source}.cu")).read()
    procs = {}
    for name, edits in [("tree", [])] + list(variants.items()):
        src = base
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: its edit no longer "
                                   f"applies to csrc/{source}.cu")
            src = src.replace(old, new)
        d = os.path.join(HERE, "gpujpeg_tpu_torch", "_build", "variants",
                         source, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(csrc):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, f), d)
        with open(os.path.join(d, f"{source}.cu"), "w") as f:
            f.write(src)
        lib = os.path.join(d, f"lib{source}.so")
        procs[name] = (lib, subprocess.Popen(
            [_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-o", lib,
             os.path.join(d, f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        cdll = ctypes.CDLL(lib)
        entry = "huffdec_block_direct" if source == "huffdec_block" \
            else source
        getattr(cdll, f"gj_{entry}").argtypes = _kernels._SIGNATURES[entry]
        libs[name] = cdll
    return libs


def fixup(torch, lib, coefs, p, scratch, gen):
    """One library's DC fix-up of coefs in place, with the look-back
    records `scratch` (big enough for any variant's tiles) and generation
    gen."""
    bpm, pat, _n = p.comp_pattern
    rc = lib.gj_dc_fixup(coefs.data_ptr(), coefs.shape[1] // p.bps, p.bps,
                         bpm, pat, scratch.data_ptr(), scratch.numel(), gen,
                         torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"gj_dc_fixup failed: error {rc}")


def fixup_variants(torch, cs, gt, dev, flush, _kernels) -> dict:
    """The fix-up's design steps (FIXUP_VARIANTS) on the six layouts of
    chip_smoke.py's [session] step (an 8K gradient frame's differential
    DC after phases A and C), in turns; each variant's DC held against the
    tree's."""
    from gpujpeg_tpu_torch.models import decoder as tdec

    libs = build(_kernels, "dc_fixup", FIXUP_VARIANTS)
    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    frame = cs.make_frame(torch, "gradient", 700, cs.H8K, cs.W8K,
                          dev).cpu().numpy()
    gens = iter(range(1, 1 << 30))
    out = {}
    for tag, *_ in cs.SESSION_LAYOUTS:
        hf = dec.prepare(enc.encode(frame, cs.session_params(gt, tag)))
        p = hf.plan
        words, nbits = dec.upload(hf)
        bstart, _e = cs.scan_call(words, nbits, p)
        coefs, _e = cs.block_call(words, bstart, p)
        del words, bstart
        tiles = -(-coefs.shape[1] // tdec.DC_TILE)
        scratch = torch.zeros(tdec.fixup_scratch_words(tiles),
                              dtype=torch.int32, device=dev)
        ref = coefs.clone()
        fixup(torch, libs["tree"], ref, p, scratch, next(gens))
        row = {}
        for name in list(libs) + list(libs)[::-1]:
            got = coefs.clone()
            fixup(torch, libs[name], got, p, scratch, next(gens))
            row[f"{name}_err"] = cs.diff(got, ref)
            row.setdefault(f"{name}_ms", []).append(cs.event_ms(
                torch, lambda: fixup(torch, libs[name], got, p, scratch,
                                     next(gens)), 20, flush))
        out[f"dc_fixup_{tag}"] = row
        cs.log(f"[variants] dc_fixup 8K {tag}: " + json.dumps(row))
        del coefs, ref, got
    return out


def direct(torch, thd, lib, words, nbits, p, lut):
    """(coefs, err) of one library's direct instance with table lut."""
    nseg = words.shape[0]
    coefs = torch.empty((64, nseg), dtype=torch.int16, device=words.device)
    err = torch.empty(nseg, dtype=torch.int32, device=words.device)
    args = (words, nseg, words.shape[1], nbits, p.nblocks, p.dc_luma,
            p.ac_luma, *p.pattern, thd.table_sets(p.tables), lut,
            lut.shape[1], coefs, err)
    rc = lib.gj_huffdec_block_direct(
        *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"gj_huffdec_block_direct failed: error {rc}")
    return coefs, err


def lut_of(torch, thd, p, bits):
    """The plan's direct_lut, or the same table built with a first level
    of `bits` bits."""
    if bits is None:
        return p.direct_lut
    keep = thd.DIRECT_LUT_BITS
    thd.DIRECT_LUT_BITS = bits
    try:
        return torch.from_numpy(thd.direct_lut(p.tables.cpu().numpy())).to(
            p.tables.device)
    finally:
        thd.DIRECT_LUT_BITS = keep


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import gpujpeg_tpu_torch as gt
    from gpujpeg_tpu_torch.ops import _kernels
    from gpujpeg_tpu_torch.ops import huffdec_kernel as thd

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cs.log(smi)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    out = {"device": smi}
    out.update(fixup_variants(torch, cs, gt, dev, flush, _kernels))
    libs = build(_kernels)
    enc, dec = gt.Encoder(device=dev), gt.Decoder(device=dev)
    params = gt.Parameters(quality=100, restart_interval=gt.RESTART_AUTO)
    for kind in ("rgb", "grey"):
        for what, seed in (("gradient", 300), ("noise", 303)):
            frame = cs.make_frame(torch, what, seed, cs.H8K, cs.W8K, dev)
            if kind == "grey":
                frame = frame[..., 0].contiguous()
            hf = dec.prepare(enc.encode(frame.cpu().numpy(), params))
            p = hf.plan
            words, nbits = dec.upload(hf)
            luts = {name: lut_of(torch, thd, p, LUT_BITS.get(name))
                    for name in libs}
            ref = direct(torch, thd, libs["tree"], words, nbits, p,
                         luts["tree"])
            row = {"words_a_row": words.shape[1]}
            for name in list(libs) + list(libs)[::-1]:
                got = direct(torch, thd, libs[name], words, nbits, p,
                             luts[name])
                row[f"{name}_err"] = max(cs.diff(got[0], ref[0]),
                                         cs.diff(got[1], ref[1]))
                row.setdefault(f"{name}_ms", []).append(cs.event_ms(
                    torch, lambda: direct(torch, thd, libs[name], words,
                                          nbits, p, luts[name]), 20,
                    flush))
            out[f"{kind}_{what}"] = row
            cs.log(f"[variants] 8K Q100 {kind} {what}: " + json.dumps(row))
            del words, ref
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
