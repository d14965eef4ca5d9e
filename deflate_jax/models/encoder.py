"""The DEFLATE encoder pipeline — one jitted program per (batch, level).

Reference analog: `realCompress` + `compressBuffer` (deflate.hpp:630-752).
The reference materializes BOTH fixed and dynamic candidate bitstreams per
block and picks the smaller (quirk Q3, 2x encode work).  Here candidate sizes
are computed *analytically* from histograms (a dot product with the code
length tables), so only the winning encoding is ever emitted.

Stage structure (SURVEY.md §7):
  A. per-block, fully parallel (vmap):  LZ77 tokens -> symbol histograms ->
     dynamic trees + header fields -> candidate bit sizes
  B. cross-block scan (B steps, trivial): exact block-type choice and bit
     offsets — stored blocks need the stream bit phase for their byte-align
     padding (reference: nextByteBoundary, deflate.hpp:117-127)
  C. per-block, fully parallel: emit chosen encoding via the prefix-sum bit
     packer; stored payloads are injected by a whole-block funnel shift, not
     per-byte entries
  D. bit-exact concatenation at the scanned offsets.

Levels (reference levels deflate.hpp:675-679, but all of ours are CORRECT —
the reference's level 2 emits wrong bytes, B1):
  0 = stored only, 1 = Huffman only, 2 = fast (hash chains, greedy),
  3 = best (deeper chains + lazy matching).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from deflate_jax.ops import bitpack as BP
from deflate_jax.ops import header as HDR
from deflate_jax.ops import huffman as H
from deflate_jax.ops import lz77 as LZ
from deflate_jax.utils import tables as T

N = T.BLOCK_SIZE
NT = N + 1                      # token slots incl. end-of-block
# worst case block: stored = 3 hdr + 7 pad + 32 len/nlen + 8*32768 data bits
MAX_BLOCK_BITS = 3 + 7 + 32 + 8 * N
WB = MAX_BLOCK_BITS // 32 + 2   # per-block word capacity

CH_STORED, CH_FIXED, CH_DYN = 0, 1, 2

_J = lambda a: jnp.asarray(a)


def _flog2(x):
    """floor(log2 x) for 1 <= x < 2^24 via the f32 exponent — elementwise,
    no table gather."""
    f = x.astype(jnp.float32)
    return (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 127


def _len_code(length):
    """Match length 3..258 -> length-code index 0..28 (RFC 1951 §3.2.5),
    computed arithmetically (reference: generateLengthLookup linear scan,
    common.hpp:508-540)."""
    m = length - 3
    e = jnp.maximum(_flog2(jnp.maximum(m, 1)) - 2, 0)
    c = jnp.where(m < 8, m, 4 + 4 * e + ((m >> e) - 4))
    return jnp.where(length >= T.MAX_MATCH, 28, c)


def _len_base(c):
    e = jnp.maximum((c - 4) >> 2, 0)
    base = jnp.where(c < 8, c, (1 << (e + 2)) + ((c - 4 - 4 * e) << e))
    return jnp.where(c == 28, 255, base) + 3


def _len_eb(c):
    return jnp.where((c < 8) | (c >= 28), 0, (c - 4) >> 2)


def _dist_code(d):
    """Distance 1..32768 -> distance code 0..29, arithmetic."""
    m = d - 1
    e = _flog2(jnp.maximum(m, 1))
    return jnp.where(m < 4, m, 2 * e + ((m >> jnp.maximum(e - 1, 0)) & 1))


def _dist_base(c):
    e = jnp.maximum((c >> 1) - 1, 0)
    return jnp.where(c < 4, c + 1, (1 << (e + 1)) + ((c & 1) << e) + 1)


def _dist_eb(c):
    return jnp.maximum((c >> 1) - 1, 0)


def tokenize_block(block, blen, level: int):
    """LZ77 parse of one block into position-indexed token arrays.

    No compaction: position i either starts a token (mark[i]) or
    contributes nothing (all-zero entry widths) — avoids the scatter/
    gather token-slot indirection entirely.  Returns dict of [N] arrays.
    """
    if level >= 2:
        # best level: deep chains, 128-byte windows, large parse tiles —
        # beats the reference's level 3 on its corpus (3108 vs 3124 B on
        # test.bmp) at ~4x the fast level's cost
        K = 4 if level == 2 else 48
        ww = 8 if level == 2 else 32
        tile = 512 if level == 2 else 2048
        tiers = () if level == 2 else (2, 4)
        # Far len-3 matches cost more bits than 3 literals on text-like
        # data but pay off on low-entropy data (bitmap row strides) —
        # see LZ.find_matches.  Fast level: static 256.  Best level:
        # per-block adaptive on byte entropy (bitmaps ~2 bits/byte vs
        # text >= 4.5; one extra [N] sort).
        if level == 2:
            toofar3 = 256
        else:
            sb = jnp.sort(block.astype(jnp.int32))
            edges = jnp.searchsorted(sb, jnp.arange(257, dtype=jnp.int32))
            cnt = jnp.diff(edges)
            cnt = cnt.at[0].add(-(N - blen))     # exclude the zero pad
            p = cnt / jnp.maximum(blen, 1)
            ent = -jnp.sum(jnp.where(
                cnt > 0, p * jnp.log2(jnp.maximum(p, 1e-12)), 0.0))
            toofar3 = jnp.where(ent < 3.5, 4096, 256)
        length, dist = LZ.find_matches(block, blen, K, win_words=ww,
                                       tiers=tiers, toofar3=toofar3)
    else:
        length = jnp.zeros((N,), jnp.int32)
        dist = jnp.zeros((N,), jnp.int32)
        tile = 512
    mark, length = LZ.greedy_parse(length, blen, tile=tile)

    is_match = mark & (length >= T.MIN_MATCH)
    lcode = _len_code(jnp.maximum(length, T.MIN_MATCH))
    dcode = _dist_code(jnp.maximum(dist, 1))
    lit_sym = jnp.where(is_match, 257 + lcode, block.astype(jnp.int32))
    ntok = jnp.sum(mark.astype(jnp.int32))
    return {"mark": mark, "is_match": is_match, "lit_sym": lit_sym,
            "len": length, "dist": dist, "lcode": lcode, "dcode": dcode,
            "ntok": ntok}


def _hist_from_sorted(skey, nbins: int, shift: int):
    """Counts per bin from keys sorted by (bin << shift | pos)."""
    sbin = skey >> shift
    edges = jnp.searchsorted(sbin, jnp.arange(nbins + 1, dtype=jnp.int32))
    return jnp.diff(edges)


def _plan_pre(block, blen, level: int):
    """Stage A part 1 for one block: tokens, sorted keys, histograms.

    The litlen keys are sorted once; emit reuses the sorted keys to apply
    the code tables without [N]-sized gathers.
    """
    tk = tokenize_block(block, blen, level)
    pos = jnp.arange(N, dtype=jnp.int32)

    sym_eff = jnp.where(tk["mark"], tk["lit_sym"], 286)
    key_l = sym_eff << 15 | pos
    # unique keys (pos in low bits), so an unstable sort gives the same
    # order; the sorted keys feed ONLY the emit-time table apply
    skey_l = jax.lax.sort([key_l], dimension=0, num_keys=1,
                          is_stable=False)[0]
    # histograms as one-hot reductions: f32 one-hot + f32 accumulation
    # — exact for counts < 2^24 regardless of reduce order
    oh_l = (sym_eff[:, None] == jnp.arange(288, dtype=jnp.int32)[None, :]
            ).astype(jnp.float32)
    hist_lit = jnp.einsum("nk->k", oh_l,
                          preferred_element_type=jnp.float32)
    hist_lit = hist_lit.astype(jnp.int32)[:T.NUM_LITLEN]
    hist_lit = hist_lit.at[286:].set(0)
    hist_lit = hist_lit.at[256].add(1)              # end-of-block

    dc_eff = jnp.where(tk["is_match"], tk["dcode"], 30)
    oh_d = (dc_eff[:, None] == jnp.arange(32, dtype=jnp.int32)[None, :]
            ).astype(jnp.float32)
    hist_dist = jnp.einsum("nk->k", oh_d,
                           preferred_element_type=jnp.float32)
    hist_dist = hist_dist.astype(jnp.int32)[:30]

    m_i = tk["is_match"].astype(jnp.int32)
    extra_total = jnp.sum((_len_eb(tk["lcode"]) + _dist_eb(tk["dcode"]))
                          * m_i)
    return {"tk": tk, "skey_l": skey_l,
            "hist_lit": hist_lit, "hist_dist": hist_dist,
            "extra_total": extra_total}


def _plan_post(pre, dyn_lit_lens, dyn_dist_lens, hv, hl, header_bits):
    """Stage A part 2: analytic candidate sizes."""
    hist_lit, hist_dist = pre["hist_lit"], pre["hist_dist"]
    extra_total = pre["extra_total"]
    fixed_bits = (3 + jnp.sum(hist_lit * _J(T.FIXED_LITLEN_LENGTHS))
                  + jnp.sum(hist_dist * _J(T.FIXED_DIST_LENGTHS)[:30])
                  + extra_total)
    dyn_bits = (3 + header_bits + jnp.sum(hist_lit * dyn_lit_lens)
                + jnp.sum(hist_dist * dyn_dist_lens) + extra_total)
    return {"dyn_lit_lens": dyn_lit_lens, "dyn_dist_lens": dyn_dist_lens,
            "header_vals": hv, "header_lens": hl,
            "fixed_bits": fixed_bits, "dyn_bits": dyn_bits}


def block_plan(block, blen, level: int):
    """Stage A for one block (single-block convenience; batch callers use
    batch_plan)."""
    pre = _plan_pre(block, blen, level)
    dyn_lit_lens = H.huffman_code_lengths(pre["hist_lit"], T.MAX_CODE_LEN)
    dyn_dist_lens = H.huffman_code_lengths(pre["hist_dist"],
                                           T.MAX_CODE_LEN)
    hv, hl, hb = HDR.emit_dynamic_header(dyn_lit_lens, dyn_dist_lens)
    return {**pre, **_plan_post(pre, dyn_lit_lens, dyn_dist_lens,
                                hv, hl, hb)}


def batch_plan(blocks, blens, level: int):
    """Stage A over a batch: vmapped tokens/histograms, batched tree
    builds — litlen, dist, AND the header's CL tree — and vmapped
    header/sizes."""
    pre = jax.vmap(lambda b, l: _plan_pre(b, l, level))(blocks, blens)
    dyn_lit_lens = H.huffman_lengths_batch(pre["hist_lit"],
                                           T.MAX_CODE_LEN)
    dyn_dist_lens = H.huffman_lengths_batch(pre["hist_dist"],
                                            T.MAX_CODE_LEN)
    hpre = jax.vmap(HDR.header_pre)(dyn_lit_lens, dyn_dist_lens)
    cl_lens = H.huffman_lengths_batch(hpre["cl_hist"],
                                      T.MAX_CL_CODE_LEN)
    hv, hl, hb = jax.vmap(HDR.header_post)(hpre, cl_lens)
    post = jax.vmap(_plan_post)(pre, dyn_lit_lens, dyn_dist_lens,
                                hv, hl, hb)
    return {**pre, **post}


def _apply_table_sorted(skey, counts, lens, rank, next_code,
                        nbins: int):
    """Per-position (code, len) lookup without an [N] gather.

    skey: keys (bin << 15 | pos) sorted ascending; counts[bin] — the
    histogram of the first `nbins` bins (bin == nbins marks dead lanes).
    Seeds each bin's compact (len, rank-within-len) at its first sorted
    slot (a tiny scatter of `nbins` elements), fills forward with one
    cummax, restores position order with one SINGLE-OPERAND sort
    (pos<<13 | len<<9 | rank fits 28 bits), then reconstructs the canonical
    code arithmetically: code = bit_reverse(next_code[len] + rank).
    Returns (code [N] bit-reversed, len [N]) position-ordered.
    """
    starts = jnp.cumsum(counts) - counts            # [nbins]
    pack = (lens[:nbins] << 9) | rank[:nbins]       # len(4) | rank(9)
    tgt = jnp.where(counts > 0, starts, N)
    # fill-forward as a native cummax: tag seeds with their (increasing)
    # bin number so later seeds dominate (a native cummax compiles far
    # faster than an associative_scan with a custom select combiner)
    binno = jnp.arange(nbins, dtype=jnp.int32)
    seed = jnp.full((N,), -1, jnp.int32).at[tgt].set(
        (binno << 13) | pack, mode="drop")
    filled = jax.lax.cummax(seed) & ((1 << 13) - 1)
    sbin = skey >> 15
    pk = jnp.where(sbin < nbins, filled, 0)
    pk = jax.lax.sort([(skey & 0x7FFF) << 13 | pk], dimension=0,
                      num_keys=1, is_stable=False)[0]
    l = (pk >> 9) & 15
    r = pk & 511
    nc = jnp.zeros((N,), jnp.int32)
    for i in range(1, 16):
        nc = jnp.where(l == i, next_code[i], nc)
    code = H.bit_reverse(nc + r, l)
    return jnp.where(l > 0, code, 0), l


def _choose_one(offset, fb, db, bl, lv, level: int):
    """Pick-min ladder for one block given its entry bit offset
    (reference deflate.hpp:739-746); broadcast-safe."""
    pad = (-(offset + 3)) & 7
    stored = 3 + pad + 32 + 8 * bl
    if level == 0:
        choice = jnp.broadcast_to(jnp.int32(CH_STORED), stored.shape)
    else:
        choice = jnp.where(stored <= jnp.minimum(fb, db), CH_STORED,
                           jnp.where(fb <= db, CH_FIXED, CH_DYN))
    bits = jnp.where(choice == CH_STORED, stored,
                     jnp.where(choice == CH_FIXED, fb, db))
    bits = jnp.where(lv, bits, 0)
    pad = jnp.where(lv, pad, 0)
    return choice, pad, bits


def choose_blocks(fixed_bits, dyn_bits, blens, live, level: int,
                  phase0=0, chunk: int = 8):
    """Stage B: exact per-block type choice + bit offsets.

    Mirrors the reference's pick-min ladder (deflate.hpp:739-746) but with
    the stored-block byte-align padding computed exactly from the running
    stream phase.  `phase0` is the absolute bit offset of this segment's
    start in the whole stream (only phase0 mod 8 matters) — segments are
    stitched back-to-back at bit granularity, so stored-block padding must
    see the global phase.  Returns (choice, pad, offset, bits) each int32
    [B]; offsets are absolute (include phase0).

    The only cross-block dependency is the running offset, and block bits
    depend on it only through offset mod 8 (the stored padding).  Each
    block therefore defines a tiny map over the 8 entry phases
    (phase -> bits appended); the stream offsets are the prefix
    composition of those maps — computed by log2(B) Hillis-Steele
    doubling rounds over [B, 8] arrays (composition = an 8-way select),
    with NO sequential scan at all.
    """
    B = fixed_bits.shape[0]
    phase0 = jnp.asarray(phase0, jnp.int32)

    # bits8[b, p]: bits block b appends when entering at stream phase p
    ph = jnp.arange(8, dtype=jnp.int32)[None, :]
    _, _, bits8 = _choose_one(ph, fixed_bits[:, None], dyn_bits[:, None],
                              blens[:, None], live[:, None], level)

    def compose(Lm, Rm):
        """(L then R)[p] = L[p] + R[(p + L[p]) & 7] — 8-way select."""
        idx = (ph + Lm) & 7
        acc = jnp.zeros_like(Lm)
        for j in range(8):
            acc = acc + jnp.where(idx == j, Rm[:, j:j + 1], 0)
        return Lm + acc

    # inclusive prefix composition, then shift to exclusive
    M = bits8
    d = 1
    while d < B:
        top = jnp.zeros((min(d, B), 8), jnp.int32)      # identity maps
        M = compose(jnp.concatenate([top, M[:-d]]), M)
        d *= 2
    excl = jnp.concatenate([jnp.zeros((1, 8), jnp.int32), M[:-1]])

    p0 = phase0 & 7
    offset = phase0 + jnp.sum(
        jnp.where(jnp.arange(8)[None, :] == p0, excl, 0), axis=1)
    choice, pad, bits = _choose_one(offset, fixed_bits, dyn_bits,
                                    blens, live, level)
    return choice, pad, offset, bits


def _emit_fields_base(block, blen, plan, choice, pad, bfinal):
    """Shared stage-C planning: per-position packet payloads + header
    entries.  Both placement backends consume this — the merge-tree
    backend (ops/bitmerge.py, the default) and the XLA scatter path
    (emit_block)."""
    tk = plan["tk"]
    stored = choice == CH_STORED
    fixed = choice == CH_FIXED
    dyn = choice == CH_DYN

    # --- code tables for the huffman paths (small [288]/[30] arrays) ---
    dyn_lit_rank, dyn_lit_nc = H.canonical_parts(plan["dyn_lit_lens"])
    dyn_dist_codes, _ = H.canonical_codes(plan["dyn_dist_lens"])
    fx_lit_rank, fx_lit_nc = H.canonical_parts(_J(T.FIXED_LITLEN_LENGTHS))
    fx_dist_codes, _ = H.canonical_codes(_J(T.FIXED_DIST_LENGTHS))

    lit_rank = jnp.where(dyn, dyn_lit_rank, fx_lit_rank[:T.NUM_LITLEN])
    lit_nc = jnp.where(dyn, dyn_lit_nc, fx_lit_nc)
    lit_lens = jnp.where(dyn, plan["dyn_lit_lens"], _J(T.FIXED_LITLEN_LENGTHS))
    dist_codes = jnp.where(dyn, dyn_dist_codes, fx_dist_codes[:30])
    dist_lens = jnp.where(dyn, plan["dyn_dist_lens"],
                          _J(T.FIXED_DIST_LENGTHS)[:30])

    # --- per-position (code, len) via the sorted keys — no [N] gathers ---
    cnt_l = plan["hist_lit"].at[256].add(-1)        # sorted keys lack EOB
    e_lit_v, e_lit_l = _apply_table_sorted(plan["skey_l"], cnt_l[:286],
                                           lit_lens, lit_rank, lit_nc,
                                           286)
    # dist table apply: only 30 symbols and dcode is already arithmetic
    # per position, so a 30-term select-chain (~90 elementwise ops) beats
    # the sorted apply's cummax + restore sort
    dpack = dist_codes[:30] | (dist_lens[:30] << 15)
    dsel = jnp.zeros((N,), jnp.int32)
    for s in range(30):
        dsel = jnp.where(tk["dcode"] == s, dpack[s], dsel)
    e_dc_v, e_dc_l = dsel & 0x7FFF, dsel >> 15

    live_tok = tk["mark"] & ~stored
    m = tk["is_match"]
    e_lit_l = jnp.where(live_tok, e_lit_l, 0)
    e_le_v = tk["len"] - _len_base(tk["lcode"])
    e_le_l = jnp.where(live_tok & m, _len_eb(tk["lcode"]), 0)
    e_dc_l = jnp.where(live_tok & m, e_dc_l, 0)
    e_de_v = tk["dist"] - _dist_base(tk["dcode"])
    e_de_l = jnp.where(live_tok & m, _dist_eb(tk["dcode"]), 0)

    # --- fuse each position's 4 fields into one <=48-bit packet ---------
    # (fusing first cuts scatter lanes 4x and avoids a [4N] interleave)
    lo = jnp.zeros((N,), jnp.uint32)
    hi = jnp.zeros((N,), jnp.uint32)
    sh = jnp.zeros((N,), jnp.int32)
    for v, l in ((e_lit_v, e_lit_l), (e_le_v, e_le_l),
                 (e_dc_v, e_dc_l), (e_de_v, e_de_l)):
        fld = (v.astype(jnp.uint32)
               & ((jnp.uint32(1) << jnp.minimum(l, 16).astype(jnp.uint32))
                  - 1))
        shc = jnp.clip(sh, 0, 31).astype(jnp.uint32)
        in_lo = sh < 32
        lo = lo | jnp.where(in_lo, fld << shc, 0)
        spill = jnp.where(in_lo & (shc > 0),
                          fld >> (jnp.uint32(32) - jnp.maximum(shc, 1)), 0)
        hi = hi | jnp.where(in_lo, spill,
                            fld << jnp.clip(sh - 32, 0, 31).astype(jnp.uint32))
        sh = sh + l

    sh_sym = sh                     # per-SYMBOL widths (decode hints)

    # --- preamble + dynamic header entries -------------------------------
    btype = jnp.where(stored, 0, jnp.where(fixed, 1, 2))
    hdr3 = jnp.stack([bfinal.astype(jnp.int32) | (btype << 1),
                      jnp.int32(0),              # stored byte-align padding
                      blen, blen ^ 0xFFFF])      # LEN, NLEN
    hdr3_l = jnp.stack([jnp.int32(3),
                        jnp.where(stored, pad, 0),
                        jnp.where(stored, 16, 0),
                        jnp.where(stored, 16, 0)])
    hv = plan["header_vals"]
    hl = jnp.where(dyn, plan["header_lens"], 0)

    eob_len = jnp.where(stored, 0, lit_lens[256])
    eob_code = H.bit_reverse(lit_nc[jnp.clip(lit_lens[256], 0, 15)]
                             + lit_rank[256], lit_lens[256])
    ev = (eob_code.astype(jnp.uint32)
          & ((jnp.uint32(1) << eob_len.astype(jnp.uint32)) - 1))

    return {"lo": lo, "hi": hi, "sh": sh, "sh_sym": sh_sym,
            "live_tok": live_tok, "is_match": m, "len": tk["len"],
            "stored": stored, "hdr3": hdr3, "hdr3_l": hdr3_l,
            "hv": hv, "hl": hl, "eob_v": ev, "eob_len": eob_len,
            "ntok": tk["ntok"]}


def _emit_fields(block, blen, plan, choice, pad, bfinal):
    """Stage-C planning for the scatter backend: the base fields plus
    hierarchical <=64-bit packet fusion (folds up to 16 consecutive
    tokens into one packet, so fewer packets are placed).  The
    merge-tree backend subsumes this in its lower tree levels."""
    f = _emit_fields_base(block, blen, plan, choice, pad, bfinal)
    lo, hi, sh = f["lo"], f["hi"], f["sh"]
    live_tok, m = f["live_tok"], f["is_match"]

    def comp64(loA, hiA, sA, loB, hiB, sB):
        """Concatenate packet B after packet A (sA + sB <= 64)."""
        sAc = jnp.clip(sA, 0, 31).astype(jnp.uint32)
        lt32 = sA < 32
        loC = jnp.where(lt32, loA | (loB << sAc), loA)
        spill = jnp.where(lt32 & (sA > 0),
                          loB >> (jnp.uint32(32) - jnp.maximum(sAc, 1)),
                          jnp.uint32(0))
        hiC = hiA | jnp.where(lt32, spill | (hiB << sAc),
                              loB << jnp.clip(sA - 32, 0, 31)
                              .astype(jnp.uint32))
        return loC, hiC, sA + sB

    lr = live_tok & (sh > 0)                       # fusable packets
    # runw[i] = block POSITIONS covered by the packet at i (a literal
    # covers 1, a match covers its length).  A fuse is legal only when
    # the LEFT packet covers its half exactly — otherwise a live token
    # hiding between the halves would be reordered.  Matches may always
    # join on the RIGHT (their coverage just accumulates).
    runw = jnp.where(lr, jnp.where(m, f["len"], 1), 0)
    for lvl in range(4):
        w = 1 << lvl
        loR = lo.reshape(-1, 2 * w)
        hiR = hi.reshape(-1, 2 * w)
        shR = sh.reshape(-1, 2 * w)
        lrR = lr.reshape(-1, 2 * w)
        lvR = live_tok.reshape(-1, 2 * w)
        rwR = runw.reshape(-1, 2 * w)
        can = (lrR[:, 0] & lrR[:, w] & (rwR[:, 0] == w)
               & (shR[:, 0] + shR[:, w] <= 64))
        loC, hiC, shC = comp64(loR[:, 0], hiR[:, 0], shR[:, 0],
                               loR[:, w], hiR[:, w], shR[:, w])
        lo = loR.at[:, 0].set(jnp.where(can, loC, loR[:, 0]))                  .at[:, w].set(jnp.where(can, 0, loR[:, w])).reshape(-1)
        hi = hiR.at[:, 0].set(jnp.where(can, hiC, hiR[:, 0]))                  .at[:, w].set(jnp.where(can, 0, hiR[:, w])).reshape(-1)
        sh = shR.at[:, 0].set(jnp.where(can, shC, shR[:, 0]))                  .at[:, w].set(jnp.where(can, 0, shR[:, w])).reshape(-1)
        runw = rwR.at[:, 0].set(jnp.where(can, w + rwR[:, w],
                                          rwR[:, 0])) \
                   .at[:, w].set(jnp.where(can, 0, rwR[:, w])).reshape(-1)
        lr = lrR.at[:, w].set(lrR[:, w] & ~can).reshape(-1)
        live_tok = lvR.at[:, w].set(lvR[:, w] & ~can).reshape(-1)
    n_live = jnp.sum(live_tok.astype(jnp.int32))

    return {**f, "lo": lo, "hi": hi, "sh": sh, "live_tok": live_tok,
            "n_live": n_live}


def emit_block(block, blen, plan, choice, pad, bfinal):
    """Stage C, XLA scatter backend: emit one block's chosen encoding into
    a word buffer (pair-fused 4x[N/2]-lane scatter placement)."""
    f = _emit_fields(block, blen, plan, choice, pad, bfinal)
    lo, hi, sh = f["lo"], f["hi"], f["sh"]
    stored = f["stored"]
    tok_off = jnp.cumsum(sh) - sh                   # token-segment offsets
    tok_bits = tok_off[-1] + sh[-1]
    hdr_words, hdr_bits = BP.pack_bits(
        jnp.concatenate([f["hdr3"], f["hv"]]),
        jnp.concatenate([f["hdr3_l"], f["hl"]]), WB)

    # --- place token packets at hdr_bits + tok_off ----------------------
    # pairs of positions fuse into one 4-word window before scattering
    # (4x[N/2] scatter lanes instead of 3x[N])
    def spread(lo, hi, s):
        """(lo,hi) << s within a 3-word window (s in [0,32))."""
        s = s.astype(jnp.uint32)
        ns = jnp.uint32(32) - jnp.maximum(s, 1)
        c0 = lo << s
        c1 = jnp.where(s == 0, hi, (lo >> ns) | (hi << s))
        c2 = jnp.where(s == 0, jnp.uint32(0), hi >> ns)
        return c0, c1, c2

    off = hdr_bits + tok_off
    offP = off.reshape(-1, 2)
    loP = lo.reshape(-1, 2)
    hiP = hi.reshape(-1, 2)
    shP = sh.reshape(-1, 2)
    off0 = offP[:, 0]
    r0 = off0 & 31
    a0, a1, a2 = spread(loP[:, 0], hiP[:, 0], r0)
    d = r0 + shP[:, 0]                       # second packet's window offset
    k1 = d >> 5                              # 0..2
    b0, b1, b2 = spread(loP[:, 1], hiP[:, 1], d & 31)
    zero = jnp.zeros_like(b0)
    bs = [b0, b1, b2, zero, zero]

    def at(j):                               # b_{j-k1} with OOB -> 0
        return jnp.where(k1 == 0, bs[j] if j <= 2 else zero,
               jnp.where(k1 == 1, bs[j - 1] if 0 <= j - 1 <= 2 else zero,
                         bs[j - 2] if 0 <= j - 2 <= 2 else zero))

    # 5 words: a fused-literal pair (60+60 bits) at phase 31 spans them
    W = [a0 | at(0), a1 | at(1), a2 | at(2), at(3), at(4)]
    w0 = off0 >> 5
    words = hdr_words
    for j in range(5):
        words = words.at[w0 + j].add(W[j], mode="drop")

    # --- end-of-block code ----------------------------------------------
    eob_off = hdr_bits + tok_bits
    eob_len, ev = f["eob_len"], f["eob_v"]
    er = (eob_off & 31).astype(jnp.uint32)
    words = words.at[eob_off >> 5].add(ev << er, mode="drop")
    words = words.at[(eob_off >> 5) + 1].add(
        jnp.where(er == 0, jnp.uint32(0),
                  ev >> (jnp.uint32(32) - jnp.maximum(er, 1))), mode="drop")
    nbits = eob_off + eob_len
    return _finish_block(words, block, blen, stored, pad, nbits)


def _finish_block(words, block, blen, stored, pad, nbits):
    """Shared stage-C tail: inject the stored payload and mask bits past
    the block's end."""
    # --- stored payload: whole-block funnel shift into place ---
    b4 = block.astype(jnp.uint32).reshape(-1, 4)
    w = (b4[:, 0] | (b4[:, 1] << 8) | (b4[:, 2] << 16) | (b4[:, 3] << 24))
    t = 35 + pad                     # bit offset of the payload, 35..42:
    # the word offset t>>5 is ALWAYS 1 (pad <= 7), so placement is a
    # static one-word shift — a concat, not a [WB]-lane scatter
    r = (t & 31).astype(jnp.uint32)
    prev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), w[:-1]])
    sh = (w << r) | jnp.where(r == 0, jnp.uint32(0),
                              prev >> (jnp.uint32(32) - r))
    tail = jnp.where(r == 0, jnp.uint32(0), w[-1] >> (jnp.uint32(32) - r))
    nw = w.shape[0]
    inject = jnp.concatenate([
        jnp.zeros((1,), jnp.uint32), jnp.where(stored, sh, 0),
        jnp.where(stored, tail, 0)[None],
        jnp.zeros((WB - nw - 2,), jnp.uint32)])
    words = words | inject
    # zero any payload bits beyond the stored length
    end = jnp.where(stored, t + 8 * blen, nbits)
    widx = jnp.arange(WB, dtype=jnp.int32)
    full_words = widx < (end >> 5)
    partial = widx == (end >> 5)
    keep = jnp.where(
        full_words, jnp.uint32(0xFFFFFFFF),
        jnp.where(partial,
                  jnp.where((end & 31) == 0, jnp.uint32(0),
                            (jnp.uint32(1) << (end & 31).astype(jnp.uint32))
                            - 1),
                  jnp.uint32(0)))
    return words & keep


def _emit_merge_batch(blocks, blens, plans, choice, pad, bfinal):
    """Stage C, merge-tree backend (the default): assemble every block's
    bitstream with the elementwise binary merge of ops/bitmerge.py — no
    scatter, no cumsum offsets.  Emits bit-identical streams to the
    scatter backend."""
    from deflate_jax.ops import bitmerge as BM

    B = blocks.shape[0]
    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)  # noqa: E731
    f = jax.vmap(
        lambda bl, ln, i, ch, pd, bf: _emit_fields_base(
            bl, ln, jax.tree.map(lambda x: x[i], plans), ch, pd, bf)
    )(blocks, blens, jnp.arange(B), choice, pad, bfinal)

    # token tree: density 16 bits/position + 32-bit boundary-match slack
    # (a literal is <=15 bits; a <=48-bit match packet covers >=3
    # positions except at the segment boundary)
    tokw, tokb = BM.merge_bitstream(
        bc(f["lo"]), bc(f["hi"]), f["sh"],
        leaf_bits=48, density=16, slack=32, cap_bits=32 * WB)

    # header tree: <=16-bit entries, padded to a power of two
    hdr_lens = jnp.concatenate([f["hdr3_l"], f["hl"]], axis=1)
    hmask = jnp.where(hdr_lens > 0,
                      (jnp.int32(1) << jnp.minimum(hdr_lens, 16)) - 1, 0)
    hdr_lo = (jnp.concatenate([f["hdr3"], f["hv"]], axis=1)
              .astype(jnp.int32) & hmask)
    NH = hdr_lo.shape[1]
    P2 = 1 << (NH - 1).bit_length()
    hdr_cap = 16 * NH
    hdrw, hdrb = BM.merge_bitstream(
        jnp.pad(hdr_lo, ((0, 0), (0, P2 - NH))), None,
        jnp.pad(hdr_lens, ((0, 0), (0, P2 - NH))),
        leaf_bits=16, density=16, slack=0, cap_bits=hdr_cap)

    # block = header <> tokens <> EOB
    out = jnp.pad(hdrw, ((0, 0), (0, WB - hdrw.shape[1])))
    out, _ = BM.place_at(out, None, tokw, hdrb, max_off_bits=hdr_cap)
    nb0 = hdrb + tokb
    ev = bc(f["eob_v"])
    r = nb0 & 31
    lo_add = ev << r
    hi_add = jnp.where(r == 0, 0,
                       jax.lax.shift_right_logical(
                           ev, 32 - jnp.maximum(r, 1)))
    idx = jnp.arange(B, dtype=jnp.int32) * WB + (nb0 >> 5)
    flat = out.reshape(-1)
    flat = flat.at[idx].add(lo_add).at[idx + 1].add(hi_add, mode="drop")
    words = jax.lax.bitcast_convert_type(flat.reshape(B, WB), jnp.uint32)
    nbits = nb0 + f["eob_len"]
    return jax.vmap(_finish_block)(words, blocks, blens, f["stored"],
                                   pad, nbits)


@partial(jax.jit, static_argnames=("level", "pack"))
def encode_batch(blocks, blens, live, final_idx, level: int, phase0=0,
                 pack: str = "merge"):
    """Encode B blocks into one contiguous bitstream segment.

    blocks:    uint8 [B, 32768] (zero padded)
    blens:     int32 [B] valid bytes per block
    live:      bool  [B] — padding blocks excluded from the stream
    final_idx: int32 — stream-global index of the BFINAL block, or -1
    phase0:    int32 — absolute bit offset of this segment's start in the
               stream (mod 8 is what matters; stored-block padding needs it)
    pack:      "merge" (the merge-tree packer, ops/bitmerge.py) or
               "scatter" (emit_block); bit-identical streams.
    Returns (words uint32 [B*WB], total_bits int32).
    """
    B = blocks.shape[0]
    phase0 = jnp.asarray(phase0, jnp.int32)
    plans = batch_plan(blocks, blens, level)
    choice, pad, offset, bits = choose_blocks(
        plans["fixed_bits"], plans["dyn_bits"], blens, live, level, phase0)
    offset = offset - phase0            # segment-relative placement
    bfinal = jnp.arange(B) == final_idx
    if pack == "merge":
        words = _emit_merge_batch(blocks, blens, plans, choice, pad,
                                  bfinal)
    else:
        words = jax.vmap(
            lambda bl, ln, i, ch, pd, bf: emit_block(
                bl, ln, jax.tree.map(lambda x: x[i], plans), ch, pd, bf)
        )(blocks, blens, jnp.arange(B), choice, pad, bfinal)
    words = jnp.where(live[:, None], words, 0)

    total = jnp.sum(bits)
    # concat: binary word-merge at scanned order (ops/bitmerge.py), in
    # place of a [B*WB]-lane scatter-add.
    # The first block's sub-byte entry phase (phase0 & 7, affecting only
    # stored-padding amounts) is baked into each block's own bits.
    from deflate_jax.ops import bitmerge as BM

    B2 = 1 << (B - 1).bit_length()
    w2, bb = words, bits
    if B2 > B:
        w2 = jnp.pad(words, ((0, B2 - B), (0, 0)))
        bb = jnp.pad(bits, (0, B2 - B))
    out, _ = BM.merge_words(w2, bb, B * WB)
    return out, total


def encode_batch_with_offsets(blocks, blens, live, final_idx, level: int,
                              phase0=0, pack: str = "merge"):
    """encode_batch plus the per-block (offset, bits) vectors — one
    compiled program serves both the stream and its manifest (avoids the
    separate plan_sizes compile)."""
    words, total = encode_batch(blocks, blens, live, final_idx, level,
                                phase0, pack=pack)
    # choose_blocks is deterministic given the same plans; recompute the
    # tiny scan outputs inside the same jit so XLA shares the plan work
    plans = batch_plan(blocks, blens, level)
    choice, pad, offset, bits = choose_blocks(
        plans["fixed_bits"], plans["dyn_bits"], blens, live, level,
        jnp.asarray(phase0, jnp.int32))
    return words, total, offset, bits


@partial(jax.jit, static_argnames=("level",))
def encode_blocks_multi(blocks, blens, live, finals, owner, level: int):
    """Encode blocks belonging to MANY independent streams in one batch.

    finals: bool [B] — block carries BFINAL (last block of its stream)
    owner:  int32 [B] — stream id per block (blocks of a stream contiguous)

    The bit-phase scan resets at stream boundaries (each stream starts at
    phase 0); every block's words are returned standalone for the host to
    stitch per stream.  Returns (words uint32 [B, WB], bits int32 [B]).
    """
    B = blocks.shape[0]
    plans = batch_plan(blocks, blens, level)

    def step(carry, x):
        offset, prev_owner = carry
        fb, db, bl, lv, ow = x
        offset = jnp.where(ow != prev_owner, 0, offset)
        pad = (-(offset + 3)) & 7
        stored = 3 + pad + 32 + 8 * bl
        if level == 0:
            choice = jnp.int32(CH_STORED)
        else:
            choice = jnp.where(stored <= jnp.minimum(fb, db), CH_STORED,
                               jnp.where(fb <= db, CH_FIXED, CH_DYN))
        bits = jnp.where(choice == CH_STORED, stored,
                         jnp.where(choice == CH_FIXED, fb, db))
        bits = jnp.where(lv, bits, 0)
        pad = jnp.where(lv, pad, 0)
        return (offset + bits, ow), (choice, pad, bits)

    (_, _), (choice, pad, bits) = jax.lax.scan(
        step, (jnp.int32(0), jnp.int32(-1)),
        (plans["fixed_bits"], plans["dyn_bits"], blens, live, owner))

    words = jax.vmap(
        lambda bl, ln, i, ch, pd, bf: emit_block(
            bl, ln, jax.tree.map(lambda x: x[i], plans), ch, pd, bf)
    )(blocks, blens, jnp.arange(B), choice, pad, finals)
    words = jnp.where(live[:, None], words, 0)
    return words, bits


def plan_sizes(blocks, blens, live, level: int):
    """Size-only planning (no emission) — used by tests and stats."""
    plans = batch_plan(blocks, blens, level)
    return choose_blocks(plans["fixed_bits"], plans["dyn_bits"], blens, live,
                         level)


def block_hints(sh, stored, W64cap: int = 4224):
    """Per-64-bit-chunk entry phases for the wavefront decoder
    (ops/wave.py): hint[w] = data-relative bit phase of the first
    symbol starting in chunk w, HINT_NONE past the EOB.

    Derived from the emit plan for free: token bit offsets are already
    the emit prefix sums; the per-chunk first token is recovered with
    one flag+compaction (route_monotone_left) — no gathers/scatters.
    Every chunk in [0, eob_chunk] contains a symbol start because a
    DEFLATE symbol is at most 48 < 64 bits.
    """
    from deflate_jax.ops.wave import HINT_NONE, route_monotone_left

    tok_off = jnp.cumsum(sh) - sh
    eob_off = tok_off[-1] + sh[-1]
    offs = jnp.concatenate([tok_off, eob_off[None]])
    n = offs.shape[0]
    chunk = (offs >> 6).astype(jnp.int32)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), chunk[:-1]])
    flag = chunk != prev
    rank = jnp.cumsum(flag.astype(jnp.int32)) - flag.astype(jnp.int32)
    lane = jnp.arange(n, dtype=jnp.int32)
    delta = jnp.where(flag, lane - rank, -1)
    (ph,), dout = route_monotone_left(
        [(offs & 63).astype(jnp.int32)], delta, int(n - 1).bit_length())
    hints = jnp.where(dout[:W64cap] == 0, ph[:W64cap], HINT_NONE)
    return jnp.where(stored, jnp.full((W64cap,), HINT_NONE, jnp.int32),
                     hints.astype(jnp.int32))


def encode_batch_with_hints(blocks, blens, live, final_idx, level: int,
                            phase0=0, pack: str = "merge"):
    """encode_batch_with_offsets plus per-block wavefront decode hints
    (manifest v2).  The extra plan/emit recomputation CSEs inside the
    same jit, as in encode_batch_with_offsets."""
    words, total, offset, bits = encode_batch_with_offsets(
        blocks, blens, live, final_idx, level, phase0, pack=pack)
    B = blocks.shape[0]
    plans = batch_plan(blocks, blens, level)
    choice, pad, _, _ = choose_blocks(
        plans["fixed_bits"], plans["dyn_bits"], blens, live, level,
        jnp.asarray(phase0, jnp.int32))
    bfinal = jnp.arange(B) == final_idx

    def one(bl, ln, i, ch, pd, bf):
        f = _emit_fields(bl, ln, jax.tree.map(lambda x: x[i], plans),
                         ch, pd, bf)
        return block_hints(f["sh_sym"], f["stored"])

    hints = jax.vmap(one)(blocks, blens, jnp.arange(B), choice, pad,
                          bfinal)
    return words, total, offset, bits, hints
