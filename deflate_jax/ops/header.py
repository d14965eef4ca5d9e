"""Dynamic-Huffman block header codec (RFC 1951 §3.2.7), vectorized.

Reference analog: writer deflate.hpp:430-626, reader inflate.hpp:136-224.
The reference RLE-compresses the code-length arrays with a serial scan and —
quirk Q2 — throws away the computed CL tree for a hardcoded one.  Here the
whole header is emitted by position-parallel arithmetic:

  * the combined litlen+dist length array maps each position to at most one
    RLE op (16/17/18/literal) decided purely from (run value, run length,
    position-within-run) — greedy chunking becomes modular arithmetic;
  * the CL tree is built from the *actual* op histogram (strictly smaller
    headers than the reference);
  * all fields flow into the shared prefix-sum bit packer.

Unlike the reference, runs may cross the litlen/dist boundary (RFC allows it).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from deflate_jax.ops import huffman as H
from deflate_jax.utils.tables import CL_ORDER, MAX_CL_CODE_LEN, NUM_CL, NUM_LITLEN

ND = 30                             # transmitted dist lengths (symbols 0..29)

NL = NUM_LITLEN + ND                # combined slots (318)
# header entry budget: 3 preamble + 19 CL lengths + 2 per combined position
HEADER_ENTRIES = 3 + NUM_CL + 2 * NL


def rle_ops(litlen_lens: jax.Array, dist_lens: jax.Array):
    """Map each combined code-length position to at most one RLE op.

    Returns (sym int32 [NL] — CL symbol or -1, extra_val [NL], extra_bits [NL],
             hlit, hdist).
    """
    i = jnp.arange(NL, dtype=jnp.int32)
    max_lit = jnp.max(jnp.where(litlen_lens > 0,
                                jnp.arange(NUM_LITLEN, dtype=jnp.int32), 0))
    hlit = jnp.maximum(257, max_lit + 1)
    max_dist = jnp.max(jnp.where(dist_lens > 0,
                                 jnp.arange(ND, dtype=jnp.int32), -1))
    hdist = jnp.maximum(1, max_dist + 1)

    dist_idx = jnp.clip(i - hlit, 0, ND - 1)
    val = jnp.where(i < hlit, litlen_lens[jnp.clip(i, 0, NUM_LITLEN - 1)],
                    jnp.where(i < hlit + hdist, dist_lens[dist_idx],
                              -(i + 10)))          # unique sentinels: no runs
    active = i < hlit + hdist

    prev = jnp.concatenate([jnp.full((1,), -99, jnp.int32), val[:-1]])
    new_run = val != prev
    run_id = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    run_start = jnp.full((NL,), NL, jnp.int32).at[run_id].min(
        i, mode="drop")  # min over members = start
    run_start = run_start[run_id]
    run_len = jnp.zeros((NL,), jnp.int32).at[run_id].add(
        active.astype(jnp.int32), mode="drop")[run_id]
    pos = i - run_start

    # ---- zero runs: op18 (11-138 zeros) / op17 (3-10) / literal zeros ----
    chunk = pos // 138
    zc_size = jnp.minimum(138, run_len - chunk * 138)
    z_is_start = (pos % 138 == 0)
    z_op18 = z_is_start & (zc_size >= 11)
    z_op17 = z_is_start & (zc_size >= 3) & (zc_size < 11)
    z_lit = zc_size < 3

    # ---- nonzero runs: first literal, then op16 chunks of 3-6 repeats ----
    q = pos - 1
    nchunk = q // 6
    nc_size = jnp.minimum(6, (run_len - 1) - nchunk * 6)
    n_first = pos == 0
    n_op16 = (pos > 0) & (q % 6 == 0) & (nc_size >= 3)
    n_lit = (pos > 0) & (nc_size < 3)

    zero = val == 0
    sym = jnp.where(zero & z_op18, 18,
          jnp.where(zero & z_op17, 17,
          jnp.where(zero & z_lit, 0,
          jnp.where(~zero & (n_first | n_lit), val,
          jnp.where(~zero & n_op16, 16, -1)))))
    emits = active & (
        jnp.where(zero, z_op18 | z_op17 | z_lit, n_first | n_op16 | n_lit))
    sym = jnp.where(emits, sym, -1)

    extra_bits = jnp.where(sym == 16, 2,
                 jnp.where(sym == 17, 3,
                 jnp.where(sym == 18, 7, 0)))
    extra_val = jnp.where(sym == 16, nc_size - 3,
                jnp.where(sym == 17, zc_size - 3,
                jnp.where(sym == 18, zc_size - 11, 0)))
    return sym, extra_val, extra_bits, hlit, hdist


def header_pre(litlen_lens: jax.Array, dist_lens: jax.Array):
    """Header stage 1: RLE ops + CL-alphabet histogram (per block)."""
    sym, extra_val, extra_bits, hlit, hdist = rle_ops(litlen_lens, dist_lens)
    cl_hist = jnp.zeros((NUM_CL,), jnp.int32).at[
        jnp.clip(sym, 0, NUM_CL - 1)].add((sym >= 0).astype(jnp.int32))
    return {"sym": sym, "extra_val": extra_val, "extra_bits": extra_bits,
            "hlit": hlit, "hdist": hdist, "cl_hist": cl_hist}


def emit_dynamic_header(litlen_lens: jax.Array, dist_lens: jax.Array):
    """Header field values/bit-lengths for one block (pack with pack_bits).

    Returns (vals int32 [HEADER_ENTRIES], lens int32 [HEADER_ENTRIES],
             total_bits int32).
    """
    pre = header_pre(litlen_lens, dist_lens)
    cl_lens = H.huffman_code_lengths(pre["cl_hist"], MAX_CL_CODE_LEN)
    return header_post(pre, cl_lens)


def header_post(pre, cl_lens):
    """Header stage 2: transmit-order fields from the built CL tree."""
    sym, extra_val, extra_bits = pre["sym"], pre["extra_val"], \
        pre["extra_bits"]
    hlit, hdist = pre["hlit"], pre["hdist"]
    cl_codes, _ = H.canonical_codes(cl_lens)

    order = jnp.asarray(CL_ORDER)
    perm_lens = cl_lens[order]                      # [19] in transmit order
    last = jnp.max(jnp.where(perm_lens > 0,
                             jnp.arange(NUM_CL, dtype=jnp.int32), 0))
    hclen = jnp.maximum(4, last + 1)

    pre_vals = jnp.stack([hlit - 257, hdist - 1, hclen - 4])
    pre_lens = jnp.array([5, 5, 4], jnp.int32)

    clv = perm_lens
    cll = jnp.where(jnp.arange(NUM_CL) < hclen, 3, 0).astype(jnp.int32)

    s = jnp.clip(sym, 0, NUM_CL - 1)
    code_vals = jnp.where(sym >= 0, cl_codes[s], 0)
    code_lens = jnp.where(sym >= 0, cl_lens[s], 0)
    # interleave (code, extra) per position
    op_vals = jnp.stack([code_vals, extra_val], axis=1).reshape(-1)
    op_lens = jnp.stack([code_lens, extra_bits], axis=1).reshape(-1)

    vals = jnp.concatenate([pre_vals, clv, op_vals])
    lens = jnp.concatenate([pre_lens, cll, op_lens])
    return vals, lens, jnp.sum(lens)
