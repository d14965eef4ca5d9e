"""Data-parallel DEFLATE over a JAX device mesh.

The reference is single-threaded (SURVEY.md §2.7); its one parallelizable
property is quirk Q5 — encoded blocks are fully independent.  That maps onto
several devices as pure data parallelism over mesh axis ``data``:

  stage A  (sharded)    per-block LZ77 parse + histograms + trees + sizes
  stage B  (replicated) all_gather the per-block candidate *sizes* (a few
                        bytes per block) and run the exact block-type /
                        bit-offset scan on every device — the only serial
                        dependency in DEFLATE encode is this integer scan
  stage C  (sharded)    emit each block's chosen encoding locally
  stage D  (collective) every device scatters its blocks' words at their
                        global bit offsets into a zero buffer; one psum over
                        ``data`` yields the finished bitstream (disjoint bits,
                        so add == or).

TP/PP/EP have no analog here (nothing matrix- or expert-shaped exists in a
codec — SURVEY.md §2.7); DP over blocks plus the offset-scan collective is
the complete parallelism story.  Collectives are all_gather + psum on the
``data`` axis; on GPUs XLA hands them to NCCL.  Every card of a host reaches
every other at the same rate, so the mesh is 1-D.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from deflate_jax.models import encoder as E

AXIS = "data"


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    """A 1-D mesh over the given (default: all) devices."""
    import numpy as np

    devs = np.array(devices if devices is not None else jax.devices())
    return Mesh(devs.reshape(-1), (axis,))


def _shard_body(blocks, blens, live, final_idx, phase0, *, level: int,
                ndev: int, axis: str = AXIS):
    """Per-device body: local plan/emit + replicated offset scan + psum."""
    Bl = blocks.shape[0]                       # local blocks per device
    B = Bl * ndev
    me = jax.lax.axis_index(axis)

    plans = jax.vmap(lambda b, l: E.block_plan(b, l, level))(blocks, blens)

    # stage B: gather the tiny per-block size vectors, scan everywhere
    fb = jax.lax.all_gather(plans["fixed_bits"], axis, tiled=True)
    db = jax.lax.all_gather(plans["dyn_bits"], axis, tiled=True)
    bl = jax.lax.all_gather(blens, axis, tiled=True)
    lv = jax.lax.all_gather(live, axis, tiled=True)
    choice, pad, offset, bits = E.choose_blocks(fb, db, bl, lv, level,
                                                phase0)
    offset = offset - phase0                   # segment-relative placement

    lo = me * Bl
    my_choice = jax.lax.dynamic_slice_in_dim(choice, lo, Bl)
    my_pad = jax.lax.dynamic_slice_in_dim(pad, lo, Bl)
    my_offset = jax.lax.dynamic_slice_in_dim(offset, lo, Bl)
    my_bfinal = (lo + jnp.arange(Bl)) == final_idx

    # stage C: emit local blocks
    words = jax.vmap(
        lambda b, n, i, ch, pd, bf: E.emit_block(
            b, n, jax.tree.map(lambda x: x[i], plans), ch, pd, bf)
    )(blocks, blens, jnp.arange(Bl), my_choice, my_pad, my_bfinal)
    words = jnp.where(live[:, None], words, 0)

    # stage D: place at global bit offsets, then combine across devices
    base = (my_offset >> 5).astype(jnp.int32)
    s = (my_offset & 31).astype(jnp.uint32)
    prev = jnp.concatenate([jnp.zeros((Bl, 1), jnp.uint32), words[:, :-1]], 1)
    sh = s[:, None]
    shifted = (words << sh) | jnp.where(sh == 0, jnp.uint32(0),
                                        prev >> (jnp.uint32(32) - sh))
    tail = jnp.where(s == 0, jnp.uint32(0),
                     words[:, -1] >> (jnp.uint32(32) - s))
    tgt = base[:, None] + jnp.arange(E.WB, dtype=jnp.int32)[None, :]
    seg = jnp.zeros((B * E.WB,), jnp.uint32)
    seg = seg.at[tgt.reshape(-1)].add(shifted.reshape(-1), mode="drop")
    seg = seg.at[base + E.WB].add(tail, mode="drop")

    out = jax.lax.psum(seg, axis)
    total = jnp.sum(bits)
    return out, total


@partial(jax.jit, static_argnames=("level", "mesh"))
def encode_mesh(blocks, blens, live, final_idx, level: int, mesh: Mesh,
                phase0=0):
    """Encode B blocks data-parallel over `mesh` into one bitstream.

    blocks: uint8 [B, 32768] with B a multiple of the mesh size; other args
    as in encoder.encode_batch.  Returns (words uint32 [B*WB] — replicated,
    total_bits int32).
    """
    ndev = mesh.devices.size
    axis = mesh.axis_names[0]
    phase0 = jnp.asarray(phase0, jnp.int32)
    body = partial(_shard_body, level=level, ndev=ndev, axis=axis)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(blocks, blens, live, final_idx, phase0)


def compress_mesh(data: bytes, level: int = 2, mesh: Mesh | None = None,
                  config=None) -> bytes:
    """Host front-end: compress one buffer data-parallel over a mesh.

    config: a ``CodecConfig``; supplies level and the mesh axis name
    (config.mesh_axis) when no explicit mesh is given.
    """
    import numpy as np

    from deflate_jax.ops.bitpack import words_to_bytes
    from deflate_jax.utils.tables import BLOCK_SIZE

    if config is not None:
        level = config.level
    if mesh is None:
        mesh = make_mesh(axis=config.mesh_axis if config is not None
                         else AXIS)
    ndev = mesh.devices.size
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    nblocks = max(1, -(-len(buf) // BLOCK_SIZE))
    B = -(-nblocks // ndev) * ndev                 # pad to mesh multiple
    blocks = np.zeros((B, BLOCK_SIZE), np.uint8)
    blens = np.zeros((B,), np.int32)
    for i in range(nblocks):
        chunk = buf[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE]
        blocks[i, :len(chunk)] = chunk
        blens[i] = len(chunk)
    live = np.arange(B) < nblocks
    words, total = encode_mesh(
        jnp.asarray(blocks), jnp.asarray(blens), jnp.asarray(live),
        jnp.int32(nblocks - 1), level, mesh)
    return words_to_bytes(np.asarray(words), int(total))


@partial(jax.jit, static_argnames=("span", "out_cap", "mesh"))
def decode_mesh(words, starts, out_lens, span: int, out_cap: int,
                mesh: Mesh):
    """Data-parallel decode of manifest-indexed blocks over `mesh`.

    Blocks from this framework's encoder are self-contained (quirk Q5), so
    with a manifest (runtime/manifest.py) giving each block's bit offset,
    decode is embarrassingly parallel: every device decodes its shard of
    blocks and the outputs all_gather back in order.

    words:    uint32 [W] compressed stream (replicated)
    starts:   int32 [B] per-block bit offsets (B divisible by mesh size)
    out_lens: int32 [B] expected output bytes per block (0 = padding slot)
    Returns (out uint8 [B, out_cap], produced int32 [B], error bool).
    """
    from deflate_jax.models import decoder as D

    axis = mesh.axis_names[0]

    def body(starts, out_lens):
        out, produced, err = jax.vmap(
            lambda s: D.decode_block_standalone(words, s, span, out_cap)
        )(starts)
        live = out_lens > 0
        err = err & live
        bad = live & (produced != out_lens)
        out_all = jax.lax.all_gather(out, axis, tiled=True)
        produced_all = jax.lax.all_gather(produced * live, axis, tiled=True)
        err_any = jax.lax.psum(jnp.sum((err | bad).astype(jnp.int32)),
                               axis) > 0
        return out_all, produced_all, err_any

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(starts, out_lens)


@partial(jax.jit, static_argnames=("W64", "mesh"))
def decode_mesh_wave(nw, hints, sizes, stored, mdj, W64: int, mesh: Mesh):
    """Data-parallel WAVEFRONT decode over `mesh`.

    Every device runs stages A-F + the match fill on its shard of
    manifest-indexed self-contained blocks; outputs all_gather back.
    nw [B, 2*W64+4] normalized windows; hints [B, W64] int32; sizes [B]
    expected bytes; stored [B] bool (window passthrough); mdj: device
    dict from ops.wave.parse_headers_host.  B must be a multiple of the
    mesh size.  Returns (words [B, OW], produced [B], err_any bool).
    """
    from deflate_jax.ops import fill as F
    from deflate_jax.ops import wave as W

    axis = mesh.axis_names[0]

    def body(nw, hints, sizes, stored, mdj):
        litw, r0, r1, nm, prod, e = W.wave_decode(
            nw, hints, sizes, mdj, W64)
        win = nw[:, :2 * W64 + 4]
        if 2 * W64 + 4 < F.OW:
            win = jnp.pad(win, ((0, 0), (0, F.OW - (2 * W64 + 4))))
        litw = jnp.where(stored[:, None], win[:, :F.OW], litw)
        nm = jnp.where(stored, 0, nm)
        prod = jnp.where(stored, sizes, prod)
        e = jnp.where(stored, 0, e)
        filled = F.fill_matches(litw, r0, r1, nm)
        live = sizes > 0
        bad = (e > 0) | (prod != sizes)
        out_all = jax.lax.all_gather(filled, axis, tiled=True)
        prod_all = jax.lax.all_gather(prod * live, axis, tiled=True)
        err_any = jax.lax.psum(
            jnp.sum((bad & live).astype(jnp.int32)), axis) > 0
        return out_all, prod_all, err_any

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(nw, hints, sizes, stored, mdj)


def decompress_mesh_wave(stream: bytes, manifest,
                         mesh: Mesh | None = None) -> bytes:
    """Host front-end: wavefront decode of a manifest-indexed stream over
    a mesh (hints from the manifest, or from a host walk when it has
    none).  Raises ValueError on corruption (wave chain validation /
    produced mismatch)."""
    import numpy as np

    from deflate_jax.models.wave_decoder import BUCKETS
    from deflate_jax.ops import wave as W

    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.devices.size
    nb = len(manifest.blocks)
    B = -(-nb // ndev) * ndev
    offs = np.zeros(B, np.int64)
    sizes = np.zeros(B, np.int64)
    spans = np.zeros(B, np.int64)
    for i, (off, bl, olen) in enumerate(manifest.blocks):
        offs[i] = off
        spans[i] = bl
        sizes[i] = olen
    md = W.parse_headers_host(stream, offs)
    stored = (md["btype"] == 0) & (np.arange(B) < nb)
    err0 = md["hdr_err"][:nb].any()
    harr = manifest.hint_array()
    if harr is None:
        harr, _ = W.hints_from_walk_host(stream, offs[:nb])
    need = int(np.maximum(spans - (md["data_start"] - offs), 1).max()
               + 63) // 64 + 1
    W64 = next((b for b in BUCKETS if b >= need), BUCKETS[-1])
    nw = W.prepare_windows(stream, md["data_start"], W64)
    hints = np.full((B, W64), W.HINT_NONE, np.uint8)
    hav = min(W64, harr.shape[1])
    hints[:nb, :hav] = harr[:, :hav]
    # padding rows decode as stored length-0 passthrough
    stored_j = stored.copy()
    stored_j[nb:] = True
    mdj = {k: jnp.asarray(md[k]) for k in md
           if k.startswith(("l_", "d_"))}
    out, produced, err = decode_mesh_wave(
        jnp.asarray(nw), jnp.asarray(hints, jnp.int32),
        jnp.asarray(sizes, jnp.int32), jnp.asarray(stored_j), mdj,
        W64, mesh)
    if bool(err) or bool(err0):
        raise ValueError("mesh wave decode failed (corrupt stream or "
                         "manifest)")
    w = np.asarray(out).view(np.uint8).reshape(B, -1)
    produced = np.asarray(produced)
    return b"".join(w[i, :produced[i]].tobytes() for i in range(nb))


def decompress_mesh(stream: bytes, manifest, mesh: Mesh | None = None) -> bytes:
    """Host front-end: decode a manifest-indexed stream over a mesh.

    v2 manifests (decode hints) take the wavefront decoder
    (decode_mesh_wave); hintless v1 manifests fall back to the scan
    decoder below."""
    import numpy as np

    if getattr(manifest, "hints", None) is not None:
        return decompress_mesh_wave(stream, manifest, mesh)

    from deflate_jax.ops.bitpack import bytes_to_words
    from deflate_jax.ops.inflate_scan import SPAN
    from deflate_jax.utils.tables import BLOCK_SIZE

    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.devices.size
    nb = len(manifest.blocks)
    B = -(-nb // ndev) * ndev
    starts = np.zeros((B,), np.int32)
    out_lens = np.zeros((B,), np.int32)
    for i, (off, _, olen) in enumerate(manifest.blocks):
        starts[i] = off
        out_lens[i] = olen
    # span bucketing: the manifest knows every block's compressed size, so
    # the token-scan span shrinks to the largest block (up to 16x less
    # chain-recovery work on compressible data)
    max_bits = max(b[1] for b in manifest.blocks)
    span = SPAN
    for cand in (1 << 14, 1 << 16):
        if max_bits + 64 <= cand:
            span = cand + 64
            break
    words, _ = bytes_to_words(stream)
    out, produced, err = decode_mesh(
        jnp.asarray(words), jnp.asarray(starts), jnp.asarray(out_lens),
        span, BLOCK_SIZE, mesh)
    if bool(err):
        raise ValueError("mesh decode failed (corrupt stream or manifest)")
    out = np.asarray(out)
    produced = np.asarray(produced)
    return b"".join(out[i, :produced[i]].tobytes() for i in range(nb))
