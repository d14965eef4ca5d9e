"""Wavefront decoder (ops/wave.py): primitive + stage differential tests.

Oracles: python zlib (foreign correctness), host_inflate (token-level
walk), and pure-numpy reimplementations of the routing primitive.
"""
import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from deflate_jax.ops import wave as W


def test_popcount_select_bit32():
    rng = np.random.default_rng(0)
    m = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    mj = jnp.asarray(m.view(np.int32))
    pc = np.asarray(W.popcount32(mj))
    assert (pc == [bin(int(x)).count("1") for x in m]).all()
    # j-th set bit
    js, ms = [], []
    for x in m:
        bits = [i for i in range(32) if (int(x) >> i) & 1]
        if not bits:
            continue
        j = int(rng.integers(0, len(bits)))
        ms.append(np.int64(x))
        js.append((j, bits[j]))
    got = np.asarray(W.select_bit32(
        jnp.asarray(np.asarray(ms, np.uint64).astype(np.uint32)
                    .view(np.int32)),
        jnp.asarray(np.asarray([j for j, _ in js], np.int32))))
    assert (got == [b for _, b in js]).all()


def _route_oracle(vals, delta, left):
    """numpy reference: stable move of occupied slots by delta."""
    n = len(delta)
    out_v = np.full(n, -1, np.int64)
    out_d = np.full(n, -1, np.int64)
    for i in range(n):
        if delta[i] >= 0:
            j = i - delta[i] if left else i + delta[i]
            out_v[j] = vals[i]
            out_d[j] = 0
    return out_v, out_d


@pytest.mark.parametrize("left", [True, False])
def test_route_monotone(left):
    rng = np.random.default_rng(1)
    n = 1024
    for trial in range(8):
        # random monotone routing instance: pick occupied slots and
        # strictly-increasing destinations with non-decreasing delta
        occ = np.sort(rng.choice(n, size=rng.integers(1, 200),
                                 replace=False))
        if left:
            # compaction: j-th occupied slot routes to slot j (the
            # stage-D use case); delta = occ - j is non-decreasing
            dest = np.arange(len(occ))
            delta_occ = occ - dest
        else:
            dest = occ.copy()
            extra = np.sort(rng.integers(0, 4, len(occ)).cumsum())
            dest = occ + extra
            keep = dest < n
            occ, dest = occ[keep], dest[keep]
            delta_occ = dest - occ
        delta = np.full(n, -1, np.int64)
        vals = np.full(n, -1, np.int64)
        delta[occ] = delta_occ
        vals[occ] = rng.integers(0, 1 << 20, len(occ))
        fn = W.route_monotone_left if left else W.route_monotone_right
        (gv,), gd = fn([jnp.asarray(vals, jnp.int32)],
                       jnp.asarray(delta, jnp.int32), 11)
        ev, ed = _route_oracle(vals, delta, left)
        landed = ed == 0
        assert (np.asarray(gd) == 0)[landed].all()
        assert (np.asarray(gv)[landed] == ev[landed]).all()


def _encode_own(data, level=2):
    """Encode with the package encoder (self-contained blocks) on CPU."""
    import deflate_jax
    from deflate_jax.models import encoder as E
    from deflate_jax.runtime import stitch as S
    from deflate_jax.utils.tables import BLOCK_SIZE

    import jax

    buf = np.frombuffer(data, np.uint8)
    nb = max(1, -(-len(buf) // BLOCK_SIZE))
    pad = nb * BLOCK_SIZE - len(buf)
    blocks = jnp.asarray(np.pad(buf, (0, pad)).reshape(nb, BLOCK_SIZE))
    lens = np.full(nb, BLOCK_SIZE, np.int32)
    if pad:
        lens[-1] = len(buf) - (nb - 1) * BLOCK_SIZE
    w, t, off, bits = jax.jit(
        E.encode_batch_with_offsets, static_argnums=(4,))(
        blocks, jnp.asarray(lens), jnp.ones(nb, bool),
        np.int32(nb - 1), level, 0)
    stream = S.words_to_bytes(np.asarray(w), int(t))
    assert zlib.decompress(stream, -15) == data
    return stream, np.asarray(off, np.int64)


def _token_oracle(stream, md, b, pos_local):
    """Decode one speculative token at block-local position (python)."""
    nbits = 8 * len(stream)

    def peek(p, n):
        p = int(md["data_start"][b]) + p
        if p >= nbits:
            return 0
        acc = int.from_bytes(
            stream[p >> 3:(p >> 3) + 8], "little") >> (p & 7)
        return acc & ((1 << n) - 1)

    def canon(p, lim, first):
        c = 0
        for l in range(1, 16):
            c = (c << 1) | ((peek(p, 15) >> (l - 1)) & 1)
            if c < int(np.uint32(lim[l])):
                return l, c - int(np.uint32(first[l]))
        return 0, 0

    l, r = canon(pos_local, md["l_lim"][b], md["l_first"][b])
    if l == 0:
        return ("invalid",)
    meta = int(np.uint32(md["l_meta"][b][l]))
    nlit, has_eob = meta & 0x1FF, (meta >> 9) & 1
    if r < nlit:
        # literal value: r-th set bit of the 256-bit mask
        mask = 0
        for q in range(8):
            mask |= int(np.uint32(md["l_litmask"][b][l][q])) << (32 * q)
        bits = [i for i in range(256) if (mask >> i) & 1]
        return ("lit", 1 + 0 * l, bits[r], l)
    if has_eob and r == nlit:
        return ("eob", l)
    j = r - nlit - has_eob
    lmask = int(np.uint32(md["l_mask"][b][l]))
    bits = [i for i in range(29) if (lmask >> i) & 1]
    if j >= len(bits):
        return ("invalid",)
    li = bits[j]
    eb = 0 if (li < 8 or li == 28) else (li - 4) >> 2
    base = (3 + li if li < 8 else
            258 if li == 28 else 3 + ((4 + (li & 3)) << ((li - 4) >> 2)))
    length = base + peek(pos_local + l, 5) % (1 << eb) if eb else base
    q = pos_local + l + eb
    dl, dr = canon(q, md["d_lim"][b], md["d_first"][b])
    if dl == 0:
        return ("invalid",)
    dmask = int(np.uint32(md["d_mask"][b][dl]))
    dbits = [i for i in range(30) if (dmask >> i) & 1]
    if dr >= len(dbits):
        return ("invalid",)
    ds = dbits[dr]
    deb = 0 if ds < 4 else (ds >> 1) - 1
    dbase = 1 + ds if ds < 4 else 1 + ((2 + (ds & 1)) << ((ds >> 1) - 1))
    dist = dbase + (peek(q + dl, 13) & ((1 << deb) - 1))
    adv = l + eb + dl + deb
    return ("match", adv, length, dist)


@pytest.mark.slow
def test_stage_a_differential():
    rng = np.random.default_rng(2)
    data = (rng.integers(97, 123, 40000, dtype=np.uint8).tobytes()
            + np.tile(rng.integers(0, 256, 97, dtype=np.uint8),
                      200).tobytes())
    stream, offs = _encode_own(data)
    md = W.parse_headers_host(stream, offs)
    W64 = 1024
    nwords = W.prepare_windows(stream, md["data_start"], W64)
    mdj = {k: jnp.asarray(v) for k, v in md.items()
           if k.startswith(("l_", "d_"))}
    A0, P1j = W.decode_positions(jnp.asarray(nwords), mdj, W64)
    A0 = np.asarray(A0)
    adv = A0 & 63
    emit = (A0 >> 6) & 511
    P1 = np.asarray(P1j)
    inv = ((A0 >> 15) & 3) == 3
    B = len(offs)
    for b in range(B):
        for p in rng.integers(0, 40000, 40):
            p = int(p)
            w, ph = p >> 6, p & 63
            tok = _token_oracle(stream, md, b, p)
            if tok[0] == "invalid":
                assert inv[b, ph, w], (b, p, tok)
            elif tok[0] == "lit":
                assert not inv[b, ph, w]
                assert emit[b, ph, w] == 1, (b, p, tok)
                assert adv[b, ph, w] == tok[3]
            elif tok[0] == "match":
                assert not inv[b, ph, w]
                assert adv[b, ph, w] == tok[1], (b, p, tok)
                assert emit[b, ph, w] == tok[2], (b, p, tok)
                assert P1[b, ph, w] == tok[3], (b, p, tok)


def _fill_matches_host(litwords, rec0, rec1, nmatch):
    """Host reference of stage G: fill match bytes into literal-placed
    output (the oracle for ops/fill.py)."""
    B = litwords.shape[0]
    out = litwords.view(np.uint8).reshape(B, -1).copy()
    for b in range(B):
        for m in range(int(nmatch[b])):
            r0, d = int(rec0[b, m]), int(rec1[b, m])
            o, ln = r0 & 0xFFFF, ((r0 >> 16) & 0xFFFF) + 3
            for j in range(ln):
                out[b, o + j] = out[b, o - d + j]
    return out


@pytest.mark.slow
def test_wave_decode_end_to_end():
    rng = np.random.default_rng(3)
    segs = [rng.integers(97, 123, 50000, dtype=np.uint8).tobytes(),
            np.tile(rng.integers(0, 256, 97, dtype=np.uint8),
                    400).tobytes(),
            rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(),
            b"a" * 40000]
    data = b"".join(segs)
    stream, offs = _encode_own(data)
    md = W.parse_headers_host(stream, offs)
    hints, span = W.hints_from_walk_host(stream, offs)
    W64 = int(-(-int(span.max()) // 64 // 128) * 128)
    assert span.max() <= 64 * W64
    nwords = W.prepare_windows(stream, md["data_start"], W64)
    mdj = {k: jnp.asarray(v) for k, v in md.items()
           if k.startswith(("l_", "d_"))}
    from deflate_jax.utils.tables import BLOCK_SIZE
    B = len(offs)
    exp = np.full(B, BLOCK_SIZE, np.int64)
    exp[-1] = len(data) - (B - 1) * BLOCK_SIZE
    litwords, rec0, rec1, nmatch, produced, err = W.wave_decode(
        jnp.asarray(nwords), jnp.asarray(hints[:, :W64], np.int32),
        jnp.asarray(exp, np.int32), mdj, W64)
    err = np.asarray(err)
    produced = np.asarray(produced)
    assert not err.any(), err
    assert (produced == exp).all(), (produced, exp)
    out = _fill_matches_host(np.asarray(litwords), np.asarray(rec0),
                             np.asarray(rec1), np.asarray(nmatch))
    got = b"".join(out[b, :exp[b]].tobytes() for b in range(B))
    # align diagnostics
    if got != data:
        ref = np.frombuffer(data, np.uint8)
        g = np.frombuffer(got, np.uint8)
        bad = np.nonzero(ref != g[:len(ref)])[0]
        raise AssertionError(f"mismatch at {bad[:10]} of {len(bad)}")
    assert got == data


@pytest.mark.slow
def test_wave_decode_detects_corruption():
    rng = np.random.default_rng(4)
    data = rng.integers(97, 123, 80000, dtype=np.uint8).tobytes()
    stream, offs = _encode_own(data)
    md = W.parse_headers_host(stream, offs)
    hints, span = W.hints_from_walk_host(stream, offs)
    W64 = 1024
    from deflate_jax.utils.tables import BLOCK_SIZE
    B = len(offs)
    exp = np.full(B, BLOCK_SIZE, np.int64)
    exp[-1] = len(data) - (B - 1) * BLOCK_SIZE
    mdj = {k: jnp.asarray(v) for k, v in md.items()
           if k.startswith(("l_", "d_"))}
    # corrupt a byte mid-body of block 0
    bad = bytearray(stream)
    bad[int(md["data_start"][0] // 8) + 600] ^= 0x5A
    nwords = W.prepare_windows(bytes(bad), md["data_start"], W64)
    *_, err = W.wave_decode(
        jnp.asarray(nwords), jnp.asarray(hints[:, :W64], np.int32),
        jnp.asarray(exp, np.int32), mdj, W64)
    assert np.asarray(err)[0], "corruption must surface in err flag"


@pytest.mark.slow
def test_wave_decoder_model_interpret():
    """Full model driver: huffman + stored blocks, the XLA match fill,
    reassembly in original order."""
    from deflate_jax.models import wave_decoder as WD
    from deflate_jax.utils.tables import BLOCK_SIZE

    rng = np.random.default_rng(5)
    data = (b"the quick brown fox jumps over the lazy dog. " * 1200
            + b"a" * 9000
            + rng.integers(0, 256, 5000, dtype=np.uint8).tobytes())
    stream, offs = _encode_own(data)
    B = len(offs)
    exp = np.full(B, BLOCK_SIZE, np.int64)
    exp[-1] = len(data) - (B - 1) * BLOCK_SIZE
    got, err = WD.inflate_wave(stream, offs, exp)
    assert not err.any(), err
    assert got == data


@pytest.mark.slow
def test_encoder_hints_match_walk():
    """Encoder-emitted decode hints must equal the oracle host walk."""
    import jax
    from deflate_jax.models import encoder as E
    from deflate_jax.runtime import stitch as S
    from deflate_jax.utils.tables import BLOCK_SIZE

    rng = np.random.default_rng(6)
    data = (rng.integers(97, 123, 60000, dtype=np.uint8).tobytes()
            + b"z" * 30000
            + rng.integers(0, 256, 8000, dtype=np.uint8).tobytes())
    buf = np.frombuffer(data, np.uint8)
    nb = -(-len(buf) // BLOCK_SIZE)
    pad = nb * BLOCK_SIZE - len(buf)
    blocks = jnp.asarray(np.pad(buf, (0, pad)).reshape(nb, BLOCK_SIZE))
    lens = np.full(nb, BLOCK_SIZE, np.int32)
    lens[-1] = len(buf) - (nb - 1) * BLOCK_SIZE
    w, t, off, bits, hints = jax.jit(
        E.encode_batch_with_hints, static_argnums=(4,))(
        blocks, jnp.asarray(lens), jnp.ones(nb, bool),
        np.int32(nb - 1), 2, 0)
    stream = S.words_to_bytes(np.asarray(w), int(t))
    assert zlib.decompress(stream, -15) == data
    offs = np.asarray(off, np.int64)
    walk, _ = W.hints_from_walk_host(stream, offs)
    got = np.asarray(hints)
    md = W.parse_headers_host(stream, offs)
    for b in range(nb):
        if md["btype"][b] == 0:
            assert (got[b] == W.HINT_NONE).all()
        else:
            assert (got[b, :4224] == walk[b, :4224]).all(), b

    # and the full decode path accepts them
    from deflate_jax.models import wave_decoder as WD
    sizes = lens.astype(np.int64)
    out, err = WD.inflate_wave(stream, offs, sizes,
                               hints=got.astype(np.uint8))
    assert not err.any()
    assert out == data


@pytest.mark.slow
def test_manifest_v2_wave_roundtrip():
    """compress_with_manifest v2 hints -> decode_all(device) wave path,
    plus JSON serialization round-trip and v1 compatibility."""
    from deflate_jax.runtime import manifest as M

    rng = np.random.default_rng(8)
    data = (rng.integers(97, 123, 50000, dtype=np.uint8).tobytes()
            + rng.integers(0, 256, 40000, dtype=np.uint8).tobytes())
    stream, man = M.compress_with_manifest(data, level=2)
    assert man.hints is not None and len(man.hints) == len(man.blocks)
    assert zlib.decompress(stream, -15) == data

    man2 = M.Manifest.from_json(man.to_json())
    assert man2.hints == man.hints and man2.blocks == man.blocks

    got = M.decode_all(stream, man2, device=True)
    assert got == data
    # hintless (v1-style) manifests still decode via the host path
    man_v1 = M.Manifest(man.block_size, man.total_bits, man.blocks, None)
    assert M.decode_all(stream, man_v1, device=False) == data


def test_fill_matches_adversarial_overlaps():
    """Direct stage-G test of the XLA fill: every distance class (dist
    1, 2, 3 -> periodic overlaps; 4..8 -> short overlaps; large), every
    byte phase, short and long lengths — vs the host oracle."""
    from deflate_jax.ops import fill as F

    rng = np.random.default_rng(11)
    B = 4
    lit = rng.integers(-2**31, 2**31, (B, F.OW), dtype=np.int64)
    lit = lit.astype(np.int32)
    rec0 = np.full((B, W.NM), -1, np.int32)
    rec1 = np.zeros((B, W.NM), np.int32)
    nmatch = np.zeros(B, np.int32)
    cases = []
    o = 16
    for dist in (1, 2, 3, 4, 5, 6, 7, 8, 31, 509):
        for ln in (3, 4, 7, 15, 16, 17, 29, 258):
            for phase in range(4):
                cases.append((o + phase, ln, dist))
                o += ln + phase + 11
    per = len(cases) // B + 1
    for b in range(B):
        sub = cases[b * per:(b + 1) * per]
        for m, (o_, ln, d) in enumerate(sub):
            rec0[b, m] = (o_ & 0xFFFF) | ((ln - 3) << 16)
            rec1[b, m] = d
        nmatch[b] = len(sub)
    got = np.asarray(F.fill_matches(
        jnp.asarray(lit), jnp.asarray(rec0), jnp.asarray(rec1),
        jnp.asarray(nmatch)))
    want = _fill_matches_host(lit, rec0, rec1, nmatch)
    gotb = got.view(np.uint8).reshape(B, -1)
    for b in range(B):
        bad = np.nonzero(gotb[b] != want[b])[0]
        assert len(bad) == 0, (b, bad[:10], nmatch[b])
