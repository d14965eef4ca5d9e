// Host-side native INFLATE — the CPU fast path of the deflate_jax runtime.
//
// Reference analog: class inflate (inflate.hpp:26-409 in the reference),
// whose hot loop probes a pointer-chasing trie once per input BIT (SURVEY.md
// quirk Q7).  This implementation is a from-scratch table-driven decoder:
// a 64-bit bit buffer and two-level canonical lookup tables (10-bit root),
// so a symbol decodes in one or two loads.  It is the host fallback behind
// the device decoders (models/) and the fast path for small inputs
// where a device round trip costs more than the decode.
//
// Exported C ABI (ctypes):
//   int dt_inflate(const uint8_t* in, size_t in_len,
//                  uint8_t* out, size_t out_cap, size_t* out_len);
//     returns 0 ok, negative error codes otherwise (see DT_E_*)
//   uint32_t dt_adler32(const uint8_t* p, size_t n);
//   void dt_stitch(...)  -- bit-level segment concatenation

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

enum {
  DT_OK = 0,
  DT_E_INPUT = -1,      // truncated / malformed stream
  DT_E_OUTPUT = -2,     // output capacity exceeded
  DT_E_CODE = -3,       // invalid Huffman code or code lengths
  DT_E_DIST = -4,       // distance past window / output start
  DT_E_BTYPE = -5,      // reserved block type 3
};

}  // extern "C"

namespace {

constexpr int kRootBits = 10;
constexpr int kMaxCodeLen = 15;

// Table entry: [sym:16][len:8][flags:8]; flag 1 = subtable pointer, where
// sym = subtable base index and len = extra index bits.
struct Entry {
  uint16_t sym;
  uint8_t len;
  uint8_t sub;
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;  // valid bits in buf

  void refill() {
    while (n <= 56 && p < end) {
      buf |= uint64_t(*p++) << n;
      n += 8;
    }
  }
  // peek k bits (k <= 57 after refill); missing bits read as zero
  uint32_t peek(int k) const { return uint32_t(buf & ((1ull << k) - 1)); }
  void drop(int k) {
    buf >>= k;
    n -= k;
  }
  bool have(int k) {
    if (n < k) refill();
    return n >= k;
  }
  void align() {
    int k = n & 7;
    drop(k);
  }
  // absolute byte position consumed so far
  size_t bytes_consumed(const uint8_t* start) const {
    return size_t(p - start) - size_t(n >> 3);
  }
};

// Build a two-level decode table from code lengths.
// table must hold (1<<kRootBits) + 2048 entries (subtable worst case).
// Returns table size used, or -1 on oversubscription.
int build_table(const uint8_t* lens, int nsym, Entry* table, bool allow_empty) {
  int count[kMaxCodeLen + 1] = {0};
  for (int s = 0; s < nsym; s++) count[lens[s]]++;
  count[0] = 0;
  int total = 0;
  for (int l = 1; l <= kMaxCodeLen; l++) total += count[l];
  if (total == 0) {
    if (!allow_empty) return -1;
    for (int i = 0; i < (1 << kRootBits); i++) table[i] = {0, 0, 0};
    return 1 << kRootBits;
  }
  // Kraft check (oversubscription is fatal; incomplete codes allowed —
  // unused table slots get len 0 and decode as errors)
  long kraft = 0;
  for (int l = 1; l <= kMaxCodeLen; l++)
    kraft += long(count[l]) << (kMaxCodeLen - l);
  if (kraft > (1L << kMaxCodeLen)) return -1;

  // symbols sorted by (len, sym)
  int offs[kMaxCodeLen + 2] = {0};
  for (int l = 1; l <= kMaxCodeLen; l++) offs[l + 1] = offs[l] + count[l];
  uint16_t sorted[320];
  {
    int o[kMaxCodeLen + 1];
    memcpy(o, offs, sizeof(o));
    for (int s = 0; s < nsym; s++)
      if (lens[s]) sorted[o[lens[s]]++] = uint16_t(s);
  }

  for (int i = 0; i < (1 << kRootBits); i++) table[i] = {0, 0, 0};
  int next_sub = 1 << kRootBits;

  uint32_t code = 0;  // canonical code, MSB-first
  int si = 0;
  int sub_base = -1, sub_prefix = -1, sub_bits = 0;
  for (int l = 1; l <= kMaxCodeLen; l++) {
    for (int c = 0; c < count[l]; c++, si++, code++) {
      uint16_t sym = sorted[si];
      // bit-reverse the l-bit code for LSB-first indexing
      uint32_t rev = 0;
      for (int b = 0; b < l; b++) rev |= ((code >> b) & 1u) << (l - 1 - b);
      if (l <= kRootBits) {
        for (uint32_t i = rev; i < (1u << kRootBits); i += (1u << l))
          table[i] = {sym, uint8_t(l), 0};
      } else {
        uint32_t prefix = rev & ((1u << kRootBits) - 1);
        if (int(prefix) != sub_prefix) {
          // longest code sharing this prefix determines subtable size
          sub_prefix = int(prefix);
          // compute remaining max length for this prefix: scan ahead is
          // costly; use kMaxCodeLen - kRootBits (5 bits, 32 entries) flat
          sub_bits = kMaxCodeLen - kRootBits;
          sub_base = next_sub;
          next_sub += 1 << sub_bits;
          for (int i = 0; i < (1 << sub_bits); i++)
            table[sub_base + i] = {0, 0, 0};
          table[prefix] = {uint16_t(sub_base), uint8_t(sub_bits), 1};
        }
        uint32_t hi = rev >> kRootBits;  // remaining l - kRootBits bits
        for (uint32_t i = hi; i < (1u << sub_bits); i += (1u << (l - kRootBits)))
          table[sub_base + i] = {sym, uint8_t(l - kRootBits), 0};
      }
    }
    code <<= 1;
  }
  return next_sub;
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,    9,   13,
                                17,   25,   33,   49,   65,   97,   129, 193,
                                257,  385,  513,  769,  1025, 1537, 2049,
                                3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                              11, 4, 12, 3, 13, 2, 14, 1, 15};

constexpr int kTableSize = (1 << kRootBits) + 320 * 32;  // root + worst-case subtables

struct Tables {
  Entry lit[kTableSize];
  Entry dist[kTableSize];
};

// decode one symbol; returns -1 on error (bad code OR truncated input).
// Missing bits peek as zeros, but the replicated-root/subtable layout means
// the selected entry is determined by the low `len` bits only — so checking
// br.n >= consumed-bits before dropping rejects any symbol that would have
// used phantom zero bits (truncated streams error instead of zero-filling).
inline int decode_sym(BitReader& br, const Entry* tbl) {
  br.refill();
  Entry e = tbl[br.peek(kRootBits)];
  if (e.sub) {
    uint32_t idx = (br.peek(kRootBits + e.len) >> kRootBits);
    int root = kRootBits;
    e = tbl[e.sym + idx];
    if (!e.len) return -1;
    if (br.n < root + e.len) return -1;
    br.drop(root + e.len);
    return e.sym;
  }
  if (!e.len) return -1;
  if (br.n < e.len) return -1;
  br.drop(e.len);
  return e.sym;
}

int fixed_tables(Tables& t) {
  uint8_t ll[288], dl[30];
  for (int i = 0; i < 144; i++) ll[i] = 8;
  for (int i = 144; i < 256; i++) ll[i] = 9;
  for (int i = 256; i < 280; i++) ll[i] = 7;
  for (int i = 280; i < 288; i++) ll[i] = 8;
  for (int i = 0; i < 30; i++) dl[i] = 5;
  if (build_table(ll, 288, t.lit, false) < 0) return -1;
  if (build_table(dl, 30, t.dist, false) < 0) return -1;
  return 0;
}

int dynamic_tables(BitReader& br, Tables& t) {
  if (!br.have(14)) return DT_E_INPUT;
  int hlit = int(br.peek(5)) + 257;
  br.drop(5);
  int hdist = int(br.peek(5)) + 1;
  br.drop(5);
  int hclen = int(br.peek(4)) + 4;
  br.drop(4);
  if (hlit > 286 || hdist > 30) return DT_E_CODE;

  uint8_t cl_lens[19] = {0};
  for (int i = 0; i < hclen; i++) {
    if (!br.have(3)) return DT_E_INPUT;
    cl_lens[kClOrder[i]] = uint8_t(br.peek(3));
    br.drop(3);
  }
  Entry cl_tbl[kTableSize];
  if (build_table(cl_lens, 19, cl_tbl, false) < 0) return DT_E_CODE;

  uint8_t lens[320] = {0};
  int i = 0;
  while (i < hlit + hdist) {
    if (!br.have(7 + 7)) br.refill();
    int s = decode_sym(br, cl_tbl);
    if (s < 0) return DT_E_CODE;
    if (s < 16) {
      lens[i++] = uint8_t(s);
    } else if (s == 16) {
      if (i == 0) return DT_E_CODE;
      if (!br.have(2)) return DT_E_INPUT;
      int rep = 3 + int(br.peek(2));
      br.drop(2);
      if (i + rep > hlit + hdist) return DT_E_CODE;
      for (int r = 0; r < rep; r++, i++) lens[i] = lens[i - 1];
    } else if (s == 17) {
      if (!br.have(3)) return DT_E_INPUT;
      int rep = 3 + int(br.peek(3));
      br.drop(3);
      if (i + rep > hlit + hdist) return DT_E_CODE;
      i += rep;
    } else {
      if (!br.have(7)) return DT_E_INPUT;
      int rep = 11 + int(br.peek(7));
      br.drop(7);
      if (i + rep > hlit + hdist) return DT_E_CODE;
      i += rep;
    }
  }
  if (lens[256] == 0) return DT_E_CODE;
  if (build_table(lens, hlit, t.lit, false) < 0) return DT_E_CODE;
  if (build_table(lens + hlit, hdist, t.dist, true) < 0) return DT_E_CODE;
  return DT_OK;
}

}  // namespace

extern "C" {

uint32_t dt_adler32(const uint8_t* p, size_t n) {
  uint32_t s1 = 1, s2 = 0;
  while (n > 0) {
    size_t chunk = n > 5552 ? 5552 : n;  // max before 32-bit overflow
    for (size_t i = 0; i < chunk; i++) {
      s1 += p[i];
      s2 += s1;
    }
    s1 %= 65521;
    s2 %= 65521;
    p += chunk;
    n -= chunk;
  }
  return (s2 << 16) | s1;
}

int dt_inflate2(const uint8_t* in, size_t in_len, uint8_t* out,
                size_t out_cap, size_t* out_len, size_t* in_consumed) {
  BitReader br{in, in + in_len};
  size_t op = 0;
  static thread_local Tables tbl;

  for (;;) {
    if (!br.have(3)) return DT_E_INPUT;
    int bfinal = int(br.peek(1));
    br.drop(1);
    int btype = int(br.peek(2));
    br.drop(2);

    if (btype == 0) {
      br.align();
      if (!br.have(32)) return DT_E_INPUT;
      uint32_t len = br.peek(16);
      br.drop(16);
      uint32_t nlen = br.peek(16);
      br.drop(16);
      if ((len ^ nlen) != 0xFFFF) return DT_E_INPUT;
      if (op + len > out_cap) return DT_E_OUTPUT;
      // copy: drain bit buffer first (it holds whole bytes after align)
      uint32_t rem = len;
      while (rem && br.n >= 8) {
        out[op++] = uint8_t(br.peek(8));
        br.drop(8);
        rem--;
      }
      if (rem) {
        if (size_t(br.end - br.p) < rem) return DT_E_INPUT;
        memcpy(out + op, br.p, rem);
        br.p += rem;
        op += rem;
      }
    } else if (btype == 3) {
      return DT_E_BTYPE;
    } else {
      if (btype == 1) {
        if (fixed_tables(tbl) < 0) return DT_E_CODE;
      } else {
        int rc = dynamic_tables(br, tbl);
        if (rc != DT_OK) return rc;
      }
      for (;;) {
        if (br.n == 0 && br.p == br.end) return DT_E_INPUT;
        int s = decode_sym(br, tbl.lit);
        if (s < 0) return DT_E_CODE;
        if (s < 256) {
          if (op >= out_cap) return DT_E_OUTPUT;
          out[op++] = uint8_t(s);
        } else if (s == 256) {
          break;
        } else {
          if (s > 285) return DT_E_CODE;
          int li = s - 257;
          if (!br.have(kLenExtra[li])) return DT_E_INPUT;
          uint32_t length = kLenBase[li] + br.peek(kLenExtra[li]);
          br.drop(kLenExtra[li]);
          int d = decode_sym(br, tbl.dist);
          if (d < 0 || d > 29) return DT_E_CODE;
          if (!br.have(kDistExtra[d])) return DT_E_INPUT;
          uint32_t dist = kDistBase[d] + br.peek(kDistExtra[d]);
          br.drop(kDistExtra[d]);
          if (dist > op) return DT_E_DIST;
          if (op + length > out_cap) return DT_E_OUTPUT;
          const uint8_t* src = out + op - dist;
          if (dist >= length) {
            memcpy(out + op, src, length);
            op += length;
          } else {
            for (uint32_t j = 0; j < length; j++) out[op + j] = src[j];
            op += length;
          }
        }
      }
    }
    if (bfinal) {
      *out_len = op;
      // bytes consumed, counting a partially-read final byte as consumed
      // (the position where e.g. a gzip trailer or next member begins)
      if (in_consumed) *in_consumed = br.bytes_consumed(in);
      return DT_OK;
    }
  }
}

int dt_inflate(const uint8_t* in, size_t in_len, uint8_t* out, size_t out_cap,
               size_t* out_len) {
  return dt_inflate2(in, in_len, out, out_cap, out_len, nullptr);
}

// Batched block-header parse for the wavefront decoder's host prep
// (ops/wave.py parse_headers_host).  For each block whose BFINAL bit
// sits at bit_offsets[b], walks the header only (the sequential part:
// CL-code decode + repeat expansion, inflate.hpp:136-224 territory) and
// records the raw code lengths; the batch canonical-metadata math stays
// vectorized numpy on the Python side.
//
// Outputs, all length nblocks unless noted:
//   btype, data_start (absolute bit of first symbol / stored payload),
//   stored_len, err (parse failure), hlit, hdist,
//   lens [nblocks * 320] code lengths (litlen then dist, zero padded).
int dt_parse_headers(const uint8_t* in, size_t in_len,
                     const int64_t* bit_offsets, int64_t nblocks,
                     int64_t* btype, int64_t* data_start,
                     int64_t* stored_len, uint8_t* err,
                     int32_t* hlit_out, int32_t* hdist_out,
                     uint8_t* lens_out) {
  for (int64_t b = 0; b < nblocks; b++) {
    btype[b] = 0;
    data_start[b] = 0;
    stored_len[b] = 0;
    err[b] = 0;
    hlit_out[b] = 0;
    hdist_out[b] = 0;
    uint8_t* lens = lens_out + b * 320;
    memset(lens, 0, 320);

    int64_t off = bit_offsets[b];
    if (off < 0 || size_t(off + 3) > 8 * in_len) {
      err[b] = 1;
      continue;
    }
    BitReader br{in + (off >> 3), in + in_len};
    br.refill();
    br.drop(int(off & 7));
    int64_t base_bit = off & ~int64_t(7);  // br consumed counts from here
    auto bitpos = [&]() {
      return base_bit + 8 * int64_t(br.p - (in + (off >> 3))) - br.n;
    };
    br.drop(1);  // BFINAL
    int bt = int(br.peek(2));
    br.drop(2);
    btype[b] = bt;
    if (bt == 3) {
      err[b] = 1;
      continue;
    }
    if (bt == 0) {
      br.align();
      if (!br.have(32)) {
        err[b] = 1;
        continue;
      }
      uint32_t len = br.peek(16);
      br.drop(16);
      uint32_t nlen = br.peek(16);
      br.drop(16);
      int64_t payload = bitpos();
      if ((len ^ nlen) != 0xFFFF ||
          size_t(payload + 8 * int64_t(len)) > 8 * in_len)
        err[b] = 1;
      stored_len[b] = len;
      data_start[b] = payload;
      continue;
    }
    if (bt == 1) {
      data_start[b] = bitpos();
      continue;  // fixed code lengths are implied; Python fills them
    }
    // dynamic header
    if (!br.have(14)) {
      err[b] = 1;
      continue;
    }
    int hlit = int(br.peek(5)) + 257;
    br.drop(5);
    int hdist = int(br.peek(5)) + 1;
    br.drop(5);
    int hclen = int(br.peek(4)) + 4;
    br.drop(4);
    uint8_t cl_lens[19] = {0};
    bool bad = false;
    for (int i = 0; i < hclen; i++) {
      if (!br.have(3)) {
        bad = true;
        break;
      }
      cl_lens[kClOrder[i]] = uint8_t(br.peek(3));
      br.drop(3);
    }
    static thread_local Entry cl_tbl[kTableSize];
    if (bad || build_table(cl_lens, 19, cl_tbl, false) < 0) {
      err[b] = 1;
      continue;
    }
    int i = 0;
    while (i < hlit + hdist) {
      int s = decode_sym(br, cl_tbl);
      if (s < 0) {
        bad = true;
        break;
      }
      if (s < 16) {
        lens[i++] = uint8_t(s);
      } else if (s == 16) {
        if (i == 0 || !br.have(2)) {
          bad = true;
          break;
        }
        int rep = 3 + int(br.peek(2));
        br.drop(2);
        if (i + rep > hlit + hdist) {
          bad = true;
          break;
        }
        for (int r = 0; r < rep; r++, i++) lens[i] = lens[i - 1];
      } else if (s == 17) {
        if (!br.have(3)) {
          bad = true;
          break;
        }
        int rep = 3 + int(br.peek(3));
        br.drop(3);
        if (i + rep > hlit + hdist) {
          bad = true;
          break;
        }
        i += rep;
      } else {
        if (!br.have(7)) {
          bad = true;
          break;
        }
        int rep = 11 + int(br.peek(7));
        br.drop(7);
        if (i + rep > hlit + hdist) {
          bad = true;
          break;
        }
        i += rep;
      }
    }
    if (bad || i != hlit + hdist || lens[256] == 0) {
      err[b] = 1;
      memset(lens, 0, 320);
      continue;
    }
    hlit_out[b] = hlit;
    hdist_out[b] = hdist;
    data_start[b] = bitpos();
  }
  return DT_OK;
}

// Bit-level concatenation of segments into a contiguous stream.
// seg_words: concatenated u32 word data; seg_offsets[i] = word offset of
// segment i; seg_bits[i] = bit length of segment i.  out must be zeroed,
// sized (sum(bits)+63)/32 words.
void dt_stitch(const uint32_t* seg_words, const uint64_t* seg_offsets,
               const uint64_t* seg_bits, size_t nseg, uint32_t* out) {
  uint64_t off = 0;
  for (size_t s = 0; s < nseg; s++) {
    const uint32_t* w = seg_words + seg_offsets[s];
    uint64_t nb = seg_bits[s];
    if (!nb) continue;
    uint64_t nwords = (nb + 31) / 32;
    uint64_t base = off >> 5;
    uint32_t sh = uint32_t(off & 31);
    if (sh == 0) {
      for (uint64_t i = 0; i < nwords; i++) out[base + i] |= w[i];
    } else {
      for (uint64_t i = 0; i < nwords; i++) {
        out[base + i] |= w[i] << sh;
        out[base + i + 1] |= w[i] >> (32 - sh);
      }
    }
    off += nb;
  }
}

// Skeleton walk for the wavefront decoder (ops/wave.py): decode symbol
// LENGTHS only (no output materialization) for an entire raw DEFLATE
// stream, cutting it into VIRTUAL BLOCKS of <= 32768 output bytes at
// symbol boundaries and recording per virtual block the per-64-bit-chunk
// symbol entry phases ("decode hints").  This is what lets FOREIGN
// conforming streams (zlib/gzip/libdeflate output — reference analog
// inflate.hpp:277-322) ride the fully-vectorized device decode path:
// virtual blocks all decode in parallel on the device; only this walk is
// sequential.
//
// vb_meta layout per virtual block (8 int64s):
//   [0] parent header bit offset (the block's BFINAL bit)
//   [1] vb first-symbol bit, absolute (stored payload bit for btype 0)
//   [2] out_len (<= 32768)
//   [3] flags: 1 = stored | 2 = chain ends naturally (EOB inside vb)
//              | 4 = needs history (a match reaches before the vb start)
//   [4] span bits: vb start .. one past the last symbol.  For cut vbs
//       the synthetic stop position; for EOB vbs includes the EOB code.
//   [5] out_start: absolute output byte offset of the vb
//   [6] btype of the parent block
//   [7] reserved (0)
// hints: hint_stride bytes per vb; 0xFF = no symbol starts in the chunk.
//
// Returns DT_OK; DT_E_OUTPUT when max_vb or the hint window would be
// exceeded (caller retries bigger or falls back to the host decoder);
// else the stream error code.
int dt_skeleton(const uint8_t* in, size_t in_len, int64_t max_vb,
                int64_t hint_stride, int64_t* vb_meta, uint8_t* hints,
                int64_t* n_vb_out, int64_t* total_out) {
  BitReader br{in, in + in_len};
  static thread_local Tables tbl;
  int64_t nvb = 0;
  int64_t out_abs = 0;  // absolute output bytes before the current vb
  const int64_t span_cap = 64 * hint_stride - 64;

  auto bitpos = [&]() { return 8 * int64_t(br.p - in) - br.n; };
  auto push_vb = [&](int64_t parent, int64_t start, int64_t out_len,
                     int64_t flags, int64_t span, int64_t btype) -> bool {
    if (nvb >= max_vb) return false;
    int64_t* m = vb_meta + nvb * 8;
    m[0] = parent;
    m[1] = start;
    m[2] = out_len;
    m[3] = flags;
    m[4] = span;
    m[5] = out_abs;
    m[6] = btype;
    m[7] = 0;
    out_abs += out_len;
    nvb++;
    return true;
  };

  for (;;) {
    if (!br.have(3)) return DT_E_INPUT;
    int64_t parent = bitpos();
    int bfinal = int(br.peek(1));
    br.drop(1);
    int btype = int(br.peek(2));
    br.drop(2);

    if (btype == 3) return DT_E_BTYPE;
    if (btype == 0) {
      br.align();
      if (!br.have(32)) return DT_E_INPUT;
      uint32_t len = br.peek(16);
      br.drop(16);
      uint32_t nlen = br.peek(16);
      br.drop(16);
      if ((len ^ nlen) != 0xFFFF) return DT_E_INPUT;
      int64_t payload = bitpos();
      if (size_t(payload + 8 * int64_t(len)) > 8 * in_len)
        return DT_E_INPUT;
      uint32_t c = 0;
      do {  // len == 0 emits one empty vb so the stream stays indexed
        uint32_t take = len - c > 32768 ? 32768 : len - c;
        if (!push_vb(parent, payload + 8 * int64_t(c), take, 1 | 2,
                     8 * int64_t(take), 0))
          return DT_E_OUTPUT;
        memset(hints + (nvb - 1) * hint_stride, 0xFF, size_t(hint_stride));
        c += take;
      } while (c < len);
      // advance the reader past the payload (buffer holds whole bytes)
      uint32_t rem = len;
      while (rem && br.n >= 8) {
        br.drop(8);
        rem--;
      }
      br.p += rem;
    } else {
      if (btype == 1) {
        if (fixed_tables(tbl) < 0) return DT_E_CODE;
      } else {
        int rc = dynamic_tables(br, tbl);
        if (rc != DT_OK) return rc;
      }
      int64_t vb_start = bitpos();
      int64_t vb_out = 0;
      int64_t vb_flags = 0;
      if (nvb >= max_vb) return DT_E_OUTPUT;
      uint8_t* h = hints + nvb * hint_stride;
      memset(h, 0xFF, size_t(hint_stride));
      for (;;) {
        if (br.n == 0 && br.p == br.end) return DT_E_INPUT;
        int64_t sym_bit = bitpos();
        int s = decode_sym(br, tbl.lit);
        if (s < 0) return DT_E_CODE;
        int64_t emit, length = 0, dist = 0;
        if (s < 256) {
          emit = 1;
        } else if (s == 256) {
          emit = 0;
        } else {
          if (s > 285) return DT_E_CODE;
          int li = s - 257;
          if (!br.have(kLenExtra[li])) return DT_E_INPUT;
          length = kLenBase[li] + br.peek(kLenExtra[li]);
          br.drop(kLenExtra[li]);
          int d = decode_sym(br, tbl.dist);
          if (d < 0 || d > 29) return DT_E_CODE;
          if (!br.have(kDistExtra[d])) return DT_E_INPUT;
          dist = kDistBase[d] + br.peek(kDistExtra[d]);
          br.drop(kDistExtra[d]);
          emit = length;
        }
        if (s != 256 && (vb_out + emit > 32768 ||
                         sym_bit - vb_start >= span_cap)) {
          // cut BEFORE this symbol: close the vb with a synthetic stop.
          // The stop position itself gets a hint entry — the wavefront
          // chain validation checks every chunk's carry-in against the
          // hints, and the stop mark is part of the old vb's chain.
          int64_t srel = sym_bit - vb_start;
          if (h[srel >> 6] == 0xFF) h[srel >> 6] = uint8_t(srel & 63);
          if (!push_vb(parent, vb_start, vb_out, vb_flags, srel, btype))
            return DT_E_OUTPUT;
          if (nvb >= max_vb) return DT_E_OUTPUT;
          vb_start = sym_bit;
          vb_out = 0;
          vb_flags = 0;
          h = hints + nvb * hint_stride;
          memset(h, 0xFF, size_t(hint_stride));
        }
        int64_t rel = sym_bit - vb_start;
        int64_t w = rel >> 6;
        if (w >= hint_stride) return DT_E_OUTPUT;
        if (h[w] == 0xFF) h[w] = uint8_t(rel & 63);
        if (s == 256) {
          if (!push_vb(parent, vb_start, vb_out, vb_flags | 2,
                       bitpos() - vb_start, btype))
            return DT_E_OUTPUT;
          break;
        }
        if (s > 256) {
          if (dist > out_abs + vb_out) return DT_E_DIST;
          if (dist > vb_out) vb_flags |= 4;  // reaches previous vb output
        }
        vb_out += emit;
      }
    }
    if (bfinal) {
      *n_vb_out = nvb;
      *total_out = out_abs;
      return DT_OK;
    }
  }
}

// Export this translation unit's RFC 1951 constants so the test suite can
// cross-check them against utils/tables.py and deflate.cpp's copies
// (three-way duplication drift guard).
void dt_rfc_tables_inflate(int32_t* len_base, int32_t* len_extra,
                           int32_t* dist_base, int32_t* dist_extra,
                           int32_t* cl_order) {
  for (int i = 0; i < 29; i++) {
    len_base[i] = kLenBase[i];
    len_extra[i] = kLenExtra[i];
  }
  for (int i = 0; i < 30; i++) {
    dist_base[i] = kDistBase[i];
    dist_extra[i] = kDistExtra[i];
  }
  for (int i = 0; i < 19; i++) cl_order[i] = kClOrder[i];
}

}  // extern "C"
