// Host-side native DEFLATE — the CPU fast path of the deflate_jax runtime.
//
// Reference analog: class deflate (deflate.hpp:23-816 in the reference).
// Differences by design: the hash-chain matcher is *correct* (the
// reference's level 2 emits wrong bytes — SURVEY.md B1), the code-length
// (CL) tree is built from real frequencies (the reference hardcodes one —
// quirk Q2), and blocks remain independent 32 KiB units (quirk Q5) so
// native and device encoders produce streams with identical structure.
//
// Exported C ABI (ctypes):
//   int dt_deflate(const uint8_t* in, size_t n, int level,
//                  uint8_t* out, size_t out_cap, size_t* out_len);
//     level: 0 stored, 1 huffman-only, 2 greedy hash chains, 3 lazy.
//     returns 0 ok, -2 if out_cap too small.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int kBlock = 32768;
constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kHashBits = 15;
constexpr int kHashSize = 1 << kHashBits;

struct BitWriter {
  uint8_t* out;
  size_t cap;
  size_t pos = 0;     // bytes fully written
  uint64_t buf = 0;
  int n = 0;
  bool overflow = false;

  void put(uint32_t v, int bits) {
    buf |= uint64_t(v & ((1u << bits) - 1)) << n;
    n += bits;
    while (n >= 8) {
      if (pos >= cap) { overflow = true; n = 0; return; }
      out[pos++] = uint8_t(buf);
      buf >>= 8;
      n -= 8;
    }
  }
  void align() {
    if (n) put(0, 8 - n);
  }
  size_t finish() {
    if (n) {
      if (pos >= cap) { overflow = true; return pos; }
      out[pos++] = uint8_t(buf);
      buf = 0; n = 0;
    }
    return pos;
  }
  uint64_t bitpos() const { return pos * 8 + n; }
};

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

uint8_t len2code[kMaxMatch + 1];
uint8_t dist2code_lo[512];     // dist 1..512 direct
uint8_t dist2code_hi[128];     // (dist-1)>>8 for dist > 512
bool tables_init = false;

void init_tables() {
  if (tables_init) return;
  for (int c = 0; c < 28; c++)
    for (int l = kLenBase[c]; l < kLenBase[c + 1]; l++) len2code[l] = uint8_t(c);
  len2code[258] = 28;
  for (int c = 0; c < 30; c++) {
    int lo = kDistBase[c];
    int hi = c < 29 ? kDistBase[c + 1] : 32769;
    for (int d = lo; d < hi && d <= 512; d++) dist2code_lo[d - 1] = uint8_t(c);
    for (int d = lo; d < hi; d++)
      if (d > 512) dist2code_hi[(d - 1) >> 8] = uint8_t(c);
  }
  tables_init = true;
}
inline int dist_code(int d) {
  return d <= 512 ? dist2code_lo[d - 1] : dist2code_hi[(d - 1) >> 8];
}

inline uint32_t rev_bits(uint32_t v, int l) {
  uint32_t r = 0;
  for (int b = 0; b < l; b++) r |= ((v >> b) & 1u) << (l - 1 - b);
  return r;
}

// Huffman code lengths, length-limited to max_len, zlib fixup semantics.
// freq/lens arrays sized n (n <= 288).
void code_lengths(const uint32_t* freq, int n, int max_len, uint8_t* lens) {
  struct Node { uint32_t f; int16_t parent; };
  Node nodes[288 * 2];
  int heap[289], hn = 0;
  memset(lens, 0, size_t(n));

  auto heap_push = [&](int i) {
    int c = ++hn; heap[c] = i;
    while (c > 1 && nodes[heap[c >> 1]].f > nodes[heap[c]].f) {
      int t = heap[c]; heap[c] = heap[c >> 1]; heap[c >> 1] = t; c >>= 1;
    }
  };
  auto heap_pop = [&]() {
    int top = heap[1]; heap[1] = heap[hn--];
    int c = 1;
    for (;;) {
      int l = 2 * c, r = l + 1, m = c;
      if (l <= hn && nodes[heap[l]].f < nodes[heap[m]].f) m = l;
      if (r <= hn && nodes[heap[r]].f < nodes[heap[m]].f) m = r;
      if (m == c) break;
      int t = heap[c]; heap[c] = heap[m]; heap[m] = t; c = m;
    }
    return top;
  };

  int nz = 0;
  for (int s = 0; s < n; s++) {
    nodes[s] = {freq[s], -1};
    if (freq[s]) { heap_push(s); nz++; }
  }
  if (nz == 0) return;
  if (nz == 1) {  // degenerate: one code of length 1
    for (int s = 0; s < n; s++) if (freq[s]) lens[s] = 1;
    return;
  }
  int next = n;
  while (hn > 1) {
    int a = heap_pop(), b = heap_pop();
    nodes[next] = {nodes[a].f + nodes[b].f, -1};
    nodes[a].parent = int16_t(next);
    nodes[b].parent = int16_t(next);
    heap_push(next++);
  }
  // depths: parents always have higher indices
  uint8_t depth[288 * 2];
  memset(depth, 0, sizeof(depth));
  int overflow = 0;
  int bl[16] = {0};
  for (int i = next - 2; i >= 0; i--) {
    if (i >= n || freq[i]) {
      int p = nodes[i].parent;
      if (p >= 0) depth[i] = uint8_t(depth[p] + 1);
      if (depth[i] > max_len) overflow++;
    }
  }
  for (int s = 0; s < n; s++)
    if (freq[s]) bl[depth[s] > max_len ? max_len : depth[s]]++;
  // zlib fixup: move pairs down until Kraft holds
  while (overflow > 0) {
    int bits = max_len - 1;
    while (bl[bits] == 0) bits--;
    bl[bits]--; bl[bits + 1] += 2; bl[max_len]--;
    overflow -= 2;
  }
  // hand out lengths: most frequent symbols get the shortest codes.
  // stable order: frequency desc, symbol asc (simple counting sort by rank)
  int order[288];
  for (int s = 0; s < n; s++) order[s] = s;
  // insertion sort is fine at n <= 288
  for (int i = 1; i < n; i++) {
    int v = order[i]; int j = i - 1;
    while (j >= 0 && (freq[order[j]] < freq[v])) { order[j + 1] = order[j]; j--; }
    order[j + 1] = v;
  }
  int l = 1, used = 0;
  for (int r = 0; r < nz; r++) {
    while (used >= bl[l]) { used = 0; l++; while (l <= max_len && bl[l] == 0) l++; }
    lens[order[r]] = uint8_t(l);
    used++;
  }
}

// canonical codes (bit-reversed, ready for LSB-first emission)
void canonical(const uint8_t* lens, int n, uint16_t* codes) {
  int bl[16] = {0};
  for (int s = 0; s < n; s++) bl[lens[s]]++;
  bl[0] = 0;
  uint32_t next[16] = {0};
  uint32_t code = 0;
  for (int l = 1; l <= 15; l++) {
    code = (code + bl[l - 1]) << 1;
    next[l] = code;
  }
  for (int s = 0; s < n; s++)
    codes[s] = lens[s] ? uint16_t(rev_bits(next[lens[s]]++, lens[s])) : 0;
}

// dist == 0: v is a literal byte; else v is the match length (3..258)
struct Token { uint16_t v; uint16_t dist; };

struct BlockState {
  Token toks[kBlock + 1];
  int ntok;
  uint32_t hist_lit[288];
  uint32_t hist_dist[30];
  int16_t head[kHashSize];
  int16_t prev[kBlock];
};

inline uint32_t hash3(const uint8_t* p) {
  uint32_t t = uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
  t ^= t >> 13; t += t << 7; t ^= t >> 9;
  return t & (kHashSize - 1);
}

inline int match_len(const uint8_t* a, const uint8_t* b, int max) {
  int l = 0;
  while (l + 8 <= max) {
    uint64_t x, y;
    memcpy(&x, a + l, 8);
    memcpy(&y, b + l, 8);
    if (x != y) {
      uint64_t d = x ^ y;
      return l + (__builtin_ctzll(d) >> 3);
    }
    l += 8;
  }
  while (l < max && a[l] == b[l]) l++;
  return l;
}

// tokenize one block with hash chains; level 2 greedy, 3 lazy
void tokenize(const uint8_t* p, int n, int level, int max_chain,
              BlockState& st) {
  st.ntok = 0;
  memset(st.hist_lit, 0, sizeof(st.hist_lit));
  memset(st.hist_dist, 0, sizeof(st.hist_dist));
  memset(st.head, -1, sizeof(st.head));

  auto find = [&](int i, int& blen, int& bdist) {
    blen = 0; bdist = 0;
    if (i + kMinMatch > n) return;
    int limit = n - i < kMaxMatch ? n - i : kMaxMatch;
    int chain = max_chain;
    for (int j = st.head[hash3(p + i)]; j >= 0 && chain-- > 0; j = st.prev[j]) {
      int l = match_len(p + i, p + j, limit);
      if (l > blen) { blen = l; bdist = i - j; if (l >= limit) break; }
    }
    if (blen == kMinMatch && bdist > 4096) blen = 0;  // too-far heuristic
  };
  auto insert = [&](int i) {
    if (i + kMinMatch <= n) {
      uint32_t h = hash3(p + i);
      st.prev[i] = st.head[h];
      st.head[h] = int16_t(i);
    }
  };
  auto put_lit = [&](int i) {
    st.toks[st.ntok++] = {p[i], 0};
    st.hist_lit[p[i]]++;
  };
  auto put_match = [&](int len, int dist) {
    st.toks[st.ntok++] = {uint16_t(len), uint16_t(dist)};
    st.hist_lit[257 + len2code[len]]++;
    st.hist_dist[dist_code(dist)]++;
  };

  if (level < 2) {
    for (int i = 0; i < n; i++) put_lit(i);
  } else {
    int i = 0;
    while (i < n) {
      int blen, bdist;
      find(i, blen, bdist);
      insert(i);
      if (level >= 3) {
        // lazy: defer while the next position has a strictly longer match
        while (blen >= kMinMatch && blen < kMaxMatch && i + 1 < n) {
          int l2, d2;
          find(i + 1, l2, d2);
          if (l2 <= blen) break;
          put_lit(i);
          i++;
          insert(i);
          blen = l2; bdist = d2;
        }
      }
      if (blen >= kMinMatch) {
        put_match(blen, bdist);
        for (int k = i + 1; k < i + blen; k++) insert(k);
        i += blen;
      } else {
        put_lit(i);
        i++;
      }
    }
  }
  st.hist_lit[256]++;  // end of block
}

// fixed-code tables
void fixed_lens(uint8_t* ll, uint8_t* dl) {
  for (int s = 0; s < 144; s++) ll[s] = 8;
  for (int s = 144; s < 256; s++) ll[s] = 9;
  for (int s = 256; s < 280; s++) ll[s] = 7;
  for (int s = 280; s < 288; s++) ll[s] = 8;
  for (int s = 0; s < 30; s++) dl[s] = 5;
}

// RLE-compress the combined code length array into CL ops.
// returns op count; ops are (sym, extra_val, extra_bits)
struct ClOp { uint8_t sym, ev, eb; };
int rle_lens(const uint8_t* lens, int total, ClOp* ops) {
  int no = 0;
  int i = 0;
  while (i < total) {
    int v = lens[i];
    int run = 1;
    while (i + run < total && lens[i + run] == v) run++;
    if (v == 0) {
      int r = run;
      while (r >= 11) { int t = r > 138 ? 138 : r; ops[no++] = {18, uint8_t(t - 11), 7}; r -= t; }
      if (r >= 3) { ops[no++] = {17, uint8_t(r - 3), 3}; r = 0; }
      while (r-- > 0) ops[no++] = {0, 0, 0};
    } else {
      ops[no++] = {uint8_t(v), 0, 0};
      int r = run - 1;
      while (r >= 3) { int t = r > 6 ? 6 : r; ops[no++] = {16, uint8_t(t - 3), 2}; r -= t; }
      while (r-- > 0) ops[no++] = {uint8_t(v), 0, 0};
    }
    i += run;
  }
  return no;
}

struct DynHeader {
  ClOp ops[320];
  int nops;
  uint8_t cl_lens[19];
  uint16_t cl_codes[19];
  int hlit, hdist, hclen;
  uint64_t bits;  // header cost in bits (excluding the 3 block-type bits)
};

void build_dyn_header(const uint8_t* ll, const uint8_t* dl, DynHeader& h) {
  h.hlit = 257;
  for (int s = 257; s < 288; s++) if (ll[s]) h.hlit = s + 1;
  h.hdist = 1;
  for (int s = 1; s < 30; s++) if (dl[s]) h.hdist = s + 1;
  uint8_t comb[320];
  memcpy(comb, ll, size_t(h.hlit));
  memcpy(comb + h.hlit, dl, size_t(h.hdist));
  h.nops = rle_lens(comb, h.hlit + h.hdist, h.ops);

  uint32_t cl_freq[19] = {0};
  for (int i = 0; i < h.nops; i++) cl_freq[h.ops[i].sym]++;
  code_lengths(cl_freq, 19, 7, h.cl_lens);
  canonical(h.cl_lens, 19, h.cl_codes);
  h.hclen = 4;
  for (int i = 0; i < 19; i++) if (h.cl_lens[kClOrder[i]]) h.hclen = i + 1;
  h.bits = 14 + uint64_t(3 * h.hclen);
  for (int i = 0; i < h.nops; i++)
    h.bits += h.cl_lens[h.ops[i].sym] + h.ops[i].eb;
}

uint64_t body_bits(const BlockState& st, const uint8_t* ll, const uint8_t* dl) {
  uint64_t bits = 0;
  for (int s = 0; s < 288; s++) bits += uint64_t(st.hist_lit[s]) * ll[s];
  for (int s = 0; s < 30; s++) bits += uint64_t(st.hist_dist[s]) * dl[s];
  for (int s = 257; s < 286; s++)
    bits += uint64_t(st.hist_lit[s]) * kLenExtra[s - 257];
  for (int s = 0; s < 30; s++)
    bits += uint64_t(st.hist_dist[s]) * kDistExtra[s];
  return bits;
}

}  // namespace

extern "C" {

int dt_deflate(const uint8_t* in, size_t in_len, int level, uint8_t* out,
               size_t out_cap, size_t* out_len) {
  init_tables();
  static thread_local BlockState st;
  BitWriter bw{out, out_cap};

  size_t off = 0;
  do {
    int n = in_len - off > kBlock ? kBlock : int(in_len - off);
    const uint8_t* p = in + off;
    bool final = (off + size_t(n) == in_len);

    uint64_t stored_bits = 32 + uint64_t(n) * 8;  // + alignment, added later

    if (level == 0) {
      bw.put(final ? 1 : 0, 1);
      bw.put(0, 2);
      bw.align();
      bw.put(uint32_t(n) & 0xFFFF, 16);
      bw.put(~uint32_t(n) & 0xFFFF, 16);
      for (int i = 0; i < n; i++) bw.put(p[i], 8);
      off += size_t(n);
      continue;
    }

    int max_chain = level >= 3 ? 128 : 32;
    tokenize(p, n, level, max_chain, st);

    uint8_t dyn_ll[288], dyn_dl[30], fx_ll[288], fx_dl[30];
    uint16_t dyn_lc[288], dyn_dc[30], fx_lc[288], fx_dc[30];
    code_lengths(st.hist_lit, 288, 15, dyn_ll);
    code_lengths(st.hist_dist, 30, 15, dyn_dl);
    canonical(dyn_ll, 288, dyn_lc);
    canonical(dyn_dl, 30, dyn_dc);
    fixed_lens(fx_ll, fx_dl);
    canonical(fx_ll, 288, fx_lc);
    canonical(fx_dl, 30, fx_dc);

    DynHeader hdr;
    build_dyn_header(dyn_ll, dyn_dl, hdr);

    uint64_t pad = (8 - ((bw.bitpos() + 3) & 7)) & 7;
    uint64_t stored_total = 3 + pad + stored_bits;
    uint64_t fixed_total = 3 + body_bits(st, fx_ll, fx_dl);
    uint64_t dyn_total = 3 + hdr.bits + body_bits(st, dyn_ll, dyn_dl);

    const uint16_t *lc, *dc;
    const uint8_t *ll, *dl;
    int btype;
    if (stored_total <= fixed_total && stored_total <= dyn_total) {
      btype = 0; lc = nullptr; dc = nullptr; ll = nullptr; dl = nullptr;
    } else if (fixed_total <= dyn_total) {
      btype = 1; lc = fx_lc; ll = fx_ll; dc = fx_dc; dl = fx_dl;
    } else {
      btype = 2; lc = dyn_lc; ll = dyn_ll; dc = dyn_dc; dl = dyn_dl;
    }

    bw.put(final ? 1 : 0, 1);
    bw.put(uint32_t(btype), 2);
    if (btype == 0) {
      bw.align();
      bw.put(uint32_t(n) & 0xFFFF, 16);
      bw.put(~uint32_t(n) & 0xFFFF, 16);
      for (int i = 0; i < n; i++) bw.put(p[i], 8);
      off += size_t(n);
      continue;
    }
    if (btype == 2) {
      bw.put(uint32_t(hdr.hlit - 257), 5);
      bw.put(uint32_t(hdr.hdist - 1), 5);
      bw.put(uint32_t(hdr.hclen - 4), 4);
      for (int i = 0; i < hdr.hclen; i++)
        bw.put(hdr.cl_lens[kClOrder[i]], 3);
      for (int i = 0; i < hdr.nops; i++) {
        const ClOp& op = hdr.ops[i];
        bw.put(hdr.cl_codes[op.sym], hdr.cl_lens[op.sym]);
        if (op.eb) bw.put(op.ev, op.eb);
      }
    }
    // emit tokens
    for (int t = 0; t < st.ntok; t++) {
      Token tk = st.toks[t];
      if (tk.dist) {
        int c = len2code[tk.v];
        bw.put(lc[257 + c], ll[257 + c]);
        if (kLenExtra[c]) bw.put(uint32_t(tk.v - kLenBase[c]), kLenExtra[c]);
        int dcode = dist_code(tk.dist);
        bw.put(dc[dcode], dl[dcode]);
        if (kDistExtra[dcode])
          bw.put(uint32_t(tk.dist - kDistBase[dcode]), kDistExtra[dcode]);
      } else {
        bw.put(lc[tk.v], ll[tk.v]);
      }
    }
    bw.put(lc[256], ll[256]);  // end of block
    off += size_t(n);
  } while (off < in_len);
  // (empty input needs no special case: the do-while body runs once with
  // n == 0 and emits a single empty BFINAL block)
  *out_len = bw.finish();
  return bw.overflow ? -2 : 0;
}

// Drift guard twin of dt_rfc_tables_inflate (see inflate.cpp): exports
// deflate.cpp's own copies of the RFC 1951 constants for the cross-check.
void dt_rfc_tables_deflate(int32_t* len_base, int32_t* len_extra,
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
