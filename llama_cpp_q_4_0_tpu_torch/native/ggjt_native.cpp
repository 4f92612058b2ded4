// Native host-side runtime: q4_0 quantizer, q4_0 planar repack and the
// SentencePiece-style bigram tokenizer.
//
// The reference consumes block_q4_0 in place (llama-util.h:166-266,
// ggml.c:870-953); the port's CUDA kernels read the planar split-half nibble
// layout instead (ops/qtensor.py), so every q4_0 weight is repacked at load.
// That repack, the q4_0 quantizer (the quantize and convert tools) and the
// tokenizer (llama.cpp:1655-1802) are the host hot paths, so they live here
// in C++ (std::thread pool), bound via ctypes.  Each is bit for bit the numpy
// or Python version it stands beside (quant/q4_0.py, quant/blockq.py,
// runtime/tokenizer.py).
//
// Build: see native/__init__.py (g++ -O3 -march=native -ffp-contract=off
// -std=c++17 -shared -fPIC -pthread; -ffp-contract=off keeps the quantizer's
// float arithmetic unfused, hence bit-exact).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- fp16

static float f16_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {  // subnormal / zero
    if (man == 0) {
      bits = sign;
    } else {
      exp = 127 - 15 + 1;
      while (!(man & 0x400)) {
        man <<= 1;
        exp--;
      }
      man &= 0x3FF;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {  // inf / nan
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

// ------------------------------------------------- q4_0 planar repack
//
// In:  blocks = N * (K/32) records of block_q4_0 {uint16 d; uint8 qs[16]}
//      (ggml.c:870-875; byte j of qs holds elements j (lo) and j+16 (hi))
// Out: packed  uint8 [K2P, N]   — split-half: byte(r, n) = nib(k=r) |
//                                 nib(k=r+K/2) << 4, rows >= K/2 zero-pad
//      scales  f32  [2, K2P/32, N] — lo/hi panel group scales, pad rows 0
// Matches QTensor packed layout exactly (pack_zero = 8: ggml's stored
// nibbles are already the biased levels).

struct BlockQ40 {
  uint16_t d;
  uint8_t qs[16];
};
static_assert(sizeof(BlockQ40) == 18, "block_q4_0 is 18 bytes");

// Iterate packed OUTPUT rows (contiguous writes), tiling the column axis
// so the strided source records stay cache-resident — a cache-blocked
// transpose rather than a per-block scatter.
static void pack_outrows_q4_0(const BlockQ40* blocks, int64_t n, int64_t k,
                              int64_t k2p, uint8_t* packed, float* scales,
                              int64_t r0, int64_t r1) {
  const int64_t nb = k / 32;
  const int64_t k2 = k / 2;
  const int64_t g2p = k2p / 32;
  constexpr int64_t CT = 512;  // column tile: 2 recs * 18B * 512 = 18 KB
  for (int64_t c0 = 0; c0 < n; c0 += CT) {
    const int64_t c1 = std::min(n, c0 + CT);
    for (int64_t r = r0; r < r1; ++r) {
      if (r >= k2) break;  // zero padding rows stay zero
      const int64_t klo = r, khi = r + k2;
      const int64_t jlo = klo / 32, ilo = klo % 32;
      const int64_t jhi = khi / 32, ihi = khi % 32;
      uint8_t* out = packed + r * n;
      for (int64_t c = c0; c < c1; ++c) {
        const BlockQ40& blo = blocks[c * nb + jlo];
        const BlockQ40& bhi = blocks[c * nb + jhi];
        const uint8_t lo = ilo < 16 ? (uint8_t)(blo.qs[ilo] & 0x0F)
                                    : (uint8_t)(blo.qs[ilo - 16] >> 4);
        const uint8_t hi = ihi < 16 ? (uint8_t)(bhi.qs[ihi] & 0x0F)
                                    : (uint8_t)(bhi.qs[ihi - 16] >> 4);
        out[c] = (uint8_t)(lo | (hi << 4));
      }
    }
  }
  // group scales (tiny): panel-ordered rows
  for (int64_t r = r0; r < r1; r += 32) {
    if (r >= k2) break;
    const int64_t grow = r / 32;
    const int64_t jlo = r / 32, jhi = (r + k2) / 32;
    for (int64_t c = 0; c < n; ++c) {
      scales[grow * n + c] = f16_to_f32(blocks[c * nb + jlo].d);
      scales[(g2p + grow) * n + c] = f16_to_f32(blocks[c * nb + jhi].d);
    }
  }
}

// packed must be zero-initialised by the caller (numpy zeros).
void gt_pack_q4_0(const uint8_t* blocks_raw, int64_t n, int64_t k,
                  int64_t k2p, uint8_t* packed, float* scales,
                  int n_threads) {
  const BlockQ40* blocks = reinterpret_cast<const BlockQ40*>(blocks_raw);
  const int64_t k2 = k / 2;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1) {
    pack_outrows_q4_0(blocks, n, k, k2p, packed, scales, 0, k2);
    return;
  }
  // split packed rows across threads, 32-aligned so scale rows don't split
  std::vector<std::thread> threads;
  int64_t chunk = (k2 + n_threads - 1) / n_threads;
  chunk = (chunk + 31) & ~int64_t(31);
  for (int t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * chunk;
    const int64_t r1 = std::min(k2, r0 + chunk);
    if (r0 >= r1) break;
    threads.emplace_back(pack_outrows_q4_0, blocks, n, k, k2p, packed,
                         scales, r0, r1);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------- q4_0 quantization
// Bit-exact port of ggml's quantize_row_q4_0_reference (ggml.c:918-953):
// d = signed_absmax / -8 (stored fp16, round-to-nearest-even), id from the
// *unrounded* d, q = MIN(15, (int8_t)(x*id + 8.5f)).

static uint16_t f32_to_f16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  const uint32_t sign = (bits >> 16) & 0x8000u;
  const uint32_t aexp = (bits >> 23) & 0xFFu;
  uint32_t man = bits & 0x7FFFFFu;
  if (aexp == 0xFFu)  // inf / nan
    return (uint16_t)(sign | 0x7C00u | (man ? 0x200u : 0u));
  const int32_t exp = (int32_t)aexp - 127 + 15;
  if (exp >= 31) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  if (exp <= 0) {  // subnormal fp16
    if (exp < -10) return (uint16_t)sign;
    man |= 0x800000u;
    const int shift = 14 - exp;
    uint32_t q = man >> shift;
    const uint32_t rem = man & ((1u << shift) - 1);
    const uint32_t half = 1u << (shift - 1);
    if (rem > half || (rem == half && (q & 1))) q++;
    return (uint16_t)(sign | q);
  }
  uint32_t q = man >> 13;
  const uint32_t rem = man & 0x1FFFu;
  uint32_t h = sign | ((uint32_t)exp << 10) | q;
  if (rem > 0x1000u || (rem == 0x1000u && (h & 1))) h++;
  return (uint16_t)h;
}

static void quant_rows_q4_0(const float* x, int64_t k, uint8_t* out,
                            int64_t row0, int64_t row1) {
  const int64_t nb = k / 32;
  for (int64_t r = row0; r < row1; ++r) {
    const float* xr = x + r * k;
    uint8_t* o = out + r * nb * 18;
    for (int64_t j = 0; j < nb; ++j) {
      const float* xb = xr + j * 32;
      float amax = 0.0f, maxv = 0.0f;
      for (int i = 0; i < 32; ++i) {
        const float a = std::fabs(xb[i]);
        if (amax < a) { amax = a; maxv = xb[i]; }
      }
      const float d = maxv / -8.0f;
      const float id = d != 0.0f ? 1.0f / d : 0.0f;
      uint8_t* blk = o + j * 18;
      const uint16_t dh = f32_to_f16(d);
      std::memcpy(blk, &dh, 2);
      for (int i = 0; i < 16; ++i) {
        int q0 = (int)(xb[i] * id + 8.5f);
        int q1 = (int)(xb[16 + i] * id + 8.5f);
        if (q0 > 15) q0 = 15;
        if (q1 > 15) q1 = 15;
        blk[2 + i] = (uint8_t)(q0 | (q1 << 4));
      }
    }
  }
}

void gt_quantize_q4_0(const float* x, int64_t n_rows, int64_t k,
                      uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n_rows) n_threads = (int)n_rows;
  if (n_threads <= 1) {
    quant_rows_q4_0(x, k, out, 0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t c0 = t * chunk;
    const int64_t c1 = std::min<int64_t>(n_rows, c0 + chunk);
    if (c0 >= c1) break;
    threads.emplace_back(quant_rows_q4_0, x, k, out, c0, c1);
  }
  for (auto& th : threads) th.join();
}

// ------------------------------------------------------- bigram tokenizer
// Port of llama_tokenizer (llama.cpp:1655-1802): split to UTF-8 chars,
// greedily merge the highest-score bigram (ties: leftmost), unknown bytes
// fall back to id = byte + 3.

struct GtVocab {
  std::unordered_map<std::string, int32_t> token_to_id;
  std::vector<float> scores;
};

void* gt_vocab_create(const uint8_t* bytes, const int64_t* offsets,
                      const float* scores, int32_t n) {
  auto* v = new GtVocab();
  v->scores.assign(scores, scores + n);
  v->token_to_id.reserve(n * 2);
  for (int32_t i = 0; i < n; ++i) {
    std::string tok(reinterpret_cast<const char*>(bytes + offsets[i]),
                    (size_t)(offsets[i + 1] - offsets[i]));
    // last id wins on duplicates (llama.cpp loader / python dict semantics)
    v->token_to_id[std::move(tok)] = i;
  }
  return v;
}

void gt_vocab_free(void* vp) { delete static_cast<GtVocab*>(vp); }

static inline int utf8_len(uint8_t b) {
  // high-nibble TABLE, exactly as the reference (llama-util.h utf8_len):
  // invalid leads 0xF8-0xFF also map to 4 — "proper" UTF-8 classification
  // diverges from the reference on malformed bytes (caught by the fuzz
  // oracle, tests/test_tokenizer_fuzz.py)
  static const int lookup[16] = {1, 1, 1, 1, 1, 1, 1, 1,
                                 1, 1, 1, 1, 2, 2, 3, 4};
  return lookup[b >> 4];
}

struct Bigram {
  float score;
  int32_t left, right, size;
};
struct BigramLess {
  bool operator()(const Bigram& a, const Bigram& b) const {
    return a.score < b.score || (a.score == b.score && a.left > b.left);
  }
};

int32_t gt_tokenize(const void* vp, const uint8_t* text, int64_t text_len,
                    int32_t add_bos, int32_t* out, int64_t out_cap) {
  const GtVocab* v = static_cast<const GtVocab*>(vp);
  int64_t n_out = 0;
  // empty input -> NO tokens, not even BOS: the reference early-returns
  // before the bos push (llama.cpp:1788-1793)
  if (text_len == 0) return 0;
  if (add_bos && n_out < out_cap) out[n_out++] = 1;  // TOKEN_BOS

  std::vector<std::string> sym;
  sym.reserve(text_len);
  std::vector<int32_t> prev, next;
  for (int64_t off = 0; off < text_len;) {
    int len = std::min<int64_t>(text_len - off, utf8_len(text[off]));
    sym.emplace_back(reinterpret_cast<const char*>(text + off), len);
    off += len;
  }
  const int32_t n_sym = (int32_t)sym.size();
  std::vector<int32_t> length(n_sym);
  prev.resize(n_sym);
  next.resize(n_sym);
  for (int32_t i = 0; i < n_sym; ++i) {
    prev[i] = i - 1;
    next[i] = i + 1 < n_sym ? i + 1 : -1;
    length[i] = (int32_t)sym[i].size();
  }

  std::priority_queue<Bigram, std::vector<Bigram>, BigramLess> heap;
  auto try_add = [&](int32_t left, int32_t right) {
    if (left == -1 || right == -1) return;
    std::string merged = sym[left] + sym[right];
    auto it = v->token_to_id.find(merged);
    if (it == v->token_to_id.end()) return;
    heap.push({v->scores[it->second], left, right, (int32_t)merged.size()});
  };
  for (int32_t i = 1; i < n_sym; ++i) try_add(i - 1, i);

  while (!heap.empty()) {
    Bigram bg = heap.top();
    heap.pop();
    if (length[bg.left] == 0 || length[bg.right] == 0 ||
        length[bg.left] + length[bg.right] != bg.size)
      continue;
    sym[bg.left] += sym[bg.right];
    length[bg.left] += length[bg.right];
    length[bg.right] = 0;
    next[bg.left] = next[bg.right];
    if (next[bg.right] >= 0) prev[next[bg.right]] = bg.left;
    try_add(prev[bg.left], bg.left);
    try_add(bg.left, next[bg.left]);
  }

  for (int32_t i = 0; i != -1; i = next[i]) {
    auto it = v->token_to_id.find(sym[i]);
    if (it == v->token_to_id.end()) {
      for (unsigned char c : sym[i]) {
        if (n_out >= out_cap) return -1;
        out[n_out++] = (int32_t)c + 3;
      }
    } else {
      if (n_out >= out_cap) return -1;
      out[n_out++] = it->second;
    }
  }
  return (int32_t)n_out;
}

}  // extern "C"
