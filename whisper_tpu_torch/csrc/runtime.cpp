// whisper_tpu_torch native runtime — host-side hot paths (a copy of the JAX
// package's whisper_tpu/runtime/runtime.cpp, built and loaded by the port
// itself).
//
// Counterpart of the reference's C runtime pieces:
//  - block dequantization (reference ggml/src/ggml-quants.c): checkpoint
//    loading for large-v3 decodes ~1.5B quantized elements; threaded C++
//    beats numpy's bit-fiddling several-fold.
//  - DTW dynamic program + backtrace (reference src/whisper.cpp:8647-8730):
//    inherently sequential O(N*M); a Python loop over 448x1500 cells costs
//    seconds, this costs ~1 ms.
//  - signal-energy envelope (reference :8360-8376).
//
// Exposed as a plain C ABI consumed via ctypes
// (whisper_tpu_torch/runtime/native.py). Built with g++ at first use by
// whisper_tpu_torch/ops/build.py into whisper_tpu_torch/_build/ (no
// dependencies).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// fp16 -> fp32 (IEEE half, no F16C dependency)
// ---------------------------------------------------------------------------
static inline float fp16_to_fp32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp  = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {
            // subnormal
            int e = -1;
            do { mant <<= 1; e++; } while (!(mant & 0x400));
            mant &= 0x3FF;
            bits = sign | ((uint32_t)(127 - 15 - e) << 23) | (mant << 13);
        }
    } else if (exp == 0x1F) {
        bits = sign | 0x7F800000u | (mant << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

// ---------------------------------------------------------------------------
// block dequantization (layouts: reference ggml/src/ggml-common.h:167-213)
// ---------------------------------------------------------------------------
#define QK 32

static void dequant_block_q4_0(const uint8_t* p, float* out) {
    float d = fp16_to_fp32(*(const uint16_t*)p);
    const uint8_t* qs = p + 2;
    for (int j = 0; j < 16; ++j) {
        out[j]      = ((int)(qs[j] & 0x0F) - 8) * d;
        out[j + 16] = ((int)(qs[j] >> 4)   - 8) * d;
    }
}

static void dequant_block_q4_1(const uint8_t* p, float* out) {
    float d = fp16_to_fp32(*(const uint16_t*)p);
    float m = fp16_to_fp32(*(const uint16_t*)(p + 2));
    const uint8_t* qs = p + 4;
    for (int j = 0; j < 16; ++j) {
        out[j]      = (qs[j] & 0x0F) * d + m;
        out[j + 16] = (qs[j] >> 4)   * d + m;
    }
}

static void dequant_block_q5_0(const uint8_t* p, float* out) {
    float d = fp16_to_fp32(*(const uint16_t*)p);
    uint32_t qh;
    std::memcpy(&qh, p + 2, 4);
    const uint8_t* qs = p + 6;
    for (int j = 0; j < 16; ++j) {
        int lo = (qs[j] & 0x0F) | (((qh >> j) & 1) << 4);
        int hi = (qs[j] >> 4)   | (((qh >> (j + 16)) & 1) << 4);
        out[j]      = (lo - 16) * d;
        out[j + 16] = (hi - 16) * d;
    }
}

static void dequant_block_q5_1(const uint8_t* p, float* out) {
    float d = fp16_to_fp32(*(const uint16_t*)p);
    float m = fp16_to_fp32(*(const uint16_t*)(p + 2));
    uint32_t qh;
    std::memcpy(&qh, p + 4, 4);
    const uint8_t* qs = p + 8;
    for (int j = 0; j < 16; ++j) {
        int lo = (qs[j] & 0x0F) | (((qh >> j) & 1) << 4);
        int hi = (qs[j] >> 4)   | (((qh >> (j + 16)) & 1) << 4);
        out[j]      = lo * d + m;
        out[j + 16] = hi * d + m;
    }
}

static void dequant_block_q8_0(const uint8_t* p, float* out) {
    float d = fp16_to_fp32(*(const uint16_t*)p);
    const int8_t* qs = (const int8_t*)(p + 2);
    for (int j = 0; j < 32; ++j) out[j] = qs[j] * d;
}

// ---------------------------------------------------------------------------
// K-quant super-blocks, 256 elements (reference dequantize_row_q{2..6}_K,
// ggml/src/ggml-quants.c:706,1050,1274,1476,1684; layouts ggml-common.h:
// 255-327). The loop structure mirrors the reference so float multiply
// order — and therefore the decoded bits — are identical.
// ---------------------------------------------------------------------------
#define QK_K 256

static inline void k4_scale_min(int j, const uint8_t* q, uint8_t* d, uint8_t* m) {
    // reference get_scale_min_k4 (ggml-quants.c:625-633)
    if (j < 4) {
        *d = q[j] & 63; *m = q[j + 4] & 63;
    } else {
        *d = (q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4);
        *m = (q[j + 4] >> 4)  | ((q[j - 0] >> 6) << 4);
    }
}

static void dequant_block_q2_K(const uint8_t* p, float* out) {
    const uint8_t* scales = p;            // 16 bytes: 4-bit scale | min<<4
    const uint8_t* q = p + 16;            // 64 bytes of 2-bit quants
    float d    = fp16_to_fp32(*(const uint16_t*)(p + 80));
    float dmin = fp16_to_fp32(*(const uint16_t*)(p + 82));
    float* y = out;
    int is = 0;
    for (int n = 0; n < QK_K; n += 128) {
        int shift = 0;
        for (int j = 0; j < 4; ++j) {
            uint8_t sc = scales[is++];
            float dl = d * (sc & 0xF), ml = dmin * (sc >> 4);
            for (int l = 0; l < 16; ++l) *y++ = dl * ((int8_t)((q[l] >> shift) & 3)) - ml;
            sc = scales[is++];
            dl = d * (sc & 0xF); ml = dmin * (sc >> 4);
            for (int l = 0; l < 16; ++l) *y++ = dl * ((int8_t)((q[l + 16] >> shift) & 3)) - ml;
            shift += 2;
        }
        q += 32;
    }
}

static void dequant_block_q3_K(const uint8_t* p, float* out) {
    const uint8_t* hm = p;                // 32 bytes high-bit mask
    const uint8_t* q = p + 32;            // 64 bytes of 2-bit quants
    const uint8_t* sraw = p + 96;         // 12 packed 6-bit scales
    float d_all = fp16_to_fp32(*(const uint16_t*)(p + 108));
    // kmask shuffle (ggml-quants.c:1054-1073)
    uint32_t aux[4];
    std::memcpy(aux, sraw, 12);
    const uint32_t km1 = 0x03030303, km2 = 0x0f0f0f0f;
    uint32_t tmp = aux[2];
    aux[2] = ((aux[0] >> 4) & km2) | (((tmp >> 4) & km1) << 4);
    aux[3] = ((aux[1] >> 4) & km2) | (((tmp >> 6) & km1) << 4);
    aux[0] = (aux[0] & km2) | (((tmp >> 0) & km1) << 4);
    aux[1] = (aux[1] & km2) | (((tmp >> 2) & km1) << 4);
    const int8_t* scales = (const int8_t*)aux;
    float* y = out;
    int is = 0;
    uint8_t m = 1;
    for (int n = 0; n < QK_K; n += 128) {
        int shift = 0;
        for (int j = 0; j < 4; ++j) {
            float dl = d_all * (scales[is++] - 32);
            for (int l = 0; l < 16; ++l)
                *y++ = dl * ((int8_t)((q[l] >> shift) & 3) - ((hm[l] & m) ? 0 : 4));
            dl = d_all * (scales[is++] - 32);
            for (int l = 0; l < 16; ++l)
                *y++ = dl * ((int8_t)((q[l + 16] >> shift) & 3) - ((hm[l + 16] & m) ? 0 : 4));
            shift += 2;
            m <<= 1;
        }
        q += 32;
    }
}

static void dequant_block_q4_K(const uint8_t* p, float* out) {
    float d    = fp16_to_fp32(*(const uint16_t*)p);
    float dmin = fp16_to_fp32(*(const uint16_t*)(p + 2));
    const uint8_t* scales = p + 4;
    const uint8_t* q = p + 16;
    float* y = out;
    int is = 0;
    for (int j = 0; j < QK_K; j += 64) {
        uint8_t sc, m;
        k4_scale_min(is + 0, scales, &sc, &m);
        float d1 = d * sc, m1 = dmin * m;
        k4_scale_min(is + 1, scales, &sc, &m);
        float d2 = d * sc, m2 = dmin * m;
        for (int l = 0; l < 32; ++l) *y++ = d1 * (q[l] & 0xF) - m1;
        for (int l = 0; l < 32; ++l) *y++ = d2 * (q[l] >> 4)  - m2;
        q += 32; is += 2;
    }
}

static void dequant_block_q5_K(const uint8_t* p, float* out) {
    float d    = fp16_to_fp32(*(const uint16_t*)p);
    float dmin = fp16_to_fp32(*(const uint16_t*)(p + 2));
    const uint8_t* scales = p + 4;
    const uint8_t* qh = p + 16;
    const uint8_t* ql = p + 48;
    float* y = out;
    int is = 0;
    uint8_t u1 = 1, u2 = 2;
    for (int j = 0; j < QK_K; j += 64) {
        uint8_t sc, m;
        k4_scale_min(is + 0, scales, &sc, &m);
        float d1 = d * sc, m1 = dmin * m;
        k4_scale_min(is + 1, scales, &sc, &m);
        float d2 = d * sc, m2 = dmin * m;
        for (int l = 0; l < 32; ++l) *y++ = d1 * ((ql[l] & 0xF) + ((qh[l] & u1) ? 16 : 0)) - m1;
        for (int l = 0; l < 32; ++l) *y++ = d2 * ((ql[l] >> 4)  + ((qh[l] & u2) ? 16 : 0)) - m2;
        ql += 32; is += 2;
        u1 <<= 2; u2 <<= 2;
    }
}

static void dequant_block_q6_K(const uint8_t* p, float* out) {
    const uint8_t* ql = p;
    const uint8_t* qh = p + 128;
    const int8_t* sc = (const int8_t*)(p + 192);
    float d = fp16_to_fp32(*(const uint16_t*)(p + 208));
    float* y = out;
    for (int n = 0; n < QK_K; n += 128) {
        for (int l = 0; l < 32; ++l) {
            int is = l / 16;
            int8_t q1 = (int8_t)((ql[l +  0] & 0xF) | (((qh[l] >> 0) & 3) << 4)) - 32;
            int8_t q2 = (int8_t)((ql[l + 32] & 0xF) | (((qh[l] >> 2) & 3) << 4)) - 32;
            int8_t q3 = (int8_t)((ql[l +  0] >> 4)  | (((qh[l] >> 4) & 3) << 4)) - 32;
            int8_t q4 = (int8_t)((ql[l + 32] >> 4)  | (((qh[l] >> 6) & 3) << 4)) - 32;
            y[l +  0] = d * sc[is + 0] * q1;
            y[l + 32] = d * sc[is + 2] * q2;
            y[l + 64] = d * sc[is + 4] * q3;
            y[l + 96] = d * sc[is + 6] * q4;
        }
        y += 128; ql += 64; qh += 32; sc += 8;
    }
}

typedef void (*dequant_fn)(const uint8_t*, float*);

// ttype codes match ggml (quant.py): 2=q4_0 3=q4_1 6=q5_0 7=q5_1 8=q8_0
// 10..14=q2_K..q6_K 1=f16
int wtpu_dequantize(int ttype, const uint8_t* in, float* out, int64_t nelems,
                    int n_threads) {
    if (ttype == 1) {  // f16
        const uint16_t* h = (const uint16_t*)in;
        for (int64_t i = 0; i < nelems; ++i) out[i] = fp16_to_fp32(h[i]);
        return 0;
    }
    dequant_fn fn = nullptr;
    int bs = 0;       // block bytes
    int bn = QK;      // block elements
    switch (ttype) {
        case 2: fn = dequant_block_q4_0; bs = 18; break;
        case 3: fn = dequant_block_q4_1; bs = 20; break;
        case 6: fn = dequant_block_q5_0; bs = 22; break;
        case 7: fn = dequant_block_q5_1; bs = 24; break;
        case 8: fn = dequant_block_q8_0; bs = 34; break;
        case 10: fn = dequant_block_q2_K; bs = 84;  bn = QK_K; break;
        case 11: fn = dequant_block_q3_K; bs = 110; bn = QK_K; break;
        case 12: fn = dequant_block_q4_K; bs = 144; bn = QK_K; break;
        case 13: fn = dequant_block_q5_K; bs = 176; bn = QK_K; break;
        case 14: fn = dequant_block_q6_K; bs = 210; bn = QK_K; break;
        default: return -1;
    }
    int64_t nb = nelems / bn;
    if (nb * bn != nelems) return -2;

    if (n_threads <= 1 || nb < 1024) {
        for (int64_t b = 0; b < nb; ++b) fn(in + b * bs, out + b * bn);
        return 0;
    }
    std::atomic<int64_t> next(0);
    const int64_t chunk = 4096;
    auto worker = [&]() {
        for (;;) {
            int64_t b0 = next.fetch_add(chunk);
            if (b0 >= nb) break;
            int64_t b1 = std::min(b0 + chunk, nb);
            for (int64_t b = b0; b < b1; ++b) fn(in + b * bs, out + b * bn);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < n_threads; ++t) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();
    return 0;
}

// ---------------------------------------------------------------------------
// DTW dynamic program + backtrace (reference dtw_and_backtrace,
// src/whisper.cpp:8647-8730; semantics identical to OpenAI timing.py)
// x: N x M row-major cost matrix. out_text/out_time: buffers of size N+M.
// Returns path length, or -1 on error.
// ---------------------------------------------------------------------------
int wtpu_dtw(const float* x, int n, int m, int32_t* out_text, int32_t* out_time) {
    if (n <= 0 || m <= 0) return -1;
    std::vector<double> cost((size_t)(n + 1) * (m + 1),
                             std::numeric_limits<double>::infinity());
    std::vector<int8_t> trace((size_t)(n + 1) * (m + 1), -1);
    const size_t W = m + 1;
    cost[0] = 0.0;

    for (int i = 1; i <= n; ++i) {
        const float* xrow = x + (size_t)(i - 1) * m;
        double* crow = cost.data() + (size_t)i * W;
        const double* prow = cost.data() + (size_t)(i - 1) * W;
        int8_t* trow = trace.data() + (size_t)i * W;
        for (int j = 1; j <= m; ++j) {
            double c0 = prow[j - 1];   // diag
            double c1 = prow[j];       // up    (i-1, j)
            double c2 = crow[j - 1];   // left  (i, j-1)
            double c;
            int8_t t;
            if (c0 < c1 && c0 < c2) { c = c0; t = 0; }
            else if (c1 < c0 && c1 < c2) { c = c1; t = 1; }
            else { c = c2; t = 2; }
            crow[j] = xrow[j - 1] + c;
            trow[j] = t;
        }
    }
    // border rules (reference :8692-8697)
    for (int j = 0; j <= m; ++j) trace[j] = 2;
    for (int i = 0; i <= n; ++i) trace[(size_t)i * W] = 1;

    int i = n, j = m;
    int len = 0;
    std::vector<int32_t> ti, tj;
    ti.reserve(n + m);
    tj.reserve(n + m);
    while (i > 0 || j > 0) {
        ti.push_back(i - 1);
        tj.push_back(j - 1);
        int8_t t = trace[(size_t)i * W + j];
        if (t == 0) { --i; --j; }
        else if (t == 1) { --i; }
        else { --j; }
        ++len;
    }
    for (int k = 0; k < len; ++k) {
        out_text[k] = ti[len - 1 - k];
        out_time[k] = tj[len - 1 - k];
    }
    return len;
}

// ---------------------------------------------------------------------------
// signal energy envelope (reference get_signal_energy :8360-8376):
// moving average of |x| with window 2*hw+1, constant divisor at edges.
// ---------------------------------------------------------------------------
void wtpu_signal_energy(const float* x, int64_t n, int hw, float* out) {
    double div = 2.0 * hw + 1.0;
    // prefix sums of |x|
    std::vector<double> pre((size_t)n + 1, 0.0);
    for (int64_t i = 0; i < n; ++i) pre[i + 1] = pre[i] + std::fabs(x[i]);
    for (int64_t i = 0; i < n; ++i) {
        int64_t a = std::max<int64_t>(0, i - hw);
        int64_t b = std::min<int64_t>(n, i + hw + 1);
        out[i] = (float)((pre[b] - pre[a]) / div);
    }
}

int wtpu_version(void) { return 1; }

}  // extern "C"

// ---------------------------------------------------------------------------
// GBNF grammar engine — native twin of decoding/grammar.py (which mirrors
// the reference's C++ engine, src/whisper.cpp:5484-5890). The hot loop is
// rejected-token computation: every decode step scans ~50k vocab tokens
// against the pushdown stacks; Python costs tens of ms per step, this ~1 ms.
// Rules arrive flattened as (type,value) int32 pairs with per-rule offsets.
// ---------------------------------------------------------------------------

namespace wtpu_grammar {

enum { G_END = 0, G_ALT = 1, G_RULE_REF = 2, G_CHAR = 3, G_CHAR_NOT = 4,
       G_CHAR_RNG_UPPER = 5, G_CHAR_ALT = 6 };

struct Engine {
    const int32_t* elems;   // (type,value) pairs, all rules concatenated
    const int32_t* offs;    // n_rules+1 offsets (in pairs)
    inline int32_t type(int32_t r, int32_t i) const { return elems[2 * (offs[r] + i)]; }
    inline int32_t val(int32_t r, int32_t i) const { return elems[2 * (offs[r] + i) + 1]; }
};

struct Pos { int32_t r, i; };
inline bool operator==(const Pos& a, const Pos& b) { return a.r == b.r && a.i == b.i; }
using Stack = std::vector<Pos>;

static inline bool is_end(const Engine& g, Pos p) {
    int32_t t = g.type(p.r, p.i);
    return t == G_END || t == G_ALT;
}

// (matched, element pos after the char class)  [grammar.py _match_char]
static bool match_char(const Engine& g, Pos p, uint32_t chr_, Pos* after) {
    bool found = false;
    const bool is_positive = g.type(p.r, p.i) == G_CHAR;
    for (;;) {
        uint32_t v = (uint32_t)g.val(p.r, p.i);
        Pos nxt{p.r, p.i + 1};
        if (g.type(nxt.r, nxt.i) == G_CHAR_RNG_UPPER) {
            found = found || (v <= chr_ && chr_ <= (uint32_t)g.val(nxt.r, nxt.i));
            p = Pos{p.r, p.i + 2};
        } else {
            found = found || v == chr_;
            p = nxt;
        }
        if (g.type(p.r, p.i) != G_CHAR_ALT) break;
    }
    *after = p;
    return found == is_positive;
}

// [grammar.py _match_partial_char]
static bool match_partial_char(const Engine& g, Pos p, int32_t pv, int32_t pr) {
    const bool is_positive = g.type(p.r, p.i) == G_CHAR;
    if (pr < 0 || (pr == 1 && pv < 2)) return false;
    uint64_t low = (uint64_t)pv << (pr * 6);
    uint64_t high = low | ((1ull << (pr * 6)) - 1);
    if (low == 0) {
        if (pr == 2) low = 1u << 11;
        else if (pr == 3) low = 1u << 16;
    }
    for (;;) {
        uint64_t v = (uint64_t)(uint32_t)g.val(p.r, p.i);
        Pos nxt{p.r, p.i + 1};
        if (g.type(nxt.r, nxt.i) == G_CHAR_RNG_UPPER) {
            if (v <= high && low <= (uint64_t)(uint32_t)g.val(nxt.r, nxt.i))
                return is_positive;
            p = Pos{p.r, p.i + 2};
        } else {
            if (low <= v && v <= high) return is_positive;
            p = nxt;
        }
        if (g.type(p.r, p.i) != G_CHAR_ALT) break;
    }
    return !is_positive;
}

static bool stacks_contain(const std::vector<Stack>& out, const Stack& s) {
    for (const auto& o : out) {
        if (o.size() == s.size() && std::equal(o.begin(), o.end(), s.begin()))
            return true;
    }
    return false;
}

// [grammar.py _advance_stack]
static void advance_stack(const Engine& g, const Stack& stack,
                          std::vector<Stack>& out) {
    if (stack.empty()) {
        if (!stacks_contain(out, stack)) out.push_back(stack);
        return;
    }
    Pos p = stack.back();
    int32_t t = g.type(p.r, p.i);
    if (t == G_RULE_REF) {
        Pos sub{g.val(p.r, p.i), 0};
        for (;;) {
            Stack ns(stack.begin(), stack.end() - 1);
            Pos nxt{p.r, p.i + 1};
            if (!is_end(g, nxt)) ns.push_back(nxt);
            if (!is_end(g, sub)) ns.push_back(sub);
            advance_stack(g, ns, out);
            while (!is_end(g, sub)) sub.i++;
            if (g.type(sub.r, sub.i) == G_ALT) sub.i++;
            else break;
        }
    } else if (t == G_CHAR || t == G_CHAR_NOT) {
        if (!stacks_contain(out, stack)) out.push_back(stack);
    }
}

// [grammar.py _accept_char]
static std::vector<Stack> accept_char(const Engine& g,
                                      const std::vector<Stack>& stacks,
                                      uint32_t chr_) {
    std::vector<Stack> out;
    for (const auto& stack : stacks) {
        if (stack.empty()) continue;
        Pos after;
        if (match_char(g, stack.back(), chr_, &after)) {
            Stack ns(stack.begin(), stack.end() - 1);
            if (!is_end(g, after)) ns.push_back(after);
            advance_stack(g, ns, out);
        }
    }
    return out;
}

struct Cand {
    int32_t tid;
    int32_t off;
    const uint32_t* cps;   // codepoints incl. trailing 0
    int32_t pv, pr;        // end-of-token partial utf8
};

// [grammar.py _reject_candidates_for_stack]
static void reject_for_stack(const Engine& g, const Stack& stack,
                             const std::vector<Cand>& candidates,
                             std::vector<Cand>& rejects) {
    if (stack.empty()) {
        for (const auto& c : candidates)
            if (c.cps[c.off] != 0 || c.pr != 0) rejects.push_back(c);
        return;
    }
    Pos sp = stack.back();
    std::vector<Cand> next;
    for (const auto& c : candidates) {
        Pos after;
        if (c.cps[c.off] == 0) {
            if (c.pr != 0 && !match_partial_char(g, sp, c.pv, c.pr))
                rejects.push_back(c);
        } else if (match_char(g, sp, c.cps[c.off], &after)) {
            Cand nc = c; nc.off += 1; next.push_back(nc);
        } else {
            rejects.push_back(c);
        }
    }
    Pos after0;
    match_char(g, sp, 0, &after0);
    Stack stack_after(stack.begin(), stack.end() - 1);
    if (!is_end(g, after0)) stack_after.push_back(after0);
    std::vector<Stack> next_stacks;
    advance_stack(g, stack_after, next_stacks);

    // recurse: reject_candidates(next_stacks, next)
    if (!next.empty() && !next_stacks.empty()) {
        std::vector<Cand> rej;
        reject_for_stack(g, next_stacks[0], next, rej);
        for (size_t s = 1; s < next_stacks.size(); s++) {
            std::vector<Cand> rej2;
            reject_for_stack(g, next_stacks[s], rej, rej2);
            rej.swap(rej2);
        }
        for (auto c : rej) { c.off -= 1; rejects.push_back(c); }
    }
}

static std::vector<Cand> reject_candidates(const Engine& g,
                                           const std::vector<Stack>& stacks,
                                           const std::vector<Cand>& candidates) {
    std::vector<Cand> rej;
    if (candidates.empty() || stacks.empty()) return rej;
    reject_for_stack(g, stacks[0], candidates, rej);
    for (size_t s = 1; s < stacks.size(); s++) {
        std::vector<Cand> rej2;
        reject_for_stack(g, stacks[s], rej, rej2);
        rej.swap(rej2);
    }
    return rej;
}

// [grammar.py decode_utf8] -> codepoints + trailing 0; returns end partial
static void decode_utf8(const uint8_t* data, int64_t n, int32_t pv, int32_t pr,
                        std::vector<uint32_t>& cps, int32_t* opv, int32_t* opr) {
    static const int lookup[16] = {1,1,1,1,1,1,1,1,0,0,0,0,2,2,3,4};
    int64_t pos = 0;
    uint32_t value = (uint32_t)pv;
    int32_t n_remain = pr;
    cps.clear();
    while (pos < n && n_remain > 0) {
        uint8_t b = data[pos];
        if ((b >> 6) != 2) { cps.assign(1, 0); *opv = 0; *opr = -1; return; }
        value = (value << 6) + (b & 0x3F);
        pos++; n_remain--;
    }
    if (pr > 0 && n_remain == 0) cps.push_back(value);
    while (pos < n) {
        uint8_t first = data[pos];
        n_remain = lookup[first >> 4] - 1;
        if (n_remain < 0) { cps.assign(1, 0); *opv = 0; *opr = n_remain; return; }
        uint32_t mask = (1u << (7 - n_remain)) - 1;
        value = first & mask;
        pos++;
        while (pos < n && n_remain > 0) {
            value = (value << 6) + (data[pos] & 0x3F);
            pos++; n_remain--;
        }
        if (n_remain == 0) cps.push_back(value);
    }
    cps.push_back(0);
    *opv = (int32_t)value; *opr = n_remain;
}

static std::vector<Stack> unflatten_stacks(const int32_t* flat,
                                           const int32_t* offs, int32_t n) {
    std::vector<Stack> stacks(n);
    for (int32_t s = 0; s < n; s++) {
        for (int32_t k = offs[s]; k < offs[s + 1]; k++)
            stacks[s].push_back(Pos{flat[2 * k], flat[2 * k + 1]});
    }
    return stacks;
}

}  // namespace wtpu_grammar

extern "C" {

// Fill out_mask[tid]=1 for every grammar-rejected token.
// Returns number rejected, or -1 on error.
int64_t wtpu_grammar_rejects(
        const int32_t* rule_elems, const int32_t* rule_offs, int32_t n_rules,
        const int32_t* stacks_flat, const int32_t* stack_offs, int32_t n_stacks,
        const uint8_t* vocab_bytes, const int64_t* vocab_offs, int32_t n_tokens,
        int32_t partial_value, int32_t partial_remain,
        uint8_t* out_mask) {
    using namespace wtpu_grammar;
    if (n_rules <= 0 || n_stacks <= 0) return 0;
    Engine g{rule_elems, rule_offs};
    std::vector<Stack> stacks = unflatten_stacks(stacks_flat, stack_offs, n_stacks);

    // decode every candidate token's codepoints into one arena
    std::vector<uint32_t> arena;
    arena.reserve((size_t)(vocab_offs[n_tokens] - vocab_offs[0]) + n_tokens);
    std::vector<Cand> cands;
    cands.reserve(n_tokens);
    std::vector<uint32_t> cps;
    std::vector<int64_t> starts(n_tokens, -1);
    std::vector<int32_t> pvs(n_tokens), prs(n_tokens);
    for (int32_t tid = 0; tid < n_tokens; tid++) {
        int64_t a = vocab_offs[tid], b = vocab_offs[tid + 1];
        if (b <= a) continue;                      // empty text: not a candidate
        int32_t opv, opr;
        decode_utf8(vocab_bytes + a, b - a, partial_value, partial_remain,
                    cps, &opv, &opr);
        starts[tid] = (int64_t)arena.size();
        arena.insert(arena.end(), cps.begin(), cps.end());
        pvs[tid] = opv; prs[tid] = opr;
    }
    for (int32_t tid = 0; tid < n_tokens; tid++) {
        if (starts[tid] < 0) continue;
        cands.push_back(Cand{tid, 0, arena.data() + starts[tid],
                             pvs[tid], prs[tid]});
    }

    std::memset(out_mask, 0, (size_t)n_tokens);
    std::vector<Cand> rej = reject_candidates(g, stacks, cands);
    for (const auto& c : rej) out_mask[c.tid] = 1;
    return (int64_t)rej.size();
}

// Accept one token: advance the stacks through its codepoints.
// partial_io = {value, n_remain} updated in place. Writes the new stacks
// into out_flat/out_offs (pair-granular); returns new stack count, or -1
// if the output buffers are too small.
int32_t wtpu_grammar_accept(
        const int32_t* rule_elems, const int32_t* rule_offs, int32_t n_rules,
        const int32_t* stacks_flat, const int32_t* stack_offs, int32_t n_stacks,
        const uint8_t* token_bytes, int64_t token_len,
        int32_t* partial_io,
        int32_t* out_flat, int32_t* out_offs,
        int32_t max_pairs, int32_t max_stacks) {
    using namespace wtpu_grammar;
    if (n_rules <= 0) return -1;
    Engine g{rule_elems, rule_offs};
    std::vector<Stack> stacks = unflatten_stacks(stacks_flat, stack_offs, n_stacks);

    std::vector<uint32_t> cps;
    int32_t opv, opr;
    decode_utf8(token_bytes, token_len, partial_io[0], partial_io[1],
                cps, &opv, &opr);
    for (size_t k = 0; k + 1 < cps.size(); k++)
        stacks = accept_char(g, stacks, cps[k]);
    partial_io[0] = opv; partial_io[1] = opr;

    if ((int32_t)stacks.size() > max_stacks) return -1;
    int32_t np = 0;
    out_offs[0] = 0;
    for (size_t s = 0; s < stacks.size(); s++) {
        if (np + (int32_t)stacks[s].size() > max_pairs) return -1;
        for (const auto& p : stacks[s]) {
            out_flat[2 * np] = p.r; out_flat[2 * np + 1] = p.i; np++;
        }
        out_offs[s + 1] = np;
    }
    return (int32_t)stacks.size();
}

}  // extern "C"
