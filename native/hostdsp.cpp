// hostdsp: native host-side runtime for rtlsdr_wsprd_tpu.
//
// The reference's runtime is C (rtlsdr_wsprd.c / wsprd/); this
// framework keeps its hot numeric path on the device (JAX) and
// implements the host-side protocol/ingest pieces natively here:
//
//   * wspr_nhash        — Bob Jenkins lookup3 hashlittle (byte-wise
//                         formulation), WSPR convention initval=146,
//                         15-bit mask. Protocol-visible; bit-exact with
//                         utils/nhash.py (reference: wsprd/nhash.c).
//   * wspr_fano_decode  — sequential Fano decoder for the K=32 r=1/2
//                         code, semantically identical to the batched
//                         device decoder (ops/fano.py): same threshold
//                         walk, cycle accounting and byte extraction.
//                         Serves as the host parity oracle and a
//                         CPU-only fallback (reference: wsprd/fano.c).
//   * wspr_conv_encode  — shift-register convolutional encoder
//                         (reference: wsprd/fano.c encode()).
//   * u8_deinterleave_center — RTL ingest: interleaved uint8 ->
//                         planar float32 recentered by -128 (the
//                         reference's XOR 0x80, rtlsdr_wsprd.c:171).
//
// Exposed as a plain C ABI consumed via ctypes (see
// rtlsdr_wsprd_tpu/native/__init__.py). Build: native/Makefile.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kPoly1 = 0xF2D05351u;  // Layland-Lushbaugh
constexpr uint32_t kPoly2 = 0xE4613C47u;
constexpr int kNBits = 81;
constexpr int kTail = kNBits - 31;  // all-zero flush region

inline uint32_t rot(uint32_t x, int k) {
  return (x << k) | (x >> (32 - k));
}

inline int parity32(uint32_t v) { return __builtin_parity(v); }

inline int encode_sym(uint32_t state) {
  return (parity32(state & kPoly1) << 1) | parity32(state & kPoly2);
}

// Polyphase dot products (wspr_pp_decimate_* below) use kW-wide
// accumulator banks — an explicit, deterministic reassociation — so
// the compiler can keep each bank in a SIMD lane under strict FP
// semantics. No -ffast-math, which must stay off file-wide (the
// quantizers rely on NaN compares).
//
// Structure picked by measurement (native/bench_pp.cpp, Xeon @2.1 GHz,
// AVX-512): FOUR independent product banks (vi*gr, vq*gi, vi*gi,
// vq*gr) combined once at the end — a single FMA per bank update, so
// the out-of-order core has 4*kW/vector-width independent chains to
// hide FMA latency (the fused form a += vi*gr - vq*gi serialized two
// dependent FMAs per update) — and TWO outputs per pass sharing the
// tap loads. Fused-form baseline 497 Msps -> 690 Msps pre-converted;
// with the tiled u8 conversion in wspr_pp_decimate_u8, ~930 Msps.
constexpr int kW = 16;  // accumulator lanes; taps (640/2400) % kW == 0

template <typename In>
inline void pp_dot(const In* bi, const In* bq, const float* gr,
                   const float* gi, int64_t taps, float center,
                   float* outI, float* outQ) {
  float A[kW] = {0}, B[kW] = {0}, C[kW] = {0}, D[kW] = {0};
  int64_t k = 0;
  for (; k + kW <= taps; k += kW) {
    for (int j = 0; j < kW; ++j) {
      const float vi = static_cast<float>(bi[k + j]) - center;
      const float vq = static_cast<float>(bq[k + j]) - center;
      A[j] += vi * gr[k + j];
      B[j] += vq * gi[k + j];
      C[j] += vi * gi[k + j];
      D[j] += vq * gr[k + j];
    }
  }
  float ai = 0.0f, aq = 0.0f;
  for (; k < taps; ++k) {
    const float vi = static_cast<float>(bi[k]) - center;
    const float vq = static_cast<float>(bq[k]) - center;
    ai += vi * gr[k] - vq * gi[k];
    aq += vi * gi[k] + vq * gr[k];
  }
  for (int j = 0; j < kW; ++j) {
    ai += A[j] - B[j];
    aq += C[j] + D[j];
  }
  *outI = ai;
  *outQ = aq;
}

// Two consecutive output frames per pass: the tap vectors gr/gi are
// loaded once and used against both frames' samples (offset R apart),
// halving tap-load pressure on the load ports.
inline void pp_dot_x2(const float* bi, const float* bq, const float* gr,
                      const float* gi, int64_t taps, int64_t R,
                      float* outI, float* outQ) {
  float A0[kW] = {0}, B0[kW] = {0}, C0[kW] = {0}, D0[kW] = {0};
  float A1[kW] = {0}, B1[kW] = {0}, C1[kW] = {0}, D1[kW] = {0};
  int64_t k = 0;
  for (; k + kW <= taps; k += kW) {
    for (int j = 0; j < kW; ++j) {
      const float g_r = gr[k + j];
      const float g_i = gi[k + j];
      const float vi0 = bi[k + j];
      const float vq0 = bq[k + j];
      const float vi1 = bi[R + k + j];
      const float vq1 = bq[R + k + j];
      A0[j] += vi0 * g_r;
      B0[j] += vq0 * g_i;
      C0[j] += vi0 * g_i;
      D0[j] += vq0 * g_r;
      A1[j] += vi1 * g_r;
      B1[j] += vq1 * g_i;
      C1[j] += vi1 * g_i;
      D1[j] += vq1 * g_r;
    }
  }
  float ai0 = 0, aq0 = 0, ai1 = 0, aq1 = 0;
  for (; k < taps; ++k) {
    ai0 += bi[k] * gr[k] - bq[k] * gi[k];
    aq0 += bi[k] * gi[k] + bq[k] * gr[k];
    ai1 += bi[R + k] * gr[k] - bq[R + k] * gi[k];
    aq1 += bi[R + k] * gi[k] + bq[R + k] * gr[k];
  }
  for (int j = 0; j < kW; ++j) {
    ai0 += A0[j] - B0[j];
    aq0 += C0[j] + D0[j];
    ai1 += A1[j] - B1[j];
    aq1 += C1[j] + D1[j];
  }
  outI[0] = ai0;
  outQ[0] = aq0;
  outI[1] = ai1;
  outQ[1] = aq1;
}

}  // namespace

extern "C" {

// ABI version of this shared object. Bumped whenever an entry point is
// added, removed, or its signature changes; the ctypes loader
// (rtlsdr_wsprd_tpu/native/__init__.py) refuses to bind a .so whose
// ABI does not match, so a stale prebuilt library can never be called
// with mismatched expectations (it falls back to the Python paths).
int wspr_hostdsp_abi(void) { return 4; }

// ---- lookup3 ---------------------------------------------------------------

uint32_t wspr_hashlittle(const uint8_t* key, uint64_t length,
                         uint32_t initval) {
  uint32_t a, b, c;
  a = b = c = 0xDEADBEEFu + static_cast<uint32_t>(length) + initval;

  while (length > 12) {
    a += key[0] | (uint32_t(key[1]) << 8) | (uint32_t(key[2]) << 16) |
         (uint32_t(key[3]) << 24);
    b += key[4] | (uint32_t(key[5]) << 8) | (uint32_t(key[6]) << 16) |
         (uint32_t(key[7]) << 24);
    c += key[8] | (uint32_t(key[9]) << 8) | (uint32_t(key[10]) << 16) |
         (uint32_t(key[11]) << 24);
    // mix
    a -= c; a ^= rot(c, 4);  c += b;
    b -= a; b ^= rot(a, 6);  a += c;
    c -= b; c ^= rot(b, 8);  b += a;
    a -= c; a ^= rot(c, 16); c += b;
    b -= a; b ^= rot(a, 19); a += c;
    c -= b; c ^= rot(b, 4);  b += a;
    key += 12;
    length -= 12;
  }

  if (length == 0) return c;
  uint32_t w[3] = {0, 0, 0};
  for (uint64_t i = 0; i < length; ++i) {
    w[i >> 2] |= uint32_t(key[i]) << (8 * (i & 3));
  }
  a += w[0];
  b += w[1];
  c += w[2];
  // final
  c ^= b; c -= rot(b, 14);
  a ^= c; a -= rot(c, 11);
  b ^= a; b -= rot(a, 25);
  c ^= b; c -= rot(b, 16);
  a ^= c; a -= rot(c, 4);
  b ^= a; b -= rot(a, 14);
  c ^= b; c -= rot(b, 24);
  return c;
}

uint32_t wspr_nhash(const char* callsign, uint64_t length) {
  return wspr_hashlittle(reinterpret_cast<const uint8_t*>(callsign), length,
                         146u) & 32767u;
}

// ---- convolutional encoder -------------------------------------------------

// data: 11 bytes MSB-first; emits nsym in {0,1,2,3} (2 bits per input
// bit): POLY1 parity in bit 1, POLY2 parity in bit 0.
void wspr_conv_encode(const uint8_t* data, uint8_t* symbols, int nsym) {
  uint32_t state = 0;
  int out = 0;
  for (int byte = 0; byte < 11 && out < nsym; ++byte) {
    for (int bit = 7; bit >= 0 && out < nsym; --bit) {
      state = (state << 1) | ((data[byte] >> bit) & 1);
      symbols[out++] = static_cast<uint8_t>(encode_sym(state));
    }
  }
}

// ---- sequential Fano decoder -----------------------------------------------

// symbols:    162 deinterleaved soft symbols (0..255)
// mettab:     int32[2*256], mettab[0]=row for tx bit 0, mettab[1] row 1
// delta:      threshold step
// maxcycles:  per-bit budget (total = maxcycles * 81)
// out_data:   uint8[11] decoded bytes (last always 0)
// out_cycles: cycle count, C semantics (success: break iter + 1;
//             timeout: total + 2)
// out_metric: final path metric
// out_maxnp:  deepest node index reached (the C's 'progress before
//             timeout' return, wsprd/fano.c:89,154: updated with the
//             CURRENT position at the top of every cycle)
// returns 1 on success, 0 on timeout.
int wspr_fano_decode(const uint8_t* symbols, const int32_t* mettab,
                     int32_t delta, uint32_t maxcycles, uint8_t* out_data,
                     uint32_t* out_cycles, int32_t* out_metric,
                     int32_t* out_maxnp) {
  // per-node branch metrics indexed by tx symbol (2 bits)
  int32_t met[kNBits][4];
  const int32_t* m0 = mettab;
  const int32_t* m1 = mettab + 256;
  for (int n = 0; n < kNBits; ++n) {
    const int s0 = symbols[2 * n];
    const int s1 = symbols[2 * n + 1];
    met[n][0] = m0[s0] + m0[s1];
    met[n][1] = m0[s0] + m1[s1];
    met[n][2] = m1[s0] + m0[s1];
    met[n][3] = m1[s0] + m1[s1];
  }

  // The walk below is this decoder's hot loop: a full-budget timeout
  // steps it maxcycles*81 ~= 810k times, the cost that dominates the
  // staged path's FEC phase on undecodable gate-passers. Two layout
  // choices bought a measured 1.6x (vs the memory-resident walk; same
  // automaton, bit-exact incl. cycle counts and maxnp):
  //  * the CURRENT node lives in registers; nd[pos] is written only on
  //    forward-leave, so the dominant fwd->fwd step never pays a
  //    store->load round trip (the search thrashes at the frontier:
  //    measured average forward run is ~1.3 moves, 44% of iterations
  //    are backtracks);
  //  * nodes are padded to 32 bytes (one shift for nd[pos], never
  //    straddling a cache line), and the threshold tighten is an add
  //    loop (quotient almost always 0/1) instead of an integer divide.
  // nd[k] for k < pos is always fresh (written when the walk last left
  // k moving forward; backtracking below a node abandons its state,
  // which the automaton never reads again before reinitializing it).
  struct alignas(32) Node {
    int32_t gamma;
    uint32_t enc;
    int32_t tm0, tm1;
    int32_t branch;
  };
  Node nd[kNBits + 1];
  int32_t cg, ctm0, ctm1, cbr;
  uint32_t cenc;

  // root: encoder output for the 0-branch of an all-zero state is
  // symbol 0; the complement branch sees symbol 3
  {
    const int32_t b0 = met[0][0];
    const int32_t b1 = met[0][3];
    cg = 0;
    cbr = 0;
    if (b0 > b1) {
      cenc = 0;
      ctm0 = b0;
      ctm1 = b1;
    } else {
      cenc = 1;
      ctm0 = b1;
      ctm1 = b0;
    }
  }

  int pos = 0;
  int32_t t = 0;
  int32_t maxnp = 0;
  const uint64_t max_total = uint64_t(maxcycles) * kNBits;

  for (uint64_t i = 1;; ++i) {
    maxnp = pos > maxnp ? pos : maxnp;  // cmov, no branch
    const int32_t ngamma = cg + (cbr ? ctm1 : ctm0);
    if (ngamma >= t) {
      // forward move; tighten threshold on first visits
      if (cg < t + delta) {
        while (ngamma >= t + delta) t += delta;
      }
      nd[pos].gamma = cg;
      nd[pos].enc = cenc;
      nd[pos].tm0 = ctm0;
      nd[pos].tm1 = ctm1;
      nd[pos].branch = cbr;
      const int newpos = pos + 1;
      const uint32_t enc_new = cenc << 1;
      if (newpos == kNBits) {
        const bool ok = i < max_total;
        *out_metric = ngamma;
        *out_cycles = static_cast<uint32_t>(i + 1);
        *out_maxnp = maxnp;
        for (int k = 0; k < 10; ++k) {
          out_data[k] = static_cast<uint8_t>(nd[7 + 8 * k].enc & 0xFF);
        }
        out_data[10] = 0;
        return ok ? 1 : 0;
      }
      const int lsym = encode_sym(enc_new);
      const int32_t b0 = met[newpos][lsym];
      const int32_t b1 = met[newpos][3 ^ lsym];
      cg = ngamma;
      if (newpos >= kTail) {
        cenc = enc_new;
        ctm0 = b0;  // tail explores only the 0-branch
      } else {
        // branchless ordering (cmov): best branch first; complement
        // encoded bit when the 1-branch wins (ties go to the 1-branch,
        // as in the reference)
        ctm0 = b0 > b1 ? b0 : b1;
        ctm1 = b0 > b1 ? b1 : b0;
        cenc = enc_new + (b0 <= b1);
      }
      cbr = 0;
      pos = newpos;
    } else {
      // backtrack walk
      for (;;) {
        if (pos == 0 || nd[pos - 1].gamma < t) {
          t -= delta;  // origin (or first visit below threshold): relax
          if (cbr != 0) {
            cbr = 0;
            cenc ^= 1;
          }
          break;
        }
        --pos;
        cg = nd[pos].gamma;
        cenc = nd[pos].enc;
        ctm0 = nd[pos].tm0;
        ctm1 = nd[pos].tm1;
        cbr = nd[pos].branch;
        if (pos < kTail && cbr != 1) {
          cbr += 1;
          cenc ^= 1;
          break;
        }
      }
    }
    if (i >= max_total) {
      *out_metric = cg;
      *out_cycles = static_cast<uint32_t>(max_total + 2);
      *out_maxnp = maxnp;
      std::memset(out_data, 0, 11);
      return 0;
    }
  }
}

// ---- ingest -----------------------------------------------------------------

// raw: n_pairs interleaved (I,Q) uint8 samples -> planar float32
// recentered by -128 (the reference's in-place XOR 0x80,
// rtlsdr_wsprd.c:158-182; the fs/4 mixer itself lives in the stage-1
// polyphase coefficients, frontend/filters.py).
void u8_deinterleave_center(const uint8_t* raw, uint64_t n_pairs,
                            float* out_i, float* out_q) {
  for (uint64_t k = 0; k < n_pairs; ++k) {
    out_i[k] = static_cast<float>(raw[2 * k]) - 128.0f;
    out_q[k] = static_cast<float>(raw[2 * k + 1]) - 128.0f;
  }
}

// raw: n_pairs interleaved (I,Q) uint8 -> planar uint8 (no centering:
// the production path ships raw bytes to the device at 1 B/sample and
// the stage-1 kernel centers there, frontend/decimate.py). One pass
// over the stream instead of numpy's two strided-copy passes.
void u8_deinterleave_pairs(const uint8_t* raw, uint64_t n_pairs,
                           uint8_t* out_i, uint8_t* out_q) {
  for (uint64_t k = 0; k < n_pairs; ++k) {
    out_i[k] = raw[2 * k];
    out_q[k] = raw[2 * k + 1];
  }
}

// ---- host-placed polyphase front end ---------------------------------------
//
// The front end runs wherever the raw byte stream is cheapest to
// deliver (frontend/host_decimate.py): on-device by default (raw
// uint8 at 1 B/sample), on-host for link-constrained deployments
// (--frontend host) — then only 375 sps
// float32 baseband crosses the link (~3 KB/s/channel, 1600x fewer
// bytes than raw). Same math as the device kernel (_polyphase_pp,
// frontend/decimate.py) and the reference's CIC+FIR chain
// (rtlsdr_wsprd.c:184-234): one output per R inputs,
//
//   yI[m] = sum_k xI[mR+k]*gr[k] - xQ[mR+k]*gi[k]
//   yQ[m] = sum_k xI[mR+k]*gi[k] + xQ[mR+k]*gr[k]
//
// with conv-ordered taps (frontend/filters.py conv_order). Inputs are
// length n_frames*R + taps - R.

void wspr_pp_decimate_f32(const float* xI, const float* xQ,
                          const float* gr, const float* gi,
                          int64_t taps, int64_t R, int64_t n_frames,
                          float* yI, float* yQ) {
  int64_t m = 0;
  for (; m + 2 <= n_frames; m += 2) {
    pp_dot_x2(xI + m * R, xQ + m * R, gr, gi, taps, R, yI + m, yQ + m);
  }
  for (; m < n_frames; ++m) {
    pp_dot(xI + m * R, xQ + m * R, gr, gi, taps, 0.0f, yI + m, yQ + m);
  }
}

// uint8 variant (stage 1 from raw RTL bytes): centers by -128 (the
// reference's XOR 0x80, rtlsdr_wsprd.c:171). Each input sample feeds
// taps/R (= 8) overlapping frames, so the bytes are converted ONCE —
// but in cache-sized TILES consumed immediately by the dots, not as a
// monolithic pre-pass that round-trips ~19 MB/window through DRAM
// between conversion and use (tiling measured ~1.4x over the
// monolithic pre-pass, ~3.5x over converting inside the dot;
// native/bench_pp.cpp).
void wspr_pp_decimate_u8(const uint8_t* xI, const uint8_t* xQ,
                         const float* gr, const float* gi,
                         int64_t taps, int64_t R, int64_t n_frames,
                         float* yI, float* yQ) {
  constexpr int64_t kTileFrames = 256;  // 256*80*4B*2 planes ~ 164 KB in L2
  const int64_t tile_in = kTileFrames * R + taps - R;
  float* fI = new float[2 * tile_in];
  float* fQ = fI + tile_in;
  for (int64_t m0 = 0; m0 < n_frames; m0 += kTileFrames) {
    const int64_t mn = std::min<int64_t>(kTileFrames, n_frames - m0);
    const int64_t need = mn * R + taps - R;
    const uint8_t* bi = xI + m0 * R;
    const uint8_t* bq = xQ + m0 * R;
    for (int64_t k = 0; k < need; ++k) {
      fI[k] = static_cast<float>(bi[k]) - 128.0f;
      fQ[k] = static_cast<float>(bq[k]) - 128.0f;
    }
    int64_t m = 0;
    for (; m + 2 <= mn; m += 2) {
      pp_dot_x2(fI + m * R, fQ + m * R, gr, gi, taps, R, yI + m0 + m,
                yQ + m0 + m);
    }
    for (; m < mn; ++m) {
      pp_dot(fI + m * R, fQ + m * R, gr, gi, taps, 0.0f, &yI[m0 + m],
             &yQ[m0 + m]);
    }
  }
  delete[] fI;
}

// real-tap variant (stage 2: stage2_coeffs is real): both planes
// filtered by the same taps. 32 accumulator lanes per plane (2400 %
// 32 == 0): only 2 banks exist here, so the extra width supplies the
// independent FMA chains the complex kernel gets from its 4 banks
// (kW=16 -> kW=32 measured ~12x on this loop; native/bench_pp.cpp).
void wspr_fir_decimate_f32(const float* xI, const float* xQ,
                           const float* g, int64_t taps, int64_t R,
                           int64_t n_frames, float* yI, float* yQ) {
  constexpr int kWF = 32;
  for (int64_t m = 0; m < n_frames; ++m) {
    const float* bi = xI + m * R;
    const float* bq = xQ + m * R;
    float aI[kWF] = {0}, aQ[kWF] = {0};
    int64_t k = 0;
    for (; k + kWF <= taps; k += kWF) {
      for (int j = 0; j < kWF; ++j) {
        aI[j] += bi[k + j] * g[k + j];
        aQ[j] += bq[k + j] * g[k + j];
      }
    }
    float ai = 0.0f, aq = 0.0f;
    for (; k < taps; ++k) {
      ai += bi[k] * g[k];
      aq += bq[k] * g[k];
    }
    for (int j = 0; j < kWF; ++j) {
      ai += aI[j];
      aq += aQ[j];
    }
    yI[m] = ai;
    yQ[m] = aq;
  }
}

// float32 -> int8/int16 sample quantization for the host->device
// transfer path (parallel/multichannel.py _DeviceWindows): round to
// nearest (ties to even, matching numpy rint), clamp to +/-lim,
// NaN -> 0. One vectorizable pass instead of numpy's four temporaries.
void f32_quantize_i8(const float* x, uint64_t n, float scale,
                     int8_t* out) {
  for (uint64_t k = 0; k < n; ++k) {
    float v = x[k] * scale;
    v = (v == v) ? v : 0.0f;  // NaN -> 0 before clamping
    v = std::nearbyintf(v);
    v = std::fmin(std::fmax(v, -127.0f), 127.0f);
    out[k] = static_cast<int8_t>(v);
  }
}

void f32_quantize_i16(const float* x, uint64_t n, float scale,
                      int16_t* out) {
  for (uint64_t k = 0; k < n; ++k) {
    float v = x[k] * scale;
    v = (v == v) ? v : 0.0f;
    v = std::nearbyintf(v);
    v = std::fmin(std::fmax(v, -32767.0f), 32767.0f);
    out[k] = static_cast<int16_t>(v);
  }
}

}  // extern "C"
