// Minimizer front end for Hopper (sm_90a).
//
// Replaces the TPU kernel finito_tpu/ops/pallas_min.py::
// minimizer_windows_pallas (body _front_kernel), which fuses the JAX
// engine's minimizer_scan + pack_query_windows
// (finito_tpu/query/minimizer_engine.py). For every k-window of every
// row of a (B, L) uint8 code batch it writes
//   best_v  (B, W) uint32  value of the leftmost m-mer of lowest mix32
//                          hash (2-bit packed, first base most
//                          significant, masked to min(2m, 32) bits, so
//                          for m > 16 only the last 16 bases survive)
//   best_o  (B, W) int32   offset of that m-mer inside the window
//   bad     (B, W) uint8   1 when any code of the window is > 3
//   q_words (NW, B, W) uint32, NW = ceil(2k/32): the window packed at 2
//                          bits per base, least-significant base first
//                          (base i at bits [2i, 2i+2) of word i/16)
// with W = L - k + 1. Pad and non-ACGT codes (> 3) enter the packs as
// (c & 3), exactly like the JAX forms, so bad windows agree bit for bit.
//
// What bounds it on the H100: bytes. A window writes (3 + NW) * 4 - 3
// bytes (best_v, best_o and NW q-words of 4, bad of 1: 17 at k = 31) and
// reads 1 byte of codes; at (8192, 128, 31, 16) that is 14.70 MB, 4.4 us
// at 3.35 TB/s. The design keeps the arithmetic and the shared-memory
// traffic near that:
//   * per-position work once, as the TPU kernel does it. A block reads
//     its span of codes (its first window's start to its last window's
//     end, the k-1 halo of every row included) with 16-byte loads on the
//     16-byte grid of the address space, so the unaligned head and tail
//     cost nothing but a few wasted bytes, and builds in shared memory,
//     once per position: the span packed 2 bits per base both ways (one
//     word per 16 codes), a bitmask of codes > 3 with its running count,
//     and the m-mer value (one funnel shift of two packed words) with its
//     mix32 hash;
//   * a thread takes G consecutive windows of one row at a time (G = 4
//     when 4 divides W, else 2 when 2 does, else 1): their minima share
//     the middle R - G + 1 hashes (the strict-< leftmost minimum, in
//     position order), bad is two reads of the count per window, and
//     each q-word is two packed words and one __funnelshift_r;
//   * a group never straddles a row end, so no lane takes a scalar path
//     at a row end and a warp writes 32 * G consecutive elements of each
//     output plane in 4G-byte stores;
//   * 32-bit window and row arithmetic: each thread divides once, for its
//     first group, and steps by the quotient and remainder of the block
//     width that the host divides out (the wrapper refuses B * L >= 2^31);
//   * blocks of 256 threads, two groups each, take about 12 KB of shared
//     memory at the main path's shape, so eight blocks fit on an SM;
//     shapes whose span outgrows the 96 KB budget (W near 1) shrink the
//     block, and a block goes past 48 KB only through
//     cudaFuncAttributeMaxDynamicSharedMemorySize.
// What holds it above the bound (PERF.md): a fixed cost per launch and
// block (the per-position phase behind three barriers, little overlap of
// a block's loads with its arithmetic), the minimum over R hashes, and,
// at W not divisible by 4, the smaller groups.
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr uint32_t kMix32 = 0x9E3779B1u;  // index.minimizer._MIX
constexpr long long kSmemDefault = 48 * 1024;
constexpr long long kSmemBudget = 96 * 1024;  // two blocks still fit on an SM
// launch shape: threads per block and window groups per thread (launch
// shapes of 128 to 1,024 windows per block time alike at the main shape)
constexpr int kThreads = 256;
constexpr int kGroupsPerThread = 2;

__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  return (v * kMix32) ^ (v >> 16);
}

// four codes, one per byte -> 8 bits, code i at bits [2i, 2i+2), as (c & 3)
__device__ __forceinline__ uint32_t pack4(uint32_t u) {
  u &= 0x03030303u;
  u = (u | (u >> 6)) & 0x000F000Fu;
  return (u | (u >> 12)) & 0xFFu;
}

// four codes, one per byte -> 4 bits, bit i set when code i is > 3
__device__ __forceinline__ uint32_t bad4(uint32_t u) {
  u = __vcmpgtu4(u, 0x03030303u) & 0x01010101u;
  u = (u | (u >> 7)) & 0x00030003u;
  return (u | (u >> 14)) & 0xFu;
}

// strict <: of equal hashes the earlier position stays
__device__ __forceinline__ void take(uint32_t h, int p, uint32_t& h_best, int& p_best) {
  if (h < h_best) {
    h_best = h;
    p_best = p;
  }
}

// codes > 3 before position q: word j of s_bad holds the count before
// chunk j (high half) and chunk j's bitmask (low half)
__device__ __forceinline__ uint32_t bad_before(const uint32_t* s_bad, int q) {
  const uint32_t w = s_bad[q >> 4];
  return (w >> 16) + __popc(w & ((1u << (q & 15)) - 1u));
}

// Shared memory of a block with n 16-code chunks (q = the position in the
// staged chunks, the span's first code at q = head):
//   pack   n + 2 words   codes [16j, 16j + 16) at 2 bits each, first code
//                        least significant; two zero pads
//   packm  n + 1 words   the same, first code most significant; zero pad
//   bad    n + 1 words   codes > 3 before chunk j << 16 | chunk j's mask
//   hash   16n words     mix32 of the m-mer value at q
//   mval   16n words     the m-mer value at q
__host__ __device__ constexpr long long smem_bytes(long long n) {
  return 4 * (3 * n + 4) + 2 * 4 * 16 * n;
}

struct Out {
  uint32_t* best_v;
  int32_t* best_o;
  uint8_t* bad;
  uint32_t* q_words;
};

template <int G> struct Vec;  // G consecutive elements as one store
template <> struct Vec<4> { using u32 = uint4; using i32 = int4; using u8 = uint32_t; };
template <> struct Vec<2> { using u32 = uint2; using i32 = int2; using u8 = uint16_t; };
template <> struct Vec<1> { using u32 = uint32_t; using i32 = int32_t; using u8 = uint8_t; };

// G values to plane[f .. f + G) in one store (f is a multiple of G)
template <typename V, typename T, int G>
__device__ __forceinline__ void store(T* plane, unsigned f, const T (&x)[G]) {
  V v;
  memcpy(&v, x, sizeof(v));
  *reinterpret_cast<V*>(plane + f) = v;
}

// G (1, 2 or 4, a divisor of W) consecutive windows of one row per
// thread and step: they share the middle R - G + 1 hashes of their
// minimum, and a warp stores 32 * G consecutive elements of each plane
template <int G>
__global__ void __launch_bounds__(256)
minimizer_front_kernel(const uint8_t* __restrict__ codes, unsigned BL,
                       unsigned L, unsigned Wg, unsigned n_groups,
                       unsigned BW, int k, int m, int n_words, int wpt, int n,
                       unsigned row_step, unsigned grp_step, Out out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ unsigned s_row0;
  uint32_t* s_pack = smem;
  uint32_t* s_packm = s_pack + n + 2;
  uint32_t* s_bad = s_packm + n + 1;
  uint32_t* s_hash = s_bad + n + 1;
  uint32_t* s_mval = s_hash + 16 * n;

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  // group v holds windows G * v .. G * v + G - 1, in row v / Wg
  const unsigned v0 = blockIdx.x * (unsigned)(threads * wpt);
  unsigned v = v0 + tid;
  unsigned row = v / Wg;  // the one division of this thread
  unsigned grp = v - row * Wg;
  if (tid == 0) s_row0 = row;
  __syncthreads();
  const unsigned span0 = s_row0 * L + G * (v0 - s_row0 * Wg);  // flat code index

  // 16-byte chunks of the 16-byte address grid, packed as they arrive;
  // bytes outside the buffer read as 0
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const uintptr_t end = base + BL;
  const uintptr_t a0 = (base + span0) & ~static_cast<uintptr_t>(15);
  const int head = static_cast<int>((base + span0) & 15);
  for (int c = tid; c < n; c += threads) {
    const uintptr_t a = a0 + 16 * (uintptr_t)c;
    uint4 x;
    if (a >= base && a + 16 <= end) {
      x = __ldg(reinterpret_cast<const uint4*>(a));
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      for (int i = 0; i < 16; ++i) {
        if (a + i >= base && a + i < end) {
          w[i >> 2] |= (uint32_t)*reinterpret_cast<const uint8_t*>(a + i) << (8 * (i & 3));
        }
      }
      x = make_uint4(w[0], w[1], w[2], w[3]);
    }
    s_pack[c] = pack4(x.x) | pack4(x.y) << 8 | pack4(x.z) << 16 | pack4(x.w) << 24;
    s_packm[c] = pack4(__byte_perm(x.x, 0, 0x0123)) << 24 | pack4(__byte_perm(x.y, 0, 0x0123)) << 16 |
                 pack4(__byte_perm(x.z, 0, 0x0123)) << 8 | pack4(__byte_perm(x.w, 0, 0x0123));
    s_bad[c] = bad4(x.x) | bad4(x.y) << 4 | bad4(x.z) << 8 | bad4(x.w) << 12;
  }
  if (tid == 0) {
    s_pack[n] = s_pack[n + 1] = s_packm[n] = s_bad[n] = 0;
  }
  __syncthreads();

  // running count of codes > 3: one warp scans the n + 1 chunk masks
  if (tid < 32) {
    const int per = (n + 1 + 31) / 32;
    const int j0 = min(tid * per, n + 1);
    const int j1 = min(j0 + per, n + 1);
    uint32_t sum = 0;
    for (int j = j0; j < j1; ++j) sum += __popc(s_bad[j]);
    uint32_t incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (tid >= d) incl += t;
    }
    uint32_t run = incl - sum;
    for (int j = j0; j < j1; ++j) {
      const uint32_t mask = s_bad[j];
      s_bad[j] = run << 16 | mask;
      run += __popc(mask);
    }
  }
  // m-mer value and hash once per position: the 16 codes from q' = q +
  // max(m - 16, 0) on, first code most significant, cut to m codes
  const int mshift = m > 16 ? m - 16 : 0;
  const int vshift = m >= 16 ? 0 : 32 - 2 * m;
  for (int q = tid; q < 16 * n; q += threads) {
    const int qq = q + mshift;
    const int j = qq >> 4;
    if (j >= n) continue;  // no window reads this position
    const uint32_t x = __funnelshift_l(s_packm[j + 1], s_packm[j], 2 * (qq & 15)) >> vshift;
    s_mval[q] = x;
    s_hash[q] = mix32(x);
  }
  __syncthreads();

  const int R = k - m + 1;
  const int rem = k - 16 * (n_words - 1);
  const uint32_t last_mask = rem == 16 ? 0xFFFFFFFFu : (1u << (2 * rem)) - 1u;
  const unsigned v_end = min(v0 + (unsigned)(threads * wpt), n_groups);
  for (int i = 0; i < wpt && v < v_end; ++i) {
    // the group's first window: its first code at q = s, its output at f
    const int s = (int)(head + row * L + G * grp - span0);
    const unsigned f = G * v;
    uint32_t hb[G];
    int pb[G];
    if (R >= G) {
      // the middle [s + G - 1, s + R) once; then, in position order, the
      // hashes before it (a) and after it (z) that each window also covers
      uint32_t hm = s_hash[s + G - 1];
      int pm = G - 1;
      for (int r = G; r < R; ++r) take(s_hash[s + r], r, hm, pm);
      uint32_t a[G], z[G];
#pragma unroll
      for (int t = 0; t + 1 < G; ++t) a[t] = s_hash[s + t], z[t] = s_hash[s + R + t];
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (t + 1 < G) {
          hb[t] = a[t], pb[t] = t;
#pragma unroll
          for (int u = t + 1; u + 1 < G; ++u) take(a[u], u, hb[t], pb[t]);
          take(hm, pm, hb[t], pb[t]);
        } else {
          hb[t] = hm, pb[t] = pm;
        }
#pragma unroll
        for (int u = 0; u < t; ++u) take(z[u], R + u, hb[t], pb[t]);
      }
    } else {
#pragma unroll
      for (int t = 0; t < G; ++t) {
        hb[t] = s_hash[s + t], pb[t] = t;
        for (int r = 1; r < R; ++r) take(s_hash[s + t + r], t + r, hb[t], pb[t]);
      }
    }
    uint32_t bv[G];
    int32_t bo[G];
    uint8_t bd[G];
#pragma unroll
    for (int t = 0; t < G; ++t) bv[t] = s_mval[s + pb[t]], bo[t] = pb[t] - t, bd[t] = 0;
    store<typename Vec<G>::u32>(out.best_v, f, bv);
    store<typename Vec<G>::i32>(out.best_o, f, bo);
    if (bad_before(s_bad, s + k + G - 1) != bad_before(s_bad, s)) {
#pragma unroll
      for (int t = 0; t < G; ++t) bd[t] = bad_before(s_bad, s + t + k) != bad_before(s_bad, s + t);
    }
    store<typename Vec<G>::u8>(out.bad, f, bd);
    const int j = s >> 4;
    const int b = s & 15;
    for (int w = 0; w < n_words; ++w) {
      const uint32_t p0 = s_pack[j + w], p1 = s_pack[j + w + 1];
      uint32_t x[G];
#pragma unroll
      for (int t = 0; t < G; ++t) {
        x[t] = b + t < 16 ? __funnelshift_r(p0, p1, 2 * (b + t))
                          : __funnelshift_r(p1, s_pack[j + w + 2], 2 * (b + t - 16));
        if (w == n_words - 1) x[t] &= last_mask;
      }
      store<typename Vec<G>::u32>(out.q_words + (size_t)w * BW, f, x);
    }
    v += threads;
    row += row_step;
    grp += grp_step;
    if (grp >= Wg) {
      grp -= Wg;
      ++row;
    }
  }
}

template <int G>
int launch(const uint8_t* codes, long long B, long long L, int k, int m, Out out,
           cudaStream_t stream) {
  const long long W = L - k + 1;
  const long long Wg = W / G;
  const int n_words = (2 * k + 31) / 32;
  int threads = kThreads, wpt = kGroupsPerThread;
  long long n = 0, smem = 0;
  for (;;) {
    const long long groups = (long long)threads * wpt;
    // a block's groups cross at most ceil((groups - 1) / Wg) row ends
    const long long span = G * groups - 1 + (groups - 1 + Wg - 1) / Wg * (k - 1) + k;
    n = (15 + span + 15) / 16;
    smem = smem_bytes(n);
    if (smem <= kSmemBudget) break;
    if (wpt > 1) {
      wpt /= 2;
    } else if (threads > 32) {
      threads /= 2;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        minimizer_front_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_groups = B * Wg;
  const long long per_block = (long long)threads * wpt;
  const long long blocks = (n_groups + per_block - 1) / per_block;
  minimizer_front_kernel<G><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
      codes, (unsigned)(B * L), (unsigned)L, (unsigned)Wg, (unsigned)n_groups,
      (unsigned)(B * W), k, m, n_words, wpt, (int)n, (unsigned)(threads / Wg),
      (unsigned)(threads % Wg), out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream, passed as a handle)
// and returns cudaGetLastError(); the caller raises when it is not 0. The
// group is 4 windows when 4 divides W, else 2 when 2 does, else 1, and
// smaller where a plane is not on the grid of its stores.
extern "C" int fin_minimizer_windows(const void* codes, long long B,
                                     long long L, int k, int m,
                                     void* best_v, void* best_o, void* bad,
                                     void* q_words, void* stream) {
  const long long W = L - k + 1;
  if (B <= 0 || W <= 0 || m < 1 || m > k || B * L >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto on_grid = [&](int g) {
    const auto at = [](const void* p, uintptr_t a) {
      return reinterpret_cast<uintptr_t>(p) % a == 0;
    };
    return W % g == 0 && at(best_v, 4 * g) && at(best_o, 4 * g) &&
           at(q_words, 4 * g) && at(bad, g);
  };
  const Out out{(uint32_t*)best_v, (int32_t*)best_o, (uint8_t*)bad, (uint32_t*)q_words};
  const auto* c = (const uint8_t*)codes;
  const auto st = (cudaStream_t)stream;
  if (on_grid(4)) return launch<4>(c, B, L, k, m, out, st);
  if (on_grid(2)) return launch<2>(c, B, L, k, m, out, st);
  return launch<1>(c, B, L, k, m, out, st);
}
