// Minimizer front end for Hopper (sm_90a): one thread per k-window.
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
// What bounds it on the H100: bytes written. A window costs
// (3 + NW) * 4 bytes of output (17 with bad stored as one byte, at k=31)
// against 1 byte of input, and about k shared-memory reads and R = k-m+1
// hashes of ALU work, which the SMs hide under the stores. So the design
// keeps every store coalesced and reads each code from device memory
// once per block:
//   * windows are numbered flat, g = b * W + w, and thread g writes
//     element g of every output plane: a warp stores 32 consecutive
//     words whatever W is, with no idle lanes at a row's ragged end
//     (W = 98 on the main path would idle 30 of 128 lanes per row in a
//     row-per-block layout);
//   * the block's windows occupy one contiguous span of the flat code
//     array (its first window's start to its last window's end, the
//     k-1 halo included), staged in shared memory with coalesced loads,
//     so rows of any length work: a block's span is at most
//     T - 1 + ceil((T - 1) / W + 1) * (k - 1) + k bytes, and the
//     launcher halves T until that fits in 48 KB;
//   * the m-mer is packed as a rolling value, one shift-or per base, and
//     the leftmost minimum comes from a strict < on the unsigned hash.
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMix32 = 0x9E3779B1u;  // index.minimizer._MIX
constexpr int kMaxThreads = 256;
constexpr long long kSmemBytes = 48 * 1024;

__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  return (v * kMix32) ^ (v >> 16);
}

__global__ void minimizer_front_kernel(const uint8_t* __restrict__ codes,
                                       long long L, long long W, long long BW,
                                       int k, int m, int n_words,
                                       uint32_t* __restrict__ best_v,
                                       int32_t* __restrict__ best_o,
                                       uint8_t* __restrict__ bad,
                                       uint32_t* __restrict__ q_words) {
  extern __shared__ uint8_t span[];
  const long long g0 = (long long)blockIdx.x * blockDim.x;
  const long long g_last = min(g0 + (long long)blockDim.x, BW) - 1;
  const long long span0 = (g0 / W) * L + g0 % W;
  const long long span1 = (g_last / W) * L + g_last % W + k;
  for (long long i = threadIdx.x; i < span1 - span0; i += blockDim.x) {
    span[i] = codes[span0 + i];
  }
  __syncthreads();

  const long long g = g0 + threadIdx.x;
  if (g >= BW) return;
  const uint8_t* s = span + ((g / W) * L + g % W - span0);

  const uint32_t mmask = m >= 16 ? 0xFFFFFFFFu : ((1u << (2 * m)) - 1u);
  uint32_t mv = 0;
  bool any_bad = false;
  for (int i = 0; i < m - 1; ++i) {
    const uint32_t c = s[i];
    mv = (mv << 2) | (c & 3u);
    any_bad |= c > 3u;
  }
  uint32_t v_best = 0, h_best = 0;
  int o_best = 0;
  for (int r = 0; r <= k - m; ++r) {
    const uint32_t c = s[r + m - 1];
    mv = ((mv << 2) | (c & 3u)) & mmask;
    any_bad |= c > 3u;
    const uint32_t h = mix32(mv);
    if (r == 0 || h < h_best) {  // strict: ties keep the leftmost
      h_best = h;
      v_best = mv;
      o_best = r;
    }
  }
  best_v[g] = v_best;
  best_o[g] = o_best;
  bad[g] = any_bad ? 1 : 0;

  for (int w = 0; w < n_words; ++w) {
    const int i0 = 16 * w;
    const int n = min(16, k - i0);
    uint32_t q = 0;
    for (int i = 0; i < n; ++i) {
      q |= ((uint32_t)s[i0 + i] & 3u) << (2 * i);
    }
    q_words[(long long)w * BW + g] = q;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream, passed as a handle) and
// returns cudaGetLastError(); the caller raises when it is not 0.
extern "C" int fin_minimizer_windows(const void* codes, long long B,
                                     long long L, int k, int m,
                                     void* best_v, void* best_o, void* bad,
                                     void* q_words, void* stream) {
  const long long W = L - k + 1;
  const long long BW = B * W;
  if (B <= 0 || W <= 0 || m < 1 || m > k) return (int)cudaErrorInvalidValue;
  const int n_words = (2 * k + 31) / 32;
  int threads = kMaxThreads;
  long long smem = 0;
  for (;;) {
    const long long rows = (threads - 1 + W - 1) / W + 1;
    smem = threads - 1 + rows * (k - 1) + k;
    if (smem <= kSmemBytes || threads == 32) break;
    threads /= 2;
  }
  if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
  const long long blocks = (BW + threads - 1) / threads;
  minimizer_front_kernel<<<(unsigned int)blocks, threads, (size_t)smem,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)codes, L, W, BW, k, m, n_words, (uint32_t*)best_v,
      (int32_t*)best_o, (uint8_t*)bad, (uint32_t*)q_words);
  return (int)cudaGetLastError();
}
