// Optimistic chain scan of the stream and replica engines (phase A of
// the two-phase rank pipeline) for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's chain
// (finito_tpu/ops/streaming.py make_chain_opt) is a lax.scan, which XLA
// runs as one loop on the device; its plain PyTorch form
// (ops/streaming.py make_chain_opt_ref) is a Python loop of L steps of
// ~70 small ATen ops each, and that per-step dispatch is the largest host
// cost of the stream and replica engines. This kernel is the whole loop
// in one launch.
//
// One thread per lane (a row of codes) walks the row's L positions with
// the automaton state in registers (lo, hi, ks, x, lastfail) and writes,
// exactly as the plain loop does,
//   emit      (B, L) int32
//   cand      (B, L) int32
//   untrusted (B, L) uint8 (torch.bool)
// for both edge forms (AUG: the state takes xe_raw & 0xFFFFFF, cand the
// raw entry) and both rank24 forms (WIDE: [rank, byte] rows, past 2^24
// nodes). Codes > 3 (pad 255, N) are invalid positions, as there.
//
// What bounds it on the H100: load latency. Step j of a lane needs the
// state step j-1 left, so a lane is L dependent gathers: the forward edge
// of a mature lane, the two rank24 entries of an immature one. A step
// issues its three loads together, on clamped addresses as the plain
// version computes them (a lane uses either the edge or the two ranks,
// and the other loads hit a few cached lines: edge[0], the entries of
// ranks 0 and n), so a warp whose lanes are in both modes still waits one
// latency a step, not two; the next code is loaded a step ahead. The
// bytes, 10 a position (1 in, 9 out), are 21 MB at (8192, 256): 6 us at
// 3.35 TB/s, far under L load latencies, so the stores stay plain
// per-lane stores. Blocks are small (64 lanes) so that a chunk's 8,192
// lanes spread over all the SMs.
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rank24.cuh"

namespace {

using fin::Cs;
using fin::rank24;

constexpr int kThreads = 64;

struct Tables {
  const int32_t* tab;   // rank24: flat (4 * n8,) or wide (4 * n8, 2) [rank, byte]
  const int32_t* edge;  // (4 * n_nodes,) forward edges, -1 where absent
  const int32_t* C;     // C[0..3] of the SBWT
  long long n8;
  long long n_nodes;
};

struct Grids {
  int32_t* emit;
  int32_t* cand;
  uint8_t* untrusted;
};

struct Lane {
  long long lo, hi, x;
  int ks, lastfail;
};

// one position j of one lane: the plain loop's step, value for value
template <bool AUG, bool WIDE>
__device__ __forceinline__ void step(const Tables& t, const Cs& C, int k, int j, uint32_t c, Lane& s,
                                     int32_t& emit, int32_t& cand, uint8_t& untr) {
  const bool invalid = c > 3;
  const bool em = s.x >= 0;  // mature: x = node of the k-mer ending at j-1
  const int cs = invalid ? 0 : static_cast<int>(c);
  // the step's three loads, on addresses that depend only on the state
  // the last step left, so they are in flight together
  const int32_t xe_raw = __ldg(t.edge + ((em && !invalid) ? s.x * 4 + cs : 0));
  const long long base = cs * t.n8;
  long long nlo = C[cs] + rank24<WIDE>(t.tab, base, invalid ? 0 : s.lo);
  long long nhi = C[cs] + rank24<WIDE>(t.tab, base, (invalid ? 0 : s.hi) + 1) - 1;

  const bool e_found = em && !invalid && xe_raw >= 0;
  const long long xe = AUG ? (xe_raw & 0xFFFFFF) : xe_raw;
  if (invalid || nlo > nhi) nlo = nhi = -1;
  const bool failed = invalid || nlo < 0;
  const bool mature = s.ks == j - k + 1;
  const bool close = !em && !failed && mature;
  const long long emit_i =
      invalid ? -1 : (close ? nlo : ((failed && mature) ? -1 : -2));
  emit = static_cast<int32_t>(em ? (e_found ? xe : -1) : emit_i);
  const bool single = !failed && nlo == nhi;
  cand = static_cast<int32_t>(em ? (e_found ? static_cast<long long>(xe_raw) : -1)
                                 : (single ? nlo : -1));
  const bool any_fail = em ? !e_found : failed;
  if (any_fail) s.lastfail = j;
  untr = j - k <= s.lastfail;

  s.x = e_found ? xe : (close ? nlo : -1);
  s.lo = (failed || em) ? 0 : nlo;
  s.hi = (failed || em) ? t.n_nodes - 1 : nhi;
  s.ks = any_fail ? j + 1 : ((em || close) ? j - k + 2 : s.ks);
}

template <bool AUG, bool WIDE>
__global__ void __launch_bounds__(kThreads)
chain_opt_kernel(const uint8_t* __restrict__ codes, int B, int L, int k, Tables t, Grids g) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t row = static_cast<size_t>(b) * L;
  const Cs C = Cs::load(t.C);
  Lane s{0, t.n_nodes - 1, -1, 0, -(k + 2)};
  uint32_t next = __ldg(codes + row);
  for (int j = 0; j < L; ++j) {
    const uint32_t c = next;
    if (j + 1 < L) next = __ldg(codes + row + j + 1);
    step<AUG, WIDE>(t, C, k, j, c, s, g.emit[row + j], g.cand[row + j], g.untrusted[row + j]);
  }
}

template <bool AUG, bool WIDE>
int launch(const uint8_t* codes, int B, int L, int k, const Tables& t, const Grids& g,
           cudaStream_t stream) {
  const unsigned blocks = (B + kThreads - 1) / kThreads;
  chain_opt_kernel<AUG, WIDE><<<blocks, kThreads, 0, stream>>>(codes, B, L, k, t, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream, passed as a handle)
// and returns cudaGetLastError(); the caller raises when it is not 0.
// tab is wide (its rows [rank, byte]) when `wide` is not 0; C holds at
// least 4 int32.
extern "C" int fin_chain_opt(const void* codes, long long B, long long L, int k,
                             const void* tab, int wide, long long n8, const void* C,
                             const void* edge, long long n_nodes, int aug, void* emit,
                             void* cand, void* untrusted, void* stream) {
  if (B <= 0 || L <= 0 || B * L >= (1LL << 31) || k < 1 || n8 < 1 || n_nodes < 1 ||
      (wide && reinterpret_cast<uintptr_t>(tab) % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tables t{static_cast<const int32_t*>(tab), static_cast<const int32_t*>(edge),
                 static_cast<const int32_t*>(C), n8, n_nodes};
  const Grids g{static_cast<int32_t*>(emit), static_cast<int32_t*>(cand),
                static_cast<uint8_t*>(untrusted)};
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), l = static_cast<int>(L);
  if (aug) {
    return wide ? launch<true, true>(c, b, l, k, t, g, st)
                : launch<true, false>(c, b, l, k, t, g, st);
  }
  return wide ? launch<false, true>(c, b, l, k, t, g, st)
              : launch<false, false>(c, b, l, k, t, g, st);
}
