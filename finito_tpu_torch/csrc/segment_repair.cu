// Segment repair of the stream and replica engines (phase B of the
// two-phase rank pipeline) for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's repair
// (finito_tpu/ops/streaming.py make_segment_repair) is a fixed-trip
// lax.scan and a lax.while_loop over the segment lanes, which XLA runs
// as one loop on the device; its plain PyTorch form (ops/streaming.py
// make_segment_repair_ref) runs that loop from Python, ~235 small ATen
// ops a trip and ~115 trips a (8192, 256) chunk, the last ~45 each behind
// a device-to-host read of "is any lane still active". That per-trip
// dispatch is the largest host cost of the stream and replica engines.
// This kernel is the whole loop in one launch.
//
// One thread per segment lane. The lane reads its split position from
// seg_idx (compact_mask's first K_seg set positions of the split mask,
// -1 past the count), seeds itself as the plain version does (from the
// trusted predecessor's contract_k interval at a run start past k, else
// from a k-1 preamble), then steps the reference's recovery state
// machine with its state in registers (j, ks, lo, hi, rec, wx, wy) until
// it retires: past its Q payload positions, or onto a trusted position.
// The plain loop takes T_c fixed trips and then straggler trips while any
// lane is active; per lane the steps are the same, lanes never read one
// another's state, and a retired lane changes nothing that is read after,
// so walking each lane to its end gives the same grids bit for bit.
// Segments cover disjoint positions (a split every Q positions of a run,
// a lane writes only below its p_end and never past a trusted position),
// so a lane writes its repaired emit and cand straight into the output
// grids at its own positions: the plain version's (K_seg, Q + 1) lane
// buffers and their final scatter have no counterpart. The caller passes
// the output grids as copies of the chain's (the inputs stay unchanged,
// as the plain version leaves them); the seed reads the input emit at
// p_start - 1, a trusted position no lane writes.
// Both edge forms (AUG: repaired cand in the augmented
// su << 25 | ustart << 24 | node form, one suu load) and both rank24
// forms (WIDE: [rank, byte] rows, past 2^24 nodes).
//
// What bounds it on the H100: load latency. A lane is a chain of
// dependent loads: a mature lane's step is its two rank24 entries, then
// contract_k (and suu) at the closed node, which the next step's rank
// entries need; a recovering lane adds two rounds of jl/jr hops before
// them. A step's independent loads go out together (the two hop sides;
// the two rank entries; contract_k, on a clamped address as the plain
// version computes it, with suu), a lane with no widen in progress skips
// the hop loads, and the next position's code and flag are loaded a step
// ahead. The bytes, a few KB of codes and ~9 B out per repaired position,
// are nothing beside the longest lane's ~115 steps of two to four
// dependent loads; blocks are small (64 lanes) so that a chunk's ~20-40 k
// lanes spread over all 132 SMs.
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rank24.cuh"

namespace {

using fin::Cs;
using fin::rank24;

constexpr int kThreads = 64;
// Trips a widen can take: the fail that starts it, then two hop rounds a
// trip on each side, whose LCS values fall strictly from at most 255. A
// widen shortens the suffix, which only an advance lengthens, so a lane
// takes at most (kTripsPerWiden + 1) * (its advances + k) trips: the
// loop's bound, which no lane reaches; it keeps a fault from spinning.
constexpr long long kTripsPerWiden = 130;

struct Tables {
  const int32_t* tab;   // rank24: flat (4 * n8,) or wide (4 * n8, 2) [rank, byte]
  const int32_t* C;     // C[0..3] of the SBWT
  const int2* ck;       // (n_nodes, 2) contract_k: the (k-1)-widening of [x, x]
  const uint32_t* jl;   // (n_nodes,) hop << 8 | LCS to the previous smaller LCS
  const uint32_t* jr;   // (n_nodes + 1,) hop << 8 | LCS to the next smaller LCS
  const int32_t* suu;   // (n_nodes,) su | ustart << 8 (AUG only)
  long long n8;
  long long n_nodes;
};

struct Inputs {
  const int32_t* seg_idx;    // (K_seg,) flat split positions, -1 past n_seg
  const uint8_t* codes;      // (B, L)
  const uint8_t* untrusted;  // (B, L) torch.bool
  const int32_t* emit;       // (B, L) the chain's emit (the seed's predecessor)
};

struct Grids {
  int32_t* emit;  // (B, L) copies of the chain's grids, repaired in place
  int32_t* cand;
};

// code | untrusted << 8 at flat position f
__device__ __forceinline__ uint32_t packed(const Inputs& in, long long f) {
  return static_cast<uint32_t>(__ldg(in.codes + f)) |
         (static_cast<uint32_t>(__ldg(in.untrusted + f)) << 8);
}

template <bool AUG, bool WIDE>
__global__ void __launch_bounds__(kThreads)
segment_repair_kernel(Inputs in, int K_seg, int L, int k, int Q, Tables t, Grids g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K_seg) return;
  const int f = __ldg(in.seg_idx + lane);
  if (f < 0) return;
  const long long n_nodes = t.n_nodes;
  const int b = f / L;
  const long long row = static_cast<long long>(b) * L;
  const int p_start = f - b * L;
  const int p_end = min(p_start + Q, L);

  // the seed: a run start at p_start >= k whose trusted predecessor was
  // found resumes from that node's post-close slide; every other segment
  // re-derives its context from a k-1 preamble
  const bool run_start = p_start == 0 || __ldg(in.untrusted + f - 1) == 0;
  const long long x_prev = (run_start && p_start >= k) ? __ldg(in.emit + f - 1) : -1;
  const bool fastl = x_prev >= 0;
  int j = fastl ? p_start : max(p_start - (k - 1), 0);
  int ks = fastl ? p_start - k + 1 : j;
  long long lo = 0, hi = n_nodes - 1;
  if (fastl) {
    const int2 pair0 = __ldg(t.ck + x_prev);
    lo = pair0.x;
    hi = pair0.y;
  }
  int rec = 0;  // 0 none, 1 fresh drop, 2 hopping
  long long wx = 0, wy = 0;

  const Cs C = Cs::load(t.C);
  const long long max_trips = (kTripsPerWiden + 1) * (p_end - j + k);
  uint32_t cur = packed(in, row + j);
  uint32_t next = j + 1 < L ? packed(in, row + j + 1) : 0;
  for (long long trip = 0; trip < max_trips; ++trip) {
    // retire past the payload or onto a trusted position (recovering
    // lanes sit on untrusted ones)
    if (j >= p_end || (j > p_start && cur < 256)) break;
    const uint32_t c = cur & 0xFF;
    const bool invalid = c > 3;

    // --- recovery: plateau-jump drops + LCS-widening hops, two hop
    // rounds a trip (a deeper widen stalls its lane a trip)
    long long nlen = j - ks, ks_h = ks, x = wx, y = wy;
    long long lo_c = lo, hi_c = hi;
    bool still = false;
    if (rec > 0) {
      const uint32_t el0 = __ldg(t.jl + wx), er0 = __ldg(t.jr + wy);
      const long long lcsL = el0 & 0xFF, lcsR = er0 & 0xFF;
      if (rec == 1) {
        nlen = max(lcsL, lcsR);
        ks_h = j - nlen;
      }
      bool hl = wx > 0 && lcsL >= nlen;
      bool hr = wy < n_nodes && lcsR >= nlen;
      if (hl) x = wx - (el0 >> 8);
      if (hr) y = wy + (er0 >> 8);
      const uint32_t el = __ldg(t.jl + x), er = __ldg(t.jr + y);
      hl = x > 0 && static_cast<long long>(el & 0xFF) >= nlen;
      hr = y < n_nodes && static_cast<long long>(er & 0xFF) >= nlen;
      if (hl) x -= el >> 8;
      if (hr) y += er >> 8;
      const bool zero_len = nlen <= 0;  // widen to the empty suffix: full
      const bool done = (!hl && !hr) || zero_len;
      still = !done;
      if (done) {
        lo_c = zero_len ? 0 : x;
        hi_c = zero_len ? n_nodes - 1 : y - 1;
      }
    }

    // --- extension (stalled lanes excluded; completed widens retry with
    // the same character this trip); the interval's two rank entries
    long long nlo = -1, nhi = -1;
    if (!still && !invalid && lo_c >= 0) {
      const long long base = c * t.n8;
      const long long a = C[c] + rank24<WIDE>(t.tab, base, lo_c);
      const long long z = C[c] + rank24<WIDE>(t.tab, base, hi_c + 1) - 1;
      if (a <= z) {
        nlo = a;
        nhi = z;
      }
    }
    const bool ok = !still && !invalid && nlo >= 0;
    const bool fail = !still && !invalid && nlo < 0;
    const bool emptied = fail && ks_h >= j;  // empty suffix failed: consume c
    const bool start_w = fail && !emptied;   // fresh drop: jump next trip
    const bool single = ok && nlo == nhi;
    const bool close = ok && j - ks_h + 1 == k;
    const bool advance = ok || invalid || emptied;

    // the closed node's contract_k pair and, AUG, its su | ustart entry
    const int2 pair = __ldg(t.ck + (close ? nlo : 0));
    if (advance && j >= p_start) {
      long long cand_j = single ? nlo : -1;
      if (AUG && single) {
        const long long sw = __ldg(t.suu + nlo);
        cand_j = ((sw & 0xFF) << 25) | ((sw >> 8) << 24) | nlo;
      }
      g.emit[row + j] = static_cast<int32_t>(close ? nlo : -1);
      g.cand[row + j] = static_cast<int32_t>(cand_j);
    }

    const bool reset = invalid || emptied;
    const long long lo2 = close ? pair.x : (ok ? nlo : lo_c);
    const long long hi2 = close ? pair.y : (ok ? nhi : hi_c);
    lo = reset ? 0 : lo2;
    hi = reset ? n_nodes - 1 : hi2;
    ks = static_cast<int>(reset ? j + 1 : (close ? ks_h + 1 : ks_h));
    wx = start_w ? lo_c : (still ? x : wx);
    wy = start_w ? hi_c + 1 : (still ? y : wy);
    rec = start_w ? 1 : (still ? 2 : 0);
    if (advance) {
      ++j;
      cur = next;
      if (j + 1 < L) next = packed(in, row + j + 1);
    }
  }
}

template <bool AUG, bool WIDE>
int launch(const Inputs& in, int K_seg, int L, int k, int Q, const Tables& t, const Grids& g,
           cudaStream_t stream) {
  const unsigned blocks = (K_seg + kThreads - 1) / kThreads;
  segment_repair_kernel<AUG, WIDE><<<blocks, kThreads, 0, stream>>>(in, K_seg, L, k, Q, t, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream, passed as a handle)
// and returns cudaGetLastError(); the caller raises when it is not 0.
// tab is wide (its rows [rank, byte]) when `wide` is not 0; C holds at
// least 4 int32; suu is read only when `aug` is not 0. emit and cand are
// the output grids, holding copies of the chain's emit and cand.
extern "C" int fin_segment_repair(const void* seg_idx, long long K_seg, const void* codes,
                                  const void* untrusted, const void* emit_in, long long B,
                                  long long L, int k, int Q, const void* tab, int wide,
                                  long long n8, const void* C, const void* ck, const void* jl,
                                  const void* jr, const void* suu, long long n_nodes, int aug,
                                  void* emit, void* cand, void* stream) {
  if (K_seg <= 0 || K_seg >= (1LL << 31) || B <= 0 || L <= 0 || B * L >= (1LL << 31) || k < 1 ||
      Q < 1 || n8 < 1 || n_nodes < 1 || (aug && suu == nullptr) ||
      (wide && reinterpret_cast<uintptr_t>(tab) % 8 != 0) ||
      reinterpret_cast<uintptr_t>(ck) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{static_cast<const int32_t*>(seg_idx), static_cast<const uint8_t*>(codes),
                  static_cast<const uint8_t*>(untrusted), static_cast<const int32_t*>(emit_in)};
  const Tables t{static_cast<const int32_t*>(tab), static_cast<const int32_t*>(C),
                 static_cast<const int2*>(ck), static_cast<const uint32_t*>(jl),
                 static_cast<const uint32_t*>(jr), static_cast<const int32_t*>(suu), n8, n_nodes};
  const Grids g{static_cast<int32_t*>(emit), static_cast<int32_t*>(cand)};
  const auto st = static_cast<cudaStream_t>(stream);
  const int K = static_cast<int>(K_seg), l = static_cast<int>(L);
  if (aug) {
    return wide ? launch<true, true>(in, K, l, k, Q, t, g, st)
                : launch<true, false>(in, K, l, k, Q, t, g, st);
  }
  return wide ? launch<false, true>(in, K, l, k, Q, t, g, st)
              : launch<false, false>(in, K, l, k, Q, t, g, st);
}
