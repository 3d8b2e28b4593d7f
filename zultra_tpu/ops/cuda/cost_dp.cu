// Optimal-parse cost DP for the block planner, one warp per block lane.
//
// Semantics are those of the reference's backward cost DP
// (src/blockdeflate.c:254-323) and its selection order: literal first,
// then match slots 0..7, a candidate winning only on a strict
// improvement, and within a short match the larger truncation winning a
// tie. The plain XLA form of the same DP is ops/parse_wavefront.py
// (_dp_scan_cost + _select_pass); tests and the chip smoke run compare
// the two for integer equality.
//
// Inputs (built by ops/dp_cuda.py, all int32, B lanes of n positions):
//   lit    (B, n)     literal bit cost, 0 beyond the block
//   slots  (B, n, 8)  len | cost << 9 | kind << 16 per match slot:
//                     kind 1 = short (full length < 40; len is the
//                     length clamped to the block end, cost the offset
//                     bits), kind 2 = long (len clamped, cost = length +
//                     offset bits), kind 0 = no match
//   varlen (B, 40)    length-symbol bits of truncation k = 3..39
// Output:
//   out    (B, n)     chosen length | slot << 9 (slot 0 = literal)
//
// Per position p, walked from the block's end down:
//   * cost[p+1 .. p+258] live in a 512-entry ring in shared memory;
//     cost[p+1] also stays in a register for the literal candidate.
//   * shorts: lane t packs (varlen_k + cost[p+k]) << 6 | (63 - k) for
//     k = 3 + t (and k = 35 + t on lanes 0..4); each short slot's best
//     truncation is one warp min over the lanes with k <= its length, so
//     the smallest cost and then the largest k win.
//   * longs read cost[p + len] from the ring; a long match clamped below
//     40 by the block end lands on it, where the cost is 0.
//   * the winner is the minimum of cost << 4 | candidate index, which
//     reproduces the strict-improvement scan order.
// Every lane evaluates the candidates redundantly from broadcast
// shared-memory reads, so the only cross-lane traffic is the 8 warp
// reductions. Costs stay below 2^25 for blocks up to 2^21 positions
// (15-bit codes at most), so the 2^26 clamp and the packings are exact.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kRing = 512;
constexpr unsigned kRingMask = kRing - 1;
constexpr int kChunk = 32;
constexpr int kSlots = 8;
constexpr int kMinMatch = 3;
constexpr int kLeaveAlone = 40;
constexpr int kVarlen = 40;
constexpr unsigned kClamp = (1u << 26) - 1;
constexpr unsigned kInf = 1u << 26;
constexpr unsigned kBig = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(32) cost_dp_kernel(
    const int32_t* __restrict__ lit, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ varlen, int32_t* __restrict__ out,
    int64_t n) {
  __shared__ int32_t ring[kRing];
  __shared__ int32_t lit_s[kChunk];
  __shared__ int4 slot_s[kChunk * 2];

  const int t = threadIdx.x;
  const int64_t lane = blockIdx.x;
  const int32_t* lit_l = lit + lane * n;
  const int4* slot_l =
      reinterpret_cast<const int4*>(slots + lane * n * kSlots);
  int32_t* out_l = out + lane * n;

  for (int i = t; i < kRing; i += 32) ring[i] = 0;

  const int ka = kMinMatch + t;
  const int kb = kMinMatch + 32 + t;
  const bool has_b = t < kVarlen - 32 - kMinMatch;  // k = 35..39
  const unsigned va = static_cast<unsigned>(varlen[lane * kVarlen + t]);
  const unsigned vb =
      has_b ? static_cast<unsigned>(varlen[lane * kVarlen + 32 + t]) : 0u;

  int64_t c = n / kChunk - 1;
  int32_t r_lit = lit_l[c * kChunk + t];
  int4 r_s0 = slot_l[c * kChunk * 2 + 2 * t];
  int4 r_s1 = slot_l[c * kChunk * 2 + 2 * t + 1];
  unsigned c1 = 0;  // cost[p + 1]

  for (; c >= 0; --c) {
    __syncwarp();
    lit_s[t] = r_lit;
    slot_s[2 * t] = r_s0;
    slot_s[2 * t + 1] = r_s1;
    __syncwarp();
    if (c > 0) {  // prefetch the next (lower) chunk while this one runs
      const int64_t b = (c - 1) * kChunk;
      r_lit = lit_l[b + t];
      r_s0 = slot_l[b * 2 + 2 * t];
      r_s1 = slot_l[b * 2 + 2 * t + 1];
    }
    int32_t mine = 0;
    for (int j = kChunk - 1; j >= 0; --j) {
      const unsigned p = static_cast<unsigned>(c * kChunk + j);
      const unsigned xa =
          min(va + static_cast<unsigned>(ring[(p + ka) & kRingMask]), kClamp);
      const unsigned pa = xa * 64u + static_cast<unsigned>(63 - ka);
      unsigned pb = kBig;
      if (has_b) {
        const unsigned xb = min(
            vb + static_cast<unsigned>(ring[(p + kb) & kRingMask]), kClamp);
        pb = xb * 64u + static_cast<unsigned>(63 - kb);
      }

      const int4 s0 = slot_s[2 * j];
      const int4 s1 = slot_s[2 * j + 1];
      const int32_t sw[kSlots] = {s0.x, s0.y, s0.z, s0.w,
                                  s1.x, s1.y, s1.z, s1.w};
      unsigned best = (static_cast<unsigned>(lit_s[j]) + c1) << 4;
      int blen = 0;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int kind = sw[m] >> 16;
        const int len = sw[m] & 511;
        const unsigned cst = static_cast<unsigned>((sw[m] >> 9) & 127);
        unsigned cand = kInf;
        int l = len;
        if (kind == 1) {  // uniform across the warp: every lane reads sw[m]
          unsigned v = ka <= len ? pa : kBig;
          if (kb <= len) v = min(v, pb);
          const unsigned w = __reduce_min_sync(kFull, v);
          if (len >= kMinMatch) {
            cand = (w >> 6) + cst;
            l = 63 - static_cast<int>(w & 63u);
          }
        } else if (kind == 2) {
          cand = cst + (len < kLeaveAlone
                            ? 0u
                            : static_cast<unsigned>(
                                  ring[(p + static_cast<unsigned>(len)) &
                                       kRingMask]));
        }
        const unsigned key = cand * 16u + static_cast<unsigned>(m + 1);
        if (key < best) {
          best = key;
          blen = l;
        }
      }
      const unsigned cost = best >> 4;
      const unsigned mcode = best & 15u;
      if (t == 0) ring[p & kRingMask] = static_cast<int32_t>(cost);
      if (t == j) {
        mine = static_cast<int32_t>((mcode ? blen : 0) |
                                    static_cast<int>(mcode << 9));
      }
      c1 = cost;
      __syncwarp();
    }
    out_l[c * kChunk + t] = mine;
  }
}

ffi::Error CostDp(cudaStream_t stream, ffi::Buffer<ffi::S32> lit,
                  ffi::Buffer<ffi::S32> slots, ffi::Buffer<ffi::S32> varlen,
                  ffi::ResultBuffer<ffi::S32> out) {
  const auto ld = lit.dimensions();
  const auto sd = slots.dimensions();
  const auto vd = varlen.dimensions();
  if (ld.size() != 2 || sd.size() != 3 || vd.size() != 2) {
    return ffi::Error::InvalidArgument("cost_dp: bad operand ranks");
  }
  const int64_t B = ld[0];
  const int64_t n = ld[1];
  if (n <= 0 || n % kChunk != 0 || n > (int64_t{1} << 21)) {
    return ffi::Error::InvalidArgument(
        "cost_dp: n must be a positive multiple of 32, at most 2^21");
  }
  if (sd[0] != B || sd[1] != n || sd[2] != kSlots || vd[0] != B ||
      vd[1] != kVarlen) {
    return ffi::Error::InvalidArgument("cost_dp: operand shapes disagree");
  }
  if (B == 0) return ffi::Error::Success();
  cost_dp_kernel<<<static_cast<unsigned>(B), 32, 0, stream>>>(
      lit.typed_data(), slots.typed_data(), varlen.typed_data(),
      out->typed_data(), n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("cost_dp: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ZultraCostDp, CostDp,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
