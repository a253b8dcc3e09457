// Banded affine-gap DP scorer for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA foreign function interface (align/banded_dp.py).
//
// One call scores B candidate rows against the device-resident reference and
// fuses everything the plain XLA scorer (banded_dp._gathered_core) does:
// the read gather and on-device reverse complement, the window gather, the
// penalty from 4-bit codes, the banded DP with its capture at x + 1 == n, and
// the ungapped penalty of the voted diagonal.  Output [2, B] float32: row 0
// the banded score (BIG when no alignment fits the band), row 1 the ungapped
// sum at the row's lane.
//
// Layout: one warp per candidate row; lane t holds band cells
// [t * CPT, t * CPT + CPT) in registers, so the x loop never touches memory
// except the staged query and window bytes in shared memory.  The insertion
// step shifts the band down one cell (one __shfl_down_sync), and the deletion
// chain is a min-plus prefix scan along the band: CPT in-thread steps plus
// log2(32) __shfl_up_sync steps.  Scores are exact integers in the fixed-point
// units of banded_dp._quantize_params; Hopper's DPX add-min
// (__viaddmin_s32) does each saturating add + min in one instruction.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarps = 4;          // candidate rows per block, one warp each
constexpr int32_t kInf = 1 << 30;  // unreachable; a score >= kInf reports BIG
constexpr float kBig = 1e9f;       // banded_dp.BIG
constexpr unsigned kFull = 0xffffffffu;

struct Units {
  int32_t mutation, ambiguity, ins_open, ins_ext, del_open, del_ext;
};

__device__ __forceinline__ uint8_t complement(uint8_t c) {
  // nibble bit reversal (basepairs.COMPLEMENT_TABLE)
  return ((c & 1) << 3) | ((c & 2) << 1) | ((c & 4) >> 1) | ((c & 8) >> 3);
}

__device__ __forceinline__ int32_t penalty(uint32_t q, uint32_t w,
                                           const Units& u) {
  return (q & w) ? u.ambiguity * (__popc(q | w) - 1) : u.mutation;
}

// min(a + b, c) in one DPX instruction on sm_90
__device__ __forceinline__ int32_t addmin(int32_t a, int32_t b, int32_t c) {
  return __viaddmin_s32(a, b, c);
}

template <int CPT>
__global__ void __launch_bounds__(32 * kWarps)
banded_scores_kernel(const uint8_t* __restrict__ reads, int64_t lq,
                     const uint8_t* __restrict__ concat, int64_t concat_len,
                     const int32_t* __restrict__ read_id,
                     const uint8_t* __restrict__ reversed,
                     const int32_t* __restrict__ win_start,
                     const int32_t* __restrict__ lane_of,
                     const int32_t* __restrict__ n_of,
                     const int32_t* __restrict__ m_of, int64_t rows, Units u,
                     int32_t scale, float* __restrict__ out) {
  constexpr int kBand = 32 * CPT;
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;  // the whole warp leaves together

  uint8_t* q = smem + warp * (2 * lq + kBand);
  uint8_t* w = q + lq;
  const int32_t n = n_of[row];
  const int32_t m = m_of[row];

  // stage the (reverse-complemented) query and the reference window
  const uint8_t* read = reads + static_cast<int64_t>(read_id[row]) * lq;
  const bool rev = reversed[row] != 0;
  for (int64_t x = t; x < lq; x += 32) {
    uint8_t c = read[x];
    if (rev) {
      int64_t src = static_cast<int64_t>(n) - 1 - x;
      src = src < 0 ? 0 : (src > lq - 1 ? lq - 1 : src);
      c = x < n ? complement(read[src]) : 0;
    }
    q[x] = c;
  }
  const int64_t ws = win_start[row];
  for (int64_t j = t; j < lq + kBand; j += 32) {
    int64_t src = ws + j;
    src = src < 0 ? 0 : (src > concat_len - 1 ? concat_len - 1 : src);
    w[j] = concat[src];
  }
  __syncwarp();

  const int32_t steps = n < lq ? n : static_cast<int32_t>(lq);

  // ungapped penalty of the voted diagonal: x < n at window offset x + lane
  int32_t lane = lane_of[row];
  lane = lane < 0 ? 0 : (lane > kBand - 1 ? kBand - 1 : lane);
  int32_t diag = 0;
  for (int32_t x = t; x < steps; x += 32) diag += penalty(q[x], w[x + lane], u);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) diag += __shfl_xor_sync(kFull, diag, s);

  // banded DP over band coordinate k = y - x
  const int k0 = t * CPT;
  int32_t best[CPT], ins[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    best[i] = (k0 + i <= m) ? 0 : kInf;
    ins[i] = kInf;
  }
  for (int32_t x = 0; x < steps; ++x) {
    const uint32_t qc = q[x];
    // query insertion (x, y) -> (x + 1, y): the band shifts down one cell
    int32_t insc[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      insc[i] = addmin(ins[i], u.ins_ext, addmin(best[i], u.ins_open, kInf));
    const int32_t from_next = __shfl_down_sync(kFull, insc[0], 1);

    int32_t after[CPT];
    bool valid[CPT];
    int32_t out_local = kInf;  // deletion value leaving this lane, no carry
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int k = k0 + i;
      const int32_t ins_new =
          i + 1 < CPT ? insc[i + 1] : (t == 31 ? kInf : from_next);
      ins[i] = ins_new;
      valid[i] = x + k < m;
      const int32_t diag_new =
          valid[i] ? addmin(best[i], penalty(qc, w[x + k], u), kInf) : kInf;
      after[i] = min(diag_new, ins_new);
      out_local = addmin(out_local, u.del_ext, addmin(after[i], u.del_open, kInf));
    }
    // deletion chain D(k + 1) = min(after(k) + del_open, D(k) + del_ext),
    // D(0) = inf: an inclusive min-plus scan of the lanes' outgoing values
    int32_t scan = out_local;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int32_t other = __shfl_up_sync(kFull, scan, s);
      if (t >= s) scan = min(scan, addmin(other, s * CPT * u.del_ext, kInf));
    }
    int32_t d = __shfl_up_sync(kFull, scan, 1);
    if (t == 0) d = kInf;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int32_t chain = valid[i] ? d : kInf;
      d = addmin(d, u.del_ext, addmin(after[i], u.del_open, kInf));
      best[i] = min(after[i], chain);
    }
  }

  // capture once the query is consumed: the window tail after it is free
  int32_t result = kInf;
  if (n >= 1 && n <= lq) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (n + k0 + i <= m) result = min(result, best[i]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      result = min(result, __shfl_xor_sync(kFull, result, s));
  }
  if (t == 0) {
    // IEEE division: the float32 nearest to units / scale
    const float scale_f = static_cast<float>(scale);
    out[row] = result >= kInf ? kBig : static_cast<float>(result) / scale_f;
    out[rows + row] = static_cast<float>(diag) / scale_f;
  }
}

template <int CPT>
void launch(cudaStream_t stream, int64_t rows, int64_t lq, const uint8_t* reads,
            const uint8_t* concat, int64_t concat_len, const int32_t* read_id,
            const uint8_t* reversed, const int32_t* win_start,
            const int32_t* lane, const int32_t* n, const int32_t* m,
            const Units& u, int32_t scale, float* out) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * (2 * lq + 32 * CPT);
  banded_scores_kernel<CPT><<<blocks, 32 * kWarps, smem, stream>>>(
      reads, lq, concat, concat_len, read_id, reversed, win_start, lane, n, m,
      rows, u, scale, out);
}

ffi::Error BandedScoresImpl(
    cudaStream_t stream, ffi::Buffer<ffi::U8> reads,
    ffi::Buffer<ffi::U8> concat, ffi::Buffer<ffi::S32> read_id,
    ffi::Buffer<ffi::U8> reversed, ffi::Buffer<ffi::S32> win_start,
    ffi::Buffer<ffi::S32> lane, ffi::Buffer<ffi::S32> n,
    ffi::Buffer<ffi::S32> m, ffi::ResultBuffer<ffi::F32> out, int64_t band,
    int64_t scale, int64_t mutation, int64_t ambiguity, int64_t ins_open,
    int64_t ins_ext, int64_t del_open, int64_t del_ext) {
  const auto rdims = reads.dimensions();
  if (rdims.size() != 2)
    return ffi::Error::InvalidArgument("reads must be [R, LQ]");
  const int64_t lq = rdims[1];
  const int64_t rows = static_cast<int64_t>(read_id.element_count());
  if (out->element_count() != static_cast<size_t>(2 * rows))
    return ffi::Error::InvalidArgument("output must be [2, B]");
  if (rows == 0) return ffi::Error::Success();
  const Units u{static_cast<int32_t>(mutation), static_cast<int32_t>(ambiguity),
                static_cast<int32_t>(ins_open),  static_cast<int32_t>(ins_ext),
                static_cast<int32_t>(del_open),  static_cast<int32_t>(del_ext)};
  const int64_t concat_len = static_cast<int64_t>(concat.element_count());
  switch (band) {
    case 32:
      launch<1>(stream, rows, lq, reads.typed_data(), concat.typed_data(),
                concat_len, read_id.typed_data(), reversed.typed_data(),
                win_start.typed_data(), lane.typed_data(), n.typed_data(),
                m.typed_data(), u, static_cast<int32_t>(scale),
                out->typed_data());
      break;
    case 64:
      launch<2>(stream, rows, lq, reads.typed_data(), concat.typed_data(),
                concat_len, read_id.typed_data(), reversed.typed_data(),
                win_start.typed_data(), lane.typed_data(), n.typed_data(),
                m.typed_data(), u, static_cast<int32_t>(scale),
                out->typed_data());
      break;
    case 128:
      launch<4>(stream, rows, lq, reads.typed_data(), concat.typed_data(),
                concat_len, read_id.typed_data(), reversed.typed_data(),
                win_start.typed_data(), lane.typed_data(), n.typed_data(),
                m.typed_data(), u, static_cast<int32_t>(scale),
                out->typed_data());
      break;
    default:
      return ffi::Error::InvalidArgument("band must be 32, 64 or 128");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MapperBandedScores, BandedScoresImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()   // reads
                                  .Arg<ffi::Buffer<ffi::U8>>()   // concat
                                  .Arg<ffi::Buffer<ffi::S32>>()  // read_id
                                  .Arg<ffi::Buffer<ffi::U8>>()   // reversed
                                  .Arg<ffi::Buffer<ffi::S32>>()  // win_start
                                  .Arg<ffi::Buffer<ffi::S32>>()  // lane
                                  .Arg<ffi::Buffer<ffi::S32>>()  // n
                                  .Arg<ffi::Buffer<ffi::S32>>()  // m
                                  .Ret<ffi::Buffer<ffi::F32>>()  // [2, B]
                                  .Attr<int64_t>("band")
                                  .Attr<int64_t>("scale")
                                  .Attr<int64_t>("mutation")
                                  .Attr<int64_t>("ambiguity")
                                  .Attr<int64_t>("ins_open")
                                  .Attr<int64_t>("ins_ext")
                                  .Attr<int64_t>("del_open")
                                  .Attr<int64_t>("del_ext"));
