// Pair-HMM forward likelihoods on an NVIDIA Hopper GPU, called from JAX
// through the XLA foreign function interface (ops/pairhmm_device.py).
//
// One warp computes one (read, haplotype) pair.  The read's rows are split
// into 32 contiguous chunks of K rows, one chunk per lane, and the M/I/D
// state of those rows stays in registers for the whole sweep.  Lane t works
// on haplotype column j = s - t at step s (a skewed wavefront): the row
// above its first row belongs to lane t-1, which computed column j one step
// earlier, so a single __shfl_up_sync per state hands that row down.
// Haplotype bases are read straight from device memory (one byte per lane
// and step, L1-resident).
//
// Layout (grouped: each read and haplotype is shipped once):
//   reads     [rows, 5, rpad] u8   planes: bases, base quals, insertion
//                                  quals, deletion quals, gap penalties
//   read_lens [rows] i32
//   haps      [n_haps, hpad] u8
//   hap_lens  [n_haps] i32
//   pair_read, pair_hap [n_pairs] i32  (-1 marks a pad pair: skipped)
//   out       [n_pairs] f32  log10 likelihood
//
// Numerics (the contract of ops/pairhmm.py): float32 state with a
// power-of-two renormalisation every kGroup steps, scaled by the exponent
// of the warp-wide peak, so no transcendental runs inside the sweep.  The
// phred -> probability conversion uses exp10f, built without fast-math
// (IEEE-accurate to 2 ulp).  Results below ops.pairhmm.F32_SUSPECT_LOG10
// are recomputed in float64 on the host by pairhmm_forward_checked.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kGroup = 8;  // steps between renormalisations
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    pairhmm_forward_kernel(const uint8_t* __restrict__ reads,
                           const int32_t* __restrict__ read_lens,
                           const uint8_t* __restrict__ haps,
                           const int32_t* __restrict__ hap_lens,
                           const int32_t* __restrict__ pair_read,
                           const int32_t* __restrict__ pair_hap,
                           float* __restrict__ out, int n_pairs, int rpad,
                           int hpad) {
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (pair >= n_pairs) return;  // uniform across the warp
  const int r = pair_read[pair];
  const int h = pair_hap[pair];
  if (r < 0 || h < 0) {
    if (lane == 0) out[pair] = 0.f;
    return;
  }
  const int R = read_lens[r];
  const int H = hap_lens[h];
  const uint8_t* rd = reads + static_cast<size_t>(r) * 5 * rpad;
  const uint8_t* hp = haps + static_cast<size_t>(h) * hpad;

  // Per-row coefficients.  Rows past the read's end get all-zero
  // coefficients, so their state stays zero and never feeds the peak.
  float pm[K], px[K], mm[K], gm[K], mi[K], md[K], eg[K];
  uint8_t rb[K];
  bool rn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;  // 0-based read position of this row
    if (i < R) {
      const float eps = exp10f(-0.1f * rd[rpad + i]);
      const float e_ins = exp10f(-0.1f * rd[2 * rpad + i]);
      const float e_del = exp10f(-0.1f * rd[3 * rpad + i]);
      const float e_gap = exp10f(-0.1f * rd[4 * rpad + i]);
      pm[k] = 1.f - eps;
      px[k] = eps / 3.f;
      mm[k] = 1.f - fminf(1.f, e_ins + e_del);
      gm[k] = 1.f - e_gap;
      mi[k] = e_ins;
      md[k] = e_del;
      eg[k] = e_gap;
      rb[k] = rd[i];
    } else {
      pm[k] = px[k] = mm[k] = gm[k] = mi[k] = md[k] = eg[k] = 0.f;
      rb[k] = 0;
    }
    rn[k] = rb[k] == 'N';
  }

  float M[K], I[K], D[K];
#pragma unroll
  for (int k = 0; k < K; ++k) M[k] = I[k] = D[k] = 0.f;

  // Row 0 is D[0, j] = 1/H for every column (free leading deletions);
  // bval carries it through the renormalisations.
  float bval = 1.f / static_cast<float>(H);
  // The row above this lane's first row, one column back (the diagonal).
  float upM = 0.f, upI = 0.f, upD = lane == 0 ? bval : 0.f;
  float acc = 0.f;
  int log2_scale = 0;
  const int last_lane = (R - 1) / K;
  const int k_last = (R - 1) % K;
  const int n_steps = H + last_lane;

  for (int s = 1; s <= n_steps; ++s) {
    float nM = __shfl_up_sync(kFull, M[K - 1], 1);
    float nI = __shfl_up_sync(kFull, I[K - 1], 1);
    float nD = __shfl_up_sync(kFull, D[K - 1], 1);
    if (lane == 0) {
      nM = 0.f;
      nI = 0.f;
      nD = bval;
    }
    const int j = s - lane;  // this lane's haplotype column (1-based)
    if (j >= 1 && j <= H) {
      const uint8_t hb = hp[j - 1];
      const bool hn = hb == 'N';
      float dM = upM, dI = upI, dD = upD;  // row above, column j-1
      float uM = nM, uI = nI;              // row above, column j
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float oM = M[k], oI = I[k], oD = D[k];
        const float prior = (rb[k] == hb || rn[k] || hn) ? pm[k] : px[k];
        const float m = prior * (dM * mm[k] + (dI + dD) * gm[k]);
        const float ins = uM * mi[k] + uI * eg[k];
        const float del = oM * md[k] + oD * eg[k];
        M[k] = m;
        I[k] = ins;
        D[k] = del;
        if (k == k_last && lane == last_lane) acc += m + ins;
        dM = oM;
        dI = oI;
        dD = oD;
        uM = m;
        uI = ins;
      }
    }
    upM = nM;
    upI = nI;
    upD = nD;

    if (s % kGroup == 0) {
      float peak = acc;
#pragma unroll
      for (int k = 0; k < K; ++k)
        peak = fmaxf(peak, fmaxf(M[k], fmaxf(I[k], D[k])));
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2)
        peak = fmaxf(peak, __shfl_xor_sync(kFull, peak, off));
      if (peak > 0.f) {
        // 2^(127 - e) for the peak's biased exponent e: exact scaling
        const int e = (__float_as_int(peak) >> 23) & 0xff;
        const float inv = __int_as_float((254 - e) << 23);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          M[k] *= inv;
          I[k] *= inv;
          D[k] *= inv;
        }
        upM *= inv;
        upI *= inv;
        upD *= inv;
        bval *= inv;
        acc *= inv;
        log2_scale += e - 127;
      }
    }
  }
  if (lane == last_lane) {
    out[pair] = log10f(fmaxf(acc, FLT_MIN)) +
                static_cast<float>(log2_scale) * 0.30102999566398120f;
  }
}

template <int K>
void launch(cudaStream_t stream, const uint8_t* reads, const int32_t* rlens,
            const uint8_t* haps, const int32_t* hlens, const int32_t* pr,
            const int32_t* ph, float* out, int n_pairs, int rpad, int hpad) {
  const int blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pairhmm_forward_kernel<K><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
      reads, rlens, haps, hlens, pr, ph, out, n_pairs, rpad, hpad);
}

ffi::Error PairHmmForward(cudaStream_t stream, ffi::Buffer<ffi::U8> reads,
                          ffi::Buffer<ffi::S32> read_lens,
                          ffi::Buffer<ffi::U8> haps,
                          ffi::Buffer<ffi::S32> hap_lens,
                          ffi::Buffer<ffi::S32> pair_read,
                          ffi::Buffer<ffi::S32> pair_hap,
                          ffi::ResultBuffer<ffi::F32> out) {
  const auto rdims = reads.dimensions();
  const auto hdims = haps.dimensions();
  if (rdims.size() != 3 || rdims[1] != 5 || hdims.size() != 2)
    return ffi::Error::InvalidArgument(
        "reads must be [rows, 5, rpad] and haps [n_haps, hpad]");
  const int rpad = static_cast<int>(rdims[2]);
  const int hpad = static_cast<int>(hdims[1]);
  const int n_pairs = static_cast<int>(pair_read.element_count());
  if (n_pairs == 0) return ffi::Error::Success();
  const auto args = [&](auto f) {
    f(stream, reads.typed_data(), read_lens.typed_data(), haps.typed_data(),
      hap_lens.typed_data(), pair_read.typed_data(), pair_hap.typed_data(),
      out->typed_data(), n_pairs, rpad, hpad);
  };
  // rpad = 32 * K, K from ops.pairhmm_device.ROWS_PER_LANE
  switch (rpad) {
    case 32: args(launch<1>); break;
    case 64: args(launch<2>); break;
    case 96: args(launch<3>); break;
    case 128: args(launch<4>); break;
    case 160: args(launch<5>); break;
    case 192: args(launch<6>); break;
    case 256: args(launch<8>); break;
    case 384: args(launch<12>); break;
    case 512: args(launch<16>); break;
    default:
      return ffi::Error::InvalidArgument("unsupported read bucket");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LorikeetPairHmmForward, PairHmmForward,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());
