// Fused multi-head attention forward, f32, for sm_90a.
//
// Replaces the forward of the TPU kernel K1,
// sign_language_nlp_tpu/ops/pallas_attention_train.py::_fwd_kernel (reached
// through _fwd_impl and fused_attention_train), both branches. For each
// batch row b and head h:
//
//     P = softmax(Q_h K_h^T / sqrt(D) + bias[b])
//     O[b, :, hD:(h+1)D] = P_d V_h,   P_d = P             (rate 0)
//                                     P_d = keep * P * inv (dropout)
//
// q is [B,Sq,E], k and v are [B,Sk,E] in model layout (E = H*D, row-major,
// contiguous); bias is head-shared [B,Sq,Sk] f32; o is [B,Sq,E]. Scores,
// softmax and accumulation are f32. The dropout keep-mask is a stateless
// hash of (seeds[b], h, i, j) (dropout_mask.cuh), inv = 1/max(1-rate, 1e-6).
// When asked (stats != nullptr, the training forward), each row's softmax
// statistics (running max m, sum l) go to stats [B,H,Sq] as float2, so that
// K2 rebuilds P = exp(s - m) / l exactly as here. A log-sum-exp m + log(l)
// would not do: with the finite mask value -1e30, a fully masked row has
// m = -1e30 and m + log(Sk) rounds back to -1e30 in f32, which would make
// every P of that row 1 instead of 1/Sk.
//
// What bounds it on the H100: at the serving shapes (S up to ~240, D 16..256)
// the work per (b, h) is small and the matmul-free f32 inner loops run on the
// CUDA cores, reading K and V tiles from shared memory. The Pallas kernel kept
// a whole batch row and its [S,S] scores resident in VMEM; a Hopper block has
// at most 227 KB of shared memory, so this kernel never holds the [Sq,Sk]
// scores at all:
//   * one block per (tile of kBQ query rows, head, batch row); each warp owns
//     kRPW of the tile's rows and keeps their output rows in registers;
//   * a loop over tiles of kBK keys with an online softmax (running max and
//     running sum per row), so shared memory holds only the Q tile and one
//     K/V tile whatever Sk is;
//   * heads are read straight from model layout at column offset h*D, with no
//     transpose copy in device memory (the point of pallas_attention_train.py
//     :12-18);
//   * D is a template parameter, so the per-lane accumulators are registers.
// Masking is additive and finite (NEG_INF = -1e30 in the callers): a row whose
// keys are all masked gets a uniform average of V, as in the reference
// semantics. The running max starts at -FLT_MAX, never -inf, and no tile is
// skipped for being masked. With dropout the row sum l takes every key and
// only the product with V skips the dropped ones, so P_d = keep * P * inv
// with P normalised over all keys, as in the TPU kernel.
#include <cfloat>
#include <cuda_runtime.h>

#include "dropout_mask.cuh"

namespace {

constexpr int kWarps = 4;                  // warps per block
constexpr int kRPW = 8;                    // query rows per warp
constexpr int kBQ = kWarps * kRPW;         // query rows per block
constexpr int kBK = 32;                    // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q tile [kBQ][D], K tile [kBK][D+1] (padded: lane j reads row j, so an
  // odd row stride keeps the 32 lanes on 32 banks), V tile [kBK][D].
  return sizeof(float) * (size_t(kBQ) * D + size_t(kBK) * (D + 1) +
                          size_t(kBK) * D);
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ bias,
                           float* __restrict__ o,
                           float2* __restrict__ stats,
                           const int* __restrict__ seeds, int threshold,
                           float inv_keep, int Sq, int Sk, int E,
                           float scale) {
  constexpr int kDPL = (D + 31) / 32;  // output columns per lane
  constexpr int kKS = D + 1;           // K tile row stride
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * D;
  float* sV = sK + kBK * kKS;

  const int b = blockIdx.z;
  const int col = blockIdx.y * D;  // head h's column offset
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + warp * kRPW;  // this warp's first query row
  const bool warp_active = row0 < Sq;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = q0 + r;
    sQ[idx] = row < Sq ? q[(size_t(b) * Sq + row) * E + col + d] : 0.f;
  }

  float m[kRPW], l[kRPW], acc[kRPW][kDPL];
  uint32_t row_key[kRPW];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = -FLT_MAX;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
    if constexpr (kDropout)
      row_key[r] = slt_dropout_row_key(seeds[b], blockIdx.y, row0 + r);
  }

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // the Q tile is in; the previous K/V tile is consumed
    for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < Sk) {
        const size_t off = (size_t(b) * Sk + key) * E + col + d;
        kx = k[off];
        vx = v[off];
      }
      sK[j * kKS + d] = kx;
      sV[j * D + d] = vx;
    }
    __syncthreads();
    if (!warp_active) continue;  // warp-uniform; the barriers above still run

    // Scores: lane j takes key k0 + j for all of the warp's rows.
    const int key = k0 + lane;
    const bool key_ok = key < Sk;
    float p[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) p[r] = 0.f;
    const float* kr = sK + lane * kKS;
    const float* qw = sQ + warp * kRPW * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRPW; ++r) p[r] = fmaf(qw[r * D + d], kd, p[r]);
    }

    // Online softmax: fold this tile into each row's running max and sum.
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int row = row0 + r;
      float s = -FLT_MAX;
      if (key_ok && row < Sq)
        s = p[r] * scale + bias[(size_t(b) * Sq + row) * Sk + key];
      const float m_new = fmaxf(m[r], warp_max(s));
      const float corr = expf(m[r] - m_new);
      const float e = key_ok ? expf(s - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(e);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] *= corr;
      if constexpr (kDropout)
        p[r] = key_ok && slt_dropout_keep(row_key[r], key, threshold)
                   ? e * inv_keep : 0.f;
      else
        p[r] = e;
    }

    // O += P V: lane holds columns lane, lane + 32, ...
    const int nk = min(kBK, Sk - k0);
    for (int j = 0; j < nk; ++j) {
      float vj[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < D ? sV[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

  if (!warp_active) return;
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int row = row0 + r;
    if (row >= Sq) break;
    const float inv = 1.f / l[r];
    float* out = o + (size_t(b) * Sq + row) * E + col;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[d] = acc[r][i] * inv;
    }
    if (stats != nullptr && lane == 0)
      stats[(size_t(b) * gridDim.y + blockIdx.y) * Sq + row] =
          make_float2(m[r], l[r]);
  }
}

template <int D, bool kDropout>
cudaError_t launch_variant(const float* q, const float* k, const float* v,
                           const float* bias, float* o, float2* stats,
                           const int* seeds, float rate, int B, int Sq,
                           int Sk, int E, int H, float scale,
                           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB a block's shared memory must be opted into (D >= 128 here).
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_fwd_kernel<D, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  fused_attention_fwd_kernel<D, kDropout><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, o, stats, seeds, slt_dropout_threshold(rate),
      slt_dropout_inv(rate), Sq, Sk, E, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* o, float2* stats,
                   const int* seeds, float rate, int B, int Sq, int Sk, int E,
                   int H, float scale, cudaStream_t stream) {
  if (rate > 0.f)
    return launch_variant<D, true>(q, k, v, bias, o, stats, seeds, rate, B,
                                   Sq, Sk, E, H, scale, stream);
  return launch_variant<D, false>(q, k, v, bias, o, stats, seeds, rate, B,
                                  Sq, Sk, E, H, scale, stream);
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (cudaErrorInvalidValue for a
// head width the kernel is not instantiated for, for shapes the grid cannot
// hold: grid.y = H and grid.z = B are at most 65535, for a rate outside
// [0, 1], or for dropout without seeds). stats ([B,H,Sq] float2) may be
// null; seeds ([B] int32) is read only when rate > 0.
int slt_fused_attention_fwd_f32(const void* q, const void* k, const void* v,
                                const void* bias, void* o, void* stats,
                                const void* seeds, float rate, int B, int Sq,
                                int Sk, int E, int H, float scale,
                                void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || E % H != 0 || B > 65535 ||
      H > 65535 || !(rate >= 0.f && rate <= 1.f) ||
      (rate > 0.f && seeds == nullptr))
    return int(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(o);
  auto* sf = static_cast<float2*>(stats);
  const auto* seed = static_cast<const int*>(seeds);
  auto st = static_cast<cudaStream_t>(stream);
  switch (E / H) {
    case 16: return int(launch<16>(qf, kf, vf, bf, of, sf, seed, rate, B, Sq, Sk, E, H, scale, st));
    case 32: return int(launch<32>(qf, kf, vf, bf, of, sf, seed, rate, B, Sq, Sk, E, H, scale, st));
    case 64: return int(launch<64>(qf, kf, vf, bf, of, sf, seed, rate, B, Sq, Sk, E, H, scale, st));
    case 128: return int(launch<128>(qf, kf, vf, bf, of, sf, seed, rate, B, Sq, Sk, E, H, scale, st));
    case 256: return int(launch<256>(qf, kf, vf, bf, of, sf, seed, rate, B, Sq, Sk, E, H, scale, st));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* slt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
