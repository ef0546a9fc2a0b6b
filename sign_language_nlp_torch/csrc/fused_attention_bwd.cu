// Fused multi-head attention backward, f32, for sm_90a.
//
// Replaces the TPU kernel K2,
// sign_language_nlp_tpu/ops/pallas_attention_train.py::_bwd_kernel (reached
// through _bwd_impl and the custom VJP _vjp_bwd of fused_attention_train).
// For each batch row b and head h, with P rebuilt from the forward's softmax
// statistics and the dropout keep-mask replayed from the same hash:
//
//     P   = exp(Q_h K_h^T * scale + bias - m) / l
//     P_d = keep * P * inv,   dP = keep * (dO_h V_h^T) * inv   (rate > 0)
//     dV_h = P_d^T dO_h
//     dS   = P * (dP - delta),  delta = rowsum(dP * P)
//     dQ_h = dS K_h * scale,    dK_h = dS^T Q_h * scale
//
// Inputs as K1 (q [B,Sq,E], k/v [B,Sk,E], head-shared bias [B,Sq,Sk], seeds
// [B], rate), plus K1's statistics stats ([B,H,Sq] float2: row max m and
// sum l) and the incoming gradient dO [B,Sq,E]; outputs dq [B,Sq,E], dk
// and dv [B,Sk,E], and the scratch delta [B,H,Sq].
//
// delta is rowsum(dP * P), as the TPU kernel takes it (its :174), and not
// the equal rowsum(dO * O) of FlashAttention: where one key takes all of a
// row's weight, dP - delta is a difference of two equal large numbers, and
// only the same P and dP on both sides make it exactly 0, as autograd of
// the plain version does. (Measured at D 256, Sq = Sk = 1, rate 0.5: the
// dO * O form left 2.8e-4 where autograd has 0.)
//
// What bounds it on the H100: like K1, the f32 inner loops on the CUDA
// cores over shared-memory tiles (five [Sq,Sk,D] contractions a head, P
// rebuilt once in each of the two main kernels). The Pallas kernel held a
// whole batch row and its [S,S] probabilities in VMEM and wrote dQ, dK and
// dV in one pass. On Hopper the Q, K, V and dO tiles of one row at D 128
// and S 120 alone would take 4 x 61 KB of a block's 227 KB, so the work is
// tiled, in two kernels on the caller's stream:
//   1. dQ: one block per (32 query rows, head, batch row), two loops over
//      32-key tiles (the layout of K1: a warp owns 8 rows, lane j key j):
//      the first sums delta, which the block also writes out, the second
//      accumulates dQ;
//   2. dK, dV: one block per (tile of keys, head, batch row), a loop over
//      32-query tiles; a warp owns kKPW keys, lane i query i. It rebuilds
//      P and dP in the same order of sums as the dQ kernel, so both see
//      the same dP - delta.
// Each output element is written by one thread that sums in a fixed order,
// so there are no atomics and runs repeat bit for bit. Masking follows K1:
// finite biases, nothing skipped, so a row whose keys are all masked has the
// uniform P of the forward.
#include <cfloat>
#include <cuda_runtime.h>

#include "dropout_mask.cuh"

namespace {

constexpr int kWarps = 4;            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRPW = 8;              // dQ: query rows per warp
constexpr int kBQ = kWarps * kRPW;   // dQ: query rows per block
constexpr int kBK = 32;              // dQ: keys per tile, one per lane
constexpr int kBQT = 32;             // dK/dV: queries per tile, one per lane
constexpr unsigned kFull = 0xffffffffu;

// dK/dV: keys per warp; the per-lane accumulators are 2 * kKPW * D/32
// registers, so D 256 takes half as many keys.
template <int D>
__host__ __device__ constexpr int keys_per_warp() { return D > 128 ? 4 : 8; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q and dO tiles [kBQ][D] (read as warp broadcasts), K and V tiles
  // [kBK][D+1] (lane j reads row j: the odd stride keeps 32 banks apart).
  return sizeof(float) * (2 * size_t(kBQ) * D + 2 * size_t(kBK) * (D + 1));
}

// Load K/V tile k0 into shared memory (zeros past Sk), with barriers on
// both sides; then lane j of a warp computes, for the warp's rows and key
// k0 + j, P (into s) and dP (into dp), both 0 for rows past Sq and keys
// past Sk.
template <int D, bool kDropout>
__device__ __forceinline__ void dq_tile_terms(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* sK, float* sV, const float* sQ,
    const float* sdO, int b, int col, int k0, int row0, int warp, int lane,
    bool warp_active, int Sq, int Sk, int E, float scale, const float* m,
    const float* inv_l, const uint32_t* row_key, int threshold,
    float inv_keep, float* s, float* dp) {
  constexpr int kKS = D + 1;
  __syncthreads();  // the Q/dO tiles are in; the last K/V tile is consumed
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
    sV[j * kKS + d] = vx;
  }
  __syncthreads();
  if (!warp_active) return;  // warp-uniform; the barriers above still ran

  const int key = k0 + lane;
  const bool key_ok = key < Sk;
#pragma unroll
  for (int r = 0; r < kRPW; ++r) s[r] = dp[r] = 0.f;
  const float* kr = sK + lane * kKS;
  const float* vr = sV + lane * kKS;
  const float* qw = sQ + warp * kRPW * D;
  const float* dw = sdO + warp * kRPW * D;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kd = kr[d], vd = vr[d];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      s[r] = fmaf(qw[r * D + d], kd, s[r]);
      dp[r] = fmaf(dw[r * D + d], vd, dp[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int row = row0 + r;
    float p = 0.f, dpr = 0.f;
    if (key_ok && row < Sq) {
      const float sc = s[r] * scale + bias[(size_t(b) * Sq + row) * Sk + key];
      p = expf(sc - m[r]) * inv_l[r];
      dpr = dp[r];
      if constexpr (kDropout)
        dpr = slt_dropout_keep(row_key[r], key, threshold) ? dpr * inv_keep
                                                           : 0.f;
    }
    s[r] = p;
    dp[r] = dpr;
  }
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ dout,
                        const float2* __restrict__ stats,
                        float* __restrict__ delta,
                        const int* __restrict__ seeds, int threshold,
                        float inv_keep, float* __restrict__ dq, int Sq,
                        int Sk, int E, float scale) {
  constexpr int kDPL = (D + 31) / 32;
  constexpr int kKS = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * D;
  float* sK = sdO + kBQ * D;
  float* sV = sK + kBK * kKS;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int col = h * D;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + warp * kRPW;
  const bool warp_active = row0 < Sq;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = q0 + r;
    const size_t off = (size_t(b) * Sq + row) * E + col + d;
    sQ[idx] = row < Sq ? q[off] : 0.f;
    sdO[idx] = row < Sq ? dout[off] : 0.f;
  }

  float m[kRPW], inv_l[kRPW], dlt[kRPW], acc[kRPW][kDPL];
  uint32_t row_key[kRPW];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int row = row0 + r;
    m[r] = 0.f;
    inv_l[r] = 0.f;
    dlt[r] = 0.f;
    if (row < Sq) {
      const float2 st = stats[(size_t(b) * H + h) * Sq + row];
      m[r] = st.x;
      inv_l[r] = 1.f / st.y;
    }
    row_key[r] = kDropout ? slt_dropout_row_key(seeds[b], h, row) : 0u;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  float p[kRPW], dp[kRPW];
  // Pass 1: delta = rowsum(dP * P); lane j sums its keys, then the warp.
  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    dq_tile_terms<D, kDropout>(k, v, bias, sK, sV, sQ, sdO, b, col, k0, row0,
                               warp, lane, warp_active, Sq, Sk, E, scale, m,
                               inv_l, row_key, threshold, inv_keep, p, dp);
    if (!warp_active) continue;
#pragma unroll
    for (int r = 0; r < kRPW; ++r) dlt[r] = fmaf(p[r], dp[r], dlt[r]);
  }
  if (warp_active) {
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      dlt[r] = warp_sum(dlt[r]);
      const int row = row0 + r;
      if (lane == 0 && row < Sq)
        delta[(size_t(b) * H + h) * Sq + row] = dlt[r];
    }
  }

  // Pass 2: dQ += dS K, dS = P * (dP - delta); lane holds columns lane,
  // lane + 32, ...
  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    dq_tile_terms<D, kDropout>(k, v, bias, sK, sV, sQ, sdO, b, col, k0, row0,
                               warp, lane, warp_active, Sq, Sk, E, scale, m,
                               inv_l, row_key, threshold, inv_keep, p, dp);
    if (!warp_active) continue;
#pragma unroll
    for (int r = 0; r < kRPW; ++r) p[r] = p[r] * (dp[r] - dlt[r]);
    const int nk = min(kBK, Sk - k0);
    for (int j = 0; j < nk; ++j) {
      float kj[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        const int d = lane + 32 * i;
        kj[i] = d < D ? sK[j * kKS + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const float dsj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[r][i] = fmaf(dsj, kj[i], acc[r][i]);
      }
    }
  }

  if (!warp_active) return;
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int row = row0 + r;
    if (row >= Sq) break;
    float* out = dq + (size_t(b) * Sq + row) * E + col;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[d] = acc[r][i] * scale;
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int kBKT = kWarps * keys_per_warp<D>();
  // K and V tiles [kBKT][D] (read as warp broadcasts), Q and dO tiles
  // [kBQT][D+1] (lane i reads row i), the bias tile [kBQT][kBKT+1], and
  // per query m, 1/l, delta and the dropout row key.
  return sizeof(float) * (2 * size_t(kBKT) * D + 2 * size_t(kBQT) * (D + 1) +
                          size_t(kBQT) * (kBKT + 1) + 4 * size_t(kBQT));
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         const float* __restrict__ dout,
                         const float2* __restrict__ stats,
                         const float* __restrict__ delta,
                         const int* __restrict__ seeds, int threshold,
                         float inv_keep, float* __restrict__ dk,
                         float* __restrict__ dv, int Sq, int Sk, int E,
                         float scale) {
  constexpr int kDPL = (D + 31) / 32;
  constexpr int kKPW = keys_per_warp<D>();
  constexpr int kBKT = kWarps * kKPW;
  constexpr int kQS = D + 1;
  constexpr int kBS = kBKT + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBKT * D;
  float* sQ = sV + kBKT * D;
  float* sdO = sQ + kBQT * kQS;
  float* sBias = sdO + kBQT * kQS;
  float* sM = sBias + kBQT * kBS;
  float* sInvL = sM + kBQT;
  float* sDelta = sInvL + kBQT;
  uint32_t* sRowKey = reinterpret_cast<uint32_t*>(sDelta + kBQT);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int col = h * D;
  const int kt0 = blockIdx.x * kBKT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wk0 = warp * kKPW;  // the warp's first key within the tile
  const bool warp_active = kt0 + wk0 < Sk;

  for (int idx = threadIdx.x; idx < kBKT * D; idx += kThreads) {
    const int c = idx / D, d = idx % D;
    const int key = kt0 + c;
    float kx = 0.f, vx = 0.f;
    if (key < Sk) {
      const size_t off = (size_t(b) * Sk + key) * E + col + d;
      kx = k[off];
      vx = v[off];
    }
    sK[idx] = kx;
    sV[idx] = vx;
  }

  float acc_k[kKPW][kDPL], acc_v[kKPW][kDPL];
#pragma unroll
  for (int c = 0; c < kKPW; ++c)
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kBQT) {
    __syncthreads();  // the K/V tile is in; the last Q/dO tile is consumed
    for (int idx = threadIdx.x; idx < kBQT * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      const int row = q0 + i;
      float qx = 0.f, dx = 0.f;
      if (row < Sq) {
        const size_t off = (size_t(b) * Sq + row) * E + col + d;
        qx = q[off];
        dx = dout[off];
      }
      sQ[i * kQS + d] = qx;
      sdO[i * kQS + d] = dx;
    }
    for (int idx = threadIdx.x; idx < kBQT * kBKT; idx += kThreads) {
      const int i = idx / kBKT, c = idx % kBKT;
      const int row = q0 + i, key = kt0 + c;
      sBias[i * kBS + c] = row < Sq && key < Sk
                               ? bias[(size_t(b) * Sq + row) * Sk + key]
                               : 0.f;
    }
    if (threadIdx.x < kBQT) {
      const int row = q0 + threadIdx.x;
      float mx = 0.f, il = 0.f, dl = 0.f;
      if (row < Sq) {
        const size_t srow = (size_t(b) * H + h) * Sq + row;
        const float2 st = stats[srow];
        mx = st.x;
        il = 1.f / st.y;
        dl = delta[srow];
      }
      sM[threadIdx.x] = mx;
      sInvL[threadIdx.x] = il;
      sDelta[threadIdx.x] = dl;
      if constexpr (kDropout)
        sRowKey[threadIdx.x] = slt_dropout_row_key(seeds[b], h, row);
    }
    __syncthreads();
    if (!warp_active) continue;  // warp-uniform; the barriers above still run

    // Lane i takes query q0 + i: scores and dO V^T for the warp's keys.
    const int row = q0 + lane;
    const bool row_ok = row < Sq;
    float s[kKPW], dp[kKPW];
#pragma unroll
    for (int c = 0; c < kKPW; ++c) s[c] = dp[c] = 0.f;
    const float* qr = sQ + lane * kQS;
    const float* dr = sdO + lane * kQS;
    const float* kw = sK + wk0 * D;
    const float* vw = sV + wk0 * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], dd = dr[d];
#pragma unroll
      for (int c = 0; c < kKPW; ++c) {
        s[c] = fmaf(qd, kw[c * D + d], s[c]);
        dp[c] = fmaf(dd, vw[c * D + d], dp[c]);
      }
    }

    // P_d into s[], dS into dp[].
#pragma unroll
    for (int c = 0; c < kKPW; ++c) {
      const int key = kt0 + wk0 + c;
      float pd = 0.f, ds = 0.f;
      if (row_ok && key < Sk) {
        const float sc = s[c] * scale + sBias[lane * kBS + wk0 + c];
        const float p = expf(sc - sM[lane]) * sInvL[lane];
        float dpr = dp[c];
        pd = p;
        if constexpr (kDropout) {
          const bool keep = slt_dropout_keep(sRowKey[lane], key, threshold);
          pd = keep ? p * inv_keep : 0.f;
          dpr = keep ? dpr * inv_keep : 0.f;
        }
        ds = p * (dpr - sDelta[lane]);
      }
      s[c] = pd;
      dp[c] = ds;
    }

    // dV += P_d^T dO and dK += dS^T Q: lane holds columns lane, lane + 32, ...
    const int nq = min(kBQT, Sq - q0);
    for (int i = 0; i < nq; ++i) {
      float qi[kDPL], di[kDPL];
#pragma unroll
      for (int x = 0; x < kDPL; ++x) {
        const int d = lane + 32 * x;
        qi[x] = d < D ? sQ[i * kQS + d] : 0.f;
        di[x] = d < D ? sdO[i * kQS + d] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kKPW; ++c) {
        const float pdi = __shfl_sync(kFull, s[c], i);
        const float dsi = __shfl_sync(kFull, dp[c], i);
#pragma unroll
        for (int x = 0; x < kDPL; ++x) {
          acc_v[c][x] = fmaf(pdi, di[x], acc_v[c][x]);
          acc_k[c][x] = fmaf(dsi, qi[x], acc_k[c][x]);
        }
      }
    }
  }

  if (!warp_active) return;
#pragma unroll
  for (int c = 0; c < kKPW; ++c) {
    const int key = kt0 + wk0 + c;
    if (key >= Sk) break;
    const size_t off = (size_t(b) * Sk + key) * E + col;
#pragma unroll
    for (int x = 0; x < kDPL; ++x) {
      const int d = lane + 32 * x;
      if (d < D) {
        dk[off + d] = acc_k[c][x] * scale;
        dv[off + d] = acc_v[c][x];
      }
    }
  }
}

struct BwdArgs {
  const float *q, *k, *v, *bias, *dout;
  const float2* stats;
  const int* seeds;
  float *dq, *dk, *dv, *delta;
  int B, Sq, Sk, E, H;
  float scale;
  int threshold;
  float inv_keep;
  cudaStream_t stream;
};

template <int D, bool kDropout>
cudaError_t launch_main(const BwdArgs& a) {
  constexpr size_t dq_smem = dq_smem_bytes<D>();
  constexpr size_t dkv_smem = dkv_smem_bytes<D>();
  constexpr int kBKT = kWarps * keys_per_warp<D>();
  // Above 48 KB a block's shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<D, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(dq_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<D, kDropout>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dkv_smem));
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  attention_bwd_dq_kernel<D, kDropout><<<dq_grid, kThreads, dq_smem,
                                         a.stream>>>(
      a.q, a.k, a.v, a.bias, a.dout, a.stats, a.delta, a.seeds, a.threshold,
      a.inv_keep, a.dq, a.Sq, a.Sk, a.E, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid((a.Sk + kBKT - 1) / kBKT, a.H, a.B);
  attention_bwd_dkv_kernel<D, kDropout><<<dkv_grid, kThreads, dkv_smem,
                                          a.stream>>>(
      a.q, a.k, a.v, a.bias, a.dout, a.stats, a.delta, a.seeds, a.threshold,
      a.inv_keep, a.dk, a.dv, a.Sq, a.Sk, a.E, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const BwdArgs& a, bool dropout) {
  return dropout ? launch_main<D, true>(a) : launch_main<D, false>(a);
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (cudaErrorInvalidValue for a
// head width the kernels are not instantiated for, for shapes the grid
// cannot hold, for a rate outside [0, 1], or for dropout without seeds).
// The two kernels run in order on `stream`; delta is scratch [B,H,Sq].
int slt_fused_attention_bwd_f32(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* stats,
                                const void* seeds, float rate, void* dq,
                                void* dk, void* dv, void* delta, int B,
                                int Sq, int Sk, int E, int H, float scale,
                                void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || E % H != 0 || B > 65535 ||
      H > 65535 || !(rate >= 0.f && rate <= 1.f) ||
      (rate > 0.f && seeds == nullptr))
    return int(cudaErrorInvalidValue);
  BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(bias),
            static_cast<const float*>(dout),
            static_cast<const float2*>(stats), static_cast<const int*>(seeds),
            static_cast<float*>(dq), static_cast<float*>(dk),
            static_cast<float*>(dv), static_cast<float*>(delta),
            B, Sq, Sk, E, H, scale, slt_dropout_threshold(rate),
            slt_dropout_inv(rate), static_cast<cudaStream_t>(stream)};
  const bool dropout = rate > 0.f;
  const int D = E / H;
  if (D != 16 && D != 32 && D != 64 && D != 128 && D != 256)
    return int(cudaErrorInvalidValue);

  switch (D) {
    case 16: return int(launch<16>(a, dropout));
    case 32: return int(launch<32>(a, dropout));
    case 64: return int(launch<64>(a, dropout));
    case 128: return int(launch<128>(a, dropout));
    default: return int(launch<256>(a, dropout));
  }
}

const char* slt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
