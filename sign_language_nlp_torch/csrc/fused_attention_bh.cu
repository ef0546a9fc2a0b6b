// Single-head fused attention forward over head-split slices, f32, for sm_90a.
//
// Replaces the TPU kernel K3,
// sign_language_nlp_tpu/ops/pallas_attention.py::_attention_kernel (reached
// through _pallas_attention_fwd_impl and the public fused_attention). For each
// of the BH slices s:
//
//     O[s] = softmax(Q[s] K[s]^T / sqrt(D) + bias[s]) V[s]
//
// q is [BH,Sq,D], k and v are [BH,Sk,D], bias is [BH,Sq,Sk] (each slice its
// own bias), o is [BH,Sq,D]; all f32, row-major, contiguous. Scores, softmax
// and accumulation are f32. Any head width D <= 256.
//
// What bounds it on the H100: at the shapes it is run at (Sq, Sk ~120, D 128)
// the f32 products run on the CUDA cores out of shared-memory tiles, so it is
// bound by operations (4·BH·Sq·Sk·D FLOPs against 67 TFLOP/s) long before the
// bytes of q, k, v, bias and o. The Pallas kernel ran one program per slice
// with the whole [S,D] q/k/v and the [S,S] scores resident in VMEM. A Hopper
// block has at most 227 KB of shared memory and the card needs many blocks in
// flight, so this kernel tiles instead:
//   * one block per (slice, tile of kBQ query rows): the slice on grid x
//     (up to 2^31 - 1, the serving shape has BH 2048 and more), the query
//     tile on grid y; each of the kWarps warps owns kRPW of the tile's rows and
//     keeps their output rows in registers (lane i holds columns i, i+32, ...);
//   * K and V are staged through shared memory in tiles of kBK keys;
//   * an online softmax (running max and running sum per row), as in K1
//     (fused_attention_fwd.cu): chosen over an exact row softmax over a
//     [kBQ,Sk] scores tile because it keeps shared memory independent of Sk
//     and is the softmax whose numerics K1 already holds on this card;
//   * D is padded to DP, a multiple of 32 (one of 32, 64, 128, 256), which is
//     a template parameter: the tiles are zero-filled past D by masked loads,
//     the padded columns add 0 to every score, and only columns < D are
//     written. So D 8 or 24 runs the DP 32 instantiation;
//   * the score loop reads Q and K four columns at a time (float4): Q rows
//     are broadcast to the warp, and the K tile's row stride DP + 4 keeps the
//     lanes of each quarter-warp on distinct banks.
// Masking is additive and finite (NEG_INF = -1e30 in the callers): f32 rounds
// s·scale − 1e30 to −1e30, so a row whose keys are all masked gets a uniform
// average of V and never NaN, as JAX's softmax does. The running max starts at
// -FLT_MAX, never -inf, and no tile is skipped for being masked.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // warps per block
constexpr int kRPW = 8;             // query rows per warp
constexpr int kBQ = kWarps * kRPW;  // query rows per block
constexpr int kBK = 32;             // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 256;

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

template <int DP>
constexpr size_t smem_bytes() {
  // Q tile [kBQ][DP], K tile [kBK][DP+4], V tile [kBK][DP].
  return sizeof(float) * (size_t(kBQ) * DP + size_t(kBK) * (DP + 4) +
                          size_t(kBK) * DP);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
fused_attention_bh_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ bias,
                          float* __restrict__ o, int Sq, int Sk, int D,
                          float scale) {
  constexpr int kDPL = DP / 32;  // output columns per lane
  constexpr int kKS = DP + 4;    // K tile row stride (16-byte aligned)
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * DP;
  float* sV = sK + kBK * kKS;

  const size_t s = blockIdx.x;  // the slice
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + warp * kRPW;  // this warp's first query row
  const bool warp_active = row0 < Sq;
  const float* qs = q + s * Sq * D;
  const float* ks = k + s * Sk * D;
  const float* vs = v + s * Sk * D;
  const float* bs = bias + s * Sq * Sk;

  for (int idx = threadIdx.x; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int row = q0 + r;
    sQ[idx] = row < Sq && d < D ? qs[size_t(row) * D + d] : 0.f;
  }

  float m[kRPW], l[kRPW], acc[kRPW][kDPL];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = -FLT_MAX;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // the Q tile is in; the previous K/V tile is consumed
    for (int idx = threadIdx.x; idx < kBK * DP; idx += kThreads) {
      const int j = idx / DP, d = idx % DP;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < Sk && d < D) {
        const size_t off = size_t(key) * D + d;
        kx = ks[off];
        vx = vs[off];
      }
      sK[j * kKS + d] = kx;
      sV[j * DP + d] = vx;
    }
    __syncthreads();
    if (!warp_active) continue;  // warp-uniform; the barriers above still run

    // Scores: lane j takes key k0 + j for all of the warp's rows.
    const int key = k0 + lane;
    const bool key_ok = key < Sk;
    float p[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) p[r] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(sK + lane * kKS);
    const float4* qw = reinterpret_cast<const float4*>(sQ + warp * kRPW * DP);
#pragma unroll 2
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 kd = kr[d4];
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const float4 qd = qw[r * (DP / 4) + d4];
        p[r] = fmaf(qd.x, kd.x, p[r]);
        p[r] = fmaf(qd.y, kd.y, p[r]);
        p[r] = fmaf(qd.z, kd.z, p[r]);
        p[r] = fmaf(qd.w, kd.w, p[r]);
      }
    }

    // Online softmax: fold this tile into each row's running max and sum.
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int row = row0 + r;
      float sc = -FLT_MAX;
      if (key_ok && row < Sq) sc = p[r] * scale + bs[size_t(row) * Sk + key];
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float corr = expf(m[r] - m_new);
      const float e = key_ok ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(e);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] *= corr;
      p[r] = e;
    }

    // O += P V: lane holds columns lane, lane + 32, ...
    const int nk = min(kBK, Sk - k0);
    for (int j = 0; j < nk; ++j) {
      float vj[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) vj[i] = sV[j * DP + lane + 32 * i];
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
    float* out = o + (s * Sq + row) * D;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[d] = acc[r][i] * inv;
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* o, int BH, int Sq, int Sk, int D,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  // Above 48 KB a block's shared memory must be opted into (DP >= 128 here).
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_bh_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  fused_attention_bh_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, o, Sq, Sk, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code: cudaErrorInvalidValue for an
// empty shape, a head width outside 1..256, or more than 65535 query tiles of
// 32 rows (grid y).
int slt_fused_attention_bh_f32(const void* q, const void* k, const void* v,
                               const void* bias, void* o, int BH, int Sq,
                               int Sk, int D, float scale, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > kMaxD ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return int(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return int(launch<32>(qf, kf, vf, bf, of, BH, Sq, Sk, D, scale, st));
  if (D <= 64) return int(launch<64>(qf, kf, vf, bf, of, BH, Sq, Sk, D, scale, st));
  if (D <= 128) return int(launch<128>(qf, kf, vf, bf, of, BH, Sq, Sk, D, scale, st));
  return int(launch<256>(qf, kf, vf, bf, of, BH, Sq, Sk, D, scale, st));
}

const char* slt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
