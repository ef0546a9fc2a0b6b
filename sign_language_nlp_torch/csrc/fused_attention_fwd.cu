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
// contiguous); bias is head-shared [B,Sq,Sk] f32; o is [B,Sq,E]. Any head
// width D <= 256. The dropout keep-mask is a stateless hash of (seeds[b], h,
// i, j) (dropout_mask.cuh), inv = 1/max(1-rate, 1e-6). When asked (stats !=
// nullptr, the training forward), each row's softmax statistics (running max
// m, sum l) go to stats [B,H,Sq] as float2, so that K2 rebuilds P =
// exp(s - m) / l exactly as here. A log-sum-exp m + log(l) would not do:
// with the finite mask value -1e30, a fully masked row has m = -1e30 and
// m + log(Sk) rounds back to -1e30 in f32, which would make every P of that
// row 1 instead of 1/Sk.
//
// What bounds it on the H100: its two [Sq,Sk,D] contractions a head
// (4·B·Sq·Sk·E FLOPs, against 67 TFLOP/s of f32 on the CUDA cores) come
// long before its bytes (q, k, v, bias, o). The first design ran both on
// the CUDA cores with one shared-memory load per FMA, a shuffle per row
// and key, and synchronous tile loads, at 14% of that bound. This one:
//   * both contractions (S = Q K^T and O += P V) run on the tensor cores
//     as 3xTF32 mma.sync.m16n8k8 (attention_mma.cuh), which keeps f32
//     accuracy; softmax, statistics and sums stay in f32 registers;
//   * one block per (64 query rows, head, batch row): 4 warps of 16 rows,
//     one m16 fragment each. The Q tile is loaded once; K/V tiles of kBK
//     keys (32, 16 above D 64) are double-buffered through cp.async straight
//     from model layout at column h*D, so the next tile's copy overlaps
//     this tile's products;
//   * the online softmax works on the accumulator fragments: a row's max
//     and sum take two shuffles across the four threads that share it;
//   * P passes from the accumulator layout to the A operand of P V with no
//     shuffle (the key order inside a chunk of 8 is permuted instead);
//   * the bias and the keep-mask are read per fragment element;
//   * D is padded to DP (32, 64, 128, 256), a template parameter: tiles are
//     zero-filled past D, padded columns add 0 to every score, and only
//     columns < D are written.
// Masking is additive and finite (NEG_INF = -1e30 in the callers): a row
// whose keys are all masked gets a uniform average of V, as in the reference
// semantics. The running max starts at -FLT_MAX, never -inf, and no tile is
// skipped for being masked. With dropout the row sum l takes every key and
// only the product with V skips the dropped ones, so P_d = keep * P * inv
// with P normalised over all keys, as in the TPU kernel.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_mma.cuh"
#include "dropout_mask.cuh"

namespace {

using slt::kThreads;
constexpr int kBQ = slt::kWarps * 16;  // query rows per block

// Keys per tile: 16 from D 128 up keeps three blocks on an SM at DP 128.
template <int DP>
__host__ __device__ constexpr int key_tile() { return DP > 64 ? 16 : 32; }

template <int DP>
constexpr size_t smem_bytes() {
  // Q tile [kBQ][DP+4], K and V tiles [2][kBK][DP+4] each.
  return sizeof(float) * size_t(DP + 4) * (kBQ + 4 * key_tile<DP>());
}

template <int DP, bool kDropout>
__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ bias,
                           float* __restrict__ o,
                           float2* __restrict__ stats,
                           const int* __restrict__ seeds, int threshold,
                           float inv_keep, int Sq, int Sk, int E, int D,
                           float scale, bool vec) {
  constexpr int kBK = key_tile<DP>();
  constexpr int LD = DP + 4;
  constexpr int NT = kBK / 8;  // key chunks of 8 per tile
  constexpr int ND = DP / 8;   // column tiles of O
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * LD;
  float* sV = sK + 2 * kBK * LD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  const bool warp_active = q0 + wrow < Sq;
  const float* qb = q + size_t(b) * Sq * E + size_t(h) * D;
  const float* kb = k + size_t(b) * Sk * E + size_t(h) * D;
  const float* vb = v + size_t(b) * Sk * E + size_t(h) * D;
  const float* biasb = bias + size_t(b) * Sq * Sk;

  slt::load_tile<kBQ, DP>(sQ, qb, q0, Sq, 0, D, E, vec);
  slt::load_tile<kBK, DP>(sK, kb, 0, Sk, 0, D, E, vec);
  slt::load_tile<kBK, DP>(sV, vb, 0, Sk, 0, D, E, vec);
  slt::cp_async_commit();

  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t row_key[2] = {0u, 0u};
  if constexpr (kDropout) {
    row_key[0] = slt_dropout_row_key(seeds[b], h, rows[0]);
    row_key[1] = slt_dropout_row_key(seeds[b], h, rows[1]);
  }

  const int n_tiles = (Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      const int nxt = (buf ^ 1) * kBK * LD;
      slt::load_tile<kBK, DP>(sK + nxt, kb, (kt + 1) * kBK, Sk, 0, D, E, vec);
      slt::load_tile<kBK, DP>(sV + nxt, vb, (kt + 1) * kBK, Sk, 0, D, E, vec);
    }
    slt::cp_async_commit();
    slt::cp_async_wait1();
    __syncthreads();  // tile kt (and the Q tile) is in for every thread

    if (warp_active) {  // warp-uniform; the barriers still run
      const float* tK = sK + buf * kBK * LD;
      const float* tV = sV + buf * kBK * LD;
      float s[NT][4];
      slt::scores_abt<DP, NT>(s, sQ + wrow * LD, tK, g, t);
      const int k0 = kt * kBK;

      // Scale and bias; -FLT_MAX past Sk or Sq. Then the tile's row max.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, key = k0 + 8 * j + 2 * t + (e & 1);
          float x = -FLT_MAX;
          if (key < Sk && rows[r] < Sq)
            x = fmaf(s[j][e], scale, __ldg(biasb + size_t(rows[r]) * Sk + key));
          s[j][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = slt::quad_max(mx[r]);
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, key = k0 + 8 * j + 2 * t + (e & 1);
          const float ex = key < Sk ? expf(s[j][e] - m[r]) : 0.f;
          ls[r] += ex;
          if constexpr (kDropout)
            s[j][e] = key < Sk && slt_dropout_keep(row_key[r], key, threshold)
                          ? ex * inv_keep : 0.f;
          else
            s[j][e] = ex;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + slt::quad_sum(ls[r]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // O += P_d V, one chunk of 8 keys at a time.
#pragma unroll
      for (int j = 0; j < NT; ++j)
        slt::accumulate_pv<DP>(acc, s[j][0], s[j][1], s[j][2], s[j][3],
                               tV + 8 * j * LD, g, t);
    }
    __syncthreads();  // buffer buf is consumed before it is refilled
  }

  if (!warp_active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= Sq) continue;
    const float inv = 1.f / l[r];
    float* out = o + (size_t(b) * Sq + row) * E + size_t(h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < D) out[d] = acc[n][2 * r + e] * inv;
      }
    if (stats != nullptr && t == 0)
      stats[(size_t(b) * gridDim.y + h) * Sq + row] = make_float2(m[r], l[r]);
  }
}

template <int DP, bool kDropout>
cudaError_t launch_variant(const float* q, const float* k, const float* v,
                           const float* bias, float* o, float2* stats,
                           const int* seeds, float rate, int B, int Sq,
                           int Sk, int E, int H, float scale, bool vec,
                           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  // Above 48 KB a block's shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_fwd_kernel<DP, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  fused_attention_fwd_kernel<DP, kDropout><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, o, stats, seeds, slt_dropout_threshold(rate),
      slt_dropout_inv(rate), Sq, Sk, E, E / H, scale, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* o, float2* stats,
                   const int* seeds, float rate, int B, int Sq, int Sk, int E,
                   int H, float scale, bool vec, cudaStream_t stream) {
  if (rate > 0.f)
    return launch_variant<DP, true>(q, k, v, bias, o, stats, seeds, rate, B,
                                    Sq, Sk, E, H, scale, vec, stream);
  return launch_variant<DP, false>(q, k, v, bias, o, stats, seeds, rate, B,
                                   Sq, Sk, E, H, scale, vec, stream);
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (cudaErrorInvalidValue for a
// head width above 256, for shapes the grid cannot hold: grid.y = H and
// grid.z = B are at most 65535, for a rate outside [0, 1], or for dropout
// without seeds). stats ([B,H,Sq] float2) may be null; seeds ([B] int32) is
// read only when rate > 0.
int slt_fused_attention_fwd_f32(const void* q, const void* k, const void* v,
                                const void* bias, void* o, void* stats,
                                const void* seeds, float rate, int B, int Sq,
                                int Sk, int E, int H, float scale,
                                void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || E % H != 0 || E / H > 256 ||
      B > 65535 || H > 65535 || !(rate >= 0.f && rate <= 1.f) ||
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
  const int D = E / H;
  const bool vec = D % 4 == 0 && slt::aligned16(q) && slt::aligned16(k) &&
                   slt::aligned16(v);
  switch (slt::padded_width(D)) {
    case 32: return int(launch<32>(qf, kf, vf, bf, of, sf, seed, rate, B, Sq, Sk, E, H, scale, vec, st));
    case 64: return int(launch<64>(qf, kf, vf, bf, of, sf, seed, rate, B, Sq, Sk, E, H, scale, vec, st));
    case 128: return int(launch<128>(qf, kf, vf, bf, of, sf, seed, rate, B, Sq, Sk, E, H, scale, vec, st));
    default: return int(launch<256>(qf, kf, vf, bf, of, sf, seed, rate, B, Sq, Sk, E, H, scale, vec, st));
  }
}

const char* slt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
