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
// sum l) and the incoming gradient dO [B,Sq,E]; outputs dq [B,Sq,E], dk and
// dv [B,Sk,E]. The bias gets no gradient, as in the TPU kernel's VJP. Any
// head width D <= 256.
//
// delta is rowsum(dP * P), as the TPU kernel takes it (its :174), and not
// the equal rowsum(dO * O) of FlashAttention: where one key takes all of a
// row's weight, dP - delta is a difference of two equal large numbers, and
// only the same P and dP on both sides make it exactly 0, as autograd of
// the plain version does. (Measured at D 256, Sq = Sk = 1, rate 0.5: the
// dO * O form left 2.8e-4 where autograd has 0.) For P to be exactly 1
// there, S is formed by the same function as in K1 (scores_abt), so the
// two kernels give the same bits for every score.
//
// What bounds it on the H100: its five [Sq,Sk,D] contractions a head
// (10·B·Sq·Sk·E FLOPs against 67 TFLOP/s of f32) come long before its bytes.
// The first design did nine of them (S and dP formed three times) on the
// CUDA cores with scalar shared-memory loops, at 8% of that bound. This one
// does each of the five once, all on the tensor cores as 3xTF32 mma.sync
// (attention_mma.cuh), in two kernels on the caller's stream, and keeps the
// [Sq,Sk] terms between them in two scratch tensors pd and ds [B,H,Sq,SkP]
// (SkP = Sk rounded up to 64; 24.6 MB each at B 50, H 8, S 120) that the
// wrapper allocates:
//   A. one block per (64 query rows, head, batch row), 4 warps of 16 rows,
//      K/V tiles of 32 keys (16 above D 64) double-buffered through cp.async:
//        pass 1: S = Q K^T and dP = dO V^T (contractions 1 and 2), P from
//                (m, l), the keep-mask and scale applied to dP; P goes to pd
//                and the kept dP to ds, and each thread sums its share of
//                delta = rowsum(dP * P) from exactly these values;
//        pass 2: each thread reads back what it wrote, forms dS = P * (dP -
//                delta) into ds (and P_d into pd under dropout) and
//                accumulates dQ = dS K * scale (contraction 3) over K tiles
//                streamed again;
//   B. one block per (64 keys, column chunk of up to 128, head, batch row),
//      4 warps of 16 keys, Q/dO tiles of 32 queries double-buffered through
//      cp.async: dV = P_d^T dO and dK = dS^T Q * scale (contractions 4 and
//      5), with P_d and dS read from the scratch as A fragments.
// Each output element is written by one thread that sums in a fixed order,
// so there are no atomics and runs repeat bit for bit. Masking follows K1:
// finite biases, nothing skipped, so a row whose keys are all masked has the
// uniform P of the forward.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_mma.cuh"
#include "dropout_mask.cuh"

namespace {

using slt::kThreads;
constexpr int kBQ = slt::kWarps * 16;   // A: query rows per block
constexpr int kBKB = slt::kWarps * 16;  // B: keys per block
constexpr int kBQB = 32;                // B: queries per tile
constexpr int kSkAlign = 64;            // scratch rows padded to this

// A's keys per tile: 16 from D 128 up keeps two blocks on an SM (101 KB of
// shared memory at DP 128, where 32 keys take 135 KB).
template <int DP>
__host__ __device__ constexpr int key_tile() { return DP > 64 ? 16 : 32; }

// B's column chunk: its accumulators are 2 x DC/2 registers a thread.
template <int DP>
__host__ __device__ constexpr int col_chunk() { return DP > 128 ? 128 : DP; }

template <int DP>
constexpr size_t rows_smem_bytes() {
  // Q and dO tiles [kBQ][DP+4], K and V tiles [2][kBK][DP+4] each.
  return sizeof(float) * size_t(DP + 4) * (2 * kBQ + 4 * key_tile<DP>());
}

template <int DC>
constexpr size_t keys_smem_bytes() {
  // Q and dO tiles [2][kBQB][DC+4] each.
  return sizeof(float) * size_t(DC + 4) * 4 * kBQB;
}

int padded_keys(int Sk) { return (Sk + kSkAlign - 1) / kSkAlign * kSkAlign; }

template <int DP, bool kDropout>
__global__ void __launch_bounds__(kThreads)
attention_bwd_rows_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ bias,
                          const float* __restrict__ dout,
                          const float2* __restrict__ stats,
                          const int* __restrict__ seeds, int threshold,
                          float inv_keep, float* __restrict__ dq,
                          float* __restrict__ pd, float* __restrict__ ds,
                          int Sq, int Sk, int SkP, int E, int D, float scale,
                          bool vec) {
  constexpr int kBK = key_tile<DP>();
  constexpr int LD = DP + 4;
  constexpr int NT = kBK / 8;
  constexpr int ND = DP / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + 2 * kBK * LD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  const bool warp_active = q0 + wrow < Sq;
  const size_t head = size_t(h) * D;
  const float* qb = q + size_t(b) * Sq * E + head;
  const float* dob = dout + size_t(b) * Sq * E + head;
  const float* kb = k + size_t(b) * Sk * E + head;
  const float* vb = v + size_t(b) * Sk * E + head;
  const float* biasb = bias + size_t(b) * Sq * Sk;
  const size_t bh = size_t(b) * H + h;
  float* pdb = pd + bh * Sq * SkP;
  float* dsb = ds + bh * Sq * SkP;

  slt::load_tile<kBQ, DP>(sQ, qb, q0, Sq, 0, D, E, vec);
  slt::load_tile<kBQ, DP>(sdO, dob, q0, Sq, 0, D, E, vec);
  slt::load_tile<kBK, DP>(sK, kb, 0, Sk, 0, D, E, vec);
  slt::load_tile<kBK, DP>(sV, vb, 0, Sk, 0, D, E, vec);
  slt::cp_async_commit();

  float m[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  uint32_t row_key[2] = {0u, 0u};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < Sq) {
      const float2 st = stats[bh * Sq + rows[r]];
      m[r] = st.x;
      inv_l[r] = 1.f / st.y;
    }
    if constexpr (kDropout)
      row_key[r] = slt_dropout_row_key(seeds[b], h, rows[r]);
  }

  // Pass 1: P and the kept dP to the scratch, delta from the same values.
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
    __syncthreads();

    if (warp_active) {  // warp-uniform; the barriers still run
      float s[NT][4], dp[NT][4];
      slt::scores_abt<DP, NT>(s, sQ + wrow * LD, sK + buf * kBK * LD, g, t);
      slt::scores_abt<DP, NT>(dp, sdO + wrow * LD, sV + buf * kBK * LD, g,
                              t);
      const int k0 = kt * kBK;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, key = k0 + 8 * j + 2 * t + (e & 1);
          float p = 0.f, dpk = 0.f;
          if (key < Sk && rows[r] < Sq) {
            const float x = fmaf(s[j][e], scale,
                                 __ldg(biasb + size_t(rows[r]) * Sk + key));
            p = expf(x - m[r]) * inv_l[r];
            dpk = dp[j][e];
            if constexpr (kDropout)
              dpk = slt_dropout_keep(row_key[r], key, threshold)
                        ? dpk * inv_keep : 0.f;
          }
          delta[r] = fmaf(p, dpk, delta[r]);
          s[j][e] = p;
          dp[j][e] = dpk;
        }
        const int key = k0 + 8 * j + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (rows[r] >= Sq) continue;
          const size_t off = size_t(rows[r]) * SkP + key;
          *reinterpret_cast<float2*>(pdb + off) =
              make_float2(s[j][2 * r], s[j][2 * r + 1]);
          *reinterpret_cast<float2*>(dsb + off) =
              make_float2(dp[j][2 * r], dp[j][2 * r + 1]);
        }
      }
    }
    __syncthreads();  // buffer buf is consumed before it is refilled
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) delta[r] = slt::quad_sum(delta[r]);

  // Pass 2: dS = P * (dP - delta), dQ += dS K.
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  slt::load_tile<kBK, DP>(sK, kb, 0, Sk, 0, D, E, vec);
  slt::cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles)
      slt::load_tile<kBK, DP>(sK + (buf ^ 1) * kBK * LD, kb, (kt + 1) * kBK,
                              Sk, 0, D, E, vec);
    slt::cp_async_commit();
    slt::cp_async_wait1();
    __syncthreads();

    if (warp_active) {
      const int k0 = kt * kBK;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int key = k0 + 8 * j + 2 * t;
        float dsv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (rows[r] >= Sq) continue;
          const size_t off = size_t(rows[r]) * SkP + key;
          const float2 p = *reinterpret_cast<const float2*>(pdb + off);
          const float2 dpk = *reinterpret_cast<const float2*>(dsb + off);
          dsv[2 * r] = p.x * (dpk.x - delta[r]);
          dsv[2 * r + 1] = p.y * (dpk.y - delta[r]);
          *reinterpret_cast<float2*>(dsb + off) =
              make_float2(dsv[2 * r], dsv[2 * r + 1]);
          if constexpr (kDropout) {
            const bool k0_ok = slt_dropout_keep(row_key[r], key, threshold);
            const bool k1_ok = slt_dropout_keep(row_key[r], key + 1, threshold);
            *reinterpret_cast<float2*>(pdb + off) = make_float2(
                k0_ok ? p.x * inv_keep : 0.f, k1_ok ? p.y * inv_keep : 0.f);
          }
        }
        slt::accumulate_pv<DP>(acc, dsv[0], dsv[1], dsv[2], dsv[3],
                               sK + buf * kBK * LD + 8 * j * LD, g, t);
      }
    }
    __syncthreads();
  }

  if (!warp_active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    float* out = dq + (size_t(b) * Sq + rows[r]) * E + head;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < D) out[d] = acc[n][2 * r + e] * scale;
      }
  }
}

// One A fragment of X^T for 16 keys (key0 + g, key0 + g + 8) and 8 queries
// (qa = 2t, qa + 1: the k order of accumulate_pv), from the scratch X
// [Sq][SkP]; 0 past Sq or Sk.
__device__ __forceinline__ void scratch_at(const float* x, int q, int key0,
                                           int g, int Sq, int Sk, int SkP,
                                           float (&a)[4]) {
  const int keys[2] = {key0 + g, key0 + g + 8};
#pragma unroll
  for (int i = 0; i < 2; ++i)    // query q + i
#pragma unroll
    for (int r = 0; r < 2; ++r)  // key row g or g + 8
      a[2 * i + r] = q + i < Sq && keys[r] < Sk
                         ? x[size_t(q + i) * SkP + keys[r]] : 0.f;
}

template <int DC>
__global__ void __launch_bounds__(kThreads)
attention_bwd_keys_kernel(const float* __restrict__ q,
                          const float* __restrict__ dout,
                          const float* __restrict__ pd,
                          const float* __restrict__ ds,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Sq, int Sk, int SkP, int E, int D, int n_chunks,
                          float scale, bool vec) {
  constexpr int LD = DC + 4;
  constexpr int ND = DC / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + 2 * kBQB * LD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int kt0 = (blockIdx.x / n_chunks) * kBKB;
  const int c0 = (blockIdx.x % n_chunks) * DC;  // first column in the head
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = kt0 + warp * 16;
  const bool warp_active = key0 < Sk;
  const size_t head = size_t(h) * D;
  const float* qb = q + size_t(b) * Sq * E + head;
  const float* dob = dout + size_t(b) * Sq * E + head;
  const size_t bh = size_t(b) * H + h;
  const float* pdb = pd + bh * Sq * SkP;
  const float* dsb = ds + bh * Sq * SkP;

  slt::load_tile<kBQB, DC>(sQ, qb, 0, Sq, c0, D, E, vec);
  slt::load_tile<kBQB, DC>(sdO, dob, 0, Sq, c0, D, E, vec);
  slt::cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int n_tiles = (Sq + kBQB - 1) / kBQB;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < n_tiles) {
      const int nxt = (buf ^ 1) * kBQB * LD;
      slt::load_tile<kBQB, DC>(sQ + nxt, qb, (qt + 1) * kBQB, Sq, c0, D, E,
                               vec);
      slt::load_tile<kBQB, DC>(sdO + nxt, dob, (qt + 1) * kBQB, Sq, c0, D, E,
                               vec);
    }
    slt::cp_async_commit();
    slt::cp_async_wait1();
    __syncthreads();

    if (warp_active) {
      const float* tQ = sQ + buf * kBQB * LD;
      const float* tdO = sdO + buf * kBQB * LD;
#pragma unroll
      for (int kc = 0; kc < kBQB / 8; ++kc) {
        const int qa = qt * kBQB + 8 * kc + 2 * t;
        float pa[4], sa[4];
        scratch_at(pdb, qa, key0, g, Sq, Sk, SkP, pa);
        scratch_at(dsb, qa, key0, g, Sq, Sk, SkP, sa);
        // pa/sa hold (q, g), (q, g+8), (q+1, g), (q+1, g+8): as the C
        // fragment order c0..c3 of accumulate_pv they are (g,2t), (g,2t+1),
        // (g+8,2t), (g+8,2t+1).
        slt::accumulate_pv<DC>(acc_v, pa[0], pa[2], pa[1], pa[3],
                               tdO + 8 * kc * LD, g, t);
        slt::accumulate_pv<DC>(acc_k, sa[0], sa[2], sa[1], sa[3],
                               tQ + 8 * kc * LD, g, t);
      }
    }
    __syncthreads();
  }

  if (!warp_active) return;
  const int keys[2] = {key0 + g, key0 + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= Sk) continue;
    const size_t off = (size_t(b) * Sk + keys[r]) * E + head;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = c0 + 8 * n + 2 * t + e;
        if (d < D) {
          dk[off + d] = acc_k[n][2 * r + e] * scale;
          dv[off + d] = acc_v[n][2 * r + e];
        }
      }
  }
}

struct BwdArgs {
  const float *q, *k, *v, *bias, *dout;
  const float2* stats;
  const int* seeds;
  float *dq, *dk, *dv, *pd, *ds;
  int B, Sq, Sk, E, H;
  float scale;
  int threshold;
  float inv_keep;
  bool vec;
  cudaStream_t stream;
};

template <int DP, bool kDropout>
cudaError_t launch_main(const BwdArgs& a) {
  constexpr int DC = col_chunk<DP>();
  constexpr size_t rows_smem = rows_smem_bytes<DP>();
  constexpr size_t keys_smem = keys_smem_bytes<DC>();
  // Above 48 KB a block's shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_rows_kernel<DP, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(rows_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_keys_kernel<DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(keys_smem));
  if (err != cudaSuccess) return err;
  const int D = a.E / a.H;
  const int SkP = padded_keys(a.Sk);
  const dim3 rows_grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  attention_bwd_rows_kernel<DP, kDropout><<<rows_grid, kThreads, rows_smem,
                                            a.stream>>>(
      a.q, a.k, a.v, a.bias, a.dout, a.stats, a.seeds, a.threshold,
      a.inv_keep, a.dq, a.pd, a.ds, a.Sq, a.Sk, SkP, a.E, D, a.scale, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_chunks = DP / DC;
  const dim3 keys_grid((a.Sk + kBKB - 1) / kBKB * n_chunks, a.H, a.B);
  attention_bwd_keys_kernel<DC><<<keys_grid, kThreads, keys_smem,
                                  a.stream>>>(
      a.q, a.dout, a.pd, a.ds, a.dk, a.dv, a.Sq, a.Sk, SkP, a.E, D, n_chunks,
      a.scale, a.vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const BwdArgs& a, bool dropout) {
  return dropout ? launch_main<DP, true>(a) : launch_main<DP, false>(a);
}

}  // namespace

extern "C" {

// Floats of each of the two scratch tensors (pd, ds) the backward takes.
long long slt_fused_attention_bwd_scratch_floats(int B, int Sq, int Sk,
                                                 int H) {
  return static_cast<long long>(B) * H * Sq * padded_keys(Sk);
}

// Returns 0 on success, else a cudaError_t code (cudaErrorInvalidValue for a
// head width above 256, for shapes the grid cannot hold, for a rate outside
// [0, 1], or for dropout without seeds). The two kernels run in order on
// `stream`; pd and ds are scratch of slt_fused_attention_bwd_scratch_floats
// floats each.
int slt_fused_attention_bwd_f32(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* stats,
                                const void* seeds, float rate, void* dq,
                                void* dk, void* dv, void* pd, void* ds,
                                int B, int Sq, int Sk, int E, int H,
                                float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || E % H != 0 || E / H > 256 ||
      B > 65535 || H > 65535 || !(rate >= 0.f && rate <= 1.f) ||
      (rate > 0.f && seeds == nullptr))
    return int(cudaErrorInvalidValue);
  const int D = E / H;
  BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(bias),
            static_cast<const float*>(dout),
            static_cast<const float2*>(stats), static_cast<const int*>(seeds),
            static_cast<float*>(dq), static_cast<float*>(dk),
            static_cast<float*>(dv), static_cast<float*>(pd),
            static_cast<float*>(ds), B, Sq, Sk, E, H, scale,
            slt_dropout_threshold(rate), slt_dropout_inv(rate),
            D % 4 == 0 && slt::aligned16(q) && slt::aligned16(k) &&
                slt::aligned16(v) && slt::aligned16(dout),
            static_cast<cudaStream_t>(stream)};
  const bool dropout = rate > 0.f;
  switch (slt::padded_width(D)) {
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
