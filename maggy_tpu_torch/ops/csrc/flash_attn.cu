// Flash attention for Hopper (sm_90a): forward, dK/dV backward, dQ backward.
//
// Replaces the three Pallas TPU kernels of maggy_tpu/ops/attention.py:
//   flash_fwd_kernel      <- _flash_fwd_kernel       (pallas_call at :226)
//   flash_bwd_dkdv_kernel <- _flash_bwd_dkdv_kernel  (pallas_call at :443)
//   flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel    (pallas_call at :482)
//
// Layouts (all row-major, contiguous): q/dO/out/dq [B,Sq,H,D], k/v/dk/dv
// [B,Sk,Hkv,D] with H % Hkv == 0 (GQA: query head h reads kv head h / rep,
// K/V are never repeated in memory), mask [B,Sk] int32 keep-mask or null,
// lse/delta [B,H,Sq] fp32.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the BERT-base
// training shape B=32, S=128, H=12, D=64, bf16: the forward moves ~25 MB
// (q,k,v read, out written, lse written) for ~1.6 GFLOP, about 7.5 us of
// memory time against 1.6 us of tensor-core time -- memory-bound. The two
// backward kernels together move ~69 MB (q,k,v,dO read, lse/delta read,
// dq,dk,dv written), about 21 us. PERF.md carries the measured times.
//
// Design. A TPU grid runs in order on one core and carries the online-softmax
// state across its innermost (sequential) grid dimension in VMEM scratch. On
// Hopper blocks run in parallel in no order, so each sequential grid
// dimension becomes a loop inside one block:
//   forward: one block per (b, h, q-tile), looping over k-tiles;
//   dK/dV:   one block per (b, kv-head, k-tile), looping over the group's
//            rep query heads and the q-tiles, so the GQA sum needs no atomics;
//   dQ:      one block per (b, h, q-tile), looping over k-tiles.
// Tiles are 64 x 64 with 256 threads: four threads own one tile row and split
// its D columns, so row reductions are two warp shuffles and the per-row
// accumulators stay in registers. Tiles are converted to fp32 in shared
// memory and all arithmetic is fp32 (as the Pallas kernel upcasts per tile);
// rows are padded by one float against bank conflicts. mma/wgmma, TMA and
// pipelining are later work: this version is simple and right first.
//
// Masking uses NEG_INF = -1e30, not -inf, so a query row whose keys are all
// masked yields exp(0) = 1 for every key it saw and returns the mean of V
// (the Pallas forward's behaviour). Causal masking is bottom-right aligned
// (offset = Sk - Sq) and k-tiles entirely above the diagonal are skipped with
// the Pallas test kb*BK < (qi+1)*BQ + offset. The backward treats masked
// entries as constants (ds = 0) and, for a fully masked row (lse below
// -1e29), gives every key of an unskipped tile p = 1/n: the exact gradient of
// the forward above.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;
constexpr float ALL_MASKED_LSE = -1e29f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows x D tile from global (row stride `stride` elements) into shared
// memory with leading dimension `ld`, converted to fp32 and scaled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          size_t stride, int rows, float scale) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * ld + c] = to_f(src[r * stride + c]) * scale;
  }
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

// Does k-tile kb contribute to q-tile qi (the Pallas causal skip test)?
__device__ __forceinline__ bool tile_live(int causal, int kb, int qi, int offset) {
  return !causal || kb * BK < (qi + 1) * BQ + offset;
}

__device__ __forceinline__ bool masked(int causal, const int* mask, int b, int Sk,
                                       int qpos, int kpos, int offset) {
  return (causal && kpos > qpos + offset) || (mask && mask[(size_t)b * Sk + kpos] == 0);
}

// Keys a fully masked row of q-tile qi averaged over in the forward.
__device__ __forceinline__ int keys_seen(int causal, int qi, int offset, int Sk) {
  if (!causal) return Sk;
  const int lim = (qi + 1) * BQ + offset;
  if (lim <= 0) return 0;
  return min(Sk, ((lim + BK - 1) / BK) * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, int H, int Hkv, int causal, float sm_scale) {
  constexpr int DP = D + 1, KP = BK + 1, DC = D / 4;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qpos = qi * BQ + row;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;

  load_tile<T, D>(sQ, DP, q + ((size_t)b * Sq + qi * BQ) * qs + (size_t)h * D, qs, BQ, sm_scale);
  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int kb = 0; kb < Sk / BK && tile_live(causal, kb, qi, offset); ++kb) {
    __syncthreads();  // the previous tile is fully consumed
    const size_t koff = ((size_t)b * Sk + kb * BK) * ks + (size_t)hk * D;
    load_tile<T, D>(sK, DP, k + koff, ks, BK, 1.f);
    load_tile<T, D>(sV, D, v + koff, ks, BK, 1.f);
    __syncthreads();

    float s[BK / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int j = part + 4 * i;
      float x = dot<D>(sQ + row * DP, sK + j * DP);
      if (masked(causal, mask, b, Sk, qpos, kb * BK + j, offset)) x = NEG_INF;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, row_max4(mx));
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float p = expf(s[i] - m_new);
      sP[row * KP + part + 4 * i] = p;
      sum += p;
    }
    l = alpha * l + row_sum4(sum);
    m = m_new;
    __syncwarp();  // a row's four threads share one warp
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = sP[row * KP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] += p * sV[j * D + part + 4 * c];
    }
  }

  const float l_safe = fmaxf(l, 1e-30f);
  T* o = out + ((size_t)b * Sq + qpos) * qs + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < DC; ++c) o[part + 4 * c] = from_f<T>(acc[c] / l_safe);
  if (part == 0) lse[((size_t)b * H + h) * Sq + qpos] = m + logf(l_safe);
}

template <typename T, typename G, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ mask, G* __restrict__ dk,
                      G* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                      int causal, float sm_scale) {
  constexpr int DP = D + 1, QP = BQ + 1, DC = D / 4;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DP;
  float* sQ = sV + BK * DP;
  float* sdO = sQ + BQ * DP;
  float* sP = sdO + BQ * DP;
  float* sdS = sP + BK * QP;
  float* sL = sdS + BK * QP;
  float* sDelta = sL + BQ;

  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv, offset = Sk - Sq;
  const int kr = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int kpos = kb * BK + kr;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const size_t koff = ((size_t)b * Sk + kb * BK) * ks + (size_t)hk * D;

  load_tile<T, D>(sK, DP, k + koff, ks, BK, 1.f);
  load_tile<T, D>(sV, DP, v + koff, ks, BK, 1.f);
  float dk_acc[DC], dv_acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    for (int qi = 0; qi < Sq / BQ; ++qi) {
      if (!tile_live(causal, kb, qi, offset)) continue;
      __syncthreads();
      const size_t qoff = ((size_t)b * Sq + qi * BQ) * qs + (size_t)h * D;
      load_tile<T, D>(sQ, DP, q + qoff, qs, BQ, 1.f);
      load_tile<T, D>(sdO, DP, dO + qoff, qs, BQ, 1.f);
      if (threadIdx.x < BQ) {
        const size_t st = ((size_t)b * H + h) * Sq + qi * BQ + threadIdx.x;
        sL[threadIdx.x] = lse[st];
        sDelta[threadIdx.x] = delta[st];
      }
      __syncthreads();
      const int n = keys_seen(causal, qi, offset, Sk);
      const float uniform = n > 0 ? 1.f / n : 0.f;
#pragma unroll 4
      for (int ii = 0; ii < BQ / 4; ++ii) {
        const int i = part + 4 * ii;
        float p, ds;
        if (masked(causal, mask, b, Sk, qi * BQ + i, kpos, offset)) {
          p = sL[i] < ALL_MASKED_LSE ? uniform : 0.f;
          ds = 0.f;
        } else {
          const float s = dot<D>(sQ + i * DP, sK + kr * DP) * sm_scale;
          p = expf(s - sL[i]);
          const float dp = dot<D>(sdO + i * DP, sV + kr * DP);
          ds = p * (dp - sDelta[i]) * sm_scale;
        }
        sP[kr * QP + i] = p;
        sdS[kr * QP + i] = ds;
      }
      __syncwarp();
      for (int i = 0; i < BQ; ++i) {
        const float p = sP[kr * QP + i], ds = sdS[kr * QP + i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[c] += p * sdO[i * DP + part + 4 * c];
          dk_acc[c] += ds * sQ[i * DP + part + 4 * c];
        }
      }
    }
  }

  const size_t o = ((size_t)b * Sk + kpos) * ks + (size_t)hk * D;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    dk[o + part + 4 * c] = from_f<G>(dk_acc[c]);
    dv[o + part + 4 * c] = from_f<G>(dv_acc[c]);
  }
}

template <typename T, typename G, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ mask, G* __restrict__ dq, int Sq,
                    int Sk, int H, int Hkv, int causal, float sm_scale) {
  constexpr int DP = D + 1, KP = BK + 1, DC = D / 4;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * DP;
  float* sK = sdO + BQ * DP;
  float* sV = sK + BK * DP;
  float* sdS = sV + BK * DP;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qpos = qi * BQ + row;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const size_t qoff = ((size_t)b * Sq + qi * BQ) * qs + (size_t)h * D;
  const size_t st = ((size_t)b * H + h) * Sq + qpos;
  const float my_lse = lse[st], my_delta = delta[st];

  load_tile<T, D>(sQ, DP, q + qoff, qs, BQ, 1.f);
  load_tile<T, D>(sdO, DP, dO + qoff, qs, BQ, 1.f);
  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  for (int kb = 0; kb < Sk / BK && tile_live(causal, kb, qi, offset); ++kb) {
    __syncthreads();
    const size_t koff = ((size_t)b * Sk + kb * BK) * ks + (size_t)hk * D;
    load_tile<T, D>(sK, DP, k + koff, ks, BK, 1.f);
    load_tile<T, D>(sV, DP, v + koff, ks, BK, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BK / 4; ++i) {
      const int j = part + 4 * i;
      float ds = 0.f;
      if (!masked(causal, mask, b, Sk, qpos, kb * BK + j, offset)) {
        const float s = dot<D>(sQ + row * DP, sK + j * DP) * sm_scale;
        const float p = expf(s - my_lse);
        const float dp = dot<D>(sdO + row * DP, sV + j * DP);
        ds = p * (dp - my_delta) * sm_scale;
      }
      sdS[row * KP + j] = ds;
    }
    __syncwarp();
    for (int j = 0; j < BK; ++j) {
      const float ds = sdS[row * KP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] += ds * sK[j * DP + part + 4 * c];
    }
  }

  G* o = dq + ((size_t)b * Sq + qpos) * qs + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < DC; ++c) o[part + 4 * c] = from_f<G>(acc[c]);
}

size_t fwd_smem(int D) { return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)); }
size_t dkdv_smem(int D) {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}
size_t dq_smem(int D) { return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)); }

template <typename T, int D>
cudaError_t fwd_t(const void* q, const void* k, const void* v, const int* mask,
                  void* out, float* lse, int B, int Sq, int Sk, int H, int Hkv,
                  int causal, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Sq / BQ, H, B), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, lse, Sq, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <typename T, typename G, int D>
cudaError_t dkdv_t(const void* q, const void* k, const void* v, const void* dO,
                   const float* lse, const float* delta, const int* mask, void* dk,
                   void* dv, int B, int Sq, int Sk, int H, int Hkv, int causal,
                   float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dkdv_kernel<T, G, D>;
  const size_t smem = dkdv_smem(D);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Sk / BK, Hkv, B), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, lse, delta, mask, (G*)dk, (G*)dv,
      Sq, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <typename T, typename G, int D>
cudaError_t dq_t(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* delta, const int* mask, void* dq,
                 int B, int Sq, int Sk, int H, int Hkv, int causal, float scale,
                 cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, G, D>;
  const size_t smem = dq_smem(D);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Sq / BQ, H, B), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, lse, delta, mask, (G*)dq,
      Sq, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16. grad_fp32 = 1 writes fp32 gradients
// from bf16 inputs (the ring-attention building block); otherwise gradients
// take the input type.
#define DISPATCH_D(D, CALL)                      \
  switch (D) {                                   \
    case 64: { constexpr int DD = 64; return CALL; }   \
    case 96: { constexpr int DD = 96; return CALL; }   \
    case 128: { constexpr int DD = 128; return CALL; } \
    default: return (int)cudaErrorInvalidValue;  \
  }

}  // namespace

extern "C" {

int flash_block_q() { return BQ; }
int flash_block_k() { return BK; }

int flash_fwd(const void* q, const void* k, const void* v, const int* mask,
              void* out, float* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
              int causal, int dtype, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    DISPATCH_D(D, (int)(fwd_t<float, DD>(q, k, v, mask, out, lse, B, Sq, Sk, H, Hkv, causal, scale, s)));
  }
  DISPATCH_D(D, (int)(fwd_t<__nv_bfloat16, DD>(q, k, v, mask, out, lse, B, Sq, Sk, H, Hkv, causal, scale, s)));
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dO,
                   const float* lse, const float* delta, const int* mask, void* dk,
                   void* dv, int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                   int dtype, int grad_fp32, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    DISPATCH_D(D, (int)(dkdv_t<float, float, DD>(q, k, v, dO, lse, delta, mask, dk, dv, B, Sq, Sk, H, Hkv, causal, scale, s)));
  }
  if (grad_fp32) {
    DISPATCH_D(D, (int)(dkdv_t<__nv_bfloat16, float, DD>(q, k, v, dO, lse, delta, mask, dk, dv, B, Sq, Sk, H, Hkv, causal, scale, s)));
  }
  DISPATCH_D(D, (int)(dkdv_t<__nv_bfloat16, __nv_bfloat16, DD>(q, k, v, dO, lse, delta, mask, dk, dv, B, Sq, Sk, H, Hkv, causal, scale, s)));
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* delta, const int* mask, void* dq,
                 int B, int Sq, int Sk, int H, int Hkv, int D, int causal, int dtype,
                 int grad_fp32, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    DISPATCH_D(D, (int)(dq_t<float, float, DD>(q, k, v, dO, lse, delta, mask, dq, B, Sq, Sk, H, Hkv, causal, scale, s)));
  }
  if (grad_fp32) {
    DISPATCH_D(D, (int)(dq_t<__nv_bfloat16, float, DD>(q, k, v, dO, lse, delta, mask, dq, B, Sq, Sk, H, Hkv, causal, scale, s)));
  }
  DISPATCH_D(D, (int)(dq_t<__nv_bfloat16, __nv_bfloat16, DD>(q, k, v, dO, lse, delta, mask, dq, B, Sq, Sk, H, Hkv, causal, scale, s)));
}

}  // extern "C"
