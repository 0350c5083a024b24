// Flash attention for Hopper (sm_90a): forward, dK/dV backward, dQ backward.
//
// Replaces the three Pallas TPU kernels of maggy_tpu/ops/attention.py:
//   bf16: flash_fwd_tc_kernel       <- _flash_fwd_kernel       (pallas_call at :226)
//         flash_bwd_dkdv_tc_kernel  <- _flash_bwd_dkdv_kernel  (pallas_call at :443)
//         flash_bwd_dq_tc_kernel    <- _flash_bwd_dq_kernel    (pallas_call at :482)
//   fp32: flash_fwd_kernel, flash_bwd_dkdv_kernel, flash_bwd_dq_kernel (the
//         same three, on CUDA cores)
//   D > 256: flash_{fwd,bwd_dkdv,bwd_dq}_split_tc_kernel (bf16) and
//         flash_{fwd,bwd_dkdv,bwd_dq}_split_kernel (fp32), split over D
//
// Layouts (all row-major, contiguous): q/dO/out/dq [B,Sq,H,D], k/v/dk/dv
// [B,Sk,Hkv,D] with H % Hkv == 0 (GQA: query head h reads kv head h / rep,
// K/V are never repeated in memory), mask [B,Sk] int32 keep-mask or null,
// lse/delta [B,H,Sq] fp32.
//
// Head dims. The Pallas kernels take any D >= 64 with D % 8 == 0, and so do
// these. Up to D = 256 the source compiles once per kernel width W, D
// rounded up to a multiple of 16 (-DFLASH_W=W, W in 64, 80, ..., 256:
// ops/build.py VARIANTS), each build a library of its own (ops/attention.py
// kernel_build picks it). Every loop over D runs over W at compile time, as
// the tensor cores' k16 steps need; D itself is read only by the loads, the
// stores and delta's prologue. Where D % 16 == 8 (W = D + 8) the last k16
// step of a reduction over D (Q K^T, dO V^T) reads the 8 columns past D: the
// bf16 tiles' columns D..W-1 are zeroed once per block and cp.async never
// writes them, and the fp32 tiles are loaded with zeros there. The
// tensor-core kernels are compiled twice per width: EXACT (D == W) folds D
// to a constant, so a D that is a multiple of 16 runs the code a build for
// that D alone would give (a run-time D there cost registers and a resident
// block per SM at D = 64: dQ 168 -> 179 registers, 3 -> 2 blocks); the
// other takes D = W - 8 at run time. The fp32 kernels take D at run time.
// Above 256 one more build (-DFLASH_SPLIT) takes every D of the rule, with
// no upper bound, at run time: the split-D kernels (their section below)
// cut the output's columns into 128-wide slices, one block each.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the BERT-base
// training shape B=32, S=128, H=12, D=64, bf16, padded: the forward moves
// ~25 MB (q,k,v read, out and lse written) for ~1.6 GFLOP: 7.6 us of memory
// time against ~1.6 us of tensor-core time, so bytes bound it; dK/dV moves
// ~38 MB (11.4 us) and dQ ~32 MB (9.5 us; ~38 MB when it also reads O and
// writes delta), bytes again. The causal Llama shapes (2 x 2048, D = 128 or
// 80) are bound by operations. chip_smoke.py computes the bound from each
// run's inputs; PERF.md carries the times.
//
// Design. A TPU grid runs in order on one core and carries the online-softmax
// state across its innermost (sequential) grid dimension in VMEM scratch. On
// Hopper blocks run in parallel in no order, so each sequential grid
// dimension becomes a loop inside one block:
//   forward: one block per (b, h, q-tile), looping over k-tiles;
//   dK/dV:   one block per (b, kv-head, k-tile), looping over the group's
//            rep query heads and the q-tiles, so the GQA sum needs no atomics;
//   dQ:      one block per (b, h, q-tile), looping over k-tiles.
//
// bf16 inputs (the training path) run on tensor cores. Four warps per block,
// each owning 16 rows (query rows in the forward and dQ, key rows in dK/dV).
// Tiles stay bf16 in shared memory, rows padded by 16 bytes so the eight row
// addresses of an ldmatrix fall in distinct banks. Loads are cp.async, 16
// bytes a thread, double-buffered: the next K/V tile (forward, dQ) or (Q, dO,
// lse, delta) tile (dK/dV) lands while the current one computes. Every
// product is mma.sync.m16n8k16 bf16 with fp32 accumulation, fed by ldmatrix
// (ldmatrix.trans where the shared tile is the row-major B operand). The
// m16n8 fp32 accumulator of S (or S^T) is exactly the m16k16 A fragment of
// the next product once rounded to bf16, so P and dS never leave registers;
// a row's max and sum need only the shuffles inside a quad.
//   forward: S = Q K^T (Q fragments held in registers), online softmax, O += P V;
//   dK/dV:   S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, so P
//            and dS come out in key-row layout, ready as A operands;
//   dQ:      S = Q K^T, dP = dO V^T, dQ += dS K (K through ldmatrix.trans).
// The products whose output runs over D (P V, P^T dO, dS^T Q, dS K) step
// over W in pairs of n8 tiles; where D % 16 == 8 the last pair's second
// tile multiplies zero columns into a register that is never stored.
// ~47 KB (forward), ~37 KB (dK/dV) and ~55 KB (dQ) of shared memory at W=64,
// 169 / 136 / 203 KB at W=256. At the largest widths the accumulators (W/2
// fp32 registers a thread for O or dQ, W for dK and dV together) no longer
// fit in registers and spill: right, not fast (PERF.md has the resources).
//
// delta = rowsum(dO * O) is computed by the dQ kernels when given O (the
// autograd backward runs dQ first and hands its delta to dK/dV): a dQ block
// already holds its rows' dO, where a dK/dV block would recompute delta for
// every q-tile it visits. Given delta instead (the ring building block's
// global delta), they read it.
//
// fp32 inputs run on the simple kernels: tiles converted to fp32 in shared
// memory, every product fp32 FMA on CUDA cores (tensor cores would break the
// fp32 tolerance), 64 x 64 tiles, 256 threads, four threads per tile row.
// Above W=192 the dK/dV kernel's query step and the dQ kernel's key step
// drop to 32 rows, so that their tiles fit in a block's 227 KB.
//
// Masking uses NEG_INF = -1e30, not -inf, so a query row whose keys are all
// masked yields exp(0) = 1 for every key it saw and returns the mean of V
// (the Pallas forward's behaviour). Causal masking is bottom-right aligned
// (offset = Sk - Sq). Key tiles wholly above the diagonal are skipped with
// the Pallas test kb*128 < (qi+1)*128 + offset at SKIP = 128, the tile size
// the JAX package runs its kernels at, whatever tile a kernel here computes
// in: which keys a fully masked causal row averages over depends on the
// skip granularity, so it must match the reference, not the CUDA tiling.
// The backward treats masked entries as constants (ds = 0) and, for a fully
// masked row (lse below -1e29), gives every key of an unskipped tile
// p = 1/n: the exact gradient of the forward above.

#if defined(FLASH_W) == defined(FLASH_SPLIT)
#error "build with -DFLASH_W=<kernel width> (64, 80, ..., 256) or -DFLASH_SPLIT (ops/build.py VARIANTS)"
#endif

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int SKIP = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int TC_NT = 128;  // tensor-core kernels: 4 warps x 16 rows
constexpr int TC_BQ = 64;   // forward query rows per block
constexpr int TC_BK = 64;   // key rows per tile (forward) and per block (dK/dV)
// dK/dV query rows per step: 32 keeps the 2 x 16 x D accumulators and the
// two 16 x 32 score fragments in registers (no spills up to D=128).
constexpr int TC_BWD_BQ = 32;
constexpr float NEG_INF = -1e30f;
constexpr float ALL_MASKED_LSE = -1e29f;
constexpr float LOG2E = 1.4426950408889634f;

// The fp32 kernels' inner tile (dK/dV: query rows a step; dQ: key rows a
// step): 64, or 32 above width 192, where two 64-row fp32 tiles of K/V and
// two of Q/dO no longer fit in a block's 232,448 bytes. 32 divides SKIP.
__host__ __device__ constexpr int fp32_tile(int W) { return W <= 192 ? 64 : 32; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Keys (a prefix of the Sk keys) a query tile starting at row q0 sees: all
// when not causal, else the whole SKIP-key tiles that start left of its
// SKIP-row tile's diagonal (the Pallas skip test at 128 x 128). A tile of
// any size dividing SKIP is processed iff its first key lies below this.
__device__ __forceinline__ int keys_seen(int causal, int q0, int offset, int Sk) {
  if (!causal) return Sk;
  const int lim = (q0 / SKIP + 1) * SKIP + offset;
  if (lim <= 0) return 0;
  return min(Sk, ((lim + SKIP - 1) / SKIP) * SKIP);
}

__device__ __forceinline__ bool masked(int causal, const int* mask, int b, int Sk,
                                       int qpos, int kpos, int offset) {
  return (causal && kpos > qpos + offset) || (mask && mask[(size_t)b * Sk + kpos] == 0);
}

// ------------------------------------------------ fp32 kernels (CUDA cores)

// rows x W tile from global (row stride `stride` elements, D real columns)
// into shared memory with leading dimension `ld`, converted to fp32 and
// scaled; columns D..W-1 are written as zeros, so sums over W see D columns.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          size_t stride, int rows, int D, float scale) {
  for (int idx = threadIdx.x; idx < rows * W; idx += NT) {
    const int r = idx / W, c = idx % W;
    dst[r * ld + c] = c < D ? to_f(src[r * stride + c]) * scale : 0.f;
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

template <int W>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < W; ++d) s += a[d] * b[d];
  return s;
}

template <typename T, int W>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, int H, int Hkv, int D, int causal, float sm_scale) {
  constexpr int DP = W + 1, KP = BK + 1, DC = W / 4;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * W;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qpos = qi * BQ + row;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const int n_keys = keys_seen(causal, qi * BQ, offset, Sk);

  load_tile<T, W>(sQ, DP, q + ((size_t)b * Sq + qi * BQ) * qs + (size_t)h * D, qs, BQ, D,
                  sm_scale);
  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int kb = 0; kb * BK < n_keys; ++kb) {
    __syncthreads();  // the previous tile is fully consumed
    const size_t koff = ((size_t)b * Sk + kb * BK) * ks + (size_t)hk * D;
    load_tile<T, W>(sK, DP, k + koff, ks, BK, D, 1.f);
    load_tile<T, W>(sV, W, v + koff, ks, BK, D, 1.f);
    __syncthreads();

    float s[BK / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int j = part + 4 * i;
      float x = dot<W>(sQ + row * DP, sK + j * DP);
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
      for (int c = 0; c < DC; ++c) acc[c] += p * sV[j * W + part + 4 * c];
    }
  }

  const float l_safe = fmaxf(l, 1e-30f);
  T* o = out + ((size_t)b * Sq + qpos) * qs + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < DC; ++c)
    if (part + 4 * c < D) o[part + 4 * c] = from_f<T>(acc[c] / l_safe);
  if (part == 0) lse[((size_t)b * H + h) * Sq + qpos] = m + logf(l_safe);
}

template <typename T, typename G, int W>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ mask, G* __restrict__ dk,
                      G* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int D,
                      int causal, float sm_scale) {
  constexpr int QT = fp32_tile(W), DP = W + 1, QP = QT + 1, DC = W / 4;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DP;
  float* sQ = sV + BK * DP;
  float* sdO = sQ + QT * DP;
  float* sP = sdO + QT * DP;
  float* sdS = sP + BK * QP;
  float* sL = sdS + BK * QP;
  float* sDelta = sL + QT;

  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv, offset = Sk - Sq;
  const int kr = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int kpos = kb * BK + kr;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const size_t koff = ((size_t)b * Sk + kb * BK) * ks + (size_t)hk * D;

  load_tile<T, W>(sK, DP, k + koff, ks, BK, D, 1.f);
  load_tile<T, W>(sV, DP, v + koff, ks, BK, D, 1.f);
  float dk_acc[DC], dv_acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    for (int qi = 0; qi < Sq / QT; ++qi) {
      const int n = keys_seen(causal, qi * QT, offset, Sk);
      if (kb * BK >= n) continue;
      __syncthreads();
      const size_t qoff = ((size_t)b * Sq + qi * QT) * qs + (size_t)h * D;
      load_tile<T, W>(sQ, DP, q + qoff, qs, QT, D, 1.f);
      load_tile<T, W>(sdO, DP, dO + qoff, qs, QT, D, 1.f);
      if (threadIdx.x < QT) {
        const size_t st = ((size_t)b * H + h) * Sq + qi * QT + threadIdx.x;
        sL[threadIdx.x] = lse[st];
        sDelta[threadIdx.x] = delta[st];
      }
      __syncthreads();
      const float uniform = 1.f / n;
#pragma unroll 4
      for (int ii = 0; ii < QT / 4; ++ii) {
        const int i = part + 4 * ii;
        float p, ds;
        if (masked(causal, mask, b, Sk, qi * QT + i, kpos, offset)) {
          p = sL[i] < ALL_MASKED_LSE ? uniform : 0.f;
          ds = 0.f;
        } else {
          const float s = dot<W>(sQ + i * DP, sK + kr * DP) * sm_scale;
          p = expf(s - sL[i]);
          const float dp = dot<W>(sdO + i * DP, sV + kr * DP);
          ds = p * (dp - sDelta[i]) * sm_scale;
        }
        sP[kr * QP + i] = p;
        sdS[kr * QP + i] = ds;
      }
      __syncwarp();
      for (int i = 0; i < QT; ++i) {
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
    if (part + 4 * c < D) {
      dk[o + part + 4 * c] = from_f<G>(dk_acc[c]);
      dv[o + part + 4 * c] = from_f<G>(dv_acc[c]);
    }
  }
}

// With `o` set, delta is computed here (four threads a row) and written to
// delta_out; else it is read from `delta`.
template <typename T, typename G, int W>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const T* __restrict__ o, float* __restrict__ delta_out,
                    const int* __restrict__ mask, G* __restrict__ dq, int Sq,
                    int Sk, int H, int Hkv, int D, int causal, float sm_scale) {
  constexpr int KT = fp32_tile(W), DP = W + 1, KP = KT + 1, DC = W / 4;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * DP;
  float* sK = sdO + BQ * DP;
  float* sV = sK + KT * DP;
  float* sdS = sV + KT * DP;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qpos = qi * BQ + row;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const size_t qoff = ((size_t)b * Sq + qi * BQ) * qs + (size_t)h * D;
  const size_t st = ((size_t)b * H + h) * Sq + qpos;
  const float my_lse = lse[st];
  float my_delta;
  if (o) {
    const size_t r = qoff + (size_t)row * qs;
    float sum = 0.f;
    for (int c = part; c < D; c += 4) sum += to_f(dO[r + c]) * to_f(o[r + c]);
    my_delta = row_sum4(sum);
    if (part == 0) delta_out[st] = my_delta;
  } else {
    my_delta = delta[st];
  }
  const int n_keys = keys_seen(causal, qi * BQ, offset, Sk);

  load_tile<T, W>(sQ, DP, q + qoff, qs, BQ, D, 1.f);
  load_tile<T, W>(sdO, DP, dO + qoff, qs, BQ, D, 1.f);
  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  for (int kb = 0; kb * KT < n_keys; ++kb) {
    __syncthreads();
    const size_t koff = ((size_t)b * Sk + kb * KT) * ks + (size_t)hk * D;
    load_tile<T, W>(sK, DP, k + koff, ks, KT, D, 1.f);
    load_tile<T, W>(sV, DP, v + koff, ks, KT, D, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < KT / 4; ++i) {
      const int j = part + 4 * i;
      float ds = 0.f;
      if (!masked(causal, mask, b, Sk, qpos, kb * KT + j, offset)) {
        const float s = dot<W>(sQ + row * DP, sK + j * DP) * sm_scale;
        const float p = expf(s - my_lse);
        const float dp = dot<W>(sdO + row * DP, sV + j * DP);
        ds = p * (dp - my_delta) * sm_scale;
      }
      sdS[row * KP + j] = ds;
    }
    __syncwarp();
    for (int j = 0; j < KT; ++j) {
      const float ds = sdS[row * KP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] += ds * sK[j * DP + part + 4 * c];
    }
  }

  G* dq_row = dq + ((size_t)b * Sq + qpos) * qs + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < DC; ++c)
    if (part + 4 * c < D) dq_row[part + 4 * c] = from_f<G>(acc[c]);
}

// ------------------------------------------- bf16 kernels (tensor cores)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of every lane receives its (lane/4, 2*(lane%4)) pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed: lane gets its (2*(lane%4), lane/4) pair.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of the 16x16 chunk kc of a 16 x 8n accumulator: n-tiles
// 2kc and 2kc+1, rounded to bf16. The m16n8 accumulator holds (g, 2t..2t+1)
// in c0,c1 and (g+8, 2t..2t+1) in c2,c3; the m16k16 A fragment wants
// (g, 2t..) (g+8, 2t..) (g, 8+2t..) (g+8, 8+2t..) in a0..a3.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ROWS x D bf16 tile (global row stride `stride` elements) into shared
// memory with row stride LD, 16 bytes per cp.async; columns D..W-1 are
// left alone (zero_pad wrote them).
template <int ROWS, int W, int LD>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, size_t stride, int D) {
  constexpr int CPR = W / 8;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += TC_NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    if (c < D) cp_async16(dst + r * LD + c, src + r * stride + c);
  }
}

// Columns D..W-1 of `rows` consecutive tile rows (row stride LD) set to
// zero, once per block before the first cp.async: the k16 steps of a
// reduction over D read up to the next multiple of 16, and nothing else
// ever writes these columns or stores them out.
template <int W, int LD>
__device__ __forceinline__ void zero_pad(bf16* tile, int rows, int D) {
  const int chunks = (W - D) / 8;  // 16-byte chunks a row
  if (chunks == 0) return;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += TC_NT) {
    const int r = idx / chunks, c = D + (idx % chunks) * 8;
    *reinterpret_cast<uint4*>(tile + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Address giving ldmatrix.x4 the A fragment (16 rows from `row0`, columns
// col0..col0+15) of a row-major tile.
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int ld, int row0, int col0,
                                              int lane) {
  return tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}

// Address giving ldmatrix.x4 the B fragments of two n-tiles (rows n0..n0+15
// of a tile stored n-major, i.e. B^T row-major, k columns col0..col0+15):
// registers {0,1} for n-tile n0, {2,3} for n0+8.
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int ld, int n0, int col0,
                                               int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + col0 + ((lane >> 3) & 1) * 8;
}

// Address giving ldmatrix.x4.trans the B fragments of two n-tiles from a
// tile stored k-major (B row-major: rows k0..k0+15, columns n0..n0+15):
// registers {0,1} for columns n0..n0+7, {2,3} for n0+8..n0+15.
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int ld, int k0, int n0,
                                              int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

// Shared row stride of a bf16 tile of width W (a multiple of 16): W plus 16
// bytes, so the eight rows one ldmatrix reads start in eight different
// 16-byte bank groups.
__host__ __device__ constexpr int tc_ld(int W) { return W + 8; }

template <int W, bool EXACT>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ mask,
                    bf16* __restrict__ out, float* __restrict__ lse,
                    int Sq, int Sk, int H, int Hkv, int D_run, int causal, float sm_scale) {
  constexpr int LD = tc_ld(W), KC = W / 16, DT = W / 8, ST = TC_BK / 8;
  const int D = EXACT ? W : D_run;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + TC_BQ * LD;    // [2][TC_BK][LD]
  bf16* sV = sK + 2 * TC_BK * LD;  // [2][TC_BK][LD]
  int* sM = reinterpret_cast<int*>(sV + 2 * TC_BK * LD);  // [2][TC_BK]

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const int q0 = qi * TC_BQ;
  const int n_kb = keys_seen(causal, q0, offset, Sk) / TC_BK;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  auto load_kv = [&](int kb, int buf) {
    const size_t koff = ((size_t)b * Sk + kb * TC_BK) * ks + (size_t)hk * D;
    cp_tile<TC_BK, W, LD>(sK + buf * TC_BK * LD, k + koff, ks, D);
    cp_tile<TC_BK, W, LD>(sV + buf * TC_BK * LD, v + koff, ks, D);
    if (mask && threadIdx.x < TC_BK / 4)
      cp_async16(sM + buf * TC_BK + threadIdx.x * 4,
                 mask + (size_t)b * Sk + kb * TC_BK + threadIdx.x * 4);
  };

  zero_pad<W, LD>(sQ, TC_BQ + 4 * TC_BK, D);  // sQ, sK[2], sV[2]
  cp_tile<TC_BQ, W, LD>(sQ, q + ((size_t)b * Sq + q0) * qs + (size_t)h * D, qs, D);
  if (n_kb > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) ldsm_x4(qf[kc], a_addr(sQ, LD, warp * 16, kc * 16, lane));

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's partial sums

  for (int kb = 0; kb < n_kb; ++kb) {
    const int buf = kb & 1;
    if (kb > 0) {
      cp_async_wait_all();  // tile kb has landed ...
      __syncthreads();      // ... for every thread, and tile kb-1 is consumed
    }
    if (kb + 1 < n_kb) load_kv(kb + 1, buf ^ 1);
    cp_async_commit();
    const bf16* tK = sK + buf * TC_BK * LD;
    const bf16* tV = sV + buf * TC_BK * LD;
    const int* tM = sM + buf * TC_BK;

    // S = Q K^T over this warp's 16 rows and the tile's TC_BK keys.
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int jp = 0; jp < ST / 2; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, bt_addr(tK, LD, jp * 16, kc * 16, lane));
        mma_bf16(s[2 * jp], qf[kc], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[kc], bk[2], bk[3]);
      }
    }

    // Mask, then the online softmax on the rows row0 (e = 0, 1) and
    // row0 + 8 (e = 2, 3); a row's 64 entries sit in one quad.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int kpos = kb * TC_BK + col, qpos = row0 + 8 * (e >> 1);
        float x = s[j][e] * sm_scale;
        if ((causal && kpos > qpos + offset) || (mask && tM[col] == 0)) x = NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = row_max4(mx[i]);
      alpha[i] = exp2f((m[i] - mx[i]) * LOG2E);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m[e >> 1]) * LOG2E);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P from registers as the A operand.
#pragma unroll
    for (int kc = 0; kc < TC_BK / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < W / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, b_addr(tV, LD, kc * 16, dp * 16, lane));
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + 8 * i;
    const float l_safe = fmaxf(row_sum4(l[i]), 1e-30f);
    const float inv = 1.f / l_safe;
    bf16* orow = out + ((size_t)b * Sq + qpos) * qs + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      if (8 * j < D)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    if (t == 0) lse[((size_t)b * H + h) * Sq + qpos] = m[i] + logf(l_safe);
  }
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <typename G, int W, bool EXACT>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ mask, G* __restrict__ dk,
                         G* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int D_run,
                         int causal, float sm_scale) {
  constexpr int LD = tc_ld(W), QB = TC_BWD_BQ, KC = W / 16, DT = W / 8, ST = QB / 8;
  const int D = EXACT ? W : D_run;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TC_BK * LD;
  bf16* sQ = sV + TC_BK * LD;     // [2][QB][LD]
  bf16* sdO = sQ + 2 * QB * LD;   // [2][QB][LD]
  float* sL = reinterpret_cast<float*>(sdO + 2 * QB * LD);  // [2][QB]
  float* sD = sL + 2 * QB;                                  // [2][QB]

  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv, offset = Sk - Sq, n_qb = Sq / QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const size_t koff = ((size_t)b * Sk + kb * TC_BK) * ks + (size_t)hk * D;
  const int krow0 = kb * TC_BK + warp * 16 + g;  // this thread's key rows: krow0, krow0 + 8
  bool keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) keep[i] = !mask || mask[(size_t)b * Sk + krow0 + 8 * i] != 0;

  // q-tiles that see this key tile form a suffix [qb0, n_qb) for each head.
  int qb0 = 0;
  while (qb0 < n_qb && kb * TC_BK >= keys_seen(causal, qb0 * QB, offset, Sk)) ++qb0;
  const int per_head = n_qb - qb0, n_it = rep * per_head;

  auto load_q = [&](int it, int buf) {
    const int h = hk * rep + it / per_head, qb = qb0 + it % per_head;
    const size_t qoff = ((size_t)b * Sq + qb * QB) * qs + (size_t)h * D;
    cp_tile<QB, W, LD>(sQ + buf * QB * LD, q + qoff, qs, D);
    cp_tile<QB, W, LD>(sdO + buf * QB * LD, dO + qoff, qs, D);
    const size_t st = ((size_t)b * H + h) * Sq + qb * QB;
    if (threadIdx.x < QB / 4)
      cp_async16(sL + buf * QB + threadIdx.x * 4, lse + st + threadIdx.x * 4);
    else if (threadIdx.x < QB / 2)
      cp_async16(sD + buf * QB + (threadIdx.x - QB / 4) * 4,
                 delta + st + (threadIdx.x - QB / 4) * 4);
  };

  zero_pad<W, LD>(sK, 2 * TC_BK + 4 * QB, D);  // sK, sV, sQ[2], sdO[2]
  cp_tile<TC_BK, W, LD>(sK, k + koff, ks, D);
  cp_tile<TC_BK, W, LD>(sV, v + koff, ks, D);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();  // tile it has landed ...
    __syncthreads();      // ... for every thread, and tile it-1 is consumed
    if (it + 1 < n_it) load_q(it + 1, buf ^ 1);
    cp_async_commit();
    const int qb = qb0 + it % per_head;
    const bf16* tQ = sQ + buf * QB * LD;
    const bf16* tdO = sdO + buf * QB * LD;
    const float* tL = sL + buf * QB;
    const float* tD = sD + buf * QB;
    const int n_keys = keys_seen(causal, qb * QB, offset, Sk);
    const float uniform = 1.f / n_keys;

    // S^T = K Q^T: 16 key rows x QB query columns per warp.
    float st[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4];
      ldsm_x4(ka, a_addr(sK, LD, warp * 16, kc * 16, lane));
#pragma unroll
      for (int jp = 0; jp < ST / 2; ++jp) {
        uint32_t bq[4];
        ldsm_x4(bq, bt_addr(tQ, LD, jp * 16, kc * 16, lane));
        mma_bf16(st[2 * jp], ka, bq[0], bq[1]);
        mma_bf16(st[2 * jp + 1], ka, bq[2], bq[3]);
      }
    }

    // P^T from the saved lse; masked entries are constants.
    uint32_t live_bits = 0;  // bit (4j + e): entry (j, e) is not masked
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const int qpos = qb * QB + qc, kpos = krow0 + 8 * (e >> 1);
        const float L = tL[qc];
        const bool live = keep[e >> 1] && !(causal && kpos > qpos + offset);
        live_bits |= (uint32_t)live << (4 * j + e);
        st[j][e] = live ? exp2f((st[j][e] * sm_scale - L) * LOG2E)
                        : (L < ALL_MASKED_LSE ? uniform : 0.f);
      }
    }

    // dV += P^T dO.
#pragma unroll
    for (int kc = 0; kc < QB / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, st[2 * kc], st[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < W / 16; ++dp) {
        uint32_t bo[4];
        ldsm_x4_t(bo, b_addr(tdO, LD, kc * 16, dp * 16, lane));
        mma_bf16(dv_acc[2 * dp], pa, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * dp + 1], pa, bo[2], bo[3]);
      }
    }

    // dP^T = V dO^T.
    float dpt[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t va[4];
      ldsm_x4(va, a_addr(sV, LD, warp * 16, kc * 16, lane));
#pragma unroll
      for (int jp = 0; jp < ST / 2; ++jp) {
        uint32_t bo[4];
        ldsm_x4(bo, bt_addr(tdO, LD, jp * 16, kc * 16, lane));
        mma_bf16(dpt[2 * jp], va, bo[0], bo[1]);
        mma_bf16(dpt[2 * jp + 1], va, bo[2], bo[3]);
      }
    }

    // dS^T = P^T (dP^T - delta) * scale, 0 where masked.
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dl = tD[8 * j + 2 * t + (e & 1)];
        dpt[j][e] = (live_bits >> (4 * j + e)) & 1u
                        ? st[j][e] * (dpt[j][e] - dl) * sm_scale : 0.f;
      }
    }

    // dK += dS^T Q.
#pragma unroll
    for (int kc = 0; kc < QB / 16; ++kc) {
      uint32_t da[4];
      acc_to_a(da, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < W / 16; ++dp) {
        uint32_t bq[4];
        ldsm_x4_t(bq, b_addr(tQ, LD, kc * 16, dp * 16, lane));
        mma_bf16(dk_acc[2 * dp], da, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * dp + 1], da, bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t o = ((size_t)b * Sk + krow0 + 8 * i) * ks + (size_t)hk * D;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      if (8 * j >= D) continue;
      store2(dk + o + 8 * j + 2 * t, dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      store2(dv + o + 8 * j + 2 * t, dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// Dot product of eight bf16 pairs held as two 16-byte vectors, in fp32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s += fx.x * fy.x + fx.y * fy.y;
  }
  return s;
}

// Q and dO A fragments stay in registers across the key loop up to this
// width; above it they are re-read from shared memory for every key tile.
constexpr int DQ_HOLD_W = 96;

// bf16 dQ on tensor cores (G = bf16, or fp32 for grad_fp32). Replaces
// _flash_bwd_dq_kernel (maggy_tpu/ops/attention.py:369). Bytes bound it:
// q, k, v and dO read and dq written, ~31 MB at the BERT-base shape (9.5 us
// at 3.35 TB/s) against ~2.4 GFLOP (2.4 us on the tensor cores). The design
// is the forward's: one block per (b, h, 64-row q-tile), four warps of 16
// query rows, Q and dO landed once by cp.async, K/V tiles and their mask ints
// double-buffered. Per key tile, S = Q K^T and dP = dO V^T on mma.sync, then
// dS = P (dP - delta) scale in registers, 0 at every masked entry (a fully
// masked row gets dq = 0, the gradient of its constant output), then
// dQ += dS K with dS as the A operand straight from the accumulators.
// With `o` set, the prologue computes delta = rowsum(dO * O) for the block's
// rows, while the tiles land: the quad that owns a row in the mma layout
// takes its 16-byte chunks t, t+4, ... below D and row_sum4 adds them;
// delta goes to delta_out for the dK/dV kernel.
template <typename G, int W, bool EXACT>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const bf16* __restrict__ o, float* __restrict__ delta_out,
                       const int* __restrict__ mask, G* __restrict__ dq,
                       int Sq, int Sk, int H, int Hkv, int D_run, int causal, float sm_scale) {
  constexpr int LD = tc_ld(W), KC = W / 16, DT = W / 8, ST = TC_BK / 8, CH = (W + 31) / 32;
  const int D = EXACT ? W : D_run;
  constexpr bool HOLD = W <= DQ_HOLD_W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + TC_BQ * LD;
  bf16* sK = sdO + TC_BQ * LD;     // [2][TC_BK][LD]
  bf16* sV = sK + 2 * TC_BK * LD;  // [2][TC_BK][LD]
  int* sM = reinterpret_cast<int*>(sV + 2 * TC_BK * LD);  // [2][TC_BK]

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const int q0 = qi * TC_BQ;
  const size_t qoff = ((size_t)b * Sq + q0) * qs + (size_t)h * D;
  const int n_kb = keys_seen(causal, q0, offset, Sk) / TC_BK;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8
  const size_t st = ((size_t)b * H + h) * Sq + q0 + r0;

  auto load_kv = [&](int kb, int buf) {
    const size_t koff = ((size_t)b * Sk + kb * TC_BK) * ks + (size_t)hk * D;
    cp_tile<TC_BK, W, LD>(sK + buf * TC_BK * LD, k + koff, ks, D);
    cp_tile<TC_BK, W, LD>(sV + buf * TC_BK * LD, v + koff, ks, D);
    if (mask && threadIdx.x < TC_BK / 4)
      cp_async16(sM + buf * TC_BK + threadIdx.x * 4,
                 mask + (size_t)b * Sk + kb * TC_BK + threadIdx.x * 4);
  };

  zero_pad<W, LD>(sQ, 2 * TC_BQ + 4 * TC_BK, D);  // sQ, sdO, sK[2], sV[2]
  cp_tile<TC_BQ, W, LD>(sQ, q + qoff, qs, D);
  cp_tile<TC_BQ, W, LD>(sdO, dO + qoff, qs, D);
  if (n_kb > 0) load_kv(0, 0);
  cp_async_commit();

  float L[2], dl[2];
  uint4 ov[2][CH];
  if (o) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if ((t + 4 * c) * 8 < D)
          ov[i][c] = *reinterpret_cast<const uint4*>(o + qoff + (size_t)(r0 + 8 * i) * qs +
                                                     (t + 4 * c) * 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) L[i] = lse[st + 8 * i];
  cp_async_wait_all();
  __syncthreads();
  if (o) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if ((t + 4 * c) * 8 < D)
          sum += dot8(ov[i][c], *reinterpret_cast<const uint4*>(sdO + (r0 + 8 * i) * LD +
                                                                (t + 4 * c) * 8));
      dl[i] = row_sum4(sum);
      if (t == 0) delta_out[st + 8 * i] = dl[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) dl[i] = delta[st + 8 * i];
  }

  uint32_t qf[KC][4], df[KC][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      ldsm_x4(qf[kc], a_addr(sQ, LD, warp * 16, kc * 16, lane));
      ldsm_x4(df[kc], a_addr(sdO, LD, warp * 16, kc * 16, lane));
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int buf = kb & 1;
    if (kb > 0) {
      cp_async_wait_all();  // tile kb has landed ...
      __syncthreads();      // ... for every thread, and tile kb-1 is consumed
    }
    if (kb + 1 < n_kb) load_kv(kb + 1, buf ^ 1);
    cp_async_commit();
    const bf16* tK = sK + buf * TC_BK * LD;
    const bf16* tV = sV + buf * TC_BK * LD;
    const int* tM = sM + buf * TC_BK;

    // S = Q K^T and dP = dO V^T over this warp's 16 rows and TC_BK keys.
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], da[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[kc][e];
          da[e] = df[kc][e];
        }
      } else {
        ldsm_x4(qa, a_addr(sQ, LD, warp * 16, kc * 16, lane));
        ldsm_x4(da, a_addr(sdO, LD, warp * 16, kc * 16, lane));
      }
#pragma unroll
      for (int jp = 0; jp < ST / 2; ++jp) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, bt_addr(tK, LD, jp * 16, kc * 16, lane));
        mma_bf16(s[2 * jp], qa, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa, bk[2], bk[3]);
        ldsm_x4(bv, bt_addr(tV, LD, jp * 16, kc * 16, lane));
        mma_bf16(dp[2 * jp], da, bv[0], bv[1]);
        mma_bf16(dp[2 * jp + 1], da, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta) * scale, 0 where masked; rows r0 (e = 0, 1) and
    // r0 + 8 (e = 2, 3).
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), i = e >> 1;
        const int kpos = kb * TC_BK + col, qpos = q0 + r0 + 8 * i;
        const bool live = !(causal && kpos > qpos + offset) && !(mask && tM[col] == 0);
        s[j][e] = live ? exp2f((s[j][e] * sm_scale - L[i]) * LOG2E) * (dp[j][e] - dl[i]) * sm_scale
                       : 0.f;
      }
    }

    // dQ += dS K, dS from registers as the A operand.
#pragma unroll
    for (int kc = 0; kc < TC_BK / 16; ++kc) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dc = 0; dc < W / 16; ++dc) {
        uint32_t bk[4];
        ldsm_x4_t(bk, b_addr(tK, LD, kc * 16, dc * 16, lane));
        mma_bf16(acc[2 * dc], sa, bk[0], bk[1]);
        mma_bf16(acc[2 * dc + 1], sa, bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    G* row = dq + qoff + (size_t)(r0 + 8 * i) * qs;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      if (8 * j < D) store2(row + 8 * j + 2 * t, acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// ------------------------------------------------ split-D kernels (D > 256)
//
// Above width 256 a block can hold neither whole rows in shared memory nor
// their accumulators in registers. So the output's columns are cut into
// slices of SPLIT_DC = 128, one more grid axis (folded into blockIdx.x, the
// slice fastest, so the blocks of one tile run side by side and share its
// rows through L2), and each block accumulates only its slice's columns: O,
// dQ, dK and dV take the registers of the width-128 kernels. The products
// that reduce over D (S = Q K^T, and in the backward dP = dO V^T) need every
// column: each block forms them whole, summing over 64-wide D chunks
// streamed through shared memory, so they are computed once per slice, ns =
// ceil(D / 128) times (at D = 512 about 2.5x the one-pass arithmetic of the
// forward and dK/dV, 3x in dQ). The tensor-core kernels keep the per-width
// design otherwise: four warps, mma.sync m16n8k16 fed by ldmatrix, P and dS
// in registers. Their loads are one double-buffered cp.async sequence of
// steps (tile, chunk); a tile's first step also lands the slice tile its
// output product reads (V in the forward, Q and dO in dK/dV, K in dQ) into
// a buffer chosen by the tile's parity. A chunk's 16-byte pieces at or past
// D are zero-filled with plain stores (its buffer held another chunk
// before), so the last k16 step of a reduction sees zeros; a slice's
// columns past D are never stored, and an n8 tile lies wholly inside D or
// wholly past it (D % 8 == 0). The fp32 kernels are the width builds'
// CUDA-core kernels, cut the same way. Slice 0 writes lse and the fused
// delta; every dQ block computes delta over the whole row itself.

constexpr int SPLIT_DC = 128;  // output columns a block
constexpr int SPLIT_DK = 64;   // D chunk of a reduction over D
constexpr int SPLIT_CLD = tc_ld(SPLIT_DK);
constexpr int SPLIT_SLD = tc_ld(SPLIT_DC);
constexpr int SPLIT_F32_T = 32;  // fp32 inner tile (dK/dV: query rows; dQ: key rows)

__host__ __device__ constexpr int split_slices(int D) { return (D + SPLIT_DC - 1) / SPLIT_DC; }
__host__ __device__ constexpr int split_chunks(int D) { return (D + SPLIT_DK - 1) / SPLIT_DK; }

// ROWS x SPLIT_DK chunk (columns c0..c0+63) of a bf16 row-major tile into
// shared memory with row stride SPLIT_CLD; pieces at or past D zero-filled.
template <int ROWS>
__device__ __forceinline__ void cp_chunk(bf16* dst, const bf16* src, size_t stride, int c0,
                                         int D) {
  constexpr int CPR = SPLIT_DK / 8;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += TC_NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    if (c0 + c < D)
      cp_async16(dst + r * SPLIT_CLD + c, src + r * stride + c0 + c);
    else
      *reinterpret_cast<uint4*>(dst + r * SPLIT_CLD + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ROWS x SPLIT_DC slice (columns c0..c0+127) into shared memory with row
// stride SPLIT_SLD; pieces past D are left alone (their products are never
// stored).
template <int ROWS>
__device__ __forceinline__ void cp_slice(bf16* dst, const bf16* src, size_t stride, int c0,
                                         int D) {
  constexpr int CPR = SPLIT_DC / 8;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += TC_NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    if (c0 + c < D) cp_async16(dst + r * SPLIT_SLD + c, src + r * stride + c0 + c);
  }
}

// c[16 x 8 ST] += A B^T over one chunk's first `len` columns (k16 steps up
// to the next multiple of 16; zeros past D): A is rows a_row0..a_row0+15 of
// chunk tile `a`, B rows 0..8 ST - 1 of chunk tile `b`.
template <int ST>
__device__ __forceinline__ void mma_chunk(float (&c)[ST][4], const bf16* a, int a_row0,
                                          const bf16* b, int len, int lane) {
#pragma unroll
  for (int kc = 0; kc < SPLIT_DK / 16; ++kc) {
    if (kc * 16 >= len) break;
    uint32_t af[4];
    ldsm_x4(af, a_addr(a, SPLIT_CLD, a_row0, kc * 16, lane));
#pragma unroll
    for (int jp = 0; jp < ST / 2; ++jp) {
      uint32_t bf[4];
      ldsm_x4(bf, bt_addr(b, SPLIT_CLD, jp * 16, kc * 16, lane));
      mma_bf16(c[2 * jp], af, bf[0], bf[1]);
      mma_bf16(c[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16 x SPLIT_DC] += P[16 x 16 KT] X[16 KT x SPLIT_DC]: P the
// accumulator pairs p[2kc], p[2kc+1] rounded to bf16 (the A operand from
// registers), X a slice tile; n8 tiles wholly past the slice's `slen`
// columns are skipped.
template <int KT>
__device__ __forceinline__ void mma_slice(float (&acc)[SPLIT_DC / 8][4],
                                          const float (&p)[2 * KT][4], const bf16* x, int slen,
                                          int lane) {
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t pa[4];
    acc_to_a(pa, p[2 * kc], p[2 * kc + 1]);
#pragma unroll
    for (int dp = 0; dp < SPLIT_DC / 16; ++dp) {
      if (dp * 16 >= slen) break;
      uint32_t bx[4];
      ldsm_x4_t(bx, b_addr(x, SPLIT_SLD, kc * 16, dp * 16, lane));
      mma_bf16(acc[2 * dp], pa, bx[0], bx[1]);
      mma_bf16(acc[2 * dp + 1], pa, bx[2], bx[3]);
    }
  }
}

// A 16 x SPLIT_DC accumulator's rows g and g + 8 (this thread's) to global
// rows `row` and `row + 8 * stride`, the slice's first `slen` columns,
// scaled by scale0 and scale1.
template <typename G>
__device__ __forceinline__ void store_slice(G* row, size_t stride,
                                            const float (&acc)[SPLIT_DC / 8][4], int slen, int t,
                                            float scale0 = 1.f, float scale1 = 1.f) {
#pragma unroll
  for (int j = 0; j < SPLIT_DC / 8; ++j) {
    if (8 * j >= slen) break;
    store2(row + 8 * j + 2 * t, acc[j][0] * scale0, acc[j][1] * scale0);
    store2(row + 8 * stride + 8 * j + 2 * t, acc[j][2] * scale1, acc[j][3] * scale1);
  }
}

// bf16 forward above width 256 (replaces _flash_fwd_kernel there). One
// block per (b, h, 64-row q-tile, column slice): per key tile, S over
// ceil(D / 64) chunk steps, the online softmax, then O_slice += P V_slice.
template <int DC>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_split_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ mask,
                          bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                          int Hkv, int D, int causal, float sm_scale) {
  static_assert(DC == SPLIT_DC, "one slice width");
  constexpr int CLD = SPLIT_CLD, SLD = SPLIT_SLD, ST = TC_BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [2][TC_BQ][CLD] Q chunks
  bf16* sK = sQ + 2 * TC_BQ * CLD;                // [2][TC_BK][CLD] K chunks
  bf16* sV = sK + 2 * TC_BK * CLD;                // [2][TC_BK][SLD] V slices
  int* sM = reinterpret_cast<int*>(sV + 2 * TC_BK * SLD);  // [2][TC_BK]

  const int ns = split_slices(D), nd = split_chunks(D);
  const int qi = blockIdx.x / ns, c0 = (blockIdx.x % ns) * DC, slen = min(DC, D - c0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const int q0 = qi * TC_BQ;
  const size_t qoff = ((size_t)b * Sq + q0) * qs + (size_t)h * D;
  const int n_steps = keys_seen(causal, q0, offset, Sk) / TC_BK * nd;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  // Step kb * nd + dc lands chunk dc of Q and of key tile kb; a tile's
  // first step also lands its V slice and mask ints.
  auto load = [&](int step, int buf) {
    const int kb = step / nd, dc = step % nd;
    const size_t koff = ((size_t)b * Sk + kb * TC_BK) * ks + (size_t)hk * D;
    cp_chunk<TC_BQ>(sQ + buf * TC_BQ * CLD, q + qoff, qs, dc * SPLIT_DK, D);
    cp_chunk<TC_BK>(sK + buf * TC_BK * CLD, k + koff, ks, dc * SPLIT_DK, D);
    if (dc == 0) {
      cp_slice<TC_BK>(sV + (kb & 1) * TC_BK * SLD, v + koff, ks, c0, D);
      if (mask && threadIdx.x < TC_BK / 4)
        cp_async16(sM + (kb & 1) * TC_BK + threadIdx.x * 4,
                   mask + (size_t)b * Sk + kb * TC_BK + threadIdx.x * 4);
    }
  };

  if (n_steps > 0) load(0, 0);
  cp_async_commit();

  float o[DC / 8][4], s[ST][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's partial sums

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1, kb = step / nd, dc = step % nd;
    cp_async_wait_all();  // step `step` has landed ...
    __syncthreads();      // ... for every thread, and step - 1 is consumed
    if (step + 1 < n_steps) load(step + 1, buf ^ 1);
    cp_async_commit();
    if (dc == 0) {
#pragma unroll
      for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
    mma_chunk<ST>(s, sQ + buf * TC_BQ * CLD, warp * 16, sK + buf * TC_BK * CLD,
                  D - dc * SPLIT_DK, lane);
    if (dc + 1 < nd) continue;

    // The key tile's S is whole: mask, online softmax, O += P V_slice.
    const int* tM = sM + (kb & 1) * TC_BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int kpos = kb * TC_BK + col, qpos = row0 + 8 * (e >> 1);
        float x = s[j][e] * sm_scale;
        if ((causal && kpos > qpos + offset) || (mask && tM[col] == 0)) x = NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = row_max4(mx[i]);
      alpha[i] = exp2f((m[i] - mx[i]) * LOG2E);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m[e >> 1]) * LOG2E);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    mma_slice<TC_BK / 16>(o, s, sV + (kb & 1) * TC_BK * SLD, slen, lane);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = fmaxf(row_sum4(l[i]), 1e-30f);
    inv[i] = 1.f / l_safe;
    if (c0 == 0 && t == 0) lse[((size_t)b * H + h) * Sq + row0 + 8 * i] = m[i] + logf(l_safe);
  }
  store_slice(out + ((size_t)b * Sq + row0) * qs + (size_t)h * D + c0, qs, o, slen, t, inv[0],
              inv[1]);
}

// bf16 dK/dV above width 256 (replaces _flash_bwd_dkdv_kernel there). One
// block per (b, kv head, 64-key tile, column slice), looping over the
// group's query heads and their TC_BWD_BQ-row q-tiles: S^T = K Q^T and dP^T
// = V dO^T over the chunk steps, then P^T and dS^T, dV_slice += P^T
// dO_slice and dK_slice += dS^T Q_slice.
template <typename G, int DC>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkdv_split_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dO,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const int* __restrict__ mask, G* __restrict__ dk,
                               G* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int D,
                               int causal, float sm_scale) {
  static_assert(DC == SPLIT_DC, "one slice width");
  constexpr int CLD = SPLIT_CLD, SLD = SPLIT_SLD, QB = TC_BWD_BQ, ST = QB / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [2][TC_BK][CLD] K chunks
  bf16* sV = sK + 2 * TC_BK * CLD;                // [2][TC_BK][CLD] V chunks
  bf16* sQ = sV + 2 * TC_BK * CLD;                // [2][QB][CLD] Q chunks
  bf16* sdO = sQ + 2 * QB * CLD;                  // [2][QB][CLD] dO chunks
  bf16* sQs = sdO + 2 * QB * CLD;                 // [2][QB][SLD] Q slices
  bf16* sdOs = sQs + 2 * QB * SLD;                // [2][QB][SLD] dO slices
  float* sL = reinterpret_cast<float*>(sdOs + 2 * QB * SLD);  // [2][QB]
  float* sD = sL + 2 * QB;                                    // [2][QB]

  const int ns = split_slices(D), nd = split_chunks(D);
  const int kb = blockIdx.x / ns, c0 = (blockIdx.x % ns) * DC, slen = min(DC, D - c0);
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv, offset = Sk - Sq, n_qb = Sq / QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const size_t koff = ((size_t)b * Sk + kb * TC_BK) * ks + (size_t)hk * D;
  const int krow0 = kb * TC_BK + warp * 16 + g;  // this thread's key rows: krow0, krow0 + 8
  bool keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) keep[i] = !mask || mask[(size_t)b * Sk + krow0 + 8 * i] != 0;

  // q-tiles that see this key tile form a suffix [qb0, n_qb) for each head.
  int qb0 = 0;
  while (qb0 < n_qb && kb * TC_BK >= keys_seen(causal, qb0 * QB, offset, Sk)) ++qb0;
  const int per_head = n_qb - qb0, n_steps = rep * per_head * nd;

  // Step it * nd + dc lands chunk dc of the key tile's K and V and of
  // q-tile it's Q and dO; a q-tile's first step also lands its Q and dO
  // slices, lse and delta.
  auto load = [&](int step, int buf) {
    const int it = step / nd, dc = step % nd;
    const int h = hk * rep + it / per_head, qb = qb0 + it % per_head;
    const size_t qoff = ((size_t)b * Sq + qb * QB) * qs + (size_t)h * D;
    cp_chunk<TC_BK>(sK + buf * TC_BK * CLD, k + koff, ks, dc * SPLIT_DK, D);
    cp_chunk<TC_BK>(sV + buf * TC_BK * CLD, v + koff, ks, dc * SPLIT_DK, D);
    cp_chunk<QB>(sQ + buf * QB * CLD, q + qoff, qs, dc * SPLIT_DK, D);
    cp_chunk<QB>(sdO + buf * QB * CLD, dO + qoff, qs, dc * SPLIT_DK, D);
    if (dc == 0) {
      const int sb = it & 1;
      cp_slice<QB>(sQs + sb * QB * SLD, q + qoff, qs, c0, D);
      cp_slice<QB>(sdOs + sb * QB * SLD, dO + qoff, qs, c0, D);
      const size_t st = ((size_t)b * H + h) * Sq + qb * QB;
      if (threadIdx.x < QB / 4)
        cp_async16(sL + sb * QB + threadIdx.x * 4, lse + st + threadIdx.x * 4);
      else if (threadIdx.x < QB / 2)
        cp_async16(sD + sb * QB + (threadIdx.x - QB / 4) * 4,
                   delta + st + (threadIdx.x - QB / 4) * 4);
    }
  };

  if (n_steps > 0) load(0, 0);
  cp_async_commit();

  float dk_acc[DC / 8][4], dv_acc[DC / 8][4], st[ST][4], dpt[ST][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1, it = step / nd, dc = step % nd;
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < n_steps) load(step + 1, buf ^ 1);
    cp_async_commit();
    if (dc == 0) {
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
    const int len = D - dc * SPLIT_DK;
    mma_chunk<ST>(st, sK + buf * TC_BK * CLD, warp * 16, sQ + buf * QB * CLD, len, lane);
    mma_chunk<ST>(dpt, sV + buf * TC_BK * CLD, warp * 16, sdO + buf * QB * CLD, len, lane);
    if (dc + 1 < nd) continue;

    const int sb = it & 1, qb = qb0 + it % per_head;
    const float* tL = sL + sb * QB;
    const float* tD = sD + sb * QB;
    const float uniform = 1.f / keys_seen(causal, qb * QB, offset, Sk);
    // P^T from the saved lse (masked entries constants), then dS^T = P^T
    // (dP^T - delta) * scale, 0 where masked.
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const int qpos = qb * QB + qc, kpos = krow0 + 8 * (e >> 1);
        const float L = tL[qc];
        const bool live = keep[e >> 1] && !(causal && kpos > qpos + offset);
        st[j][e] = live ? exp2f((st[j][e] * sm_scale - L) * LOG2E)
                        : (L < ALL_MASKED_LSE ? uniform : 0.f);
        dpt[j][e] = live ? st[j][e] * (dpt[j][e] - tD[qc]) * sm_scale : 0.f;
      }
    }
    mma_slice<QB / 16>(dv_acc, st, sdOs + sb * QB * SLD, slen, lane);
    mma_slice<QB / 16>(dk_acc, dpt, sQs + sb * QB * SLD, slen, lane);
  }

  const size_t o = ((size_t)b * Sk + krow0) * ks + (size_t)hk * D + c0;
  store_slice(dk + o, ks, dk_acc, slen, t);
  store_slice(dv + o, ks, dv_acc, slen, t);
}

// bf16 dQ above width 256 (replaces _flash_bwd_dq_kernel there). One block
// per (b, h, 64-row q-tile, column slice): per key tile, S = Q K^T and dP =
// dO V^T over the chunk steps, dS, then dQ_slice += dS K_slice. With `o`
// set, the prologue computes delta = rowsum(dO * O) over the whole row from
// global memory (slice 0 writes it to delta_out).
template <typename G, int DC>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_split_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dO,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const bf16* __restrict__ o, float* __restrict__ delta_out,
                             const int* __restrict__ mask, G* __restrict__ dq, int Sq, int Sk,
                             int H, int Hkv, int D, int causal, float sm_scale) {
  static_assert(DC == SPLIT_DC, "one slice width");
  constexpr int CLD = SPLIT_CLD, SLD = SPLIT_SLD, ST = TC_BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [2][TC_BQ][CLD] Q chunks
  bf16* sdO = sQ + 2 * TC_BQ * CLD;               // [2][TC_BQ][CLD] dO chunks
  bf16* sK = sdO + 2 * TC_BQ * CLD;               // [2][TC_BK][CLD] K chunks
  bf16* sV = sK + 2 * TC_BK * CLD;                // [2][TC_BK][CLD] V chunks
  bf16* sKs = sV + 2 * TC_BK * CLD;               // [2][TC_BK][SLD] K slices
  int* sM = reinterpret_cast<int*>(sKs + 2 * TC_BK * SLD);  // [2][TC_BK]

  const int ns = split_slices(D), nd = split_chunks(D);
  const int qi = blockIdx.x / ns, c0 = (blockIdx.x % ns) * DC, slen = min(DC, D - c0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const int q0 = qi * TC_BQ;
  const size_t qoff = ((size_t)b * Sq + q0) * qs + (size_t)h * D;
  const int n_steps = keys_seen(causal, q0, offset, Sk) / TC_BK * nd;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8
  const size_t st = ((size_t)b * H + h) * Sq + q0 + r0;

  // Step kb * nd + dc lands chunk dc of Q, dO and key tile kb's K and V; a
  // tile's first step also lands its K slice and mask ints.
  auto load = [&](int step, int buf) {
    const int kb = step / nd, dc = step % nd;
    const size_t koff = ((size_t)b * Sk + kb * TC_BK) * ks + (size_t)hk * D;
    cp_chunk<TC_BQ>(sQ + buf * TC_BQ * CLD, q + qoff, qs, dc * SPLIT_DK, D);
    cp_chunk<TC_BQ>(sdO + buf * TC_BQ * CLD, dO + qoff, qs, dc * SPLIT_DK, D);
    cp_chunk<TC_BK>(sK + buf * TC_BK * CLD, k + koff, ks, dc * SPLIT_DK, D);
    cp_chunk<TC_BK>(sV + buf * TC_BK * CLD, v + koff, ks, dc * SPLIT_DK, D);
    if (dc == 0) {
      cp_slice<TC_BK>(sKs + (kb & 1) * TC_BK * SLD, k + koff, ks, c0, D);
      if (mask && threadIdx.x < TC_BK / 4)
        cp_async16(sM + (kb & 1) * TC_BK + threadIdx.x * 4,
                   mask + (size_t)b * Sk + kb * TC_BK + threadIdx.x * 4);
    }
  };

  if (n_steps > 0) load(0, 0);
  cp_async_commit();

  // The rows' lse and delta; with `o`, the quad that owns a row sums its
  // 16-byte chunks t, t + 4, ... of dO * O while the first step lands.
  float L[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    L[i] = lse[st + 8 * i];
    if (o) {
      const size_t r = qoff + (size_t)(r0 + 8 * i) * qs;
      float sum = 0.f;
      for (int c = t * 8; c < D; c += 32)
        sum += dot8(*reinterpret_cast<const uint4*>(o + r + c),
                    *reinterpret_cast<const uint4*>(dO + r + c));
      dl[i] = row_sum4(sum);
      if (c0 == 0 && t == 0) delta_out[st + 8 * i] = dl[i];
    } else {
      dl[i] = delta[st + 8 * i];
    }
  }

  float acc[DC / 8][4], s[ST][4], dp[ST][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1, kb = step / nd, dc = step % nd;
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < n_steps) load(step + 1, buf ^ 1);
    cp_async_commit();
    if (dc == 0) {
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    const int len = D - dc * SPLIT_DK;
    mma_chunk<ST>(s, sQ + buf * TC_BQ * CLD, warp * 16, sK + buf * TC_BK * CLD, len, lane);
    mma_chunk<ST>(dp, sdO + buf * TC_BQ * CLD, warp * 16, sV + buf * TC_BK * CLD, len, lane);
    if (dc + 1 < nd) continue;

    // dS = P (dP - delta) * scale, 0 where masked; rows r0 (e = 0, 1) and
    // r0 + 8 (e = 2, 3).
    const int* tM = sM + (kb & 1) * TC_BK;
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), i = e >> 1;
        const int kpos = kb * TC_BK + col, qpos = q0 + r0 + 8 * i;
        const bool live = !(causal && kpos > qpos + offset) && !(mask && tM[col] == 0);
        s[j][e] = live ? exp2f((s[j][e] * sm_scale - L[i]) * LOG2E) * (dp[j][e] - dl[i]) * sm_scale
                       : 0.f;
      }
    }
    mma_slice<TC_BK / 16>(acc, s, sKs + (kb & 1) * TC_BK * SLD, slen, lane);
  }

  store_slice(dq + qoff + (size_t)r0 * qs + c0, qs, acc, slen, t);
}

// fp32 forward above width 256: the CUDA-core forward with S summed over
// 64-wide D chunks and each block one column slice of O.
template <int DC>
__global__ void __launch_bounds__(NT)
flash_fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ mask,
                       float* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                       int Hkv, int D, int causal, float sm_scale) {
  constexpr int CP = SPLIT_DK + 1, KP = BK + 1, CC = DC / 4;
  extern __shared__ float smem[];
  float* sQ = smem;          // [BQ][CP] a Q chunk, scaled
  float* sK = sQ + BQ * CP;  // [BK][CP] a K chunk
  float* sV = sK + BK * CP;  // [BK][DC] the V slice
  float* sP = sV + BK * DC;  // [BQ][KP]

  const int ns = split_slices(D);
  const int qi = blockIdx.x / ns, c0 = (blockIdx.x % ns) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qpos = qi * BQ + row;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const float* qt = q + ((size_t)b * Sq + qi * BQ) * qs + (size_t)h * D;
  const int n_keys = keys_seen(causal, qi * BQ, offset, Sk);

  float acc[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int kb = 0; kb * BK < n_keys; ++kb) {
    const size_t koff = ((size_t)b * Sk + kb * BK) * ks + (size_t)hk * D;
    float s[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += SPLIT_DK) {
      __syncthreads();  // the previous chunk (and key tile) is consumed
      load_tile<float, SPLIT_DK>(sQ, CP, qt + d0, qs, BQ, D - d0, sm_scale);
      load_tile<float, SPLIT_DK>(sK, CP, k + koff + d0, ks, BK, D - d0, 1.f);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BK / 4; ++i)
        s[i] += dot<SPLIT_DK>(sQ + row * CP, sK + (part + 4 * i) * CP);
    }
    load_tile<float, DC>(sV, DC, v + koff + c0, ks, BK, D - c0, 1.f);
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      if (masked(causal, mask, b, Sk, qpos, kb * BK + part + 4 * i, offset)) s[i] = NEG_INF;
      mx = fmaxf(mx, s[i]);
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
    __syncthreads();  // the V slice has landed
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = sP[row * KP + j];
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[c] += p * sV[j * DC + part + 4 * c];
    }
  }

  const float l_safe = fmaxf(l, 1e-30f);
  float* o = out + ((size_t)b * Sq + qpos) * qs + (size_t)h * D + c0;
#pragma unroll
  for (int c = 0; c < CC; ++c)
    if (c0 + part + 4 * c < D) o[part + 4 * c] = acc[c] / l_safe;
  if (c0 == 0 && part == 0) lse[((size_t)b * H + h) * Sq + qpos] = m + logf(l_safe);
}

// fp32 dK/dV above width 256: the CUDA-core dK/dV with S^T and dP^T summed
// over D chunks, SPLIT_F32_T query rows a step, each block one column
// slice of dK and dV.
template <int DC>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dO,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ mask, float* __restrict__ dk,
                            float* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int D,
                            int causal, float sm_scale) {
  constexpr int QT = SPLIT_F32_T, CP = SPLIT_DK + 1, QP = QT + 1, CC = DC / 4;
  extern __shared__ float smem[];
  float* sK = smem;             // [BK][CP] K chunk
  float* sV = sK + BK * CP;     // [BK][CP] V chunk
  float* sQ = sV + BK * CP;     // [QT][CP] Q chunk
  float* sdO = sQ + QT * CP;    // [QT][CP] dO chunk
  float* sQs = sdO + QT * CP;   // [QT][DC] Q slice
  float* sdOs = sQs + QT * DC;  // [QT][DC] dO slice
  float* sP = sdOs + QT * DC;   // [BK][QP]
  float* sdS = sP + BK * QP;    // [BK][QP]
  float* sL = sdS + BK * QP;    // [QT]
  float* sDelta = sL + QT;      // [QT]

  const int ns = split_slices(D);
  const int kb = blockIdx.x / ns, c0 = (blockIdx.x % ns) * DC;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv, offset = Sk - Sq;
  const int kr = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int kpos = kb * BK + kr;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const size_t koff = ((size_t)b * Sk + kb * BK) * ks + (size_t)hk * D;

  float dk_acc[CC], dv_acc[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    for (int qi = 0; qi < Sq / QT; ++qi) {
      const int n = keys_seen(causal, qi * QT, offset, Sk);
      if (kb * BK >= n) continue;
      const size_t qoff = ((size_t)b * Sq + qi * QT) * qs + (size_t)h * D;
      float s[QT / 4], dp[QT / 4];
#pragma unroll
      for (int ii = 0; ii < QT / 4; ++ii) s[ii] = dp[ii] = 0.f;
      for (int d0 = 0; d0 < D; d0 += SPLIT_DK) {
        __syncthreads();
        load_tile<float, SPLIT_DK>(sK, CP, k + koff + d0, ks, BK, D - d0, 1.f);
        load_tile<float, SPLIT_DK>(sV, CP, v + koff + d0, ks, BK, D - d0, 1.f);
        load_tile<float, SPLIT_DK>(sQ, CP, q + qoff + d0, qs, QT, D - d0, 1.f);
        load_tile<float, SPLIT_DK>(sdO, CP, dO + qoff + d0, qs, QT, D - d0, 1.f);
        __syncthreads();
#pragma unroll
        for (int ii = 0; ii < QT / 4; ++ii) {
          const int i = part + 4 * ii;
          s[ii] += dot<SPLIT_DK>(sQ + i * CP, sK + kr * CP);
          dp[ii] += dot<SPLIT_DK>(sdO + i * CP, sV + kr * CP);
        }
      }
      load_tile<float, DC>(sQs, DC, q + qoff + c0, qs, QT, D - c0, 1.f);
      load_tile<float, DC>(sdOs, DC, dO + qoff + c0, qs, QT, D - c0, 1.f);
      if (threadIdx.x < QT) {
        const size_t st = ((size_t)b * H + h) * Sq + qi * QT + threadIdx.x;
        sL[threadIdx.x] = lse[st];
        sDelta[threadIdx.x] = delta[st];
      }
      __syncthreads();
      const float uniform = 1.f / n;
#pragma unroll
      for (int ii = 0; ii < QT / 4; ++ii) {
        const int i = part + 4 * ii;
        float p, ds;
        if (masked(causal, mask, b, Sk, qi * QT + i, kpos, offset)) {
          p = sL[i] < ALL_MASKED_LSE ? uniform : 0.f;
          ds = 0.f;
        } else {
          p = expf(s[ii] * sm_scale - sL[i]);
          ds = p * (dp[ii] - sDelta[i]) * sm_scale;
        }
        sP[kr * QP + i] = p;
        sdS[kr * QP + i] = ds;
      }
      __syncwarp();  // a key row's four threads share one warp
      for (int i = 0; i < QT; ++i) {
        const float p = sP[kr * QP + i], ds = sdS[kr * QP + i];
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          dv_acc[c] += p * sdOs[i * DC + part + 4 * c];
          dk_acc[c] += ds * sQs[i * DC + part + 4 * c];
        }
      }
    }
  }

  const size_t o = ((size_t)b * Sk + kpos) * ks + (size_t)hk * D + c0;
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    if (c0 + part + 4 * c < D) {
      dk[o + part + 4 * c] = dk_acc[c];
      dv[o + part + 4 * c] = dv_acc[c];
    }
  }
}

// fp32 dQ above width 256: the CUDA-core dQ with S and dP summed over D
// chunks, SPLIT_F32_T keys a step, each block one column slice of dQ;
// delta over the whole row (from `o`, slice 0 writing delta_out) or read.
template <int DC>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dO,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ o, float* __restrict__ delta_out,
                          const int* __restrict__ mask, float* __restrict__ dq, int Sq, int Sk,
                          int H, int Hkv, int D, int causal, float sm_scale) {
  constexpr int KT = SPLIT_F32_T, CP = SPLIT_DK + 1, KP = KT + 1, CC = DC / 4;
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][CP] Q chunk
  float* sdO = sQ + BQ * CP;   // [BQ][CP] dO chunk
  float* sK = sdO + BQ * CP;   // [KT][CP] K chunk
  float* sV = sK + KT * CP;    // [KT][CP] V chunk
  float* sKs = sV + KT * CP;   // [KT][DC] K slice
  float* sdS = sKs + KT * DC;  // [BQ][KP]

  const int ns = split_slices(D);
  const int qi = blockIdx.x / ns, c0 = (blockIdx.x % ns) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qpos = qi * BQ + row;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const size_t qoff = ((size_t)b * Sq + qi * BQ) * qs + (size_t)h * D;
  const size_t st = ((size_t)b * H + h) * Sq + qpos;
  const float my_lse = lse[st];
  float my_delta;
  if (o) {
    const size_t r = qoff + (size_t)row * qs;
    float sum = 0.f;
    for (int c = part; c < D; c += 4) sum += dO[r + c] * o[r + c];
    my_delta = row_sum4(sum);
    if (c0 == 0 && part == 0) delta_out[st] = my_delta;
  } else {
    my_delta = delta[st];
  }
  const int n_keys = keys_seen(causal, qi * BQ, offset, Sk);

  float acc[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) acc[c] = 0.f;

  for (int kb = 0; kb * KT < n_keys; ++kb) {
    const size_t koff = ((size_t)b * Sk + kb * KT) * ks + (size_t)hk * D;
    float s[KT / 4], dp[KT / 4];
#pragma unroll
    for (int i = 0; i < KT / 4; ++i) s[i] = dp[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += SPLIT_DK) {
      __syncthreads();
      load_tile<float, SPLIT_DK>(sQ, CP, q + qoff + d0, qs, BQ, D - d0, 1.f);
      load_tile<float, SPLIT_DK>(sdO, CP, dO + qoff + d0, qs, BQ, D - d0, 1.f);
      load_tile<float, SPLIT_DK>(sK, CP, k + koff + d0, ks, KT, D - d0, 1.f);
      load_tile<float, SPLIT_DK>(sV, CP, v + koff + d0, ks, KT, D - d0, 1.f);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < KT / 4; ++i) {
        const int j = part + 4 * i;
        s[i] += dot<SPLIT_DK>(sQ + row * CP, sK + j * CP);
        dp[i] += dot<SPLIT_DK>(sdO + row * CP, sV + j * CP);
      }
    }
    load_tile<float, DC>(sKs, DC, k + koff + c0, ks, KT, D - c0, 1.f);
#pragma unroll
    for (int i = 0; i < KT / 4; ++i) {
      const int j = part + 4 * i;
      float ds = 0.f;
      if (!masked(causal, mask, b, Sk, qpos, kb * KT + j, offset)) {
        const float p = expf(s[i] * sm_scale - my_lse);
        ds = p * (dp[i] - my_delta) * sm_scale;
      }
      sdS[row * KP + j] = ds;
    }
    __syncthreads();  // the K slice has landed
    for (int j = 0; j < KT; ++j) {
      const float ds = sdS[row * KP + j];
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[c] += ds * sKs[j * DC + part + 4 * c];
    }
  }

  float* dq_row = dq + ((size_t)b * Sq + qpos) * qs + (size_t)h * D + c0;
#pragma unroll
  for (int c = 0; c < CC; ++c)
    if (c0 + part + 4 * c < D) dq_row[part + 4 * c] = acc[c];
}

// ---------------------------------------------------------------- launch

// Launch `kern`, or, with `info`, describe it instead: registers per thread,
// local (spill and stack) bytes per thread, static and dynamic shared memory
// per block, threads per block, and resident blocks per SM.
template <typename... P, typename... A>
int launch(void (*kern)(P...), dim3 grid, int threads, size_t smem, cudaStream_t stream,
           int* info, A... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (info) {
    cudaFuncAttributes a;
    int blocks = 0;
    if ((err = cudaFuncGetAttributes(&a, kern)) != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, smem)) != cudaSuccess)
      return (int)err;
    info[0] = a.numRegs;
    info[1] = (int)a.localSizeBytes;
    info[2] = (int)a.sharedSizeBytes;
    info[3] = (int)smem;
    info[4] = threads;
    info[5] = blocks;
    return 0;
  }
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (tensor-core
// kernels). grad_fp32 = 1 writes fp32 gradients from bf16 inputs (the
// ring-attention building block); otherwise gradients take the input type.
// dQ computes delta into delta_out when given the forward's output `o`
// (then `delta` is null), else reads `delta`. A non-null `info` describes
// the kernel the call would launch.

#if defined(FLASH_SPLIT)

constexpr size_t fwd_split_smem() {
  return sizeof(float) * (BQ * (SPLIT_DK + 1) + BK * (SPLIT_DK + 1) + BK * SPLIT_DC +
                          BQ * (BK + 1));
}
constexpr size_t dkdv_split_smem() {
  return sizeof(float) * (2 * BK * (SPLIT_DK + 1) + 2 * SPLIT_F32_T * (SPLIT_DK + 1) +
                          2 * SPLIT_F32_T * SPLIT_DC + 2 * BK * (SPLIT_F32_T + 1) +
                          2 * SPLIT_F32_T);
}
constexpr size_t dq_split_smem() {
  return sizeof(float) * (2 * BQ * (SPLIT_DK + 1) + 2 * SPLIT_F32_T * (SPLIT_DK + 1) +
                          SPLIT_F32_T * SPLIT_DC + BQ * (SPLIT_F32_T + 1));
}
constexpr size_t fwd_split_tc_smem() {
  return sizeof(bf16) * (2 * (TC_BQ + TC_BK) * SPLIT_CLD + 2 * TC_BK * SPLIT_SLD) +
         sizeof(int) * 2 * TC_BK;
}
constexpr size_t dkdv_split_tc_smem() {
  return sizeof(bf16) * (2 * (2 * TC_BK + 2 * TC_BWD_BQ) * SPLIT_CLD +
                         2 * 2 * TC_BWD_BQ * SPLIT_SLD) +
         sizeof(float) * 4 * TC_BWD_BQ;
}
constexpr size_t dq_split_tc_smem() {
  return sizeof(bf16) * (2 * (2 * TC_BQ + 2 * TC_BK) * SPLIT_CLD + 2 * TC_BK * SPLIT_SLD) +
         sizeof(int) * 2 * TC_BK;
}
// fwd 82,688 / dK,dV 99,840 / dQ 74,752 bytes (fp32); 72,192 / 90,624 /
// 109,056 (bf16): two blocks fit an SM's 228 KB.
static_assert(fwd_split_smem() <= 232448 && dkdv_split_smem() <= 232448 &&
                  dq_split_smem() <= 232448 && fwd_split_tc_smem() <= 232448 &&
                  dkdv_split_tc_smem() <= 232448 && dq_split_tc_smem() <= 232448,
              "a kernel's tiles exceed a block's shared memory");

// The head dims this build takes: the JAX package's rule above 256, with
// no upper bound.
bool head_dim_ok(int D) { return D > 256 && D % 8 == 0; }

int fwd_any(const void* q, const void* k, const void* v, const int* mask, void* out,
            float* lse, int B, int Sq, int Sk, int H, int Hkv, int D, int causal, int dtype,
            float scale, cudaStream_t s, int* info) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  const int ns = split_slices(D);
  if (dtype == 0)
    return launch(flash_fwd_split_kernel<SPLIT_DC>, dim3(Sq / BQ * ns, H, B), NT,
                  fwd_split_smem(), s, info, (const float*)q, (const float*)k, (const float*)v,
                  mask, (float*)out, lse, Sq, Sk, H, Hkv, D, causal, scale);
  return launch(flash_fwd_split_tc_kernel<SPLIT_DC>, dim3(Sq / TC_BQ * ns, H, B), TC_NT,
                fwd_split_tc_smem(), s, info, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                mask, (bf16*)out, lse, Sq, Sk, H, Hkv, D, causal, scale);
}

int dkdv_any(const void* q, const void* k, const void* v, const void* dO, const float* lse,
             const float* delta, const int* mask, void* dk, void* dv, int B, int Sq, int Sk,
             int H, int Hkv, int D, int causal, int dtype, int grad_fp32, float scale,
             cudaStream_t s, int* info) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  const int ns = split_slices(D);
  if (dtype == 0)
    return launch(flash_bwd_dkdv_split_kernel<SPLIT_DC>, dim3(Sk / BK * ns, Hkv, B), NT,
                  dkdv_split_smem(), s, info, (const float*)q, (const float*)k, (const float*)v,
                  (const float*)dO, lse, delta, mask, (float*)dk, (float*)dv, Sq, Sk, H, Hkv,
                  D, causal, scale);
  if (grad_fp32)
    return launch(flash_bwd_dkdv_split_tc_kernel<float, SPLIT_DC>,
                  dim3(Sk / TC_BK * ns, Hkv, B), TC_NT, dkdv_split_tc_smem(), s, info,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, lse, delta,
                  mask, (float*)dk, (float*)dv, Sq, Sk, H, Hkv, D, causal, scale);
  return launch(flash_bwd_dkdv_split_tc_kernel<bf16, SPLIT_DC>, dim3(Sk / TC_BK * ns, Hkv, B),
                TC_NT, dkdv_split_tc_smem(), s, info, (const bf16*)q, (const bf16*)k,
                (const bf16*)v, (const bf16*)dO, lse, delta, mask, (bf16*)dk, (bf16*)dv, Sq,
                Sk, H, Hkv, D, causal, scale);
}

int dq_any(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           const float* delta, const void* o, float* delta_out, const int* mask, void* dq,
           int B, int Sq, int Sk, int H, int Hkv, int D, int causal, int dtype, int grad_fp32,
           float scale, cudaStream_t s, int* info) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  const int ns = split_slices(D);
  if (dtype == 0)
    return launch(flash_bwd_dq_split_kernel<SPLIT_DC>, dim3(Sq / BQ * ns, H, B), NT,
                  dq_split_smem(), s, info, (const float*)q, (const float*)k, (const float*)v,
                  (const float*)dO, lse, delta, (const float*)o, delta_out, mask, (float*)dq,
                  Sq, Sk, H, Hkv, D, causal, scale);
  if (grad_fp32)
    return launch(flash_bwd_dq_split_tc_kernel<float, SPLIT_DC>, dim3(Sq / TC_BQ * ns, H, B),
                  TC_NT, dq_split_tc_smem(), s, info, (const bf16*)q, (const bf16*)k,
                  (const bf16*)v, (const bf16*)dO, lse, delta, (const bf16*)o, delta_out, mask,
                  (float*)dq, Sq, Sk, H, Hkv, D, causal, scale);
  return launch(flash_bwd_dq_split_tc_kernel<bf16, SPLIT_DC>, dim3(Sq / TC_BQ * ns, H, B),
                TC_NT, dq_split_tc_smem(), s, info, (const bf16*)q, (const bf16*)k,
                (const bf16*)v, (const bf16*)dO, lse, delta, (const bf16*)o, delta_out, mask,
                (bf16*)dq, Sq, Sk, H, Hkv, D, causal, scale);
}

#else  // FLASH_W: one kernel width

constexpr int KW = FLASH_W;  // this build's kernel width
static_assert(KW % 16 == 0 && KW >= 64 && KW <= 256, "FLASH_W: a multiple of 16 in 64..256");
constexpr int FT = fp32_tile(KW);

constexpr size_t fwd_smem() {
  return sizeof(float) * (BQ * (KW + 1) + BK * (KW + 1) + BK * KW + BQ * (BK + 1));
}
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * BK * (KW + 1) + 2 * FT * (KW + 1) + 2 * BK * (FT + 1) + 2 * FT);
}
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BQ * (KW + 1) + 2 * FT * (KW + 1) + BQ * (FT + 1));
}
constexpr size_t fwd_tc_smem() {
  return sizeof(bf16) * (TC_BQ + 4 * TC_BK) * tc_ld(KW) + sizeof(int) * 2 * TC_BK;
}
constexpr size_t dkdv_tc_smem() {
  return sizeof(bf16) * (2 * TC_BK + 4 * TC_BWD_BQ) * tc_ld(KW) + sizeof(float) * 4 * TC_BWD_BQ;
}
constexpr size_t dq_tc_smem() {
  return sizeof(bf16) * (2 * TC_BQ + 4 * TC_BK) * tc_ld(KW) + sizeof(int) * 2 * TC_BK;
}
// A block's dynamic shared memory on Hopper: at most 232,448 bytes.
static_assert(fwd_smem() <= 232448 && dkdv_smem() <= 232448 && dq_smem() <= 232448 &&
                  fwd_tc_smem() <= 232448 && dkdv_tc_smem() <= 232448 &&
                  dq_tc_smem() <= 232448,
              "a kernel's tiles exceed a block's shared memory");

// The head dims this build takes: the JAX package's rule (D >= 64, D % 8
// == 0) up to this width, i.e. KW and KW - 8 (KW alone at width 64).
bool head_dim_ok(int D) { return D >= 64 && D % 8 == 0 && D <= KW; }

// The tensor-core kernel `kern<args..., EXACT>` for head dim D: EXACT when D
// == KW, else the run-time-D kernel for KW - 8 (at width 64 no such D
// exists, so that build compiles only the EXACT kernel).
#define TC_KERNEL(kern, ...) \
  (D == KW ? kern<__VA_ARGS__, true> : kern<__VA_ARGS__, KW == 64>)

int fwd_any(const void* q, const void* k, const void* v, const int* mask, void* out,
            float* lse, int B, int Sq, int Sk, int H, int Hkv, int D, int causal, int dtype,
            float scale, cudaStream_t s, int* info) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(flash_fwd_kernel<float, KW>, dim3(Sq / BQ, H, B), NT, fwd_smem(), s, info,
                  (const float*)q, (const float*)k, (const float*)v, mask, (float*)out, lse,
                  Sq, Sk, H, Hkv, D, causal, scale);
  return launch(TC_KERNEL(flash_fwd_tc_kernel, KW), dim3(Sq / TC_BQ, H, B), TC_NT,
                fwd_tc_smem(), s, info, (const bf16*)q, (const bf16*)k, (const bf16*)v, mask,
                (bf16*)out, lse, Sq, Sk, H, Hkv, D, causal, scale);
}

int dkdv_any(const void* q, const void* k, const void* v, const void* dO, const float* lse,
             const float* delta, const int* mask, void* dk, void* dv, int B, int Sq, int Sk,
             int H, int Hkv, int D, int causal, int dtype, int grad_fp32, float scale,
             cudaStream_t s, int* info) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(flash_bwd_dkdv_kernel<float, float, KW>, dim3(Sk / BK, Hkv, B), NT,
                  dkdv_smem(), s, info, (const float*)q, (const float*)k, (const float*)v,
                  (const float*)dO, lse, delta, mask, (float*)dk, (float*)dv, Sq, Sk, H, Hkv,
                  D, causal, scale);
  if (grad_fp32)
    return launch(TC_KERNEL(flash_bwd_dkdv_tc_kernel, float, KW), dim3(Sk / TC_BK, Hkv, B),
                  TC_NT, dkdv_tc_smem(), s, info, (const bf16*)q, (const bf16*)k,
                  (const bf16*)v, (const bf16*)dO, lse, delta, mask, (float*)dk, (float*)dv, Sq,
                  Sk, H, Hkv, D, causal, scale);
  return launch(TC_KERNEL(flash_bwd_dkdv_tc_kernel, bf16, KW), dim3(Sk / TC_BK, Hkv, B),
                TC_NT, dkdv_tc_smem(), s, info, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                (const bf16*)dO, lse, delta, mask, (bf16*)dk, (bf16*)dv, Sq, Sk, H, Hkv, D,
                causal, scale);
}

int dq_any(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           const float* delta, const void* o, float* delta_out, const int* mask, void* dq,
           int B, int Sq, int Sk, int H, int Hkv, int D, int causal, int dtype, int grad_fp32,
           float scale, cudaStream_t s, int* info) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(flash_bwd_dq_kernel<float, float, KW>, dim3(Sq / BQ, H, B), NT, dq_smem(), s,
                  info, (const float*)q, (const float*)k, (const float*)v, (const float*)dO,
                  lse, delta, (const float*)o, delta_out, mask, (float*)dq, Sq, Sk, H, Hkv, D,
                  causal, scale);
  if (grad_fp32)
    return launch(TC_KERNEL(flash_bwd_dq_tc_kernel, float, KW), dim3(Sq / TC_BQ, H, B),
                  TC_NT, dq_tc_smem(), s, info, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                  (const bf16*)dO, lse, delta, (const bf16*)o, delta_out, mask, (float*)dq, Sq,
                  Sk, H, Hkv, D, causal, scale);
  return launch(TC_KERNEL(flash_bwd_dq_tc_kernel, bf16, KW), dim3(Sq / TC_BQ, H, B), TC_NT,
                dq_tc_smem(), s, info, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                (const bf16*)dO, lse, delta, (const bf16*)o, delta_out, mask, (bf16*)dq, Sq, Sk,
                H, Hkv, D, causal, scale);
}

#endif  // FLASH_SPLIT

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, const int* mask,
              void* out, float* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
              int causal, int dtype, float scale, void* stream) {
  return fwd_any(q, k, v, mask, out, lse, B, Sq, Sk, H, Hkv, D, causal, dtype, scale,
                 (cudaStream_t)stream, nullptr);
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dO,
                   const float* lse, const float* delta, const int* mask, void* dk,
                   void* dv, int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                   int dtype, int grad_fp32, float scale, void* stream) {
  return dkdv_any(q, k, v, dO, lse, delta, mask, dk, dv, B, Sq, Sk, H, Hkv, D, causal, dtype,
                  grad_fp32, scale, (cudaStream_t)stream, nullptr);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* delta, const void* o, float* delta_out,
                 const int* mask, void* dq, int B, int Sq, int Sk, int H, int Hkv, int D,
                 int causal, int dtype, int grad_fp32, float scale, void* stream) {
  return dq_any(q, k, v, dO, lse, delta, o, delta_out, mask, dq, B, Sq, Sk, H, Hkv, D, causal,
                dtype, grad_fp32, scale, (cudaStream_t)stream, nullptr);
}

// Resources of the kernel that kernel (0 = flash_fwd, 1 = flash_bwd_dkdv,
// 2 = flash_bwd_dq) launches for (D, dtype, grad_fp32), into info[6]:
// registers, local bytes per thread, static shared bytes, dynamic shared
// bytes, threads per block, resident blocks per SM.
int flash_kernel_info(int kernel, int D, int dtype, int grad_fp32, int* info) {
  const float scale = 1.f;
  switch (kernel) {
    case 0:
      return fwd_any(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 0, 0, 1, 1, D,
                     0, dtype, scale, nullptr, info);
    case 1:
      return dkdv_any(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, 1, 0, 0, 1, 1, D, 0, dtype, grad_fp32, scale, nullptr, info);
    case 2:
      return dq_any(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, 1, 0, 0, 1, 1, D, 0, dtype, grad_fp32, scale, nullptr, info);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
