// Flash attention for Hopper (sm_90a): forward, dK/dV backward, dQ backward.
//
// Replaces the three Pallas TPU kernels of maggy_tpu/ops/attention.py:
//   bf16: flash_fwd_tc_kernel       <- _flash_fwd_kernel       (pallas_call at :226)
//         flash_bwd_dkdv_tc_kernel  <- _flash_bwd_dkdv_kernel  (pallas_call at :443)
//         flash_bwd_dq_tc_kernel    <- _flash_bwd_dq_kernel    (pallas_call at :482)
//   fp32: flash_fwd_kernel, flash_bwd_dkdv_kernel, flash_bwd_dq_kernel (the
//         same three, on CUDA cores)
//
// Layouts (all row-major, contiguous): q/dO/out/dq [B,Sq,H,D], k/v/dk/dv
// [B,Sk,Hkv,D] with H % Hkv == 0 (GQA: query head h reads kv head h / rep,
// K/V are never repeated in memory), mask [B,Sk] int32 keep-mask or null,
// lse/delta [B,H,Sq] fp32.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the BERT-base
// training shape B=32, S=128, H=12, D=64, bf16, padded: the forward moves
// ~25 MB (q,k,v read, out and lse written) for ~1.6 GFLOP: 7.6 us of memory
// time against ~1.6 us of tensor-core time, so bytes bound it; dK/dV moves
// ~38 MB (11.4 us) and dQ ~32 MB (9.5 us; ~38 MB when it also reads O and
// writes delta), bytes again. chip_smoke.py computes the bound from each
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
// ~47 KB (forward), ~37 KB (dK/dV) and ~55 KB (dQ) of shared memory at D=64
// leave several blocks resident on each SM.
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
  const int n_keys = keys_seen(causal, qi * BQ, offset, Sk);

  load_tile<T, D>(sQ, DP, q + ((size_t)b * Sq + qi * BQ) * qs + (size_t)h * D, qs, BQ, sm_scale);
  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int kb = 0; kb * BK < n_keys; ++kb) {
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
      const int n = keys_seen(causal, qi * BQ, offset, Sk);
      if (kb * BK >= n) continue;
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
      const float uniform = 1.f / n;
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

// With `o` set, delta is computed here (four threads a row) and written to
// delta_out; else it is read from `delta`.
template <typename T, typename G, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const T* __restrict__ o, float* __restrict__ delta_out,
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

  load_tile<T, D>(sQ, DP, q + qoff, qs, BQ, 1.f);
  load_tile<T, D>(sdO, DP, dO + qoff, qs, BQ, 1.f);
  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  for (int kb = 0; kb * BK < n_keys; ++kb) {
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

  G* dq_row = dq + ((size_t)b * Sq + qpos) * qs + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < DC; ++c) dq_row[part + 4 * c] = from_f<G>(acc[c]);
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
// memory with row stride LD, 16 bytes per cp.async.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, size_t stride) {
  constexpr int CPR = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += TC_NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    cp_async16(dst + r * LD + c, src + r * stride + c);
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

// Shared row stride of a bf16 tile: D plus 16 bytes, so the eight rows one
// ldmatrix reads start in eight different 4-bank groups.
__host__ __device__ constexpr int tc_ld(int D) { return D + 8; }

template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ mask,
                    bf16* __restrict__ out, float* __restrict__ lse,
                    int Sq, int Sk, int H, int Hkv, int causal, float sm_scale) {
  constexpr int LD = tc_ld(D), KC = D / 16, DT = D / 8, ST = TC_BK / 8;
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
    cp_tile<TC_BK, D, LD>(sK + buf * TC_BK * LD, k + koff, ks);
    cp_tile<TC_BK, D, LD>(sV + buf * TC_BK * LD, v + koff, ks);
    if (mask && threadIdx.x < TC_BK / 4)
      cp_async16(sM + buf * TC_BK + threadIdx.x * 4,
                 mask + (size_t)b * Sk + kb * TC_BK + threadIdx.x * 4);
  };

  cp_tile<TC_BQ, D, LD>(sQ, q + ((size_t)b * Sq + q0) * qs + (size_t)h * D, qs);
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
      for (int dp = 0; dp < D / 16; ++dp) {
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

template <typename G, int D>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ mask, G* __restrict__ dk,
                         G* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                         int causal, float sm_scale) {
  constexpr int LD = tc_ld(D), QB = TC_BWD_BQ, KC = D / 16, DT = D / 8, ST = QB / 8;
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
    cp_tile<QB, D, LD>(sQ + buf * QB * LD, q + qoff, qs);
    cp_tile<QB, D, LD>(sdO + buf * QB * LD, dO + qoff, qs);
    const size_t st = ((size_t)b * H + h) * Sq + qb * QB;
    if (threadIdx.x < QB / 4)
      cp_async16(sL + buf * QB + threadIdx.x * 4, lse + st + threadIdx.x * 4);
    else if (threadIdx.x < QB / 2)
      cp_async16(sD + buf * QB + (threadIdx.x - QB / 4) * 4,
                 delta + st + (threadIdx.x - QB / 4) * 4);
  };

  cp_tile<TC_BK, D, LD>(sK, k + koff, ks);
  cp_tile<TC_BK, D, LD>(sV, v + koff, ks);
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
      for (int dp = 0; dp < D / 16; ++dp) {
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
      for (int dp = 0; dp < D / 16; ++dp) {
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

// Q and dO A fragments stay in registers across the key loop up to this head
// dim; above it they are re-read from shared memory for every key tile.
constexpr int DQ_HOLD_D = 96;

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
// takes its 16-byte chunks t, t+4, ... and row_sum4 adds them; delta goes
// to delta_out for the dK/dV kernel.
template <typename G, int D>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const bf16* __restrict__ o, float* __restrict__ delta_out,
                       const int* __restrict__ mask, G* __restrict__ dq,
                       int Sq, int Sk, int H, int Hkv, int causal, float sm_scale) {
  constexpr int LD = tc_ld(D), KC = D / 16, DT = D / 8, ST = TC_BK / 8, CH = D / 32;
  constexpr bool HOLD = D <= DQ_HOLD_D;
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
    cp_tile<TC_BK, D, LD>(sK + buf * TC_BK * LD, k + koff, ks);
    cp_tile<TC_BK, D, LD>(sV + buf * TC_BK * LD, v + koff, ks);
    if (mask && threadIdx.x < TC_BK / 4)
      cp_async16(sM + buf * TC_BK + threadIdx.x * 4,
                 mask + (size_t)b * Sk + kb * TC_BK + threadIdx.x * 4);
  };

  cp_tile<TC_BQ, D, LD>(sQ, q + qoff, qs);
  cp_tile<TC_BQ, D, LD>(sdO, dO + qoff, qs);
  if (n_kb > 0) load_kv(0, 0);
  cp_async_commit();

  float L[2], dl[2];
  uint4 ov[2][CH];
  if (o) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < CH; ++c)
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
        sum += dot8(ov[i][c],
                    *reinterpret_cast<const uint4*>(sdO + (r0 + 8 * i) * LD + (t + 4 * c) * 8));
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
      for (int dc = 0; dc < D / 16; ++dc) {
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
    for (int j = 0; j < DT; ++j) store2(row + 8 * j + 2 * t, acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// ---------------------------------------------------------------- launch

size_t fwd_smem(int D) { return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)); }
size_t dkdv_smem(int D) {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}
size_t dq_smem(int D) { return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)); }
size_t fwd_tc_smem(int D) {
  return sizeof(bf16) * (TC_BQ + 4 * TC_BK) * tc_ld(D) + sizeof(int) * 2 * TC_BK;
}
size_t dkdv_tc_smem(int D) {
  return sizeof(bf16) * (2 * TC_BK + 4 * TC_BWD_BQ) * tc_ld(D) + sizeof(float) * 4 * TC_BWD_BQ;
}
size_t dq_tc_smem(int D) {
  return sizeof(bf16) * (2 * TC_BQ + 4 * TC_BK) * tc_ld(D) + sizeof(int) * 2 * TC_BK;
}

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

template <typename T, int D>
int fwd_t(const void* q, const void* k, const void* v, const int* mask, void* out,
          float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal, float scale,
          cudaStream_t s, int* info) {
  return launch(flash_fwd_kernel<T, D>, dim3(Sq / BQ, H, B), NT, fwd_smem(D), s, info,
                (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, lse, Sq, Sk, H, Hkv,
                causal, scale);
}

template <int D>
int fwd_tc_t(const void* q, const void* k, const void* v, const int* mask, void* out,
             float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal, float scale,
             cudaStream_t s, int* info) {
  return launch(flash_fwd_tc_kernel<D>, dim3(Sq / TC_BQ, H, B), TC_NT, fwd_tc_smem(D), s, info,
                (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, (bf16*)out, lse, Sq, Sk,
                H, Hkv, causal, scale);
}

template <typename T, typename G, int D>
int dkdv_t(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           const float* delta, const int* mask, void* dk, void* dv, int B, int Sq, int Sk,
           int H, int Hkv, int causal, float scale, cudaStream_t s, int* info) {
  return launch(flash_bwd_dkdv_kernel<T, G, D>, dim3(Sk / BK, Hkv, B), NT, dkdv_smem(D), s,
                info, (const T*)q, (const T*)k, (const T*)v, (const T*)dO, lse, delta, mask,
                (G*)dk, (G*)dv, Sq, Sk, H, Hkv, causal, scale);
}

template <typename G, int D>
int dkdv_tc_t(const void* q, const void* k, const void* v, const void* dO, const float* lse,
              const float* delta, const int* mask, void* dk, void* dv, int B, int Sq, int Sk,
              int H, int Hkv, int causal, float scale, cudaStream_t s, int* info) {
  return launch(flash_bwd_dkdv_tc_kernel<G, D>, dim3(Sk / TC_BK, Hkv, B), TC_NT,
                dkdv_tc_smem(D), s, info, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                (const bf16*)dO, lse, delta, mask, (G*)dk, (G*)dv, Sq, Sk, H, Hkv, causal,
                scale);
}

template <typename T, typename G, int D>
int dq_t(const void* q, const void* k, const void* v, const void* dO, const float* lse,
         const float* delta, const void* o, float* delta_out, const int* mask, void* dq,
         int B, int Sq, int Sk, int H, int Hkv, int causal, float scale, cudaStream_t s,
         int* info) {
  return launch(flash_bwd_dq_kernel<T, G, D>, dim3(Sq / BQ, H, B), NT, dq_smem(D), s, info,
                (const T*)q, (const T*)k, (const T*)v, (const T*)dO, lse, delta,
                (const T*)o, delta_out, mask, (G*)dq, Sq, Sk, H, Hkv, causal, scale);
}

template <typename G, int D>
int dq_tc_t(const void* q, const void* k, const void* v, const void* dO, const float* lse,
            const float* delta, const void* o, float* delta_out, const int* mask, void* dq,
            int B, int Sq, int Sk, int H, int Hkv, int causal, float scale, cudaStream_t s,
            int* info) {
  return launch(flash_bwd_dq_tc_kernel<G, D>, dim3(Sq / TC_BQ, H, B), TC_NT, dq_tc_smem(D), s,
                info, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, lse,
                delta, (const bf16*)o, delta_out, mask, (G*)dq, Sq, Sk, H, Hkv, causal, scale);
}

#define DISPATCH_D(D, CALL)                      \
  switch (D) {                                   \
    case 64: { constexpr int DD = 64; return CALL; }   \
    case 96: { constexpr int DD = 96; return CALL; }   \
    case 128: { constexpr int DD = 128; return CALL; } \
    default: return (int)cudaErrorInvalidValue;  \
  }

// dtype codes: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (tensor-core
// kernels). grad_fp32 = 1 writes fp32 gradients from bf16 inputs (the
// ring-attention building block); otherwise gradients take the input type.
// dQ computes delta into delta_out when given the forward's output `o`
// (then `delta` is null), else reads `delta`. A non-null `info` describes
// the kernel the call would launch.
int fwd_any(const void* q, const void* k, const void* v, const int* mask, void* out,
            float* lse, int B, int Sq, int Sk, int H, int Hkv, int D, int causal, int dtype,
            float scale, cudaStream_t s, int* info) {
  if (dtype == 0) {
    DISPATCH_D(D, (fwd_t<float, DD>(q, k, v, mask, out, lse, B, Sq, Sk, H, Hkv, causal, scale, s, info)));
  }
  DISPATCH_D(D, (fwd_tc_t<DD>(q, k, v, mask, out, lse, B, Sq, Sk, H, Hkv, causal, scale, s, info)));
}

int dkdv_any(const void* q, const void* k, const void* v, const void* dO, const float* lse,
             const float* delta, const int* mask, void* dk, void* dv, int B, int Sq, int Sk,
             int H, int Hkv, int D, int causal, int dtype, int grad_fp32, float scale,
             cudaStream_t s, int* info) {
  if (dtype == 0) {
    DISPATCH_D(D, (dkdv_t<float, float, DD>(q, k, v, dO, lse, delta, mask, dk, dv, B, Sq, Sk, H, Hkv, causal, scale, s, info)));
  }
  if (grad_fp32) {
    DISPATCH_D(D, (dkdv_tc_t<float, DD>(q, k, v, dO, lse, delta, mask, dk, dv, B, Sq, Sk, H, Hkv, causal, scale, s, info)));
  }
  DISPATCH_D(D, (dkdv_tc_t<bf16, DD>(q, k, v, dO, lse, delta, mask, dk, dv, B, Sq, Sk, H, Hkv, causal, scale, s, info)));
}

int dq_any(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           const float* delta, const void* o, float* delta_out, const int* mask, void* dq,
           int B, int Sq, int Sk, int H, int Hkv, int D, int causal, int dtype, int grad_fp32,
           float scale, cudaStream_t s, int* info) {
  if (dtype == 0) {
    DISPATCH_D(D, (dq_t<float, float, DD>(q, k, v, dO, lse, delta, o, delta_out, mask, dq, B, Sq, Sk, H, Hkv, causal, scale, s, info)));
  }
  if (grad_fp32) {
    DISPATCH_D(D, (dq_tc_t<float, DD>(q, k, v, dO, lse, delta, o, delta_out, mask, dq, B, Sq, Sk, H, Hkv, causal, scale, s, info)));
  }
  DISPATCH_D(D, (dq_tc_t<bf16, DD>(q, k, v, dO, lse, delta, o, delta_out, mask, dq, B, Sq, Sk, H, Hkv, causal, scale, s, info)));
}

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
