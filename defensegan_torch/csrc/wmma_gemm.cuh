// Tiled tensor-core GEMM with a fused elementwise epilogue, shared by the
// fused projection loops (fused_projection_v2.cu, fused_projection_v2i.cu,
// fused_projection_v3.cu, fused_projection_v4.cu): their fc products, v3's
// packed conv B, and v2's and v2i's four products. The 3x3 grid convs of
// v3 and v4 run on Hopper's wgmma + TMA instead (conv3x3_sm90.cuh).
//
//   C[M, N] = A[M, K] @ B[K, N],  A and B row-major, then epi(row, col, acc)
//
// Element types: bf16 x bf16 -> f32 accumulators, or int8 x int8 -> int32.
// The product runs on the tensor cores through WMMA 16x16x16 fragments
// (mma.sync underneath). Each block of 4 warps owns a 64x64 output tile;
// each warp a 32x32 quadrant (2x2 fragments). The K loop streams 64-byte
// deep slabs of A and B through a 2-stage cp.async ring in shared memory,
// so the next slab's copy overlaps the current slab's products. The
// epilogue stages one 16x16 accumulator fragment per warp in shared memory
// and hands each element, with its global (row, col), to the functor: the
// elementwise work of a projection step (bias, relu, tanh-gradient, mask,
// momentum update) is fused into the product that feeds it.
//
// Requirements (checked by the Python wrappers): M % 64 == 0,
// N % 64 == 0, K % 32 == 0 (bf16) or K % 64 == 0 (int8), and every row
// start 16-byte aligned. Nothing is allocated here; launches go on the
// caller's stream.
//
// These products still run at mma.sync's rate; the grid convs run on wgmma
// + TMA (conv3x3_sm90.cuh), and the same design is the way for these too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace fpk {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kThreads = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory geometry per element type. A slab is kBM rows x 64 bytes
// (4 chunks of 16 bytes); a B slab is BK rows x kBN columns. WMMA wants
// every fragment pointer 32-byte aligned: for bf16 a 16-deep k step is 32
// bytes, for int8 it is 16, so int8 chunks are stored at a 32-byte pitch.
// Row strides carry 16 bytes of padding against bank conflicts.
template <typename T>
struct Tile;

template <>
struct Tile<bf16> {
  using Acc = float;
  static constexpr int BK = 32;           // elements per slab
  static constexpr int kAStride = 80;     // bytes per A row in smem
  static constexpr int kAPitch = 16;      // bytes between A chunks
  static constexpr int kBStride = 144;    // bytes per B row in smem
  static constexpr int kBPitch = 16;      // bytes between B chunks
  static constexpr int kBChunks = 8;      // 16-byte chunks per B row
};

template <>
struct Tile<int8_t> {
  using Acc = int;
  static constexpr int BK = 64;
  static constexpr int kAStride = 144;
  static constexpr int kAPitch = 32;
  static constexpr int kBStride = 144;
  static constexpr int kBPitch = 32;
  static constexpr int kBChunks = 4;
};

template <typename T>
struct Geometry {
  using TT = Tile<T>;
  static constexpr int kASize = kBM * TT::kAStride;
  static constexpr int kBSize = TT::BK * TT::kBStride;
  static constexpr int kStage = kASize + kBSize;
  static constexpr int kEpi = 4 * 256 * 4;  // one 16x16 fragment per warp
  static constexpr int kSmem = 2 * kStage + kEpi;
  static_assert(kASize % 32 == 0 && kStage % 32 == 0, "32-byte alignment");
  static_assert(kSmem <= 48 * 1024, "static shared memory limit");
};

template <typename T>
using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                       typename Tile<T>::Acc>;

// Copies one slab into a stage: kBM rows x BK of A from `a` (the slab's
// first element, row stride lda) and BK rows x kBN of B from `b`.
template <typename T>
__device__ __forceinline__ void load_slab(unsigned char* stage, const T* a,
                                          int lda, const T* b, int ldb) {
  using TT = Tile<T>;
  constexpr int kPerChunk = 16 / sizeof(T);
  const int t = threadIdx.x;
  // A: kBM rows x 4 chunks = 256 chunks, two per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int id = t + i * kThreads;
    int r = id >> 2, c = id & 3;
    cp_async16(stage + r * TT::kAStride + c * TT::kAPitch,
               a + (size_t)r * lda + c * kPerChunk);
  }
  // B: BK rows x kBChunks chunks = 256 chunks, two per thread
  unsigned char* sb = stage + Geometry<T>::kASize;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int id = t + i * kThreads;
    int r = id / TT::kBChunks, c = id % TT::kBChunks;
    cp_async16(sb + r * TT::kBStride + c * TT::kBPitch,
               b + (size_t)r * ldb + c * kPerChunk);
  }
}

// acc += (this warp's 32x32 quadrant of) one staged slab's product.
template <typename T>
__device__ __forceinline__ void mma_slab(AccFrag<T> (&acc)[2][2],
                                         const unsigned char* sa, int wr,
                                         int wc) {
  using namespace nvcuda;
  using TT = Tile<T>;
  const unsigned char* sb = sa + Geometry<T>::kASize;
#pragma unroll
  for (int kk = 0; kk < TT::BK / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // a 16-deep k step is 32 bytes into the A row for both types
      const T* p = reinterpret_cast<const T*>(
          sa + (wr * 32 + i * 16) * TT::kAStride + kk * 32);
      wmma::load_matrix_sync(fa[i], p, TT::kAStride / sizeof(T));
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // 16 columns span 32 bytes of a B row for both types
      const T* p = reinterpret_cast<const T*>(
          sb + (kk * 16) * TT::kBStride + (wc * 32 + j * 16) * 2);
      wmma::load_matrix_sync(fb[j], p, TT::kBStride / sizeof(T));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// The K loop of one 64x64 tile: acc = sum over n_slabs slabs, streamed
// through the 2-stage ring in one accumulation chain. src(s, pa, pb) names
// slab s: the first element of its A rows (row stride lda) and of its B
// rows (row stride ldb).
template <typename T, typename Src>
__device__ __forceinline__ void mma_pipeline(AccFrag<T> (&acc)[2][2],
                                             unsigned char* smem,
                                             const Src& src, int lda,
                                             int ldb, int n_slabs) {
  using namespace nvcuda;
  using Acc = typename Tile<T>::Acc;
  using G = Geometry<T>;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], Acc(0));
  if (n_slabs <= 0) return;

  const T* pa;
  const T* pb;
  src(0, pa, pb);
  load_slab<T>(smem, pa, lda, pb, ldb);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) {
      src(s + 1, pa, pb);
      load_slab<T>(smem + ((s + 1) & 1) * G::kStage, pa, lda, pb, ldb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_slab<T>(acc, smem + (s & 1) * G::kStage, wr, wc);
    __syncthreads();
  }
}

// Hands every element of the block's 64x64 tile, with its (row, col) from
// (m0, n0), to f(row, col, value), one staged 16x16 fragment at a time.
template <typename T, typename F>
__device__ __forceinline__ void store_tile(AccFrag<T> (&acc)[2][2],
                                           unsigned char* smem, int m0,
                                           int n0, const F& f) {
  using namespace nvcuda;
  using Acc = typename Tile<T>::Acc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp >> 1, wc = warp & 1;
  Acc* stage =
      reinterpret_cast<Acc*>(smem + 2 * Geometry<T>::kStage) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row0 = m0 + wr * 32 + i * 16;
      const int col0 = n0 + wc * 32 + j * 16;
      // lanes 0-15 take 16 consecutive columns of one row, lanes 16-31
      // the next row: each warp access covers two 16-element row segments
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int idx = e * 32 + lane;
        f(row0 + (idx >> 4), col0 + (idx & 15), stage[idx]);
      }
      __syncwarp();
    }
  }
}

// Slabs of a plain product: slab s is K rows [s*BK, (s+1)*BK).
template <typename T>
struct GemmSlabs {
  const T* a;  // A + m0 * lda
  const T* b;  // B + n0
  int ldb;
  __device__ __forceinline__ void operator()(int s, const T*& pa,
                                             const T*& pb) const {
    pa = a + s * Tile<T>::BK;
    pb = b + (size_t)s * Tile<T>::BK * ldb;
  }
};

// One 64x64 tile of C = A @ B, then epi(row, col, acc) on every element.
template <typename T, typename Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_epilogue(const T* __restrict__ A, int lda, const T* __restrict__ B,
                  int ldb, int K, Epi epi) {
  __shared__ __align__(128) unsigned char smem[Geometry<T>::kSmem];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  AccFrag<T> acc[2][2];
  GemmSlabs<T> src{A + (size_t)m0 * lda, B + n0, ldb};
  mma_pipeline<T>(acc, smem, src, lda, ldb, K / Tile<T>::BK);
  store_tile<T>(acc, smem, m0, n0, epi);
}

template <typename T, typename Epi>
inline cudaError_t launch_gemm(const T* A, int lda, const T* B, int ldb,
                               int M, int N, int K, Epi epi,
                               cudaStream_t stream) {
  dim3 grid(N / kBN, M / kBM);
  gemm_epilogue<T, Epi><<<grid, kThreads, 0, stream>>>(A, lda, B, ldb, K,
                                                       epi);
  return cudaGetLastError();
}

// z (f32) -> bf16 copy: the first step's A operand of z @ W1.
__global__ void cast_bf16(const float* __restrict__ z, bf16* __restrict__ zb,
                          int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) zb[i] = __float2bfloat16_rn(z[i]);
}

inline cudaError_t launch_cast_bf16(const float* z, bf16* zb, int n,
                                    cudaStream_t stream) {
  cast_bf16<<<(n + 255) / 256, 256, 0, stream>>>(z, zb, n);
  return cudaGetLastError();
}

// h = relu(acc + b1), stored in bf16 (v2) or f32 (v2i).
template <typename Out>
struct EpiBiasRelu {
  const float* b1;
  Out* h;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    float v = fmaxf(acc + b1[c], 0.0f);
    if constexpr (sizeof(Out) == 2) {
      h[(size_t)r * ld + c] = __float2bfloat16_rn(v);
    } else {
      h[(size_t)r * ld + c] = v;
    }
  }
};

// Momentum update from dz = acc: v = m*v + dz; z = z - lr*v; zb = bf16(z).
struct EpiMomentum {
  float* z;
  float* v;
  bf16* zb;
  int ld;
  float momentum;
  float lr;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    size_t i = (size_t)r * ld + c;
    float vv = momentum * v[i] + acc;
    float zz = z[i] - lr * vv;
    v[i] = vv;
    z[i] = zz;
    zb[i] = __float2bfloat16_rn(zz);
  }
};

// dh = acc * [h > 0] -> bf16. The mask is taken from the bf16 h, which is
// positive exactly where the f32 h is (bf16 keeps f32's exponent range).
// h and dh may be the same buffer: each element is read, then written, by
// the one thread that owns it.
struct EpiReluMask {
  const bf16* h;
  bf16* dh;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    size_t i = (size_t)r * ld + c;
    dh[i] = __float2bfloat16_rn(__bfloat162float(h[i]) > 0.0f ? acc : 0.0f);
  }
};

}  // namespace fpk
