// The 1x1 projection over voxel rows (the ResBlock's skip_proj), forward and
// weight gradient: y[r, :] = x[r, :] @ w + bias + residual, and
// dw = sum over r of x[r, :]^T ct[r, :], db = sum over r of ct[r, :].
//
// Replaces the Pallas TPU kernels vdm4cdm_tpu/ops/pallas/lanemm.py::_fwd_kernel
// (reached through _run_fwd, also as the dx pass on the transposed weight) and
// ::_dw_kernel (reached through _run_dw). The TPU kernels work on lane-packed
// rows with a block-diagonal weight; here rows are plain channels-last voxels,
// x is (R, K) with R = B * D * H * W, and w is the plain (K, N) matrix, so
// nothing of that packing has a counterpart.
//
// Bound on the H100: bytes. The widest site (K = N = 256, bf16) does
// 2 * 256 * 256 operations per 1,024 bytes of rows, 128 per byte, under the
// card's ~295; every other site is further below. So the kernels read each
// row of x (and the residual, and ct) once from device memory with 16-byte
// cp.async copies, keep the weight tile in shared memory, and fold what would
// otherwise be passes of their own into the epilogue: the bias, the residual
// (the first half's output of a split pair projection, or nothing) and the one
// rounding to the output dtype.
//
// Forward: a block owns 128 rows and BN output columns and walks K in chunks
// staged two deep in shared memory. Blocks that share rows are neighbours in
// the grid (the column tile is the fastest index), so the rows they all read
// come from L2 after the first. bf16 runs on the tensor cores through
// mma.sync m16n8k16 with f32 accumulators, f32 on plain FMAs so that its
// products stay in full f32. The weight arrives transposed, (N, K), so that
// both tiles are K-minor; the dx pass is the same kernel on the untransposed
// weight with no bias.
//
// Weight gradient: the contraction runs over R (thousands to millions of rows)
// into at most 256 x 256 outputs, so R is split: a block owns a (K tile,
// N tile) and a run of consecutive rows, walks the run in chunks of 32 rows,
// accumulates in registers and adds its f32 tile to the zeroed output with
// atomicAdd. The order of those additions changes from run to run, so two
// runs agree to f32 rounding of a sum over R terms, not bitwise. Both operands
// are row-major with channels contiguous, so R is the outer dimension of both
// shared-memory tiles and ldmatrix.trans delivers the mma fragments. The
// blocks of the first K tile also sum their ct tiles' columns into db.
//
// This first version uses mma.sync and cp.async, not wgmma/TMA, and stores
// the output from the mma fragments directly (4 or 8 bytes a thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // forward: rows per block
constexpr int THREADS = 256;
constexpr int DK = 32;  // weight gradient: rows per chunk

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int VEC = 8, BK = 32; };
template <> struct Tile<float> { static constexpr int VEC = 4, BK = 16; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices, each transposed on the way into the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ------------------------------------------------------------------ forward

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
mm1x1_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                 const float* __restrict__ bias, const T* __restrict__ res,
                 T* __restrict__ out, long long R, int K, int N, int tiles_n) {
  constexpr int VEC = Tile<T>::VEC, BK = Tile<T>::BK, LD = BK + VEC;
  static_assert(BK / VEC == 4, "four 16-byte vectors per tile row");
  __shared__ __align__(16) T As[2][BM][LD];
  __shared__ __align__(16) T Bs[2][BN][LD];

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long m0 = (tile / tiles_n) * BM;
  const int n0 = (int)(tile % tiles_n) * BN;
  const int n_chunks = (K + BK - 1) / BK;

  // Each thread copies two 16-byte vectors of every A tile: row v / 4,
  // channel segment v % 4, for v = tid and tid + THREADS.
  auto load_chunk = [&](int kc, int stage) {
    const int c0 = kc * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * THREADS;
      const int row = v >> 2, seg = v & 3;
      const int c = c0 + seg * VEC;
      const long long m = m0 + row;
      const bool ok = m < R && c < K;
      const T* src = ok ? x + m * K + c : x;
      cp_async16(&As[stage][row][seg * VEC], src, ok);
    }
    for (int v = tid; v < BN * 4; v += THREADS) {
      const int n = v >> 2, seg = v & 3;
      const int c = c0 + seg * VEC;
      const bool ok = (n0 + n) < N && c < K;
      const T* src = ok ? wt + (long long)(n0 + n) * K + c : wt;
      cp_async16(&Bs[stage][n][seg * VEC], src, ok);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;

  if constexpr (sizeof(T) == 2) {
    // ---- bf16: tensor cores, warps tiled WARPS_M x WARPS_N, 32 columns each
    constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
    constexpr int WM = BM / WARPS_M, MT = WM / 16, NT = 4;
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    load_chunk(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int st = kc & 1;
      if (kc + 1 < n_chunks) load_chunk(kc + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[MT][4], bf[NT][2];
        const int k = ks + t4 * 2;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = wm * WM + i * 16 + g;
          af[i][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][k]);
          af[i][1] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][k]);
          af[i][2] = *reinterpret_cast<const uint32_t*>(&As[st][r][k + 8]);
          af[i][3] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][k + 8]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wn * 32 + j * 8 + g;
          bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[st][n][k]);
          bf[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[st][n][k + 8]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
      }
      __syncthreads();
    }

    // epilogue: C fragment (rows g and g + 8, columns t4 * 2 and t4 * 2 + 1).
    // N is even and the column is even, so the pair is in range together and
    // its 4-byte access is aligned.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * 32 + j * 8 + t4 * 2;
      if (col >= N) continue;
      const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm * WM + i * 16 + g + h * 8;
          if (m >= R) continue;
          const long long o = m * N + col;
          float v0 = acc[i][j][h * 2] + b0, v1 = acc[i][j][h * 2 + 1] + b1;
          if (res) {
            const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + o);
            v0 += __low2float(r2);
            v1 += __high2float(r2);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
        }
    }
  } else {
    // ---- f32: FMAs, each thread a TM x 4 register tile (rows and columns
    // strided so that a warp's shared-memory reads broadcast)
    constexpr int TNT = BN / 4, TMT = THREADS / TNT, TM = BM / TMT;
    const int tn = tid % TNT, tm = tid / TNT;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    load_chunk(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int st = kc & 1;
      if (kc + 1 < n_chunks) load_chunk(kc + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], bv[4];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = to_f32(As[st][tm + i * TMT][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_f32(Bs[st][tn + j * TNT][k]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tn + j * TNT;
      if (col >= N) continue;
      const float b = bias ? bias[col] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long m = m0 + tm + i * TMT;
        if (m >= R) continue;
        const long long o = m * N + col;
        float v = acc[i][j] + b;
        if (res) v += to_f32(res[o]);
        out[o] = static_cast<T>(v);
      }
    }
  }
}

template <typename T, int BN>
cudaError_t launch_fwd(const void* x, const void* wt, const float* bias, const void* res,
                       void* out, long long R, int K, int N, cudaStream_t stream) {
  const long long tiles_m = (R + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = tiles_m * tiles_n;
  if (tiles < 1 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  mm1x1_fwd_kernel<T, BN><<<(unsigned)tiles, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), bias, static_cast<const T*>(res),
      static_cast<T*>(out), R, K, N, tiles_n);
  return cudaGetLastError();
}

// ---------------------------------------------------------- weight gradient

template <typename T, int DM, int DN>
__global__ void __launch_bounds__((DM / 16) * (DN / 32) * 32)
mm1x1_dw_kernel(const T* __restrict__ x, const T* __restrict__ ct, float* __restrict__ dw,
                float* __restrict__ db, long long R, int K, int N, long long run) {
  constexpr int NTHREADS = (DM / 16) * (DN / 32) * 32;
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int SEGX = DM / VEC, SEGC = DN / VEC;
  constexpr int NX = DK * SEGX / NTHREADS, NC = DK * SEGC / NTHREADS;
  constexpr int LDX = DM + VEC, LDC = DN + VEC;
  static_assert(NX >= 1 && NC >= 1 && DK * SEGX % NTHREADS == 0 && DK * SEGC % NTHREADS == 0,
                "whole vectors per thread");
  __shared__ __align__(16) T Xs[2][DK][LDX];
  __shared__ __align__(16) T Cs[2][DK][LDC];

  const int tid = threadIdx.x;
  const int tiles_n = (N + DN - 1) / DN;
  const int tile = blockIdx.y;
  const int ci0 = (tile / tiles_n) * DM, co0 = (tile % tiles_n) * DN;
  const long long v0 = (long long)blockIdx.x * run;
  const long long v1 = (v0 + run < R) ? v0 + run : R;
  if (v0 >= v1) return;
  const int n_chunks = (int)((v1 - v0 + DK - 1) / DK);
  const bool do_db = db != nullptr && ci0 == 0;

  // Rows past the run's end and channel tails are zero-filled by the copy.
  auto load_chunk = [&](int kc, int stage) {
    const long long base = v0 + (long long)kc * DK;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int v = tid + i * NTHREADS;
      const int row = v / SEGX, seg = v % SEGX;
      const int c = ci0 + seg * VEC;
      const long long vv = base + row;
      const bool ok = vv < v1 && c < K;
      const T* src = ok ? x + vv * K + c : x;
      cp_async16(&Xs[stage][row][seg * VEC], src, ok);
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int v = tid + i * NTHREADS;
      const int row = v / SEGC, seg = v % SEGC;
      const int c = co0 + seg * VEC;
      const long long vv = base + row;
      const bool ok = vv < v1 && c < N;
      const T* src = ok ? ct + vv * N + c : ct;
      cp_async16(&Cs[stage][row][seg * VEC], src, ok);
    }
  };

  float db_acc = 0.f;
  const int lane = tid & 31, warp = tid >> 5;

  if constexpr (sizeof(T) == 2) {
    // ---- bf16: each warp a 16 (ci) x 32 (co) tile on the tensor cores
    constexpr int WARPS_N = DN / 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int g = lane >> 2, t4 = lane & 3;
    // ldmatrix source rows: lane l addresses row l % 8 of matrix l / 8
    const int lr = lane & 7, lb3 = (lane >> 3) & 1, lb4 = (lane >> 4) & 1;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

    load_chunk(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int st = kc & 1;
      if (kc + 1 < n_chunks) load_chunk(kc + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < DK; ks += 16) {
        uint32_t af[4], bf[2][4];
        // A[m][k] = Xs[k][m]: matrices (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8)
        ldmatrix_x4_trans(af, &Xs[st][ks + lr + lb4 * 8][wm * 16 + lb3 * 8]);
        // B[k][n] = Cs[k][n]: matrices (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          ldmatrix_x4_trans(bf[q], &Cs[st][ks + lr + lb3 * 8][wn * 32 + q * 16 + lb4 * 8]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma_bf16(acc[2 * q], af, &bf[q][0]);
          mma_bf16(acc[2 * q + 1], af, &bf[q][2]);
        }
      }
      if (do_db && tid < DN) {
#pragma unroll 8
        for (int k = 0; k < DK; ++k) db_acc += to_f32(Cs[st][k][tid]);
      }
      __syncthreads();
    }

    // C fragment: rows g and g + 8, columns t4 * 2 and t4 * 2 + 1
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = ci0 + wm * 16 + g + (r >> 1) * 8;
        const int n = co0 + wn * 32 + j * 8 + t4 * 2 + (r & 1);
        if (m < K && n < N) atomicAdd(&dw[(long long)m * N + n], acc[j][r]);
      }
  } else {
    // ---- f32: FMAs, each thread a 4 (ci) x 4 (co) register tile
    constexpr int TNT = DN / 4;
    const int tn = tid % TNT, tm = tid / TNT;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    load_chunk(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int st = kc & 1;
      if (kc + 1 < n_chunks) load_chunk(kc + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < DK; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&Xs[st][k][tm * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Cs[st][k][tn * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (do_db && tid < DN) {
#pragma unroll 8
        for (int k = 0; k < DK; ++k) db_acc += to_f32(Cs[st][k][tid]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = ci0 + tm * 4 + i, n = co0 + tn * 4 + j;
        if (m < K && n < N) atomicAdd(&dw[(long long)m * N + n], acc[i][j]);
      }
  }

  if (do_db && tid < DN && co0 + tid < N) atomicAdd(&db[co0 + tid], db_acc);
}

// Blocks aimed at per launch: several for each of the card's 132 SMs, few
// enough that a run stays long against its atomics.
constexpr int TARGET_BLOCKS = 1056;
constexpr int MIN_CHUNKS_PER_RUN = 8;

template <typename T, int DM, int DN>
cudaError_t launch_dw(const void* x, const void* ct, float* dw, float* db, long long R, int K,
                      int N, cudaStream_t stream) {
  const long long chunks = (R + DK - 1) / DK;
  const int tiles = ((K + DM - 1) / DM) * ((N + DN - 1) / DN);
  long long splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  const long long most = chunks / MIN_CHUNKS_PER_RUN;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  const long long run = ((chunks + splits - 1) / splits) * DK;
  splits = (R + run - 1) / run;
  dim3 grid((unsigned)splits, (unsigned)tiles, 1);
  mm1x1_dw_kernel<T, DM, DN><<<grid, (DM / 16) * (DN / 32) * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ct), dw, db, R, K, N, run);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dw(const void* x, const void* ct, float* dw, float* db, long long R, int K,
                        int N, cudaStream_t st) {
  const bool wide_m = K >= 64, wide_n = N >= 64;
  if (wide_m && wide_n) return launch_dw<T, 64, 64>(x, ct, dw, db, R, K, N, st);
  if (wide_m) return launch_dw<T, 64, 32>(x, ct, dw, db, R, K, N, st);
  if (wide_n) return launch_dw<T, 32, 64>(x, ct, dw, db, R, K, N, st);
  return launch_dw<T, 32, 32>(x, ct, dw, db, R, K, N, st);
}

}  // namespace

// x (R, K), wt (N, K) (the weight transposed) in the same dtype (0 = f32,
// 1 = bf16), bias (N) f32 or null, res (R, N) or null, out (R, N). K and N
// are multiples of 8; every pointer is 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int mm1x1_fwd(int dtype, const void* x, const void* wt, const float* bias,
                         const void* res, void* out, long long R, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = N <= 32;
  if (R < 1 || K < 8 || N < 8 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    return (int)(narrow ? launch_fwd<__nv_bfloat16, 32>(x, wt, bias, res, out, R, K, N, st)
                        : launch_fwd<__nv_bfloat16, 64>(x, wt, bias, res, out, R, K, N, st));
  }
  if (dtype == 0) {
    return (int)(narrow ? launch_fwd<float, 32>(x, wt, bias, res, out, R, K, N, st)
                        : launch_fwd<float, 64>(x, wt, bias, res, out, R, K, N, st));
  }
  return (int)cudaErrorInvalidValue;
}

// x (R, K) and ct (R, N) in the same dtype (0 = f32, 1 = bf16); dw (K, N) f32
// and db (N) f32 (or null), both zero-filled by the caller. K and N are
// multiples of 8; every pointer is 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int mm1x1_dw(int dtype, const void* x, const void* ct, float* dw, float* db,
                        long long R, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || K < 8 || N < 8 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)dispatch_dw<__nv_bfloat16>(x, ct, dw, db, R, K, N, st);
  if (dtype == 0) return (int)dispatch_dw<float>(x, ct, dw, db, R, K, N, st);
  return (int)cudaErrorInvalidValue;
}
