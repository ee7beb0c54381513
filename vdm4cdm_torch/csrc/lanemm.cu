// The 1x1 projection over voxel rows (the ResBlock's skip_proj), forward and
// weight gradient: y[r, :] = x[r, :] @ w + bias + residual, and
// dw = sum over r of x[r, :]^T ct[r, :], db = sum over r of ct[r, :].
//
// Replaces the Pallas TPU kernels vdm4cdm_tpu/ops/pallas/lanemm.py::_fwd_kernel
// (reached through _run_fwd, also as the dx pass on the transposed weight) and
// ::_dw_kernel (reached through _run_dw). The TPU kernels work on lane-packed
// rows with a block-diagonal weight; here rows are plain channels-last voxels,
// x is (R, K) with R = B * D * H * W, and the weight is the plain (K, N)
// matrix, so nothing of that packing has a counterpart.
//
// Bound on the H100: bytes. The widest site (K = N = 256, bf16) does
// 2 * 256 * 256 operations per 1,024 bytes of rows, 128 per byte, under the
// card's ~295; every other site is further below. So the kernels read each
// row of x (and the residual, and ct) once from device memory with 16-byte
// copies and fold what would otherwise be passes of their own into the
// epilogue: the bias, the residual (the first half's output of a split pair
// projection, or nothing) and the one rounding to the output dtype.
//
// Forward, bf16 with K, N <= 256 (every skip_proj site of the 3D presets but
// the 384-channel ones): persistent CTAs, two an SM where shared memory
// allows, each walking the row tiles blockIdx.x, blockIdx.x + gridDim.x, ...
//   - the whole weight, rounded to bf16, and the f32 bias sit in shared memory
//     for the CTA's life. The weight is read in either orientation, (K, N) or
//     (N, K) (w_trans), f32 or bf16, and converted on the way in, so neither
//     the forward nor the dx pass (the forward on the transposed weight) needs
//     a copy of it;
//   - a ring of 2-4 stages of row tiles of x, and of the residual when there
//     is one, fed by 16-byte cp.async: the loads of the next tiles stay in
//     flight while the current tile's product and epilogue run;
//   - each warp takes 16 rows and up to 64 output columns of a tile through
//     mma.sync m16n8k16 (f32 accumulators), both operands by ldmatrix from
//     XOR-swizzled rows, so that the 8 rows of every 8x8 matrix fall in 8
//     different bank groups;
//   - the epilogue adds bias and residual in f32, rounds once, stages the
//     tile in shared memory (swizzled alike) and writes it out as 16-byte
//     coalesced stores of whole output rows.
// The launch plan (rows a tile, padded widths, stages, CTAs an SM, grid,
// shared memory) is exported as mm1x1_fwd_plan and mirrored by
// ops/kernels/lanemm.py::fwd_plan.
//
// Forward, f32 (the parity path) and the widths past 256: a block owns 128
// rows and 32 or 64 output columns and walks K in chunks staged two deep;
// bf16 runs on mma.sync, f32 on plain FMAs so that its products stay in full
// f32. The weight tile is read in either orientation and dtype too.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // forward, wide or f32 path: rows per block
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

// Four 8x8 b16 matrices, as stored (row r of matrix i from lane 8 i + r).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
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
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Element (k, n) of the weight: w is (K, N) row-major, or with w_trans the
// (N, K) row-major matrix it is read as the transpose of; f32 or bf16.
__device__ __forceinline__ float weight_at(const void* w, int w_f32, int w_trans, int k, int n,
                                           int K, int N) {
  const long long o = w_trans ? (long long)n * K + k : (long long)k * N + n;
  return w_f32 ? static_cast<const float*>(w)[o]
               : __bfloat162float(static_cast<const __nv_bfloat16*>(w)[o]);
}

// ------------------------------------------------- launch plan (forward)

constexpr int SMEM_SM = 233472;   // shared memory of an SM (H100)
constexpr int SMEM_CTA = 232448;  // the most a CTA may use
constexpr int SMEM_RESERVED = 1024;  // the card's own share of each CTA

struct FwdPlan {
  int kind;         // 1 = persistent tensor-core kernel, 0 = blocks of BM rows
  int bm;           // rows a tile
  int kp, np;       // K and N padded (kind 1), or the K chunk and N tile (kind 0)
  int stages;       // ring depth
  int ctas_per_sm;  // kind 1: CTAs resident an SM the grid is sized for
  int grid;
  int threads;
  int smem;         // dynamic shared memory a CTA (kind 1), 0 for kind 0
};

int pad_width(int v) {
  int p = 32;
  while (p < v) p *= 2;
  return p;
}

// Kind 1: widths padded to 32, 64, 128 or 256; a warp takes 16 rows and
// np / wn columns (wn = 1 up to 64 columns, else np / 64), so a tile has
// 16 * 8 / wn rows. The most stages (2-4) that let two CTAs share an SM,
// else one CTA with the most that fit.
FwdPlan make_fwd_plan(int dtype, long long R, int K, int N, int has_res, int sms) {
  FwdPlan p{};
  p.threads = THREADS;
  if (dtype == 1 && K <= 256 && N <= 256) {
    p.kind = 1;
    p.kp = pad_width(K);
    p.np = pad_width(N);
    const int wn = p.np > 64 ? p.np / 64 : 1;
    p.bm = 16 * (8 / wn);
    const int stage = p.bm * p.kp * 2 + (has_res ? p.bm * p.np * 2 : 0);
    const int fixed = p.np * p.kp * 2 + p.np * 4 + p.bm * p.np * 2;
    int per_sm = 2, s = 4;
    while (s > 2 && per_sm * (fixed + s * stage + SMEM_RESERVED) > SMEM_SM) --s;
    if (per_sm * (fixed + s * stage + SMEM_RESERVED) > SMEM_SM) {
      per_sm = 1;
      s = 4;
      while (s > 2 && fixed + s * stage > SMEM_CTA) --s;
    }
    p.stages = s;
    p.ctas_per_sm = per_sm;
    p.smem = fixed + s * stage;
    const long long tiles = (R + p.bm - 1) / p.bm;
    const long long most = (long long)sms * per_sm;
    p.grid = (int)(tiles < most ? tiles : most);
    return p;
  }
  p.kind = 0;
  p.bm = BM;
  p.kp = dtype == 1 ? Tile<__nv_bfloat16>::BK : Tile<float>::BK;
  p.np = N <= 32 ? 32 : 64;
  p.stages = 2;
  const long long tiles = ((R + BM - 1) / BM) * ((N + p.np - 1) / p.np);
  p.grid = tiles > 0x7fffffffLL ? -1 : (int)tiles;
  return p;
}

// ------------------------------------------- forward, persistent (kind 1)

// The 16-byte segment seg of a row of L segments, XOR-swizzled so that the
// same segment of any 8 consecutive rows lies in 8 different 16-byte bank
// groups (L >= 4: every padded width is at least 32 elements).
template <int L>
__device__ __forceinline__ int swz(int row, int seg) {
  static_assert(L >= 4, "rows of at least four 16-byte segments");
  if constexpr (L >= 8) {
    return seg ^ (row & 7);
  } else {
    return seg ^ ((row >> 1) & 3);
  }
}

template <int KP, int NP>
__global__ void __launch_bounds__(THREADS, 2)
mm1x1_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w, int w_f32,
                    int w_trans, const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
                    long long R, int K, int N, int stages) {
  using bf16 = __nv_bfloat16;
  constexpr int WN = NP > 64 ? NP / 64 : 1, WM = 8 / WN, TM = 16 * WM;
  constexpr int WNC = NP / WN, NT = WNC / 8;
  constexpr int LK = KP / 8, LN = NP / 8;
  static_assert(NT % 2 == 0, "n8 tiles in pairs");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);                       // [NP][KP]
  float* bs = reinterpret_cast<float*>(smem + NP * KP * 2);       // [NP]
  bf16* Os = reinterpret_cast<bf16*>(smem + NP * KP * 2 + NP * 4);  // [TM][NP]
  unsigned char* ring = smem + NP * KP * 2 + NP * 4 + TM * NP * 2;
  const bool has_res = res != nullptr;
  const int stage_bytes = TM * KP * 2 + (has_res ? TM * NP * 2 : 0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long tiles = (R + TM - 1) / TM;
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long n_my = first < tiles ? (tiles - 1 - first) / stride + 1 : 0;
  const int segs_k = K / 8, segs_n = N / 8;

  // the row tile of the CTA's j-th item into stage s: x, and the residual
  auto load_tile = [&](long long j, int s) {
    const long long m0 = (first + j * stride) * TM;
    bf16* xs = reinterpret_cast<bf16*>(ring + s * stage_bytes);
#pragma unroll
    for (int v = tid; v < TM * LK; v += THREADS) {
      const int row = v / LK, seg = v % LK;
      const long long m = m0 + row;
      const bool ok = m < R && seg < segs_k;
      cp_async16(xs + row * KP + swz<LK>(row, seg) * 8, ok ? x + m * K + seg * 8 : x, ok);
    }
    if (has_res) {
      bf16* rs = reinterpret_cast<bf16*>(ring + s * stage_bytes + TM * KP * 2);
#pragma unroll
      for (int v = tid; v < TM * LN; v += THREADS) {
        const int row = v / LN, seg = v % LN;
        const long long m = m0 + row;
        const bool ok = m < R && seg < segs_n;
        cp_async16(rs + row * NP + swz<LN>(row, seg) * 8, ok ? res + m * N + seg * 8 : res, ok);
      }
    }
  };

  // the first tiles' loads go out before the weight is staged under them
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_my) load_tile(s, s);
    cp_async_commit();
  }
  // the weight, rounded to bf16, as Ws[n][k] (k contiguous, swizzled), zero
  // past K and N: groups of 4 elements, 4 consecutive k (w_trans) or n
  // (otherwise) a thread, 8 groups in flight
  {
    constexpr int GROUPS = NP * KP / 4, BATCH = 8;
    for (int g0 = 0; g0 < GROUPS; g0 += THREADS * BATCH) {
      float v[BATCH][4];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int gi = g0 + u * THREADS + tid;
        int n, k;
        if (w_trans) {
          n = gi / (KP / 4);
          k = gi % (KP / 4) * 4;
        } else {
          k = gi / (NP / 4);
          n = gi % (NP / 4) * 4;
        }
        const bool ok = gi < GROUPS && n < N && k < K;
        const long long o = w_trans ? (long long)n * K + k : (long long)k * N + n;
        if (ok && w_f32) {
          const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(w) + o);
          v[u][0] = f.x, v[u][1] = f.y, v[u][2] = f.z, v[u][3] = f.w;
        } else if (ok) {
          const uint2 h = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(w) + o);
          const __nv_bfloat162 h0 = *reinterpret_cast<const __nv_bfloat162*>(&h.x);
          const __nv_bfloat162 h1 = *reinterpret_cast<const __nv_bfloat162*>(&h.y);
          v[u][0] = __low2float(h0), v[u][1] = __high2float(h0);
          v[u][2] = __low2float(h1), v[u][3] = __high2float(h1);
        } else {
          v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int gi = g0 + u * THREADS + tid;
        if (gi >= GROUPS) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int n, k;
          if (w_trans) {
            n = gi / (KP / 4);
            k = gi % (KP / 4) * 4 + e;
          } else {
            k = gi / (NP / 4);
            n = gi % (NP / 4) * 4 + e;
          }
          Ws[n * KP + swz<LK>(n, k >> 3) * 8 + (k & 7)] = __float2bfloat16_rn(v[u][e]);
        }
      }
    }
    for (int n = tid; n < NP; n += THREADS) bs[n] = (bias != nullptr && n < N) ? bias[n] : 0.f;
  }

  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t4 = lane & 3;
  const int ksteps = (K + 15) >> 4;
  // ldmatrix rows: A matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) of the
  // warp's m16 tile; B matrices (k 0-7 | 8-15) x (n8 tile 2jj | 2jj + 1)
  const int a_row = wm * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), a_seg = lane >> 4;
  const int b_n = wn * WNC + (lane >> 4) * 8 + (lane & 7), b_seg = (lane >> 3) & 1;

  for (long long j = 0; j < n_my; ++j) {
    if (stages >= 4) {
      cp_async_wait<2>();
    } else if (stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the stage the previous tile left is free: refill it
    if (j + stages - 1 < n_my) load_tile(j + stages - 1, (int)((j + stages - 1) % stages));
    cp_async_commit();

    const int st = (int)(j % stages);
    const bf16* xs = reinterpret_cast<const bf16*>(ring + st * stage_bytes);
    float acc[NT][4];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[jn][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KP / 16; ++ks) {
      if (ks < ksteps) {
        uint32_t a[4];
        ldmatrix_x4(a, xs + a_row * KP + swz<LK>(a_row, 2 * ks + a_seg) * 8);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          const int n = b_n + jj * 16;
          uint32_t b[4];
          ldmatrix_x4(b, Ws + n * KP + swz<LK>(n, 2 * ks + b_seg) * 8);
          mma_bf16(acc[2 * jj], a, b);
          mma_bf16(acc[2 * jj + 1], a, b + 2);
        }
      }
    }

    // epilogue: C fragment rows g and g + 8, columns t4 * 2 and t4 * 2 + 1
    // of each n8 tile; bias and residual in f32, one rounding, into Os
    const bf16* rs = reinterpret_cast<const bf16*>(ring + st * stage_bytes + TM * KP * 2);
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const int col = wn * WNC + jn * 8 + t4 * 2;
      const float b0 = bs[col], b1 = bs[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 16 + g + h * 8;
        const int off = row * NP + swz<LN>(row, col >> 3) * 8 + (col & 7);
        float v0 = acc[jn][h * 2] + b0, v1 = acc[jn][h * 2 + 1] + b1;
        if (has_res) {
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(rs + off);
          v0 += __low2float(r2);
          v1 += __high2float(r2);
        }
        *reinterpret_cast<__nv_bfloat162*>(Os + off) = __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();
    // whole output rows, 16 bytes a thread, consecutive threads on
    // consecutive addresses
    const long long m0 = (first + j * stride) * TM;
#pragma unroll
    for (int v = tid; v < TM * LN; v += THREADS) {
      const int row = v / LN, seg = v % LN;
      const long long m = m0 + row;
      if (m < R && seg < segs_n) {
        *reinterpret_cast<uint4*>(out + m * N + seg * 8) =
            *reinterpret_cast<const uint4*>(Os + row * NP + swz<LN>(row, seg) * 8);
      }
    }
  }
}

template <int KP, int NP>
cudaError_t launch_tc(const FwdPlan& p, const void* x, const void* w, int w_f32, int w_trans,
                      const float* bias, const void* res, void* out, long long R, int K, int N,
                      cudaStream_t stream) {
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mm1x1_fwd_tc_kernel<KP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CTA);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  mm1x1_fwd_tc_kernel<KP, NP><<<p.grid, THREADS, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, w_f32, w_trans, bias,
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), R, K, N,
      p.stages);
  return cudaGetLastError();
}

template <int KP>
cudaError_t dispatch_tc(const FwdPlan& p, const void* x, const void* w, int w_f32, int w_trans,
                        const float* bias, const void* res, void* out, long long R, int K, int N,
                        cudaStream_t st) {
  switch (p.np) {
    case 32: return launch_tc<KP, 32>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N, st);
    case 64: return launch_tc<KP, 64>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N, st);
    case 128: return launch_tc<KP, 128>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N, st);
    case 256: return launch_tc<KP, 256>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------ forward, blocks of BM rows (kind 0)

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
mm1x1_fwd_kernel(const T* __restrict__ x, const void* __restrict__ w, int w_f32, int w_trans,
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
  // channel segment v % 4, for v = tid and tid + THREADS. The weight tile
  // is read element by element (either orientation, either dtype) into
  // registers with the A copies, and stored in x's dtype as Bs[n][k] once
  // the current chunk's products are done, so that its loads are in flight
  // under them.
  constexpr int WPT = BN * BK / THREADS;
  float wreg[WPT];
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
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      // neighbouring threads on neighbouring addresses: k fastest in an
      // (N, K) weight, n fastest in a (K, N) one
      const int v = tid + i * THREADS;
      const int n = w_trans ? v / BK : v % BN, k = w_trans ? v % BK : v / BN;
      const bool ok = (n0 + n) < N && (c0 + k) < K;
      wreg[i] = ok ? weight_at(w, w_f32, w_trans, c0 + k, n0 + n, K, N) : 0.f;
    }
  };
  auto store_w = [&](int stage) {
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int v = tid + i * THREADS;
      const int n = w_trans ? v / BK : v % BN, k = w_trans ? v % BK : v / BN;
      Bs[stage][n][k] = from_f32<T>(wreg[i]);
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
    store_w(0);
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
      // Bs[st ^ 1] was last read before the previous chunk's barrier
      if (kc + 1 < n_chunks) store_w(st ^ 1);
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
    store_w(0);
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
      if (kc + 1 < n_chunks) store_w(st ^ 1);
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
cudaError_t launch_fwd(const FwdPlan& p, const void* x, const void* w, int w_f32, int w_trans,
                       const float* bias, const void* res, void* out, long long R, int K, int N,
                       cudaStream_t stream) {
  if (p.grid < 1) return cudaErrorInvalidValue;
  mm1x1_fwd_kernel<T, BN><<<(unsigned)p.grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, w_f32, w_trans, bias, static_cast<const T*>(res),
      static_cast<T*>(out), R, K, N, (N + BN - 1) / BN);
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

// The forward's launch plan for x (R, K) -> (R, N) in dtype (0 = f32,
// 1 = bf16), with or without a residual, on a card of sms SMs (0: this
// card's), as 9 ints: kind, rows a tile, padded K (or K chunk), padded N (or
// N tile), stages, CTAs an SM, grid, threads, dynamic shared memory. The
// mirror is ops/kernels/lanemm.py::fwd_plan.
extern "C" int mm1x1_fwd_plan(int dtype, long long R, int K, int N, int has_res, int sms,
                              int* out) {
  if (sms <= 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const FwdPlan p = make_fwd_plan(dtype, R, K, N, has_res, sms);
  const int v[9] = {p.kind, p.bm, p.kp, p.np, p.stages, p.ctas_per_sm, p.grid, p.threads, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// x (R, K) in dtype (0 = f32, 1 = bf16); w the weight, (K, N) row-major, or
// with w_trans the (N, K) row-major matrix whose transpose it is, f32 or
// bf16 (w_f32), rounded to x's dtype by the kernel; bias (N) f32 or null;
// res (R, N) in x's dtype or null; out (R, N). K and N are multiples of 8;
// every pointer is 16-byte aligned. Returns cudaGetLastError() after the
// launch.
extern "C" int mm1x1_fwd(int dtype, const void* x, const void* w, int w_f32, int w_trans,
                         const float* bias, const void* res, void* out, long long R, int K,
                         int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || K < 8 || N < 8 || K % 8 || N % 8 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const FwdPlan p = make_fwd_plan(dtype, R, K, N, res != nullptr, sms);
  if (p.kind == 1) {
    switch (p.kp) {
      case 32: return (int)dispatch_tc<32>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N, st);
      case 64: return (int)dispatch_tc<64>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N, st);
      case 128: return (int)dispatch_tc<128>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N, st);
      case 256: return (int)dispatch_tc<256>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const bool narrow = p.np == 32;
  if (dtype == 1) {
    return (int)(narrow ? launch_fwd<__nv_bfloat16, 32>(p, x, w, w_f32, w_trans, bias, res, out,
                                                         R, K, N, st)
                        : launch_fwd<__nv_bfloat16, 64>(p, x, w, w_f32, w_trans, bias, res, out,
                                                         R, K, N, st));
  }
  return (int)(narrow ? launch_fwd<float, 32>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N, st)
                      : launch_fwd<float, 64>(p, x, w, w_f32, w_trans, bias, res, out, R, K, N,
                                              st));
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
