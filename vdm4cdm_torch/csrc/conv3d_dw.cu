// Weight and bias gradient of the SAME 3x3x3 stride-1 convolution,
// channels-last: dw[kz, ky, kx, ci, co] = sum over (b, d, h, w) of
// x[b, d + kz - 1, h + ky - 1, w + kx - 1, ci] * ct[b, d, h, w, co] with x
// read through circular or zero padding, and db[co] = sum of ct[..., co].
//
// Replaces the Pallas TPU kernel vdm4cdm_tpu/ops/pallas/conv3d.py::_dw_kernel
// (reached through _conv_pallas_dw): the same function of (x, ct), f32
// results, the bias gradient riding along.
//
// Bound on the H100: 2 * 27 * Cin * Cout operations per voxel over
// (Cin + Cout) * 2 bytes, above the card's ~295 operations per byte from 32
// channels up, so the tensor cores bound it (about 0.47 ms for (4, 128^3,
// 32 -> 32) bf16).
//
// Design of the bf16 path (conv3d_dw_bf16_kernel). It is 27 GEMMs with
// M = Cin, N = Cout and the voxels as the contraction. The earlier version
// gave each tap its own blocks, which re-read x and ct from L2 once per tap
// (27 x (Cin + Cout) x 2 bytes a voxel). Now the work is a queue of items
// (32 x 32 tile of (ci, co), output brick of 4 x 8 x 8 voxels, see
// conv3d_brick.cuh), tile-major, cut into one run per SM of equal length
// (so one wave of CTAs, whatever the tile count); a CTA holds one tile's
// sums for all 27 taps over its run, and for each item:
//   - stages the brick's ct (256 voxels x 32 co) and its haloed x (6 x 10 x
//     10 voxels x 32 ci) once, with cp.async, two stages deep, x gathered
//     with the forward's wrap / zero / halo-plane index math and the brick's
//     out-of-range voxels zero-filled in ct (so they add nothing);
//   - accumulates all 27 taps from that one staging with wgmma m64n32k16
//     on two warpgroups: each holds 7 pairs of taps (taps 14 g .. 14 g +
//     13), a pair's m64 operand being the two taps' x^T (32 ci each), which
//     its four warps load by ldmatrix.trans at the taps' shifted row
//     addresses into registers (the shifted gather rules out a descriptor
//     for it); B is the ct brick itself, read by the tensor cores from
//     shared memory (64-byte swizzled, co contiguous: an MN-major operand);
//     the last pair's second tap is a row of ones, whose product with ct
//     is db; 7 x 16 f32 accumulators a thread. (An mma.sync version on 18
//     warps ran 13-17% slower at every site, measured on the H100.)
//   - every 4 bricks adds the registers into running sums in shared memory
//     and restarts them: the tensor cores' f32 accumulation rounds toward
//     zero, and over a run of ~250,000 voxels that bias reached 3e-4 of
//     max |dw| (measured on the H100 at (4, 128^3, 64 -> 64)).
// Each input byte crosses L2 about 1.7 times per tile instead of 27. One
// CTA an SM (219 KB of shared memory); where its run reaches a tile's end,
// a CTA adds that tile's 27 x 32 x 32 sums (and db, on the first ci tile)
// to the zeroed outputs with atomicAdd, so the order of those additions
// changes from run to run and two runs agree to f32 rounding of a sum over
// K terms, not bitwise.
//
// The f32 path (conv3d_dw_f32_kernel) serves the parity checks only: the
// earlier design on plain FMAs (a block per (tap, tile, run of voxels), a
// 4 x 4 register tile per thread) so that its products stay in full f32.
//
// zmode 1 (halo) is the weight gradient of the sharded path's valid-in-z conv
// (replaces _dw_kernel under zmode="halo", reached through
// _conv_pallas_dw(..., zmode="halo") from conv3d_pallas_zhalo's backward): x
// has D + 2 planes, the slab and its two exchanged halo planes, ct has D, and
// tap kz of output plane d reads x plane d + kz, never wrapped or
// zero-filled. H and W are gathered as in zmode 0. The sums are the slab's
// own; the train step averages every gradient over the ranks.
//
// The launch plan (tile, split, grid, threads, shared memory) is exported as
// conv3d_k3s1_dw_plan and mirrored by ops/kernels/conv3d.py::dw_plan.

#include "conv3d_brick.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16 path

constexpr int TC = 32;                  // ci and co per tile
constexpr int THREADS = 256;            // two warpgroups
constexpr int PAIRS = 7;                // tap pairs a warpgroup holds
constexpr int ACC = PAIRS * 16;         // f32 accumulators a thread
constexpr int XS = brick::NH * TC * 2;  // haloed x brick, bytes
constexpr int CS = brick::M * TC * 2;   // ct brick
constexpr int STAGE = XS + CS;
constexpr int STAGES = 2;
constexpr int FLUSH = 4;  // bricks between flushes of the accumulators
constexpr int ACC_OFF = STAGES * STAGE;
constexpr int SMEM = ACC_OFF + THREADS * ACC * 4;  // 224,256 bytes: one CTA an SM
static_assert(XS % 512 == 0 && STAGE % 512 == 0, "the ct bricks sit on 64-byte swizzle atoms");

// D (64 x 32) += A (64 x 16, registers) B (16 x 32, MN-major in shared memory)
__device__ __forceinline__ void wgmma_m64n32k16_tb(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
conv3d_dw_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ct,
                      float* __restrict__ dw, float* __restrict__ db, int D, int H, int W,
                      int Cin, int Cout, int circular, int zmode, int nbd, int nbh, int nbw,
                      int n_bricks, long long n_items) {
  using namespace brick;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_co = cdiv(Cout, TC);
  // this CTA's run of the queue of items (tile, brick), item = tile *
  // n_bricks + brick: every CTA gets the same count, give or take one
  const long long i0 = n_items * blockIdx.x / gridDim.x;
  const int n = (int)(n_items * (blockIdx.x + 1) / gridDim.x - i0);
  const int zoff = zmode == 1 ? 1 : 0;  // x's planes: D, or D + 2 in zmode 1
  const int Dx = D + 2 * zoff;
  const bool circ = circular != 0;
  const uint32_t sbase = smem_u32(smem);
  // each thread's running sums, element k at s_acc[k * THREADS + tid]
  float* s_acc = reinterpret_cast<float*>(smem + ACC_OFF);
  for (int k = 0; k < ACC; ++k) s_acc[k * THREADS + tid] = 0.f;

  auto load = [&](long long item, int st) {
    const int tile = (int)(item / n_bricks), bi = (int)(item - (long long)tile * n_bricks);
    const int ci0 = tile / tiles_co * TC, co0 = tile % tiles_co * TC;
    const int bw_ = bi % nbw, bh_ = bi / nbw % nbh, bd_ = bi / (nbw * nbh) % nbd;
    const int bb = bi / (nbw * nbh * nbd);
    const int d0 = bd_ * BD, h0 = bh_ * BH, w0 = bw_ * BW;
    const uint32_t xs = sbase + st * STAGE, cs = xs + XS;
    const bf16* xb = x + (long long)bb * Dx * H * W * Cin;
    for (int e = tid; e < NH * 4; e += THREADS) {
      const int v = e >> 2, j = e & 3, c = ci0 + 8 * j;
      const int hd = v / (HH * HW), hh = v / HW % HH, hw = v % HW;
      const int sd = in_depth(d0 - 1 + hd + zoff, D, Dx, circ, zmode);
      const int sh = in_plane(h0 - 1 + hh, H, circ);
      const int sw = in_plane(w0 - 1 + hw, W, circ);
      const bool ok = sd >= 0 && sh >= 0 && sw >= 0 && c < Cin;
      cp_async16(xs + swz<4>(v, j), ok ? xb + (((long long)sd * H + sh) * W + sw) * Cin + c : x,
                 ok);
    }
    const bf16* cb = ct + (long long)bb * D * H * W * Cout;
    for (int e = tid; e < M * 4; e += THREADS) {
      const int m = e >> 2, j = e & 3, c = co0 + 8 * j;
      const int d = d0 + m / (BH * BW), h = h0 + m / BW % BH, w = w0 + m % BW;
      const bool ok = d < D && h < H && w < W && c < Cout;
      cp_async16(cs + swz<4>(m, j), ok ? cb + (((long long)d * H + h) * W + w) * Cout + c : ct,
                 ok);
    }
  };

  // warp w: group w / 4; rows 16 (w % 4) .. + 15 of each pair's m64 tile,
  // i.e. ci half w % 2 of the pair's tap w % 4 / 2
  const int grp = warp >> 2, half = (warp >> 1) & 1, cih = warp & 1;
  const int q = lane >> 3, r = lane & 7, g = lane >> 2, t4 = lane & 3;
  int hoff[PAIRS];  // each pair's tap as a halo offset, -1 for the ones row
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int tap = 14 * grp + 2 * p + half;
    hoff[p] = tap < 27 ? halo_index(tap / 9, tap / 3 % 3, tap % 3) : -1;
  }
  const uint32_t ones = 0x3F803F80u;  // two bf16 1.0

  float acc[PAIRS][16];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[p][e] = 0.f;

  load(i0, 0);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    if (it + 1 < n) load(i0 + it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int tile = (int)((i0 + it) / n_bricks);
    const int ci0 = tile / tiles_co * TC, co0 = tile % tiles_co * TC;
    const uint32_t xs = sbase + st * STAGE, cs = xs + XS;
    // k-step ks: the brick's 16 voxels of rows (ks / 4, 2 (ks % 4)) and the
    // next; its A fragments load while the last k-step's wgmma run
    uint32_t afr[2][PAIRS][4];
#pragma unroll 4
    for (int ks = 0; ks < M / 16; ++ks) {
      const int k = ks & 1;
      const int hv = halo_index(ks >> 2, (ks & 3) * 2 + (q >> 1), r);
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        if (hoff[p] >= 0) {
          ldsm_x4_trans(afr[k][p], xs + swz<4>(hv + hoff[p], 2 * cih + (q & 1)));
        } else {
          afr[k][p][0] = afr[k][p][1] = afr[k][p][2] = afr[k][p][3] = ones;
        }
      }
      wgmma_fence();
      // B: the k-step's 16 ct rows, two 8-row atoms of 512 bytes
      const uint64_t desc = smem_desc(cs + ks * 16 * TC * 2, 512, 512, 2);
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) wgmma_m64n32k16_tb(acc[p], afr[k][p], desc);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    // The tensor cores round their f32 sums toward zero, a bias that grows
    // with the number of accumulations: every FLUSH bricks, and where the
    // tile ends, the registers go into the thread's running sums (rounded
    // to nearest) and restart.
    const bool last = it == n - 1 || (i0 + it + 1) / n_bricks != tile;
    if (it % FLUSH == FLUSH - 1 || last) {
#pragma unroll
      for (int p = 0; p < PAIRS; ++p)
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          s_acc[(p * 16 + e) * THREADS + tid] += acc[p][e];
          acc[p][e] = 0.f;
        }
    }
    if (last) {
      // the tile's share of this run goes out. D fragment e = 4 j + f: row
      // 16 (w % 4) + g + 8 (f / 2), column 8 j + 2 t4 + f % 2
      const bool do_db = db != nullptr && ci0 == 0;
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const int tap = 14 * grp + 2 * p + half;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          float* a = &s_acc[(p * 16 + e) * THREADS + tid];
          const int ci = ci0 + 16 * cih + g + ((e >> 1) & 1) * 8;
          const int co = co0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
          if (tap < 27) {
            if (ci < Cin && co < Cout) atomicAdd(&dw[((long long)tap * Cin + ci) * Cout + co], *a);
          } else if (do_db && cih == 0 && g == 0 && ((e >> 1) & 1) == 0 && co < Cout) {
            atomicAdd(&db[co], *a);  // every row of the ones tile is db
          }
          *a = 0.f;
        }
      }
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int F_BK = 32;  // voxels per chunk

template <int BM, int BN>
__global__ void __launch_bounds__((BM / 4) * (BN / 4))
conv3d_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ ct,
                     float* __restrict__ dw, float* __restrict__ db, int B, int D, int H, int W,
                     int Cin, int Cout, int circular, int zmode, long long run) {
  constexpr int THR = (BM / 4) * (BN / 4);
  constexpr int VEC = 4;
  constexpr int SEGX = BM / VEC, SEGC = BN / VEC;
  constexpr int NX = F_BK * SEGX / THR, NC = F_BK * SEGC / THR;
  constexpr int LDX = BM + VEC, LDC = BN + VEC;
  static_assert(NX >= 1 && NC >= 1 && F_BK * SEGX % THR == 0 && F_BK * SEGC % THR == 0,
                "whole vectors per thread");
  __shared__ __align__(16) float Xs[2][F_BK][LDX];
  __shared__ __align__(16) float Cs[2][F_BK][LDC];

  const int tid = threadIdx.x;
  const long long S = (long long)D * H * W;
  const long long total = S * B;
  const int tiles_m = (Cin + BM - 1) / BM, tiles_n = (Cout + BN - 1) / BN;
  const int tile = blockIdx.y;
  const int tap = tile / (tiles_m * tiles_n);
  const int rem = tile - tap * tiles_m * tiles_n;
  const int ci0 = (rem / tiles_n) * BM, co0 = (rem % tiles_n) * BN;
  const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
  const long long v0 = (long long)blockIdx.x * run;
  const long long v1 = (v0 + run < total) ? v0 + run : total;
  if (v0 >= v1) return;
  const int n_chunks = (int)((v1 - v0 + F_BK - 1) / F_BK);
  const bool do_db = db != nullptr && tap == 0 && ci0 == 0;
  const int zoff = zmode == 1 ? 1 : 0;
  const int Dx = D + 2 * zoff;

  // Each thread gathers the same NX rows of every x tile; it keeps those
  // voxels' (b, d, h, w) and steps them by F_BK from chunk to chunk.
  long long xv[NX];
  int xb[NX], xd[NX], xh[NX], xw[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const int row = (tid + i * THR) / SEGX;
    xv[i] = v0 + row;
    const long long m = xv[i] % S;
    xb[i] = (int)(xv[i] / S);
    xw[i] = (int)(m % W);
    xh[i] = (int)((m / W) % H);
    xd[i] = (int)(m / ((long long)W * H));
  }

  // Chunks are loaded in order, so the x voxels advance inside the loader.
  auto load_chunk = [&](int kc, int stage) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int v = tid + i * THR;
      const int row = v / SEGX, seg = v % SEGX;
      const int c = ci0 + seg * VEC;
      const int sd = brick::in_depth(xd[i] + kz - 1 + zoff, D, Dx, circular, zmode);
      const int sh = brick::in_plane(xh[i] + ky - 1, H, circular);
      const int sw = brick::in_plane(xw[i] + kx - 1, W, circular);
      const bool ok = xv[i] < v1 && c < Cin && sd >= 0 && sh >= 0 && sw >= 0;
      const float* src =
          ok ? x + ((((long long)xb[i] * Dx + sd) * H + sh) * W + sw) * Cin + c : x;
      brick::cp_async16(brick::smem_u32(&Xs[stage][row][seg * VEC]), src, ok);
      xv[i] += F_BK;
      xw[i] += F_BK;
      while (xw[i] >= W) {
        xw[i] -= W;
        if (++xh[i] == H) {
          xh[i] = 0;
          if (++xd[i] == D) {
            xd[i] = 0;
            ++xb[i];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int v = tid + i * THR;
      const int row = v / SEGC, seg = v % SEGC;
      const int c = co0 + seg * VEC;
      const long long vv = v0 + (long long)kc * F_BK + row;
      const bool ok = vv < v1 && c < Cout;
      const float* src = ok ? ct + vv * Cout + c : ct;
      brick::cp_async16(brick::smem_u32(&Cs[stage][row][seg * VEC]), src, ok);
    }
  };

  float db_acc = 0.f;
  constexpr int TNT = BN / 4;
  const int tn = tid % TNT, tm = tid / TNT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_chunk(0, 0);
  brick::cp_async_commit();
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < n_chunks) load_chunk(kc + 1, st ^ 1);
    brick::cp_async_commit();
    brick::cp_async_wait<1>();
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < F_BK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&Xs[st][k][tm * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Cs[st][k][tn * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (do_db && tid < BN) {
#pragma unroll 8
      for (int k = 0; k < F_BK; ++k) db_acc += Cs[st][k][tid];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = ci0 + tm * 4 + i, n = co0 + tn * 4 + j;
      if (m < Cin && n < Cout) atomicAdd(&dw[((long long)tap * Cin + m) * Cout + n], acc[i][j]);
    }

  if (do_db && tid < BN && co0 + tid < Cout) atomicAdd(&db[co0 + tid], db_acc);
}

// f32: blocks aimed at per launch, enough to fill the card's SMs several
// times over, few enough that a run stays long against its atomics.
constexpr int F_TARGET_BLOCKS = 2048;
constexpr int F_MIN_CHUNKS_PER_RUN = 8;

// The launch plan: {kind (1 = bricks, 0 = runs of voxels), tile d, h, w
// (kind 0: 0, 0, voxels a run), ci per CTA, co per CTA, splits (kind 1: of
// the queue of (tile, brick) items into one run per CTA, as many as the card
// has SMs; kind 0: of the voxels per tile), grid x, grid y, threads, dynamic
// shared-memory bytes}.
constexpr int PLAN_LEN = 11;

void make_plan(int dtype, int B, int D, int H, int W, int Cin, int Cout, int sms, int* p) {
  if (dtype == 1) {
    const long long items = (long long)B * brick::cdiv(D, brick::BD) *
                            brick::cdiv(H, brick::BH) * brick::cdiv(W, brick::BW) *
                            brick::cdiv(Cin, TC) * brick::cdiv(Cout, TC);
    const int ctas = items < sms ? (int)items : sms;
    const int v[PLAN_LEN] = {1, brick::BD, brick::BH, brick::BW, TC, TC, ctas, ctas, 1,
                             THREADS, SMEM};
    for (int i = 0; i < PLAN_LEN; ++i) p[i] = v[i];
  } else {
    const int bm = Cin >= 64 ? 64 : 32, bn = Cout >= 64 ? 64 : 32;
    const long long total = (long long)B * D * H * W;
    const long long chunks = (total + F_BK - 1) / F_BK;
    const int tiles = 27 * ((Cin + bm - 1) / bm) * ((Cout + bn - 1) / bn);
    long long splits = (F_TARGET_BLOCKS + tiles - 1) / tiles;
    const long long most = chunks / F_MIN_CHUNKS_PER_RUN;
    if (splits > most) splits = most;
    if (splits < 1) splits = 1;
    const long long run = ((chunks + splits - 1) / splits) * F_BK;
    splits = (total + run - 1) / run;
    const int v[PLAN_LEN] = {0, 0, 0, (int)run, bm, bn, (int)splits, (int)splits, tiles,
                             (bm / 4) * (bn / 4), 0};
    for (int i = 0; i < PLAN_LEN; ++i) p[i] = v[i];
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <int BM, int BN>
void launch_f32(const int* p, const void* x, const void* ct, float* dw, float* db, int B, int D,
                int H, int W, int Cin, int Cout, int circular, int zmode, cudaStream_t st) {
  conv3d_dw_f32_kernel<BM, BN><<<dim3((unsigned)p[7], (unsigned)p[8]), p[9], 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(ct), dw, db, B, D, H, W, Cin, Cout,
      circular, zmode, (long long)p[3]);
}

}  // namespace

// The launch plan of conv3d_k3s1_dw at these sizes on the current device
// (see make_plan; sms = 0 asks the device for its SM count), for the check
// against ops/kernels/conv3d.py::dw_plan. Returns 0.
extern "C" int conv3d_k3s1_dw_plan(int dtype, int B, int D, int H, int W, int Cin, int Cout,
                                   int sms, int* plan) {
  make_plan(dtype, B, D, H, W, Cin, Cout, sms > 0 ? sms : sm_count(), plan);
  return 0;
}

// x (B, Dx, H, W, Cin) with Dx = D (zmode 0) or D + 2 (zmode 1) and ct
// (B, D, H, W, Cout) in the same dtype (0 = f32, 1 = bf16); dw (27, Cin,
// Cout) f32 and db (Cout) f32 (or null), both zero-filled by the caller. Cin
// and Cout are multiples of 8; every pointer is 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int conv3d_k3s1_dw(int dtype, const void* x, const void* ct, float* dw, float* db,
                              int B, int D, int H, int W, int Cin, int Cout, int circular,
                              int zmode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zmode < 0 || zmode > 1) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  static const int sms = sm_count();
  int p[PLAN_LEN];
  make_plan(dtype, B, D, H, W, Cin, Cout, sms, p);
  if (dtype == 1) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3d_dw_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    const int nb = B * brick::cdiv(D, brick::BD) * brick::cdiv(H, brick::BH) *
                   brick::cdiv(W, brick::BW);
    conv3d_dw_bf16_kernel<<<(unsigned)p[7], THREADS, SMEM, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ct), dw, db, D, H, W, Cin, Cout,
        circular, zmode, brick::cdiv(D, brick::BD), brick::cdiv(H, brick::BH),
        brick::cdiv(W, brick::BW), nb,
        (long long)nb * brick::cdiv(Cin, TC) * brick::cdiv(Cout, TC));
  } else if (p[4] == 64 && p[5] == 64) {
    launch_f32<64, 64>(p, x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
  } else if (p[4] == 64) {
    launch_f32<64, 32>(p, x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
  } else if (p[5] == 64) {
    launch_f32<32, 64>(p, x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
  } else {
    launch_f32<32, 32>(p, x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
  }
  return (int)cudaGetLastError();
}
