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
// The f32 path (conv3d_dw_f32_kernel), the weight gradient of the trained
// model's f32 train step: the same queue of items (16 ci x 32 or 16 co
// tiles), on the TF32 tensor cores with the 3xTF32 split of
// conv3d_brick.cuh (mma.sync from registers: both operands are MN-major);
// bound 3 x 2 x 27 Cin Cout operations a voxel at 495 TFLOP/s, against 67 on
// the FMA units. The kernel's comment says more.
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

constexpr int F_TCI = 16;                    // ci a tile: one m16 tile
constexpr int F_THREADS = 9 * 32;            // warp (kz, ky) holds the three kx taps
constexpr int F_XLD = F_TCI + 8;             // x row stride (floats): see below
constexpr int F_XS = brick::NH * F_XLD * 4;  // the haloed x brick, bytes

// co a tile: 32 where it divides Cout, else 16. Rows of TCO + 8 floats.
int f32_co_tile(int Cout) { return Cout % 32 == 0 ? 32 : 16; }
template <int TCO> struct DwF {
  static constexpr int NT = TCO / 8;  // n8 tiles
  static constexpr int CLD = TCO + 8;
  static constexpr int STAGE = F_XS + brick::M * CLD * 4;
  static constexpr int SMEM = 2 * STAGE;
  static_assert(SMEM <= 232448, "two stages fit a CTA's shared memory");
};

// The same queue of (tile, brick) items as the bf16 path, tiles of 16 ci x
// TCO co. Per item each of 9 warps takes the three kx taps of its (kz, ky)
// over the brick's 32 rows of 8 voxels (the k8 steps), mma.sync m16n8k8 in
// 3xTF32 with operands from registers. Both operands are MN-major here (the
// voxels are the contraction): each lane reads its fragment elements with
// 8-byte loads, which the fragment's index maps make contiguous: A row g
// (g + 8) is ci 2g (2g + 1), B column g of n8 tile 2p (2p + 1) is co 16p +
// 2g (+ 1), k slot t4 (t4 + 4) is voxel w = t4 (t4 + 4) of the brick row.
// Rows of F_XLD (TCO + 8) floats put the four k slots' rows 8 banks apart:
// no bank conflicts whatever a tap's shift. ct's split is taken once a k8
// step for the warp's three taps, x's once a tap (a staged hi / lo copy of x
// would not fit twice in shared memory). The tensor cores' f32 sums are
// flushed into running sums (rounded to nearest) after every brick (96
// accumulations).
template <int TCO>
__global__ void __launch_bounds__(F_THREADS, 1)
conv3d_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ ct,
                     float* __restrict__ dw, float* __restrict__ db, int D, int H, int W,
                     int Cin, int Cout, int circular, int zmode, int nbd, int nbh, int nbw,
                     int n_bricks, long long n_items) {
  using namespace brick;
  using L = DwF<TCO>;
  constexpr int NT = L::NT, CLD = L::CLD;
  constexpr int DBP = F_THREADS / TCO;  // ct rows summed for db a step
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_co = cdiv(Cout, TCO);
  const long long i0 = n_items * blockIdx.x / gridDim.x;
  const int n = (int)(n_items * (blockIdx.x + 1) / gridDim.x - i0);
  const int zoff = zmode == 1 ? 1 : 0;  // x's planes: D, or D + 2 in zmode 1
  const int Dx = D + 2 * zoff;
  const bool circ = circular != 0;
  const uint32_t sbase = smem_u32(smem);

  auto load = [&](long long item, int st) {
    const int tile = (int)(item / n_bricks), bi = (int)(item - (long long)tile * n_bricks);
    const int ci0 = tile / tiles_co * F_TCI, co0 = tile % tiles_co * TCO;
    const int bw_ = bi % nbw, bh_ = bi / nbw % nbh, bd_ = bi / (nbw * nbh) % nbd;
    const int bb = bi / (nbw * nbh * nbd);
    const int d0 = bd_ * BD, h0 = bh_ * BH, w0 = bw_ * BW;
    const uint32_t xs = sbase + st * L::STAGE, cs = xs + F_XS;
    const float* xb = x + (long long)bb * Dx * H * W * Cin;
    for (int e = tid; e < NH * 4; e += F_THREADS) {
      const int v = e >> 2, j = e & 3, c = ci0 + 4 * j;
      const int hd = v / (HH * HW), hh = v / HW % HH, hw = v % HW;
      const int sd = in_depth(d0 - 1 + hd + zoff, D, Dx, circ, zmode);
      const int sh = in_plane(h0 - 1 + hh, H, circ);
      const int sw = in_plane(w0 - 1 + hw, W, circ);
      const bool ok = sd >= 0 && sh >= 0 && sw >= 0 && c < Cin;
      cp_async16(xs + (v * F_XLD + 4 * j) * 4,
                 ok ? xb + (((long long)sd * H + sh) * W + sw) * Cin + c : x, ok);
    }
    const float* cb = ct + (long long)bb * D * H * W * Cout;
    for (int e = tid; e < M * (TCO / 4); e += F_THREADS) {
      const int m = e / (TCO / 4), j = e % (TCO / 4), c = co0 + 4 * j;
      const int d = d0 + m / (BH * BW), h = h0 + m / BW % BH, w = w0 + m % BW;
      const bool ok = d < D && h < H && w < W && c < Cout;
      cp_async16(cs + (m * CLD + 4 * j) * 4,
                 ok ? cb + (((long long)d * H + h) * W + w) * Cout + c : ct, ok);
    }
  };

  const int kz = warp / 3, ky = warp % 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int db_col = tid % TCO, db_row = tid / TCO;
  float db_acc = 0.f;
  float acc[3][NT][4], sum[3][NT][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][j][e] = sum[k][j][e] = 0.f;

  load(i0, 0);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    if (it + 1 < n) load(i0 + it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int tile = (int)((i0 + it) / n_bricks);
    const int ci0 = tile / tiles_co * F_TCI, co0 = tile % tiles_co * TCO;
    const int bi = (int)(i0 + it - (long long)tile * n_bricks);
    const int d_in = D - bi / (nbw * nbh) % nbd * BD, h_in = H - bi / nbw % nbh * BH;
    const float* xs = reinterpret_cast<const float*>(smem + st * L::STAGE);
    const float* cs = reinterpret_cast<const float*>(smem + st * L::STAGE + F_XS);
#pragma unroll 2
    for (int ks = 0; ks < M / 8; ++ks) {  // brick row (d, h) = (ks / 8, ks % 8)
      if (ks / 8 >= d_in || ks % 8 >= h_in) continue;  // past the grid: ct rows of zeros
      // B: ct of voxels t4 and t4 + 4 of the row, co pairs (2g, 2g + 1)
      uint32_t bfr[NT][4];
      const float* c0 = cs + (ks * 8 + t4) * CLD + 2 * g;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        const float2 u = *reinterpret_cast<const float2*>(c0 + 16 * p);
        const float2 v = *reinterpret_cast<const float2*>(c0 + 4 * CLD + 16 * p);
        split_tf32(u.x, bfr[2 * p][0], bfr[2 * p][2]);
        split_tf32(v.x, bfr[2 * p][1], bfr[2 * p][3]);
        split_tf32(u.y, bfr[2 * p + 1][0], bfr[2 * p + 1][2]);
        split_tf32(v.y, bfr[2 * p + 1][1], bfr[2 * p + 1][3]);
      }
      const float* x0 = xs + (halo_index(ks / 8 + kz, ks % 8 + ky, 0) + t4) * F_XLD + 2 * g;
      // A of tap kx: x of halo voxels t4 + kx and t4 + kx + 4, ci pairs
      // (2g, 2g + 1)
      uint32_t ah[3][4], al[3][4];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float2 u = *reinterpret_cast<const float2*>(x0 + kx * F_XLD);
        const float2 v = *reinterpret_cast<const float2*>(x0 + (kx + 4) * F_XLD);
        split_tf32(u.x, ah[kx][0], al[kx][0]);
        split_tf32(u.y, ah[kx][1], al[kx][1]);
        split_tf32(v.x, ah[kx][2], al[kx][2]);
        split_tf32(v.y, ah[kx][3], al[kx][3]);
      }
      // one pass a term (lo hi, hi lo, hi hi: the small ones first), so
      // that the 3 x NT MMAs in a row go to independent accumulators
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_tf32(acc[kx][j], t == 0 ? al[kx] : ah[kx], bfr[j][t == 1 ? 2 : 0],
                     bfr[j][t == 1 ? 3 : 1]);
    }
    if (db != nullptr && ci0 == 0) {
      for (int m = db_row; m < M; m += DBP) db_acc += cs[m * CLD + db_col];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[k][j][e] += acc[k][j][e];
          acc[k][j][e] = 0.f;
        }
    if (it == n - 1 || (i0 + it + 1) / n_bricks != tile) {
      // the tile's share of this run goes out. C fragment e: row g + 8 (e /
      // 2) (ci 2g + e / 2), column 2 t4 + e % 2 of n8 tile j (co 16 (j / 2)
      // + 4 t4 + 2 (e % 2) + j % 2)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int tap = (kz * 3 + ky) * 3 + k;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ci = ci0 + 2 * g + (e >> 1);
            const int co = co0 + 16 * (j >> 1) + 4 * t4 + 2 * (e & 1) + (j & 1);
            if (ci < Cin && co < Cout)
              atomicAdd(&dw[((long long)tap * Cin + ci) * Cout + co], sum[k][j][e]);
            sum[k][j][e] = 0.f;
          }
      }
      if (db != nullptr && ci0 == 0) {
        if (co0 + db_col < Cout) atomicAdd(&db[co0 + db_col], db_acc);
        db_acc = 0.f;
      }
    }
    __syncthreads();
  }
}

// The launch plan: {kind (1 = bricks), tile d, h, w, ci per CTA, co per
// CTA, splits (of the queue of (tile, brick) items into one run per CTA, as
// many as the card has SMs), grid x, grid y, threads, dynamic shared-memory
// bytes}.
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
    const int tco = f32_co_tile(Cout);
    const long long items = (long long)B * brick::cdiv(D, brick::BD) *
                            brick::cdiv(H, brick::BH) * brick::cdiv(W, brick::BW) *
                            brick::cdiv(Cin, F_TCI) * brick::cdiv(Cout, tco);
    const int ctas = items < sms ? (int)items : sms;
    const int v[PLAN_LEN] = {1, brick::BD, brick::BH, brick::BW, F_TCI, tco, ctas, ctas, 1,
                             F_THREADS, tco == 32 ? DwF<32>::SMEM : DwF<16>::SMEM};
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

template <int TCO>
int launch_f32(const int* p, const void* x, const void* ct, float* dw, float* db, int B, int D,
               int H, int W, int Cin, int Cout, int circular, int zmode, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3d_dw_f32_kernel<TCO>, cudaFuncAttributeMaxDynamicSharedMemorySize, DwF<TCO>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nbd = brick::cdiv(D, brick::BD), nbh = brick::cdiv(H, brick::BH),
            nbw = brick::cdiv(W, brick::BW);
  const int nb = B * nbd * nbh * nbw;
  conv3d_dw_f32_kernel<TCO><<<(unsigned)p[7], F_THREADS, DwF<TCO>::SMEM, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(ct), dw, db, D, H, W, Cin, Cout,
      circular, zmode, nbd, nbh, nbw, nb,
      (long long)nb * brick::cdiv(Cin, F_TCI) * brick::cdiv(Cout, TCO));
  return 0;
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
  } else {
    const int err = p[5] == 32
                        ? launch_f32<32>(p, x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st)
                        : launch_f32<16>(p, x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
