// The P frame's residual core and the global-motion probe's window costs
// on Hopper (sm_90a).
//
// p_residual_kernel: for every macroblock of one P frame (or of a
// split-frame band stack handed over as one tall plane) the residual
// against the motion search's prediction, the forward 4x4 core transform,
// inter quantisation (rounding bias 1/6), the chroma DC Hadamard and its
// quantisation, the optional P_Skip drop and 4x4 nonzero map,
// dequantisation, the inverse transform and the clamped reconstruction.
// The reference runs this computation as plain XLA:
// jaxinter._residual_p (thinvids_tpu/codecs/h264/jaxinter.py). The plain
// PyTorch version the kernel is held to, bit for bit, is
// torchinter.residual_p_ref.
//
// probe_cost_kernel: the global-motion probe's cost of each of the 81
// candidate windows, sum over the cells of a (B, hc, wc) stack of
// quarter-res box sums of mask[b, r] * |cq - window|, where window (oy, ox)
// is rq_ext[b, r + oy, c + ox] of the edge-padded (or halo-extended)
// reference. The reference computes it as plain XLA: jaxme.coarse_probe
// and jaxme.banded_probe_cost (thinvids_tpu/codecs/h264/jaxme.py). The
// plain PyTorch version is torchme.probe_cost_ref.
//
// Residual layout: one warp per MB, four MBs a block. Lanes 0..15 own the
// 16 luma 4x4 blocks (raster index by * 4 + bx), lanes 16..19 the four U
// blocks, 20..23 the four V blocks, 24..31 compute alongside and store
// nothing. Each lane keeps its block in registers; the chroma DC Hadamard
// and its inverse gather the DCs by warp shuffles, the P_Skip level sum
// and maximum are shuffle reductions over the warp. P_Skip and the nonzero
// map are template flags: the RD-off step pays for neither.
//
// What bounds the residual on an H100: per frame it reads cur and pred as
// int16 and writes int16 levels and recon (8 B a sample, ~25 MB at
// 1088x1920, ~7.5 us of HBM time); its ~352 integer operations a 4x4
// block take ~4 us of the card's int32 rate. Bytes bound it. The design
// reads and writes each sample once, four int16 at a time.
//
// What bounds the probe: 81 windows x 3 operations (subtract, absolute
// value, add) a quarter-res cell, ~32 M operations at 1080p against
// ~1.3 MB of cells. Operations bound it. One block takes a 32 x 32 tile of
// cells and its 4-cell apron into shared memory, each thread keeps the 81
// partial sums of its four cells in registers, and the block adds them
// warp by warp into shared memory and then with one atomic add a window
// into the uint32 output: modular addition makes the result the exact
// int32 wrapping sum, whatever the order.
//
// Integer semantics follow torch's int32: arithmetic right shifts floor,
// left shifts go through unsigned, no value leaves int32 while cur and
// pred lie in [0, 255].
//
// Tables (MF and V by qp % 6 and raster position) come from the wrapper
// (codecs/h264/torchresid.py, built from transform.py) once per device by
// p_set_tables, into constant memory.
//
// C interface (loaded with ctypes): p_tables_len returns the int32 count
// p_set_tables takes; probe_qsr the probe's window radius in cells;
// p_residual_launch and probe_cost_launch enqueue on the given stream and
// return cudaGetLastError(). Nothing synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// table blob layout (torchresid._table_blob)
constexpr int kMfOff = 0;            // MF[6][16]
constexpr int kVOff = 96;            // V[6][16]
constexpr int kTablesLen = 192;

__constant__ int c_tab[kTablesLen];

constexpr int kMbsPerBlock = 4;

// the probe: window radius in cells, windows a side, tile of cells
constexpr int kQsr = 4;
constexpr int kWin = 2 * kQsr + 1;
constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;    // 32 x 8 threads over 32 x 32 cells

__device__ __forceinline__ int h2(int i, int a) { return (i & a) ? -1 : 1; }

__device__ __forceinline__ int shl(int x, int s) {
  return static_cast<int>(static_cast<unsigned>(x) << s);
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

struct ResArgs {
  const int16_t* cy;
  const int16_t* cu;
  const int16_t* cv;
  const int16_t* py;
  const int16_t* pu;
  const int16_t* pv;
  int mbh, mbw, qp, qpc, pskip_sum;
  int16_t* luma;        // (16 mbh, 16 mbw) levels
  int16_t* chroma_dc;   // (2, nmb, 4)
  int16_t* chroma_ac;   // (2, 8 mbh, 8 mbw) levels, DC positions 0
  int16_t* ry;          // (16 mbh, 16 mbw)
  int16_t* ru;          // (8 mbh, 8 mbw)
  int16_t* rv;
  uint8_t* nz4;         // (4 mbh, 4 mbw) bool, or null
};

template <bool kPskip, bool kNz4>
__global__ void __launch_bounds__(32 * kMbsPerBlock)
    p_residual_kernel(ResArgs a) {
  const int lane = threadIdx.x & 31;
  const int nmb = a.mbh * a.mbw;
  const int mb = blockIdx.x * kMbsPerBlock + (threadIdx.x >> 5);
  if (mb >= nmb) return;                      // the whole warp
  const int my = mb / a.mbw;
  const int mx = mb - my * a.mbw;
  const bool luma = lane < 16;
  const bool active = lane < 24;
  const int cl = lane - 16;                       // chroma lane 0..7
  const int plane = luma ? 0 : (cl < 4 ? 1 : 2);  // lanes >= 24: V, unused
  const int blk = luma ? lane : (cl & 3);
  const int by = luma ? blk >> 2 : blk >> 1;
  const int bx = luma ? blk & 3 : blk & 1;
  const int size = luma ? 16 : 8;
  const int W = size * a.mbw;
  const long long base = static_cast<long long>(my * size + 4 * by) * W +
                         mx * size + 4 * bx;
  const int16_t* cur = plane == 0 ? a.cy : (plane == 1 ? a.cu : a.cv);
  const int16_t* prd = plane == 0 ? a.py : (plane == 1 ? a.pu : a.pv);

  const int q = luma ? a.qp : a.qpc;
  const int q6 = q % 6;
  const int qd = q / 6;
  const int qbits = 15 + qd;
  const int fq = (1 << qbits) / 6;

  // residual, four int16 a row
  int pred[4][4], x[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    short4 c4 = make_short4(0, 0, 0, 0), p4 = make_short4(0, 0, 0, 0);
    if (active) {
      c4 = *reinterpret_cast<const short4*>(cur + base + r * W);
      p4 = *reinterpret_cast<const short4*>(prd + base + r * W);
    }
    pred[r][0] = p4.x; pred[r][1] = p4.y; pred[r][2] = p4.z;
    pred[r][3] = p4.w;
    x[r][0] = c4.x - p4.x; x[r][1] = c4.y - p4.y; x[r][2] = c4.z - p4.z;
    x[r][3] = c4.w - p4.w;
  }

  // forward core transform: along H (over r for each c), then along W
  int w[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int s0 = x[0][c] + x[3][c], s3 = x[0][c] - x[3][c];
    const int s1 = x[1][c] + x[2][c], s2 = x[1][c] - x[2][c];
    x[0][c] = s0 + s1;
    x[1][c] = 2 * s3 + s2;
    x[2][c] = s0 - s1;
    x[3][c] = s3 - 2 * s2;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s0 = x[r][0] + x[r][3], s3 = x[r][0] - x[r][3];
    const int s1 = x[r][1] + x[r][2], s2 = x[r][1] - x[r][2];
    w[r][0] = s0 + s1;
    w[r][1] = 2 * s3 + s2;
    w[r][2] = s0 - s1;
    w[r][3] = s3 - 2 * s2;
  }

  // chroma DC: the 2x2 Hadamard of the group's four DCs, this lane's
  // output (by, bx), quantised with twice the bias and one more bit
  const int gbase = lane & ~3;                    // chroma group's lane 0
  int had2 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = __shfl_sync(kFull, w[0][0], gbase + k);
    had2 += h2(by & 1, k >> 1) * h2(bx & 1, k & 1) * d;
  }
  int zdc = 0;
  if (!luma) {
    zdc = (abs(had2) * c_tab[kMfOff + q6 * 16] + 2 * fq) >> (qbits + 1);
    if (had2 < 0) zdc = -zdc;
  }

  // quantisation: every position of luma, the AC positions of chroma
  int z[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int wp = w[p >> 2][p & 3];
    int zp = (abs(wp) * c_tab[kMfOff + q6 * 16 + p] + fq) >> qbits;
    if (wp < 0) zp = -zp;
    z[p] = (p == 0 && !luma) ? 0 : zp;
  }

  if (kPskip) {
    // the MB's level mass and largest level over luma, both ACs and both
    // DCs; a negligible MB drops every level (recon = prediction)
    int s = 0, m = 0;
    if (active) {
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        s += abs(z[p]);
        m = max(m, abs(z[p]));
      }
      s += abs(zdc);
      m = max(m, abs(zdc));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(kFull, s, o);
      m = max(m, __shfl_xor_sync(kFull, m, o));
    }
    if (s <= a.pskip_sum && m <= 1) {
#pragma unroll
      for (int p = 0; p < 16; ++p) z[p] = 0;
      zdc = 0;
    }
  }

  // dequantised chroma DC: the inverse Hadamard of the group's levels
  int f2 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = __shfl_sync(kFull, zdc, gbase + k);
    f2 += h2(by & 1, k >> 1) * h2(bx & 1, k & 1) * d;
  }
  const int dcr = shl(f2 * (c_tab[kVOff + q6 * 16] * 16), qd) >> 5;

  // dequantisation
  int d[4][4];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int r = p >> 2, c = p & 3;
    d[r][c] = (p == 0 && !luma) ? dcr
                                : shl(z[p] * c_tab[kVOff + q6 * 16 + p], qd);
  }

  // inverse transform: along W first, then along H
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e0 = d[r][0] + d[r][2], e1 = d[r][0] - d[r][2];
    const int e2 = (d[r][1] >> 1) - d[r][3], e3 = d[r][1] + (d[r][3] >> 1);
    d[r][0] = e0 + e3;
    d[r][1] = e1 + e2;
    d[r][2] = e1 - e2;
    d[r][3] = e0 - e3;
  }
  int out[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int g0 = d[0][c] + d[2][c], g1 = d[0][c] - d[2][c];
    const int g2 = (d[1][c] >> 1) - d[3][c], g3 = d[1][c] + (d[3][c] >> 1);
    out[0][c] = clip255(pred[0][c] + ((g0 + g3 + 32) >> 6));
    out[1][c] = clip255(pred[1][c] + ((g1 + g2 + 32) >> 6));
    out[2][c] = clip255(pred[2][c] + ((g1 - g2 + 32) >> 6));
    out[3][c] = clip255(pred[3][c] + ((g0 - g3 + 32) >> 6));
  }

  if (!active) return;
  int16_t* lev = luma ? a.luma
                      : a.chroma_ac + static_cast<long long>(plane - 1) *
                                          (64LL * nmb);
  int16_t* rec = plane == 0 ? a.ry : (plane == 1 ? a.ru : a.rv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    *reinterpret_cast<short4*>(lev + base + r * W) = make_short4(
        static_cast<short>(z[4 * r]), static_cast<short>(z[4 * r + 1]),
        static_cast<short>(z[4 * r + 2]), static_cast<short>(z[4 * r + 3]));
    *reinterpret_cast<short4*>(rec + base + r * W) = make_short4(
        static_cast<short>(out[r][0]), static_cast<short>(out[r][1]),
        static_cast<short>(out[r][2]), static_cast<short>(out[r][3]));
  }
  if (luma) {
    if (kNz4) {
      bool nz = false;
#pragma unroll
      for (int p = 0; p < 16; ++p) nz |= z[p] != 0;
      a.nz4[static_cast<long long>(4 * my + by) * (4 * a.mbw) + 4 * mx + bx] =
          nz ? 1 : 0;
    }
  } else {
    a.chroma_dc[(static_cast<long long>(plane - 1) * nmb + mb) * 4 + blk] =
        static_cast<int16_t>(zdc);
  }
}

// grid (tiles across, tiles down, B); block (32, 8). Cell (r, c) of item b
// against window (oy, ox) reads rq[b, r + oy, c + ox] of the (hc + 2 qsr,
// wc + 2 qsr) extended plane.
__global__ void __launch_bounds__(kTile * kTile / kRowsPerThread)
    probe_cost_kernel(const int* cq, const int* rq, const uint8_t* mask,
                      int hc, int wc, unsigned* cost) {
  constexpr int kExt = kTile + 2 * kQsr;
  __shared__ int s_rq[kExt][kExt + 1];
  __shared__ unsigned s_cost[kWin * kWin];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int he = hc + 2 * kQsr;
  const int we = wc + 2 * kQsr;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int t = ty * kTile + tx;
  const int nthreads = kTile * kTile / kRowsPerThread;
  const int* rqb = rq + static_cast<long long>(b) * he * we;

  for (int i = t; i < kWin * kWin; i += nthreads) s_cost[i] = 0;
  for (int i = t; i < kExt * kExt; i += nthreads) {
    const int rr = i / kExt, cc = i - rr * kExt;
    const int gr = r0 + rr, gc = c0 + cc;
    s_rq[rr][cc] = (gr < he && gc < we)
                       ? rqb[static_cast<long long>(gr) * we + gc] : 0;
  }
  __syncthreads();

  unsigned acc[kWin * kWin];
#pragma unroll
  for (int k = 0; k < kWin * kWin; ++k) acc[k] = 0;
  const int c = c0 + tx;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int rr = ty + j * (kTile / kRowsPerThread);
    const int r = r0 + rr;
    if (r < hc && c < wc && mask[static_cast<long long>(b) * hc + r]) {
      const int v = cq[(static_cast<long long>(b) * hc + r) * wc + c];
#pragma unroll
      for (int oy = 0; oy < kWin; ++oy) {
#pragma unroll
        for (int ox = 0; ox < kWin; ++ox)
          acc[oy * kWin + ox] += static_cast<unsigned>(
              abs(v - s_rq[rr + oy][tx + ox]));
      }
    }
  }
  // warp sums into shared memory, then one atomic add a window
#pragma unroll
  for (int k = 0; k < kWin * kWin; ++k) {
    unsigned s = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (tx == 0) atomicAdd(&s_cost[k], s);
  }
  __syncthreads();
  for (int i = t; i < kWin * kWin; i += nthreads) atomicAdd(&cost[i], s_cost[i]);
}

}  // namespace

extern "C" {

int p_tables_len() { return kTablesLen; }

int probe_qsr() { return kQsr; }

// Copy the wrapper's table blob to the current device's constant memory.
int p_set_tables(const int* blob, int n) {
  if (n != kTablesLen) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaMemcpyToSymbol(c_tab, blob, sizeof(int) * kTablesLen));
}

int p_residual_launch(const int16_t* cy, const int16_t* cu, const int16_t* cv,
                      const int16_t* py, const int16_t* pu, const int16_t* pv,
                      int mbh, int mbw, int qp, int qpc, int pskip,
                      int pskip_sum, int16_t* luma, int16_t* chroma_dc,
                      int16_t* chroma_ac, int16_t* ry, int16_t* ru,
                      int16_t* rv, uint8_t* nz4, void* stream) {
  const ResArgs a{cy, cu, cv, py, pu, pv, mbh, mbw, qp, qpc, pskip_sum,
                  luma, chroma_dc, chroma_ac, ry, ru, rv, nz4};
  const int nmb = mbh * mbw;
  const dim3 grid((nmb + kMbsPerBlock - 1) / kMbsPerBlock);
  const dim3 block(32 * kMbsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pskip && nz4 != nullptr)
    p_residual_kernel<true, true><<<grid, block, 0, s>>>(a);
  else if (pskip)
    p_residual_kernel<true, false><<<grid, block, 0, s>>>(a);
  else if (nz4 != nullptr)
    p_residual_kernel<false, true><<<grid, block, 0, s>>>(a);
  else
    p_residual_kernel<false, false><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// cost: 81 uint32, zeroed here on the stream, then summed into.
int probe_cost_launch(const int* cq, const int* rq_ext, const uint8_t* mask,
                      int B, int hc, int wc, unsigned* cost, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      cudaMemsetAsync(cost, 0, sizeof(unsigned) * kWin * kWin, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((wc + kTile - 1) / kTile, (hc + kTile - 1) / kTile, B);
  const dim3 block(kTile, kTile / kRowsPerThread);
  probe_cost_kernel<<<grid, block, 0, s>>>(cq, rq_ext, mask, hc, wc, cost);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
