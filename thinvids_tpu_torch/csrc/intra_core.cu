// Intra core of H.264 IDR frames on Hopper (sm_90a), batched over frames
// (or split-frame bands): prediction, 4x4 forward transform, luma and
// chroma DC Hadamards, quantisation, dequantisation, inverse transform and
// the clamped reconstruction, for every macroblock, with mode decision off.
//
// The reference runs this computation as plain XLA: jaxcore._intra_core
// (thinvids_tpu/codecs/h264/jaxcore.py), a lax.scan along MB row 0 and a
// lax.scan over the later rows. The plain PyTorch version the kernels are
// held to, bit for bit, is torchcore.intra_core_batch_ref.
//
// Schedule (mode decision off, the encoder's fixed raster): MB (0, 0) is
// predicted DC-128; every later MB of row 0 horizontally from the right
// column of its left neighbour's recon; every MB of rows >= 1 vertically
// from the bottom recon row of the MB above. So row 0 is one chain along
// the row, and each MB column below it an independent chain down the rows:
//   - intra_row0_kernel: one block (one warp) per item walks row 0's mbw
//     MBs in order, the left column carried in shared memory;
//   - intra_cols_kernel: grid (mbw, B), one warp per MB column walks rows
//     1 .. mbh - 1, the bottom recon row carried in shared memory. It reads
//     row 0's recon that the first launch wrote (same stream, in order).
// The dependent chain is mbw + mbh - 1 MB steps a frame.
//
// One MB step is one warp: lanes 0..15 own the 16 luma 4x4 blocks (raster
// index by * 4 + bx), lanes 16..19 the four U blocks, 20..23 the four V
// blocks, 24..31 compute alongside and store nothing. Each lane keeps its
// block in registers; the DC Hadamards gather the DCs by warp shuffles
// that every lane executes.
//
// What bounds it on an H100: per frame it reads the three planes (1.5 B a
// pixel) and QP map and writes int32 levels and recon (1,536 + 1,536 B an
// MB), ~28 MB at 1088x1920; ~8.4 us of HBM time. It is bound by neither:
// the dependent chain of mbw + mbh - 1 MB steps is the floor of one
// frame's time, each step a few hundred dependent instructions and a
// round trip to L2. Batching items fills the card with independent
// chains; fewer or shorter steps are the later work.
//
// Integer semantics follow torch's int32: arithmetic right shifts floor
// (Python's // 2 and >> on negatives), no value leaves int32 at 8-bit
// input (|w| * mf + f < 2^31), left shifts go through unsigned.
//
// Tables (MF, V, zig-zag and its inverse, the z-scan position of each
// raster luma block, the chroma QP map) come from the wrapper
// (codecs/h264/torchintra.py, built from transform.py) once per device by
// intra_set_tables, into constant memory.
//
// C interface (loaded with ctypes): intra_tables_len returns the int32
// count intra_set_tables takes; intra_row0_launch and intra_cols_launch
// enqueue one kernel each over all B items on the given stream and return
// cudaGetLastError(). The QP map is a device pointer: no launch
// synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// table blob layout (torchintra._table_blob)
constexpr int kMfOff = 0;            // MF[6][16]
constexpr int kVOff = 96;            // V[6][16]
constexpr int kZzOff = 192;          // zig-zag: raster position of scan i
constexpr int kIzzOff = 208;         // scan index of raster position p
constexpr int kZscanInvOff = 224;    // z-scan slot of raster luma block k
constexpr int kQpcOff = 240;         // chroma QP of qp 0..51
constexpr int kTablesLen = 292;

__constant__ int c_tab[kTablesLen];

enum Pred { kDc128 = 0, kHoriz = 1, kVert = 2 };

// H4[i][a] of the 4x4 Hadamard, H2[i][a] of the 2x2 one
__device__ __forceinline__ int h4(int i, int a) {
  // rows [1,1,1,1], [1,1,-1,-1], [1,-1,-1,1], [1,-1,1,-1]
  const int bit = ((i == 1) & (a >= 2)) | ((i == 2) & ((a == 1) | (a == 2))) |
                  ((i == 3) & (a & 1));
  return bit ? -1 : 1;
}

__device__ __forceinline__ int h2(int i, int a) { return (i & a) ? -1 : 1; }

__device__ __forceinline__ int shl(int x, int s) {
  return static_cast<int>(static_cast<unsigned>(x) << s);
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// Frame-batched output pointers and shapes.
struct Args {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  const int* qp;        // (B, nmb)
  int mbh, mbw;
  int* luma_dc;         // (B, nmb, 16)
  int* luma_ac;         // (B, nmb, 16, 15)
  int* chroma_dc;       // (B, nmb, 2, 4)
  int* chroma_ac;       // (B, nmb, 2, 4, 15)
  int* ry;              // (B, 16 mbh, 16 mbw)
  int* ru;              // (B, 8 mbh, 8 mbw)
  int* rv;
};

// One MB of item `b` at (my, mx), predicted by `mode`; `edge` holds the
// carried neighbour samples: [0, 16) luma, [16, 24) U, [24, 32) V, the
// left neighbour's right column (kHoriz) or the above neighbour's bottom
// row (kVert). On return `edge` holds this MB's right column (row 0) or
// bottom row (columns), as `carry_right` says.
__device__ void encode_mb(const Args& a, int b, int my, int mx, Pred mode,
                          int* edge, bool carry_right) {
  const int lane = threadIdx.x & 31;
  const bool luma = lane < 16;
  const bool active = lane < 24;
  const int cl = lane - 16;                       // chroma lane 0..7
  const int plane = luma ? 0 : (cl < 4 ? 1 : 2);  // lanes >= 24: V, unused
  const int blk = luma ? lane : (cl & 3);
  const int by = luma ? blk >> 2 : blk >> 1;
  const int bx = luma ? blk & 3 : blk & 1;
  const int size = luma ? 16 : 8;
  const int W = size * a.mbw;
  const int H = size * a.mbh;
  const int eoff = plane == 0 ? 0 : (plane == 1 ? 16 : 24);
  const int nmb = a.mbh * a.mbw;
  const int mb = my * a.mbw + mx;

  const uint8_t* src = plane == 0 ? a.y : (plane == 1 ? a.u : a.v);
  int* rec = plane == 0 ? a.ry : (plane == 1 ? a.ru : a.rv);
  const long long base = static_cast<long long>(b) * H * W +
                         static_cast<long long>(my * size + 4 * by) * W +
                         mx * size + 4 * bx;

  const int qp = a.qp[static_cast<long long>(b) * nmb + mb];
  const int qpl = qp < 0 ? 0 : (qp > 51 ? 51 : qp);
  const int q = luma ? qp : c_tab[kQpcOff + qpl];
  const int q6 = q % 6;
  const int qd = q / 6;
  const int qbits = 15 + qd;
  const int fq = (1 << qbits) / 3;

  // prediction and residual
  int pred[4][4], x[4][4];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int p = 128;
      if (mode == kHoriz) p = edge[eoff + 4 * by + r];
      if (mode == kVert) p = edge[eoff + 4 * bx + c];
      pred[r][c] = p;
      const int s = active ? static_cast<int>(src[base + r * W + c]) : 0;
      x[r][c] = s - p;
    }
  }

  // forward core transform: rows (over r for each c), then columns
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

  // DC transform of this lane's DC position (by, bx) in the MB's DC matrix
  const int dc = w[0][0];
  const int gbase = lane & ~3;                    // chroma group's lane 0
  int had4 = 0, had2 = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int d = __shfl_sync(kFull, dc, k);
    had4 += h4(by & 3, k >> 2) * h4(bx & 3, k & 3) * d;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = __shfl_sync(kFull, dc, gbase + k);
    had2 += h2(by & 1, k >> 1) * h2(bx & 1, k & 1) * d;
  }
  // luma: Hadamard // 2 (floor); chroma: the 2x2 Hadamard as it is
  const int wdc = luma ? (had4 >> 1) : had2;
  const int mf00 = c_tab[kMfOff + q6 * 16];
  int zdc = (abs(wdc) * mf00 + 2 * fq) >> (qbits + 1);
  if (wdc < 0) zdc = -zdc;

  // dequantised DC from the quantised DC levels
  int f4 = 0, f2 = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int d = __shfl_sync(kFull, zdc, k);
    f4 += h4(by & 3, k >> 2) * h4(bx & 3, k & 3) * d;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = __shfl_sync(kFull, zdc, gbase + k);
    f2 += h2(by & 1, k >> 1) * h2(bx & 1, k & 1) * d;
  }
  const int ls = c_tab[kVOff + q6 * 16] * 16;
  int dcr;
  if (luma) {
    if (q >= 36) {
      dcr = shl(f4 * ls, qd - 6);
    } else {
      const int sh = 6 - qd;
      dcr = (f4 * ls + (1 << (sh - 1))) >> sh;
    }
  } else {
    dcr = shl(f2 * ls, qd) >> 5;
  }

  // AC quant (DC slot zeroed), dequant with the DC put back
  int z[16], d[4][4];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int r = p >> 2, c = p & 3;
    int zp = 0;
    if (p != 0) {
      const int wp = w[r][c];
      zp = (abs(wp) * c_tab[kMfOff + q6 * 16 + p] + fq) >> qbits;
      if (wp < 0) zp = -zp;
    }
    z[p] = zp;
    d[r][c] = p == 0 ? dcr : shl(zp * c_tab[kVOff + q6 * 16 + p], qd);
  }

  // inverse transform: each row first, then each column
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

  // every lane has read the carried edge: the MB's own edge replaces it
  __syncwarp();
  if (active) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) rec[base + r * W + c] = out[r][c];
    }
    const long long m = static_cast<long long>(b) * nmb + mb;
    if (luma) {
      a.luma_dc[m * 16 + c_tab[kIzzOff + blk]] = zdc;
      int* ac = a.luma_ac + (m * 16 + c_tab[kZscanInvOff + blk]) * 15;
#pragma unroll
      for (int i = 1; i < 16; ++i) ac[i - 1] = z[c_tab[kZzOff + i]];
    } else {
      const long long pb = (m * 2 + (plane - 1)) * 4 + blk;
      a.chroma_dc[pb] = zdc;
      int* ac = a.chroma_ac + pb * 15;
#pragma unroll
      for (int i = 1; i < 16; ++i) ac[i - 1] = z[c_tab[kZzOff + i]];
    }
    const int last = luma ? 3 : 1;
    if (carry_right && bx == last) {
#pragma unroll
      for (int r = 0; r < 4; ++r) edge[eoff + 4 * by + r] = out[r][3];
    }
    if (!carry_right && by == last) {
#pragma unroll
      for (int c = 0; c < 4; ++c) edge[eoff + 4 * bx + c] = out[3][c];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32) intra_row0_kernel(Args a) {
  __shared__ int edge[32];
  const int b = blockIdx.x;
  for (int mx = 0; mx < a.mbw; ++mx)
    encode_mb(a, b, 0, mx, mx == 0 ? kDc128 : kHoriz, edge, true);
}

__global__ void __launch_bounds__(32) intra_cols_kernel(Args a) {
  __shared__ int edge[32];
  const int mx = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  // the bottom recon row of MB (0, mx), written by intra_row0_kernel
  if (t < 16) {
    edge[t] = a.ry[static_cast<long long>(b) * 256 * a.mbh * a.mbw +
                   15LL * 16 * a.mbw + 16 * mx + t];
  } else {
    const int c = (t - 16) & 7;
    const int* r = t < 24 ? a.ru : a.rv;
    edge[t] = r[static_cast<long long>(b) * 64 * a.mbh * a.mbw +
                7LL * 8 * a.mbw + 8 * mx + c];
  }
  for (int my = 1; my < a.mbh; ++my)
    encode_mb(a, b, my, mx, kVert, edge, false);
}

Args make_args(const uint8_t* y, const uint8_t* u, const uint8_t* v,
               const int* qp, int mbh, int mbw, int* luma_dc, int* luma_ac,
               int* chroma_dc, int* chroma_ac, int* ry, int* ru, int* rv) {
  return Args{y, u, v, qp, mbh, mbw, luma_dc, luma_ac, chroma_dc,
              chroma_ac, ry, ru, rv};
}

}  // namespace

extern "C" {

int intra_tables_len() { return kTablesLen; }

// Copy the wrapper's table blob to the current device's constant memory.
int intra_set_tables(const int* blob, int n) {
  if (n != kTablesLen) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaMemcpyToSymbol(c_tab, blob, sizeof(int) * kTablesLen));
}

int intra_row0_launch(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                      const int* qp, int B, int mbh, int mbw, int* luma_dc,
                      int* luma_ac, int* chroma_dc, int* chroma_ac, int* ry,
                      int* ru, int* rv, void* stream) {
  const Args a = make_args(y, u, v, qp, mbh, mbw, luma_dc, luma_ac,
                           chroma_dc, chroma_ac, ry, ru, rv);
  intra_row0_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int intra_cols_launch(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                      const int* qp, int B, int mbh, int mbw, int* luma_dc,
                      int* luma_ac, int* chroma_dc, int* chroma_ac, int* ry,
                      int* ru, int* rv, void* stream) {
  const Args a = make_args(y, u, v, qp, mbh, mbw, luma_dc, luma_ac,
                           chroma_dc, chroma_ac, ry, ru, rv);
  intra_cols_kernel<<<dim3(mbw, B), 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
