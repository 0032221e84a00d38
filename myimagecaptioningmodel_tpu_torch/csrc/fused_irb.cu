// Eval-mode MobileNetV2 inverted-residual block with batch norm folded into
// its convolutions (kernel G):
//   e   = relu6(x @ we + be)           1x1 expand, float accumulation; 0 outside
//                                      the image (the depthwise's zero padding)
//   d   = round(relu6(dw3x3(e) + bd))  depthwise at stride 1 or 2, float
//   out = round(d @ wp + bp [+ x])     1x1 project, float; the residual in float
// with e kept in float, or rounded to the activation dtype (round_e: the chain
// kernel's rounding, and the encoder's fused path's).
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/fused_irb.py:187
// fused_inverted_residual and :355 fused_irb_chain. The TPU kernel takes one
// (image, row tile) per grid step with the expanded tensor [rows + 2, W + 2,
// Cexp] in VMEM (up to ~10 MB). An SM has 227 KB of shared memory, so here a
// block takes a tile of output pixels and walks Cexp in chunks; the expanded
// tensor never reaches device memory: a block reads its input window (with a
// 1-row and 1-column halo) once, each weight chunk once, and writes its
// output once.
//
// What bounds it on an H100: at 224 px the blocks do 60-1,700 operations per
// byte they must move (input, output and weights once), so at the bf16
// tensor-core peak a block is bound by bytes at B=8 and by operations only in
// the 6x-expanded middle of the network.
//
// bfloat16 (irb_tc): both products on tensor cores (mma.sync m16n8k16, bf16
// in, float32 accumulators), 16 warps a block: an H100 trace of 8-warp
// blocks (chip_probe.py) found every phase below waiting on latency, and 16
// took the 17 blocks' sum at B=128 from 2.97 to 2.34 ms. A block takes ni
// whole images (7x7: two, so that the products' pixel side is 98 rows, where
// the project's registers allow) or th full-width output rows of one image
// (14x14: the whole image), chosen as the most pixels whose buffers fit
// 200 KB of shared memory and whose project accumulators fit the warps'
// registers:
//
//   1. tables of the block's pixels, once: each window pixel's input offset
//      (-1 outside the image) and each output pixel's first tap, so that no
//      later phase divides; then the input window (the tile's rows and
//      columns plus the 3x3 halo, zero outside the image) in bf16 with
//      cp.async; at 112 px a tile is up to 6 output rows (8 window rows),
//      so the halo rows expanded twice are a quarter of conv2_1's, not half;
//   2. per chunk of ce = 32 (or 16) expanded channels, whose weights (we
//      [Cin, ce] and wp [ce, Cout], each row 16 bytes wider than its data so
//      that ldmatrix reads 8 rows on distinct banks; B fragments by
//      ldmatrix.trans; be, bd, wd) were copied with cp.async into one of two
//      buffers while the previous chunk computed:
//      expand: [window pixels, Cin] x [Cin, ce] on tensor cores, a warp
//        taking two (16-pixel m-tile, n-tile pair) units at a time; bias,
//        ReLU6, 0 outside the image, rounded to bf16 when round_e, into e
//        [window pixels, ce] (float32 without round_e);
//      depthwise: 9 taps a pixel on CUDA cores, a thread per (pixel, 4
//        channels) with the taps' weights in registers, float; bias, ReLU6,
//        rounded to bf16 into d [pixels, ce];
//      project: [pixels, ce] x [ce, Cout] on tensor cores into float32
//        accumulators held in registers across all of the block's chunks:
//        warp (wm, wn) of a wgm x wgn grid takes PM m-tiles x PN n-tiles
//        (Narrow, Cout <= 32: 3 x 2; Wide: 2 x 6);
//   3. the epilogue adds bp and the residual (from the staged window) in
//      float, rounds once, and stores through shared memory with 16-byte
//      stores. When the tiles would leave over half the SMs idle, Cexp is
//      split over up to a wave of blocks: each split stores its float
//      partial and irb_reduce adds them in a fixed order, then finishes as
//      the epilogue does.
//
// float32 (irb_fma, the FMA path kept exact): a block takes one (image, tile
// of th x tw output pixels, up to 256) and walks Cexp in chunks of 32
// channels, one channel per lane: the window staged as float, the window
// rows it needs expanded into a ring of 3 rows, the depthwise outputs of
// each row into ds [pixels][32], then ds @ wp[chunk] added into a float
// accumulator [pixels][Cout] in shared memory. The window's and the
// accumulator's channel rows are padded with zeros to a multiple of 4 (the
// float4 reads), so any Cin, Cexp and Cout take this path (MobileNetV2 x0.35
// has 5, 11, 22, 33, ...). The bf16 path takes them too: where a channel
// count is not a multiple of 8 (4 for the float rows) its 16-byte copies of
// that operand become element copies with the same zero fill, Cout's
// n-tiles cover it rounded up to 8, and the epilogue stores element by
// element.
//
// The chain layout differs only in the input row offset and strides, and
// irb_chain_border writes its zero border rows, W tail and channel-pad
// lanes. Cexp need not be a multiple of the chunk: the last chunk's missing
// channels are zero-filled (weights and biases 0 give e = d = 0).
#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace capk {

constexpr int kIrbThreads = 256;
constexpr int kIrbCE = 32;       // float32: expanded channels per chunk, one per lane
constexpr int kIrbMaxPix = 256;  // float32: output pixels of a tile
constexpr int kIrbNT = 64;       // float32: project columns per pass, 16 threads x 4
constexpr int kIrbDLd = kIrbCE + 1;
constexpr int kIrbPJ = 4;  // float32: expand positions per warp pass

// capk_fused_irb's ints, in order (fused_irb.py's _ARG_FIELDS)
enum IrbArg : int {
  kIDtype, kIBatch, kIHeight, kIWidth, kICin, kICexp, kICout, kIStride, kIShortcut, kIRoundE,
  kIXRow0, kIXRowStride, kIXColStride, kIOutRow0, kIOutRowStride, kIOutColStride,
  kIChainRows, kIChainCols, kIChainChans, kINumIrbArgs
};

struct IrbPlan {
  int ho, wo, splits, cps, blocks;  // blocks: the grid's x (tiles), y = splits
  size_t smem;
  // float32: (image, row tile, column tile) of th x tw output pixels
  int th, tw, row_tiles, col_tiles;
  // bf16: ni images x th rows (full width) a block; windows of wr x wc pixels
  // an image; shared-memory row strides (elements) and byte offsets
  int ni, groups, wr, wc, nw16, p, p16, ce, cin16, cout16, wgm, wgn, wide;
  int ldx, lde, ldd, ldo, ldwe, ldwp;
  // sections: x window, e (then o), d, the window pixels' input offsets, the
  // output pixels' window offsets, two weight buffers of wsz bytes (we, then
  // wp, be, bd, wd at the r* offsets)
  int ox, oe, od, oxo, opw, ow, wsz, rwp, rbe, rbd, rwd;
};

struct IrbParams {
  const void* x;
  const void* we;
  const float *be, *wd, *bd;
  const void* wp;
  const float* bp;
  void* out;
  float* part;
  int B, H, W, cin, cexp, cout, stride, shortcut, round_e;
  long x_row0, x_row_stride, x_col_stride, x_batch;
  long out_row0, out_row_stride, out_col_stride, out_batch;
};

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.f), 6.f); }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Shared-memory floats of a float32 (th x tw) tile, section by section; ci
// and co: Cin and Cout rounded up to a multiple of 4, the rows' padded widths.
struct IrbSmem {
  int ci, co, xs, es, ds, acc, we, wp, be, bd, wd, total;
  __host__ __device__ IrbSmem(int th, int tw, int s, int cin, int cout) {
    const int wrows = (th - 1) * s + 3, wcols = (tw - 1) * s + 3, P = th * tw;
    ci = ceil_div(cin, 4) * 4;
    co = ceil_div(cout, 4) * 4;
    int o = 0;
    xs = o;  o += wrows * wcols * ci;
    es = o;  o += 3 * wcols * kIrbCE;
    ds = o;  o += ceil_div(P, 16) * 16 * kIrbDLd;
    o = ceil_div(o, 4) * 4;
    acc = o; o += P * co;
    we = o;  o += ci * kIrbCE;
    wp = o;  o += kIrbCE * ceil_div(cout, kIrbNT) * kIrbNT;
    be = o;  o += kIrbCE;
    bd = o;  o += kIrbCE;
    wd = o;  o += 9 * kIrbCE;
    total = o;
  }
};

// float32: FMA products, float arithmetic throughout.
template <typename T>
__global__ void __launch_bounds__(kIrbThreads) irb_fma(IrbParams p, IrbPlan pl) {
  extern __shared__ __align__(16) float sm[];
  const IrbSmem lay(pl.th, pl.tw, p.stride, p.cin, p.cout);
  float *xs = sm + lay.xs, *es = sm + lay.es, *ds = sm + lay.ds, *acc = sm + lay.acc;
  float *we_s = sm + lay.we, *wp_s = sm + lay.wp, *be_s = sm + lay.be, *bd_s = sm + lay.bd;
  float* wd_s = sm + lay.wd;
  const int s = p.stride, cin = p.cin, cout = p.cout, cexp = p.cexp, ci = lay.ci, co = lay.co;
  const int wld = ceil_div(cout, kIrbNT) * kIrbNT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32, nwarps = kIrbThreads / 32;

  int bid = blockIdx.x;
  const int ct = bid % pl.col_tiles;
  bid /= pl.col_tiles;
  const int rt = bid % pl.row_tiles, b = bid / pl.row_tiles;
  const int r0 = rt * pl.th, q0 = ct * pl.tw;
  const int th = min(pl.th, pl.ho - r0), tw = min(pl.tw, pl.wo - q0), P = th * tw;
  const int xr = (th - 1) * s + 3, xc = (tw - 1) * s + 3;  // the tile's input window
  const int ir0 = r0 * s - 1, ic0 = q0 * s - 1;           // its origin in the image
  const T* x = static_cast<const T*>(p.x) + (long)b * p.x_batch;
  const T* we = static_cast<const T*>(p.we);
  const T* wp = static_cast<const T*>(p.wp);

  // 1. the input window, as float; zeros outside the image and past Cin
  for (int i = tid; i < xr * xc * ci; i += kIrbThreads) {
    const int k = i % ci, rest = i / ci, wc = rest % xc, wr = rest / xc;
    const int ir = ir0 + wr, ic = ic0 + wc;
    xs[i] = (k < cin && ir >= 0 && ir < p.H && ic >= 0 && ic < p.W)
                ? ld(x, (ir + p.x_row0) * p.x_row_stride + ic * p.x_col_stride + k)
                : 0.f;
  }
  for (int i = tid; i < P * co; i += kIrbThreads) acc[i] = 0.f;

  const int nchunks = ceil_div(cexp, kIrbCE), split = blockIdx.y;
  const int ch_end = min(nchunks, (split + 1) * pl.cps);
  for (int ch = split * pl.cps; ch < ch_end; ++ch) {
    const int c0 = ch * kIrbCE;
    const bool live = c0 + lane < cexp;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < ci * kIrbCE; i += kIrbThreads) {
      const int c = c0 + i % kIrbCE, k = i / kIrbCE;
      we_s[i] = c < cexp && k < cin ? ld(we, (long)k * cexp + c) : 0.f;
    }
    for (int i = tid; i < kIrbCE * wld; i += kIrbThreads) {
      const int c = c0 + i / wld, n = i % wld;
      wp_s[i] = c < cexp && n < cout ? ld(wp, (long)c * cout + n) : 0.f;
    }
    if (tid < kIrbCE) {
      be_s[tid] = live ? p.be[c0 + tid] : 0.f;
      bd_s[tid] = live ? p.bd[c0 + tid] : 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) wd_s[t * kIrbCE + tid] = live ? p.wd[t * cexp + c0 + tid] : 0.f;
    }
    __syncthreads();

    // 2. expand + depthwise, one output row at a time
    for (int i = 0; i < th; ++i) {
      for (int dy = i == 0 ? 0 : 3 - s; dy < 3; ++dy) {  // window rows not yet expanded
        const int wr = i * s + dy, ir = ir0 + wr;
        const bool row_in = ir >= 0 && ir < p.H;
        const float* xrow = xs + (long)wr * xc * ci;
        float* e = es + (wr % 3) * xc * kIrbCE;
        for (int w0 = warp * kIrbPJ; w0 < xc; w0 += nwarps * kIrbPJ) {
          float a[kIrbPJ] = {};
          if (row_in) {
            for (int k = 0; k < ci; k += 4) {
              const float w_0 = we_s[(k + 0) * kIrbCE + lane], w_1 = we_s[(k + 1) * kIrbCE + lane];
              const float w_2 = we_s[(k + 2) * kIrbCE + lane], w_3 = we_s[(k + 3) * kIrbCE + lane];
#pragma unroll
              for (int j = 0; j < kIrbPJ; ++j) {
                const int wc = min(w0 + j, xc - 1);
                const float4 v = *reinterpret_cast<const float4*>(xrow + wc * ci + k);
                a[j] = fmaf(v.x, w_0, a[j]);
                a[j] = fmaf(v.y, w_1, a[j]);
                a[j] = fmaf(v.z, w_2, a[j]);
                a[j] = fmaf(v.w, w_3, a[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kIrbPJ; ++j) {
            const int wc = w0 + j, ic = ic0 + wc;
            if (wc >= xc) continue;
            float v = row_in && ic >= 0 && ic < p.W ? relu6f(a[j] + be_s[lane]) : 0.f;
            if (p.round_e) v = round_as(v, we);
            e[wc * kIrbCE + lane] = v;
          }
        }
      }
      __syncthreads();
      for (int j = warp; j < tw; j += nwarps) {
        float a = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* e = es + ((i * s + dy) % 3) * xc * kIrbCE + j * s * kIrbCE + lane;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) a = fmaf(e[dx * kIrbCE], wd_s[(dy * 3 + dx) * kIrbCE + lane], a);
        }
        ds[(i * tw + j) * kIrbDLd + lane] = round_as(relu6f(a + bd_s[lane]), we);
      }
      __syncthreads();  // the next row's expand overwrites the ring
    }

    // acc[P][co] += ds[P][32] @ wp_s[32][co]
    const int tn = tid % 16, tp = tid / 16;
    for (int n0 = 0; n0 < co; n0 += kIrbNT) {
      const int n = n0 + 4 * tn;
      if (n >= co) continue;
      float a[16][4] = {};
      for (int c = 0; c < kIrbCE; ++c) {
        const float4 w = *reinterpret_cast<const float4*>(wp_s + c * wld + n);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int pix = tp + 16 * jj;
          const float d = pix < P ? ds[pix * kIrbDLd + c] : 0.f;
          a[jj][0] = fmaf(d, w.x, a[jj][0]);
          a[jj][1] = fmaf(d, w.y, a[jj][1]);
          a[jj][2] = fmaf(d, w.z, a[jj][2]);
          a[jj][3] = fmaf(d, w.w, a[jj][3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int pix = tp + 16 * jj;
        if (pix >= P) continue;
        float4* o = reinterpret_cast<float4*>(acc + pix * co + n);
        float4 v = *o;
        v.x += a[jj][0];
        v.y += a[jj][1];
        v.z += a[jj][2];
        v.w += a[jj][3];
        *o = v;
      }
    }
  }
  __syncthreads();

  // 3. the epilogue, or this slice's float partial
  T* out = static_cast<T*>(p.out) + (long)b * p.out_batch;
  for (int i = tid; i < P * cout; i += kIrbThreads) {
    const int pix = i / cout, n = i % cout, r = r0 + pix / tw, q = q0 + pix % tw;
    float v = acc[pix * co + n];
    if (p.part != nullptr) {
      p.part[((((long)split * p.B + b) * pl.ho + r) * pl.wo + q) * cout + n] = v;
      continue;
    }
    v += p.bp[n];
    if (p.shortcut) v += ld(x, (r + p.x_row0) * p.x_row_stride + q * p.x_col_stride + n);
    store_as(out + (r + p.out_row0) * p.out_row_stride + q * p.out_col_stride + n, v);
  }
}


// ---- bfloat16: tensor-core products ----

namespace irbtc {

// 16 warps a block: every phase of a chunk has twice the warps of an 8-warp
// block, within the same shared memory (one block an SM either way)
constexpr int kThreads = 512, kWarps = kThreads / 32;

// The project's accumulators a warp: PM m-tiles x PN n-tiles.
template <int PM_, int PN_>
struct Cfg {
  static constexpr int PM = PM_, PN = PN_;
  static_assert(PN % 2 == 0, "n-tiles load in pairs");
};
using Narrow = Cfg<3, 2>;  // Cout <= 32
using Wide = Cfg<2, 6>;    // Cout <= 768

typedef __nv_bfloat16 bf16;

// Window pixel w of the tile -> (image, row, column) in the window.
struct WinPix {
  int im, wr, wc;
  __device__ __forceinline__ WinPix(int w, const IrbPlan& pl) {
    im = w / (pl.wr * pl.wc);
    const int rest = w - im * pl.wr * pl.wc;
    wr = rest / pl.wc;
    wc = rest - wr * pl.wc;
  }
};

template <class C>
__global__ void __launch_bounds__(kThreads) irb_tc(IrbParams p, IrbPlan pl) {
  constexpr int PM = C::PM, PN = C::PN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + pl.ox);
  unsigned char* es = smem + pl.oe;  // e: bf16 (round_e) or float; after the last chunk, o
  bf16* ds = reinterpret_cast<bf16*>(smem + pl.od);
  int* xo_s = reinterpret_cast<int*>(smem + pl.oxo);  // window pixel -> input offset, -1 outside
  int* pw_s = reinterpret_cast<int*>(smem + pl.opw);  // output pixel -> its first tap's window pixel
  const int s = p.stride, cin = p.cin, cout = p.cout, cexp = p.cexp, ce = pl.ce;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32, g = lane >> 2, c4 = lane & 3;

  const int rt = blockIdx.x % pl.row_tiles, grp = blockIdx.x / pl.row_tiles;
  const int b0 = grp * pl.ni, r0 = rt * pl.th;
  const int ni = min(pl.ni, p.B - b0), th = min(pl.th, pl.ho - r0);
  const int per_img = pl.th * pl.wo;
  const bf16* x = static_cast<const bf16*>(p.x) + (long)b0 * p.x_batch;
  const bf16* we = static_cast<const bf16*>(p.we);
  const bf16* wp = static_cast<const bf16*>(p.wp);

  // chunk ch's weights into buffer buf: we [Cin16][ce], wp [ce][Cout16], be,
  // bd [ce], wd [9][ce], with cp.async, zero past Cin, Cexp and Cout
  auto weights = [&](int buf) { return smem + pl.ow + buf * pl.wsz; };
  auto stage_weights = [&](int ch, int buf) {
    unsigned char* wb = weights(buf);
    bf16* we_s = reinterpret_cast<bf16*>(wb);
    bf16* wp_s = reinterpret_cast<bf16*>(wb + pl.rwp);
    const int c0 = ch * ce;
    const int sh = ce == 32 ? 2 : 1;  // log2 of the 16-byte vectors a we row: ce / 8
    for (int i = tid; i < pl.cin16 << sh; i += kThreads) {
      const int k = i >> sh, cc = (i & ((1 << sh) - 1)) * 8;
      if (cexp % 8 == 0) {
        const bool in = k < cin && c0 + cc < cexp;
        cp_async16(we_s + k * pl.ldwe + cc, in ? we + (long)k * cexp + c0 + cc : we, in ? 16 : 0);
      } else {
        for (int e = 0; e < 8; ++e)
          we_s[k * pl.ldwe + cc + e] = k < cin && c0 + cc + e < cexp
                                           ? we[(long)k * cexp + c0 + cc + e]
                                           : __float2bfloat16(0.f);
      }
    }
    for (int cc = warp; cc < ce; cc += kWarps) {  // a warp a wp row
      for (int n = lane * 8; n < pl.cout16; n += 256) {
        if (cout % 8 == 0) {
          const bool in = c0 + cc < cexp && n < cout;
          cp_async16(wp_s + cc * pl.ldwp + n, in ? wp + (long)(c0 + cc) * cout + n : wp,
                     in ? 16 : 0);
        } else {
          for (int e = 0; e < 8; ++e)
            wp_s[cc * pl.ldwp + n + e] = c0 + cc < cexp && n + e < cout
                                             ? wp[(long)(c0 + cc) * cout + n + e]
                                             : __float2bfloat16(0.f);
        }
      }
    }
    // be, bd and the 9 rows of wd: 11 rows of ce floats, 4 a copy
    for (int i = tid; i < 11 << (sh + 1); i += kThreads) {
      const int r = i >> (sh + 1), cc = (i & ((2 << sh) - 1)) * 4;
      const float* src = r == 0 ? p.be : r == 1 ? p.bd : p.wd + (long)(r - 2) * cexp;
      float* dst = reinterpret_cast<float*>(wb + (r == 0 ? pl.rbe : r == 1 ? pl.rbd : pl.rwd)) +
                   (r >= 2 ? (r - 2) * ce : 0);
      if (cexp % 4 == 0) {
        const bool in = c0 + cc < cexp;
        cp_async16(dst + cc, in ? src + c0 + cc : p.be, in ? 16 : 0);
      } else {
        for (int e = 0; e < 4; ++e) dst[cc + e] = c0 + cc + e < cexp ? src[c0 + cc + e] : 0.f;
      }
    }
    cp_async_commit();
  };

  // the block's pixel tables, once: window pixel (im, wr, wc) is input
  // (b0 + im, r0 s - 1 + wr, wc - 1); output pixel px = (im, i, j) reads the
  // window from (im, i s, j s)
  for (int w = tid; w < pl.nw16; w += kThreads) {
    int off = -1;
    if (w < pl.wr * pl.wc * pl.ni) {
      const WinPix wpx(w, pl);
      const int ir = r0 * s - 1 + wpx.wr, ic = wpx.wc - 1;
      if (wpx.im < ni && ir >= 0 && ir < p.H && ic >= 0 && ic < p.W)
        off = (int)(wpx.im * p.x_batch + (ir + p.x_row0) * p.x_row_stride + ic * p.x_col_stride);
    }
    xo_s[w] = off;
  }
  for (int px = tid; px < pl.p; px += kThreads) {
    const int im = px / per_img, rest = px - im * per_img, i = rest / pl.wo, j = rest - i * pl.wo;
    pw_s[px] = (im * pl.wr + i * s) * pl.wc + j * s;
  }
  const int nchunks = ceil_div(cexp, ce), split = blockIdx.y;
  const int ch0 = split * pl.cps, ch_end = min(nchunks, ch0 + pl.cps);
  stage_weights(ch0, 0);
  __syncthreads();  // the tables

  // 1. the input window, bf16, zeros outside the image and past Cin
  {
    const int cpr = pl.cin16 / 8;
    const bool vec = cin % 8 == 0 && p.x_col_stride % 8 == 0 && p.x_row_stride % 8 == 0;
    for (int i = tid; i < pl.nw16 * cpr; i += kThreads) {
      const int w = i / cpr, k = (i - w * cpr) * 8, off = xo_s[w];
      if (vec) {
        const bool in = off >= 0 && k < cin;
        cp_async16(xs + w * pl.ldx + k, in ? x + off + k : x, in ? 16 : 0);
      } else {
        for (int e = 0; e < 8; ++e)
          xs[w * pl.ldx + k + e] = off >= 0 && k + e < cin ? x[off + k + e] : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  }

  // the project's accumulators, in registers across every chunk
  const int wm = warp % pl.wgm, wn = warp / pl.wgm;
  const int mtp = pl.p16 / 16, ntp = ceil_div(cout, 8);
  float acc[PM][PN][4];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < PN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int ch = ch0; ch < ch_end; ++ch) {
    const int buf = (ch - ch0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ch's weights (and the window) are in; chunk ch - 1 is done
    // 2. the next chunk's weights load while this one computes
    if (ch + 1 < ch_end) stage_weights(ch + 1, buf ^ 1);
    unsigned char* wb = weights(buf);
    const bf16* we_s = reinterpret_cast<const bf16*>(wb);
    const bf16* wp_s = reinterpret_cast<const bf16*>(wb + pl.rwp);
    const float* be_s = reinterpret_cast<const float*>(wb + pl.rbe);
    const float* bd_s = reinterpret_cast<const float*>(wb + pl.rbd);
    const float* wd_s = reinterpret_cast<const float*>(wb + pl.rwd);

    // expand: e[w][c] = relu6(x[w] . we[:, c] + be[c]), 0 outside the image;
    // a unit is a (16-pixel m-tile, pair of n-tiles), and a warp takes two
    // units at a time, their products interleaved
    {
      const int sp = ce == 32 ? 1 : 0;  // log2 of the n-tile pairs: ce / 16
      const int units = pl.nw16 / 16 << sp;
      for (int u0 = warp; u0 < units; u0 += 2 * kWarps) {
        const int nu = u0 + kWarps < units ? 2 : 1;  // warp-uniform
        float ea[2][2][4];
        const bf16* a_row[2];
        const bf16* b_row[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int u = q < nu ? u0 + q * kWarps : u0, mt = u >> sp, jj = u & sp;
          a_row[q] = xs + (mt * 16 + (lane & 15)) * pl.ldx + (lane >> 4) * 8;
          b_row[q] = we_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * pl.ldwe + jj * 16 + (lane >> 4) * 8;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) ea[q][j][e] = 0.f;
        }
#pragma unroll 2
        for (int kk = 0; kk < pl.cin16; kk += 16) {
          uint32_t a[2][4], b[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q < nu) {
              ldmatrix_x4(a[q], a_row[q] + kk);
              ldmatrix_x4_trans(b[q], b_row[q] + kk * pl.ldwe);
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q < nu) {
              mma_bf16(ea[q][0], a[q], b[q][0], b[q][1]);
              mma_bf16(ea[q][1], a[q], b[q][2], b[q][3]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q >= nu) continue;
          const int u = u0 + q * kWarps, mt = u >> sp, jj = u & sp;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int w = mt * 16 + g + 8 * h;
            const bool in = xo_s[w] >= 0;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int cc = jj * 16 + 8 * j + 2 * c4;
              const float v0 = in ? relu6f(ea[q][j][2 * h] + be_s[cc]) : 0.f;
              const float v1 = in ? relu6f(ea[q][j][2 * h + 1] + be_s[cc + 1]) : 0.f;
              if (p.round_e)
                *reinterpret_cast<uint32_t*>(es + ((long)w * pl.lde + cc) * 2) = pack_bf16x2(v0, v1);
              else
                *reinterpret_cast<float2*>(es + ((long)w * pl.lde + cc) * 4) = make_float2(v0, v1);
            }
          }
        }
      }
    }
    __syncthreads();

    // depthwise: d[px][c] = round(relu6(sum_taps e * wd + bd)), a thread per
    // (pixel, 4 channels), the taps' weights in registers
    {
      const int G = ce / 4, c = (tid % G) * 4, nslot = kThreads / G;
      float w9[9][4], bd4[4];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(wd_s + t * ce + c);
        w9[t][0] = v.x;
        w9[t][1] = v.y;
        w9[t][2] = v.z;
        w9[t][3] = v.w;
      }
      {
        const float4 v = *reinterpret_cast<const float4*>(bd_s + c);
        bd4[0] = v.x;
        bd4[1] = v.y;
        bd4[2] = v.z;
        bd4[3] = v.w;
      }
      for (int px = tid / G; px < pl.p; px += nslot) {
        const long w0 = pw_s[px];
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (p.round_e) {
          const bf16* e = reinterpret_cast<const bf16*>(es) + w0 * pl.lde + c;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const uint2 u = *reinterpret_cast<const uint2*>(e + (dy * pl.wc + dx) * pl.lde);
              const float f[4] = {__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u)};
#pragma unroll
              for (int k = 0; k < 4; ++k) a[k] = fmaf(f[k], w9[dy * 3 + dx][k], a[k]);
            }
        } else {
          const float* e = reinterpret_cast<const float*>(es) + w0 * pl.lde + c;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float4 v = *reinterpret_cast<const float4*>(e + (dy * pl.wc + dx) * pl.lde);
              const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) a[k] = fmaf(f[k], w9[dy * 3 + dx][k], a[k]);
            }
        }
        *reinterpret_cast<uint2*>(ds + px * pl.ldd + c) =
            make_uint2(pack_bf16x2(relu6f(a[0] + bd4[0]), relu6f(a[1] + bd4[1])),
                       pack_bf16x2(relu6f(a[2] + bd4[2]), relu6f(a[3] + bd4[3])));
      }
    }
    __syncthreads();

    // project: acc += d [pixels, ce] . wp [ce, Cout]
    for (int kk = 0; kk < ce; kk += 16) {
      uint32_t a[PM][4];
#pragma unroll
      for (int i = 0; i < PM; ++i) {
        const int mt = wm * PM + i;
        if (mt < mtp) ldmatrix_x4(a[i], ds + (mt * 16 + (lane & 15)) * pl.ldd + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < PN / 2; ++jj) {
        const int nt = wn * PN + 2 * jj;
        if (nt >= ntp) continue;
        uint32_t b[4];
        ldmatrix_x4_trans(b, wp_s + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * pl.ldwp + nt * 8 +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          if (wm * PM + i >= mtp) continue;
          mma_bf16(acc[i][2 * jj], a[i], b[0], b[1]);
          if (nt + 1 < ntp) mma_bf16(acc[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // 3. the epilogue, or this split's float partial. Output pixel px of the
  // tile is (image b0 + px / (th wo), row r0 + (px / wo) % th, column px % wo).
  auto pixel = [&](int px, int& im, int& i, int& j) {
    im = px / per_img;
    const int rest = px - im * per_img;
    i = rest / pl.wo;
    j = rest - i * pl.wo;
    return px < pl.p && im < ni && i < th;
  };
  if (p.part != nullptr) {
#pragma unroll
    for (int ii = 0; ii < PM; ++ii)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int im, i, j;
        if (!pixel((wm * PM + ii) * 16 + g + 8 * h, im, i, j)) continue;
        float* dst = p.part + (((long)split * p.B + b0 + im) * pl.ho + r0 + i) * pl.wo * cout +
                     (long)j * cout;
#pragma unroll
        for (int jj = 0; jj < PN; ++jj) {
          const int n = (wn * PN + jj) * 8 + 2 * c4;
          if (n + 1 < cout && cout % 2 == 0)
            *reinterpret_cast<float2*>(dst + n) = make_float2(acc[ii][jj][2 * h], acc[ii][jj][2 * h + 1]);
          else if (n < cout) {  // an odd Cout: element stores, none past it
            dst[n] = acc[ii][jj][2 * h];
            if (n + 1 < cout) dst[n + 1] = acc[ii][jj][2 * h + 1];
          }
        }
      }
    return;
  }
  bf16* os = reinterpret_cast<bf16*>(es);  // e is done: the last chunk's depthwise has synchronized
#pragma unroll
  for (int ii = 0; ii < PM; ++ii)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = (wm * PM + ii) * 16 + g + 8 * h;
      int im, i, j;
      if (!pixel(px, im, i, j)) continue;
      // the residual from the staged window: output (i, j) is window (i + 1, j + 1) at stride 1
      const bf16* xr = xs + ((im * pl.wr + i + 1) * pl.wc + j + 1) * pl.ldx;
#pragma unroll
      for (int jj = 0; jj < PN; ++jj) {
        const int n = (wn * PN + jj) * 8 + 2 * c4;
        if (n >= cout) continue;
        float v0 = acc[ii][jj][2 * h] + p.bp[n];
        float v1 = acc[ii][jj][2 * h + 1] + (n + 1 < cout ? p.bp[n + 1] : 0.f);
        if (p.shortcut) {
          v0 += __bfloat162float(xr[n]);
          v1 += __bfloat162float(xr[n + 1]);
        }
        *reinterpret_cast<uint32_t*>(os + px * pl.ldo + n) = pack_bf16x2(v0, v1);
      }
    }
  __syncthreads();
  bf16* out = static_cast<bf16*>(p.out);
  if (cout % 8 == 0 && p.out_col_stride % 8 == 0 && p.out_row_stride % 8 == 0) {
    const int vpr = cout / 8;
    for (int t = tid; t < pl.p * vpr; t += kThreads) {
      const int px = t / vpr, n = (t - px * vpr) * 8;
      int im, i, j;
      if (!pixel(px, im, i, j)) continue;
      *reinterpret_cast<uint4*>(out + (long)(b0 + im) * p.out_batch +
                                (r0 + i + p.out_row0) * p.out_row_stride + j * p.out_col_stride +
                                n) = *reinterpret_cast<const uint4*>(os + px * pl.ldo + n);
    }
  } else {  // element stores
    for (int t = tid; t < pl.p * cout; t += kThreads) {
      const int px = t / cout, n = t - px * cout;
      int im, i, j;
      if (!pixel(px, im, i, j)) continue;
      out[(long)(b0 + im) * p.out_batch + (r0 + i + p.out_row0) * p.out_row_stride +
          j * p.out_col_stride + n] = os[px * pl.ldo + n];
    }
  }
}

// The tile of the most output pixels that fits: ni images (th = ho) or th
// rows of one image, the project's m-tiles within the warp grid's, shared
// memory within kMaxDynamicSmem; ce 32 unless 16 gives a larger tile.
static bool plan(const int* a, int sms, IrbPlan* pl) {
  const int B = a[kIBatch], H = a[kIHeight], W = a[kIWidth], s = a[kIStride];
  const int cin = a[kICin], cexp = a[kICexp], cout = a[kICout];
  const int ntp = ceil_div(cout, 8);
  const bool wide = cout > 32;
  const int PM = wide ? Wide::PM : Narrow::PM, PN = wide ? Wide::PN : Narrow::PN;
  int wgn = 1;
  while (wgn * PN < ntp) wgn *= 2;
  if (wgn > kWarps) return false;
  const int wgm = kWarps / wgn, cap = wgm * PM * 16;
  const int ho = (H - 1) / s + 1, wo = (W - 1) / s + 1;
  const int cin16 = ceil_div(cin, 16) * 16, cout16 = ceil_div(cout, 16) * 16;
  const int ebytes = a[kIRoundE] ? 2 : 4;
  IrbPlan best{};
  best.p = 0;
  auto lay = [&](IrbPlan& t, int ni, int th, int ce) {
    t.ho = ho; t.wo = wo; t.ni = ni; t.th = th; t.ce = ce;
    t.wr = (th - 1) * s + 3; t.wc = (wo - 1) * s + 3;
    t.nw16 = ceil_div(ni * t.wr * t.wc, 16) * 16;
    t.p = ni * th * wo; t.p16 = ceil_div(t.p, 16) * 16;
    t.cin16 = cin16; t.cout16 = cout16; t.wgm = wgm; t.wgn = wgn; t.wide = wide;
    t.ldx = cin16 + 8; t.lde = ce + 8; t.ldd = ce + 8; t.ldo = ceil_div(cout, 8) * 8 + 8;
    t.ldwe = ce + 8; t.ldwp = cout16 + 8;
    size_t o = 0;
    auto take = [&](size_t bytes) { const size_t at = o; o += (bytes + 15) / 16 * 16; return (int)at; };
    t.ox = take((size_t)t.nw16 * t.ldx * 2);
    t.oe = take(std::max((size_t)t.nw16 * t.lde * ebytes, (size_t)t.p16 * t.ldo * 2));
    t.od = take((size_t)t.p16 * t.ldd * 2);
    t.oxo = take((size_t)t.nw16 * 4);
    t.opw = take((size_t)t.p16 * 4);
    size_t w = 0;
    auto wtake = [&](size_t bytes) { const size_t at = w; w += (bytes + 15) / 16 * 16; return (int)at; };
    wtake((size_t)cin16 * t.ldwe * 2);
    t.rwp = wtake((size_t)ce * t.ldwp * 2);
    t.rbe = wtake(ce * 4);
    t.rbd = wtake(ce * 4);
    t.rwd = wtake(9 * ce * 4);
    t.wsz = (int)w;
    t.ow = take(2 * w);
    t.smem = o;
    return t.p16 <= cap && o <= kMaxDynamicSmem;
  };
  for (int ce : {32, 16}) {
    auto consider = [&](int ni, int th) {
      IrbPlan t{};
      if (lay(t, ni, th, ce) && t.p > best.p) best = t;
    };
    for (int ni = std::min(B, 8); ni >= 2; --ni) consider(ni, ho);
    for (int th = ho; th >= 1; --th) consider(1, th);
  }
  if (best.p == 0) return false;
  // balanced: the last row tile or image group is not a sliver
  if (best.ni == 1) {
    lay(best, 1, ceil_div(ho, ceil_div(ho, best.th)), best.ce);
  } else {
    lay(best, ceil_div(B, ceil_div(B, best.ni)), ho, best.ce);
  }
  best.row_tiles = ceil_div(ho, best.th);
  best.groups = ceil_div(B, best.ni);
  // the window pixels' input offsets are ints from image b0's first element
  if ((long)best.ni * (H + 2 * a[kIXRow0]) * a[kIXRowStride] > INT_MAX) return false;
  if ((long)best.groups * best.row_tiles > INT_MAX) return false;
  best.blocks = best.groups * best.row_tiles;
  // Cexp splits over blocks only when the tiles leave over half the SMs idle,
  // and then up to one wave: every split adds a pass over float partials
  const int nchunks = ceil_div(cexp, best.ce);
  const int want = 2 * best.blocks >= sms ? 1 : sms / best.blocks;
  best.cps = ceil_div(nchunks, std::min(nchunks, want));
  best.splits = ceil_div(nchunks, best.cps);
  *pl = best;
  return true;
}

}  // namespace irbtc

// out = round(sum of the splits' partials in order + bp [+ x]).
template <typename T>
__global__ void __launch_bounds__(256) irb_reduce(IrbParams p, int splits, int ho, int wo) {
  const long total = (long)p.B * ho * wo * p.cout;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    float v = p.part[i];
    for (int s = 1; s < splits; ++s) v += p.part[s * total + i];
    const int n = i % p.cout;
    long rest = i / p.cout;
    const int q = rest % wo;
    rest /= wo;
    const int r = rest % ho;
    const long b = rest / ho;
    v += p.bp[n];
    if (p.shortcut)
      v += ld(x, b * p.x_batch + (r + p.x_row0) * p.x_row_stride + q * p.x_col_stride + n);
    store_as(out + b * p.out_batch + (r + p.out_row0) * p.out_row_stride + q * p.out_col_stride + n,
             v);
  }
}

// The chain layout's zeros: border rows, W tail and channel-pad lanes.
template <typename T>
__global__ void __launch_bounds__(256)
    irb_chain_border(T* out, long total, int rows, int cols, int chans, int wo, int cout) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int c = i % chans, q = (i / chans) % cols, r = (i / ((long)chans * cols)) % rows;
    if (r == 0 || r == rows - 1 || q >= wo || c >= cout) store_as(out + i, 0.f);
  }
}

static int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return cached[dev];
}


// float32: the tile (up to kIrbMaxPix output pixels whose buffers fit), the
// grid and the Cexp split.
static bool fma_plan(const int* a, int sms, IrbPlan* pl) {
  const int B = a[kIBatch], H = a[kIHeight], W = a[kIWidth], s = a[kIStride];
  const int cin = a[kICin], cexp = a[kICexp], cout = a[kICout];
  pl->ho = (H - 1) / s + 1;
  pl->wo = (W - 1) / s + 1;
  pl->th = 0;
  for (int tw = std::min(pl->wo, kIrbMaxPix); tw >= 1 && pl->th == 0; tw = tw == 1 ? 0 : ceil_div(tw, 2))
    for (int th = std::min(pl->ho, kIrbMaxPix / tw); th >= 1; --th)
      if ((size_t)IrbSmem(th, tw, s, cin, cout).total * 4 <= kMaxDynamicSmem) {
        pl->th = th;
        pl->tw = tw;
        break;
      }
  if (pl->th == 0) return false;
  pl->row_tiles = ceil_div(pl->ho, pl->th);  // balanced: the last tile is not a sliver
  pl->th = ceil_div(pl->ho, pl->row_tiles);
  pl->col_tiles = ceil_div(pl->wo, pl->tw);
  pl->tw = ceil_div(pl->wo, pl->col_tiles);
  pl->smem = (size_t)IrbSmem(pl->th, pl->tw, s, cin, cout).total * 4;
  const long base = (long)B * pl->row_tiles * pl->col_tiles;
  if (base > INT_MAX) return false;
  pl->blocks = (int)base;
  const int nchunks = ceil_div(cexp, kIrbCE);
  const int want = ceil_div(2 * sms, (int)std::min(base, (long)2 * sms));  // two waves of blocks
  const int splits = std::min(nchunks, want);
  pl->cps = ceil_div(nchunks, splits);
  pl->splits = ceil_div(nchunks, pl->cps);
  return true;
}

// The tile, the grid and the Cexp split for these shapes; false if none fits.
static bool irb_plan(const int* a, IrbPlan* pl) {
  const int B = a[kIBatch], H = a[kIHeight], W = a[kIWidth], s = a[kIStride];
  const int cin = a[kICin], cexp = a[kICexp], cout = a[kICout];
  if (B < 1 || H < 1 || W < 1 || (s != 1 && s != 2) || cin < 1 || cexp < 1 || cout < 1 ||
      (a[kIShortcut] && (s != 1 || cin != cout)))
    return false;
  const int sms = sm_count();
  if (sms == 0) return false;
  if (a[kIDtype] == kBF16) return irbtc::plan(a, sms, pl);
  if (a[kIDtype] == kF32) return fma_plan(a, sms, pl);
  return false;
}

static int grid_for(long total) { return (int)std::min((total + 255) / 256, 4096L); }

template <typename T>
static int irb_launch(const int* a, const IrbParams& p, const IrbPlan& pl, cudaStream_t stream) {
  // bf16: the tensor-core tile of the plan's warp grid; float32: the FMA tile
  void (*tile)(IrbParams, IrbPlan);
  if constexpr (sizeof(T) == 2) {
    static const bool raised = raise_smem_limit(irbtc::irb_tc<irbtc::Wide>) &&
                               raise_smem_limit(irbtc::irb_tc<irbtc::Narrow>);
    if (!raised) return (int)cudaErrorInvalidValue;
    tile = pl.wide ? irbtc::irb_tc<irbtc::Wide> : irbtc::irb_tc<irbtc::Narrow>;
  } else {
    static const bool raised = raise_smem_limit(irb_fma<T>);
    if (!raised) return (int)cudaErrorInvalidValue;
    tile = irb_fma<T>;
  }
  tile<<<dim3(pl.blocks, pl.splits), sizeof(T) == 2 ? irbtc::kThreads : kIrbThreads, pl.smem,
         stream>>>(p, pl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (pl.splits > 1) {
    irb_reduce<T><<<grid_for((long)p.B * pl.ho * pl.wo * p.cout), 256, 0, stream>>>(
        p, pl.splits, pl.ho, pl.wo);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (a[kIChainRows] > 0) {
    const long total = (long)p.B * a[kIChainRows] * a[kIChainCols] * a[kIChainChans];
    irb_chain_border<T><<<grid_for(total), 256, 0, stream>>>(
        static_cast<T*>(p.out), total, a[kIChainRows], a[kIChainCols], a[kIChainChans], pl.wo,
        p.cout);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace capk

extern "C" {

// The number of Cexp splits capk_fused_irb will use for these ints (then
// `part` must hold splits x B x Hout x Wout x Cout floats when splits > 1),
// or 0 for shapes the kernel does not take.
int capk_fused_irb_splits(const int* args) {
  capk::IrbPlan pl;
  return capk::irb_plan(args, &pl) ? pl.splits : 0;
}

// One block (kernel G) on `stream`. args: capk::IrbArg's fields; ptrs: x,
// we [Cin, Cexp], be [Cexp], wd [9, Cexp], bd [Cexp], wp [Cexp, Cout], bp
// [Cout], out, part (x, we, wp and out in the dtype; the rest float32). x
// pixel (b, r, c) channel k lies at b * x_batch + (r + x_row0) *
// x_row_stride + c * x_col_stride + k with x_batch = (H + 2 x_row0) *
// x_row_stride, and likewise out. chain_rows > 0: out is the chain layout
// [B, chain_rows, chain_cols, chain_chans] and its pad is written with
// zeros. Returns a CUDA error code (cudaErrorInvalidValue for shapes the
// kernel does not take).
int capk_fused_irb(const int* a, void* const* ptrs, cudaStream_t stream) {
  using namespace capk;
  IrbPlan pl;
  if (!irb_plan(a, &pl)) return (int)cudaErrorInvalidValue;
  IrbParams p{};
  p.x = ptrs[0];
  p.we = ptrs[1];
  p.be = static_cast<const float*>(ptrs[2]);
  p.wd = static_cast<const float*>(ptrs[3]);
  p.bd = static_cast<const float*>(ptrs[4]);
  p.wp = ptrs[5];
  p.bp = static_cast<const float*>(ptrs[6]);
  p.out = ptrs[7];
  p.part = static_cast<float*>(ptrs[8]);
  if (pl.splits > 1 && p.part == nullptr) return (int)cudaErrorInvalidValue;
  if (pl.splits == 1) p.part = nullptr;
  p.B = a[kIBatch];
  p.H = a[kIHeight];
  p.W = a[kIWidth];
  p.cin = a[kICin];
  p.cexp = a[kICexp];
  p.cout = a[kICout];
  p.stride = a[kIStride];
  p.shortcut = a[kIShortcut];
  p.round_e = a[kIRoundE];
  p.x_row0 = a[kIXRow0];
  p.x_row_stride = a[kIXRowStride];
  p.x_col_stride = a[kIXColStride];
  p.x_batch = (long)(p.H + 2 * a[kIXRow0]) * a[kIXRowStride];
  p.out_row0 = a[kIOutRow0];
  p.out_row_stride = a[kIOutRowStride];
  p.out_col_stride = a[kIOutColStride];
  p.out_batch = (long)(pl.ho + 2 * a[kIOutRow0]) * a[kIOutRowStride];
  if (a[kIDtype] == kBF16) return irb_launch<__nv_bfloat16>(a, p, pl, stream);
  if (a[kIDtype] == kF32) return irb_launch<float>(a, p, pl, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
