// Border-clamped bilinear gather for sm_90a (NVIDIA Hopper). Built by nvcc
// into a shared library with a plain C interface and loaded with ctypes
// (neuray_tpu_torch/ops/gather.py).
//
// Replaces the Pallas TPU kernel neuray_tpu/ops/pallas/gather.py:85
// gather_bilinear_border (body _gather_kernel at :37). Same result:
// clamp (ix, iy) to [0, size-1], anchor x0 in [0, fw-2] and y0 in
// [0, fh-2], t = clamped - anchor in [0, 1], lerp along x, then y. The
// TPU kernel's 16-wide column window, one-hot selection and channel
// chunking were VMEM and sublane constraints and are not carried over.
// One launch also does the work around each render gather
// (interpolate_feature_map): it converts points of the (h, w) frame to map
// pixels as neuray_tpu/ops/interpolate.py:56-63 does, op for op in
// round-to-nearest, and multiplies by the projection mask in the output's
// dtype.
//
// What bounds it on this card: bytes. A point reads 8 B of coordinates
// and four taps of c channels and writes c outputs, for three lerps a
// channel (well under one flop a byte). The points of one render chunk
// project onto a few epipolar segments of each view, so the map bytes
// they touch are a small part of the map and stay in L2; the output write
// is then the floor. What the design does about it:
// - A lane group per (view, point). When c*sizeof(T) is a multiple of 16
//   and the map is 16-byte aligned, G = c*sizeof(T)/16 lanes share a
//   point (f32 c = 64: 16 lanes of 4 channels, bf16 8 of 8, u8 4 of 16);
//   each issues its four taps as 16-byte read-only loads
//   (ld.global.nc.v4) for kPoints points before any arithmetic, and
//   stores 16 bytes of output (u8 -> bf16: 32). In NHWC the two taps of a
//   row are adjacent, so a point reads two runs of 2c contiguous values,
//   and the lanes of a warp store contiguous memory. 8-byte vectors where
//   16 do not divide a pixel (bf16 c = 4).
// - Coordinates once per lane: the view is blockIdx.y, the point a
//   multiply-add of block and slot, one float2 load a lane (a broadcast
//   in the group), the frame conversion (division in three ops,
//   div_rn), clamp, anchor and weights in 32-bit arithmetic; 64-bit
//   arithmetic only for element offsets (v*p*c reaches 1.6e8).
// - Any other c (the rgb map's 3) or a misaligned map: one lane a channel
//   with scalar loads, in the same kernel. One thread a point reading its
//   2c contiguous values a row was measured slower at c = 3 and on the
//   encode's real c = 4 coordinates (gather_bench.py --routes). The
//   wrapper picks the route (ops/gather.py: _route); the library checks
//   it.
// - Grid: as many blocks as fit resident (occupancy x SMs, queried once),
//   shared by the views, and a grid-stride loop over the points.
// - u8: the codes convert to f32 through the mantissa of 2^23 (a byte
//   permute and a subtraction, not the quarter-rate integer conversion).
// The u8 instantiation lerps the codes and dequantizes (code * scale -
// offset) with every f32 op rounded on its own (__fmul_rn, __fsub_rn), so
// it equals its plain PyTorch version bit for bit.
//
// The backward (gather_border_f32_backward): the gradient of the f32 map,
// a scatter-add. The JAX package leaves it to XLA, as the transpose of its
// gather (jax.vjp of neuray_tpu/ops/interpolate.py:115). Each (view,
// point) adds grad_out * mask * w_tap to the four taps it read; the taps
// and weights come from the forward's prologue (anchor), so they are the
// forward's bit for bit, and every product is rounded on its own, as the
// plain version (ops/gather.py: gather_bilinear_border_backward_ref) forms
// it; only the order of the sums differs.
//
// What bounds it on this card: bytes (grad_out read once, the coordinates
// and the mask once, the [v, fh, fw, c] gradient written once). A scatter
// with global atomics moves far more: each 16 B of a tap is a
// read-modify-write at L2 (1 KB a 64-channel point, 4x its grad_out), and
// the map has to be zero-filled before it. So the points are binned by
// the map tile they touch and each tile is summed in shared memory, in a
// memset of the counts and three kernels:
// - Tiles of kTile x kTile = 8 x 8 pixels for every c (4 was slower at c =
//   64: more entries and blocks). A point's four taps touch 1, 2 or 4
//   tiles, ~(1 + 1/8)^2 = 1.27 entries a point.
// - bin_points<false> (the count): kBinPoints * 256 points of a view a
//   block, their bins (the view's tiles) counted in shared memory and
//   added to the global counts with one atomic a bin the block touched
//   (an atomic a point contends at L2); the last block to finish scans
//   the counts into bin offsets, cuts each bin into chunks of at most
//   kChunk = 256 entries and lists the chunks past each bin's first.
//   bin_points<true> (the fill) counts again, takes its range of each bin
//   with one atomic, and writes a 16-byte record an entry (the point, its
//   anchor pixel, tx and ty), so the sum reads no coordinates. One memset
//   zeroes the counts; nothing returns to the host: the last grid's size
//   is an upper bound from the shapes. Scratch: 16 bytes an entry, sized
//   for 4 v p entries (16.8 MB at the training pass's 8 x 32,768 points,
//   a quarter of its grad_out), and 8 bytes a bin.
// - accumulate_tiles: a block a chunk (block i < bins: bin i's first). A
//   lane owns a channel, ceil(c / 32) warps all of them (a warp reads 128
//   contiguous bytes of a grad_out row, at any alignment); the chunk is
//   cut into tile_subsets(c) parts (4 at c <= 64, 64 KB of copies at
//   most), each walked by its warps into its own copy of the tile in
//   shared memory, so every add is a plain load and store: an f32
//   atomicAdd to shared memory is a compare-and-swap loop on this card
//   (ATOMS.CAST.SPIN), and a first design with 16 of them an entry was
//   slower than the global-atomic kernel it replaced. A warp loads kBatch
//   records at once, then their masks and grad_out values (grad_out with
//   volatile loads: the compiler sinks plain read-only loads to their
//   uses, a memory latency an entry), then sums; consecutive entries with
//   the same anchor add in registers (a ray's samples and clamped points
//   land on one pixel), and a run's four taps go to shared memory without
//   a branch (a tap outside the tile adds an exact 0 to the lane's own
//   word).
// - A bin of one chunk sums its copies and stores the whole tile, zeros
//   included, 16 bytes at a time where c allows: its pixels are written
//   once, and no gradient byte of it goes through a global atomic. A
//   longer bin (a view's points clustered on a few pixels; every point on
//   one pixel at worst) is split: one block a chunk side by side, each
//   adding its tile's nonzero sums with 16-byte global atomics to the
//   map's tile, which the fill kernel zeroed. That is the one place the
//   map is written twice or takes atomics, at most one add a pixel a
//   chunk. So the wrapper allocates the gradient with torch.empty and no
//   memset of the map runs.
// Measured (PERF.md, NVIDIA H100 80GB HBM3): 1.03-1.40x faster than the
// global-atomic scatter it replaced on the training steps' 64-channel
// maps, 2-5x on the long bin, slower on the small maps (the depth head's,
// self-hit's), where its memset and three launches cost more than the
// work. The sum is the most of it, bound by its instruction count more
// than by bytes: every product is rounded on its own, as the plain
// version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads a block, at most
constexpr int kPoints = 2;     // points a lane: taps in flight

// where a point's (x, y) lives
enum Frame : int { kMapPixels = 0, kAlignCorners = 1, kHalfPixel = 2 };

struct Args {
  const void* map;      // [v, fh, fw, c]
  const float* coords;  // [v, p, 2]
  const float* mask;    // [v, p] or null
  const float* scale;   // [c], u8 only
  const float* offset;  // [c], u8 only
  void* out;            // [v, p, c]
  int p, fh, fw, c;
  int frame;            // Frame
  float hm1, wm1;       // h - 1, w - 1 of the points' frame
  float rh, rw;         // their reciprocals, rounded to nearest
  bool xy_vec;          // coords 8-byte aligned: one float2 load
};

template <typename T> struct OutOf { using type = T; };
template <> struct OutOf<uint8_t> { using type = __nv_bfloat16; };

// a u8 code as f32 without the quarter-rate integer conversion: the code
// in the low mantissa bits of 2^23, less 2^23 (exact for 0..255)
__device__ __forceinline__ float u8_f32(uint32_t bits) {
  return __fsub_rn(__uint_as_float(bits), 8388608.0f);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(uint8_t x) {
  return u8_f32(0x4B000000u | x);
}

// element i of a vector of T held in 32-bit words, as f32
template <typename T>
__device__ __forceinline__ float unpack(const uint32_t* w, int i) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(w[i]);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                   : (w[i >> 1] << 16));
  } else {
    return u8_f32(__byte_perm(w[i >> 2], 0x4B000000u, 0x7440 | (i & 3)));
  }
}

// N consecutive channels of one tap: one 8- or 16-byte load, or N scalar
// loads
template <typename T, int N, bool VEC> struct Tap;

template <typename T, int N> struct Tap<T, N, true> {
  static constexpr int kWords = N * (int)sizeof(T) / 4;
  static_assert(kWords == 2 || kWords == 4, "a vector tap is 8 or 16 bytes");
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWords == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x, w[1] = q.y;
    }
  }
  __device__ __forceinline__ float operator[](int i) const {
    return unpack<T>(w, i);
  }
};

template <typename T, int N> struct Tap<T, N, false> {
  T e[N];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = __ldg(p + i);
  }
  __device__ __forceinline__ float operator[](int i) const {
    return to_f32(e[i]);
  }
};

// x / b rounded to nearest, given y = RN(1/b): q = RN(x*y) is within an
// ulp of x/b, its residual x - q*b is exact in an fma, and one correction
// RN(q + residual*y) is the correctly rounded quotient (Markstein's
// theorem; no overflow or underflow at pixel coordinates). Three
// dependent ops where __fdiv_rn takes a reciprocal refinement and a
// range check on every call.
__device__ __forceinline__ float div_rn(float x, float b, float y) {
  const float q = __fmul_rn(x, y);
  return __fmaf_rn(__fmaf_rn(-q, b, x), y, q);
}

// feature_pixel_coords for one coordinate: a point of a frame whose size
// less one is s1 (reciprocal r1) to a pixel of a map of size n. Halving is
// a multiply by 0.5, which rounds as the division by 2 does.
__device__ __forceinline__ float to_map(float x, float s1, float r1, int n,
                                        int frame) {
  const float norm = __fsub_rn(__fmul_rn(div_rn(x, s1, r1), 2.0f), 1.0f);
  if (frame == kAlignCorners)
    return __fmul_rn(__fmul_rn(__fadd_rn(norm, 1.0f), 0.5f), (float)(n - 1));
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(norm, 1.0f), (float)n), 1.0f),
                   0.5f);
}

struct Anchor {
  int x0, y0;       // the top-left tap, in [0, fw-2] x [0, fh-2]
  float tx, ty, m;  // lerp weights and mask
};

// point i (flat over views): its top-left tap, lerp weights and mask (1
// when there is none, or when with_mask is false)
__device__ __forceinline__ Anchor anchor(const Args& a, int64_t i,
                                         bool with_mask = true) {
  float2 xy;
  if (a.xy_vec) {
    xy = __ldg(reinterpret_cast<const float2*>(a.coords) + i);
  } else {
    xy = make_float2(__ldg(a.coords + 2 * i), __ldg(a.coords + 2 * i + 1));
  }
  if (a.frame != kMapPixels) {
    xy.x = to_map(xy.x, a.wm1, a.rw, a.fw, a.frame);
    xy.y = to_map(xy.y, a.hm1, a.rh, a.fh, a.frame);
  }
  const float ix = fminf(fmaxf(xy.x, 0.0f), a.fw - 1.0f);
  const float iy = fminf(fmaxf(xy.y, 0.0f), a.fh - 1.0f);
  const float x0 = fminf(floorf(ix), a.fw - 2.0f);
  const float y0 = fminf(floorf(iy), a.fh - 2.0f);
  Anchor k;
  k.x0 = (int)x0;
  k.y0 = (int)y0;
  k.tx = ix - x0;
  k.ty = iy - y0;
  k.m = with_mask && a.mask ? __ldg(a.mask + i) : 1.0f;
  return k;
}

struct Point {
  int64_t tap;  // element offset of the top-left tap
  float tx, ty, m;
};

// anchor() with the element offset of the top-left tap in the map
__device__ __forceinline__ Point locate(const Args& a, int64_t map_view,
                                        int64_t i) {
  const Anchor k = anchor(a, i);
  Point pt;
  pt.tap = map_view + (int64_t)(k.y0 * a.fw + k.x0) * a.c;
  pt.tx = k.tx;
  pt.ty = k.ty;
  pt.m = k.m;
  return pt;
}

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, t)), __fmul_rn(b, t));
}

// channel i of a point's four taps, lerped along x, then y, in f32
template <typename T, int N, bool VEC>
__device__ __forceinline__ float lerp4(const Tap<T, N, VEC> (&t)[4], int i,
                                       float tx, float ty) {
  if constexpr (std::is_same<T, uint8_t>::value) {
    return lerp_rn(lerp_rn(t[0][i], t[1][i], tx), lerp_rn(t[2][i], t[3][i], tx),
                   ty);
  } else {
    const float top = t[0][i] * (1.0f - tx) + t[1][i] * tx;
    const float bot = t[2][i] * (1.0f - tx) + t[3][i] * tx;
    return top * (1.0f - ty) + bot * ty;
  }
}

// the value in the output's dtype, times the mask in that dtype
__device__ __forceinline__ void finish(float v, float m, bool masked,
                                       float* o) {
  *o = masked ? __fmul_rn(v, m) : v;
}
__device__ __forceinline__ void finish(float v, float m, bool masked,
                                       __nv_bfloat16* o) {
  __nv_bfloat16 b = __float2bfloat16(v);
  if (masked) {
    b = __float2bfloat16(
        __fmul_rn(__bfloat162float(b), __bfloat162float(__float2bfloat16(m))));
  }
  *o = b;
}

// word j of N outputs
template <int N>
__device__ __forceinline__ uint32_t out_word(const float (&r)[N], int j) {
  return __float_as_uint(r[j]);
}
template <int N>
__device__ __forceinline__ uint32_t out_word(const __nv_bfloat16 (&r)[N],
                                             int j) {
  return (uint32_t)__bfloat16_as_ushort(r[2 * j]) |
         ((uint32_t)__bfloat16_as_ushort(r[2 * j + 1]) << 16);
}

// N outputs: 16-byte stores where they fill them, else 8-byte, else
// scalar (every store offset is a multiple of N * sizeof(O))
template <typename O, int N>
__device__ __forceinline__ void store(O* p, const O (&r)[N]) {
  constexpr int kBytes = N * (int)sizeof(O);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      reinterpret_cast<uint4*>(p)[k] =
          make_uint4(out_word<N>(r, 4 * k), out_word<N>(r, 4 * k + 1),
                     out_word<N>(r, 4 * k + 2), out_word<N>(r, 4 * k + 3));
    }
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int k = 0; k < kBytes / 8; ++k) {
      reinterpret_cast<uint2*>(p)[k] =
          make_uint2(out_word<N>(r, 2 * k), out_word<N>(r, 2 * k + 1));
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = r[i];
  }
}

// Block (lanes, slots): threadIdx.x is the lane (N channels), threadIdx.y
// the point slot; a lane handles kPoints points, slots apart. The view is
// blockIdx.y; blockIdx.x strides over the view's points.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(kThreads) gather_lanes(const Args a) {
  using O = typename OutOf<T>::type;
  constexpr bool kU8 = std::is_same<T, uint8_t>::value;
  const T* __restrict__ map = static_cast<const T*>(a.map);
  O* __restrict__ out = static_cast<O*>(a.out);
  const int lanes = a.c / N;
  const int slots = blockDim.y;
  const int per_block = slots * kPoints;
  const int64_t first = (int64_t)blockIdx.y * a.p;
  const int64_t map_view = (int64_t)blockIdx.y * a.fh * a.fw * a.c;
  const int64_t row = (int64_t)a.fw * a.c;
  const bool masked = a.mask != nullptr;
  for (int k = threadIdx.x; k < lanes; k += blockDim.x) {
    const int ch = k * N;
    // u8: the lane's dequant scales and offsets, in registers (measured
    // faster than a table in shared memory despite the registers)
    float s[N], o[N];
    if constexpr (kU8) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s[i] = __ldg(a.scale + ch + i);
        o[i] = __ldg(a.offset + ch + i);
      }
    }
    for (int base = blockIdx.x * per_block; base < a.p;
         base += gridDim.x * per_block) {
      Point pts[kPoints];
      Tap<T, N, VEC> taps[kPoints][4];
#pragma unroll
      for (int j = 0; j < kPoints; ++j) {
        const int q = min(base + (int)threadIdx.y + j * slots, a.p - 1);
        pts[j] = locate(a, map_view, first + q);
      }
#pragma unroll
      for (int j = 0; j < kPoints; ++j) {
        const T* t = map + pts[j].tap + ch;
        taps[j][0].load(t);
        taps[j][1].load(t + a.c);
        taps[j][2].load(t + row);
        taps[j][3].load(t + row + a.c);
      }
#pragma unroll
      for (int j = 0; j < kPoints; ++j) {
        const int q = base + (int)threadIdx.y + j * slots;
        if (q >= a.p) continue;
        O r[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float v = lerp4(taps[j], i, pts[j].tx, pts[j].ty);
          if constexpr (kU8) v = __fsub_rn(__fmul_rn(v, s[i]), o[i]);
          finish(v, pts[j].m, masked, &r[i]);
        }
        store<O, N>(out + (first + q) * a.c + ch, r);
      }
    }
  }
}

// ---- the backward: bin the points by tile, sum each tile in shared memory

constexpr int kTile = 8;           // tile side, pixels
constexpr int kChunk = 256;        // entries of a bin one block sums at most
constexpr int kBinPoints = 4;      // points a thread of the bin kernels
constexpr int kBatch = 16;         // records a warp of the sum loads at once
constexpr int kMaxBins = 12288;    // a view's bins, counted in 48 KB
constexpr int kMaxChannels = 256;  // 8 warps of a lane a channel

// The parts of a chunk a tile's block walks side by side, each into its own
// copy of the tile: ceil(c / 32) warps a part, at most 8 warps and 4 parts,
// so the copies take at most 64 KB for any c up to kMaxChannels
__host__ __device__ __forceinline__ int tile_subsets(int c) {
  const int parts = 8 / ((c + 31) / 32);
  return parts < 4 ? parts : 4;
}

struct Tiles {
  int nx, n;      // tiles a row of the map, tiles a view
  int bins;       // v * n
  int subsets;    // tile_subsets(c)
  int* count;     // [bins + 1]: entries a bin, then its fill cursor; last:
                  // blocks of the count done
  int* off;       // [bins + 1]: bin offsets, off[bins] the entries in all
  int* extra;     // [1]: the chunks past each bin's first
  int2* items;    // [extra]: (bin, chunk) of each of them
  int4* records;  // [4*v*p] by bin, 16 bytes an entry: the point's index in
                  // its view, its anchor x0 | y0 << 16, tx and ty (f32 bits)
};

// The bins (tiles of its view) that point i's four taps touch: key[0]
// always, key[j] where has[j]
__device__ __forceinline__ Anchor tile_keys(const Args& a, const Tiles& b,
                                            int64_t i, int (&key)[4],
                                            bool (&has)[4]) {
  const Anchor k = anchor(a, i, false);
  const int c0 = k.x0 / kTile, c1 = (k.x0 + 1) / kTile;
  const int r0 = k.y0 / kTile, r1 = (k.y0 + 1) / kTile;
  key[0] = r0 * b.nx + c0;
  key[1] = r0 * b.nx + c1;
  key[2] = r1 * b.nx + c0;
  key[3] = r1 * b.nx + c1;
  has[1] = c1 != c0;
  has[2] = r1 != r0;
  has[3] = has[1] && has[2];
  return k;
}

// Exclusive prefix sums, by one block, of value(i) over i in [0, n):
// emit(i, the sum before i, value(i)); kBinPoints values a thread a round.
// Returns the total (to every thread).
template <typename Value, typename Emit>
__device__ int block_scan(int n, Value value, Emit emit) {
  __shared__ int sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x * kBinPoints) {
    const int first = base + threadIdx.x * kBinPoints;
    int vals[kBinPoints], sum = 0;
#pragma unroll
    for (int j = 0; j < kBinPoints; ++j) {
      vals[j] = first + j < n ? value(first + j) : 0;
      sum += vals[j];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < warps ? sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += x;
      }
      if (lane < warps) sums[lane] = w;
    }
    __syncthreads();
    int run = carry + (warp ? sums[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int j = 0; j < kBinPoints; ++j) {
      if (first + j < n) emit(first + j, run, vals[j]);
      run += vals[j];
    }
    carry += sums[warps - 1];
    __syncthreads();
  }
  return carry;
}

// The count's last block: the counts (added by atomics of other blocks, so
// read from L2) -> bin offsets and fill cursors; each bin cut into chunks
// of kChunk entries, the chunks past the first listed in items.
__device__ void scan_bins(const Tiles& b) {
  const int n = b.bins;
  const int total = block_scan(
      n, [&](int i) { return __ldcg(b.count + i); },
      [&](int i, int sum, int) { b.off[i] = b.count[i] = sum; });
  if (threadIdx.x == 0) b.off[n] = total;
  __syncthreads();
  const int extra = block_scan(
      n,
      [&](int i) {
        return max(0, (b.off[i + 1] - b.off[i] - 1) / kChunk);
      },
      [&](int i, int sum, int more) {
        for (int j = 1; j <= more; ++j) b.items[sum + j - 1] = make_int2(i, j);
      });
  if (threadIdx.x == 0) *b.extra = extra;
}

// Where bin's tile lies in the map: its first pixel and its rows and
// columns inside the map
struct TileAt {
  float* out;
  int th, tw, tx0, ty0;
};

__device__ __forceinline__ TileAt tile_at(const Args& a, const Tiles& b,
                                          float* grad_map, int bin) {
  const int view = bin / b.n, t = bin - view * b.n;
  TileAt at;
  at.ty0 = (t / b.nx) * kTile;
  at.tx0 = (t % b.nx) * kTile;
  at.th = min(kTile, a.fh - at.ty0);
  at.tw = min(kTile, a.fw - at.tx0);
  at.out = grad_map + (((int64_t)view * a.fh + at.ty0) * a.fw + at.tx0) * a.c;
  return at;
}

// The tile's element i (of kTile*kTile*c, a multiple of 4 when c is) put to
// its place in the map by the block: stored (kAdd false) or, where not
// zero, added with a global atomic (kAdd true); sum4(i) or sum1(i) the
// value, 4 floats at a time where c allows (the map is 16-byte aligned).
template <bool kAdd, typename Sum4, typename Sum1>
__device__ __forceinline__ void put_tile(const TileAt& at, int c, int fw,
                                         Sum4 sum4, Sum1 sum1) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  if (c % 4 == 0) {
    const int row = at.tw * c / 4;
    for (int i = tid; i < at.th * row; i += threads) {
      const int r = i / row, e = (i - r * row) * 4;
      float4* to = reinterpret_cast<float4*>(at.out + (int64_t)r * fw * c + e);
      const float4 x = sum4(r * kTile * c + e);
      if constexpr (kAdd) {
        if (x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f)
          atomicAdd(to, x);
      } else {
        *to = x;
      }
    }
  } else {
    const int row = at.tw * c;
    for (int i = tid; i < at.th * row; i += threads) {
      const int r = i / row, e = i - r * row;
      float* to = at.out + (int64_t)r * fw * c + e;
      const float x = sum1(r * kTile * c + e);
      if constexpr (kAdd) {
        if (x != 0.f) atomicAdd(to, x);
      } else {
        *to = x;
      }
    }
  }
}

// kBinPoints * blockDim.x points of view blockIdx.y a block; the view's
// bins counted in shared memory (hist, n ints), one global add a bin.
// kFill false: the counts, and the last block scans them. true: the
// block counts again, takes its range of each bin at the bin's cursor
// (one global add a bin) and writes its records there, from the anchors
// it kept in registers; then the blocks zero the map's tiles of the split
// bins (a bin of more than kChunk entries), whose chunks add to them.
template <bool kFill>
__global__ void __launch_bounds__(kThreads)
    bin_points(const Args a, const Tiles b, int v, float* grad_map) {
  extern __shared__ int hist[];
  const int64_t first = (int64_t)blockIdx.y * a.p;
  int* counts = b.count + (int64_t)blockIdx.y * b.n;
  for (int i = threadIdx.x; i < b.n; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  // a thread's points: all their coordinates loaded before the counts
  const int start = blockIdx.x * kBinPoints * blockDim.x + threadIdx.x;
  int key[kBinPoints][4];
  bool has[kBinPoints][4];
  Anchor k[kBinPoints];
#pragma unroll
  for (int j = 0; j < kBinPoints; ++j) {
    const int q = min(start + j * blockDim.x, a.p - 1);
    if (a.p > 0) k[j] = tile_keys(a, b, first + q, key[j], has[j]);
  }
#pragma unroll
  for (int j = 0; j < kBinPoints; ++j) {
    if (start + j * (int)blockDim.x >= a.p) break;
    atomicAdd(hist + key[j][0], 1);
#pragma unroll
    for (int t = 1; t < 4; ++t)
      if (has[j][t]) atomicAdd(hist + key[j][t], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < b.n; i += blockDim.x) {
    const int h = hist[i];
    if (h == 0) continue;
    if constexpr (kFill) {
      hist[i] = atomicAdd(counts + i, h);
    } else {
      atomicAdd(counts + i, h);
    }
  }
  if constexpr (kFill) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBinPoints; ++j) {
      const int q = start + j * blockDim.x;
      if (q >= a.p) break;
      const int4 r = make_int4(q, k[j].x0 | (k[j].y0 << 16),
                               __float_as_int(k[j].tx),
                               __float_as_int(k[j].ty));
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t > 0 && !has[j][t]) continue;
        b.records[atomicAdd(hist + key[j][t], 1)] = r;
      }
    }
    // a split bin's chunk 1 is listed once: its tile zeroed once
    const int blocks = gridDim.x * gridDim.y;
    for (int i = blockIdx.y * gridDim.x + blockIdx.x; i < *b.extra;
         i += blocks) {
      const int2 item = b.items[i];
      if (item.y != 1) continue;
      put_tile<false>(
          tile_at(a, b, grad_map, item.x), a.c, a.fw,
          [](int) { return make_float4(0.f, 0.f, 0.f, 0.f); },
          [](int) { return 0.f; });
    }
  } else {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(b.count + (int64_t)v * b.n, 1) ==
             (int)(gridDim.x * gridDim.y) - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    scan_bins(b);
  }
}

// A float of grad_out, with volatile asm: the compiler may neither sink
// the load to its use nor load again there (it does both to plain
// read-only loads, leaving a latency an entry)
__device__ __forceinline__ float load_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// f32 at a shared-memory address (volatile: the run's loads and stores
// keep their order, two taps may meet at the same word)
__device__ __forceinline__ float lds(unsigned at) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(at));
  return v;
}
__device__ __forceinline__ void sts(unsigned at, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(at), "f"(v));
}

// A run's sums added to its four taps in the tile, without a branch: the
// run's anchor at tile pixel (lx, ly); at: the lane's channel of tile
// pixel 0 (a shared-memory address); a tap outside the tile adds an exact 0
// there instead
__device__ __forceinline__ void add_run(unsigned at, const float (&acc)[4],
                                        int lx, int ly, int c) {
  const bool x0 = lx >= 0, x1 = lx + 1 < kTile, y0 = ly >= 0,
             y1 = ly + 1 < kTile;
  const unsigned s = at + 4u * (unsigned)((ly * kTile + lx) * c);
  const unsigned dx = 4u * c, dy = 4u * kTile * c;
  const bool in[4] = {y0 && x0, y0 && x1, y1 && x0, y1 && x1};
  const unsigned to[4] = {s, s + dx, s + dy, s + dy + dx};
#pragma unroll
  for (int tap = 0; tap < 4; ++tap) {
    const unsigned a = in[tap] ? to[tap] : at;
    sts(a, lds(a) + (in[tap] ? acc[tap] : 0.0f));
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Block (32, subsets * warps) per chunk of a bin: blockIdx.x < bins is
// chunk 0 of bin blockIdx.x, the rest the listed chunks past the first
// (blocks past them exit). A lane owns a channel, a subset's warps all c of
// them; subset s walks the s-th part of the chunk into its own copy of the
// tile, so every add is a plain load and store. A bin of one chunk sums the
// copies and stores the tile; each chunk of a split bin adds its sum to
// the tile the fill zeroed.
__global__ void __launch_bounds__(kThreads)
    accumulate_tiles(const Args a, const Tiles b,
                     const float* __restrict__ grad_out,
                     float* __restrict__ grad_map) {
  extern __shared__ __align__(16) float tiles[];  // [subsets][T*T][c]
  int bin = blockIdx.x, chunk = 0;
  if (bin >= b.bins) {
    if (bin - b.bins >= *b.extra) return;
    const int2 item = b.items[bin - b.bins];
    bin = item.x;
    chunk = item.y;
  }
  const int view = bin / b.n;
  const int c = a.c, subsets = b.subsets;
  const int warps = blockDim.y / subsets;
  const int sub = threadIdx.y / warps;
  const int lane = threadIdx.x;
  const int ch = (threadIdx.y - sub * warps) * 32 + lane;
  const bool own = ch < c;
  const int size = kTile * kTile * c;
  const int tid = threadIdx.y * 32 + lane, threads = 32 * blockDim.y;
  for (int i = tid * 4; i < subsets * size; i += threads * 4)
    *reinterpret_cast<float4*>(tiles + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the lane's channel of tile pixel 0 in its subset's copy
  const unsigned mine =
      (unsigned)__cvta_generic_to_shared(tiles + sub * size + (own ? ch : 0));
  const TileAt at = tile_at(a, b, grad_map, bin);
  const int first = b.off[bin], count = b.off[bin + 1] - first;
  const int begin = first + chunk * kChunk;
  const int end = first + min(count, (chunk + 1) * kChunk);
  const int per = (end - begin + subsets - 1) / subsets;
  const int lo = min(end, begin + sub * per), hi = min(end, lo + per);
  const int64_t points = (int64_t)view * a.p;
  const float* rows = grad_out + points * c + (own ? ch : 0);
  int rxy = -1;  // the run's anchor, x0 | y0 << 16
  float acc[4] = {};
  for (int base = lo; base < hi; base += kBatch) {
    const int n = min(kBatch, hi - base);
    // lane j: record j of the batch and its mask (past n: the batch's
    // first, unused)
    const int4 rec = __ldg(b.records + base + (lane < n ? lane : 0));
    const float m = a.mask ? __ldg(a.mask + points + rec.x) : 1.0f;
    float g[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      g[j] = load_nc(rows + (int64_t)__shfl_sync(0xffffffffu, rec.x, j) * c);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j >= n) break;
      const int xy = __shfl_sync(0xffffffffu, rec.y, j);
      const float tx = __int_as_float(__shfl_sync(0xffffffffu, rec.z, j));
      const float ty = __int_as_float(__shfl_sync(0xffffffffu, rec.w, j));
      const float mj = __shfl_sync(0xffffffffu, m, j);
      // as the plain version rounds: (grad_out * mask) * row weight * tap
      // weight (times 1 when there is no mask: exact)
      const float gm = __fmul_rn(g[j], mj);
      const float top = __fmul_rn(gm, 1.0f - ty);
      const float bot = __fmul_rn(gm, ty);
      const float w[4] = {__fmul_rn(top, 1.0f - tx), __fmul_rn(top, tx),
                          __fmul_rn(bot, 1.0f - tx), __fmul_rn(bot, tx)};
      const bool same = xy == rxy;
      if (!same && rxy >= 0 && own)
        add_run(mine, acc, (rxy & 0xffff) - at.tx0, (rxy >> 16) - at.ty0, c);
#pragma unroll
      for (int tap = 0; tap < 4; ++tap)
        acc[tap] = same ? acc[tap] + w[tap] : w[tap];
      rxy = xy;
    }
  }
  if (rxy >= 0 && own)
    add_run(mine, acc, (rxy & 0xffff) - at.tx0, (rxy >> 16) - at.ty0, c);
  __syncthreads();

  auto copies4 = [&](int i) {
    float4 x = *reinterpret_cast<const float4*>(tiles + i);
    for (int u = 1; u < subsets; ++u)
      x = add4(x, *reinterpret_cast<const float4*>(tiles + u * size + i));
    return x;
  };
  auto copies1 = [&](int i) {
    float x = tiles[i];
    for (int u = 1; u < subsets; ++u) x += tiles[u * size + i];
    return x;
  };
  if (count <= kChunk) {
    put_tile<false>(at, c, a.fw, copies4, copies1);
  } else {
    put_tile<true>(at, c, a.fw, copies4, copies1);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The launch shape of a lane kernel (N channels a lane) over v views:
// as many blocks as fit resident, shared by the views. resident: blocks
// of kThreads an SM holds, queried once per kernel.
template <typename K>
int launch_shape(K kernel, int& resident, const Args& a, int v, int N,
                 dim3& grid, dim3& block) {
  if (resident == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const int lanes = std::min(a.c / N, 32);
  block = dim3(lanes, kThreads / lanes);
  const int per_block = (int)block.y * kPoints;
  const int64_t need = ((int64_t)a.p + per_block - 1) / per_block;
  const int64_t fit =
      std::max<int64_t>(1, (int64_t)resident * sm_count() / v);
  grid = dim3((unsigned)std::min(need, fit), (unsigned)v);
  return 0;
}

template <typename T, int N, bool VEC>
int run(const Args& a, int v, cudaStream_t stream) {
  static int resident = 0;
  dim3 grid, block;
  const int e =
      launch_shape(gather_lanes<T, N, VEC>, resident, a, v, N, grid, block);
  if (e != 0) return e;
  gather_lanes<T, N, VEC><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Whether the backward takes these shapes: a view's bins counted in 48 KB
// of shared memory (kMaxBins), c <= kMaxChannels, the anchor packed in 16
// bits of x and 15 of y, and the 4 v p entries, the bins and the chunks
// indexed in int32
bool backward_takes(int v, int p, int fh, int fw, int c) {
  const int64_t n = (int64_t)((fw + kTile - 1) / kTile) *
                    ((fh + kTile - 1) / kTile);
  const int64_t entries = 4 * (int64_t)v * p;
  return v >= 0 && p >= 0 && c >= 0 && c <= kMaxChannels && n <= kMaxBins &&
         fw < 65536 && fh < 32768 &&
         entries + n * v + (entries + kChunk - 1) / kChunk < INT32_MAX;
}

// The backward's scratch, carved from one int32 buffer at base (or only
// measured when base is null): the counts, offsets, the extra chunks and
// the records (16-byte aligned). Returns its int32s.
int64_t backward_layout(int v, int p, int fh, int fw, int* base, Tiles& b) {
  b.nx = (fw + kTile - 1) / kTile;
  b.n = b.nx * ((fh + kTile - 1) / kTile);
  b.bins = b.n * v;
  const int64_t entries = 4 * (int64_t)v * p;
  const int64_t most = (entries + kChunk - 1) / kChunk;  // extra chunks
  int64_t at = 0;
  auto take = [&](int64_t ints, int align) {
    at = (at + align - 1) / align * align;
    int* x = base ? base + at : nullptr;
    at += ints;
    return x;
  };
  b.count = take(b.bins + 1, 1);
  b.off = take(b.bins + 1, 1);
  b.extra = take(1, 1);
  b.items = reinterpret_cast<int2*>(take(2 * most, 2));
  b.records = reinterpret_cast<int4*>(take(4 * entries, 4));
  return at + 3;  // the buffer's base may be 4 bytes from 16-byte aligned
}

// The backward's memset and three launches (the note at the top). The
// bins' grid: kBinPoints * kThreads points a block; the sum's: a block a
// bin, then one for each chunk past a bin's first there can be.
int run_backward(const Args& a, int v, int* scratch, const float* grad_out,
                 float* grad_map, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;
  if (!backward_takes(v, a.p, a.fh, a.fw, a.c))
    return (int)cudaErrorInvalidValue;
  int* base = reinterpret_cast<int*>(
      (reinterpret_cast<uintptr_t>(scratch) + 15) & ~(uintptr_t)15);
  Tiles b;
  b.subsets = tile_subsets(a.c);
  backward_layout(v, a.p, a.fh, a.fw, base, b);
  const int most = (4 * v * a.p + kChunk - 1) / kChunk;
  const size_t smem = (size_t)b.subsets * kTile * kTile * a.c * sizeof(float);
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        accumulate_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int per_block = kBinPoints * kThreads;
  const dim3 grid((unsigned)std::max(1, (a.p + per_block - 1) / per_block),
                  v);
  const size_t hist = b.n * sizeof(int);
  cudaError_t e =
      cudaMemsetAsync(b.count, 0, (b.bins + 1) * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  bin_points<false><<<grid, kThreads, hist, stream>>>(a, b, v, grad_map);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bin_points<true><<<grid, kThreads, hist, stream>>>(a, b, v, grad_map);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int warps = (a.c + 31) / 32;
  accumulate_tiles<<<(unsigned)(b.bins + most), dim3(32, b.subsets * warps),
                     smem, stream>>>(a, b, grad_out, grad_map);
  return (int)cudaGetLastError();
}

// The route the wrapper chose: n elements a lane load, vec: as one 8- or
// 16-byte vector, else n = 1. An inconsistent route is refused, never
// run.
template <typename T>
int dispatch(const Args& a, int v, int n, int vec, cudaStream_t s) {
  if (vec) {
    const int bytes = n * (int)sizeof(T);
    if ((bytes != 8 && bytes != 16) || a.c % n != 0 ||
        ((uintptr_t)a.map & (bytes - 1)) != 0)
      return (int)cudaErrorInvalidValue;
    if (bytes == 16) return run<T, 16 / sizeof(T), true>(a, v, s);
    return run<T, 8 / sizeof(T), true>(a, v, s);
  }
  if (n == 1) return run<T, 1, false>(a, v, s);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* map, const void* coords, const void* mask,
               const void* scale, const void* offset, void* out, int p,
               int fh, int fw, int c, int frame, int h, int w) {
  Args a;
  a.map = map;
  a.coords = static_cast<const float*>(coords);
  a.mask = static_cast<const float*>(mask);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.out = out;
  a.p = p;
  a.fh = fh;
  a.fw = fw;
  a.c = c;
  a.frame = frame;
  a.hm1 = (float)(h - 1);
  a.wm1 = (float)(w - 1);
  a.rh = 1.0f / a.hm1;
  a.rw = 1.0f / a.wm1;
  a.xy_vec = ((uintptr_t)coords & 7) == 0;
  return a;
}

template <typename T>
int entry(const void* map, const void* coords, const void* mask,
          const void* scale, const void* offset, void* out, int v, int p,
          int fh, int fw, int c, int frame, int h, int w, int n, int vec,
          void* stream) {
  if (v == 0 || p == 0 || c == 0) return 0;
  const Args a = make_args(map, coords, mask, scale, offset, out, p, fh, fw,
                           c, frame, h, w);
  return dispatch<T>(a, v, n, vec, (cudaStream_t)stream);
}

// The backward: a lane a channel, so grad_out needs no alignment; the
// gradient is stored 16 bytes at a time where c allows. No points (p = 0)
// still writes the zero gradient.
int backward_entry(const void* grad_out, const void* coords, const void* mask,
                   void* grad_map, void* scratch, int v, int p, int fh,
                   int fw, int c, int frame, int h, int w, void* stream) {
  if (v == 0 || c == 0) return 0;
  if (((uintptr_t)grad_map & 15) != 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(nullptr, coords, mask, nullptr, nullptr, nullptr,
                           p, fh, fw, c, frame, h, w);
  return run_backward(a, v, static_cast<int*>(scratch),
                      static_cast<const float*>(grad_out),
                      static_cast<float*>(grad_map), (cudaStream_t)stream);
}

}  // namespace

// map [v, fh, fw, c] contiguous (fh, fw >= 2); coords [v, p, 2] f32
// contiguous: (x, y) map pixels when frame is 0, else points of an
// (h, w) frame converted as feature_pixel_coords does with align_corners
// (frame 1) or without (frame 2); mask [v, p] f32 or null; scale, offset
// [c] f32 (u8 only, else null); out [v, p, c] in the map's dtype (u8:
// bf16). n, vec: the route (above). v <= 65535. Launches on ``stream``
// without synchronizing and returns cudaGetLastError() of the launch (0 on
// success).
#define GATHER_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* map, const void* coords, const void* mask, \
                      const void* scale, const void* offset, void* out,      \
                      int v, int p, int fh, int fw, int c, int frame, int h, \
                      int w, int n, int vec, void* stream) {                 \
    return entry<T>(map, coords, mask, scale, offset, out, v, p, fh, fw, c,  \
                    frame, h, w, n, vec, stream);                            \
  }

GATHER_ENTRY(gather_border_f32, float)
GATHER_ENTRY(gather_border_bf16, __nv_bfloat16)
GATHER_ENTRY(gather_border_u8, uint8_t)

// The f32 map's gradient: grad_map [v, fh, fw, c] f32 (16-byte aligned),
// every element written (the caller need not zero it), gets grad_out
// [v, p, c] f32 times mask [v, p] (or 1 when null) times each tap's weight
// summed at the four taps of each point; coords, frame, h, w as for the
// forward; scratch: gather_border_f32_backward_scratch() int32. A memset
// and three launches on ``stream``; returns the first error of them (0 on
// success), cudaErrorInvalidValue for shapes the scratch entry refuses.
extern "C" int gather_border_f32_backward(
    const void* grad_out, const void* coords, const void* mask,
    void* grad_map, void* scratch, int v, int p, int fh, int fw, int c,
    int frame, int h, int w, void* stream) {
  return backward_entry(grad_out, coords, mask, grad_map, scratch, v, p, fh,
                        fw, c, frame, h, w, stream);
}

// The int32s of scratch gather_border_f32_backward needs for these shapes,
// or -1 when it does not take them (more than 256 channels, more than 12288
// 8x8 tiles a view, a map of 32768 rows or 65536 columns, or more than
// ~5e8 points in all).
extern "C" int64_t gather_border_f32_backward_scratch(int v, int p, int fh,
                                                      int fw, int c) {
  if (!backward_takes(v, p, fh, fw, c)) return -1;
  Tiles b;
  return backward_layout(v, p, fh, fw, nullptr, b);
}
