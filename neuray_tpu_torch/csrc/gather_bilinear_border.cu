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
// point) adds grad_out * mask * w_tap to the four taps it read, with the
// forward's prologue (locate), so the taps and weights are the forward's
// bit for bit, and every product rounded on its own, as the plain version
// (ops/gather.py: gather_bilinear_border_backward_ref) forms it. The same
// lane groups read grad_out in 16-byte loads and add with sm_90's 16-byte
// vector atomics (red.global.add.v4.f32) into the zeroed map. Bound by
// bytes in principle (grad_out once, the touched map pixels once); the
// atomics sum in another order on every run, and where many points share
// a tap (a training chunk lands ~17 taps on each touched pixel) they queue
// in L2.

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

struct Point {
  int64_t tap;  // element offset of the top-left tap
  float tx, ty, m;
};

// point i (flat over views): its top-left tap, lerp weights and mask
__device__ __forceinline__ Point locate(const Args& a, int64_t map_view,
                                        int64_t i) {
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
  Point pt;
  pt.tap = map_view + (int64_t)((int)y0 * a.fw + (int)x0) * a.c;
  pt.tx = ix - x0;
  pt.ty = iy - y0;
  pt.m = a.mask ? __ldg(a.mask + i) : 1.0f;
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

// N values added to p: one 16-byte (N = 4) or 8-byte (N = 2) vector
// atomic, else N scalar ones
template <int N>
__device__ __forceinline__ void add_tap(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (N == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) atomicAdd(p + i, v[i]);
  }
}

// The backward of gather_lanes<float, N, VEC> (a.map and a.out unused):
// the same blocks, lanes and points; each lane reads N channels of its
// points' grad_out and adds them, weighted, to the four taps.
template <int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    scatter_lanes(const Args a, const float* __restrict__ grad_out,
                  float* __restrict__ grad_map) {
  const int lanes = a.c / N;
  const int slots = blockDim.y;
  const int per_block = slots * kPoints;
  const int64_t first = (int64_t)blockIdx.y * a.p;
  const int64_t map_view = (int64_t)blockIdx.y * a.fh * a.fw * a.c;
  const int64_t row = (int64_t)a.fw * a.c;
  const bool masked = a.mask != nullptr;
  for (int k = threadIdx.x; k < lanes; k += blockDim.x) {
    const int ch = k * N;
    for (int base = blockIdx.x * per_block; base < a.p;
         base += gridDim.x * per_block) {
      Point pts[kPoints];
      Tap<float, N, VEC> g[kPoints];
#pragma unroll
      for (int j = 0; j < kPoints; ++j) {
        const int q = min(base + (int)threadIdx.y + j * slots, a.p - 1);
        pts[j] = locate(a, map_view, first + q);
        g[j].load(grad_out + (first + q) * a.c + ch);
      }
#pragma unroll
      for (int j = 0; j < kPoints; ++j) {
        const int q = base + (int)threadIdx.y + j * slots;
        if (q >= a.p) continue;
        const float tx = pts[j].tx, ty = pts[j].ty;
        float t00[N], t01[N], t10[N], t11[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float gm = masked ? __fmul_rn(g[j][i], pts[j].m) : g[j][i];
          const float top = __fmul_rn(gm, 1.0f - ty);
          const float bot = __fmul_rn(gm, ty);
          t00[i] = __fmul_rn(top, 1.0f - tx);
          t01[i] = __fmul_rn(top, tx);
          t10[i] = __fmul_rn(bot, 1.0f - tx);
          t11[i] = __fmul_rn(bot, tx);
        }
        float* t = grad_map + pts[j].tap + ch;
        add_tap<N>(t, t00);
        add_tap<N>(t + a.c, t01);
        add_tap<N>(t + row, t10);
        add_tap<N>(t + row + a.c, t11);
      }
    }
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

template <int N, bool VEC>
int run_backward(const Args& a, int v, const float* grad_out, float* grad_map,
                 cudaStream_t stream) {
  static int resident = 0;
  dim3 grid, block;
  const int e =
      launch_shape(scatter_lanes<N, VEC>, resident, a, v, N, grid, block);
  if (e != 0) return e;
  scatter_lanes<N, VEC><<<grid, block, 0, stream>>>(a, grad_out, grad_map);
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

// The backward's route, checked as dispatch checks the forward's: n
// channels a lane, as 8- or 16-byte vectors of grad_out and grad_map
// (both aligned to them), else one channel a lane.
int backward_entry(const void* grad_out, const void* coords, const void* mask,
                   void* grad_map, int v, int p, int fh, int fw, int c,
                   int frame, int h, int w, int n, int vec, void* stream) {
  if (v == 0 || p == 0 || c == 0) return 0;
  const Args a = make_args(nullptr, coords, mask, nullptr, nullptr, nullptr,
                           p, fh, fw, c, frame, h, w);
  const float* g = static_cast<const float*>(grad_out);
  float* m = static_cast<float*>(grad_map);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    const int bytes = n * 4;
    if ((bytes != 8 && bytes != 16) || c % n != 0 ||
        ((uintptr_t)g & (bytes - 1)) != 0 || ((uintptr_t)m & (bytes - 1)) != 0)
      return (int)cudaErrorInvalidValue;
    if (n == 4) return run_backward<4, true>(a, v, g, m, s);
    return run_backward<2, true>(a, v, g, m, s);
  }
  if (n == 1) return run_backward<1, false>(a, v, g, m, s);
  return (int)cudaErrorInvalidValue;
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

// The f32 map's gradient: grad_map [v, fh, fw, c] f32, zeroed by the
// caller, gets grad_out [v, p, c] f32 times mask [v, p] (or 1 when null)
// times each tap's weight added at the four taps of each point; coords,
// frame, h, w as for the forward; n, vec: the route (backward_entry).
// Launches on ``stream`` and returns cudaGetLastError() of the launch.
extern "C" int gather_border_f32_backward(const void* grad_out,
                                          const void* coords, const void* mask,
                                          void* grad_map, int v, int p, int fh,
                                          int fw, int c, int frame, int h,
                                          int w, int n, int vec, void* stream) {
  return backward_entry(grad_out, coords, mask, grad_map, v, p, fh, fw, c,
                        frame, h, w, n, vec, stream);
}
