// Border-clamped bilinear gather at feature-map pixel coordinates, for
// sm_90a (NVIDIA Hopper). Built by nvcc into a shared library with a
// plain C interface and loaded with ctypes (neuray_tpu_torch/ops/gather.py).
//
// Replaces the Pallas TPU kernel neuray_tpu/ops/pallas/gather.py:85
// gather_bilinear_border (body _gather_kernel at :37). Same result:
// clamp (ix, iy) to [0, size-1], anchor x0 in [0, fw-2] and y0 in
// [0, fh-2], t = clamped - anchor in [0, 1], lerp along x, then y.
// The TPU kernel's 16-wide aligned window, one-hot column selection,
// 8-point stores and channel chunking were VMEM/sublane constraints and
// are not carried over.
//
// Cost: bound by memory traffic. Per (view, point) it reads 4 taps of
// c channels (4*c*4 B in f32), 8 B of coords, and writes c*4 B, for
// three lerps per channel (~0.3 flop/B). At the render's 64-channel map
// (8 x 200 x 200 x 64 x 4 B = 82 MB) the map exceeds the 50 MB L2, and
// the taps of neighbouring points land on neighbouring rows, so
// locality (point ordering, tiling the map in shared memory) is the
// lever for a later version. This first version is simple: one thread
// per (view, point, channel), so the threads of a warp read one
// point's channels from contiguous addresses; 64-bit offsets, since
// v*p*c reaches 1.6e8 at the scene encode; f32 accumulation; output
// stored in the map's dtype (f32 or bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The clamp and anchor of element i = (view, point, channel): the
// offset of its top-left tap in the map and the lerp weights tx, ty.
struct Tap {
  int64_t offset;
  int ch;
  float tx, ty;
};

__device__ __forceinline__ Tap locate(const float* __restrict__ coords,
                                      int64_t i, int64_t p, int fh, int fw,
                                      int c) {
  const int64_t pt = i / c;  // flat (view, point)
  const int ch = (int)(i - pt * c);
  const int64_t view = pt / p;
  const float ix = __ldg(coords + 2 * pt);
  const float iy = __ldg(coords + 2 * pt + 1);
  const float ixc = fminf(fmaxf(ix, 0.0f), fw - 1.0f);
  const float iyc = fminf(fmaxf(iy, 0.0f), fh - 1.0f);
  const float x0 = fminf(fmaxf(floorf(ixc), 0.0f), fw - 2.0f);
  const float y0 = fminf(fmaxf(floorf(iyc), 0.0f), fh - 2.0f);
  const int64_t row = (view * fh + (int64_t)y0) * fw + (int64_t)x0;
  return {row * c + ch, ch, ixc - x0, iyc - y0};
}

template <typename T>
__global__ void gather_bilinear_border_kernel(
    const T* __restrict__ feats, const float* __restrict__ coords,
    T* __restrict__ out, int64_t p, int64_t total, int fh, int fw, int c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const Tap t = locate(coords, i, p, fh, fw, c);
    const T* t00 = feats + t.offset;
    const T* t10 = t00 + (int64_t)fw * c;
    const float f00 = load_f32(t00), f01 = load_f32(t00 + c);
    const float f10 = load_f32(t10), f11 = load_f32(t10 + c);
    const float top = f00 * (1.0f - t.tx) + f01 * t.tx;
    const float bot = f10 * (1.0f - t.tx) + f11 * t.tx;
    store(out + i, top * (1.0f - t.ty) + bot * t.ty);
  }
}

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, t)), __fmul_rn(b, t));
}

__global__ void gather_bilinear_border_u8_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ coords,
    const float* __restrict__ scale, const float* __restrict__ offset,
    __nv_bfloat16* __restrict__ out, int64_t p, int64_t total, int fh,
    int fw, int c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const Tap t = locate(coords, i, p, fh, fw, c);
    const uint8_t* t00 = codes + t.offset;
    const uint8_t* t10 = t00 + (int64_t)fw * c;
    const float top = lerp_rn(__ldg(t00), __ldg(t00 + c), t.tx);
    const float bot = lerp_rn(__ldg(t10), __ldg(t10 + c), t.tx);
    const float code = lerp_rn(top, bot, t.ty);
    out[i] = __float2bfloat16(
        __fsub_rn(__fmul_rn(code, __ldg(scale + t.ch)), __ldg(offset + t.ch)));
  }
}

// 256 threads a block; a grid-stride loop covers what 132 SMs x 16
// blocks do not
int grid_for(int64_t total) {
  const int64_t blocks = (total + 255) / 256;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
int launch(const void* feats, const void* coords, void* out, int64_t v,
           int64_t p, int fh, int fw, int c, void* stream) {
  const int64_t total = v * p * c;
  if (total == 0) return 0;
  gather_bilinear_border_kernel<T><<<grid_for(total), 256, 0,
                                     (cudaStream_t)stream>>>(
      (const T*)feats, (const float*)coords, (T*)out, p, total, fh, fw, c);
  return (int)cudaGetLastError();
}

}  // namespace

// feats [v, fh, fw, c] contiguous; coords [v, p, 2] f32 contiguous
// (x, y feature-map pixels); out [v, p, c]. Requires fh >= 2, fw >= 2
// (checked by the caller). Launches on ``stream`` without synchronizing
// and returns cudaGetLastError() of the launch (0 on success).
extern "C" int gather_bilinear_border_f32(const void* feats,
                                          const void* coords, void* out,
                                          int64_t v, int64_t p, int fh,
                                          int fw, int c, void* stream) {
  return launch<float>(feats, coords, out, v, p, fh, fw, c, stream);
}

extern "C" int gather_bilinear_border_bf16(const void* feats,
                                           const void* coords, void* out,
                                           int64_t v, int64_t p, int fh,
                                           int fw, int c, void* stream) {
  return launch<__nv_bfloat16>(feats, coords, out, v, p, fh, fw, c, stream);
}

// codes [v, fh, fw, c] u8 contiguous; coords [v, p, 2] f32 contiguous;
// scale, offset [c] f32; out [v, p, c] bf16. As above otherwise.
extern "C" int gather_bilinear_border_u8(const void* codes,
                                         const void* coords,
                                         const void* scale,
                                         const void* offset, void* out,
                                         int64_t v, int64_t p, int fh,
                                         int fw, int c, void* stream) {
  const int64_t total = v * p * c;
  if (total == 0) return 0;
  gather_bilinear_border_u8_kernel<<<grid_for(total), 256, 0,
                                     (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const float*)coords, (const float*)scale,
      (const float*)offset, (__nv_bfloat16*)out, p, total, fh, fw, c);
  return (int)cudaGetLastError();
}
