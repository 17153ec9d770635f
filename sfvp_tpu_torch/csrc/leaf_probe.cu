// P2 and P5: the cost of reading a popped leaf row, directly or staged in
// shared memory by cp.async.
//
// P2 replaces benchmarks/micro_leaf_cost.py, main -> make(mode) (pallas_call
// at :98): one serial loop of ``iters`` iterations over an (nr, 128) float32
// table; each iteration picks row rnd mod nr (an int32 LCG: rnd * 1103515245
// + 12345, wrapping, then rem(|rnd|, 2^30) truncating, |INT_MIN| staying
// INT_MIN), sums 128 floats in one serial chain of 127 adds and adds the
// sum into the accumulator. One template mode per Pallas mode:
//   base     - the chain over constants (acc + c, c = 0..127), no loads;
//   extract  - the row read through __ldg (the TPU's dynamic VMEM row
//              load and 128 lane extracts): the leaf pop of K3, K5, K6, K9;
//   smemdma  - the row copied into shared memory by cp.async (32 copies of
//              16 bytes), a wait, then 128 shared loads (the TPU's
//              VMEM->SMEM DMA and scalar loads);
//   smemload - 128 shared loads of row rnd mod 2 of a buffer filled once
//              with the table's rows 0 and 1 before the loop (the
//              ring-hidden ideal; the TPU's reads an unset scratch);
//   dmaonly  - the copy and its wait, then the chain over constants.
// P5 replaces benchmarks/micro_smem_dma.py, main (pallas_call at :38): row
// 1 of a (16, 128) table into shared memory by cp.async, then the sum of
// its elements 0, 16, ..., 112.
//
// Both write their accumulator into every element of an (8, 128) output,
// the TPU probes' output shape. Built with -fmad=false, the adds in the
// twin's order (kernels/leafprobe.py), so kernel and twin agree bit for
// bit.
//
// What bounds it on an H100: latency. A serial chain is one thread's: one
// thread in one block, every load of a row on the chain of the next add,
// so the time per iteration is the latency of a row read (L2 or L1 for
// extract, cp.async's round trip for smemdma) plus 127 dependent adds; the
// bytes bound (iters x 512 B over 3.35 TB/s) is far below it. What the
// design does about it: nothing, on purpose: the probe measures that
// latency, the per-pop number a leaf prefetch ring in K5 or K6 would hide.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One row of 128 floats into shared memory: 32 copies of 16 bytes, then
// the wait.
__device__ __forceinline__ void copy_row(float* dst, const float* row) {
#pragma unroll
  for (int c = 0; c < kLanes; c += 4) cp_async16(dst + c, row + c);
  cp_async_wait_all();
}

// The int32 LCG of the TPU probe: wrap, |.| (INT_MIN stays), rem 2^30.
__device__ __forceinline__ int lcg(int rnd) {
  const int w = static_cast<int>(static_cast<unsigned>(rnd) * 1103515245u +
                                 12345u);
  const int a = w < 0 ? static_cast<int>(0u - static_cast<unsigned>(w)) : w;
  return a % (1 << 30);
}

enum Mode { kBase = 0, kExtract = 1, kSmemDma = 2, kSmemLoad = 3,
            kDmaOnly = 4 };

template <int MODE>
__global__ void leaf_probe_kernel(const float* __restrict__ table, int nr,
                                  int iters, float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][kLanes];
  if (MODE == kSmemLoad) {
    for (int c = 0; c < kLanes; ++c) {
      buf[0][c] = table[c];
      buf[1][c] = table[kLanes + c];
    }
  }
  int rnd = 1;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float* row = table + static_cast<size_t>(rnd % nr) * kLanes;
    float s;
    if (MODE == kExtract) {
      s = __ldg(row);
#pragma unroll
      for (int c = 1; c < kLanes; ++c) s = s + __ldg(row + c);
    } else if (MODE == kSmemDma || MODE == kSmemLoad) {
      if (MODE == kSmemDma) copy_row(buf[0], row);
      const float* b = buf[MODE == kSmemDma ? 0 : (rnd % 2)];
      s = b[0];
#pragma unroll
      for (int c = 1; c < kLanes; ++c) s = s + b[c];
    } else {
      if (MODE == kDmaOnly) copy_row(buf[0], row);
      s = acc + 0.0f;
#pragma unroll
      for (int c = 1; c < kLanes; ++c) s = s + (acc + static_cast<float>(c));
    }
    rnd = lcg(rnd);
    acc = acc + s;
  }
  for (int j = 0; j < 8 * kLanes; ++j) out[j] = acc;
}

// P5: row 1 of a (16, 128) table by cp.async, the sum of every 16th
// element.
__global__ void smem_dma_kernel(const float* __restrict__ x,
                                float* __restrict__ out) {
  __shared__ __align__(16) float buf[kLanes];
  copy_row(buf, x + kLanes);
  float acc = 0.0f;
  for (int i = 0; i < 8; ++i) acc = acc + buf[16 * i];
  for (int j = 0; j < 8 * kLanes; ++j) out[j] = acc;
}

template <int MODE>
int launch(const float* table, int nr, int iters, float* out,
           cudaStream_t st) {
  leaf_probe_kernel<MODE><<<1, 1, 0, st>>>(table, nr, iters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P2: ``mode`` 0 base, 1 extract, 2 smemdma, 3 smemload, 4 dmaonly over
// the (nr, 128) ``table``; out (8, 128). Returns cudaGetLastError() of the
// launch on ``stream``.
extern "C" int sfvp_leaf_probe(const float* table, int nr, int iters,
                               int mode, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBase: return launch<kBase>(table, nr, iters, out, st);
    case kExtract: return launch<kExtract>(table, nr, iters, out, st);
    case kSmemDma: return launch<kSmemDma>(table, nr, iters, out, st);
    case kSmemLoad: return launch<kSmemLoad>(table, nr, iters, out, st);
    case kDmaOnly: return launch<kDmaOnly>(table, nr, iters, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// P5: x (16, 128), out (8, 128).
extern "C" int sfvp_smem_dma(const float* x, float* out, void* stream) {
  smem_dma_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return static_cast<int>(cudaGetLastError());
}
