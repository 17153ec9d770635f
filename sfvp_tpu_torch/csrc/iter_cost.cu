// P6: ns per iteration of the parts of a traversal walk's loop, one
// variant a template instance.
//
// Replaces benchmarks/probe_iter_cost.py, main -> build(variant) (kernel
// body :41-140, pallas_call at :142): a while loop of ``iters`` iterations
// over an (8, 128) float32 state, each popping a counter, reading a row of
// an (8M, 128) table and doing one of ten bodies (v0-v9 below). On the TPU
// it priced the steps of the K3 packet walk's iteration; here the same
// steps are those of K6's (packet_trace2.cu) and P1's
// (stripped_trace.cu) iteration.
//
// One block of 1024 threads, one element (r, l) = (tid / 128, tid % 128)
// of the state a thread. Scalar state belongs to thread 0 in shared
// memory, and a barrier publishes it, as K6's thread-0 turn does: the pop
// of the counter (``sp``, from ``iters`` down), v7's conditional stores
// and v8's network over row[0:8] and row[8:16]. So v7 and v8 measure
// K6's turn: thread 0 works while 1023 threads wait at the barrier. The
// popped value is double-buffered (iteration k reads slot k & 1), so one
// barrier an iteration publishes it. The row is idx = max(i % M, 0) of
// the popped i (v4: rows 8 idx .. 8 idx + 7), read by every thread (one
// broadcast load a warp).
//
// The bodies, each add in the probe's order (-fmad=false):
//   v0 loop       acc += row[l]
//   v1 scalars48  acc += the serial sum of row[0..47] (every thread)
//   v2 scalars128 acc += the serial sum of row[0..127]
//   v3 bcast      t = 0; t = t + row[c] * acc for c < 48; acc = t
//   v4 rowslice8  the slab test of K3's 8-rows-a-node layout on the rays:
//                 a block max of acc, per row a min and a sum over 128
//                 lanes
//   v5 cond       acc + 2 row[l] or acc - 3 row[l] by the parity of i
//   v6 reduce16   8 x (a block min of the lanes that "hit", a block any)
//   v7 when8      thread 0's 8 conditional stores and count (a push)
//   v8 sortnet    thread 0's 19-comparator network over 8 keys, 8 codes
//   v9            per row, a min and a max over 128 lanes (the probe's
//                 tenth branch, which its main never runs)
// Reductions are warp shuffles, a shared partial a warp and a barrier,
// with jnp's semantics: a max or min is NaN if an input is. The partials
// alternate between two buffers, so that a buffer is written again only
// after another barrier.
//
// ``rays`` (v4) is the output buffer read before it is written
// (probe_iter_cost.py:44, unset on the TPU): here it is defined as the
// zeros the wrapper fills it with, as the twin's.
//
// v6-v9 are not the probe's body as it runs: it binds ``row`` only for
// v0-v3 and v5 (probe_iter_cost.py:54), so v6, v7 and v8 raise when traced
// (its main reports them as failed) and the TPU never measured them. The
// port reads row idx for them as v0 does, which is what their bodies use.
//
// What bounds it on an H100: the serial chain of dependent iterations (a
// latency probe, one block). chip_smoke.py's bound is the larger of the
// FP32 operations the function needs and the bytes it reads: the lanes
// each body reads (v0, v2, v5, v6, v9: 128; v1, v3: 48; v4: 6 of 8 rows;
// v7: 8; v8: 16) of the distinct rows the run pops, over 3.35 TB/s.
#include <cuda_runtime.h>

namespace sfvp {

constexpr int kIterThreads = 1024;
constexpr int kIterLanes = 128;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

struct IterShared {
  int sp[2];            // [0] the pop counter, [1] v7's store target
  int popped[2];        // the i of iteration k: popped[k & 1]
  float scal[2][2];     // v7's count, v8's two sums, published alike
  float part[2][2][32]; // reduction partials: buffer, quantity, warp
};

// A block reduction of ``x`` (MAX: nan_max, else nan_min) into every
// thread, with the partials in buffer ``buf``.
template <bool MAX>
__device__ __forceinline__ float block_reduce(IterShared& s, float x,
                                              int buf) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? nan_max(x, y) : nan_min(x, y);
  }
  if ((tid & 31) == 0) s.part[buf][0][tid >> 5] = x;
  __syncthreads();
  float r = s.part[buf][0][0];
  for (int w = 1; w < 32; ++w) {
    r = MAX ? nan_max(r, s.part[buf][0][w]) : nan_min(r, s.part[buf][0][w]);
  }
  return r;
}

// Per row of the (8, 128) state (4 warps a row): the nan_min of ``a``
// (MAXB: the nan_max of b, else the sum of b, integers) into every thread
// of the row, with the partials in buffer ``buf``.
template <bool MAXB>
__device__ __forceinline__ void row_reduce(IterShared& s, float& a, float& b,
                                           int buf) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ya = __shfl_xor_sync(0xffffffffu, a, o);
    const float yb = __shfl_xor_sync(0xffffffffu, b, o);
    a = nan_min(a, ya);
    b = MAXB ? nan_max(b, yb) : b + yb;  // sums of 0/1: exact
  }
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    s.part[buf][0][warp] = a;
    s.part[buf][1][warp] = b;
  }
  __syncthreads();
  const int w0 = warp & ~3;
  a = s.part[buf][0][w0];
  b = s.part[buf][1][w0];
  for (int w = w0 + 1; w < w0 + 4; ++w) {
    a = nan_min(a, s.part[buf][0][w]);
    b = MAXB ? nan_max(b, s.part[buf][1][w]) : b + s.part[buf][1][w];
  }
}

template <int V>
__global__ void __launch_bounds__(kIterThreads, 1)
iter_cost_kernel(const float* __restrict__ table, int m, int iters,
                 const float* __restrict__ acc0, float* __restrict__ out) {
  __shared__ IterShared s;
  const int tid = threadIdx.x;
  const int r = tid / kIterLanes, l = tid % kIterLanes;
  const float rays = out[tid];  // the unset output: zeros (see above)
  float acc = acc0[tid];
  const float inf = __int_as_float(0x7f800000);
  if (tid == 0) s.sp[0] = iters;
  __syncthreads();
  int buf = 0;
  for (int it = iters, k = 0; it > 0; --it, ++k) {
    if (tid == 0) {
      const int i = s.sp[0];
      s.sp[0] = i - 1;
      s.popped[k & 1] = i;
      const float* row = table + (size_t)max(i % m, 0) * kIterLanes;
      if (V == 7) {
        int spn = i % 100;
        for (int c = 0; c < 8; ++c) {
          const bool d = row[c] > 0.0f;
          if (d) s.sp[1] = c;
          spn += (int)d;
        }
        s.scal[k & 1][0] = (float)spn;
      } else if (V == 8) {
        float key[8], code[8];
        for (int c = 0; c < 8; ++c) {
          key[c] = row[c];
          code[c] = row[8 + c];
        }
#define SFVP_P6_SWAP(a, b)                                  \
  {                                                         \
    const bool sw = key[a] < key[b];                        \
    const float ka = sw ? key[b] : key[a];                  \
    const float kb = sw ? key[a] : key[b];                  \
    const float ca = sw ? code[b] : code[a];                \
    const float cb = sw ? code[a] : code[b];                \
    key[a] = ka;                                            \
    key[b] = kb;                                            \
    code[a] = ca;                                           \
    code[b] = cb;                                           \
  }
        SFVP_P6_SWAP(0, 1) SFVP_P6_SWAP(2, 3) SFVP_P6_SWAP(4, 5)
        SFVP_P6_SWAP(6, 7) SFVP_P6_SWAP(0, 2) SFVP_P6_SWAP(1, 3)
        SFVP_P6_SWAP(4, 6) SFVP_P6_SWAP(5, 7) SFVP_P6_SWAP(1, 2)
        SFVP_P6_SWAP(5, 6) SFVP_P6_SWAP(0, 4) SFVP_P6_SWAP(3, 7)
        SFVP_P6_SWAP(1, 5) SFVP_P6_SWAP(2, 6) SFVP_P6_SWAP(1, 4)
        SFVP_P6_SWAP(3, 6) SFVP_P6_SWAP(2, 4) SFVP_P6_SWAP(3, 5)
        SFVP_P6_SWAP(3, 4)
#undef SFVP_P6_SWAP
        // Python's sum: 0 + k0 + k1 + ... in order
        float sk = 0.0f, sc = 0.0f;
        for (int c = 0; c < 8; ++c) sk = sk + key[c];
        for (int c = 0; c < 8; ++c) sc = sc + code[c];
        s.scal[k & 1][0] = sk;
        s.scal[k & 1][1] = sc;
      }
    }
    __syncthreads();
    const int i = s.popped[k & 1];
    const int idx = max(i % m, 0);
    const float* row = table + (size_t)idx * kIterLanes;
    if (V == 0) {
      acc = acc + __ldg(row + l);
    } else if (V == 1 || V == 2) {
      float sum = 0.0f;
      for (int c = 0; c < (V == 1 ? 48 : 128); ++c) sum = sum + __ldg(row + c);
      acc = acc + sum;
    } else if (V == 3) {
      float t = 0.0f;
      for (int c = 0; c < 48; ++c) t = t + __ldg(row + c) * acc;
      acc = t;
    } else if (V == 4) {
      const float* nb = table + ((size_t)idx * 8 + r) * kIterLanes;
      const float lim = block_reduce<true>(s, acc, buf);
      buf ^= 1;
      float tn = -inf, tf = inf;
      for (int f = 0; f < 6; f += 2) {
        const float t0 = (__ldg(nb + f) - rays) * rays;
        const float t1 = (__ldg(nb + f + 1) - rays) * rays;
        tn = nan_max(tn, nan_min(t0, t1));
        tf = nan_min(tf, nan_max(nan_max(t0, t1), lim));
      }
      const bool hit = tn <= tf;
      float key = hit ? tn : inf, anyh = hit ? 1.0f : 0.0f;
      row_reduce<false>(s, key, anyh, buf);
      buf ^= 1;
      acc = acc + key + anyh;
    } else if (V == 5) {
      acc = i % 2 == 0 ? acc + __ldg(row + l) * 2.0f
                       : acc - __ldg(row + l) * 3.0f;
    } else if (V == 6) {
      const bool hit = __ldg(row + l) * acc > 0.0f;
      float sum = 0.0f;
      for (int c = 0; c < 8; ++c) {
        const float mn = block_reduce<false>(s, hit ? acc : inf, buf);
        buf ^= 1;
        sum = sum + mn;
        sum = sum + (__syncthreads_or(hit) ? 1.0f : 0.0f);
      }
      acc = acc + sum;
    } else if (V == 7) {
      acc = acc + s.scal[k & 1][0];
    } else if (V == 8) {
      acc = acc + s.scal[k & 1][0] + s.scal[k & 1][1];
    } else if (V == 9) {
      const bool hit = __ldg(row + l) * acc > 0.0f;
      float key = hit ? acc : inf, anyh = hit ? 1.0f : 0.0f;
      row_reduce<true>(s, key, anyh, buf);
      buf ^= 1;
      acc = acc + key + anyh;
    }
  }
  out[tid] = acc;
}

template <int V>
int launch_iter_cost(const float* table, int m, int iters, const float* acc0,
                     float* out, cudaStream_t stream) {
  iter_cost_kernel<V><<<1, kIterThreads, 0, stream>>>(table, m, iters, acc0,
                                                      out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sfvp

// table: (8 m, 128) float32; acc0: the (8, 128) initial state; out: (8,
// 128), zeros on entry (v4 reads it as its rays); variant 0-9
// (kernels/itercost.py VARIANTS). Returns cudaGetLastError() of the launch
// on ``stream``, or cudaErrorInvalidValue for an unknown variant.
extern "C" int sfvp_iter_cost(const float* table, int m, int iters,
                              int variant, const float* acc0, float* out,
                              void* stream) {
  using namespace sfvp;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_iter_cost<0>(table, m, iters, acc0, out, st);
    case 1: return launch_iter_cost<1>(table, m, iters, acc0, out, st);
    case 2: return launch_iter_cost<2>(table, m, iters, acc0, out, st);
    case 3: return launch_iter_cost<3>(table, m, iters, acc0, out, st);
    case 4: return launch_iter_cost<4>(table, m, iters, acc0, out, st);
    case 5: return launch_iter_cost<5>(table, m, iters, acc0, out, st);
    case 6: return launch_iter_cost<6>(table, m, iters, acc0, out, st);
    case 7: return launch_iter_cost<7>(table, m, iters, acc0, out, st);
    case 8: return launch_iter_cost<8>(table, m, iters, acc0, out, st);
    case 9: return launch_iter_cost<9>(table, m, iters, acc0, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
