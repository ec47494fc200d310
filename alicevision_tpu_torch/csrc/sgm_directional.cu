// One forward SGM directional sweep on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel alicevision_tpu/ops/sgm_pallas.py
// (sgm_directional_pass, body _sgm_kernel_const). Computes, over a cost
// volume C of shape (S, N, D) (D innermost, contiguous) with a per-position
// P2 of shape (S, N) and a constant P1:
//
//   L_0 = C_0
//   L_s = (C_s + min(L_{s-1}, min(L_{s-1}[d-1], L_{s-1}[d+1]) + P1,
//                    min_d L_{s-1} + P2[s])) - min_d L_{s-1}      (s >= 1)
//
// with the d-neighbours edge-replicated (d = 0 and d = D-1 use their own
// value), the arithmetic order of the plain version in
// alicevision_tpu_torch/mvs/plane_sweep.py::_directional_pass, so the two
// agree bit for bit.
//
// What bounds it on an H100: bytes. Each cost value is read once, each
// result written once, and P2 read once: (2*S*N*D + S*N) * 4 bytes against
// about 7 float operations per element. On the dense path's 640x480 maps
// with D = 256 the two launches per depth map are (640, 960, 256) and
// (480, 1280, 256), about 1.26 GB each, about 0.38 ms at 3.35 TB/s.
//
// Design (simple first): one warp owns one row n for the whole sweep; the
// loop over s runs inside the kernel. Two variants, chosen by D:
//
// * D <= 512: the carry L_{s-1} stays in registers. D is spread over the 32
//   lanes in chunks of 128: lane l holds d = 128 k + 4 l + j (j = 0..3) of
//   chunk k (1 to 4 chunks), so each chunk is one coalesced 512-byte read or
//   write (float4 per lane when D % 4 == 0). min_d is a warp-shuffle
//   reduction; the neighbours d +- 1 come from the lane's own registers plus
//   one shuffle at each 4-value border and one at the chunk border. Lanes
//   past D hold +inf, so they never win the min. The next row's cost and P2
//   are loaded before the current step's reduction.
// * D > 512 (the reference's default is 1500 planes): the carry lives in
//   shared memory, two rows a warp (the previous and the next, swapped each
//   step; 12 KB a warp at D = 1500), walked in the same 128-wide chunks.
//   min_d of the new row is taken while it is written, so each step reads
//   the carry once. Up to kMaxD = 29056 (two rows a warp in 227 KB).
//
// Both keep the arithmetic order (C + best) - m of the plain version, so
// they agree with it bit for bit.
//
// What holds this design back: the serial chain of S dependent steps, and
// only N warps in flight (N = 960 or 1280 at the slice's shapes, about 7-10
// warps per SM), which is too little memory-level parallelism to reach the
// bandwidth bound. Several rows per warp, a deeper prefetch (cp.async) and
// folding the flips and concatenations of sgm_aggregate into the indexing
// are for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kChunk = 4 * kWarp;  // D values per chunk
constexpr unsigned kFull = 0xffffffffu;

template <int CHUNKS, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int D, int lane,
                                         float (&v)[CHUNKS][4]) {
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int d0 = k * kChunk + 4 * lane;
    if (VEC) {
      if (d0 < D) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(row + d0));
        v[k][0] = x.x;
        v[k][1] = x.y;
        v[k][2] = x.z;
        v[k][3] = x.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k][j] = __int_as_float(0x7f800000);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[k][j] = (d0 + j < D) ? __ldg(row + d0 + j) : __int_as_float(0x7f800000);
    }
  }
}

template <int CHUNKS, bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ row, int D, int lane,
                                          const float (&v)[CHUNKS][4]) {
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int d0 = k * kChunk + 4 * lane;
    if (VEC) {
      if (d0 < D)
        *reinterpret_cast<float4*>(row + d0) = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (d0 + j < D) row[d0 + j] = v[k][j];
    }
  }
}

template <int CHUNKS, bool VEC>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
    sgm_directional_kernel(const float* __restrict__ cost, const float* __restrict__ p2,
                           float* __restrict__ out, int S, int N, int D, float p1) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (n >= N) return;  // whole warps leave together

  const size_t step = static_cast<size_t>(N) * D;  // elements per s
  const float* c_row = cost + static_cast<size_t>(n) * D;
  float* o_row = out + static_cast<size_t>(n) * D;
  const float inf = __int_as_float(0x7f800000);

  float L[CHUNKS][4];
  float C[CHUNKS][4];
  load_row<CHUNKS, VEC>(c_row, D, lane, L);
  store_row<CHUNKS, VEC>(o_row, D, lane, L);  // row s = 0 passes through
  float p2_next = 0.f;
  if (S > 1) {
    load_row<CHUNKS, VEC>(c_row + step, D, lane, C);
    p2_next = __ldg(p2 + static_cast<size_t>(N) + n);
  }

  for (int s = 1; s < S; ++s) {
    float Cs[CHUNKS][4];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[k][j] = C[k][j];
    const float p2s = p2_next;
    if (s + 1 < S) {  // issue the next row's loads before this step's math
      load_row<CHUNKS, VEC>(c_row + (s + 1) * step, D, lane, C);
      p2_next = __ldg(p2 + static_cast<size_t>(s + 1) * N + n);
    }

    // m = min_d L_{s-1}
    float m = inf;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) m = fminf(m, L[k][j]);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) m = fminf(m, __shfl_xor_sync(kFull, m, off));

    // neighbours across the 4-value borders of each lane
    float left[CHUNKS], right[CHUNKS];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      left[k] = __shfl_up_sync(kFull, L[k][3], 1);    // d0 - 1 from lane - 1
      right[k] = __shfl_down_sync(kFull, L[k][0], 1);  // d0 + 4 from lane + 1
    }
    // ... and across the chunk borders (lane 0 <-> lane 31 of the chunk before)
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      if (k > 0) {
        const float x = __shfl_sync(kFull, L[k - 1][3], kWarp - 1);
        if (lane == 0) left[k] = x;
      }
      if (k + 1 < CHUNKS) {
        const float y = __shfl_sync(kFull, L[k + 1][0], 0);
        if (lane == kWarp - 1) right[k] = y;
      }
    }

    const float mp2 = m + p2s;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      float nl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = k * kChunk + 4 * lane + j;
        if (d >= D) {
          nl[j] = inf;
          continue;
        }
        const float lp = L[k][j];
        float up = (j > 0) ? L[k][j - 1] : left[k];
        float dn = (j < 3) ? L[k][j + 1] : right[k];
        if (d == 0) up = lp;
        if (d == D - 1) dn = lp;
        const float best = fminf(fminf(lp, fminf(up, dn) + p1), mp2);
        nl[j] = (Cs[k][j] + best) - m;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) L[k][j] = nl[j];
    }
    store_row<CHUNKS, VEC>(o_row + s * step, D, lane, L);
  }
}

constexpr int kMaxRegChunks = 4;          // register path: D <= 512
constexpr int kSmemBudget = 48 * 1024;    // static limit, no opt-in needed
constexpr int kSmemMax = 232448;          // opt-in limit of an H100 block
constexpr int kMaxD = kSmemMax / (2 * 4);  // two carry rows for one warp: 29056

__device__ __forceinline__ float warp_min(float m) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) m = fminf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ row, int D, int d0, float (&v)[4]) {
  if (VEC) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(row + d0));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (d0 + j < D) ? __ldg(row + d0 + j) : __int_as_float(0x7f800000);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ row, int D, int d0, const float (&v)[4]) {
  if (VEC) {
    *reinterpret_cast<float4*>(row + d0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (d0 + j < D) row[d0 + j] = v[j];
  }
}

// The carry in shared memory: Dp = D rounded up to 4 floats a row, two rows
// a warp. Padding slots hold +inf.
template <bool VEC>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
    sgm_directional_smem_kernel(const float* __restrict__ cost, const float* __restrict__ p2,
                                float* __restrict__ out, int S, int N, int D, float p1,
                                int warps_per_block) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int n = blockIdx.x * warps_per_block + warp;
  // whole warps leave together (those past warps_per_block, whose shared
  // rows do not exist, and those past N); no block-wide barrier below
  if (warp >= warps_per_block || n >= N) return;

  const int Dp = (D + 3) & ~3;
  float* cur = reinterpret_cast<float*>(smem4) + static_cast<size_t>(warp) * 2 * Dp;
  float* nxt = cur + Dp;
  const size_t step = static_cast<size_t>(N) * D;
  const float* c_row = cost + static_cast<size_t>(n) * D;
  float* o_row = out + static_cast<size_t>(n) * D;
  const float inf = __int_as_float(0x7f800000);

  // row s = 0 passes through; m = its min
  float m = inf;
  for (int d0 = 4 * lane; d0 < D; d0 += kChunk) {
    float v[4];
    load4<VEC>(c_row, D, d0, v);
    store4<VEC>(o_row, D, d0, v);
    *reinterpret_cast<float4*>(cur + d0) = make_float4(v[0], v[1], v[2], v[3]);
    m = fminf(m, fminf(fminf(v[0], v[1]), fminf(v[2], v[3])));
  }
  m = warp_min(m);
  __syncwarp();

  for (int s = 1; s < S; ++s) {
    const float* c_s = c_row + s * step;
    float* o_s = o_row + s * step;
    const float mp2 = m + __ldg(p2 + static_cast<size_t>(s) * N + n);
    float mn = inf;
    for (int d0 = 4 * lane; d0 < D; d0 += kChunk) {
      float Cs[4];
      load4<VEC>(c_s, D, d0, Cs);
      const float4 l4 = *reinterpret_cast<const float4*>(cur + d0);
      const float Lv[4] = {l4.x, l4.y, l4.z, l4.w};
      const float left = (d0 > 0) ? cur[d0 - 1] : Lv[0];
      const float right = (d0 + 4 < D) ? cur[d0 + 4] : Lv[3];
      float nl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + j;
        if (d >= D) {
          nl[j] = inf;
          continue;
        }
        const float lp = Lv[j];
        float up = (j > 0) ? Lv[j - 1] : left;
        float dn = (j < 3) ? Lv[j + 1] : right;
        if (d == 0) up = lp;
        if (d == D - 1) dn = lp;
        const float best = fminf(fminf(lp, fminf(up, dn) + p1), mp2);
        nl[j] = (Cs[j] + best) - m;
      }
      store4<VEC>(o_s, D, d0, nl);
      *reinterpret_cast<float4*>(nxt + d0) = make_float4(nl[0], nl[1], nl[2], nl[3]);
      mn = fminf(mn, fminf(fminf(nl[0], nl[1]), fminf(nl[2], nl[3])));
    }
    m = warp_min(mn);
    __syncwarp();  // this step's row is complete before the next step reads it
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <int CHUNKS>
void launch(const float* cost, const float* p2, float* out, int S, int N, int D, float p1,
            bool vec, cudaStream_t stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (vec)
    sgm_directional_kernel<CHUNKS, true><<<grid, block, 0, stream>>>(cost, p2, out, S, N, D, p1);
  else
    sgm_directional_kernel<CHUNKS, false><<<grid, block, 0, stream>>>(cost, p2, out, S, N, D, p1);
}

template <bool VEC>
cudaError_t launch_smem(const float* cost, const float* p2, float* out, int S, int N, int D,
                        float p1, cudaStream_t stream) {
  const int per_warp = 2 * ((D + 3) & ~3) * static_cast<int>(sizeof(float));
  int wpb = kSmemBudget / per_warp;
  wpb = wpb < 1 ? 1 : (wpb > kWarpsPerBlock ? kWarpsPerBlock : wpb);
  const int bytes = wpb * per_warp;
  if (bytes > kSmemBudget) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgm_directional_smem_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kWarp * kWarpsPerBlock);  // warps past wpb leave at once
  const dim3 grid((N + wpb - 1) / wpb);
  sgm_directional_smem_kernel<VEC><<<grid, block, bytes, stream>>>(cost, p2, out, S, N, D, p1, wpb);
  return cudaSuccess;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream` without synchronizing and
// returns cudaGetLastError() (0 on success).
extern "C" int sgm_directional_pass_f32(const void* cost, const void* p2, void* out, int S,
                                        int N, int D, float p1, int device, void* stream) {
  if (S < 1 || N < 1 || D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto* c = static_cast<const float*>(cost);
  const auto* q = static_cast<const float*>(p2);
  auto* o = static_cast<float*>(out);
  const bool vec = (D % 4 == 0) && (reinterpret_cast<std::uintptr_t>(c) % 16 == 0) &&
                   (reinterpret_cast<std::uintptr_t>(o) % 16 == 0);
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= kChunk) {
    launch<1>(c, q, o, S, N, D, p1, vec, st);
  } else if (D <= 2 * kChunk) {
    launch<2>(c, q, o, S, N, D, p1, vec, st);
  } else if (D <= 3 * kChunk) {
    launch<3>(c, q, o, S, N, D, p1, vec, st);
  } else if (D <= kMaxRegChunks * kChunk) {
    launch<4>(c, q, o, S, N, D, p1, vec, st);
  } else {
    const cudaError_t e = vec ? launch_smem<true>(c, q, o, S, N, D, p1, st)
                              : launch_smem<false>(c, q, o, S, N, D, p1, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
