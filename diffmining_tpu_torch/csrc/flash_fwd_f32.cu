// flash_fwd_f32: non-causal softmax(q.k^T * scale).v in float32, for the CLIP
// vision towers' self-attention at crops of 448 px and more (ViT-L/14: L =
// 1025 at 448, 4097 at 896; head dim 64). Written for Hopper (sm_90a).
//
// The towers run in float32, and the JAX package's Pallas forwards compute
// in their operands' dtype (every astype in them is to the operand's own
// dtype), so at float32 they are float32 throughout. This kernel is their
// counterpart in two modes of one loop:
//   * online (NOMAX = false) replaces _flash_kernel_t (K3,
//     diffmining_tpu/ops/flash_attention.py:199), the route of L = 1025;
//   * no-max (NOMAX = true) replaces _flash_kernel_t_nomax (K2, :250), the
//     route from L = 4097 on, and _flash_kernel_t_1shot (K1, :290), which
//     is the same arithmetic with the key row in one block.
//
// Arithmetic, float32 throughout (no TF32, no bf16; fp32 FMA only):
//   qs    = q * fp32(scale*log2e)                     (the pre-scale, :363)
//   s     = qs . k^T; keys past Lk get -1e30
//   online: m_new = max(m, rowmax(s)), alpha = exp2(m - m_new), m from -1e30
//           p = exp2(s - m_new); acc = acc*alpha + p.v; l = l*alpha + sum p
//   no-max: p = exp2(s); acc += p.v; l += sum p
//   o     = acc * (1 / max(l, 1e-30))
// exp2 results below the smallest normal float flush to zero, as on the TPU
// and in the plain versions. The running max is taken per 64-key tile here
// and per TPU key block there; in float32 that moves only roundings.
//
// What bounds it on an H100 SXM: at B8 H16 L1025 D64 one call is 4 L^2 D a
// head = 3.4e10 fp32 operations, 0.51 ms at the 67 TFLOP/s float32 rate
// outside the tensor cores; q, k, v and o are 17 MB, 0.005 ms at 3.35 TB/s.
// It is bound by its operations.
//
// Design (a simple kernel that is right first): one block of 256 threads a
// (batch, head, 64-row q tile). The pre-scaled q tile stays in shared
// memory; K and V stream through shared memory in 64-key tiles, the next
// tile's global loads issued into registers before the current tile's
// products so they are in flight meanwhile. A thread holds a 4 x 4 block of
// S (rows 4ty.., keys tx + 16j) and of the output (rows 4ty.., head-dim
// columns 4tx..): the 16 threads of a half-warp share the rows, so the row
// max is four shuffles and the row sum is carried per thread and reduced
// once at the end. P goes through shared memory between the two products.
// Every shared tile has a row stride of D + 4 floats, so the 16-byte reads
// of each product are free of bank conflicts.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int BQ = 64;        // q rows a block
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 256;  // 16 x 16: ty = rows 4ty..4ty+3, tx
constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value

struct Strides {
  long long s[12];  // element strides (batch, head, row) of q, k, v, o
};

__device__ __forceinline__ float exp2_ftz(float x) {
  const float y = exp2f(x);
  return y < FLT_MIN ? 0.f : y;
}

template <int D, bool NOMAX>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(const float* __restrict__ q,
                                                                const float* __restrict__ k,
                                                                const float* __restrict__ v, float* __restrict__ o,
                                                                int Lq, int Lk, Strides st, float q_scale) {
  static_assert(D % 16 == 0, "a thread holds D / 16 head-dim columns");
  constexpr int S = D + 4;       // row stride of the q, K and V tiles
  constexpr int SP = BK + 4;     // row stride of the P tile
  constexpr int V4 = D / 4;      // 16-byte chunks a row
  constexpr int DPT = D / 16;    // output columns a thread holds
  constexpr int LOADS = BK * V4 / THREADS;  // 16-byte loads a thread a tile, of K and of V
  static_assert(BK * V4 % THREADS == 0 && BQ * V4 % THREADS == 0, "tiles split evenly over the threads");

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + BQ * S;
  float* sv = sk + BK * S;
  float* sp = sv + BK * S;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * st.s[0] + h * st.s[1];
  const float* kb = k + b * st.s[3] + h * st.s[4];
  const float* vb = v + b * st.s[6] + h * st.s[7];
  float* ob = o + b * st.s[9] + h * st.s[10];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // the pre-scaled q tile; rows past Lq are zeros and are never stored
  for (int f = tid; f < BQ * V4; f += THREADS) {
    const int r = f / V4, c = f % V4;
    float4 x = zero4;
    if (q0 + r < Lq) {
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * st.s[2] + 4 * c);
      x.x *= q_scale;
      x.y *= q_scale;
      x.z *= q_scale;
      x.w *= q_scale;
    }
    *reinterpret_cast<float4*>(sq + r * S + 4 * c) = x;
  }

  float4 kr[LOADS], vr[LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int f = tid + it * THREADS, r = f / V4, c = f % V4;
      const bool in = k0 + r < Lk;  // keys past Lk: zeros (their p is 0)
      kr[it] = in ? *reinterpret_cast<const float4*>(kb + (k0 + r) * st.s[5] + 4 * c) : zero4;
      vr[it] = in ? *reinterpret_cast<const float4*>(vb + (k0 + r) * st.s[8] + 4 * c) : zero4;
    }
  };

  float acc[4][DPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  fetch(0);
  for (int k0 = 0; k0 < Lk; k0 += BK) {
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int f = tid + it * THREADS, r = f / V4, c = f % V4;
      *reinterpret_cast<float4*>(sk + r * S + 4 * c) = kr[it];
      *reinterpret_cast<float4*>(sv + r * S + 4 * c) = vr[it];
    }
    __syncthreads();
    if (k0 + BK < Lk) fetch(k0 + BK);  // in flight during this tile's products

    // S = qs . k^T: rows 4ty + i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < V4; ++c) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sq + (4 * ty + i) * S + 4 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * S + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j >= Lk)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = NEG_INF;

    // p, the running max (online mode) and the per-thread part of l
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float shift = 0.f;
      if (!NOMAX) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = exp2_ftz(m[i] - m_new);
        m[i] = m_new;
        shift = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2_ftz(s[i][j] - shift);
        l[i] += p;
        sp[(4 * ty + i) * SP + tx + 16 * j] = p;
      }
    }
    __syncthreads();

    // acc += P . V: rows 4ty + i, head-dim columns DPT tx + j
#pragma unroll 2
    for (int c4 = 0; c4 < BK / 4; ++c4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(sp + (4 * ty + i) * SP + 4 * c4);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = sv + (4 * c4 + cc) * S + DPT * tx;
        float vv[DPT];
        if constexpr (DPT % 4 == 0) {
#pragma unroll
          for (int j = 0; j < DPT; j += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + j);
            vv[j] = x.x;
            vv[j + 1] = x.y;
            vv[j + 2] = x.z;
            vv[j + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < DPT; ++j) vv[j] = vrow[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y : cc == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites K, V and P
  }

  // l from the half-warp's parts; o = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = q0 + 4 * ty + i;
    if (r >= Lq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* orow = ob + r * st.s[11] + DPT * tx;
    if constexpr (DPT % 4 == 0) {
#pragma unroll
      for (int j = 0; j < DPT; j += 4)
        *reinterpret_cast<float4*>(orow + j) =
            make_float4(acc[i][j] * inv, acc[i][j + 1] * inv, acc[i][j + 2] * inv, acc[i][j + 3] * inv);
    } else {
#pragma unroll
      for (int j = 0; j < DPT; ++j) orow[j] = acc[i][j] * inv;
    }
  }
}

template <int D, bool NOMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk, const Strides& st,
           float q_scale, cudaStream_t stream) {
  constexpr size_t smem = (size_t(BQ) * (D + 4) + 2 * size_t(BK) * (D + 4) + size_t(BQ) * (BK + 4)) * sizeof(float);
  auto kernel = flash_fwd_f32_kernel<D, NOMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                          static_cast<const float*>(v), static_cast<float*>(o), Lq, Lk, st, q_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). strides: 12 element strides,
// (batch, head, row) for q, k, v, o in that order, the head dim contiguous
// and every row 16-byte aligned. nomax selects the no-max mode. Returns the
// CUDA error of the launch (0 on success); D must be 64.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                             int D, int nomax, const long long* strides, float q_scale, void* stream) {
  Strides st;
  for (int i = 0; i < 12; ++i) st.s[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (D == 64) {
    return nomax ? launch<64, true>(q, k, v, o, B, H, Lq, Lk, st, q_scale, s)
                 : launch<64, false>(q, k, v, o, B, H, Lq, Lk, st, q_scale, s);
  }
  return cudaErrorInvalidValue;
}
