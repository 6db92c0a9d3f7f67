// WHILE conditional nodes of a CUDA graph under stream capture: the
// card's counterpart of a device-side loop (jax.lax.while_loop) inside
// one compiled program.
//
// imba_cond_begin adds, after the work captured so far on `stream`, the
// flag kernel set_conditional, which sets a new conditional handle from
// the loop's condition, then a WHILE node that depends on it, and begins
// capturing `body` into the node's body graph.  Later work captured on
// `stream` runs after the node.  imba_cond_end closes the body: it
// launches the flag kernel again (on what the body has just written), so
// the body runs again while the condition holds, and ends the capture;
// with `set` 0 (a body abandoned on an error) it only ends the capture.
//
// The condition (struct Test) is a 0-d device flag, or the masked
// re-trace's (imbatracer_torch/render/traverse.py; JAX's lax.while_loop
// condition, imbatracer_tpu/render/traverse.py:281-300, :356-411): some
// slot still needs a round and fewer than `cap` rounds have run.  At the
// loop's entry the flag kernel sets the round counter to 1 and reads the
// lanes in need that the slot gather counted (round 1 is under any cap of
// 2 or more); at the end of a pass it adds the round and ORs the slots'
// need flags, one block of kTestThreads threads, 16-byte words a thread,
// kTestUnroll of them in flight.  So a pass ends in one launch, where the
// round's add, the flags' any, the compare, the and and the flag kernel
// were five, and the loop's entry takes the gather and this kernel, where
// nonzero_static, a sum, a fill, an any, a compare and an and came before
// the gather and the flag kernel.  What bounds it is its launch (~1 us
// in a graph); the bytes, at most the slots' flags, take ~0.02 us.
//
// The re-trace's loops stamp themselves on the card's %globaltimer: the
// entry's flag kernel keeps its stamp beside the round counter (`stamp`),
// and the launch that ends the loop (the entry's, or the last pass's)
// appends one record to the scene's loop log: the entry's and its own
// stamp and the rounds, with the loop's id above them.  The log is an
// int64 vector: word 0 counts the records appended, those past the
// capacity too, which are counted there and not written; the records
// follow, kLogWords words each.  Thread 0 does it: a timer read and a
// store at the entry, a timer read, an atomic add and three stores at the
// exit.  The profiler leaves out what runs inside a WHILE node's body;
// the log times the whole loop, and the entry's stamp, beside the traced
// entry launch, puts the log on the profiler's clock.
//
// No host read is needed: the condition is read on the card at each
// replay.  A body is captured on a stream of its own (imba_stream_create):
// not one of PyTorch's pooled streams, one of which may be the stream
// being captured.  Plain C interface, bound with ctypes
// (render/graphs.py).  Returns 0 or a CUDA error code; -1 when `stream`
// is not capturing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTestThreads = 512;
constexpr int kTestUnroll = 8;
// Words of a loop log's record: entry ns, exit ns, rounds | loop << 32.
constexpr int kLogWords = 3;

// The loop's condition: `flag` (a 0-d bool) when set; else the masked
// re-trace's, at the entry with `count` (0-d i32, the lanes in need) and
// at the end of a pass with `need` (n bools, the slots' flags); `rounds`
// a 0-d i32 round counter, `cap` the most rounds.  With `log`, the
// re-trace's loop is stamped: `stamp` a 0-d i64 for the entry's stamp,
// `log` the scene's loop log of `log_cap` records, `loop` the loop's id.
struct Test {
  const bool* flag;
  const uint8_t* need;
  long long n;
  const int* count;
  int* rounds;
  int cap;
  long long* stamp;
  long long* log;
  long long log_cap;
  int loop;
};

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// Append the ended loop's record, or count it past the capacity.
__device__ void log_loop(const Test& c, long long entry, int rounds) {
  const long long exit = global_ns();
  const unsigned long long i =
      atomicAdd(reinterpret_cast<unsigned long long*>(c.log), 1ull);
  if (i >= static_cast<unsigned long long>(c.log_cap)) return;
  long long* r = c.log + 1 + kLogWords * i;
  r[0] = entry;
  r[1] = exit;
  r[2] = static_cast<long long>(static_cast<unsigned>(rounds)) |
         static_cast<long long>(c.loop) << 32;
}

// Whether a flag of p[0:n] that this thread reads is set: 16-byte words
// where p is aligned, kTestUnroll loads in flight, then the bytes left.
__device__ bool any_flag(const uint8_t* p, long long n) {
  const bool aligned = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  const long long words = aligned ? n / 16 : 0;
  const uint4* w = reinterpret_cast<const uint4*>(p);
  unsigned acc = 0u;
  for (long long base = threadIdx.x; base < words;
       base += static_cast<long long>(kTestThreads) * kTestUnroll) {
    uint4 x[kTestUnroll];
#pragma unroll
    for (int k = 0; k < kTestUnroll; ++k) {
      const long long i = base + static_cast<long long>(k) * kTestThreads;
      x[k] = i < words ? w[i] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kTestUnroll; ++k)
      acc |= x[k].x | x[k].y | x[k].z | x[k].w;
  }
  for (long long i = 16 * words + threadIdx.x; i < n; i += kTestThreads)
    acc |= p[i];
  return acc != 0u;
}

// Set the WHILE node's handle from the condition: one thread for a flag
// and at the entry, kTestThreads at the end of a pass.
__global__ void __launch_bounds__(kTestThreads)
    set_conditional(cudaGraphConditionalHandle handle, Test c) {
  if (c.flag) {
    cudaGraphSetConditional(handle, *c.flag ? 1u : 0u);
    return;
  }
  if (c.count) {
    const long long entry = c.log ? global_ns() : 0;
    const bool go = *c.count > 0 && 1 < c.cap;
    *c.rounds = 1;
    cudaGraphSetConditional(handle, go ? 1u : 0u);
    if (c.log) {
      *c.stamp = entry;
      if (!go) log_loop(c, entry, 1);
    }
    return;
  }
  const int r = *c.rounds + 1;
  const int any = __syncthreads_or(any_flag(c.need, c.n));
  if (threadIdx.x == 0) {
    const bool go = any && r < c.cap;
    *c.rounds = r;
    cudaGraphSetConditional(handle, go ? 1u : 0u);
    if (c.log && !go) log_loop(c, *c.stamp, r);
  }
}

// The %globaltimer's steps: one thread reads it until it has changed `n`
// times and writes each change in ns to out[0:n] (0 where it did not
// change within 2^20 reads).
__global__ void timer_steps(long long* out, int n) {
  long long last = global_ns();
  for (int k = 0; k < n; ++k) {
    long long t = last;
    for (int spin = 0; t == last && spin < (1 << 20); ++spin) t = global_ns();
    out[k] = t - last;
    last = t;
  }
}

cudaError_t launch_test(cudaStream_t s, cudaGraphConditionalHandle handle,
                        const Test& c) {
  if (!c.flag && !(c.rounds && (c.count || c.need)))
    return cudaErrorInvalidValue;
  if (c.log && (c.flag || !c.stamp || c.log_cap < 0 || c.loop < 0))
    return cudaErrorInvalidValue;
  set_conditional<<<1, c.flag || c.count ? 1 : kTestThreads, 0, s>>>(handle,
                                                                      c);
  return cudaGetLastError();
}

cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr,
                                  ndeps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, ndeps);
#endif
}

}  // namespace

// imba_cond_begin: the condition at the loop's entry is `flag`, or, with
// `flag` null, the re-trace's: `count`, `rounds`, `cap`, stamped into
// `log` (null: not stamped) with `stamp`, `log_cap` and `loop`.
extern "C" int imba_cond_begin(void* stream, void* body, const bool* flag,
                               const int* count, int* rounds, int cap,
                               long long* stamp, long long* log,
                               long long log_cap, int loop,
                               unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStream_t b = static_cast<cudaStream_t>(body);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(s, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaStreamCaptureStatus body_status;
  err = cudaStreamIsCapturing(b, &body_status);
  if (err != cudaSuccess) return err;
  if (b == s || body_status != cudaStreamCaptureStatusNone)
    return cudaErrorIllegalState;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  err = launch_test(s, handle, {flag, nullptr, 0, count, rounds, cap, stamp,
                                log, log_cap, loop});
  if (err != cudaSuccess) return err;
  err = capture_info(s, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(b, params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  return 0;
}

// imba_cond_end: with `set`, the condition at the end of a pass is `flag`,
// or, with `flag` null, the re-trace's: `need` (n flags), `rounds`, `cap`,
// stamped as imba_cond_begin's.
extern "C" int imba_cond_end(void* body, unsigned long long handle, int set,
                             const bool* flag, const void* need,
                             long long n, int* rounds, int cap,
                             long long* stamp, long long* log,
                             long long log_cap, int loop) {
  cudaStream_t b = static_cast<cudaStream_t>(body);
  if (set) {
    cudaError_t err = launch_test(
        b, handle,
        {flag, static_cast<const uint8_t*>(need), n, nullptr, rounds, cap,
         stamp, log, log_cap, loop});
    if (err != cudaSuccess) return err;
  }
  cudaGraph_t graph;
  return cudaStreamEndCapture(b, &graph);
}

extern "C" int imba_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  *out = s;
  return 0;
}

// imba_timer_steps: timer_steps on `stream`.
extern "C" int imba_timer_steps(void* stream, long long* out, int n) {
  if (n < 1) return cudaErrorInvalidValue;
  timer_steps<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, n);
  return cudaGetLastError();
}
