// WHILE conditional nodes of a CUDA graph under stream capture: the
// card's counterpart of a device-side loop (jax.lax.while_loop) inside
// one compiled program.
//
// imba_cond_begin adds, after the work captured so far on `stream`, a
// one-thread kernel that sets a new conditional handle from the device
// flag `*flag`, then a WHILE node that depends on it, and begins
// capturing `body` into the node's body graph.  Later work captured on
// `stream` runs after the node.  imba_cond_end closes the body: it
// launches the kernel that sets the handle again from `*flag` (which the
// body has just written), so the body runs again while the flag is true,
// and ends the capture; with a null `flag` (a body abandoned on an
// error) it only ends the capture.
//
// No host read is needed: the flag is read on the card at each replay.
// A body is captured on a stream of its own (imba_stream_create): not one
// of PyTorch's pooled streams, one of which may be the stream being
// captured.  Plain C interface, bound with ctypes (render/graphs.py).
// Returns 0 or a CUDA error code; -1 when `stream` is not capturing.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle,
                                const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
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

extern "C" int imba_cond_begin(void* stream, void* body, const bool* flag,
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
  set_conditional<<<1, 1, 0, s>>>(handle, flag);
  err = cudaGetLastError();
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

extern "C" int imba_cond_end(void* body, unsigned long long handle,
                             const bool* flag) {
  cudaStream_t b = static_cast<cudaStream_t>(body);
  if (flag != nullptr) {
    set_conditional<<<1, 1, 0, b>>>(handle, flag);
    cudaError_t err = cudaGetLastError();
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
