// Conditional nodes of CUDA graphs: the device side of utils/control.py,
// the port's counterpart of `jax.lax.cond` inside a captured step.
//
// No TPU kernel is replaced here.  On the TPU, XLA lowers `lax.cond` on a
// device scalar to a conditional that runs only the taken branch; a CUDA
// graph does the same with an IF node (CUDA 12.4+), whose body graph runs
// when a handle set on the device is non-zero.  PyTorch declares this in
// `at::cuda::CUDAGraph::begin_capture_to_if_node`, but the builds this
// package runs on do not all bind it in Python, so it is written out here
// with a plain C interface:
//
//   gem_graph_if_begin  on the capturing stream: create a conditional
//                       handle on the graph being captured, launch a
//                       one-thread kernel that sets it from a device bool
//                       (negated on request), add an IF node after that
//                       kernel, make the node the stream's only capture
//                       dependency, and start capturing `body_stream` into
//                       the node's body graph;
//   gem_graph_if_end    end the body's capture and count the body's
//                       kernel, copy and fill nodes;
//   gem_graph_stream_create  a non-blocking stream for bodies;
//   gem_graph_count_nodes    the top-level nodes of a graph: all, the
//                            conditional ones, and the kernels, copies and
//                            fills (a check for tests and chip_smoke.py);
//   gem_trace_stamp          the tracer's device stamp (utils/
//                            observability.py `mark`): a one-thread kernel
//                            that writes %globaltimer into one slot of a
//                            ring, at the row a counter on the device
//                            holds, advancing the counter first on request,
//                            so a replayed graph stamps a new row per frame
//                            with no host read.
//
// What the body's work allocates is routed into a private pool by the
// caller (PyTorch's caching allocator is driven from Python), so no
// PyTorch header is included and the library builds in seconds.
//
// Bounds: none worth counting.  The set kernel reads one byte; an untaken
// IF node costs its launch, a few microseconds (PERF.md, chip_smoke.py
// phase 13).  A stamp reads and writes 8 bytes (16 when it advances).

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

// CUDA 13 gave these three calls the edge-data argument of their _v2/_v3
// forms; the package passes no edge data.
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
  unsigned long long id = 0;
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, &id, graph, deps, nullptr,
                                  ndeps);
#else
  return cudaStreamGetCaptureInfo(s, status, &id, graph, deps, ndeps);
#endif
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t ndeps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, ndeps, params);
#else
  return cudaGraphAddNode(node, graph, deps, ndeps, params);
#endif
}

cudaError_t set_dependencies(cudaStream_t s, cudaGraphNode_t* node) {
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      s, node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(
      s, node, 1, cudaStreamSetCaptureDependencies);
#endif
}

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred, int negate) {
  cudaGraphSetConditional(handle, (*pred ? 1u : 0u) ^ (negate ? 1u : 0u));
}

}  // namespace

// Named for the profiler: its launches are the stamps' own device events.
__global__ void gem_stage_stamp_kernel(long long* ring, long long* row,
                                       long long rows, int cols, int col,
                                       int advance) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long r = *row;
  if (advance) *row = ++r;
  ring[(((r - 1) % rows + rows) % rows) * cols + col] = now;
}

extern "C" int gem_trace_stamp(void* stream, void* ring, void* row,
                               long long rows, int cols, int col,
                               int advance) {
  gem_stage_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(row), rows,
      cols, col, advance);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gem_graph_stream_create(void** out) {
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return static_cast<int>(err);
}

extern "C" int gem_graph_if_begin(void* stream, const void* pred, int negate,
                                  void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(s, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition_kernel<<<1, 1, 0, s>>>(handle,
                                       static_cast<const bool*>(pred),
                                       negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dependencies now end in the set kernel
  err = capture_info(s, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = add_node(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_dependencies(s, &node);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream),
      params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeGlobal));
}

extern "C" int gem_graph_if_end(void* body_stream, long long* work) {
  cudaGraph_t body = nullptr;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the body's nodes that do work on the device: kernels, copies, fills
  size_t n = 0;
  err = cudaGraphGetNodes(body, nullptr, &n);
  cudaGraphNode_t* all = new cudaGraphNode_t[n > 0 ? n : 1];
  if (err == cudaSuccess) err = cudaGraphGetNodes(body, all, &n);
  long long count = 0;
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(all[i], &type);
    count += type == cudaGraphNodeTypeKernel ||
             type == cudaGraphNodeTypeMemcpy ||
             type == cudaGraphNodeTypeMemset;
  }
  delete[] all;
  *work = count;
  return static_cast<int>(err);
}

// Counted with libcuda's cuGraph* entry points: a graph handle that
// PyTorch's runtime made (`CUDAGraph.raw_cuda_graph()`) is refused by this
// library's own statically linked runtime.
extern "C" int gem_graph_count_nodes(void* graph, long long* nodes,
                                     long long* conditional,
                                     long long* work) {
  using GetNodes = CUresult (*)(CUgraph, CUgraphNode*, size_t*);
  using GetType = CUresult (*)(CUgraphNode, CUgraphNodeType*);
  void* get_nodes = nullptr;
  void* get_type = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuGraphGetNodes", &get_nodes, 12000, cudaEnableDefault, &found);
  if (err == cudaSuccess)
    err = cudaGetDriverEntryPointByVersion(
        "cuGraphNodeGetType", &get_type, 12000, cudaEnableDefault, &found);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (get_nodes == nullptr || get_type == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  CUgraph g = static_cast<CUgraph>(graph);
  size_t n = 0;
  CUresult res = reinterpret_cast<GetNodes>(get_nodes)(g, nullptr, &n);
  CUgraphNode* all = new CUgraphNode[n > 0 ? n : 1];
  if (res == CUDA_SUCCESS)
    res = reinterpret_cast<GetNodes>(get_nodes)(g, all, &n);
  long long cond = 0, busy = 0;
  for (size_t i = 0; res == CUDA_SUCCESS && i < n; ++i) {
    CUgraphNodeType type;
    res = reinterpret_cast<GetType>(get_type)(all[i], &type);
    cond += type == CU_GRAPH_NODE_TYPE_CONDITIONAL;
    busy += type == CU_GRAPH_NODE_TYPE_KERNEL ||
            type == CU_GRAPH_NODE_TYPE_MEMCPY ||
            type == CU_GRAPH_NODE_TYPE_MEMSET;
  }
  delete[] all;
  *nodes = static_cast<long long>(n);
  *conditional = cond;
  *work = busy;
  return static_cast<int>(res);
}
