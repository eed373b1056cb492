// Conditional nodes of the captured registration loops
// (fpcr_tpu_torch/utils/graphs.py::skip_if_all).
//
// A loop's chunk is captured as one CUDA graph. Each of its iterations can
// sit in a conditional IF node (CUDA 12.4+), whose condition a one-thread
// kernel sets on the device from the loop's done flags just before it: the
// body's kernels then run only while some flag is clear, and the host
// reads nothing. The body is captured on its own, as a graph of its own,
// and the node holds a copy of it as a child graph. The chunk's graph is
// captured, instantiated, launched and destroyed through the runtime here
// too, apart from PyTorch's graphs, so that no memory pool of its own is
// made for it: all of its memory is in the pool of its parts.
//
// Not a TPU kernel's counterpart: the JAX package's lax.while_loop stops on
// the device by itself.

#include <cuda_runtime.h>

namespace {

// The IF node's condition: 1 while some flag of done[0, n) is clear; a
// body let run adds 1 to *bodies.
__global__ void set_unless_all_kernel(cudaGraphConditionalHandle handle,
                                      const bool* done, int n,
                                      long long* bodies) {
    unsigned int live = 0;
    for (int i = 0; i < n; ++i) live |= done[i] ? 0u : 1u;
    cudaGraphSetConditional(handle, live);
    *bodies += live;
}

// The graph `stream` is capturing and the nodes it depends on now.
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
    cudaStreamCaptureStatus status;
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr,
                                               graph, deps, ndeps);
    if (err != cudaSuccess) return err;
    return status == cudaStreamCaptureStatusActive
               ? cudaSuccess
               : cudaErrorIllegalState;
}

}  // namespace

extern "C" {

// Appends to the graph that `stream` is capturing, after its current
// work: a kernel that sets a new condition from done[0, n) (bool) and
// counts in *bodies (int64) the times it lets the body run, then an IF node
// of that condition whose body is a copy of the graph `body`; the IF node
// becomes the stream's one dependency.
int fpcr_graph_add_if(void* stream, const void* done, int n, void* body,
                      void* bodies) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t ndeps = 0;
    cudaError_t err = capture_info(s, &graph, &deps, &ndeps);
    if (err != cudaSuccess) return err;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    set_unless_all_kernel<<<1, 1, 0, s>>>(
        handle, static_cast<const bool*>(done), n,
        static_cast<long long*>(bodies));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = capture_info(s, &graph, &deps, &ndeps);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
    if (err != cudaSuccess) return err;
    cudaGraphNode_t child;
    err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                     nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
    if (err != cudaSuccess) return err;
    return cudaStreamUpdateCaptureDependencies(
        s, &node, 1, cudaStreamSetCaptureDependencies);
}

// Appends a copy of the graph `body` to the graph that `stream` is
// capturing, as one child-graph node after its current work, and makes it
// the stream's one dependency; an empty `body` appends nothing.
int fpcr_graph_add_child(void* stream, void* body) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    size_t nodes = 0;
    cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(body),
                                        nullptr, &nodes);
    if (err != cudaSuccess || nodes == 0) return err;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t ndeps = 0;
    err = capture_info(s, &graph, &deps, &ndeps);
    if (err != cudaSuccess) return err;
    cudaGraphNode_t child;
    err = cudaGraphAddChildGraphNode(&child, graph, deps, ndeps,
                                     static_cast<cudaGraph_t>(body));
    if (err != cudaSuccess) return err;
    return cudaStreamUpdateCaptureDependencies(
        s, &child, 1, cudaStreamSetCaptureDependencies);
}

// Begins capturing `stream` (thread-local mode): the graph of a chunk
// captured in parts, which fpcr_graph_add_child and fpcr_graph_add_if fill.
int fpcr_graph_capture_begin(void* stream) {
    return cudaStreamBeginCapture(static_cast<cudaStream_t>(stream),
                                  cudaStreamCaptureModeThreadLocal);
}

// Ends the capture of `stream` and, if `instantiate`, makes its graph an
// executable graph in *exec (else drops it).
int fpcr_graph_capture_end(void* stream, int instantiate, void** exec) {
    cudaGraph_t graph = nullptr;
    cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(stream),
                                           &graph);
    if (err != cudaSuccess) return err;
    if (instantiate) {
        cudaGraphExec_t made = nullptr;
        err = cudaGraphInstantiate(&made, graph, 0);
        *exec = made;
    }
    cudaGraphDestroy(graph);
    return err;
}

int fpcr_graph_launch(void* exec, void* stream) {
    return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                           static_cast<cudaStream_t>(stream));
}

int fpcr_graph_destroy(void* exec) {
    return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

}  // extern "C"
