// Launch gate for timing one kernel launch with CUDA events.
//
// Under tracing, obs.device_span brackets each launch with a start and an
// end event.  On an idle stream the start event is stamped as soon as it is
// enqueued, and the kernel only when the host has gone through its launch
// path, so the pair would time the host as well.  The gate holds the stream
// instead: gate_wait enqueues a wait on one word of mapped host memory
// (cuStreamWaitValue32, GEQ), the host enqueues the start event, the kernel
// and the end event, then writes the word (kernels.build.LaunchGate), and
// the stream runs the three back to back.
//
// Nothing inside the hold may wait for the device: under lazy module loading
// a kernel's first launch does, so LaunchGate loads every kernel of the
// library (the *_load entry points) before its first hold.
//
// gate_alloc makes the word (pinned, mapped, portable: one word serves
// every device) and returns its host and device addresses; it is never
// freed.  Both entry points return 0 or the failing call's error code.

#include <cuda.h>
#include <cuda_runtime.h>

extern "C" int gate_alloc(void** host, void** dev) {
    cudaError_t err = cudaHostAlloc(host, 64, cudaHostAllocMapped |
                                              cudaHostAllocPortable);
    if (err != cudaSuccess) return (int)err;
    *(volatile unsigned int*)(*host) = 0;
    return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

extern "C" int gate_wait(void* stream, void* dev, unsigned int value) {
    return (int)cuStreamWaitValue32((CUstream)stream, (CUdeviceptr)dev, value,
                                    CU_STREAM_WAIT_VALUE_GEQ);
}
