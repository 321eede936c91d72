// The megakernel engine's preempt flag: int32 words of pinned host memory
// that a persistent kernel reads (and writes) while it runs (the FPGA's AXI
// preempt line).  Counterpart of the reference's `PreemptFlag`
// (src/repro/core/preemption.py), a one-element buffer the JAX CPU backend
// reads in place; not a kernel.
//
// Interface (plain C, loaded with ctypes; see core/preemption.py):
//   preempt_flag_alloc(host, dev) -> cudaError_t
//     *host: the words for the host (a numpy view reads and writes them),
//     *dev:  the same words as the device addresses them.
//   preempt_flag_free(host)        -> cudaError_t
// Word 0 is the flag the host writes; word 1 the chunks the running launch
// has completed, which the kernel writes at every chunk boundary.
//
// cudaHostAlloc(Mapped | Portable) maps the page into the device's address
// space explicitly, whatever allocator PyTorch uses for its own pinned
// tensors (which may cache and hand a freed block to another caller).  The
// words are zeroed here.  The kernel reads the flag with `ld.acquire.sys`,
// so every read goes to host memory; an aligned int32 store on the host is
// never seen torn.

#include <cuda_runtime.h>

constexpr int kWords = 2;  // the flag, the progress

extern "C" int preempt_flag_alloc(void** host, void** dev) {
  void* h = nullptr;
  cudaError_t err =
      cudaHostAlloc(&h, kWords * sizeof(int), cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < kWords; ++i) static_cast<volatile int*>(h)[i] = 0;
  err = cudaHostGetDevicePointer(dev, h, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(h);
    return (int)err;
  }
  *host = h;
  return 0;
}

extern "C" int preempt_flag_free(void* host) { return (int)cudaFreeHost(host); }
