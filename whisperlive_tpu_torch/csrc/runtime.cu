// Error text for the codes the kernel launchers return.
#include <cuda_runtime.h>

extern "C" const char* wl_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
