// Error reporting for the port's kernel library.
#include <cuda_runtime.h>

extern "C" const char* mxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
