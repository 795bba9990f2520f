// The C interface's error text: every launcher returns
// cudaGetLastError() as an int, and the Python wrappers raise with this.

#include <cuda_runtime.h>

extern "C" const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
