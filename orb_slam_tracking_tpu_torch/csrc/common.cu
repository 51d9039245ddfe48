// Shared entry point of the port's kernel library: turns the cudaError_t
// that every launcher returns into its message for the Python wrapper.
#include <cuda_runtime.h>

extern "C" const char* osltt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
