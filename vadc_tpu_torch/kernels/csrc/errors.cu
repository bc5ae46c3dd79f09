// Error text for the status codes that the C entry points of this library
// return (each returns cudaGetLastError() right after its launch).
#include <cuda_runtime.h>

extern "C" const char* vadc_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
