// NVIDIA GPU enumeration core — C ABI.
//
// The port's counterpart of the reference's native/tpuenum.h. Consumed
// from Python via ctypes (k8s_gpu_device_plugin_torch/device/native.py),
// built at first use with $CXX (default g++).
//
// Everything here reads files: no NVML, no CUDA. Sources:
//   /dev/nvidia<minor>                          device nodes
//   /proc/driver/nvidia/gpus/<bdf>/information  Model, GPU UUID,
//                                               Bus Location, Device Minor
//   /sys/bus/pci/devices/<bdf>/{vendor,device,numa_node}
//   /proc/driver/nvidia-caps/mig-minors         MIG capability minors
// A node with no information file behind it is listed bare (minor and
// path only); the Python side joins it to NVML by minor number.
//
// Testability: all filesystem access is rooted at $GPUENUM_ROOT (default
// ""), so tests point the library at a synthetic /dev + /proc + /sys tree.

#ifndef GPUENUM_H_
#define GPUENUM_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct GpuEnumInfo {
  int32_t index;           // enumeration order: by PCI bus id, then minor
  int32_t minor;           // /dev/nvidia<minor>
  int32_t numa_node;       // -1 if unknown
  int32_t has_info;        // 1 if an information file describes this GPU
  uint32_t pci_vendor_id;  // 0x10de, or 0 if sysfs does not say
  uint32_t pci_device_id;  // e.g. 0x2330, or 0 if sysfs does not say
  char uuid[96];           // "GPU-…" from the information file, or ""
  char model[96];          // "NVIDIA H100 80GB HBM3", or ""
  char bus_id[32];         // "0000:18:00.0", or ""
  char path[64];           // "/dev/nvidia<minor>"
  char generation[16];     // "h100" from the PCI id, or "" if unknown
} GpuEnumInfo;

typedef struct GpuEnumMigCap {
  int32_t gpu_minor;       // the parent's /dev/nvidia<minor>
  int32_t gi;              // GPU instance id
  int32_t ci;              // compute instance id, -1 for the GI's own line
  int32_t cap_minor;       // /dev/nvidia-caps/nvidia-cap<cap_minor>
} GpuEnumMigCap;

// Number of GPUs visible on this host.
int32_t gpuenum_gpu_count(void);

// Fill up to `max` entries; returns the number written, or -1 on error.
int32_t gpuenum_enumerate(GpuEnumInfo* out, int32_t max);

// The host's generation name into `out` (NUL-terminated, truncated to
// `max`): the first GPU whose PCI device id the table knows. Returns the
// length written, 0 if unknown.
int32_t gpuenum_generation(char* out, int32_t max);

// Where the generation came from: measured from a PCI device id, or not
// known (callers then warn loudly: a wrong generation skews every figure
// derived from the per-generation spec table).
#define GPUENUM_GEN_UNKNOWN 0
#define GPUENUM_GEN_PCI 1
int32_t gpuenum_generation_source(void);

// Generation name of one PCI device id (vendor 0x10de) into `out`;
// returns the length written, 0 if the table does not know the id.
int32_t gpuenum_generation_of(uint32_t pci_device_id, char* out, int32_t max);

// MIG capability lines of mig-minors: count, and fill up to `max`.
int32_t gpuenum_mig_count(void);
int32_t gpuenum_mig_enumerate(GpuEnumMigCap* out, int32_t max);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // GPUENUM_H_
