// NVIDIA GPU enumeration core — implementation (see gpuenum.h).
//
// GPUs come from the driver's information files, joined to their device
// nodes by "Device Minor:", and from the device nodes alone where no
// information file describes them (a container may hide /proc/driver).
// PCI vendor, device id and NUMA node come from sysfs; a device whose
// vendor is not NVIDIA's (0x10de) is skipped. The generation comes from
// the PCI device id.

#include "gpuenum.h"

#include <dirent.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <fstream>
#include <set>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kNvidiaVendor = 0x10de;

std::string Root() {
  const char* root = getenv("GPUENUM_ROOT");
  return root ? std::string(root) : std::string();
}

// PCI device ids of vendor 0x10de the port knows; unknown ids yield "".
// Must agree with GENERATIONS in device/topology.py (a test pins it).
struct GenEntry {
  uint32_t device_id;
  const char* name;
};
constexpr GenEntry kGenerations[] = {
    {0x2330, "h100"},  // H100 SXM5 80GB HBM3
};

std::string Trim(const std::string& s) {
  const char* ws = " \t\r\n";
  const size_t a = s.find_first_not_of(ws);
  if (a == std::string::npos) return "";
  const size_t b = s.find_last_not_of(ws);
  return s.substr(a, b - a + 1);
}

std::string ReadTrimmed(const std::string& path) {
  std::ifstream f(path);
  if (!f.good()) return "";
  std::string s;
  std::getline(f, s);
  return Trim(s);
}

bool DirEntries(const std::string& dir, std::vector<std::string>* out) {
  DIR* d = opendir(dir.c_str());
  if (d == nullptr) return false;
  while (dirent* e = readdir(d)) {
    const std::string name = e->d_name;
    if (name != "." && name != "..") out->push_back(name);
  }
  closedir(d);
  return true;
}

// Numeric suffix of `name` after `prefix`, or -1.
int NumSuffix(const std::string& name, const std::string& prefix) {
  if (name.rfind(prefix, 0) != 0 || name.size() == prefix.size()) return -1;
  const std::string digits = name.substr(prefix.size());
  if (!std::all_of(digits.begin(), digits.end(),
                   [](char c) { return c >= '0' && c <= '9'; }))
    return -1;
  return atoi(digits.c_str());
}

uint32_t ParseHex(const std::string& s) {
  return s.empty() ? 0 : static_cast<uint32_t>(strtoul(s.c_str(), nullptr, 16));
}

std::string GenerationOf(uint32_t device_id) {
  for (const auto& gen : kGenerations)
    if (gen.device_id == device_id) return gen.name;
  return "";
}

struct RawGpu {
  int minor = -1;
  int numa_node = -1;
  bool has_info = false;
  uint32_t vendor = 0;
  uint32_t device = 0;
  std::string uuid, model, bus_id;
};

// "Key:   value" lines of an information file.
void ParseInformation(const std::string& path, RawGpu* gpu) {
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    const size_t colon = line.find(':');
    if (colon == std::string::npos) continue;
    const std::string key = Trim(line.substr(0, colon));
    const std::string value = Trim(line.substr(colon + 1));
    if (key == "Model") gpu->model = value;
    else if (key == "GPU UUID") gpu->uuid = value;
    else if (key == "Bus Location") gpu->bus_id = value;
    else if (key == "Device Minor") gpu->minor = atoi(value.c_str());
  }
}

std::vector<RawGpu> ScanGpus() {
  const std::string root = Root();
  std::vector<RawGpu> gpus;
  std::set<int> claimed;  // minors an information file speaks for

  std::vector<std::string> bdfs;
  const std::string proc = root + "/proc/driver/nvidia/gpus";
  if (DirEntries(proc, &bdfs)) {
    for (const auto& bdf : bdfs) {
      RawGpu gpu;
      ParseInformation(proc + "/" + bdf + "/information", &gpu);
      if (gpu.minor < 0) continue;
      claimed.insert(gpu.minor);
      if (gpu.bus_id.empty()) gpu.bus_id = bdf;
      const std::string sys = root + "/sys/bus/pci/devices/" + bdf;
      gpu.vendor = ParseHex(ReadTrimmed(sys + "/vendor"));
      if (gpu.vendor != 0 && gpu.vendor != kNvidiaVendor) continue;
      gpu.device = ParseHex(ReadTrimmed(sys + "/device"));
      const std::string numa = ReadTrimmed(sys + "/numa_node");
      if (!numa.empty()) gpu.numa_node = atoi(numa.c_str());
      gpu.has_info = true;
      gpus.push_back(gpu);
    }
  }

  std::vector<std::string> nodes;
  if (DirEntries(root + "/dev", &nodes)) {
    for (const auto& name : nodes) {
      const int minor = NumSuffix(name, "nvidia");
      if (minor < 0 || claimed.count(minor)) continue;
      claimed.insert(minor);
      RawGpu gpu;
      gpu.minor = minor;
      gpus.push_back(gpu);
    }
  }

  // by PCI bus id (nvidia-smi's and NVML's order) where known, then minor
  std::sort(gpus.begin(), gpus.end(), [](const RawGpu& a, const RawGpu& b) {
    if (a.bus_id.empty() != b.bus_id.empty()) return b.bus_id.empty();
    if (a.bus_id != b.bus_id) return a.bus_id < b.bus_id;
    return a.minor < b.minor;
  });
  return gpus;
}

std::string DetectGeneration(const std::vector<RawGpu>& gpus, int32_t* source) {
  if (source != nullptr) *source = GPUENUM_GEN_UNKNOWN;
  for (const auto& gpu : gpus) {
    const std::string gen = GenerationOf(gpu.device);
    if (!gen.empty()) {
      if (source != nullptr) *source = GPUENUM_GEN_PCI;
      return gen;
    }
  }
  return "";
}

std::vector<GpuEnumMigCap> ScanMig() {
  std::vector<GpuEnumMigCap> caps;
  std::ifstream f(Root() + "/proc/driver/nvidia-caps/mig-minors");
  std::string line;
  while (std::getline(f, line)) {
    // gpu<m>/gi<g>/access <minor>  or  gpu<m>/gi<g>/ci<c>/access <minor>
    GpuEnumMigCap cap = {-1, -1, -1, -1};
    char path[128];
    if (sscanf(line.c_str(), "%127s %d", path, &cap.cap_minor) != 2) continue;
    int used = 0;
    if (sscanf(path, "gpu%d/gi%d/ci%d/access%n", &cap.gpu_minor, &cap.gi,
               &cap.ci, &used) == 3 && path[used] == '\0') {
      caps.push_back(cap);
      continue;
    }
    cap.ci = -1;
    used = 0;
    if (sscanf(path, "gpu%d/gi%d/access%n", &cap.gpu_minor, &cap.gi, &used) == 2 &&
        path[used] == '\0')
      caps.push_back(cap);
  }
  return caps;
}

}  // namespace

extern "C" {

int32_t gpuenum_gpu_count(void) {
  return static_cast<int32_t>(ScanGpus().size());
}

int32_t gpuenum_enumerate(GpuEnumInfo* out, int32_t max) {
  if (out == nullptr || max < 0) return -1;
  const std::vector<RawGpu> gpus = ScanGpus();
  const int32_t n = std::min<int32_t>(max, static_cast<int32_t>(gpus.size()));
  for (int32_t i = 0; i < n; ++i) {
    const RawGpu& gpu = gpus[i];
    GpuEnumInfo* info = &out[i];
    memset(info, 0, sizeof(*info));
    info->index = i;
    info->minor = gpu.minor;
    info->numa_node = gpu.numa_node;
    info->has_info = gpu.has_info ? 1 : 0;
    info->pci_vendor_id = gpu.vendor;
    info->pci_device_id = gpu.device;
    snprintf(info->uuid, sizeof(info->uuid), "%s", gpu.uuid.c_str());
    snprintf(info->model, sizeof(info->model), "%s", gpu.model.c_str());
    snprintf(info->bus_id, sizeof(info->bus_id), "%s", gpu.bus_id.c_str());
    snprintf(info->path, sizeof(info->path), "/dev/nvidia%d", gpu.minor);
    snprintf(info->generation, sizeof(info->generation), "%s",
             GenerationOf(gpu.device).c_str());
  }
  return n;
}

int32_t gpuenum_generation(char* out, int32_t max) {
  if (out == nullptr || max <= 0) return 0;
  const std::string gen = DetectGeneration(ScanGpus(), nullptr);
  snprintf(out, static_cast<size_t>(max), "%s", gen.c_str());
  return static_cast<int32_t>(strlen(out));
}

int32_t gpuenum_generation_source(void) {
  int32_t source = GPUENUM_GEN_UNKNOWN;
  DetectGeneration(ScanGpus(), &source);
  return source;
}

int32_t gpuenum_generation_of(uint32_t pci_device_id, char* out, int32_t max) {
  if (out == nullptr || max <= 0) return 0;
  snprintf(out, static_cast<size_t>(max), "%s", GenerationOf(pci_device_id).c_str());
  return static_cast<int32_t>(strlen(out));
}

int32_t gpuenum_mig_count(void) {
  return static_cast<int32_t>(ScanMig().size());
}

int32_t gpuenum_mig_enumerate(GpuEnumMigCap* out, int32_t max) {
  if (out == nullptr || max < 0) return -1;
  const std::vector<GpuEnumMigCap> caps = ScanMig();
  const int32_t n = std::min<int32_t>(max, static_cast<int32_t>(caps.size()));
  for (int32_t i = 0; i < n; ++i) out[i] = caps[i];
  return n;
}

}  // extern "C"
