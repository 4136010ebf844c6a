// C++ unit test for the GPU enumeration core, run against a synthetic
// $GPUENUM_ROOT tree (no hardware):
//
//   g++ -std=c++17 -O2 -o /tmp/gpuenum_test gpuenum_test.cc gpuenum.cc
//   /tmp/gpuenum_test
//
// The tree: four H100s (PCI id 0x2330) on two NUMA nodes, listed out of
// bus order; a fifth NVIDIA device with an id the table does not know; a
// non-NVIDIA device the driver lists, which is skipped; a bare device
// node no information file describes; and a mig-minors file.

#include "gpuenum.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>

#include <fstream>
#include <string>

static int failures = 0;
#define CHECK(cond)                                                   \
  do {                                                                \
    if (!(cond)) {                                                    \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      ++failures;                                                     \
    }                                                                 \
  } while (0)

static void WriteFile(const std::string& path, const std::string& content) {
  std::ofstream f(path);
  f << content;
}

static void MkdirP(const std::string& path) {
  for (size_t i = 1; i <= path.size(); ++i)
    if (i == path.size() || path[i] == '/') mkdir(path.substr(0, i).c_str(), 0755);
}

static void AddGpu(const std::string& root, const std::string& bdf, int minor,
                   const char* vendor, const char* device, int numa) {
  const std::string proc = root + "/proc/driver/nvidia/gpus/" + bdf;
  MkdirP(proc);
  char uuid[64];
  snprintf(uuid, sizeof(uuid), "GPU-%08d-0000-0000-0000-000000000000", minor);
  WriteFile(proc + "/information",
            std::string("Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t 42\n") +
                "GPU UUID: \t " + uuid + "\nBus Type: \t PCIe\n" +
                "Bus Location: \t " + bdf + "\nDevice Minor: \t " +
                std::to_string(minor) + "\nGPU Excluded:\t No\n");
  const std::string sys = root + "/sys/bus/pci/devices/" + bdf;
  MkdirP(sys);
  WriteFile(sys + "/vendor", std::string(vendor) + "\n");
  WriteFile(sys + "/device", std::string(device) + "\n");
  WriteFile(sys + "/numa_node", std::to_string(numa) + "\n");
  WriteFile(root + "/dev/nvidia" + std::to_string(minor), "");
}

static std::string MakeFakeHost() {
  const char* tmpdir = getenv("TMPDIR");
  std::string tmpl = std::string(tmpdir && *tmpdir ? tmpdir : "/tmp") +
                     "/gpuenum_test_XXXXXX";
  const std::string root = mkdtemp(&tmpl[0]);
  MkdirP(root + "/dev");
  // minors out of bus order: the enumeration sorts by bus id
  AddGpu(root, "0000:9b:00.0", 2, "0x10de", "0x2330", 1);
  AddGpu(root, "0000:18:00.0", 0, "0x10de", "0x2330", 0);
  AddGpu(root, "0000:bb:00.0", 3, "0x10de", "0x2330", 1);
  AddGpu(root, "0000:2a:00.0", 1, "0x10de", "0x2330", 0);
  AddGpu(root, "0000:db:00.0", 4, "0x10de", "0x2331", 1);  // unknown id
  AddGpu(root, "0000:05:00.0", 7, "0x1af4", "0x1050", 0);  // not NVIDIA's
  WriteFile(root + "/dev/nvidia9", "");                    // bare node
  WriteFile(root + "/dev/nvidiactl", "");
  WriteFile(root + "/dev/nvidia-uvm", "");
  MkdirP(root + "/proc/driver/nvidia-caps");
  WriteFile(root + "/proc/driver/nvidia-caps/mig-minors",
            "config 1\nmonitor 2\ngpu0/gi1/access 12\ngpu0/gi1/ci0/access 13\n"
            "gpu0/gi2/access 21\ngpu0/gi2/ci0/access 22\nbogus line\n");
  return root;
}

int main() {
  const std::string root = MakeFakeHost();
  setenv("GPUENUM_ROOT", root.c_str(), 1);

  CHECK(gpuenum_gpu_count() == 6);  // five NVIDIA GPUs and the bare node
  GpuEnumInfo infos[8];
  const int n = gpuenum_enumerate(infos, 8);
  CHECK(n == 6);
  const int want_minor[] = {0, 1, 2, 3, 4, 9};
  const int want_numa[] = {0, 0, 1, 1, 1, -1};
  for (int i = 0; i < n; ++i) {
    CHECK(infos[i].index == i);
    CHECK(infos[i].minor == want_minor[i]);
    CHECK(infos[i].numa_node == want_numa[i]);
    char path[64];
    snprintf(path, sizeof(path), "/dev/nvidia%d", want_minor[i]);
    CHECK(strcmp(infos[i].path, path) == 0);
  }
  for (int i = 0; i < 4; ++i) {
    CHECK(infos[i].has_info == 1);
    CHECK(infos[i].pci_vendor_id == 0x10de);
    CHECK(infos[i].pci_device_id == 0x2330);
    CHECK(strcmp(infos[i].generation, "h100") == 0);
    CHECK(strcmp(infos[i].model, "NVIDIA H100 80GB HBM3") == 0);
    CHECK(strncmp(infos[i].uuid, "GPU-", 4) == 0);
  }
  CHECK(strcmp(infos[0].bus_id, "0000:18:00.0") == 0);
  CHECK(strcmp(infos[2].uuid, "GPU-00000002-0000-0000-0000-000000000000") == 0);
  CHECK(infos[4].pci_device_id == 0x2331);
  CHECK(infos[4].generation[0] == '\0');  // unknown id: no generation
  CHECK(infos[5].has_info == 0 && infos[5].uuid[0] == '\0');
  CHECK(infos[5].bus_id[0] == '\0' && infos[5].pci_device_id == 0);

  char gen[16];
  CHECK(gpuenum_generation(gen, sizeof(gen)) == 4);
  CHECK(strcmp(gen, "h100") == 0);
  CHECK(gpuenum_generation_source() == GPUENUM_GEN_PCI);
  CHECK(gpuenum_generation_of(0x2330, gen, sizeof(gen)) == 4);
  CHECK(gpuenum_generation_of(0x2331, gen, sizeof(gen)) == 0);

  CHECK(gpuenum_mig_count() == 4);
  GpuEnumMigCap caps[8];
  CHECK(gpuenum_mig_enumerate(caps, 8) == 4);
  CHECK(caps[0].gpu_minor == 0 && caps[0].gi == 1 && caps[0].ci == -1 &&
        caps[0].cap_minor == 12);
  CHECK(caps[1].gi == 1 && caps[1].ci == 0 && caps[1].cap_minor == 13);
  CHECK(caps[3].gi == 2 && caps[3].ci == 0 && caps[3].cap_minor == 22);

  // bad arguments
  CHECK(gpuenum_enumerate(nullptr, 1) == -1);
  CHECK(gpuenum_mig_enumerate(nullptr, 1) == -1);

  // an empty root: no GPU, no generation, no MIG line
  setenv("GPUENUM_ROOT", "/nonexistent_gpuenum", 1);
  CHECK(gpuenum_gpu_count() == 0);
  CHECK(gpuenum_generation_source() == GPUENUM_GEN_UNKNOWN);
  CHECK(gpuenum_mig_count() == 0);

  if (failures == 0) {
    printf("gpuenum_test: all checks passed\n");
    return 0;
  }
  fprintf(stderr, "gpuenum_test: %d failures\n", failures);
  return 1;
}
