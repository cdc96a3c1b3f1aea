// Host runtime shim of the performance and energy accounting (the port's
// copy of cloudsc2jax/native/hostinfo.cpp).
//
// Native analogue of the reference's only C component, mycpu.c (a
// sched_getcpu wrapper used by timer_mod.F90:93 to report the core each
// OpenMP thread ran on), extended with:
//   - monotonic nanosecond clock (SYSTEM_CLOCK analogue, timer_mod.F90:56)
//   - RAPL/Cray energy counter reads (ec_pmon_mod.F90:14-56 analogue)
//   - a cyclic column expansion (expand_mod.F90:270-335 analogue)
//     used by the loader for large NGPTOT replication without the
//     Python/numpy copy overhead.
//
// Built as a plain shared library and bound via ctypes (no pybind11).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <sched.h>
#include <unistd.h>

extern "C" {

int cloudsc2_sched_getcpu(void) {
#ifdef __linux__
  return sched_getcpu();
#else
  return -1;
#endif
}

int64_t cloudsc2_monotonic_ns(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

// Reads an integer counter from a sysfs file; returns -1 on failure.
static int64_t read_counter(const char *path) {
  FILE *f = std::fopen(path, "r");
  if (!f) return -1;
  long long v = -1;
  if (std::fscanf(f, "%lld", &v) != 1) v = -1;
  std::fclose(f);
  return v;
}

// Energy in microjoules: Cray pm_counters first (reference behaviour),
// then Linux RAPL. Returns -1 when no counter is available.
int64_t cloudsc2_energy_uj(void) {
  int64_t v = read_counter("/sys/cray/pm_counters/energy");
  if (v >= 0) return v * 1000000LL;  // joules -> microjoules
  return read_counter("/sys/class/powercap/intel-rapl:0/energy_uj");
}

// Cyclic column expansion: dst[c, k] = src[c % src_cols, k] for
// row-major (cols, depth) buffers. The reference does this with an
// OpenMP loop over NPROMA blocks (expand_mod.F90:270-335); here a flat
// memcpy sweep, trivially prefetch-friendly.
void cloudsc2_expand_f64(const double *src, int64_t src_cols,
                         double *dst, int64_t dst_cols, int64_t depth) {
  const int64_t row = depth * static_cast<int64_t>(sizeof(double));
  for (int64_t c = 0; c < dst_cols; ++c) {
    std::memcpy(dst + c * depth, src + (c % src_cols) * depth, row);
  }
}

}  // extern "C"
