/* bump-time: jump the wall clock by <delta> milliseconds, once.
 *
 * TPU-framework analogue of the reference's one-shot clock bump shim
 * (jepsen/resources/bump-time.c).  Re-designed around clock_gettime /
 * clock_settime(CLOCK_REALTIME) with flat int64 nanosecond arithmetic
 * instead of timeval carry loops: one read, one add, one write.
 *
 * Usage:  bump-time <delta-ms>      (delta may be negative / fractional)
 * Prints the resulting wall-clock time as "<sec>.<nsec>" on success.
 * Exit codes: 0 ok, 1 bad usage / read failure, 2 set failure.
 */
#define _POSIX_C_SOURCE 199309L
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
#include <time.h>

static const int64_t NS = 1000000000LL;

static int64_t ts_to_ns(struct timespec t) {
  return (int64_t)t.tv_sec * NS + t.tv_nsec;
}

static struct timespec ns_to_ts(int64_t n) {
  struct timespec t;
  /* floor-divide so negative totals still yield tv_nsec in [0, NS) */
  int64_t s = n / NS;
  int64_t r = n % NS;
  if (r < 0) { s -= 1; r += NS; }
  t.tv_sec = (time_t)s;
  t.tv_nsec = (long)r;
  return t;
}

int main(int argc, char **argv) {
  if (argc != 2) {
    fprintf(stderr, "usage: %s <delta-ms>\n", argv[0]);
    return 1;
  }
  int64_t delta_ns = (int64_t)(atof(argv[1]) * 1e6);

  struct timespec now;
  if (clock_gettime(CLOCK_REALTIME, &now) != 0) {
    perror("clock_gettime");
    return 1;
  }
  struct timespec bumped = ns_to_ts(ts_to_ns(now) + delta_ns);
  if (clock_settime(CLOCK_REALTIME, &bumped) != 0) {
    perror("clock_settime");
    return 2;
  }
  if (clock_gettime(CLOCK_REALTIME, &now) != 0) {
    perror("clock_gettime");
    return 1;
  }
  printf("%lld.%09ld\n", (long long)now.tv_sec, now.tv_nsec);
  return 0;
}
