/* strobe-time: oscillate the wall clock by +/- <delta> ms every <period> ms
 * for <duration> seconds, then restore it.
 *
 * TPU-framework analogue of the reference's clock strobe shim
 * (jepsen/resources/strobe-time.c).  Re-designed with flat int64
 * nanosecond arithmetic: we snapshot the offset between CLOCK_REALTIME
 * and CLOCK_MONOTONIC once at startup, then repeatedly set the wall
 * clock to monotonic + (offset or offset+delta), flipping each period.
 * Anchoring every write to the monotonic clock means the strobe itself
 * never accumulates drift, and the final restore is exact.
 *
 * Usage:  strobe-time <delta-ms> <period-ms> <duration-s>
 * Prints the number of clock writes performed.
 * Exit codes: 0 ok, 1 bad usage / read failure, 2 set failure,
 *             3 sleep failure.
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
  int64_t s = n / NS;
  int64_t r = n % NS;
  if (r < 0) { s -= 1; r += NS; }
  t.tv_sec = (time_t)s;
  t.tv_nsec = (long)r;
  return t;
}

static int64_t read_ns(clockid_t clk) {
  struct timespec t;
  if (clock_gettime(clk, &t) != 0) {
    perror("clock_gettime");
    exit(1);
  }
  return ts_to_ns(t);
}

static void write_wall_ns(int64_t n) {
  struct timespec t = ns_to_ts(n);
  if (clock_settime(CLOCK_REALTIME, &t) != 0) {
    perror("clock_settime");
    exit(2);
  }
}

int main(int argc, char **argv) {
  if (argc != 4) {
    fprintf(stderr,
            "usage: %s <delta-ms> <period-ms> <duration-s>\n"
            "Every period ms, toggles the wall clock between its true "
            "value and true+delta ms, for duration seconds; then "
            "restores the clock and prints the number of writes.\n",
            argv[0]);
    return 1;
  }
  int64_t delta_ns  = (int64_t)(atof(argv[1]) * 1e6);
  int64_t period_ns = (int64_t)(atof(argv[2]) * 1e6);
  int64_t dur_ns    = (int64_t)(atof(argv[3]) * 1e9);

  /* wall = monotonic + base, sampled before we start meddling */
  int64_t base = read_ns(CLOCK_REALTIME) - read_ns(CLOCK_MONOTONIC);
  int64_t stop = read_ns(CLOCK_MONOTONIC) + dur_ns;

  struct timespec nap = ns_to_ts(period_ns);
  int64_t writes = 0;
  int skewed = 1;  /* first write applies the skew */

  while (read_ns(CLOCK_MONOTONIC) < stop) {
    int64_t off = skewed ? base + delta_ns : base;
    write_wall_ns(read_ns(CLOCK_MONOTONIC) + off);
    skewed = !skewed;
    writes++;
    struct timespec rem;
    if (nanosleep(&nap, &rem) != 0) {
      perror("nanosleep");
      exit(3);
    }
  }

  write_wall_ns(read_ns(CLOCK_MONOTONIC) + base);
  printf("%lld\n", (long long)writes);
  return 0;
}
