// Native event-loop oracle for the Ben-Or reference semantics.
//
// A C++ re-implementation of benor_tpu/backends/express.py — the
// deterministic re-host of the reference's per-node Express servers
// (the upstream repository's src/nodes/node.ts) — used for large-N differential
// testing where the Python oracle's per-message interpreter overhead
// dominates (the drain loop delivers O(N^2) messages per round).
//
// Semantics preserved bit-for-bit with the Python oracle, including the
// reference's behavioral quirks (SURVEY.md §2.1):
//   * unbounded per-round buffers re-firing the tally on every arrival
//     past N-F (quirk 8),
//   * quorum threshold counts raw messages including "?" (quirk 4),
//   * plurality-adopt before the coin (quirk 9),
//   * broadcasts include self (quirk 6),
//   * killed nodes silently drop messages (quirk 3),
//   * global-halt probe after each vote tally (sub-behavior 5e),
//   * faulty nodes crash-from-birth with null state (node.ts:21-26).
//
// The coin stream reproduces CPython's random.Random(seed).random()
// exactly: MT19937 with init_by_array seeding and 53-bit double output,
// so native and Python oracles generate IDENTICAL traces for the same
// (seed, scenario) — verified by tests/test_native_oracle.py.

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// MT19937 matching CPython's _randommodule.c (init_by_array seeding).
// ---------------------------------------------------------------------------
class PyMT19937 {
 public:
  explicit PyMT19937(uint32_t seed) {
    // CPython random.seed(int) for small non-negative ints passes the
    // absolute value as a single-element key to init_by_array.
    uint32_t key[1] = {seed};
    init_by_array(key, 1);
  }

  // CPython random_random(): 53-bit double in [0, 1).
  double random() {
    uint32_t a = genrand() >> 5;  // 27 bits
    uint32_t b = genrand() >> 6;  // 26 bits
    return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0);
  }

  // CPython Random.getrandbits(k) for k <= 32.
  uint32_t getrandbits(int k) { return genrand() >> (32 - k); }

  // CPython Random._randbelow_with_getrandbits(n): rejection sampling over
  // n.bit_length() bits — matches random.Random.randrange(n) draw-for-draw.
  uint32_t randbelow(uint32_t n) {
    int k = 32 - __builtin_clz(n);  // bit_length; caller ensures n >= 1
    uint32_t r = getrandbits(k);
    while (r >= n) r = getrandbits(k);
    return r;
  }

 private:
  static constexpr int N = 624;
  static constexpr int M = 397;
  static constexpr uint32_t MATRIX_A = 0x9908b0dfU;
  static constexpr uint32_t UPPER_MASK = 0x80000000U;
  static constexpr uint32_t LOWER_MASK = 0x7fffffffU;

  uint32_t mt_[N];
  int mti_ = N + 1;

  void init_genrand(uint32_t s) {
    mt_[0] = s;
    for (mti_ = 1; mti_ < N; mti_++) {
      mt_[mti_] =
          1812433253U * (mt_[mti_ - 1] ^ (mt_[mti_ - 1] >> 30)) + mti_;
    }
  }

  void init_by_array(const uint32_t *key, int key_length) {
    init_genrand(19650218U);
    int i = 1, j = 0;
    int k = (N > key_length) ? N : key_length;
    for (; k; k--) {
      mt_[i] = (mt_[i] ^ ((mt_[i - 1] ^ (mt_[i - 1] >> 30)) * 1664525U)) +
               key[j] + j;
      i++;
      j++;
      if (i >= N) {
        mt_[0] = mt_[N - 1];
        i = 1;
      }
      if (j >= key_length) j = 0;
    }
    for (k = N - 1; k; k--) {
      mt_[i] = (mt_[i] ^ ((mt_[i - 1] ^ (mt_[i - 1] >> 30)) * 1566083941U)) -
               i;
      i++;
      if (i >= N) {
        mt_[0] = mt_[N - 1];
        i = 1;
      }
    }
    mt_[0] = 0x80000000U;
  }

  uint32_t genrand() {
    uint32_t y;
    static const uint32_t mag01[2] = {0U, MATRIX_A};
    if (mti_ >= N) {
      int kk;
      for (kk = 0; kk < N - M; kk++) {
        y = (mt_[kk] & UPPER_MASK) | (mt_[kk + 1] & LOWER_MASK);
        mt_[kk] = mt_[kk + M] ^ (y >> 1) ^ mag01[y & 1U];
      }
      for (; kk < N - 1; kk++) {
        y = (mt_[kk] & UPPER_MASK) | (mt_[kk + 1] & LOWER_MASK);
        mt_[kk] = mt_[kk + (M - N)] ^ (y >> 1) ^ mag01[y & 1U];
      }
      y = (mt_[N - 1] & UPPER_MASK) | (mt_[0] & LOWER_MASK);
      mt_[N - 1] = mt_[M - 1] ^ (y >> 1) ^ mag01[y & 1U];
      mti_ = 0;
    }
    y = mt_[mti_++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680U;
    y ^= (y << 15) & 0xefc60000U;
    y ^= (y >> 18);
    return y;
  }
};

// ---------------------------------------------------------------------------
// Oracle state. Values: 0, 1, 2 == "?", -1 == null (faulty).
// ---------------------------------------------------------------------------
constexpr int8_t VALQ = 2;

struct Message {
  int32_t dest;
  int32_t k;
  int8_t x;
  uint8_t phase;  // 0 = proposal, 1 = voting
};

struct Oracle {
  int32_t n, f, max_rounds;
  int64_t step_cap;
  bool shuffle;        // delivery order: false = fifo, true = seeded shuffle
  PyMT19937 rng;       // the protocol coin stream (node.ts:111)
  PyMT19937 drng;      // delivery-order stream (seed derivation matches
                       // backends/express.py: (seed ^ 0x9E3779B9) & 2^32-1)
  std::deque<Message> queue;  // fifo order
  std::vector<Message> bag;   // shuffle order: swap-pop bag
  bool halt_pending = false;

  std::vector<uint8_t> killed, is_faulty, decided;
  std::vector<int8_t> x;
  std::vector<int32_t> k;
  // per-node, per-round tally counts (values 0/1/"?") — equivalent to the
  // Python oracle's unbounded lists, but only counts are ever consumed
  // (node.ts:54-69, 89-98 count; the raw list is never re-read otherwise),
  // and `len >= N-F` re-fires identically off the running total.
  struct Tally {
    int32_t c0 = 0, c1 = 0, cq = 0;
    int32_t len() const { return c0 + c1 + cq; }
  };
  std::vector<std::vector<Tally>> proposals, votes;  // [node][round]

  Oracle(int32_t n_, int32_t f_, int32_t max_rounds_, uint32_t seed,
         int64_t step_cap_, uint8_t order, const int8_t *vals,
         const uint8_t *faulty, const uint8_t *initial_killed)
      : n(n_), f(f_), max_rounds(max_rounds_), step_cap(step_cap_),
        shuffle(order != 0), rng(seed), drng((seed ^ 0x9E3779B9U)),
        killed(n_), is_faulty(faulty, faulty + n_), decided(n_),
        x(n_), k(n_, 0), proposals(n_), votes(n_) {
    for (int32_t i = 0; i < n; i++) {
      // pre-start /stop calls arrive via initial_killed (a healthy node
      // stopped before /start keeps its state but never participates —
      // parity with the Python oracle's stop_node-before-start behavior)
      killed[i] = is_faulty[i] | initial_killed[i];
      x[i] = is_faulty[i] ? -1 : vals[i];
      decided[i] = 0;
      if (is_faulty[i]) k[i] = -1;  // projected to null in the wrapper
      proposals[i].resize(max_rounds + 2);
      votes[i].resize(max_rounds + 2);
    }
  }

  void push(const Message &m) {
    if (shuffle) bag.push_back(m);
    else queue.push_back(m);
  }

  void broadcast(int32_t round, int8_t val, uint8_t phase) {
    if (round > max_rounds) return;  // round cap bounds livelock configs
    for (int32_t i = 0; i < n; i++) push({i, round, val, phase});
  }

  static void bump(Tally &t, int8_t v) {
    if (v == 0) t.c0++;
    else if (v == 1) t.c1++;
    else t.cq++;
  }

  void on_message(const Message &m) {
    int32_t i = m.dest;
    if (killed[i]) return;             // quirk 3: silent drop
    // protocol broadcasts keep 1 <= k <= max_rounds + 1 by construction;
    // INJECTED messages are range-checked by the Python wrapper, and this
    // guard keeps an out-of-range k memory-safe regardless (the tally
    // vectors are sized max_rounds + 2)
    if (m.k < 0 || m.k > max_rounds + 1) return;
    if (m.phase == 0) {                // proposal phase (node.ts:46-82)
      Tally &t = proposals[i][m.k];
      bump(t, m.x);
      if (t.len() >= n - f) {          // quirks 4/8: >=, counts "?"
        int8_t nx = t.c0 > t.c1 ? 0 : (t.c1 > t.c0 ? 1 : VALQ);
        broadcast(m.k, nx, 1);
      }
    } else if (m.phase == 1) {         // voting phase (node.ts:83-158)
      Tally &t = votes[i][m.k];
      bump(t, m.x);
      if (t.len() >= n - f) {
        if (t.c0 > f) {                // node.ts:99-104
          x[i] = 0;
          decided[i] = 1;
        } else if (t.c1 > f) {
          x[i] = 1;
          decided[i] = 1;
        } else if (t.c0 + t.c1 > 0 && t.c0 > t.c1) {  // quirk 9
          x[i] = 0;
        } else if (t.c0 + t.c1 > 0 && t.c0 < t.c1) {
          x[i] = 1;
        } else {
          x[i] = rng.random() > 0.5 ? 0 : 1;  // node.ts:111
        }
        halt_pending = true;           // sub-behavior 5e
        k[i] = m.k + 1;                // node.ts:147 — even if decided
        broadcast(k[i], x[i], 0);
      }
    }
    // phase >= 2: an injected unknown messageType — delivered as a no-op
    // (the reference handler's if/else-if chain ignores it).  It must
    // still occupy a queue slot: under shuffle delivery every pending
    // message perturbs the seeded randbelow draws, so dropping it at
    // enqueue time would shift the whole delivery permutation away from
    // the Python oracle's.
  }

  void run_halt_probe() {
    halt_pending = false;
    // reachedFinality: only decided == false blocks (tests/utils.ts:22-24)
    for (int32_t i = 0; i < n; i++)
      if (!is_faulty[i] && !decided[i]) return;
    for (int32_t i = 0; i < n; i++) killed[i] = 1;
  }

  // Returns delivered-message count, or -1 if the step cap tripped.
  int64_t start() {
    for (int32_t i = 0; i < n; i++) {  // /start fan-out (consensus.ts:3-8)
      if (!killed[i]) {
        k[i] = 1;
        broadcast(1, x[i], 0);
      }
    }
    int64_t steps = 0;
    if (shuffle) {
      while (!bag.empty()) {
        if (steps >= step_cap) return -1;
        uint32_t j = drng.randbelow(static_cast<uint32_t>(bag.size()));
        std::swap(bag[j], bag.back());
        Message m = bag.back();
        bag.pop_back();
        on_message(m);
        if (halt_pending) run_halt_probe();
        steps++;
      }
    } else {
      while (!queue.empty()) {
        if (steps >= step_cap) return -1;
        Message m = queue.front();
        queue.pop_front();
        on_message(m);
        if (halt_pending) run_halt_probe();
        steps++;
      }
    }
    return steps;
  }
};

}  // namespace

extern "C" {

// Runs the full oracle; writes final per-node state into the out arrays.
// `order`: 0 = fifo, 1 = seeded-shuffle delivery.  `killed_io` is in/out:
// on entry the initial killed mask (faulty nodes plus any pre-start /stop
// calls), on exit the final one.
// Returns delivered-message count, or -1 if the safety step cap tripped.
int64_t benor_express_run(int32_t n, int32_t f, int32_t max_rounds,
                          uint32_t seed, int64_t step_cap, uint8_t order,
                          const int8_t *initial_values,
                          const uint8_t *faulty, int8_t *out_x,
                          uint8_t *out_decided, int32_t *out_k,
                          uint8_t *killed_io) {
  Oracle o(n, f, max_rounds, seed, step_cap, order, initial_values, faulty,
           killed_io);
  int64_t steps = o.start();
  std::memcpy(out_x, o.x.data(), n);
  std::memcpy(out_decided, o.decided.data(), n);
  std::memcpy(out_k, o.k.data(), n * sizeof(int32_t));
  std::memcpy(killed_io, o.killed.data(), n);
  return steps;
}

// Injection variant (r5): benor_express_run plus n_inj externally injected
// messages (the reference's POST /message surface, node.ts:43-163) pushed
// into the delivery queue BEFORE the /start fan-out — exactly where the
// Python oracle's pre-start ExpressNetwork.inject_message puts them, so
// injected traces stay bit-equal across languages for either order.
// Killed-at-injection-time targets are skipped (the reference's handler
// body sits inside !killed; the wrapper mirrors the no-response wire
// behavior).  inj_phase: 0 = proposal, 1 = voting.
int64_t benor_express_run_inj(int32_t n, int32_t f, int32_t max_rounds,
                              uint32_t seed, int64_t step_cap, uint8_t order,
                              const int8_t *initial_values,
                              const uint8_t *faulty,
                              int64_t n_inj, const int32_t *inj_dest,
                              const int32_t *inj_k, const int8_t *inj_x,
                              const uint8_t *inj_phase, int8_t *out_x,
                              uint8_t *out_decided, int32_t *out_k,
                              uint8_t *killed_io) {
  Oracle o(n, f, max_rounds, seed, step_cap, order, initial_values, faulty,
           killed_io);
  for (int64_t j = 0; j < n_inj; j++) {
    if (inj_dest[j] < 0 || inj_dest[j] >= n) continue;
    if (o.killed[inj_dest[j]]) continue;
    o.push({inj_dest[j], inj_k[j], inj_x[j], inj_phase[j]});
  }
  int64_t steps = o.start();
  std::memcpy(out_x, o.x.data(), n);
  std::memcpy(out_decided, o.decided.data(), n);
  std::memcpy(out_k, o.k.data(), n * sizeof(int32_t));
  std::memcpy(killed_io, o.killed.data(), n);
  return steps;
}

// Batched variant (r3 VERDICT item 7): one call runs the oracle over an
// [S] seed vector with the same scenario, writing [S, N] out arrays and a
// per-seed delivered-message count into out_steps (-1 where the step cap
// tripped).  Lifts the one-seed-per-ctypes-call restriction so
// differential and DISTRIBUTIONAL tests (rounds-to-decide over ~10^3
// seeds, VERDICT item 4) run at C++ speed end-to-end.  No pre-start
// /stop support in batch mode (initial killed = the faulty mask), which
// is the only mode the distribution studies use.  Returns the number of
// seeds whose step cap tripped (0 = all clean).
int64_t benor_express_run_batch(int32_t n, int32_t f, int32_t max_rounds,
                                const uint32_t *seeds, int64_t n_seeds,
                                int64_t step_cap, uint8_t order,
                                const int8_t *initial_values,
                                const uint8_t *faulty, int8_t *out_x,
                                uint8_t *out_decided, int32_t *out_k,
                                uint8_t *out_killed, int64_t *out_steps) {
  int64_t tripped = 0;
  for (int64_t s = 0; s < n_seeds; s++) {
    // initial killed mask == the faulty mask (no pre-start /stop in batch
    // mode); the ctor only reads it, so the same buffer serves every seed
    Oracle o(n, f, max_rounds, seeds[s], step_cap, order, initial_values,
             faulty, faulty);
    int64_t steps = o.start();
    out_steps[s] = steps;
    if (steps < 0) tripped++;
    std::memcpy(out_x + s * n, o.x.data(), n);
    std::memcpy(out_decided + s * n, o.decided.data(), n);
    std::memcpy(out_k + s * n, o.k.data(), n * sizeof(int32_t));
    std::memcpy(out_killed + s * n, o.killed.data(), n);
  }
  return tripped;
}

}  // extern "C"
