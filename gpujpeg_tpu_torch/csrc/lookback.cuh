// The guard of the decoupled look-backs (huffdec_scan.cu's sync instance,
// pack_stuff_rows.cu's scan instance).  A CTA waits only on CTAs that took
// their tickets before it and are running, so a wait always ends; one that
// lasts kStallNs traps (a fault in a kernel) instead of holding the card.

#pragma once

namespace gj {

constexpr unsigned long long kStallNs = 20000000000ull;   // 20 s

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// one poll of a wait that began at t0 (0 before its first poll)
__device__ __forceinline__ void stall_guard(unsigned long long& t0) {
    const unsigned long long t = global_ns();
    if (t0 == 0)
        t0 = t;
    else if (t - t0 > kStallNs)
        __trap();
}

}  // namespace gj
