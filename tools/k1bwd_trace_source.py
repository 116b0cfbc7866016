"""Writes a copy of csrc/instance_norm.cu (to the path given) with globaltimer
stamps at the fused backward's handoffs, for tools/k1bwd_trace.py."""
import sys
import os
src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "unet_implementations_tpu_torch", "kernels", "csrc", "instance_norm.cu")).read()
def sub(old, new, count=1):
    global src
    assert src.count(old) == count, (old, src.count(old))
    src = src.replace(old, new)
sub('#include "hopper.cuh"\n', '#include "hopper.cuh"\n__device__ unsigned long long g_trace[132 * 256 * 8];\n'
    '#define TR(i, ev) do { if ((i) < 256) g_trace[(blockIdx.x * 256 + (i)) * 8 + (ev)] = global_ns(); } while (0)\n')
sub("    bar_sync(kBarRows + buf, all);\n    const float* rb", "    bar_sync(kBarRows + buf, all);\n    if (lane == 0) TR(i, 2);\n    const float* rb")
sub("      st_word(row + j, tag | __float_as_uint(u));\n    }\n", "      st_word(row + j, tag | __float_as_uint(u));\n    }\n    if (lane == 0) TR(i, 3);\n")
sub("      while (ld_relaxed(a.count + pc.pair) != static_cast<unsigned>(a.parts)) {\n        if (global_ns() - start > kMaxWaitNs) __trap();\n      }\n", "      while (ld_relaxed(a.count + pc.pair) != static_cast<unsigned>(a.parts)) {\n        if (global_ns() - start > kMaxWaitNs) __trap();\n      }\n      TR(i, 6);\n")
sub("      reduce(pc, rcur, static_cast<int>(reduced % kBuffers));\n",
    "      if (t == 0) TR(reduced, 0);\n      reduce(pc, rcur, static_cast<int>(reduced % kBuffers));\n      if (t == 0) TR(reduced, 1);\n")
sub("  // dx of one piece (its first ring slot", "  long long napplied = 0;\n  // dx of one piece (its first ring slot")
sub("    bar_sync(kBarReady + buf, all);\n", "    bar_sync(kBarReady + buf, all);\n    if (t == 0) TR(napplied, 4);\n")
sub("    pool_rows(a.partials + pc.pair * a.parts * w, a.parts, w, a.tag, sb, lane);\n", "    pool_rows(a.partials + pc.pair * a.parts * w, a.parts, w, a.tag, sb, lane);\n    if (lane == 0) TR(i, 5);\n")
sub("      if (++slot == a.ring_steps) slot = 0;\n    }\n  };\n", "      if (++slot == a.ring_steps) slot = 0;\n    }\n    if (t == 0) TR(napplied, 7);\n    ++napplied;\n  };\n")
src += '\nextern "C" int unet_trace_copy(void* dst) { return cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)); }\n'
open(sys.argv[1], "w").write(src)
