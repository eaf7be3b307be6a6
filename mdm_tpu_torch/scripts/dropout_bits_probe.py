"""The dropout-bit dump kernel (csrc/dropout_bits.cu) alone on one GPU.

Prints the card and its highest SM clock, then one JSON line: the kernel's
registers, spill and stack bytes (the build's ptxas report), its SASS
instructions by opcode (cuobjdump), the instructions per word on the path
of a thread whose groups are all whole (all of them, the IMAD family, and
the integer ones: what the built kernel spends beside the Philox rounds),
and the time of the three dump entry
points at the flagship training shapes (B=128, S=197, H=4, D=512, F=1024):
``dropout_bits`` [128, 4, 197, 197], ``tail_dropout_bits`` (three outputs,
one launch) and ``sequence_dropout_bits`` [128, 197, 512], each with its
words per second and bytes per second. CUDA events, mean of 50 calls
after 3 warm. ``--rates`` then prints a second JSON line: the issue rates
per SM and clock of IMAD, LOP3 and IMAD.WIDE.U32 chains, each with its
SASS opcodes (the IMAD.WIDE chain carries the adds and moves ptxas puts
beside it).

    python -m mdm_tpu_torch.scripts.dropout_bits_probe [--rates]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import dropout_bits as DB
from ._card import card_line

KERNEL = "philox_dump"
B, S, H, D, F = 128, 197, 4, 512, 1024


def sass_listing(so) -> str:
    """The SASS of the dump kernel in the built library."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    lines, keep = [], False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            keep = KERNEL in m.group(1)
        if keep:
            lines.append(line)
    return "\n".join(lines)


def opcodes(listing: str) -> dict:
    """{opcode with its modifiers: count} of a SASS listing (NOPs left out)."""
    counts = collections.Counter()
    for line in listing.splitlines():
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and m.group(1) != "NOP":
            counts[m.group(1)] += 1
    return dict(sorted(counts.items()))


_NOT_INTEGER = re.compile(r"^(U|S2R|S2UR|LDC|STG|BRA|EXIT|BSSY|BSYNC|NOP)")


def path_counts(listing: str) -> dict:
    """Instructions on the path of a thread whose groups are all whole: a
    predicated branch is taken (it skips a group's word-by-word stores), a
    predicated exit is not, except the one that follows the last 16-byte
    store's predicate; the path ends there or at an unpredicated exit.
    Returns the words it stores (4 per 16-byte store) and the instructions
    per word: all, the IMAD family (the FMA pipe) and the integer ones
    (neither memory, uniform datapath nor control)."""
    code = []
    for line in listing.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            code.append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                         m.group(4).strip()))
    at = {addr: i for i, (addr, *_) in enumerate(code)}
    counts = collections.Counter()
    i, vec_pred = 0, None
    while i < len(code):
        _, pred, op, args = code[i]
        if op == "NOP":
            i += 1
            continue
        counts["all"] += 1
        counts["imad"] += op.startswith("IMAD")
        counts["integer"] += not _NOT_INTEGER.match(op)
        if op.startswith("STG.E.128"):
            counts["words"] += 4
            vec_pred = pred
        if op == "EXIT" and (not pred or pred == vec_pred):
            break
        # A branch is conditional on its guard or on a predicate operand.
        if op.startswith("BRA") and (pred or re.match(r"!?U?P[0-6]\b", args)):
            i = at[int(re.findall(r"0x[0-9a-f]+", args)[-1], 16)]
            continue
        i += 1
    words = counts.pop("words")
    return dict(words=words, **{k: v / words for k, v in counts.items()})


def stack_bytes(log: str) -> int:
    """The dump kernel's stack frame in the ptxas report (0: no local copy)."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name and KERNEL in name:
            return int(m.group(1))
    return -1


def _ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure() -> dict:
    dev = torch.device("cuda")
    rows = {}
    for name, fn, words in (
            ("dropout_bits", lambda: DB.dropout_bits(7, B, H, S, device=dev), B * H * S * S),
            ("tail_dropout_bits", lambda: DB.tail_dropout_bits(7, B, S, D, F, device=dev),
             B * S * (2 * D + F)),
            ("sequence_dropout_bits", lambda: DB.sequence_dropout_bits(7, B, S, D, device=dev),
             B * S * D)):
        ms = _ms(fn)
        rows[name] = dict(ms=ms, words=words, g_words_per_s=words / ms / 1e6,
                          tb_per_s=4 * words / ms / 1e9)
    return rows


# Issue-rate microbenchmarks: 8 independent chains a thread, 2048 threads
# per SM. A chain step is one IMAD.WIDE.U32 whose operand is the sum of
# the last product's halves (so both stay live; the add issues on the
# other pipe), one IMAD, or one LOP3.
_RATES_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr uint32_t kM = 0xD2511F53u;
template <int kOp>
__global__ void __launch_bounds__(256) chains(uint32_t* out, int iters) {
  uint64_t p[8];
  uint32_t x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p[j] = threadIdx.x * 8ull + j + ((uint64_t)blockIdx.x << 32);
    x[j] = threadIdx.x ^ (j * 977u);
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kOp == 0)  // IADD3 + IMAD.WIDE.U32: p = (lo(p) + hi(p)) * M
        asm volatile("{ .reg .u32 lo, hi, s; mov.b64 {lo, hi}, %0; add.u32 s, lo, hi;"
                     " mul.wide.u32 %0, s, %1; }" : "+l"(p[j]) : "r"(kM));
      if (kOp == 1)  // IMAD: x = x * M + j
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x[j]) : "r"(kM), "r"(j * 3u + 1));
      if (kOp == 2)  // LOP3: x = x ^ j ^ M
        asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(x[j]) : "r"(j * 3u + 1), "r"(kM));
    }
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= (uint32_t)p[j] ^ (uint32_t)(p[j] >> 32) ^ x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
}  // namespace
extern "C" int run_chains(int op, void* out, int blocks, int iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint32_t*>(out);
  if (op == 0) chains<0><<<blocks, 256, 0, st>>>(o, iters);
  if (op == 1) chains<1><<<blocks, 256, 0, st>>>(o, iters);
  if (op == 2) chains<2><<<blocks, 256, 0, st>>>(o, iters);
  return (int)cudaGetLastError();
}
"""
_RATE_OPS = {"IMAD.WIDE.U32": 0, "IMAD": 1, "LOP3.LUT": 2}  # name -> op


def issue_rates(clock_hz: float) -> dict:
    """Chain steps per SM and clock (threads x steps / time / SMs / the
    highest SM clock): the named instruction's issue rate, each with its
    microbenchmark's SASS opcodes; the library is built in a temporary
    directory under the kernel library's (``_build.build_dir()``)."""
    import ctypes
    import tempfile

    _build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        src, so = os.path.join(tmp, "rates.cu"), os.path.join(tmp, "rates.so")
        with open(src, "w") as f:
            f.write(_RATES_SRC)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:6], "-shared",
                        "-o", so, src], check=True, capture_output=True)
        tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                              check=True).stdout
        lib = ctypes.CDLL(so)
        lib.run_chains.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        blocks, iters = sms * 8, 4096
        out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
        st = torch.cuda.current_stream().cuda_stream
        rates = {}
        for name, op in _RATE_OPS.items():
            ms = _ms(lambda: _build.check(lib.run_chains(op, out.data_ptr(), blocks, iters, st),
                                          "run_chains"), iters=10)
            rates[name] = blocks * 256 * iters * 8 / (ms * 1e-3) / sms / clock_hz
        per_kernel = {}
        for chunk in sass.split("Function : ")[1:]:
            m = re.search(r"chainsILi(\d)E", chunk.splitlines()[0])
            if m:
                per_kernel[int(m.group(1))] = opcodes(chunk)
        return {name: dict(per_sm_clock=rates[name], sass=per_kernel.get(op))
                for name, op in _RATE_OPS.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rates", action="store_true",
                    help="also measure the card's IMAD.WIDE.U32, IMAD and LOP3 issue rates")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dropout_bits_probe: no CUDA device is visible")
    so = _build.build()
    _build.load_library()
    print(card_line())
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    print(f"SM clock max: {clock.splitlines()[0]}")
    log = so.with_suffix(".log").read_text()
    listing = sass_listing(so)
    ms = measure()
    print(json.dumps({"ptxas": _build.ptxas_report(log, KERNEL), "stack_bytes": stack_bytes(log),
                      "sass_opcodes": opcodes(listing), "per_word": path_counts(listing),
                      "ms": ms}))
    if args.rates:
        hz = float(clock.splitlines()[0].split()[0]) * 1e6
        print(json.dumps({"issue_rates": issue_rates(hz)}))


if __name__ == "__main__":
    main()
